#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`xmm_superres_denoise_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result and its seconds:

1. device: the card's name and power limit (nvidia-smi) and what PyTorch sees;
2. build: the dense-block kernel compiled with nvcc for sm_90a (ptxas report);
3. kernel: the kernel held against its plain PyTorch version at the serving
   shape (B=2, 416x416x32) in f32 (TF32 off) and bf16, and timed with CUDA
   events beside the plain version and a cuDNN composition of the same block;
4. serve: 4 synthetic Poisson detxy FITS (403x411, so padding is exercised)
   served by `serve_files` through `InferenceEngine` at full esr_gen width and
   depth (416^2 -> 832^2) with the trained weights, in f32 and in bf16. The
   launch count is reset just before each run and read just after; the f32
   products are held against a forward on the card through the plain dense
   block, called explicitly here.

The last two lines are a `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Any failure exits non-zero. Without a CUDA
card it exits non-zero at once and prints no result. All products go to a
temporary directory; the only file written inside the checkout is the
kernel library under build/torch_kernels/.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEADLINE_S = 900  # the whole run; the watchdog exits non-zero past it
SERVE_FILES = 4
SERVE_BATCH = 2
NATIVE_HW = (411, 403)  # numpy (NAXIS2, NAXIS1) of an EPIC-pn detxy image
KERNEL_SHAPE = (2, 416, 416, 32)  # the trunk's dense-block input when serving
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12
# tolerances of kernel vs plain version: f32 sums in another order (TF32 off);
# bf16 rounds each level's activations to bf16 in both, so a few bf16 ulps
F32_ATOL = 1e-4
BF16_ULPS = 4 * 2.0**-8
# served f32 predictions vs the plain-block forward, relative to hr clamp_max
SERVE_F32_RTOL = 2e-5
# served bf16 predictions vs the f32 plain forward, relative to hr clamp_max
SERVE_BF16_RTOL = 0.1


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(
        f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}: {kind} x{count} "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    return {"platform": "gpu", "kind": kind, "count": count}


def phase_build():
    from xmm_superres_denoise_torch.ops import dense_block as db

    lib, log, secs = db.build()
    say(f"[build] nvcc {' '.join(db.NVCC_FLAGS)} -> {lib.name} ({secs:.2f} s)")
    for line in log.splitlines():
        if line.strip():
            say(f"[build]   {line.strip()}")


def _block_inputs(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(g.normal(size=shape).astype(np.float32))
    ws = []
    for j in range(1, 6):
        bound = 1.0 / math.sqrt(9 * c * j)  # torch Conv2d default init scale
        ws.append(torch.from_numpy(g.uniform(-bound, bound, (3, 3, c * j, c)).astype(np.float32)))
        ws.append(torch.from_numpy(g.uniform(-bound, bound, (c,)).astype(np.float32)))
    return x.to(device, dtype), [w.to(device, dtype) for w in ws]


def _library_block(x_nchw, oihw, biases):
    """The same block as a composition of cuDNN convolutions (the yardstick;
    the port never calls it)."""
    feats = [x_nchw]
    y = None
    for k in range(5):
        y = F.conv2d(torch.cat(feats, 1), oihw[k], biases[k], padding=1)
        if k < 4:
            feats.append(F.leaky_relu(y, 0.2))
    return y * 0.2 + x_nchw


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(dtype) -> dict:
    from xmm_superres_denoise_torch.ops.dense_block import (
        dense_block,
        dense_block_reference,
    )
    from xmm_superres_denoise_torch.ops.precision import true_f32

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    x, ws = _block_inputs(KERNEL_SHAPE, dtype, dev)
    b, h, w, c = KERNEL_SHAPE
    with torch.inference_mode(), true_f32():
        out = dense_block(x, *ws)
        ref = dense_block_reference(x, *ws)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ULPS * scale
        finite = bool(torch.isfinite(out).all())
        ms = _time_ms(lambda: dense_block(x, *ws))
        plain_ms = _time_ms(lambda: dense_block_reference(x, *ws))
        x_nchw = x.permute(0, 3, 1, 2)
        oihw = [wk.permute(3, 2, 0, 1).contiguous() for wk in ws[0::2]]
        lib_out = _library_block(x_nchw, oihw, ws[1::2])
        lib_err = (lib_out.permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
        library_ms = _time_ms(lambda: _library_block(x_nchw, oihw, ws[1::2]))
    esize = x.element_size()
    flops = b * h * w * 9 * c * c * sum(range(1, 6)) * 2
    nbytes = esize * (2 * x.numel() + sum(t.numel() for t in ws))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    name = "f32" if dtype == torch.float32 else "bf16"
    say(
        f"[kernel] dense_block {name} {KERNEL_SHAPE}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}, max|plain| {scale:.3f}), max|cudnn-plain| {lib_err:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cudnn {library_ms:.4f} ms, "
        f"bound {max(t_ops, t_bytes) * 1e3:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved) "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if not finite or not err <= tol:
        raise AssertionError(f"dense_block {name} disagrees with its plain version: {err} > {tol}")
    return {
        "name": f"dense_block[{name}]",
        "route": "cuda",
        "source": "xmm_superres_denoise_torch/csrc/dense_block.cu",
        "replaces": "xmm_superres_denoise_tpu/ops/pallas_rrdb.py:141",
        "launches": None,  # filled from the serve run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "ok": True,
    }


def _write_inputs(directory: Path) -> list:
    from xmm_superres_denoise_torch.io.fits import write_image

    g = np.random.default_rng(2024)
    files = []
    for i in range(SERVE_FILES):
        # a flat Poisson background with a few bright point sources, counts
        # of a 20 ks exposure
        lam = np.full(NATIVE_HW, g.uniform(0.5, 3.0))
        for _ in range(8):
            y, x = g.integers(20, NATIVE_HW[0] - 20), g.integers(20, NATIVE_HW[1] - 20)
            lam[y - 2 : y + 3, x - 2 : x + 3] += g.uniform(5, 40)
        hdr = {
            "EXPOSURE": 20_000.0, "CRPIX1": 200.0, "CRPIX2": 205.0,
            "CRVAL1": 150.0 + i, "CRVAL2": 2.0, "CDELT1": -0.001111,
            "CDELT2": 0.001111, "PA_PNT": 65.0, "CTYPE1": "RA---TAN",
            "CTYPE2": "DEC--TAN",
        }
        files.append(write_image(
            directory / f"pn_{i}_detxy_image_20ks.fits", g.poisson(lam).astype(np.int32), hdr
        ))
    return files


def plain_forward(model, x):
    """The SR generator's forward with every dense block on its plain
    version: the reference the served f32 predictions are held against."""
    from xmm_superres_denoise_torch.models.rrdb import conv_nhwc, pixel_shuffle
    from xmm_superres_denoise_torch.ops.dense_block import dense_block_reference

    trunk = model.trunk
    fea = conv_nhwc(trunk.conv_first, x)
    t = fea
    for i in range(trunk.num_res_blocks):
        rrdb, r_in = getattr(trunk, f"rrdb_{i}"), t
        for rdb in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            t = dense_block_reference(t, *rdb.flat_params())
        t = t * 0.2 + r_in
    fea = fea + conv_nhwc(trunk.trunk_conv, t)
    for i in range(model.num_upsample):
        fea = conv_nhwc(getattr(model, f"upconv_{i}"), fea)
        fea = pixel_shuffle(F.leaky_relu(fea, 0.01), 2)
    fea = F.leaky_relu(conv_nhwc(model.HRconv, fea), 0.2)
    return torch.clamp(conv_nhwc(model.conv_last, fea), 0.0, 1.0)


def phase_serve(tmp: Path) -> dict:
    from xmm_superres_denoise_torch.config import load_run_config
    from xmm_superres_denoise_torch.infer.run_file import (
        InferenceEngine,
        load_rate_image,
        serve_files,
    )
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.utils.weights import params_from_flax

    files = _write_inputs(tmp)
    ds_cfg, model_cfg = load_run_config(ROOT / "res/configs/runs/esr_gen_sr.toml")
    params = params_from_flax(ROOT / "docs/convergence_esr_gen/best_params.npz")
    hr_max = ds_cfg.hr.clamp_max
    n_batches = math.ceil(SERVE_FILES / SERVE_BATCH)
    expected_launches = n_batches * model_cfg.model.residual_blocks * 3 * 5
    preds, launches, engines = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        t0 = time.perf_counter()
        engine = InferenceEngine(model_cfg, ds_cfg, params, dtype=dtype)
        out = tmp / name
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense_block.launches = 0
        products = serve_files(files, engine, out, hr_exp_ks=100.0, model_name="esr_gen",
                               batch_size=SERVE_BATCH)
        torch.cuda.synchronize()
        launches[name] = dense_block.launches
        serve_s = time.perf_counter() - t1
        stack = []
        for p_in, p_pred in products:
            pred, _ = read_image(p_pred)
            inp, _ = read_image(p_in)
            if pred.shape != (832, 832) or inp.shape != (416, 416):
                raise AssertionError(f"{name}: product shapes {pred.shape}, {inp.shape}")
            if not (np.isfinite(pred).all() and np.isfinite(inp).all()):
                raise AssertionError(f"{name}: non-finite values in {p_pred.name}")
            stack.append(pred)
        preds[name] = np.stack(stack)
        say(
            f"[serve] {name}: {SERVE_FILES} files in {serve_s:.3f} s "
            f"({SERVE_FILES / serve_s:.2f} images/s incl. FITS read+write), "
            f"dense_block launches {launches[name]} (expected {expected_launches}), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"pred range [{preds[name].min():.3e}, {preds[name].max():.3e}] "
            f"({time.perf_counter() - t0:.2f} s)"
        )
        if launches[name] != expected_launches:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {expected_launches}")
        engines[name] = engine

    # the engine alone on the same images, warm: the serve time less FITS I/O
    raw = np.stack([load_rate_image(f)[0] for f in files])
    engine_ms = {}
    for name, engine in engines.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_tiles(raw, batch_size=SERVE_BATCH)
        torch.cuda.synchronize()
        engine_ms[name] = (time.perf_counter() - t0) * 1e3 / SERVE_FILES
    say(
        "[serve] engine alone (run_tiles, warm, host clock incl. transfers): "
        + ", ".join(f"{k} {v:.3f} ms/image" for k, v in engine_ms.items())
    )

    # reference: the same f32 model on the card with the plain dense block
    t0 = time.perf_counter()
    f32_engine = engines["f32"]
    with torch.inference_mode(), true_f32():
        x = f32_engine.prepare(torch.from_numpy(raw).to("cuda:0"))
        ref = f32_engine.normalizer.denormalize_hr(plain_forward(f32_engine.model, x))
        ref = ref[..., 0].cpu().numpy()
    err32 = float(np.abs(preds["f32"] - ref).max())
    err16 = float(np.abs(preds["bf16"] - ref).max())
    mse16 = float(np.mean(((preds["bf16"] - ref) / hr_max) ** 2))
    say(
        f"[serve] f32 products vs plain-block forward: max|diff| {err32:.3e} "
        f"= {err32 / hr_max:.3e} x hr_max (tol {SERVE_F32_RTOL:.0e}); bf16 products "
        f"vs it: max|diff| {err16 / hr_max:.3e} x hr_max (tol {SERVE_BF16_RTOL}), "
        f"PSNR {10 * np.log10(1.0 / max(mse16, 1e-30)):.2f} dB on the hr_max scale "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if not err32 <= SERVE_F32_RTOL * hr_max:
        raise AssertionError(f"f32 serve disagrees with the plain forward: {err32}")
    if not err16 <= SERVE_BF16_RTOL * hr_max:
        raise AssertionError(f"bf16 serve too far from f32: {err16}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    try:
        t_start = time.perf_counter()
        device = phase_device()
        phase_build()
        kernels = [phase_kernel(torch.float32), phase_kernel(torch.bfloat16)]
        with tempfile.TemporaryDirectory(prefix="xmmsr_chip_smoke_") as tmp:
            launches = phase_serve(Path(tmp))
        for entry, name in zip(kernels, ("f32", "bf16")):
            entry["launches"] = launches[name]
        say(f"[done] {time.perf_counter() - t_start:.2f} s")
        say(json.dumps({"kernels": kernels}))
        say(json.dumps({"ok": True, "device": device}))
    finally:
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
