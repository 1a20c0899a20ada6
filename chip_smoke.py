#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`xmm_superres_denoise_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result and its seconds:

1. device: the card's name and power limit (nvidia-smi) and what PyTorch sees;
2. build: the four kernel libraries compiled with nvcc for sm_90a, all at
   once (ptxas reports): K2 dense_block, K1 dense_block_s2d, P int8_gemm,
   K3 conv_i8;
3. kernel: each kernel held against its plain PyTorch version at the shapes
   the main paths give it, and timed with CUDA events beside the plain
   version, a library call where one computes the same function, and its
   bound: K2 at (2, 416, 416, 32) and K1 at (2, 208, 208, 128) in f32 (TF32
   off) and bf16, with K2 also held on K1's inputs (C = 128, the fast
   forward's shape; bf16 K2 runs K1's wgmma level there, and the bf16 line
   adds that level's share of its bound and its ptxas report; the f32 lines
   add the FFMA level's TFLOP/s, share of its bound, time at one full round
   of tiles, ptxas report and shared memory); P at the
   probe's (2048, 128) x (128, 128), exact, also timed on the device alone
   (torch.profiler) beside torch._int_mm, with the host time per call; K3
   raw (exact int32 sums) and fused (the int8 forward's epilogue inside,
   bf16, bitwise equal to its plain composition in bf16 and f32) at the int8
   forward's shapes: dense level 1 (codes into the concat), level 5
   (residual; alone, and with the codes of the next block's input beside
   it), conv_first and trunk_conv (with codes beside), upconv and HRconv, with
   the route each took (s8 wgmma or mma.sync), TOP/s, share of the bound
   and the route's ptxas report and shared memory;
4. serve: 4 synthetic Poisson detxy FITS (403x411, so padding is exercised)
   served by `serve_files` through `InferenceEngine` at full esr_gen width and
   depth (416^2 -> 832^2) with the trained weights, in f32 and in bf16. The
   launch count is reset just before each run and read just after; the f32
   products are held against a forward on the card through the plain dense
   block, called explicitly here;
5. s2d: the same 4 prepared tiles through `make_s2d_sr_forward` (dense
   blocks on K1) and `make_fast_rrdb_forward` (on K2) in f32 and bf16, at
   batch 2, against that plain forward; and `make_s2d_dn_forward` at 416^2
   with seeded weights against the plain DN forward;
6. serve-int8: the same 4 files served through `InferenceEngine(quantize=
   True)` in bf16 (int8 convolutions on K3, P's exactness check at build),
   held to the 40 dB int8 gate against the f32 plain forward;
7. cli: the command line (`xmm_superres_denoise_torch.cli`) serving the
   same 4 files with the run config and the trained checkpoint: `serve
   --bf16` in-process, bitwise equal to [serve]'s bf16 products; `serve
   --int8 --bf16 --int8_scales` twice with one fresh scales path, the first
   run calibrating and writing {"fingerprint", "scales"}, the second loading
   it without calibrating (calls of calibrate_int8_scales counted), both
   bitwise equal to [serve-int8]'s products and at the 40 dB gate; and one
   `python -m ... infer --bf16` subprocess, bitwise equal to `infer_file`
   in-process;
8. http: `run_http_server` on 127.0.0.1 (a free port) in a thread over the
   bf16 engine: each file POSTed, each response bitwise equal to
   `infer_file`'s prediction, then /stats, then the stop event;
9. eval: a synthetic simulated dataset tree (80 base names at the
   detector's geometry, AGN and background sets, written with the port's
   FITS codec) through `XmmDataModule` (the run config's dataset section,
   on cuda:0): the val loader's batch of 8 at 416^2 -> 832^2 through the
   f32 model (K2) and `make_eval_step` with the core and extended metric
   collections and their `in:` input-baseline twins, held to the same
   collections computed on the CPU in float64 from the card's own
   predictions; ms per batch for the forward, the core and the extended
   metrics, and the loader's host ms per batch;
10. loss: the esr_gen_sr run config's composite loss (psnr 0.5 + ms_ssim 0.5,
   sqrt table) on a seeded (8, 832, 832, 1) pair, value and d loss / d preds
   on the card (TF32 off) against float64 on the CPU, and the warm
   forward+backward time;
11. grad: one forward+backward of the full-width SR model (trained
   weights, f32, TF32 off, the run config's loss, batch 1 at 416^2 ->
   832^2, or 128^2 when the CPU reference would take over a minute) on the
   card, its dense blocks through `dense_block`'s autograd route (K2
   forward, recomputed backward), held parameter group by group to the same
   on the CPU model; one bf16 forward+backward; the inference-only
   `dense_block_s2d` and `conv_i8` refusing a gradient;
12. profile: one warm batch of each serving mode (model f32 and bf16, S2D
   f32 and bf16, fast f32 and bf16, int8) traced with torch.profiler:
   device-busy time per image, idle share, and busy time by kernel group;
   a trace that lost some of the port's kernel launches is taken again;
   for int8 also its elementwise launches per batch and K3's time against
   the forward's int8 operations at the published peak.

The last two lines are a `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Any failure exits non-zero. Without a CUDA
card it exits non-zero at once and prints no result. All products go to a
temporary directory; the only files written inside the checkout are the
kernel libraries under build/torch_kernels/.
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
S2D_SHAPE = (2, 208, 208, 128)  # the S2D trunk's dense-block input when serving
# 11 x 12 tiles of 16 x 16 px = 132 blocks, one per SM: the bf16 level with no
# partial last wave (S2D_SHAPE has 338 tiles, 2.56 waves)
ONE_WAVE_SHAPE = (1, 176, 192, 128)
# the f32 level's tiles (conv3x3_f32.cuh: 10 x 16 px at C = 32, four blocks
# per SM; 14 x 16 px at C = 128, one block per SM) in exactly one round on
# 132 SMs: 24 x 22 = 528 and 12 x 11 = 132 tiles
F32_ROUND_SHAPES = {32: (1, 240, 352, 32), 128: (1, 168, 176, 128)}
F32_SOURCE = "xmm_superres_denoise_torch/csrc/conv3x3_f32.cuh"  # K2's and K1's f32 level
# K3 at the int8 forward's shapes (S2D domain, batch 2): name -> (input
# shape, Cout, the concat group its codes go to or None, LeakyReLU slope,
# residual scale, requantises, writes its values); group 0 is the first
# group of a fresh concat (the next dense block's, or upconv's, input);
# level 5 without codes (a dense block that ends its RRDB) carries the JSON
# entries
K3_SHAPES = {
    "level5": ((2, 208, 208, 640), 128, None, None, 0.2, False, True),
    "level5+codes": ((2, 208, 208, 640), 128, 0, None, 0.2, True, True),
    "level1": ((2, 208, 208, 128), 128, 1, 0.2, None, True, False),
    "conv_first+codes": ((2, 208, 208, 4), 128, 0, None, None, True, True),
    "trunk_conv+codes": ((2, 208, 208, 128), 128, 0, None, 1.0, True, True),
    "upconv": ((2, 208, 208, 128), 512, None, 0.01, None, False, True),
    "hrconv": ((2, 416, 416, 128), 128, None, 0.2, None, False, True),
}
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
PEAK_BYTES_PER_S = 3.35e12
# tolerances of kernel vs plain version: f32 sums in another order (TF32 off);
# bf16 rounds each level's activations to bf16 in both, so a few bf16 ulps
F32_ATOL = 1e-4
BF16_ULPS = 4 * 2.0**-8
# served f32 predictions vs the plain-block forward, relative to hr clamp_max
SERVE_F32_RTOL = 2e-5
# served bf16 predictions vs the f32 plain forward, relative to hr clamp_max:
# 4 bf16 ulps at the top of the range
SERVE_BF16_RTOL = 4 * 2.0**-8
# int8 products vs the f32 plain forward: the JAX package's gate
INT8_PSNR_DB = 40.0
# the S2D DN forward (f32, seeded weights) vs the plain DN forward, [0, 1] scale
DN_ATOL = 2e-5
RUN_CONFIG = ROOT / "res/configs/runs/esr_gen_sr.toml"
CHECKPOINT = ROOT / "docs/convergence_esr_gen/best_params.npz"
# the composite loss on the card (TF32 off) vs float64 on the CPU
LOSS_RTOL = 1e-5  # value, relative
LOSS_GRAD_RTOL = 1e-4  # gradient, relative to max|grad|
TIMING_BUDGET_MS = 1000.0  # per timed function, after its first call


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


def phase_build() -> dict:
    """Build every kernel library at once; returns each one's compiler log."""
    from xmm_superres_denoise_torch.ops import cuda_build

    t0 = time.perf_counter()
    say(f"[build] nvcc {' '.join(cuda_build.NVCC_FLAGS)}, {len(cuda_build.LIBRARIES)} "
        "libraries at once")
    logs = {}
    with ThreadPoolExecutor(len(cuda_build.LIBRARIES)) as pool:
        builds = {n: pool.submit(cuda_build.build, n) for n in cuda_build.LIBRARIES}
    for name, fut in builds.items():
        lib, logs[name], secs = fut.result()
        say(f"[build] {name} -> {lib.name} ({secs:.2f} s)")
        for line in logs[name].splitlines():
            if line.strip():
                say(f"[build]   {line.strip()}")
    say(f"[build] all ({time.perf_counter() - t0:.2f} s)")
    return logs


def _ptxas_report(log: str, kernel: str) -> str:
    """Registers and spills of the entry `kernel` from a `-Xptxas -v` log."""
    m = re.search(
        rf"Function properties for \S*{kernel}\S*\s+\d+ bytes stack frame, (\d+) bytes spill "
        rf"stores, (\d+) bytes spill loads\s+ptxas info\s*: Used (\d+) registers", log)
    if m is None:
        return f"no ptxas report for {kernel}"
    return (f"{m.group(3)} registers at launch, {m.group(1)} B spill stores, "
            f"{m.group(2)} B spill loads")


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
    """Mean CUDA-event time of up to `iters` calls after `warmup` calls; a
    call slower than TIMING_BUDGET_MS / iters is timed fewer times (at
    least twice) so the slow plain versions stay within the smoke's time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    if first * iters > TIMING_BUDGET_MS:
        warmup, iters = 0, max(2, int(TIMING_BUDGET_MS / first))
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _five_launch_bytes(shape, esize: int) -> int:
    """Bytes the five level launches move through device memory: x copied
    into the concat buffer (read and write), level k reading its k*C prefix
    and writing C channels, level 5 also reading x for the residual."""
    b, h, w, c = shape
    per_pixel = 2 * c + sum(k * c + c for k in range(1, 6)) + c
    return b * h * w * per_pixel * esize


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    """(bound ms, "operations" or "bytes") at the published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _f32_level(build_logs: dict, c: int, ms: float, flops: float, bound_ms: float) -> str:
    """What an f32 `[kernel]` line adds about the FFMA level at width `c`,
    timed at `ms` for `flops` against `bound_ms`: TFLOP/s and share of the
    bound, the time of one full round of its tiles (no partial last round),
    ptxas's report and the shared memory of a block."""
    from xmm_superres_denoise_torch.ops import cuda_build
    from xmm_superres_denoise_torch.ops.dense_block import _SIGNATURES, dense_block, pack_weights

    shape = F32_ROUND_SHAPES[c]
    x, ws = _block_inputs(shape, torch.float32, torch.device("cuda:0"))
    packed = pack_weights(ws[0::2], ws[1::2], torch.float32)
    with torch.inference_mode():
        round_ms = _time_ms(lambda: dense_block(x, packed), iters=10)
    round_flops = math.prod(shape[:3]) * 9 * c * c * sum(range(1, 6)) * 2
    round_bound_ms = round_flops / PEAK_FLOPS[torch.float32] * 1e3
    smem = cuda_build.library("dense_block", _SIGNATURES).dense_block_f32_smem_bytes(c)
    co = 128 if c % 128 == 0 else 32
    return (
        f"; the FFMA level (conv3x3_f32_kernel<{co}>) runs at "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {bound_ms / ms:.1%} of the bound; one full "
        f"round of tiles {shape}: {round_ms:.4f} ms, "
        f"{round_flops / (round_ms * 1e-3) / 1e12:.2f} TFLOP/s, {round_bound_ms / round_ms:.1%} "
        f"of its bound; ptxas: {_ptxas_report(build_logs['dense_block'], f'conv3x3_f32_kernelILi{co}E')}; "
        f"{smem} B of dynamic shared memory per block"
    )


def phase_kernel(dtype, build_logs: dict) -> dict:
    from xmm_superres_denoise_torch.ops.dense_block import (
        dense_block,
        dense_block_reference,
        pack_weights,
    )
    from xmm_superres_denoise_torch.ops.precision import true_f32

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    x, ws = _block_inputs(KERNEL_SHAPE, dtype, dev)
    packed = pack_weights(ws[0::2], ws[1::2], dtype)  # as the model keeps it
    b, h, w, c = KERNEL_SHAPE
    with torch.inference_mode(), true_f32():
        out = dense_block(x, packed)
        ref = dense_block_reference(x, *ws)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ULPS * scale
        finite = bool(torch.isfinite(out).all())
        ms = _time_ms(lambda: dense_block(x, packed))
        plain_ms = _time_ms(lambda: dense_block_reference(x, *ws))
        x_nchw = x.permute(0, 3, 1, 2)
        oihw = [wk.permute(3, 2, 0, 1).contiguous() for wk in ws[0::2]]
        lib_out = _library_block(x_nchw, oihw, ws[1::2])
        lib_err = (lib_out.permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
        library_ms = _time_ms(lambda: _library_block(x_nchw, oihw, ws[1::2]))
    esize = x.element_size()
    flops = b * h * w * 9 * c * c * sum(range(1, 6)) * 2
    nbytes = esize * (2 * x.numel() + sum(t.numel() for t in ws))
    bound_ms, bound_by = _bound(flops, nbytes, dtype)
    name = "f32" if dtype == torch.float32 else "bf16"
    level = _f32_level(build_logs, c, ms, flops, bound_ms) if dtype == torch.float32 else ""
    say(
        f"[kernel] dense_block {name} {KERNEL_SHAPE}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}, max|plain| {scale:.3f}), max|cudnn-plain| {lib_err:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cudnn {library_ms:.4f} ms, "
        f"kernel/cudnn {ms / library_ms:.2f}, bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; five-launch traffic "
        f"{_five_launch_bytes(KERNEL_SHAPE, x.element_size()) / 1e9:.3f} GB, "
        f"{_five_launch_bytes(KERNEL_SHAPE, x.element_size()) / PEAK_BYTES_PER_S * 1e3:.4f} ms "
        f"at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s){level} ({time.perf_counter() - t0:.2f} s)"
    )
    if not finite or not err <= tol:
        raise AssertionError(f"dense_block {name} disagrees with its plain version: {err} > {tol}")
    return {
        "name": f"dense_block[{name}]",
        "route": "cuda",
        "source": F32_SOURCE if dtype == torch.float32 else "xmm_superres_denoise_torch/csrc/dense_block.cu",
        "replaces": "xmm_superres_denoise_tpu/ops/pallas_rrdb.py:141",
        "launches": None,  # filled from the serve run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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
    """The SR (or DN) generator's forward with every dense block on its
    plain version: the reference the served f32 predictions are held
    against."""
    from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, conv_nhwc, pixel_shuffle
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
    if isinstance(model, GeneratorRRDB_DN):
        return torch.clamp(conv_nhwc(model.conv_last, fea) + x, 0.0, 1.0)
    for i in range(model.num_upsample):
        fea = conv_nhwc(getattr(model, f"upconv_{i}"), fea)
        fea = pixel_shuffle(F.leaky_relu(fea, 0.01), 2)
    fea = F.leaky_relu(conv_nhwc(model.HRconv, fea), 0.2)
    return torch.clamp(conv_nhwc(model.conv_last, fea), 0.0, 1.0)


def phase_serve(tmp: Path):
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
    ctx = {"files": files, "raw": raw, "ref": ref, "hr_max": hr_max, "params": params,
           "engine": f32_engine, "ds_cfg": ds_cfg, "model_cfg": model_cfg,
           "preds": preds, "engines": engines,
           "profile": {f"model {k} (K2)": (e.predict, dense_block) for k, e in engines.items()}}
    return launches, ctx


def phase_kernel_s2d(dtype, build_logs: dict) -> dict:
    from xmm_superres_denoise_torch.ops import cuda_build
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.dense_block_s2d import (
        _SIGNATURES,
        dense_block_s2d,
        dense_block_s2d_reference,
        pack_weights,
    )
    from xmm_superres_denoise_torch.ops.precision import true_f32

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    x, flat = _block_inputs(S2D_SHAPE, dtype, dev)
    ws, bs = flat[0::2], flat[1::2]
    packed = pack_weights(ws, bs, dtype)
    b, h, w, c = S2D_SHAPE
    with torch.inference_mode(), true_f32():
        out = dense_block_s2d(x, packed)
        ref = dense_block_s2d_reference(x, ws, bs)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = F32_ATOL * max(1.0, scale) if dtype == torch.float32 else BF16_ULPS * scale
        finite = bool(torch.isfinite(out).all())
        # K2 at C = 128, as make_fast_rrdb_forward runs it, on the same inputs
        k2_out = dense_block(x, packed)
        k2_err = (k2_out.float() - ref.float()).abs().max().item()
        k2_finite = bool(torch.isfinite(k2_out).all())
        ms = _time_ms(lambda: dense_block_s2d(x, packed), iters=10)
        k2_ms = _time_ms(lambda: dense_block(x, packed), iters=10)
        plain_ms = _time_ms(lambda: dense_block_s2d_reference(x, ws, bs), iters=5, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)
        oihw = [wk.permute(3, 2, 0, 1).contiguous() for wk in ws]
        lib_err = (_library_block(x_nchw, oihw, bs).permute(0, 2, 3, 1).float()
                   - ref.float()).abs().max().item()
        library_ms = _time_ms(lambda: _library_block(x_nchw, oihw, bs), iters=10)
    flops = b * h * w * 9 * c * c * sum(range(1, 6)) * 2  # as computed, S2D zeros included
    nominal = flops / 4  # the 416^2 x 32 block it stands for
    nbytes = x.element_size() * (2 * x.numel() + sum(t.numel() for t in flat))
    bound_ms, bound_by = _bound(flops, nbytes, dtype)
    name = "f32" if dtype == torch.float32 else "bf16"
    level = ""
    if dtype == torch.bfloat16:
        smem = cuda_build.library("dense_block_s2d", _SIGNATURES).dense_block_s2d_smem_bytes()
        xw, fw = _block_inputs(ONE_WAVE_SHAPE, dtype, dev)
        pw = pack_weights(fw[0::2], fw[1::2], dtype)
        with torch.inference_mode():
            wave_ms = _time_ms(lambda: dense_block_s2d(xw, pw, h_strip=16, w_tile=16), iters=10)
        wave_flops = flops * math.prod(ONE_WAVE_SHAPE) / math.prod(S2D_SHAPE)
        level = (
            f"; the wgmma level (conv3x3_wgmma_kernel) reaches {bound_ms / ms:.1%} of the bound "
            f"(K2 at C=128 {bound_ms / k2_ms:.1%}); one full wave {ONE_WAVE_SHAPE} (132 tiles): "
            f"{wave_ms:.4f} ms, {wave_flops / (wave_ms * 1e-3) / 1e12:.2f} TFLOP/s, against "
            f"{flops / (ms * 1e-3) / 1e12:.2f} at 338 tiles (2.56 waves); ptxas: "
            f"{_ptxas_report(build_logs['dense_block_s2d'], 'conv3x3_wgmma_kernel')}; "
            f"{smem} B of dynamic shared memory per block"
        )
    else:
        level = (_f32_level(build_logs, c, ms, flops, bound_ms)
                 + f"; K2 at C=128, the same level: {flops / (k2_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                 f"{bound_ms / k2_ms:.1%} of the bound")
    say(
        f"[kernel] dense_block_s2d {name} {S2D_SHAPE}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}, max|plain| {scale:.3f}), max|cudnn-plain| {lib_err:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cudnn {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP as computed, {nominal / 1e9:.1f} "
        f"nominal, {nbytes / 1e6:.1f} MB; achieved {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"S2D, {nominal / (ms * 1e-3) / 1e12:.2f} TFLOP/s nominal); dense_block (K2, the fast "
        f"forward's block) on the same inputs: max|kernel-plain| {k2_err:.3e} (same tol), "
        f"K2 {k2_ms:.4f} ms beside K1 {ms:.4f} ms, K1/cudnn {ms / library_ms:.2f}, K2/cudnn "
        f"{k2_ms / library_ms:.2f}{level} ({time.perf_counter() - t0:.2f} s)"
    )
    if not finite or not err <= tol:
        raise AssertionError(f"dense_block_s2d {name} disagrees with its plain version: {err} > {tol}")
    if not k2_finite or not k2_err <= tol:
        raise AssertionError(f"dense_block {name} at C=128 disagrees with the plain version: "
                             f"{k2_err} > {tol}")
    f32 = dtype == torch.float32
    k2_entry = {
        "name": f"dense_block[{name},C=128]",
        "route": "cuda",
        "source": F32_SOURCE if f32 else "xmm_superres_denoise_torch/csrc/dense_block.cu",
        "replaces": "xmm_superres_denoise_tpu/ops/pallas_rrdb.py:141",
        "launches": None,  # filled from the fast forward's run
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": plain_ms,  # the same function's plain version, same inputs
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    return {
        "name": f"dense_block_s2d[{name}]",
        "route": "cuda",
        "source": F32_SOURCE if f32 else "xmm_superres_denoise_torch/csrc/dense_block_s2d.cu",
        "replaces": "xmm_superres_denoise_tpu/ops/pallas_dense_block.py:158",
        "launches": None,  # filled from the s2d run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, k2_entry


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device time of the kernels one call launches: torch.profiler
    over `iters` warm calls, the kernels' own durations summed (no launch
    gaps, no host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no CUDA kernel")
    return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


def _host_us(fn, iters: int = 200) -> float:
    """Host time per call while enqueueing `iters` calls back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def phase_kernel_p() -> dict:
    from xmm_superres_denoise_torch.ops.int8_gemm import (
        PROBE_SHAPE,
        int8_gemm,
        int8_gemm_reference,
        probe_operands,
    )

    t0 = time.perf_counter()
    a, b = probe_operands("cuda:0")
    m, k, n = PROBE_SHAPE
    out = int8_gemm(a, b).cpu()
    ref = int8_gemm_reference(a.cpu(), b.cpu())  # int64 on the host
    exact = torch.equal(out, ref) and torch.equal(int8_gemm_reference(a, b).cpu(), ref)
    err = float((out.long() - ref.long()).abs().max())
    ms = _time_ms(lambda: int8_gemm(a, b), iters=50)
    plain_ms = _time_ms(lambda: int8_gemm_reference(a, b), iters=50)
    try:
        lib = torch._int_mm(a, b)
        lib_mm = lambda: torch._int_mm(a, b)  # noqa: E731
    except RuntimeError:  # cuBLASLt wants the second operand column-major
        b_col = b.t().contiguous().t()
        lib = torch._int_mm(a, b_col)
        lib_mm = lambda: torch._int_mm(a, b_col)  # noqa: E731
    lib_exact = torch.equal(lib.cpu(), ref)
    library_ms = _time_ms(lib_mm, iters=50)
    dev_ms, lib_dev_ms = _device_ms(lambda: int8_gemm(a, b)), _device_ms(lib_mm)
    host_us, lib_host_us = _host_us(lambda: int8_gemm(a, b)), _host_us(lib_mm)
    flops = 2 * m * k * n
    nbytes = m * k + k * n + 4 * m * n
    bound_ms, bound_by = _bound(flops, nbytes, torch.int8)
    say(
        f"[kernel] int8_gemm {tuple(a.shape)} x {tuple(b.shape)}: exact {exact} (max|diff| "
        f"{err:.0f}), torch._int_mm exact {lib_exact}; CUDA events over 50 back-to-back calls: "
        f"kernel {ms:.4f} ms, plain (f64 matmul on the card) {plain_ms:.4f} ms, torch._int_mm "
        f"{library_ms:.4f} ms; device only (torch.profiler, 20 warm calls): kernel "
        f"{dev_ms * 1e3:.2f} us, torch._int_mm {lib_dev_ms * 1e3:.2f} us; host per call while "
        f"enqueueing: kernel {host_us:.2f} us, torch._int_mm {lib_host_us:.2f} us; bound "
        f"{bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} G int8 ops) "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if not exact:
        raise AssertionError("int8_gemm sums are not exact")
    return {
        "name": "int8_gemm",
        "route": "cuda",
        "source": "xmm_superres_denoise_torch/csrc/int8_gemm.cu",
        "replaces": "scripts/device_probe_pallas_int8.py:24",
        "launches": None,  # filled from the serve-int8 run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _k3_case(which: str, dev):
    """Seeded operands of one K3 shape: (x8, HWIO w8, packed, the f32 and
    bf16 epilogues, the bf16 and f32 residuals or None, the concat slice
    the codes go to or None)."""
    from xmm_superres_denoise_torch.ops.conv_i8 import Epilogue, pack_weights

    shape, cout, level, slope, res_scale, requant, values = K3_SHAPES[which]
    g = np.random.default_rng(len(which))
    b, h, w, cin = shape
    x8 = torch.from_numpy(g.integers(-127, 128, shape).astype(np.int8)).to(dev)
    codes = None
    if level is not None:  # a concat buffer: x8 its prefix (level > 0), the codes a slice
        buf = torch.full((b, h, w, 5 * cout), -128, dtype=torch.int8, device=dev)
        if level:
            buf[..., :cin] = x8
            x8 = buf[..., :cin]
        codes = buf[..., level * cout : (level + 1) * cout]
    w8 = torch.from_numpy(g.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)).to(dev)
    c_o = torch.from_numpy((g.uniform(0.5, 2.0, cout) / (np.sqrt(9 * cin) * 73.0**2))
                           .astype(np.float32)).to(dev)
    bias = torch.from_numpy((g.normal(size=cout) * 0.1).astype(np.float32)).to(dev)
    qscale = float(g.uniform(2.0, 4.0)) if requant else None
    epis = {dt: Epilogue(c_o, bias, dt, slope=slope, res_scale=res_scale, qscale=qscale,
                         values=values) for dt in (torch.float32, torch.bfloat16)}
    res = {dt: None for dt in epis}
    if res_scale is not None:
        r = torch.from_numpy(g.normal(size=(b, h, w, cout)).astype(np.float32)).to(dev)
        res = {dt: r.to(dt) for dt in epis}
    return x8, w8, pack_weights(w8, dev), epis, res, codes


def phase_kernel_k3(build_logs: dict) -> tuple:
    """K3 raw and fused at each of K3_SHAPES; returns the raw and the fused
    JSON entries of level 5."""
    from xmm_superres_denoise_torch.ops import cuda_build
    from xmm_superres_denoise_torch.ops.conv_i8 import (
        _SIGNATURES,
        conv_i8,
        conv_i8_reference,
        route,
    )

    dev = torch.device("cuda:0")
    lib = cuda_build.library("conv_i8", _SIGNATURES)
    entries = {}
    for which, (shape, cout, level, slope, res_scale, requant, values) in K3_SHAPES.items():
        t0 = time.perf_counter()
        x8, w8, packed, epis, res, codes = _k3_case(which, dev)
        b, h, w, cin = shape
        cin_k = packed.kernel.shape[2]
        path = route(cin)
        if path != ("wgmma" if lib.conv_i8_wgmma_route(cin_k) else "mma.sync"):
            raise AssertionError(f"conv_i8 {which}: the wrapper's route {path} is not the kernel's")
        # raw: the exact int32 sums
        out = conv_i8(x8, packed)
        ref = conv_i8_reference(x8, w8)  # float64 on the card, exact
        err = float((out.long() - ref.long()).abs().max())
        exact = torch.equal(out, ref)
        ms = _time_ms(lambda: conv_i8(x8, packed), iters=20)
        plain_ms = _time_ms(lambda: conv_i8_reference(x8, w8), iters=3, warmup=1)
        # fused, in both epilogue dtypes, against the plain composition
        same, fused_err = {}, {}
        for dt, epi in epis.items():
            want = epi.apply(ref, res[dt])
            got = conv_i8(x8, packed, epi, residual=res[dt], codes=codes)
            pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
            same[dt] = all(torch.equal(a, b) for a, b in pairs)
            fused_err[dt] = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        epi, r = epis[torch.bfloat16], res[torch.bfloat16]
        fused = lambda: conv_i8(x8, packed, epi, residual=r, codes=codes)  # noqa: E731
        fused_ms = _time_ms(fused, iters=20)
        fused_plain_ms = _time_ms(lambda: epi.apply(conv_i8_reference(x8, w8), r),
                                  iters=3, warmup=1)
        flops = 2 * b * h * w * 9 * cin * cout
        nbytes = x8.numel() + w8.numel() + 4 * b * h * w * cout
        bound_ms, bound_by = _bound(flops, nbytes, torch.int8)
        out_esize = (1 if requant else 0) + (2 if values else 0)  # codes, bf16 values
        fused_bytes = (x8.numel() + w8.numel() + 8 * cout + b * h * w * cout * out_esize
                       + (2 * b * h * w * cout if res_scale is not None else 0))
        fused_bound_ms, fused_by = _bound(flops, fused_bytes, torch.int8)
        kernel = "conv3x3_wgmma_kernel" if path == "wgmma" else "conv3x3_kernel"
        say(
            f"[kernel] conv_i8 {which} {shape} -> {cout} on the {path} route: raw exact {exact} "
            f"(max|diff| {err:.0f}, max|sum| {int(ref.abs().max())}), {ms:.4f} ms, "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TOP/s, {bound_ms / ms:.1%} of its bound "
            f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} G int8 ops, {nbytes / 1e6:.1f} MB), "
            f"plain (f64 conv) {plain_ms:.4f} ms; fused (bf16 epilogue"
            f"{', LeakyReLU ' + str(slope) if slope else ''}"
            f"{', residual x' + str(res_scale) if res_scale else ''}"
            f"{', int8 codes into concat group ' + str(level) if requant else ''}"
            f"{'' if values else ', no values'}) bitwise equal to "
            f"its plain composition: bf16 {same[torch.bfloat16]}, f32 {same[torch.float32]}; "
            f"{fused_ms:.4f} ms, {flops / (fused_ms * 1e-3) / 1e12:.1f} TOP/s, "
            f"{fused_bound_ms / fused_ms:.1%} of its bound {fused_bound_ms:.4f} ms by {fused_by} "
            f"({fused_bytes / 1e6:.1f} MB), plain composition {fused_plain_ms:.4f} ms; ptxas: "
            f"{_ptxas_report(build_logs['conv_i8'], kernel)}, {lib.conv_i8_smem_bytes(cin_k)} B of "
            f"dynamic shared memory per block; no PyTorch call computes an s8 convolution "
            f"({time.perf_counter() - t0:.2f} s)"
        )
        if not exact:
            raise AssertionError(f"conv_i8 {which} sums are not exact")
        if not all(same.values()):
            raise AssertionError(f"conv_i8 {which} fused epilogue differs from its plain version")
        if which == "level5":
            common = {"route": "cuda", "source": "xmm_superres_denoise_torch/csrc/conv_i8.cu",
                      "replaces": "xmm_superres_denoise_tpu/ops/int8_forward.py:125",
                      "launches": None, "library_ms": None}  # launches: from serve-int8
            entries["raw"] = {"name": "conv_i8", **common, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            entries["fused"] = {"name": "conv_i8[fused]", **common,
                                "max_abs_err": fused_err[torch.bfloat16],
                                "ms": fused_ms, "plain_ms": fused_plain_ms,
                                "bound_ms": fused_bound_ms, "bound_by": fused_by}
    return entries["raw"], entries["fused"]


def _k3_forward_ops(b: int, h: int, w: int, blocks: int, group: int) -> int:
    """int8 operations of K3's 64 convolutions in one int8 SR forward of a
    batch of b, S2D domain h x w (conv_first over its 4 true channels)."""
    def conv(hh, ww, cin, cout):
        return 2 * b * hh * ww * 9 * cin * cout

    return (conv(h, w, 4, group)
            + 3 * blocks * sum(conv(h, w, k * group, group) for k in range(1, 6))
            + conv(h, w, group, group)            # trunk_conv
            + conv(h, w, group, 4 * group)        # upconv
            + conv(2 * h, 2 * w, group, group))   # HRconv, after d2s


def _batched(fwd, x):
    return torch.cat([fwd(x[i : i + SERVE_BATCH]) for i in range(0, len(x), SERVE_BATCH)])


def _forward_ms(fwd, x) -> float:
    """CUDA-event time of one warm batch, per image."""
    batch = x[:SERVE_BATCH]
    return _time_ms(lambda: fwd(batch), iters=3, warmup=1) / SERVE_BATCH


def phase_s2d(ctx) -> dict:
    from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
    from xmm_superres_denoise_torch.ops.dense_block import dense_block, make_fast_rrdb_forward
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_dn_forward, make_s2d_sr_forward

    dev = torch.device("cuda:0")
    engine, hr_max, ref = ctx["engine"], ctx["hr_max"], ctx["ref"]
    model = GeneratorRRDB_SR()
    params = ROOT / "docs/convergence_esr_gen/best_params.npz"
    n_batches = math.ceil(SERVE_FILES / SERVE_BATCH)
    launches = {}
    with torch.inference_mode():
        x = engine.prepare(torch.from_numpy(ctx["raw"]).to(dev))
        for make, counter, label in ((make_s2d_sr_forward, dense_block_s2d, "s2d"),
                                     (make_fast_rrdb_forward, dense_block, "fast")):
            for dtype in (torch.float32, torch.bfloat16):
                t0 = time.perf_counter()
                name = "f32" if dtype == torch.float32 else "bf16"
                fwd = make(model, params, dtype, device=dev)
                torch.cuda.synchronize()
                counter.launches = 0
                pred = _batched(fwd, x)
                torch.cuda.synchronize()
                n = counter.launches
                pred = engine.normalizer.denormalize_hr(pred.float().clamp(0, 1))[..., 0].cpu().numpy()
                err = float(np.abs(pred - ref).max())
                mse = float(np.mean(((pred - ref) / hr_max) ** 2))
                ms = _forward_ms(fwd, x)
                say(
                    f"[s2d] {label} SR {name}: {n} {counter.__name__} launches for {n_batches} "
                    f"batches of {SERVE_BATCH} (expected {60 * n_batches}); vs plain-block "
                    f"forward max|diff| {err / hr_max:.3e} x hr_max, PSNR "
                    f"{10 * np.log10(1.0 / max(mse, 1e-30)):.2f} dB; {ms:.3f} ms/image "
                    f"(CUDA events, warm batch) ({time.perf_counter() - t0:.2f} s)"
                )
                tol = SERVE_F32_RTOL if dtype == torch.float32 else SERVE_BF16_RTOL
                if n != 60 * n_batches:
                    raise AssertionError(f"{label} {name}: {n} launches, expected {60 * n_batches}")
                if not (np.isfinite(pred).all() and err <= tol * hr_max):
                    raise AssertionError(f"{label} {name} forward too far from the plain forward: {err}")
                launches[f"{label} {name}"] = n
                ctx["profile"][f"{label} {name} ({'K1' if label == 's2d' else 'K2'})"] = (fwd, counter)

        t0 = time.perf_counter()
        dn = GeneratorRRDB_DN()
        dn.reset_parameters(torch.Generator().manual_seed(0))
        fwd = make_s2d_dn_forward(dn, dn.state_dict(), torch.float32, device=dev)
        dn = dn.to(dev)
        dense_block_s2d.launches = 0
        got = _batched(fwd, x)
        n = dense_block_s2d.launches
        with true_f32():
            want = _batched(lambda t: plain_forward(dn, t), x)
        err = (got - want).abs().max().item()
        say(
            f"[s2d] S2D DN f32 416^2 -> 416^2, seeded weights: {n} dense_block_s2d launches; "
            f"vs plain DN forward max|diff| {err:.3e} on [0, 1] (tol {DN_ATOL:.0e}) "
            f"({time.perf_counter() - t0:.2f} s)"
        )
        if n != 60 * n_batches or not err <= DN_ATOL:
            raise AssertionError(f"S2D DN forward: {n} launches, max|diff| {err}")
    return launches


def phase_serve_int8(ctx, tmp: Path) -> dict:
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, serve_files
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8
    from xmm_superres_denoise_torch.ops.int8_gemm import int8_gemm

    t0 = time.perf_counter()
    hr_max, ref = ctx["hr_max"], ctx["ref"]
    n_batches = math.ceil(SERVE_FILES / SERVE_BATCH)
    expected = 64 * n_batches
    engine = InferenceEngine(ctx["model_cfg"], ctx["ds_cfg"], ctx["params"], dtype=torch.bfloat16,
                             quantize=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    conv_i8.launches = int8_gemm.launches = 0
    products = serve_files(ctx["files"], engine, tmp / "int8", hr_exp_ks=100.0,
                           model_name="esr_gen", batch_size=SERVE_BATCH)
    torch.cuda.synchronize()
    launches = {"conv_i8": conv_i8.launches, "int8_gemm": int8_gemm.launches}
    serve_s = time.perf_counter() - t1
    pred = np.stack([read_image(p)[0] for _, p in products])
    mse = float(np.mean(((pred - ref) / hr_max) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    engine.run_tiles(ctx["raw"], batch_size=SERVE_BATCH)
    torch.cuda.synchronize()
    engine_ms = (time.perf_counter() - t2) * 1e3 / SERVE_FILES
    say(
        f"[serve-int8] bf16 epilogues: {SERVE_FILES} files in {serve_s:.3f} s incl. calibration "
        f"on the first batch and FITS read+write; conv_i8 launches {launches['conv_i8']} "
        f"(expected {expected}), int8_gemm launches {launches['int8_gemm']} (the exactness check "
        f"at build); {len(engine.int8_scales)} scale keys; products vs the f32 plain forward "
        f"max|diff| {np.abs(pred - ref).max() / hr_max:.3e} x hr_max, PSNR {psnr:.2f} dB on the "
        f"hr_max scale (gate {INT8_PSNR_DB:.0f} dB); engine alone (run_tiles, warm, host clock "
        f"incl. transfers) {engine_ms:.3f} ms/image ({time.perf_counter() - t0:.2f} s)"
    )
    if launches["conv_i8"] != expected or launches["int8_gemm"] < 1:
        raise AssertionError(f"int8 serve launches {launches}, expected {expected} conv_i8")
    if not (np.isfinite(pred).all() and pred.shape == ref.shape and psnr >= INT8_PSNR_DB):
        raise AssertionError(f"int8 serve below the gate: PSNR {psnr:.2f} dB")
    ctx["profile"]["int8 bf16 (K3)"] = (engine.predict, conv_i8)
    ctx["int8_scales"], ctx["int8_preds"] = engine.int8_scales, pred
    return launches


def _cli(argv) -> tuple:
    """The port's CLI `main(argv)` in-process: (exit code, the JSON of its
    last stdout line, seconds)."""
    from xmm_superres_denoise_torch.cli import main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), time.perf_counter() - t0


def _served(listing) -> np.ndarray:
    from xmm_superres_denoise_torch.io.fits import read_image

    return np.stack([read_image(p["prediction"])[0] for p in listing])


def _psnr(pred, ref, hr_max) -> float:
    return 10 * np.log10(1.0 / max(float(np.mean(((pred - ref) / hr_max) ** 2)), 1e-30))


def phase_cli(ctx, tmp: Path) -> None:
    from xmm_superres_denoise_torch.infer.run_file import infer_file
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
    from xmm_superres_denoise_torch.ops import int8_forward
    from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.utils.fingerprint import params_fingerprint
    from xmm_superres_denoise_torch.utils.weights import flax_tree, load_params_npz

    files, hr_max, ref = ctx["files"], ctx["hr_max"], ctx["ref"]
    common = ["--run_config", RUN_CONFIG, "--checkpoint", CHECKPOINT, "--batch", SERVE_BATCH]
    n_batches = math.ceil(SERVE_FILES / SERVE_BATCH)

    # 1. serve --bf16, in-process
    t0 = time.perf_counter()
    dense_block.launches = 0
    rc, listing, secs = _cli(["serve", *files, "--out", tmp / "cli_bf16", "--bf16", *common])
    launches = dense_block.launches
    if rc != 0 or len(listing) != SERVE_FILES:
        raise AssertionError(f"cli serve --bf16: exit code {rc}, {listing}")
    pred = _served(listing)
    same = bool(np.array_equal(pred, ctx["preds"]["bf16"]))
    say(
        f"[cli] serve --bf16: {SERVE_FILES} files in {secs:.3f} s ({SERVE_FILES / secs:.2f} "
        f"images/s incl. the engine's build and FITS read+write), dense_block launches "
        f"{launches} ({launches / n_batches:.0f} per batch, expected 60); products bitwise "
        f"equal to [serve]'s bf16: {same} ({time.perf_counter() - t0:.2f} s)"
    )
    if launches != 60 * n_batches or not same:
        raise AssertionError(f"cli serve --bf16: {launches} launches, bitwise equal {same}")

    # 2. serve --int8 twice with one fresh --int8_scales path
    t0 = time.perf_counter()
    scales_path = tmp / "int8_scales.json"
    real, calls = int8_forward.calibrate_int8_scales, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    int8_forward.calibrate_int8_scales = counted
    try:
        runs = []
        for i in range(2):
            n_before = len(calls)
            conv_i8.launches = 0
            rc, listing, secs = _cli(["serve", *files, "--out", tmp / f"cli_int8_{i}", "--int8",
                                      "--bf16", "--int8_scales", scales_path, *common])
            if rc != 0 or len(listing) != SERVE_FILES:
                raise AssertionError(f"cli serve --int8 run {i + 1}: exit code {rc}")
            runs.append((_served(listing), secs, len(calls) - n_before, conv_i8.launches))
    finally:
        int8_forward.calibrate_int8_scales = real
    saved = json.loads(scales_path.read_text())
    fingerprint = params_fingerprint(
        {"params": flax_tree(load_params_npz(CHECKPOINT, GeneratorRRDB_SR()))})
    psnrs = [_psnr(r[0], ref, hr_max) for r in runs]
    same = bool(np.array_equal(runs[0][0], runs[1][0]))
    as_engine = bool(np.array_equal(runs[0][0], ctx["int8_preds"]))
    theirs = ctx["int8_scales"]
    rel = max(abs(saved["scales"][k] - v) / v for k, v in theirs.items())
    say(
        f"[cli] serve --int8 --bf16 --int8_scales (fresh path), twice: run 1 {runs[0][1]:.3f} s with "
        f"{runs[0][2]} calibration(s), run 2 {runs[1][1]:.3f} s with {runs[1][2]} (the file "
        f"loaded); conv_i8 launches {runs[0][3]} / {runs[1][3]} (expected {64 * n_batches}); "
        f"the file holds {sorted(saved)} with {len(saved['scales'])} scales, fingerprint "
        f"{saved['fingerprint']} equal to utils/fingerprint.py on the npz: "
        f"{saved['fingerprint'] == fingerprint}; run 2 bitwise equal to run 1: {same}, run 1 to "
        f"[serve-int8]'s products: {as_engine}; PSNR vs "
        f"the f32 plain forward {psnrs[0]:.2f} / {psnrs[1]:.2f} dB (gate {INT8_PSNR_DB:.0f}); "
        f"scales equal to [serve-int8]'s engine's: {saved['scales'] == theirs} (max relative "
        f"difference {rel:.3e}) ({time.perf_counter() - t0:.2f} s)"
    )
    if (runs[0][2], runs[1][2]) != (1, 0) or set(saved) != {"fingerprint", "scales"}:
        raise AssertionError(f"cli int8: calibrations {runs[0][2]}, {runs[1][2]}; {set(saved)}")
    if saved["fingerprint"] != fingerprint or not same or not as_engine:
        raise AssertionError(f"cli int8: fingerprint {saved['fingerprint']}, runs equal {same}, "
                             f"equal to [serve-int8] {as_engine}")
    if min(psnrs) < INT8_PSNR_DB or any(r[3] != 64 * n_batches for r in runs):
        raise AssertionError(f"cli int8: PSNR {psnrs}, launches {[r[3] for r in runs]}")

    # 3. the module entry point in its own process
    t0 = time.perf_counter()
    out = tmp / "cli_subprocess"
    proc = subprocess.run(
        [sys.executable, "-m", "xmm_superres_denoise_torch.cli", "infer", "--bf16",
         "--fits", str(files[0]), "--out", str(out), "--run_config", str(RUN_CONFIG),
         "--checkpoint", str(CHECKPOINT)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise AssertionError(f"python -m ...cli infer --bf16: exit code {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    got = read_image(json.loads(proc.stdout.strip().splitlines()[-1])["prediction"])[0]
    _, p_pred = infer_file(files[0], ctx["engines"]["bf16"], tmp / "cli_inprocess", 100.0,
                           "esr_gen")
    same = bool(np.array_equal(got, read_image(p_pred)[0]))
    say(
        f"[cli] python -m xmm_superres_denoise_torch.cli infer --bf16 (own process): exit code "
        f"0, prediction {got.shape} bitwise equal to infer_file in-process: {same} "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if not same:
        raise AssertionError("cli infer subprocess differs from infer_file in-process")


def phase_http(ctx, tmp: Path) -> None:
    from xmm_superres_denoise_torch.infer.http_server import run_http_server
    from xmm_superres_denoise_torch.infer.run_file import infer_file
    from xmm_superres_denoise_torch.io.fits import read_image

    t0 = time.perf_counter()
    engine = ctx["engines"]["bf16"]
    stop, ready, bound = threading.Event(), threading.Event(), {}

    def on_bound(server):
        bound["server"] = server
        ready.set()

    thread = threading.Thread(
        target=run_http_server, args=("127.0.0.1", 0, engine),
        kwargs=dict(hr_exp_ks=100.0, model_name="esr_gen", stop=stop, on_bound=on_bound),
        daemon=True,
    )
    thread.start()
    try:
        if not ready.wait(60):
            raise AssertionError("http: the server did not start")
        url = f"http://127.0.0.1:{bound['server'].server_address[1]}"
        same = []
        for i, f in enumerate(ctx["files"]):
            req = urllib.request.Request(url + "/infer", data=Path(f).read_bytes(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = read_image(r.read())[0]
            _, p_pred = infer_file(f, engine, tmp / f"http_ref_{i}", 100.0, "esr_gen")
            same.append(bool(np.array_equal(got, read_image(p_pred)[0])))
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        stop.set()
        thread.join(timeout=30)
    lat = stats.get("latency_ms", {})
    say(
        f"[http] run_http_server on {url}, bf16 engine: {len(same)} POSTs, responses bitwise "
        f"equal to infer_file: {same}; /stats: {stats['requests']} requests, {stats['errors']} "
        f"errors, latency p50 {lat.get('p50')} ms, p90 {lat.get('p90')} ms (host clock, incl. "
        f"FITS decode and product write); stopped through its event: {not thread.is_alive()} "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if not all(same) or stats["requests"] != len(same) or stats["errors"] or thread.is_alive():
        raise AssertionError(f"http: bitwise {same}, stats {stats}, alive {thread.is_alive()}")


def _loss_pair(shape, seed=11):
    """A seeded target in [0, 1] (a coarse field, 8 x 8 px cells, plus noise)
    and a prediction of it with noise, float32 numpy."""
    g = np.random.default_rng(seed)
    b, h, w, c = shape
    coarse = g.uniform(0, 1, (b, h // 8, w // 8, c)).astype(np.float32)
    target = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    target = np.clip(target + 0.05 * g.standard_normal(shape, dtype=np.float32), 0, 1)
    preds = np.clip(target + 0.1 * g.standard_normal(shape, dtype=np.float32), 1e-3, 1)
    return preds.astype(np.float32), target.astype(np.float32)


def phase_loss() -> None:
    """The run config's composite loss and its gradient on the card against
    float64 on the CPU, and the warm forward+backward time."""
    from xmm_superres_denoise_torch.cli import load_run_config
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.train.loss import create_loss

    t0 = time.perf_counter()
    ds, _, _, sc_dict, loss_cfg = load_run_config(RUN_CONFIG)
    loss = create_loss(sc_dict, loss_cfg)
    shape = (ds.batch_size, ds.hr.res, ds.hr.res, 1)
    preds, target = _loss_pair(shape)

    def value_and_grad(dev, dtype):
        x = torch.from_numpy(preds).to(dev, dtype).requires_grad_()
        t = torch.from_numpy(target).to(dev, dtype)
        with true_f32():
            v = loss(x, t)
            v.backward()
        return v.detach(), x.grad

    v, g = value_and_grad("cuda:0", torch.float32)
    v64, g64 = value_and_grad("cpu", torch.float64)
    v_err = abs(float(v) - float(v64)) / abs(float(v64))
    g_scale = float(g64.abs().max())
    g_err = float((g.double().cpu() - g64).abs().max())
    x = torch.from_numpy(preds).to("cuda:0").requires_grad_()
    t = torch.from_numpy(target).to("cuda:0")

    def step():
        x.grad = None
        with true_f32():
            loss(x, t).backward()

    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(step, iters=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    terms = ", ".join(f"{n} x {p:.6g}" for n, p, _ in loss.terms)
    say(
        f"[loss] esr_gen_sr composite loss ({terms}, correction {loss.correction:.6g}) on "
        f"{shape} f32, TF32 off: value {float(v):.8f} vs float64 on the CPU {float(v64):.8f}, "
        f"relative diff {v_err:.3e} (tol {LOSS_RTOL:.0e}); d loss / d preds max|diff| "
        f"{g_err:.3e} = {g_err / g_scale:.3e} x max|grad| {g_scale:.3e} (tol "
        f"{LOSS_GRAD_RTOL:.0e}); forward+backward {ms:.3f} ms (CUDA events, warm), peak memory "
        f"{peak:.2f} GiB ({time.perf_counter() - t0:.2f} s)"
    )
    if not (math.isfinite(float(v)) and v_err <= LOSS_RTOL and g_err <= LOSS_GRAD_RTOL * g_scale):
        raise AssertionError(f"loss on the card: value {v_err}, gradient {g_err / g_scale}")


GRAD_RTOL = 1e-4  # card vs CPU parameter gradients, relative to max|g| of each group
GRAD_CPU_BUDGET_S = 60.0  # the CPU reference's forward+backward at 416^2, else 128^2
EVAL_RTOL = 1e-4  # collections on the card vs float64 on the CPU, relative
EVAL_FSIM_RTOL = 5e-4
EVAL_BASE_NAMES = 80  # the sim split's val share (0.1) holds one batch of 8


def _param_group(name: str) -> str:
    """The parameter group of a generator parameter, for the [grad] report."""
    parts = name.split(".")
    return parts[1] if parts[0] == "trunk" else parts[0]


def _sr_model(dtype=torch.float32, device="cuda:0"):
    from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
    from xmm_superres_denoise_torch.utils.weights import params_from_flax

    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(CHECKPOINT))
    return model.to(device, dtype)


def _fwd_bwd(model, loss, x, target):
    """One forward and backward of the clamped model through the loss (f32
    loss for a bf16 model); the grads stay on the model."""
    for p in model.parameters():
        p.grad = None
    out = torch.clamp(model(x), 0.0, 1.0)
    v = loss(out.float(), target)
    v.backward()
    return v.detach()


def phase_grad(ctx) -> None:
    """Gradients through K2: the full-width SR model with the trained
    weights, f32 with TF32 off, the run config's loss; one forward+backward
    on the card (dense blocks through `_DenseBlockFn`: K2 forward,
    recomputed backward) against the same on the CPU model; a bf16
    forward+backward; the inference-only ops' refusals."""
    from xmm_superres_denoise_torch.cli import load_run_config
    from xmm_superres_denoise_torch.ops.conv_i8 import Epilogue, conv_i8
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.train.loss import create_loss

    t0 = time.perf_counter()
    _, _, _, sc_dict, loss_cfg = load_run_config(RUN_CONFIG)
    loss = create_loss(sc_dict, loss_cfg)
    with torch.inference_mode():
        x_full = ctx["engine"].prepare(torch.from_numpy(ctx["raw"][:1]).to("cuda:0")).cpu()
    x_full = x_full.clone()  # a normal tensor, out of inference mode
    _, target_full = _loss_pair((1, 832, 832, 1), seed=12)
    target_full = torch.from_numpy(target_full)

    # the CPU reference at 416^2 if its forward+backward fits the budget, as
    # estimated from a 128^2 run (work grows with the pixel count)
    cpu_model = _sr_model(device="cpu")
    t1 = time.perf_counter()
    with true_f32():
        _fwd_bwd(cpu_model, loss, x_full[:, 144:272, 144:272], target_full[:, 288:544, 288:544])
    est = (time.perf_counter() - t1) * (416 / 128) ** 2
    side = 416 if est <= GRAD_CPU_BUDGET_S else 128
    lo = (416 - side) // 2
    x, target = x_full[:, lo:lo + side, lo:lo + side], target_full[:, 2 * lo:2 * (lo + side),
                                                                   2 * lo:2 * (lo + side)]
    x, target = x.contiguous(), target.contiguous()
    t1 = time.perf_counter()
    with true_f32():
        v_cpu = _fwd_bwd(cpu_model, loss, x, target)
    cpu_s = time.perf_counter() - t1
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}

    model = _sr_model()
    xc, tc = x.to("cuda:0"), target.to("cuda:0")
    with true_f32():
        dense_block.launches = 0
        v = _fwd_bwd(model, loss, xc, tc)
        torch.cuda.synchronize()
        launches = dense_block.launches  # the forward's: the backward runs cuDNN
    grads = {n: p.grad for n, p in model.named_parameters()}
    groups: dict = {}
    for n, g in grads.items():
        if g is None or not torch.isfinite(g).all() or not g.abs().max() > 0:
            raise AssertionError(f"[grad] {n}: gradient {None if g is None else g.abs().max()}")
        err = float((g.double().cpu() - cpu_grads[n].double()).abs().max())
        rel = err / float(cpu_grads[n].abs().max())
        groups[_param_group(n)] = max(groups.get(_param_group(n), 0.0), rel)
    with true_f32():
        ms = _time_ms(lambda: _fwd_bwd(model, loss, xc, tc), iters=5)
    worst = max(groups.values())
    say(
        f"[grad] esr_gen SR f32 (TF32 off), trained weights, run config loss, batch 1, {side}^2 -> "
        f"{2 * side}^2 (CPU reference estimated {est:.1f} s at 416^2, budget "
        f"{GRAD_CPU_BUDGET_S:.0f} s; took {cpu_s:.2f} s): loss {float(v):.8f} vs CPU "
        f"{float(v_cpu):.8f}; {len(grads)} parameters, all finite and non-zero; dense_block "
        f"launches in the step {launches} (expected 60, the forward's); largest max|g_card - g_cpu| / "
        f"max|g_cpu| per group: "
        + ", ".join(f"{k} {e:.3e}" for k, e in groups.items())
        + f" (tol {GRAD_RTOL:.0e}); forward+backward {ms:.3f} ms (CUDA events, warm)"
    )
    if len(grads) != 130 or launches != 60 or not worst <= GRAD_RTOL:
        raise AssertionError(f"[grad] {len(grads)} grads, {launches} launches, worst {worst}")

    model16 = _sr_model(torch.bfloat16)
    dense_block.launches = 0
    v16 = _fwd_bwd(model16, loss, xc.to(torch.bfloat16), tc)
    torch.cuda.synchronize()
    n16 = dense_block.launches
    bad = [n for n, p in model16.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    ms16 = _time_ms(lambda: _fwd_bwd(model16, loss, xc.to(torch.bfloat16), tc), iters=5)
    say(f"[grad] bf16: loss {float(v16):.6f}, gradients for "
        f"{sum(p.grad is not None for p in model16.parameters())} parameters, non-finite {bad}, "
        f"dense_block launches {n16}; forward+backward {ms16:.3f} ms (CUDA events, warm)")
    if bad or n16 != 60 or sum(1 for _ in model16.parameters()) != 130:
        raise AssertionError(f"[grad] bf16: non-finite {bad}, {n16} launches")

    refused = []
    xs = torch.zeros((1, 16, 104, 128), device="cuda:0", requires_grad=True)
    w = [torch.zeros((3, 3, 128 * k, 128), device="cuda:0") for k in range(1, 6)]
    b = [torch.zeros(128, device="cuda:0") for _ in range(5)]
    ep = Epilogue(torch.ones(128, device="cuda:0"), torch.zeros(128, device="cuda:0"),
                  torch.float32, res_scale=0.2)
    residual = torch.zeros((1, 8, 8, 128), device="cuda:0", requires_grad=True)
    calls = {
        "dense_block_s2d": lambda: dense_block_s2d(xs, w, b),
        "conv_i8": lambda: conv_i8(torch.zeros((1, 8, 8, 128), dtype=torch.int8, device="cuda:0"),
                                   torch.zeros((3, 3, 128, 128), dtype=torch.int8,
                                               device="cuda:0"), ep, residual=residual),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "inference only" in str(e):
                refused.append(name)
    say(f"[grad] with a gradient needed, refused: {refused} ({time.perf_counter() - t0:.2f} s)")
    if refused != list(calls):
        raise AssertionError(f"[grad] inference-only ops refused {refused}, expected {list(calls)}")


def _collections(dm, scalers):
    from xmm_superres_denoise_torch.metrics import (
        get_ext_metrics,
        get_in_ext_metrics,
        get_in_metrics,
        get_metrics,
    )

    return {"metrics": get_metrics(dm.normalizer, scalers, "val"),
            "in:metrics": get_in_metrics(dm.normalizer, scalers, "val"),
            "ext": get_ext_metrics(dm.normalizer, scalers, "val"),
            "in:ext": get_in_ext_metrics(dm.normalizer, scalers, "val")}


def phase_eval(tmp: Path) -> None:
    """Evaluation on the card: a synthetic simulated dataset tree (80 base
    names at the detector's geometry, 20 ks at 1x and 100 ks at 2x, AGN and
    background sets), `XmmDataModule` from the run config's dataset section
    on cuda:0, the val loader at batch 8 through the f32 model (K2) and
    `make_eval_step` with the core and extended collections and their `in:`
    twins for the trainer's scaling normalizer; the same collections on the
    CPU in float64 from the card's own predictions and targets."""
    import dataclasses

    from xmm_superres_denoise_torch.config import load_run_config
    from xmm_superres_denoise_torch.data import native_loader
    from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
    from xmm_superres_denoise_torch.data.synthetic import write_sim_tree
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.preprocess import upsample_nearest
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.ops.stretch import Normalizer
    from xmm_superres_denoise_torch.train.loss import create_loss
    from xmm_superres_denoise_torch.train.steps import clamped_apply, make_eval_step
    from xmm_superres_denoise_torch.cli import load_run_config as load_cli_config

    t0 = time.perf_counter()
    ds_cfg, _ = load_run_config(RUN_CONFIG)
    root = write_sim_tree(tmp / "data", name=ds_cfg.name, n_base=EVAL_BASE_NAMES,
                          res_mult=ds_cfg.res_mult, lr_exp=ds_cfg.lr.exps[0],
                          hr_exp=ds_cfg.hr.exp, variants=1, seed=7)
    write_s = time.perf_counter() - t0
    cfg = dataclasses.replace(ds_cfg, directory=root)
    dm = XmmDataModule(cfg, splits_root=tmp / "splits", seed=0, device="cuda:0")
    scale = cfg.hr.res // cfg.lr.res
    # the trainer's scaling normalizer (the JAX CLI's _build_trainer: linear)
    scalers = [Normalizer(cfg.lr.clamp_max, cfg.hr.clamp_max, "linear")]
    colls = _collections(dm, scalers)
    _, _, _, sc_dict, loss_cfg = load_cli_config(RUN_CONFIG)
    loss = create_loss(sc_dict, loss_cfg)
    model = _sr_model()
    preds = []

    def apply(x):
        y = clamped_apply(model, x)
        preds.append(y)
        return y

    step = make_eval_step(apply, loss, {k: c.update for k, c in colls.items()}, upsample_input=scale)

    t1 = time.perf_counter()
    native = native_loader.native_available()  # g++ builds the reader at first use: not timed below
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    batches = list(dm.loader("val"))
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t1) * 1e3 / max(len(batches), 1)
    t1 = time.perf_counter()
    n_train = 0
    for _ in dm.loader("train"):
        n_train += 1
        if n_train == 4:
            break
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t1) * 1e3 / n_train
    if len(batches) != 1 or batches[0]["lr"].shape != (8, 416, 416, 1) \
            or batches[0]["hr"].shape != (8, 832, 832, 1) or not batches[0]["lr"].is_cuda:
        raise AssertionError(f"[eval] val loader: {[tuple(b['lr'].shape) for b in batches]}")
    batch = batches[0]

    states = {k: c.init("cuda:0") for k, c in colls.items()}
    with true_f32():
        dense_block.launches = 0
        states, loss_sum, w_sum = step(states, batch)
        torch.cuda.synchronize()
        launches = dense_block.launches
    card = {k: {n: float(v) for n, v in c.compute(states[k]).items()} for k, c in colls.items()}
    pred = preds[-1]

    # the same collections on the CPU in float64, from the card's predictions
    p64, t64, w64 = (t.detach().cpu().double() for t in (pred, batch["hr"], batch["weight"]))
    lr64 = upsample_nearest(batch["lr"].cpu().double().permute(0, 3, 1, 2),
                            scale).permute(0, 2, 3, 1)
    worst = {}
    for k, c in colls.items():
        st = c.update(c.init("cpu", torch.float64), lr64 if k.startswith("in:") else p64, t64, w64)
        ref = {n: float(v) for n, v in c.compute(st).items()}
        for n, v64 in ref.items():
            rel = abs(card[k][n] - v64) / max(abs(v64), 1e-12)
            tol = EVAL_FSIM_RTOL if n.endswith("fsim") else EVAL_RTOL
            if not (math.isfinite(card[k][n]) and rel <= tol):
                raise AssertionError(f"[eval] {n}: card {card[k][n]} vs float64 {v64}")
            worst[k] = max(worst.get(k, (0.0, "")), (rel, n))

    # time the parts of one eval batch on the card
    x, hr, w = batch["lr"], batch["hr"], batch["weight"]
    with torch.no_grad(), true_f32():
        fwd_ms = _time_ms(lambda: clamped_apply(model, x), iters=5)
        up = upsample_nearest(x.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)
        parts = {}
        for part, keys in (("core", ("metrics", "in:metrics")), ("extended", ("ext", "in:ext"))):
            def run(keys=keys):
                for k in keys:
                    colls[k].update(colls[k].init("cuda:0"), up if k.startswith("in:") else pred,
                                    hr, w)
            parts[part] = _time_ms(run, iters=5)
        step_ms = _time_ms(lambda: step({k: c.init("cuda:0") for k, c in colls.items()}, batch),
                           iters=3)
    headline = {n: round(v, 6) for n, v in card["metrics"].items()}
    say(
        f"[eval] synthetic sim tree ({EVAL_BASE_NAMES} base names, written in {write_s:.2f} s), "
        f"val split {len(dm.split_indices('val'))} samples -> {len(batches)} batch of "
        f"{tuple(x.shape)} -> {tuple(pred.shape)}, f32 model (TF32 off), dense_block launches "
        f"{launches} (expected 60); loss sum {float(loss_sum):.6f} over weight {float(w_sum):.0f}; "
        f"{headline}; vs float64 on the CPU, largest relative difference per collection: "
        + ", ".join(f"{k} {r:.3e} ({n})" for k, (r, n) in worst.items())
        + f" (tol {EVAL_RTOL:.0e}, fsim {EVAL_FSIM_RTOL:.0e})"
    )
    say(
        f"[eval] per batch of 8 (CUDA events, warm): model forward {fwd_ms:.3f} ms, core metrics "
        f"{parts['core']:.3f} ms, extended metrics {parts['extended']:.3f} ms, whole eval step "
        f"{step_ms:.3f} ms; loader host time per batch (decode, composite, prepare on the card; "
        f"native FITS reader {native}, built or loaded in {native_s:.2f} s before): "
        f"val {val_ms:.1f} ms, train {train_ms:.1f} ms over {n_train} batches "
        f"({time.perf_counter() - t0:.2f} s)"
    )
    if launches != 60 or float(w_sum) != 8.0:
        raise AssertionError(f"[eval] {launches} dense_block launches, weight sum {float(w_sum)}")


LIBRARY_GROUPS = ("cuDNN/cuBLAS convolution or GEMM", "elementwise, copies and the rest")
K3_GROUPS = ("K3 s8 wgmma level", "K3 s8 mma.sync Tile128 (conv_first)")
TRACE_TRIES = 3


def _profile_group(name: str) -> str:
    """The kernel group of a device kernel's name (demangled or not)."""
    # before the library match below: the port's own names hold "conv"
    if "conv3x3_f32_kernel" in name:
        return "K2/K1 f32 FFMA level (CUDA cores)"
    if "int8_gemm_kernel" in name:
        return "P int8 GEMM"
    if "conv3x3_wgmma" in name and "S8" in name:  # before the bf16 level's match
        return K3_GROUPS[0]
    if "conv3x3_wgmma" in name:
        return "K1/K2 bf16 wgmma level, 16x16 px x 128 ch"
    if "conv3x3_kernel" in name:
        if "Bf16" in name:
            return "K2 bf16 mma.sync level, 16x16 px x 32 ch"
        return K3_GROUPS[1]
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "gemm", "cutlass", "sm90")):
        return LIBRARY_GROUPS[0]
    return LIBRARY_GROUPS[1]


def _trace(fwd, x, counter):
    """One warm call of `fwd`, then one traced: (the trace's CUDA kernel
    events, the port kernel launches `counter` counted during it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fwd(x)  # warm
        torch.cuda.synchronize()
        before = counter.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd(x)
            torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], counter.launches - before


def phase_profile(ctx) -> None:
    """One warm batch of each serving mode traced with torch.profiler: the
    device's busy time per image (the one yardstick across modes), its idle
    share of the kernels' span, and the busy time by kernel group. A trace
    that holds fewer of the port's kernels than its counter launched lost
    events (seen on the card now and then) and is taken again, up to
    TRACE_TRIES times; the line says how many it holds."""
    x = ctx["engine"].prepare(torch.from_numpy(ctx["raw"][:SERVE_BATCH]).to("cuda:0"))
    for mode, (fwd, counter) in ctx["profile"].items():
        t0 = time.perf_counter()
        for tries in range(1, TRACE_TRIES + 1):
            kernels, launched = _trace(fwd, x, counter)
            groups: dict = {}
            for e in kernels:
                g = groups.setdefault(_profile_group(e.name), [0.0, 0])
                g[0] += e.time_range.elapsed_us()
                g[1] += 1
            traced = sum(n for g, (_, n) in groups.items() if g not in LIBRARY_GROUPS)
            if traced == launched:
                break
        if not kernels:
            raise AssertionError(f"{mode}: the profiler saw no CUDA kernel")
        busy = sum(us for us, _ in groups.values())
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
        parts = ", ".join(f"{g} {us / 1e3 / SERVE_BATCH:.3f} ms ({n} launches)"
                          for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]))
        k3 = ""
        if "int8" in mode:
            k3_ms = sum(groups.get(g, (0.0, 0))[0] for g in K3_GROUPS) / 1e3 / SERVE_BATCH
            cfg = ctx["model_cfg"].model
            bound = _k3_forward_ops(1, x.shape[1] // 2, x.shape[2] // 2, cfg.residual_blocks,
                                    4 * cfg.filters) / PEAK_FLOPS[torch.int8] * 1e3
            k3 = (f"; K3 {k3_ms:.3f} ms/image against the forward's int8 bound {bound:.4f} "
                  f"ms/image ({bound / k3_ms:.1%})")
        say(
            f"[profile] {mode}: device busy {busy / 1e3 / SERVE_BATCH:.3f} ms/image, idle "
            f"{1 - busy / span:.1%} of the kernels' span; {parts}; elementwise launches per "
            f"batch {groups.get(LIBRARY_GROUPS[1], (0.0, 0))[1]}{k3}; port kernels traced "
            f"{traced} of {launched} launched, {tries} trace(s) ({time.perf_counter() - t0:.2f} s)"
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    try:
        t_start = time.perf_counter()
        device = phase_device()
        build_logs = phase_build()
        kernels = [phase_kernel(torch.float32, build_logs), phase_kernel(torch.bfloat16, build_logs)]
        (s2d_f32, k2_c128_f32), (s2d_bf16, k2_c128) = (phase_kernel_s2d(torch.float32, build_logs),
                                                       phase_kernel_s2d(torch.bfloat16, build_logs))
        p_entry, (k3_entry, k3_fused) = phase_kernel_p(), phase_kernel_k3(build_logs)
        with tempfile.TemporaryDirectory(prefix="xmmsr_chip_smoke_") as tmp:
            launches, ctx = phase_serve(Path(tmp))
            s2d_launches = phase_s2d(ctx)
            int8_launches = phase_serve_int8(ctx, Path(tmp))
            phase_cli(ctx, Path(tmp))
            phase_http(ctx, Path(tmp))
            phase_eval(Path(tmp))
        phase_loss()
        phase_grad(ctx)
        phase_profile(ctx)
        for entry, name in zip(kernels, ("f32", "bf16")):
            entry["launches"] = launches[name]
        s2d_f32["launches"] = s2d_launches["s2d f32"]
        s2d_bf16["launches"] = s2d_launches["s2d bf16"]
        k2_c128["launches"] = s2d_launches["fast bf16"]
        k2_c128_f32["launches"] = s2d_launches["fast f32"]
        p_entry["launches"] = int8_launches["int8_gemm"]
        k3_entry["launches"] = k3_fused["launches"] = int8_launches["conv_i8"]
        kernels += [k2_c128, k2_c128_f32, s2d_f32, s2d_bf16, p_entry, k3_entry, k3_fused]
        say(f"[done] {time.perf_counter() - t_start:.2f} s")
        say(json.dumps({"kernels": kernels}))
        say(json.dumps({"ok": True, "device": device}))
    finally:
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
