#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`xmm_superres_denoise_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result and its seconds:

1. device: the card's name and power limit (nvidia-smi) and what PyTorch sees;
2. build: the eight kernel libraries compiled with nvcc for sm_90a, all at
   once (ptxas reports): K2 dense_block, K1 dense_block_s2d, P int8_gemm,
   K3 conv_i8, window_attention, mlp_block, mdta_gram, window_qkv;
3. kernel: each kernel held against its plain PyTorch version at the shapes
   the main paths give it, and timed with CUDA events beside the plain
   version, a library call where one computes the same function, and its
   bound: K2 at (2, 416, 416, 32) and K1 at (2, 208, 208, 128) in f32 (TF32
   off) and bf16, with K2 also held on K1's inputs (C = 128, inside K2's
   range, though no main path runs it there; bf16 K2 runs K1's wgmma level
   there, and the bf16 line adds that level's share of its bound and its
   ptxas report; the bf16 line
   at C = 32 adds the persistent wgmma level's share of the operation bound
   and of the five-launch traffic floor, its time at one full wave of items,
   ptxas report and shared memory; the f32 lines add the FFMA level's
   TFLOP/s, share of its bound, time at one full round of tiles, ptxas
   report and shared memory); P (the s8 wgmma m64n128k32 that K3 serves
   on) at the probe's (2048, 128) x (128, 128), exact, also timed on the
   device alone (torch.profiler) beside torch._int_mm and its bound, with
   the host time per call; K3
   raw (exact int32 sums) and fused (the int8 forward's epilogue inside,
   bf16, bitwise equal to its plain composition in bf16 and f32) at the int8
   forward's shapes: dense level 1 (codes into the concat), level 5
   (residual; alone, and with the codes of the next block's input beside
   it), conv_first and trunk_conv (with codes beside), upconv and HRconv, with
   the route each took (the 128-channel s8 wgmma level, or the (tap,
   channel) wgmma route at conv_first's Cin 4), TOP/s, share of the bound
   (conv_first: of its byte floor, raw and fused) and the route's ptxas
   report and shared memory; the fused window attention at the zoo's
   shapes (SwinIR's 169 x 169, HAB's 256 x 256 with and without the shift
   mask, OCAB's 256 x 576 on unfolded keys, DRCT's window-16 blocks at d 53
   and 46 under the mask and d 122 and 77 without, and its d 122 at window
   13, 169 x 169), each with the ptxas report of the instance it runs and
   its bound at the true head size, finite and within
   2^-7 (sum_j P_j |v_j| + |o|) + 1e-6 of its plain composition per element
   (P the plain f32 probabilities: the f32 sums' order, one bf16 ulp of P
   and of the output), timed beside the plain version and
   `F.scaled_dot_product_attention` with a float mask, with its bound; the
   fused MLP half-block (LayerNorm, fc1, GELU, fc2, residual) at the cells'
   (4, 173056, 180), H 720, finite and within 2^-7 (|plain| + |y| + |y -
   b2|) + 2^-10 max|y| of its plain composition per element (y = plain -
   x: one bf16 ulp at the output's, the bias add's and fc2's roundings),
   timed beside the plain version with its bound by operations and bytes;
   the Swin blocks' qkv side (`window_qkv`: norm1, the cyclic shift and the
   window partition gathered into the qkv wgmma, its bias in the epilogue)
   with every instance's ptxas report, at SwinIR's (4, 416^2, 180) window
   13, DRCT's widest C 308 at window 16 shifted by 8 and HAB's C 180
   shifted without the norm, finite, within 2^-7 (|plain| + |y|) + 2^-10
   max|y| of its plain composition per element (y = plain - bias) with at
   most 2 % of the elements differing, timed beside the plain version with
   its bound by bytes and operations;
   MDTA's Gram side (`mdta_gram`: the Gram and sums of squares over the
   pixels on wgmma, then the softmax) at Restormer's five level shapes at
   batch 4 and dim 48, finite and within the plain bf16 composition's error
   plus one bf16 ulp of an f64 evaluation per element, timed beside the
   plain version with its byte bound, and summed over the 44 calls of a
   forward;
4. serve: 4 synthetic Poisson detxy FITS (403x411, so padding is exercised)
   served by `serve_files` through `InferenceEngine` at full esr_gen width and
   depth (416^2 -> 832^2) with the trained weights, in f32 and in bf16. The
   launch count is reset just before each run and read just after; the f32
   products are held against a forward on the card through the plain dense
   block, called explicitly here; the engine's chunks in flight (_INFLIGHT
   = 2) on the 4 images 8 times at batch 2 against one chunk at a time, in
   turns, bitwise equal to each other and to the served products;
5. serve-int8: the same 4 files served through `InferenceEngine(quantize=
   True)` in bf16 (int8 convolutions on K3, P's exactness check at build),
   held to the 40 dB int8 gate against the f32 plain forward;
6. cli: the command line (`xmm_superres_denoise_torch.cli`) serving the
   same 4 files with the run config and the trained checkpoint: `serve
   --bf16` in-process, bitwise equal to [serve]'s bf16 products; `serve
   --int8 --bf16 --int8_scales` twice with one fresh scales path, the first
   run calibrating and writing {"fingerprint", "scales"}, the second loading
   it without calibrating (calls of calibrate_int8_scales counted), both
   bitwise equal to [serve-int8]'s products and at the 40 dB gate; and one
   `python -m ... infer --bf16` subprocess, bitwise equal to `infer_file`
   in-process;
7. mesh: serving on a data mesh of cards. (a) `cli serve --bf16 --mesh_data
   -1` (every card: one on a one-card machine), bitwise equal to [cli]'s
   bf16 products; (b) `InferenceEngine(mesh=("cuda:0", "cuda:0"))`, two
   replicas on one card, serving the 4 files at batch 4 (two shards of 2)
   and 3 (padded to 4 and trimmed, then a batch of 1 on mesh[0]) in f32,
   bf16 and int8 (bf16 epilogues, calibrating once on mesh[0] over its first
   batch), each held to the single-card engine's products (bitwise, or
   within SERVE_F32_RTOL / SERVE_BF16_RTOL, or INT8_PSNR_DB), its int8
   scales equal to the single card's, K2 / K3 launches per replica, P
   launches (one per replica's build), current_device unchanged, and
   run_tiles ms per image beside the single card's; (c) with more than one
   card, the same over cuda:0..N-1 (a line says when it does not run);
8. http: `run_http_server` on 127.0.0.1 (a free port) in a thread over the
   bf16 engine: each file POSTed, each response bitwise equal to
   `infer_file`'s prediction, then /stats, then the stop event;
9. events: a synthetic EPIC-pn event list of 4,194,304 events (DETX
   -16120..16119, DETY -16440..16439: 411 x 403 at bin 80; PI 150..12000,
   PATTERN 0..12, some FLAG set; TIME from 5.6e8 s, with events exactly on
   each GTI edge and 1 s either side) in a PPS directory with its FBKTSR
   curve (20-40 GTIs from its flares, capped at 20 ks), CALIND and ATTTSR;
   loaded through the native reader (which must be the one that ran) and
   binned on cuda:0 (`bin_events(device=...)`), on the host and by an
   independent count written here (np.add.at): bitwise equal, for the EPN
   cuts and the EMOS mask; load s, host bin ms, card bin ms with and
   without the host->device copy, Mevents/s of each;
10. end2end: the trained weights exported by the port as a full ONNX graph,
   run by the port's lite runtime on cuda:0 against the engine's f32
   forward on one prepared tile; `cli end2end --checkpoint weights.onnx` on
   [events]' PPS directory in f32, bf16 and int8 (twice on one fresh scales
   file), in-process with K2, K3 and P launches counted, the detxy product
   bitwise equal to [events]' host image and each prediction bitwise equal
   to `infer_file` through an engine loaded from the npz, int8 at the 40 dB
   gate; the same end2end as a `python -m` subprocess; `cli detxy`; `cli
   verify --onnx weights.onnx` on the 4 [serve] files; latency_s per mode;
11. eval: a synthetic simulated dataset tree (80 base names at the
   detector's geometry, AGN and background sets, written with the port's
   FITS codec) through `XmmDataModule` (the run config's dataset section,
   on cuda:0): the val loader's batch of 8 at 416^2 -> 832^2 through the
   f32 model (K2) and `make_eval_step` with the core and extended metric
   collections and their `in:` input-baseline twins, held to the same
   collections computed on the CPU in float64 from the card's own
   predictions; ms per batch for the forward, the core and the extended
   metrics, and the loader's host ms per batch;
12. train: training through the command line on the same tree, the shipped
   esr_gen_sr run config at full width (batch 8, 416^2 -> 832^2, f32,
   s2d_train as shipped: the dense blocks on K1 through its gradient route)
   with only its epochs (2), checkpoint root and data directory changed:
   `cli fit` in-process with each train step timed (CUDA events) and its K1
   and K2 launches counted (60 K1 per step, none of K2), the files the fit
   leaves (checkpoints, best.json, history.jsonl, TB events, the run config),
   `cli test` bitwise equal to the fit's test; one epoch in bf16 and one with
   s2d_train = false (60 K2 launches per step); one step through DDP on NCCL
   at world size 1, bitwise equal to the unwrapped step; one epoch of `cli
   fit --profile DIR` with `log_images_every_n_epochs = 1`: the trace file,
   bounded to the fit's first FIT_PROFILE_STEPS train steps of the epoch's 8
   (that many optimizer steps, 60 K1 kernels each), its size and the seconds
   the profiler added; the image logger's panel (with matplotlib)
   and 2 x n FITS, and its SSIM map on the card against float64 on the CPU;
13. loss: the esr_gen_sr run config's composite loss (psnr 0.5 + ms_ssim 0.5,
   sqrt table) on a seeded (8, 832, 832, 1) pair, value and d loss / d preds
   on the card (TF32 off) against float64 on the CPU, and the warm
   forward+backward time;
14. grad: one forward+backward of the full-width SR model (trained
   weights, f32, TF32 off, the run config's loss, batch 1 at 416^2 ->
   832^2, or 128^2 when the CPU reference would take over a minute) on the
   card, its dense blocks through `dense_block`'s autograd route (K2
   forward, recomputed backward), held parameter group by group to the same
   on the CPU model; the same through the S2D training route
   (`make_s2d_train_apply`: K1 forward, 60 launches) held to the same CPU
   gradients, with its f32 and bf16 times; one bf16 forward+backward; the
   inference-only `dense_block_s2d` and `conv_i8` refusing a gradient;
15. train-routes: the measurements behind the S2D route's design at batch
   8: a dense block's backward in the original domain (C = 32) against
   the S2D domain on cuDNN (C = 128, NCHW and channels_last), and the
   outer convolutions in both domains, f32 (TF32 off) and bf16;
16. profile: one warm batch of each serving mode (model f32 and bf16,
   int8) traced with torch.profiler:
   device-busy time per image, idle share, and busy time by kernel group;
   a trace that lost some of the port's kernel launches is taken again;
   for int8 also its elementwise launches per batch and K3's time against
   the forward's int8 operations at the published peak.

17. zoo: the transformer zoo's five shipped run configs (swinir_sr,
   swinfir_sr, drct_sr_fsdp, hat_sr, restormer_denoise) and drct_sr_w16
   (drct_sr_fsdp at patch 16: window 16, blocks 2 and 4 shifted, the model
   of the cell drct_sr_bf16_bulk) at full width with seeded weights, each
   written as a Flax-layout npz (`layers_scan` for HAT and DRCT) and, but
   for drct_sr_w16 (a run config cannot set patch_size), the 4 files
   served through `cli serve` in f32 and bf16;
   the raw output on the card in f32 (TF32 off) held to the CPU's f32
   forward of the same weights at 52^2 (SwinIR, SwinFIR, DRCT) or 64^2
   (HAT, Restormer), 1e-4 x max(1, max|CPU|); bf16 held to f32 at 416^2,
   20 log10(max|f32| / RMS(bf16 - f32)) >= 30 dB; engine ms per image in
   f32 and bf16 (CUDA events), peak memory, FLOPs per image and their
   bound, a traced forward of each by kernel group; then `cli fit` of
   swinir_sr at full width (batch 2, memory_efficient, one epoch of 8 steps
   on a 20-name synthetic tree, each step timed) and `cli test` of its best
   checkpoint, bitwise equal to the fit's test. The window attention
   counter is read around the f32 and the bf16 forward at 416^2: none in
   f32, and in bf16 one launch per attention (SwinIR and SwinFIR 36, DRCT
   30 at either window, HAT 42, Restormer 0), and so is the MLP half-block's
   (SwinIR and SwinFIR 36, DRCT 6, HAT 42, Restormer 0), MDTA's Gram side's
   (Restormer 44, the others 0) and the qkv side's (SwinIR and SwinFIR 36,
   DRCT 30, HAT 36, Restormer 0); the `kernels` line's window_attention,
   mlp_block, window_qkv and mdta_gram entries carry the counts measured
   there. FFT and convolutions are PyTorch's ops.

The `kernels` line's K2 f32 and bf16, P and K3 entries also carry
`launches_end2end`, their launches in one `cli end2end` batch. K1's entries
carry the launches of one S2D training step ([grad]); K2's C = 128 entries
carry none, as no main path launches K2 there. The last two
lines are a `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Any failure exits non-zero. Without a CUDA
card it exits non-zero at once and prints no result. All products go to a
temporary directory; the only files written inside the checkout are the
kernel libraries under build/torch_kernels/.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
DEADLINE_S = 1100  # the whole run; the watchdog exits non-zero past it
SERVE_FILES = 4
SERVE_BATCH = 2
PIPE_REPEAT = 8  # [serve]'s chunks in flight: the 4 images 8 times, 16 chunks of 2
NATIVE_HW = (411, 403)  # numpy (NAXIS2, NAXIS1) of an EPIC-pn detxy image
KERNEL_SHAPE = (2, 416, 416, 32)  # the trunk's dense-block input when serving
S2D_SHAPE = (2, 208, 208, 128)  # the S2D route's dense-block input at batch 2, 416^2
# 11 x 12 tiles of 16 x 16 px = 132 blocks, one per SM: the bf16 level with no
# partial last wave (S2D_SHAPE has 338 tiles, 2.56 waves)
ONE_WAVE_SHAPE = (1, 176, 192, 128)
# 12 x 22 tiles of 16 x 16 px = 264 items: one for each of the two consumer
# warpgroups of the 132 persistent blocks of the bf16 level at C = 32
# (conv3x3_wgmma32.cuh; KERNEL_SHAPE has 1,352 items, 5.1 per warpgroup)
ONE_WAVE_C32_SHAPE = (1, 192, 352, 32)
BF16_C32_SOURCE = "xmm_superres_denoise_torch/csrc/conv3x3_wgmma32.cuh"  # K2's bf16 level at C = 32
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


def _bf16_level(build_logs: dict, ms: float, flops: float, bound_ms: float) -> str:
    """What the bf16 `[kernel]` line adds about the level at C = 32
    (conv3x3_wgmma32.cuh), timed at `ms` for `flops` against the operation
    bound `bound_ms`: its share of that bound and of the five-launch traffic
    floor, each level's time alone beside the bytes it moves, the time of
    one full wave of items (one per consumer warpgroup), ptxas's report of
    its resident-weight form and its shared memory."""
    from xmm_superres_denoise_torch.ops import cuda_build
    from xmm_superres_denoise_torch.ops.dense_block import (
        _SIGNATURES,
        dense_block,
        level_kernel,
        pack_weights,
    )

    floor_ms = _five_launch_bytes(KERNEL_SHAPE, 2) / PEAK_BYTES_PER_S * 1e3
    dev = torch.device("cuda:0")
    x, ws = _block_inputs(ONE_WAVE_C32_SHAPE, torch.bfloat16, dev)
    packed = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
    with torch.inference_mode():
        wave_ms = _time_ms(lambda: dense_block(x, packed), iters=20)
    lib = cuda_build.library("dense_block", _SIGNATURES)
    smem = lib.dense_block_bf16_smem_bytes(5 * 32, 32)
    # each level alone at the serving shape, beside the bytes it must move
    # (its k*C prefix read, C written, x read again at level 5)
    b, h, w, c = KERNEL_SHAPE
    x, ws = _block_inputs(KERNEL_SHAPE, torch.bfloat16, dev)
    packed = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
    buf = torch.zeros((b, h, w, 5 * c), dtype=torch.bfloat16, device=dev)
    buf[..., :c] = x
    out = torch.empty_like(x)
    _, level = level_kernel(torch.bfloat16)
    stream = cuda_build.stream_of(buf)
    levels = []
    for k in range(1, 6):
        dst, dst_stride = (out.data_ptr(), c) if k == 5 else (buf[..., k * c:].data_ptr(), 5 * c)
        args = (cuda_build.device_index(buf), buf.data_ptr(), b, h, w, 5 * c, k * c,
                packed.kernel[k - 1].data_ptr(),
                packed.biases[k - 1].data_ptr(), c, dst, dst_stride, int(k == 5), stream)
        level_ms = _time_ms(lambda: cuda_build.check(lib, "dense_block", level(*args), "level"))
        level_bytes = b * h * w * 2 * (k * c + c + (c if k == 5 else 0))
        levels.append(f"{level_ms * 1e3:.1f} us ({level_bytes / PEAK_BYTES_PER_S * 1e6:.1f})")
    return (
        f"; the wgmma level (conv3x3_wgmma32_kernel, persistent, weights resident) reaches "
        f"{bound_ms / ms:.1%} of the operation bound and {floor_ms / ms:.1%} of the five-launch "
        f"traffic floor ({floor_ms:.4f} ms); levels 1-5 alone (byte floor): {', '.join(levels)}; "
        f"one full wave {ONE_WAVE_C32_SHAPE} (264 items): {wave_ms:.4f} ms; ptxas: "
        f"{_ptxas_report(build_logs['dense_block'], 'conv3x3_wgmma32_kernelILb0E')}; "
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
    level = (_f32_level(build_logs, c, ms, flops, bound_ms) if dtype == torch.float32
             else _bf16_level(build_logs, ms, flops, bound_ms))
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
        "source": F32_SOURCE if dtype == torch.float32 else BF16_C32_SOURCE,
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
    _chunks_in_flight(engines, raw, preds)

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


def _chunks_in_flight(engines, raw, preds) -> None:
    """The engine's chunk pipeline on a longer stack (the 4 images
    PIPE_REPEAT times, batch SERVE_BATCH): `_INFLIGHT` = 2 chunks queued
    ahead of the readback against 0 (each chunk read back before the next
    is launched, the parent's order), in turns 0, 2, 2, 0; host clock incl.
    transfers. The products must be bitwise equal between the two and to
    [serve]'s."""
    stack = np.concatenate([raw] * PIPE_REPEAT)
    for name, engine in engines.items():
        t0 = time.perf_counter()
        outs, ms = {}, {0: [], 2: []}
        for inflight in (0, 2, 2, 0):
            engine._INFLIGHT = inflight
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = engine.run_tiles(stack, batch_size=SERVE_BATCH)
            ms[inflight].append((time.perf_counter() - t1) * 1e3 / len(stack))
            outs.setdefault(inflight, out)
        del engine._INFLIGHT  # the class's value again
        same = all(np.array_equal(a, b) for a, b in zip(outs[0], outs[2]))
        served = bool(np.array_equal(outs[2][0][: len(raw)], preds[name]))
        say(f"[serve] {name} chunks in flight, {len(stack)} images at batch {SERVE_BATCH}: "
            f"_INFLIGHT 2 {ms[2][0]:.3f} / {ms[2][1]:.3f} ms/image, one chunk at a time (0) "
            f"{ms[0][0]:.3f} / {ms[0][1]:.3f} ms/image (host clock incl. transfers); bitwise "
            f"equal to each other: {same}, to [serve]'s products: {served} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not (same and served):
            raise AssertionError(f"{name}: chunks in flight change the products")


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
        # K2 at C = 128 (K1's level in bf16, the same FFMA level in f32), same inputs
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
        f"S2D, {nominal / (ms * 1e-3) / 1e12:.2f} TFLOP/s nominal); dense_block (K2 at C=128) "
        f"on the same inputs: max|kernel-plain| {k2_err:.3e} (same tol), "
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
        "launches": None,
        "note": "no main path launches K2 at C = 128",
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
        "launches": None,  # filled from [grad]'s S2D training step
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, k2_entry


def _device_ms(fn, iters: int = 20) -> float:
    """Device time of the kernels one call launches: torch.profiler over
    `iters` warm calls, each kernel's mean duration times its launches per
    call, summed (no launch gaps, no host time). The profiler loses events
    now and then: a kernel it saw fewer than `iters` times still counts
    once a call at its mean, and a trace with no kernel at all is taken
    again, up to TRACE_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            return sum(sum(d) / len(d) * max(1, round(len(d) / iters))
                       for d in by_name.values()) / 1e3
    raise AssertionError("the profiler saw no CUDA kernel")


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


def phase_kernel_p(build_logs: dict) -> dict:
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
        f"[kernel] int8_gemm {tuple(a.shape)} x {tuple(b.shape)} on the s8 wgmma "
        f"(m64n128k32, A from registers; the instruction K3 serves on): exact {exact} (max|diff| "
        f"{err:.0f}), torch._int_mm exact {lib_exact}; CUDA events over 50 back-to-back calls: "
        f"kernel {ms:.4f} ms, plain (f64 matmul on the card) {plain_ms:.4f} ms, torch._int_mm "
        f"{library_ms:.4f} ms; device only (torch.profiler, 20 warm calls): kernel "
        f"{dev_ms * 1e3:.2f} us ({bound_ms / dev_ms:.1%} of its bound), torch._int_mm "
        f"{lib_dev_ms * 1e3:.2f} us; host per call while enqueueing: kernel {host_us:.2f} us, "
        f"torch._int_mm {lib_host_us:.2f} us; bound {bound_ms:.5f} ms by {bound_by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} G int8 ops); ptxas: "
        f"{_ptxas_report(build_logs['int8_gemm'], 'int8_gemm_kernel')} "
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
    """K3 raw and fused at each of K3_SHAPES, timed with CUDA events over
    back-to-back calls and on the device alone (torch.profiler: at
    conv_first's tens of microseconds the events time the host's enqueue);
    returns the raw and the fused JSON entries of level 5 and the fused
    entry of conv_first + codes, the (tap, channel) route."""
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
        path = route(cin)
        if path != ("wgmma" if lib.conv_i8_wgmma_route(cin) else "wgmma_taps"):
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
        dev_ms = _device_ms(lambda: conv_i8(x8, packed))
        fused_dev_ms = _device_ms(fused)
        flops = 2 * b * h * w * 9 * cin * cout
        nbytes = x8.numel() + w8.numel() + 4 * b * h * w * cout
        bound_ms, bound_by = _bound(flops, nbytes, torch.int8)
        out_esize = (1 if requant else 0) + (2 if values else 0)  # codes, bf16 values
        fused_bytes = (x8.numel() + w8.numel() + 8 * cout + b * h * w * cout * out_esize
                       + (2 * b * h * w * cout if res_scale is not None else 0))
        fused_bound_ms, fused_by = _bound(flops, fused_bytes, torch.int8)
        kernel = "conv3x3_wgmma_kernel" if path == "wgmma" else "conv3x3_tapk_kernel"
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
            f"({fused_bytes / 1e6:.1f} MB), plain composition {fused_plain_ms:.4f} ms; device only "
            f"(torch.profiler): raw {dev_ms:.4f} ms ({bound_ms / dev_ms:.1%} of its bound), fused "
            f"{fused_dev_ms:.4f} ms ({fused_bound_ms / fused_dev_ms:.1%}); ptxas: "
            f"{_ptxas_report(build_logs['conv_i8'], kernel)}, {lib.conv_i8_smem_bytes(cin)} B of "
            f"dynamic shared memory per block; no PyTorch call computes an s8 convolution "
            f"({time.perf_counter() - t0:.2f} s)"
        )
        if not exact:
            raise AssertionError(f"conv_i8 {which} sums are not exact")
        if not all(same.values()):
            raise AssertionError(f"conv_i8 {which} fused epilogue differs from its plain version")
        common = {"route": "cuda", "source": "xmm_superres_denoise_torch/csrc/conv_i8.cu",
                  "replaces": "xmm_superres_denoise_tpu/ops/int8_forward.py:125",
                  "launches": None, "library_ms": None}  # launches: from serve-int8
        fused_entry = {**common, "max_abs_err": fused_err[torch.bfloat16], "ms": fused_ms,
                       "device_ms": fused_dev_ms, "plain_ms": fused_plain_ms,
                       "bound_ms": fused_bound_ms, "bound_by": fused_by}
        if which == "level5":
            entries["raw"] = {"name": "conv_i8", **common, "max_abs_err": err, "ms": ms,
                              "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
            entries["fused"] = {"name": "conv_i8[fused]", **fused_entry}
        elif which == "conv_first+codes":
            entries["taps"] = {**fused_entry, "name": "conv_i8[conv_first, wgmma_taps]",
                               "source": "xmm_superres_denoise_torch/csrc/conv3x3_tapk.cuh"}
    return entries["raw"], entries["fused"], entries["taps"]


# the zoo cells' attention shapes at their serving batch of 4 images: (name,
# query window, key window, masked, the zoo run whose forward launches it,
# its blocks in that forward)
WA_SHAPES = (("swinir_169x169", 13, 13, False, "swinir_sr", 36, 180, 6),
             ("hab_256x256", 16, 16, False, "hat_sr", 18, 180, 6),
             ("hab_256x256_shift_mask", 16, 16, True, "hat_sr", 18, 180, 6),
             ("ocab_256x576", 16, 24, False, "hat_sr", 6, 180, 6),
             # DRCT's blocks at window 16 (`[zoo]`'s drct_sr_w16, the cell
             # drct_sr_bf16_bulk's model): 2 and 4 shifted, d 53 and 46 padded
             # to 64 under the mask; 3 and 5, d 122 and 77 padded to 128, two
             # warpgroups of two 64-key chunks
             ("drct_256x256_d53_shift_mask", 16, 16, True, "drct_sr_w16", 6, 212, 4),
             ("drct_256x256_d46_shift_mask", 16, 16, True, "drct_sr_w16", 6, 276, 6),
             ("drct_256x256_d122", 16, 16, False, "drct_sr_w16", 6, 244, 2),
             ("drct_256x256_d77", 16, 16, False, "drct_sr_w16", 6, 308, 4),
             # DRCT's block 3 at the run config's window 13: 169 keys at d
             # 122, three warpgroups of one chunk
             ("drct_169x169_d122", 13, 13, False, "drct_sr_fsdp", 6, 244, 2))
WA_IMAGES = 4
WA_SFU_PER_S = 132 * 16 * 1.98e9  # exponentials a second: 16 a cycle an SM at 1.98 GHz


def _wa_case(ws: int, owin: int, masked: bool, dev, seed=0, c=180, nh=6):
    """Seeded bf16 operands of one zoo attention of width c over nh heads at
    the serving batch, laid out as the models lay them out: q, k, v strided
    views of one qkv (WindowAttention), or q from ws windows and k, v the
    halves of the unfolded owin windows (OCAB); the bias gathered from a
    bf16 table; the shift mask of the 416^2 image's windows."""
    from xmm_superres_denoise_torch.models.hat import rpi_oca, unfold_overlap_windows
    from xmm_superres_denoise_torch.models.swin_common import (
        index_buffer, relative_position_index, shift_mask, window_partition)

    g = torch.Generator(device=dev).manual_seed(seed)
    d, side = c // nh, 416
    qkv = torch.randn((WA_IMAGES, side, side, 3 * c), generator=g, device=dev).bfloat16()
    n = ws * ws
    if owin == ws:
        win = window_partition(qkv, ws).reshape(-1, n, 3 * c)
        q, k, v = win.reshape(-1, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        idx = relative_position_index(ws, ws)
    else:
        qw = window_partition(qkv[..., :c], ws).reshape(-1, n, c)
        kv = unfold_overlap_windows(qkv[..., c:], ws, owin)
        m = owin * owin
        q = qw.reshape(-1, n, nh, d).transpose(1, 2)
        k = kv[..., :c].reshape(-1, m, nh, d).transpose(1, 2)
        v = kv[..., c:].reshape(-1, m, nh, d).transpose(1, 2)
        idx = rpi_oca(ws, (owin - ws) / ws)
    m = k.shape[2]
    table = torch.randn(((ws + owin - 1) ** 2, nh), generator=g, device=dev).bfloat16() * 0.02
    bias = table[index_buffer(idx).to(dev).view(-1)].view(n, m, nh).permute(2, 0, 1)
    mask = shift_mask(side, side, ws, ws // 2, dev) if masked else None
    return q, k, v, d ** -0.5, bias, mask


def _wa_bound(q, k, v, scale, bias, mask, plain):
    """Per-element bound of |kernel - plain|: 2^-7 (sum_j P_j |v_j| + |o|)
    + 1e-6 with P the plain version's f32 probabilities. The two differ
    only in the order of their f32 sums and, where that crosses a rounding
    boundary, by one bf16 ulp of a probability (2^-7 P_j) and of the output
    (2^-7 |o|); 1e-6 covers the sums' order where both round alike."""
    qs = (q * torch.full((), scale, dtype=q.dtype, device=q.device)).float()
    s = torch.matmul(qs, k.float().transpose(-2, -1))
    if bias is not None:
        s += bias.float()[None]
    if mask is not None:
        b_, nh, n, m = s.shape
        nw = mask.shape[0]
        s.view(b_ // nw, nw, nh, n, m).add_(mask[None, :, None])
    p = torch.softmax(s, dim=-1)
    del s
    return 2.0**-7 * (torch.matmul(p, v.float().abs()) + plain.float().abs()) + 1e-6


def _wa_instance(pl, mask) -> str:
    """The mangled name of the `window_attention_sm90_kernel<DK, CPW, MASK>`
    instance that the launch `pl` (`ops/window_attention.py: plan`) runs."""
    return (f"window_attention_sm90_kernelILi{pl.padded_head}ELi{pl.chunks_per_split}ELb"
            f"{int(mask is not None)}E")


def phase_kernel_window_attention(build_logs: dict) -> list:
    """The fused window attention at the zoo cells' shapes: the kernel
    against its plain composition (finite, and within `_wa_bound` per
    element, else AssertionError; max|diff| printed), CUDA-event times of the
    kernel, the plain version and `F.scaled_dot_product_attention` with the
    bias (and mask) as a float mask (the yardstick only: the port never
    calls it), the kernel's device time (torch.profiler) and its bound."""
    import torch.nn.functional as F

    from xmm_superres_denoise_torch.ops.window_attention import (
        plan, readable, window_attention, window_attention_plain)

    dev = torch.device("cuda:0")
    entries = []
    for name, ws, owin, masked, run, blocks, c, nh in WA_SHAPES:
        t0 = time.perf_counter()
        q, k, v, scale, bias, mask = _wa_case(ws, owin, masked, dev, c=c, nh=nh)
        b_, nh, n, d = q.shape
        m = k.shape[2]
        with torch.inference_mode():
            got = window_attention(q, k, v, scale, bias, mask)
            plain = window_attention_plain(q, k, v, scale, bias, mask)
            diff = (got.float() - plain.float()).abs()
            err = float(diff.max())
            over = float((diff / _wa_bound(q, k, v, scale, bias, mask, plain)).max())
            finite = bool(torch.isfinite(got.float()).all())
            same = float((got == plain).float().mean())
            del got, plain, diff
            ms = _time_ms(lambda: window_attention(q, k, v, scale, bias, mask))
            dev_ms = _device_ms(lambda: window_attention(q, k, v, scale, bias, mask), iters=5)
            plain_ms = _time_ms(lambda: window_attention_plain(q, k, v, scale, bias, mask), iters=5)
            float_mask = bias.float()[None]
            if mask is not None:
                nw = mask.shape[0]
                float_mask = (float_mask + mask[:, None]).repeat(b_ // nw, 1, 1, 1)
            float_mask = float_mask.to(q.dtype).expand(b_, nh, n, m)
            try:
                library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=float_mask, scale=scale), iters=5)
            except RuntimeError as e:
                library_ms = None
                say(f"[kernel] window_attention {name}: sdpa failed: {e}")
            del float_mask
        pairs = b_ * nh
        nbytes = pairs * (2 * n * d + 2 * m * d) * 2  # q, k, v in, the output out
        flops = pairs * 2 * 2 * n * m * d  # q k^T and P v at the true d: padding is cost, not work
        exps_ms = pairs * n * m / WA_SFU_PER_S * 1e3
        bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
        if exps_ms > bound_ms:
            bound_ms, bound_by = exps_ms, "exponentials"
        per_image = blocks / WA_IMAGES
        say(
            f"[kernel] window_attention {name} B_={b_} nh={nh} N={n} M={m} d={d}: max|diff| vs "
            f"plain {err:.3e}, {over:.3f} of the bound at most ({same:.2%} bitwise equal, "
            f"finite {finite}); CUDA events: kernel {ms:.4f} ms "
            f"(device only {dev_ms:.4f}), plain {plain_ms:.4f} ms, sdpa with a float mask "
            f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB: {nbytes / 3.35e12 * 1e3:.4f} "
            f"ms; {flops / 1e12:.3f} TFLOP: {flops / 989e12 * 1e3:.4f} ms; {pairs * n * m / 1e9:.3f}"
            f" G exp: {exps_ms:.4f} ms); {blocks} a {run} forward: kernel {ms * per_image:.3f} "
            f"ms an "
            f"image, plain {plain_ms * per_image:.3f}; ptxas: "
            f"{_ptxas_report(build_logs['window_attention'], _wa_instance(plan(*map(readable, (q, k, v))), mask))} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not finite or not over <= 1.0:
            raise AssertionError(f"window_attention {name} disagrees with its plain version: "
                                 f"max|diff| {err}, {over} of the bound, finite {finite}")
        entries.append({"name": f"window_attention {name}", "route": "cuda",
                        "source": "xmm_superres_denoise_torch/csrc/window_attention.cu",
                        "replaces": None, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "run": run, "blocks_per_forward": blocks,
                        "launches_per_forward": None})  # from the zoo's bf16 forward of `run`
        del q, k, v, bias, mask
        torch.cuda.empty_cache()
    return entries


# the zoo cells' MLP half-block at their serving batch of 4 images of 416^2
# tokens: C 180, H 720 (SwinIR, SwinFIR, HAT's HABs and OCABs, DRCT's first
# block of each group)
MLP_SHAPE = (4, 416 * 416, 180, 720)
MLP_IMAGES = 4


def _mlp_case(dev, seed=0):
    """Seeded bf16 tokens and a LayerNorm and Mlp of the cells' widths, with
    parameters of the size a trained block holds (weights N(0, 1 / fan_in),
    nonzero biases, LayerNorm's scale around 1)."""
    from xmm_superres_denoise_torch.models.swin_common import LayerNorm, Mlp

    b, t, c, h = MLP_SHAPE
    g = torch.Generator().manual_seed(seed)
    norm, mlp = LayerNorm(c), Mlp(c, h, c)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
        norm.bias.copy_(0.2 * torch.randn(c, generator=g))
        mlp.fc1.weight.copy_(torch.randn(h, c, generator=g) / c ** 0.5)
        mlp.fc1.bias.copy_(0.5 * torch.randn(h, generator=g))
        mlp.fc2.weight.copy_(torch.randn(c, h, generator=g) / h ** 0.5)
        mlp.fc2.bias.copy_(0.5 * torch.randn(c, generator=g))
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((b, t, c), generator=gd, device=dev) + torch.randn((c,), generator=gd, device=dev)
    return x.bfloat16(), norm.to(dev, torch.bfloat16).eval(), mlp.to(dev, torch.bfloat16).eval()


def phase_kernel_mlp_block(build_logs: dict) -> dict:
    """The fused MLP half-block at the zoo cells' shape: the kernel against
    its plain composition (finite, and per element within 2^-7 (|plain| +
    |y| + |y - b2|) + 2^-10 max|y|, y = plain - x: one bf16 ulp at each of
    the output's, the bias add's and fc2's roundings, and the sums' order
    beyond, else AssertionError), CUDA-event times of the kernel and the
    plain version, the kernel's device time (torch.profiler) and its bound
    by operations and bytes."""
    from xmm_superres_denoise_torch.ops.mlp_block import mlp_block, mlp_block_plain

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    x, norm, mlp = _mlp_case(dev)
    b, t, c, h = MLP_SHAPE
    with torch.inference_mode():
        got = mlp_block(x, norm, mlp)
        plain = mlp_block_plain(x, norm, mlp)
        y = plain.float() - x.float()
        b2 = mlp.fc2.bias.float()
        diff = (got.float() - plain.float()).abs()
        bound = 2.0**-7 * (plain.float().abs() + y.abs() + (y - b2).abs()) + 2.0**-10 * y.abs().max()
        err = float(diff.max())
        over = float((diff / bound).max())
        finite = bool(torch.isfinite(got.float()).all())
        same = float((got == plain).float().mean())
        del got, plain, y, diff, bound
        ms = _time_ms(lambda: mlp_block(x, norm, mlp))
        dev_ms = _device_ms(lambda: mlp_block(x, norm, mlp), iters=5)
        plain_ms = _time_ms(lambda: mlp_block_plain(x, norm, mlp), iters=5)
    tokens = b * t
    flops = 4 * tokens * c * h  # fc1 and fc2
    nbytes = 2 * tokens * c * 2 + 2 * (2 * c * h + h + 3 * c)  # x in, out out, the parameters
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    per_image = 1 / MLP_IMAGES
    say(f"[kernel] mlp_block ({b}, {t}, {c}) H={h}: max|diff| vs plain {err:.3e}, {over:.3f} of "
        f"the bound at most ({same:.2%} bitwise equal, finite {finite}); CUDA events: kernel "
        f"{ms:.4f} ms (device only {dev_ms:.4f}), plain {plain_ms:.4f} ms; bound {bound_ms:.4f} "
        f"ms by {bound_by} ({flops / 1e9:.1f} GFLOP: {flops / 989e12 * 1e3:.4f} ms; "
        f"{nbytes / 1e9:.3f} GB: {nbytes / 3.35e12 * 1e3:.4f} ms), {100 * bound_ms / ms:.1f} % "
        f"of it; per block an image: kernel {ms * per_image:.3f} ms, plain "
        f"{plain_ms * per_image:.3f}; ptxas: "
        f"{_ptxas_report(build_logs['mlp_block'], 'mlp_block_sm90_kernel')} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not finite or not over <= 1.0:
        raise AssertionError(f"mlp_block disagrees with its plain version: max|diff| {err}, "
                             f"{over} of the bound, finite {finite}")
    del x, norm, mlp
    torch.cuda.empty_cache()
    return {"name": "mlp_block (4, 173056, 180) H=720", "route": "cuda",
            "source": "xmm_superres_denoise_torch/csrc/mlp_block.cu", "replaces": None,
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launches_per_forward": None}  # per zoo run, from its bf16 forward


# the Swin blocks' qkv side at the cells' batch of 4 images of 416^2 tokens:
# name -> (C, window, shift, norm, run, blocks of this shape a forward of
# `run`): SwinIR's and SwinFIR's blocks; DRCT's five dense blocks at window
# 16, one per instance of the kernel, six of each a forward (C 180 to 276
# as its blocks 1 to 4 run them, blocks 2 and 4 shifted, and the widest, C
# 308, shifted); HAB's (its norm off, shifted)
QKV_SHAPES = {
    "swinir": (180, 13, 0, True, "swinir_sr", 36),
    "drct_c180": (180, 16, 0, True, "drct_sr_w16", 6),
    "drct_c212_shifted": (212, 16, 8, True, "drct_sr_w16", 6),
    "drct_c244": (244, 16, 0, True, "drct_sr_w16", 6),
    "drct_c276_shifted": (276, 16, 8, True, "drct_sr_w16", 6),
    "drct_c308_shifted": (308, 16, 8, True, "drct_sr_w16", 6),
    "hab_shifted": (180, 16, 8, False, "hat_sr", 36),
}
QKV_IMAGES = 4
QKV_MAX_UNEQUAL = 0.001  # share of outputs that may differ from the plain composition


def _qkv_case(c, norm_on, dev, seed=0):
    """Seeded bf16 tokens (4, 416^2, c) with a per-channel scale and offset,
    a LayerNorm (or None) and the qkv Linear (c -> 3c) with parameters of
    the size a trained block holds."""
    from xmm_superres_denoise_torch.models.swin_common import LayerNorm, dense_torch_init

    g = torch.Generator().manual_seed(seed)
    norm, qkv = LayerNorm(c), dense_torch_init(c, 3 * c)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
        norm.bias.copy_(0.2 * torch.randn(c, generator=g))
        qkv.weight.copy_(torch.randn(3 * c, c, generator=g) / c ** 0.5)
        qkv.bias.copy_(0.5 * torch.randn(3 * c, generator=g))
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    x = (torch.randn((QKV_IMAGES, 416 * 416, c), generator=gd, device=dev)
         * (0.5 + torch.rand((c,), generator=gd, device=dev))
         + torch.randn((c,), generator=gd, device=dev))
    norm = norm.to(dev, torch.bfloat16).eval() if norm_on else None
    return x.bfloat16(), norm, qkv.to(dev, torch.bfloat16).eval()


def phase_kernel_window_qkv(build_logs: dict) -> list:
    """The Swin blocks' qkv side (norm1, the cyclic shift, the window
    partition, the qkv GEMM and its bias) at `QKV_SHAPES`: the ptxas report
    of every instance, then per shape the kernel against its plain
    composition (finite, per element within 2^-7 (|plain| + |y|) + 2^-10
    max|y|, y = plain - bias, and at most QKV_MAX_UNEQUAL of the elements
    differing, else AssertionError), CUDA-event times of the kernel and the
    plain version, the kernel's device time (torch.profiler) and its bound
    by bytes and operations."""
    from xmm_superres_denoise_torch.ops.window_qkv import (
        K_STEPS, k_steps, window_qkv, window_qkv_plain)

    dev = torch.device("cuda:0")
    for ks in K_STEPS:
        for norm_on in (True, False):
            say(f"[kernel] window_qkv instance <{ks}, {norm_on}> ptxas: "
                f"{_ptxas_report(build_logs['window_qkv'], f'window_qkv_sm90_kernelILi{ks}ELb{int(norm_on)}E')}")
    entries = []
    for name, (c, ws, shift, norm_on, run, blocks) in QKV_SHAPES.items():
        t0 = time.perf_counter()
        x, norm, qkv = _qkv_case(c, norm_on, dev)
        size = (416, 416)
        with torch.inference_mode():
            got = window_qkv(x, size, ws, shift, norm, qkv)
            plain = window_qkv_plain(x, size, ws, shift, norm, qkv)
            p = plain.float()
            y = p - qkv.bias.float()
            diff = (got.float() - p).abs()
            bound = 2.0**-7 * (p.abs() + y.abs()) + 2.0**-10 * y.abs().max()
            err = float(diff.max())
            over = float((diff / bound).max())
            finite = bool(torch.isfinite(got.float()).all())
            unequal = float((got != plain).float().mean())
            del got, plain, p, y, diff, bound
            ms = _time_ms(lambda: window_qkv(x, size, ws, shift, norm, qkv))
            dev_ms = _device_ms(lambda: window_qkv(x, size, ws, shift, norm, qkv), iters=5)
            plain_ms = _time_ms(lambda: window_qkv_plain(x, size, ws, shift, norm, qkv), iters=5)
        tokens = x.shape[0] * x.shape[1]
        flops = 2 * tokens * c * 3 * c  # at the true C and 3C: padding is cost, not work
        nbytes = tokens * (2 * c + 6 * c) + 2 * (3 * c * c + 3 * c + (2 * c if norm_on else 0))
        bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
        per_image = blocks / QKV_IMAGES
        ks = k_steps(c)
        say(f"[kernel] window_qkv {name} ({QKV_IMAGES}, 416^2, {c}) window {ws} shift {shift} "
            f"norm {norm_on}: max|diff| vs plain {err:.3e}, {over:.3f} of the bound at most "
            f"({unequal:.3%} of the elements differ, finite {finite}); CUDA events: kernel "
            f"{ms:.4f} ms (device only {dev_ms:.4f}), plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB: "
            f"{nbytes / 3.35e12 * 1e3:.4f} ms; {flops / 1e9:.1f} GFLOP: "
            f"{flops / 989e12 * 1e3:.4f} ms), {100 * bound_ms / ms:.1f} % of it; {blocks} a {run} "
            f"forward: kernel {ms * per_image:.3f} ms an image, plain {plain_ms * per_image:.3f}; "
            f"ptxas: {_ptxas_report(build_logs['window_qkv'], f'window_qkv_sm90_kernelILi{ks}ELb{int(norm_on)}E')} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not finite or not over <= 1.0 or not unequal <= QKV_MAX_UNEQUAL:
            raise AssertionError(f"window_qkv {name} disagrees with its plain version: max|diff| "
                                 f"{err}, {over} of the bound, {unequal} unequal, finite {finite}")
        entries.append({"name": f"window_qkv {name}", "route": "cuda",
                        "source": "xmm_superres_denoise_torch/csrc/window_qkv.cu",
                        "replaces": None, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "run": run, "blocks_per_forward": blocks,
                        "launches_per_forward": None})  # from the zoo's bf16 forward of `run`
        del x, norm, qkv
        torch.cuda.empty_cache()
    return entries


# Restormer's MDTA Gram side at the cell's batch of 4 images of 416^2 and
# dim 48: name -> ((h, w), c, heads, calls a forward); levels 1-3 and the
# latent down and up, and the decoder's level 1 with the refinement at 2 dim
MDTA_SHAPES = {
    "level1": ((416, 416), 48, 1, 4),
    "level2": ((208, 208), 96, 2, 12),
    "level3": ((104, 104), 192, 4, 12),
    "latent": ((52, 52), 384, 8, 8),
    "decoder1": ((416, 416), 96, 1, 8),
}
MDTA_IMAGES = 4


def _mdta_case(hw, c, heads, dev, seed=0):
    """Seeded bf16 qkv (4, h, w, 3c) with a per-channel scale and offset, as
    the depthwise convolution leaves it, and a bf16 temperature a head."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((MDTA_IMAGES, *hw, 3 * c), generator=g, device=dev)
    x = x * (0.2 + torch.rand((3 * c,), generator=g, device=dev))
    x = x + 0.5 * torch.randn((3 * c,), generator=g, device=dev)
    temp = 0.5 + 1.5 * torch.rand((heads, 1, 1), generator=g, device=dev)
    return x.bfloat16(), temp.bfloat16()


def _mdta_f64(qkv, heads, temp):
    """softmax(temperature * q_hat k_hat^T) in f64 from qkv's bf16 values."""
    from xmm_superres_denoise_torch.ops.mdta_gram import heads_first

    q, k, _ = qkv.double().chunk(3, dim=-1)
    q, k = heads_first(q, heads), heads_first(k, heads)
    logits = (q @ k.transpose(-2, -1)) / (q.norm(dim=-1).clamp(min=1e-12)[..., :, None]
                                           * k.norm(dim=-1).clamp(min=1e-12)[..., None, :])
    return torch.softmax(logits * temp.double(), dim=-1)


def phase_kernel_mdta_gram(build_logs: dict) -> list:
    """MDTA's Gram side at the cell's five level shapes (batch 4, dim 48):
    the kernels against an f64 evaluation from the same bf16 q and k (finite,
    and per element within the plain bf16 composition's error plus one bf16
    ulp, else AssertionError), max|diff| against the plain version, CUDA-event
    times of the kernels and the plain version, the kernels' device time
    (torch.profiler), their byte bound (q and k read once, the attention
    written), ptxas's report of the Gram kernel's instance; then the sums over
    the 44 calls of one forward."""
    from xmm_superres_denoise_torch.ops.mdta_gram import mdta_attention_plain, mdta_gram

    dev = torch.device("cuda:0")
    entries, total = [], {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, (hw, c, heads, calls) in MDTA_SHAPES.items():
        t0 = time.perf_counter()
        qkv, temp = _mdta_case(hw, c, heads, dev)
        d = c // heads
        with torch.inference_mode():
            got = mdta_gram(qkv, heads, temp).double()
            plain = mdta_attention_plain(qkv, heads, temp).double()
            ref = _mdta_f64(qkv, heads, temp)
            ulp = torch.exp2(torch.floor(torch.log2(ref)) - 7)
            over = float(((got - ref).abs() - (plain - ref).abs()).div(ulp).max())
            err = float((got - plain).abs().max())
            finite = bool(torch.isfinite(got).all())
            same = float((got == plain).double().mean())
            del got, plain, ref, ulp
            ms = _time_ms(lambda: mdta_gram(qkv, heads, temp))
            dev_ms = _device_ms(lambda: mdta_gram(qkv, heads, temp), iters=5)
            plain_ms = _time_ms(lambda: mdta_attention_plain(qkv, heads, temp), iters=5)
        px = hw[0] * hw[1]
        nbytes = MDTA_IMAGES * (px * 2 * c + heads * d * d) * 2  # q and k in, the attention out
        bound_ms, bound_by = _bound(2 * MDTA_IMAGES * heads * d * d * px, nbytes, torch.bfloat16)
        instance = f"mdta_gram_sm90_kernelILi{48 if d <= 48 else 96}ELi{1 if d <= 64 else 2}E"
        say(f"[kernel] mdta_gram {name} ({MDTA_IMAGES}, {hw[0]}x{hw[1]}, 3x{c}) heads {heads} "
            f"d {d}: against f64, the plain version's error plus {over:.3f} bf16 ulp at most "
            f"(bound: 1); max|diff| vs plain {err:.3e} ({same:.2%} bitwise equal, finite "
            f"{finite}); CUDA events: kernels {ms:.4f} ms (device only {dev_ms:.4f}), plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.4f} GB), "
            f"{100 * bound_ms / ms:.1f} % of it; {calls} a forward; ptxas: "
            f"{_ptxas_report(build_logs['mdta_gram'], instance)} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not finite or not over <= 1.0:
            raise AssertionError(f"mdta_gram {name} is off its f64 value by more than the plain "
                                 f"version's error and an ulp: {over} ulp, finite {finite}")
        for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound_ms)):
            total[key] += calls * value
        entries.append({"name": f"mdta_gram {name} ({MDTA_IMAGES}, {px}, 3x{c}) heads {heads}",
                        "route": "cuda", "source": "xmm_superres_denoise_torch/csrc/mdta_gram.cu",
                        "replaces": None, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "calls_per_forward": calls,
                        "launches_per_forward": None})  # from restormer_denoise's bf16 forward
        del qkv, temp
        torch.cuda.empty_cache()
    per = {k: v / MDTA_IMAGES for k, v in total.items()}
    say(f"[kernel] mdta_gram over the 44 calls of one forward of {MDTA_IMAGES} at dim 48, per "
        f"image: kernels {per['ms']:.4f} ms (device only {per['device_ms']:.4f}), plain "
        f"{per['plain_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms by bytes: "
        f"{100 * per['bound_ms'] / per['ms']:.1f} % of it")
    return entries


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
    conv_i8.route_launches = dict.fromkeys(conv_i8.route_launches, 0)
    products = serve_files(ctx["files"], engine, tmp / "int8", hr_exp_ks=100.0,
                           model_name="esr_gen", batch_size=SERVE_BATCH)
    torch.cuda.synchronize()
    launches = {"conv_i8": conv_i8.launches, "int8_gemm": int8_gemm.launches,
                **{f"conv_i8 {r}": n for r, n in conv_i8.route_launches.items()}}
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
        f"(expected {expected}: the 128-channel wgmma route {launches['conv_i8 wgmma']}, the "
        f"(tap, channel) route {launches['conv_i8 wgmma_taps']}, one conv_first a batch), "
        f"int8_gemm launches {launches['int8_gemm']} (the exactness check at build); "
        f"{len(engine.int8_scales)} scale keys; products vs the f32 plain forward "
        f"max|diff| {np.abs(pred - ref).max() / hr_max:.3e} x hr_max, PSNR {psnr:.2f} dB on the "
        f"hr_max scale (gate {INT8_PSNR_DB:.0f} dB); engine alone (run_tiles, warm, host clock "
        f"incl. transfers) {engine_ms:.3f} ms/image ({time.perf_counter() - t0:.2f} s)"
    )
    if launches["conv_i8"] != expected or launches["int8_gemm"] < 1 \
            or launches["conv_i8 wgmma_taps"] != n_batches:
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


MESH_BATCHES = (4, 3)  # shards of 2; then 3 padded to 4 and trimmed, and a batch of 1 on mesh[0]


def _counted_launches(engine) -> list:
    """Wrap the engine's per-shard launch: [K2, K3] launches per replica."""
    from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8
    from xmm_superres_denoise_torch.ops.dense_block import dense_block

    per = [[0, 0] for _ in engine._replicas]
    index = {id(r): i for i, r in enumerate(engine._replicas)}
    real = engine._launch

    def launch(rep, host, with_input):
        k2, k3 = dense_block.launches, conv_i8.launches
        out = real(rep, host, with_input)
        per[index[id(rep)]][0] += dense_block.launches - k2
        per[index[id(rep)]][1] += conv_i8.launches - k3
        return out

    engine._launch = launch
    return per


def _expected_per_replica(n_rep: int, per_forward: int, batches=MESH_BATCHES) -> list:
    """Launches per replica of serving SERVE_FILES images at each of
    `batches`: a chunk of k > 1 is split over every replica, a chunk of 1
    runs on mesh[0]."""
    want = [0] * n_rep
    for b in batches:
        for i in range(0, SERVE_FILES, b):
            k = min(b, SERVE_FILES - i)
            for r in (range(n_rep) if k > 1 and n_rep > 1 else [0]):
                want[r] += per_forward
    return want


def _mesh_case(ctx, tmp: Path, mesh: tuple, singles: dict) -> None:
    """The engine over `mesh` against the single-card engines in f32, bf16
    and int8: the 4 files served at each of MESH_BATCHES, products held to
    the single card's (bitwise where they are, else the serving classes),
    launches per replica, the int8 scales, current_device, ms per image."""
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, serve_files
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.ops.int8_gemm import int8_gemm

    hr_max = ctx["hr_max"]
    tag = "+".join(mesh)
    for mode in ("f32", "bf16", "int8"):
        t0 = time.perf_counter()
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        device_before = torch.cuda.current_device()
        p_before = int8_gemm.launches
        engine = InferenceEngine(ctx["model_cfg"], ctx["ds_cfg"], ctx["params"], dtype=dtype,
                                 quantize=mode == "int8", mesh=mesh)
        per = _counted_launches(engine)
        lines, ok = [], True
        for b in MESH_BATCHES:
            served = {}
            for who, e in (("one", singles[mode]), ("mesh", engine)):
                products = serve_files(ctx["files"], e, tmp / f"mesh_{tag}_{who}_{mode}_{b}",
                                       hr_exp_ks=100.0, model_name="esr_gen", batch_size=b)
                served[who] = np.stack([read_image(p)[0] for _, p in products])
            got, want = served["mesh"], served["one"]
            bitwise = bool(np.array_equal(got, want))
            err = float(np.abs(got - want).max()) / hr_max
            if mode == "int8":
                psnr = _psnr(got, want, hr_max)
                lines.append(f"batch {b}: bitwise {bitwise}, max|diff| {err:.3e} x hr_max, "
                             f"PSNR {psnr:.2f} dB (gate {INT8_PSNR_DB:.0f})")
                ok &= bitwise or psnr >= INT8_PSNR_DB
            else:
                tol = SERVE_F32_RTOL if mode == "f32" else SERVE_BF16_RTOL
                lines.append(f"batch {b}: bitwise {bitwise}, max|diff| {err:.3e} x hr_max "
                             f"(tol {tol:.3g})")
                ok &= err <= tol
        same_device = torch.cuda.current_device() == device_before
        forward = 64 if mode == "int8" else 60
        want_launches = _expected_per_replica(len(mesh), forward)
        got_launches = [k3 if mode == "int8" else k2 for k2, k3 in per]
        p_launches = int8_gemm.launches - p_before
        scales = ""
        if mode == "int8":
            equal = engine.int8_scales == singles["int8"].int8_scales
            scales = f"; int8 scales equal to the single card's: {equal}; P launches {p_launches}"
            ok &= equal and p_launches == len(mesh)
        ms = {"one": [], "mesh": []}
        for who in ("one", "mesh", "mesh", "one"):
            e = singles[mode] if who == "one" else engine
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            e.run_tiles(ctx["raw"], batch_size=SERVE_FILES)
            torch.cuda.synchronize()
            ms[who].append((time.perf_counter() - t1) * 1e3 / SERVE_FILES)
        say(f"[mesh] {tag} {mode}: {'; '.join(lines)}; {'K3' if mode == 'int8' else 'K2'} "
            f"launches per replica {got_launches} (expected {want_launches}){scales}; "
            f"current_device unchanged: {same_device}{_restore_note(mesh, device_before)}; "
            f"run_tiles of {SERVE_FILES} images at "
            f"batch {SERVE_FILES} (warm, host clock incl. transfers): mesh {ms['mesh'][0]:.3f} / "
            f"{ms['mesh'][1]:.3f} ms/image, one card {ms['one'][0]:.3f} / {ms['one'][1]:.3f} "
            f"ms/image ({time.perf_counter() - t0:.2f} s)")
        if not (ok and same_device and got_launches == want_launches):
            raise AssertionError(f"[mesh] {tag} {mode}: disagrees with the single card")


def _restore_note(devices, current: int) -> str:
    """What `current_device unchanged` shows: a kernel's entry point sets
    its tensors' card and restores the caller's (`csrc/device_guard.cuh`),
    which only a card other than the current one exercises."""
    if all(torch.device(d).index == current for d in devices):
        return " (the entry points' restore not exercised: every replica is on the current card)"
    return " (the entry points' restore exercised by the replicas on other cards)"


def phase_mesh(ctx, tmp: Path) -> None:
    """Serving on a data mesh of cards: (a) `cli serve --bf16 --mesh_data
    -1` (every card; one on a one-card machine), bitwise equal to [cli]'s
    bf16 products; (b) `InferenceEngine(mesh=("cuda:0", "cuda:0"))`, two
    replicas on one card, and (c) with more than one card, the mesh over
    all of them, each against the single-card engines (`_mesh_case`)."""
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
    from xmm_superres_denoise_torch.ops.dense_block import dense_block

    t0 = time.perf_counter()
    common = ["--run_config", RUN_CONFIG, "--checkpoint", CHECKPOINT, "--batch", SERVE_BATCH]
    dense_block.launches = 0
    device_before = torch.cuda.current_device()
    rc, listing, secs = _cli(["serve", *ctx["files"], "--out", tmp / "mesh_cli", "--bf16",
                              "--mesh_data", -1, *common])
    launches = dense_block.launches
    if rc != 0 or len(listing) != SERVE_FILES:
        raise AssertionError(f"cli serve --mesh_data -1: exit code {rc}")
    pred = _served(listing)
    same = bool(np.array_equal(pred, ctx["preds"]["bf16"]))
    err = float(np.abs(pred - ctx["preds"]["bf16"]).max()) / ctx["hr_max"]
    n_cards = torch.cuda.device_count()
    same_device = torch.cuda.current_device() == device_before
    say(f"[mesh] (a) cli serve --bf16 --mesh_data -1 ({n_cards} card(s)): {SERVE_FILES} files in "
        f"{secs:.3f} s, dense_block launches {launches}; products "
        f"bitwise equal to [cli]'s bf16: {same} (max|diff| {err:.3e} x hr_max); current_device "
        f"unchanged: {same_device}"
        f"{_restore_note([f'cuda:{i}' for i in range(n_cards)], device_before)} "
        f"({time.perf_counter() - t0:.2f} s)")
    # one card: the same engine as [cli]'s; several: other per-card batches, the bf16 class
    if not (same if n_cards == 1 else err <= SERVE_BF16_RTOL) or not same_device:
        raise AssertionError(f"[mesh] (a): bitwise {same}, max|diff| {err}")
    if launches != 60 * sum(_expected_per_replica(n_cards, 1, (SERVE_BATCH,))):
        raise AssertionError(f"[mesh] (a): {launches} launches")

    singles = dict(ctx["engines"])
    singles["int8"] = InferenceEngine(ctx["model_cfg"], ctx["ds_cfg"], ctx["params"],
                                      dtype=torch.bfloat16, quantize=True)
    # calibrates on the 4 images at once, as each mesh engine's first batch will
    singles["int8"].run_tiles(ctx["raw"], batch_size=MESH_BATCHES[0])
    _mesh_case(ctx, tmp, ("cuda:0", "cuda:0"), singles)
    if n_cards > 1:
        _mesh_case(ctx, tmp, tuple(f"cuda:{i}" for i in range(n_cards)), singles)
    else:
        say("[mesh] (c) not run: torch.cuda.device_count() is 1, and a mesh of distinct cards "
            "needs two or more")
    say(f"[mesh] ({time.perf_counter() - t0:.2f} s)")


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


EVENTS_N = 4 * 2**20  # a 20 ks full-frame EPIC-pn observation with its background
EVENTS_T0 = 5.6e8  # XMM mission elapsed time: an f32 ulp is 64 s there
EVENTS_SPAN_S = 30_000.0
EVENTS_DET = (-16120, 16119, -16440, 16439)  # DETX, DETY TLMIN/TLMAX: 403 x 411 at bin 80
EVENTS_MAX_EXPO_KS = 20.0
EVENTS_GTI_RANGE = (20, 40)  # GTIs the FBKTSR curve's flares cut before capping
EVENTS_EDGE = 256  # events placed exactly on each edge of each capped GTI, and 1 s either side
EVENTS_TIMED = 5  # warm calls per timed binning route
E2E_PPS = "P0123456789PNS003PIEVLI0000.FTZ"


def _rate_curve(g):
    """A flaring-background curve (FBKTSR) over the observation: a quiet
    rate with short flares, 10 s bins."""
    t = EVENTS_T0 + np.arange(0.0, EVENTS_SPAN_S, 10.0)
    rate = g.uniform(0.1, 0.3, t.size)
    for s in g.choice(t.size - 30, 30, replace=False):
        rate[s : s + g.integers(3, 30)] = g.uniform(1.0, 9.0)
    return t, rate


def _in_gti(t, start, stop):
    """Membership of times `t` in sorted, disjoint [start, stop) intervals."""
    k = np.searchsorted(start, t, side="right") - 1
    return (k >= 0) & (t < stop[np.maximum(k, 0)])


def _independent_count(cols, gti, flag_mask, pattern_max):
    """The detxy image counted here without the port: the evselect
    selection restated with numpy (GTI membership by searchsorted over the
    sorted, disjoint GTIs) and np.add.at into the 411 x 403 grid."""
    x0, x1, y0, y1 = EVENTS_DET
    in_gti = _in_gti(cols["TIME"], gti.start, gti.stop)
    sel = ((cols["PI"] >= 500) & (cols["PI"] <= 2000) & ((cols["FLAG"] & flag_mask) == 0)
           & (cols["PATTERN"] <= pattern_max) & in_gti)
    ix = (cols["DETX"][sel] - x0) // 80
    iy = (cols["DETY"][sel] - y0) // 80
    nx, ny = (x1 - x0 + 1) // 80, (y1 - y0 + 1) // 80
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    img = np.zeros((ny, nx), np.float32)
    np.add.at(img, (iy[inside], ix[inside]), 1.0)
    return img


def phase_events(tmp: Path) -> dict:
    """A synthetic 4 M-event EPIC-pn list in a PPS directory, loaded through
    the native reader and binned on the card, on the host and by an
    independent count: bitwise equal, for the EPN cuts and the EMOS mask."""
    from xmm_superres_denoise_torch.data import native_loader
    from xmm_superres_denoise_torch.io import native_bintable
    from xmm_superres_denoise_torch.io.fits import write_bintable
    from xmm_superres_denoise_torch.ops import events as ev

    t0 = time.perf_counter()
    g = np.random.default_rng(14)
    t_rate, rate = _rate_curve(g)
    gti_all = ev.gti_from_rate(t_rate, rate, 0.5)
    gti = ev.cap_gti_exposure(gti_all, EVENTS_MAX_EXPO_KS)
    x0, x1, y0, y1 = EVENTS_DET
    n = EVENTS_N
    times = g.uniform(EVENTS_T0, EVENTS_T0 + EVENTS_SPAN_S, n)
    edges = np.concatenate([gti.start, gti.stop])
    for i, e in enumerate(edges):  # exactly on each edge, and 1 s either side
        s = i * 3 * EVENTS_EDGE
        times[s : s + EVENTS_EDGE] = e
        times[s + EVENTS_EDGE : s + 2 * EVENTS_EDGE] = e - 1.0
        times[s + 2 * EVENTS_EDGE : s + 3 * EVENTS_EDGE] = e + 1.0
    cols = {
        "TIME": np.sort(times),
        "DETX": g.integers(x0, x1 + 1, n).astype(np.int32),
        "DETY": g.integers(y0, y1 + 1, n).astype(np.int32),
        "X": g.integers(20_000, 32_000, n).astype(np.int32),
        "Y": g.integers(20_000, 32_000, n).astype(np.int32),
        "PI": g.integers(150, 12_001, n).astype(np.int32),
        "PATTERN": g.integers(0, 13, n).astype(np.int32),
        "FLAG": g.choice(np.array([0] * 12 + [1, 0x10, 0x2000, 0x40000000], np.int32), n),
    }
    pps = tmp / "pps"
    pps.mkdir()
    hdr = {"INSTRUME": "EPN", "ONTIME": EVENTS_SPAN_S, "TSTART": EVENTS_T0,
           "TSTOP": EVENTS_T0 + EVENTS_SPAN_S, "OBS_ID": "0123456789",
           "REFXCRPX": 25921, "REFYCRPX": 25921, "REFXCRVL": 187.701875, "REFYCRVL": 12.389,
           "REFXCDLT": -1.38888888888889e-05, "REFYCDLT": 1.38888888888889e-05}
    evl = write_bintable(pps / E2E_PPS, cols, extname="EVENTS", header=hdr,  # uncompressed
                         column_limits={"DETX": (x0, x1), "DETY": (y0, y1),
                                        "X": (1, 51840), "Y": (1, 51840)})
    write_bintable(pps / "P0123456789PNS003FBKTSR0000.FTZ", {"TIME": t_rate, "RATE": rate},
                   extname="RATE", header={"FLCUTTHR": 0.5},
                   primary_header={"INSTRUME": "EPN", "OBS_ID": "0123456789"})
    (pps / "P0123456789OBX000CALIND0000.FTZ").write_bytes(b"\x00")
    ta = EVENTS_T0 + np.linspace(0.0, EVENTS_SPAN_S, 3000)
    write_bintable(pps / "P0123456789OBX000ATTTSR0000.FTZ",
                   {"TIME": ta, "AHFRA": 187.7 + g.normal(0, 1e-3, ta.size),
                    "AHFDEC": 12.39 + g.normal(0, 1e-3, ta.size),
                    "AHFPA": 109.3 + g.normal(0, 1e-2, ta.size)}, extname="ATTHK")
    write_s = time.perf_counter() - t0
    mb = evl.stat().st_size / 2**20

    tb = time.perf_counter()
    native_loader.get_lib()  # the reader's g++ build at first use, kept out of the load time
    build_s = time.perf_counter() - tb
    t1 = time.perf_counter()
    events = ev.load_event_list(evl)
    load_s = time.perf_counter() - t1
    # load_event_list falls back to the Python reader only where this returns None
    native = native_bintable.read_bintable_native(evl, ["TIME"], extname="EVENTS")
    reader = "python" if native is None else "native"
    say(f"[events] {n} events ({mb:.1f} MiB, uncompressed), {len(gti_all.start)} GTIs from the "
        f"FBKTSR flares, {len(gti.start)} after the {EVENTS_MAX_EXPO_KS:.0f} ks cap "
        f"({gti.exposure:.1f} s), {EVENTS_EDGE} events on each GTI edge and 1 s either side; "
        f"written in {write_s:.2f} s; the native reader built in {build_s:.2f} s; load "
        f"{load_s:.3f} s through the {reader} reader "
        f"({n / load_s / 1e6:.2f} Mevents/s)")
    # what a rebase to the first event and an f32 cast (the JAX package's
    # device route) would misplace: events within half an f32 ulp of an edge
    t_first = cols["TIME"][0]
    f32 = [(a - t_first).astype(np.float32) for a in (cols["TIME"], gti.start, gti.stop)]
    flips = int(np.sum(_in_gti(*f32) != _in_gti(cols["TIME"], gti.start, gti.stop)))
    say(f"[events] events whose GTI membership an f32 cast after a rebase would flip: {flips} "
        "(the card compares the float64 times)")
    if reader != "native" or not EVENTS_GTI_RANGE[0] <= len(gti_all.start) <= EVENTS_GTI_RANGE[1]:
        raise AssertionError(f"events: reader {reader}, {len(gti_all.start)} GTIs")

    dev = torch.device("cuda:0")
    images = {}
    for inst in ("EPN", "EMOS1"):
        filt = ev.instrument_filter(inst)
        kw = dict(pattern_max=filt["pattern_max"], flag_mask=filt["flag_mask"])
        card, _ = ev.bin_events(events, gti, device=dev, **kw)  # warm: allocator, first launch
        host, meta = ev.bin_events(events, gti, **kw)
        ref = _independent_count(cols, gti, filt["flag_mask"], filt["pattern_max"])
        same = bool(np.array_equal(card, host) and np.array_equal(host, ref))

        th = time.perf_counter()
        for _ in range(EVENTS_TIMED):
            ev.bin_events(events, gti, **kw)
        host_ms = (time.perf_counter() - th) * 1e3 / EVENTS_TIMED
        torch.cuda.synchronize()
        tc = time.perf_counter()
        for _ in range(EVENTS_TIMED):
            ev.bin_events(events, gti, device=dev, **kw)  # ends in the copy back: synchronous
        copy_ms = (time.perf_counter() - tc) * 1e3 / EVENTS_TIMED
        args = ev._device_inputs(events, gti, 2**20, dev)
        static = dict(nx=meta["nx"], ny=meta["ny"], bin_size=80, x0=meta["x0"], y0=meta["y0"],
                      pi_lo=500, pi_hi=2000, **kw)
        card_ms = _time_ms(lambda: ev._bin_events_device(*args, **static))
        rejected = n - int(host.sum())
        one_bin = torch.full((rejected,), meta["nx"] * meta["ny"], device=dev)
        spread = one_bin + torch.arange(rejected, device=dev) % ev.OVERFLOW_BINS
        size = meta["nx"] * meta["ny"] + ev.OVERFLOW_BINS
        one_ms, spread_ms = (_time_ms(lambda i=i: torch.bincount(i, minlength=size))
                             for i in (one_bin, spread))
        say(f"[events] {inst} cuts: card, host and independent count bitwise equal: {same} "
            f"({int(host.sum())} counts in {host.shape}); host bin {host_ms:.3f} ms "
            f"({n / host_ms / 1e3:.2f} Mevents/s); card bin incl. the host->device copy "
            f"{copy_ms:.3f} ms ({n / copy_ms / 1e3:.2f} Mevents/s); card bin alone (CUDA "
            f"events) {card_ms:.3f} ms ({n / card_ms / 1e3:.2f} Mevents/s); the bincount of "
            f"the {rejected} rejected events into one overflow bin {one_ms:.3f} ms, spread "
            f"over {ev.OVERFLOW_BINS} bins (the route's) {spread_ms:.3f} ms")
        if not same:
            raise AssertionError(f"events {inst}: card, host and independent count differ")
        images[inst] = host
    say(f"[events] ({time.perf_counter() - t0:.2f} s)")
    return {"pps": pps, "detxy": images["EPN"], "gti": gti}


def _e2e_cli(argv) -> tuple:
    """`cli end2end` (or another subcommand) in-process, with the count of
    each kernel's launches: (exit code, JSON, seconds, {kernel: launches})."""
    from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.int8_gemm import int8_gemm

    dense_block.launches = conv_i8.launches = int8_gemm.launches = 0
    rc, out, secs = _cli(argv)
    return rc, out, secs, {"K2": dense_block.launches, "K3": conv_i8.launches,
                           "P": int8_gemm.launches}


def phase_end2end(ctx, tmp: Path, events: dict) -> dict:
    """The obsid chain through the command line with an ONNX checkpoint the
    port exported from the trained weights: end2end in f32, bf16 and int8
    (twice), detxy and verify. Returns the launches of each run."""
    from xmm_superres_denoise_torch.infer.onnx_export import export_rrdb_onnx_model
    from xmm_superres_denoise_torch.infer.onnx_runtime_lite import read_onnx_model, run_graph
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, infer_file
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.ops.precision import true_f32

    t0 = time.perf_counter()
    hr_max, f32_engine = ctx["hr_max"], ctx["engines"]["f32"]
    onnx = export_rrdb_onnx_model(f32_engine.model, None, tmp / "weights.onnx")
    graph = read_onnx_model(onnx)
    with torch.inference_mode():
        x = f32_engine.prepare(torch.from_numpy(ctx["raw"][:1]).to("cuda:0"))
        want = f32_engine.normalizer.denormalize_hr(f32_engine.predict(x))
        with true_f32():
            run_graph(graph, {"input": x.permute(0, 3, 1, 2)}, device="cuda:0")
            torch.cuda.synchronize()
            tg = time.perf_counter()
            out = run_graph(graph, {"input": x.permute(0, 3, 1, 2)}, device="cuda:0")["output"]
            torch.cuda.synchronize()
            graph_ms = (time.perf_counter() - tg) * 1e3
        got = f32_engine.normalizer.denormalize_hr(out.permute(0, 2, 3, 1))
        err = float(torch.max(torch.abs(got - want)))
    say(f"[end2end] exported {onnx.name} ({onnx.stat().st_size / 2**20:.2f} MiB, "
        f"{len(graph.nodes)} nodes, {len(graph.initializers)} initializers); run_graph on "
        f"cuda:0 ({graph_ms:.2f} ms, host clock) vs the engine's f32 forward on one tile: "
        f"max|diff| {err / hr_max:.3e} x hr_max (tol {SERVE_F32_RTOL:.0e})")
    if not err <= SERVE_F32_RTOL * hr_max:
        raise AssertionError(f"end2end: run_graph disagrees with the f32 engine: {err}")

    base = ["end2end", "--pps", events["pps"], "--checkpoint", onnx, "--run_config", RUN_CONFIG]
    scales = tmp / "e2e_int8_scales.json"
    modes = {"f32": [], "bf16": ["--bf16"], "int8 calibrate": ["--int8", "--bf16",
             "--int8_scales", scales], "int8 load": ["--int8", "--bf16", "--int8_scales", scales]}
    runs, launches = {}, {}
    for mode, flags in modes.items():
        rc, out, secs, counts = _e2e_cli([*base, "--out", tmp / f"e2e_{mode.replace(' ', '_')}",
                                          *flags])
        if rc != 0:
            raise AssertionError(f"cli end2end {mode}: exit code {rc}")
        runs[mode], launches[mode] = out, counts
        say(f"[end2end] cli end2end {mode}: {secs:.3f} s, latency_s {out['latency_s']}, "
            f"launches {counts}")

    detxy, dhdr = read_image(runs["f32"]["detxy"])
    same_detxy = bool(np.array_equal(detxy.astype(np.float32), events["detxy"]))
    int8_engine = InferenceEngine(
        ctx["model_cfg"], ctx["ds_cfg"], ctx["params"], dtype=torch.bfloat16, quantize=True,
        int8_scales=json.loads(scales.read_text())["scales"])
    refs = {"f32": ctx["engines"]["f32"], "bf16": ctx["engines"]["bf16"],
            "int8 calibrate": int8_engine, "int8 load": int8_engine}
    preds, same = {}, {}
    for mode, engine in refs.items():
        _, p_pred = infer_file(runs[mode]["detxy"], engine, tmp / f"e2e_ref_{mode[:4]}", 100.0,
                               "esr_gen")
        preds[mode] = read_image(runs[mode]["prediction"])[0]
        same[mode] = bool(np.array_equal(preds[mode], read_image(p_pred)[0]))
    psnr = _psnr(preds["int8 load"], preds["f32"], hr_max)
    say(f"[end2end] detxy product ({detxy.shape}, EXPOSURE {dhdr['EXPOSURE']}, RA_PNT "
        f"{dhdr['RA_PNT']:.5f} from the ATTTSR) bitwise equal to [events]' host image: "
        f"{same_detxy}; predictions bitwise equal to infer_file through engines loaded from "
        f"the npz: {same}; int8 vs f32 PSNR {psnr:.2f} dB on the hr_max scale (gate "
        f"{INT8_PSNR_DB:.0f})")
    if not same_detxy or not all(same.values()) or psnr < INT8_PSNR_DB:
        raise AssertionError(f"end2end: detxy {same_detxy}, bitwise {same}, int8 {psnr} dB")
    want = {"f32": {"K2": 60, "K3": 0}, "bf16": {"K2": 60, "K3": 0},
            "int8 calibrate": {"K2": 0, "K3": 64}, "int8 load": {"K2": 0, "K3": 64}}
    for mode, counts in launches.items():
        if any(counts[k] != v for k, v in want[mode].items()) or (
                mode.startswith("int8") and counts["P"] < 1):
            raise AssertionError(f"end2end {mode}: launches {counts}, expected {want[mode]}")

    # the module entry point in its own process, f32: bitwise equal in-process
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "xmm_superres_denoise_torch.cli", *map(str, base),
         "--out", str(tmp / "e2e_subprocess")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python -m ...cli end2end: exit code {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    same_sub = bool(np.array_equal(read_image(sub["prediction"])[0], preds["f32"]))
    rc, det, _, _ = _e2e_cli(["detxy", "--pps", events["pps"], "--out", tmp / "e2e_detxy"])
    same_det = rc == 0 and Path(det["detxy"]).read_bytes() == Path(runs["f32"]["detxy"]).read_bytes()
    say(f"[end2end] python -m xmm_superres_denoise_torch.cli end2end (own process): latency_s "
        f"{sub['latency_s']}, prediction bitwise equal in-process: {same_sub}; cli detxy "
        f"product byte-identical to end2end's: {same_det} ({time.perf_counter() - t1:.2f} s)")
    if not (same_sub and same_det):
        raise AssertionError(f"end2end subprocess {same_sub}, detxy {same_det}")

    t2 = time.perf_counter()
    data = tmp / "verify_data"
    data.mkdir()
    for f in ctx["files"]:
        (data / Path(f).name).write_bytes(Path(f).read_bytes())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        from xmm_superres_denoise_torch.cli import main

        rc = main(["verify", "--onnx", str(onnx), "--run_config", str(RUN_CONFIG),
                   "--data", str(data)])
    report = json.loads(out.getvalue())
    rows = report["files"]
    say(f"[end2end] cli verify --onnx {onnx.name} on the {len(rows)} [serve] files: exit code "
        f"{rc}, runtime {report['runtime']}, max|diff| {[r['max_abs_diff'] for r in rows]} "
        f"(tol {report['tol']}), PSNR vs ONNX {[r['psnr_vs_onnx'] for r in rows]} dB, SSIM "
        f"{[r['ssim_vs_onnx'] for r in rows]}, int8 {report.get('int8_psnr_db')} dB (gate "
        f"{INT8_PSNR_DB:.0f}), passed {report['passed']} ({time.perf_counter() - t2:.2f} s)")
    if rc != 0 or not report["passed"]:
        raise AssertionError(f"cli verify: exit code {rc}, {report}")
    say(f"[end2end] ({time.perf_counter() - t0:.2f} s)")
    return launches


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


def _s2d_route_grads(model, loss, x, target, cpu_grads):
    """The f32 model's S2D training route on the card: per-group gradient
    error against the CPU model's, K1 launches per forward+backward, and ms
    per forward+backward in f32 (TF32 off) and bf16 (the parameters cast
    inside the forward, as the trainer's bf16 step does)."""
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_train_apply

    apply = make_s2d_train_apply(model)

    def step(dtype):
        for p in model.parameters():
            p.grad = None
        v = loss(apply(model, x.to(dtype)).float(), target)
        v.backward()
        return v.detach()

    launches, ms = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # TF32 off for the f32 step only, as the trainer runs its steps
        with true_f32() if name == "f32" else contextlib.nullcontext():
            dense_block_s2d.launches = 0
            step(dtype)
            torch.cuda.synchronize()
            launches[name] = dense_block_s2d.launches
            if name == "f32":
                groups: dict = {}
                for n, p in model.named_parameters():
                    g = p.grad
                    if g is None or not torch.isfinite(g).all():
                        raise AssertionError(f"[grad] S2D route {n}: gradient {g}")
                    rel = float((g.double().cpu() - cpu_grads[n].double()).abs().max()) / float(
                        cpu_grads[n].abs().max())
                    groups[_param_group(n)] = max(groups.get(_param_group(n), 0.0), rel)
            elif any(p.grad is None or not torch.isfinite(p.grad).all()
                     for p in model.parameters()):
                raise AssertionError("[grad] S2D route bf16: a gradient is missing or not finite")
            ms[name] = _time_ms(lambda: step(dtype), iters=5)
    return groups, launches, ms


def phase_grad(ctx) -> dict:
    """Gradients through K2: the full-width SR model with the trained
    weights, f32 with TF32 off, the run config's loss; one forward+backward
    on the card (dense blocks through `_DenseBlockFn`: K2 forward,
    recomputed backward) against the same on the CPU model; the same
    through the S2D training route (K1); a bf16 forward+backward; the
    inference-only ops' refusals. Returns K1's launches in one S2D training
    step, by dtype."""
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

    # the S2D training route (make_s2d_train_apply): the same function with
    # the dense blocks on K1, recomputed in the original domain backward
    s2d_groups, s2d_launches, s2d_ms = _s2d_route_grads(model, loss, xc, tc, cpu_grads)
    s2d_worst = max(s2d_groups.values())
    say(
        f"[grad] S2D training route (make_s2d_train_apply, f32, TF32 off): dense_block_s2d "
        f"launches in the step {s2d_launches['f32']} (expected 60: 12 blocks x 5 levels, the "
        f"forward's); largest max|g_card - g_cpu| / max|g_cpu| per group: "
        + ", ".join(f"{k} {e:.3e}" for k, e in s2d_groups.items())
        + f" (tol {GRAD_RTOL:.0e}); forward+backward f32 {s2d_ms['f32']:.3f} ms, bf16 "
        f"{s2d_ms['bf16']:.3f} ms ({s2d_launches['bf16']} launches); the model route (K2) f32 "
        f"{ms:.3f} ms (CUDA events, warm)"
    )
    if s2d_launches != {"f32": 60, "bf16": 60} or not s2d_worst <= GRAD_RTOL:
        raise AssertionError(f"[grad] S2D route: {s2d_launches} launches, worst {s2d_worst}")

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
    return s2d_launches


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


def phase_eval(tmp: Path) -> Path:
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
    return root


TRAIN_BATCH = 8  # the run config's batch


def _grads(fn, tensors, grad_out):
    """Gradients of `fn(*tensors)` against `grad_out` for every tensor."""
    inputs = [t.detach().requires_grad_() for t in tensors]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*inputs), inputs, grad_out)


def phase_train_routes() -> None:
    """The measurements that chose the S2D training route's backward and
    its outer convolutions, at the trainer's batch of 8, 416^2 (208^2 x 128
    in the S2D domain), f32 with TF32 off and bf16 as the trainer runs it,
    ms per call:

    * a dense block's backward (recompute + data and weight gradients): in
      the original domain at C = 32 through the plain version (f32
      convolutions, each level rounded to the dtype) and as convolutions in
      the dtype (channels_last); in the S2D domain at C = 128 as
      convolutions in the dtype, NCHW and channels_last, through the weight
      transform. `block_grads`, the backward of `_DenseBlockS2DFn` and
      `_DenseBlockFn`, runs the first in f32 and the second in bf16;
    * forward+backward of trunk_conv, upconv and HRconv in the original
      domain (what the route runs) and in the S2D domain (what JAX runs)."""
    from xmm_superres_denoise_torch.models.rrdb import conv3x3_nhwc
    from xmm_superres_denoise_torch.ops.dense_block import (
        block_grads,
        cudnn_block,
        dense_block_reference,
    )
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.ops.space_to_depth import s2d, s2d_conv_weights_torch

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    needs = (True,) * 11
    rows = []
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, flat = _block_inputs((TRAIN_BATCH, 416, 416, 32), dtype, dev, seed=3)
        g = torch.randn_like(x)
        x4, g4 = s2d(x).contiguous(), s2d(g).contiguous()

        def s2d_domain(layout):
            fmt = torch.contiguous_format if layout == "NCHW" else torch.channels_last

            def block(xin, *p):
                pairs = [s2d_conv_weights_torch(p[i], p[i + 1]) for i in range(0, 10, 2)]
                return _library_block(
                    xin, [w.permute(3, 2, 0, 1).contiguous(memory_format=fmt) for w, _ in pairs],
                    [b for _, b in pairs])
            xin, gin = x4.permute(0, 3, 1, 2), g4.permute(0, 3, 1, 2)
            if layout == "NCHW":
                xin, gin = xin.contiguous(), gin.contiguous()
            return lambda: _grads(block, (xin, *flat), gin)

        calls = {
            "original C=32, plain version (f32 convolutions)": (
                lambda: _grads(dense_block_reference, (x, *flat), g)),
            f"original C=32, {name} convolutions channels_last": (
                lambda: _grads(cudnn_block, (x, *flat), g)),
            f"S2D C=128, {name} convolutions NCHW": s2d_domain("NCHW"),
            f"S2D C=128, {name} convolutions channels_last": s2d_domain("channels_last"),
        }
        route = 0 if name == "f32" else 1
        with true_f32() if name == "f32" else contextlib.nullcontext():
            block_grads(x, flat, needs, g)  # the route itself runs
            times = [(label, _time_ms(fn, iters=5, warmup=1)) for label, fn in calls.items()]
        rows.append(f"{name}: " + ", ".join(
            f"{label} {ms:.3f}{' (block_grads)' if i == route else ''}"
            for i, (label, ms) in enumerate(times)))
    say("[train-routes] one dense block's backward at batch 8 (416^2 x 32 = 208^2 x 128), ms: "
        + "; ".join(rows))

    rows = []
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for conv, side, cin, cout in (("trunk_conv", 416, 32, 32), ("upconv", 416, 32, 128),
                                      ("HRconv", 832, 32, 32)):
            g = torch.Generator(device=dev).manual_seed(1)
            x = torch.rand((TRAIN_BATCH, side, side, cin), generator=g, device=dev).to(dtype)
            w = (0.05 * torch.randn((3, 3, cin, cout), generator=g, device=dev)).to(dtype)
            b = torch.zeros(cout, device=dev, dtype=dtype)

            def fwd_bwd(domain):
                xi, wi, bi = (t.detach().requires_grad_() for t in (x, w, b))
                if domain == "original":
                    y = conv3x3_nhwc(xi, wi.permute(3, 2, 0, 1), bi)
                else:
                    w4, b4 = s2d_conv_weights_torch(wi, bi)
                    y = conv3x3_nhwc(s2d(xi), w4.permute(3, 2, 0, 1), b4)
                return torch.autograd.grad(y, [xi, wi, bi], torch.ones_like(y))

            with true_f32():
                orig = _time_ms(lambda: fwd_bwd("original"), iters=5, warmup=1)
                s2d_ms = _time_ms(lambda: fwd_bwd("s2d"), iters=5, warmup=1)
            rows.append(f"{name} {conv} {orig:.3f} / {s2d_ms:.3f}")
    say("[train-routes] outer convolutions' forward+backward at batch 8, original domain / S2D "
        "domain (channels_last) ms: " + ", ".join(rows)
        + f" ({time.perf_counter() - t0:.2f} s)")


def _train_config(tmp: Path, root: Path, name: str, epochs: int, **trainer) -> Path:
    """The shipped esr_gen_sr run config with `epochs`, its checkpoints
    under `tmp/name`, the dataset directory `root` and the `trainer` keys."""
    text = RUN_CONFIG.read_text()
    text = re.sub(r"^epochs = .*$", f"epochs = {epochs}", text, count=1, flags=re.M)
    text = re.sub(r'^checkpoint_root = .*$', f'checkpoint_root = "{tmp / name}"', text,
                  count=1, flags=re.M)
    text = re.sub(r'^directory = .*$', f'directory = "{root}"', text, count=1, flags=re.M)
    for key, value in trainer.items():
        if re.search(rf"^{key} = ", text, flags=re.M):
            text = re.sub(rf"^{key} = .*$", f"{key} = {value}", text, count=1, flags=re.M)
        else:
            text = text.replace("[trainer]\n", f"[trainer]\n{key} = {value}\n", 1)
    path = tmp / f"{name}.toml"
    path.write_text(text)
    return path


def _cli_json(argv) -> tuple:
    """`cli.main(argv)` in-process: (exit code, its standard output as JSON)."""
    from xmm_superres_denoise_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, (json.loads(out.getvalue()) if out.getvalue().strip() else None)


def _timed_fit(argv, epochs: int) -> tuple:
    """`cli fit` in-process with each train step timed (CUDA events) and
    its K1 and K2 launches counted; returns (rc, JSON, per-epoch rows)."""
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
    from xmm_superres_denoise_torch.train import loop

    log = []
    real = loop.make_train_step

    def timed_make(*a, **k):
        step = real(*a, **k)

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            k1, k2 = dense_block_s2d.launches, dense_block.launches
            start.record()
            out = step(state, batch)
            end.record()
            end.synchronize()
            log.append((start.elapsed_time(end), dense_block_s2d.launches - k1,
                        dense_block.launches - k2))
            return out

        return timed

    loop.make_train_step = timed_make
    try:
        rc, logs = _cli_json(argv)
    finally:
        loop.make_train_step = real
    per = max(len(log) // epochs, 1)
    rows = []
    for e in range(epochs):
        part = log[e * per:(e + 1) * per]
        warm = part[1:] if e == 0 and len(part) > 1 else part  # the first step builds and warms
        rows.append({"steps": len(part), "ms": sum(t for t, _, _ in warm) / len(warm),
                     "each": [t for t, _, _ in part],
                     "k1": sorted({a for _, a, _ in part}), "k2": sorted({b for _, _, b in part})})
    return rc, logs, rows


def phase_train(tmp: Path, root: Path) -> None:
    """Training on the card through the command line: `cli fit` of the
    shipped esr_gen_sr run config (full width, batch 8, 416^2 -> 832^2,
    f32, s2d_train as shipped: the dense blocks on K1) for 2 epochs on the
    synthetic tree, the files a fit leaves, `cli test` bitwise equal to the
    fit's own test; one epoch in bf16 and one with s2d_train = false (K2);
    and one DDP step on NCCL at world size 1 against the unwrapped step."""
    from xmm_superres_denoise_torch.ops.dense_block import dense_block
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d

    t0 = time.perf_counter()
    with contextlib.chdir(tmp):  # the data module writes its splits under ./res/splits
        run = _train_config(tmp, root, "fit_f32", 2)
        dense_block_s2d.launches = dense_block.launches = 0
        rc, fit_logs, rows = _timed_fit(["fit", run], 2)
        k1_total, k2_total = dense_block_s2d.launches, dense_block.launches
        fit_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[train] cli fit exited {rc}")
        ckroot = tmp / "fit_f32" / "esr_gen"
        history = [json.loads(line) for line in (ckroot / "history.jsonl").read_text().splitlines()]
        for e, (row, h) in enumerate(zip(rows, history)):
            say(f"[train] epoch {e}: {row['steps']} steps, {row['ms']:.1f} ms per train step "
                f"(CUDA events{', warm steps' if e == 0 else ''}), dense_block_s2d launches per "
                f"step {row['k1']}, dense_block {row['k2']}; train/loss {h['train/loss']:.6f}, "
                f"val/loss {h['val/loss']:.6f}; {h['time_s']:.1f} s")
        files = {
            "ckpts": sorted(p.name for p in (ckroot / "ckpts").glob("*.pt")),
            "best.json": json.loads((ckroot / "best.json").read_text()),
            "history.jsonl": len(history),
            "tb": [p.name for p in (ckroot / "tb").glob("events.out.tfevents.*")],
            "run_config.toml": (ckroot / "run_config.toml").exists(),
        }
        t1 = time.perf_counter()
        rc_test, test_logs = _cli_json(["test", run])
        test_s = time.perf_counter() - t1
        bad = [k for k, v in fit_logs.items() if v is None or not math.isfinite(v)]
        say(f"[train] cli fit: 2 epochs in {fit_s:.1f} s, K1 launches {k1_total}, K2 launches "
            f"{k2_total}; files {files}; cli test (best checkpoint) rc {rc_test} in {test_s:.1f} "
            f"s, {len(test_logs or {})} metrics, bitwise equal to the fit's test: "
            f"{test_logs == fit_logs}; test/loss {fit_logs['test/loss']:.6f}, non-finite {bad}")
        ok = (rc_test == 0 and test_logs == fit_logs and not bad and len(history) == 2
              and files["ckpts"] == ["1.pt", "2.pt"] and files["tb"] and files["run_config.toml"]
              and all(math.isfinite(h[k]) for h in history for k in ("train/loss", "val/loss"))
              and all(r["k1"] == [60] and r["k2"] == [0] for r in rows))
        if not ok:
            raise AssertionError(f"[train] fit/test: rows {rows}, files {files}")

        _profiled_fit(tmp, root, history)

        for name, trainer, want in (("fit_bf16", {"precision": '"bf16"'}, ([60], [0])),
                                    ("fit_model_route", {}, ([0], [60]))):
            run = _train_config(tmp, root, name, 1, **trainer)
            if name == "fit_model_route":
                run.write_text(run.read_text().replace("s2d_train = true", "s2d_train = false"))
            t1 = time.perf_counter()
            rc, logs, (row,) = _timed_fit(["fit", run, "--no-extended"], 1)
            say(f"[train] {name}: 1 epoch, {row['ms']:.1f} ms per train step (warm steps), "
                f"dense_block_s2d launches per step {row['k1']}, dense_block {row['k2']}; "
                f"test/loss {logs['test/loss']:.6f} ({time.perf_counter() - t1:.1f} s)")
            if rc != 0 or (row["k1"], row["k2"]) != want or not math.isfinite(logs["test/loss"]):
                raise AssertionError(f"[train] {name}: rc {rc}, row {row}")
    _ddp_world_one()
    say(f"[train] ({time.perf_counter() - t0:.2f} s)")


def _ssim_map_f64(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The image logger's SSIM map evaluated in float64 on the CPU."""
    from xmm_superres_denoise_torch.ops.ssim import gaussian_kernel_1d

    taps = torch.as_tensor(gaussian_kernel_1d(), dtype=torch.float64)

    def blur(x):
        return F.conv2d(F.conv2d(x, taps.reshape(1, 1, 13, 1)), taps.reshape(1, 1, 1, 13))

    p, t = (F.pad(torch.as_tensor(a, dtype=torch.float64).permute(0, 3, 1, 2), (6,) * 4,
                  mode="reflect") for a in (pred, target))
    mu_p, mu_t = blur(p), blur(t)
    s_p, s_t, s_pt = blur(p * p) - mu_p**2, blur(t * t) - mu_t**2, blur(p * t) - mu_p * mu_t
    c1, c2 = 0.01**2, 0.05**2
    m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (s_p + s_t + c2))
    return m[0, 0].numpy()


def _profiled_fit(tmp: Path, root: Path, history: list) -> None:
    """One epoch of `cli fit --profile DIR` with the epoch image logger on:
    the trace file and its window, the fit's first FIT_PROFILE_STEPS train
    steps (that many optimizer steps, and 60 K1 kernels each, of the fit's
    60 per train step, val batch and display forward), its size and what
    the profiler added to the epoch; the logger's panel (when
    matplotlib is installed) and 2 x n FITS; its SSIM map on the card
    against float64 on the CPU."""
    from xmm_superres_denoise_torch.cli import FIT_PROFILE_STEPS
    from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
    from xmm_superres_denoise_torch.train import loop
    from xmm_superres_denoise_torch.utils.imagelogger import _ssim_map

    t0 = time.perf_counter()
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
        say("[train] the image logger's PNG half is not run: matplotlib is not installed on this "
            "machine; its FITS and SSIM-map half runs")
    run = _train_config(tmp, root, "fit_profiled", 1, log_images_every_n_epochs=1)
    prof = tmp / "fit_profile"
    real_fit, fit_k1 = loop.Trainer.fit, []

    def fit(self, *a, **k):
        before = dense_block_s2d.launches
        try:
            return real_fit(self, *a, **k)
        finally:
            fit_k1.append(dense_block_s2d.launches - before)

    loop.Trainer.fit = fit
    try:
        rc, logs, (row,) = _timed_fit(["fit", run, "--no-extended", "--profile", prof], 1)
    finally:
        loop.Trainer.fit = real_fit
    call_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[train] cli fit --profile exited {rc}")
    traces = sorted(prof.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"[train] --profile wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_traced = sum(1 for e in kernels if _profile_group(e.get("name", "")).startswith("K2/K1 f32"))
    # the host's range of each optimizer step (a card adds a gpu_user_annotation twin)
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("Optimizer.step#")]
    size = traces[0].stat().st_size
    ckroot = tmp / "fit_profiled" / "esr_gen"
    epoch_s = json.loads((ckroot / "history.jsonl").read_text().splitlines()[0])["time_s"]
    images = sorted(p.name for p in (ckroot / "images" / "epoch_00000").iterdir())
    n_fits = sum(1 for n in images if n.endswith(".fits.gz"))
    say(f"[train] cli fit --profile: 1 epoch of {row['steps']} steps, K1 launches per step "
        f"{row['k1']}; trace {traces[0].name} {size / 2**20:.1f} MiB "
        f"({size / 2**20 / FIT_PROFILE_STEPS:.1f} MiB per traced step), {len(events)} events, "
        f"window of {len(steps)} optimizer steps (FIT_PROFILE_STEPS {FIT_PROFILE_STEPS}), "
        f"{len(kernels)} CUDA kernels, of them {k1_traced} K1 (the f32 FFMA level) against "
        f"{fit_k1} launched in the fit (60 per train step, val batch and display forward); "
        f"epoch {epoch_s:.1f} s profiled against {history[0]['time_s']:.1f} "
        f"/ {history[1]['time_s']:.1f} s for the unprofiled fit's epochs 0 / 1 (the profiled "
        f"epoch also runs the image logger); the whole call {call_s:.1f} s incl. the trace's "
        f"export and `test`; image logger files {images}")
    # the window bounds the trace: the first FIT_PROFILE_STEPS train steps
    # and nothing after them, of an epoch that runs more
    if (row["k1"] != [60] or row["steps"] <= FIT_PROFILE_STEPS
            or len(steps) != FIT_PROFILE_STEPS or k1_traced != 60 * FIT_PROFILE_STEPS):
        raise AssertionError(f"[train] --profile: trace holds {k1_traced} K1 kernels in "
                             f"{len(steps)} optimizer steps, {row}")
    want_png = ["display.png"] if has_mpl else []
    if n_fits < 2 or n_fits % 2 or [n for n in images if n.endswith(".png")] != want_png:
        raise AssertionError(f"[train] image logger files {images}")

    t1 = time.perf_counter()
    pred, target = _loss_pair((1, 832, 832, 1), seed=13)
    card = _ssim_map(pred, target, device="cuda:0")
    exact = _ssim_map_f64(pred, target)
    err = float(np.abs(card - exact).max())
    err_cpu = float(np.abs(_ssim_map(pred, target) - exact).max())
    say(f"[train] image logger SSIM map at 832^2: max|card f32 - float64| {err:.3e}, max|CPU f32 "
        f"- float64| {err_cpu:.3e} (tol: twice the CPU's, at least 2e-6) "
        f"({time.perf_counter() - t1:.2f} s)")
    if not err <= max(2e-6, 2 * err_cpu):
        raise AssertionError(f"[train] SSIM map on the card: {err}")


def _ddp_world_one() -> None:
    """One train step through DDP on NCCL at world size 1 against the same
    step unwrapped, cuDNN deterministic: bitwise equal parameters."""
    import socket

    import torch.distributed as dist

    from xmm_superres_denoise_torch.cli import load_run_config
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.parallel import make_mesh, wrap_ddp
    from xmm_superres_denoise_torch.train import steps as ts
    from xmm_superres_denoise_torch.train.loss import create_loss

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, _, sc_dict, loss_cfg = load_run_config(RUN_CONFIG)
        loss = create_loss(sc_dict, loss_cfg)
        g = np.random.default_rng(13)
        batch = {"lr": torch.from_numpy(g.uniform(0, 1, (2, 104, 104, 1)).astype(np.float32)),
                 "hr": torch.from_numpy(g.uniform(0, 1, (2, 208, 208, 1)).astype(np.float32))}
        batch = {k: v.to("cuda:0") for k, v in batch.items()}
        tx = ts.Tx(1e-4)
        models, losses = [], []
        for wrap in (False, True):
            model = _sr_model()
            module = wrap_ddp(model, make_mesh("auto", 1, "cuda"), torch.device("cuda:0")) \
                if wrap else model
            state = ts.TrainState.create(module, tx)
            step = ts.make_train_step(ts.clamped_apply, loss, tx,
                                      group=dist.group.WORLD if wrap else None)
            with true_f32():
                state, v = step(state, batch)
            models.append(model)
            losses.append(float(v))
        same = all(torch.equal(p, q) for p, q in zip(models[0].parameters(),
                                                      models[1].parameters()))
        say(f"[train] DDP on NCCL, world size 1: loss {losses[1]:.8f} vs unwrapped "
            f"{losses[0]:.8f}; parameters after the step bitwise equal: {same}")
        if not same or losses[0] != losses[1]:
            raise AssertionError("[train] DDP step differs from the unwrapped step")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


LIBRARY_GROUPS = ("cuDNN/cuBLAS convolution or GEMM", "elementwise, copies and the rest")
K3_GROUPS = ("K3 s8 wgmma level", "K3 s8 wgmma (tap, channel) route (conv_first)")
TRACE_TRIES = 3


def _profile_group(name: str) -> str:
    """The kernel group of a device kernel's name (demangled or not)."""
    # before the library match below: the port's own names hold "conv"
    if "conv3x3_f32_kernel" in name:
        return "K2/K1 f32 FFMA level (CUDA cores)"
    if "int8_gemm_kernel" in name:
        return "P int8 GEMM"
    if "conv3x3_wgmma32" in name:  # before the other wgmma levels' matches
        return "K2 bf16 wgmma level, 16x16 px x 32 ch (conv3x3_wgmma32, persistent)"
    if "conv3x3_wgmma" in name and "S8" in name:  # before the bf16 level's match
        return K3_GROUPS[0]
    if "conv3x3_wgmma" in name:
        return "K1/K2 bf16 wgmma level, 16x16 px x 128 ch"
    if "conv3x3_tapk" in name:
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
    TRACE_TRIES times; the one that holds the most is read, and the line
    says how many it holds."""
    x = ctx["engine"].prepare(torch.from_numpy(ctx["raw"][:SERVE_BATCH]).to("cuda:0"))
    for mode, (fwd, counter) in ctx["profile"].items():
        t0 = time.perf_counter()
        best = None
        for tries in range(1, TRACE_TRIES + 1):
            kernels, launched = _trace(fwd, x, counter)
            groups: dict = {}
            for e in kernels:
                g = groups.setdefault(_profile_group(e.name), [0.0, 0])
                g[0] += e.time_range.elapsed_us()
                g[1] += 1
            traced = sum(n for g, (_, n) in groups.items() if g not in LIBRARY_GROUPS)
            if best is None or traced > best[2]:
                best = kernels, groups, traced
            if traced == launched:
                break
        kernels, groups, traced = best  # the trace that lost the fewest
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


# [zoo]: the transformer zoo's five shipped run configs at full width, seeded
# weights, and DRCT at the paper's window 16
ZOO_RUNS = ("swinir_sr", "swinfir_sr", "drct_sr_fsdp", "hat_sr", "restormer_denoise",
            "drct_sr_w16")
# runs no shipped run config states: (the run config, its model's patch_size);
# drct_sr_w16 is drct_sr_fsdp at patch 16 (416 / 16 = 26 > 16: window 16,
# blocks 2 and 4 of each group shifted), the model of the benchmark's cell
# drct_sr_bf16_bulk. A run config cannot set the model's keys, so these are
# built in Python and not served through `cli serve`.
ZOO_VARIANTS = {"drct_sr_w16": ("drct_sr_fsdp", 16)}
# card vs CPU f32 at a size the CPU forwards in seconds: four windows of 13
# (SwinIR, SwinFIR, DRCT); windows of 16 and three 2x downsamples (HAT, Restormer,
# DRCT at window 16)
ZOO_CHECK_PX = {"swinir": 52, "swinfir": 52, "drct": 52, "hat": 64, "restormer": 64,
                "drct_sr_w16": 64}  # by model, or by run where its window differs
ZOO_F32_RTOL = 1e-4  # card f32 vs CPU f32 raw output, x max(1, max|CPU|)
ZOO_BF16_DB = 30.0  # card bf16 vs card f32 at 416^2: 20 log10(max|f32| / RMS(bf16 - f32))
ZOO_TIMED = 2  # warm batches timed per mode
ZOO_FIT_BASE_NAMES = 20  # 16 train names: 8 steps at swinir_sr's batch of 2
# window_attention launches in one bf16 forward: one per attention (SwinIR and
# SwinFIR 6 x 6 Swin blocks, DRCT 6 x 5 dense blocks, HAT 36 HABs and 6 OCABs)
ZOO_WA_LAUNCHES = {"swinir_sr": 36, "swinfir_sr": 36, "drct_sr_fsdp": 30, "hat_sr": 42,
                   "restormer_denoise": 0, "drct_sr_w16": 30}
# mlp_block launches in one bf16 forward: one per MLP half-block at C <= 192
# and H <= 768 (SwinIR's and SwinFIR's 36 Swin blocks, DRCT's 6 first dense
# blocks, HAT's 36 HABs and 6 OCABs; DRCT's wider blocks and Restormer none)
ZOO_MLP_LAUNCHES = {"swinir_sr": 36, "swinfir_sr": 36, "drct_sr_fsdp": 6, "hat_sr": 42,
                    "restormer_denoise": 0, "drct_sr_w16": 6}
# mdta_gram launches in one bf16 forward: one per MDTA (Restormer's 44 at the
# run config's dim 24, d 24 and 48; the other models none)
ZOO_MDTA_LAUNCHES = {"swinir_sr": 0, "swinfir_sr": 0, "drct_sr_fsdp": 0, "hat_sr": 0,
                     "restormer_denoise": 44, "drct_sr_w16": 0}
# window_qkv launches in one bf16 forward: one per Swin block's qkv side
# (SwinIR's and SwinFIR's 36, DRCT's 30 at either window, HAT's 36 HABs; its
# OCABs and Restormer none)
ZOO_QKV_LAUNCHES = {"swinir_sr": 36, "swinfir_sr": 36, "drct_sr_fsdp": 30, "hat_sr": 36,
                    "restormer_denoise": 0, "drct_sr_w16": 30}
ZOO_GROUPS = ("GEMM (cuBLAS)", "convolution (cuDNN)", "softmax", "LayerNorm", "FFT",
              "elementwise, copies and the rest")


def _zoo_group(name: str) -> str:
    """The kernel group of a device kernel in a zoo forward."""
    low = name.lower()
    if "fft" in low:
        return ZOO_GROUPS[4]
    if any(k in low for k in ("conv", "cudnn", "fprop", "implicit", "im2col", "depthwise")):
        return ZOO_GROUPS[1]
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90", "cublas", "gemv")):
        return ZOO_GROUPS[0]
    if "softmax" in low:
        return ZOO_GROUPS[2]
    if "layer_norm" in low or "layernorm" in low:
        return ZOO_GROUPS[3]
    return ZOO_GROUPS[5]


def _zoo_flops(model, hw: int) -> float:
    """FLOPs (2 per multiply-add) of one forward at (1, hw, hw, 1), counted
    by torch's FlopCounterMode on the meta device: matmuls and convolutions
    (FFTs, softmax and elementwise work are not counted); NaN when a meta
    kernel is missing."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    try:
        meta = copy.deepcopy(model).to("meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            meta(torch.empty(1, hw, hw, 1, device="meta"))
        return float(counter.get_total_flops())
    except Exception as e:  # the count is a report, not a check
        say(f"[zoo]   FLOPs not counted: {type(e).__name__}: {e}")
        return float("nan")


def _zoo_profile(fwd, x) -> str:
    """One warm call of `fwd`, then one traced: device busy ms per image,
    idle share of the kernels' span and busy time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fwd(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "the profiler saw no CUDA kernel"
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(_zoo_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = sum(us for us, _ in groups.values())
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    n = x.shape[0]
    parts = ", ".join(f"{g} {us / 1e3 / n:.3f} ms ({k})"
                      for g, (us, k) in sorted(groups.items(), key=lambda kv: -kv[1][0]))
    return (f"device busy {busy / 1e3 / n:.3f} ms/image, idle {1 - busy / span:.1%}; {parts}")


def _events_ms(fn, x, iters: int) -> float:
    """Mean CUDA-event ms of `fn(x)` over `iters` warm calls."""
    with torch.inference_mode():
        fn(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def phase_zoo(tmp: Path) -> dict:
    """The transformer zoo on the card: for each shipped run config, and
    DRCT at patch 16 (`ZOO_VARIANTS`), the model at full width with seeded
    weights written as a Flax-layout npz (`layers_scan` for HAT and DRCT),
    the 4 detxy files served through `cli serve` in f32 and bf16 (not the
    variants: a run config cannot set their patch_size), the raw output (before the engine's clip) held
    to the CPU's f32 forward of the same weights at a small size, bf16 held
    to f32 at 416^2 in dB, engine ms per image (CUDA events), peak memory
    and a traced bf16 and f32 forward; then `cli fit` / `test` of swinir_sr.
    Returns each run's window_attention, mlp_block, mdta_gram and window_qkv
    launches in its bf16 forward."""
    from xmm_superres_denoise_torch.cli import load_run_config
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, load_rate_image
    from xmm_superres_denoise_torch.models.registry import build_model
    from xmm_superres_denoise_torch.ops.precision import true_f32
    from xmm_superres_denoise_torch.ops.mdta_gram import mdta_gram
    from xmm_superres_denoise_torch.ops.mlp_block import mlp_block
    from xmm_superres_denoise_torch.ops.window_attention import window_attention
    from xmm_superres_denoise_torch.ops.window_qkv import window_qkv
    from xmm_superres_denoise_torch.utils.weights import (
        load_params_npz,
        params_from_flax,
        save_params_npz,
    )

    t_all = time.perf_counter()
    files = _write_inputs(tmp)
    raw = np.stack([load_rate_image(f)[0] for f in files])
    wa_launches, mlp_launches, mdta_launches, qkv_launches = {}, {}, {}, {}
    for i, run in enumerate(ZOO_RUNS):
        t0 = time.perf_counter()
        base, patch = ZOO_VARIANTS.get(run, (run, None))
        path = ROOT / "res/configs/runs" / f"{base}.toml"
        ds, mc, *_ = load_run_config(path)
        if patch is not None:
            mc = dataclasses.replace(mc, model=dataclasses.replace(mc.model, patch_size=patch))
        name = mc.name.value
        lr = (ds.lr.res, ds.lr.res)
        hr = (ds.hr.res, ds.hr.res) if ds.hr else lr
        model = build_model(mc, lr, hr)
        model.reset_parameters(torch.Generator().manual_seed(100 + i))
        npz = tmp / f"{run}.npz"
        save_params_npz(npz, model)  # the scanned layout where the run config sets scan_layers
        state = params_from_flax(load_params_npz(npz, model), model)
        flops = _zoo_flops(model, lr[0])
        n_params = sum(p.numel() for p in model.parameters())

        served = {}
        for mode, flags in (() if patch is not None else (("f32", []), ("bf16", ["--bf16"]))):
            rc, listing, secs = _cli(["serve", *files, "--out", tmp / f"{run}_{mode}",
                                      "--run_config", path, "--checkpoint", npz,
                                      "--batch", SERVE_BATCH, *flags])
            if rc != 0 or len(listing) != SERVE_FILES:
                raise AssertionError(f"[zoo] {run}: cli serve {mode} exited {rc}")
            preds = _served(listing)
            if preds.shape[1:] != hr or not np.isfinite(preds).all():
                raise AssertionError(f"[zoo] {run} {mode}: products {preds.shape}, finite "
                                     f"{np.isfinite(preds).all()}")
            served[mode] = secs

        engines = {"f32": InferenceEngine(mc, ds, state, dtype=torch.float32),
                   "bf16": InferenceEngine(mc, ds, state, dtype=torch.bfloat16)}
        x = engines["f32"].prepare(torch.from_numpy(raw[:SERVE_BATCH]).to("cuda:0"))
        with torch.inference_mode():
            window_attention.launches = mlp_block.launches = mdta_gram.launches = 0
            window_qkv.launches = 0
            with true_f32():
                y32 = engines["f32"].model(x).float()
            wa_f32, mlp_f32, mdta_f32, qkv_f32 = (window_attention.launches, mlp_block.launches,
                                                  mdta_gram.launches, window_qkv.launches)
            window_attention.launches = mlp_block.launches = mdta_gram.launches = 0
            window_qkv.launches = 0
            y16 = engines["bf16"].model(x.bfloat16()).float()
            torch.cuda.synchronize()
            wa_launches[run], mlp_launches[run] = window_attention.launches, mlp_block.launches
            mdta_launches[run], qkv_launches[run] = mdta_gram.launches, window_qkv.launches
        rms = float(torch.sqrt(torch.mean((y16 - y32) ** 2)))
        db = 20 * math.log10(float(y32.abs().max()) / max(rms, 1e-30))

        px = ZOO_CHECK_PX.get(run, ZOO_CHECK_PX[name])
        xs = x[:1, :px, :px].contiguous()
        with torch.inference_mode(), true_f32():
            card = engines["f32"].model(xs).float().cpu()
        cpu_model = build_model(mc, lr, hr)
        cpu_model.load_state_dict(state)
        t1 = time.perf_counter()
        with torch.inference_mode():
            ref = cpu_model.eval()(xs.cpu())
        cpu_s = time.perf_counter() - t1
        err = float((card - ref).abs().max())
        tol = ZOO_F32_RTOL * max(1.0, float(ref.abs().max()))

        ms, peak, traces = {}, {}, {}
        for mode, engine in engines.items():
            torch.cuda.reset_peak_memory_stats()
            ms[mode] = _events_ms(engine.predict, x, ZOO_TIMED) / SERVE_BATCH
            peak[mode] = torch.cuda.max_memory_allocated() / 2**30
            traces[mode] = _zoo_profile(engine.predict, x)
        bound = {m: flops / PEAK_FLOPS[dt] * 1e3
                 for m, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        say(f"[zoo] {run}: {type(model).__name__} at full width ({n_params} parameters, "
            f"scan_layers {mc.scan_layers}), {lr[0]}^2 -> {hr[0]}^2; "
            + (f"cli serve of {SERVE_FILES} files: f32 {served['f32']:.2f} s, bf16 "
               f"{served['bf16']:.2f} s (each incl. the engine's build, the npz read and FITS "
               f"I/O)" if served else f"patch_size {patch}, built in Python, not served by cli")
            + f"; engine ms/image "
            f"(CUDA events, batch {SERVE_BATCH}, warm): f32 {ms['f32']:.2f}, bf16 "
            f"{ms['bf16']:.2f}; peak memory f32 {peak['f32']:.2f} GiB, bf16 "
            f"{peak['bf16']:.2f} GiB; {flops / 1e12:.3f} TFLOP per image (matmuls and "
            f"convolutions), bound f32 {bound['f32']:.2f} ms, bf16 {bound['bf16']:.2f} ms; card "
            f"f32 vs CPU f32 at {px}^2: max|diff| {err:.3e} (tol {tol:.1e}; CPU {cpu_s:.1f} s); "
            f"bf16 vs f32 at {lr[0]}^2: {db:.2f} dB (min {ZOO_BF16_DB}); window_attention "
            f"launches in one forward of {SERVE_BATCH}: f32 {wa_f32}, bf16 {wa_launches[run]} "
            f"(expected 0 and {ZOO_WA_LAUNCHES[run]}); mlp_block launches: f32 {mlp_f32}, bf16 "
            f"{mlp_launches[run]} (expected 0 and {ZOO_MLP_LAUNCHES[run]}); mdta_gram launches: "
            f"f32 {mdta_f32}, bf16 {mdta_launches[run]} (expected 0 and "
            f"{ZOO_MDTA_LAUNCHES[run]}); window_qkv launches: f32 {qkv_f32}, bf16 "
            f"{qkv_launches[run]} (expected 0 and {ZOO_QKV_LAUNCHES[run]}) "
            f"({time.perf_counter() - t0:.1f} s)")
        for mode in ("f32", "bf16"):
            say(f"[zoo]   {run} {mode} trace: {traces[mode]}")
        if not (err <= tol and db >= ZOO_BF16_DB and torch.isfinite(y32).all()
                and torch.isfinite(y16).all()):
            raise AssertionError(f"[zoo] {run}: card vs CPU {err} (tol {tol}), bf16 {db} dB")
        if wa_f32 != 0 or wa_launches[run] != ZOO_WA_LAUNCHES[run]:
            raise AssertionError(f"[zoo] {run}: window_attention launches f32 {wa_f32}, bf16 "
                                 f"{wa_launches[run]}, expected 0 and {ZOO_WA_LAUNCHES[run]}")
        if mlp_f32 != 0 or mlp_launches[run] != ZOO_MLP_LAUNCHES[run]:
            raise AssertionError(f"[zoo] {run}: mlp_block launches f32 {mlp_f32}, bf16 "
                                 f"{mlp_launches[run]}, expected 0 and {ZOO_MLP_LAUNCHES[run]}")
        if mdta_f32 != 0 or mdta_launches[run] != ZOO_MDTA_LAUNCHES[run]:
            raise AssertionError(f"[zoo] {run}: mdta_gram launches f32 {mdta_f32}, bf16 "
                                 f"{mdta_launches[run]}, expected 0 and {ZOO_MDTA_LAUNCHES[run]}")
        if qkv_f32 != 0 or qkv_launches[run] != ZOO_QKV_LAUNCHES[run]:
            raise AssertionError(f"[zoo] {run}: window_qkv launches f32 {qkv_f32}, bf16 "
                                 f"{qkv_launches[run]}, expected 0 and {ZOO_QKV_LAUNCHES[run]}")
        del engines, model, cpu_model, x, y32, y16
        torch.cuda.empty_cache()
    _zoo_fit(tmp)
    say(f"[zoo] ({time.perf_counter() - t_all:.2f} s)")
    return wa_launches, mlp_launches, mdta_launches, qkv_launches


def _zoo_fit(tmp: Path) -> None:
    """`cli fit` of swinir_sr.toml at full width (batch 2 and
    memory_efficient as shipped, f32) for one epoch of 8 steps on a 20-name
    synthetic tree, each step timed with CUDA events; finite losses,
    parameters moved from the seeded init, and `cli test` of the best
    checkpoint bitwise equal to the fit's test."""
    from xmm_superres_denoise_torch.cli import load_run_config
    from xmm_superres_denoise_torch.data.synthetic import write_sim_tree
    from xmm_superres_denoise_torch.models.registry import build_model

    t0 = time.perf_counter()
    path = ROOT / "res/configs/runs/swinir_sr.toml"
    ds, mc, tc, *_ = load_run_config(path)
    root = write_sim_tree(tmp / "zoo_data", name=ds.name, n_base=ZOO_FIT_BASE_NAMES,
                          res_mult=ds.res_mult, lr_exp=ds.lr.exps[0], hr_exp=ds.hr.exp,
                          variants=1, seed=8)
    text = path.read_text()
    text = re.sub(r"^epochs = .*$", "epochs = 1", text, count=1, flags=re.M)
    text = re.sub(r"^checkpoint_root = .*$", f'checkpoint_root = "{tmp / "zoo_fit"}"', text,
                  count=1, flags=re.M)
    text = re.sub(r"^directory = .*$", f'directory = "{root}"', text, count=1, flags=re.M)
    run = tmp / "swinir_fit.toml"
    run.write_text(text)
    with contextlib.chdir(tmp):  # the data module writes its splits under ./res/splits
        torch.cuda.reset_peak_memory_stats()
        rc, fit_logs, (row,) = _timed_fit(["fit", run], 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        fit_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[zoo] cli fit swinir_sr exited {rc}")
        ckroot = tmp / "zoo_fit" / "swinir"
        history = [json.loads(line)
                   for line in (ckroot / "history.jsonl").read_text().splitlines()]
        init = build_model(mc, (ds.lr.res,) * 2, (ds.hr.res,) * 2)
        init.reset_parameters(torch.Generator().manual_seed(tc.seed))  # the Trainer's init
        trained = torch.load(ckroot / "ckpts" / "1.pt", map_location="cpu",
                             weights_only=True)["model"]
        moved = sum(not torch.equal(t, trained[k]) for k, t in init.state_dict().items())
        t1 = time.perf_counter()
        rc_test, test_logs = _cli_json(["test", run])
        test_s = time.perf_counter() - t1
    bad = [k for k, v in fit_logs.items() if v is None or not math.isfinite(v)]
    losses = [(h["train/loss"], h["val/loss"]) for h in history]
    say(f"[zoo] cli fit swinir_sr (full width, batch {ds.batch_size}, memory_efficient "
        f"{mc.memory_efficient}, f32): {row['steps']} steps, ms per train step (CUDA events) "
        f"{', '.join(f'{t:.1f}' for t in row['each'])} (warm mean {row['ms']:.1f}); train/loss, "
        f"val/loss {losses}; {moved} of {len(trained)} parameter arrays moved; peak memory "
        f"{peak:.2f} GiB; fit {fit_s:.1f} s; cli test rc {rc_test} in {test_s:.1f} s, "
        f"{len(test_logs or {})} metrics, bitwise equal to the fit's test: "
        f"{test_logs == fit_logs}; test/loss {fit_logs['test/loss']:.6f}, non-finite {bad}")
    if not (rc_test == 0 and test_logs == fit_logs and not bad and len(history) == 1
            and 0 < row["steps"] <= 8 and moved == len(trained)
            and all(math.isfinite(v) for pair in losses for v in pair)):
        raise AssertionError(f"[zoo] fit/test: row {row}, history {history}, moved {moved}")


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
        p_entry, (k3_entry, k3_fused, k3_taps) = (phase_kernel_p(build_logs),
                                                  phase_kernel_k3(build_logs))
        wa_entries = phase_kernel_window_attention(build_logs)
        mlp_entry = phase_kernel_mlp_block(build_logs)
        qkv_entries = phase_kernel_window_qkv(build_logs)
        mdta_entries = phase_kernel_mdta_gram(build_logs)
        with tempfile.TemporaryDirectory(prefix="xmmsr_chip_smoke_") as tmp:
            launches, ctx = phase_serve(Path(tmp))
            int8_launches = phase_serve_int8(ctx, Path(tmp))
            phase_cli(ctx, Path(tmp))
            phase_mesh(ctx, Path(tmp))
            phase_http(ctx, Path(tmp))
            e2e_launches = phase_end2end(ctx, Path(tmp), phase_events(Path(tmp)))
            root = phase_eval(Path(tmp))
            phase_train(Path(tmp), root)
        phase_loss()
        k1_launches = phase_grad(ctx)
        phase_train_routes()
        phase_profile(ctx)
        with tempfile.TemporaryDirectory(prefix="xmmsr_chip_zoo_") as tmp:
            zoo_wa, zoo_mlp, zoo_mdta, zoo_qkv = phase_zoo(Path(tmp))
        for entry, name in zip(kernels, ("f32", "bf16")):
            entry["launches"] = launches[name]
            entry["launches_end2end"] = e2e_launches[name]["K2"]
        s2d_f32["launches"] = k1_launches["f32"]
        s2d_bf16["launches"] = k1_launches["bf16"]
        p_entry["launches"] = int8_launches["int8_gemm"]
        k3_entry["launches"] = k3_fused["launches"] = int8_launches["conv_i8"]
        k3_taps["launches"] = int8_launches["conv_i8 wgmma_taps"]
        for entry in wa_entries:
            entry["launches_per_forward"] = zoo_wa[entry["run"]]
        mlp_entry["launches_per_forward"] = zoo_mlp
        for entry in qkv_entries:
            entry["launches_per_forward"] = zoo_qkv[entry["run"]]
        for entry in mdta_entries:
            entry["launches_per_forward"] = zoo_mdta["restormer_denoise"]
        p_entry["launches_end2end"] = e2e_launches["int8 calibrate"]["P"]
        k3_entry["launches_end2end"] = k3_fused["launches_end2end"] = (
            e2e_launches["int8 calibrate"]["K3"])
        kernels += [k2_c128, k2_c128_f32, s2d_f32, s2d_bf16, p_entry, k3_entry, k3_fused, k3_taps,
                    *wa_entries, mlp_entry, *qkv_entries, *mdta_entries]
        say(f"[done] {time.perf_counter() - t_start:.2f} s")
        say(json.dumps({"kernels": kernels}))
        say(json.dumps({"ok": True, "device": device}))
    finally:
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
