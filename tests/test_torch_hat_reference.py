"""The port's HAT against the benchmark's frozen plain reference
(`benchmark/reference/hat.py`), on the CPU, at a size where every
mechanism of the served configuration is active: 32^2 -> 64^2, embed 60,
two groups of two HABs, 6 heads, window 8 with shift 4 (so the second HAB
of each group takes the shift mask), OCAB on 12 x 12 windows that run past
the image's edge into the zero padding, the CAB with its channel
attention. Both sides take one seeded `make_params` dict, the bias tables
drawn at std 0.5 instead of 0.02 (`TABLE_STD`): at 0.02 a transposed OCAB
index moves the output by 5e-6, inside the f32 class, and at 0.5 well
outside it.

Also: the operation count against torch's FlopCounterMode on the port's
model, the `zoo.*` spans and the forward counters the benchmark's exact
check reads, and the `hat.*` metric readers on a synthetic trace of the
kernel names an H100 run shows.
"""

import json

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from benchmark import check, harness
from benchmark.counts import hat as hat_counts
from benchmark.programs import hat as program
from benchmark.reference import hat as reference
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.utils import profiling as tprof

CFG = dict(harness.load_cell("hat_sr_bf16_bulk")["cfg"], embed_dim=60, depths=[2, 2],
           num_heads=[6, 6], window_size=8, img_size=32, patch_size=1, lr_res=32, hr_res=64,
           batch_size=2)
SEED = 2**33 + 7
TABLE_STD = 0.5
# f32 on both sides, only the order of sums differs (the zoo tests' f32 class)
F32_TOL = 1e-5
# bf16 rounds each product's operands and each stored activation at 2^-9
# relative, which over the model reads 0.004-0.005 in both numbers here;
# the reference in float8 e4m3 (2^-4) reads 0.023, so 0.01 tells the two apart
BF16_TOL = {"pred_rel_rms": 0.01, "pred_max": 0.01}


def _params(dtype=torch.float32):
    p = reference.make_params(CFG, SEED, "cpu", dtype)
    for k, v in p.items():
        if k.endswith("relative_position_bias_table"):
            p[k] = (v.float() * (TABLE_STD / 0.02)).to(dtype)
    return p


def _rates():
    g = np.random.default_rng(3)
    lam = np.full((3, 30, 28), 1.5)
    lam[:, 8:13, 6:11] += 30.0
    return (g.poisson(lam) / 20000.0).astype(np.float32)


def _engine(params, dtype):
    return InferenceEngine(program.model_config(CFG), program.dataset_config(CFG), params,
                           dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def f32():
    params = _params()
    engine = _engine(params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.inference_mode():
        raw = engine.model(x)
    return params, engine, x, raw


def _raw_gap(raw, params, x):
    with torch.inference_mode():
        ref = reference.model(params, x, CFG)
    gap = float((raw - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    print("raw max|diff| / max(1, max|ref|)", gap)
    return gap


def test_state_dict_keys_and_shapes_are_the_references():
    engine = _engine(_params(), torch.float32)
    assert {k: tuple(v.shape) for k, v in engine.model.state_dict().items()} == {
        k: tuple(s) for k, s, _ in reference.param_shapes(CFG)}


def test_f32_port_serves_the_reference(f32):
    params, engine, x, raw = f32
    assert _raw_gap(raw, params, x) <= F32_TOL
    rates = _rates()
    pred, inp = engine.run_tiles(rates, batch_size=2)
    with torch.inference_mode():
        rp, ri = reference.serve(params, torch.from_numpy(rates), CFG)
    y = np.sqrt(pred / CFG["hr_max"])
    assert 0.05 < np.median(y) < 0.95  # the output lies inside the clip
    assert np.abs(pred - rp.numpy()).max() / CFG["hr_max"] <= F32_TOL
    assert np.abs(inp - ri.numpy()).max() / CFG["lr_max"] <= F32_TOL


def _no_mask(h, w, ws, shift, device):
    return None


def _transposed_index(ws, wse, device, index=reference.oca_index):
    idx = index(ws, wse, device)
    return idx.reshape(ws, ws, wse, wse).permute(1, 0, 3, 2).flatten()


def _no_cab(w, p, y, q):
    return torch.zeros_like(y)


@pytest.mark.parametrize("name,fn", [("shift_mask", _no_mask), ("oca_index", _transposed_index),
                                     ("_cab", _no_cab)])
def test_reference_mutant_fails_the_f32_comparison(f32, monkeypatch, name, fn):
    params, _, x, raw = f32
    monkeypatch.setattr(reference, name, fn)
    assert _raw_gap(raw, params, x) > F32_TOL


def test_bf16_port_is_held_where_the_float8_control_is_not():
    params, rates = _params(), _rates()
    pred, inp = _engine(_params(torch.bfloat16), torch.bfloat16).run_tiles(rates, batch_size=2)
    with torch.inference_mode():
        rp, ri = (t.numpy() for t in reference.serve(params, torch.from_numpy(rates), CFG))
        qp, qi = (t.numpy() for t in reference.serve(params, torch.from_numpy(rates), CFG,
                                                     torch.bfloat16, reference.fp8))

    def numbers(p, i):
        return check.worst([check.gaps(p[j], i[j], rp[j], ri[j], CFG) for j in range(len(p))])

    bf16, fp8 = numbers(pred, inp), numbers(qp, qi)
    print("bf16", bf16, "float8", fp8)
    assert all(bf16[k] <= v for k, v in BF16_TOL.items()) and bf16["input_max"] == 0
    assert all(fp8[k] > v for k, v in BF16_TOL.items())


def test_operation_count_is_the_flop_counters(f32):
    from torch.utils.flop_counter import FlopCounterMode

    _, engine, x, _ = f32
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        engine.model(x[:1])
    assert counter.get_total_flops() == hat_counts.forward_ops(CFG)
    full = harness.load_cell("hat_sr_bf16_bulk")["cfg"]
    assert round(hat_counts.forward_ops(full) / 1e10) == 1045


def test_forward_emits_each_span_and_counts_each_block(f32, tmp_path, monkeypatch):
    _, engine, x, _ = f32
    before = program.counters()
    with tprof.trace(tmp_path), torch.inference_mode():
        engine.model(x[:1])
    after = program.counters()
    assert {k: after[k] - before[k] for k in after} == program.expected_counters(CFG, 1) == {
        "hat_hab_calls": 4, "hat_cab_calls": 4, "hat_ocab_calls": 2, "hat_masked_attn_calls": 2}
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and str(e.get("name")).startswith("zoo.")]
    assert {n: names.count(n) for n in set(names)} == {
        "zoo.hab": 4, "zoo.cab": 4, "zoo.ocab": 2,
        "zoo.qkv": 4, "zoo.attention": 4, "zoo.proj": 4, "zoo.mlp": 4}
    entered = []  # with no profiler recording, no span is entered
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", lambda *a, **k: entered.append(a))
    with torch.inference_mode():
        engine.model(x[:1])
    assert entered == []


def test_hab_stages_nest_in_order_beside_the_cab_and_ocab_opens_none(f32):
    """Each HAB holds its four stages one after another and its CAB between
    the attention and proj, inside no stage; OCAB's attention and MLP open
    no stage span."""
    _, engine, x, _ = f32
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            engine.model(x[:1])
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("zoo.")), key=lambda s: s[1])

    def inside(outer):
        return [n for n, a, b in spans if outer[1] <= a and b <= outer[2] and (n, a, b) != outer]

    habs = [s for s in spans if s[0] == "zoo.hab"]
    assert len(habs) == 4
    for hab in habs:
        assert inside(hab) == ["zoo.qkv", "zoo.attention", "zoo.cab", "zoo.proj", "zoo.mlp"]
    for ocab in (s for s in spans if s[0] == "zoo.ocab"):
        assert inside(ocab) == []
    for stage in (s for s in spans if s[0] in ("zoo.qkv", "zoo.attention", "zoo.proj", "zoo.mlp")):
        assert inside(stage) == []


# kernel names of one bf16 HAT call on an NVIDIA H100 (torch 2.11, CUDA 12.8)
CARD_KERNELS = {
    "im2col": "void at::native::im2col_kernel<c10::BFloat16>(long, c10::BFloat16 const*, long, "
              "long, long, long, long, long, long, long, long, long, long, long, c10::BFloat16*)",
    "f32_gemm": "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_"
                "aligna4_alignc4_execute_kernel__5x_cublas",
    "bf16_gemm": "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_64x3_tn_"
                 "align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_64x3_tn_align2::Params)",
    "conv": "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x32_"
            "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "cudnn_pad": "void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
                 "(cudnnKernelDataType_t)0>(int, int, int, int, int, int, int, int, "
                 "__nv_bfloat16 const*, __nv_bfloat16*)",
    "softmax": "void (anonymous namespace)::softmax_warp_forward<float, float, float, 8, false, "
               "false>(float*, float const*, int, int, int, bool const*, int, bool)",
    "add": "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::"
           "CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<float> "
           "const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl<at::native::CUDAFunctor_"
           "add<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<float> const&)::"
           "{lambda(int)#1})",
    "copy": "Memcpy DtoD (Device -> Device)",
}


def test_hat_readers_on_a_synthetic_trace_of_card_kernel_names():
    seconds = {"im2col": 0.01, "f32_gemm": 0.2, "bf16_gemm": 0.3, "conv": 0.06, "cudnn_pad": 0.04,
               "softmax": 0.15, "add": 0.5, "copy": 0.02}
    ops, t = [], 0.0
    for k, s in seconds.items():  # each kernel twice, back to back
        for _ in range(2):
            ops.append((CARD_KERNELS[k], t, t + s / 2))
            t += s / 2
    cfg = harness.load_cell("hat_sr_bf16_bulk")["cfg"]
    ctx = {"cfg": cfg, "trace": {"ops": ops, "window_s": t, "busy_s": t}, "traced_images": 16}
    read = {m: harness.module("metrics", f"hat.{m}_ms_per_image").read
            for m in ("unfold", "f32_logits", "conv")}
    assert read["unfold"](ctx) == pytest.approx(1e3 * 0.01 / 16)
    assert read["f32_logits"](ctx) == pytest.approx(1e3 * 0.2 / 16)
    assert read["conv"](ctx) == pytest.approx(1e3 * (0.06 + 0.04) / 16)  # cuDNN's own padding in
    for r in read.values():
        assert r({"cfg": cfg}) is None  # no trace
        assert r(dict(ctx, trace={"ops": [(CARD_KERNELS["add"], 0.0, 1.0)]})) is None  # none of its
