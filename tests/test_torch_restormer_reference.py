"""The port's Restormer against the benchmark's frozen plain reference
(`benchmark/reference/restormer.py`), on the CPU, at a size where every
mechanism of the served configuration is active: 32^2 -> 32^2 (three
halvings to 4^2), dim 8 at the registry's depth ([4, 6, 6, 8] blocks, 4
refinement) and heads [1, 2, 4, 8], GDFN expansion 2.66, no convolution
biases, through the registry and the engine as the cell builds them. Both
sides take one seeded `make_params` dict, whose temperatures are drawn
log-normal (a fresh model holds ones).

Also: the operation count against torch's FlopCounterMode on the port's
model, the `zoo.*` spans and the forward counters the benchmark's exact
check reads, the program's refusal of a model that is not the
configuration's, and the `restormer.*` metric readers on a synthetic
trace of the kernel names an H100 run shows.
"""

import json

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from benchmark import check, harness
from benchmark.counts import restormer as restormer_counts
from benchmark.programs import restormer as program
from benchmark.reference import restormer as reference
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.utils import profiling as tprof

CELL = "restormer_dn_bf16_bulk"
CFG = dict(harness.load_cell(CELL)["cfg"], dim=8, lr_res=32, hr_res=32, batch_size=2)
SEED = 2**33 + 7
# f32 on both sides, only the order of sums differs (the zoo tests' f32 class)
F32_TOL = 1e-5
# bf16 rounds each product's operands, each stored activation and the
# LayerNorms' statistics at 2^-9 relative, which over the 44 blocks reads
# 0.016-0.017 in both numbers here; the reference in float8 e4m3 (2^-4)
# reads 0.14-0.18, so 0.05 tells the two apart by about 3x on each side
BF16_TOL = {"pred_rel_rms": 0.05, "pred_max": 0.05}


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
    params = reference.make_params(CFG, SEED, "cpu", torch.float32)
    engine = _engine(params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.inference_mode():
        raw = engine.model(x)
    return params, engine, x, raw


def _raw_gap(raw, params, x):
    with torch.inference_mode():
        ref = reference.model(params, x.permute(0, 3, 1, 2), CFG).permute(0, 2, 3, 1)
    gap = float((raw - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    print("raw max|diff| / max(1, max|ref|)", gap)
    return gap


def test_state_dict_keys_and_shapes_are_the_references(f32):
    _, engine, _, _ = f32
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


def _no_l2_normalize(t):
    return t


def _no_temperature(q, k, temperature, quant, logits=reference._logits):
    return logits(q, k, torch.ones_like(temperature), quant)


def _swapped_gate(x1, x2, gate=reference._gate):
    return gate(x2, x1)


def _transposed_unshuffle(x, unshuffle=reference.pixel_unshuffle):
    y = unshuffle(x)
    b, c4, h, w = y.shape
    return y.reshape(b, c4 // 4, 2, 2, h, w).transpose(2, 3).reshape(b, c4, h, w)


@pytest.mark.parametrize("name,fn", [("_l2_normalize", _no_l2_normalize),
                                     ("_logits", _no_temperature), ("_gate", _swapped_gate),
                                     ("pixel_unshuffle", _transposed_unshuffle)])
def test_reference_mutant_fails_the_f32_comparison(f32, monkeypatch, name, fn):
    params, _, x, raw = f32
    monkeypatch.setattr(reference, name, fn)
    assert _raw_gap(raw, params, x) > F32_TOL


def test_bf16_port_is_held_where_the_float8_control_is_not(f32):
    params, rates = f32[0], _rates()
    engine = _engine(reference.make_params(CFG, SEED, "cpu", torch.bfloat16), torch.bfloat16)
    pred, inp = engine.run_tiles(rates, batch_size=2)
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
    assert counter.get_total_flops() == restormer_counts.forward_ops(CFG)
    full = harness.load_cell(CELL)["cfg"]
    assert round(restormer_counts.forward_ops(full) / 1e8) == 8171


def test_forward_emits_each_span_and_counts_each_block(f32, tmp_path, monkeypatch):
    _, engine, x, _ = f32
    before = program.counters()
    with tprof.trace(tmp_path), torch.inference_mode():
        engine.model(x[:1])
    after = program.counters()
    assert {k: after[k] - before[k] for k in after} == program.expected_counters(CFG, 1) == {
        "restormer_mdta_calls": 44, "restormer_gdfn_calls": 44}
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and str(e.get("name")).startswith("zoo.")]
    assert {n: names.count(n) for n in set(names)} == {
        "zoo.mdta": 44, "zoo.gdfn": 44, "zoo.channel_norm": 88}
    entered = []  # with no profiler recording, no span is entered
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", lambda *a, **k: entered.append(a))
    with torch.inference_mode():
        engine.model(x[:1])
    assert entered == []


def test_each_block_norms_before_its_mdta_and_its_gdfn(f32):
    """`zoo.channel_norm` twice a block, beside MDTA's and GDFN's spans: in
    time order norm, MDTA, norm, GDFN in each of the 44 blocks, no span
    inside another."""
    _, engine, x, _ = f32
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            engine.model(x[:1])
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("zoo.")), key=lambda s: s[1])
    assert [n for n, _, _ in spans] == 44 * [
        "zoo.channel_norm", "zoo.mdta", "zoo.channel_norm", "zoo.gdfn"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("key,value", [("num_blocks", [4, 6, 6, 6]), ("num_refinement_blocks", 2),
                                       ("heads", [1, 2, 4, 4]), ("ffn_expansion_factor", 2.0),
                                       ("bias", True)])
def test_program_refuses_a_model_that_is_not_the_configurations(f32, key, value):
    _, engine, _, _ = f32
    program.check_model(engine.model, CFG)
    with pytest.raises(ValueError):
        program.check_model(engine.model, dict(CFG, **{key: value}))


# kernel names of one bf16 Restormer call on an NVIDIA H100 (torch 2.11, CUDA 12.8)
CARD_KERNELS = {
    "gram_nt": "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_"
               "aligna4_alignc4_execute_kernel__5x_cublas",
    "gram_nn": "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_"
               "aligna4_alignc4_execute_kernel__5x_cublas",
    "dwconv": "conv2d_c1_k1_nhwc",
    "welford": "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, "
               "at::native::WelfordOps<c10::BFloat16, float, int, thrust::THRUST_200700_750_800_"
               "860_900_1000_1200_NS::pair<c10::BFloat16, c10::BFloat16> >, unsigned int, "
               "c10::BFloat16, 2, 2> >(...)",
    "mean": "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, "
            "at::native::MeanOps<c10::BFloat16, float, float, c10::BFloat16>, unsigned int, "
            "c10::BFloat16, 4, 8> >(...)",
    "sum": "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, "
           "at::native::func_wrapper_t<c10::BFloat16, at::native::sum_functor<c10::BFloat16, "
           "float, c10::BFloat16>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, "
           "unsigned int, c10::BFloat16, 4, 8> >(...)",
    "bf16_gemm": "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_32x3_tn_"
                 "align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_32x3_tn_align2::Params)",
    "nvjet": "nvjet_tst_288x128_64x4_1x2_h_ssched_bz_coopA_TNN",
    "conv": "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
            "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "mul": "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
           "at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, "
           "at::native::binary_internal::MulFunctor<float> > >(...)",
    "copy": "Memcpy DtoD (Device -> Device)",
}


def test_restormer_readers_on_a_synthetic_trace_of_card_kernel_names():
    seconds = {"gram_nt": 0.28, "gram_nn": 0.09, "dwconv": 0.08, "welford": 0.04, "mean": 0.02,
               "sum": 0.03, "bf16_gemm": 0.03, "nvjet": 0.01, "conv": 0.005, "mul": 0.07,
               "copy": 0.02}
    ops, t = [], 0.0
    for k, s in seconds.items():  # each kernel twice, back to back
        for _ in range(2):
            ops.append((CARD_KERNELS[k], t, t + s / 2))
            t += s / 2
    ctx = {"cfg": CFG, "trace": {"ops": ops, "window_s": t, "busy_s": t}, "traced_images": 16}
    read = {m: harness.module("metrics", f"restormer.{m}_ms_per_image").read
            for m in ("gram", "dwconv", "norm")}
    assert read["gram"](ctx) == pytest.approx(1e3 * (0.28 + 0.09) / 16)
    assert read["dwconv"](ctx) == pytest.approx(1e3 * 0.08 / 16)
    assert read["norm"](ctx) == pytest.approx(1e3 * (0.04 + 0.02 + 0.03) / 16)
    for r in read.values():
        assert r({"cfg": CFG}) is None  # no trace
        assert r(dict(ctx, trace={"ops": [(CARD_KERNELS["mul"], 0.0, 1.0)]})) is None  # none of its
