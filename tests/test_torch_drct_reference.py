"""The port's DRCT against the benchmark's frozen plain reference
(`benchmark/reference/drct.py`), on the CPU, at a size where every
mechanism of the served configuration is active: 32^2 -> 64^2, embed 12
and gc 32 (the five blocks of a group read 12, 44, 76, 108 and 140
channels over 6, 4, 2, 6 and 4 heads: unequal heads, odd head sizes), two
groups, window 8 at patch 2 (16 > 8, so blocks 2 and 4 of each group shift
by 4 and take the shift mask), the adjust convolutions and the dense
concatenations. Both sides take one seeded `make_params` dict, the bias
tables drawn at std 0.5 instead of 0.02 (`TABLE_STD`), so that a wrong
index moves the output well outside the f32 class.

Also: the operation count against torch's FlopCounterMode on the port's
model, the `zoo.*` spans and the forward counters the benchmark's exact
check reads, the program's refusal of a model that is not the
configuration's, and the `drct.*` metric readers on a synthetic trace.
"""

import json

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from benchmark import check, harness
from benchmark.counts import drct as drct_counts
from benchmark.counts.peaks import bound_s
from benchmark.programs import drct as program
from benchmark.reference import drct as reference
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.utils import profiling as tprof

CFG = dict(harness.load_cell("drct_sr_bf16_bulk")["cfg"], embed_dim=12, depths=[5, 5],
           num_heads=[6, 6], window_size=8, img_size=32, patch_size=2, lr_res=32, hr_res=64,
           batch_size=2)
SEED = 2**33 + 11
TABLE_STD = 0.5
# f32 on both sides, only the order of sums differs (the zoo tests' f32 class)
F32_TOL = 1e-5
# bf16 rounds each product's operands and each stored activation at 2^-9
# relative; over this model it reads 0.0039 and 0.0031, the reference in
# float8 e4m3 (2^-4) 0.016 and 0.020, so 0.008 tells the two apart with
# about 2x on each side
BF16_TOL = {"pred_rel_rms": 0.008, "pred_max": 0.008}


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


def test_blocks_are_the_published_widths_and_heads():
    full = harness.load_cell("drct_sr_bf16_bulk")["cfg"]
    assert reference.blocks(full, 6) == [(180, 6, 720, 0, 32), (212, 4, 848, 8, 32),
                                         (244, 2, 976, 0, 32), (276, 6, 276, 8, 32),
                                         (308, 4, 308, 0, 180)]
    assert [c // h for c, h, *_ in reference.blocks(CFG, 6)] == [2, 11, 38, 18, 35]


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


def _no_mask(h, w, ws, shift, device):
    return None


def _transposed_rel_index(ws, device, index=reference._rel_index):
    return index(ws, device).reshape(ws, ws, ws, ws).permute(1, 0, 3, 2).flatten()


def _shifts_in_odd_blocks(cfg, num_heads, blocks=reference.blocks):
    out = blocks(cfg, num_heads)
    shift = max(b[3] for b in out)
    return [(c, h, hid, 0 if s else shift, co) for c, h, hid, s, co in out]


@pytest.mark.parametrize("name,fn", [("shift_mask", _no_mask), ("_rel_index", _transposed_rel_index),
                                     ("blocks", _shifts_in_odd_blocks)])
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
    assert counter.get_total_flops() == drct_counts.forward_ops(CFG)
    full = harness.load_cell("drct_sr_bf16_bulk")["cfg"]
    assert round(drct_counts.forward_ops(full) / 1e10) == 720
    assert round(drct_counts.attention_ops(full) / 1e10) == 130
    assert round(drct_counts.attention_bytes(full) / 1e8) == 101


def test_forward_emits_each_span_and_counts_each_group(f32, tmp_path, monkeypatch):
    _, engine, x, _ = f32
    before = program.counters()
    with tprof.trace(tmp_path), torch.inference_mode():
        engine.model(x[:1])
    after = program.counters()
    assert {k: after[k] - before[k] for k in after} == program.expected_counters(CFG, 1) == {
        "drct_rdg_calls": 2, "drct_masked_attn_calls": 4}
    full = harness.load_cell("drct_sr_bf16_bulk")["cfg"]
    assert program.expected_counters(full, 4) == {"drct_rdg_calls": 24,
                                                  "drct_masked_attn_calls": 48}
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and str(e.get("name")).startswith("zoo.")]
    assert {n: names.count(n) for n in set(names)} == {
        "zoo.rdg": 2, "zoo.dense": 10,
        "zoo.qkv": 10, "zoo.attention": 10, "zoo.proj": 10, "zoo.mlp": 10}
    entered = []  # with no profiler recording, no span is entered
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", lambda *a, **k: entered.append(a))
    with torch.inference_mode():
        engine.model(x[:1])
    assert entered == []


def test_swin_block_stages_nest_in_order_inside_each_group(f32):
    """Each RDG holds five Swin blocks' four stages, one after another, each
    block's stages before its dense step, and no stage inside a dense step."""
    _, engine, x, _ = f32
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            engine.model(x[:1])
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("zoo.")), key=lambda s: s[1])
    rdgs = [s for s in spans if s[0] == "zoo.rdg"]
    assert len(rdgs) == 2
    for _, a0, b0 in rdgs:
        assert [n for n, a, b in spans if a0 <= a and b <= b0 and n != "zoo.rdg"] == 5 * [
            "zoo.qkv", "zoo.attention", "zoo.proj", "zoo.mlp", "zoo.dense"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]) if a[0] != "zoo.rdg")


@pytest.mark.parametrize("change,what", [
    (dict(mlp_ratio=2.0), "MLP hidden"),
    (dict(gc=16), "channels"),
    (dict(num_heads=[6, 6, 6]), "groups"),
    (dict(patch_size=4), "unclamped"),
])
def test_program_refuses_a_model_that_is_not_the_configurations(f32, change, what):
    _, engine, _, _ = f32
    program.check_model(engine.model, CFG)
    with pytest.raises(ValueError, match=what):
        program.check_model(engine.model, dict(CFG, **change))


# kernel names of one bf16 DRCT call on an NVIDIA H100 (torch 2.11, CUDA 12.8)
CARD_KERNELS = {
    "attention_128": "void (anonymous namespace)::window_attention_sm90_kernel<128, 2, false>("
                     "(anonymous namespace)::Params)",
    "attention_32": "void (anonymous namespace)::window_attention_sm90_kernel<32, 2, false>("
                    "(anonymous namespace)::Params)",
    "cat": "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::"
           "(anonymous namespace)::OpaqueType<2u>, unsigned int, 3, 128, 1, 16>(at::native::"
           "(anonymous namespace)::OpaqueType<2u>*, at::native::(anonymous namespace)::"
           "CatArrInputTensorMetadata<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned "
           "int, 128, 1>, at::native::(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, "
           "int, unsigned int)",
    "gemm": "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_"
            "execute_segment_k_off_kernel__5x_cublas",
    "copy": "Memcpy DtoD (Device -> Device)",
}


def test_drct_readers_on_a_synthetic_trace_of_card_kernel_names():
    seconds = {"attention_128": 0.04, "attention_32": 0.02, "cat": 0.01, "gemm": 0.3,
               "copy": 0.02}
    ops, t = [], 0.0
    for k, s in seconds.items():  # each kernel twice, back to back
        for _ in range(2):
            ops.append((CARD_KERNELS[k], t, t + s / 2))
            t += s / 2
    cfg = harness.load_cell("drct_sr_bf16_bulk")["cfg"]
    ctx = {"cfg": cfg, "trace": {"ops": ops, "window_s": t, "busy_s": t}, "traced_images": 16}
    roofline = harness.module("metrics", "drct.attention_roofline").read
    concat = harness.module("metrics", "drct.concat_ms_per_image").read
    least, by = bound_s(16 * drct_counts.attention_ops(cfg),
                        16 * drct_counts.attention_bytes(cfg), "bfloat16")
    assert by == "bytes"
    assert roofline(ctx) == pytest.approx(100.0 * least / 0.06)
    assert concat(ctx) == pytest.approx(1e3 * 0.01 / 16)
    for r in (roofline, concat):
        assert r({"cfg": cfg}) is None  # no trace
        assert r(dict(ctx, trace={"ops": [(CARD_KERNELS["gemm"], 0.0, 1.0)]})) is None  # none of its
    other = harness.load_cell("hat_sr_bf16_bulk")["cfg"]
    assert roofline(dict(ctx, cfg=other)) is None  # another model's attention
