"""The zoo's shared modules against the JAX package's, on the CPU.

The same numpy inputs and the same Flax init (carried into the port through
`utils/weights.py`) through JAX's module and its port: the window geometry
(partition / reverse, relative-position index, shift mask, effective
window) exactly; `WindowAttention` with and without a mask, the Swin block
with and without a shift, SwinFIR's `FourierUnit`, HAT's `OCAB` and
Restormer's `MDTA` and `ChannelLayerNorm` at the f32 class (1e-5 x
max(1, max|JAX|)) and the bf16 class (4 bf16 ulps x max(1, max|JAX f32|)
of JAX's bf16); HAT's overlap unfold bitwise, against JAX's and against
torch's `nn.Unfold` in JAX's order. Each test prints max|diff|.

Three precision traps, each with a test that fails if it is missed: the
attention logits are f32 from bf16 operands (a bf16 product would round
them), `q * scale` rounds the scale to bf16 first, and Flax's LayerNorm
takes its statistics in f32 for a bf16 input.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_zoo_common import BF16_TOL, F32_TOL, check, jax_apply, jax_init, port, run_port

from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import restormer as trest
from xmm_superres_denoise_torch.models import swin_common as tsc
from xmm_superres_denoise_torch.models import swinir as tswinir

jsc = importlib.import_module("xmm_superres_denoise_tpu.models.swin_common")
jhat = importlib.import_module("xmm_superres_denoise_tpu.models.hat")
jrest = importlib.import_module("xmm_superres_denoise_tpu.models.restormer")
jswinir = importlib.import_module("xmm_superres_denoise_tpu.models.swinir")
flax_nn = importlib.import_module("flax.linen")


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


# --------------------------------------------------------------------------
# window geometry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,ws,shift", [(12, 12, 4, 2), (24, 18, 6, 3), (16, 16, 8, 0),
                                          (26, 26, 13, 6)])
def test_window_geometry_matches_jax(h, w, ws, shift):
    x = _normal((2, h, w, 3), seed=h * w)
    win = tsc.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jsc.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(tsc.window_reverse(win, ws, h, w).numpy(), x)
    np.testing.assert_array_equal(tsc.relative_position_index(ws, ws),
                                  jsc.relative_position_index(ws, ws))
    got, want = tsc.shifted_window_mask(h, w, ws, shift), jsc.shifted_window_mask(h, w, ws, shift)
    assert (got is None) == (want is None) == (shift == 0)
    if shift:
        np.testing.assert_array_equal(got, want)
        mask = tsc.shift_mask(h, w, ws, shift, "cpu")
        assert mask is tsc.shift_mask(h, w, ws, shift, "cpu")  # made once per (size, device)
        np.testing.assert_array_equal(mask.numpy(), want)
    for res in ((13, 13), (26, 26), (3, 3)):  # the clamp depends on the config's resolution
        assert tsc.effective_window(res, 16, 8) == jsc.effective_window(res, 16, 8)
    assert tsc.effective_window((13, 13), 16, 8) == (13, 0)


# --------------------------------------------------------------------------
# attention and the Swin block
# --------------------------------------------------------------------------

C, HEADS = 60, 2  # head dim 30, as in production (180 / 6): d**-0.5 is not a bf16 number


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_window_attention_matches_jax(masked):
    ws, h = 4, 8
    x = _normal((2 * (h // ws) ** 2, ws * ws, C), seed=1)
    mask = jsc.shifted_window_mask(h, h, ws, 2) if masked else None
    jm = jsc.WindowAttention(C, (ws, ws), HEADS)
    v = jax_init(jm, x, mask)
    tm = port(tsc.WindowAttention(C, (ws, ws), HEADS), v)
    tmask = None if mask is None else torch.from_numpy(mask)
    check(run_port(tm, x, tmask), jax_apply(jm, v, x, mask), F32_TOL, f"WindowAttention f32 {masked=}")
    want32 = jax_apply(jm, v, x, mask)
    check(run_port(tm, x, tmask, dtype=torch.bfloat16),
          jax_apply(jm, v, x, mask, dtype=jnp.bfloat16), BF16_TOL, "WindowAttention bf16",
          scale=want32)


@pytest.mark.parametrize("shift", [0, 3], ids=["W-MSA", "SW-MSA"])
def test_swin_block_matches_jax(shift):
    h, ws = 12, 6
    x = _normal((2, h * h, C), seed=2 + shift)
    kw = dict(dim=C, input_resolution=(h, h), num_heads=HEADS, window_size=ws,
              shift_size=shift, mlp_ratio=2.0)
    jm = jsc.SwinTransformerBlock(**kw)
    v = jax_init(jm, x, (h, h))
    tm = port(tsc.SwinTransformerBlock(**kw), v)
    assert tm.shift == shift
    want = jax_apply(jm, v, x, (h, h))
    check(run_port(tm, x, (h, h)), want, F32_TOL, f"SwinTransformerBlock f32 shift {shift}")
    check(run_port(tm, x, (h, h), dtype=torch.bfloat16),
          jax_apply(jm, v, x, (h, h), dtype=jnp.bfloat16), BF16_TOL,
          f"SwinTransformerBlock bf16 shift {shift}", scale=want)


def test_attention_logits_are_f32_from_bf16_operands_with_a_bf16_scale():
    """The port's attention core against JAX's expression (swin_common.py's
    einsum with preferred_element_type=f32, f32 softmax, cast, attn @ v) on
    the same bf16 q, k, v with logits of a few units: within one bf16 ulp of
    the output. Logits from a bf16 product, or the scale unrounded, miss it."""
    b, n, d = 8, 49, 30
    scale = d**-0.5
    q, k, v = (_normal((b, HEADS, n, d), seed=s, scale=3.0) for s in (3, 4, 5))

    def jax_core(q, k, v):
        q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
        attn = jnp.einsum("bhnd,bhmd->bhnm", q * scale, k, preferred_element_type=jnp.float32)
        attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1).astype(jnp.bfloat16)
        return np.asarray(jnp.einsum("bhnm,bhmd->bhnd", attn, v).astype(jnp.float32))

    want = jax_core(q, k, v)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    got = tsc.attention_core(tq, tk, tv, scale, None, None).float().numpy()
    ulp = 2.0**-8 * float(np.abs(want).max())
    naive_logits = torch.softmax((tq * scale) @ tk.transpose(-2, -1), -1).float()
    naive = (naive_logits.bfloat16() @ tv).float().numpy()
    unrounded = torch.softmax((tq.float() * scale) @ tk.float().transpose(-2, -1), -1)
    unrounded = (unrounded.bfloat16() @ tv).float().numpy()
    errs = {name: float(np.abs(t - want).max()) for name, t in
            (("port", got), ("bf16 logits", naive), ("f32 scale", unrounded))}
    print(f"attention core, bf16 operands: max|diff| from JAX {errs} (one ulp {ulp:.3e})")
    assert errs["port"] <= ulp
    assert errs["bf16 logits"] > ulp and errs["f32 scale"] > 0.0


def test_layer_norm_takes_f32_statistics_for_bf16_input():
    """The port's LayerNorm against Flax's on bf16 input and bf16
    parameters: bitwise, or one bf16 ulp where the f32 sums differ. A
    LayerNorm computed in bf16 is further off."""
    x = _normal((4, 64, C), seed=6, scale=2.0) + 3.0
    jm = flax_nn.LayerNorm(epsilon=1e-5)
    v = jax_init(jm, x)
    v["params"]["scale"] = _normal((C,), seed=7) + 1.0
    v["params"]["bias"] = _normal((C,), seed=8)
    want = jax_apply(jm, v, x, dtype=jnp.bfloat16)
    tm = port(tsc.LayerNorm(C), v).bfloat16()
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = tm(xb).float().numpy()
        mu = xb.mean(-1, keepdim=True)
        var = ((xb - mu) ** 2).mean(-1, keepdim=True)
        in_bf16 = ((xb - mu) / torch.sqrt(var + 1e-5) * tm.scale + tm.bias).float().numpy()
    ulp = 2.0**-8 * float(np.abs(want).max())
    err, err16 = float(np.abs(got - want).max()), float(np.abs(in_bf16 - want).max())
    print(f"LayerNorm bf16: port max|diff| {err:.3e}, computed in bf16 {err16:.3e} "
          f"(one ulp {ulp:.3e}); entries differing {(got != want).mean():.2%}")
    assert err <= ulp and err16 > err


def test_drop_path_draws_only_from_a_generator():
    x = torch.ones(8, 5, 3)
    assert tsc.drop_path(x, 0.5, None) is x  # the deterministic forward
    assert tsc.drop_path(x, 0.0, torch.Generator().manual_seed(0)) is x
    y = tsc.drop_path(x, 0.5, torch.Generator().manual_seed(0))
    kept = y[:, 0, 0]
    assert set(kept.tolist()) <= {0.0, 2.0} and 0 < int((kept > 0).sum()) < 8
    assert torch.equal(y, tsc.drop_path(x, 0.5, torch.Generator().manual_seed(0)))
    assert all(torch.equal(y[i], torch.full_like(y[i], float(kept[i]))) for i in range(8))
    # through a model: a generator draws, the same seed draws the same, and
    # a recompute under checkpointing would draw again, so it is refused
    kw = dict(img_size=12, patch_size=1, in_chans=1, embed_dim=12, depths=(2,), num_heads=(2,),
              window_size=6, mlp_ratio=2.0, upscale=1, upsampler="", drop_path_rate=0.5)
    model = tswinir.SwinIR(**kw)
    x = torch.rand(4, 12, 12, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = model(x)
        drawn = [model(x, torch.Generator().manual_seed(s)) for s in (2, 2, 3)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], plain)
    assert not torch.equal(drawn[0], drawn[2])
    with pytest.raises(ValueError, match="checkpointing"):
        tswinir.SwinIR(**kw, use_checkpoint=True)(x, torch.Generator().manual_seed(2))


# --------------------------------------------------------------------------
# SwinFIR's FourierUnit, HAT's unfold and OCAB, Restormer's MDTA
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(12, 12), (10, 14)])
def test_fourier_unit_matches_jax(h, w):
    """torch.fft.rfft2/irfft2 against JAX's real-DFT matmuls, in f32 for
    either input dtype; odd and even widths."""
    x = _normal((2, h, w, 6), seed=h + w)
    jm = jswinir.FourierUnit(6)
    v = jax_init(jm, x)
    tm = port(tswinir.FourierUnit(6), v)
    want = jax_apply(jm, v, x)
    check(run_port(tm, x), want, F32_TOL, f"FourierUnit f32 {h}x{w}")
    check(run_port(tm, x, dtype=torch.bfloat16), jax_apply(jm, v, x, dtype=jnp.bfloat16),
          BF16_TOL, f"FourierUnit bf16 {h}x{w}", scale=want)


@pytest.mark.parametrize("ws,owin,hw", [(4, 6, 12), (16, 24, 32), (6, 8, 24)])
def test_hat_unfold_matches_jax_and_torch_unfold(ws, owin, hw):
    x = _normal((2, hw, hw, 5), seed=ws)
    got = thaat.unfold_overlap_windows(torch.from_numpy(x), ws, owin).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhat.unfold_overlap_windows(jnp.asarray(x), ws,
                                                                                owin)))
    unf = torch.nn.Unfold(kernel_size=owin, stride=ws, padding=(owin - ws) // 2)
    ref = unf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    nw = ref.shape[-1]
    ref = ref.view(2, 5, owin * owin, nw).permute(0, 3, 2, 1).reshape(-1, owin * owin, 5)
    np.testing.assert_array_equal(got, ref.numpy())
    np.testing.assert_array_equal(thaat.rpi_oca(ws, (owin - ws) / ws),
                                  jhat.rpi_oca(ws, (owin - ws) / ws))


def test_ocab_matches_jax():
    h, ws = 12, 6
    x = _normal((2, h * h, C), seed=9)
    kw = dict(dim=C, input_resolution=(h, h), window_size=ws, overlap_ratio=1 / 3,
              num_heads=HEADS, mlp_ratio=2.0)
    jm = jhat.OCAB(**kw)
    v = jax_init(jm, x, (h, h))
    tm = port(thaat.OCAB(**kw), v)
    want = jax_apply(jm, v, x, (h, h))
    check(run_port(tm, x, (h, h)), want, F32_TOL, "OCAB f32")
    check(run_port(tm, x, (h, h), dtype=torch.bfloat16),
          jax_apply(jm, v, x, (h, h), dtype=jnp.bfloat16), BF16_TOL, "OCAB bf16", scale=want)


def test_mdta_and_channel_layer_norm_match_jax():
    x = _normal((2, 10, 12, 16), seed=10)
    jm = jrest.MDTA(16, 4)
    v = jax_init(jm, x)
    v["params"]["temperature"] = np.linspace(0.5, 2.0, 4, dtype=np.float32).reshape(4, 1, 1)
    tm = port(trest.MDTA(16, 4), v)
    want = jax_apply(jm, v, x)
    check(run_port(tm, x), want, F32_TOL, "MDTA f32")
    check(run_port(tm, x, dtype=torch.bfloat16), jax_apply(jm, v, x, dtype=jnp.bfloat16),
          BF16_TOL, "MDTA bf16", scale=want)
    for with_bias in (True, False):
        jn = jrest.ChannelLayerNorm(16, with_bias)
        vn = jax_init(jn, x)
        vn["params"]["weight"] = _normal((16,), seed=11) + 1.0
        tn = port(trest.ChannelLayerNorm(16, with_bias), vn)
        want = jax_apply(jn, vn, x)
        check(run_port(tn, x), want, F32_TOL, f"ChannelLayerNorm f32 {with_bias=}")
        check(run_port(tn, x, dtype=torch.bfloat16), jax_apply(jn, vn, x, dtype=jnp.bfloat16),
              BF16_TOL, f"ChannelLayerNorm bf16 {with_bias=}", scale=want)


# --------------------------------------------------------------------------
# the attention split and the Swin block's stage spans
# --------------------------------------------------------------------------

STAGES = ["zoo.qkv", "zoo.attention", "zoo.proj", "zoo.mlp"]


def _seeded_block(shift, dtype):
    blk = tsc.SwinTransformerBlock(C, (8, 8), HEADS, window_size=4, shift_size=shift,
                                   mlp_ratio=2.0)
    tsc.reset_zoo_parameters(blk, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
    return blk.to(dtype).eval()


def _unsplit_attend(attn, qkv, mask):
    """The attention and proj of (B*nW, N, 3C) rows as one function, the
    composition before `attend` and `project` split it."""
    b_, n, c3 = qkv.shape
    c, nh = c3 // 3, attn.num_heads
    qkv = qkv.reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    table = attn.relative_position_bias_table.to(qkv.dtype)
    bias = table[attn.relative_position_index.view(-1)].view(n, n, nh).permute(2, 0, 1)
    out = tsc.attention_core(qkv[0], qkv[1], qkv[2], attn.scale, bias, mask)
    return tsc.linear(attn.proj, out.transpose(1, 2).reshape(b_, n, c))


def _unsplit_block(blk, x, x_size):
    h, w = x_size
    b, l, c = x.shape
    ws, shift = blk.ws, blk.shift
    qkv = tsc.window_qkv(x, x_size, ws, shift, blk.norm1, blk.attn.qkv)
    attn = _unsplit_attend(blk.attn, qkv, tsc.shift_mask(h, w, ws, shift, x.device))
    y = tsc.window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + y.reshape(b, l, c)
    return tsc.mlp_residual(x, blk.norm2, blk.mlp, 0.0, None)


@pytest.mark.parametrize("shift", [0, 2], ids=["W-MSA", "SW-MSA"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attend_then_project_is_the_unsplit_composition_bitwise(shift, dtype):
    blk = _seeded_block(shift, dtype)
    x = torch.from_numpy(_normal((2, 64, C), seed=12)).to(dtype)
    xw = torch.from_numpy(_normal((8, 16, C), seed=13)).to(dtype)
    mask = tsc.shift_mask(8, 8, 4, shift, "cpu")
    with torch.inference_mode():
        qkv = tsc.linear(blk.attn.qkv, xw)
        assert torch.equal(blk.attn.project(blk.attn.attend(qkv, mask)),
                           _unsplit_attend(blk.attn, qkv, mask))
        assert torch.equal(blk.attn(xw, mask), _unsplit_attend(blk.attn, qkv, mask))
        assert torch.equal(blk(x, (8, 8)), _unsplit_block(blk, x, (8, 8)))


def _zoo_spans(prof):
    """(name, start, end) of the `zoo.*` spans a CPU profile recorded, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("zoo.")), key=lambda s: s[1])


@pytest.mark.parametrize("shift", [0, 2], ids=["W-MSA", "SW-MSA"])
def test_swin_block_opens_its_four_stages_in_order(shift):
    blk = _seeded_block(shift, torch.float32)
    x = torch.from_numpy(_normal((1, 64, C), seed=14))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            blk(x, (8, 8))
    spans = _zoo_spans(prof)
    assert [n for n, _, _ in spans] == STAGES
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after another
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            blk.attn(torch.from_numpy(_normal((4, 16, C), seed=15)))
    assert _zoo_spans(prof) == []  # the module alone, as OCAB's helpers: no stage span
