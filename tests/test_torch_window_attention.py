"""The zoo's window attention (`ops/window_attention.py`): the wrapper's
routing and launch plan on the CPU, and the hand-written kernel of
`csrc/window_attention.cu` against its plain composition on the card.

This file imports no JAX. The tests marked `gpu` skip without a CUDA card;
whether a card is present is decided inside the `cuda` fixture:

    python -m pytest --noconftest tests/test_torch_window_attention.py

Tolerance of the kernel against `window_attention_plain` on the card, per
output element: the two compute the same f32 logits up to the order of
their f32 sums (products of bf16 values are exact in f32), and the same
f32 softmax up to that and the exponential's last bits. What may change is
the bf16 rounding of a probability P_j near a rounding boundary, by one
ulp (at most 2^-7 P_j), and the bf16 rounding of the output, by one ulp
(at most 2^-7 |o|). So |kernel - plain| <= 2^-7 (sum_j P_j |v_j| + |o|),
with P the plain version's f32 probabilities; 1e-6 more covers the f32
sums' order where both round alike.
"""

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_sass import sass_counts
from xmm_superres_denoise_torch.models.hat import rpi_oca, unfold_overlap_windows
from xmm_superres_denoise_torch.models.swin_common import (
    attention_core,
    index_buffer,
    relative_position_index,
    shifted_window_mask,
    window_partition,
)
from xmm_superres_denoise_torch.ops.window_attention import (
    _bias_rows,
    MAX_HEAD,
    MAX_KEYS,
    MAX_QUERIES,
    padded_head,
    plan,
    readable,
    route,
    route_for,
    window_attention,
    window_attention_plain,
)

NH, C = 6, 180  # the zoo's heads and width: d = 30
D = C // NH


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _bf16(g, shape, std=1.0):
    return torch.from_numpy((g.normal(size=shape) * std).astype(np.float32)).bfloat16()


def _window_case(ws: int, windows: int, shift_hw=None, seed=0, device="cpu", c=C, nh=NH):
    """WindowAttention's operands at window ws and width c over nh heads: q,
    k, v the strided views of one (B_, N, 3c) qkv, the bias gathered from a
    bf16 table as the module gathers it, and the shift mask of a (h, w)
    image when `shift_hw` is given (B_ a multiple of its nW)."""
    g = np.random.default_rng(seed)
    n, d = ws * ws, c // nh
    qkv = _bf16(g, (windows, n, 3 * c)).to(device)
    qkv5 = qkv.reshape(windows, n, 3, nh, d).permute(2, 0, 3, 1, 4)
    table = _bf16(g, ((2 * ws - 1) ** 2, nh)).to(device)
    idx = index_buffer(relative_position_index(ws, ws)).to(device)
    bias = table[idx.view(-1)].view(n, n, nh).permute(2, 0, 1)
    mask = None
    if shift_hw is not None:
        h, w = shift_hw
        mask = torch.from_numpy(shifted_window_mask(h, w, ws, ws // 2)).to(device)
        assert windows % mask.shape[0] == 0
    return qkv5[0], qkv5[1], qkv5[2], d ** -0.5, bias, mask


def _ocab_case(images: int, side: int, seed=0, device="cpu", ws=16, overlap=0.5):
    """OCAB's operands on `images` images of side x side tokens: q from 16 x
    16 windows, k and v the strided halves of the unfolded 24 x 24 windows,
    the bias gathered by `rpi_oca`."""
    g = np.random.default_rng(seed)
    owin = ws + int(ws * overlap)
    qkv = _bf16(g, (images, side, side, 3 * C)).to(device)
    q_windows = window_partition(qkv[..., :C], ws).reshape(-1, ws * ws, C)
    kv = unfold_overlap_windows(qkv[..., C:], ws, owin)
    b_, nq, m = q_windows.shape[0], ws * ws, owin * owin
    q = q_windows.reshape(b_, nq, NH, D).transpose(1, 2)
    k = kv[..., :C].reshape(b_, m, NH, D).transpose(1, 2)
    v = kv[..., C:].reshape(b_, m, NH, D).transpose(1, 2)
    table = _bf16(g, ((ws + owin - 1) ** 2, NH)).to(device)
    idx = index_buffer(rpi_oca(ws, overlap)).to(device)
    bias = table[idx.view(-1)].view(nq, m, NH).permute(2, 0, 1)
    return q, k, v, D ** -0.5, bias, None


def _free_case(n: int, m: int, windows: int, seed=0, device="cpu", d=D):
    """Contiguous (B_, nh, rows, d) operands at any N and M, with a bias."""
    g = np.random.default_rng(seed)
    q = _bf16(g, (windows, NH, n, d)).to(device)
    k = _bf16(g, (windows, NH, m, d)).to(device)
    v = _bf16(g, (windows, NH, m, d)).to(device)
    bias = _bf16(g, (NH, n, m)).to(device)
    return q, k, v, d ** -0.5, bias, None


# the cells' shapes and two ragged ones: (name, case builder)
CASES = {
    "swinir_169x169": lambda dev: _window_case(13, 64, device=dev),
    "hab_256x256": lambda dev: _window_case(16, 32, device=dev),
    "hab_256x256_shift_mask": lambda dev: _window_case(16, 32, shift_hw=(64, 64), device=dev),
    "ocab_256x576_unfolded": lambda dev: _ocab_case(2, 64, device=dev),
    "ragged_49x49_shift_mask": lambda dev: _window_case(7, 8, shift_hw=(14, 14), device=dev),
    "ragged_100x320": lambda dev: _free_case(100, 320, 4, device=dev),
    # DRCT's dense blocks at 13 x 13: widths 212, 244, 276 over 4, 2, 6 heads
    "drct_169x169_d53": lambda dev: _window_case(13, 16, device=dev, c=212, nh=4),
    "drct_169x169_d122": lambda dev: _window_case(13, 16, device=dev, c=244, nh=2),
    "drct_169x169_d46_shift_mask": lambda dev: _window_case(13, 8, shift_hw=(26, 26), device=dev,
                                                            c=276, nh=6),
    "wide_100x384_d64": lambda dev: _free_case(100, 384, 4, device=dev, d=64),
    # DRCT's dense blocks at window 16 (the benchmark's configuration): 256
    # keys at d 122 and 77 (blocks 3 and 5, padded to 128), and at d 53 and
    # 46 under the shift mask (blocks 2 and 4)
    "drct_256x256_d122": lambda dev: _window_case(16, 8, device=dev, c=244, nh=2),
    "drct_256x256_d77": lambda dev: _window_case(16, 8, device=dev, c=308, nh=4),
    "drct_256x256_d53_shift_mask": lambda dev: _window_case(16, 8, shift_hw=(32, 32), device=dev,
                                                            c=212, nh=4),
    "drct_256x256_d46_shift_mask": lambda dev: _window_case(16, 8, shift_hw=(32, 32), device=dev,
                                                            c=276, nh=6),
}


# --------------------------------------------------------------------------
# CPU: the routing decision, the launch plan, the mask's window index
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device_type,dtype,needs_grad,want", [
    ("cuda", torch.bfloat16, False, "kernel"),
    ("cuda", torch.bfloat16, True, "plain"),
    ("cuda", torch.float32, False, "plain"),
    ("cuda", torch.float16, False, "plain"),
    ("cpu", torch.bfloat16, False, "plain"),
    ("cpu", torch.float32, False, "plain"),
])
def test_route_for(device_type, dtype, needs_grad, want):
    assert route_for(device_type, dtype, needs_grad) == want


def test_route_reads_grad_mode_and_requires_grad():
    q, k, v, _, bias, _ = _free_case(8, 8, 1)
    assert route(q, k, v, bias) == "plain"  # a CPU tensor
    # on the CPU the device decides; what route reads of autograd is
    # grad_needed: grad mode and requires_grad of any operand
    from xmm_superres_denoise_torch.ops.dense_block import grad_needed

    assert not grad_needed(q, k, v, bias)
    assert grad_needed(q, k, v, bias.clone().requires_grad_())
    with torch.no_grad():
        assert not grad_needed(q.clone().requires_grad_(), k, v, bias)


@pytest.mark.parametrize("name,want", [
    # (padded d, channel pairs, splits, chunks per split, query tiles,
    # bias_cols, windows, mask pairs)
    ("swinir_169x169", (32, True, 1, 3, 3, 170, 0, False)),
    ("hab_256x256", (32, True, 2, 2, 4, 256, 0, False)),
    ("hab_256x256_shift_mask", (32, True, 2, 2, 4, 256, 16, True)),
    ("ocab_256x576_unfolded", (32, True, 3, 3, 4, 576, 0, False)),
    ("ragged_49x49_shift_mask", (32, True, 1, 1, 1, 50, 4, False)),
    ("ragged_100x320", (32, True, 2, 3, 2, 320, 0, False)),
    ("drct_169x169_d53", (64, False, 2, 2, 3, 170, 0, False)),
    ("drct_169x169_d122", (128, True, 3, 1, 3, 170, 0, False)),
    ("drct_169x169_d46_shift_mask", (64, True, 2, 2, 3, 170, 4, False)),
    ("wide_100x384_d64", (64, True, 3, 2, 2, 384, 0, False)),
    ("drct_256x256_d122", (128, True, 2, 2, 4, 256, 0, False)),
    ("drct_256x256_d77", (128, False, 2, 2, 4, 256, 0, False)),
    ("drct_256x256_d53_shift_mask", (64, False, 2, 2, 4, 256, 4, True)),
    ("drct_256x256_d46_shift_mask", (64, True, 2, 2, 4, 256, 4, True)),
])
def test_plan_at_the_cells_shapes(name, want):
    q, k, v, _, bias, mask = CASES[name]("cpu")
    pl = plan(q, k, v, bias, mask)
    assert (pl.padded_head, pl.channel_pairs, pl.splits, pl.chunks_per_split, pl.query_tiles,
            pl.bias_cols, pl.windows, pl.mask_pairs) == want
    assert (pl.batch, pl.heads, pl.queries, pl.keys, pl.head_dim) == (
        q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3])
    # every warpgroup has a chunk below M, and the chunks cover M
    assert (pl.splits - 1) * pl.chunks_per_split * 64 < pl.keys
    assert pl.splits * pl.chunks_per_split * 64 >= pl.keys
    assert (pl.q_strides, pl.k_strides, pl.v_strides) == (
        q.stride()[:3], k.stride()[:3], v.stride()[:3])


def test_plan_reads_qkv_and_the_unfolded_keys_in_place():
    # WindowAttention's q, k, v are views of one (B_, N, 3C) qkv: window
    # stride N * 3C, head stride d, row stride 3C; OCAB's k and v halves of
    # the unfolded (B_, 576, 2C) windows: row stride 2C
    q, k, v, _, bias, _ = CASES["swinir_169x169"]("cpu")
    pl = plan(q, k, v, bias)
    assert pl.q_strides == pl.k_strides == pl.v_strides == (169 * 3 * C, D, 3 * C)
    assert k.data_ptr() - q.data_ptr() == C * 2 and v.data_ptr() - q.data_ptr() == 2 * C * 2
    q, k, v, _, bias, _ = CASES["ocab_256x576_unfolded"]("cpu")
    pl = plan(q, k, v, bias)
    assert pl.q_strides == (256 * C, D, C)
    assert pl.k_strides == pl.v_strides == (576 * 2 * C, D, 2 * C)


def test_readable_copies_only_what_the_kernel_cannot_read_in_place():
    for name in ("swinir_169x169", "ocab_256x576_unfolded"):
        q, k, v, *_ = CASES[name]("cpu")
        assert all(readable(t) is t for t in (q, k, v))
    # a single image's unfold is a view with strided channels
    g = np.random.default_rng(0)
    kv = unfold_overlap_windows(_bf16(g, (1, 32, 32, 2 * C)), 16, 24)
    k = kv[..., :C].reshape(-1, 576, NH, D).transpose(1, 2)
    assert k.stride(-1) != 1
    kr = readable(k)
    assert kr.stride(-1) == 1 and torch.equal(kr, k)
    assert plan(kr[:, :, :256], kr, kr).k_strides == (NH * 576 * D, 576 * D, D)


def test_bias_rows_are_contiguous_aligned_and_padded_past_an_odd_m():
    # the kernel reads the bias a pair of columns to a 32-bit load: a
    # contiguous, aligned bias is read in place; one at an odd element
    # offset, or a permuted view, is copied; past an odd M a zero column
    g = np.random.default_rng(0)
    size = NH * 16 * 16
    flat = _bf16(g, (2 + size,))
    start = 0 if flat.data_ptr() % 4 == 0 else 1
    aligned = flat[start:start + size].view(NH, 16, 16)
    odd = flat[start + 1:start + 1 + size].view(NH, 16, 16)
    assert _bias_rows(aligned, 16) is aligned
    assert odd.is_contiguous() and odd.data_ptr() % 4 == 2
    rows = _bias_rows(odd, 16)
    assert rows.data_ptr() % 4 == 0 and rows.is_contiguous() and torch.equal(rows, odd)
    permuted = aligned.permute(0, 2, 1)
    rows = _bias_rows(permuted, 16)
    assert rows.is_contiguous() and torch.equal(rows, permuted)
    _, _, _, _, bias, _ = CASES["swinir_169x169"]("cpu")
    rows = _bias_rows(bias, 170)
    assert rows.shape == (NH, 169, 170) and rows.data_ptr() % 4 == 0
    assert torch.equal(rows[..., :169], bias) and not rows[..., 169].any()


def test_padded_head():
    # an odd d takes the 64- or 128-channel forms, which read single channels
    assert [padded_head(d) for d in (1, 2, 30, 31, 32, 33, 46, 53, 64, 77, 122, 128)] == [
        64, 32, 32, 64, 32, 64, 64, 64, 64, 128, 128, 128]


@pytest.mark.parametrize("d", [30, 31, 46, 53, 77, 122])
def test_split_covers_every_key_count(d):
    # every warpgroup holds a chunk below M, the chunks cover M, within the
    # kernel's three warpgroups and three chunks each; that the kernel has
    # an instance for each split is its own check, on the card
    # (test_kernel_takes_every_split_the_wrapper_makes)
    dk = padded_head(d)
    for m in range(1, MAX_KEYS[dk] + 1):
        pl = plan(*_free_case(4, m, 1, d=d)[:3])
        ks, cpw = pl.splits, pl.chunks_per_split
        assert pl.padded_head == dk and 1 <= ks <= 3 and 1 <= cpw <= 3, m
        assert (ks - 1) * cpw * 64 < m <= ks * cpw * 64


@pytest.mark.parametrize("n,m,d,what", [
    (MAX_QUERIES + 1, 64, D, "queries"),
    (64, MAX_KEYS[32] + 1, D, "keys"),
    (64, MAX_KEYS[64] + 1, 46, "keys"),
    (64, MAX_KEYS[128] + 1, 122, "keys"),
    (64, MAX_KEYS[128] + 1, 77, "keys"),
    (64, 64, MAX_HEAD + 2, "head size"),
])
def test_plan_refuses_shapes_outside_the_range(n, m, d, what):
    g = np.random.default_rng(0)
    q, k, v = _bf16(g, (2, 2, n, d)), _bf16(g, (2, 2, m, d)), _bf16(g, (2, 2, m, d))
    with pytest.raises(ValueError, match=what):
        plan(q, k, v)


def test_plan_refuses_odd_strides_and_a_foreign_mask():
    g = np.random.default_rng(0)
    base = _bf16(g, (2, 2, 16, 31))
    q = base[..., :30]  # row stride 31: channels in pairs would straddle words
    with pytest.raises(ValueError, match="even strides"):
        plan(q, q, q)
    q, k, v, _, bias, mask = CASES["hab_256x256_shift_mask"]("cpu")
    with pytest.raises(ValueError, match="multiple of nW"):
        plan(q[:20], k[:20], v[:20], bias, mask)
    with pytest.raises(ValueError, match="bias"):
        plan(q, k, v, bias[:, :, :10], mask)
    with pytest.raises(ValueError, match="bias in q's dtype"):
        plan(q, k, v, bias.float(), mask)


def test_mask_of_window_b_is_mask_b_mod_nw():
    # the kernel reads mask[b % nW] for window b: the plain version's view
    # of B_ as (B_ / nW, nW) implies that order
    q, k, v, scale, bias, mask = CASES["ragged_49x49_shift_mask"]("cpu")
    q, k, v, bias = q.float(), k.float(), v.float(), bias.float()
    got = window_attention_plain(q, k, v, scale, bias, mask)
    nw = mask.shape[0]
    for b in range(q.shape[0]):
        one = window_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], scale, bias,
                                     mask[b % nw][None])
        torch.testing.assert_close(got[b:b + 1], one, rtol=0, atol=1e-6)
        # and not the mask of another window
        other = window_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], scale, bias,
                                       mask[(b + 1) % nw][None])
        assert (got[b:b + 1] - other).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_core_on_the_cpu_is_the_plain_composition(dtype):
    q, k, v, scale, bias, mask = CASES["hab_256x256_shift_mask"]("cpu")
    q, k, v, bias = q.to(dtype), k.to(dtype), v.to(dtype), bias.to(dtype)
    before = window_attention.launches
    got = attention_core(q, k, v, scale, bias, mask)
    assert torch.equal(got, window_attention_plain(q, k, v, scale, bias, mask))
    assert got.shape == q.shape and window_attention.launches == before


# --------------------------------------------------------------------------
# The card: the kernel against the plain composition
# --------------------------------------------------------------------------


def _bound(q, k, v, scale, bias, mask, plain):
    """2^-7 (sum_j P_j |v_j| + |o|) + 1e-6, P the plain f32 probabilities."""
    qs = (q * torch.full((), scale, dtype=q.dtype, device=q.device)).float()
    s = torch.matmul(qs, k.float().transpose(-2, -1))
    if bias is not None:
        s = s + bias.float()[None]
    if mask is not None:
        b_, nh, n, m = s.shape
        nw = mask.shape[0]
        s = (s.view(b_ // nw, nw, nh, n, m) + mask[None, :, None]).view(b_, nh, n, m)
    p = torch.softmax(s, dim=-1)
    return 2.0**-7 * (torch.matmul(p, v.float().abs()) + plain.float().abs()) + 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_the_plain_composition(cuda, name):
    q, k, v, scale, bias, mask = CASES[name](cuda)
    before = window_attention.launches
    with torch.inference_mode():
        got = window_attention(q, k, v, scale, bias, mask)
        plain = window_attention_plain(q, k, v, scale, bias, mask)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    # the kernel writes (B_, N, nh * d): the caller's transpose is a view
    assert got.transpose(1, 2).is_contiguous()
    diff = (got.float() - plain.float()).abs()
    bound = _bound(q, k, v, scale, bias, mask, plain)
    same = (got == plain).float().mean().item()
    print(f"{name}: max|diff| {diff.max().item():.3e}, max|plain| "
          f"{plain.float().abs().max().item():.3e}, bitwise equal {100 * same:.2f} %, "
          f"max diff/bound {(diff / bound).max().item():.3f}")
    assert torch.isfinite(got.float()).all()
    assert (diff <= bound).all(), (diff - bound).max().item()


@pytest.mark.gpu
def test_off_the_kernel_inputs_take_the_plain_composition_on_the_card(cuda):
    q, k, v, scale, bias, mask = CASES["hab_256x256_shift_mask"](cuda)
    before = window_attention.launches
    # f32: the parity class
    args32 = (q.float(), k.float(), v.float(), scale, bias.float(), mask)
    with torch.inference_mode():
        assert torch.equal(window_attention(*args32), window_attention_plain(*args32))
    # a gradient needed: training through autograd
    qg = q.detach().clone().requires_grad_()
    got = window_attention(qg, k, v, scale, bias, mask)
    assert torch.equal(got, window_attention_plain(qg, k, v, scale, bias, mask))
    got.float().sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad.float()).all()
    assert window_attention.launches == before


@pytest.mark.gpu
def test_kernel_refuses_shapes_outside_its_range(cuda):
    g = np.random.default_rng(0)
    before = window_attention.launches
    for n, m, d in ((MAX_QUERIES + 1, 64, D), (64, MAX_KEYS[32] + 1, D),
                    (256, MAX_KEYS[128] + 1, 122), (64, 64, MAX_HEAD + 2)):
        q, k, v = (_bf16(g, (2, 2, r, d)).to(cuda) for r in (n, m, m))
        with torch.inference_mode(), pytest.raises(ValueError, match="window_attention kernel"):
            window_attention(q, k, v, 0.2)
    assert window_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [30, 46, 77, 122])
def test_kernel_takes_every_split_the_wrapper_makes(cuda, d):
    # at each padded head, M at both ends of every chunk count up to
    # MAX_KEYS: the kernel launches each split `plan` makes (it refuses a
    # split it has no instance for) and stays within the bound
    dk = padded_head(d)
    for chunks in range(1, MAX_KEYS[dk] // 64 + 1):
        for m in (64 * chunks - 63, 64 * chunks):
            q, k, v, scale, bias, _ = _free_case(64, m, 2, seed=m, device=cuda, d=d)
            with torch.inference_mode():
                got = window_attention(q, k, v, scale, bias)
                plain = window_attention_plain(q, k, v, scale, bias, None)
            diff = (got.float() - plain.float()).abs()
            assert torch.isfinite(got.float()).all(), m
            assert (diff <= _bound(q, k, v, scale, bias, None, plain)).all(), (m, plan(q, k, v))


@pytest.mark.gpu
def test_kernel_is_warpgroup_mma(cuda):
    # both products on wgmma (HGMMA) in each of the fourteen instances (d
    # padded to 32 with 1-3 chunks a warpgroup, to 64 with 1-2, to 128 with
    # 1-2; with and without a mask); no mma.sync (HMMA)
    counts = sass_counts("window_attention", ("HGMMA", "HMMA"))
    print(counts)
    kernels = {fn: c for fn, c in counts.items() if "window_attention_sm90_kernel" in fn}
    assert len(kernels) == 14
    assert all(c["HGMMA"] > 0 for c in kernels.values()), kernels
    assert sum(c["HMMA"] for c in counts.values()) == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("run,launches", [("swinir_sr", 36), ("hat_sr", 42),
                                          ("drct_sr_fsdp", 30)])
def test_one_bf16_forward_launches_the_kernel_once_per_attention(cuda, run, launches):
    # SwinIR: 6 x 6 Swin blocks; HAT: 6 x 6 HABs and 6 OCABs; DRCT: 6 groups
    # of 5 dense blocks (head sizes 30, 53, 122, 46, 77), at the run configs'
    # widths, one 416^2 image
    from pathlib import Path

    from xmm_superres_denoise_torch.config.schema import load_run_config
    from xmm_superres_denoise_torch.models.registry import build_model

    path = Path(__file__).resolve().parents[1] / "res/configs/runs" / f"{run}.toml"
    ds, mc = load_run_config(path)
    model = build_model(mc, (ds.lr.res,) * 2, (ds.hr.res,) * 2)
    model.reset_parameters(torch.Generator().manual_seed(5))
    model = model.to(cuda, torch.bfloat16).eval()
    x = torch.rand((1, ds.lr.res, ds.lr.res, 1), generator=torch.Generator().manual_seed(6))
    before = window_attention.launches
    with torch.inference_mode():
        y = model(x.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert window_attention.launches - before == launches
    assert torch.isfinite(y.float()).all()


def _serving_case(c: int, nh: int, masked: bool, device, seed=0):
    """One DRCT block's attention operands at the cell's serving batch: 4
    images of 416^2 tokens in 16 x 16 windows (2,704 windows), q, k, v the
    strided views of one qkv drawn on the card, the bias gathered from a
    bf16 table, the shift mask of the 416^2 image's windows when masked."""
    from xmm_superres_denoise_torch.models.swin_common import shift_mask

    g = torch.Generator(device=device).manual_seed(seed)
    ws, n, side = 16, 256, 416
    windows = 4 * (side // ws) ** 2
    qkv = torch.randn((windows, n, 3 * c), generator=g, device=device).bfloat16()
    q, k, v = qkv.reshape(windows, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    table = torch.randn(((2 * ws - 1) ** 2, nh), generator=g, device=device).bfloat16()
    idx = index_buffer(relative_position_index(ws, ws)).to(device)
    bias = table[idx.view(-1)].view(n, n, nh).permute(2, 0, 1)
    mask = shift_mask(side, side, ws, ws // 2, device) if masked else None
    return q, k, v, (c // nh) ** -0.5, bias, mask


@pytest.mark.gpu
@pytest.mark.parametrize("c,nh,masked", [(180, 6, False), (212, 4, True), (244, 2, False),
                                         (276, 6, True), (308, 4, False)])
def test_kernel_at_drct_window16_shapes_at_the_serving_batch(cuda, c, nh, masked):
    # each of a DRCT group's five blocks at window 16 (d 30, 53 masked, 122,
    # 46 masked, 77; N = M = 256) over batch 4's windows, within the bound
    q, k, v, scale, bias, mask = _serving_case(c, nh, masked, cuda)
    before = window_attention.launches
    with torch.inference_mode():
        got = window_attention(q, k, v, scale, bias, mask)
        plain = window_attention_plain(q, k, v, scale, bias, mask)
        diff = (got.float() - plain.float()).abs()
        over = (diff / _bound(q, k, v, scale, bias, mask, plain)).max().item()
    assert window_attention.launches == before + 1
    print(f"d {c // nh}{' masked' if masked else ''}: max|diff| {diff.max().item():.3e}, "
          f"max diff/bound {over:.3f}")
    assert torch.isfinite(got.float()).all()
    assert over <= 1.0


@pytest.mark.gpu
def test_one_bf16_drct_forward_at_window_16_launches_the_kernel_30_times(cuda):
    # the benchmark's DRCT configuration (patch 16: window 16, blocks 2 and 4
    # of each group shifted), one 416^2 image
    from benchmark import harness
    from benchmark.programs import drct as program
    from xmm_superres_denoise_torch.models.registry import build_model

    cfg = harness.load_cell("drct_sr_bf16_bulk")["cfg"]
    model = build_model(program.model_config(cfg), (cfg["lr_res"],) * 2, (cfg["hr_res"],) * 2)
    assert {(b.ws, b.shift) for b in model.modules() if hasattr(b, "shift")} == {(16, 0), (16, 8)}
    model.reset_parameters(torch.Generator().manual_seed(5))
    model = model.to(cuda, torch.bfloat16).eval()
    x = torch.rand((1, 416, 416, 1), generator=torch.Generator().manual_seed(6))
    before = window_attention.launches
    with torch.inference_mode():
        y = model(x.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert window_attention.launches - before == 30
    assert torch.isfinite(y.float()).all()
