"""The Gram side of Restormer's MDTA (`ops/mdta_gram.py`): the wrapper's
routing and launch plan on the CPU, the plain version and MDTA's forward
against the ops they replaced, the kernels' arithmetic emulated on the CPU,
and the hand-written kernels of `csrc/mdta_gram.cu` on the card.

This file imports no JAX. The tests marked `gpu` skip without a CUDA card;
whether a card is present is decided inside the `cuda` fixture:

    python -m pytest --noconftest tests/test_torch_mdta_gram.py

Tolerance, per output element, against an f64 evaluation of the same
function from the same bf16 q and k (`_f64`): at most the plain bf16
composition's error there plus one bf16 ulp of the output. The kernels make
two roundings fewer than the plain version (q_hat and k_hat are never
rounded to bf16) and one rounding at the end, as it does; what else differs
is the order of their f32 sums (the Gram over the pixels split into chunks,
the sums of squares, the softmax's), whose error on a logit (a cosine times
the temperature) is under 1e-5, so far below half an ulp of the output
that the last rounding may land one ulp from the plain version's, and no
further.
"""

import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_sass import sass_counts
from xmm_superres_denoise_torch.models import restormer as trest
from xmm_superres_denoise_torch.ops.mdta_gram import (
    heads_first,
    mdta_attention_plain,
    mdta_gram,
    plan,
    route,
    route_for,
)

SMS = 132  # an H100's SMs
CELL_HW = 416


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _qkv(b, hw, c, seed=0, dtype=torch.bfloat16, device="cpu"):
    """(b, h, w, 3c) with a per-channel offset and scale, as a depthwise
    convolution leaves it: the Gram's cosines spread over (-1, 1)."""
    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, 3 * c, generator=g) * (0.2 + torch.rand(3 * c, generator=g))
    return (x + 0.5 * torch.randn(3 * c, generator=g)).to(device, dtype)


def _temperature(heads, seed=1, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (0.5 + 1.5 * torch.rand(heads, 1, 1, generator=g)).to(device, dtype)


def _f64(qkv, heads, temperature):
    """The function in f64 from qkv's values: the norms on the Gram, the
    temperature rounded to qkv's dtype."""
    q, k, _ = qkv.double().chunk(3, dim=-1)
    q, k = heads_first(q, heads), heads_first(k, heads)
    gram = q @ k.transpose(-2, -1)
    qn = q.norm(dim=-1).clamp(min=1e-12)
    kn = k.norm(dim=-1).clamp(min=1e-12)
    logits = gram / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.to(qkv.dtype).double()
    return torch.softmax(logits, dim=-1)


def _ulp(ref):
    """One bf16 ulp at each value of ref (positive, normal)."""
    return torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)


def _assert_within_bound(got, plain, ref, what):
    got, plain = got.double(), plain.double()
    err, plain_err, ulp = (got - ref).abs(), (plain - ref).abs(), _ulp(ref)
    print(f"{what}: max|got - f64| {err.max().item():.3e} ({(err / ulp).max().item():.3f} ulp), "
          f"max|plain - f64| {plain_err.max().item():.3e} "
          f"({(plain_err / ulp).max().item():.3f} ulp), "
          f"rows sum to 1 within {(got.sum(-1) - 1).abs().max().item():.2e}")
    assert torch.isfinite(got).all()
    assert (err <= plain_err + ulp).all(), (err - plain_err - ulp).max().item()


# --------------------------------------------------------------------------
# CPU: the routing decision
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device_type,dtype,needs_grad,d,want", [
    ("cuda", torch.bfloat16, False, 24, "kernel"),   # the run config's dim 24
    ("cuda", torch.bfloat16, False, 48, "kernel"),   # the cell's levels 1-3 and latent
    ("cuda", torch.bfloat16, False, 96, "kernel"),   # the cell's decoder level 1, refinement
    ("cuda", torch.bfloat16, False, 128, "kernel"),  # the widest the kernel takes
    ("cuda", torch.bfloat16, False, 136, "plain"),
    ("cuda", torch.bfloat16, False, 20, "plain"),    # not a multiple of 8
    ("cuda", torch.bfloat16, True, 48, "plain"),     # training through autograd
    ("cuda", torch.float32, False, 48, "plain"),     # the parity class, f32 evaluation
    ("cuda", torch.float16, False, 48, "plain"),
    ("cpu", torch.bfloat16, False, 48, "plain"),
    ("cpu", torch.float32, False, 24, "plain"),
])
def test_route_for(device_type, dtype, needs_grad, d, want):
    assert route_for(device_type, dtype, needs_grad, d) == want


def test_route_reads_the_device_grad_mode_and_d():
    qkv = _qkv(1, 8, 48)
    temp = torch.nn.Parameter(_temperature(2))
    assert route(qkv, 2, temp) == "plain"  # a CPU tensor
    from xmm_superres_denoise_torch.ops.dense_block import grad_needed

    assert grad_needed(qkv, temp)  # a parameter that requires grad, in grad mode
    with torch.inference_mode():
        assert not grad_needed(qkv, temp)


# --------------------------------------------------------------------------
# CPU: the launch plan
# --------------------------------------------------------------------------


def _levels(dim):
    """(hw, c, heads) of each Restormer level at a 416^2 input: levels 1-3,
    the latent, and level 1 of the decoder and refinement at 2 dim."""
    return [(416, dim, 1), (208, 2 * dim, 2), (104, 4 * dim, 4), (52, 8 * dim, 8),
            (416, 2 * dim, 1)]


@pytest.mark.parametrize("dim", [48, 24])
@pytest.mark.parametrize("level", range(5))
@pytest.mark.parametrize("batch", [1, 4])
def test_plan_at_the_level_shapes(dim, level, batch):
    hw, c, heads = _levels(dim)[level]
    qkv = torch.empty((batch, hw, hw, 3 * c), dtype=torch.bfloat16)
    pl = plan(qkv, heads, SMS)
    d, px = c // heads, hw * hw
    assert (pl.batch, pl.pixels, pl.channels, pl.heads) == (batch, px, c, heads)
    assert (pl.pixel_stride, pl.batch_stride) == (3 * c, px * 3 * c)
    assert d % pl.width == 0 and pl.width == next(w for w in (64, 32, 16, 8) if d % w == 0)
    assert pl.rows % 16 == 0 and 16 <= pl.rows <= 256
    assert pl.chunk_px % pl.rows == 0
    assert (pl.chunks - 1) * pl.chunk_px < px <= pl.chunks * pl.chunk_px  # no empty chunk
    ctas = batch * heads * pl.chunks
    partials = ctas * (d * d + 2 * d) * 4
    read = batch * px * 2 * c * 2
    assert partials <= 0.105 * read, partials / read  # about a tenth of the bytes read at most
    if (batch, hw) == (4, CELL_HW):  # the largest calls: two CTAs on every SM at least
        assert ctas >= 2 * SMS, ctas


def test_plan_at_the_cells_level_1():
    # 18 KB a stage (96 pixels of 48 channels of q and k), 27 stages a
    # chunk, 67 chunks: 268 CTAs for 132 SMs, the last chunk short
    pl = plan(torch.empty((4, 416, 416, 144), dtype=torch.bfloat16), 1, SMS)
    assert tuple(pl) == (4, 173056, 48, 1, 96, 16, 2592, 67, 144, 173056 * 144)


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_plan_boxes_tile_both_operands_at_every_head_width(d):
    # B is N = d rounded up to 48, 64, 96 or 128 columns wide; its boxes are
    # whole (at d 32 N is 48: boxes of 16 channels, not 32), and A's 64 rows
    # a half are whole boxes too
    pl = plan(torch.empty((2, 61, 67, 6 * d), dtype=torch.bfloat16), 2, SMS)
    n = next(nn for nn in (48, 64, 96, 128) if d <= nn)
    assert d % pl.width == 0 and n % pl.width == 0 and 64 % pl.width == 0
    assert pl.width == max(w for w in (8, 16, 32, 64) if d % w == 0 and n % w == 0)
    if d == 32:
        assert pl.width == 16


@pytest.mark.parametrize("case,what", [
    ("f32", "bf16 qkv"),
    ("d20", "multiple of 8"),
    ("d136", "multiple of 8 up to 128"),
    ("heads", "do not split"),
    ("channels_strided", "contiguous channels"),
    ("pixels_cropped", "one stride"),
    ("pixel_stride_odd", "16-byte multiples"),
    ("misaligned", "16-byte aligned"),
    ("three_dims", r"\(b, h, w, 3c\)"),
    ("empty", "at least one image"),
])
def test_plan_refuses_inputs_outside_the_range(case, what):
    c, heads = {"d20": (40, 2), "d136": (136, 1), "heads": (48, 5)}.get(case, (48, 1))
    qkv = torch.zeros((2, 8, 8, 3 * c), dtype=torch.bfloat16)
    if case == "f32":
        qkv = qkv.float()
    elif case == "channels_strided":
        qkv = torch.zeros((2, 8, 8, 6 * c), dtype=torch.bfloat16)[..., ::2]
    elif case == "pixels_cropped":
        qkv = torch.zeros((2, 8, 10, 3 * c), dtype=torch.bfloat16)[:, :, :8]
    elif case == "pixel_stride_odd":
        qkv = torch.zeros((2, 8, 8, 3 * c + 4), dtype=torch.bfloat16)[..., :3 * c]
    elif case == "misaligned":
        flat = torch.zeros(2 * 64 * 3 * c + 8, dtype=torch.bfloat16)
        start = next(i for i in range(1, 8) if (flat.data_ptr() + 2 * i) % 16)
        qkv = flat[start:start + 2 * 64 * 3 * c].view(2, 8, 8, 3 * c)
    elif case == "three_dims":
        qkv = qkv[0]
    elif case == "empty":
        qkv = qkv[:0]
    with pytest.raises(ValueError, match=what):
        plan(qkv, heads, SMS)


# --------------------------------------------------------------------------
# CPU: the plain version and MDTA's forward are the ops they replaced
# --------------------------------------------------------------------------


def _replaced_lines(x, qkv, nh, temperature):
    """MDTA's Gram side as `models/restormer.py` wrote it before the kernels:
    q, k and v from qkv, the L2 norms, the f32 product, the temperature,
    the softmax; and v as the product took it."""
    b, h, w, c = x.shape
    d = c // nh
    q, k, v = qkv.chunk(3, dim=-1)

    def heads_first_(t):
        return t.reshape(b, h * w, nh, d).permute(0, 2, 3, 1)

    def l2_normalize(t):
        norm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
        return t / torch.clamp(norm, min=1e-12)

    q, k, v = l2_normalize(heads_first_(q)), l2_normalize(heads_first_(k)), heads_first_(v)
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    attn = attn * temperature.to(x.dtype)
    return torch.softmax(attn, dim=-1).to(x.dtype), v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads", [(16, 4), (48, 1), (24, 2)])
def test_mdta_attention_plain_is_the_lines_it_replaced(dtype, c, heads):
    qkv = _qkv(2, (9, 7), c, dtype=dtype)
    temp = _temperature(heads)
    want, v = _replaced_lines(qkv[..., :c], qkv, heads, temp)
    got = mdta_attention_plain(qkv, heads, temp)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(heads_first(qkv[..., 2 * c:], heads), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mdta_forward_on_the_cpu_is_the_replaced_forward_and_launches_nothing(dtype):
    torch.manual_seed(3)
    m = trest.MDTA(16, 4).to(dtype)
    with torch.no_grad():
        m.temperature.copy_(_temperature(4))
    x = _qkv(2, (8, 6), 16, seed=4, dtype=dtype)[..., :16].contiguous()
    before = mdta_gram.launches
    with torch.inference_mode():
        got = m(x)
        b, h, w, c = x.shape
        qkv = trest.conv(m.qkv_dwconv, trest.conv(m.qkv, x))
        attn, v = _replaced_lines(x, qkv, 4, m.temperature)
        out = torch.matmul(attn, v).permute(0, 3, 1, 2).reshape(b, h, w, c)
        want = trest.conv(m.project_out, out)
    assert torch.equal(got, want)
    assert mdta_gram.launches == before  # the CPU never launches


def test_restormer_training_step_on_the_cpu_takes_the_plain_version():
    torch.manual_seed(5)
    m = trest.MDTA(16, 2)
    x = torch.randn(1, 6, 6, 16)
    before = mdta_gram.launches
    m(x).square().mean().backward()
    assert m.temperature.grad is not None and torch.isfinite(m.temperature.grad).all()
    assert mdta_gram.launches == before


# --------------------------------------------------------------------------
# CPU: the kernels' arithmetic, emulated
# --------------------------------------------------------------------------


def _emulate(qkv, heads, temperature, pl):
    """What the kernels compute, in f32 PyTorch ops from qkv's bf16 values:
    per chunk of `pl.chunk_px` pixels the f32 Gram and sums of squares (exact
    products of bf16 values, f32 sums), the partials summed in chunk order,
    then the norms clamped at 1e-12, the temperature rounded to bf16, the
    softmax in f32 and one rounding to bf16."""
    q, k, _ = qkv.float().chunk(3, dim=-1)
    q, k = heads_first(q, heads), heads_first(k, heads)
    gram = qq = kk = 0.0
    for i in range(pl.chunks):
        qc = q[..., i * pl.chunk_px:(i + 1) * pl.chunk_px]
        kc = k[..., i * pl.chunk_px:(i + 1) * pl.chunk_px]
        gram = gram + qc @ kc.transpose(-2, -1)
        qq = qq + (qc * qc).sum(-1)
        kk = kk + (kc * kc).sum(-1)
    qn = torch.sqrt(qq).clamp(min=1e-12)
    kn = torch.sqrt(kk).clamp(min=1e-12)
    logits = gram / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.to(torch.bfloat16).float()
    return torch.softmax(logits, dim=-1).to(torch.bfloat16)


@pytest.mark.parametrize("b,hw,c,heads", [
    (2, (64, 64), 48, 1),  # 8 chunks, the last one short
    (1, (52, 52), 96, 2),  # d 48 over 2 heads, one chunk
    (2, (40, 37), 24, 1),  # d 24: boxes of 8 channels, no swizzle
    (1, (33, 35), 192, 2),  # d 96: two 64-row halves of A
])
def test_the_kernels_arithmetic_is_the_function_within_the_bound(b, hw, c, heads):
    qkv = _qkv(b, hw, c, seed=c + heads)
    temp = _temperature(heads, seed=heads)
    pl = plan(qkv, heads, SMS)
    got = _emulate(qkv, heads, temp, pl)
    plain = mdta_attention_plain(qkv, heads, temp)
    ref = _f64(qkv, heads, temp)
    assert got.shape == ref.shape == (b, heads, c // heads, c // heads)
    _assert_within_bound(got, plain, ref, f"emulated {b}x{hw}x{c}/{heads}")


# --------------------------------------------------------------------------
# The card: the kernels against an f64 evaluation
# --------------------------------------------------------------------------


# (batch, (h, w), c, heads): every level of the cell's dim 48 and the run
# config's dim 24 at a 416^2 input, at batch 4 and (level 1) batch 1, a
# pixel count that is no multiple of the stage or the chunk, and every head
# width d the route sends to the kernels (multiples of 8 up to 128: each
# instance N 48 / 64 / 96 / 128 with one or two halves of A, over boxes of
# 8 channels unswizzled and of 16 / 32 / 64 in the 32 / 64 / 128-byte
# swizzle), at two heads over a ragged pixel count, and the 128-byte
# swizzle at a 416^2 image
CARD_CASES = {
    **{f"dim48_level{i}_b4": (4, (hw, hw), c, nh) for i, (hw, c, nh) in enumerate(_levels(48))},
    **{f"dim24_level{i}_b4": (4, (hw, hw), c, nh) for i, (hw, c, nh) in enumerate(_levels(24))},
    "dim48_level1_b1": (1, (416, 416), 48, 1),
    "dim48_decoder1_b1": (1, (416, 416), 96, 1),
    "dim24_level1_b1": (1, (416, 416), 24, 1),
    "ragged_pixels": (3, (413, 411), 48, 1),
    **{f"d{d}_heads2_ragged": (2, (61, 67), 2 * d, 2) for d in range(8, 129, 8)},
    "d64_b1": (1, (416, 416), 64, 1),
    "d128_b1": (1, (416, 416), 128, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernels_match_f64_within_the_plain_versions_error_and_an_ulp(cuda, name):
    b, hw, c, heads = CARD_CASES[name]
    qkv = _qkv(b, hw, c, seed=len(name), device=cuda)
    temp = _temperature(heads, seed=len(name), dtype=torch.bfloat16, device=cuda)
    before = mdta_gram.launches
    with torch.inference_mode():
        got = mdta_gram(qkv, heads, temp)
        plain = mdta_attention_plain(qkv, heads, temp)
        ref = _f64(qkv, heads, temp)
    torch.cuda.synchronize()
    assert mdta_gram.launches == before + 1
    assert got.shape == (b, heads, c // heads, c // heads) and got.dtype == torch.bfloat16
    _assert_within_bound(got, plain, ref, name)


@pytest.mark.gpu
def test_repeated_calls_are_bitwise_equal(cuda):
    qkv = _qkv(4, (416, 416), 96, seed=9, device=cuda)
    temp = _temperature(1, dtype=torch.bfloat16, device=cuda)
    with torch.inference_mode():
        first = mdta_gram(qkv, 1, temp)
        again = [mdta_gram(qkv, 1, temp) for _ in range(3)]
    assert all(torch.equal(first, a) for a in again)


@pytest.mark.gpu
def test_off_the_kernel_inputs_take_the_plain_version_on_the_card(cuda):
    qkv = _qkv(1, (32, 32), 40, device=cuda)
    temp = _temperature(2, dtype=torch.bfloat16, device=cuda)
    before = mdta_gram.launches
    with torch.inference_mode():
        assert torch.equal(mdta_gram(qkv.float(), 2, temp.float()),
                           mdta_attention_plain(qkv.float(), 2, temp.float()))
        assert torch.equal(mdta_gram(qkv, 4, temp.repeat(2, 1, 1)),  # d 10
                           mdta_attention_plain(qkv, 4, temp.repeat(2, 1, 1)))
    leaf = torch.nn.Parameter(temp.float())
    got = mdta_gram(qkv, 2, leaf)  # a temperature that requires grad: autograd
    assert got.grad_fn is not None
    got.float().sum().backward()
    assert leaf.grad is not None
    assert mdta_gram.launches == before


@pytest.mark.gpu
def test_kernel_refuses_a_strided_qkv(cuda):
    qkv = _qkv(1, (16, 20), 48, device=cuda)[:, :, :16]
    temp = _temperature(1, dtype=torch.bfloat16, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="mdta_gram kernel"):
        mdta_gram(qkv, 1, temp)


@pytest.mark.gpu
def test_gram_kernel_is_warpgroup_mma(cuda):
    # the Gram on wgmma (HGMMA) in each of its four widths; no mma.sync (HMMA)
    counts = sass_counts("mdta_gram", ("HGMMA", "HMMA"))
    print(counts)
    grams = {fn: c for fn, c in counts.items() if "mdta_gram_sm90_kernel" in fn}
    assert len(grams) == 4
    assert all(c["HGMMA"] > 0 for c in grams.values()), grams
    assert any("mdta_softmax_sm90_kernel" in fn for fn in counts)
    assert sum(c["HMMA"] for c in counts.values()) == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [24, 48])
def test_one_bf16_restormer_forward_launches_the_kernels_once_per_mdta(cuda, dim):
    # 44 MDTA calls a forward (4 + 6 + 6 + 8 blocks down, 6 + 6 + 4 up, 4
    # refinement): all on the kernels in bf16, none in f32; the run config's
    # dim 24 and the cell's 48, one 416^2 single-channel image
    model = trest.Restormer(1, 1, dim=dim)
    model.reset_parameters(torch.Generator().manual_seed(5))
    x = torch.rand((1, CELL_HW, CELL_HW, 1), generator=torch.Generator().manual_seed(6))
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = model.to(cuda, dtype).eval()
        before, calls = mdta_gram.launches, trest.MDTA.calls
        with torch.inference_mode():
            y = m(x.to(cuda, dtype))
        torch.cuda.synchronize()
        assert torch.isfinite(y.float()).all()
        counts[dtype] = (mdta_gram.launches - before, trest.MDTA.calls - calls)
    assert counts == {torch.float32: (0, 44), torch.bfloat16: (44, 44)}, counts
