"""The Swin blocks' qkv side (`ops/window_qkv.py`): the wrapper's routing,
launch plan and weight layout on the CPU, the blocks' call sites
(`models/swin_common.py: SwinTransformerBlock`, `models/hat.py: HAB`)
against the ops they replaced, and the hand-written kernel of
`csrc/window_qkv.cu` against its plain composition on the card.

This file imports no JAX. The tests marked `gpu` skip without a CUDA card;
whether a card is present is decided inside the `cuda` fixture:

    python -m pytest --noconftest tests/test_torch_window_qkv.py

Tolerance of the kernel against `window_qkv_plain` on the card, per output
element: the two make the same bf16 roundings, and differ in the order of
their f32 sums (LayerNorm's statistics and the product's). A sum near a
bf16 rounding boundary may round one ulp (at most 2^-7 of the value) the
other way: the output's last rounding (2^-7 |out|) and the product's (2^-7
|y|, y = out - bias); LayerNorm's, one ulp of a few normalised channels,
reaches the output through the product's sum of C far below an ulp of y.
So |kernel - plain| <= 2^-7 (|plain| + |y|) + 2^-10 max|y|, the last term
for the propagated sums; the share of elements that differ at all is held
under 0.1 % (`MAX_UNEQUAL`), and as a whole max|kernel - plain| <= 2 bf16
ulps x max|plain| (2^-6 max|plain|). On an H100 the largest share over the
card cases was 0.016 % (the ragged tile; 0.009-0.014 % at the cells'
shapes with the norm, 0.001 % without it), and the CPU emulation's 0.027 %.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_sass import sass_counts
from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import swin_common as tsc
from xmm_superres_denoise_torch.ops.window_qkv import (
    CHUNK,
    K_STEPS,
    k_steps,
    plan,
    route,
    route_for,
    weights_of,
    window_qkv,
    window_qkv_plain,
)

CELL = 416  # the cells' input side: 416^2 tokens an image
MAX_UNEQUAL = 0.001  # share of output elements that may differ from the plain composition


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _layers(c, seed=0, dtype=torch.float32, device="cpu", bias=True):
    """A `LayerNorm(c)` and the qkv `Linear(c, 3c)` with parameters of
    realistic size that exercise every term: LayerNorm's scale around 1 and
    a bias, weights N(0, 1 / fan_in), a nonzero bias."""
    g = torch.Generator().manual_seed(seed)
    norm, qkv = tsc.LayerNorm(c), tsc.dense_torch_init(c, 3 * c, bias)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
        norm.bias.copy_(0.2 * torch.randn(c, generator=g))
        qkv.weight.copy_(torch.randn(3 * c, c, generator=g) / c ** 0.5)
        if bias:
            qkv.bias.copy_(0.5 * torch.randn(3 * c, generator=g))
    return norm.to(device, dtype).eval(), qkv.to(device, dtype).eval()


def _tokens(batch, hw, c, seed=1, dtype=torch.bfloat16, device="cpu"):
    """(batch, hw * hw, c) with a per-channel offset and scale, so that
    LayerNorm's mean and variance matter."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, hw * hw, c, generator=g) * (0.5 + torch.rand(c, generator=g))
    return (x + torch.randn(c, generator=g)).to(device, dtype)


def _replaced_ops(x, x_size, ws, shift, norm, qkv):
    """What the Swin block and HAB ran before the op: the norm, the roll,
    `window_partition` and `linear`."""
    h, w = x_size
    b, _, c = x.shape
    img = (x if norm is None else norm(x)).reshape(b, h, w, c)
    if shift > 0:
        img = torch.roll(img, (-shift, -shift), dims=(1, 2))
    return tsc.linear(qkv, tsc.window_partition(img, ws).reshape(-1, ws * ws, c))


# --------------------------------------------------------------------------
# CPU: the routing decision
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device_type,dtype,grad,c,hw,ws,shift,want", [
    ("cuda", torch.bfloat16, False, 180, 416, 13, 0, "kernel"),  # SwinIR, SwinFIR
    ("cuda", torch.bfloat16, False, 180, 416, 16, 8, "kernel"),  # HAB, DRCT's first block
    ("cuda", torch.bfloat16, False, 212, 416, 16, 8, "kernel"),  # DRCT's dense blocks
    ("cuda", torch.bfloat16, False, 244, 416, 16, 0, "kernel"),
    ("cuda", torch.bfloat16, False, 276, 416, 16, 8, "kernel"),
    ("cuda", torch.bfloat16, False, 308, 416, 16, 0, "kernel"),
    ("cuda", torch.bfloat16, False, 320, 64, 8, 4, "kernel"),    # the widest the kernel takes
    ("cuda", torch.bfloat16, False, 182, 416, 13, 6, "kernel"),  # C = 2 mod 4
    ("cuda", torch.bfloat16, True, 180, 416, 13, 0, "plain"),    # training through autograd
    ("cuda", torch.float32, False, 180, 416, 13, 0, "plain"),    # the parity class
    ("cuda", torch.float16, False, 180, 416, 13, 0, "plain"),
    ("cpu", torch.bfloat16, False, 180, 416, 13, 0, "plain"),
    ("cpu", torch.float32, False, 180, 416, 16, 8, "plain"),
    ("cuda", torch.bfloat16, False, 181, 416, 13, 0, "plain"),   # an odd C
    ("cuda", torch.bfloat16, False, 322, 416, 13, 0, "plain"),   # C > 320
    ("cuda", torch.bfloat16, False, 180, 408, 17, 0, "plain"),   # N = 289 > 256
    ("cuda", torch.bfloat16, False, 180, 416, 15, 0, "plain"),   # 416 % 15
    ("cuda", torch.bfloat16, False, 180, 416, 16, 16, "plain"),  # shift >= window
])
def test_route_for(device_type, dtype, grad, c, hw, ws, shift, want):
    assert route_for(device_type, dtype, grad, c, (hw, hw), ws, shift) == want


def test_route_reads_grad_mode_requires_grad_and_the_geometry():
    norm, qkv = _layers(12)
    x = _tokens(1, 8, 12, dtype=torch.float32)
    assert route(x, (8, 8), 4, 2, norm, qkv) == "plain"  # a CPU tensor
    from xmm_superres_denoise_torch.ops.dense_block import grad_needed

    assert grad_needed(x, qkv.weight)  # parameters require grad in grad mode
    with torch.no_grad():
        assert not grad_needed(x, qkv.weight, norm.scale)


# --------------------------------------------------------------------------
# CPU: the launch plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,hw,c,ws,shift,want", [
    (4, CELL, 180, 13, 0, (4 * CELL * CELL, 180, 12, 9, 4 * 32 * 32)),  # SwinIR: 540 = 8.4 chunks
    (4, CELL, 308, 16, 8, (4 * CELL * CELL, 308, 20, 15, 4 * 26 * 26)),  # DRCT's widest
    (1, CELL, 212, 16, 0, (CELL * CELL, 212, 14, 10, 26 * 26)),
    (2, 24, 60, 8, 4, (2 * 24 * 24, 60, 12, 3, 2 * 9)),  # narrow: the least instance
])
def test_plan(batch, hw, c, ws, shift, want):
    norm, qkv = _layers(c, dtype=torch.bfloat16)
    x = torch.empty((batch, hw * hw, c), dtype=torch.bfloat16)
    assert tuple(plan(x, (hw, hw), ws, shift, norm, qkv)) == want


@pytest.mark.parametrize("case,what", [
    ("odd_channels", "even number of channels"),
    ("too_wide", "even number of channels"),
    ("too_many_tokens", "windows of N <= 256"),
    ("indivisible", "divides by the window"),
    ("shift_past_window", "shift 0 <= shift < window"),
    ("f32", "bf16 tokens"),
    ("strided", "contiguous rows"),
    ("misaligned", "8-byte"),
    ("layers", "layers must be"),
    ("tokens", r"\(B, H \* W, C\)"),
])
def test_plan_refuses_inputs_outside_the_range(case, what):
    c = {"odd_channels": 181, "too_wide": 322}.get(case, 180)
    hw, ws, shift = {"too_many_tokens": (34, 17, 0), "indivisible": (32, 10, 0),
                     "shift_past_window": (32, 8, 8)}.get(case, (32, 8, 4))
    norm, qkv = _layers(c, dtype=torch.bfloat16)
    x = torch.zeros((2, hw * hw, c), dtype=torch.bfloat16)
    if case == "f32":
        x = x.float()
    elif case == "strided":
        x = torch.zeros((2, hw * hw, 2 * c), dtype=torch.bfloat16)[..., :c]
    elif case == "misaligned":
        flat = torch.zeros(2 * hw * hw * c + 8, dtype=torch.bfloat16)
        start = next(i for i in range(1, 8) if (flat.data_ptr() + 2 * i) % 8)
        x = flat[start:start + 2 * hw * hw * c].view(2, hw * hw, c)
    elif case == "layers":
        _, qkv = _layers(c + 2, dtype=torch.bfloat16)
    elif case == "tokens":
        x = x[:, :-1]
    with pytest.raises(ValueError, match=what):
        plan(x, (hw, hw), ws, shift, norm, qkv)


# --------------------------------------------------------------------------
# CPU: the plain composition and the call sites are the ops they replaced
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("with_norm", [True, False])
def test_plain_composition_is_the_ops_it_replaces(dtype, shift, with_norm):
    norm, qkv = _layers(12, dtype=dtype)
    norm = norm if with_norm else None
    x = _tokens(2, 8, 12, dtype=dtype)
    before = window_qkv.launches
    with torch.no_grad():
        want = _replaced_ops(x, (8, 8), 4, shift, norm, qkv)
        plain = window_qkv_plain(x, (8, 8), 4, shift, norm, qkv)
        got = window_qkv(x, (8, 8), 4, shift, norm, qkv)
    assert plain.shape == (2 * 4, 16, 36) and plain.dtype == dtype
    assert torch.equal(plain, want) and torch.equal(got, want)
    assert window_qkv.launches == before  # the CPU never launches


def _block(kind):
    """A Swin block or a HAB at width 12 on 8 x 8 tokens, window 4, shift 2,
    its parameters drawn by the zoo's initializer, with nonzero biases and
    norm parameters."""
    if kind == "swin":
        blk = tsc.SwinTransformerBlock(12, (8, 8), 2, 4, 2)
    else:
        blk = thaat.HAB(12, (8, 8), 2, 4, 2, compress_ratio=3, squeeze_factor=3)
    tsc.reset_zoo_parameters(blk, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for prm in blk.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(4)))
    return blk.eval()


def _attention_half(blk, x, x_size):
    """The block's attention half as it ran before the op: the norm, the
    roll, the partition and `WindowAttention.forward` (qkv included)."""
    h, w = x_size
    b, _, c = x.shape
    img = blk.norm1(x).reshape(b, h, w, c)
    if blk.shift > 0:
        img = torch.roll(img, (-blk.shift, -blk.shift), dims=(1, 2))
    xw = tsc.window_partition(img, blk.ws).reshape(-1, blk.ws * blk.ws, c)
    return blk.attn(xw, tsc.shift_mask(h, w, blk.ws, blk.shift, x.device))


@pytest.mark.parametrize("kind", ["swin", "hab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_call_sites_hand_attend_the_rows_forward_made(kind, dtype):
    blk = _block(kind).to(dtype)
    x = _tokens(2, 8, 12, dtype=dtype)
    with torch.no_grad():
        norm, img = (blk.norm1, x) if kind == "swin" else (None, blk.norm1(x))
        qkv = window_qkv(img, (8, 8), blk.ws, blk.shift, norm, blk.attn.qkv)
        got = blk.attn.project(
            blk.attn.attend(qkv, tsc.shift_mask(8, 8, blk.ws, blk.shift, x.device)))
        want = _attention_half(blk, x, (8, 8))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["swin", "hab"])
def test_block_forwards_on_the_cpu_launch_nothing(kind):
    blk = _block(kind).to(torch.bfloat16)
    x = _tokens(1, 8, 12)
    before = window_qkv.launches
    with torch.inference_mode():
        y = blk(x, (8, 8))
    assert y.shape == x.shape and window_qkv.launches == before


# --------------------------------------------------------------------------
# CPU: the weights as the kernel reads them, and the kernel's arithmetic
# --------------------------------------------------------------------------


def _region(image_row: torch.Tensor, offset: int) -> torch.Tensor:
    """A (64, 16) bf16 region of one chunk's image at element `offset`, read
    as wgmma reads it through a 32-byte-swizzle descriptor: element e of row
    r at byte r * 32 + (((2e >> 4) ^ (r >> 2)) & 1) * 16 + (2e & 15)."""
    r, e = torch.arange(CHUNK)[:, None], torch.arange(16)[None, :]
    byte = r * 32 + ((((2 * e) >> 4) ^ (r >> 2)) & 1) * 16 + ((2 * e) & 15)
    return image_row[offset + byte // 2]


def _chunk(image: torch.Tensor, j: int, ks: int) -> torch.Tensor:
    """Chunk j's 64 weight rows (64, 16 ks) from its image."""
    return torch.cat([_region(image[j], kb * CHUNK * 16) for kb in range(ks)], dim=1)


@pytest.mark.parametrize("c,with_norm,bias", [(180, True, True), (60, True, False),
                                              (308, False, True), (14, True, True),
                                              (212, True, True), (276, True, True)])
def test_weight_image_holds_the_padded_weights_under_the_swizzle(c, with_norm, bias):
    norm, qkv = _layers(c, dtype=torch.bfloat16, bias=bias)
    norm = norm if with_norm else None
    image, vec = weights_of(norm, qkv, torch.device("cpu"))
    ks, n = k_steps(c), -(-3 * c // CHUNK)
    assert image.shape == (n, ks * CHUNK * 16) and image.dtype == torch.bfloat16
    wp = torch.zeros((n * CHUNK, 16 * ks), dtype=torch.bfloat16)
    wp[:3 * c, :c] = qkv.weight
    for j in range(n):
        assert torch.equal(_chunk(image, j, ks), wp[j * CHUNK:(j + 1) * CHUNK])
    pad = lambda v, k: torch.cat([v, torch.zeros(k - v.numel(), dtype=v.dtype)])  # noqa: E731
    zeros = torch.zeros(c, dtype=torch.bfloat16)
    gamma, beta = (norm.scale, norm.bias) if with_norm else (zeros, zeros)
    b = qkv.bias if bias else torch.zeros(3 * c, dtype=torch.bfloat16)
    assert torch.equal(vec, torch.cat([pad(gamma, 16 * ks), pad(beta, 16 * ks),
                                       pad(b, n * CHUNK)]))


def test_weight_image_is_made_once_per_parameter_version():
    norm, qkv = _layers(60, dtype=torch.bfloat16)
    a = weights_of(norm, qkv, torch.device("cpu"))
    assert all(u is v for u, v in zip(a, weights_of(norm, qkv, torch.device("cpu"))))
    with torch.no_grad():
        qkv.weight.mul_(2)  # an in-place update bumps the version
    b = weights_of(norm, qkv, torch.device("cpu"))
    assert not torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with torch.no_grad():
        norm.scale.add_(1)
    c = weights_of(norm, qkv, torch.device("cpu"))
    assert torch.equal(b[0], c[0]) and not torch.equal(b[1], c[1])


def _source_tokens(batch, hw, ws, shift):
    """The token of x that each output row reads, from the kernel's index
    arithmetic: row r % N of window r / N, the pixel moved by the shift."""
    r = np.arange(batch * hw * hw)
    n, nwx = ws * ws, hw // ws
    win, pos = r // n, r % n
    b, wl = win // (nwx * nwx), win % (nwx * nwx)
    y = ((wl // nwx) * ws + pos // ws + shift) % hw
    x = ((wl % nwx) * ws + pos % ws + shift) % hw
    return torch.from_numpy((b * hw + y) * hw + x)


def _emulate(x, hw, ws, shift, image, vec, c, eps, with_norm):
    """The kernel's arithmetic in PyTorch ops on the CPU, reading the
    weights from the image: the rows gathered by the index arithmetic,
    LayerNorm in f32 rounded once, per chunk the f32 sums rounded, + bias
    rounded."""
    bf = torch.bfloat16
    ks, n = image.shape[1] // (CHUNK * 16), image.shape[0]
    kp = 16 * ks
    rows = x.reshape(-1, c)[_source_tokens(x.shape[0], hw, ws, shift)].float()
    if with_norm:
        mean = rows.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((rows - mean) ** 2).mean(-1, keepdim=True) + eps)
        rows = (vec[:c].float() * (rstd * (rows - mean)) + vec[kp:kp + c].float()).to(bf)
    a = F.pad(rows.to(bf), (0, kp - c)).float()
    out = torch.cat([(a @ _chunk(image, j, ks).float().T).to(bf) for j in range(n)], dim=1)
    out = (out.float() + vec[2 * kp:2 * kp + n * CHUNK].float()).to(bf)
    return out[:, :3 * c].reshape(-1, ws * ws, 3 * c)


@pytest.mark.parametrize("c,hw,ws,shift,with_norm", [(60, 16, 8, 4, True), (180, 13, 13, 0, True),
                                                     (180, 16, 8, 4, False), (14, 12, 4, 2, True)])
def test_the_kernels_arithmetic_on_its_image_is_the_plain_composition(c, hw, ws, shift, with_norm):
    # the gather, the layout, the padding and the order of the roundings,
    # at the tolerance the card holds the kernel to (module docstring)
    norm, qkv = _layers(c, dtype=torch.bfloat16)
    norm = norm if with_norm else None
    x = _tokens(2, hw, c)
    image, vec = weights_of(norm, qkv, torch.device("cpu"))
    got = _emulate(x, hw, ws, shift, image, vec, c, 1e-5, with_norm)
    with torch.no_grad():
        plain = window_qkv_plain(x, (hw, hw), ws, shift, norm, qkv)
    _assert_within_bound(got, plain, qkv.bias)


def _assert_within_bound(got, plain, bias):
    p = plain.float()
    y = p - (0 if bias is None else bias.float())
    diff = (got.float() - p).abs()
    bound = 2.0**-7 * (p.abs() + y.abs()) + 2.0**-10 * y.abs().max()
    unequal = (got != plain).float().mean().item()
    print(f"max|diff| {diff.max().item():.3e}, max|plain| {p.abs().max().item():.3e}, "
          f"max|y| {y.abs().max().item():.3e}, unequal {100 * unequal:.3f} %, "
          f"max diff/bound {(diff / bound).max().item():.3f}")
    assert got.shape == plain.shape and got.dtype == plain.dtype
    assert torch.isfinite(got.float()).all()
    assert (diff <= bound).all(), (diff - bound).max().item()
    assert diff.max() <= 2.0**-6 * p.abs().max()
    assert unequal <= MAX_UNEQUAL


# --------------------------------------------------------------------------
# The card: the kernel against the plain composition
# --------------------------------------------------------------------------


# (batch, side, C, window, shift, norm): SwinIR's and SwinFIR's blocks at
# the cell's batch of 4; DRCT's five dense blocks at window 16 (shifted in
# blocks 2 and 4); HAB's with its norm off, shifted and not; a width of 2
# mod 4 (4-byte copies and stores), a narrow one, a ragged last tile and
# the kernel's widest
CARD_CASES = {
    "swinir": (4, CELL, 180, 13, 0, True),
    "drct_block1": (1, CELL, 180, 16, 0, True),
    "drct_block2": (1, CELL, 212, 16, 8, True),
    "drct_block3": (1, CELL, 244, 16, 0, True),
    "drct_block4": (1, CELL, 276, 16, 8, True),
    "drct_block5": (4, CELL, 308, 16, 0, True),
    "hab_shifted": (1, CELL, 180, 16, 8, False),
    "hab": (2, CELL, 180, 16, 0, False),
    "c_2_mod_4": (1, 104, 182, 13, 6, True),
    "narrow": (3, 24, 60, 8, 4, True),
    "ragged_tile": (1, 30, 96, 5, 2, True),
    "widest": (1, 64, 320, 16, 15, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_the_plain_composition(cuda, name):
    batch, hw, c, ws, shift, with_norm = CARD_CASES[name]
    norm, qkv = _layers(c, seed=len(name), dtype=torch.bfloat16, device=cuda)
    norm = norm if with_norm else None
    x = _tokens(batch, hw, c, seed=len(name) + 1, device=cuda)
    before = window_qkv.launches
    with torch.inference_mode():
        got = window_qkv(x, (hw, hw), ws, shift, norm, qkv)
        plain = window_qkv_plain(x, (hw, hw), ws, shift, norm, qkv)
    torch.cuda.synchronize()
    assert window_qkv.launches == before + 1
    _assert_within_bound(got, plain, qkv.bias)


@pytest.mark.gpu
def test_kernel_without_a_bias(cuda):
    norm, qkv = _layers(180, dtype=torch.bfloat16, device=cuda, bias=False)
    x = _tokens(1, 52, 180, device=cuda)
    with torch.inference_mode():
        got = window_qkv(x, (52, 52), 13, 6, norm, qkv)
        plain = window_qkv_plain(x, (52, 52), 13, 6, norm, qkv)
    _assert_within_bound(got, plain, None)


@pytest.mark.gpu
def test_off_the_kernel_inputs_take_the_plain_composition_on_the_card(cuda):
    norm, qkv = _layers(180, dtype=torch.bfloat16, device=cuda)
    x = _tokens(1, 64, 180, device=cuda)
    norm32, qkv32 = _layers(180, dtype=torch.float32, device=cuda)
    before = window_qkv.launches
    with torch.inference_mode():
        assert torch.equal(window_qkv(x.float(), (64, 64), 16, 8, norm32, qkv32),
                           window_qkv_plain(x.float(), (64, 64), 16, 8, norm32, qkv32))
        n17, q17 = _layers(180, dtype=torch.bfloat16, device=cuda)
        x17 = _tokens(1, 68, 180, device=cuda)
        assert torch.equal(window_qkv(x17, (68, 68), 17, 0, n17, q17),
                           window_qkv_plain(x17, (68, 68), 17, 0, n17, q17))
    got = window_qkv(x, (64, 64), 16, 8, norm, qkv)  # parameters that require grad: autograd
    assert got.grad_fn is not None
    got.float().sum().backward()
    assert torch.isfinite(qkv.weight.grad.float()).all()
    assert window_qkv.launches == before


@pytest.mark.gpu
def test_kernel_refuses_an_input_it_does_not_take(cuda):
    norm, qkv = _layers(180, dtype=torch.bfloat16, device=cuda)
    x = _tokens(1, 64, 180, device=cuda)[:, :-64]  # tokens of a 63 x 64 image called 64 x 64
    with torch.inference_mode(), pytest.raises(ValueError, match="window_qkv"):
        window_qkv(x, (64, 64), 16, 8, norm, qkv)


@pytest.mark.gpu
def test_kernel_is_warpgroup_mma(cuda):
    # the product on wgmma (HGMMA); no mma.sync (HMMA)
    counts = sass_counts("window_qkv", ("HGMMA", "HMMA"))
    print(counts)
    kernels = {fn: c for fn, c in counts.items() if "window_qkv_sm90_kernel" in fn}
    assert len(kernels) == 2 * len(K_STEPS)  # each instance's k16 steps, with and without the norm
    assert all(c["HGMMA"] > 0 for c in kernels.values()), kernels
    assert sum(c["HMMA"] for c in counts.values()) == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("run,launches", [("swinir_sr", 36), ("drct_sr_fsdp", 30),
                                          ("hat_sr", 36)])
def test_one_bf16_forward_launches_the_kernel_once_per_block(cuda, run, launches):
    # SwinIR: 6 x 6 Swin blocks; DRCT: 6 x 5 dense blocks at 180-308
    # channels; HAT: its 36 HABs (OCAB keeps its own qkv); at the run
    # configs' widths, one 416^2 image
    from pathlib import Path

    from xmm_superres_denoise_torch.config.schema import load_run_config
    from xmm_superres_denoise_torch.models.registry import build_model

    path = Path(__file__).resolve().parents[1] / "res/configs/runs" / f"{run}.toml"
    ds, mc = load_run_config(path)
    model = build_model(mc, (ds.lr.res,) * 2, (ds.hr.res,) * 2)
    model.reset_parameters(torch.Generator().manual_seed(5))
    model = model.to(cuda, torch.bfloat16).eval()
    x = torch.rand((1, ds.lr.res, ds.lr.res, 1), generator=torch.Generator().manual_seed(6))
    before = window_qkv.launches
    with torch.inference_mode():
        y = model(x.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert window_qkv.launches - before == launches
    assert torch.isfinite(y.float()).all()
