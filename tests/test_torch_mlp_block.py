"""The zoo's MLP half-block (`ops/mlp_block.py`): the wrapper's routing,
launch plan and weight layout on the CPU, the blocks' call site
(`models/swin_common.py: mlp_residual`) against the ops it replaced, and
the hand-written kernel of `csrc/mlp_block.cu` against its plain
composition on the card.

This file imports no JAX. The tests marked `gpu` skip without a CUDA card;
whether a card is present is decided inside the `cuda` fixture:

    python -m pytest --noconftest tests/test_torch_mlp_block.py

Tolerance of the kernel against `mlp_block_plain` on the card, per output
element: the two make the same bf16 roundings, and differ in the order of
their f32 sums (LayerNorm's statistics, fc1's and fc2's products). A sum
near a bf16 rounding boundary may round one ulp (at most 2^-7 of the
value) the other way: the output's last rounding (2^-7 |out|), the bias
add's (2^-7 |y|, y = out - x) and fc2's product's (2^-7 |y - b2|); and
LayerNorm's or fc1's, whose one-ulp changes in a few hidden units reach
the output through fc2's sum of 720 far below an ulp of y. So |kernel -
plain| <= 2^-7 (|plain| + |y| + |y - b2|) + 2^-10 max|y|, the last term
for the propagated sums; and, as a whole, max|kernel - plain| <= 4 bf16
ulps x max|plain| (2^-6 max|plain|).
"""

import pytest
import torch
import torch.nn.functional as F

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_sass import sass_counts
from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import swin_common as tsc
from xmm_superres_denoise_torch.ops.mlp_block import (
    CHUNK,
    MAX_HIDDEN,
    mlp_block,
    mlp_block_plain,
    plan,
    route,
    route_for,
    weights_of,
)

CELL_TOKENS = 173_056  # tokens of one image at the cells' 416^2 input


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _layers(c, h, seed=0, dtype=torch.float32, device="cpu"):
    """A `LayerNorm(c)` and an `Mlp(c, h, c)` with parameters of realistic
    size that exercise every term: LayerNorm's scale around 1 and a bias,
    weights N(0, 1 / fan_in), nonzero biases."""
    g = torch.Generator().manual_seed(seed)
    norm, mlp = tsc.LayerNorm(c), tsc.Mlp(c, h, c)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
        norm.bias.copy_(0.2 * torch.randn(c, generator=g))
        mlp.fc1.weight.copy_(torch.randn(h, c, generator=g) / c ** 0.5)
        mlp.fc1.bias.copy_(0.5 * torch.randn(h, generator=g))
        mlp.fc2.weight.copy_(torch.randn(c, h, generator=g) / h ** 0.5)
        mlp.fc2.bias.copy_(0.5 * torch.randn(c, generator=g))
    return norm.to(device, dtype).eval(), mlp.to(device, dtype).eval()


def _tokens(batch, tokens, c, seed=1, dtype=torch.bfloat16, device="cpu"):
    """(batch, tokens, c) with a per-channel offset and scale, so that
    LayerNorm's mean and variance matter."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, tokens, c, generator=g) * (0.5 + torch.rand(c, generator=g))
    return (x + torch.randn(c, generator=g)).to(device, dtype)


# --------------------------------------------------------------------------
# CPU: the routing decision
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device_type,dtype,needs_grad,c,h,want", [
    ("cuda", torch.bfloat16, False, 180, 720, "kernel"),  # SwinIR, SwinFIR, HAT, DRCT's first
    ("cuda", torch.bfloat16, False, 192, 768, "kernel"),  # the widest the kernel takes
    ("cuda", torch.bfloat16, False, 60, 240, "kernel"),
    ("cuda", torch.bfloat16, False, 180, 360, "kernel"),  # mlp_ratio 2
    ("cuda", torch.bfloat16, True, 180, 720, "plain"),    # training through autograd
    ("cuda", torch.float32, False, 180, 720, "plain"),    # the parity class, f32 evaluation
    ("cuda", torch.float16, False, 180, 720, "plain"),
    ("cpu", torch.bfloat16, False, 180, 720, "plain"),
    ("cpu", torch.float32, False, 180, 720, "plain"),
    ("cuda", torch.bfloat16, False, 212, 848, "plain"),   # DRCT's dense blocks 2-5
    ("cuda", torch.bfloat16, False, 244, 976, "plain"),
    ("cuda", torch.bfloat16, False, 276, 276, "plain"),
    ("cuda", torch.bfloat16, False, 308, 308, "plain"),
    ("cuda", torch.bfloat16, False, 192, 769, "plain"),
    ("cuda", torch.bfloat16, False, 194, 194, "plain"),
])
def test_route_for(device_type, dtype, needs_grad, c, h, want):
    assert route_for(device_type, dtype, needs_grad, c, h) == want


def test_route_reads_grad_mode_requires_grad_and_the_widths():
    norm, mlp = _layers(12, 48)
    x = _tokens(1, 8, 12, dtype=torch.float32)
    assert route(x, norm, mlp) == "plain"  # a CPU tensor
    from xmm_superres_denoise_torch.ops.dense_block import grad_needed

    assert grad_needed(x, mlp.fc1.weight)  # parameters require grad in grad mode
    with torch.no_grad():
        assert not grad_needed(x, mlp.fc1.weight, norm.scale)


# --------------------------------------------------------------------------
# CPU: the launch plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,tokens,c,h,want", [
    (4, CELL_TOKENS, 180, 720, (4 * CELL_TOKENS, 180, 720, 15)),
    (1, CELL_TOKENS, 180, 720, (CELL_TOKENS, 180, 720, 15)),
    (2, 1000, 192, 768, (2000, 192, 768, 16)),
    (1, 37, 60, 100, (37, 60, 100, 3)),
])
def test_plan(batch, tokens, c, h, want):
    norm, mlp = _layers(c, h, dtype=torch.bfloat16)
    x = torch.empty((batch, tokens, c), dtype=torch.bfloat16)
    assert tuple(plan(x, norm, mlp)) == want


@pytest.mark.parametrize("case,what", [
    ("odd_channels", "even number of channels"),
    ("too_wide", "even number of channels"),
    ("too_deep", "hidden width"),
    ("f32", "bf16 tokens"),
    ("strided", "contiguous rows"),
    ("misaligned", "16-byte aligned"),
    ("layers", "layers must be"),
])
def test_plan_refuses_inputs_outside_the_range(case, what):
    c, h = {"odd_channels": (181, 720), "too_wide": (194, 720),
            "too_deep": (180, MAX_HIDDEN + 1)}.get(case, (180, 720))
    norm, mlp = _layers(c, h, dtype=torch.bfloat16)
    x = torch.zeros((2, 16, c), dtype=torch.bfloat16)
    if case == "f32":
        x = x.float()
    elif case == "strided":
        x = torch.zeros((2, 16, 2 * c), dtype=torch.bfloat16)[..., :c]
    elif case == "misaligned":
        flat = torch.zeros(2 * 16 * c + 8, dtype=torch.bfloat16)
        start = next(i for i in range(1, 8) if (flat.data_ptr() + 2 * i) % 16)
        x = flat[start:start + 2 * 16 * c].view(2, 16, c)
    elif case == "layers":
        _, mlp = _layers(c + 2, h, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=what):
        plan(x, norm, mlp)


# --------------------------------------------------------------------------
# CPU: the weights as the kernel reads them, and the kernel's arithmetic
# --------------------------------------------------------------------------


def _region(image_row: torch.Tensor, offset: int, rows: int) -> torch.Tensor:
    """A (rows, 16) bf16 region of one chunk's image at element `offset`,
    read as wgmma reads it through a 32-byte-swizzle descriptor: element e
    of row r at byte r * 32 + (((2e >> 4) ^ (r >> 2)) & 1) * 16 + (2e & 15)."""
    r, e = torch.arange(rows)[:, None], torch.arange(16)[None, :]
    byte = r * 32 + ((((2 * e) >> 4) ^ (r >> 2)) & 1) * 16 + ((2 * e) & 15)
    return image_row[offset + byte // 2]


def _chunk(image: torch.Tensor, j: int):
    """Chunk j's W1 rows (48, 192) and W2 columns (192, 48) from its image."""
    w1 = torch.cat([_region(image[j], kb * CHUNK * 16, CHUNK) for kb in range(12)], dim=1)
    w2 = torch.cat([_region(image[j], 12 * CHUNK * 16 + kk * 192 * 16, 192)
                    for kk in range(CHUNK // 16)], dim=1)
    return w1, w2


@pytest.mark.parametrize("c,h", [(180, 720), (60, 100), (192, 768)])
def test_weight_image_holds_the_padded_weights_under_the_swizzle(c, h):
    norm, mlp = _layers(c, h, dtype=torch.bfloat16)
    image, vec = weights_of(norm, mlp, torch.device("cpu"))
    n = -(-h // CHUNK)
    assert image.shape == (n, 2 * 12 * CHUNK * 16) and image.dtype == torch.bfloat16
    w1p = torch.zeros((n * CHUNK, 192), dtype=torch.bfloat16)
    w1p[:h, :c] = mlp.fc1.weight
    w2p = torch.zeros((192, n * CHUNK), dtype=torch.bfloat16)
    w2p[:c, :h] = mlp.fc2.weight
    for j in {0, n - 1}:
        w1, w2 = _chunk(image, j)
        assert torch.equal(w1, w1p[j * CHUNK:(j + 1) * CHUNK])
        assert torch.equal(w2, w2p[:, j * CHUNK:(j + 1) * CHUNK])
    pad = lambda v, k: torch.cat([v, torch.zeros(k - v.numel(), dtype=v.dtype)])  # noqa: E731
    assert torch.equal(vec, torch.cat([pad(norm.scale, 192), pad(norm.bias, 192),
                                       pad(mlp.fc2.bias, 192), pad(mlp.fc1.bias, n * CHUNK)]))


def test_weight_image_is_made_once_per_parameter_version():
    norm, mlp = _layers(60, 100, dtype=torch.bfloat16)
    a = weights_of(norm, mlp, torch.device("cpu"))
    assert all(u is v for u, v in zip(a, weights_of(norm, mlp, torch.device("cpu"))))
    with torch.no_grad():
        mlp.fc1.weight.mul_(2)  # an in-place update bumps the version
    b = weights_of(norm, mlp, torch.device("cpu"))
    assert not torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _emulate(x, image, vec, c, h, eps):
    """The kernel's arithmetic in PyTorch ops on the CPU, reading the
    weights from the image: LayerNorm in f32 rounded once, per chunk fc1's
    f32 sums rounded, + b1 rounded, the erf GELU in f32 rounded, fc2's f32
    sums over every chunk rounded, + b2 rounded, + x rounded."""
    bf = torch.bfloat16
    xf = x.float().reshape(-1, c)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    a = (vec[:c].float() * (rstd * (xf - mean)) + vec[192:192 + c].float()).to(bf)
    a = F.pad(a, (0, 192 - c))
    acc = torch.zeros((xf.shape[0], 192))
    for j in range(image.shape[0]):
        w1, w2 = _chunk(image, j)
        hid = (a.float() @ w1.float().T).to(bf)
        hid = (hid.float() + vec[576 + j * CHUNK:576 + (j + 1) * CHUNK].float()).to(bf)
        g = F.gelu(hid.float()).to(bf)
        acc += g.float() @ w2.float().T
    y = (acc[:, :c].to(bf).float() + vec[384:384 + c].float()).to(bf)
    return (xf + y.float()).to(bf).reshape(x.shape)


@pytest.mark.parametrize("c,h,tokens", [(60, 100, 37), (180, 720, 20)])
def test_the_kernels_arithmetic_on_its_image_is_the_plain_composition(c, h, tokens):
    # the layout, the padding and the order of the roundings, at the
    # tolerance the card holds the kernel to (module docstring)
    norm, mlp = _layers(c, h, dtype=torch.bfloat16)
    x = _tokens(1, tokens, c)
    image, vec = weights_of(norm, mlp, torch.device("cpu"))
    got = _emulate(x, image, vec, c, h, norm.eps)
    with torch.no_grad():
        plain = mlp_block_plain(x, norm, mlp)
    _assert_within_bound(got, plain, x, mlp.fc2.bias)


def _assert_within_bound(got, plain, x, b2):
    p, y = plain.float(), (plain.float() - x.float())
    diff = (got.float() - p).abs()
    bound = 2.0**-7 * (p.abs() + y.abs() + (y - b2.float()).abs()) + 2.0**-10 * y.abs().max()
    same = (got == plain).float().mean().item()
    print(f"max|diff| {diff.max().item():.3e}, max|plain| {p.abs().max().item():.3e}, "
          f"max|y| {y.abs().max().item():.3e}, bitwise equal {100 * same:.2f} %, "
          f"max diff/bound {(diff / bound).max().item():.3f}")
    assert torch.isfinite(got.float()).all()
    assert (diff <= bound).all(), (diff - bound).max().item()
    assert diff.max() <= 2.0**-6 * p.abs().max()


# --------------------------------------------------------------------------
# CPU: the blocks' call site is the ops it replaced
# --------------------------------------------------------------------------


def _block(kind):
    """A Swin block, a HAB or an OCAB at width 12 on 8 x 8 tokens, with a
    drop-path rate, its parameters drawn by the zoo's initializer."""
    if kind == "swin":
        blk = tsc.SwinTransformerBlock(12, (8, 8), 2, 4, 2, drop_path_rate=0.3)
    elif kind == "hab":
        blk = thaat.HAB(12, (8, 8), 2, 4, 2, compress_ratio=3, squeeze_factor=3,
                        drop_path_rate=0.3)
    else:
        blk = thaat.OCAB(12, (8, 8), 4, 0.5, 2, mlp_ratio=4.0)
    tsc.reset_zoo_parameters(blk, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for prm in blk.parameters():  # nonzero biases and norm parameters
            prm.add_(0.1 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(4)))
    return blk


@pytest.mark.parametrize("kind", ["swin", "hab", "ocab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drawn", [False, True])
def test_mlp_residual_is_the_ops_it_replaced(kind, dtype, drawn):
    blk = _block(kind).to(dtype)
    rate = getattr(blk, "drop_path_rate", 0.0)
    x = _tokens(2, 64, 12, dtype=dtype)
    gen = (lambda: torch.Generator().manual_seed(7)) if drawn else (lambda: None)  # noqa: E731
    before = mlp_block.launches
    with torch.no_grad():
        got = tsc.mlp_residual(x, blk.norm2, blk.mlp, rate, gen())
        want = x + tsc.drop_path(blk.mlp(blk.norm2(x)), rate, gen())
    assert torch.equal(got, want) and got.dtype == dtype
    assert mlp_block.launches == before  # the CPU never launches


def test_block_forwards_on_the_cpu_launch_nothing():
    blk = _block("hab")
    x = _tokens(1, 64, 12, dtype=torch.bfloat16)
    before = mlp_block.launches
    with torch.inference_mode():
        y = blk.to(torch.bfloat16)(x, (8, 8))
    assert y.shape == x.shape and mlp_block.launches == before


# --------------------------------------------------------------------------
# The card: the kernel against the plain composition
# --------------------------------------------------------------------------


# (batch, tokens, C, H): the cells' one and four images, a token count that
# is no multiple of the 128-token tile, DRCT's first block at 13 x 13
# windows of a 416^2 image (the same widths), a hidden width that is no
# multiple of the 48-wide chunk, the kernel's widest and a narrow one
CARD_CASES = {
    "cell_batch1": (1, CELL_TOKENS, 180, 720),
    "cell_batch4": (4, CELL_TOKENS, 180, 720),
    "ragged_tokens": (3, 1001, 180, 720),
    "drct_first_block": (2, CELL_TOKENS, 180, 720),
    "ragged_hidden": (1, 4099, 180, 500),
    "widest": (1, 5000, 192, 768),
    "narrow": (2, 777, 60, 120),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_the_plain_composition(cuda, name):
    batch, tokens, c, h = CARD_CASES[name]
    norm, mlp = _layers(c, h, seed=len(name), dtype=torch.bfloat16, device=cuda)
    x = _tokens(batch, tokens, c, seed=len(name) + 1, device=cuda)
    before = mlp_block.launches
    with torch.inference_mode():
        got = mlp_block(x, norm, mlp)
        plain = mlp_block_plain(x, norm, mlp)
    torch.cuda.synchronize()
    assert mlp_block.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _assert_within_bound(got, plain, x, mlp.fc2.bias)


@pytest.mark.gpu
def test_off_the_kernel_inputs_take_the_plain_composition_on_the_card(cuda):
    norm, mlp = _layers(180, 720, dtype=torch.bfloat16, device=cuda)
    x = _tokens(1, 999, 180, device=cuda)
    before = mlp_block.launches
    norm32, mlp32 = _layers(180, 720, dtype=torch.float32, device=cuda)
    with torch.inference_mode():
        assert torch.equal(mlp_block(x.float(), norm32, mlp32),
                           mlp_block_plain(x.float(), norm32, mlp32))
        wide_norm, wide_mlp = _layers(212, 848, dtype=torch.bfloat16, device=cuda)
        xw = _tokens(1, 999, 212, device=cuda)
        assert torch.equal(mlp_block(xw, wide_norm, wide_mlp),
                           mlp_block_plain(xw, wide_norm, wide_mlp))
    got = mlp_block(x, norm, mlp)  # parameters that require grad: autograd
    assert got.grad_fn is not None
    got.float().sum().backward()
    assert torch.isfinite(mlp.fc1.weight.grad.float()).all()
    assert mlp_block.launches == before


@pytest.mark.gpu
def test_kernel_refuses_an_odd_width(cuda):
    norm, mlp = _layers(181, 720, dtype=torch.bfloat16, device=cuda)
    x = _tokens(1, 64, 181, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="mlp_block kernel"):
        mlp_block(x, norm, mlp)


@pytest.mark.gpu
def test_kernel_is_warpgroup_mma(cuda):
    # both products on wgmma (HGMMA); no mma.sync (HMMA)
    counts = sass_counts("mlp_block", ("HGMMA", "HMMA"))
    print(counts)
    kernels = {fn: c for fn, c in counts.items() if "mlp_block_sm90_kernel" in fn}
    assert len(kernels) == 1
    assert all(c["HGMMA"] > 0 for c in kernels.values()), kernels
    assert sum(c["HMMA"] for c in counts.values()) == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("run,launches", [("swinir_sr", 36), ("hat_sr", 42),
                                          ("drct_sr_fsdp", 6)])
def test_one_bf16_forward_launches_the_kernel_once_per_block(cuda, run, launches):
    # SwinIR: 6 x 6 Swin blocks; HAT: 6 x 6 HABs and 6 OCABs; DRCT: the
    # first of each group's 5 dense blocks (180 / 720), the rest wider; at
    # the run configs' widths, one 416^2 image
    from pathlib import Path

    from xmm_superres_denoise_torch.config.schema import load_run_config
    from xmm_superres_denoise_torch.models.registry import build_model

    path = Path(__file__).resolve().parents[1] / "res/configs/runs" / f"{run}.toml"
    ds, mc = load_run_config(path)
    model = build_model(mc, (ds.lr.res,) * 2, (ds.hr.res,) * 2)
    model.reset_parameters(torch.Generator().manual_seed(5))
    model = model.to(cuda, torch.bfloat16).eval()
    x = torch.rand((1, ds.lr.res, ds.lr.res, 1), generator=torch.Generator().manual_seed(6))
    before = mlp_block.launches
    with torch.inference_mode():
        y = model(x.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert mlp_block.launches - before == launches
    assert torch.isfinite(y.float()).all()
