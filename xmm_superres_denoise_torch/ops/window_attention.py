"""The transformer zoo's window attention on a hand-written Hopper kernel.

softmax(q * scale @ k^T + bias [+ mask]) @ v over (B_, nh, N, d) queries
and (B_, nh, M, d) keys and values, with the precision of the JAX package's
`models/swin_common.py` (and HAT's OCAB): the logits f32 from bf16 operands,
the bias and mask added in f32, the softmax in f32 and rounded to the input
dtype once normalised, `attn @ v` in the input dtype.

* `window_attention(q, k, v, scale, bias, mask)` is the entry point, and
  `models/swin_common.py: attention_core` calls it. Where it goes is decided
  by what the input shows (`route`): a CUDA bf16 input that needs no
  gradient (serving, under `torch.inference_mode()`) launches the kernel of
  `csrc/window_attention.cu`; a CPU tensor, any other dtype (f32 is the
  parity class and f32 evaluation) or an input that needs a gradient
  (training through autograd, as `ops/dense_block.py` routes) runs
  `window_attention_plain`. A kernel input outside the kernel's range
  (`plan`) raises; there is no fallback. `route_for` is the decision
  itself, from the device type, the dtype and whether a gradient is needed.
  An operand whose channels the kernel cannot read in place is copied
  first (`readable`).
* `window_attention_plain` is the composition of PyTorch ops the kernel
  fuses: the f32 logits, each add, the softmax and the cast are passes over
  the f32 logits in device memory.
* `plan` checks a kernel input and returns what the launch is handed: the
  split of the keys over warpgroups, the strides, the bias and mask layout.
  The range: N <= 256 queries, d <= 128 padded to 32, 64 or 128, and M <=
  576, 384 or 256 keys at those paddings (`MAX_KEYS`): SwinIR's and HAT's d
  = 30, and DRCT's dense blocks (d 30, 53, 122, 46, 77) at window 16.
* `window_attention.launches` counts kernel launches (one per call on the
  kernel's path).

The kernel's output is a (B_, N, nh, d) buffer, returned as its (B_, nh, N,
d) view, so a caller's `out.transpose(1, 2).reshape(B_, N, nh * d)` copies
nothing. What bounds the kernel and how its design meets that are in the
note at the top of `csrc/window_attention.cu`. The library is built at
first use (`ops/cuda_build.py`) and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .dense_block import grad_needed
from .precision import scalar_like

Tensor = torch.Tensor

MAX_QUERIES = 256  # N: four 64-row query tiles
MAX_HEAD = 128     # d, padded to 32, 64 or 128
# chunks of 64 keys a warpgroup holds at each padded d, over at most three
# warpgroups; past three chunks at 128, two warpgroups of two (`_split`)
_CHUNKS_PER_SPLIT = {32: 3, 64: 2, 128: 1}
_MAX_SPLITS = 3
_CHUNK = 64
MAX_KEYS = {32: 576, 64: 384, 128: 256}  # M
_MAX_GRID = 2**31 - 1

_I, _P, _L = cuda_build.I, cuda_build.P, ctypes.c_longlong
_SIGNATURES = {
    "window_attention": [_I, _P, _P, _P, *[_L] * 9, _P, _I, _P, _L, _I, _I, _I, _P,
                         *[_I] * 7, cuda_build.F32, _I, _I, _P],
}


def window_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float,
                           bias: Optional[Tensor], mask: Optional[Tensor]) -> Tensor:
    """softmax(q * scale @ k^T + bias [+ mask]) @ v over (B_, nh, N, d):
    `q * scale` in the input dtype (the scalar rounded to it), the logits in
    f32 from q and k upcast, bias (nh, N, M) and mask (nW, N, M) added in
    f32, the softmax in f32 and cast back, `attn @ v` in the input dtype.
    The mask of window b is mask[b % nW]."""
    dtype = q.dtype
    q = q * scalar_like(q, scale)
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    if bias is not None:
        attn = attn + bias[None]
    if mask is not None:
        b_, nh, n, m = attn.shape
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, nh, n, m) + mask[None, :, None]).view(b_, nh, n, m)
    attn = torch.softmax(attn, dim=-1).to(dtype)
    return torch.matmul(attn, v)


def route_for(device_type: str, dtype: torch.dtype, needs_grad: bool) -> str:
    """'kernel' for a CUDA bf16 input that needs no gradient, else 'plain'."""
    kernel = device_type == "cuda" and dtype == torch.bfloat16 and not needs_grad
    return "kernel" if kernel else "plain"


def route(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None,
          mask: Optional[Tensor] = None) -> str:
    """`route_for` of q's device and dtype, and whether autograd records a
    function of the operands here (`ops/dense_block.py: grad_needed`)."""
    return route_for(q.device.type, q.dtype, grad_needed(q, k, v, bias, mask))


class Plan(NamedTuple):
    """What a launch is handed. Strides are in elements."""

    batch: int      # B_, windows times images
    heads: int      # nh
    queries: int    # N
    keys: int       # M
    head_dim: int   # d
    padded_head: int  # d padded to 32, 64 or 128
    channel_pairs: bool  # q, k, v read and the output written a pair of channels at a time
    splits: int     # warpgroups a block splits the keys over
    chunks_per_split: int  # 64-key chunks of logits each warpgroup holds
    query_tiles: int       # 64-row tiles a block walks
    q_strides: Tuple[int, int, int]  # (window, head, row)
    k_strides: Tuple[int, int, int]
    v_strides: Tuple[int, int, int]
    bias_cols: int  # row stride of the bias the kernel reads: M rounded up to even
    windows: int    # nW of the mask, 0 without one
    mask_strides: Tuple[int, int]  # (window, row)
    mask_pairs: bool  # the mask's (col, col + 1) read as one 8-byte load


def padded_head(d: int) -> int:
    """d padded with zeros to the kernel's 32, 64 or 128 channels; an odd d
    to 64 or more, as the 32-channel forms read pairs of channels only."""
    return next(dk for dk in (32, 64, 128) if d <= dk and (dk > 32 or d % 2 == 0))


def _split(m: int, dk: int) -> Tuple[int, int]:
    """(warpgroups, chunks each) for M <= MAX_KEYS[dk] keys at padded head
    size dk: at most `_CHUNKS_PER_SPLIT[dk]` chunks a warpgroup, as few
    warpgroups as that allows, the chunks spread evenly; at 128, four
    chunks (193-256 keys) as two warpgroups of two. The kernel has an
    instance for each such split and refuses any other (csrc: max_cpw,
    max_ks, min_ks)."""
    chunks = -(-m // _CHUNK)
    if dk == 128 and chunks > _MAX_SPLITS:
        return 2, 2
    splits = -(-chunks // _CHUNKS_PER_SPLIT[dk])
    return splits, -(-chunks // splits)


def plan(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None,
         mask: Optional[Tensor] = None) -> Plan:
    """Check that the kernel takes these operands and say how it is launched.

    Raises ValueError outside the kernel's range: N <= 256 queries, d <= 128,
    M <= 576, 384 or 256 keys at d padded to 32, 64 or 128 (`MAX_KEYS`), the
    channels of a row contiguous and, at an even d, even strides and every
    operand 4-byte aligned, bias (nh, N, M) in q's dtype, mask (nW, N, M)
    float32 with B_ a multiple of nW."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("window_attention takes q, k, v as (B_, nh, rows, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b_, nh, n, d = q.shape
    m = k.shape[2]
    if tuple(k.shape) != (b_, nh, m, d) or tuple(v.shape) != (b_, nh, m, d):
        raise ValueError(f"window_attention: k and v must be {(b_, nh, m, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("window_attention: q, k and v must share dtype and device")
    if not 1 <= d <= MAX_HEAD:
        raise ValueError(f"window_attention kernel takes a head size 1 <= d <= {MAX_HEAD}, "
                         f"got d={d}")
    dk = padded_head(d)
    if not (1 <= n <= MAX_QUERIES and 1 <= m <= MAX_KEYS[dk]):
        raise ValueError(f"window_attention kernel takes 1 <= N <= {MAX_QUERIES} queries and, "
                         f"at d <= {dk}, 1 <= M <= {MAX_KEYS[dk]} keys, got N={n}, M={m}, d={d}")
    if b_ * nh > _MAX_GRID:
        raise ValueError(f"window_attention kernel takes at most {_MAX_GRID} (window, head) "
                         f"pairs, got {b_ * nh}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if st[3] != 1 or (d % 2 == 0 and not _pairs(t)):
            raise ValueError(f"window_attention kernel reads {name}'s rows of channels, at an "
                             f"even d a pair of channels to a 32-bit load: it needs the "
                             f"channels contiguous and, at an even d, even strides and a "
                             f"4-byte aligned start, got d={d}, strides {st}")
        strides.append(st[:3])
    if bias is not None:
        if tuple(bias.shape) != (nh, n, m):
            raise ValueError(f"window_attention: bias must be {(nh, n, m)}, got "
                             f"{tuple(bias.shape)}")
        if bias.dtype != q.dtype or bias.device != q.device:
            raise ValueError(f"window_attention kernel reads the bias in q's dtype on q's "
                             f"device, got {bias.dtype} on {bias.device}")
    windows, mask_strides, mask_pairs = 0, (0, 0), False
    if mask is not None:
        windows = mask.shape[0]
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, m) or b_ % windows:
            raise ValueError(f"window_attention: mask must be (nW, {n}, {m}) with B_={b_} a "
                             f"multiple of nW, got {tuple(mask.shape)}")
        if mask.dtype != torch.float32 or mask.device != q.device or mask.stride(2) != 1:
            raise ValueError("window_attention kernel reads the mask as float32 rows on q's "
                             f"device, got {mask.dtype} on {mask.device}, strides {mask.stride()}")
        mask_strides = mask.stride()[:2]
        mask_pairs = (m % 2 == 0 and all(s % 2 == 0 for s in mask_strides)
                      and mask.data_ptr() % 8 == 0)
    splits, per_split = _split(m, dk)
    return Plan(b_, nh, n, m, d, dk, d % 2 == 0, splits, per_split, -(-n // 64), *strides,
                m + m % 2, windows, mask_strides, mask_pairs)


def _bias_rows(bias: Tensor, cols: int) -> Tensor:
    """The bias as the kernel reads it: (nh, N, cols) in its dtype,
    contiguous, 4-byte aligned (the kernel reads pairs of columns as one
    32-bit word), the column past an odd M zero. The models' gathered bias
    is a permuted view, copied here once a call (about 1 MB)."""
    nh, n, m = bias.shape
    if cols == m and bias.is_contiguous() and bias.data_ptr() % 4 == 0:
        return bias
    out = torch.zeros((nh, n, cols), dtype=bias.dtype, device=bias.device)
    out[..., :m].copy_(bias)
    return out


def _pairs(t: Tensor) -> bool:
    """Whether every pair of channels (2i, 2i + 1) of `t` is one aligned
    32-bit word: even strides and a 4-byte aligned start."""
    return not any(s % 2 for s in t.stride()[:-1]) and t.data_ptr() % 4 == 0


def readable(t: Tensor) -> Tensor:
    """`t` if the kernel reads it in place (channels contiguous and, at an
    even d, `_pairs`), else a contiguous copy. The layouts the models hand
    over are read in place, except OCAB's unfolded keys and values of a
    single image, which `unfold_overlap_windows` returns as a view with
    strided channels."""
    if t.stride(-1) == 1 and (t.shape[-1] % 2 or _pairs(t)):
        return t
    return t.contiguous()


def _launch(q: Tensor, k: Tensor, v: Tensor, scale: float, bias: Optional[Tensor],
            mask: Optional[Tensor]) -> Tensor:
    q, k, v = readable(q), readable(k), readable(v)
    pl = plan(q, k, v, bias, mask)
    out = torch.empty((pl.batch, pl.queries, pl.heads, pl.head_dim), dtype=q.dtype,
                      device=q.device)
    if pl.batch == 0:
        return out.transpose(1, 2)
    bias_k = None if bias is None else _bias_rows(bias, pl.bias_cols)
    scale_bf16 = float(torch.tensor(scale, dtype=q.dtype))  # the bf16 scalar, on the host
    lib = cuda_build.library("window_attention", _SIGNATURES)
    err = lib.window_attention(
        cuda_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *pl.q_strides, *pl.k_strides, *pl.v_strides,
        None if bias_k is None else bias_k.data_ptr(), pl.bias_cols,
        None if mask is None else mask.data_ptr(), pl.mask_strides[0], pl.mask_strides[1],
        int(pl.mask_pairs), pl.windows, out.data_ptr(), pl.batch, pl.heads, pl.queries,
        pl.keys, pl.head_dim, pl.padded_head, int(pl.channel_pairs), scale_bf16, pl.splits,
        pl.chunks_per_split, cuda_build.stream_of(q))
    cuda_build.check(lib, "window_attention", err, "window_attention")
    window_attention.launches += 1
    return out.transpose(1, 2)


def window_attention(q: Tensor, k: Tensor, v: Tensor, scale: float,
                     bias: Optional[Tensor] = None, mask: Optional[Tensor] = None) -> Tensor:
    """softmax(q * scale @ k^T + bias [+ mask]) @ v, (B_, nh, N, d): on the
    kernel for a CUDA bf16 input that needs no gradient, else the plain
    version (module docstring)."""
    if route(q, k, v, bias, mask) == "plain":
        return window_attention_plain(q, k, v, scale, bias, mask)
    return _launch(q, k, v, scale, bias, mask)


window_attention.launches = 0
