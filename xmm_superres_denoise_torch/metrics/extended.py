"""Extended image-quality metrics (piq-equivalent) on NHWC tensors.

The port of the JAX package's `metrics/extended.py`. The reference's
extended suite wraps piq (its `metrics/metrics.py:42-101`): GMSD, MS-GMSD,
HaarPSI, MDSI, FSIM and VIF-p on single-channel [0, 1] images at test time
(its `xmm_metric_collection.py:41-61`). These are from-scratch
implementations of the published algorithms with piq's constants, the same
as the JAX package's, op for op:

  * filters are cross-correlations (`F.conv2d`, no kernel flip) under
    `true_f32`, where JAX asks for `Precision.HIGHEST`;
  * FSIM's phase congruency filters in the frequency domain with a
    log-Gabor bank (numpy, cached per (h, w), and as a tensor per (h, w,
    device, dtype)) through `torch.fft.fft2`/`ifft2` in complex64 (complex128
    for f64 inputs).

All are per-image functions on NHWC batches returning (N,) scores, wired into
`collection.MetricBank` by `register_extended_metrics()`, which runs on
import.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import true_f32

Tensor = torch.Tensor


def _filters(kernels: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(np.asarray(kernels, np.float32)).to(like.device, like.dtype)


def _conv2d_same(x: Tensor, kernels: np.ndarray) -> Tensor:
    """Correlate NHWC single-channel x with a stack of 2-D kernels -> NHWK,
    zero padded as JAX pads SAME: (k // 2, k - 1 - k // 2) per side."""
    k = _filters(kernels, x)  # (K, kh, kw)
    kh, kw = k.shape[-2], k.shape[-1]
    y = F.pad(x.permute(0, 3, 1, 2), (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    with true_f32():
        y = F.conv2d(y, k[:, None])
    return y.permute(0, 2, 3, 1)


def _conv2d_valid(x: Tensor, kernel2d: np.ndarray) -> Tensor:
    k = _filters(kernel2d, x)
    with true_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), k[None, None])
    return y.permute(0, 2, 3, 1)


def _avg_pool2(x: Tensor) -> Tensor:
    """2x2/stride-2 average pool with piq's bottom/right zero pad for odd
    dims, H and W padded independently."""
    n, h, w, c = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        h, w = x.shape[1], x.shape[2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _avg_pool_k(x: Tensor, k: int) -> Tensor:
    """k x k average pool over the largest multiple of k (piq's
    content-adaptive downsampling of MDSI and FSIM)."""
    n, h, w, _ = x.shape
    hp, wp = (h // k) * k, (w // k) * k
    return x[:, :hp, :wp, :].reshape(n, hp // k, k, wp // k, k, 1).mean(dim=(2, 4))


_PREWITT = np.array(
    [[[-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0]]], dtype=np.float32
) / 3.0
_PREWITT_XY = np.concatenate([_PREWITT, _PREWITT.transpose(0, 2, 1)], axis=0)


def _gradient_magnitude(x: Tensor, kernels: np.ndarray) -> Tensor:
    g = _conv2d_same(x, kernels)  # NHWK
    return torch.sqrt(torch.sum(torch.square(g), dim=-1, keepdim=True) + 1e-12)


def _gmsd_score(x: Tensor, y: Tensor, t: float) -> Tensor:
    gx = _gradient_magnitude(x, _PREWITT_XY)
    gy = _gradient_magnitude(y, _PREWITT_XY)
    gms = (2.0 * gx * gy + t) / (torch.square(gx) + torch.square(gy) + t)
    flat = gms.reshape(gms.shape[0], -1)
    mean = torch.mean(flat, dim=-1, keepdim=True)
    return torch.sqrt(torch.mean(torch.square(flat - mean), dim=-1))


def gmsd_per_image(preds: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """Gradient Magnitude Similarity Deviation (piq.gmsd semantics): [0, 1]
    inputs, initial 2x2 average pool, Prewitt gradients, t = 170/255^2,
    population-std pooling."""
    x = _avg_pool2(preds / data_range)
    y = _avg_pool2(target / data_range)
    return _gmsd_score(x, y, t=170.0 / (255.0**2))


_MS_GMSD_WEIGHTS = np.array([0.096, 0.596, 0.289, 0.019], dtype=np.float32)


def ms_gmsd_per_image(preds: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """Multi-Scale GMSD (piq.multi_scale_gmsd, chromatic=False): 255-scale,
    t=170, 4 scales pooled between, sqrt of weighted sum of squared scores."""
    x = preds / data_range * 255.0
    y = target / data_range * 255.0
    scores = []
    for scale in range(len(_MS_GMSD_WEIGHTS)):
        if scale > 0:
            x = _avg_pool2(x)
            y = _avg_pool2(y)
        scores.append(_gmsd_score(x, y, t=170.0))
    stack = torch.stack(scores, dim=-1)  # (N, scales)
    weights = torch.as_tensor(_MS_GMSD_WEIGHTS).to(stack.device, stack.dtype)
    return torch.sqrt(torch.sum(weights * torch.square(stack), dim=-1))


# --------------------------------------------------------------------------- #
# HaarPSI (Reisenhofer et al. 2018), piq.haarpsi semantics, grayscale path.
# --------------------------------------------------------------------------- #


def _haar_filters(n_scales: int = 3):
    """2-D Haar wavelet filters g_j (horizontal) for scales j=1..n."""
    filters = []
    for j in range(1, n_scales + 1):
        size = 2**j
        f = np.zeros((size, size), dtype=np.float32)
        f[: size // 2, :] = -1.0
        f[size // 2 :, :] = 1.0
        f /= size**2
        filters.append(f)
    return filters


def haarpsi_per_image(
    preds: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    c: float = 30.0,
    alpha: float = 4.2,
) -> Tensor:
    """Haar wavelet Perceptual Similarity Index (grayscale).

    piq semantics: 255-scale, initial 2x2 average pool, 3 Haar scales; local
    similarity from scales 1-2, weights from scale-3 magnitude; logit/sigmoid
    pooling with alpha=4.2, c=30.
    """
    x = _avg_pool2(preds / data_range * 255.0)
    y = _avg_pool2(target / data_range * 255.0)

    filters = _haar_filters(3)

    def responses(img):  # horizontal and vertical per scale
        return [(torch.abs(_conv2d_same(img, f[None])), torch.abs(_conv2d_same(img, f.T[None])))
                for f in filters]

    rx = responses(x)
    ry = responses(y)

    sims = []
    weights = []
    for ori in range(2):  # horizontal / vertical
        mag_x = [rx[s][ori] for s in range(3)]
        mag_y = [ry[s][ori] for s in range(3)]
        local_sim = sum(
            (2.0 * mag_x[s] * mag_y[s] + c) / (mag_x[s] ** 2 + mag_y[s] ** 2 + c)
            for s in range(2)
        ) / 2.0
        sims.append(local_sim)
        weights.append(torch.maximum(mag_x[2], mag_y[2]))

    sim = torch.cat(sims, dim=-1)
    w = torch.cat(weights, dim=-1)
    n = sim.shape[0]
    num = torch.sum(torch.sigmoid(alpha * sim).reshape(n, -1) * w.reshape(n, -1), dim=-1)
    den = torch.sum(w.reshape(n, -1), dim=-1)
    score = num / torch.clamp(den, min=1e-12)
    # inverse sigmoid + square (piq: (logit(.)/alpha)**2)
    return torch.square(torch.log(score / (1.0 - score)) / alpha)


# --------------------------------------------------------------------------- #
# MDSI (Nafchi et al. 2016), piq.mdsi semantics, grayscale path.
# --------------------------------------------------------------------------- #


def mdsi_per_image(
    preds: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    c1: float = 140.0,
    c2: float = 55.0,
    c3: float = 550.0,
    alpha: float = 0.6,
    rho: float = 1.0,
    q: float = 0.25,
    o: float = 0.25,
) -> Tensor:
    """Mean Deviation Similarity Index (gradient + "chromaticity" terms).

    Grayscale inputs: the luminance path is exact; the chromaticity
    similarity degenerates to a constant for single-channel data, so the
    score is driven by gradient similarity. piq combination: 'sum' scheme
    GS' = alpha*GS + (1-alpha)*CS, deviation pooling with q/o/rho exponents;
    average-pool downsampling by max(1, round(min(h, w) / 256)).
    """
    x = preds / data_range * 255.0
    y = target / data_range * 255.0

    k = max(1, round(min(x.shape[1], x.shape[2]) / 256))
    if k > 1:
        x, y = _avg_pool_k(x, k), _avg_pool_k(y, k)

    gx = _gradient_magnitude(x, _PREWITT_XY)
    gy = _gradient_magnitude(y, _PREWITT_XY)
    gf = _gradient_magnitude((x + y) / 2.0, _PREWITT_XY)

    gs_xy = (2.0 * gx * gy + c1) / (torch.square(gx) + torch.square(gy) + c1)
    gs_xf = (2.0 * gx * gf + c2) / (torch.square(gx) + torch.square(gf) + c2)
    gs_yf = (2.0 * gy * gf + c2) / (torch.square(gy) + torch.square(gf) + c2)
    gs = gs_xy + gs_xf - gs_yf

    cs = torch.ones_like(gs)  # single-channel: chromaticity similarity saturates

    gcs = alpha * gs + (1.0 - alpha) * cs
    flat = gcs.reshape(gcs.shape[0], -1)
    flat_q = torch.pow(torch.abs(flat), q) * torch.sign(flat)
    mean_q = torch.mean(flat_q, dim=-1, keepdim=True)
    return torch.pow(torch.mean(torch.pow(torch.abs(flat_q - mean_q), rho), dim=-1), o / rho)


# --------------------------------------------------------------------------- #
# VIF-p (pixel-domain Visual Information Fidelity), torchmetrics semantics.
# --------------------------------------------------------------------------- #


def vif_p_per_image(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Pixel-domain VIF (torchmetrics VisualInformationFidelity semantics):
    4 scales, gaussian windows of size 2^(4-k+1)+1, sigma N/5, valid conv,
    2x downsampling between scales."""
    eps = 1e-10
    num = torch.zeros((preds.shape[0],), dtype=preds.dtype, device=preds.device)
    den = torch.zeros_like(num)
    x, y = preds * 255.0, target * 255.0
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        sd = n / 5.0
        half = n // 2
        g1 = np.exp(-((np.arange(n) - half) ** 2) / (2 * sd * sd))
        g = np.outer(g1, g1)
        g = (g / g.sum()).astype(np.float32)

        if scale > 1:  # filter then downsample by 2 (valid)
            x = _conv2d_valid(x, g)[:, ::2, ::2, :]
            y = _conv2d_valid(y, g)[:, ::2, ::2, :]

        mu_x = _conv2d_valid(x, g)
        mu_y = _conv2d_valid(y, g)
        mu_x_sq, mu_y_sq, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sigma_x_sq = torch.clamp(_conv2d_valid(x * x, g) - mu_x_sq, min=0.0)
        sigma_y_sq = torch.clamp(_conv2d_valid(y * y, g) - mu_y_sq, min=0.0)
        sigma_xy = _conv2d_valid(x * y, g) - mu_xy

        gcoef = sigma_xy / (sigma_x_sq + eps)
        sv_sq = sigma_y_sq - gcoef * sigma_xy

        zero = torch.zeros_like(gcoef)
        gcoef = torch.where(sigma_x_sq < eps, zero, gcoef)
        sv_sq = torch.where(sigma_x_sq < eps, sigma_y_sq, sv_sq)
        sigma_x_sq = torch.where(sigma_x_sq < eps, zero, sigma_x_sq)
        gcoef = torch.where(sigma_y_sq < eps, zero, gcoef)
        sv_sq = torch.where(sigma_y_sq < eps, zero, sv_sq)
        sv_sq = torch.where(gcoef < 0.0, sigma_y_sq, sv_sq)
        gcoef = torch.clamp(gcoef, min=0.0)
        sv_sq = torch.clamp(sv_sq, min=eps)

        num_map = torch.log2(1.0 + gcoef * gcoef * sigma_x_sq / (sv_sq + sigma_n_sq))
        den_map = torch.log2(1.0 + sigma_x_sq / sigma_n_sq)
        num = num + torch.sum(num_map.reshape(num_map.shape[0], -1), dim=-1)
        den = den + torch.sum(den_map.reshape(den_map.shape[0], -1), dim=-1)
    return num / torch.clamp(den, min=eps)


# --------------------------------------------------------------------------- #
# FSIM (Zhang et al. 2011): phase congruency + gradient similarity.
# --------------------------------------------------------------------------- #


@lru_cache(maxsize=None)
def _log_gabor_bank(
    h: int,
    w: int,
    scales: int = 4,
    orientations: int = 4,
    min_length: int = 6,
    mult: float = 2.0,
    sigma_f: float = 0.55,
    delta_theta: float = 1.2,
) -> np.ndarray:
    """Frequency-domain log-Gabor filters, shape (orients, scales, h, w).

    Kovesi's construction with piq.fsim's constants: radial log-Gabor at
    wavelengths min_length * mult^s with a 15th-order Butterworth lowpass at
    0.45, angular Gaussian of sigma pi/orientations/delta_theta.
    """
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fx**2 + fy**2)
    theta = np.arctan2(-fy, fx)
    r[0, 0] = 1.0  # avoid log(0); the DC entry is zeroed below

    lowpass = 1.0 / (1.0 + (r / 0.45) ** (2 * 15))
    radials = []
    for s in range(scales):
        wavelength = min_length * mult**s
        f0 = 1.0 / wavelength
        rad = np.exp(-(np.log(r / f0) ** 2) / (2 * np.log(sigma_f) ** 2))
        rad *= lowpass
        rad[0, 0] = 0.0
        radials.append(rad)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    theta_sigma = np.pi / orientations / delta_theta
    bank = np.empty((orientations, scales, h, w), np.float32)
    for o in range(orientations):
        angle = o * np.pi / orientations
        ds = sin_t * np.cos(angle) - cos_t * np.sin(angle)
        dc = cos_t * np.cos(angle) + sin_t * np.sin(angle)
        dtheta = np.abs(np.arctan2(ds, dc))
        spread = np.exp(-(dtheta**2) / (2 * theta_sigma**2))
        for s in range(scales):
            bank[o, s] = (radials[s] * spread).astype(np.float32)
    return bank


_BANKS: Dict[Tuple, Tensor] = {}


def _bank_tensor(h: int, w: int, scales: int, orientations: int, min_length: int, mult: float,
                 like: Tensor) -> Tensor:
    """`_log_gabor_bank` as a tensor on `like`'s device in its dtype, made
    once per (h, w, constants, device, dtype)."""
    key = (h, w, scales, orientations, min_length, mult, like.device, like.dtype)
    bank = _BANKS.get(key)
    if bank is None:
        bank = torch.from_numpy(
            _log_gabor_bank(h, w, scales, orientations, min_length, mult)
        ).to(like.device, like.dtype)
        _BANKS[key] = bank
    return bank


def _median(x: Tensor) -> Tensor:
    """Median over the last dim, the mean of the two middle values for an
    even count (as `jnp.median`; `torch.median` returns the lower one)."""
    s = torch.sort(x, dim=-1).values
    m = s.shape[-1] // 2
    if s.shape[-1] % 2:
        return s[..., m]
    return (s[..., m - 1] + s[..., m]) / 2.0


def _phase_congruency(
    x: Tensor,
    scales: int = 4,
    orientations: int = 4,
    min_length: int = 6,
    mult: float = 2.0,
    k: float = 2.0,
) -> Tensor:
    """Kovesi PC2 phase-congruency map for NHWC single-channel x -> (N,H,W)."""
    eps = 1e-8
    n, h, w, _ = x.shape
    bank = _bank_tensor(h, w, scales, orientations, min_length, mult, x)
    fx = torch.fft.fft2(x[..., 0])  # (N, H, W), complex64 for f32 x

    pc_sum = torch.zeros((n, h, w), dtype=x.dtype, device=x.device)
    for o in range(orientations):
        eo = torch.fft.ifft2(fx[:, None] * bank[o][None])  # (N, scales, H, W)
        even, odd = eo.real, eo.imag
        an = torch.abs(eo)
        sum_e = torch.sum(even, dim=1)
        sum_o = torch.sum(odd, dim=1)
        sum_an = torch.sum(an, dim=1)

        # full Kovesi PC2 energy (piq semantics): project each scale onto
        # the mean phase and subtract the |A sin(phi - phibar)| deviation
        x_energy = torch.sqrt(sum_e**2 + sum_o**2) + eps
        mean_e = sum_e / x_energy
        mean_o = sum_o / x_energy
        energy = torch.sum(
            even * mean_e[:, None] + odd * mean_o[:, None]
            - torch.abs(even * mean_o[:, None] - odd * mean_e[:, None]),
            dim=1,
        )

        # Rayleigh noise threshold from the smallest-scale response
        tau = _median(an[:, 0].reshape(n, -1)) / math.sqrt(math.log(4.0))
        total_tau = tau * (1.0 - (1.0 / mult) ** scales) / (1.0 - 1.0 / mult)
        noise_mean = total_tau * math.sqrt(math.pi / 2.0)
        noise_sigma = total_tau * math.sqrt((4.0 - math.pi) / 2.0)
        thresh = (noise_mean + k * noise_sigma)[:, None, None]

        pc_sum = pc_sum + torch.clamp(energy - thresh, min=0.0) / (sum_an + eps)
    return pc_sum


_SCHARR = np.array(
    [[[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]]], np.float32
) / 16.0
_SCHARR_XY = np.concatenate([_SCHARR, _SCHARR.transpose(0, 2, 1)], axis=0)


def fsim_per_image(
    preds: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    t1: float = 0.85,
    t2: float = 160.0,
) -> Tensor:
    """Feature Similarity Index (piq.fsim semantics, chromatic=False).

    255-scale, content-adaptive average-pool downsampling, phase-congruency
    similarity x Scharr-gradient similarity, PC-max weighted pooling.
    Identity inputs score exactly 1.
    """
    x = preds / data_range * 255.0
    y = target / data_range * 255.0

    kk = max(1, round(min(x.shape[1], x.shape[2]) / 256))
    if kk > 1:
        x, y = _avg_pool_k(x, kk), _avg_pool_k(y, kk)

    pc_x = _phase_congruency(x)
    pc_y = _phase_congruency(y)

    gx = _gradient_magnitude(x, _SCHARR_XY)[..., 0]
    gy = _gradient_magnitude(y, _SCHARR_XY)[..., 0]

    s_pc = (2.0 * pc_x * pc_y + t1) / (pc_x**2 + pc_y**2 + t1)
    s_g = (2.0 * gx * gy + t2) / (gx**2 + gy**2 + t2)
    s_l = s_pc * s_g
    pc_m = torch.maximum(pc_x, pc_y)

    n = s_l.shape[0]
    num = torch.sum((s_l * pc_m).reshape(n, -1), dim=-1)
    den = torch.sum(pc_m.reshape(n, -1), dim=-1)
    return num / torch.clamp(den, min=1e-12)


# --------------------------------------------------------------------------- #
# Registration with the accumulating MetricBank
# --------------------------------------------------------------------------- #

EXT_METRIC_NAMES = ("vif_p", "fsim", "gmsd", "ms_gmsd", "haarpsi", "msdi")
# key "msdi" (sic) follows the reference's collection key (its
# xmm_metric_collection.py:53)

EXT_METRICS = {
    "vif_p": vif_p_per_image,
    "fsim": fsim_per_image,
    "gmsd": gmsd_per_image,
    "ms_gmsd": ms_gmsd_per_image,
    "haarpsi": haarpsi_per_image,
    "msdi": mdsi_per_image,
}


def register_extended_metrics() -> None:
    """Add the per-image extended metrics to collection.MetricBank's update
    table with the reference's batch-mean accumulation (its
    metrics.py:42-101)."""
    from . import collection as _c

    def _make(fn):
        def upd(p: Tensor, t: Tensor, w: Tensor, group=None):
            # one global batch-mean per update whatever the number of ranks
            return _c.batch_mean_delta(fn(p, t), w, group), torch.sum(w)

        return upd

    for name, fn in EXT_METRICS.items():
        _c._UPDATES.setdefault(name, _make(fn))


register_extended_metrics()
