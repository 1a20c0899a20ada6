"""Independent numpy FSIM oracle (piq.fsim algorithm, chromatic=False).

Self-contained port of the published FSIM algorithm (Zhang et al. 2011,
"FSIM: A Feature Similarity Index for Image Quality Assessment") with
piq's constants and structure (piq/fsim.py — scales=4, orientations=4,
min_length=6, mult=2, sigma_f=0.55, delta_theta=1.2, k=2.0; Kovesi PC2
phase congruency INCLUDING the phase-deviation |A sin| term; Scharr
gradients; T1=0.85, T2=160; PC-max weighted pooling).

A copy of the JAX package's `metrics/fsim_oracle.py`. Exists as the
verification oracle for the tensor implementation
(`metrics/extended.py:fsim_per_image`): the port's tests hold it to this
oracle with the bound the JAX package's own FSIM test uses. NOT a
compute-path module: plain numpy, host-only.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def _log_gabor_bank_np(
    h: int,
    w: int,
    scales: int = 4,
    orientations: int = 4,
    min_length: int = 6,
    mult: float = 2.0,
    sigma_f: float = 0.55,
    delta_theta: float = 1.2,
) -> np.ndarray:
    """(orientations, scales, h, w) frequency-domain log-Gabor filters."""
    fy = np.fft.fftfreq(h)[:, None].astype(np.float64)
    fx = np.fft.fftfreq(w)[None, :].astype(np.float64)
    r = np.sqrt(fx**2 + fy**2)
    theta = np.arctan2(-fy, fx)
    r[0, 0] = 1.0

    lowpass = 1.0 / (1.0 + (r / 0.45) ** 30)
    radials = []
    for s in range(scales):
        f0 = 1.0 / (min_length * mult**s)
        rad = np.exp(-(np.log(r / f0) ** 2) / (2.0 * np.log(sigma_f) ** 2))
        rad = rad * lowpass
        rad[0, 0] = 0.0
        radials.append(rad)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    theta_sigma = np.pi / orientations / delta_theta
    bank = np.empty((orientations, scales, h, w), np.float64)
    for o in range(orientations):
        angle = o * np.pi / orientations
        ds = sin_t * np.cos(angle) - cos_t * np.sin(angle)
        dc = cos_t * np.cos(angle) + sin_t * np.sin(angle)
        dtheta = np.abs(np.arctan2(ds, dc))
        spread = np.exp(-(dtheta**2) / (2.0 * theta_sigma**2))
        for s in range(scales):
            bank[o, s] = radials[s] * spread
    return bank


def _phase_congruency_np(
    img: np.ndarray,
    scales: int = 4,
    orientations: int = 4,
    min_length: int = 6,
    mult: float = 2.0,
    k: float = 2.0,
) -> np.ndarray:
    """Kovesi PC2 map for one 2-D image — full formula with the
    phase-deviation |A sin(phi - phibar)| term (piq semantics)."""
    h, w = img.shape
    bank = _log_gabor_bank_np(h, w, scales, orientations, min_length, mult)
    imfft = np.fft.fft2(img.astype(np.float64))

    pc = np.zeros((h, w))
    for o in range(orientations):
        eo = np.fft.ifft2(imfft[None] * bank[o])  # (scales, h, w) complex
        even, odd = eo.real, eo.imag
        an = np.abs(eo)
        sum_e, sum_o, sum_an = even.sum(0), odd.sum(0), an.sum(0)

        x_energy = np.sqrt(sum_e**2 + sum_o**2) + EPS
        mean_e, mean_o = sum_e / x_energy, sum_o / x_energy
        # PC2 energy: sum_s A_s cos(phi_s - phibar) - |A_s sin(phi_s - phibar)|
        energy = (
            even * mean_e + odd * mean_o - np.abs(even * mean_o - odd * mean_e)
        ).sum(0)

        # Rayleigh noise threshold from the smallest-scale response
        tau = np.median(an[0]) / np.sqrt(np.log(4.0))
        total_tau = tau * (1.0 - (1.0 / mult) ** scales) / (1.0 - 1.0 / mult)
        noise_mean = total_tau * np.sqrt(np.pi / 2.0)
        noise_sigma = total_tau * np.sqrt((4.0 - np.pi) / 2.0)
        T = noise_mean + k * noise_sigma

        pc += np.maximum(energy - T, 0.0) / (sum_an + EPS)
    return pc


_SCHARR = np.array(
    [[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]], np.float64
) / 16.0


def _conv2d_same_np(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Zero-padded same-size 2-D correlation (F.conv2d padding=1 semantics)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)))
    out = np.zeros_like(img, np.float64)
    for i in range(kh):
        for j in range(kw):
            out += kernel[i, j] * padded[i : i + img.shape[0], j : j + img.shape[1]]
    return out


def _gradient_magnitude_np(img: np.ndarray) -> np.ndarray:
    gx = _conv2d_same_np(img, _SCHARR)
    gy = _conv2d_same_np(img, _SCHARR.T)
    return np.sqrt(gx**2 + gy**2)


def fsim_oracle(
    preds: np.ndarray,
    target: np.ndarray,
    data_range: float = 1.0,
    t1: float = 0.85,
    t2: float = 160.0,
) -> np.ndarray:
    """FSIM per image for NHWC single-channel stacks (piq semantics)."""
    x = np.asarray(preds, np.float64) / data_range * 255.0
    y = np.asarray(target, np.float64) / data_range * 255.0
    n, h, w, _ = x.shape

    kk = max(1, round(min(h, w) / 256))
    if kk > 1:
        hp, wp = (h // kk) * kk, (w // kk) * kk
        x = x[:, :hp, :wp, :].reshape(n, hp // kk, kk, wp // kk, kk, 1).mean(axis=(2, 4))
        y = y[:, :hp, :wp, :].reshape(n, hp // kk, kk, wp // kk, kk, 1).mean(axis=(2, 4))
    else:
        x, y = x[..., 0][..., None] * 1.0, y * 1.0

    out = np.empty((n,))
    for i in range(n):
        xi, yi = x[i, ..., 0], y[i, ..., 0]
        pc_x = _phase_congruency_np(xi)
        pc_y = _phase_congruency_np(yi)
        gx = _gradient_magnitude_np(xi)
        gy = _gradient_magnitude_np(yi)

        s_pc = (2.0 * pc_x * pc_y + t1) / (pc_x**2 + pc_y**2 + t1)
        s_g = (2.0 * gx * gy + t2) / (gx**2 + gy**2 + t2)
        s_l = s_pc * s_g
        pc_m = np.maximum(pc_x, pc_y)
        out[i] = (s_l * pc_m).sum() / max(pc_m.sum(), 1e-12)
    return out
