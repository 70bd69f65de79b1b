"""Quality metrics: PSNR / SSIM / flow EPE / VFID: a copy of
``vsr_tpu/utils/metrics.py``.

Parity with the reference eval code (backend/inpaint/video/core/metrics.py:
20-55 and :12): PSNR over [0,255] images, SSIM with data_range=255 and the
reference's win_size=65 gaussian-free uniform window (skimage
compare_ssim semantics), mean end-point error for flow.

Pure numpy — used by the bench/parity harness, never on the hot path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray, data_range: float = 255.0) -> float:
    """PSNR over [0, data_range] images (metrics.py:20-37)."""
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(data_range / np.sqrt(mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable moving average with 'same' size (reflect-free crop handled
    by the valid-region slice in ssim())."""
    kernel = np.ones(size) / size
    out = x
    for axis in (0, 1):
        out = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), axis, out)
    return out


def ssim(
    img1: np.ndarray,
    img2: np.ndarray,
    data_range: float = 255.0,
    win_size: int = 65,
) -> float:
    """Structural similarity, skimage-compatible (uniform window, K1=.01,
    K2=.03, sample covariance normalization), channels averaged.
    """
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    assert a.shape == b.shape
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if min(a.shape[0], a.shape[1]) < win_size:
        win_size = min(a.shape[0], a.shape[1])
        if win_size % 2 == 0:
            win_size -= 1
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    vals = []
    pad = win_size // 2
    for c in range(a.shape[2]):
        x, y = a[..., c], b[..., c]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1 = 2 * ux * uy + C1
        A2 = 2 * vxy + C2
        B1 = ux ** 2 + uy ** 2 + C1
        B2 = vx + vy + C2
        S = (A1 * A2) / (B1 * B2)
        valid = S[pad : S.shape[0] - pad, pad : S.shape[1] - pad]
        vals.append(valid.mean() if valid.size else S.mean())
    return float(np.mean(vals))


def psnr_and_ssim(img1: np.ndarray, img2: np.ndarray) -> Tuple[float, float]:
    return psnr(img1, img2), ssim(img1, img2)


def flow_epe(flow_pred: np.ndarray, flow_gt: np.ndarray) -> float:
    """Mean end-point error over [..., 2] flow fields (metrics.py:12)."""
    return float(np.mean(np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=-1))))


def frechet_distance(
    real_activations: np.ndarray, fake_activations: np.ndarray, eps: float = 1e-6
) -> float:
    """Frechet distance between activation Gaussians (VFID,
    metrics.py:85-151). activations: [N, D] feature rows."""
    import scipy.linalg

    mu1 = real_activations.mean(axis=0)
    mu2 = fake_activations.mean(axis=0)
    sigma1 = np.cov(real_activations, rowvar=False)
    sigma2 = np.cov(fake_activations, rowvar=False)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def vfid(real_videos, fake_videos, i3d_apply) -> float:
    """Video FID: I3D features of real/fake clips -> Frechet distance.

    real/fake_videos: [N, T, H, W, 3] in [-1, 1]; i3d_apply: callable
    returning [N, 1024] features, numpy or a CPU tensor (the port's
    models/i3d.InceptionI3d in eval mode, e.g. ``lambda v:
    i3d(torch.from_numpy(v).to(dev)).cpu()`` under ``torch.no_grad()``)."""
    real = np.asarray(i3d_apply(real_videos))
    fake = np.asarray(i3d_apply(fake_videos))
    return frechet_distance(real, fake)
