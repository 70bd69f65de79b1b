"""Host-side Canny edge targets for the flow-completion trainer: a copy of
``vsr_tpu/train/canny.py``.

The reference trains its flow-completion edge head against Canny edges of
the normalized flow magnitude, computed by an in-graph differentiable Canny
(backend/inpaint/video/core/trainer_flow_w_edge.py:60,261-273 with
model/canny/canny_filter.py — kornia's algorithm: 5x5 gaussian sigma 2,
unnormalized 3x3 sobel, 45-degree-quantized non-max suppression, double
threshold 0.1/0.2, iterative hysteresis). The targets take no gradients, so
this port runs on host numpy/cv2 with the SAME math; the fixpoint hysteresis
is an iterative strong-into-weak dilation instead of a conv loop (provably
the same fixpoint: each sweep promotes exactly the weak pixels with a strong
8-neighbor). Parity vs the executed reference torch Canny is asserted in
tests/test_propainter_trainer.py.
"""

from __future__ import annotations

import numpy as np

_SOBEL_X = np.array(
    [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
_SOBEL_Y = _SOBEL_X.T

# NMS direction k compares against the neighbor at offset (dy, dx); order
# matches get_canny_nms_kernel (model/canny/kernels.py:604-621): the angle
# index (round(angle/45) % 8) selects the along-gradient neighbor pair
_NMS_OFFSETS = ((0, 1), (1, 1), (1, 0), (1, -1),
                (0, -1), (-1, -1), (-1, 0), (-1, 1))


def _shift(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Shifted copy with zero fill — the zero-padded conv2d neighbor read."""
    out = np.zeros_like(img)
    h, w = img.shape[-2:]
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = img[..., ys, xs]
    return out


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    # kernels.py:16-25 (odd ksize path) — normalized to sum 1
    x = np.arange(ksize, dtype=np.float32) - ksize // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(img: np.ndarray, ksize=(5, 5), sigma=(2.0, 2.0)):
    """Separable gaussian, 'reflect' border (gaussian.py:10-52).

    torch F.pad(mode='reflect') == cv2.BORDER_REFLECT_101; cv2.sepFilter2D
    correlates, matching filter2d's un-flipped conv2d."""
    import cv2

    ky = _gaussian_kernel1d(ksize[0], sigma[0])
    kx = _gaussian_kernel1d(ksize[1], sigma[1])
    return cv2.sepFilter2D(img.astype(np.float32), -1, kx, ky,
                           borderType=cv2.BORDER_REFLECT_101)


def _spatial_gradient(img: np.ndarray):
    """Unnormalized 3x3 sobel, replicate border (sobel.py:8-55 with
    normalized=False; the conv3d kernel flip there is a size-1-dim no-op, so
    it is a correlation — cv2.filter2D's convention)."""
    import cv2

    gx = cv2.filter2D(img, -1, _SOBEL_X, borderType=cv2.BORDER_REPLICATE)
    gy = cv2.filter2D(img, -1, _SOBEL_Y, borderType=cv2.BORDER_REPLICATE)
    return gx, gy


def canny_host(img: np.ndarray, low_threshold: float = 0.1,
               high_threshold: float = 0.2, kernel_size=(5, 5),
               sigma=(2.0, 2.0), hysteresis: bool = True, eps: float = 1e-6):
    """Exact kornia-Canny (canny_filter.py:38-175) on one [H, W] float image.

    Returns (magnitude, edges) — edges binary {0, 1} after hysteresis (or
    {0, 0.5, 1} weak/strong when hysteresis=False)."""
    blurred = _gaussian_blur(img, kernel_size, sigma)
    gx, gy = _spatial_gradient(blurred)
    magnitude = np.sqrt(gx * gx + gy * gy + eps)
    angle = np.degrees(np.arctan2(gy, gx))

    # canny_filter.py:129-143 — along-gradient non-max suppression via the
    # 8 shifted-difference maps (zero-padded conv semantics)
    nms = np.stack([magnitude - _shift(magnitude, dy, dx)
                    for dy, dx in _NMS_OFFSETS])
    # round-half-to-even in both torch.round and np.round
    pos_idx = (np.round(angle / 45.0) % 8).astype(np.int64)
    neg_idx = (pos_idx + 4) % 8
    take = np.take_along_axis(nms, pos_idx[None], axis=0)[0]
    take_n = np.take_along_axis(nms, neg_idx[None], axis=0)[0]
    is_max = np.minimum(take, take_n) > 0.0
    magnitude = magnitude * is_max

    low = magnitude > low_threshold
    high = magnitude > high_threshold
    edges = low * 0.5 + high * 0.5
    if not hysteresis:
        return magnitude, edges.astype(np.float32)

    # canny_filter.py:157-175 fixpoint: weak (0.5) pixels 8-adjacent to a
    # strong (1.0) pixel become strong; weak pixels never reached become 0
    strong = high
    weak = low & ~high
    while True:
        neigh = np.zeros_like(strong)
        for dy, dx in _NMS_OFFSETS:
            neigh |= _shift(strong, dy, dx)
        promoted = strong | (neigh & weak)
        if promoted.sum() == strong.sum():
            break
        strong = promoted
    return magnitude, strong.astype(np.float32)


def flow_edges_host(flows: np.ndarray, low_threshold: float = 0.1,
                    high_threshold: float = 0.2) -> np.ndarray:
    """[..., H, W, 2] flows -> [..., H, W, 1] binary Canny edge targets.

    Reference get_edges (trainer_flow_w_edge.py:261-273): flow magnitude,
    normalized by the GLOBAL max over the whole batch (zeroed when the max
    is < 1), then Canny(sigma=(2,2), low 0.1, high 0.2)."""
    shape = flows.shape
    flat = flows.reshape(-1, *shape[-3:]).astype(np.float32)
    gray = np.sqrt((flat ** 2).sum(-1))
    gmax = gray.max()
    if gmax < 1.0:
        gray = np.zeros_like(gray)
    else:
        gray = gray / gmax
    edges = np.stack([
        canny_host(g, low_threshold, high_threshold)[1] for g in gray])
    return edges.reshape(*shape[:-1], 1)
