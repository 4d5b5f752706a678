"""Image comparison metrics for golden tests.

The reference uses nv-flip perceptual diff (rend3-test/src/runner.rs:227-290);
here we provide MAE + SSIM against the wgpu reference renders, plus a simple
perceptual mean diff in linearized color space (utils/flip.py has FLIP).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mae", "ssim", "compare_images"]


def _to_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float64) / 255.0
    return img.astype(np.float64)


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(_to_float(a) - _to_float(b)).mean())


def ssim(a: np.ndarray, b: np.ndarray, *, data_range: float = 1.0) -> float:
    """Global-window grayscale SSIM with an 8x8 sliding window (uniform)."""
    a = _to_float(a)
    b = _to_float(b)
    if a.ndim == 3:
        a = a[..., :3].mean(axis=-1)
        b = b[..., :3].mean(axis=-1)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    win = 8

    def _filter(x):
        # Uniform box filter via cumulative sums.
        c = np.cumsum(np.cumsum(x, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        h, w = x.shape
        n = win
        out = (
            c[n : h + 1, n : w + 1]
            - c[0 : h + 1 - n, n : w + 1]
            - c[n : h + 1, 0 : w + 1 - n]
            + c[0 : h + 1 - n, 0 : w + 1 - n]
        ) / (n * n)
        return out

    mu_a = _filter(a)
    mu_b = _filter(b)
    var_a = _filter(a * a) - mu_a**2
    var_b = _filter(b * b) - mu_b**2
    cov = _filter(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float((num / den).mean())


def compare_images(test: np.ndarray, golden: np.ndarray) -> dict:
    t = _to_float(test)[..., :3]
    g = _to_float(golden)[..., :3]
    assert t.shape == g.shape, f"shape mismatch {t.shape} vs {g.shape}"
    diff = np.abs(t - g)
    return {
        "mae": float(diff.mean()),
        "max": float(diff.max()),
        "p99": float(np.percentile(diff, 99)),
        "ssim": ssim(t, g),
        "bad_pixel_frac": float((diff.max(axis=-1) > 0.05).mean()),
    }
