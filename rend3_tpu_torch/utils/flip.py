"""LDR NVIDIA FLIP perceptual image difference (numpy).

Behavioral port of the metric the reference test harness uses
(rend3-test/src/runner.rs:244-258, nv-flip crate), following the published
LDR-FLIP algorithm (Andersson et al. 2020): opponent-space CSF filtering,
Hunt-adjusted HyAB color difference with a perceptual remap, edge/point
feature differences, and the final per-pixel error
deltaE = deltaE_color ^ (1 - deltaE_feature) in [0, 1].
"""

from __future__ import annotations

import numpy as np

__all__ = ["flip", "flip_mean", "DEFAULT_PPD"]

DEFAULT_PPD = 67.02  # nv_flip::DEFAULT_PIXELS_PER_DEGREE


def _srgb_to_linear(c):
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


_RGB2XYZ = np.array(
    [
        [0.41238656, 0.35759149, 0.18045049],
        [0.21263682, 0.71518298, 0.0721802],
        [0.01933062, 0.11919716, 0.95037259],
    ]
)
_D65 = np.array([0.950428545, 1.0, 1.088900371])


def _linrgb_to_xyz(img):
    return img @ _RGB2XYZ.T


def _xyz_to_linrgb(img):
    return img @ np.linalg.inv(_RGB2XYZ).T


def _linrgb_to_ycxcz(img):
    xyz = _linrgb_to_xyz(img) / _D65
    y = 116.0 * xyz[..., 1] - 16.0
    cx = 500.0 * (xyz[..., 0] - xyz[..., 1])
    cz = 200.0 * (xyz[..., 1] - xyz[..., 2])
    return np.stack([y, cx, cz], axis=-1)


def _ycxcz_to_linrgb(img):
    yy = (img[..., 0] + 16.0) / 116.0
    x = img[..., 1] / 500.0 + yy
    z = yy - img[..., 2] / 200.0
    xyz = np.stack([x, yy, z], axis=-1) * _D65
    return _xyz_to_linrgb(xyz)


def _linrgb_to_lab(img):
    xyz = _linrgb_to_xyz(np.clip(img, 0.0, 1.0)) / _D65
    d = 6.0 / 29.0

    def f(t):
        return np.where(t > d ** 3, np.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1)


def _hunt(lab):
    """Hunt adjustment: scale chroma by luminance."""
    l = lab[..., 0:1]
    return np.concatenate([l, 0.01 * l * lab[..., 1:]], axis=-1)


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.sqrt((d[..., 1:] ** 2).sum(-1))


def _sep_filter(img, k1d):
    """Separable 2D convolution of a (H, W) image with edge replication."""
    r = len(k1d) // 2
    p = np.pad(img, ((r, r), (0, 0)), mode="edge")
    out = np.zeros_like(img, dtype=np.float64)
    for i, w in enumerate(k1d):
        out += w * p[i : i + img.shape[0]]
    p = np.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = np.zeros_like(img, dtype=np.float64)
    for i, w in enumerate(k1d):
        out2 += w * p[:, i : i + img.shape[1]]
    return out2


def _conv2(img, k2d):
    """Full 2D convolution with edge replication (small kernels)."""
    r = k2d.shape[0] // 2
    p = np.pad(img, ((r, r), (r, r)), mode="edge")
    out = np.zeros(img.shape, np.float64)
    kh, kw = k2d.shape
    for i in range(kh):
        for j in range(kw):
            out += k2d[i, j] * p[i : i + img.shape[0], j : j + img.shape[1]]
    return out


def _csf_kernel(a1, b1, a2, b2, ppd):
    """Spatial-domain CSF filter (sum of two Gaussians), normalized."""
    # radius in degrees for the widest Gaussian, then to pixels
    r_deg = 3.0 * np.sqrt(max(b1, b2) / (2.0 * np.pi ** 2))
    r = int(np.ceil(r_deg * ppd))
    xs = np.arange(-r, r + 1) / ppd
    g = lambda a, b: a * np.sqrt(np.pi / b) * np.exp(-np.pi ** 2 * xs ** 2 / b)
    k = g(a1, b1) + g(a2, b2)
    return k / k.sum()


def _gauss_and_derivs(sigma_px):
    r = int(np.ceil(3.0 * sigma_px))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(xs ** 2) / (2.0 * sigma_px ** 2))
    gx = -xs * g  # first derivative (unnormalized)
    gxx = (xs ** 2 / sigma_px ** 2 - 1.0) * g  # second derivative
    return g, gx, gxx


def flip(reference: np.ndarray, test: np.ndarray, ppd: float = DEFAULT_PPD) -> np.ndarray:
    """Per-pixel FLIP error map in [0, 1]; inputs (H, W, 3) u8 or [0,1] f32 sRGB."""
    def prep(img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float64) / 255.0
        img = img[..., :3].astype(np.float64)
        return _srgb_to_linear(img)

    ref, tst = prep(reference), prep(test)
    ycc_r, ycc_t = _linrgb_to_ycxcz(ref), _linrgb_to_ycxcz(tst)

    # --- color pipeline: per-channel CSF filtering in YCxCz ---
    params = {
        0: (1.0, 0.0047, 0.0, 1.0e-5),     # A (achromatic)
        1: (1.0, 0.0053, 0.0, 1.0e-5),     # RG
        2: (34.1, 0.04, 13.5, 0.025),      # BY
    }
    filt_r = np.empty_like(ycc_r)
    filt_t = np.empty_like(ycc_t)
    for c, (a1, b1, a2, b2) in params.items():
        k = _csf_kernel(a1, b1, a2, b2, ppd)
        filt_r[..., c] = _sep_filter(ycc_r[..., c], k)
        filt_t[..., c] = _sep_filter(ycc_t[..., c], k)
    lin_r = np.clip(_ycxcz_to_linrgb(filt_r), 0.0, 1.0)
    lin_t = np.clip(_ycxcz_to_linrgb(filt_t), 0.0, 1.0)

    hunt_r = _hunt(_linrgb_to_lab(lin_r))
    hunt_t = _hunt(_linrgb_to_lab(lin_t))
    delta_c = _hyab(hunt_r, hunt_t)

    # perceptual remap of the color difference
    green = _hunt(_linrgb_to_lab(np.array([[[0.0, 1.0, 0.0]]])))
    blue = _hunt(_linrgb_to_lab(np.array([[[0.0, 0.0, 1.0]]])))
    cmax = float(_hyab(green, blue)[0, 0])
    pc, pt = 0.4, 0.95
    delta_c = np.where(
        delta_c < pc * cmax,
        (pt / (pc * cmax)) * delta_c,
        pt + ((delta_c - pc * cmax) / ((1.0 - pc) * cmax)) * (1.0 - pt),
    )
    delta_c = np.clip(delta_c, 0.0, 1.0)

    # --- feature pipeline: edge / point differences on achromatic ---
    w = 0.082
    sigma = 0.5 * w * ppd
    g, gx, gxx = _gauss_and_derivs(sigma)
    y_r = (ycc_r[..., 0] + 16.0) / 116.0
    y_t = (ycc_t[..., 0] + 16.0) / 116.0

    def features(y):
        # separable: edge = d/dx ⊗ g, point = d2/dx2 ⊗ g (both axes)
        gn = g / g.sum()
        exn = gx / np.abs(gx).sum() * 2.0
        pxn = gxx / np.abs(gxx).sum() * 2.0
        ex = _conv2(y, np.outer(gn, exn))
        ey = _conv2(y, np.outer(exn, gn))
        px = _conv2(y, np.outer(gn, pxn))
        py = _conv2(y, np.outer(pxn, gn))
        edge = np.sqrt(ex ** 2 + ey ** 2)
        point = np.sqrt(px ** 2 + py ** 2)
        return edge, point

    er, pr = features(y_r)
    et, pt_ = features(y_t)
    qf = 0.5
    delta_f = np.maximum(np.abs(er - et), np.abs(pr - pt_))
    delta_f = np.clip(delta_f, 0.0, 1.0) ** qf

    return np.power(delta_c, 1.0 - delta_f)


def flip_mean(reference: np.ndarray, test: np.ndarray, ppd: float = DEFAULT_PPD) -> float:
    return float(flip(reference, test, ppd).mean())
