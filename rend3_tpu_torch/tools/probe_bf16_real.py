"""P3: K4's kernel body at a small scale, from tools/probe_bf16_real.py, on the card.

A 64x256 target in four 32x128 tiles, 16 cells of 72 texel rows by 512
lanes (a 4x4 grid of 64x64 cells over a 256x256 source), and S = 5 * 4 +
16 * 8 = 148 steps of random (tile, cell, flags). Bit 4 of a step's flags
zeroes its tile (the init branch); bits 0-3 select its bands. Per selected
pixel: the `own` test of its base texel against the cell and the 256x256
bounds, the two-hot y-lerp (weights w * (1 - fy), w * fy), the x-lerp, all
through kernel probe_lerp (ops/probe_bf16.py). The variants remove one
piece each, as the JAX probe's flags do. Inputs come from
numpy's default_rng(seed) in the JAX probe's order.

Usage: python3 -m rend3_tpu_torch.tools.probe_bf16_real
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import probe_bf16 as pb
from . import ProbeRun, device_for, init_out

__all__ = ["VARIANTS", "build", "run"]

STILE_H, STILE_W, LT = 32, 128, 64
N_BANDS, BAND_H = 4, 8


def build(name, device="cuda", *, bf16=True, ohx_lerp=True, int_coords=True, w_area_in_ohy=True,
          init_branch=True, seed=0, init="nan") -> ProbeRun:
    """One variant (the JAX probe's build flags), run once."""
    dev = device_for(device)
    C, R = 4, 72
    Hs = Ws = 256
    H, W = 64, 256
    Gx = Gy = 4
    nT = (H // STILE_H) * (W // STILE_W)
    npx = STILE_H * STILE_W
    npb = BAND_H * STILE_W
    cap = 8
    rng = np.random.default_rng(seed)
    S = 5 * nT + 16 * cap

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    tiles = up(rng.random((Gy * Gx, R, C * STILE_W), np.float32), torch.float32)
    st = up(rng.integers(0, nT, S), torch.int32)
    spid = up(rng.integers(0, Gy * Gx, S), torch.int32)
    sflags = up(rng.integers(0, 32, S), torch.int32)
    coords = up(rng.integers(0, 250, (nT, 2, npx)), torch.int32)
    fracs = up(rng.random((nT, 3, npx), np.float32), torch.float32)
    mode = ((pb.LERP_BF16 if bf16 else 0) | (pb.LERP_YCELL if int_coords else 0)
            | (pb.LERP_WAREA if w_area_in_ohy else 0) | (pb.LERP_XLERP if ohx_lerp else 0)
            | (pb.LERP_INIT if init_branch else 0))
    out0 = init_out((nT, pb.OUT_ROWS, npx), init, dev)
    kw = dict(mode=mode, npb=npb, gx=Gx, lt=LT, hs=Hs, ws=Ws)

    def plain():
        return pb.probe_lerp_plain(tiles, fracs, coords, st, spid, sflags, out0, **kw)

    args = {"t": tiles, "f": fracs, "coords": coords, "st": st, "sc": spid, "sf": sflags, "out": out0, **kw}
    return ProbeRun(name, ("probe_lerp",), pb.probe_lerp(tiles, fracs, coords, st, spid, sflags, out0, **kw),
                    plain, "", args)


VARIANTS = (
    ("full f32", dict(bf16=False)),
    ("full bf16", dict()),
    ("bf16 no-ohx-lerp", dict(ohx_lerp=False)),
    ("bf16 no-int-coords", dict(int_coords=False)),
    ("bf16 no-w-area", dict(w_area_in_ohy=False)),
    ("bf16 no-init", dict(init_branch=False)),
)


def run(device="cuda", seed=0, init="nan", log=print):
    """Every variant of the JAX probe's main; logs `name: OK` per variant
    and returns the runs."""
    runs = []
    for name, kw in VARIANTS:
        r = build(name, device, seed=seed, init=init, **kw)
        log(f"{r.name}: OK{r.note}")
        runs.append(r)
    return runs


if __name__ == "__main__":
    run()
