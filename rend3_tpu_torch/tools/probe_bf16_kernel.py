"""P2: the context-bisect variants of tools/probe_bf16_kernel.py on the card.

Each JAX variant added back one piece of K4's kernel around the bf16 dot;
each computes, per channel c < 4 and pixel p,
sum_j wx[j, p] * sum_r t[r, 128c + j] * wy[r, p]:

- v1 / v2: dense random wy and wx; the dot through kernel P1 (probe_dot),
  then the x-weighted lane sums (probe_reduce), written (v1) or added to
  the output (v2);
- v3-v6: wy two-hot at round(f2 * (R - 8)) with 1 - fy / fy, wx all ones,
  four bands of NPB pixels, gated on f[0, 0] < 1 and added to the output
  (probe_lerp); the hoisted cast, the transposed product and the padded
  contraction of v4-v6 compute the same values as v3;
- v7: v3's body over a 16-step (tile, cell) list with bf16 or f32 operands.

v2-v7 add to outputs they never initialise; the output starts as `init`
(NaN, as interpret mode leaves it, by default).

Usage: python3 -m rend3_tpu_torch.tools.probe_bf16_kernel
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import probe_bf16 as pb
from . import ProbeRun, device_for, init_out

__all__ = ["R", "CW", "NPB", "NPX", "VARIANTS", "variant", "run"]

R, CW, NPB, C = 72, 512, 1024, 4
NPX = 4096  # full tile pixels (4 bands x 1024)


def _rand(rng, *shape, device):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)


def _dense(name, rng, device, init, accumulate):
    t = _rand(rng, R, CW, device=device)
    y = _rand(rng, R, NPB, device=device)
    x = _rand(rng, 128, NPB, device=device)
    out0 = init_out((pb.OUT_ROWS, NPB), init, device)

    def plain():
        return pb.probe_reduce_plain(pb.probe_dot_plain(t, y, bf16=True), x, out0, accumulate=accumulate)

    out = pb.probe_reduce(pb.probe_dot(t, y, bf16=True), x, out0, accumulate=accumulate)
    return ProbeRun(name, ("probe_dot", "probe_reduce"), out, plain, "", {"t": t, "y": y, "x": x, "out": out0})


def _lerp(name, t, f, st, sc, sf, mode, init, squeeze):
    """One probe_lerp launch over a fresh `init` output, squeezed to the
    first tile's block for the single-tile variants."""
    out0 = init_out((f.shape[0], pb.OUT_ROWS, NPX), init, f.device)

    def plain():
        o = pb.probe_lerp_plain(t, f, None, st, sc, sf, out0, mode=mode, npb=NPB)
        return o[0] if squeeze else o

    out = pb.probe_lerp(t, f, None, st, sc, sf, out0, mode=mode, npb=NPB)
    args = {"t": t, "f": f, "st": st, "sc": sc, "sf": sf, "out": out0, "mode": mode, "npb": NPB}
    return ProbeRun(name, ("probe_lerp",), out[0] if squeeze else out, plain, "", args)


def _banded(name, rng, device, init):
    """v3-v6: one step over tile 0 and cell 0, all four bands."""
    t = _rand(rng, R, CW, device=device)[None]
    f = _rand(rng, 3, NPX, device=device)[None]
    one = torch.zeros(1, dtype=torch.int32, device=device)
    flags = torch.full((1,), 15, dtype=torch.int32, device=device)
    return _lerp(name, t, f, one, one, flags, pb.LERP_BF16 | pb.LERP_GATE, init, True)


def _grid(name, rng, device, init, bf16):
    """v7: 16 steps over 8 tiles and 4 cells, run where the cell id >= 0."""
    nT, S, n_cells = 8, 16, 4
    st = torch.arange(S, dtype=torch.int32, device=device) % nT
    sp = torch.arange(S, dtype=torch.int32, device=device) % n_cells
    t = _rand(rng, n_cells, R, CW, device=device)
    f = _rand(rng, nT, 3, NPX, device=device)
    flags = torch.where(sp >= 0, 15, 0).to(torch.int32)
    return _lerp(name, t, f, st, sp, flags, pb.LERP_BF16 if bf16 else 0, init, False)


VARIANTS = (
    ("v1 dot+slice+reduce", lambda n, rng, d, i: _dense(n, rng, d, i, False)),
    ("v2 +accumulate", lambda n, rng, d, i: _dense(n, rng, d, i, True)),
    ("v3 +when/bands (kernel shape)", _banded),
    ("v4 hoisted lhs cast", _banded),
    ("v5 transposed matmul", _banded),
    ("v6 pad contraction to 128", _banded),
    ("v7 grid+prefetch bf16", lambda n, rng, d, i: _grid(n, rng, d, i, True)),
    ("v7 grid+prefetch f32", lambda n, rng, d, i: _grid(n, rng, d, i, False)),
)


def variant(k: int, rng, device="cuda", init="nan") -> ProbeRun:
    """Variant k of VARIANTS with inputs drawn from `rng` in the JAX
    variant's order."""
    name, fn = VARIANTS[k]
    return fn(name, rng, device_for(device), init)


def run(device="cuda", seed=0, init="nan", log=print):
    """Every variant, inputs from one RandomState(seed) in the JAX probe's
    order; logs `name: OK` per variant and returns the runs."""
    dev = device_for(device)
    rng = np.random.RandomState(seed)
    runs = []
    for k in range(len(VARIANTS)):
        r = variant(k, rng, dev, init)
        log(f"{r.name}: OK{r.note}")
        runs.append(r)
    return runs


if __name__ == "__main__":
    run()
