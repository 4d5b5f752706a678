"""P1: the bf16 dot of tools/probe_bf16_dot.py on the card.

(R, CW) x (R, NPB) -> (CW, NPB), contracting dim 0 of both operands, in
four formulations: f32 operands, bf16 operands, bf16 with the lhs
transposed first, bf16 with the contraction padded to 128 rows. All go
through kernel P1 (ops/probe_bf16.probe_dot); each line prints the max
error against the f32 a^T b, as the JAX probe does.

Usage: python3 -m rend3_tpu_torch.tools.probe_bf16_dot
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import probe_bf16 as pb
from . import ProbeRun, device_for

__all__ = ["R", "CW", "NPB", "VARIANTS", "run"]

R, CW, NPB = 72, 512, 1024


def _variant(name, rng, device, *, bf16=True, transposed=False, pad=None) -> ProbeRun:
    """Draws a, then b, as the JAX probe's run() does, and runs P1."""
    a = torch.from_numpy(rng.rand(R, CW).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.rand(R, NPB).astype(np.float32)).to(device)
    ref = torch.matmul(a.T, b)  # the probe's f32 yardstick (TF32 is off in the package)
    ka, kb = a, b
    if pad is not None:
        ka, kb = (torch.nn.functional.pad(v, (0, 0, 0, pad - R)) for v in (a, b))
    if transposed:
        ka = ka.T.contiguous()

    def plain():
        return pb.probe_dot_plain(ka, kb, bf16=bf16, transposed=transposed)

    out = pb.probe_dot(ka, kb, bf16=bf16, transposed=transposed)
    return ProbeRun(name, ("probe_dot",), out, plain, f", max err {float((out - ref).abs().max()):.5f}",
                    {"a": ka, "b": kb})


VARIANTS = (
    ("f32 (0,0) contraction", dict(bf16=False)),
    ("bf16 (0,0) contraction", dict()),
    ("bf16 transpose-first", dict(transposed=True)),
    ("bf16 pad-to-128", dict(pad=128)),
)


def variant(k: int, rng, device="cuda") -> ProbeRun:
    """Variant k of VARIANTS with inputs drawn from `rng`."""
    name, kw = VARIANTS[k]
    return _variant(name, rng, device_for(device), **kw)


def run(device="cuda", seed=0, log=print):
    """Every variant, inputs from one RandomState(seed) in the JAX probe's
    order; logs `name: OK, max err e` per variant and returns the runs."""
    dev = device_for(device)
    rng = np.random.RandomState(seed)
    runs = []
    for k in range(len(VARIANTS)):
        r = variant(k, rng, dev)
        log(f"{r.name}: OK{r.note}")
        runs.append(r)
    return runs


if __name__ == "__main__":
    run()
