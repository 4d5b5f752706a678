"""Kernels P1-P3: the bf16 select-and-lerp probes of K4's TPU design.

Port of the kernel bodies of tools/probe_bf16_dot.py (P1),
tools/probe_bf16_kernel.py (P2) and tools/probe_bf16_real.py (P3). On the
TPU they probed which formulations of a bf16 one-hot matmul Mosaic lowers;
here each computes what its probe computes, through hand-written CUDA
kernels (csrc/probe_bf16.cu) on a card and the plain PyTorch versions below
on the CPU:

- `probe_dot` (P1, and P2 v1 / v2's dense dot): a^T b over dim 0 of both
  operands, operands in f32 or rounded to bf16, summed as a sequential fma
  over the rows in ascending order;
- `probe_reduce` (P2 v1 / v2): the x-weighted 128-lane sums per channel,
  written or added to the output;
- `probe_lerp` (P2 v3-v7, P3): a (tile, cell, flags) step list walked in
  order per tile, each selected band's pixels adding the two-hot y-lerp of
  their texel rows, then a 128-lane sum or an x-lerp.

The orders of operations are those XLA:CPU gives the JAX kernels in
interpret mode, found by bit-matching (ROADMAP §3): the dot's sequential
fma, and the 128-lane sum as four sequential 32-lane sums added in order.
A kernel and its plain version share them, so they agree bit for bit.
Outputs start from the caller's tensor (the probes fill it with NaN, as
interpret mode leaves unwritten output memory, or with zeros); the
wrappers return a new tensor and leave it as it was.
"""

from __future__ import annotations

from typing import Optional

import torch

from .deferred import fma32

__all__ = [
    "probe_dot", "probe_dot_plain", "probe_reduce", "probe_reduce_plain", "probe_lerp", "probe_lerp_plain",
    "lerp_launch_args", "LERP_BF16", "LERP_YCELL", "LERP_WAREA", "LERP_XLERP", "LERP_INIT", "LERP_GATE", "LANES", "OUT_ROWS",
]

LANES = 128     # lanes of one channel
CHANNELS = 4
OUT_ROWS = 8    # rows of an output block (the channels padded to 8)

# probe_lerp modes (csrc/probe_bf16.cu): bf16 texels and y-weights; ry, rx
# from int coords against the step's cell (P3), else rint(f[2] * (R - 8))
# and rint(f[0] * 120); y-weights w * (1 - fy), w * fy, else 1 - fy, fy;
# the x-lerp, else the 128-lane sum; bit 4 of a step's flags zeroes its
# tile; a step runs only if f[tile, 0, 0] < 1.
LERP_BF16, LERP_YCELL, LERP_WAREA, LERP_XLERP, LERP_INIT, LERP_GATE = 1, 2, 4, 8, 16, 32

# Launch counts of the CUDA kernels (plain-version runs do not count).
launches = {"probe_dot": 0, "probe_reduce": 0, "probe_lerp": 0}


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _check(*named):
    dev = named[0][1].device
    for name, t, dt in named:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
    return dev


def _lane_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 (128 lanes) in XLA:CPU's order: four sequential
    32-lane sums from 0, then those four in order from 0."""
    total = torch.zeros_like(terms[0])
    for blk in range(0, LANES, 32):
        s = torch.zeros_like(terms[0])
        for j in range(blk, blk + 32):
            s = s + terms[j]
        total = total + s
    return total


# ---------------------------------------------------------------------------
# P1: a^T b
# ---------------------------------------------------------------------------


def probe_dot_plain(a, b, *, bf16: bool, transposed: bool = False) -> torch.Tensor:
    """Plain version of probe_dot."""
    if transposed:
        a = a.T
    if bf16:
        a, b = _round_bf16(a), _round_bf16(b)
    acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32, device=a.device)
    for r in range(a.shape[0]):
        if bf16:
            # bf16 products are exact in f32: one add is the fma's one rounding.
            acc = acc + a[r][:, None] * b[r][None, :]
        else:
            acc = fma32(a[r][:, None], b[r][None, :], acc)
    return acc


def probe_dot(a, b, *, bf16: bool, transposed: bool = False) -> torch.Tensor:
    """P1: out (M, N) f32 = a^T b. a (K, M) f32, or (M, K) when
    `transposed` (the probe's transpose-first form); b (K, N) f32."""
    dev = _check(("a", a, torch.float32), ("b", b, torch.float32))
    K, M = (a.shape[1], a.shape[0]) if transposed else (a.shape[0], a.shape[1])
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != K:
        raise ValueError(f"probe_dot: a {tuple(a.shape)} and b {tuple(b.shape)} do not contract")
    if dev.type == "cpu":
        return probe_dot_plain(a, b, bf16=bf16, transposed=transposed)
    from . import cuda_kernels

    N = b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    cuda_kernels.call("p1_probe_dot", a, b, out, ints=(K, M, N, int(transposed), int(bf16)))
    launches["probe_dot"] += 1
    return out


# ---------------------------------------------------------------------------
# P2 v1 / v2: the x-weighted lane reduce
# ---------------------------------------------------------------------------


def probe_reduce_plain(r2, x, out, *, accumulate: bool) -> torch.Tensor:
    """Plain version of probe_reduce."""
    res = out.clone()
    for c in range(CHANNELS):
        v = _lane_sum(x * r2[c * LANES : (c + 1) * LANES])
        res[c] = res[c] + v if accumulate else v
    return res


def probe_reduce(r2, x, out, *, accumulate: bool) -> torch.Tensor:
    """P2 v1 / v2: per channel c < 4 and column p, sum_j x[j, p] *
    r2[128c + j, p], written to (or, with `accumulate`, added to) row c of a
    copy of `out` (8, n). r2 (512, n), x (128, n), all f32."""
    dev = _check(("r2", r2, torch.float32), ("x", x, torch.float32), ("out", out, torch.float32))
    n = r2.shape[1]
    if r2.shape != (CHANNELS * LANES, n) or x.shape != (LANES, n) or out.shape != (OUT_ROWS, n):
        raise ValueError(f"probe_reduce: shapes {tuple(r2.shape)}, {tuple(x.shape)}, {tuple(out.shape)}")
    if dev.type == "cpu":
        return probe_reduce_plain(r2, x, out, accumulate=accumulate)
    from . import cuda_kernels

    res = out.clone()
    cuda_kernels.call("p2_probe_reduce", r2, x, res, ints=(n, int(accumulate)))
    launches["probe_reduce"] += 1
    return res


# ---------------------------------------------------------------------------
# P2 v3-v7, P3: the step-list lerp
# ---------------------------------------------------------------------------


def probe_lerp_plain(t, f, coords, st, sc, sf, out, *, mode: int, npb: int, gx: int = 1, lt: int = 0,
                     hs: int = 0, ws: int = 0) -> torch.Tensor:
    """Plain version of probe_lerp: the steps in order, each selected band
    as one vectorised update."""
    res = out.clone()
    R = t.shape[1]
    npx = f.shape[2]
    bf16 = bool(mode & LERP_BF16)
    tt = _round_bf16(t) if bf16 else t
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    for T, cell, fl in zip(st.tolist(), sc.tolist(), sf.tolist()):
        if mode & LERP_INIT and (fl >> 4) & 1:
            res[T] = 0.0
        if mode & LERP_GATE and not bool(f[T, 0, 0] < 1.0):
            continue
        tc = tt[cell]
        for band in range(npx // npb):
            if not (fl >> band) & 1:
                continue
            sl = slice(band * npb, (band + 1) * npb)
            f0, f1, f2 = f[T, 0, sl], f[T, 1, sl], f[T, 2, sl]
            if mode & LERP_YCELL:
                cy = cell // gx
                cx = cell - cy * gx
                bx, by = coords[T, 0, sl], coords[T, 1, sl]
                rel_x, rel_y = bx - cx * lt, by - cy * lt
                own = ((rel_y >= 0) & (rel_y < lt) & (rel_x >= 0) & (rel_x < lt)
                       & (bx >= 0) & (bx + 1 < ws) & (by >= 0) & (by + 1 < hs))
                ry = torch.where(own, rel_y, torch.full_like(rel_y, -2)).long()
                rx = torch.where(own, rel_x, torch.full_like(rel_x, -2)).long()
                w = torch.where(own, f2, zero)
            else:
                ry = torch.round(f2 * float(R - 8)).long()
                rx = torch.round(f0 * float(LANES - 8)).long()
                w = f2
            one_m = one - f1
            wlo, whi = (w * one_m, w * f1) if mode & LERP_WAREA else (one_m, f1)
            if bf16:
                wlo, whi = _round_bf16(wlo), _round_bf16(whi)
            lo_ok = (ry >= 0) & (ry < R)
            hi_ok = (ry + 1 >= 0) & (ry + 1 < R)
            ry_lo, ry_hi = ry.clamp(0, R - 1), (ry + 1).clamp(0, R - 1)

            def rcol(cols):
                """Two-hot dot columns `cols` (npb, k) of each pixel."""
                p0 = torch.where(lo_ok[:, None], tc[ry_lo[:, None], cols] * wlo[:, None], zero)
                hv = tc[ry_hi[:, None], cols]
                # bf16: exact products, so one add is the fma's one rounding.
                acc = p0 + hv * whi[:, None] if bf16 else fma32(hv, whi[:, None], p0)
                return torch.where(hi_ok[:, None], acc, p0)

            vals = []
            for c in range(CHANNELS):
                c0 = c * LANES
                if mode & LERP_XLERP:
                    ia, ib = rx, rx + 1
                    okb = (ib >= 0) & (ib < LANES)
                    oka = (ia >= 0) & (ia < LANES)
                    cols = torch.stack([ia.clamp(0, LANES - 1), ib.clamp(0, LANES - 1)], 1) + c0
                    rc = rcol(cols)
                    a = torch.where(oka, (one - f0) * rc[:, 0], zero)
                    b = torch.where(okb, f0 * rc[:, 1], zero)
                    vals.append((zero + a) + b)
                else:
                    cols = torch.arange(c0, c0 + LANES, device=t.device).expand(ry.shape[0], LANES)
                    vals.append(_lane_sum(rcol(cols).T))
            res[T, :CHANNELS, sl] = res[T, :CHANNELS, sl] + torch.stack(vals)
    return res


def lerp_launch_args(t, f, coords, st, sc, sf, out, *, mode: int, npb: int, gx: int = 1, lt: int = 0, hs: int = 0,
                     ws: int = 0):
    """(tensors, ints) of the CUDA launch `p3_probe_lerp` for probe_lerp's
    arguments, with `out` the tensor the kernel updates in place."""
    return ((t, f, coords if mode & LERP_YCELL else None, st, sc, sf, out),
            (f.shape[0], t.shape[1], f.shape[2], npb, st.shape[0], gx, lt, hs, ws, mode))


def probe_lerp(t, f, coords: Optional[torch.Tensor], st, sc, sf, out, *, mode: int, npb: int, gx: int = 1,
               lt: int = 0, hs: int = 0, ws: int = 0) -> torch.Tensor:
    """P2 v3-v7 / P3: the S steps (st tile, sc cell, sf flags, int32) walked
    in order over a copy of `out` (nT, 8, npx) f32. t (cells, R, 512) f32
    texel rows; f (nT, 3, npx) f32 rows (fx or the gate, fy, w or the ry
    source); coords (nT, 2, npx) int32 base texels (LERP_YCELL only), with
    the cell grid width gx, cell size lt and the source bounds hs, ws. Bits
    0-3 of a step's flags select its bands of npb pixels."""
    named = [("t", t, torch.float32), ("f", f, torch.float32), ("st", st, torch.int32),
             ("sc", sc, torch.int32), ("sf", sf, torch.int32), ("out", out, torch.float32)]
    if mode & LERP_YCELL:
        if coords is None:
            raise ValueError("probe_lerp: the cell mode needs coords")
        named.append(("coords", coords, torch.int32))
    dev = _check(*named)
    nT, _three, npx = f.shape
    S = st.shape[0]
    if (t.dim() != 3 or t.shape[2] != CHANNELS * LANES or f.shape[1] != 3 or out.shape != (nT, OUT_ROWS, npx)
            or sc.shape != (S,) or sf.shape != (S,) or npx % npb or npx // npb > 4):
        raise ValueError(f"probe_lerp: shapes t {tuple(t.shape)}, f {tuple(f.shape)}, out {tuple(out.shape)}")
    if S and (int(sc.min()) < 0 or int(sc.max()) >= t.shape[0]):
        raise ValueError("probe_lerp: a step's cell lies outside t")
    if dev.type == "cpu":
        return probe_lerp_plain(t, f, coords, st, sc, sf, out, mode=mode, npb=npb, gx=gx, lt=lt, hs=hs, ws=ws)
    from . import cuda_kernels

    res = out.clone()
    tensors, ints = lerp_launch_args(t, f, coords, st, sc, sf, res, mode=mode, npb=npb, gx=gx, lt=lt, hs=hs, ws=ws)
    cuda_kernels.call("p3_probe_lerp", *tensors, ints=ints)
    launches["probe_lerp"] += 1
    return res
