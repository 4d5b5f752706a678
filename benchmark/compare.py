"""The comparison that decides `correct`: the port's images against the
reference's, frame by frame.

Two numbers per frame, each held to a limit in LIMITS (their readings are in
PERF.md):

- `bad_px_pct`: the share of pixels, in percent, whose largest colour
  channel differs by more than BAD_U8 u8 levels. Rounding (bf16 texels,
  fused products, another order of sums) moves a channel by a level or two;
  a pixel past BAD_U8 saw another surface, another shadow texel or another
  alpha-test outcome.
- `mean_abs_u8`: the mean of that difference over the colour channels of
  every pixel, which catches a small shift spread over the whole frame
  (lighting, tonemapping) that no single pixel shows.

A run's reading of each number is its worst frame's. Where the scene leaves
the answer to rounding (two surfaces at one depth within a tie, a shadow
tap at its texel's depth), the reference gives both answers and the port's
value is measured from the interval between them.
"""

from __future__ import annotations

import torch

__all__ = ["BAD_U8", "LIMITS", "frame_numbers", "judge"]

BAD_U8 = 8
LIMITS = {"bad_px_pct": 0.5, "mean_abs_u8": 0.6}


def frame_numbers(port_img: torch.Tensor, ref: dict) -> dict:
    """The compared numbers of one (H, W, 4) u8 frame against the
    reference's (reference.Reference.render): per channel, the distance
    from the port's value to the interval [lo, hi] of the answers rounding
    can give."""
    p = port_img[..., :3].to(torch.int32)
    d = torch.maximum(ref["lo"][..., :3].to(torch.int32) - p, p - ref["hi"][..., :3].to(torch.int32)).clamp_min(0)
    return {
        "bad_px_pct": float((d.amax(-1) > BAD_U8).double().mean()) * 100.0,
        "mean_abs_u8": float(d.double().mean()),
    }


def judge(per_frame: list, limits: dict = None) -> tuple:
    """(correct, {name: [worst reading, limit]}) over the frames' numbers."""
    limits = LIMITS if limits is None else limits
    worst = {k: max(f[k] for f in per_frame) for k in limits} if per_frame else {k: float("nan") for k in limits}
    ok = bool(per_frame) and all(worst[k] <= limits[k] for k in limits)
    return ok, {k: [worst[k], limits[k]] for k in limits}
