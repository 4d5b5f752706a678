"""Blocking device reads per frame: the port's `sync::<site>` spans (each a
call that holds the host until the device is done: a `nonzero`, an
`int(t)`, a `.tolist()`, a size read by `repeat_interleave` or
`bincount`, an upload that synchronizes the stream) counted over the
traced frames, per frame. A CUDA graph can capture no frame that has any."""

LAYER = "device"
UNIT = "syncs"
SOURCE = "program_counter"
MOVES = "frame_ms"
PREFIX = "sync::"


def read(ctx):
    """Calls of every sync:: span over ctx["frames"]; None when the port
    records no such span."""
    from rend3_tpu_torch.utils import profiling

    n = sum(v for k, v in profiling.stats().counts.items() if k.startswith(PREFIX))
    if not ctx["frames"] or not n:
        return None
    return n / ctx["frames"]
