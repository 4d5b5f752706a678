"""Device operations per frame over the profiled frames: kernel launches plus
memcpy / memset operations in the profiler's trace (the arithmetic of
rend3_tpu_torch/tools/frame_launches.py)."""

LAYER = "device"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    p = ctx["profile"]
    if not p or not p["frames"] or p["busy_s"] <= 0:
        return None
    return (p["kernels"] + p["copies"]) / p["frames"]
