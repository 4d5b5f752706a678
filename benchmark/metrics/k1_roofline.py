"""K1's share of its roofline over the profiled frames: the summed bound of
its launches (roofline.k1_bound_ms, from the tensors each launch was
passed) over their summed device time in the profiler's trace, in percent."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    k1 = (ctx["profile"] or {}).get("k1")
    if not k1 or k1["device_ms"] <= 0:
        return None
    return 100.0 * k1["bound_ms"] / k1["device_ms"]
