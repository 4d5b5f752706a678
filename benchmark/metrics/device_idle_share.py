"""The device's idle share of a user's frame: 1 - (device busy time per
frame, the union of kernel and copy intervals over the device-only profiled
frames) / (the mean host-clock time of the plain frames that follow them,
which run with no profiler, StageTimer or scope). The profiler's own host
cost slows a profiled frame, and StageTimer and the scopes slow the traced
frames after the plain ones, so neither's time is the user's frame."""

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    p, plain = ctx["profile"], ctx["plain_s"]
    if not p or p["busy_s"] <= 0 or not p["frames"] or not plain:
        return None
    return 1.0 - (p["busy_s"] / p["frames"]) / (sum(plain) / len(plain))
