"""Object tables copied to the device per frame, in KB (1024 bytes): the
port's counter `upload.object_bytes` (the object table, material slots and
cutout mask, copied whole when an object changed; 0 on a frame whose
caches hold) over the traced frames."""

LAYER = "frame upload"
UNIT = "KB"
SOURCE = "program_counter"
MOVES = "frame_ms"
COUNTER = "upload.object_bytes"


def read(ctx):
    """None where the port counts no such bytes."""
    from rend3_tpu_torch.utils import profiling

    counters = getattr(profiling.stats(), "counters", None) or {}
    if not ctx["frames"] or COUNTER not in counters:
        return None
    return counters[COUNTER] / ctx["frames"] / 1024
