"""Skinning's bytes copied to the device per frame, in KB (1024 bytes): the
port's counter `upload.skin_bytes` (the layout's lists when it is rebuilt,
the joint palette when a pose changes; 0 on a frame with nothing skinned)
over the traced frames."""

LAYER = "skinning"
UNIT = "KB"
SOURCE = "program_counter"
MOVES = "frame_ms"
COUNTER = "upload.skin_bytes"


def read(ctx):
    """None where the port counts no such bytes."""
    from rend3_tpu_torch.utils import profiling

    counters = getattr(profiling.stats(), "counters", None) or {}
    if not ctx["frames"] or COUNTER not in counters:
        return None
    return counters[COUNTER] / ctx["frames"] / 1024
