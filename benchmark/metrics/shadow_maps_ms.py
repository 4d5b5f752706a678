"""Shadow-map time per frame: the port's StageTimer stage `shadow_maps` (the
cached maps' check, or every map re-rasterized on K2 when a caster or the
shadow camera moved), device time on the stream."""

LAYER = "shadow maps"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
STAGES = ("shadow_maps",)


def read(ctx):
    """Summed StageTimer ms of STAGES over the traced frames, per frame;
    None when no stage ran."""
    ms = [v for k, v in ctx["stages_ms"].items() if k in STAGES]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
