"""The shadow maps' cache hits over the traced frames: the port's counters
`shadow_cache.hit` (the maps reused) over hit + `shadow_cache.miss` (every
map re-rasterized on K2), from the frame's shadow-map stage."""

LAYER = "shadow maps"
UNIT = "share"
SOURCE = "program_counter"
MOVES = "frame_ms"


def read(ctx):
    """hit / (hit + miss); None when neither was counted."""
    from rend3_tpu_torch.utils import profiling

    counters = getattr(profiling.stats(), "counters", None) or {}
    hit, miss = counters.get("shadow_cache.hit", 0), counters.get("shadow_cache.miss", 0)
    if hit + miss == 0:
        return None
    return hit / (hit + miss)
