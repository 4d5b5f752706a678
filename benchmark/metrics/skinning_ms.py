"""Skinning per frame: the port's spans `skin::layout` (the layout's
build, when a skeleton is added or removed), `skin::palette` (the joint
matrices' upload, when a pose changes) and `skin::apply` (the blend and the
writes into the override ranges) over the traced frames. 0 where the port
counted `skin.vertices` and opened no such span (nothing skinned); None
where it recorded neither."""

LAYER = "skinning"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPES = ("skin::layout", "skin::palette", "skin::apply")
COUNTER = "skin.vertices"


def read(ctx):
    from rend3_tpu_torch.utils import profiling

    counters = getattr(profiling.stats(), "counters", None) or {}
    found = [ctx["scopes_ms"][s] for s in SCOPES if s in ctx["scopes_ms"]]
    if not ctx["frames"] or (not found and COUNTER not in counters):
        return None
    return sum(found) / ctx["frames"]
