"""Object instructions applied per frame: the port's span `objects::evaluate`
(inside evaluate_instructions: the adds, transforms and removals of the
frame's objects through the object manager) per traced frame. 0 where the
port counted `objects.transforms` and opened no such span (no object
instruction that frame); None where it recorded neither."""

LAYER = "scene API and managers"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPE = "objects::evaluate"
COUNTER = "objects.transforms"


def read(ctx):
    from rend3_tpu_torch.utils import profiling

    counters = getattr(profiling.stats(), "counters", None) or {}
    if not ctx["frames"] or (SCOPE not in ctx["scopes_ms"] and COUNTER not in counters):
        return None
    return ctx["scopes_ms"].get(SCOPE, 0.0) / ctx["frames"]
