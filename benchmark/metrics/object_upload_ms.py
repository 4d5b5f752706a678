"""The upload's host work that scales with the object count, per frame: the
port's span `upload::objects` (the object table, material-slot and cutout
caches and their copies, every object's sphere against the camera's and
each shadow camera's frustum, the masks' copies)."""

LAYER = "frame upload"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPE = "upload::objects"


def read(ctx):
    if not ctx["frames"] or SCOPE not in ctx["scopes_ms"]:
        return None
    return ctx["scopes_ms"][SCOPE] / ctx["frames"]
