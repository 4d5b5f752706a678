"""Upload time per frame: the port's host scope
`BaseRenderGraph::build_frame_callable` (scene state into device tables)."""

LAYER = "frame upload"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPE = "BaseRenderGraph::build_frame_callable"


def read(ctx):
    if not ctx["frames"] or SCOPE not in ctx["scopes_ms"]:
        return None
    return ctx["scopes_ms"][SCOPE] / ctx["frames"]
