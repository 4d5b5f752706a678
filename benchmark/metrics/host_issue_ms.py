"""The host's own time issuing a frame: the port's root span
`BaseRenderGraph::render_frame_tensor` (upload and every stage, on the
host's clock) per traced frame, less the part spent waiting on the device
(`sync::<site>` spans, sync_wait_ms). Python, PyTorch's dispatch and the
launches: what a CUDA graph or fused kernels would remove."""

LAYER = "device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
ROOT = "BaseRenderGraph::render_frame_tensor"
PREFIX = "sync::"


def read(ctx):
    """(root span ms - sync:: span ms) over ctx["frames"]; None when the
    port records no root span."""
    scopes = ctx["scopes_ms"]
    if not ctx["frames"] or ROOT not in scopes:
        return None
    wait = sum(v for k, v in scopes.items() if k.startswith(PREFIX))
    return (scopes[ROOT] - wait) / ctx["frames"]
