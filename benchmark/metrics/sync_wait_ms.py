"""The host's wait on the device per frame: the summed time of the port's
`sync::<site>` spans (each a blocking device read or a stream-synchronizing
upload) over the traced frames, per frame."""

LAYER = "device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
PREFIX = "sync::"


def read(ctx):
    """Summed sync:: span ms over ctx["frames"]; None when there is none."""
    ms = [v for k, v in ctx["scopes_ms"].items() if k.startswith(PREFIX)]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
