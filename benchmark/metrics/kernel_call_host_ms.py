"""The host's cost of calling the hand-written kernels per frame: the
summed time of the port's `kernel::<name>` spans (each wrapper's call on
the card from its launch preparation on: F1's stride merge, the argument
lists, the ctypes call) over the traced frames, per frame."""

LAYER = "kernels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
PREFIX = "kernel::"


def read(ctx):
    """Summed kernel:: span ms over ctx["frames"]; None when there is none."""
    ms = [v for k, v in ctx["scopes_ms"].items() if k.startswith(PREFIX)]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
