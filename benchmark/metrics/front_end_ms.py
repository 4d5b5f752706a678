"""Front-end time per frame: the StageTimer stages `clip` (transform and
near-plane clip of every triangle), `setup` (cull and setup of the
predicted set), `planes` and `bin`, device time on the stream."""

LAYER = "front end"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
STAGES = ("clip", "setup", "planes", "bin")


def read(ctx):
    """Summed StageTimer ms of STAGES over the traced frames, per frame;
    None when no stage ran."""
    ms = [v for k, v in ctx["stages_ms"].items() if k in STAGES]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
