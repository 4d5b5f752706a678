"""Two-phase occlusion time per frame: the StageTimer stages `hiz` (the Hi-Z
pyramid and every row's visibility test) and `resid` (the residual set's
setup, planes, binning, raster and merge), device time on the stream."""

LAYER = "two-phase occlusion"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
STAGES = ("hiz", "resid")


def read(ctx):
    """Summed StageTimer ms of STAGES over the traced frames, per frame;
    None when no stage ran."""
    ms = [v for k, v in ctx["stages_ms"].items() if k in STAGES]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
