"""Peels and shading time per frame: the StageTimer stages of the cutout peels
(`cut_*`), the blend peels (`blend_*`), the shadow lookups
(`shadow_coords`, `pcf`), texture sampling, lighting and the blit, device
time on the stream."""

LAYER = "peels and shading"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
STAGES = ("cut_setup", "cut_planes", "cut_bin", "cut_raster", "cut_alpha", "blend_geom", "blend_raster", "blend_shade",
          "shadow_coords", "pcf", "textures", "lighting", "blit")


def read(ctx):
    """Summed StageTimer ms of STAGES over the traced frames, per frame;
    None when no stage ran."""
    ms = [v for k, v in ctx["stages_ms"].items() if k in STAGES]
    if not ctx["frames"] or not ms:
        return None
    return sum(ms) / ctx["frames"]
