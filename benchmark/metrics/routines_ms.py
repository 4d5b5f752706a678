"""Registered material routines per frame: the port's spans
`routines::shadows` (their shadow factors), `routines::shade` (their shading
of the opaque image and of the blend peels' pixels) and `routines::verdict`
(a cutout routine's alpha test over a peel, before C1) over the traced
frames. The verdict's time also falls inside the StageTimer stage
`cut_alpha`, and the blend peels' routines inside `blend_shade`, which
peels_shading_ms reads. 0 where the port counted `routines.archetypes` and
opened no such span (no routine registered); None where it recorded
neither."""

from benchmark.span_reader import span_reader

LAYER = "extension features"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPES = ("routines::shadows", "routines::shade", "routines::verdict")
COUNTER = "routines.archetypes"

read = span_reader(SCOPES, COUNTER)
