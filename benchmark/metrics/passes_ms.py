"""Registered passes per frame: the port's spans `passes::hdr` (a pass on the
resolved linear image) and `passes::srgb` (a pass on the encoded u8 image)
over the traced frames. 0 where the port counted `passes.run` and opened no
such span (no pass registered); None where it recorded neither."""

from benchmark.span_reader import span_reader

LAYER = "extension features"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPES = ("passes::hdr", "passes::srgb")
COUNTER = "passes.run"

read = span_reader(SCOPES, COUNTER)
