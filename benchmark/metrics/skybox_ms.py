"""The skybox per frame: the port's span `sky::background` (each sample's
sky directions, and the K4 queries of the pixels no surface covers, into
the padded cube store) over the traced frames. 0 where the port counted
`sky.queries` and opened no such span (no skybox); None where it recorded
neither."""

from benchmark.span_reader import span_reader

LAYER = "extension features"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
SCOPES = ("sky::background",)
COUNTER = "sky.queries"

read = span_reader(SCOPES, COUNTER)
