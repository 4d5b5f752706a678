"""Scene time per frame: the host clock around the frame's steps 1-3 (the
mix's instructions, swap_instruction_buffers, evaluate_instructions),
measured by the harness."""

LAYER = "scene API and managers"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_ms"


def read(ctx):
    if not ctx["scene_s"]:
        return None
    return sum(ctx["scene_s"]) * 1e3 / len(ctx["scene_s"])
