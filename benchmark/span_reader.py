"""The read function of a per-layer metric that sums spans of the port
(profiling's totals) over the traced frames, per frame: 0 where the port
counted the metric's counter and opened none of the spans, None where it
recorded neither (a program without them) or no frame was traced."""


def span_reader(scopes: tuple, counter: str):
    """read(ctx) over the spans `scopes` and the counter `counter`."""

    def read(ctx):
        from rend3_tpu_torch.utils import profiling

        counters = getattr(profiling.stats(), "counters", None) or {}
        found = [ctx["scopes_ms"][s] for s in scopes if s in ctx["scopes_ms"]]
        if not ctx["frames"] or (not found and counter not in counters):
            return None
        return sum(found) / ctx["frames"]

    return read
