"""The readers of the port's spans and counters on a fake context: what
each reads from `scopes_ms` and from `profiling.stats()`, and None where a
program records none of it (as one that lacks the spans and counters)."""

import pytest

from benchmark import harness
from benchmark.tests.tinyroot import REPO
from rend3_tpu_torch.utils import profiling

ROOT = "BaseRenderGraph::render_frame_tensor"


def _reader(name):
    return harness.load_metric(REPO, name)


@pytest.fixture
def traced():
    """Two frames: per frame three sync:: reads, two kernel:: calls, a
    shadow-cache hit; the second frame's maps re-rasterized (a miss)."""
    profiling.enable()
    try:
        for frame in range(2):
            with profiling.scope(ROOT):
                for site in ("sync::setup.survivors", "sync::bin.pairs", "sync::peel.pixels"):
                    with profiling.scope(site):
                        pass
                for kernel in ("kernel::F1", "kernel::K1"):
                    with profiling.scope(kernel):
                        pass
                profiling.count("shadow_cache.hit" if frame == 0 else "shadow_cache.miss")
    finally:
        profiling.disable()
    yield profiling.stats()
    profiling.enable()
    profiling.disable()


def _ctx(stats, frames=2):
    return {"frames": frames, "frame_s": [0.1] * frames, "scene_s": [0.01] * frames, "plain_s": [],
            "stages_ms": {}, "scopes_ms": dict(stats.totals_ms), "profile": None}


def test_readers_read_the_spans_and_counters(traced):
    ctx = _ctx(traced)
    scopes = ctx["scopes_ms"]
    sync = sum(v for k, v in scopes.items() if k.startswith("sync::"))
    assert _reader("host_syncs_per_frame").read(ctx) == 3.0
    assert _reader("sync_wait_ms").read(ctx) == pytest.approx(sync / 2)
    assert _reader("host_issue_ms").read(ctx) == pytest.approx((scopes[ROOT] - sync) / 2)
    assert _reader("kernel_call_host_ms").read(ctx) == pytest.approx(
        (scopes["kernel::F1"] + scopes["kernel::K1"]) / 2)
    assert _reader("shadow_cache_hit_share").read(ctx) == 0.5
    assert 0.0 < _reader("host_issue_ms").read(ctx) < scopes[ROOT] / 2


@pytest.mark.parametrize("name", ["host_syncs_per_frame", "sync_wait_ms", "host_issue_ms", "kernel_call_host_ms",
                                  "shadow_cache_hit_share"])
def test_readers_find_nothing_without_the_spans(name):
    """A program without the spans and counters (its scopes only the
    upload's) reads None, and so does a run with no traced frame."""
    profiling.enable()
    try:
        with profiling.scope("BaseRenderGraph::build_frame_callable"):
            pass
    finally:
        profiling.disable()
    ctx = _ctx(profiling.stats())
    assert _reader(name).read(ctx) is None
    assert _reader(name).read({**ctx, "frames": 0}) is None
