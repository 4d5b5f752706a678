"""The arithmetic of the end-to-end metrics, the trace reduction and the
kernel bound on known inputs."""

import pytest
import torch

from benchmark import devtrace, harness, roofline


def test_p95_is_the_nearest_rank():
    values = [float(v) for v in range(1, 201)]          # 1 .. 200
    assert harness.p95(values) == 190.0                  # 190 of 200 at or below it
    assert harness.p95(list(reversed(values))) == 190.0
    assert harness.p95([5.0]) == 5.0
    assert harness.p95([1.0, 2.0, 3.0, 4.0, 100.0]) == 100.0


def test_frame_ms_counts_the_whole_window():
    stats = harness.frame_stats([0.010] * 19 + [0.200], wall_s=0.400)
    assert stats["frame_ms"] == pytest.approx(20.0)      # 400 ms over 20 frames, the stall included
    assert stats["frame_p95_ms"] == pytest.approx(10.0)  # the 19th of 20 values
    assert harness.frame_stats([0.010] * 18 + [0.200] * 2, wall_s=0.580)["frame_p95_ms"] == pytest.approx(200.0)


def test_union_of_device_intervals():
    busy, gaps = devtrace.union([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)])
    assert busy == 12 + 10 + 1
    assert gaps == [(12, 20), (30, 40)]
    assert devtrace.union([]) == (0.0, [])


def test_k1_bound_counts_bytes_and_tested_pixels():
    # One 128x32 tile, one triangle whose box covers 10 x 4 of its pixels.
    call = {
        "bbox": torch.tensor([[2.0, 1.0, 12.0, 5.0]]), "offsets": torch.tensor([0, 1], dtype=torch.int32),
        "ids": torch.tensor([0], dtype=torch.int32), "width": 128, "height": 32, "y0": 0, "in_bytes": [],
        "table_bytes": 1000,
    }
    assert roofline.raster_fragments(call["bbox"], call["offsets"], call["ids"], 128) == 40
    gbuf = 25 * 128 * 32 * 4
    expect = max((1000 + gbuf) / roofline.HBM_BYTES_PER_S,
                 (40 * roofline.RASTER_TEST_OPS + 128 * 32 * roofline.K1_FINALIZE_OPS) / roofline.F32_OPS_PER_S)
    assert roofline.k1_bound_ms(call) == pytest.approx(expect * 1e3)
