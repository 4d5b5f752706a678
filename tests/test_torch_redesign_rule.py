"""Rule 2's order (testing.redesign_order) on the kernel rows measured
before P1's and K5's redesign (PERF.md §6's earlier device times, NVIDIA
H100 80GB HBM3, 700 W): P1 first (slower than torch.matmul), then K5 (the
only kernel the main path loses time on), and with those two redesigned
the off-frame kernels by launches on chip_smoke's paths x (device -
bound). On the rows measured after that redesign (chip_smoke.py phase 11
on the same card): K7, K6, K8, P3, P2, and with K6-K8 redesigned too, P3
then P2. On the rows measured after K6-K8's redesign, with every kernel
redesigned (testing.REDESIGNED) or within twice its bound: none."""

import pytest

from rend3_tpu_torch import testing

# name, device ms, bound ms, library ms, launches on chip_smoke's paths.
EARLIER_ROWS = [
    ("raster_resolve", 0.1564, 0.0660, None, 15),
    ("raster_msaa", 0.1076, 0.0630, None, 32),
    ("raster_count", 0.0809, 0.0653, None, 60),
    ("raster_bound", 0.0737, 0.0628, None, 75),
    ("raster_depth", 0.0960, 0.00656, None, 12),
    ("pcf5", 0.0221, 0.0208, None, 18),
    ("bilinear", 0.1031, 0.1016, None, 114),
    ("gather", 0.0057, 0.00107, 0.0166, 27),
    ("raster_vis", 1.3026, 0.0533, None, 2),
    ("shadow_occ", 23.7936, 0.0374, None, 1),
    ("shadow_occ_lt", 2.4268, 0.0372, None, 1),
    ("probe_dot", 0.0093, 0.00113, 0.0059, 6),
    ("probe_reduce", 0.0107, 0.00079, 0.0197, 2),
    ("probe_lerp", 0.0823, 0.00112, None, 12),
]
# Launches in one static representative frame at 1 sample (PERF.md §6).
FRAME = {"raster_resolve": 2, "raster_count": 2, "raster_bound": 2, "pcf5": 1, "bilinear": 3, "gather": 2}

CASES = {
    "k1_k2_redesigned": ({"K1", "K2"}, ["P1", "K5", "K7", "K6", "K8", "P3", "P2"]),
    "k1_k2_p1_k5_redesigned": ({"K1", "K2", "P1", "K5"}, ["K7", "K6", "K8", "P3", "P2"]),
    # Nothing redesigned: K1's frame launches rank it before K5; K2 (no
    # static-frame launch) among the off-frame kernels by its path launches.
    "none": (set(), ["P1", "K1", "K5", "K7", "K6", "K8", "K2", "P3", "P2"]),
}


# The same rows measured after P1's and K5's redesign.
PR7_ROWS = [
    ("raster_resolve", 0.1556, 0.0660, None, 15),
    ("raster_msaa", 0.1080, 0.0630, None, 32),
    ("raster_count", 0.0810, 0.0653, None, 60),
    ("raster_bound", 0.0733, 0.0628, None, 75),
    ("raster_depth", 0.0969, 0.00656, None, 12),
    ("pcf5", 0.0225, 0.0208, None, 18),
    ("bilinear", 0.1029, 0.1016, None, 114),
    ("gather", 0.00274, 0.00107, 0.0165, 27),
    ("raster_vis", 1.3009, 0.0533, None, 2),
    ("shadow_occ", 23.7964, 0.0374, None, 1),
    ("shadow_occ_lt", 2.4272, 0.0372, None, 1),
    ("probe_dot", 0.00622, 0.00113, 0.00580, 6),
    ("probe_reduce", 0.0105, 0.00079, 0.0199, 2),
    ("probe_lerp", 0.0803, 0.00112, None, 12),
]
PR7_CASES = {
    "k1_k2_p1_k5_redesigned": ({"K1", "K2", "P1", "K5"}, ["K7", "K6", "K8", "P3", "P2"]),
    "k6_k7_k8_also_redesigned": ({"K1", "K2", "P1", "K5", "K6", "K7", "K8"}, ["P3", "P2"]),
}

# The rows measured after K6-K8's redesign (PERF.md §6, same card):
# P3 then P2; with those two redesigned as well (testing.REDESIGNED), and K3
# and K4 within twice their bounds with no library call, none is left.
AFTER_K6_K8_ROWS = [
    ("raster_resolve", 0.1570, 0.0660, None, 15),
    ("raster_msaa", 0.1090, 0.0630, None, 32),
    ("raster_count", 0.0806, 0.0653, None, 60),
    ("raster_bound", 0.0739, 0.0628, None, 75),
    ("raster_depth", 0.0981, 0.00656, None, 12),
    ("pcf5", 0.0217, 0.0208, None, 18),
    ("bilinear", 0.1012, 0.1016, None, 114),
    ("gather", 0.00259, 0.00107, 0.0162, 27),
    ("raster_vis", 0.3775, 0.0533, None, 2),
    ("shadow_occ", 0.5634, 0.0374, None, 1),
    ("shadow_occ_lt", 0.3918, 0.0372, None, 1),
    ("probe_dot", 0.00589, 0.00113, 0.00564, 6),
    ("probe_reduce", 0.0107, 0.00079, 0.0198, 2),
    ("probe_lerp", 0.0811, 0.00112, None, 12),
]
AFTER_K6_K8_CASES = {
    "k1_k2_k5_k8_p1_redesigned": ({"K1", "K2", "P1", "K5", "K6", "K7", "K8"}, ["P3", "P2"]),
    "all_redesigned_or_at_bound": (testing.REDESIGNED, []),
}


def _rows(overrides=None, table=EARLIER_ROWS):
    rows = [dict(name=n, ms=ms, bound_ms=b, library_ms=lib, launches=la) for n, ms, b, lib, la in table]
    for r in rows:
        r.update((overrides or {}).get(r["name"], {}))
    return rows


@pytest.mark.parametrize("case", list(CASES))
def test_redesign_order_on_earlier_rows(case):
    redesigned, expected = CASES[case]
    order = testing.redesign_order(_rows(), FRAME, redesigned)
    assert [k for k, _name, _why in order] == expected


@pytest.mark.parametrize("case", list(PR7_CASES))
def test_redesign_order_on_pr7_rows(case):
    redesigned, expected = PR7_CASES[case]
    order = testing.redesign_order(_rows(table=PR7_ROWS), FRAME, redesigned)
    assert [k for k, _name, _why in order] == expected


@pytest.mark.parametrize("case", list(AFTER_K6_K8_CASES))
def test_redesign_order_after_k6_k8_redesign(case):
    redesigned, expected = AFTER_K6_K8_CASES[case]
    order = testing.redesign_order(_rows(table=AFTER_K6_K8_ROWS), FRAME, redesigned)
    assert [k for k, _name, _why in order] == expected


@pytest.mark.parametrize("case", ["near_bound_but_slower_than_library", "near_bound_and_faster"])
def test_redesign_order_library_beats_the_bound_test(case):
    """A row within 2x of its bound is skipped unless a library call beats
    it; a library call that beats it puts it first, by the factor."""
    lib = 0.02 if case == "near_bound_but_slower_than_library" else 0.03
    order = testing.redesign_order(_rows({"pcf5": {"library_ms": lib}}), FRAME, {"K1", "K2"})
    kernels = [k for k, _name, _why in order]
    if case == "near_bound_but_slower_than_library":
        assert kernels[:2] == ["P1", "K3"]  # 1.58x before 1.105x
    else:
        assert "K3" not in kernels
