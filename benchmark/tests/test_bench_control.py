"""The control, the reference in TF32 put in the program's place, fails
the check (control.py runs it at a cell's own size on the card)."""

from benchmark import compare, control
from benchmark.tests import tinyroot


def test_tf32_control_is_refused(tmp_path):
    root = tinyroot.make(tmp_path, width=480, height=270, buildings=100)
    for seed in (1, 2**33 + 5):
        ok, check = compare.judge(control.readings(root, "bistro-proxy-1080p.flythrough", seed, "cpu"))
        assert not ok, check
