"""The check refuses a run whose timed path is broken underneath the
harness, once for each fault a cell of this benchmark can have: a frame
that returns its state unchanged (the image frozen; in the dynamic cell,
the movers' transforms never applied), half of the frame left out, an
answer altered where it is produced. (No cell spans cards, so no exchange
between them can be left out.) A sound run of the same cell passes.

The cases marked `cuda` plant the dynamic cell's fault at the cell's own
size on the card, on three seeds, with a window that reaches the checked
frames (run with `-s` to see the readings); they skip without a card."""

import pytest

from benchmark import harness
from benchmark.tests import tinyroot

FLY, DYN = "bistro-proxy-1080p.flythrough", "bistro-proxy-1080p.dynamic"


def _frozen(img, state):
    state.setdefault("first", img)
    return state["first"]


def _half(img, state):
    img = img.clone()
    img[img.shape[0] // 2:] = 0
    return img


def _altered(img, state):
    img = img.clone()
    img[8:24, 8:24, 0] += 64
    return img


def _drop_transforms(monkeypatch):
    """The port takes no notice of set_object_transform."""
    from rend3_tpu_torch.core.renderer import Renderer

    monkeypatch.setattr(Renderer, "set_object_transform", lambda self, handle, transform: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("faults"))


def _run(root, monkeypatch, fault, workload=FLY):
    from rend3_tpu_torch.routine.base import BaseRenderGraph

    if fault is not None:
        orig = BaseRenderGraph.render_frame_tensor
        state = {}

        def broken(self, *a, **k):
            return fault(orig(self, *a, **k), state)

        monkeypatch.setattr(BaseRenderGraph, "render_frame_tensor", broken)
    return harness.run_cell(root, workload, 2**34 + 3, 1.0, False, device="cpu")


@pytest.mark.parametrize("workload", [FLY, DYN])
def test_sound_run_passes(root, monkeypatch, workload):
    result = _run(root, monkeypatch, None, workload)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("fault", [_frozen, _half, _altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_fault_is_refused(root, monkeypatch, fault):
    result = _run(root, monkeypatch, fault)
    assert not result["correct"], result["check"]


def test_dropped_transforms_are_refused(root, monkeypatch):
    _drop_transforms(monkeypatch)
    result = _run(root, monkeypatch, None, DYN)
    assert not result["correct"], result["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 101, 2**33 + 102, 2**33 + 103])
def test_dropped_transforms_are_refused_on_the_card(monkeypatch, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _drop_transforms(monkeypatch)
    # 15 s at the cell's 110 ms a frame reach frame 119, the last a run may check.
    result = harness.run_cell(tinyroot.REPO, DYN, seed, 15.0, False, device="cuda")
    print(f"dropped transforms, seed {seed}: {result['check']}")
    assert not result["correct"], result["check"]
