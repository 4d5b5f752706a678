"""A configuration, a mix, a generator and a per-layer metric added as new
files (and entries in BENCHMARK.json) are found by name and run, with no
edit to any file that is already there."""

import json
import os

from benchmark import harness
from benchmark.tests import tinyroot

READER = '''"""Frames traced."""

LAYER = "test layer"
UNIT = "frames"
SOURCE = "host_clock"
MOVES = "frame_ms"


def read(ctx):
    return float(ctx["frames"]) or None
'''


GENERATOR = '''"""A row of four cubes, not the city; the traffic spins the second
one about its axis, which the camera-and-movers generator cannot."""

import numpy as np

from benchmark import scene as S, traffic as T


def build_scene(config, seed):
    cam = config["camera"]
    out = S.Scene(width=config["width"], height=config["height"], ambient=tuple(config["ambient"]),
                  vfov=cam["vfov"], near=cam["near"], eye=np.asarray(cam["eye"], np.float32),
                  target=np.asarray(cam["target"], np.float32), half_width=20.0, samples=config["samples"])
    out.materials.append(S.MaterialArrays(albedo=np.array([0.6, 0.5, 0.4, 1.0], np.float32)))
    out.meshes.append(S.subdivided_cube(2))
    for k in range(4):
        out.add_object(0, 0, S.translation([8.0 * k - 12.0, 3.0, 0.0]) @ S.scale(3.0))
    light = config["scene"]["lights"][0]
    out.lights.append(S.LightArrays(
        color=np.asarray(light["color"], np.float32), intensity=float(light["intensity"]),
        direction=np.asarray(light["direction"], np.float32), distance=float(light["distance"]),
        resolution=int(light["resolution"])))
    return out


class Traffic(T.Traffic):
    def moved(self, frame):
        return [(1, S.translation([-4.0, 3.0, 0.0]) @ S.rotation_y(0.3 * frame) @ S.scale(3.0))]
'''


def test_new_files_are_found_and_run(tmp_path, monkeypatch):
    root = tinyroot.make(tmp_path)
    bench = os.path.join(root, "benchmark")
    before = {}
    for dirpath, _dirs, files in os.walk(bench):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                before[os.path.join(dirpath, f)] = fh.read()
    with open(os.path.join(bench, "configs", "bistro-proxy-1080p.json")) as f:
        config = json.load(f)
    config["name"] = "flat-city-test"
    config["scene"]["representative"] = False
    with open(os.path.join(bench, "configs", "flat-city-test.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "mixes", "slow-orbit.json"), "w") as f:
        json.dump({"camera": {"path": "loop", "path_seed": 9, "points": 4, "angle_jitter": 0.0, "radius": [0.5, 0.6],
                              "height": [20.0, 25.0], "target_radius": 5.0, "target_height": [0.0, 1.0],
                              "frames": 60}, "warmup_frames": 1}, f)
    with open(os.path.join(bench, "metrics", "frames_traced.py"), "w") as f:
        f.write(READER)
    os.makedirs(os.path.join(bench, "generators"), exist_ok=True)
    with open(os.path.join(bench, "generators", "cube_row_test.py"), "w") as f:
        f.write(GENERATOR)
    config["name"], config["generator"] = "cube-row-test", "cube_row_test"
    with open(os.path.join(bench, "configs", "cube-row-test.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "mixes", "spin-test.json"), "w") as f:
        json.dump({"generator": "cube_row_test", "camera": {"path": "fixed"}, "warmup_frames": 1}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "flat-city-test", "source": "https://example.org/flat-city",
                                "file": "benchmark/configs/flat-city-test.json", "reduced": [],
                                "why": "a test configuration"})
    manifest["configs"].append({"name": "cube-row-test", "source": "https://example.org/cube-row",
                                "file": "benchmark/configs/cube-row-test.json", "reduced": [],
                                "why": "a test configuration of a new generator"})
    manifest["workloads"].append({"name": "flat-city-test.slow-orbit", "config": "flat-city-test",
                                  "traffic": "slow-orbit", "chips": 1, "why": "a test cell"})
    manifest["workloads"].append({"name": "cube-row-test.spin-test", "config": "cube-row-test",
                                  "traffic": "spin-test", "chips": 1, "why": "a test cell of new generators"})
    manifest["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                                  "source": "host_clock", "layer": "test layer", "moves": "frame_ms",
                                  "workloads": ["flat-city-test.slow-orbit"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)

    cell, config, mix, e2e, per_layer = harness.find_cell(root, manifest, "flat-city-test.slow-orbit")
    assert config["name"] == "flat-city-test" and mix["camera"]["frames"] == 60
    assert "frames_traced" in [m["name"] for m in per_layer]
    assert "frames_traced" not in [m["name"] for m in harness.find_cell(root, manifest, "bistro-proxy-1080p.static")[4]]
    # Profile one frame in each phase: the CPU's profiled frames are slow.
    monkeypatch.setattr(harness, "DEVICE_FRAMES", 1)
    monkeypatch.setattr(harness, "PLAIN_FRAMES", 1)
    monkeypatch.setattr(harness, "LABEL_FRAMES", 1)
    result = harness.run_cell(root, "flat-city-test.slow-orbit", 3, 5.0, trace=True, device="cpu")
    assert result["metrics"]["frames_traced"]["unit"] == "frames"
    assert result["correct"], result["check"]

    _cell, config, mix, _e2e, _pl = harness.find_cell(root, manifest, "cube-row-test.spin-test")
    build_scene, Traffic, _port, _ref = harness.parts(root, config, mix)
    spin = Traffic({"camera": {"path": "fixed"}}, build_scene(config, 3), 3)
    assert len(spin.scene.transforms) == 4 and not (spin.transforms(0) == spin.transforms(1)).all()
    result = harness.run_cell(root, "cube-row-test.spin-test", 5, 2.0, trace=False, device="cpu")
    assert result["correct"] and result["attempted"] > 1, result["check"]
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path
