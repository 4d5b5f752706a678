"""The scene generator and the traffic mixes are functions of the seed and
the frame index alone."""

import json
import os

import numpy as np

from benchmark import harness, scene, traffic
from benchmark.tests.tinyroot import REPO


def _config(name="bistro-proxy-1080p"):
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def _mix(name):
    with open(os.path.join(REPO, "benchmark", "mixes", name + ".json")) as f:
        return json.load(f)


def _small(config):
    config["scene"]["n_buildings"] = 81
    return config


def test_scene_is_deterministic_per_seed():
    a, b = scene.build_scene(_small(_config()), 2**33 + 7), scene.build_scene(_small(_config()), 2**33 + 7)
    c = scene.build_scene(_small(_config()), 11)
    for x, y in ((a, b), (a, c)):
        assert len(x.transforms) == len(y.transforms)
        assert all(np.array_equal(p, q) for p, q in zip(x.transforms, y.transforms))   # the layout: config's seed
        assert all(np.array_equal(p.positions, q.positions) for p, q in zip(x.meshes, y.meshes))
        assert [len(t.rgba) for t in x.textures] == [len(t.rgba) for t in y.textures]
    assert all(np.array_equal(p.rgba, q.rgba) for p, q in zip(a.textures, b.textures))
    assert not all(np.array_equal(p.rgba, q.rgba) for p, q in zip(a.textures, c.textures))  # colours: the run's seed


def test_full_size_scene_counts():
    assert scene.build_scene(_config(), 1).triangles() == 121_426  # 121,362 opaque and cutout, 64 glass
    assert len(scene.build_scene(_config(), 1).buildings) == 600


def test_mixes_are_functions_of_seed_and_frame():
    sc = scene.build_scene(_small(_config()), 5)
    for name in ("static", "flythrough", "dynamic"):
        a, b = traffic.Traffic(_mix(name), sc, 99), traffic.Traffic(_mix(name), sc, 99)
        for i in (0, 1, 17, 239, 240, 1000):
            assert np.array_equal(a.view(i), b.view(i))
            assert np.array_equal(a.transforms(i), b.transforms(i))
            assert np.array_equal(a.state(i)["view"], a.view(i))
            assert np.array_equal(a.state(i)["transforms"], a.transforms(i))
        assert np.array_equal(a.view(3), a.view(3 + a.period))
    fly = traffic.Traffic(_mix("flythrough"), sc, 1)
    assert fly.period == 240 and not np.array_equal(fly.view(0), fly.view(1))
    assert np.array_equal(fly.view(7), traffic.Traffic(_mix("flythrough"), sc, 2).view(7))  # one loop for every seed
    dyn = traffic.Traffic(_mix("dynamic"), sc, 1)
    assert len(dyn.moved(0)) == 64 and np.array_equal(dyn.view(0), dyn.view(50))
    assert not np.array_equal(dyn.transforms(0), dyn.transforms(1))
    static = traffic.Traffic(_mix("static"), sc, 1)
    assert static.moved(5) == [] and not static.moves_camera


def test_checked_frames_are_drawn_from_the_seed():
    assert harness._sample_frames(2**33 + 1) == harness._sample_frames(2**33 + 1)
    frames = {tuple(harness._sample_frames(s)) for s in range(20)}
    assert len(frames) > 10 and all(0 <= i < harness.SAMPLE_SPAN for f in frames for i in f)
