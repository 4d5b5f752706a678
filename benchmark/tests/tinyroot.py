"""A checkout-like root at a size the CPU renders in a fraction of a second:
the benchmark's files copied under a temporary directory, every
configuration cut to 160x90 with 16 buildings and small shadow maps, every
mix to two warm-up frames and at most 4 movers."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)


def make(tmp, width=160, height=90, buildings=16) -> str:
    root = str(tmp)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(root, "benchmark", "configs")):
        path = os.path.join(root, "benchmark", "configs", name)
        with open(path) as f:
            c = json.load(f)
        c["width"], c["height"] = width, height
        c["scene"]["n_buildings"] = buildings
        c["scene"]["subdiv"] = 2
        for light in c["scene"]["lights"]:
            light["resolution"] = max(64, light["resolution"] // 8)
        with open(path, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(root, "benchmark", "mixes")):
        path = os.path.join(root, "benchmark", "mixes", name)
        with open(path) as f:
            m = json.load(f)
        m["warmup_frames"] = 2
        if "movers" in m:
            m["movers"]["count"] = min(4, m["movers"]["count"])
        with open(path, "w") as f:
            json.dump(m, f)
    return root
