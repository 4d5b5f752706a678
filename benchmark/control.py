"""The control of the check: the reference in TF32 put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--device cuda|cpu]

For each seed, renders the frames a run of the cell would check (the two
drawn from the seed, and frame LATE_FRAME standing in for the window's
last) with the float32 reference and with the reference whose matrix
products read TF32 operands, and prints compare.frame_numbers of the second
against the first, each beside its limit, then one JSON line with the worst
reading per seed. The configuration states float32 with TF32 off, so TF32 is
the nearest precision below it; a sound check refuses every seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATE_FRAME = 300


def readings(root: str, workload: str, seed: int, device: str) -> list:
    """compare.frame_numbers of the TF32 reference against the float32 one,
    one dict per checked frame."""
    from benchmark import compare, harness

    _cell, config, mix, _e2e, _pl = harness.find_cell(root, harness.load_manifest(root), workload)
    build_scene, Traffic, _port, Reference = harness.parts(root, config, mix)
    scene = build_scene(config, seed)
    traffic = Traffic(mix, scene, seed)
    exact = Reference(scene, device)
    tf32 = Reference(scene, device, tf32=True)
    out = []
    for i in harness._sample_frames(seed) + [LATE_FRAME]:
        state = traffic.state(i)
        out.append(compare.frame_numbers(tf32.render(**state)["image"], exact.render(**state)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import compare

    worst = {}
    for seed in args.seeds:
        nums = readings(ROOT, args.workload, seed, args.device)
        ok, check = compare.judge(nums)
        worst[seed] = {k: v for k, (v, _lim) in check.items()}
        print(f"seed {seed}: " + ", ".join(f"{k} {v:.6g} limit {lim}" for k, (v, lim) in check.items())
              + f"; passes the check: {ok}", file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "control": "tf32", "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
