"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress, the set-up account and each
compared number beside its limit on standard error, and as the last line of
standard output one JSON object: correct, attempted, failed, metrics,
device (and with --trace 1 breakdown), then check. Exits nonzero with no
result when the cell's cards are missing, when a run loads JAX or the JAX
package, or when the port cannot be imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode for every module the run imports, torch's 2,000-odd
# files with them, kept in a fixed directory of the checkout. Where the
# environment forbids bytecode beside the sources (PYTHONDONTWRITEBYTECODE)
# and none was installed, each run would compile them all again: seconds of
# set-up that serve no frame and swing with the host's load.
sys.pycache_prefix = os.path.join(ROOT, "_bench_cache", "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
