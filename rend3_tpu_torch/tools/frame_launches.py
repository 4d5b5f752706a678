"""Kernel launches and device time of one static frame and one shadow pass.

    python3 rend3_tpu_torch/tools/frame_launches.py [--tree DIR] [--flat] [--calls N]
    python3 -m rend3_tpu_torch.tools.frame_launches [--flat] [--calls N]

Builds bench.py's representative city (rend3_tpu_torch.bench.scene: 600
buildings, 1920x1080, occlusion culling on; `--flat` the flat-material
city) on the card, renders two warm-up frames through render_frame_tensor,
then traces with torch.profiler N calls (default 3) of
build_frame_callable's program (a static frame: cached shadow maps, the
carried occlusion mask) and N calls of the shadow-pass callable
(graph._last_shadow_call: every map re-rasterized and stacked). Prints one
JSON line with, for each of the two and per call:

- kernels: device kernels launched (every CUDA kernel in the trace);
- copies: device memcpy and memset operations;
- float64_kernels: kernels whose name carries `double` (PyTorch's
  elementwise kernels name their scalar type);
- busy_ms, wall_ms, busy_share: summed device time of the kernels and
  copies, the host-clock time of the traced calls, and their ratio;
- top: the 12 kernels launched most, with launches per call;

and the card's name. Run as a file with `--tree DIR` it imports the
package `rend3_tpu_torch` from DIR (for example another commit's `git
archive` in an ignored directory), so two trees are counted by the same
code on one card, one after the other; DIR needs bench.scene and
BaseRenderGraph._last_shadow_call. `profile_calls` is what chip_smoke.py's
bench phase runs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

__all__ = ["profile_calls", "main"]


def profile_calls(fn, args, calls: int = 3) -> dict:
    """Trace `calls` calls of fn(*args) (after one untraced call) with
    torch.profiler; the per-call counts and times described above."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = collections.Counter()
    copies = 0
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        busy_us += e.time_range.elapsed_us()
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels[e.name] += 1
    busy_ms = busy_us / 1e3 / calls
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel: no device time to report")
    return {
        "kernels": sum(kernels.values()) / calls,
        "copies": copies / calls,
        "float64_kernels": sum(n for k, n in kernels.items() if "double" in k) / calls,
        "busy_ms": busy_ms,
        "wall_ms": wall_ms,
        "busy_share": busy_ms / wall_ms,
        "top": [{"launches": n / calls, "name": k[:100]} for k, n in kernels.most_common(12)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="import rend3_tpu_torch from this directory")
    ap.add_argument("--flat", action="store_true", help="the flat-material city")
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if "rend3_tpu_torch" in sys.modules:
        if args.tree:
            raise SystemExit("--tree needs the script run as a file, not with -m")
    else:  # run as a file: the package of DIR, or of the tree holding this file
        sys.path.insert(0, os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", "..")))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("frame_launches needs a CUDA device")
    import rend3_tpu_torch
    from rend3_tpu_torch import bench

    runner, keep, ev, target, settings = bench.scene("cuda", not args.flat)
    graph = runner.base_graph
    for _ in range(2):
        graph.render_frame_tensor(ev, target, settings)
    program, fargs = graph.build_frame_callable(ev, target, settings)
    frame = profile_calls(program, fargs, args.calls)
    fn, inputs = graph._last_shadow_call
    shadow = profile_calls(fn, inputs, args.calls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(rend3_tpu_torch.__file__))),
        "scene": "flat" if args.flat else "representative",
        "static_frame": frame,
        "shadow_pass": shadow,
    }))
    del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
