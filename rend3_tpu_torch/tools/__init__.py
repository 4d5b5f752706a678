"""Entry points of the bf16 probes P1-P3 (kernels in ops/probe_bf16.py).

    python3 -m rend3_tpu_torch.tools.probe_bf16_dot      # P1
    python3 -m rend3_tpu_torch.tools.probe_bf16_kernel   # P2
    python3 -m rend3_tpu_torch.tools.probe_bf16_real     # P3

Each is the counterpart of the JAX probe of the same name under tools/:
the same variants under the same names, the same inputs drawn from an
explicit numpy generator in the JAX probe's order, one printed line per
variant. Each module's `run(device="cuda", seed=0)` runs every variant on
the card (the CPU when asked) and returns a `ProbeRun` per variant.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["ProbeRun", "device_for", "init_out"]


class ProbeRun(NamedTuple):
    name: str                    # the JAX probe's variant name
    kernels: Tuple[str, ...]     # launch counters (ops/probe_bf16.launches) the variant uses
    out: torch.Tensor            # the variant's output from this run
    plain: Callable[[], torch.Tensor]    # the variant through the plain versions
    note: str = ""               # what the variant's line adds after "OK"
    args: dict = {}              # the variant's input tensors by name (for timing one kernel alone)


def device_for(device) -> torch.device:
    """The device to run on; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device (none is available); pass device='cpu' for the CPU")
    return dev


def init_out(shape, init: str, device) -> torch.Tensor:
    """An output buffer as a probe starts it: NaN (what interpret mode
    leaves in output memory no step writes) or zeros."""
    if init not in ("nan", "zero"):
        raise ValueError(f"init must be 'nan' or 'zero', got {init!r}")
    return torch.full(shape, float("nan") if init == "nan" else 0.0, dtype=torch.float32, device=device)
