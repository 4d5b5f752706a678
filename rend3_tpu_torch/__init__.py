"""rend3-tpu-torch: the PyTorch + CUDA port of rend3_tpu.

The same retained-mode renderer (handle-and-instruction scene API, managers,
deferred visibility-buffer frame, shadows) on PyTorch, with every kernel the
JAX package wrote in Pallas for the TPU written by hand in CUDA C++ for
Hopper (csrc/). The JAX package stays in the repository as the reference;
this package never imports it, nor jax.
"""

import torch as _torch

# Vertex transforms and shading must be true float32, as
# rend3_tpu/__init__.py:13-15 sets for JAX: TF32 would shift rasterized edges.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import types  # noqa: E402,F401
from .core.renderer import Renderer  # noqa: E402,F401
from .types import Camera, Handedness, MeshBuilder, Object  # noqa: E402,F401

__version__ = "0.1.0"
