"""The rend3 examples on the port (ports of examples/*.py).

Each runs as `python3 -m rend3_tpu_torch.examples.<name>` and takes `--out`
(default `<name>-torch.png`, beside the JAX package's committed renders
without replacing them), `--width` / `--height` (default 1280x720, the
reference screenshots' size) and `--device` (default the card; "cpu"
renders on the CPU). Examples that read assets take the asset's path as an
argument; the default is the file the JAX example reads, under the
reference checkout that the environment variable REND3_REFERENCE names. An absent file stops the example with an
error naming it: nothing is fetched and nothing stands in for it. The App
classes also take the path, or the file's bytes, as a constructor argument.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["REFERENCE_ROOT", "reference_asset", "asset_bytes", "parser", "run"]

# Root of a checkout of the reference repository (its examples/src holds the
# example assets).
REFERENCE_ROOT = os.environ.get("REND3_REFERENCE", "")


def reference_asset(rel: str) -> str:
    """Path of an asset of the reference checkout, e.g.
    "examples/src/static_gltf/data.glb"."""
    return os.path.join(REFERENCE_ROOT, rel)


def asset_bytes(source: Union[str, bytes], what: str) -> Tuple[bytes, Optional[str]]:
    """(bytes, base directory or None) of an asset given as a path or as
    its bytes. A path that does not exist raises FileNotFoundError."""
    if isinstance(source, (bytes, bytearray)):
        return bytes(source), None
    if not os.path.isfile(source):
        raise FileNotFoundError(
            f"{what} not found at {source!r}: pass its path (the reference checkout's "
            "examples/src holds it; set REND3_REFERENCE to that checkout's root)"
        )
    with open(source, "rb") as f:
        return f.read(), os.path.dirname(os.path.abspath(source))


def parser(description: str, out: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--out", default=out, help="PNG to write")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    return p


def run(make_app, args) -> np.ndarray:
    """Render one frame of make_app() through the framework, write it to
    args.out and return it. A missing asset exits with its error."""
    from .. import framework
    from ..testing import save_png

    try:
        app = make_app()
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    img = framework.render_single_frame(app, args.width, args.height, device=args.device)
    save_png(args.out, img)
    print(f"wrote {args.out}")
    return img
