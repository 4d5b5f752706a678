"""Asset loading abstraction (counterpart of rend3-framework/src/assets.rs;
port of rend3_tpu/framework/assets.py, host code).

Reference behavior (assets.rs:10-100): an `AssetPath` is either Internal
(resolved against the loader's base — a file directory, an Android asset
root, or a base URL depending on platform) or External (used verbatim), and
`AssetLoader.get_asset` fetches the resolved path's bytes. Examples pass
every resource through it so the same code runs from disk or a CDN.

Here the platforms collapse to filesystem + `data:`/`file:` URIs.
Network bases still *resolve* (`get_asset_path`) so path handling is
portable, but fetching them raises `AssetNetworkError` — this runtime has
no egress; apps that need remote assets mirror them locally.
"""

from __future__ import annotations

import base64
import os
import urllib.parse
from dataclasses import dataclass
from typing import Union

from ..types.error import AssetError

__all__ = ["AssetPath", "AssetLoader", "AssetFileError", "AssetNetworkError"]


class AssetFileError(AssetError):
    """reference assets.rs:12-15 AssetError::FileError."""


class AssetNetworkError(AssetError):
    """reference assets.rs:16-19 AssetError::NetworkError (here: egress
    unavailable)."""


@dataclass(frozen=True)
class AssetPath:
    """assets.rs:23-35 — Internal paths join the loader base; External
    paths are absolute and used verbatim."""

    path: str
    external: bool = False

    @staticmethod
    def internal(path: str) -> "AssetPath":
        return AssetPath(path, external=False)

    @staticmethod
    def external_(path: str) -> "AssetPath":
        return AssetPath(path, external=True)


class AssetLoader:
    """Resolve + fetch assets relative to a base directory or URL."""

    def __init__(self, base: str = ""):
        self.base = base

    def get_asset_path(self, path: Union[str, AssetPath]) -> str:
        if isinstance(path, str):
            path = AssetPath.internal(path)
        if path.external:
            return path.path
        # The reference concatenates (assets.rs:31); keep URL bases intact
        # and join filesystem bases portably.
        if "://" in self.base:
            return self.base + path.path
        return os.path.join(self.base, path.path) if self.base else path.path

    def get_asset(self, path: Union[str, AssetPath]) -> bytes:
        full = self.get_asset_path(path)
        scheme = urllib.parse.urlparse(full).scheme
        if scheme in ("http", "https"):
            raise AssetNetworkError(
                f"cannot fetch {full!r}: network egress is unavailable on this "
                "runtime; mirror the asset locally and use a filesystem base"
            )
        if scheme == "data":
            header, _, payload = full.partition(",")
            if header.endswith(";base64"):
                return base64.b64decode(payload)
            return urllib.parse.unquote_to_bytes(payload)
        if scheme == "file":
            full = urllib.parse.urlparse(full).path
        try:
            with open(full, "rb") as f:
                return f.read()
        except OSError as e:
            raise AssetFileError(f"could not read asset {full!r}: {e}") from e
