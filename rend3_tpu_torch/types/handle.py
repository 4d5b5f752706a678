"""Resource handles.

Refcounted owning handles whose final drop enqueues a Delete instruction,
plus raw non-owning index handles (reference: rend3-types/src/lib.rs:33-220).
Python's own refcounting plays the role of the reference's Arc: all clones of
a `ResourceHandle` share one `_HandleCore`, and the core's finalizer invokes
the stored destroy function exactly once.
"""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")

__all__ = ["RawResourceHandle", "ResourceHandle"]


class RawResourceHandle(Generic[T]):
    """Non-owning index into a manager's slot table."""

    __slots__ = ("idx", "kind")

    def __init__(self, idx: int, kind: str):
        self.idx = idx
        self.kind = kind

    def __eq__(self, other) -> bool:
        return isinstance(other, RawResourceHandle) and other.idx == self.idx and other.kind == self.kind

    def __hash__(self) -> int:
        return hash((self.kind, self.idx))

    def __repr__(self) -> str:  # pragma: no cover
        return f"RawResourceHandle<{self.kind}>({self.idx})"


class _HandleCore:
    __slots__ = ("raw", "destroy_fn")

    def __init__(self, raw: RawResourceHandle, destroy_fn: Optional[Callable[[RawResourceHandle], None]]):
        self.raw = raw
        self.destroy_fn = destroy_fn

    def __del__(self):
        fn = self.destroy_fn
        if fn is not None:
            self.destroy_fn = None
            try:
                fn(self.raw)
            except Exception:
                # Finalizers cannot raise; log instead of hiding the drop
                # failure entirely (interpreter shutdown is expected noise).
                import sys

                if sys is not None and not sys.is_finalizing():
                    import logging

                    logging.getLogger(__name__).warning(
                        "dropping %r failed", self.raw, exc_info=True
                    )


class ResourceHandle(Generic[T]):
    """Owning handle; dropping the last clone enqueues deletion."""

    __slots__ = ("_core",)

    def __init__(self, raw: RawResourceHandle, destroy_fn: Optional[Callable[[RawResourceHandle], None]] = None):
        self._core = _HandleCore(raw, destroy_fn)

    @property
    def raw(self) -> RawResourceHandle:
        return self._core.raw

    @property
    def idx(self) -> int:
        return self._core.raw.idx

    @property
    def kind(self) -> str:
        return self._core.raw.kind

    def get_raw(self) -> RawResourceHandle:
        return self._core.raw

    def clone(self) -> "ResourceHandle[T]":
        h = ResourceHandle.__new__(ResourceHandle)
        h._core = self._core
        return h

    def __repr__(self) -> str:  # pragma: no cover
        return f"ResourceHandle<{self.kind}>({self.idx})"
