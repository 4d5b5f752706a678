"""Host-side allocators.

`RangeAllocator` backs the mesh megabuffer sub-allocation (reference uses
range-alloc in rend3/src/managers/mesh.rs); `HandleAllocator` is the freelist
index allocator with the one-frame delayed reclaim needed by temporal culling
(reference: rend3/src/managers/handle_alloc.rs:15-77, delay rationale at
:22-29).
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple

__all__ = ["RangeAllocator", "HandleAllocator"]


class RangeAllocator:
    """First-fit free-range allocator over [0, size)."""

    def __init__(self, size: int):
        self.size = size
        self._free: List[Tuple[int, int]] = [(0, size)] if size else []

    def allocate(self, count: int) -> Optional[int]:
        if count == 0:
            return 0
        for i, (start, length) in enumerate(self._free):
            if length >= count:
                if length == count:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + count, length - count)
                return start
        return None

    def free(self, start: int, count: int) -> None:
        if count == 0:
            return
        entry = (start, count)
        idx = bisect.bisect_left(self._free, entry)
        self._free.insert(idx, entry)
        self._coalesce(max(0, idx - 1))

    def _coalesce(self, idx: int) -> None:
        i = idx
        while i + 1 < len(self._free):
            s0, l0 = self._free[i]
            s1, l1 = self._free[i + 1]
            if s0 + l0 == s1:
                self._free[i] = (s0, l0 + l1)
                self._free.pop(i + 1)
            elif s0 + l0 > s1:  # overlapping free — programming error
                raise AssertionError("RangeAllocator corruption")
            else:
                i += 1
                if i > idx + 1:
                    break

    def grow(self, new_size: int) -> None:
        assert new_size >= self.size
        if new_size == self.size:
            return
        self.free(self.size, new_size - self.size)
        self.size = new_size

    def used(self) -> int:
        return self.size - sum(l for _, l in self._free)


class HandleAllocator:
    """Freelist slot allocator. `delayed_reclaim=True` gives deleted slots
    back only after `reclaim()` is called at the top of the *next* frame,
    so in-flight temporal data can still reference them."""

    def __init__(self, kind: str, delayed_reclaim: bool = False):
        self.kind = kind
        self.count = 0
        self._free: List[int] = []
        self._delayed: List[int] = []
        self._delayed_reclaim = delayed_reclaim

    def allocate(self) -> int:
        if self._free:
            return self._free.pop()
        idx = self.count
        self.count += 1
        return idx

    def deallocate(self, idx: int) -> None:
        if self._delayed_reclaim:
            self._delayed.append(idx)
        else:
            self._free.append(idx)

    def reclaim(self) -> List[int]:
        """Move delayed slots to the freelist; returns the reclaimed slots."""
        reclaimed = self._delayed
        self._free.extend(reclaimed)
        self._delayed = []
        return reclaimed
