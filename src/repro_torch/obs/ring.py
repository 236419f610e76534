"""Bounded append-only ring: the shared history container (the port's
own copy of ``repro.obs.ring``; it imports nothing but the standard
library).

Long-lived serving processes accumulate history — flush errors, drift
alerts, span roots — and a pathological session must not be able to
grow those lists without bound. :class:`BoundedRing` is the one
container the obs/serve/stream layers share for that: a deque-backed
ring that keeps the newest ``maxlen`` items, counts what it evicted
(``dropped``), and quacks enough like a list (len / iter / index /
bool) that call sites written against plain lists keep working.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, List, TypeVar

T = TypeVar("T")


class BoundedRing:
    """Fixed-capacity newest-wins ring with an eviction counter."""

    __slots__ = ("_items", "dropped")

    def __init__(self, maxlen: int, items: Iterable = ()):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self._items: collections.deque = collections.deque(
            items, maxlen=maxlen
        )
        self.dropped = 0  # items evicted to stay within maxlen

    @property
    def maxlen(self) -> int:
        return self._items.maxlen  # type: ignore[return-value]

    def append(self, item) -> None:
        if len(self._items) == self._items.maxlen:
            self.dropped += 1
        self._items.append(item)

    def extend(self, items: Iterable) -> None:
        for item in items:
            self.append(item)

    def clear(self) -> None:
        """Drop contents *and* the eviction count (a fresh window)."""
        self._items.clear()
        self.dropped = 0

    def drain(self) -> List:
        """Pop everything (oldest first) — the consume-once read."""
        out = list(self._items)
        self._items.clear()
        return out

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._items)[i]
        return self._items[i]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"BoundedRing(maxlen={self.maxlen}, n={len(self)}, "
            f"dropped={self.dropped})"
        )
