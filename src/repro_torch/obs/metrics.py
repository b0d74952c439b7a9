"""Named counter / gauge cells and schedule-level exchange accounting (the
port of ``repro/obs/metrics.py``).

A counter is any object with a ``.value``: a ``Slot`` here, a
``multiprocessing.RawValue`` on the process transport. ``Registry`` names
them and behaves like the dict of cells the call sites index
(``counters["wire_bytes"].value += n``), so ``Link._count`` and
``execute_rounds`` run against either.
"""
from __future__ import annotations


class Slot:
    """A mutable counter cell (mirrors ``mp.RawValue``'s ``.value``)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value

    def __repr__(self):
        return f"Slot({self.value!r})"


class Registry:
    """Named cells with ``.value`` semantics. ``counter(name, cell=...)``
    adopts an externally owned cell under a name instead of allocating
    one; mapping-style access returns the cell."""

    def __init__(self):
        self._slots: dict = {}

    def counter(self, name: str, cell=None):
        """Get or create (optionally adopting ``cell``)."""
        slot = self._slots.get(name)
        if slot is None:
            slot = self._slots[name] = Slot() if cell is None else cell
        return slot

    gauge = counter          # the same cell: gauges are set, counters added

    def add(self, name: str, v) -> None:
        self.counter(name).value += v

    def set(self, name: str, v) -> None:
        self.counter(name).value = v

    def snapshot(self) -> dict:
        """``{name: value}`` of every cell."""
        return {k: s.value for k, s in self._slots.items()}

    def __getitem__(self, name: str):
        return self._slots[name]

    def get(self, name: str, default=None):
        return self._slots.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def __iter__(self):
        return iter(self._slots)

    def items(self):
        return self._slots.items()

    def __len__(self) -> int:
        return len(self._slots)


def count_round(counters, rnd, n_elements: int) -> None:
    """One executed message round costs one sync_round, len(rnd) messages
    and Σ frac·n·8 logical wire bytes — invariant under bucketing, which
    repartitions frames, not messages. ``counters`` maps names to cells
    with a ``.value``."""
    counters["sync_rounds"].value += 1
    counters["messages"].value += len(rnd)
    counters["wire_bytes"].value += int(
        sum(m.frac for m in rnd) * n_elements * 8)
