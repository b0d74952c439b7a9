"""Elastic membership: the master-side worker state machine (a copy of
``repro/ft/membership.py``).

The paper's HPC regime assumes a fixed, reliable P; a production runtime has
to treat P as a fluid. This module owns the bookkeeping half of that story —
who is in the run, what state they are in, and which *epoch* of the schedule
they belong to — while ``net.server`` owns the wire actions (freezing the
superstep, re-resolving rounds, shipping RECONFIGURE frames).

State machine (per worker)::

    JOINED ──READY──► ACTIVE ──hb stale──► SUSPECT ──timeout/ERROR──► DEAD
       │                 │                    │
       │                 ├──BYE preempted────►└──────────────────────► LEFT
       │                 └──ERROR/socket drop───────────────────────► DEAD
    DEAD/LEFT ──rejoin HELLO──► JOINED (next epoch)

Transitions bump nothing by themselves; ``epoch`` advances only when the
server completes a reconfiguration (survivors re-scheduled, mesh rewired).
The table is transport-agnostic; today only the tcp master drives it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

JOINED = "joined"      # HELLO accepted, not yet READY
ACTIVE = "active"      # participating in the current epoch
SUSPECT = "suspect"    # heartbeat stale — not yet declared lost
DEAD = "dead"          # socket drop / ERROR frame / process exit
LEFT = "left"          # clean mid-run BYE (preemption)

STATES = (JOINED, ACTIVE, SUSPECT, DEAD, LEFT)
_LOST = (DEAD, LEFT)


@dataclass
class Member:
    wid: int
    state: str = JOINED
    epoch: int = 0          # epoch the member (re)joined at
    since: float = field(default_factory=time.monotonic)
    detail: str = ""

    def _move(self, state: str, detail: str = "") -> None:
        self.state = state
        self.since = time.monotonic()
        self.detail = detail


class MembershipTable:
    """Thread-safe membership table for one run.

    The master's reader threads mark transitions; the serve loop reads
    ``survivors()`` and drives reconfigurations. All mutation is under one
    lock — membership changes are rare (human-timescale) events, never on
    the per-round hot path.
    """

    def __init__(self, n_workers: int):
        self._lock = threading.Lock()
        self.epoch = 0
        self.members = {w: Member(w) for w in range(n_workers)}
        self.history: list[dict] = []     # transition log, JSON-able

    def _record(self, m: Member, prev: str) -> None:
        self.history.append({"wid": m.wid, "from": prev, "to": m.state,
                             "epoch": self.epoch, "detail": m.detail})

    def _transition(self, wid: int, state: str, detail: str = "") -> None:
        with self._lock:
            m = self.members.setdefault(wid, Member(wid))
            prev = m.state
            if prev == state:
                return
            m._move(state, detail)
            self._record(m, prev)

    # --- transitions, named for the wire events that drive them ---
    def mark_ready(self, wid: int) -> None:
        self._transition(wid, ACTIVE)

    def mark_suspect(self, wid: int, detail: str = "hb stale") -> None:
        with self._lock:
            m = self.members[wid]
            if m.state == ACTIVE:
                prev = m.state
                m._move(SUSPECT, detail)
                self._record(m, prev)

    def mark_dead(self, wid: int, detail: str = "") -> None:
        self._transition(wid, DEAD, detail)

    def mark_left(self, wid: int, detail: str = "preempted") -> None:
        self._transition(wid, LEFT, detail)

    def mark_rejoined(self, wid: int) -> None:
        """A respawned worker HELLOed with the rejoin flag: back to JOINED;
        it becomes ACTIVE at the next reconfiguration epoch."""
        with self._lock:
            m = self.members.setdefault(wid, Member(wid))
            prev = m.state
            m._move(JOINED, "rejoin")
            m.epoch = self.epoch + 1    # enters at the NEXT epoch
            self._record(m, prev)

    def advance_epoch(self) -> int:
        """A reconfiguration completed: everyone JOINED/SUSPECT-surviving
        becomes ACTIVE in the new epoch. Returns the new epoch number."""
        with self._lock:
            self.epoch += 1
            for m in self.members.values():
                if m.state in (JOINED, SUSPECT):
                    prev = m.state
                    m._move(ACTIVE, f"epoch {self.epoch}")
                    m.epoch = self.epoch
                    self._record(m, prev)
            return self.epoch

    # --- reads ---
    def state(self, wid: int) -> str:
        with self._lock:
            return self.members[wid].state

    def is_lost(self, wid: int) -> bool:
        with self._lock:
            m = self.members.get(wid)
            return m is not None and m.state in _LOST

    def survivors(self) -> list[int]:
        """wids still in the run (ACTIVE or SUSPECT — a suspect is given the
        benefit of the doubt until declared), sorted ascending so the lowest
        survivor is a deterministic leader choice."""
        with self._lock:
            return sorted(w for w, m in self.members.items()
                          if m.state in (ACTIVE, SUSPECT))

    def joiners(self) -> list[int]:
        with self._lock:
            return sorted(w for w, m in self.members.items()
                          if m.state == JOINED)

    def snapshot(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "members": {w: m.state for w, m in self.members.items()},
                    "transitions": list(self.history)}


def dense_rank_map(survivors: list[int]) -> dict[int, int]:
    """dense rank (0..P'−1) → real wid, for remapping schedule rounds built
    over a dense index space onto the surviving members."""
    return {rank: wid for rank, wid in enumerate(sorted(survivors))}
