"""Per-thread append-only span recorder (the port of
``repro/obs/trace.py``).

A ``Tracer`` belongs to exactly one thread (a worker loop, a comm
executor, a master serve loop), so recording takes no lock. Storage is
preallocated numpy; beyond capacity ``record`` only bumps ``dropped``.
Tracing is off by default: with ``PSConfig.trace`` off no tracer is
created and every instrumentation site sits behind ``if tr is not None``,
so no timestamp and no device synchronise is taken.

Spans on the card. PyTorch returns from a launch before the device has
finished, so a span closed by the host clock right after its launches
would end early and its device time would land in the next span. A tracer
made with ``sync`` (a callable, e.g. the synchronise of the thread's
current CUDA stream) calls it in ``now()`` before reading the clock; every
span of the runtime is opened and closed with ``now()``. Without ``sync``
(the CPU) ``now()`` is ``time.perf_counter()``.

The span kinds and the Table-3 classes at the bottom are the reference's:
``obs.report.breakdown`` reads them.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

# -- span kinds --------------------------------------------------------------
COMPUTE = 0        # one exchange-step gradient computation
LOCAL_STEP = 1     # the τ−1 local-only steps between exchanges (one span)
EXCHANGE = 2       # one full all-reduce on the comm executor / comm thread
ROUND = 3          # one message round of an exchange (arg = round index)
BUCKET = 4         # one bucket's rounds (arg = bucket)
BUCKET_WAIT = 5    # main thread blocked for a bucket to land (arg = bucket)
COMM_WAIT = 6      # main thread blocked on exchange completion
UPDATE = 7         # optimizer update (arg = bucket, −1 = whole row)
BARRIER = 8        # barrier wait (arg: 0 = A, 1 = B, 2 = C)
TURN_WAIT = 9      # turnstile / master-lock admission wait
RECV_WAIT = 10     # blocked on the master link (WEIGHTS down / grads in)
EVAL = 11          # eval-function snapshot (master only)

KIND_NAMES = {
    COMPUTE: "compute", LOCAL_STEP: "local_step", EXCHANGE: "exchange",
    ROUND: "round", BUCKET: "bucket", BUCKET_WAIT: "bucket_wait",
    COMM_WAIT: "comm_wait", UPDATE: "update", BARRIER: "barrier",
    TURN_WAIT: "turn_wait", RECV_WAIT: "recv_wait", EVAL: "eval",
}

# Table-3 classes: a worker's wall time is gradient compute, EXPOSED
# communication (its update path blocked on a wire or a barrier) and the
# optimizer update. EXCHANGE / ROUND / BUCKET are comm-thread busy spans:
# where bytes moved, not time the training loop lost.
COMPUTE_KINDS = frozenset({COMPUTE, LOCAL_STEP})
EXPOSED_KINDS = frozenset({BUCKET_WAIT, COMM_WAIT, BARRIER, TURN_WAIT,
                           RECV_WAIT})
UPDATE_KINDS = frozenset({UPDATE})
COMM_BUSY_KINDS = frozenset({EXCHANGE})

DEFAULT_CAPACITY = 1 << 16


class Tracer:
    """One thread's span buffer. ``record(kind, t0, t1, arg)`` appends;
    past ``capacity`` it counts ``dropped`` instead of growing."""

    __slots__ = ("name", "wid", "capacity", "n", "dropped", "sync",
                 "_t0", "_t1", "_kind", "_arg")

    def __init__(self, name: str, wid: int = -1,
                 capacity: int = DEFAULT_CAPACITY, sync=None):
        self.name = name
        self.wid = wid
        self.capacity = int(capacity)
        self.n = 0
        self.dropped = 0
        self.sync = sync
        self._t0 = np.empty(self.capacity, np.float64)
        self._t1 = np.empty(self.capacity, np.float64)
        self._kind = np.empty(self.capacity, np.int32)
        self._arg = np.empty(self.capacity, np.int64)

    def now(self) -> float:
        """The host clock after the device work queued so far (``sync``)."""
        if self.sync is not None:
            self.sync()
        return time.perf_counter()

    def record(self, kind: int, t0: float, t1: float, arg: int = 0) -> None:
        i = self.n
        if i >= self.capacity:
            self.dropped += 1
            return
        self._t0[i] = t0
        self._t1[i] = t1
        self._kind[i] = kind
        self._arg[i] = arg
        self.n = i + 1

    def spans(self) -> list:
        """``[[kind, t0, t1, arg], ...]`` in record order — the JSON form
        carried home in BYE and in spill files."""
        return [[int(self._kind[i]), float(self._t0[i]), float(self._t1[i]),
                 int(self._arg[i])] for i in range(self.n)]


# -- registry: creation takes the lock, recording never does -----------------
_LOCK = threading.Lock()
_TRACERS: list = []


def tracer(name: str, wid: int = -1, capacity: int = DEFAULT_CAPACITY,
           sync=None) -> Tracer:
    """Create and register a tracer. Callers create one only when tracing
    is on: an empty registry is the disabled state."""
    t = Tracer(name, wid=wid, capacity=capacity, sync=sync)
    with _LOCK:
        _TRACERS.append(t)
    return t


def drain() -> list:
    """Pop every registered tracer."""
    with _LOCK:
        out, _TRACERS[:] = list(_TRACERS), []
    return out


def stats() -> dict:
    """Registry totals (all 0 when tracing is off)."""
    with _LOCK:
        ts = list(_TRACERS)
    return {"tracers": len(ts), "records": sum(t.n for t in ts),
            "dropped": sum(t.dropped for t in ts)}


# -- spill files -------------------------------------------------------------

def spill_path(trace_dir: str, wid: int) -> str:
    return os.path.join(trace_dir, f"trace-w{wid}.json")


def dump_spill(trace_dir: str, wid: int, payload: dict) -> str:
    """Write one worker's trace payload (``{"clock", "threads",
    "dropped"}``) under ``trace_dir``; returns the path."""
    os.makedirs(trace_dir, exist_ok=True)
    path = spill_path(trace_dir, wid)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def load_spill(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
