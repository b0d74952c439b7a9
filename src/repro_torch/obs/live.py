"""The live telemetry plane: streaming time series and online health
detection (a copy of ``repro/obs/live.py``).

 * ``Ring`` / ``TimeSeries`` — preallocated ring buffers keyed
   ``(wid, metric)``. Every telemetry-bearing HEARTBEAT the tcp master
   receives lands here (push: ``net.wire.Link.hb_hook`` fires on the
   reader thread), and a master-side sampler thread adds periodic reads of
   the ``metrics.Registry`` gauges (heartbeat staleness, ef_ratio,
   aggregate counters) under the reserved wid −1. Fixed capacity,
   overwrite-oldest: a week-long run costs the memory of a minute-long one.
 * ``HealthDetector`` — ``ft.straggler.BoundedStaleness`` on measured
   signal: per-window worker rates become per-exchange delays (1/rate),
   the policy's median-deadline mask flags stragglers, heartbeat age flags
   silence. Detection only: no membership change, no change to the math.
 * ``LiveMonitor`` — owns both plus the optional JSONL stream
   (``PSConfig.telemetry_jsonl``); its ``snapshot()`` is what the master
   serves to ``launch.monitor`` over the STATS frame and what lands on
   ``PSResult.health``.

Events are dicts ``{"t", "kind", "wid", ...}`` with kinds ``straggler`` /
``hb_stale`` / ``recovered`` / ``worker_left`` / ``worker_dead`` and the
membership plane's lifecycle kinds; each one adds one to
``counters["health_events"]``. Everything here is off by default
(``PSConfig.telemetry``): an untouched config allocates no store, starts
no thread, takes no timestamps. Every value stored is a plain Python
number: a tensor gauge is read with ``.item()`` by the caller.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.ft.straggler import BoundedStaleness

AGG_WID = -1                 # the master's own aggregate-gauge series
_SPARK = "▁▂▃▄▅▆▇█"


class Ring:
    """Preallocated (t, value) ring buffer — push is O(1), no allocation
    after construction, oldest samples silently overwritten."""

    __slots__ = ("capacity", "n", "_i", "_t", "_v")

    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError(f"capacity={capacity}")
        self.capacity = capacity
        self.n = 0                       # samples held (≤ capacity)
        self._i = 0                      # next write slot
        self._t = np.zeros(capacity)
        self._v = np.zeros(capacity)

    def push(self, t: float, v: float) -> None:
        self._t[self._i] = t
        self._v[self._i] = v
        self._i = (self._i + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def values(self) -> tuple:
        """(t, v) arrays in chronological order (copies)."""
        if self.n < self.capacity:
            return self._t[:self.n].copy(), self._v[:self.n].copy()
        idx = np.r_[self._i:self.capacity, 0:self._i]
        return self._t[idx], self._v[idx]

    def last(self):
        """(t, v) of the newest sample, or None if empty."""
        if not self.n:
            return None
        j = (self._i - 1) % self.capacity
        return float(self._t[j]), float(self._v[j])


class TimeSeries:
    """The store: ``(wid, metric) -> Ring``. Not thread-safe by itself —
    LiveMonitor serializes access (reader threads push, sampler samples,
    STATS acceptor snapshots)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._series: dict = {}

    def record(self, wid: int, metric: str, value, t: float) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return                       # non-numeric telemetry: not a series
        ring = self._series.get((wid, metric))
        if ring is None:
            ring = self._series[(wid, metric)] = Ring(self.capacity)
        ring.push(t, v)

    def series(self, wid: int, metric: str) -> Optional[Ring]:
        return self._series.get((wid, metric))

    def last(self, wid: int, metric: str):
        ring = self._series.get((wid, metric))
        return ring.last()[1] if ring is not None and ring.n else None

    def wids(self) -> list:
        return sorted({w for w, _ in self._series})

    def metrics(self, wid: int) -> list:
        return sorted(m for w, m in self._series if w == wid)

    def tail(self, k: int = 32) -> dict:
        """{wid: {metric: [[t, v], ...]}} — the newest ≤k samples of every
        series, JSON-ready (what the STATS frame carries)."""
        out: dict = {}
        for (wid, metric), ring in sorted(self._series.items()):
            t, v = ring.values()
            out.setdefault(wid, {})[metric] = [
                [round(float(a), 3), float(b)]
                for a, b in zip(t[-k:], v[-k:])]
        return out


def sparkline(values, width: int = 24) -> str:
    """Unicode sparkline of the last ``width`` values (monitor rendering)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[3] * len(vals)
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


class HealthDetector:
    """Online straggler / heartbeat-silence detection over the store's
    latest per-worker samples.

    Rates → delays: a worker iterating at r ips spends 1/r s per iteration,
    so ``BoundedStaleness.participation`` (median × deadline_factor over
    delays, quorum-floored) applies verbatim — the SAME policy the sync
    family would use to mask an exchange, here consuming measured signal.
    A worker is flagged only after ``strikes`` consecutive observations
    (one noisy sample must not flag; with the sampler at the heartbeat
    period, strikes=2 ⇒ detection within 2 heartbeat intervals). Rate
    detection waits until EVERY worker has a positive rate — during
    problem build rates are 0 and medians are meaningless. State
    transitions emit events; steady states do not.
    """

    RATE_METRIC = "rate_ips"

    def __init__(self, n_workers: int, deadline_factor: float = 2.0,
                 stale_after_s: float = 6.0, strikes: int = 2,
                 min_quorum: float = 0.5):
        self.n_workers = n_workers
        self.policy = BoundedStaleness(
            n_pods=n_workers, deadline_factor=deadline_factor,
            min_quorum=min_quorum)
        self.stale_after_s = stale_after_s
        self.strikes = max(int(strikes), 1)
        self._strike: dict = {}          # (wid, kind) -> consecutive count
        self.flagged: dict = {}          # wid -> kind currently flagged
        self._step = 0

    def set_n_workers(self, n_workers: int) -> None:
        """Elastic membership changed P: the straggler mask requires a full
        complement of rates, so the detector must learn the new P or it
        would wait forever for the dead worker's heartbeat. Strike state
        resets — the new epoch starts with a clean slate."""
        self.n_workers = n_workers
        self.policy.n_pods = n_workers
        self._strike.clear()

    def observe(self, t: float, rates: dict, staleness: dict) -> list:
        """One detector pass. ``rates``: {wid: latest rate_ips or None};
        ``staleness``: {wid: seconds since last heartbeat}. Returns the
        NEW events (transitions only)."""
        self._step += 1
        current: dict = {}               # wid -> kind observed this pass
        detail: dict = {}
        for wid, s in staleness.items():
            if s > self.stale_after_s:
                current[wid] = "hb_stale"
                detail[wid] = {"hb_age_s": round(float(s), 3)}
        active = {w: r for w, r in rates.items()
                  if r is not None and r > 0.0}
        if len(active) == self.n_workers:
            wids = sorted(active)
            delays = [1.0 / active[w] for w in wids]
            mask = self.policy.participation(self._step, delays)
            med = float(np.median([active[w] for w in wids]))
            for w, m in zip(wids, mask):
                if m == 0 and w not in current:
                    current[w] = "straggler"
                    detail[w] = {"rate_ips": active[w],
                                 "median_rate_ips": round(med, 2)}
        events = []
        for wid, kind in current.items():
            key = (wid, kind)
            self._strike[key] = self._strike.get(key, 0) + 1
            if (self._strike[key] >= self.strikes
                    and self.flagged.get(wid) != kind):
                self.flagged[wid] = kind
                events.append({"t": round(t, 3), "kind": kind, "wid": wid,
                               **detail.get(wid, {})})
        for key in list(self._strike):
            if current.get(key[0]) != key[1]:
                del self._strike[key]
        for wid in list(self.flagged):
            if wid not in current:
                events.append({"t": round(t, 3), "kind": "recovered",
                               "wid": wid,
                               "was": self.flagged.pop(wid)})
        return events


class LiveMonitor:
    """Store + detector + JSONL stream behind one lock. The master feeds it
    from three threads (per-link readers via ``ingest_hb``, the sampler via
    ``sample``, the STATS acceptor via ``snapshot``); the shared-memory
    transports call ``sample`` from the launcher poll loop with aggregate
    gauges only (no per-worker heartbeats there — honest boundary)."""

    def __init__(self, n_workers: int, deadline_factor: float = 2.0,
                 hb_interval_s: float = 2.0, stale_after_s: float = 0.0,
                 capacity: int = 512, jsonl_path: Optional[str] = None,
                 counters=None, meta: Optional[dict] = None):
        self.store = TimeSeries(capacity=capacity)
        self.detector = HealthDetector(
            n_workers, deadline_factor=deadline_factor,
            stale_after_s=stale_after_s or max(3.0 * hb_interval_s, 1.0))
        self.events: list = []
        self._retired: set = set()       # wids no longer in the run — their
        #                                  stale ring samples must not feed
        #                                  the detector after an epoch change
        self.counters = counters         # metrics.Registry (health_events)
        self.meta = dict(meta or {})
        self.n_samples = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._jsonl = open(jsonl_path, "w") if jsonl_path else None
        if self._jsonl is not None:
            # eager run-header line: even a run shorter than the first
            # sampler tick leaves a parseable record of what it was
            json.dump({"meta": self.meta, "n_workers": n_workers,
                       "hb_interval_s": hb_interval_s}, self._jsonl)
            self._jsonl.write("\n")
            self._jsonl.flush()

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _emit(self, events: list) -> None:
        self.events.extend(events)
        if events and self.counters is not None:
            self.counters.counter("health_events").value += len(events)

    # -- feeds ---------------------------------------------------------------

    def ingest_hb(self, wid: int, payload: dict) -> None:
        """Called from a link reader thread on EVERY telemetry-bearing
        HEARTBEAT: each numeric field becomes one sample (covers future
        fields — a worker reporting ``loss`` lands here unchanged)."""
        t = self._now()
        with self._lock:
            for key, value in payload.items():
                self.store.record(wid, key, value, t)

    def sample(self, staleness: Optional[dict] = None,
               gauges: Optional[dict] = None) -> list:
        """One sampler pass: record master-side per-worker staleness and
        aggregate gauges (wid −1), run the detector over the latest rates,
        stream the sample to JSONL. Returns the new events."""
        t = self._now()
        with self._lock:
            staleness = dict(staleness or {})
            for wid, s in staleness.items():
                self.store.record(wid, "hb_staleness_s", s, t)
            for key, value in (gauges or {}).items():
                self.store.record(AGG_WID, key, value, t)
            rates = {w: self.store.last(w, HealthDetector.RATE_METRIC)
                     for w in self.store.wids()
                     if w >= 0 and w not in self._retired}
            if staleness and not rates:
                rates = {w: None for w in staleness}
            events = self.detector.observe(t, rates, staleness) \
                if rates else []
            self._emit(events)
            self.n_samples += 1
            if self._jsonl is not None:
                json.dump({"t": round(t, 3),
                           "workers": self._latest_locked(),
                           "gauges": {k: v for k, v in (gauges or {}).items()
                                      if isinstance(v, (int, float))},
                           "events": events}, self._jsonl)
                self._jsonl.write("\n")
                self._jsonl.flush()
        return events

    def set_membership(self, active_wids) -> None:
        """Elastic epoch change: the detector tracks the new P and retired
        wids stop feeding it (their last ring samples would otherwise count
        as live rates forever)."""
        wids = sorted(int(w) for w in active_wids)
        with self._lock:
            self._retired = {w for w in self.store.wids()
                             if w >= 0 and w not in wids}
            self.detector.set_n_workers(len(wids))

    def mark_worker_event(self, wid: int, kind: str, detail: str = ""
                          ) -> dict:
        """Lifecycle events the wire observes directly (mid-run BYE, dead
        socket) — no debouncing, the signal is unambiguous."""
        ev = {"t": round(self._now(), 3), "kind": kind, "wid": wid}
        if detail:
            ev["detail"] = detail
        with self._lock:
            self._emit([ev])
            if self._jsonl is not None:
                # event-only record: the JSONL stream must name the death /
                # recovery even if the run ends before the next sampler tick
                # (launch/monitor --from-jsonl folds bare event lines in)
                json.dump({"t": ev["t"], "events": [ev]}, self._jsonl)
                self._jsonl.write("\n")
                self._jsonl.flush()
        return ev

    # -- reads ---------------------------------------------------------------

    def _latest_locked(self) -> dict:
        out: dict = {}
        for wid in self.store.wids():
            if wid < 0:
                continue
            out[wid] = {m: self.store.last(wid, m)
                        for m in self.store.metrics(wid)}
        return out

    def snapshot(self, k: int = 32) -> dict:
        """JSON-ready state: what the STATS frame serves and what
        ``health()`` summarizes."""
        with self._lock:
            return {"t": round(self._now(), 3),
                    "meta": dict(self.meta),
                    "n_samples": self.n_samples,
                    "events": list(self.events),
                    "flagged": {str(w): k
                                for w, k in self.detector.flagged.items()},
                    "workers": self.store.tail(k),
                    "gauges": {m: self.store.last(AGG_WID, m)
                               for m in self.store.metrics(AGG_WID)}}

    def health(self) -> dict:
        """The ``PSResult.health`` payload: events + final per-worker
        telemetry, compact (no series history)."""
        with self._lock:
            return {"events": list(self.events),
                    "flagged": {str(w): k
                                for w, k in self.detector.flagged.items()},
                    "n_samples": self.n_samples,
                    "workers": self._latest_locked()}

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def render(snap: dict, width: int = 24) -> str:
    """The monitor's table: one row per worker from a ``snapshot()`` dict
    (shared by ``launch/monitor`` live mode and its --from-jsonl mode)."""
    meta = snap.get("meta", {})
    lines = [
        "run: {algo} [{transport}] t={t:.1f}s samples={n} "
        "health_events={ev}".format(
            algo=meta.get("algorithm", "?"),
            transport=meta.get("transport", "?"),
            t=snap.get("t", 0.0), n=snap.get("n_samples", 0),
            ev=len(snap.get("events", []))),
        f"{'wid':>4} {'iters':>8} {'rate_ips':>9} {'exposed_s':>9} "
        f"{'hb_age':>7} {'status':<10} rate history",
    ]
    flagged = snap.get("flagged", {})
    for wid, series in sorted(snap.get("workers", {}).items(),
                              key=lambda kv: int(kv[0])):
        w = int(wid)
        if w < 0:
            continue

        def _last(metric):
            pts = series.get(metric) or []
            return pts[-1][1] if pts else None

        rate_pts = series.get("rate_ips") or []
        kind = flagged.get(str(w)) or flagged.get(w)
        status = kind.upper() if kind else "ok"
        iters = _last("iters")
        rate = _last("rate_ips")
        hb = _last("hb_staleness_s")
        exposed = _last("exposed_s")
        lines.append(
            f"{w:>4} "
            f"{int(iters) if iters is not None else '-':>8} "
            f"{f'{rate:.1f}' if rate is not None else '-':>9} "
            f"{f'{exposed:.2f}' if exposed is not None else '-':>9} "
            f"{f'{hb:.1f}' if hb is not None else '-':>7} "
            f"{status:<10} "
            f"{sparkline([v for _, v in rate_pts], width)}")
    for ev in snap.get("events", [])[-5:]:
        lines.append(f"  event t={ev.get('t')}s wid={ev.get('wid')} "
                     f"{ev.get('kind')}"
                     + (f" ({ev.get('detail')})" if ev.get("detail") else ""))
    gauges = snap.get("gauges") or {}
    if gauges:
        shown = ", ".join(f"{k}={v}" for k, v in sorted(gauges.items())
                          if isinstance(v, (int, float)))
        if shown:
            lines.append(f"  master: {shown}")
    return "\n".join(lines)
