"""Trace merging, the measured Table-3 breakdown and the Chrome-trace
export (the port of ``repro/obs/report.py``).

Input: per-worker trace payloads (what BYE carries home, what spill files
hold, what the thread transport reads off the registry):

    {"clock": {"offset_s": ..., "rtt_s": ...},
     "threads": {"main": [[kind, t0, t1, arg], ...], "comm": [...]},
     "dropped": 0}

``merge_traces`` shifts every worker span by its clock offset onto the
master's timeline; ``breakdown`` gives the paper's Table-3 accounting
(compute / exposed-comm / update shares of wall) from the aligned spans;
``chrome_trace`` writes the ``traceEvents`` JSON that Perfetto and
chrome://tracing open (one pid per worker, one tid per thread).
"""
from __future__ import annotations

import json

from repro_torch.obs import trace as _trace


def merge_traces(workers: dict, master: dict | None = None) -> dict:
    """workers: wid -> trace payload (above). Returns the merged structure
    with every worker span ALIGNED to the master clock (t + offset); the
    master's own threads (already on its clock) ride along unshifted."""
    out_workers = {}
    for wid, payload in sorted(workers.items(), key=lambda kv: int(kv[0])):
        clk = payload.get("clock") or {}
        off = float(clk.get("offset_s", 0.0))
        threads = {}
        for tname, spans in (payload.get("threads") or {}).items():
            threads[tname] = [[int(k), float(a) + off, float(b) + off,
                               int(arg)] for k, a, b, arg in spans]
        out_workers[int(wid)] = {
            "offset_s": off,
            "rtt_s": float(clk.get("rtt_s", 0.0)),
            "dropped": int(payload.get("dropped", 0)),
            "threads": threads,
        }
    merged = {"workers": out_workers}
    if master and master.get("threads"):
        merged["master"] = {"threads": {
            tname: [[int(k), float(a), float(b), int(arg)]
                    for k, a, b, arg in spans]
            for tname, spans in master["threads"].items()}}
    return merged


def _iter_spans(merged):
    for wid, w in merged["workers"].items():
        for tname, spans in w["threads"].items():
            for s in spans:
                yield wid, tname, s
    for tname, spans in merged.get("master", {}).get("threads", {}).items():
        for s in spans:
            yield "master", tname, s


def breakdown(merged: dict) -> dict:
    """The measured Table-3 accounting. Per worker, over aligned spans:

      compute_s       Σ COMPUTE + LOCAL_STEP            (gradient work)
      exposed_comm_s  Σ waits (BUCKET/COMM/BARRIER/TURN/RECV) — time the
                      training loop sat blocked on a wire or a peer; the
                      quantity overlap exists to shrink
      update_s        Σ UPDATE                           (optimizer math)
      comm_busy_s     Σ EXCHANGE — comm-thread activity (may overlap
                      compute; NOT added to the share decomposition)
      wall_s          span extent (max t1 − min t0 across its threads)

    Shares are fractions of wall; ``comm_share`` is the paper's
    "communication %" — EXPOSED comm only, which is why overlap lowers it
    while comm_busy_s stays put."""
    per = {}
    for wid, w in merged["workers"].items():
        lo, hi = float("inf"), float("-inf")
        acc = {"compute_s": 0.0, "exposed_comm_s": 0.0, "update_s": 0.0,
               "comm_busy_s": 0.0}
        for spans in w["threads"].values():
            for k, a, b, _arg in spans:
                lo, hi = min(lo, a), max(hi, b)
                d = b - a
                if k in _trace.COMPUTE_KINDS:
                    acc["compute_s"] += d
                elif k in _trace.EXPOSED_KINDS:
                    acc["exposed_comm_s"] += d
                elif k in _trace.UPDATE_KINDS:
                    acc["update_s"] += d
                elif k in _trace.COMM_BUSY_KINDS:
                    acc["comm_busy_s"] += d
        wall = max(hi - lo, 1e-12) if hi > lo else 0.0
        per[wid] = {
            "wall_s": round(wall, 6),
            **{k: round(v, 6) for k, v in acc.items()},
            "comm_share": round(acc["exposed_comm_s"] / wall, 4) if wall
            else 0.0,
            "compute_share": round(acc["compute_s"] / wall, 4) if wall
            else 0.0,
            "update_share": round(acc["update_s"] / wall, 4) if wall
            else 0.0,
        }
    n = max(len(per), 1)
    agg = {f"mean_{k}": round(sum(p[k] for p in per.values()) / n, 4)
           for k in ("comm_share", "compute_share", "update_share")}
    return {"workers": per, **agg}


def chrome_trace(merged: dict) -> dict:
    """The Chrome trace-event JSON (``ph:"X"`` complete events, µs units)
    — load the written file at https://ui.perfetto.dev or chrome://tracing.
    Worker wid → pid wid; the master is pid 9999; thread names become tid
    metadata so the timeline reads ``worker 0 / main``, ``… / comm``."""
    t_min = min((s[1] for _, _, s in _iter_spans(merged)),
                default=0.0)
    events = []
    tids: dict = {}

    def _tid(pid, tname):
        key = (pid, tname)
        if key not in tids:
            tids[key] = len([1 for (p, _), _v in tids.items() if p == pid])
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tids[key], "args": {"name": tname}})
        return tids[key]

    for wid in merged["workers"]:
        events.append({"name": "process_name", "ph": "M", "pid": int(wid),
                       "args": {"name": f"worker {wid}"}})
    if "master" in merged:
        events.append({"name": "process_name", "ph": "M", "pid": 9999,
                       "args": {"name": "master"}})
    for who, tname, (k, a, b, arg) in _iter_spans(merged):
        pid = 9999 if who == "master" else int(who)
        events.append({
            "name": _trace.KIND_NAMES.get(k, str(k)), "ph": "X",
            "pid": pid, "tid": _tid(pid, tname),
            "ts": round((a - t_min) * 1e6, 3),
            "dur": round((b - a) * 1e6, 3),
            "args": {"arg": arg},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, merged: dict) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(merged), f)
    return path
