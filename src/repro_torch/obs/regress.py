"""BENCH_*.json perf-regression gate — compare two runs metric by metric
(a copy of ``repro/obs/regress.py``).

    PYTHONPATH=src python -m repro_torch.obs.regress BASELINE.json CURRENT.json \
        [--tol 0.25] [--metrics iters_per_sec] [--warn-only]
    PYTHONPATH=src python -m repro_torch.obs.regress bench_history/fig6_8_convergence

Every ``BENCH_*.json`` the repo writes embeds run metadata and numeric
results in one of three shapes (benchmarks/run.py rows with ``derived``
k=v strings, fig6_8's ``algorithms`` list, ad-hoc smoke dicts);
``flatten_metrics`` reduces all of them to one flat
``{dotted.path: float}`` namespace so the comparison is shape-agnostic.

Direction is inferred from the metric name: throughput-like metrics
(``iters_per_sec``, ``rate_ips``, ``ef_ratio``) regress when they DROP
below tolerance, cost-like metrics (``*_s``, ``us_per_*``, ``*bytes*``,
``*err*``) when they RISE; unrecognized metrics are reported as two-sided
drift notes, never failures — a gate must not fail on a metric it cannot
interpret. Exit 1 on any regression unless ``--warn-only`` (CI's
first-landing mode). With a single directory argument (the
``bench_history/<name>/`` trail appended by ``benchmarks/run.py``) the two
newest files are compared.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_SKIP_KEYS = {"meta", "curve_real", "curve_des", "history", "argv",
              "trace", "rows_meta"}
_HIGHER_BETTER = ("iters_per_sec", "per_sec", "rate_ips", "ef_ratio",
                  "overlapped", "ips")
_LOWER_BETTER = ("us_per", "_s", "time", "bytes", "err", "loss",
                 "exposed", "staleness", "alpha", "dropped")


def _direction(key: str) -> str:
    """'up' = higher is better, 'down' = lower is better, '?' = unknown."""
    low = key.lower()
    leaf = low.rsplit(".", 1)[-1]
    for pat in _HIGHER_BETTER:
        if pat in leaf:
            return "up"
    for pat in _LOWER_BETTER:
        if pat in leaf:
            return "down"
    return "?"


def _parse_derived(s: str) -> dict:
    """'final_err=0.040;t_to_0.25=0.202s' → numeric dict (units stripped)."""
    out = {}
    for part in str(s).split(";"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        v = v.strip().rstrip("xs%")      # 0.202s / 5.3x / 83%
        try:
            out[k.strip()] = float(v)
        except ValueError:
            pass
    return out


def flatten_metrics(obj, prefix: str = "") -> dict:
    """Reduce any BENCH record to {dotted.path: float}. Lists of dicts are
    keyed by their 'name'/'algorithm'/'module' field when present (rows,
    fig6_8 algorithms), by index otherwise; inf/nan leaves are dropped."""
    out: dict = {}

    def _put(key, v):
        try:
            f = float(v)
        except (TypeError, ValueError):
            return
        if f == f and abs(f) != float("inf"):    # not nan, not inf
            out[key] = f

    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in _SKIP_KEYS:
                continue
            key = f"{prefix}.{k}" if prefix else str(k)
            if k == "derived":
                for dk, dv in _parse_derived(v).items():
                    _put(f"{prefix}.{dk}" if prefix else dk, dv)
            elif isinstance(v, bool):
                continue
            elif isinstance(v, (int, float)):
                _put(key, v)
            elif isinstance(v, (dict, list)):
                out.update(flatten_metrics(v, key))
    elif isinstance(obj, list):
        for i, item in enumerate(obj):
            if isinstance(item, dict):
                label = item.get("name") or item.get("algorithm") \
                    or item.get("module") or str(i)
                sub = {k: v for k, v in item.items()
                       if k not in ("name", "algorithm", "module")}
                out.update(flatten_metrics(
                    sub, f"{prefix}.{label}" if prefix else str(label)))
            elif isinstance(item, (int, float)) and not isinstance(item,
                                                                   bool):
                # numeric list (e.g. bucket_send_bytes): aggregate, a
                # per-element gate would churn on repartitioning
                _put(f"{prefix}.sum", sum(
                    x for x in obj if isinstance(x, (int, float))))
                break
    return out


def compare(base: dict, cur: dict, tol: float = 0.25,
            metric_filter: str = "") -> dict:
    """Compare two flattened metric dicts. Returns {"regressions": [...],
    "improvements": [...], "drift": [...]} — each entry
    (key, base, current, rel_change)."""
    regressions, improvements, drift = [], [], []
    for key in sorted(set(base) & set(cur)):
        if metric_filter and metric_filter not in key:
            continue
        b, c = base[key], cur[key]
        if b == 0.0:
            continue                     # no meaningful relative change
        rel = (c - b) / abs(b)
        if abs(rel) <= tol:
            continue
        d = _direction(key)
        entry = (key, b, c, rel)
        if d == "up":
            (regressions if rel < 0 else improvements).append(entry)
        elif d == "down":
            (regressions if rel > 0 else improvements).append(entry)
        else:
            drift.append(entry)
    return {"regressions": regressions, "improvements": improvements,
            "drift": drift}


def _load(path: str) -> dict:
    with open(path) as f:
        return flatten_metrics(json.load(f))


def _two_newest(dirpath: str) -> tuple:
    files = sorted((os.path.join(dirpath, f) for f in os.listdir(dirpath)
                    if f.endswith(".json")), key=os.path.getmtime)
    if len(files) < 2:
        raise SystemExit(
            f"{dirpath}: need ≥2 history files to compare, "
            f"found {len(files)}")
    return files[-2], files[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="BASELINE.json CURRENT.json, or one "
                         "bench_history/<name>/ directory (compares the "
                         "two newest files)")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="relative tolerance band (0.25 = ±25%%)")
    ap.add_argument("--metrics", default="",
                    help="only gate metrics whose dotted path contains "
                         "this substring (e.g. iters_per_sec)")
    ap.add_argument("--warn-only", action="store_true",
                    help="report regressions but exit 0 (first landing / "
                         "cross-machine baselines)")
    args = ap.parse_args(argv)

    if len(args.paths) == 1 and os.path.isdir(args.paths[0]):
        base_path, cur_path = _two_newest(args.paths[0])
    elif len(args.paths) == 2:
        base_path, cur_path = args.paths
    else:
        ap.error("pass BASELINE CURRENT or one history directory")
    base, cur = _load(base_path), _load(cur_path)
    shared = set(base) & set(cur)
    print(f"# regress: {base_path} -> {cur_path} "
          f"({len(shared)} shared metrics, tol=±{args.tol:.0%}"
          + (f", filter='{args.metrics}'" if args.metrics else "") + ")")
    if not shared:
        print("# no shared numeric metrics — nothing to gate")
        return 0
    r = compare(base, cur, tol=args.tol, metric_filter=args.metrics)
    for label, entries in (("REGRESSION", r["regressions"]),
                           ("improvement", r["improvements"]),
                           ("drift", r["drift"])):
        for key, b, c, rel in entries:
            print(f"{label:>12}  {key}: {b:g} -> {c:g} ({rel:+.1%})")
    if not any(r.values()):
        print("# all shared metrics within tolerance")
    if r["regressions"] and not args.warn_only:
        print(f"# FAIL: {len(r['regressions'])} metric(s) regressed "
              f"beyond ±{args.tol:.0%}")
        return 1
    if r["regressions"]:
        print("# warn-only: regressions reported, exit 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
