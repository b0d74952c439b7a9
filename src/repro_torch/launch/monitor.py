"""Watch a live tcp run of the port: per-worker table and sparklines over
STATS (the port of ``repro/launch/monitor.py``).

    # one-shot snapshot (prints the table once and exits)
    PYTHONPATH=src python -m repro_torch.launch.monitor --connect 127.0.0.1:29500

    # live view, redrawn every --interval seconds until the run ends
    PYTHONPATH=src python -m repro_torch.launch.monitor --connect HOST:PORT --follow

    # offline: re-render a --telemetry-jsonl stream after the fact
    PYTHONPATH=src python -m repro_torch.launch.monitor --from-jsonl telem.jsonl

The master serves STATS on its rendezvous listener AFTER rendezvous (all
training links are connected by then, so any new connection is a monitor).
One snapshot per connection: send ``STATS {"token", "k"}``, read back the
``LiveMonitor.snapshot(k)`` JSON, done — the monitor never holds a socket
open into the data plane. Requires the run to have the live plane on
(``--telemetry`` / ``--telemetry-jsonl`` on launch.cluster, or
``PSConfig(telemetry=True)``) and a pinned ``--port``.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

if __package__ in (None, ""):     # run as a file: put src on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.net import wire  # noqa: E402
from repro_torch.net.wire import Link  # noqa: E402
from repro_torch.obs import live as obs_live  # noqa: E402


def fetch_stats(host: str, port: int, token: str = "repro-net",
                k: int = 32, timeout_s: float = 5.0) -> dict:
    """One STATS round trip. Raises OSError (incl. WireError) while the
    master is still in rendezvous or already gone; RuntimeError on a
    token mismatch."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    link = Link(sock)
    try:
        link.sock.settimeout(timeout_s)
        link.send_json(wire.STATS, {"token": token, "k": int(k)})
        frame = link.recv_header()
        payload = link.recv_json(frame)
        if frame.ftype == wire.ERROR:
            raise RuntimeError(f"master refused STATS: {payload}")
        if frame.ftype != wire.STATS:
            raise wire.WireError(f"expected STATS, got {frame}")
        return payload
    finally:
        link.close()


def snap_from_jsonl(path: str) -> dict:
    """Fold a --telemetry-jsonl stream back into a snapshot()-shaped dict
    (each line carries latest-per-worker values; we accumulate them into
    the per-metric histories the table's sparklines want)."""
    workers: dict = {}
    events: list = []
    gauges: dict = {}
    meta = {"algorithm": "(jsonl)", "transport": path}
    t, n = 0.0, 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "meta" in rec and "workers" not in rec:   # run-header line
                meta.update(rec.get("meta") or {})
                continue
            t = float(rec.get("t", t))
            n += 1
            for wid, metrics in (rec.get("workers") or {}).items():
                for m, v in (metrics or {}).items():
                    if isinstance(v, (int, float)):
                        workers.setdefault(int(wid), {}) \
                            .setdefault(m, []).append([t, float(v)])
            for k, v in (rec.get("gauges") or {}).items():
                if isinstance(v, (int, float)):
                    gauges[k] = v
            events.extend(rec.get("events") or [])
    # a worker whose last event was never recovered stays flagged
    flagged: dict = {}
    for ev in events:
        wid = ev.get("wid")
        if ev.get("kind") == "recovered":
            flagged.pop(str(wid), None)
        elif ev.get("kind") in ("straggler", "hb_stale"):
            flagged[str(wid)] = ev["kind"]
    return {"t": t, "meta": meta,
            "n_samples": n, "events": events, "flagged": flagged,
            "workers": workers, "gauges": gauges}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="the master's rendezvous address (its --port)")
    ap.add_argument("--token", default="repro-net")
    ap.add_argument("--k", type=int, default=32,
                    help="history samples per series in each snapshot")
    ap.add_argument("--follow", action="store_true",
                    help="redraw every --interval s until the run ends")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--retry-for", type=float, default=15.0,
                    help="keep retrying this long while the master is "
                         "still in rendezvous / not yet listening")
    ap.add_argument("--from-jsonl", default=None, metavar="PATH",
                    help="render a --telemetry-jsonl stream instead of "
                         "connecting to a live master")
    ap.add_argument("--width", type=int, default=24,
                    help="sparkline width (characters)")
    args = ap.parse_args(argv)

    if args.from_jsonl:
        print(obs_live.render(snap_from_jsonl(args.from_jsonl),
                              width=args.width))
        return 0
    if not args.connect:
        ap.error("pass --connect HOST:PORT or --from-jsonl PATH")
    host, port_s = args.connect.rsplit(":", 1)
    port = int(port_s)
    deadline = time.monotonic() + args.retry_for
    got_one = False
    while True:
        try:
            snap = fetch_stats(host, port, token=args.token, k=args.k)
        except OSError as exc:
            if got_one:
                # we were following a live run and the listener is gone:
                # the run ended — a clean exit, not an error
                print("# run ended (master gone)", flush=True)
                return 0
            if time.monotonic() > deadline:
                print(f"# no master at {args.connect}: {exc}",
                      file=sys.stderr)
                return 2
            time.sleep(min(args.interval, 0.5))
            continue
        got_one = True
        out = obs_live.render(snap, width=args.width)
        if args.follow and sys.stdout.isatty():
            sys.stdout.write("\x1b[H\x1b[2J")     # home + clear
        print(out, flush=True)
        if not args.follow:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
