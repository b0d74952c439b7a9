"""Preemption watchdog: signal-triggered final checkpoint + heartbeats (a
copy of ``repro/ft/watchdog.py``).

On SIGTERM/SIGINT (cluster preemption) the watchdog sets a stop flag; the
train loop checks it each step, writes a final checkpoint and exits cleanly.
A heartbeat file lets an external supervisor detect hung processes (the
'node failure' detection path at 1000+ nodes; here single-process).

Unlike the reference, each beat writes the time to a temporary file beside
the heartbeat and renames it over the heartbeat (``os.replace``), so a
reader sees the previous beat or the new one, never a file that is empty
or half written."""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional


class Watchdog:
    def __init__(self, heartbeat_path: Optional[str] = None,
                 interval_s: float = 10.0, install_signals: bool = True):
        self.should_stop = threading.Event()
        self.heartbeat_path = heartbeat_path
        self.interval_s = interval_s
        self._hb_thread: Optional[threading.Thread] = None
        self._prev_handlers = {}
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal)
                except ValueError:      # not in main thread
                    pass

    def _on_signal(self, signum, frame):
        self.should_stop.set()

    def start_heartbeat(self):
        if self.heartbeat_path is None or self._hb_thread is not None:
            return self

        tmp = (f"{self.heartbeat_path}.{os.getpid()}."
               f"{threading.get_ident()}.tmp")

        def beat():
            while not self.should_stop.is_set():
                try:
                    with open(tmp, "w") as f:
                        f.write(str(time.time()))
                    os.replace(tmp, self.heartbeat_path)
                except OSError:
                    pass
                self.should_stop.wait(self.interval_s)

        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()
        return self

    @staticmethod
    def is_alive(heartbeat_path: str, timeout_s: float = 60.0) -> bool:
        try:
            with open(heartbeat_path) as f:
                last = float(f.read().strip())
        except (OSError, ValueError):
            return False
        return (time.time() - last) < timeout_s

    def close(self):
        self.should_stop.set()
        for sig, h in self._prev_handlers.items():
            try:
                signal.signal(sig, h)
            except ValueError:
                pass
