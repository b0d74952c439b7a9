"""The port stands alone: importing every ``repro_torch`` module, and
``chip_smoke.py``, loads neither ``jax`` nor any module of ``repro``; nor
does the tcp worker's own import footprint, the live telemetry plane's
(``obs.live``, ``obs.regress``, ``launch.monitor``) or elastic
membership's (``ft.membership``, ``ft.chaos``, ``ft.elastic_scale``,
``ft.straggler``)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
assert len(names) >= 72, names
assert {"repro_torch.models.moe", "repro_torch.models.mla",
        "repro_torch.configs.grok1_314b",
        "repro_torch.configs.deepseek_v2_236b"} <= set(names), names
print("IMPORTS-OK", len(names))
"""


_WORKER = r"""
import sys
import repro_torch.net.worker
import repro_torch.net.peer
import repro_torch.obs
from repro_torch.obs import clock, metrics, report, trace
import repro_torch.ps.problems
import repro_torch.ft.chaos, repro_torch.ft.membership
import repro_torch.ft.elastic_scale, repro_torch.ft.straggler
import repro_torch.obs.live, repro_torch.obs.regress
import repro_torch.launch.monitor
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("WORKER-OK")
"""


def _run(script: str, marker: str) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), REPO])
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert marker in proc.stdout


def test_port_imports_no_jax_and_no_reference():
    _run(_SCRIPT, "IMPORTS-OK")


def test_tcp_worker_imports_no_jax_and_no_reference():
    """What a tcp worker interpreter loads: torch and the port only."""
    _run(_WORKER, "WORKER-OK")
