"""Shared test fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the
real (single) device; multi-device tests spawn subprocesses."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 900):
    """Run a python snippet in a subprocess with N host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, (
        f"subprocess failed:\nSTDOUT:\n{proc.stdout[-4000:]}\n"
        f"STDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture(scope="session")
def subproc():
    return run_with_devices
