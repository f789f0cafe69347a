import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def run_multidevice(script: str, n_devices: int = 8, timeout: int = 600):
    """Run a python snippet in a subprocess with N forced host devices.

    Tests and benches in-process must see 1 device (per the dry-run contract),
    so anything needing a mesh runs out-of-process.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script)],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"multidevice subprocess failed\n--- stdout ---\n{proc.stdout}"
            f"\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def multidevice():
    return run_multidevice


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skips elsewhere)")
