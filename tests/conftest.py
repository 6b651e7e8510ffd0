"""Test configuration.

The suite runs on the CPU (JAX_PLATFORMS=cpu).  Multi-device sharding tests
need a virtual CPU mesh, whose device count is fixed at interpreter start,
so they spawn a *subprocess* with an n-device CPU mesh — use the
`run_in_cpu_mesh` helper.  Those subprocesses never touch a GPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest


def cpu_mesh_environ(n_devices: int = 8) -> dict:
    """Environment for a subprocess with n virtual CPU JAX devices."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    # Keep the package importable.
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return env


def run_in_cpu_mesh(code: str, n_devices: int = 8, timeout: int = 600):
    """Run a python snippet under an n-device CPU mesh; returns CompletedProcess."""
    return subprocess.run(
        [sys.executable, "-c", code],
        env=cpu_mesh_environ(n_devices),
        capture_output=True,
        text=True,
        timeout=timeout,
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
