"""Test configuration: run the suite on a virtual 8-device CPU mesh with
float64 enabled, so the sharded code paths are exercised without a
multi-GPU machine.  The platform is forced through jax.config as well as
the environment, in case jax was imported before this file ran.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu_card` fixture: it decides inside the test, never at import
(pytest-xdist workers must collect the same tests), and skips with a
reason when no card is visible.  They run their work in a child process,
outside this file's CPU pin: `python -m pytest tests/ -m gpu` on a
machine with a card.
"""

import os
import shutil
import subprocess

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_card():
    """Skip unless `nvidia-smi` lists a GPU; returns its first line."""
    smi = shutil.which("nvidia-smi")
    found = ""
    if smi:
        proc = subprocess.run([smi, "-L"], capture_output=True, text=True,
                              timeout=60)
        found = proc.stdout.strip() if proc.returncode == 0 else ""
    if not found:
        pytest.skip("needs an NVIDIA GPU; nvidia-smi lists none here")
    return found.splitlines()[0]
