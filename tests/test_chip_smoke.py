"""chip_smoke.py: it refuses to run without a GPU, and its phases — the
same checks it makes on the card — pass at tiny sizes on the CPU, so a
change that would break the on-card check fails here first."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# A copied test tree without the repo (CI's arbitrary-cwd run) skips.
chip_smoke = pytest.importorskip("chip_smoke")

NORTHSTAR_TINY = {"grid": 24, "nev": 6, "degree": 40, "maxdim": 20,
                  "schedule": (20, 40)}


def test_exits_nonzero_on_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "platform 'cpu'" in proc.stderr
    assert '"ok"' not in proc.stdout


TINY = [
    ("readme", {}),
    ("config2", {"grid": 16}),
    ("fused65k", {"grid": 16}),
    ("northstar", NORTHSTAR_TINY),
    ("nonsym", {"grid": 32}),
    ("complex", {"n": 4096}),
    ("extended", {}),
    ("spmv", {"grid": 64, "nbr": 8, "kb": 2, "bsize": 16, "iters": 10}),
]


@pytest.mark.parametrize("phase,kwargs", TINY)
def test_phase_tiny_on_cpu(phase, kwargs, capsys):
    getattr(chip_smoke, f"phase_{phase}")(**kwargs)
    out = capsys.readouterr().out
    assert out.startswith(f"phase {phase}: {{")


def test_phases_tiny_with_x64_off():
    """Every one-card phase at tiny size in a child process with JAX's
    default x64 off, as chip_smoke.py runs them on the card (this suite
    turns x64 on for itself)."""
    calls = "; ".join(
        f"chip_smoke.phase_{phase}(**{kwargs!r})" for phase, kwargs in TINY)
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "assert not jax.config.jax_enable_x64; "
            f"import chip_smoke; {calls}")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("\nphase ") + 1 == len(TINY)


def test_four_card_path_on_virtual_cpu_mesh(capsys):
    """The --cards 4 path on four virtual CPU devices: every sharded solve
    spans the mesh and matches its one-device twin."""
    chip_smoke.run_four_cards(4, sizes={
        "grid": 16, "grid65k": 16, "csr_n": 4096,
        "northstar": NORTHSTAR_TINY,
    })
    out = capsys.readouterr().out
    assert out.count("compare ") == 4
    assert '"basis_devices": 4' in out


@pytest.mark.gpu
def test_extended_phase_on_gpu(gpu_card):
    """The double-word transforms compiled for the card (NVPTX contracts
    a*b + c unless `_pin` blocks it), in a child process outside this
    suite's CPU pin."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = "import chip_smoke; chip_smoke.phase_extended()"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "phase extended:" in proc.stdout
