"""The PyTorch port imports no JAX, and its GPU smoke run refuses to run
without a GPU or outside a checkout."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "lightdock_tpu_torch",
    "lightdock_tpu_torch.ops.quaternion",
    "lightdock_tpu_torch.ops.tiling",
    "lightdock_tpu_torch.ops.cull",
    "lightdock_tpu_torch.ops._build",
    "lightdock_tpu_torch.ops.dfire_pairs",
    "lightdock_tpu_torch.ops.elec_vdw_pairs",
    "lightdock_tpu_torch.engine.params",
    "lightdock_tpu_torch.engine.energy_dense",
    "lightdock_tpu_torch.engine.energy_kernel",
    "lightdock_tpu_torch.engine.gso",
    "lightdock_tpu_torch.engine.runner",
]


def test_port_never_imports_jax():
    """Neither the port nor the stand-in system that the GPU smoke run
    builds imports jax."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from __graft_entry__ import _toy_system\n"
            "_toy_system(8, 4, 2)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "print(len(bad), bad[:5])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("0 []"), proc.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu_or_checkout(where, tmp_path):
    """Here there is no CUDA device; alone, there is no package either.
    Either way the script exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / script.name).write_text(script.read_text())
        script = tmp_path / script.name
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "FAIL" in proc.stderr
