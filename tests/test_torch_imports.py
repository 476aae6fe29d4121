"""The PyTorch port imports neither JAX nor the JAX package, and its GPU
smoke run refuses to run without a GPU or outside a checkout."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "lightdock_tpu_torch",
    "lightdock_tpu_torch.constants",
    "lightdock_tpu_torch.scoring",
    "lightdock_tpu_torch.scoring.tables",
    "lightdock_tpu_torch.scoring.potentials",
    "lightdock_tpu_torch.scoring.models",
    "lightdock_tpu_torch.utils",
    "lightdock_tpu_torch.utils.rng",
    "lightdock_tpu_torch.utils.output",
    "lightdock_tpu_torch.utils.positions",
    "lightdock_tpu_torch.utils.pdb",
    "lightdock_tpu_torch.utils.setupfile",
    "lightdock_tpu_torch.utils.metrics",
    "lightdock_tpu_torch.utils.clusters",
    "lightdock_tpu_torch.utils.native",
    "lightdock_tpu_torch.ops.quaternion",
    "lightdock_tpu_torch.ops.tiling",
    "lightdock_tpu_torch.ops.cull",
    "lightdock_tpu_torch.ops._build",
    "lightdock_tpu_torch.ops.dfire_pairs",
    "lightdock_tpu_torch.ops.elec_vdw_pairs",
    "lightdock_tpu_torch.ops.dfire_pairs_v1",
    "lightdock_tpu_torch.ops.elec_vdw_pairs_v1",
    "lightdock_tpu_torch.ops.probes",
    "lightdock_tpu_torch.engine.params",
    "lightdock_tpu_torch.engine.energy_dense",
    "lightdock_tpu_torch.engine.energy_host",
    "lightdock_tpu_torch.engine.gso_host",
    "lightdock_tpu_torch.engine.energy_kernel",
    "lightdock_tpu_torch.engine.gso",
    "lightdock_tpu_torch.engine.runner",
    "lightdock_tpu_torch.standin",
    "lightdock_tpu_torch.simulation",
    "lightdock_tpu_torch.cli",
    "lightdock_tpu_torch.precision_fidelity",
    "lightdock_tpu_torch.bench",
    "lightdock_tpu_torch.setup_sim",
    "lightdock_tpu_torch.cli_tools",
    "lightdock_tpu_torch.analysis",
    "lightdock_tpu_torch.cli_analysis",
    "lightdock_tpu_torch.parallel",
    "lightdock_tpu_torch.parallel.mesh",
    "lightdock_tpu_torch.parallel.multihost",
    "lightdock_tpu_torch.parallel.sharded",
    "lightdock_tpu_torch.parallel.farm",
    "lightdock_tpu_torch.probes",
    "lightdock_tpu_torch.probes.__main__",
    "lightdock_tpu_torch.probes.exp_gather_kernel",
    "lightdock_tpu_torch.probes.exp_gather2d",
    "lightdock_tpu_torch.probes.exp_gather32",
    "lightdock_tpu_torch.probes.exp_gather_forms",
    "lightdock_tpu_torch.probes.exp_bisect",
    "lightdock_tpu_torch.probes.exp_probe_ops",
]

FORBIDDEN = ("jax", "lightdock_tpu", "__graft_entry__", "scripts")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_never_imports_jax():
    """After importing every port module, building the stand-in systems, a
    kernel energy path of each generation on them, a two-swarm farm that
    takes a step, a sharded kernel step on a one-process mesh, the P6
    probe, a command-line run on the CPU from the files of
    ``standin.write_complex`` (PDB files, setup.json, positions, ANM) with
    each engine, the precision tool with its hybrids on such files,
    ``tools setup`` then ``analysis all`` on the CPU (the native reader and
    writer built and used), and the benchmark with its farm at a tiny
    size, no ``jax``, no ``lightdock_tpu`` or ``lightdock_tpu.*``, no
    ``__graft_entry__`` and no ``scripts`` is in ``sys.modules``;
    ``chip_smoke.py`` imports none of them."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from lightdock_tpu_torch import standin\n"
            "from lightdock_tpu_torch.engine.energy_kernel import (\n"
            "    kernel_params, make_kernel_energy_fn)\n"
            "params, _, _ = standin.toy_system(8, 4, 2)\n"
            "standin.toy_system(8, 4, 2, num_anm=2, method='dna')\n"
            "standin.membrane_system(2, n_rec=40, n_lig=30)\n"
            "make_kernel_energy_fn(kernel_params(params), 'cpu')\n"
            "steps, pos, _ = standin.toy_system(8, 4, 2, dfire_mode='steps')\n"
            "make_kernel_energy_fn(kernel_params(steps, 'v1'), 'cpu', kernel='v1')\n"
            "from lightdock_tpu_torch.parallel.farm import SwarmFarmRunner\n"
            "SwarmFarmRunner(steps, [pos, pos], [0, 1], 1, False, 0, 0, device='cpu',\n"
            "                energy_mode='kernel_v1', output_root=None).run_segmented(1)\n"
            "from lightdock_tpu_torch.parallel import mesh, sharded\n"
            "import torch\n"
            "from lightdock_tpu_torch.parallel.multihost import stack_swarm_states\n"
            "states = stack_swarm_states([pos], False, 0, 0, torch.float32, 'cpu')\n"
            "sharded.run_multi_swarm_2d_kernel(mesh.make_mesh(device='cpu'), params, states,\n"
            "                                  torch.rand(1, 1, 2))\n"
            "from lightdock_tpu_torch import probes\n"
            "probes.run(['P6'], probes.resolve_device('cpu'), calls=1, say=lambda s: None)\n"
            "import contextlib, io, os, tempfile\n"
            "from lightdock_tpu_torch import cli\n"
            "with tempfile.TemporaryDirectory() as work:\n"
            "    setup, pos = standin.write_complex(work, 'dna', 12, 8, 3, num_anm=1)\n"
            "    out = os.path.join(work, 'swarm_0')\n"
            "    with contextlib.redirect_stdout(io.StringIO()):\n"
            "        assert cli.main([str(setup), str(pos[0]), '2', 'dna', '--platform', 'cpu',\n"
            "                         '--anm-dir', work, '--output-dir', out]) == 0\n"
            "    assert os.path.exists(os.path.join(out, 'gso_1.out'))\n"
            "    host = os.path.join(work, 'swarm_host')\n"
            "    with contextlib.redirect_stdout(io.StringIO()):\n"
            "        assert cli.main([str(setup), str(pos[0]), '1', 'dna', '--platform', 'cpu',\n"
            "                         '--engine', 'host', '--anm-dir', work,\n"
            "                         '--output-dir', host]) == 0\n"
            "    assert os.path.exists(os.path.join(host, 'gso_1.out'))\n"
            "    from lightdock_tpu_torch import precision_fidelity as pf\n"
            "    pf.STANDINS = {'1ppe': (12, 8, 3, 0), '1azp': (12, 8, 3, 1)}\n"
            "    with contextlib.redirect_stderr(io.StringIO()):\n"
            "        pf.main(['--device', 'cpu', '--standin', work, '--steps', '10',\n"
            "                 '--hybrids', '--out', os.path.join(work, 'p.json')])\n"
            "    from lightdock_tpu_torch import cli_analysis, cli_tools\n"
            "    run = os.path.join(work, 'run')\n"
            "    with contextlib.redirect_stdout(io.StringIO()):\n"
            "        assert cli_tools.main(['setup', os.path.join(work, 'lightdock_rec.pdb'),\n"
            "                               os.path.join(work, 'lightdock_lig.pdb'), '-s', '2',\n"
            "                               '-g', '4', '--workdir', run]) == 0\n"
            "        os.makedirs(os.path.join(run, 'swarm_0'))\n"
            "        assert cli.main([os.path.join(run, 'setup.json'),\n"
            "                         os.path.join(run, 'init', 'initial_positions_0.dat'), '1',\n"
            "                         'dna', '--platform', 'cpu',\n"
            "                         '--output-dir', os.path.join(run, 'swarm_0')]) == 0\n"
            "        assert cli_analysis.main(['all', run, '1', '--setup',\n"
            "                                  os.path.join(run, 'setup.json'),\n"
            "                                  '--platform', 'cpu']) == 0\n"
            "    assert os.path.exists(os.path.join(run, 'top', 'top_1.pdb'))\n"
            "from lightdock_tpu_torch import bench\n"
            "bench.ATOMS_1PPE, bench.GLOWWORMS, bench.STEPS, bench.REPEATS = (8, 4), 2, 1, 1\n"
            "bench.FARM_SWARMS, bench.FARM_STEPS = 2, 1\n"
            "with contextlib.redirect_stdout(io.StringIO()), \\\n"
            "        contextlib.redirect_stderr(io.StringIO()):\n"
            "    assert bench.main(['--device', 'cpu']) == 0\n"
            f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "print(len(bad), bad[:5])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("0 []"), proc.stdout
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = [alias.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names]
    imported += [node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module and node.level == 0]
    assert imported and not [m for m in imported if _forbidden(m)], imported


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
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "FAIL" in proc.stderr
