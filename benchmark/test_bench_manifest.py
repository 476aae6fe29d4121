"""The benchmark's files against BENCHMARK.json and the contract's rules,
discovery by files alone (the example DNA + ANM cell added as new files
and run), the generator (its inputs for the existing configurations byte
for byte as before, and its DNA and ANM inputs), and the imports.

    python -m pytest benchmark/test_bench_manifest.py -q
"""

import ast
import hashlib
import json
import pathlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from ldbench import manifest  # noqa: E402
from ldbench.check import NUMBERS  # noqa: E402
from ldbench.inputs import Complex  # noqa: E402
from ldbench.methods import NUCLEOTIDES  # noqa: E402
from examples.add import add, copy_of, strip  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
EXAMPLE = HERE / "examples" / "1azp-dna-anm.glob32.json"
# The program: this tree's root, then whatever the caller's path holds (a
# copy of the benchmark alone finds the program there).
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))


def reported(cell, metric):
    return cell in metric.get("workloads", [c["name"] for c in BENCH["workloads"]])


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + list(METRICS))
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key), key
    for m in METRICS.values():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    own = manifest.load("workloads", cell)
    c = manifest.cell(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert w[key] == own[key], (cell, key)
    for metric in c["end_to_end"] + c["per_layer"]:
        assert reported(cell, METRICS[metric]), (cell, metric)
        m = manifest.metric(metric)
        assert (m.NAME, m.UNIT, m.BETTER, m.SOURCE) == tuple(
            METRICS[metric][k] for k in ("name", "unit", "better", "source"))
        if metric in c["per_layer"]:
            assert (m.LAYER, m.MOVES) == (METRICS[metric]["layer"], METRICS[metric]["moves"])
    # A layer's metric moves an end-to-end metric the cell reports.
    for metric in c["per_layer"]:
        assert METRICS[metric]["moves"] in c["end_to_end"], (cell, metric)
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) > 1 and c["per_layer"]
    assert set(c["limits"]) == set(NUMBERS)


def test_configs():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and all(k in data for k in c["reduced"])
        assert data["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_four_chip_cells():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


def test_every_entry_has_its_file():
    """Every name in BENCHMARK.json has its file (a metric, its own or its
    base's); every file loads."""
    assert {w["name"] for w in BENCH["workloads"]} <= set(manifest.names("workloads"))
    assert {c["name"] for c in BENCH["configs"]} <= set(manifest.names("configs"))
    assert {w["traffic"] for w in BENCH["workloads"]} <= set(manifest.names("traffic"))
    for name in METRICS:
        assert manifest.metric(name).NAME == name
    for name in manifest.names("workloads"):
        c = manifest.cell(name)
        assert c["chips"] == 1 and set(c["limits"]) == set(NUMBERS)
    for name in manifest.names("metrics"):
        m = manifest.metric(name)
        assert m.NAME == name and UNIT.match(m.UNIT) and m.BETTER in ("lower", "higher")


def test_tagged_metric_is_its_base_under_its_own_name():
    base, tagged = manifest.metric("prep_ms.job"), manifest.metric("prep_ms.job.swarm1")
    assert tagged.read is base.read and tagged.UNIT == base.UNIT
    assert (tagged.NAME, tagged.MOVES) == ("prep_ms.job.swarm1", "poses_per_s.swarm1")
    assert manifest.metric("poses_per_s.swarm1").read is manifest.metric("poses_per_s").read
    with pytest.raises(FileNotFoundError):
        manifest.metric("no_such_metric.swarm1")


def test_new_files_are_found(tmp_path):
    """A cell, a configuration, a traffic mix and a metric are added as new
    files in a copy; the harness finds them by name, with no edit."""
    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "configs" / "toy.json").write_text(
        (HERE / "configs" / "1ppe-dfire-rigid.json").read_text())
    (copy / "traffic" / "glob2.json").write_text(json.dumps(
        {"glob": True, "swarms": 2, "why": "two swarms"}))
    cell = json.loads((HERE / "workloads" / "1ppe-dfire-rigid.swarm1.json").read_text())
    cell.update(config="toy", traffic="glob2")
    (copy / "workloads" / "toy.glob2.json").write_text(json.dumps(cell))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "toy.glob2", "config": "toy", "traffic": "glob2",
                               "chips": 1, "why": cell["why"]})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "output layer",
                               "moves": "job_s_p95", "workloads": ["toy.glob2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "1ppe-dfire-rigid.swarm1" in m["workloads"]:
            m["workloads"].append("toy.glob2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (copy / "metrics" / "new_metric.py").write_text(
        'NAME = "new_metric"\nUNIT = "ms"\nBETTER = "lower"\nSOURCE = "host_clock"\n'
        'LAYER = "output layer"\nMOVES = "job_s_p95"\nWRAPS = []\n\n'
        'def read(run):\n    return 1.0\n')
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from ldbench import manifest; "
            "c = manifest.cell('toy.glob2'); "
            "print(c['traffic']['swarms'], manifest.metric('new_metric').read(None), "
            "'toy.glob2' in manifest.names('workloads'), ','.join(c['per_layer']), "
            "','.join(manifest.cell('1ppe-dfire-rigid.swarm1')['per_layer']))")
    out = subprocess.run([sys.executable, "-c", code, str(copy)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out[:4] == ["2", "1.0", "True", "new_metric"]
    assert "new_metric" not in out[4].split(",")


def files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_example_cell_is_new_files_alone(tmp_path):
    """The benchmark without the example DNA + ANM cell's files and entries,
    and the same with the example added, differ by exactly its two new files
    and entries appended to BENCHMARK.json, whether the tree holds the cell
    or not; the copy's harness finds it and runs it whole on the CPU at a
    small size, correct."""
    base = copy_of(tmp_path / "base")
    strip(EXAMPLE, base)
    copy = tmp_path / "copy"
    shutil.copytree(base, copy)
    add(EXAMPLE, copy)
    old, new = files(base / "benchmark"), files(copy / "benchmark")
    assert set(new) - set(old) == {pathlib.Path("configs/1azp-dna-anm.json"),
                                   pathlib.Path("workloads/1azp-dna-anm.glob32.json")}
    assert all(new[p] == old[p] for p in old)
    was_bench = json.loads((base / "BENCHMARK.json").read_text())
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    for key in ("command", "paths", "run_seconds"):
        assert bench[key] == BENCH[key] == was_bench[key]
    for kind in ("configs", "workloads"):
        assert bench[kind][:len(was_bench[kind])] == was_bench[kind]
        assert [e["name"] for e in bench[kind][len(was_bench[kind]):]] == [
            e["name"] for e in json.loads(EXAMPLE.read_text())["benchmark"][kind]]
    for kind in ("end_to_end", "per_layer"):
        assert len(bench[kind]) == len(was_bench[kind])
        for was, now in zip(was_bench[kind], bench[kind]):
            assert {k: v for k, v in now.items() if k != "workloads"} == {
                k: v for k, v in was.items() if k != "workloads"}
            assert now.get("workloads", [])[:len(was.get("workloads", []))] == was.get(
                "workloads", [])
    small = {"config": {"receptor_atoms": 300, "ligand_atoms": 90, "glowworms": 30,
                        "steps": 20, "swarm_centres": 3},
             "traffic": {"swarms": 3}, "min_job_s": 0.3,
             "check": {"jobs": 2, "swarms": 3, "segments": 3, "score_snapshots": 2}}
    out = subprocess.run(
        [sys.executable, str(copy / "benchmark" / "run.py"), "--workload",
         "1azp-dna-anm.glob32", "--seed", str(2 ** 31 + 23), "--seconds", "1", "--trace", "0",
         "--platform", "cpu", "--override", json.dumps(small)],
        capture_output=True, text=True, cwd=tmp_path, timeout=600,
        env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, out.stderr[-3000:]
    assert set(result["metrics"]) == {"poses_per_s", "setup_s"}


def test_example_tests_pass_on_a_checkout_that_holds_the_cell(tmp_path):
    """A checkout to which ``examples/add.py`` has added the cell, as a later
    change would, passes the example's own tests; adding it again changes
    nothing."""
    checkout = copy_of(tmp_path / "checkout")
    add_py = [sys.executable, str(checkout / "benchmark" / "examples" / "add.py"),
              str(checkout / "benchmark" / "examples" / EXAMPLE.name), str(checkout)]
    written = subprocess.run(add_py, capture_output=True, text=True, check=True).stdout.split()
    assert sorted(pathlib.Path(p).name for p in written) == [
        "1azp-dna-anm.glob32.json", "1azp-dna-anm.json"]
    before = files(checkout)
    assert subprocess.run(add_py, capture_output=True, text=True,
                          check=True).stdout.split() == []
    assert files(checkout) == before
    bench, cell = checkout / "benchmark", "1azp-dna-anm.glob32"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"{bench}/test_bench_manifest.py::test_names_and_units",
         f"{bench}/test_bench_manifest.py::test_cell_files[{cell}]",
         f"{bench}/test_bench_manifest.py::test_example_cell_is_new_files_alone",
         f"{bench}/test_bench_faults.py::test_sound_run_is_correct[{cell}]",
         f"{bench}/test_bench_faults.py::test_control_is_not_correct[{cell}]",
         f"{bench}/test_bench_faults.py::test_receptor_modes_left_out_is_not_correct[{cell}]"],
        capture_output=True, text=True, cwd=checkout, timeout=900, env=ENV)
    assert out.returncode == 0, out.stdout[-3000:]
    assert "6 passed" in out.stdout, out.stdout[-3000:]


def small_config():
    return dict(manifest.load("configs", "1k4c-dfire-membrane"), receptor_atoms=300,
                ligand_atoms=80, glowworms=12,
                membrane={"beads": 40, "spacing": 4.0, "z": 0.0})


def test_generator_is_deterministic(tmp_path):
    a = Complex(small_config(), 2 ** 31 + 7, tmp_path / "a")
    b = Complex(small_config(), 2 ** 31 + 7, tmp_path / "b")
    c = Complex(small_config(), 2 ** 31 + 8, tmp_path / "c")
    for name in ("lightdock_rec.pdb", "lightdock_lig.pdb", "setup.json", "data/DCparams"):
        assert (a.root / name).read_bytes() == (b.root / name).read_bytes()
        assert (a.root / name).read_bytes() != (c.root / name).read_bytes()
    assert np.array_equal(a.positions(3, 4), b.positions(3, 4))
    assert not np.array_equal(a.positions(3, 4), a.positions(4, 4))
    assert not np.array_equal(a.positions(3, 4), c.positions(3, 4))
    assert a.n_beads == 40
    assert (a.root / "lightdock_rec.pdb").read_text().count(" MMB ") == 40


@pytest.mark.parametrize("name", ["1ppe-dfire-rigid", "1k4c-dfire-membrane"])
def test_swarms_sit_on_the_surface(tmp_path, name):
    """Swarm centres outside the receptor, a quarter of the ligand's
    diameter beyond its surface, clear of the membrane's plane; glowworms
    within the swarm radius of their centre; a one-swarm job takes the
    centres in turn."""
    config = manifest.load("configs", name)
    cx = Complex(config, 2 ** 31 + 3, tmp_path)
    protein = cx.rec[:len(cx.rec) - cx.n_beads]
    half, radius = config["box"] / 2, config["swarm_radius"]
    assert len(cx.centres) == config["swarm_centres"]
    assert (np.abs(cx.centres - protein.mean(axis=0)).max(axis=1) > half + 5).all()
    if config.get("membrane"):
        beads = cx.rec[-cx.n_beads:]
        assert (beads[:, 2] == config["membrane"]["z"]).all()
        assert (np.abs(beads[:, :2]).max(axis=1) > half).all()
        assert (np.abs(cx.centres[:, 2] - config["membrane"]["z"]) >= radius).all()
    jobs = cx.positions(0, config["swarm_centres"])
    for s, poses in enumerate(jobs):
        assert (np.linalg.norm(poses[:, :3] - cx.centres[s], axis=1) <= radius).all()
    for job in (0, 5, 33):
        t = cx.positions(job, 1)[0][:, :3]
        assert (np.linalg.norm(t - cx.centres[job % len(cx.centres)], axis=1) <= radius).all()


@pytest.mark.parametrize("kept", [(0, 1), (0,), (1,)])
def test_trace_is_placed_by_either_marker(kept):
    """The device's events are put on the host's clock by the marker at
    either end of the window; one launched before the window is left out."""
    from ldbench.devtrace import place

    offset, lo, hi = 7_000_000_000, 1_000_000_000, 52_000_000_000
    events = [("warm", lo - 5_000_000 + offset, lo - 4_000_000 + offset)] + [
        (f"k{i}", a + offset, a + offset + 1000) for i, a in
        enumerate(range(lo + 10_000, hi - 10_000, 1_000_000_000))]
    markers = [("spin_kernel", (lo, hi)[k] + offset + 2000, (lo, hi)[k] + offset + 3000)
               for k in kept]
    inside, found = place(events, markers, lo, hi)
    assert abs(found - offset) <= 2000
    assert [e[0] for e in inside] == [e[0] for e in events[1:]]
    with pytest.raises(RuntimeError):
        place(events, [], lo, hi)


def test_busy_and_idle_time():
    """The device's busy intervals merge overlapping and touching events and
    are clipped to the window; the idle gaps go to the innermost span around
    their middle."""
    sys.path.insert(1, str(ROOT))
    import run
    from ldbench.devtrace import DeviceTrace, busy_intervals, busy_ns, idle_gaps
    from ldbench.spans import Spans

    events = [("x", 0, 10), ("y", 5, 15), ("z", 15, 20), ("w", 30, 40), ("v", -5, 2),
              ("u", 95, 120)]
    busy = busy_intervals([(n, a + 7, b + 7) for n, a, b in events], 7, 0, 100)
    assert busy.tolist() == [[0, 20], [30, 40], [95, 100]]
    trace = DeviceTrace(events, (0, 100), 0, busy)
    assert busy_ns(trace) == 35 and idle_gaps(trace).tolist() == [[20, 30], [40, 95]]
    spans = Spans([])
    spans.mark("job", 0, 100)
    spans.mark("snapshot_text", 60, 70)
    idle = dict(run.breakdown(trace, spans)["idle_gaps"])
    assert idle == {"snapshot_text": pytest.approx(55e-9), "job": pytest.approx(10e-9)}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_imports():
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole), and the reference imports nothing of the
    program."""
    for path in HERE.rglob("*.py"):
        found = set(imports(path))
        assert not found & {"jax", "jaxlib", "flax", "lightdock_tpu"}, path
        if path.parent.name == "reference":
            assert "lightdock_tpu_torch" not in found, path
            assert "ldbench" not in found, path


def test_contract_limits():
    """Sizes and keys BENCHMARK.json may have."""
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


# SHA-256 of the inputs each configuration gave at seed 2 ** 31 + 101 before
# the generator took DNA and ANM: the files of the complex, and the
# positions files of jobs 0, 7 and the warm-up job (10 ** 9), two swarms
# each, joined in order.
INPUTS_BEFORE = {
    "1k4c-dfire-membrane": {
        "lightdock_rec.pdb": "5c175fb09e9018d95d9dd4c672e3d0e0d8d11cb9af75d98f7a21be509629e222",
        "lightdock_lig.pdb": "485c023d412e0ca42d836c0196d8b157678ccfb8e763e9c6ed99b9fc0d2b9f15",
        "setup.json": "4812a3ad62497ca3cead43acad378e53601e44e97d3c0ed46fa8f2334808b095",
        "data/DCparams": "7eac336186281e01088faeb6f9e59e4577e6dc365ee49d1249967c727c1e1f12",
        0: "fd892e64f0875bd7e57c0d61264248863de084c202c5381f00f7e4ce7e38c254",
        7: "63c1d3370c2ef5a3f105bf61068cd94d5948119a21ac8625e5ba627d8026c12c",
        10 ** 9: "906fab5a921670262ed2ff7d7b15605bf7e083b4980b3908979d3697044423db",
    },
    "1ppe-dfire-rigid": {
        "lightdock_rec.pdb": "577c48c360517ae96d8db3531c133ba5e4b349abc2fdf221f03a39a521f31af8",
        "lightdock_lig.pdb": "3f7e3acacb0229f5f12468a39eaab2c7bee05a300d9638d8d4eaa3d6eea3773a",
        "setup.json": "4812a3ad62497ca3cead43acad378e53601e44e97d3c0ed46fa8f2334808b095",
        "data/DCparams": "7eac336186281e01088faeb6f9e59e4577e6dc365ee49d1249967c727c1e1f12",
        0: "d2364211ad88cfeba060b751f7baf8d81f553b0f7e1b66c9bf467282b5eeacf2",
        7: "87ae02c3a45c538d5300acd16c72213e290797506558e63c75ac1bacb716bbee",
        10 ** 9: "a6a852cb280a7efe53b9ec589d6cee7ed95f0bd5ceefc1de12b185f7e1157454",
    },
}


@pytest.mark.parametrize("name", sorted(INPUTS_BEFORE))
def test_inputs_are_unchanged(tmp_path, name):
    """Each existing configuration at full size gives the bytes it gave
    before the generator took DNA and ANM."""
    cx = Complex(manifest.load("configs", name), 2 ** 31 + 101, tmp_path / "cx")
    found = {}
    for key, want in INPUTS_BEFORE[name].items():
        if isinstance(key, str):
            data = (cx.root / key).read_bytes()
        else:
            data = b"".join(p.read_bytes() for p in cx.write_job(key, 2, tmp_path / str(key)))
        found[key] = hashlib.sha256(data).hexdigest()
    assert found == INPUTS_BEFORE[name]
    assert not list(cx.root.glob("*_nm.npy"))


def test_dna_anm_inputs(tmp_path):
    """A DNA configuration with modes: nucleotides on the ligand, no DFIRE
    table, setup.json naming the modes, modes smooth, free of the rigid
    motions and orthonormal, and positions whose pose columns are those of
    the rigid DFIRE configuration of the same seed and sizes."""
    config = dict(json.loads(EXAMPLE.read_text())["files"]["configs/1azp-dna-anm.json"],
                  receptor_atoms=500, ligand_atoms=200, glowworms=12)
    cx = Complex(config, 2 ** 31 + 7, tmp_path / "dna")
    rigid = Complex(dict(manifest.load("configs", "1ppe-dfire-rigid"), receptor_atoms=500,
                         ligand_atoms=200, glowworms=12), 2 ** 31 + 7, tmp_path / "dfire")
    setup = json.loads(cx.setup.read_text())
    assert (setup["use_anm"], setup["anm_rec"], setup["anm_lig"]) == (True, 10, 10)
    assert not (cx.root / "data" / "DCparams").exists()
    lig = (cx.root / "lightdock_lig.pdb").read_text().splitlines()[:-1]
    assert {line[17:20].strip() for line in lig} <= set(NUCLEOTIDES)
    assert np.array_equal(cx.rec, rigid.rec) and np.array_equal(cx.centres, rigid.centres)
    for name, xyz in (("rec", cx.rec), ("lig", cx.lig)):
        modes = np.load(cx.root / f"{name}_nm.npy")
        assert modes.shape == (10, len(xyz), 3)
        flat = modes.reshape(10, -1)
        assert np.allclose(flat @ flat.T, np.eye(10), atol=1e-12)
        x = xyz - xyz.mean(axis=0)
        assert np.abs(modes.sum(axis=1)).max() < 1e-9
        assert max(abs((np.cross(np.eye(3)[c], x) * m).sum()) for m in modes
                   for c in range(3)) < 1e-9
        # Smooth: atoms within 3 A move alike, far more than atoms 25 A apart.
        d = np.linalg.norm(xyz[:, None] - xyz[None], axis=-1)
        step = np.linalg.norm(modes[0][:, None] - modes[0][None], axis=-1)
        assert step[(d > 0) & (d < 3)].mean() < 0.3 * step[d > 25].mean()
    for job in (0, 5):
        for a, b in zip(cx.positions(job, 3), rigid.positions(job, 3)):
            assert a.shape == (12, 27) and np.array_equal(a[:, :7], b)
        assert not np.array_equal(cx.positions(job, 1)[0][:, 7:],
                                  cx.positions(job + 1, 1)[0][:, 7:])
    coefficients = np.concatenate([p[:, 7:] for p in cx.positions(2, 20)])
    assert abs(coefficients.mean()) < 0.1 and abs(coefficients.std() - 1) < 0.1


def test_method_without_a_reference_is_refused(tmp_path, monkeypatch):
    """A configuration whose method the reference does not score is
    refused at set-up, before any input is made or job run."""
    sys.path.insert(1, str(ROOT))
    import run

    monkeypatch.setattr(run, "Complex", lambda *a: pytest.fail("inputs made"))
    override = {"config": {"method": "pydock"}}
    with pytest.raises(ValueError, match="no reference scorer for method 'pydock'"):
        run.main(["--workload", "1ppe-dfire-rigid.swarm1", "--seed", "1", "--seconds", "1",
                  "--platform", "cpu", "--override", json.dumps(override)])
    with pytest.raises(ValueError, match="no reference scorer for method 'pydock'"):
        Complex(dict(manifest.load("configs", "1ppe-dfire-rigid"), method="pydock"), 1, tmp_path)
