"""The benchmark's files against BENCHMARK.json and the contract's rules,
discovery by files alone, the generator, and the imports.

    python -m pytest benchmark/test_bench_manifest.py -q
"""

import ast
import json
import pathlib
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

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}


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
