"""The port's host IO library (``csrc/io_native.cpp`` through
``lightdock_tpu_torch.utils.native``) against its plain versions and the
JAX package's: the ``gso_N.out`` writer byte for byte against
``format_gso_output`` (negative zeros, halves, ANM columns) and against the
JAX package's native writer (NaNs of either sign as well), the PDB
reader against ``parse_pdb_plain`` and ``lightdock_tpu.utils.pdb``; and a
build that cannot run raises instead of falling back."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu.utils import output as jout  # noqa: E402
from lightdock_tpu.utils import pdb as jpdb  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.ops import _build  # noqa: E402
from lightdock_tpu_torch.utils import native, output, pdb  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _snapshot(seed, g, d):
    rng = np.random.RandomState(seed)
    poses = rng.standard_normal((g, d)) * 10.0 ** rng.uniform(-9, 3, (g, d))
    return (poses, rng.uniform(0, 20, g), rng.randint(0, 6, g), rng.uniform(0, 5, g),
            rng.standard_normal(g) * 100)


def _edge_values():
    """Values where decimal rendering goes wrong first: signed zeros, tiny
    negatives that round to -0, exact binary halves at 3, 7 and 8 decimals
    (k / 16, k / 256, k / 512 for odd k), values next to those halves,
    subnormals, non-finite values of either sign, and magnitudes beyond
    2^32."""
    halves = np.concatenate([np.arange(-301, 302, 2) / d for d in (16.0, 256.0, 512.0)])
    near = np.concatenate([np.nextafter(halves, np.inf), np.nextafter(halves, -np.inf)])
    special = [0.0, -0.0, -1e-9, 1e-9, -4.9999999e-8, 5e-8, -5e-8, 5e-9, -5e-4, 0.0005,
               0.5, 1.5, 2.5, -2.5, 0.9999999999, -0.99999999995, 4294967295.5,
               4294967296.0, -4294967296.5, 1e15, -1e300, 5e-324, -5e-324,
               2.0 ** -1022, np.nan, -np.nan, np.inf, -np.inf]
    return np.concatenate([halves, near, special])


@pytest.mark.parametrize("pose_dim", [7, 27])
def test_writer_byte_identical(tmp_path, pose_dim):
    """Seeded snapshots, rigid (7 columns) and with 10 + 10 ANM columns."""
    cols = _snapshot(pose_dim, 200, pose_dim)
    output.write_gso_output(tmp_path / "gso_1.out", *cols)
    text = (tmp_path / "gso_1.out").read_text()
    assert text == output.format_gso_output(*cols)
    assert text == jout.format_gso_output(*cols)


def _signed_nans():
    """NaNs with the sign bit clear and set: the quiet NaN and its
    negation, inf - inf (the sign bit set on x86) and a NaN with a payload
    of either sign."""
    payload = np.array([0x7FF8000000000123, 0xFFF8000000000123],
                       dtype=np.uint64).view(np.float64)
    with np.errstate(invalid="ignore"):
        inf_minus_inf = np.array([np.inf]) - np.array([np.inf])
    return np.concatenate([[np.nan, -np.nan], inf_minus_inf, payload])


def _fields(line):
    """A ``gso_N.out`` row's number fields: the pose's, then luciferin,
    the neighbour count, vision and scoring."""
    pose, rest = line[1:].split(")")
    return pose.split(", ") + rest.split()[2:]


def test_writer_edge_values(tmp_path):
    """The port's writer against the JAX package's native writer byte for
    byte, NaNs of either sign in every column included (glibc writes
    "-nan" where the sign bit is set); the rows without a NaN also against
    the plain ``format_gso_output``, which writes "nan" for both."""
    from lightdock_tpu.utils import native as jnative

    values = np.concatenate([_edge_values(), _signed_nans()])
    g = values.size
    rng = np.random.RandomState(1)
    poses = np.stack([values, -values, values[::-1]], axis=1)
    nn = rng.randint(-5, 10 ** 6, g)
    cols = (poses, values[::-1].copy(), nn, values, -values)
    assert jnative.write_gso(str(tmp_path / "jax.out"), *cols), \
        "the JAX package's native writer did not run"
    output.write_gso_output(tmp_path / "edge.out", *cols)
    text = (tmp_path / "edge.out").read_text()
    assert text == (tmp_path / "jax.out").read_text()

    rows = text.splitlines()[1:]
    table = np.column_stack([poses, cols[1], nn, cols[3], cols[4]])
    nan = np.isnan(table)
    for col in (0, 1, 2, 3, 5, 6):  # every pose component, luciferin, vision, scoring
        signs = np.signbit(table[nan[:, col], col])
        assert signs.any() and not signs.all()
    for i, j in zip(*np.nonzero(nan)):
        assert _fields(rows[i])[j] == ("-nan" if np.signbit(table[i, j]) else "nan")
    clean = ~nan.any(axis=1)
    plain = output.format_gso_output(*(c[clean] for c in cols)).splitlines()[1:]
    assert [r for r, keep in zip(rows, clean) if keep] == plain
    assert "-0.0000000" in text


def test_reader_reads_signed_nan(tmp_path):
    """A snapshot with "-nan" scores reads back as NaN through the port's
    text reader (used by the text resume), as through the JAX package's."""
    poses, luc, nn, vis, sco = _snapshot(7, 6, 7)
    sco[[1, 4]] = _signed_nans()[[1, 2]]
    path = tmp_path / "gso_10.out"
    output.write_gso_output(path, poses, luc, nn, vis, sco)
    assert path.read_text().count("-nan") == 2
    ours, ref = output.read_gso_output(path), jout.read_gso_output(path)
    assert np.isnan(ours[4][[1, 4]]).all() and not np.isnan(np.delete(ours[4], [1, 4])).any()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)

def test_writer_float32_state(tmp_path):
    """The runner hands the writer float32 state cast to float64 and int32
    neighbour counts."""
    cols = [np.asarray(c, dtype=np.float32).astype(np.float64) for c in _snapshot(2, 64, 11)]
    cols[2] = cols[2].astype(np.int32)
    output.write_gso_output(tmp_path / "a.out", *cols)
    assert (tmp_path / "a.out").read_text() == output.format_gso_output(*cols)


def test_writer_errors(tmp_path):
    cols = _snapshot(3, 4, 7)
    with pytest.raises(FileNotFoundError):
        native.write_gso(tmp_path / "missing" / "gso_1.out", *cols)
    with pytest.raises(ValueError):
        native.write_gso(tmp_path / "a.out", cols[0], cols[1][:3], *cols[2:])


def _pdb_variants(tmp_path):
    """Stand-in PDB files of both methods, and one with HETATM records,
    insertion codes, short lines, negative coordinates and other records."""
    paths = []
    for method in ("dfire", "dna"):
        standin.write_complex(tmp_path / method, method, 90, 40, 2, seed=4)
        paths += [tmp_path / method / "lightdock_rec.pdb", tmp_path / method / "lightdock_lig.pdb"]
    odd = tmp_path / "odd.pdb"
    odd.write_text(
        "REMARK  made by hand\n"
        "ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N\n"
        "ATOM      2  CA  ALA A   1A     -1.000-100.250   0.000\n"
        "HETATM    3 ZN    ZN B 101       0.125   3.500  -7.875  1.00  0.00          ZN\n"
        "TER\n"
        "ATOM      4 1HB  LYS  1000       1.000   2.000   3.000  1.00  0.00           H\n"
        "ATOM      5  O   HOH W   7     999.999-999.999  12.345\n"
        "END\n")
    return paths + [odd]


def test_parse_pdb_matches(tmp_path):
    for path in _pdb_variants(tmp_path):
        ours, plain, ref = pdb.parse_pdb(path), pdb.parse_pdb_plain(path), jpdb.parse_pdb(path)
        for other in (plain, ref):
            assert ours.atom_names == other.atom_names
            assert ours.res_names == other.res_names
            assert ours.res_ids == other.res_ids
            assert ours.chain_ids == other.chain_ids
            np.testing.assert_array_equal(ours.coordinates, other.coordinates)
        assert ours.coordinates.shape == (ours.num_atoms, 3) and ours.num_atoms > 0
    empty = tmp_path / "empty.pdb"
    empty.write_text("REMARK nothing\nEND\n")
    assert pdb.parse_pdb(empty).coordinates.shape == (0, 3)
    with pytest.raises(FileNotFoundError):
        pdb.parse_pdb(tmp_path / "absent.pdb")
    good = "ATOM      1  N   ALA A   1      11.104   6.134  -6.504\n"
    for bad in ("ATOM      2  CA  ALA A   1      11.1x4   6.134  -6.504\n",
                "ATOM      2  CA  ALA A   1      11.104           -6.504\n",
                "ATOM      2  CA  ALA A   1      11.104   6.134\n"):
        path = tmp_path / "bad.pdb"
        path.write_text(good + bad)
        with pytest.raises(ValueError):
            pdb.parse_pdb_plain(path)
        with pytest.raises(ValueError, match="line 2"):
            pdb.parse_pdb(path)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process, so
    the next call has to compile ``io_native.cpp``."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    """No $CXX and no g++: the writer and the reader raise and write
    nothing; no switch or fallback takes the Python path."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    out = fresh_build / "gso_1.out"
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        output.write_gso_output(out, *_snapshot(5, 3, 7))
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        pdb.parse_pdb(_pdb_variants(fresh_build)[0])


def test_failed_build_raises_with_log(fresh_build, monkeypatch):
    """A compiler that fails: the error names the command and carries its
    output."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false .*io_native.cpp failed"):
        output.write_gso_output(fresh_build / "gso_1.out", *_snapshot(6, 3, 7))
    assert not list((fresh_build / "build").glob("*.so"))


def test_build_keyed_by_source(fresh_build, monkeypatch):
    """The library lands in the build directory under a name keyed by the
    source's hash, and a second process-level load reuses it."""
    lib = _build.load("io_native")
    assert lib.path.parent == fresh_build / "build"
    assert lib.path.name.startswith("libio_native-") and lib.build_seconds > 0
    monkeypatch.setattr(_build, "_loaded", {})
    again = _build.load("io_native")
    assert again.path == lib.path and again.build_seconds == 0.0
