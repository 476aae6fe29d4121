"""The port's table-selection probes P1-P6 (``lightdock_tpu_torch.probes``,
plain versions on the CPU) against the JAX probes they port
(``scripts/exp_*.py``), run in Pallas interpret mode.

Each script is loaded with ``signal.alarm`` and ``signal.signal`` patched
(a script arms a kill of its process at import) and with
``pl.pallas_call`` recording: every call runs in interpret mode and keeps
its operands and output, and ``jax.jit`` passes its function through.
P1-P3 then run the script's own ``run`` (its kernels and BlockSpecs) at
small shapes, P1 with REPS = 3 and (P, R, L) = (2, 8, 128), P2 and P3 at
R = 16; P4-P6 run all their probes at import, at their own shapes.  Every
variant's plain version is held against the JAX output on the arrays of
the port's ``inputs()``, which must equal the recorded operands bit for
bit.

Tolerances: bit-equal wherever the two sum in one order (every variant of
P2-P6: the loops over r and reps run in order on both sides).  P1's
float32 variants sum (R, L) in XLA's order against the port's fixed order
(runs of 8 elements in order, a tree over a block's 32 runs, the blocks
in order): rtol 1e-6 (measured 3.1e-7 at 3 reps, 5.9e-7 at 33 reps and
R L = 512).  P1's chain16 rounds each rep's float32 sum to bfloat16 on
both sides: one bfloat16 ulp, rtol 2^-8 (measured 0, at 3, 33 and 300
reps, where i > 256 is inexact in bfloat16).
"""

import functools
import importlib.util
import pathlib
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.experimental import pallas as pl  # noqa: E402

from lightdock_tpu_torch import probes  # noqa: E402
from lightdock_tpu_torch.ops import probes as ops  # noqa: E402
from lightdock_tpu_torch.probes import __main__ as entry  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
P1_SHAPES, P1_REPS = dict(P=2, R=8, L=128), 3
CHAIN16_LONG_REPS = 300   # past i = 256, where i in bfloat16 stops being exact
LOOP_R = 16
COMPACT = dict(P=4, L=128, R=16)   # the receptor loop at the compact geometry
# Variant names of each probe in the script's order (the port's variants()).
NAMES = {
    "P1": ["chain", "tak", "tourn", "chain16"],
    "P2": ["slot", "gather", "chain"],
    "P3": ["v3gather", "v2chain"],
    "P4": ["bare_gather", "computed_idx_gather", "fori_static_tab_gather",
           "fori_plload_gather", "unrolled_static_slices"],
    "P5": ["bare_gather_32", "computed_idx_gather", "fori_dyn3dslice_64",
           "fori_gather_64", "vmem_53mb_touch", "chain_fori_64"],
    "P6": ["sqrt", "trunc_cast", "gather_static_tab", "gather_dyn_tab",
           "smem_scalar_loop", "fori_dyn_gather", "where_chain20"],
}
CASES = [(p, n) for p in sorted(NAMES) for n in NAMES[p]]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet_scripts(mp):
    """Patches, for a MonkeyPatch context, what a script changes at import:
    its kill alarm and its insert into ``sys.path``."""
    mp.setattr(signal, "alarm", lambda *a: 0)
    mp.setattr(signal, "signal", lambda *a: None)
    mp.setattr(sys, "path", list(sys.path))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def recorded():
    """{probe: [(operands, output) of each pallas_call, in call order]},
    the scripts run at the small shapes of the module docstring."""
    calls = []
    real = pl.pallas_call

    def recording(kernel, **kwargs):
        f = real(kernel, interpret=True, **kwargs)
        rec = {}
        calls.append(rec)

        def call(*operands):
            if "out" not in rec:   # the scripts call again only to time
                rec["operands"] = [np.asarray(o) for o in operands]
                rec["out"] = np.asarray(f(*operands))
            return rec["out"]
        return call

    out = {}
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        _quiet_scripts(mp)
        mp.setattr(pl, "pallas_call", recording)
        mp.setattr(jax, "jit", lambda f, **kw: f)
        m = _load_script("exp_gather_kernel")
        m.REPS = P1_REPS
        m.P, m.R, m.L = P1_SHAPES["P"], P1_SHAPES["R"], P1_SHAPES["L"]
        n = len(calls)
        for body, dtype in ((m.chain_body, jax.numpy.float32), (m.tak_body, jax.numpy.float32),
                            (m.tourn_body, jax.numpy.float32),
                            (m.chain_body, jax.numpy.bfloat16)):
            m.run("probe", body, dtype)   # chain16's print of a bfloat16 sum fails after the call
        out["P1"] = calls[n:]
        m.REPS = CHAIN16_LONG_REPS
        m.run("probe", m.chain_body, jax.numpy.bfloat16)
        out["P1.chain16_long"] = calls[-1]
        for probe, name, modes in (("P2", "exp_gather2d", ("slot", "gather", "chain")),
                                   ("P3", "exp_gather32", ("v3gather", "v2chain"))):
            m = _load_script(name)
            m.R = LOOP_R
            n = len(calls)
            for mode in modes:
                m.run(mode)
            out[probe] = calls[n:]
        for probe in ("P4", "P5", "P6"):
            n = len(calls)
            _load_script(probes.SCRIPTS[probe])
            out[probe] = calls[n:]
    assert sys.path == path   # the scripts' own inserts into the path are undone
    return out


def _port(probe):
    mod = probes.load(probe)
    if probe == "P1":
        arrays = mod.inputs(**P1_SHAPES)
        return arrays, mod.variants(arrays, reps=P1_REPS)
    if probe in ("P2", "P3"):
        arrays = mod.inputs(R=LOOP_R)
    else:
        arrays = mod.inputs()
    return arrays, mod.variants(arrays)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("probe,name", CASES)
def test_plain_matches_jax_probe(recorded, probe, name):
    """A variant's plain version against the JAX probe's interpret-mode
    output on the same inputs, at the tolerances of the module docstring.
    ``fori_plload_gather`` (P4) cannot run on this JAX, which has no
    ``pl.load``: it computes what ``unrolled_static_slices`` computes and is
    held against that probe's output."""
    arrays, variants = _port(probe)
    assert [v.name for v in variants] == NAMES[probe]
    i = NAMES[probe].index(name)
    v, rec = variants[i], recorded[probe][i]
    t = v.tensors(arrays, "cpu")
    assert len(rec["operands"]) == len(v.args)
    for op, key in zip(rec["operands"], v.args.values()):
        assert t[key].shape == op.shape
        assert np.array_equal(_bits(t[key]), op.view(np.int16) if op.dtype.itemsize == 2 else op), key
    if name == "fori_plload_gather":
        assert "out" not in rec   # the probe raised: no pl.load
        ref = recorded[probe][NAMES[probe].index("unrolled_static_slices")]["out"]
    else:
        ref = rec["out"]
    got = v(t)
    assert got.shape == ref.shape and got.dtype == v.dtype
    got, ref = got.float().numpy(), ref.astype(np.float32)
    if probe == "P1" and name != "chain16":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    elif name == "chain16":
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)


def test_chain16_long_reps_matches_jax(recorded):
    """chain16 at 300 reps, where the bfloat16 rep index ``i`` is no longer
    exact (i > 256) and the bfloat16 accumulator's ulp (128 past 2^14)
    exceeds one rep's sum (about 90), against the JAX probe in interpret
    mode: within one bfloat16 ulp, rtol 2^-8 (measured 0)."""
    mod = probes.load("P1")
    arrays = mod.inputs(**P1_SHAPES)
    v = mod.variants(arrays, reps=CHAIN16_LONG_REPS)[3]
    assert v.name == "chain16" and v.dtype == torch.bfloat16
    rec = recorded["P1.chain16_long"]
    t = v.tensors(arrays, "cpu")
    for op, key in zip(rec["operands"], v.args.values()):
        assert np.array_equal(_bits(t[key]), op.view(np.int16)), key
    got, ref = v(t).float().numpy(), rec["out"].astype(np.float32)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("probe,name", [("P2", "slot"), ("P2", "gather"), ("P2", "chain"),
                                        ("P3", "v3gather"), ("P3", "v2chain")])
def test_receptor_loop_plain_matches_script_kernel_compact(probe, name):
    """The receptor loop's plain version bit-equal to the script's own
    ``kernel``, run through ``pl.pallas_call(..., interpret=True)``, at the
    compact geometry (coordinates from uniform(-6, 6), (P, L, R) = (4,
    128, 16)), where the pairs reach every slot 0-31, both sides of every
    chain threshold and of the 15 A cutoff; the scripts' uniform(-20, 20)
    almost never leaves slot 31."""
    mod = probes.load(probe)
    arrays = mod.inputs(span=probes.load("P2").COMPACT_SPAN, **COMPACT)
    lig, rec, tab = (np.asarray(arrays[k], np.float32) for k in ("lig", "rec", "tab"))
    d2 = ((lig[None] - rec[:, None, :, None]) ** 2).sum(2)
    assert np.unique(np.clip((2 * np.sqrt(d2) - 1).astype(np.int32), 0, 31)).size == 32
    assert d2.min() < mod.THRESH[0] and (d2 > ops.CUTOFF2).any() and (d2 < ops.CUTOFF2).any()
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        _quiet_scripts(mp)
        script = _load_script(probes.SCRIPTS[probe])
    assert sys.path == path
    script.R = COMPACT["R"]   # the kernel's loop reads the module's R
    call = pl.pallas_call(functools.partial(script.kernel, name), interpret=True,
                          out_shape=jax.ShapeDtypeStruct((COMPACT["P"], COMPACT["L"]),
                                                         jax.numpy.float32))
    ref = np.asarray(call(lig, rec, tab))
    (v,) = [v for v in mod.variants(arrays) if v.name == name]
    t = v.tensors(arrays, "cpu")
    for key, x in (("lig", lig), ("rec", rec), ("tab", tab)):
        assert np.array_equal(t[key].numpy(), x), key
    np.testing.assert_array_equal(v(t).numpy(), ref)


def _f32_sum_orders(terms):
    """One rep's f32 sum of ``terms`` (R L,) in three orders: the kernel's
    (``ops.probes`` docstring: runs of 8 in order, the 32 run sums of a
    256-element block in a halving tree, the blocks in order), one serial
    pass, and a halving tree over all the terms."""
    v = terms.astype(np.float32)
    run = v.reshape(-1, ops.WARP, ops.RUN)
    acc = run[..., 0]
    for k in range(1, ops.RUN):
        acc = acc + run[..., k]
    h = ops.WARP // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    kernel = acc[0, 0]
    for b in range(1, acc.shape[0]):
        kernel = np.float32(kernel + acc[b, 0])
    serial = v[0]
    for x in v[1:]:
        serial = np.float32(serial + x)
    tree = v
    while tree.size > 1:
        tree = tree[:tree.size // 2] + tree[tree.size // 2:]
    return kernel, serial, tree[0]


@pytest.mark.parametrize("variant", ["chain", "tak", "tourn", "chain16"])
def test_select_reps_plain_order(variant):
    """``select_reps_plain`` sums each rep's (R, L) terms in the kernel's
    documented order, exactly.  At P = 1, R L = 512 (two blocks) and d2 = 0,
    every rep's x = i 1e-6 lies below the first threshold, so every form
    selects tab[0] and the terms are tab[0] itself: values from {+-2^24, 1,
    2, 3} (seed 4), for which the kernel's order, a serial pass and a
    halving tree give three different f32 sums (608, 422, 592; in bfloat16
    608, 424, 592).  Two reps: the output is the rounded sum added twice
    from zero in the working type."""
    mod = probes.load("P1")
    dt = torch.bfloat16 if variant == "chain16" else torch.float32
    terms = np.random.RandomState(4).choice([2.0 ** 24, -2.0 ** 24, 1.0, 2.0, 3.0], 512)
    kernel, serial, tree = _f32_sum_orders(terms)
    rounded = [float(torch.tensor(float(x)).to(dt)) for x in (kernel, serial, tree)]
    assert len(set(rounded)) == 3, rounded
    tab = torch.as_tensor(np.random.RandomState(5).randn(21, 2, 256), dtype=torch.float32)
    tab[0] = torch.as_tensor(terms.reshape(2, 256), dtype=torch.float32)
    d2 = torch.zeros((1, 2, 256))
    assert mod.THRESH[0] > 1e-6
    got = ops.select_reps_plain(d2.to(dt), tab.to(dt), mod.THRESH,
                                "chain" if variant == "chain16" else variant, 2)
    once = torch.tensor(float(kernel)).to(dt)
    expect = (torch.zeros((), dtype=dt) + once) + once
    assert got.shape == (1, 1, 1) and got.dtype == dt
    assert torch.equal(got.reshape(()), expect), (float(got), rounded)


@pytest.mark.parametrize("reps", [1, 33])
@pytest.mark.parametrize("variant", NAMES["P1"])
def test_select_reps_plain_matches_script_kernel(variant, reps):
    """``select_reps_plain`` against the script's own Pallas kernel
    (``mk_kernel`` of its body, with the script's BlockSpecs) run in
    interpret mode, at (P, R, L) = (2, 2, 256), R L = 512, and 1 or 33
    reps (33: past one batch of 8 and a run of 32), at the module
    docstring's tolerances."""
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        _quiet_scripts(mp)
        script = _load_script("exp_gather_kernel")
    assert sys.path == path
    script.REPS = reps   # the kernel's loop reads the module's REPS
    mod = probes.load("P1")
    arrays = mod.inputs(P=2, R=2, L=256)
    (v,) = [v for v in mod.variants(arrays, reps=reps) if v.name == variant]
    t = v.tensors(arrays, "cpu")
    jdt = jax.numpy.bfloat16 if v.dtype == torch.bfloat16 else jax.numpy.float32
    body = {"chain": script.chain_body, "tak": script.tak_body, "tourn": script.tourn_body,
            "chain16": script.chain_body}[variant]
    call = pl.pallas_call(script.mk_kernel(body), interpret=True,
                          out_shape=jax.ShapeDtypeStruct((2, 1, 1), jdt),
                          in_specs=[pl.BlockSpec(memory_space=script.pltpu.VMEM)] * 2,
                          out_specs=pl.BlockSpec(memory_space=script.pltpu.VMEM))
    ref = np.asarray(call(*(jax.numpy.asarray(t[k].float().numpy(), jdt)
                            for k in ("d2", "tab")))).astype(np.float32)
    got = v(t)
    assert got.shape == ref.shape and got.dtype == v.dtype
    rtol = 2.0 ** -8 if variant == "chain16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol, atol=0)


def test_p1_tak_equals_tourn_not_chain():
    """tak and tourn select the same entry exactly; chain adds deltas, a
    different function (as in the script)."""
    mod = probes.load("P1")
    arrays = mod.inputs(**P1_SHAPES)
    out = {v.name: v(v.tensors(arrays, "cpu")) for v in mod.variants(arrays, reps=P1_REPS)}
    assert torch.equal(out["tak"], out["tourn"])
    assert not torch.allclose(out["tak"], out["chain"])


def test_thresholds_and_shapes_match_scripts():
    """The port's thresholds and shapes are the scripts'."""
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        _quiet_scripts(mp)
        s1, s3 = _load_script("exp_gather_kernel"), _load_script("exp_gather32")
    assert sys.path == path
    p1, p3 = probes.load("P1"), probes.load("P3")
    assert p1.THRESH == s1.THRESH and (p1.P, p1.R, p1.L, p1.K, p1.REPS) == (s1.P, s1.R, s1.L, s1.K, s1.REPS)
    assert p3.THRESH == s3.THRESH and (p3.P, p3.L, p3.R) == (s3.P, s3.L, s3.R)


def test_bare_gather_clips_indices():
    """``bare`` clips its indices into the table (the kernel reads no
    memory outside it): out-of-range indices take the first or last slot."""
    tab = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    idx = torch.tensor([[-3, 0, 31, 40]], dtype=torch.int32)
    out = ops.gather_form("bare", tab=tab, idx=idx)
    assert out.tolist() == [[0.0, 1.0, 31 * 4 + 2.0, 31 * 4 + 3.0]]


@pytest.mark.parametrize("wrapper", ["select_reps", "receptor_loop", "gather_form"])
def test_wrappers_refuse_other_devices(wrapper):
    """No fallback: a tensor on neither the CPU nor the card raises."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        if wrapper == "select_reps":
            ops.select_reps(torch.empty((1, 1, 256), device=meta),
                            torch.empty((21, 1, 256), device=meta),
                            probes.load("P1").THRESH, "chain", 1)
        elif wrapper == "receptor_loop":
            ops.receptor_loop(torch.empty((1, 3, 8), device=meta), torch.empty((2, 3), device=meta),
                              torch.empty((2, 32, 8), device=meta), probes.load("P2").THRESH,
                              "gather")
        else:
            ops.gather_form("sqrt", torch.empty((2, 8), device=meta))


def test_entry_point_on_cpu(capsys):
    """``python -m lightdock_tpu_torch.probes --device cpu --only P6``
    prints one line a variant with its sum; without a GPU the default
    device raises."""
    assert entry.main(["--only", "P6", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("P6 (exp_probe_ops.py) on cpu")
    assert [ln.split()[0] for ln in lines[1:]] == [f"P6.{n}" for n in NAMES["P6"]]
    assert all(" ms " in ln and "pairs/s" in ln and "chk=" in ln for ln in lines[1:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(["--only", "P6"])


def test_threshold_arrays_made_once_a_tuple():
    """The kernels' ctypes threshold arrays are made once for each tuple of
    values: the same values give the same array, other values (one
    threshold moved, one fewer) another array holding those values, never
    the cached one; an empty tuple still gives one element."""
    thr = tuple(probes.load("P2").THRESH)
    first = ops.threshold_array(thr)
    assert ops.threshold_array(tuple(float(t) for t in thr)) is first
    assert list(first) == [np.float32(t) for t in thr]
    moved = thr[:3] + (thr[3] + 0.25,) + thr[4:]
    other = ops.threshold_array(moved)
    assert other is not first and list(other) == [np.float32(t) for t in moved]
    assert list(first) == [np.float32(t) for t in thr]   # the cached array is untouched
    shorter = ops.threshold_array(thr[:-1])
    assert shorter is not first and len(shorter) == len(thr) - 1
    assert len(ops.threshold_array(())) == 1


_TAB = torch.zeros((4, 32, 8))
_X = torch.full((2, 8), 2.0)
_IDX = torch.zeros((2, 8), dtype=torch.int32)
_REFUSED = {
    "unknown form": (ValueError, dict(form="gather", x=_X)),
    "no x": (ValueError, dict(form="sqrt")),
    "x not 2-d": (ValueError, dict(form="sqrt", x=torch.ones(8))),
    "float64 x": (TypeError, dict(form="sqrt", x=_X.double())),
    "int64 idx": (TypeError, dict(form="bare", tab=_TAB[0], idx=_IDX.long())),
    "no table": (ValueError, dict(form="slot_gather", x=_X)),
    "table width": (ValueError, dict(form="slot_gather", x=_X, tab=torch.zeros((32, 9)))),
    "table slots": (ValueError, dict(form="slot_gather", x=_X, tab=torch.zeros((16, 8)))),
    "table row": (ValueError, dict(form="slot_gather", x=_X, tab=_TAB, row=4)),
    "too few tables": (ValueError, dict(form="slice_loop", x=_X, tab=_TAB, reps=5)),
    "chain thresholds": (ValueError, dict(form="chain_loop", x=_X, tab=_TAB, thresholds=(1.0,))),
    "no rec": (ValueError, dict(form="scalar_loop", x=_X, reps=2)),
    "short rec": (ValueError, dict(form="scalar_loop", x=_X, rec=torch.zeros((1, 3)), reps=2)),
    "no reps": (ValueError, dict(form="static_loop", x=_X, tab=_TAB[0], reps=0)),
    "table elsewhere": (ValueError, dict(form="slot_gather", x=_X, tab=_TAB.to("meta"))),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_gather_form_refusals(case):
    """The checks the kernel's launch shares with the plain version: each
    input the kernel cannot take raises, on the CPU as on the card."""
    exc, kwargs = _REFUSED[case]
    with pytest.raises(exc):
        ops.gather_form(**kwargs)
