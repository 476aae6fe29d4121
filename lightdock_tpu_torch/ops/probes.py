"""The table-selection probes P1-P6: three Hopper kernels and their plain
versions.

The probes (``lightdock_tpu_torch.probes``, ports of ``scripts/exp_*.py``)
time the ways DFIRE can pick a pair's table entry from its d2: a select
chain, a tournament of selects, a count of the thresholds passed and one
indexed load, or the arithmetic slot ``trunc(2 sqrt(d2) - 1)`` and one
gather.  Three wrappers serve them, each over one kernel template of
``csrc/probes.cu`` that takes the variant as a template parameter:

* :func:`select_reps` (P1): ``sum over reps i and (r, l) of
  select(d2 + i 1e-6) [d2 + i 1e-6 <= 225]`` for each p of d2 (P, R, L);
* :func:`receptor_loop` (P2, P3): for each (p, l), the sum over receptor
  atoms r of the slot, the slot's gathered entry or the masked chain;
* :func:`gather_form` (P4-P6): one (P, L) expression per form.

Every variant computes what its JAX probe computes, rounding where it
rounds (bfloat16 at every operation of P1's chain16), and sums in the
probe's order where that order is sequential (over r or reps).  Where the
probe sums in an order of XLA's own (P1's (R, L) sum), the kernel's order
is fixed and the plain version repeats it, so the two are bit-equal: each
256-element block's terms in runs of 8 consecutive elements, each run
added in order from its first element; the block's 32 run sums in a
halving tree (run j + run j + h onto run j, h = 16, 8, 4, 2, 1); the
blocks' sums in order from the first.  The kernel computes a batch of 8
reps' terms a thread (chain16 two reps to a bf16x2 register), puts them
in shared memory, and one warp a rep adds them in that order; its second
launch adds the blocks and the reps.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises; any other device raises.  There is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import constants as C
from . import _build, counts_launches

NSLOT = C.DFIRE_EFFECTIVE_BINS   # slots of the arithmetic binning (0.5 A)
CUTOFF2 = C.DFIRE_DIST_CUTOFF2   # the probes' d2 mask
SELECT_K = 21                    # P1's table entries (20 thresholds)
SELECT_THREADS = 256             # select_reps: elements a block, one a thread
WARP = 32                        # select_reps: run sums a block, in a halving tree
RUN = SELECT_THREADS // WARP     # select_reps: consecutive elements added in order
MAX_CHAIN = 20                   # thresholds of the P2-P6 chains
REP_CHUNK = 32                   # reps per step of select_reps_plain
ROW_CHUNK = 64                   # receptor atoms per step of receptor_loop_plain

SELECT_MODES = {"chain": 0, "tak": 1, "tourn": 2}
LOOP_MODES = {"slot": 0, "gather": 1, "chain": 2}
# form: (kernel id, operands it reads besides x)
FORMS = {
    "bare": (0, ("tab", "idx")),             # tab[row][clip(idx), l]
    "slot_gather": (1, ("x", "tab")),        # tab[row][slot(x), l]
    "static_loop": (2, ("x", "tab")),        # sum_r tab[row][slot(x + r), l]
    "slice_loop": (3, ("x", "tab")),         # sum_r tab[r][slot(x + r), l]
    "row_loop": (4, ("x", "tab")),           # sum_r tab[r][0, l] (x 0 + 1)
    "parity_loop": (5, ("x", "tab")),        # sum_r tab[r][clip(trunc + r % 2), l]
    "touch": (6, ("x", "tab")),              # x + tab[row][0, l]
    "chain_loop": (7, ("x", "tab")),         # sum_r chain(x, tab[r]), no mask
    "sqrt": (8, ("x",)),                     # sqrt(x)
    "trunc_cast": (9, ("x",)),               # float(slot(x))
    "scalar_loop": (10, ("x", "rec")),       # sum_r (x - rec[r, 0])
}
GATHERS = {"bare", "slot_gather", "static_loop", "slice_loop", "parity_loop"}
PER_REP_TABLE = {"slice_loop", "row_loop", "parity_loop", "chain_loop"}


def sqrt(x):
    """float32 sqrt rounded correctly, as XLA's and the kernels' are: taken
    in float64 and rounded once (PyTorch's vectorised float32 sqrt on the
    CPU is not always correctly rounded)."""
    return torch.sqrt(x.double()).to(torch.float32)


def trunc(x):
    """``int32(2 sqrt(x) - 1)``, the cast truncating toward zero."""
    return (2.0 * sqrt(x) - 1.0).to(torch.int32)


def slot(d2):
    """The arithmetic bin ``clip(trunc(d2), 0, NSLOT - 1)`` (int64, for
    gathers)."""
    return trunc(d2).clamp(0, NSLOT - 1).to(torch.int64)


def _chain(x, rows, thresholds):
    """``rows[0] + sum_k rows[k + 1] [x >= s_k]``, added in channel order
    (JAX's ``where`` chain): ``rows(k)`` gives entry k broadcastable to x."""
    contrib = rows(0).expand(x.shape)
    for k, s in enumerate(thresholds):
        contrib = torch.where(x >= s, contrib + rows(k + 1), contrib)
    return contrib


def _tournament(x, tab, thresholds, lo, hi):
    """exp_gather_kernel.py's ``tourn_body`` select tree over tab[lo:hi]."""
    if hi - lo == 1:
        return tab[lo].expand(x.shape)
    mid = (lo + hi) // 2
    left = _tournament(x, tab, thresholds, lo, mid)
    right = _tournament(x, tab, thresholds, mid, hi)
    return torch.where(x >= thresholds[mid - 1], right, left)


def _check_select(d2, tab, thresholds, mode, reps):
    if mode not in SELECT_MODES:
        raise ValueError(f"select_reps mode {mode!r}; one of {sorted(SELECT_MODES)}")
    if d2.dim() != 3 or tab.dim() != 3 or tab.shape[1:] != d2.shape[1:]:
        raise ValueError(f"d2 {tuple(d2.shape)} and tab {tuple(tab.shape)} are "
                         "not (P, R, L) and (K, R, L)")
    if tab.shape[0] != SELECT_K or len(thresholds) != SELECT_K - 1:
        raise ValueError(f"{tab.shape[0]} entries and {len(thresholds)} thresholds; "
                         f"the probe has {SELECT_K} and {SELECT_K - 1}")
    if any(b < a for a, b in zip(thresholds, thresholds[1:])):
        raise ValueError("thresholds must ascend")
    if d2.dtype not in (torch.float32, torch.bfloat16) or tab.dtype != d2.dtype:
        raise TypeError(f"d2 {d2.dtype} and tab {tab.dtype}: both float32 or both bfloat16")
    if (d2.shape[1] * d2.shape[2]) % SELECT_THREADS or reps < 1:
        raise ValueError(f"R L = {d2.shape[1] * d2.shape[2]} must be a multiple of "
                         f"{SELECT_THREADS} and reps {reps} at least 1")
    if tab.device != d2.device:
        raise ValueError(f"tab is on {tab.device}, d2 on {d2.device}")


def select_reps_plain(d2, tab, thresholds, mode: str, reps: int):
    """Plain version of :func:`select_reps`, the kernel's order repeated
    (module docstring): each rep's terms of a 256-element block added in
    runs of 8 consecutive elements, the 32 run sums in a halving tree, the
    blocks in order; then the reps in order in the working type.  Any
    device."""
    _check_select(d2, tab, thresholds, mode, reps)
    dt = d2.dtype
    p, r, l = d2.shape
    thr = torch.tensor(thresholds, dtype=torch.float32).to(dt).tolist()
    tab = tab.reshape(SELECT_K, r * l)
    x0 = d2.reshape(p, r * l)
    nb = r * l // SELECT_THREADS
    eps = torch.tensor(1e-6, dtype=dt, device=d2.device)
    totals = []                                       # (P,) f32 per rep
    for c0 in range(0, reps, REP_CHUNK):
        i = torch.arange(c0, min(c0 + REP_CHUNK, reps), device=d2.device)
        x = x0[None] + (i.to(dt) * eps)[:, None, None]                 # (c, P, RL)
        if mode == "chain":
            sel = _chain(x, lambda k: tab[k], thr)
        elif mode == "tak":
            idx = sum((x >= s).to(torch.int64) for s in thr)
            sel = torch.gather(tab, 0, idx.reshape(-1, r * l)).reshape(x.shape)
        else:
            sel = _tournament(x, tab, thr, 0, SELECT_K)
        v = (sel * (x <= CUTOFF2).to(dt)).float().reshape(x.shape[0], p, nb, WARP, RUN)
        run = v[..., 0]
        for k in range(1, RUN):
            run = run + v[..., k]
        h = WARP // 2
        while h:
            run = run[..., :h] + run[..., h:2 * h]
            h //= 2
        block = run[..., 0]                                            # (c, P, nb)
        tot = block[..., 0]
        for b in range(1, nb):
            tot = tot + block[..., b]
        totals.extend(tot.unbind(0))
    acc = torch.zeros(p, dtype=dt, device=d2.device)
    for t in totals:
        acc = acc + t.to(dt)
    return acc.reshape(p, 1, 1)


def _check_loop(lig, rec, tab, thresholds, mode):
    if mode not in LOOP_MODES:
        raise ValueError(f"receptor_loop mode {mode!r}; one of {sorted(LOOP_MODES)}")
    if lig.dim() != 3 or lig.shape[1] != 3 or rec.dim() != 2 or rec.shape[1] != 3:
        raise ValueError(f"lig {tuple(lig.shape)} and rec {tuple(rec.shape)} are "
                         "not (P, 3, L) and (R, 3)")
    if tuple(tab.shape) != (rec.shape[0], NSLOT, lig.shape[2]):
        raise ValueError(f"tab {tuple(tab.shape)} is not ({rec.shape[0]}, {NSLOT}, "
                         f"{lig.shape[2]})")
    if len(thresholds) != MAX_CHAIN:
        raise ValueError(f"{len(thresholds)} chain thresholds; the probe has {MAX_CHAIN}")
    for name, x in (("lig", lig), ("rec", rec), ("tab", tab)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the probes take float32")
        if x.device != lig.device:
            raise ValueError(f"{name} is on {x.device}, lig on {lig.device}")


def receptor_loop_plain(lig, rec, tab, thresholds, mode: str):
    """Plain version of :func:`receptor_loop`: each step's terms for
    ``ROW_CHUNK`` receptor atoms at once, added in receptor order.  Any
    device."""
    _check_loop(lig, rec, tab, thresholds, mode)
    acc = torch.zeros((lig.shape[0], lig.shape[2]), dtype=torch.float32,
                      device=lig.device)
    for r0 in range(0, rec.shape[0], ROW_CHUNK):
        rc, tc = rec[r0:r0 + ROW_CHUNK], tab[r0:r0 + ROW_CHUNK]
        d2 = None
        for c in range(3):
            diff = lig[None, :, c, :] - rc[:, c, None, None]            # (c, P, L)
            t = diff * diff
            d2 = t if d2 is None else d2 + t
        if mode == "chain":
            contrib = _chain(d2, lambda k: tc[:, None, k, :], thresholds)
            term = contrib * (d2 <= CUTOFF2).to(torch.float32)
        else:
            idx = slot(d2)
            term = idx.to(torch.float32) if mode == "slot" else torch.gather(tc, 1, idx)
        for t in term.unbind(0):
            acc = acc + t
    return acc


def _gather_tab(tab):
    """A (NSLOT, L) table as the (1, NSLOT, L) stack the forms index."""
    return tab[None] if tab.dim() == 2 else tab


def _check_form(form, x, tab, idx, rec, thresholds, reps, row):
    """Checks shared by both versions of :func:`gather_form`; returns the
    (P, L) tensor that sets the output's shape and device."""
    if form not in FORMS:
        raise ValueError(f"gather_form form {form!r}; one of {sorted(FORMS)}")
    needs = FORMS[form][1]
    ref = idx if form == "bare" else x
    if ref is None or ref.dim() != 2:
        raise ValueError(f"{form} needs {'idx' if form == 'bare' else 'x'} (P, L)")
    if x is not None and x.dtype != torch.float32:
        raise TypeError(f"x is {x.dtype}; the probes take float32")
    if "idx" in needs and idx.dtype != torch.int32:
        raise TypeError(f"idx is {idx.dtype}, not int32")
    if "tab" in needs:
        if tab is None or tab.dtype != torch.float32 or tab.dim() not in (2, 3) \
                or tab.shape[-1] != ref.shape[1]:
            raise ValueError(f"{form} needs a float32 table (N, S, {ref.shape[1]}) "
                             f"or (S, {ref.shape[1]})")
        n, s = (1, tab.shape[0]) if tab.dim() == 2 else tab.shape[:2]
        if form in GATHERS and s != NSLOT:
            raise ValueError(f"{form} gathers from {NSLOT} slots, the table has {s}")
        if form == "chain_loop" and s < MAX_CHAIN + 1:
            raise ValueError(f"chain_loop reads {MAX_CHAIN + 1} entries, the table has {s}")
        used = reps if form in PER_REP_TABLE else row + 1
        if row < 0 or used > n:
            raise ValueError(f"{form} reads {used} tables of {n}")
    if "rec" in needs and (rec is None or rec.dim() != 2 or rec.shape[0] < reps
                           or rec.dtype != torch.float32):
        raise ValueError(f"{form} needs a float32 rec (>= {reps}, C)")
    if form == "chain_loop" and len(thresholds) != MAX_CHAIN:
        raise ValueError(f"chain_loop takes {MAX_CHAIN} thresholds, not {len(thresholds)}")
    if reps < 1:
        raise ValueError(f"reps {reps} must be at least 1")
    dev = ref.device
    for name, t in (("x", x), ("tab", tab), ("idx", idx), ("rec", rec)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    return ref


def gather_form_plain(form: str, x=None, tab=None, idx=None, rec=None, *,
                      thresholds=(), reps: int = 1, row: int = 0):
    """Plain version of :func:`gather_form`; loops add in rep order.  Any
    device."""
    _check_form(form, x, tab, idx, rec, thresholds, reps, row)
    tabs = None if tab is None else _gather_tab(tab)
    if form == "sqrt":
        return sqrt(x)
    if form == "trunc_cast":
        return slot(x).to(torch.float32)
    if form == "bare":
        return torch.gather(tabs[row], 0, idx.to(torch.int64).clamp(0, tabs.shape[1] - 1))
    if form == "slot_gather":
        return torch.gather(tabs[row], 0, slot(x))
    if form == "touch":
        return x + tabs[row, 0:1, :]
    acc = torch.zeros_like(x)
    for r in range(reps):
        if form == "static_loop":
            term = torch.gather(tabs[row], 0, slot(x + float(r)))
        elif form == "slice_loop":
            term = torch.gather(tabs[r], 0, slot(x + float(r)))
        elif form == "row_loop":
            term = tabs[r, 0:1, :] * (x * 0.0 + 1.0)
        elif form == "parity_loop":
            i = (trunc(x) + r % 2).clamp(0, NSLOT - 1)
            term = torch.gather(tabs[r], 0, i.to(torch.int64))
        elif form == "chain_loop":
            term = _chain(x, lambda k: tabs[r, k:k + 1, :], thresholds)
        else:  # scalar_loop
            term = x - rec[r, 0]
        acc = acc + term
    return acc


# -- the kernels ---------------------------------------------------------------

def _lib():
    lib = _build.load("probes").lib
    if not getattr(lib, "_bound", False):
        f = ctypes.c_float
        lib.select_reps_launch.restype = ctypes.c_int
        lib.select_reps_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(f), f,
                                                          ctypes.c_void_p])
        lib.receptor_loop_launch.restype = ctypes.c_int
        lib.receptor_loop_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.POINTER(f), f,
                                                          ctypes.c_void_p])
        lib.gather_form_launch.restype = ctypes.c_int
        lib.gather_form_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.POINTER(f),
                                                          ctypes.c_void_p])
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=64)
def threshold_array(thresholds: tuple):
    """The ctypes float array of ``thresholds`` (a tuple of floats), made
    once a tuple: a call with other values gets another array, never this
    one.  At least one element, so an empty tuple still has a pointer."""
    arr = (ctypes.c_float * max(len(thresholds), 1))()
    for k, v in enumerate(thresholds):
        arr[k] = float(v)
    return arr


def _run(name, index, launch):
    """``launch(stream)`` on the current stream of CUDA device ``index``,
    switching the current device only when it is another; raises on a
    launch error.  The current device and the raw stream handle come from
    ``torch._C`` directly (``torch._C._cuda_getCurrentRawStream`` is what
    Triton's launcher takes): ``torch.cuda.current_stream`` builds a Python
    stream object a call, and a single-shot probe's device work is about a
    microsecond."""
    if torch._C._cuda_getDevice() == index:
        err = launch(torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = launch(torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _dispatch(name, ref, plain, launch):
    """A CUDA tensor ``ref`` takes ``launch()``; a CPU tensor ``plain()``.
    The CUDA test comes first and reads ``is_cuda``, which builds no
    ``torch.device``: a single-shot probe's host path is a few
    microseconds."""
    if ref.is_cuda:
        return launch()
    if ref.device.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda, not {ref.device.type}")
    return plain()


@counts_launches
def select_reps(d2, tab, thresholds, mode: str, reps: int):
    """P1: for each p of d2 (P, R, L), ``sum over i < reps of the sum over
    (r, l) of select_mode(d2 + i 1e-6)[r, l] [d2 + i 1e-6 <= 225]``, with
    the reps added in order in d2's type; (P, 1, 1).

    ``chain`` adds ``tab[k + 1]`` where d2 >= s_k onto ``tab[0]``;
    ``tak`` and ``tourn`` take ``tab[#thresholds passed]``, by a count and
    one load or by a tree of selects.  float32, or bfloat16 rounded at
    every operation as JAX does (each rep's (R, L) sum in float32).

    A CPU tensor takes :func:`select_reps_plain`; a CUDA tensor launches
    ``csrc/probes.cu`` and adds one to ``select_reps.launches``."""

    def launch():
        _check_select(d2, tab, thresholds, mode, reps)
        p, r, l = d2.shape
        x, t = d2.contiguous(), tab.contiguous()
        # One allocation: the output's P floats, then the (P, R L / 256,
        # reps) block sums.  The output is a view of its first P elements.
        ws = torch.empty(p + p * (r * l // SELECT_THREADS) * reps, dtype=torch.float32,
                         device=d2.device)
        out = (ws if d2.dtype == torch.float32 else ws.view(d2.dtype)).as_strided(
            (p, 1, 1), (1, 1, 1))
        thr = threshold_array(tuple(thresholds))
        _run("select_reps", d2.get_device(), lambda s: _lib().select_reps_launch(
            x.data_ptr(), t.data_ptr(), ws.data_ptr() + 4 * p, out.data_ptr(), p, r * l, reps,
            SELECT_MODES[mode], int(d2.dtype == torch.bfloat16), len(thresholds), thr,
            CUTOFF2, s))
        select_reps.launches += 1
        return out

    return _dispatch("select_reps", d2,
                     lambda: select_reps_plain(d2, tab, thresholds, mode, reps), launch)


@counts_launches
def receptor_loop(lig, rec, tab, thresholds, mode: str):
    """P2, P3: for each pose p and ligand atom l of lig (P, 3, L), the sum
    over receptor atoms r of rec (R, 3), in order, of

    * ``slot``: ``float(slot(d2))``;
    * ``gather``: ``tab[r, slot(d2), l]``;
    * ``chain``: ``(tab[r, 0, l] + sum_k tab[r, k + 1, l] [d2 >= s_k])
      [d2 <= 225]``,

    with d2 = ((dx dx + dy dy) + dz dz) by direct difference and tab
    (R, 32, L); float32 (P, L).

    A CPU tensor takes :func:`receptor_loop_plain`; a CUDA tensor launches
    ``csrc/probes.cu`` and adds one to ``receptor_loop.launches``."""

    def launch():
        _check_loop(lig, rec, tab, thresholds, mode)
        p, _, l = lig.shape
        a, b, t = lig.contiguous(), rec.contiguous(), tab.contiguous()
        out = torch.empty((p, l), dtype=torch.float32, device=lig.device)
        thr = threshold_array(tuple(thresholds))
        _run("receptor_loop", lig.get_device(), lambda s: _lib().receptor_loop_launch(
            a.data_ptr(), b.data_ptr(), t.data_ptr(), out.data_ptr(), p, l,
            rec.shape[0], LOOP_MODES[mode], len(thresholds), thr, CUTOFF2, s))
        receptor_loop.launches += 1
        return out

    return _dispatch("receptor_loop", lig,
                     lambda: receptor_loop_plain(lig, rec, tab, thresholds, mode), launch)


@counts_launches
def gather_form(form: str, x=None, tab=None, idx=None, rec=None, *, thresholds=(),
                reps: int = 1, row: int = 0):
    """P4-P6: one (P, L) float32 expression per ``form`` (the table of
    :data:`FORMS`) of the operands it names: x (P, L) float32, ``tab``
    (N, S, L) or (S, L) (one table), ``idx`` (P, L) int32 (clipped into
    [0, S)) and ``rec`` (R, C); ``row`` is the table the single-shot forms read,
    ``reps`` the count of the loops, which add in order from zero.

    A CPU tensor takes :func:`gather_form_plain`; a CUDA tensor launches
    ``csrc/probes.cu`` and adds one to ``gather_form.launches``.  The
    launch does the checks, allocates the output and calls the kernel, with
    nothing else on the host: a single-shot form's device work is about a
    microsecond."""
    ref = idx if form == "bare" else x
    if ref is None:
        raise ValueError(f"{form} needs {'idx' if form == 'bare' else 'x'} (P, L)")
    return _dispatch("gather_form", ref,
                     lambda: gather_form_plain(form, x, tab, idx, rec, thresholds=thresholds,
                                               reps=reps, row=row),
                     functools.partial(_gather_form_launch, form, x, tab, idx, rec,
                                       thresholds, reps, row))


def _gather_form_launch(form, x, tab, idx, rec, thresholds, reps, row):
    """The launch of :func:`gather_form` on the card: the checks, the
    output's allocation and one call (:func:`_run`)."""
    ref = _check_form(form, x, tab, idx, rec, thresholds, reps, row)
    # The operands as the kernel reads them, kept alive through the call.
    x = None if x is None else x.contiguous()
    tab = None if tab is None else tab.contiguous()
    idx = None if idx is None else idx.contiguous()
    rec = None if rec is None else rec.contiguous()
    if form == "bare":
        out = torch.empty_like(idx, dtype=torch.float32)
    else:
        out = torch.empty_like(x)   # (P, L) float32, contiguous like x
    p, l = ref.shape
    args = (None if x is None else x.data_ptr(), None if tab is None else tab.data_ptr(),
            None if idx is None else idx.data_ptr(), None if rec is None else rec.data_ptr(),
            out.data_ptr(), p, l, FORMS[form][0], 0 if tab is None else tab.shape[-2],
            0 if rec is None else rec.shape[1], reps, row, len(thresholds),
            threshold_array(tuple(thresholds)) if thresholds else None)
    fn = _lib().gather_form_launch
    _run("gather_form", ref.get_device(), lambda s: fn(*args, s))
    gather_form.launches += 1
    return out
