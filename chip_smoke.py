#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightdock_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``lightdock_tpu_torch/csrc`` with nvcc (one
process per source, all at once), then drives two paths:

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions and the kernel build times;
2. holds the DFIRE kernel (K1) against its plain PyTorch version on the
   card, at the DFIRE path's shapes (200 poses) and at 37 poses (pose
   padding), with and without the moved gate, and for poses clustered so
   that some chunk-tiles are far (the kernel's far branch) with and
   without interface flags: raw sums to rtol/atol 5e-5, interface flags
   exactly;
3. runs the DFIRE path, ``GsoTorchRunner`` for 100 GSO steps on the
   1ppe-shaped DFIRE system (1615 x 221 atoms, 200 glowworms, rigid, f32)
   through ``run_segmented(100, 10)``, writing gso_1.out, gso_10.out, ...
   to a temporary directory; checks finite scores, one K1 launch per step,
   the snapshots, and the step-1 scores against the dense oracle (5e-5);
4. times K1 and its plain version at the path's shapes (CUDA events) and
   the 100-step run (min of 5, reset before each);
5. times steps 1-20 one at a time, and profiles steps 11-30 with
   torch.profiler: wall time, device busy time and share, device ops and
   kernel launch calls per step, and the kernel's device time;
6. holds the elec/vdw kernel (K3) against its plain version at the
   1azp-shaped DNA inputs (1094 x 506 atoms), 200 and 37 poses, with a
   rigid receptor and with a per-pose receptor (receptor ANM), with and
   without the moved gate, and on clustered poses with far chunk-tiles
   with and without interface flags; reports the f32 errors of both
   versions against the plain version in f64 at 200 poses; checks that a
   coincident atom pair gives NaN in both versions;
7. runs the DNA + ANM path: ``GsoTorchRunner`` for 100 steps on the
   1azp-shaped DNA system with 10 + 10 ANM modes and 200 glowworms (f32,
   restraint bias on) through ``run_segmented(100, 10)``: finite scores,
   one K3 launch per step, the snapshots with their ANM columns, and the
   step-1 scores against the pose-chunked dense oracle (5e-5);
8. phases 4 and 5 for the DNA + ANM path and K3.

Fails with a non-zero exit and no result line when there is no CUDA
device, when it is not run from a checkout, or when any check fails.  The
last line of its output is the JSON device record; the line before it
lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_POSES, STEPS, SEGMENT, SEED = 200, 100, 10, 324324
DFIRE_ATOMS = (1615, 221)          # 1ppe-shaped stand-in
DNA_ATOMS, DNA_ANM = (1094, 506), 10   # 1azp-shaped stand-in, 10 + 10 modes
ORACLE_CHUNK = 16                  # poses per dense-oracle chunk
RTOL = ATOL = 5e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelPath:
    """One configuration the smoke run drives: its system, its kernel (with
    the plain version and the launch counter), and the energy path built
    for it on the card."""

    def __init__(self, label, kernel, plain, kernel_names, n_rec, n_lig,
                 num_anm=0, method="dfire"):
        import torch

        from __graft_entry__ import _toy_system
        from lightdock_tpu_torch.engine.energy_kernel import (
            kernel_params, make_kernel_energy_fn)
        from lightdock_tpu_torch.engine.params import torch_params

        self.label, self.kernel, self.plain = label, kernel, plain
        self.kernel_names = kernel_names
        self.num_anm = num_anm
        self.params, self.pos, _ = _toy_system(n_rec, n_lig, N_POSES,
                                               num_anm=num_anm, method=method)
        kparams = kernel_params(self.params)
        self.tp = torch_params(kparams, "cuda", torch.float32)
        self.energy_fn = make_kernel_energy_fn(kparams, "cuda", torch.float32)

    def pose(self, n, t=None):
        """(t, q, a_rec, a_lig) of the first ``n`` poses on the card."""
        import torch
        k = self.num_anm
        cols = [self.pos[:n, :3] if t is None else t, self.pos[:n, 3:7],
                self.pos[:n, 7:7 + k], self.pos[:n, 7 + k:7 + 2 * k]]
        return [torch.as_tensor(x, dtype=torch.float32, device="cuda") for x in cols]

    def runner(self, out_dir=None):
        import torch

        from lightdock_tpu_torch.engine.runner import GsoTorchRunner
        k = self.num_anm
        return GsoTorchRunner(self.params, self.pos, SEED, use_anm=k > 0,
                              anm_rec=k, anm_lig=k, output_directory=out_dir,
                              dtype=torch.float32, device="cuda")


def compare(path, args, kwargs, phase, label):
    """Kernel against plain on the same inputs; returns the max |raw diff|."""
    import torch
    before = path.kernel.launches
    out = path.kernel(*args, **kwargs)
    torch.cuda.synchronize()
    check(path.kernel.launches == before + 1, f"{path.label}: kernel did not launch")
    ref = path.plain(*args, **kwargs)
    n = args[1].shape[0]
    check(out[0].shape == (n,) and bool(torch.isfinite(out[0]).all()),
          f"{path.label}: kernel raw sums not finite / shaped ({label})")
    err = float((out[0] - ref[0]).abs().max())
    close = bool(torch.allclose(out[0], ref[0], rtol=RTOL, atol=ATOL))
    if kwargs["need_iface"]:
        flags = torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        note = (f"interface flags equal {flags}, flags set "
                f"{int(out[1].sum())}+{int(out[2].sum())}")
    else:
        flags = out[1] is None and out[2] is None
        note = f"no flags returned {flags}"
    act, near = args[-2], kwargs["near_chunks"]
    say(f"phase {phase}: {path.label} {label}: max|raw diff| {err:.3e} "
        f"(allclose {close}), {note}, active chunk-tiles "
        f"{int(act.sum())}/{act.numel()}, near {int((near * act).sum())}")
    check(close, f"{path.label}: kernel raw sums disagree with plain ({label})")
    check(flags, f"{path.label}: interface flags disagree with plain ({label})")
    return err


def kernel_cases(path, phase, gen, rng):
    """The kernel against plain at the path's shapes (G=200 and 37, with
    and without the moved gate) and on clustered poses with far
    chunk-tiles (with and without interface flags).  Returns the max
    error and the ungated G=200 call."""
    import numpy as np
    import torch

    max_err, main = 0.0, None
    for n in (N_POSES, 37):
        for gated in (False, True):
            moved = (torch.rand(n, generator=gen, device="cuda") < 0.6) if gated else None
            args, kwargs = path.energy_fn.kernel_args(path.tp, *path.pose(n), moved)
            err = compare(path, args, kwargs, phase, f"G={n} moved_gate={gated}")
            max_err = max(max_err, err)
            if n == N_POSES and not gated:
                main = (args, kwargs)
    # Poses clustered by chunk, up to 45 A from the receptor: some
    # chunk-tiles are culled and some far, so the kernel's far branch runs.
    # Near bits come from the energy path's own box cull.
    blk = 16
    n_chunks = -(-N_POSES // blk)
    t_far = (np.repeat(rng.uniform(-45, 45, (n_chunks, 3)), blk, axis=0)[:N_POSES]
             + rng.uniform(-3, 3, (N_POSES, 3)))
    args, kwargs = path.energy_fn.kernel_args(path.tp, *path.pose(N_POSES, t_far))
    near, act = kwargs["near_chunks"], args[-2]
    n_near, n_act = int((near * act).sum()), int(act.sum())
    check(0 < n_near < n_act, f"{path.label}: clustered poses left {n_near} of "
          f"{n_act} active chunk-tiles near; the far branch is not exercised")
    for need_iface in (True, False):
        err = compare(path, args, dict(kwargs, need_iface=need_iface), phase,
                         f"G={N_POSES} clustered need_iface={need_iface}")
        max_err = max(max_err, err)
    again = path.kernel(*main[0], **main[1])
    first = path.kernel(*main[0], **main[1])
    check(torch.equal(again[0], first[0]), f"{path.label}: sums differ between runs")
    return max_err, main


def drive(path, counters, phase):
    """The path's main run: 100 steps through ``run_segmented`` with every
    kernel count set to 0 just before and read just after.  Returns the
    path kernel's launches and the step-1 scores from the gso_1 sidecar."""
    import numpy as np
    import torch

    expected = {f"gso_{s}.out" for s in [1] + list(range(10, STEPS + 1, 10))}
    with tempfile.TemporaryDirectory() as out_dir:
        runner = path.runner(out_dir)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(STEPS, SEGMENT)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        snaps = {p.name for p in pathlib.Path(out_dir).glob("gso_*.out")}
        with np.load(pathlib.Path(out_dir) / "gso_1.out.npz") as sidecar:
            step1 = sidecar["scoring"]
        line = (pathlib.Path(out_dir) / f"gso_{STEPS}.out").read_text().splitlines()[1]
        cols = len(line[line.index("(") + 1:line.index(")")].split(","))
    ours = launches[path.kernel.__name__]
    say(f"phase {phase}: {path.label}: {STEPS} steps in {run_s:.3f} s (first run, "
        f"with snapshots); kernel launches {launches}; snapshots {len(snaps)} "
        f"with {cols} pose columns; final scores min {float(final.scoring.min()):.6f} "
        f"max {float(final.scoring.max()):.6f}")
    check(ours == STEPS, f"{path.label}: {ours} kernel launches in {STEPS} steps")
    check(sum(launches.values()) == ours, f"{path.label}: other kernels launched")
    check(snaps == expected, f"{path.label}: snapshots {sorted(snaps)}")
    # t, q, then the receptor's and the ligand's ANM coefficients
    check(cols == 7 + 2 * path.num_anm, f"{path.label}: {cols} pose columns")
    for name, x in final._asdict().items():
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"{path.label}: non-finite {name}")
    check(tuple(final.scoring.shape) == (N_POSES,), "scores have the wrong shape")
    if path.num_anm:
        moved = final.a_rec - path.pose(N_POSES)[2]
        check(bool(moved.abs().max() > 0), f"{path.label}: ANM modes never moved")
    return ours, step1


def oracle(path, step1, phase):
    """Step-1 scores against the pose-chunked dense oracle in the kernel
    path's frame (the same f32 coordinates, so the same d2)."""
    import torch

    from lightdock_tpu_torch.engine import energy_dense as ed
    from lightdock_tpu_torch.engine.energy_kernel import frame_center
    from lightdock_tpu_torch.engine.params import torch_params
    from lightdock_tpu_torch.ops.tiling import spatial_sort_params

    oracle_p = spatial_sort_params(path.params)
    otp = torch_params(oracle_p, "cuda", torch.float32)
    center = torch.as_tensor(frame_center(oracle_p), dtype=torch.float32, device="cuda")
    otp = dataclasses.replace(otp, rec_coords=otp.rec_coords - center[None, :])
    t, q, a_rec, a_lig = path.pose(N_POSES)
    ref = ed.batch_energy_chunked(otp, t - center[None, :], q, a_rec, a_lig,
                                  chunk=ORACLE_CHUNK)
    got = torch.as_tensor(step1, device="cuda")
    err = float((got - ref).abs().max())
    close = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
    say(f"phase {phase}: {path.label}: step-1 scores vs dense oracle: max|diff| "
        f"{err:.3e} (allclose {close}), score range [{float(ref.min()):.4f}, "
        f"{float(ref.max()):.4f}]")
    check(close, f"{path.label}: step-1 scores disagree with the dense oracle")


def profile_steps(runner, card, kernel_names, first=10, last=30) -> str:
    """Profile steps first+1..last of ``runner`` after a reset and return a
    one-line summary.  Device time is the sum of the device-side events
    (kernels, copies, fills) the profiler records; on one stream they do not
    overlap, so it is the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.reset()
    runner.run(first)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(last)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = last - first
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        return (f"[{card}] steps {first + 1}-{last}: wall {wall_us / 1e3:.3f} ms; "
                "device time not measured (the profiler saw no device events)")
    busy = sum(e.time_range.elapsed_us() for e in dev_events)
    ours = [e for e in dev_events if any(k in e.name for k in kernel_names)]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    launch = [e for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                             "cudaLaunchKernelExC", "cuLaunchKernelEx")]
    launch_us = sum(e.time_range.elapsed_us() for e in launch)
    return (f"[{card}] profile of steps {first + 1}-{last}: wall "
            f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
            f"({busy / wall_us:.4f} of wall), {len(dev_events)} device ops "
            f"({len(dev_events) / steps:.1f} a step), {len(launch)} launch "
            f"calls taking {launch_us / 1e3:.3f} ms of host time; pair "
            f"kernel (both launches) {ours_us / 1e3:.3f} ms over {len(ours)} "
            f"device ops ({ours_us / busy:.4f} of device busy)")


def timing(path, main, card, phases):
    """Kernel vs plain ms a call, the path's poses/s (min of 5, reset
    before each), steps 1-20 one at a time, and the profile of steps
    11-30.  Returns (kernel_ms, plain_ms)."""
    import torch

    args, kwargs = main
    kernel_ms = cuda_ms(lambda: path.kernel(*args, **kwargs), 200)
    plain_ms = cuda_ms(lambda: path.plain(*args, **kwargs), 10)
    say(f"phase {phases[0]}: [{card}] {path.label} kernel at G={N_POSES}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    timer = path.runner()
    times = []
    for _ in range(5):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.run(STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    say(f"phase {phases[0]}: [{card}] {path.label}: {STEPS} GSO steps x "
        f"{N_POSES} poses: min of 5 {best:.4f} s = {N_POSES * STEPS / best:.1f} "
        f"poses/s (all: {', '.join(f'{x:.4f}' for x in times)})")
    check(all(math.isfinite(x) for x in times), "timing failed")
    timer.reset()
    step_ms = []
    for step in range(1, 21):
        t0 = time.perf_counter()
        timer.run(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    say(f"phase {phases[1]}: [{card}] {path.label}: steps 1-20 one at a time: "
        f"min {min(step_ms):.3f} ms, median {sorted(step_ms)[10]:.3f} ms, max "
        f"{max(step_ms):.3f} ms per step")
    say(f"phase {phases[1]}: {path.label}: "
        + profile_steps(timer, card, path.kernel_names))
    return kernel_ms, plain_ms


def f64_errors(path, main, phase):
    """Both f32 versions against the plain version in f64 on the same
    inputs: how far each is from the exact sums."""
    import torch
    args, kwargs = main
    wide = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]
    exact = path.plain(*wide, **kwargs)[0]
    k_err = float((path.kernel(*args, **kwargs)[0].double() - exact).abs().max())
    p_err = float((path.plain(*args, **kwargs)[0].double() - exact).abs().max())
    say(f"phase {phase}: {path.label} at G={N_POSES} against plain f64: kernel "
        f"max|err| {k_err:.3e}, plain f32 max|err| {p_err:.3e}, |raw| up to "
        f"{float(exact.abs().max()):.3e}")


def coincident_pair(phase):
    """A coincident atom pair: NaN in the kernel and in its plain version."""
    import torch

    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev

    def vec(v):
        return torch.full((1,), v, dtype=torch.float32, device="cuda")

    ones = torch.ones((1, 1, 1), dtype=torch.int32, device="cuda")
    args = (torch.zeros((1, 1, 3), device="cuda"), torch.zeros((1, 3, 1), device="cuda"),
            vec(0.5), vec(0.5), vec(0.2), vec(0.2), vec(1.5), vec(1.5), ones, ones)
    before = ev.elec_vdw_pairs.launches
    out = ev.elec_vdw_pairs(*args, r_tile=32, l_tile=128)[0]
    ref = ev.elec_vdw_pairs_plain(*args, r_tile=32, l_tile=128)[0]
    torch.cuda.synchronize()
    check(ev.elec_vdw_pairs.launches == before + 1, "K3 did not launch")
    say(f"phase {phase}: K3 coincident pair: kernel {float(out[0])}, plain "
        f"{float(ref[0])}")
    check(bool(torch.isnan(out).all() and torch.isnan(ref).all()),
          "a coincident pair must give NaN in the kernel and in plain")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"{exc.name} is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs an NVIDIA GPU")
    if not (ROOT / "lightdock_tpu_torch" / "csrc").is_dir():
        fail(f"no lightdock_tpu_torch package beside {__file__}; run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    from lightdock_tpu_torch.ops import _build
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # -- 1. the card and the build ------------------------------------------
    say(card)
    say(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.load_all(["dfire_pairs", "elec_vdw_pairs"])
    build_s = time.perf_counter() - t0
    for name, lib in built.items():
        ptxas = [ln.strip() for ln in lib.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        say(f"phase 1: built {lib.path.name} (nvcc {lib.build_seconds:.2f} s); "
            f"ptxas: {' | '.join(ptxas) or 'reused'}")
    say(f"phase 1: both kernels built in {build_s:.2f} s")

    counters = (dp.dfire_pairs, ev.elec_vdw_pairs)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.RandomState(SEED)

    # -- 2-5. the DFIRE path and K1 -----------------------------------------
    dfire = KernelPath("K1 DFIRE", dp.dfire_pairs, dp.dfire_pairs_plain,
                 ("dfire_pairs_kernel", "sum_tiles_kernel"), *DFIRE_ATOMS)
    k1_err, k1_main = kernel_cases(dfire, 2, gen, rng)
    k1_launches, step1 = drive(dfire, counters, 3)
    oracle(dfire, step1, 3)
    k1_ms, k1_plain_ms = timing(dfire, k1_main, card, (4, 5))

    # -- 6-8. the DNA + ANM path and K3 --------------------------------------
    rigid = KernelPath("K3 rigid DNA", ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain,
                 ("elec_vdw_pairs_kernel", "sum_tiles_kernel"), *DNA_ATOMS,
                 method="dna")
    k3_err, _ = kernel_cases(rigid, 6, gen, rng)
    dna = KernelPath("K3 DNA + ANM", ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain,
               ("elec_vdw_pairs_kernel", "sum_tiles_kernel"), *DNA_ATOMS,
               num_anm=DNA_ANM, method="dna")
    err, k3_main = kernel_cases(dna, 6, gen, rng)
    k3_err = max(k3_err, err)
    f64_errors(dna, k3_main, 6)
    coincident_pair(6)
    k3_launches, step1 = drive(dna, counters, 7)
    oracle(dna, step1, 7)
    k3_ms, k3_plain_ms = timing(dna, k3_main, card, (8, 8))
    check("jax" not in sys.modules, "the port imported jax")

    say(json.dumps({"kernels": [{
        "name": "dfire_pairs",
        "route": "cuda",
        "source": "lightdock_tpu_torch/csrc/dfire_pairs.cu",
        "replaces": "lightdock_tpu/ops/pallas_energy.py:1088",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }, {
        "name": "elec_vdw_pairs",
        "route": "cuda",
        "source": "lightdock_tpu_torch/csrc/elec_vdw_pairs.cu",
        "replaces": "lightdock_tpu/ops/pallas_energy.py:1325",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
