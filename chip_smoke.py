#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightdock_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from ``lightdock_tpu_torch/csrc`` with nvcc, then:

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions and the kernel build time;
2. holds the DFIRE kernel against its plain PyTorch version on the card, at
   the main path's shapes (200 poses) and at 37 poses (pose padding), with
   and without the moved gate, and for poses clustered so that some
   chunk-tiles are far (the kernel's far branch) with and without
   interface flags: raw sums to rtol/atol 5e-5, interface flags exactly;
3. runs the main path, ``GsoTorchRunner`` for 100 GSO steps on the
   1ppe-shaped DFIRE system (1615 x 221 atoms, 200 glowworms, rigid, f32)
   through ``run_segmented(100, 10)``, writing gso_1.out, gso_10.out, ...
   to a temporary directory; checks finite scores, one kernel launch per
   step, and the step-1 scores against the dense oracle (5e-5);
4. times the kernel and its plain version at the main path's shapes (CUDA
   events) and the 100-step run (min of 5, reset before each);
5. times steps 1-20 one at a time, and profiles steps 11-30 with
   torch.profiler: wall time, device busy time and share, device ops and
   kernel launch calls per step, and the DFIRE kernel's device time.

Fails with a non-zero exit and no result line when there is no CUDA
device, when it is not run from a checkout, or when any check fails.  The
last line of its output is the JSON device record.
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
N_REC, N_LIG, N_POSES = 1615, 221, 200   # 1ppe-shaped stand-in
STEPS, SEGMENT, SEED = 100, 10, 324324
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


def profile_steps(runner, card: str, first: int = 10, last: int = 30) -> str:
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
    k1 = [e for e in dev_events if "dfire_pairs_kernel" in e.name
          or "sum_tiles_kernel" in e.name]
    k1_us = sum(e.time_range.elapsed_us() for e in k1)
    launch = [e for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                             "cudaLaunchKernelExC", "cuLaunchKernelEx")]
    launch_us = sum(e.time_range.elapsed_us() for e in launch)
    return (f"[{card}] profile of steps {first + 1}-{last}: wall "
            f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
            f"({busy / wall_us:.4f} of wall), {len(dev_events)} device ops "
            f"({len(dev_events) / steps:.1f} a step), {len(launch)} launch "
            f"calls taking {launch_us / 1e3:.3f} ms of host time; DFIRE "
            f"kernel (both launches) {k1_us / 1e3:.3f} ms over {len(k1)} "
            f"device ops ({k1_us / busy:.4f} of device busy)")


def main() -> int:
    try:
        import numpy as np  # noqa: F401
        import torch
    except ImportError as exc:
        fail(f"{exc.name} is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs an NVIDIA GPU")
    if not (ROOT / "lightdock_tpu_torch" / "csrc").is_dir():
        fail(f"no lightdock_tpu_torch package beside {__file__}; run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    from __graft_entry__ import _toy_system
    from lightdock_tpu_torch.engine import energy_dense as ed
    from lightdock_tpu_torch.engine.energy_kernel import (
        frame_center, kernel_params, make_kernel_energy_fn)
    from lightdock_tpu_torch.engine.params import torch_params
    from lightdock_tpu_torch.engine.runner import GsoTorchRunner
    from lightdock_tpu_torch.ops import _build
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops.tiling import spatial_sort_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # -- 1. the card and the build ------------------------------------------
    say(card)
    say(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.load("dfire_pairs")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 1: built {built.path.name} in {build_s:.2f} s (nvcc "
        f"{built.build_seconds:.2f} s); ptxas: {' | '.join(ptxas) or 'reused'}")

    # -- the main path's system ---------------------------------------------
    params, pos, _ = _toy_system(N_REC, N_LIG, N_POSES)
    kparams = kernel_params(params)
    tp = torch_params(kparams, dev, torch.float32)
    energy_fn = make_kernel_energy_fn(kparams, dev, torch.float32)

    def pose(n):
        return (torch.as_tensor(pos[:n, :3], dtype=torch.float32, device=dev),
                torch.as_tensor(pos[:n, 3:7], dtype=torch.float32, device=dev))

    # -- 2. kernel against plain at the main path's shapes ------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    max_err = 0.0
    main_args = None
    for n in (N_POSES, 37):
        t, q = pose(n)
        for gated in (False, True):
            moved = (torch.rand(n, generator=gen, device=dev) < 0.6) if gated else None
            args, kwargs = energy_fn.kernel_args(tp, t, q, moved)
            before = dp.dfire_pairs.launches
            out = dp.dfire_pairs(*args, **kwargs)
            torch.cuda.synchronize()
            check(dp.dfire_pairs.launches == before + 1, "kernel did not launch")
            ref = dp.dfire_pairs_plain(*args, **kwargs)
            check(out[0].shape == (n,) and bool(torch.isfinite(out[0]).all()),
                  f"kernel raw sums not finite / shaped (G={n})")
            err = float((out[0] - ref[0]).abs().max())
            close = bool(torch.allclose(out[0], ref[0], rtol=RTOL, atol=ATOL))
            flags = (torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2]))
            n_near = int(kwargs["near_chunks"].sum())
            say(f"phase 2: G={n} moved_gate={gated}: max|raw diff| {err:.3e} "
                f"(allclose {close}), interface flags equal {flags}, active "
                f"chunk-tiles {int(args[3].sum())}/{args[3].numel()}, near "
                f"{n_near}, flags set {int(out[1].sum())}+{int(out[2].sum())}")
            check(close, f"kernel raw sums disagree with plain (G={n}, gate={gated})")
            check(flags, f"interface flags disagree with plain (G={n}, gate={gated})")
            max_err = max(max_err, err)
            if n == N_POSES and not gated:
                main_args = (args, kwargs)

    # Poses clustered by chunk, up to 45 A from the receptor: some
    # chunk-tiles are culled and some far, so the kernel's far branch (bin
    # search from the split, no interface work) runs.  Near bits come from
    # the energy path's own box cull.
    rng = np.random.RandomState(SEED)
    n_chunks = -(-N_POSES // dp.POSE_BLOCK)
    t_far = (np.repeat(rng.uniform(-45, 45, (n_chunks, 3)), dp.POSE_BLOCK, axis=0)
             [:N_POSES] + rng.uniform(-3, 3, (N_POSES, 3)))
    t_far = torch.as_tensor(t_far, dtype=torch.float32, device=dev)
    args, kwargs = energy_fn.kernel_args(tp, t_far, pose(N_POSES)[1])
    near = kwargs["near_chunks"]
    n_near, n_act = int((near * args[3]).sum()), int(args[3].sum())
    check(0 < n_near < n_act, f"clustered poses left {n_near} of {n_act} "
          "active chunk-tiles near; the far branch is not exercised")
    for need_iface in (True, False):
        kw = dict(kwargs, need_iface=need_iface)
        out = dp.dfire_pairs(*args, **kw)
        ref = dp.dfire_pairs_plain(*args, **kw)
        check(bool(torch.isfinite(out[0]).all()), "kernel raw sums not finite (far)")
        err = float((out[0] - ref[0]).abs().max())
        close = bool(torch.allclose(out[0], ref[0], rtol=RTOL, atol=ATOL))
        if need_iface:
            flags = torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
            note = f"interface flags equal {flags}"
        else:
            flags = out[1] is None and out[2] is None
            note = f"no flags returned {flags}"
        say(f"phase 2: G={N_POSES} clustered need_iface={need_iface}: max|raw "
            f"diff| {err:.3e} (allclose {close}), {note}, active chunk-tiles "
            f"{n_act}/{args[3].numel()}, near {n_near} of them")
        check(close, f"kernel raw sums disagree with plain (far, iface={need_iface})")
        check(flags, f"interface flags disagree with plain (far, iface={need_iface})")
        max_err = max(max_err, err)
    again = dp.dfire_pairs(*main_args[0], **main_args[1])
    first = dp.dfire_pairs(*main_args[0], **main_args[1])
    check(torch.equal(again[0], first[0]), "kernel sums differ between runs")

    # -- 3. the main path: 100 GSO steps through the runner ------------------
    with tempfile.TemporaryDirectory() as out_dir:
        runner = GsoTorchRunner(params, pos, SEED, use_anm=False, anm_rec=0,
                                anm_lig=0, output_directory=out_dir,
                                dtype=torch.float32, device="cuda")
        dp.dfire_pairs.launches = 0
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(STEPS, SEGMENT)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dp.dfire_pairs.launches
        snaps = sorted(p.name for p in pathlib.Path(out_dir).glob("gso_*.out"))
        with np.load(pathlib.Path(out_dir) / "gso_1.out.npz") as sidecar:
            step1_scores = sidecar["scoring"]
    expected = {f"gso_{s}.out" for s in [1] + list(range(10, STEPS + 1, 10))}
    say(f"phase 3: {STEPS} steps in {run_s:.3f} s (first run, with snapshots); "
        f"kernel launches {launches}; snapshots {len(snaps)}; final scores "
        f"min {float(final.scoring.min()):.6f} max {float(final.scoring.max()):.6f}")
    check(launches == STEPS, f"{launches} kernel launches in {STEPS} steps")
    check(set(snaps) == expected, f"snapshots {snaps}")
    for name, x in final._asdict().items():
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"non-finite {name} after {STEPS} steps")
    check(tuple(final.scoring.shape) == (N_POSES,), "scores have the wrong shape")

    # Dense oracle on the kernel path's frame (same f32 coordinates, so the
    # same d2 and bins); step tables instead of the kernel's cumulative ones.
    oracle_p = spatial_sort_params(params)
    otp = torch_params(oracle_p, dev, torch.float32)
    center = torch.as_tensor(frame_center(oracle_p), dtype=torch.float32, device=dev)
    otp = dataclasses.replace(otp, rec_coords=otp.rec_coords - center[None, :])
    t, q = pose(N_POSES)
    zeros = torch.zeros((N_POSES, 0), dtype=torch.float32, device=dev)
    oracle = ed.batch_energy(otp, t - center[None, :], q, zeros, zeros)
    got = torch.as_tensor(step1_scores, device=dev)
    o_err = float((got - oracle).abs().max())
    o_close = bool(torch.allclose(got, oracle, rtol=RTOL, atol=ATOL))
    say(f"phase 3: step-1 scores vs dense oracle: max|diff| {o_err:.3e} "
        f"(allclose {o_close}), score range [{float(oracle.min()):.4f}, "
        f"{float(oracle.max()):.4f}]")
    check(o_close, "step-1 scores disagree with the dense oracle")

    # -- 4. timing ----------------------------------------------------------
    args, kwargs = main_args
    kernel_ms = cuda_ms(lambda: dp.dfire_pairs(*args, **kwargs), 200)
    plain_ms = cuda_ms(lambda: dp.dfire_pairs_plain(*args, **kwargs), 10)
    say(f"phase 4: [{card}] K1 dfire_pairs at G={N_POSES}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    timer = GsoTorchRunner(params, pos, SEED, use_anm=False, anm_rec=0,
                           anm_lig=0, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(5):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.run(STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    say(f"phase 4: [{card}] {STEPS} GSO steps x {N_POSES} poses: min of 5 "
        f"{best:.4f} s = {N_POSES * STEPS / best:.1f} poses/s "
        f"(all: {', '.join(f'{x:.4f}' for x in times)})")
    check(all(math.isfinite(x) for x in times), "timing failed")

    # -- 5. per-step times and a profile of steps 11-30 ----------------------
    timer.reset()
    step_ms = []
    for step in range(1, 21):
        t0 = time.perf_counter()
        timer.run(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    say(f"phase 5: [{card}] steps 1-20 one at a time: min "
        f"{min(step_ms):.3f} ms, median {sorted(step_ms)[10]:.3f} ms, max "
        f"{max(step_ms):.3f} ms per step")
    say("phase 5: " + profile_steps(timer, card))
    check("jax" not in sys.modules, "the port imported jax")

    say(json.dumps({"kernels": [{
        "name": "dfire_pairs",
        "route": "cuda",
        "source": "lightdock_tpu_torch/csrc/dfire_pairs.cu",
        "replaces": "lightdock_tpu/ops/pallas_energy.py:1088",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
