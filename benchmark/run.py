#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lightdock_tpu_torch``:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's complex (for DFIRE with its table, to which it
points ``LIGHTDOCK_DATA``; with its ANM modes where the configuration has
them) and every job's positions from the seed (``ldbench.inputs``), and
runs one whole warm-up job.  The window is a closed loop of one
client: jobs, each one call of the program's command line
(``lightdock_tpu_torch.cli.main``, the command ``lightdock-tpu-torch
setup.json <positions> 100 <method>`` in-process, with ``--anm-dir``
naming the complex's directory where it has modes), start back to back until
``--seconds`` have passed; the last runs to its end.  After the window the
outputs of the timed jobs are checked against the plain reference
(``ldbench.check``);
the last line of standard output is the result, its last key the numbers
compared with their limits, which are also the last lines of standard
error.  With ``--trace 1`` the per-layer metrics of ``metrics/`` are read
from host spans around the program's layer boundaries and from
``torch.profiler``'s device trace of the whole window.
"""

import os
import time

T_START = time.perf_counter_ns()
# One intra-op thread: the program's host work is one thread's, and idle
# pool threads only contend with it.
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from ldbench import check, manifest  # noqa: E402
from ldbench.inputs import Complex  # noqa: E402
from ldbench.methods import method  # noqa: E402
from ldbench.record import RunRecord  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lightdock_tpu")
BREAKDOWN_ENTRIES = 10


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Off the driver's path: the CPU tests' platform and sizes, and the
    # readings behind the limits.
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--override", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--readings", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Jobs:
    """The program's command line, one job at a time, in this process."""

    def __init__(self, cell, run_dir, platform, trace, log):
        self.cell, self.platform, self.trace, self.log = cell, platform, trace, log
        self.run_dir = pathlib.Path(run_dir)
        self.setup = self.run_dir / "complex" / "setup.json"
        self.swarms = cell["traffic"]["swarms"]
        self.steps, self.g = cell["config"]["steps"], cell["config"]["glowworms"]

    def dir(self, job) -> pathlib.Path:
        return self.run_dir / "jobs" / str(job)

    def argv(self, job) -> list:
        init = self.dir(job) / "init"
        positions = (str(init / "initial_positions_*.dat") if self.cell["traffic"]["glob"]
                     else str(init / "initial_positions_0.dat"))
        config = self.cell["config"]
        argv = [str(self.setup), positions, str(self.steps), config["method"]]
        if config.get("anm_rec", 0) + config.get("anm_lig", 0):
            argv += ["--anm-dir", str(self.setup.parent)]
        if self.platform == "cpu":
            argv += ["--platform", "cpu"]
        if self.trace:
            argv += ["--metrics", str(self.dir(job) / "metrics.jsonl")]
        return argv

    def run(self, job) -> dict:
        from lightdock_tpu_torch import cli

        here = os.getcwd()
        record = {"job": job, "dir": self.dir(job), "ok": False,
                  "poses": self.swarms * self.g * self.steps, "steps": self.steps}
        argv = self.argv(job)
        os.chdir(self.dir(job))
        try:
            with contextlib.redirect_stdout(self.log), contextlib.redirect_stderr(self.log):
                record["t0"] = time.perf_counter_ns()
                try:
                    record["ok"] = cli.main(argv) == 0
                except (Exception, SystemExit):
                    record["error"] = traceback.format_exc(limit=4)
                record["t1"] = time.perf_counter_ns()
        finally:
            os.chdir(here)
        if record.get("error"):
            print(f"job {job} failed:\n{record['error']}", file=sys.stderr)
        if self.trace:
            record["segments"] = segments(self.dir(job) / "metrics.jsonl")
        return record


def segments(path) -> list:
    if not path.is_file():
        return []
    out = []
    for line in path.read_text().splitlines():
        event = json.loads(line)
        if event.get("event") == "segment":
            out.append(float(event["seconds"]))
    return out


def per_layer(cell, record, spans):
    values = {}
    for name in cell["per_layer"]:
        m = manifest.metric(name)
        need = {f"{mod}:{attr}" for mod, attr, _ in getattr(m, "WRAPS", [])}
        gone = need & (spans.missing if spans else set())
        values[name] = None if gone else m.read(record)
        if values[name] is None:
            why = f"callables not found: {sorted(gone)}" if gone else "nothing to read"
            print(f"metric {name}: {why}", file=sys.stderr)
    return values


def breakdown(trace, spans):
    """The device operations that took most time, and the idle time by what
    the host was doing (the innermost of the benchmark's spans)."""
    import numpy as np

    from ldbench.devtrace import idle_gaps

    ops = {}
    for name, a, b in trace.events:
        key = name[:160]
        ops[key] = ops.get(key, 0) + (b - a)
    # Spans of one label do not overlap; a gap goes to the innermost
    # (shortest) span around its middle, else to the harness.
    gaps = idle_gaps(trace)
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    label = np.full(len(gaps), -1)
    width = np.full(len(gaps), np.iinfo(np.int64).max)
    names = []
    for name, s, e in sorted(spans.records, key=lambda r: r[1]):
        if name not in names:
            names.append(name)
    for k, name in enumerate(names):
        ab = np.array(sorted((s, e) for n, s, e in spans.records if n == name), np.int64)
        i = np.searchsorted(ab[:, 0], mid, side="right") - 1
        j = np.maximum(i, 0)
        w = ab[j, 1] - ab[j, 0]
        take = (i >= 0) & (mid < ab[j, 1]) & (w < width)
        label[take], width[take] = k, w[take]
    total = np.bincount(label + 1, weights=gaps[:, 1] - gaps[:, 0], minlength=len(names) + 1)
    idle = {(names[k - 1] if k else "harness"): int(v) for k, v in enumerate(total) if v > 0}

    def top(d):
        return [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][
            :BREAKDOWN_ENTRIES]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def window(args, cell, jobs, device, platform, prepare):
    """Set-up's warm-up job, then the timed jobs; returns (the record, the
    peak bytes, (busy s, window s) of a traced run).  ``prepare(job)``
    writes a job's positions where set-up made too few."""
    import torch

    from ldbench.devtrace import Profiler, busy_ns
    from ldbench.spans import Spans

    warm = jobs.run("warm")
    if not warm["ok"]:
        raise RuntimeError(f"the warm-up job failed:\n{warm.get('error')}")
    shutil.rmtree(jobs.dir("warm"), ignore_errors=True)
    cuda = platform == "cuda"
    spans = profiler = None
    if args.trace:
        wraps = [w for name in cell["per_layer"] for w in getattr(manifest.metric(name), "WRAPS", [])]
        wraps += [("lightdock_tpu_torch.simulation", "load_simulation", "input"),
                  ("lightdock_tpu_torch.parallel.farm", "make_energy", "energy_setup"),
                  ("lightdock_tpu_torch.engine.runner", "make_energy", "energy_setup")]
        spans = Spans(wraps)
        if cuda:
            profiler = Profiler(device)
    window_start = profiler.start() if profiler else time.perf_counter_ns()
    setup_s = (window_start - T_START) * 1e-9
    timed = []
    while not timed or (time.perf_counter_ns() - window_start) * 1e-9 < args.seconds:
        prepare(len(timed))
        rec = jobs.run(len(timed))
        timed.append(rec)
        if spans:
            spans.mark("job", rec["t0"], rec["t1"])
    trace = profiler.stop() if profiler else None
    if spans:
        spans.close()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record = RunRecord(timed, setup_s, spans, trace)
    busy = None
    if trace is not None:
        lo, hi = trace.window
        busy = (busy_ns(trace) * 1e-9, (hi - lo) * 1e-9)
    return record, peak, busy


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.cell(args.workload)
    cell = merge(cell, json.loads(args.override))
    platform = args.platform
    if platform == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    args.run_dir = tempfile.mkdtemp(prefix="ldbench-")
    # The program's log lines and its standard output go to a file.
    log = open(pathlib.Path(args.run_dir) / "program.log", "a")
    handler = logging.StreamHandler(log)
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    args.log = log
    try:
        if args.readings:
            return readings(args, cell, platform)
        return run(args, cell, platform)
    finally:
        logging.getLogger().removeHandler(handler)
        log.close()
        shutil.rmtree(args.run_dir, ignore_errors=True)


def make_inputs(cell, seed, run_dir, n_jobs):
    """The complex and each job's positions files; returns (complex, {job:
    initial poses}).  Raises first where the method has no reference."""
    method(cell["config"]["method"])
    cx = Complex(cell["config"], seed, pathlib.Path(run_dir) / "complex")
    os.environ["LIGHTDOCK_DATA"] = str(cx.data)
    swarms = cell["traffic"]["swarms"]
    initial = {}
    for job in ["warm", *range(n_jobs)]:
        key = 10 ** 9 if job == "warm" else job
        d = pathlib.Path(run_dir) / "jobs" / str(job)
        cx.write_job(key, swarms, d)
        initial[job] = cx.positions(key, swarms)
    return cx, initial


def run(args, cell, platform) -> int:
    import torch

    import lightdock_tpu_torch.cli  # noqa: F401  (the program: raises where it is absent)

    torch.set_num_threads(1)

    device = torch.device(platform, 0) if platform == "cuda" else torch.device("cpu")
    n_jobs = math.ceil(args.seconds / cell["min_job_s"]) + 2
    cx, initial = make_inputs(cell, args.seed, args.run_dir, n_jobs)
    jobs = Jobs(cell, args.run_dir, platform, args.trace, args.log)
    swarms = cell["traffic"]["swarms"]

    def prepare(job):
        if job not in initial:
            cx.write_job(job, swarms, jobs.dir(job))
            initial[job] = cx.positions(job, swarms)

    record, peak, busy = window(args, cell, jobs, device, platform, prepare)
    layer = per_layer(cell, record, record.spans) if args.trace else {}
    brk = breakdown(record.trace, record.spans) if record.trace else None
    record.spans = record.trace = None   # freed before the reference runs
    if platform == "cuda":
        torch.cuda.empty_cache()
    checker = check.Checker(cx, device, cell["check"])
    jobs_checked = [dict(j, initial=initial[j["job"]]) for j in record.jobs]
    correct, failed, found = check.verify(checker, jobs_checked, args.seed, cell["limits"])
    for j in record.jobs:
        shutil.rmtree(j["dir"], ignore_errors=True)
    print(f"jobs {len(record.jobs)} in {record.window_s():.3f} s; job seconds "
          + " ".join(f"{(j['t1'] - j['t0']) * 1e-9:.3f}" for j in record.jobs), file=sys.stderr)
    print("checked " + ", ".join(f"{k} {v}" for k, v in checker.checked.items()),
          file=sys.stderr)
    result = {"correct": correct, "attempted": len(record.jobs), "failed": failed}
    metrics = {}
    for name in (cell["per_layer"] if args.trace else cell["end_to_end"]):
        value = layer.get(name) if args.trace else manifest.metric(name).read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": manifest.metric(name).UNIT}
    result["metrics"] = metrics
    result["device"] = device_info(platform, cell["chips"], peak, busy)
    if brk:
        result["breakdown"] = brk
    result["checks"] = {k: {"value": found[k], "limit": cell["limits"][k]}
                        for k in check.NUMBERS}
    for k in check.NUMBERS:
        print(f"{k} {found[k]!r} limit {cell['limits'][k]!r}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX package loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


def device_info(platform, chips, peak, busy):
    import torch

    info = {"platform": "gpu" if platform == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if platform == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": peak}
    if busy:
        info["busy_s"], info["window_s"] = busy
    return info


def readings(args, cell, platform) -> int:
    """The readings the limits are set from: for each seed of
    ``--readings`` (a comma list), the program's jobs for ``--seconds`` and
    the control in its place on the same inputs, each judged by the
    checks; one JSON line a seed."""
    import torch

    from reference.control import run_swarm

    device = torch.device("cpu") if platform == "cpu" else torch.device("cuda", 0)
    limits = dict.fromkeys(check.NUMBERS, math.inf)
    for seed in [int(s) for s in args.readings.split(",")]:
        run_dir = pathlib.Path(args.run_dir) / str(seed)
        n_jobs = math.ceil(args.seconds / cell["min_job_s"]) + 2
        cx, initial = make_inputs(cell, seed, run_dir, n_jobs)
        jobs = Jobs(cell, run_dir, platform, 0, args.log)
        start, timed = time.perf_counter(), []
        while not timed or time.perf_counter() - start < args.seconds:
            if len(timed) not in initial:
                cx.write_job(len(timed), jobs.swarms, jobs.dir(len(timed)))
                initial[len(timed)] = cx.positions(len(timed), jobs.swarms)
            timed.append(dict(jobs.run(len(timed))))
        out = {"seed": seed, "jobs": len(timed)}
        checker = check.Checker(cx, device, cell["check"])
        _, out["failed"], out["program"] = check.verify(
            checker, [dict(j, initial=initial[j["job"]]) for j in timed], seed, limits)
        out["checked"] = checker.checked
        # The control in the program's place: the sampled swarms of the
        # first job, in bfloat16, judged alike.
        ctl = check.Checker(cx, device, cell["check"])
        scorer = check.make_scorer(cx, device, torch.bfloat16)
        k = cell["check"]["swarms"]
        cdir = run_dir / "control"
        for s in range(k):
            run_swarm(initial[0][s], ctl.seed, ctl.steps, scorer, cdir / f"swarm_{s}",
                      anm_rec=ctl.anm_rec)
        _, _, out["control"] = check.verify(
            ctl, [{"dir": cdir, "initial": initial[0][:k], "ok": True, "job": 0}], seed, limits)
        print(json.dumps(out), flush=True)
        for j in timed:
            shutil.rmtree(j["dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
