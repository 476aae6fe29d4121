"""Whether the timed jobs' outputs are right: the numbers compared and their
limits.

Every job of the window must have written every snapshot of every swarm
(``swarm_<s>/gso_<step>.out``, step 1 and every tenth); a job that raised
or left one out failed.  Then, on a sample drawn from the run's seed:

- ``score_gap``: the gap by which a written score lies outside the
  plain reference's bracket (the configuration's ``method``: ``dfire``
  scored by ``reference.dfire``, ``dna`` by ``reference.dna``; another
  method has no reference and is refused at set-up), over 1 + |score|, at
  its widest.  A snapshot's score is that of the pose before the step's
  move, so a lone snapshot is scored again where the glowworm did not move
  (no neighbours), and a followed one everywhere the follow vouches for.
- ``state_off_pct``: the reference follows a sampled swarm from the
  snapshot before a segment (from the job's own positions for the first)
  through the segment's steps (``reference.gso.follow``); at the
  segment's end, the share of the glowworms it vouches for whose written
  state differs from its own: a translation, rotation or ANM coefficient
  off by more than ``POSE_TOLERANCE``, a luciferin outside the band a
  program may hold by more than ``LUCIFERIN_TOLERANCE`` of 1 + |luciferin|,
  another neighbour count, or a vision range off by more than its 3
  decimals allow.  A glowworm the follow vouches for may still differ
  through the knock-on effect of one it did not (see
  ``reference.gso``), so this is a share, not a count.

The follow starts each segment after the first from the program's own
snapshot; the first starts from the benchmark's inputs.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from reference import gso as ref_gso
from reference import gsofile
from reference.pose import Side
from reference.rng import uniforms

from .inputs import CHECK, stream
from .methods import method

NUMBERS = ("score_gap", "state_off_pct")
POSE_TOLERANCE = 1e-4       # A and quaternion units; float32 moves drift ~1e-6
LUCIFERIN_TOLERANCE = 1e-6  # beyond the band, of 1 + |luciferin|
VISION_TOLERANCE = 6e-4     # half a unit of the text's 3 decimals, and float32


def snapshot_steps(steps: int) -> list:
    return [1] + list(range(10, steps + 1, 10))


def make_scorer(cx, device, dtype):
    """The reference's scorer of the complex ``cx`` (``ldbench.inputs``) by
    its configuration's method, read from its files: the PDB files, the
    restraints of ``setup.json``, the ANM modes it names, and the method's
    table."""
    setup = json.loads(cx.setup.read_text())
    sides = [Side(cx.root / f"lightdock_{name}.pdb", setup[f"{side}_restraints"]["active"],
                  cx.root / f"{name}_nm.npy" if setup["use_anm"] and setup[f"anm_{name}"]
                  else None)
             for side, name in (("receptor", "rec"), ("ligand", "lig"))]
    return method(cx.config["method"]).scorer(cx, *sides, device, dtype)


class Checker:
    """The reference for one run's complex, on ``device``."""

    def __init__(self, cx, device, params: dict):
        import torch

        self.params = params
        self.scorer = make_scorer(cx, device, torch.float64)
        self.seed = json.loads(cx.setup.read_text())["seed"]
        self.steps = cx.config["steps"]
        self.anm_rec = cx.config.get("anm_rec", 0)
        self.g = cx.config["glowworms"]
        self.draws = uniforms(self.seed, self.steps * self.g).reshape(self.steps, self.g)
        self.found = dict.fromkeys(NUMBERS, 0.0)
        self.checked = {"poses_scored": 0, "glowworms_followed": 0, "glowworms_off": 0,
                        "segments": 0}

    def missing(self, job_dir, swarms: int) -> list:
        """The snapshots of ``job_dir`` that are not there."""
        root = pathlib.Path(job_dir)
        return [f"swarm_{s}/gso_{k}.out" for s in range(swarms)
                for k in snapshot_steps(self.steps)
                if not (root / f"swarm_{s}" / f"gso_{k}.out").is_file()]

    def job(self, job_dir, initial: list, rng) -> None:
        """Check a sample of one job's outputs (``initial``: each swarm's
        starting poses) and fold its numbers into :attr:`found`."""
        root = pathlib.Path(job_dir)
        snaps = snapshot_steps(self.steps)
        p = self.params
        for s in rng.choice(len(initial), size=min(p["swarms"], len(initial)), replace=False):
            later = rng.choice(np.arange(1, len(snaps)), size=min(p["segments"] - 1, len(snaps) - 1),
                               replace=False)
            for i in [0, *sorted(later)]:
                self._segment(root / f"swarm_{s}", initial[s], snaps, i)
        for _ in range(p["score_snapshots"]):
            s = int(rng.integers(len(initial)))
            k = snaps[int(rng.integers(len(snaps)))]
            self._scores(gsofile.read(root / f"swarm_{s}" / f"gso_{k}.out"))

    def _scores(self, snap):
        poses, _, nn, _, score = snap
        still = nn == 0
        if not still.any():
            return
        mid, lo, hi = self.scorer.score(poses[still, :3], poses[still, 3:7],
                                        poses[still, 7:])
        self._score_gap(score[still], mid, lo, hi)

    def _score_gap(self, score, mid, lo, hi):
        gap = np.maximum(np.maximum(lo - score, score - hi), 0.0) / (1.0 + np.abs(mid))
        self._fold("score_gap", np.where(np.isfinite(score), gap, np.inf).max())
        self.checked["poses_scored"] += len(score)

    def _segment(self, swarm_dir, poses0, snaps, i):
        end = snaps[i]
        if i == 0:
            start, state = 0, ref_gso.initial(poses0)
        else:
            start = snaps[i - 1]
            poses, luc, nn, vis, score = gsofile.read(swarm_dir / f"gso_{start}.out")
            state = ref_gso.State(poses[:, :3], poses[:, 3:7], poses[:, 7:], luc, vis, score, nn)
        out, ok, luc_band, score_band = ref_gso.follow(state, self.draws[start:end],
                                                       self.scorer.score, self.anm_rec)
        poses, luc, nn, vis, score = gsofile.read(swarm_dir / f"gso_{end}.out")
        ref_poses = np.concatenate([out.t, out.q, out.anm], axis=1)
        if poses.shape != ref_poses.shape:
            off = np.ones(len(ok), dtype=bool)
        else:
            over = np.maximum(np.maximum(luc_band[:, 0] - luc, luc - luc_band[:, 1]), 0.0)
            off = ~(np.abs(poses - ref_poses).max(axis=1) <= POSE_TOLERANCE)
            off |= ~(over <= LUCIFERIN_TOLERANCE * (1.0 + np.abs(out.luciferin)))
            off |= (nn != out.neighbours) | ~(np.abs(vis - out.vision) <= VISION_TOLERANCE)
            # A score is that of the pose before the last move: where the
            # follow vouches for it and the state agrees, it is checked here
            # (a knock-on move changes the pose it was taken at).
            same = ok & ~off
            if same.any():
                self._score_gap(score[same], out.score[same], score_band[same, 0],
                                score_band[same, 1])
        self.checked["glowworms_followed"] += int(ok.sum())
        self.checked["glowworms_off"] += int((off & ok).sum())
        self.checked["segments"] += 1
        self.found["state_off_pct"] = (100.0 * self.checked["glowworms_off"]
                                       / max(self.checked["glowworms_followed"], 1))

    def _fold(self, name, value):
        self.found[name] = max(self.found[name], float(value))


def verify(checker: Checker, jobs: list, seed: int, limits: dict):
    """Check ``jobs`` (each a dict with ``dir``, ``initial``, ``ok``) with the
    sample of ``checker.params``; returns (correct, failed, lines) where
    ``lines`` holds each number with its limit."""
    rng = stream(seed, CHECK)
    failed = 0
    good = []
    for job in jobs:
        gone = checker.missing(job["dir"], len(job["initial"])) if job["ok"] else ["(raised)"]
        if gone:
            failed += 1
            job["error"] = job.get("error") or f"missing {gone[:3]}"
        else:
            good.append(job)
    sample = rng.choice(len(good), size=min(checker.params["jobs"], len(good)), replace=False) \
        if good else []
    for j in sorted(sample):
        checker.job(good[j]["dir"], good[j]["initial"], rng)
    found = checker.found
    correct = (failed == 0 and checker.checked["glowworms_followed"] > 0
               and all(found[k] <= limits[k] for k in NUMBERS))
    return correct, failed, found
