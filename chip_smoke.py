#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightdock_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``lightdock_tpu_torch/csrc`` with nvcc and the
host IO library (``csrc/io_native.cpp``) with the host C++ compiler (one
process per source, all at once), then drives five paths and a farm, each
on a stand-in complex from ``lightdock_tpu_torch.standin`` made from a seed,
the command line on the files of such complexes, the sharded paths on
ranks of ``torch.distributed``, the workflow from raw PDB files to
ranked complexes, the benchmark entry point with its crossover map, and
the float64 host parity engine:

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, the kernel build times with ptxas' registers and spills (and
   the IO library's build time), and
   the registers and resident warps an SM of K1 and K2, and of K3, K4
   and K5 with their local (stack and spill) bytes a thread, rigid and
   per pose (K4 also with bfloat16 step tables), and of the box cull
   kernel with its shared bytes a block;
2. holds the DFIRE kernel (K1) against its plain PyTorch version on the
   card, at the DFIRE path's shapes (200 poses) and at 37 poses (pose
   padding), with and without the moved gate, and for poses clustered so
   that some chunk-tiles are far (the kernel's far branch) with and
   without interface flags: raw sums to rtol/atol 5e-5, interface flags
   exactly; then K1 and K2, rigid and per-pose receptor, on pairs at
   every bin edge and within 64 ulps either side
   (``standin.bin_edge_case``);
3. runs the DFIRE path, ``GsoTorchRunner`` for 100 GSO steps on the
   1ppe-shaped DFIRE system (1615 x 221 atoms, 200 glowworms, rigid, f32)
   through ``run_segmented(100, 10)``, writing gso_1.out, gso_10.out, ...
   to a temporary directory; checks finite scores, one K1 launch per step,
   the snapshots, and the step-1 scores against the dense oracle (5e-5);
4. times K1 and its plain version at the path's shapes (CUDA events) and
   the 100-step run (min of 5, reset before each), with K1's registers,
   resident warps an SM and its bound on operations;
5. times steps 1-20 one at a time, and profiles steps 11-30 with
   torch.profiler: wall time, device busy time and share, device ops and
   kernel launch calls per step, and the kernel's device time;
6. holds the elec/vdw kernel (K3) against its plain version at the
   1azp-shaped DNA inputs (1094 x 506 atoms), 200 and 37 poses, with a
   rigid receptor and with a per-pose receptor (receptor ANM), with and
   without the moved gate, and on clustered poses with far chunk-tiles
   with and without interface flags; reports the f32 errors of both
   versions against the plain version in f64 at 200 poses; checks that a
   coincident atom pair gives NaN in both versions; then K3, rigid and
   per-pose receptor, on pairs at the interface, vdw and elec cutoffs and
   within 64 ulps either side (``standin.cutoff_edge_case``): sums to
   5e-5, flags exactly;
7. runs the DNA + ANM path: ``GsoTorchRunner`` for 100 steps on the
   1azp-shaped DNA system with 10 + 10 ANM modes and 200 glowworms (f32,
   restraint bias on) through ``run_segmented(100, 10)``: finite scores,
   one K3 launch per step, the snapshots with their ANM columns, and the
   step-1 scores against the pose-chunked dense oracle (5e-5);
8. phases 4 and 5 for the DNA + ANM path and K3; then K3, rigid and per
   pose, at G = 200 and on a 6,400-pose batch of the 1azp-shaped stand-in
   (a farm's batch, 32 x 200; one kernel call): against plain at 6,400
   poses (rtol and atol 5e-5, flags exactly, two launches bit-equal), and at each size the wrapper's ms a
   call (CUDA events), the device time of the body and of the second pass
   (torch.profiler), the bound, registers and resident warps;
9. holds K1 with a per-pose receptor against its plain version on the
   1ppe-shaped DFIRE system with 10 + 10 ANM modes (the cases of phase 2),
   then runs 30 GSO steps of that DFIRE + ANM path: finite scores, one K1
   launch a step, 27 pose columns, step-1 scores against the dense oracle;
10. holds the work-list DFIRE kernel (K2) against its plain version at the
    1k4c shapes (3413 x 3268 atoms; the cases of phase 2), against K1 on
    the same inputs, with every pose unmoved (an empty list: zero sums, no
    flags, and the energy path returns the stored scores exactly), and
    with a per-pose receptor at the 1ppe shape;
11. runs the 1k4c-shaped DFIRE membrane path: ``GsoTorchRunner`` for 100
    steps (200 glowworms next to the receptor's membrane face, rigid, f32)
    through ``run_segmented(100, 10)``: the active share of tile pairs at
    step 1 (0 < n_active < n_r n_l), one K2 launch and no K1 launch a
    step, the snapshots, finite scores, and the step-1 scores against the
    pose-chunked gather-form dense oracle (5e-5);
12. times K2 at G = 200 (CUDA events), its compaction, pair and second
    passes alone (torch.profiler), K1 on the same inputs, K1 with the
    per-pose receptor of phase 9, the plain version, and phases 4 and 5
    for the 1k4c path, with K2's registers, resident warps and bound on
    operations;
13. holds the step-form DFIRE kernel (K4, the v1 mode) against its plain
    version at the 1ppe shapes with the step tables: 200 and 37 poses,
    with and without the moved gate, clustered poses with culled
    tile-poses with and without interface flags, and the step tables in
    bfloat16; raw sums to 5e-5, flags exactly, two launches bit-equal;
    then on pairs at every bin edge and within 64 ulps either side (the
    step-table form of ``standin.bin_edge_case``), rigid and per pose:
    sums and flags exactly equal;
14. runs the 1ppe v1 DFIRE path, ``GsoTorchRunner(energy_mode=
    'kernel_v1')`` for 100 steps through ``run_segmented(100, 10)``: one
    K4 launch and no other kernel's a step, the snapshots, finite scores,
    the step-1 scores against the dense step-form oracle (5e-5); then
    phases 4 and 5 for it and K4; then K4, rigid and per pose, at G = 200
    and on a 6,400-pose batch (``toy_system(1615, 221, 6400,
    dfire_mode="steps")``, a farm's step): the batch against plain (rtol
    5e-5 with ``K4_BATCH_ATOL``, the floor its sums need printed; flags
    exactly; two launches bit-equal), and at each the wrapper's ms, the
    body's and the second pass's device ms, the bound, registers and
    resident warps;
15. holds the v1 elec/vdw kernel (K5) against its plain version at the
    1azp shapes with a rigid and a per-pose receptor (the cases of phase
    13 without bfloat16), on the coincident pair (NaN in both) and on the
    cutoff-edge pairs of phase 6, then runs the 1azp DNA + ANM v1 path for
    100 steps (one K5 launch a step, the oracle), phases 4 and 5 for it
    and K5, and K5's timings and checks at 6,400 poses as phase 8 K3's;
16. runs the farm: ``SwarmFarmRunner`` with 32 swarms x 200 glowworms on
    the 1ppe DFIRE stand-in (``energy_mode='kernel'``) for 100 steps
    through ``run_segmented(100, 10)``, writing 32 swarm directories: 100
    K1 launches in all, finite scores; K1 against its plain version on the
    farm's step-1 inputs (6,400 poses in one call, with and without the
    moved gate; rtol 5e-5 with the absolute floor ``REORDER_ATOL``, flags
    exactly); swarms 0 and 31 run alone for 10
    steps from the same positions (``GsoTorchRunner``) match the farm's
    step-1 scores (5e-5), and it reports over how many of the 10 steps
    their neighbour counts agree and whether the gso_1 and gso_10 text is
    byte-identical (sums over other pose batches may round apart); times
    K1 on the 6,400 step-1 poses with its bound, the 100 steps (min of 5,
    reset before each) as aggregate poses/s, K1's registers and resident
    warps, and profiles steps 11-30;
17. runs 4 swarms of the farm for 10 steps in ``energy_mode='kernel_v1'``:
    one K4 launch a step, step-1 scores equal to the kernel-mode farm's
    (5e-5); K4 against its plain version on these 800 poses as phase 16
    holds K1;
18. runs the table-selection probes P1-P6 (``lightdock_tpu_torch.probes``,
    the ports of ``scripts/exp_*.py``), all 27 variants at the scripts'
    shapes through the entry point's ``run_variant`` (every count set to 0
    just before each variant and read just after: its wrapper, and no
    other, launched), printing the scripts' ``name ms pairs/s chk=`` lines
    (CUDA events, 20 calls after a warm-up); holds each kernel against its
    plain version on the card bit for bit (the plain versions repeat the
    kernels' order; the JAX probes' tolerances, met on the CPU by
    ``tests/test_torch_probes.py``, are looser), P4-P6 also against the
    plain version on the CPU, checks two launches bit-equal and P1's tak
    equal to tourn, times the plain version and, where one PyTorch call
    computes the same function (``torch.gather``, ``torch.sqrt``, one add),
    that call; then prints P3's A/B line, v3gather's pairs/s against
    v2chain's, holds the receptor loop's three modes against plain bit
    for bit at P2's and P3's shapes with coordinates from uniform(-6, 6)
    (every slot, chain threshold and the cutoff crossed; one line a mode),
    prints each variant's device time a call (torch.profiler; P1's two
    kernels, ``select_reps_kernel`` and ``rep_sum_kernel``, and no other
    a call), each variant that has a PyTorch call with its wrapper ms
    beside that call's and its device time, and for each P1 variant its
    device time, wrapper ms, bound, the SASS instructions its kernel
    issues an element-rep (``cuobjdump -sass``) with their time at full
    issue, its registers and resident warps an SM;
19. drives the command line, ``lightdock_tpu_torch.cli.main`` in-process
    in a temporary working directory, on the files ``standin.write_complex``
    writes for the 1ppe-shaped DFIRE complex (PDB files, setup.json, one
    positions file of 200 glowworms): ``setup.json initial_positions_0.dat
    100 dfire --metrics FILE``: exit 0, 100 K1 launches and no other
    kernel's, the snapshots with their sidecars, finite scores, the metrics'
    segments, each followed by its trace line, and summary; the step-1 scores against a ``GsoTorchRunner``
    built from ``load_simulation`` on the same files (5e-5), whether
    gso_100.out is byte-identical to the runner's; the CLI's poses/s (its
    ``--metrics`` summary) beside the runner's (min of 5, reset before
    each), and what ``load_simulation`` and ``batch_params`` cost once a
    run;
20. drives the rest of the command line the same way: ``dna`` on the
    1azp-shaped files with 10 + 10 ANM modes for 30 steps (one K3 launch a
    step, 27 pose columns), and for 10 steps with ``--energy-mode
    kernel_v1`` (one K5 launch a step); the multi-swarm glob of 32 positions files of
    the 1ppe-shaped complex for 20 steps, then to 30 with ``--resume auto``
    (one K1 launch a step: 20, then 10; 32 swarm directories; the gso_30
    scores against an uninterrupted 30-step run, 5e-5, and whether the
    text is byte-identical); ``--energy-mode kernel_v1`` for 10 steps (one
    K4 launch a step); ``--resume swarm_0/gso_10.out --resume-step 10``
    with that sidecar deleted (the text path; 10 K1 launches), the state
    it reads held against the sidecar's to the text's decimals, and its
    gso_20 scores beside the same resume from the sidecar's (printed, with
    the step at which the two trajectories part); ``--profile``
    for 10 steps (the trace written); and ``python -m
    lightdock_tpu_torch.cli ... 10 dfire`` in a process of its own (exit 0);
21. spawns 2 ranks of ``torch.distributed`` (``multihost.spawn_local``;
    gloo when the cards are fewer than the ranks, NCCL otherwise; each
    rank's card named) that split the receptor atoms of one swarm
    (``sharded.run_multi_swarm_2d_kernel`` on a 1 x 2 mesh): the 1ppe DFIRE
    system for 100 steps (one K1 launch a step a rank and no other
    kernel's) and the 1azp DNA + ANM system for 30 (one K3 launch a step a
    rank, a per-pose receptor slice); step-1 scores against
    ``GsoTorchRunner`` (5e-5); the run's poses at steps 10, 50 and 100
    scored by the single-GPU kernel energy (rtol 5e-5, ``REORDER_ATOL`` on
    raw sums carried to scores); the kernel against plain on the rank's
    slice; the two ranks' final states bit-equal; poses/s (min of 3)
    beside phase 4's;
22. spawns 4 ranks as a 2 x 2 (swarm, atoms) mesh running the 32 x 200
    farm through ``run_swarm_farm(n_atom_shards=2, energy_mode='kernel')``
    for 20 steps: one K1 launch a step a rank, 32 swarm directories each
    written by one rank, step-1 scores against phase 16's farm (5e-5 with
    the floor), a row's two ranks bit-equal, aggregate poses/s (min of 3)
    beside phase 16's;
23. runs ``lightdock_tpu_torch.cli.main`` on 2 ranks with torchrun's
    environment on the 32-file glob for 20 steps: one K1 launch a step a
    rank, each rank writing its 16 swarms, gso_20 against one process on
    the same files (5e-5; byte-identity printed), rank 0's ``--metrics``
    counting all 32 swarms;
24. scores a float64 swarm at float32 (``GsoTorchRunner(dtype=float64,
    energy_dtype=float32)``): 100 steps on the 1ppe DFIRE stand-in (K1)
    and on the 1azp DNA + ANM stand-in (K3), 10 steps of ``kernel_v1``
    with ``dq_bf16`` on 1ppe (K4 with bfloat16 step tables): one launch of
    the path's kernel a step and none of another, the state float64,
    step-1 scores bit-equal to the float32 runner's cast to float64, every
    unmoved pose's score kept, a stored float64 score passed through the
    gate as float64(float32(score)), K4's step tables bfloat16, poses/s
    (min of 5, reset before each) in turns with the float32 runner; then
    the float64 dense run of the 1ppe stand-in files for 10 steps on the
    card and on the CPU (gso_1 and gso_10 text-identical, no kernel
    launched); then ``lightdock_tpu_torch.precision_fidelity`` with
    ``--standin`` and ``--hybrids`` for 100 steps: every row of the script
    with its fields, the float64 seed control's step-1 scores equal, part
    A's median relative errors within 1e-5, K1 and K3 each launched by the
    float32 kernel leg and part A alone; a line a row.
25. runs the workflow around a run, from raw PDB files: times the native
    gso_N.out writer against its plain version (``format_gso_output`` and
    the write) in turns at 200 x 7 and 200 x 27 pose columns, and the
    ``.npz`` sidecar apart; copies the 1ppe-shaped stand-in's PDB files to
    rec.pdb and lig.pdb and runs ``lightdock-tpu-torch-tools setup`` for 32
    swarms x 200 (timed), the 32-file glob through ``lightdock-tpu-torch``
    for 100 steps with ``--metrics`` (100 K1 launches and no other
    kernel's; its poses/s beside phase 20's resumed glob), then 4 more in
    turns with the plain and the native writer; ``lightdock-tpu-torch-
    analysis rank`` with metrics over all 6,400 poses, ``cluster`` and
    ``all`` on the card (timed, no kernel launched), the clash count's
    device ms beside its bound (float64 operations over 34 TFLOP/s), the
    pose transform and an RMSD matrix; on copies of 4 swarms, ``rank`` then
    ``all`` on the card and with ``--platform cpu`` (timed; every file
    byte-identical); then a DNA + ANM setup (1094 x 506 atoms, 10 + 10
    modes, 4 x 200) run 10 steps (10 K3 launches, 27 pose columns) and
    analysed on the card and the CPU alike; every snapshot the phase writes
    equals ``format_gso_output`` of its sidecar's state.
26. runs the port's benchmark entry point as a user does, ``python -m
    lightdock_tpu_torch.bench`` in a process of its own with the default
    energy mode ('auto'), for the default system (the 1ppe stand-in and the
    32-swarm farm on stderr), ``--system 1azp`` and ``--system 1k4c``: the
    last line ``bench.py``'s keys and ``device`` naming the card, a
    positive value, the mode on stderr ``pick_energy_mode``'s (for one
    swarm's replayed steps, and 6,400 poses a call in the farm), and where
    it is 'kernel' the launches of the timed runs (K1 500 and the farm's
    50, K3 500, K2 500, no other kernel's); then ``--crossover`` at four
    points whose measured lead lies outside the spread between runs (one
    swarm, replayed, at 1ppe and at 1czy DNA, the kernel's; a 2-swarm farm
    at 1czy DNA, dense's; a 32-swarm farm at 1ppe r200, the kernel's),
    printing each point's line and the table: the bench's pick is
    ``pick_energy_mode``'s and lost by no more than 1.2x there.  The whole
    map is ``bench --crossover``'s, on demand (``engine.runner``).
27. runs the float64 host parity engine: ``HostScorer`` on the card
    against the CPU on 8 poses of each method's stand-in (1ppe DFIRE, 1azp
    DNA with 10 + 10 modes, 1azp PYDOCK) at rel 1e-12, then
    ``lightdock-tpu-torch --engine host`` 10 steps on the 1ppe stand-in's
    files (200 glowworms) on the card and with ``--platform cpu``: gso_1.out
    text-identical, the final states (read from the engine each run built)
    within 1e-9 and the neighbour counts equal, no pair kernel launched;
    ms a step, and the energy's ms a step with the poses it scored, on
    each device, and all 200 poses rescored on the warm card.
28. holds the box cull kernel (``ops.cull.cull_tile_bits``) against its
    plain version on the arguments the energy path hands it: the 1k4c
    stand-in at 6,400 poses (the membrane cell's call: 428 x 104
    sub-boxes, three cutoffs) and each path of phases 3-15 at 200 poses
    45 A out, with and without the moved gate: every bit equal but within
    1e-5 relative of a cutoff^2, nothing the float64 bound keeps dropped,
    two launches equal, the counts equal to the per-pose bits' sums; no
    cull launch and all-ones bits with ``cull=False``; the kernel's ms a
    call (with and without counts), its plain version's with the
    temporaries it takes, and its bound at 6,400 and 200 poses.  Each
    path's main run (phases 3, 7, 9, 11, 14, 15) launches it once a step;
    its kernels-line entry counts those launches.

Ranks that share one card time the sharded paths' correctness, not their
scaling.

Every kernel's bound (the least time the card could take for the same
work: the larger of its bytes over 3.35 TB/s and its f32 operations over
67 TFLOP/s) is computed from the inputs of its timed call, counting the
pair-poses of real atoms and poses only (for a probe, the table entries
its function reads on this run's data, its other operands, and its
elements times ``PROBE_OPS``, bfloat16 ones over 134 TFLOP/s).

Fails with a non-zero exit and no result line when there is no CUDA
device, when it is not run from a checkout, or when any check fails (a
rank's failure included).  The last line of its output is the JSON device
record; the line before it lists the kernels, with each kernel's launches
a rank in the sharded phases (``rank_launches``), at phase 24's sites
(``mixed_launches``), in phase 25's runs (``workflow_launches``) and in
phase 26's bench runs (``bench_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
N_POSES, STEPS, SEGMENT, SEED = 200, 100, 10, 324324
DFIRE_ATOMS = (1615, 221)          # 1ppe-shaped stand-in
DNA_ATOMS, DNA_ANM = (1094, 506), 10   # 1azp-shaped stand-in, 10 + 10 modes
ANM_STEPS = 30                     # depth of the DFIRE + ANM run (phase 9)
ORACLE_CHUNK = 16                  # poses per dense-oracle chunk
RTOL = ATOL = 5e-5
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s outside
# the tensor cores; bfloat16 FLOP/s outside the tensor cores, twice f32
# (NVIDIA's H100 architecture white paper: 133.8 TFLOP/s).
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 134e12
# f32 operations per pair-pose in an active chunk-tile: d2 is 3 sub, 3 mul
# and 2 add; DFIRE adds the accumulate; elec/vdw adds the reciprocal, the
# elec product, mask and scale, then on near chunks the p^6 chain, the vdw
# product and mask and the term add, and the accumulate.
FLOPS_DFIRE, FLOPS_EV_NEAR, FLOPS_EV_FAR = 9, 22, 13
# f32 operations per sub-box pair of the box cull, its compares aside: per
# axis the distance (sub, abs), the reach (2 adds), the gap (sub, clamp)
# and its square, then the sum's 2 adds; phase 28's poses of a farm call
# and the band (relative to a cutoff^2) in which the kernel's bits may part
# from the plain version's.
FLOPS_CULL, CULL_BATCH, CULL_EDGE_REL = 3 * 7 + 2, 6400, 1e-5
FARM_SWARMS, FARM_V1_SWARMS, FARM_SINGLE_STEPS = 32, 4, 10
# Depths of the command-line runs of phase 20: the DNA + ANM run, the
# multi-swarm glob before and after --resume auto, and the short runs.
CLI_DNA_STEPS, CLI_FARM_STEPS, CLI_RESUMED_STEPS, CLI_SHORT_STEPS = 30, 20, 30, 10
# Absolute floor on raw DFIRE sums where a call holds thousands of poses
# (phases 16-17): among 6,400 poses some sums nearly cancel, and there two
# f32 orders of the same ~56k pair terms part by a few ulps of the partial
# sums (up to 3.2e-4 on the 200-pose cases).  1e-3 raw is 1.6e-5 of score.
REORDER_ATOL = 1e-3
# Absolute floor on K4's raw sums at the 6,400-pose batch of phase 14: the
# floor they need beside rtol 5e-5 read 6.155e-5 rigid and 5.343e-5 per
# pose on an H100 (PERF.md), from a few sums that nearly cancel; about
# three times that.
K4_BATCH_ATOL = 2e-4
EV_BATCH = 6400                    # poses of the elec/vdw kernels' batch (32 x 200)
# The band of float32 ulps around each DFIRE bin edge where phase 2 holds
# K1 and K2 to plain (the band in which tests/test_torch_dfire_bins.py
# models the kernels' slot on the CPU), and around each elec/vdw cutoff
# where phases 6 and 15 hold K3 and K5 to plain.
EDGE_ULPS = 64
# Phases 21-23: ranks of torch.distributed, spawned on this host.  Receptor
# atoms over 2 ranks (phase 21: DFIRE 100 steps, DNA + ANM 30; the run's own
# poses rescored at SHARD_CHECK_STEPS), a 2 x 2 (swarm, atoms) mesh (phase 22)
# and the command line on 2 ranks (phase 23), both SHARD_FARM_STEPS steps.
SHARD_RANKS, SHARD_GRID, SHARD_DNA_STEPS = 2, (2, 2), 30
SHARD_FARM_STEPS, SHARD_CHECK_STEPS = 20, (10, 50, 100)
RANK_TIMEOUT = 300                 # seconds a collective waits for a peer
# Phase 24: the depth of the K4 run with bfloat16 step tables and of the
# float64 dense run on the card and on the CPU; the most part A's median
# relative error of a float32 mode may read (the JAX package's CPU rows in
# PRECISION_r05.json read 8.9e-8 on 1ppe, 3.4e-7 on 1azp).
MIXED_V1_STEPS, MIXED_CPU_STEPS, PART_A_MEDIAN = 10, 10, 1e-5
# Phase 25: the workflow around a run.  `tools setup` of WORKFLOW_SWARMS x
# N_POSES on the 1ppe-shaped stand-in's PDB files, the glob STEPS steps
# (and WORKFLOW_AB_RUNS more in turns, the plain writer against the native
# one), the analysis on the card; the card's files against the CPU's on
# copies of the first WORKFLOW_SUBSET swarms; a DNA + ANM setup of
# WORKFLOW_SUBSET swarms run CLI_SHORT_STEPS steps.  Each writer form
# timed WRITER_REPS times a turn, the clash count CLASH_REPS calls.
WORKFLOW_SWARMS, WORKFLOW_SUBSET, WORKFLOW_AB_RUNS = 32, 4, 4
WRITER_REPS, CLASH_REPS = 20, 5
# Phase 26: the keys of the bench's last line, each bench system's pair
# kernel, the seconds a bench process may take, and the crossover's points
# (swarms, labels): each mode's lead there lies outside the spread between
# runs (engine.runner.CROSSOVER_MAP), so a 1.2x gate holds on any host.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
BENCH_KERNELS = {"1ppe": "dfire_pairs", "1azp": "elec_vdw_pairs",
                 "1k4c": "dfire_pairs_worklist"}
BENCH_TIMEOUT = 600
BENCH_CROSSOVERS = ((1, ("1ppe", "1czy dna")), (2, ("1czy dna",)), (32, ("1ppe r200",)))
# float64 operations a second outside the tensor cores (NVIDIA's H100 SXM
# data sheet), and the clash count's float64 operations a receptor-ligand
# pair (3 differences, 3 squares, 2 adds, 1 compare): its bound.
PEAK_F64, FLOPS_CLASH = 34e12, 9
# operations an element (P1: an element-rep; P2-P3: a pair; P4-P6: an
# output element and rep) of each probe variant, counting a compare, a
# select, an add, a multiply, a sqrt and a cast one each (loads, index
# arithmetic and bfloat16 rounding not counted):
#   select_reps (chain16 in bfloat16): the moved d2 (mul, add) 2; chain
#     20 x (compare, add, select) 60; tak 20 x (compare, integer add) 40;
#     tourn 20 x (compare, select) 40; the mask (compare, mul) 2; the sum 1.
#   receptor_loop: d2 (3 sub, 3 mul, 2 add) 8; the slot (sqrt, mul, sub,
#     cast, 2 clamps) 6; slot adds the cast to float; chain 20 x 3 and the
#     mask 2; the accumulate 1.
#   gather_form: bare's clip 2, slot 6, trunc_cast 7, touch and sqrt 1; a
#     loop's accumulate 1 and its r add 1, row_loop (x 0 + 1) 2 and its
#     product 1, parity_loop r % 2 and its add 2, chain 60, scalar_loop's
#     difference 1.
PROBE_OPS = {
    ("select_reps", "chain"): 65, ("select_reps", "tak"): 45, ("select_reps", "tourn"): 45,
    ("receptor_loop", "slot"): 16, ("receptor_loop", "gather"): 15,
    ("receptor_loop", "chain"): 71,
    ("gather_form", "bare"): 2, ("gather_form", "slot_gather"): 6,
    ("gather_form", "static_loop"): 8, ("gather_form", "slice_loop"): 8,
    ("gather_form", "row_loop"): 4, ("gather_form", "parity_loop"): 9,
    ("gather_form", "touch"): 1, ("gather_form", "chain_loop"): 61,
    ("gather_form", "sqrt"): 1, ("gather_form", "trunc_cast"): 7,
    ("gather_form", "scalar_loop"): 2,
}
PROBE_REPLACES = {"P1": "scripts/exp_gather_kernel.py:85", "P2": "scripts/exp_gather2d.py:71",
                  "P3": "scripts/exp_gather32.py:65", "P4": "scripts/exp_gather_forms.py:33",
                  "P5": "scripts/exp_bisect.py:30", "P6": "scripts/exp_probe_ops.py:30"}
PROBE_PLAIN_CALLS = {"P1": 2, "P2": 2, "P3": 2}   # timed plain calls; 5 elsewhere
# Phase 27: the host parity engine.  Its scorer's poses a method and their
# tolerance (card against CPU, relative), the command line's steps and the
# tolerance of the final states (card against CPU, absolute: the energies'
# float64 sums run in another order on the card).
HOST_SCORER_POSES, HOST_SCORER_RTOL = 8, 1e-12
HOST_STEPS, HOST_STATE_ATOL = 10, 1e-9
HOST_STATE = ("t", "q", "a_rec", "a_lig", "luciferin", "scoring", "vision")


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
    """One configuration the smoke run drives: its system, the energy path
    built for it on the card, and the kernel that path chose (with its
    plain version, launch counter and device kernel names)."""

    def __init__(self, label, system, energy_mode="kernel"):
        import torch

        from lightdock_tpu_torch.engine.energy_kernel import (
            kernel_params, make_kernel_energy_fn)
        from lightdock_tpu_torch.engine.params import torch_params
        from lightdock_tpu_torch.ops import dfire_pairs as dp
        from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4
        from lightdock_tpu_torch.ops import elec_vdw_pairs as ev
        from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5

        self.label = label
        self.params, self.pos, self.num_anm = system
        self.energy_mode = energy_mode
        gen = "v1" if energy_mode == "kernel_v1" else "v2"
        kparams = kernel_params(self.params, gen)
        self.tp = torch_params(kparams, "cuda", torch.float32)
        self.energy_fn = make_kernel_energy_fn(kparams, "cuda", torch.float32,
                                               kernel=gen)
        self.kernel = self.energy_fn.kernel
        self.plain, self.kernel_names = {
            dp.dfire_pairs: (dp.dfire_pairs_plain,
                             ("dfire_pairs_kernel", "sum_rows_kernel")),
            dp.dfire_pairs_worklist: (dp.dfire_pairs_worklist_plain,
                                      ("compact_tiles_kernel",
                                       "dfire_pairs_worklist_kernel",
                                       "sum_rows_kernel")),
            ev.elec_vdw_pairs: (ev.elec_vdw_pairs_plain,
                                ("elec_vdw_pairs_kernel", "sum_rows_kernel")),
            k4.dfire_pairs_v1: (k4.dfire_pairs_v1_plain,
                                ("dfire_pairs_v1_kernel", "sum_rows_kernel")),
            k5.elec_vdw_pairs_v1: (k5.elec_vdw_pairs_v1_plain,
                                   ("elec_vdw_pairs_v1_kernel", "sum_rows_kernel")),
        }[self.kernel]

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
                              dtype=torch.float32, device="cuda",
                              energy_mode=self.energy_mode)


def compare(path, args, kwargs, phase, label, kernel=None, plain=None, atol=ATOL):
    """A kernel (the path's by default) against plain on the same inputs,
    raw sums at rtol 5e-5 and ``atol``; returns the max |raw diff|."""
    import torch
    kernel = kernel or path.kernel
    plain = plain or path.plain
    before = kernel.launches
    out = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    check(kernel.launches == before + 1, f"{path.label}: {kernel.__name__} did not launch")
    ref = plain(*args, **kwargs)
    n = args[1].shape[0]
    check(out[0].shape == (n,) and bool(torch.isfinite(out[0]).all()),
          f"{path.label}: kernel raw sums not finite / shaped ({label})")
    err = float((out[0] - ref[0]).abs().max())
    floor = float(((out[0] - ref[0]).abs() - RTOL * ref[0].abs()).clamp(min=0).max())
    close = bool(torch.allclose(out[0], ref[0], rtol=RTOL, atol=atol))
    if atol != ATOL:
        beyond = ~torch.isclose(out[0], ref[0], rtol=RTOL, atol=ATOL)
        label += (f", atol {atol:g} ({int(beyond.sum())} sums beyond atol {ATOL:g}, "
                  f"|raw| there up to {float(ref[0][beyond].abs().max()) if beyond.any() else 0:.4g})")
    if kwargs["need_iface"]:
        flags = torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        note = (f"interface flags equal {flags}, flags set "
                f"{int(out[1].sum())}+{int(out[2].sum())}")
    else:
        flags = out[1] is None and out[2] is None
        note = f"no flags returned {flags}"
    act, near = args[-2], kwargs.get("near_chunks")
    near_n = int((near * act).sum()) if near is not None else "-"
    say(f"phase {phase}: {path.label} {kernel.__name__} {label}: max|raw diff| "
        f"{err:.3e} (allclose {close}; atol needed beside rtol {RTOL:g}: {floor:.3e}), "
        f"{note}, active bits "
        f"{int(act.sum())}/{act.numel()}, near {near_n}")
    check(close, f"{path.label}: kernel raw sums disagree with plain ({label})")
    check(flags, f"{path.label}: interface flags disagree with plain ({label})")
    return err


def kernel_cases(path, phase, gen, rng, kernel=None, plain=None):
    """A kernel against plain at the path's shapes (G=200 and 37, with and
    without the moved gate) and on clustered poses with far chunk-tiles
    (with and without interface flags); two launches must be bit-equal.
    Returns the max error and the ungated G=200 call."""
    import numpy as np
    import torch

    kernel = kernel or path.kernel
    max_err, main = 0.0, None
    for n in (N_POSES, 37):
        for gated in (False, True):
            moved = (torch.rand(n, generator=gen, device="cuda") < 0.6) if gated else None
            args, kwargs = path.energy_fn.kernel_args(path.tp, *path.pose(n), moved)
            err = compare(path, args, kwargs, phase, f"G={n} moved_gate={gated}",
                          kernel, plain)
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
                      f"G={N_POSES} clustered need_iface={need_iface}", kernel, plain)
        max_err = max(max_err, err)
    again = kernel(*main[0], **main[1])
    first = kernel(*main[0], **main[1])
    check(torch.equal(again[0], first[0]), f"{path.label}: sums differ between runs")
    return max_err, main


def drive(path, counters, phase, steps=STEPS):
    """The path's main run: ``steps`` steps through ``run_segmented`` with
    every kernel count, the box cull's too, set to 0 just before and read
    just after.  Returns the path kernel's launches, the step-1 scores
    from the gso_1 sidecar and the cull kernel's launches (one a step)."""
    import numpy as np
    import torch

    from lightdock_tpu_torch.ops.cull import cull_tile_bits

    expected = {f"gso_{s}.out" for s in [1] + list(range(10, steps + 1, 10))}
    with tempfile.TemporaryDirectory() as out_dir:
        runner = path.runner(out_dir)
        for c in counters:
            c.launches = 0
        cull_tile_bits.launches = 0
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(steps, SEGMENT)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        culls = cull_tile_bits.launches
        snaps = {p.name for p in pathlib.Path(out_dir).glob("gso_*.out")}
        with np.load(pathlib.Path(out_dir) / "gso_1.out.npz") as sidecar:
            step1 = sidecar["scoring"]
        cols = snapshot_columns(pathlib.Path(out_dir) / f"gso_{steps}.out")
    runner.release()
    ours = launches[path.kernel.__name__]
    say(f"phase {phase}: {path.label}: {steps} steps in {run_s:.3f} s (first run, "
        f"with snapshots); kernel launches {launches}, cull_tile_bits {culls}; "
        f"snapshots {len(snaps)} "
        f"with {cols} pose columns; final scores min {float(final.scoring.min()):.6f} "
        f"max {float(final.scoring.max()):.6f}")
    check(ours == steps, f"{path.label}: {ours} kernel launches in {steps} steps")
    check(sum(launches.values()) == ours, f"{path.label}: other kernels launched")
    check(culls == steps, f"{path.label}: {culls} cull kernel launches in {steps} steps")
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
    return ours, step1, culls


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
    form = "gather" if otp.method == "dfire" and otp.dfire_dq is None else "dense"
    say(f"phase {phase}: {path.label}: step-1 scores vs {form} oracle: max|diff| "
        f"{err:.3e} (allclose {close}), score range [{float(ref.min()):.4f}, "
        f"{float(ref.max()):.4f}]")
    check(close, f"{path.label}: step-1 scores disagree with the dense oracle")


def device_profile(fn):
    """Run ``fn`` under torch.profiler; returns (wall us, device events,
    launch-call events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launch = [e for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                             "cudaLaunchKernelExC", "cuLaunchKernelEx")]
    return wall_us, dev, launch


def profile_steps(reset, advance, card, kernel_names, first=10, last=30) -> str:
    """Profile steps first+1..last after ``reset()`` and ``advance(first)``
    (``advance(n)`` runs to n completed steps) and return a one-line
    summary.  Device time is the sum of the device-side events (kernels,
    copies, fills) the profiler records; on one stream they do not overlap,
    so it is the device's busy time."""
    reset()
    advance(first)
    wall_us, dev_events, launch = device_profile(lambda: advance(last))
    steps = last - first
    if not dev_events:
        return (f"[{card}] steps {first + 1}-{last}: wall {wall_us / 1e3:.3f} ms; "
                "device time not measured (the profiler saw no device events)")
    busy = sum(e.time_range.elapsed_us() for e in dev_events)
    ours = [e for e in dev_events if any(k in e.name for k in kernel_names)]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    launch_us = sum(e.time_range.elapsed_us() for e in launch)
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return (f"[{card}] profile of steps {first + 1}-{last}: wall "
            f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
            f"({busy / wall_us:.4f} of wall), {len(dev_events)} device ops "
            f"({len(dev_events) / steps:.1f} a step), {len(launch)} launch "
            f"calls taking {launch_us / 1e3:.3f} ms of host time; pair "
            f"kernel (all its launches) {ours_us / 1e3:.3f} ms over {len(ours)} "
            f"device ops ({ours_us / busy:.4f} of device busy); most device "
            "time: " + "; ".join(f"{name[:70]} {us / 1e3:.3f} ms over {n}"
                                 for name, (n, us) in top))


def timing(path, main, card, phases, plain_reps=10):
    """Kernel vs plain ms a call, the path's poses/s (min of 5, reset
    before each), steps 1-20 one at a time, and the profile of steps
    11-30.  Returns (kernel_ms, plain_ms)."""
    import torch

    args, kwargs = main
    kernel_ms = cuda_ms(lambda: path.kernel(*args, **kwargs), 200)
    plain_ms = cuda_ms(lambda: path.plain(*args, **kwargs), plain_reps)
    say(f"phase {phases[0]}: [{card}] {path.label} kernel at G={N_POSES}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms per call "
        f"({plain_reps} plain calls)")
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
    path.poses_per_s = N_POSES * STEPS / best
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
        + profile_steps(timer.reset, timer.run, card, path.kernel_names))
    timer.release()
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


def pair_poses(main, bits, chunks):
    """The pair-poses that the set ``bits`` (n_r, n_l, P) of one kernel call
    ask for, counting real atoms only: each tile's bits weighted by its
    true row and column counts (the last tiles of each side are part
    padding).  With ``chunks`` a bit covers a 16-pose chunk and counts the
    chunk's real poses."""
    import torch

    args, kwargs = main
    nr, (g, _, nl) = args[0].shape[1], args[1].shape
    r_tile, l_tile = kwargs["r_tile"], kwargs["l_tile"]

    def real(n_tiles, n, size):
        first = torch.arange(n_tiles, dtype=torch.float64, device=bits.device) * size
        return (n - first).clamp(min=0, max=size)

    poses = (real(bits.shape[2], g, 16) if chunks
             else torch.ones(bits.shape[2], dtype=torch.float64, device=bits.device))
    return int(torch.einsum("rlp,r,l,p->", bits.double(), real(bits.shape[0], nr, r_tile),
                            real(bits.shape[1], nl, l_tile), poses))


def nbytes_once(main, out):
    """Bytes of a kernel call's inputs and outputs, each once."""
    import torch

    args, kwargs = main
    tensors = []
    for a in list(args) + [kwargs.get("near_chunks")] + list(out):
        if torch.is_tensor(a):
            tensors.append(a)
        elif isinstance(a, tuple):   # DfireTables
            tensors += [x for x in a if torch.is_tensor(x)]
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(main, out, ev=False):
    """(bound_ms, bound_by) of one K1, K2 or K3 call: the larger of the
    bytes its inputs and outputs take once over the HBM rate and its f32
    operations over the f32 peak, counting the real pair-poses of this
    call's active chunk-tiles (:func:`pair_poses`)."""
    args, kwargs = main
    act = args[8] if ev else args[3]
    n_act = pair_poses(main, act, chunks=True)
    if ev:
        near = kwargs["near_chunks"]
        n_near = pair_poses(main, act * near, chunks=True) if near is not None else n_act
        flops = n_near * FLOPS_EV_NEAR + (n_act - n_near) * FLOPS_EV_FAR
    else:
        flops = n_act * FLOPS_DFIRE
    t_bytes, t_ops = nbytes_once(main, out) / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ops_bound(main):
    """The operations half of a DFIRE call's :func:`bound`, in ms: the same
    work for every version of the kernel, whatever its table's bytes."""
    return pair_poses(main, main[0][3], chunks=True) * FLOPS_DFIRE / PEAK_F32 * 1e3


def edge_cases(phase):
    """K1 and K2, rigid and per-pose receptor, against plain on pairs at
    every bin edge and within ``EDGE_ULPS`` ulps either side
    (``standin.bin_edge_case``).  Returns the max errors of K1 and K2."""
    import types

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.ops import dfire_pairs as dp

    err = {dp.dfire_pairs: 0.0, dp.dfire_pairs_worklist: 0.0}
    path = types.SimpleNamespace(label=f"bin edges +-{EDGE_ULPS} ulps")
    for per_pose in (False, True):
        case = standin.bin_edge_case("cuda", per_pose=per_pose, ulps=EDGE_ULPS)
        for kernel, plain in ((dp.dfire_pairs, dp.dfire_pairs_plain),
                              (dp.dfire_pairs_worklist, dp.dfire_pairs_worklist_plain)):
            err[kernel] = max(err[kernel], compare(
                path, case.args, case.kwargs, phase,
                f"G={case.d2.shape[0]} per-pose receptor {per_pose}", kernel, plain))
    return err[dp.dfire_pairs], err[dp.dfire_pairs_worklist]


def occupancy(lib):
    """{kernel: (registers a thread, resident warps an SM)} of K1 and K2,
    rigid and per pose, from the DFIRE library's ``dfire_pairs_occupancy``
    (``csrc/dfire_pairs.cu``)."""
    import ctypes

    fn = lib.dfire_pairs_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    out = {}
    for which, name in enumerate(("K1", "K1 per-pose", "K2", "K2 per-pose")):
        blocks, regs, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = fn(which, ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(smem))
        check(err == 0, f"dfire_pairs_occupancy({which}): CUDA error {err}")
        out[name] = (regs.value, blocks.value * 256 // 32)
    return out


def ev_occupancy(built):
    """{kernel: (registers a thread, local (stack and spill) bytes a
    thread, resident warps an SM)} of K3 and K5, rigid and per pose, from
    ``elec_vdw_pairs_occupancy`` and ``elec_vdw_pairs_v1_occupancy``
    (``csrc/elec_vdw_pairs.cu``, ``csrc/elec_vdw_pairs_v1.cu``)."""
    import ctypes

    out = {}
    for lib_name, kernel in (("elec_vdw_pairs", "K3"), ("elec_vdw_pairs_v1", "K5")):
        fn = getattr(built[lib_name].lib, f"{lib_name}_occupancy")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        for which, suffix in enumerate(("", " per-pose")):
            blocks, regs, local, smem = (ctypes.c_int() for _ in range(4))
            err = fn(which, *(ctypes.byref(x) for x in (blocks, regs, local, smem)))
            check(err == 0, f"{lib_name}_occupancy({which}): CUDA error {err}")
            out[kernel + suffix] = (regs.value, local.value, blocks.value * 256 // 32)
    return out


def k4_occupancy(built, n_k, r_tile):
    """{kernel: (registers a thread, local (stack and spill) bytes a
    thread, resident warps an SM)} of K4, rigid and per pose, float32 and
    bfloat16 step tables, with the dynamic shared memory of ``n_k``
    channels and ``r_tile`` rows, from ``dfire_pairs_v1_occupancy``
    (``csrc/dfire_pairs_v1.cu``)."""
    import ctypes

    fn = built["dfire_pairs_v1"].lib.dfire_pairs_v1_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    out = {}
    for which, suffix in enumerate(("", " per-pose", " bf16", " bf16 per-pose")):
        blocks, regs, local, smem = (ctypes.c_int() for _ in range(4))
        err = fn(which, n_k, r_tile, *(ctypes.byref(x) for x in (blocks, regs, local, smem)))
        check(err == 0, f"dfire_pairs_v1_occupancy({which}): CUDA error {err}")
        out["K4" + suffix] = (regs.value, local.value, blocks.value * 256 // 32)
    return out


def cutoff_edges(phase, kernel, plain, pose_bits):
    """K3 (or, with ``pose_bits``, K5), rigid and per-pose receptor,
    against plain on pairs at the interface, vdw and elec cutoffs and
    within ``EDGE_ULPS`` ulps either side (``standin.cutoff_edge_case``):
    sums at 5e-5 and exactly zero where plain's are, flags exactly.
    Returns the max error."""
    import types

    import torch

    from lightdock_tpu_torch import standin

    err = 0.0
    path = types.SimpleNamespace(label=f"cutoff edges +-{EDGE_ULPS} ulps")
    for per_pose in (False, True):
        case = standin.cutoff_edge_case("cuda", per_pose=per_pose, ulps=EDGE_ULPS)
        args, kwargs = case.k5 if pose_bits else case.k3
        err = max(err, compare(path, args, kwargs, phase, f"G={case.d2.shape[0]} "
                               f"per-pose receptor {per_pose}", kernel, plain))
        out, ref = kernel(*args, **kwargs)[0], plain(*args, **kwargs)[0]
        check(torch.equal(out == 0, ref == 0),
              f"{kernel.__name__}: a cutoff mask differs from plain's (per pose {per_pose})")
    return err


def kernel_sizes(phase, card, name, kernel, plain, mains, occ, body_name, bound_fn,
                 batch_atol=ATOL):
    """A pair kernel (``name``: K3, K4 or K5) on each call of ``mains``
    ({label: (args, kwargs)}: rigid and per pose, G = 200 and ``EV_BATCH``
    poses).  A call of ``EV_BATCH`` poses is first held against plain
    (rtol 5e-5 and ``batch_atol``, flags exactly; the line prints the
    absolute floor the sums need beside rtol) and its two launches must be
    bit-equal.  Then at each: the wrapper's ms a call (CUDA events), the
    device ms of the body ``body_name`` and of the second pass
    (torch.profiler, 10 calls), the bound (``bound_fn(main, out)``),
    registers and resident warps (``occ``).  Returns the max error at
    ``EV_BATCH`` poses."""
    import types

    import torch

    err = 0.0
    for label, (args, kwargs) in mains.items():
        batch = args[1].shape[0] == EV_BATCH
        if batch:
            path = types.SimpleNamespace(label=f"{name} {label}")
            err = max(err, compare(path, args, kwargs, phase, f"{name} batch", kernel, plain,
                                   atol=batch_atol))
            again = kernel(*args, **kwargs)[0]
            check(torch.equal(again, kernel(*args, **kwargs)[0]),
                  f"{name} {label}: sums differ between runs")
        out = kernel(*args, **kwargs)
        bnd = bound_fn((args, kwargs), out)
        ms = cuda_ms(lambda: kernel(*args, **kwargs), 20 if batch else 100)
        parts = device_parts(lambda: kernel(*args, **kwargs), (body_name, "sum_rows_kernel"))
        regs, local, warps = occ[name + (" per-pose" if args[0].shape[0] > 1 else "")]
        say(f"phase {phase}: [{card}] {name} {label}: {ms:.4f} ms a call through the "
            f"wrapper, body {fmt_ms(parts[body_name])}, second pass "
            f"{fmt_ms(parts['sum_rows_kernel'])} (torch.profiler, 10 calls), bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); {regs} registers, {local} B local, {warps} "
            f"resident warps an SM")
    return err


def device_parts(fn, names, calls=10):
    """{name: device ms a call of the events whose name holds ``name``, or
    None} over ``calls`` calls of ``fn`` under torch.profiler."""
    _, dev, _ = device_profile(lambda: [fn() for _ in range(calls)])
    parts = {}
    for part in names:
        us = [e.time_range.elapsed_us() for e in dev if part in e.name]
        parts[part] = sum(us) / len(us) / 1e3 if us else None
    return parts


def fmt_ms(x):
    return "not measured (no device events)" if x is None else f"{x:.4f} ms"


def ev_sizes(phase, card, name, kernel, plain, mains, occ):
    """K3 or K5 (``name``) on :func:`kernel_sizes`'s calls.  The floor the
    sums need beside rtol 5e-5 at 6,400 poses stayed 0 (PERF.md): the
    common atol."""
    pose_bits = name == "K5"
    body = "elec_vdw_pairs_v1_kernel" if pose_bits else "elec_vdw_pairs_kernel"

    def bound_fn(main, out):
        return bound_v1(main, out, FLOPS_EV_NEAR) if pose_bits else bound(main, out, ev=True)

    return kernel_sizes(phase, card, name, kernel, plain, mains, occ, body, bound_fn)


def k4_phase(phase, card, dfire_v1, occ):
    """Phase 14's K4 figures: at G = 200 (the path's poses; and per pose,
    the 1ppe stand-in with 10 + 10 ANM modes) and on ``EV_BATCH`` poses
    (``toy_system(1615, 221, 6400, dfire_mode="steps")``, rigid and per
    pose), :func:`kernel_sizes` (the batch against plain at rtol 5e-5
    with ``K4_BATCH_ATOL``).  Returns the max error."""
    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4

    anm_v1 = KernelPath("1ppe DFIRE + ANM v1", standin.toy_system(
        *DFIRE_ATOMS, N_POSES, num_anm=DNA_ANM, dfire_mode="steps"), energy_mode="kernel_v1")
    mains = {f"rigid G={N_POSES}": dfire_v1.energy_fn.kernel_args(
        dfire_v1.tp, *dfire_v1.pose(N_POSES)),
        f"per-pose G={N_POSES}": anm_v1.energy_fn.kernel_args(anm_v1.tp, *anm_v1.pose(N_POSES))}
    for label, anm in (("rigid", 0), ("per-pose", DNA_ANM)):
        path = KernelPath(f"1ppe DFIRE v1 {label} G={EV_BATCH}", standin.toy_system(
            *DFIRE_ATOMS, EV_BATCH, num_anm=anm, dfire_mode="steps"), energy_mode="kernel_v1")
        mains[f"{label} G={EV_BATCH}"] = path.energy_fn.kernel_args(path.tp,
                                                                    *path.pose(EV_BATCH))
    return kernel_sizes(phase, card, "K4", k4.dfire_pairs_v1, k4.dfire_pairs_v1_plain, mains,
                        occ, "dfire_pairs_v1_kernel",
                        lambda main, out: bound_v1(main, out, FLOPS_DFIRE),
                        batch_atol=K4_BATCH_ATOL)


def ev_batch_mains(systems, mode):
    """{label: (args, kwargs)} of the elec/vdw kernel of ``mode`` on the
    ``EV_BATCH``-pose stand-ins ``systems`` ({"rigid": ..., "per-pose":
    ...}), the first ``EV_BATCH`` poses in the order given."""
    mains = {}
    for label, system in systems.items():
        path = KernelPath(f"1azp DNA {label} G={EV_BATCH}", system, energy_mode=mode)
        mains[f"{label} G={EV_BATCH}"] = path.energy_fn.kernel_args(path.tp,
                                                                   *path.pose(EV_BATCH))
    return mains


def occupancy_report(phase, card, label, kernel, main, occ):
    """Phase ``phase``'s line of a DFIRE kernel's registers, resident warps
    an SM and bound on operations on ``main`` (the same work whatever the
    kernel's table bytes)."""
    which = ("K2" if "worklist" in kernel.__name__ else "K1") + (
        " per-pose" if main[0][0].shape[0] > 1 else "")
    regs, warps = occ[which]
    say(f"phase {phase}: [{card}] {label}: {which} {regs} registers, {warps} "
        f"resident warps an SM, bound {ops_bound(main):.4f} ms (operations)")


def coincident_pair(phase, kernel, plain, name):
    """A coincident atom pair: NaN in an elec/vdw kernel (K3 or K5) and in
    its plain version."""
    import torch

    def vec(v):
        return torch.full((1,), v, dtype=torch.float32, device="cuda")

    ones = torch.ones((1, 1, 1), dtype=torch.int32, device="cuda")
    args = (torch.zeros((1, 1, 3), device="cuda"), torch.zeros((1, 3, 1), device="cuda"),
            vec(0.5), vec(0.5), vec(0.2), vec(0.2), vec(1.5), vec(1.5), ones, ones)
    before = kernel.launches
    out = kernel(*args, r_tile=32, l_tile=128)[0]
    ref = plain(*args, r_tile=32, l_tile=128)[0]
    torch.cuda.synchronize()
    check(kernel.launches == before + 1, f"{name} did not launch")
    say(f"phase {phase}: {name} coincident pair: kernel {float(out[0])}, plain "
        f"{float(ref[0])}")
    check(bool(torch.isnan(out).all() and torch.isnan(ref).all()),
          "a coincident pair must give NaN in the kernel and in plain")


def worklist_checks(k4c, anm, gen, main, phase):
    """Phase 10 beyond the plain comparisons: K2 against K1 on the 1k4c
    inputs, an empty work list, and K2 with a per-pose receptor at the
    1ppe shape.  Returns the max error against plain."""
    import torch

    from lightdock_tpu_torch.ops import dfire_pairs as dp

    args, kwargs = main
    k2 = dp.dfire_pairs_worklist(*args, **kwargs)
    k1 = dp.dfire_pairs(*args, **kwargs)
    err = float((k2[0] - k1[0]).abs().max())
    close = bool(torch.allclose(k2[0], k1[0], rtol=RTOL, atol=ATOL))
    flags = torch.equal(k2[1], k1[1]) and torch.equal(k2[2], k1[2])
    say(f"phase {phase}: {k4c.label} K2 against K1 on the same inputs: max|raw "
        f"diff| {err:.3e} (allclose {close}), interface flags equal {flags}")
    check(close and flags, "K2 disagrees with K1")

    # Every pose unmoved: no active chunk, an empty list.
    moved = torch.zeros(N_POSES, dtype=torch.bool, device="cuda")
    args0, kwargs0 = k4c.energy_fn.kernel_args(k4c.tp, *k4c.pose(N_POSES), moved)
    n_active = int(dp.worklist(args0[3])[1])
    err0 = compare(k4c, args0, kwargs0, phase, f"G={N_POSES} every pose unmoved")
    out0 = dp.dfire_pairs_worklist(*args0, **kwargs0)
    empty = not (out0[0].any() or out0[1].any() or out0[2].any())
    prev = torch.rand(N_POSES, generator=gen, device="cuda") * 10 - 5
    scores = k4c.energy_fn(k4c.tp, *k4c.pose(N_POSES), moved=moved, prev_scoring=prev)
    kept = torch.equal(scores, prev)
    say(f"phase {phase}: {k4c.label} every pose unmoved: n_active {n_active}, "
        f"zero sums and no flags {empty}, scores equal prev_scoring {kept}")
    check(n_active == 0 and empty and kept, "the empty work list is not empty")

    # A per-pose receptor (receptor ANM) at the 1ppe shape.
    g = torch.Generator(device="cuda").manual_seed(11)
    moved = torch.rand(N_POSES, generator=g, device="cuda") < 0.6
    for gate in (None, moved):
        a, kw = anm.energy_fn.kernel_args(anm.tp, *anm.pose(N_POSES), gate)
        check(a[0].shape[0] == N_POSES, "the 1ppe ANM receptor is not per pose")
        err = max(err, compare(anm, a, kw, phase, f"G={N_POSES} per-pose receptor "
                               f"moved_gate={gate is not None}",
                               dp.dfire_pairs_worklist, dp.dfire_pairs_worklist_plain))
    return max(err, err0)


def worklist_timing(k4c, main, card, phase):
    """K2 a call (CUDA events), its three device passes alone
    (torch.profiler over 20 calls), and K1 on the same inputs.  Returns
    (K2 ms, K1 ms)."""
    from lightdock_tpu_torch.ops import dfire_pairs as dp

    args, kwargs = main
    k2_ms = cuda_ms(lambda: dp.dfire_pairs_worklist(*args, **kwargs), 50)
    k1_ms = cuda_ms(lambda: dp.dfire_pairs(*args, **kwargs), 50)
    _, dev, _ = device_profile(
        lambda: [dp.dfire_pairs_worklist(*args, **kwargs) for _ in range(20)])
    parts = {}
    for name in ("compact_tiles_kernel", "dfire_pairs_worklist_kernel", "sum_rows_kernel"):
        us = [e.time_range.elapsed_us() for e in dev if name in e.name]
        parts[name] = (f"{sum(us) / len(us) / 1e3:.4f} ms" if us
                       else "not measured (no device events)")
    say(f"phase {phase}: [{card}] {k4c.label} at G={N_POSES}: K2 {k2_ms:.4f} ms "
        f"a call, K1 on the same inputs {k1_ms:.4f} ms; K2's passes alone: "
        f"compaction {parts['compact_tiles_kernel']}, pairs "
        f"{parts['dfire_pairs_worklist_kernel']}, second pass "
        f"{parts['sum_rows_kernel']}")
    return k2_ms, k1_ms


def active_share(path, phase):
    """The step-1 active share of tile pairs on the path (every pose
    scores at step 1): n_active of n_r n_l."""
    from lightdock_tpu_torch.ops import dfire_pairs as dp

    args, _ = path.energy_fn.kernel_args(path.tp, *path.pose(N_POSES))
    act = args[3]
    n_tiles = act.shape[0] * act.shape[1]
    n_active = int(dp.worklist(act)[1])
    say(f"phase {phase}: {path.label}: step 1 active tile pairs {n_active} of "
        f"{n_tiles} ({n_active / n_tiles:.4f}), active chunk-tiles "
        f"{int(act.sum())} of {act.numel()} ({int(act.sum()) / act.numel():.4f})")
    check(0 < n_active < n_tiles, f"{path.label}: {n_active} of {n_tiles} tile "
          "pairs active at step 1; the work list would be a no-op")


def v1_kernel_cases(path, phase, gen, rng):
    """K4 or K5 against plain at the path's shapes (G=200 and 37, with and
    without the moved gate), on clustered poses with culled tile-poses
    (with and without interface flags) and, for K4, with the step tables in
    bfloat16; two launches must be bit-equal.  Returns the max error and
    the ungated G=200 call."""
    import numpy as np
    import torch

    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4

    max_err, main = 0.0, None
    for n in (N_POSES, 37):
        for gated in (False, True):
            moved = (torch.rand(n, generator=gen, device="cuda") < 0.6) if gated else None
            args, kwargs = path.energy_fn.kernel_args(path.tp, *path.pose(n), moved)
            max_err = max(max_err, compare(path, args, kwargs, phase,
                                           f"G={n} moved_gate={gated}"))
            if n == N_POSES and not gated:
                main = (args, kwargs)
    # Poses clustered in groups of 16, up to 45 A from the receptor: the
    # box cull zeroes some tile-poses' bits.
    n_groups = -(-N_POSES // 16)
    t_far = (np.repeat(rng.uniform(-45, 45, (n_groups, 3)), 16, axis=0)[:N_POSES]
             + rng.uniform(-3, 3, (N_POSES, 3)))
    args, kwargs = path.energy_fn.kernel_args(path.tp, *path.pose(N_POSES, t_far))
    act = args[-2]
    check(0 < int(act.sum()) < act.numel(),
          f"{path.label}: clustered poses culled {act.numel() - int(act.sum())} of "
          f"{act.numel()} tile-poses")
    for need_iface in (True, False):
        max_err = max(max_err, compare(path, args, dict(kwargs, need_iface=need_iface),
                                       phase, f"G={N_POSES} clustered need_iface={need_iface}"))
    if path.kernel is k4.dfire_pairs_v1:
        a, kw = main
        b16 = a[:2] + (a[2].to(torch.bfloat16),) + a[3:]
        max_err = max(max_err, compare(path, b16, kw, phase,
                                       f"G={N_POSES} bfloat16 step tables"))
        max_err = max(max_err, k4_edges(phase))
    again = path.kernel(*main[0], **main[1])
    first = path.kernel(*main[0], **main[1])
    check(torch.equal(again[0], first[0]), f"{path.label}: sums differ between runs")
    return max_err, main


def k4_edges(phase):
    """K4, rigid and per-pose receptor, against plain on pairs at every bin
    edge and within ``EDGE_ULPS`` ulps either side (the step-table form of
    ``standin.bin_edge_case``): sums and flags exactly equal.  Returns the
    max error."""
    import types

    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4

    err = 0.0
    path = types.SimpleNamespace(label=f"bin edges +-{EDGE_ULPS} ulps")
    for per_pose in (False, True):
        args, kwargs = standin.bin_edge_case("cuda", per_pose=per_pose, ulps=EDGE_ULPS).k4
        err = max(err, compare(path, args, kwargs, phase, f"G={args[1].shape[0]} per-pose "
                               f"receptor {per_pose}", k4.dfire_pairs_v1,
                               k4.dfire_pairs_v1_plain))
        out = k4.dfire_pairs_v1(*args, **kwargs)
        ref = k4.dfire_pairs_v1_plain(*args, **kwargs)
        check(all(torch.equal(a, b) for a, b in zip(out, ref)),
              f"K4 at the bin edges is not exactly plain (per pose {per_pose})")
    return err


def bound_v1(main, out, flops_per_pair):
    """(bound_ms, bound_by) of one K4 or K5 call, as :func:`bound` counts
    them, over the real pair-poses of this call's active tile-poses: its
    tensors once (for K4 the step tables included) over the HBM rate,
    ``flops_per_pair`` f32 operations a pair-pose over the f32 peak."""
    args, _ = main
    t_bytes = nbytes_once(main, out) / PEAK_BYTES * 1e3
    t_ops = pair_poses(main, args[-2], chunks=False) * flops_per_pair / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def farm_kernel_cases(runner, phase, label, kernel, plain):
    """A farm's kernel against its plain version on the farm's step-1
    inputs: all S x G poses in one call, in the order the energy path hands
    them over (Morton order of the translation; moved poses first under the
    gate), with and without the moved gate.  Returns the max error and
    the ungated call."""
    import types

    import torch

    from lightdock_tpu_torch.ops.cull import morton_key

    runner.reset()
    st = runner.states
    n = st.t.shape[0] * st.t.shape[1]
    pose = [x.reshape(n, *x.shape[2:]) for x in (st.t, st.q, st.a_rec, st.a_lig)]
    path = types.SimpleNamespace(label=label, kernel=kernel, plain=plain)
    gen = torch.Generator(device=runner.device).manual_seed(13)

    def inputs(moved=None):
        key = morton_key(pose[0])
        if moved is not None:
            key = key + torch.logical_not(moved).to(torch.int64) * (1 << 32)
        order = torch.sort(key, stable=True).indices
        return runner.energy_fn.kernel_args(
            runner.params, *(x[order] for x in pose),
            None if moved is None else moved[order])

    max_err, main = 0.0, None
    for gated in (False, True):
        moved = (torch.rand(n, generator=gen, device=runner.device) < 0.6) if gated else None
        args, kwargs = inputs(moved)
        max_err = max(max_err, compare(path, args, kwargs, phase,
                                       f"G={n} step-1 inputs moved_gate={gated}",
                                       atol=REORDER_ATOL))
        main = main or (args, kwargs)
    return max_err, main


def farm_phases(card, counters, occ):
    """Phases 16 and 17: the 32-swarm farm in the kernel mode against single
    runs and K1 against plain on its inputs, K1 a call on them with its
    bound, registers and resident warps (``occ``), the farm's poses/s and
    profile, then 4 swarms in the v1 mode and K4 against plain on theirs.
    Returns K1's and K4's max errors, the farm's step-1 scores (S, G) and
    its poses/s."""
    import numpy as np
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.engine.runner import GsoTorchRunner
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4
    from lightdock_tpu_torch.parallel.farm import SwarmFarmRunner

    n_all = FARM_SWARMS * N_POSES
    params, pos, _ = standin.toy_system(*DFIRE_ATOMS, n_all)
    swarms = [pos[i * N_POSES:(i + 1) * N_POSES] for i in range(FARM_SWARMS)]

    def farm(p, positions, mode, root):
        return SwarmFarmRunner(p, positions, list(range(len(positions))), SEED,
                               use_anm=False, anm_rec=0, anm_lig=0,
                               dtype=torch.float32, output_root=root,
                               energy_mode=mode, device="cuda")

    label = f"farm {FARM_SWARMS} x {N_POSES} 1ppe DFIRE"
    expected = {f"gso_{s}.out" for s in [1] + list(range(10, STEPS + 1, 10))}
    with tempfile.TemporaryDirectory() as root:
        runner = farm(params, swarms, "kernel", root)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(STEPS, SEGMENT)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        dirs = sorted(q.name for q in pathlib.Path(root).iterdir())
        snaps_ok = all({q.name for q in (pathlib.Path(root) / d).glob("gso_*.out")}
                       == expected for d in dirs)
        step1 = np.stack([np.load(pathlib.Path(root) / f"swarm_{i}" / "gso_1.out.npz")["scoring"]
                          for i in range(FARM_SWARMS)])
        texts = {(i, s): (pathlib.Path(root) / f"swarm_{i}" / f"gso_{s}.out").read_text()
                 for i in (0, FARM_SWARMS - 1) for s in (1, FARM_SINGLE_STEPS)}
    say(f"phase 16: {label}: {STEPS} steps in {run_s:.3f} s (first run, with "
        f"snapshots); kernel launches {launches}; {len(dirs)} swarm directories, "
        f"11 snapshots each {snaps_ok}; final scores min "
        f"{float(final.scoring.min()):.6f} max {float(final.scoring.max()):.6f}")
    check(launches["dfire_pairs"] == STEPS and sum(launches.values()) == STEPS,
          f"{label}: kernel launches {launches} in {STEPS} steps")
    check(dirs == sorted(f"swarm_{i}" for i in range(FARM_SWARMS)) and snaps_ok,
          f"{label}: swarm directories {dirs[:4]}... or their snapshots")
    check(tuple(final.scoring.shape) == (FARM_SWARMS, N_POSES), "farm scores misshapen")
    for name, x in final._asdict().items():
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"{label}: non-finite {name}")
    k1_err, farm_main = farm_kernel_cases(runner, 16, label, dp.dfire_pairs,
                                          dp.dfire_pairs_plain)
    out = dp.dfire_pairs(*farm_main[0], **farm_main[1])
    farm_bound = bound(farm_main, out)
    farm_k1_ms = cuda_ms(lambda: dp.dfire_pairs(*farm_main[0], **farm_main[1]), 20)
    say(f"phase 16: [{card}] {label}: K1 on the {n_all} step-1 poses {farm_k1_ms:.4f} ms "
        f"a call, bound {farm_bound[0]:.4f} ms ({farm_bound[1]})")

    # Timing, which also keeps the first steps' neighbour counts.
    timer = farm(params, swarms, "kernel", None)
    times, outs = [], None
    for _ in range(5):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = timer.run_segmented(STEPS, STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    say(f"phase 16: [{card}] {label}: {STEPS} GSO steps x {n_all} poses: min of 5 "
        f"{best:.4f} s = {n_all * STEPS / best:.1f} poses/s "
        f"({best / STEPS * 1e3:.3f} ms a step; all: {', '.join(f'{x:.4f}' for x in times)})")
    check(all(math.isfinite(x) for x in times), "farm timing failed")
    farm_nn = outs.num_neighbors[:FARM_SINGLE_STEPS].cpu()
    occupancy_report(16, card, f"{label}, K1 at {n_all} poses", dp.dfire_pairs,
                     farm_main, occ)

    # Swarms 0 and 31 alone, from the same positions.
    for i in (0, FARM_SWARMS - 1):
        with tempfile.TemporaryDirectory() as out_dir:
            single = GsoTorchRunner(params, swarms[i], SEED, use_anm=False, anm_rec=0,
                                    anm_lig=0, output_directory=out_dir,
                                    dtype=torch.float32, device="cuda")
            _, souts = single.run(FARM_SINGLE_STEPS)
            same_text = {s: (pathlib.Path(out_dir) / f"gso_{s}.out").read_text() == texts[(i, s)]
                         for s in (1, FARM_SINGLE_STEPS)}
        ours = souts.scoring[0]
        theirs = torch.as_tensor(step1[i], device="cuda")
        err = float((ours - theirs).abs().max())
        close = bool(torch.allclose(ours, theirs, rtol=RTOL, atol=ATOL))
        nn_same = sum(bool(torch.equal(souts.num_neighbors[k].cpu(), farm_nn[k, i]))
                      for k in range(FARM_SINGLE_STEPS))
        say(f"phase 16: {label}: swarm {i} alone: step-1 scores max|diff| {err:.3e} "
            f"(allclose {close}); neighbour counts equal on {nn_same} of "
            f"{FARM_SINGLE_STEPS} steps; gso_1 text identical {same_text[1]}, "
            f"gso_{FARM_SINGLE_STEPS} text identical {same_text[FARM_SINGLE_STEPS]}")
        check(close, f"{label}: swarm {i}'s step-1 scores differ from a single run")
    say(f"phase 16: {label}: " + profile_steps(
        timer.reset, lambda n: timer.run_segmented(n, n), card,
        ("dfire_pairs_kernel", "sum_rows_kernel")))

    # 17. Four swarms in the v1 mode (K4), against the kernel-mode farm.
    steps_params, _, _ = standin.toy_system(*DFIRE_ATOMS, n_all, dfire_mode="steps")
    v1 = farm(steps_params, swarms[:FARM_V1_SWARMS], "kernel_v1", None)
    for c in counters:
        c.launches = 0
    final, outs = v1.run_segmented(FARM_SINGLE_STEPS, FARM_SINGLE_STEPS)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    ours = outs.scoring[0]
    theirs = torch.as_tensor(step1[:FARM_V1_SWARMS], device="cuda")
    err = float((ours - theirs).abs().max())
    close = bool(torch.allclose(ours, theirs, rtol=RTOL, atol=ATOL))
    say(f"phase 17: farm {FARM_V1_SWARMS} x {N_POSES} kernel_v1: "
        f"{FARM_SINGLE_STEPS} steps, kernel launches {launches}; step-1 scores "
        f"against the kernel-mode farm max|diff| {err:.3e} (allclose {close})")
    check(launches["dfire_pairs_v1"] == FARM_SINGLE_STEPS
          and sum(launches.values()) == FARM_SINGLE_STEPS,
          f"v1 farm: kernel launches {launches} in {FARM_SINGLE_STEPS} steps")
    check(close and bool(torch.isfinite(final.scoring).all()),
          "v1 farm step-1 scores differ from the kernel-mode farm's")
    k4_err, _ = farm_kernel_cases(v1, 17, f"farm {FARM_V1_SWARMS} x {N_POSES} kernel_v1",
                                  k4.dfire_pairs_v1, k4.dfire_pairs_v1_plain)
    return k1_err, k4_err, step1, n_all * STEPS / best


def probe_table_entries(v, t):
    """Table entries one call of probe variant ``v`` must read on this
    run's inputs: for a gather, the distinct entries its indices pick; for
    a chain (and P1's tournament), its 21 entries of each table it walks;
    the touch one row, the row loop one row a rep; P2's slot none."""
    import torch

    from lightdock_tpu_torch.ops import probes as pops

    kw = v.kwargs
    kind = kw.get("mode", kw.get("form"))
    if "tab" not in v.args or kind == "slot":
        return 0
    tab = t[v.args["tab"]]
    reps = kw.get("reps", 1)
    if v.op == "select_reps":
        if kind != "tak":
            return tab.numel()
        d2 = t["d2"].reshape(t["d2"].shape[0], -1)
        thr = torch.tensor(kw["thresholds"], dtype=torch.float32, device=d2.device)
        lane = torch.arange(d2.shape[1], device=d2.device)
        return distinct((torch.bucketize(d2 + float(i) * 1e-6, thr, right=True)   # passed
                         * d2.shape[1] + lane for i in range(reps)), tab.numel())
    if v.op == "receptor_loop":
        r_count, n_slot, l_count = tab.shape
        if kind == "chain":
            return r_count * (pops.MAX_CHAIN + 1) * l_count
        lig, rec = t["lig"], t["rec"]
        lane = torch.arange(l_count, device=tab.device)

        def keys():
            for r in range(r_count):
                d = [lig[:, c, :] - rec[r, c] for c in range(3)]
                d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]      # (P, L)
                yield (r * n_slot + pops.slot(d2)) * l_count + lane
        return distinct(keys(), tab.numel())
    tabs = tab if tab.dim() == 3 else tab[None]
    n_slot, l_count = tabs.shape[1:]
    if kind == "touch":
        return l_count
    if kind == "row_loop":
        return reps * l_count
    if kind == "chain_loop":
        return reps * (pops.MAX_CHAIN + 1) * l_count
    lane = torch.arange(l_count, device=tab.device)
    x = t[v.args["x"]] if "x" in v.args else None
    if kind == "bare":
        slots = [t[v.args["idx"]].long().clamp(0, n_slot - 1)]
    elif kind == "slot_gather":
        slots = [pops.slot(x)]
    elif kind == "static_loop":
        slots = [pops.slot(x + float(r)) for r in range(reps)]
    elif kind == "slice_loop":
        slots = [r * n_slot + pops.slot(x + float(r)) for r in range(reps)]
    else:   # parity_loop
        slots = [r * n_slot + (pops.trunc(x) + r % 2).clamp(0, n_slot - 1).long()
                 for r in range(reps)]
    return distinct((k * l_count + lane for k in slots), tabs.numel())


def distinct(keys, size):
    """How many distinct values in [0, size) the tensors ``keys`` hold."""
    import torch

    seen = None
    for k in keys:
        if seen is None:
            seen = torch.zeros(size, dtype=torch.bool, device=k.device)
        seen[k.reshape(-1)] = True
    return int(seen.sum())


def probe_bound(v, t, out):
    """(bound_ms, bound_by) of one probe variant's call: its output and
    the operands its function reads once (of a table the entries of
    :func:`probe_table_entries`, of rec the column the scalar loop reads)
    over the HBM rate; its elements times ``PROBE_OPS`` over the peak of
    its type outside the tensor cores."""
    import torch

    kw = v.kwargs
    kind = kw.get("mode", kw.get("form"))
    nbytes = out.numel() * out.element_size()
    for arg, key in v.args.items():
        x = t[key]
        if arg == "tab":
            nbytes += probe_table_entries(v, t) * x.element_size()
            continue
        if v.op == "gather_form" and arg == "rec":
            x = x[:kw["reps"], 0]
        nbytes += x.numel() * x.element_size()
    if v.op == "select_reps":
        elements = t["d2"].numel() * kw["reps"]
    elif v.op == "receptor_loop":
        elements = out.numel() * t["rec"].shape[0]
    else:
        elements = out.numel() * kw["reps"]
    peak = PEAK_BF16 if v.dtype == torch.bfloat16 else PEAK_F32
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = elements * PROBE_OPS[(v.op, kind)] / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def probe_library(v, t):
    """The one PyTorch call that computes a variant's function, or None."""
    import torch

    kind = v.kwargs.get("form")
    if kind == "bare":
        idx = t[v.args["idx"]].long()
        return lambda: torch.gather(t[v.args["tab"]], 0, idx)
    if kind == "sqrt":
        return lambda: torch.sqrt(t["x"])
    if kind == "touch":
        row = t[v.args["tab"]][v.kwargs["row"], 0:1, :]
        return lambda: t["x"] + row
    return None


def probe_phase(card, probes_lib):
    """Phase 18: every probe variant through the entry point on the card,
    against its plain version, timed; returns its records.  ``probes_lib``
    is the built ``csrc/probes.cu``, whose P1 kernel's occupancy and SASS
    are reported."""
    import torch

    from lightdock_tpu_torch import probes
    from lightdock_tpu_torch.ops import probes as pops

    counters = (pops.select_reps, pops.receptor_loop, pops.gather_form)
    dev = probes.resolve_device("cuda")
    records, results, timed, wrapper_ms = [], [], [], {}
    t_phase = time.perf_counter()
    for pid in sorted(probes.SCRIPTS):
        mod = probes.load(pid)
        arrays = mod.inputs()
        say(f"phase 18: [{card}] {pid} ({probes.SCRIPTS[pid]}.py)")
        outs = {}
        for v in mod.variants(arrays):
            name = f"{pid}.{v.name}"
            for c in counters:
                c.launches = 0
            res = probes.run_variant(pid, v, arrays, dev)
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
            say(f"phase 18: {res.line()}")
            ours = launches[v.op]   # one call, the warm-up and the timed calls
            check(ours == 2 + probes.TIMED_CALLS and sum(launches.values()) == ours,
                  f"{name}: launches {launches} in its run")
            results.append(res)

            t = res.inputs
            out = v(t)
            ref = v.plain(t)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and out.dtype == ref.dtype
                  and bool(torch.isfinite(out.float()).all()),
                  f"{name}: kernel output {tuple(out.shape)} {out.dtype} not finite / shaped")
            err = float((out.float() - ref.float()).abs().max())
            same = torch.equal(out, ref) and torch.equal(res.out, out)
            again = torch.equal(v(t), out)
            note = ""
            if pid in ("P4", "P5", "P6"):
                cpu = v.plain(v.tensors(arrays, "cpu"))
                note = f", equal to plain on the CPU {torch.equal(out.cpu(), cpu)}"
                same = same and torch.equal(out.cpu(), cpu)
            say(f"phase 18: {name} kernel against plain on the card: max|diff| {err:.3e}, "
                f"bit-equal {same}, two launches bit-equal {again}{note}")
            check(same and again, f"{name}: kernel disagrees with its plain version")
            outs[v.name] = out
            timed.append((name, v, t))
            plain_ms = cuda_ms(lambda: v.plain(t), PROBE_PLAIN_CALLS.get(pid, 5))
            lib = probe_library(v, t)
            lib_ms, lib_note = None, "none"
            if lib is not None:
                lib_ms = cuda_ms(lib, 20)
                lib_note = (f"{lib_ms:.4f} ms (max|diff| from the kernel "
                            f"{float((lib() - out).abs().max()):.3e})")
            if lib is not None or pid == "P1":
                # The wrapper called as the PyTorch call is, without the
                # entry point's Variant between.
                wrap, kw = getattr(pops, v.op), {k: t[a] for k, a in v.args.items()}
                wrapper_ms[name] = cuda_ms(lambda: wrap(**kw, **v.kwargs), 20)
            bnd = probe_bound(v, t, out)
            say(f"phase 18: [{card}] {name}: kernel {res.ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bnd[0]:.6f} ms ({bnd[1]}), PyTorch call {lib_note}, launches {ours}")
            records.append(record(name, "lightdock_tpu_torch/csrc/probes.cu",
                                  PROBE_REPLACES[pid], ours, err, res.ms, plain_ms, bnd, lib_ms))
        if pid == "P1":
            check(torch.equal(outs["tak"], outs["tourn"]), "P1: tak and tourn differ")
    say(f"phase 18: [{card}] {probes.ab_line(results)}")
    receptor_loop_compact()
    dev_us = probe_device_times(timed, card)
    parts = []
    for rec in records:
        if rec["library_ms"] is not None:
            name, lib_ms = rec["name"], rec["library_ms"]
            us = dev_us.get(name)
            parts.append(f"{name} wrapper {wrapper_ms[name]:.4f} ms ({rec['ms']:.4f} through "
                         f"the entry point) against {lib_ms:.4f} ms "
                         f"({wrapper_ms[name] / lib_ms:.2f}x), device "
                         + ("not measured" if us is None else f"{us:.3f} us"))
    say(f"phase 18: [{card}] wrapper beside its one PyTorch call (CUDA events, 20 calls): "
        + "; ".join(parts))
    p1_report(card, probes_lib, records, dev_us, wrapper_ms, timed)
    say(f"phase 18: {len(records)} probe variants in {time.perf_counter() - t_phase:.1f} s")
    return records


def receptor_loop_compact():
    """Phase 18: the receptor loop's kernel against its plain version, bit
    for bit, at P2's and P3's shapes with coordinates from uniform(-6, 6),
    where the pairs cross every slot, chain threshold and the cutoff (the
    scripts' geometry almost never leaves slot 31); one line a mode."""
    import torch

    from lightdock_tpu_torch import probes
    from lightdock_tpu_torch.ops import probes as pops

    p2 = probes.load("P2")
    cases = []
    for pid in ("P2", "P3"):
        arrays = probes.load(pid).inputs(span=p2.COMPACT_SPAN)
        cases.append((pid, {k: torch.as_tensor(a, dtype=torch.float32, device="cuda")
                            for k, a in arrays.items()}))
    for mode in pops.LOOP_MODES:
        parts = []
        for pid, t in cases:
            args = (t["lig"], t["rec"], t["tab"], p2.THRESH, mode)
            out, ref = pops.receptor_loop(*args), pops.receptor_loop_plain(*args)
            torch.cuda.synchronize()
            same = torch.equal(out, ref) and bool(torch.isfinite(out).all())
            err = float((out - ref).abs().max())
            parts.append(f"{pid}'s shapes {tuple(out.shape)} x {t['rec'].shape[0]} "
                         f"max|diff| {err:.3e}, bit-equal {same}")
            check(same, f"receptor_loop {mode} at {pid}'s shapes, uniform(-6, 6): kernel "
                        f"disagrees with its plain version (max|diff| {err:.3e})")
        say(f"phase 18: receptor_loop {mode} at the compact geometry against plain: "
            + "; ".join(parts))


def probe_device_times(timed, card, calls=10):
    """Each probe variant's device time a call: the sum of the device
    events of its ``calls`` calls over ``calls``, from one torch.profiler
    window that runs the variants one after another with a fill kernel
    between two variants to part their events.  Beside its work: for the
    small forms the wrapper's call time is the host's, not the card's.
    Returns {variant: device us a call}, empty when not measured."""
    import torch

    sep = torch.zeros(1, device="cuda")

    def pad():   # a profile's first and last device events may go unrecorded
        for _ in range(50):
            sep.zero_()
        torch.cuda.synchronize()

    def run_all():
        pad()
        for _, v, t in timed:
            sep.zero_()
            for _ in range(calls):
                v(t)
        pad()

    _, dev, _ = device_profile(run_all)
    groups, cur = [], None
    for e in sorted(dev, key=lambda e: e.time_range.start):
        if "FillFunctor" in e.name:
            if cur:
                groups.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    if len(groups) != len(timed):
        say(f"phase 18: [{card}] probe device times not measured: the profiler "
            f"parted {len(dev)} device events into {len(groups)} groups for "
            f"{len(timed)} variants")
        return {}
    kernels = {"select_reps": ("select_reps_kernel", "rep_sum_kernel"),
               "receptor_loop": ("receptor_loop_kernel",),
               "gather_form": ("gather_form_kernel", "gather_form_reps_kernel")}
    parts, dev_us = [], {}
    for (name, v, _), events in zip(timed, groups):
        names = kernels[v.op]
        check(all(any(k in e.name for k in names) for e in events),
              f"{name}: device events of another kernel {[e.name[:60] for e in events][:3]}")
        us = sum(e.time_range.elapsed_us() for e in events) / calls
        dev_us[name] = us
        expected = calls * (1 if v.op == "gather_form" else len(names))
        check(v.op != "select_reps" or len(events) == expected,
              f"{name}: {len(events)} device kernels in {calls} calls, {expected} expected")
        parts.append(f"{name} {us:.3f} us ({us * 1e3 / v.work:.5f} ns a pair; "
                     f"{len(events)} events, {expected} expected)")
    say(f"phase 18: [{card}] probe device time a call (torch.profiler, {calls} calls "
        "each): " + "; ".join(parts))
    return dev_us


def sass_loops(lib_path, pattern):
    """{template arguments: (instructions of its largest loop, {opcode:
    count} there)} of each function of the library at ``lib_path`` whose
    mangled name matches the regular expression ``pattern`` (its groups
    are the template arguments), from ``cuobjdump -sass``; None where
    cuobjdump is not found.  A loop is a backward branch; its instructions
    are those from the branch's target to the branch, NOPs not counted."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return None
    proc = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr.strip()[:300]}")
    found, key, instrs, labels = {}, None, [], {}

    def flush():
        if key is None:
            return
        addr = {a: i for i, (a, _) in enumerate(instrs)}
        best = (0, 0, -1)
        for i, (_, text) in enumerate(instrs):
            m = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?([.\w]+)\)?", text)
            if not m:
                continue
            target = m.group(1)
            j = labels.get(target, addr.get(int(target, 16) if target.startswith("0x") else -1))
            if j is not None and j <= i and i - j + 1 > best[0]:
                best = (i - j + 1, j, i)
        ops = {}
        for _, text in instrs[best[1]:best[2] + 1]:
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            if op != "NOP":
                ops[op] = ops.get(op, 0) + 1
        found[key] = (sum(ops.values()), ops)

    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            mk = re.search(pattern, m.group(1))
            key, instrs, labels = (mk.groups() if mk else None), [], {}
            continue
        if key is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(instrs)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2).strip()))
    flush()
    return found


def p1_report(card, probes_lib, records, dev_us, wrapper_ms, timed):
    """Phase 18: each P1 variant's device time a call, its wrapper ms, its
    bound, the SASS instructions its kernel issues an element-rep (the
    batch loop's instructions over the batch's 8 reps) and the time that
    takes at full issue (every SM's four schedulers issuing one 32-lane
    instruction a cycle at the card's maximum SM clock), its registers,
    local bytes and resident warps an SM."""
    import ctypes

    import torch

    from lightdock_tpu_torch.ops import probes as pops

    fn = probes_lib.lib.select_reps_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    mhz = float(proc.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 4 * 32 * mhz * 1e6   # lane-instructions a second at full issue
    loops = sass_loops(probes_lib.path, r"select_reps_kernelILb([01])ELi(\d)E")
    by_name = {rec["name"]: rec for rec in records}
    parts = []
    for name, v, t in timed:
        if v.op != "select_reps":
            continue
        bf16, mode = int(v.dtype == torch.bfloat16), pops.SELECT_MODES[v.kwargs["mode"]]
        blocks, regs, local = (ctypes.c_int() for _ in range(3))
        err = fn(bf16, mode, ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local))
        check(err == 0, f"select_reps_occupancy({bf16}, {mode}): CUDA error {err}")
        rec = by_name[name]
        elements = t["d2"].numel() * v.kwargs["reps"]
        loop = None if loops is None else loops.get((str(bf16), str(mode)))
        if loop is None:
            sass = "SASS not measured (no cuobjdump or no loop found)"
        else:
            per = loop[0] / 8   # a batch: a thread's 8 reps' terms and one run of 8 added
            top = sorted(loop[1].items(), key=lambda kv: -kv[1])[:8]
            sass = (f"{per:.2f} SASS instructions an element-rep ({loop[0]} in the batch "
                    f"loop: {', '.join(f'{op} {n}' for op, n in top)}), full issue "
                    f"{per * elements / rate * 1e6:.3f} us")
        us = dev_us.get(name)
        parts.append(f"{name} device {'not measured' if us is None else f'{us:.3f} us'}, "
                     f"wrapper {wrapper_ms[name]:.4f} ms, bound {rec['bound_ms']:.6f} ms "
                     f"({rec['bound_by']}), {sass}, {regs.value} registers, {local.value} B "
                     f"local, {blocks.value * 8} resident warps an SM")
    say(f"phase 18: [{card}] P1 ({sms} SMs at {mhz:.0f} MHz: {rate / 1e12:.2f} T "
        "lane-instructions/s at full issue): " + "; ".join(parts))


@contextlib.contextmanager
def working_directory(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def cli_run(counters, work, argv):
    """``lightdock_tpu_torch.cli.main(argv)`` in the working directory
    ``work``, every kernel count set to 0 just before and read just after;
    its standard output kept.  Returns (launches, seconds, output)."""
    import torch

    from lightdock_tpu_torch import cli

    out = io.StringIO()
    with working_directory(work):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    check(rc == 0, f"lightdock-tpu-torch {' '.join(map(str, argv))}: exit {rc}")
    return launches, seconds, out.getvalue()


def only(launches, name, n, label):
    """``n`` launches of kernel ``name`` and none of another."""
    check(launches[name] == n and sum(launches.values()) == n,
          f"{label}: kernel launches {launches}, expected {n} of {name} and no other")


def sidecar_scores(swarm_dir, step):
    import numpy as np
    with np.load(pathlib.Path(swarm_dir) / f"gso_{step}.out.npz") as z:
        return z["scoring"]


def snapshot_columns(path) -> int:
    line = pathlib.Path(path).read_text().splitlines()[1]
    return len(line[line.index("(") + 1:line.index(")")].split(","))


def text_resume_divergence(setup, pos, text_dir, sidecar_dir):
    """Phase 20's text resume against the resume from the sidecar, on the
    card: the state ``GsoTorchRunner.load_snapshot`` reads from
    ``text_dir``'s gso_10.out (no sidecar) against the sidecar's arrays in
    ``sidecar_dir``, each field within half its last written decimal (7
    for poses, 8 for luciferin and scores, 3 for vision) and one float32
    rounding; then both states stepped to 20 one step at a time.  Returns
    (held, max|diff| a field, per step (poses with |dscore| > ATOL,
    max|dscore|, poses with |dt| > 1e-4))."""
    import numpy as np
    import torch

    from lightdock_tpu_torch.engine.runner import GsoTorchRunner
    from lightdock_tpu_torch.simulation import load_simulation

    snap = f"swarm_0/gso_{CLI_SHORT_STEPS}.out"
    with working_directory(text_dir):
        sim = load_simulation(setup, pos, "dfire")
    params = sim.batch_params(np.float32)
    runners = []
    for resume_dir, step in ((text_dir, CLI_SHORT_STEPS), (sidecar_dir, None)):
        r = GsoTorchRunner(params, sim.positions, sim.seed, sim.use_anm, sim.setup.anm_rec,
                           sim.setup.anm_lig, dtype=torch.float32, device="cuda")
        r.load_snapshot(resume_dir / snap, step)
        runners.append(r)
    text, side = runners
    decimals = {"t": 7, "q": 7, "a_rec": 7, "a_lig": 7, "luciferin": 8, "vision": 3,
                "scoring": 8}
    held, loaded = True, {}
    for name, d in decimals.items():
        a = getattr(text.state, name).double().cpu().numpy()
        b = getattr(side.state, name).double().cpu().numpy()
        if a.size:
            diff = np.abs(a - b)
            loaded[name] = float(f"{diff.max():.3e}")
            held &= bool((diff <= 0.5 * 10.0 ** -d + 2.0 ** -23 * np.abs(b)).all())
    held &= bool(torch.equal(text.state.num_neighbors, side.state.num_neighbors))
    parted = []
    for step in range(CLI_SHORT_STEPS + 1, 2 * CLI_SHORT_STEPS + 1):
        a, _ = text.run(step)
        b, _ = side.run(step)
        dscore = (a.scoring - b.scoring).abs()
        dt = (a.t - b.t).abs().amax(dim=1)
        parted.append((int((dscore > ATOL).sum()), float(f"{float(dscore.max()):.3e}"),
                       int((dt > 1e-4).sum())))
    return held, loaded, parted


def cli_path_phase(card, counters):
    """Phase 19: the command line on the 1ppe-shaped DFIRE files, 100 steps,
    against ``GsoTorchRunner`` built from ``load_simulation`` on the same
    files."""
    import numpy as np
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.engine.runner import GsoTorchRunner
    from lightdock_tpu_torch.simulation import load_simulation

    label = f"CLI 1ppe DFIRE ({DFIRE_ATOMS[0]} x {DFIRE_ATOMS[1]} atoms, {N_POSES} glowworms)"
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        setup, (pos,) = standin.write_complex(work, "dfire", *DFIRE_ATOMS, N_POSES, seed=SEED)
        metrics = work / "metrics.jsonl"
        launches, run_s, out = cli_run(counters, work, [setup, pos, STEPS, "dfire",
                                                        "--metrics", metrics])
        swarm = work / "swarm_0"
        expected = {f"gso_{s}.out" for s in [1] + list(range(10, STEPS + 1, 10))}
        snaps = {q.name for q in swarm.glob("gso_*.out")}
        sidecars = {q.name[:-4] for q in swarm.glob("gso_*.out.npz")}
        events = [json.loads(ln) for ln in metrics.read_text().splitlines()]
        summary = events[-1]
        say(f"phase 19: {label}: `lightdock-tpu-torch setup.json initial_positions_0.dat "
            f"{STEPS} dfire --metrics` in {run_s:.3f} s (parsing and model building "
            f"included); kernel launches {launches}; {len(snaps)} snapshots, "
            f"{len(sidecars)} sidecars; its output ends: "
            + " | ".join(out.strip().splitlines()[-2:]))
        only(launches, "dfire_pairs", STEPS, label)
        check(snaps == expected and sidecars == expected, f"{label}: snapshots {sorted(snaps)}")
        scores = [sidecar_scores(swarm, s) for s in (1, STEPS)]
        check(all(np.isfinite(x).all() and x.shape == (N_POSES,) for x in scores),
              f"{label}: non-finite or misshapen scores")
        check([e["event"] for e in events]
              == ["segment", "trace"] * (STEPS // SEGMENT) + ["summary"]
              and summary["total_poses_scored"] == N_POSES * STEPS
              and summary["backend"] == "cuda" and summary["poses_per_s"] > 0,
              f"{label}: metrics events {[e['event'] for e in events]}, summary {summary}")

        t0 = time.perf_counter()
        with working_directory(work):
            sim = load_simulation(setup, pos, "dfire")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = sim.batch_params(np.float32)
        params_s = time.perf_counter() - t0

        def runner(out_dir=None):
            return GsoTorchRunner(params, sim.positions, sim.seed, sim.use_anm,
                                  sim.setup.anm_rec, sim.setup.anm_lig,
                                  output_directory=out_dir, dtype=torch.float32,
                                  device="cuda")

        direct = runner(str(work / "runner"))
        direct.run_segmented(STEPS, SEGMENT)
        ours = torch.as_tensor(scores[0])
        theirs = torch.as_tensor(sidecar_scores(work / "runner", 1))
        err = float((ours - theirs).abs().max())
        close = bool(torch.allclose(ours, theirs, rtol=RTOL, atol=ATOL))
        same = ((swarm / f"gso_{STEPS}.out").read_text()
                == (work / "runner" / f"gso_{STEPS}.out").read_text())
        timer, times = runner(), []
        for _ in range(5):
            timer.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.run(STEPS)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
    say(f"phase 19: {label}: step-1 scores against GsoTorchRunner on the same files "
        f"max|diff| {err:.3e} (allclose {close}); gso_{STEPS}.out byte-identical "
        f"to the runner's {same}")
    say(f"phase 19: [{card}] {label}: poses/s: the CLI's --metrics summary "
        f"{summary['poses_per_s']} (segments with snapshots and sidecars, "
        f"{summary['total_seconds']} s of {run_s:.3f} s); GsoTorchRunner.run({STEPS}) on "
        f"the same files, min of 5 {best:.4f} s = {N_POSES * STEPS / best:.1f} "
        f"(all: {', '.join(f'{x:.4f}' for x in times)}); once a run: "
        f"load_simulation (PDB files, setup.json, models, positions) {load_s * 1e3:.1f} ms, "
        f"batch_params {params_s * 1e3:.1f} ms")
    check(close, f"{label}: step-1 scores differ from the runner's")


def cli_rest_phase(card, counters):
    """Phase 20: the command line's DNA + ANM path, the multi-swarm glob and
    --resume auto, kernel_v1, the text resume, --profile and
    ``python -m lightdock_tpu_torch.cli``.  Returns the resumed glob's
    poses/s (its ``Throughput`` line)."""
    import numpy as np

    from lightdock_tpu_torch import standin

    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        # DNA with 10 + 10 ANM modes on the 1azp-shaped files: K3.
        dna = work / "dna"
        setup, (pos,) = standin.write_complex(dna, "dna", *DNA_ATOMS, N_POSES,
                                              num_anm=DNA_ANM, seed=SEED)
        label = f"CLI 1azp DNA + ANM ({DNA_ATOMS[0]} x {DNA_ATOMS[1]}, {DNA_ANM} + {DNA_ANM} modes)"
        launches, run_s, _ = cli_run(counters, dna, [setup, pos, CLI_DNA_STEPS, "dna"])
        last = dna / "swarm_0" / f"gso_{CLI_DNA_STEPS}.out"
        cols = snapshot_columns(last)
        finite = bool(np.isfinite(sidecar_scores(dna / "swarm_0", CLI_DNA_STEPS)).all())
        say(f"phase 20: {label}: {CLI_DNA_STEPS} steps in {run_s:.3f} s; kernel "
            f"launches {launches}; gso_{CLI_DNA_STEPS}.out with {cols} pose columns; "
            f"finite scores {finite}")
        only(launches, "elec_vdw_pairs", CLI_DNA_STEPS, label)
        check(cols == 7 + 2 * DNA_ANM and finite, f"{label}: {cols} columns, finite {finite}")
        # The same files in --energy-mode kernel_v1: K5.
        dna_v1 = work / "dna_v1"
        dna_v1.mkdir()
        label += " --energy-mode kernel_v1"
        launches, run_s, _ = cli_run(counters, dna_v1, [setup, pos, CLI_SHORT_STEPS, "dna",
                                                        "--energy-mode", "kernel_v1",
                                                        "--anm-dir", dna])
        finite = bool(np.isfinite(sidecar_scores(dna_v1 / "swarm_0", CLI_SHORT_STEPS)).all())
        say(f"phase 20: {label}: {CLI_SHORT_STEPS} steps in {run_s:.3f} s; kernel "
            f"launches {launches}; finite scores {finite}")
        only(launches, "elec_vdw_pairs_v1", CLI_SHORT_STEPS, label)
        check(finite, f"{label}: non-finite scores")

        # The multi-swarm glob, 32 x 200 on the 1ppe-shaped files, then
        # --resume auto, against an uninterrupted run.
        farm = work / "farm"
        setup, _ = standin.write_complex(farm, "dfire", *DFIRE_ATOMS, N_POSES,
                                         n_swarms=FARM_SWARMS, seed=SEED)
        glob = str(farm / "initial_positions_*.dat")
        label = f"CLI multi-swarm glob {FARM_SWARMS} x {N_POSES} 1ppe DFIRE"
        part, full = farm / "part", farm / "full"
        part.mkdir()
        full.mkdir()
        first, first_s, _ = cli_run(counters, part, [setup, glob, CLI_FARM_STEPS, "dfire"])
        resumed, resumed_s, out = cli_run(counters, part, [setup, glob, CLI_RESUMED_STEPS,
                                                           "dfire", "--resume", "auto"])
        whole, whole_s, _ = cli_run(counters, full, [setup, glob, CLI_RESUMED_STEPS, "dfire"])
        dirs = sorted(q.name for q in part.iterdir())
        a = np.stack([sidecar_scores(part / f"swarm_{i}", CLI_RESUMED_STEPS)
                      for i in range(FARM_SWARMS)])
        b = np.stack([sidecar_scores(full / f"swarm_{i}", CLI_RESUMED_STEPS)
                      for i in range(FARM_SWARMS)])
        err = float(np.abs(a - b).max())
        close = bool(np.allclose(a, b, rtol=RTOL, atol=ATOL)) and bool(np.isfinite(a).all())
        same = all((part / f"swarm_{i}" / f"gso_{CLI_RESUMED_STEPS}.out").read_text()
                   == (full / f"swarm_{i}" / f"gso_{CLI_RESUMED_STEPS}.out").read_text()
                   for i in range(FARM_SWARMS))
        say(f"phase 20: {label}: {CLI_FARM_STEPS} steps in {first_s:.3f} s, kernel "
            f"launches {first}; resumed to {CLI_RESUMED_STEPS} with --resume auto in "
            f"{resumed_s:.3f} s, kernel launches {resumed} ({out.strip().splitlines()[-1]}); "
            f"{len(dirs)} swarm directories; gso_{CLI_RESUMED_STEPS} scores against an "
            f"uninterrupted {CLI_RESUMED_STEPS}-step run ({whole_s:.3f} s, launches "
            f"{whole['dfire_pairs']}) max|diff| {err:.3e} (allclose {close}); every "
            f"gso_{CLI_RESUMED_STEPS}.out byte-identical {same}")
        only(first, "dfire_pairs", CLI_FARM_STEPS, label)
        only(resumed, "dfire_pairs", CLI_RESUMED_STEPS - CLI_FARM_STEPS, f"{label}, resumed")
        check(dirs == sorted(f"swarm_{i}" for i in range(FARM_SWARMS)),
              f"{label}: swarm directories {dirs[:4]}...")
        check(close, f"{label}: the resumed scores differ from the uninterrupted run's")
        glob_poses_s = float(out.strip().splitlines()[-1].split()[1])

        # kernel_v1 (K4), then the resume from its gso_10.out (K1): with
        # the sidecar, and from the text with the sidecar deleted; then
        # --profile, on the 1ppe-shaped files of swarm 0.
        pos = farm / "initial_positions_0.dat"
        v1 = farm / "v1"
        v1.mkdir()
        label = "CLI 1ppe DFIRE --energy-mode kernel_v1"
        launches, run_s, _ = cli_run(counters, v1, [setup, pos, CLI_SHORT_STEPS, "dfire",
                                                    "--energy-mode", "kernel_v1"])
        say(f"phase 20: {label}: {CLI_SHORT_STEPS} steps in {run_s:.3f} s (the step "
            f"tables built); kernel launches {launches}")
        only(launches, "dfire_pairs_v1", CLI_SHORT_STEPS, label)
        v1_sidecar = farm / "v1_sidecar"
        shutil.copytree(v1, v1_sidecar)
        (v1 / "swarm_0" / f"gso_{CLI_SHORT_STEPS}.out.npz").unlink()
        resume = ["--resume", f"swarm_0/gso_{CLI_SHORT_STEPS}.out",
                  "--resume-step", CLI_SHORT_STEPS]
        label = f"CLI --resume swarm_0/gso_{CLI_SHORT_STEPS}.out (text, no sidecar)"
        launches, run_s, _ = cli_run(counters, v1, [setup, pos, 2 * CLI_SHORT_STEPS,
                                                    "dfire", *resume])
        by_sidecar, side_s, _ = cli_run(counters, v1_sidecar, [setup, pos, 2 * CLI_SHORT_STEPS,
                                                               "dfire", *resume])
        text = sidecar_scores(v1 / "swarm_0", 2 * CLI_SHORT_STEPS)
        side = sidecar_scores(v1_sidecar / "swarm_0", 2 * CLI_SHORT_STEPS)
        loaded_ok, loaded, parted = text_resume_divergence(setup, pos, v1, v1_sidecar)
        say(f"phase 20: {label}: steps {CLI_SHORT_STEPS + 1}-{2 * CLI_SHORT_STEPS} in "
            f"{run_s:.3f} s; kernel launches {launches}; the state load_snapshot reads "
            f"from the text against the sidecar's, max|diff| {loaded} (within the text's "
            f"decimals {loaded_ok}); gso_{2 * CLI_SHORT_STEPS} scores against the resume "
            f"from the sidecar ({side_s:.3f} s, launches {by_sidecar}): "
            f"{int((np.abs(text - side) > ATOL).sum())} of {N_POSES} poses beyond {ATOL}, "
            f"max|diff| {float(np.abs(text - side).max()):.3e}; the two resumes stepped "
            f"by GsoTorchRunner, a step (poses with |dscore| > {ATOL}, max|dscore|, "
            f"poses with |dt| > 1e-4): {parted}")
        only(launches, "dfire_pairs", CLI_SHORT_STEPS, label)
        only(by_sidecar, "dfire_pairs", CLI_SHORT_STEPS, f"{label}, from the sidecar")
        check(loaded_ok, f"{label}: the state read from the text differs from the "
              f"sidecar's beyond the text's decimals: {loaded}")
        check(bool(np.isfinite(text).all()) and text.shape == (N_POSES,),
              f"{label}: non-finite or misshapen scores")
        prof = farm / "profile"
        prof.mkdir()
        launches, run_s, _ = cli_run(counters, prof, [setup, pos, CLI_SHORT_STEPS, "dfire",
                                                      "--profile"])
        trace = prof / "swarm_0" / "torch_trace.json"
        size = trace.stat().st_size if trace.exists() else 0
        say(f"phase 20: CLI --profile: {CLI_SHORT_STEPS} steps in {run_s:.3f} s; kernel "
            f"launches {launches}; {trace.name} {size} bytes")
        only(launches, "dfire_pairs", CLI_SHORT_STEPS, "CLI --profile")
        check(size > 0, "CLI --profile wrote no trace")

        # A process of its own: python -m lightdock_tpu_torch.cli.
        sub = farm / "subprocess"
        sub.mkdir()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lightdock_tpu_torch.cli", str(setup), str(pos),
             str(CLI_SHORT_STEPS), "dfire"], cwd=sub, capture_output=True, text=True,
            timeout=600, env={**os.environ, "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x])})
        sub_s = time.perf_counter() - t0
        say(f"phase 20: `python -m lightdock_tpu_torch.cli ... {CLI_SHORT_STEPS} dfire` in "
            f"a process of its own: exit {proc.returncode} in {sub_s:.3f} s; its output "
            "ends: " + " | ".join(proc.stdout.strip().splitlines()[-2:]))
        check(proc.returncode == 0 and (sub / "swarm_0" / f"gso_{CLI_SHORT_STEPS}.out").exists(),
              f"python -m lightdock_tpu_torch.cli exit {proc.returncode}: {proc.stderr[-2000:]}")
    return glob_poses_s


# -- phases 21-23: ranks of torch.distributed on the card --------------------

def pair_kernels():
    """The five pair kernels' wrappers, whose ``launches`` the phases count."""
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4
    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev
    from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5
    return (dp.dfire_pairs, dp.dfire_pairs_worklist, ev.elec_vdw_pairs,
            k4.dfire_pairs_v1, k5.elec_vdw_pairs_v1)


def rank_start(rank, world, phase):
    """A rank's start: the process group from the environment
    ``spawn_local`` set (NCCL where every rank has a card, else gloo: NCCL
    refuses two ranks on one device) and the rank's card, named
    explicitly.  Returns (backend, device)."""
    import torch

    from lightdock_tpu_torch.parallel.multihost import maybe_initialize_distributed

    cards = torch.cuda.device_count()
    check(cards > 0, f"phase {phase} rank {rank}: no CUDA device")
    backend = "nccl" if cards >= world else "gloo"
    maybe_initialize_distributed(backend, timeout=RANK_TIMEOUT)
    return backend, f"cuda:{rank % cards}"


def record_writes():
    """The paths of the snapshots this process writes from now on (the
    writer of ``parallel.multihost`` wrapped)."""
    from lightdock_tpu_torch.parallel import multihost

    written, write = [], multihost.write_gso_output

    def recorded(path, *args, **kwargs):
        written.append(str(path))
        return write(path, *args, **kwargs)

    multihost.write_gso_output = recorded
    return written


def score_floor(method) -> float:
    """``REORDER_ATOL`` on raw sums carried to scores: DFIRE's scale, and a
    bias that at most triples a score (a fraction of each side's restraints
    added)."""
    from lightdock_tpu_torch import constants as C
    return REORDER_ATOL * (C.DFIRE_SCALE if method == "dfire" else 1.0) * 3


def spawn(fn, world, *args):
    """``fn(rank, *args)`` on ``world`` ranks (``spawn_local``); a rank that
    fails fails the phase."""
    from lightdock_tpu_torch.parallel.multihost import spawn_local
    try:
        spawn_local(fn, world, *args)
    except Exception as exc:  # the child's own FAIL line is on stderr
        fail(f"{fn.__name__} on {world} ranks: {type(exc).__name__}: {exc}")


def sharded_swarm_rank(rank, out):
    """Phase 21 on one rank: one swarm, the receptor atoms over
    ``SHARD_RANKS`` ranks (``sharded.run_multi_swarm_2d_kernel`` on a
    (1, 2) mesh), for the 1ppe DFIRE system (100 steps, K1) and the 1azp
    DNA + ANM system (30 steps, K3 with a per-pose receptor)."""
    import numpy as np
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.engine.gso import swarms_step
    from lightdock_tpu_torch.engine.runner import GsoTorchRunner, make_energy
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev
    from lightdock_tpu_torch.parallel import sharded
    from lightdock_tpu_torch.parallel.mesh import make_mesh
    from lightdock_tpu_torch.parallel.multihost import (barrier, stack_swarm_states,
                                                        swarm_randoms)

    backend, device = rank_start(rank, SHARD_RANKS, 21)
    mesh = make_mesh(n_swarm=1, n_atoms=SHARD_RANKS, device=device)
    counters = pair_kernels()
    f32 = torch.float32
    result = {"backend": backend, "device": str(mesh.device), "coord": mesh.coord}
    cases = (("1ppe DFIRE", standin.toy_system(*DFIRE_ATOMS, N_POSES), STEPS,
              dp.dfire_pairs, dp.dfire_pairs_plain),
             ("1azp DNA + ANM", standin.toy_system(*DNA_ATOMS, N_POSES, num_anm=DNA_ANM,
                                                   method="dna"),
              SHARD_DNA_STEPS, ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain))
    for label, (params, pos, k), steps, kernel, plain in cases:
        label = f"{label} on rank {rank} of {SHARD_RANKS}"
        states = stack_swarm_states([pos], k > 0, k, k, f32, mesh.device)
        randoms = torch.as_tensor(swarm_randoms(SEED, steps, 1, N_POSES), dtype=f32,
                                  device=mesh.device)
        for c in counters:
            c.launches = 0
        final, outs = sharded.run_multi_swarm_2d_kernel(mesh, params, states, randoms)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        only(launches, kernel.__name__, steps, f"phase 21: {label}")
        for name, x in final._asdict().items():
            if x.is_floating_point():
                check(bool(torch.isfinite(x).all()), f"phase 21: {label}: non-finite {name}")
        # Step 1 against the single-GPU runner from the same positions.
        _, single = GsoTorchRunner(params, pos, SEED, k > 0, k, k, dtype=f32,
                                   device=mesh.device).run(1)
        step1 = float((outs.scoring[0, 0] - single.scoring[0]).abs().max())
        check(bool(torch.allclose(outs.scoring[0, 0], single.scoring[0], rtol=RTOL,
                                  atol=ATOL)),
              f"phase 21: {label}: step-1 scores differ from GsoTorchRunner's by {step1:.3e}")
        # The run's own poses at later steps, scored by the single-GPU kernel
        # energy: the poses a step scored are the previous step's output.
        tp, energy_fn = make_energy(params, "kernel", mesh.device, f32)
        along = {}
        for s in (x for x in SHARD_CHECK_STEPS if x <= steps):
            pose = [getattr(outs, f)[s - 2, 0] for f in ("t", "q", "a_rec", "a_lig")]
            ref = energy_fn(tp, *pose)
            ours = outs.scoring[s - 1, 0]
            along[s] = float((ours - ref).abs().max())
            check(bool(torch.allclose(ours, ref, rtol=RTOL, atol=score_floor(params.method))),
                  f"phase 21: {label}: step {s} scores differ from the single-GPU "
                  f"energy of the same poses by {along[s]:.3e}")
        # The kernel against its plain version on this rank's slice, at the
        # step-1 poses (after the counts were read).
        p_loc, shard_fn = sharded.make_kernel_atom_sharded_fns(params, mesh)
        args, kwargs = shard_fn.kernel_args(p_loc, *(x[0] for x in (
            states.t, states.q, states.a_rec, states.a_lig)))
        got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
        plain_err = float((got[0] - want[0]).abs().max())
        check(bool(torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL))
              and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])
                      if a is not None),
              f"phase 21: {label}: {kernel.__name__} differs from plain on the shard")
        torch.save({f: x.cpu() for f, x in final._asdict().items()},
                   out / f"{'dfire' if kernel is dp.dfire_pairs else 'dna'}_rank{rank}.pt")
        result[label] = dict(launches=launches[kernel.__name__], step1=step1, along=along,
                             plain_err=plain_err, shard_atoms=int(p_loc.rec_coords.shape[0]))
        say(f"phase 21: {label} ({backend}, {mesh.device}, mesh coordinate {mesh.coord}): "
            f"{steps} steps, kernel launches {launches}; receptor slice "
            f"{p_loc.rec_coords.shape[0]} atoms; step-1 scores against GsoTorchRunner "
            f"max|diff| {step1:.3e}; the run's poses scored by the single-GPU kernel "
            f"energy, max|diff| by step {along}; {kernel.__name__} against plain on the "
            f"slice {plain_err:.3e}")
    # Poses/s of the DFIRE run, min of 3: the steps alone, every rank between
    # two barriers.
    params, pos, _ = cases[0][1]
    states = stack_swarm_states([pos], False, 0, 0, f32, mesh.device)
    randoms = torch.as_tensor(swarm_randoms(SEED, STEPS, 1, N_POSES), dtype=f32,
                              device=mesh.device)
    p_loc, energy_fn = sharded.make_kernel_atom_sharded_fns(params, mesh)
    times = []
    for _ in range(3):
        st = states
        barrier(mesh.device)
        t0 = time.perf_counter()
        for r in randoms:
            st, _ = swarms_step(p_loc, st, r, energy_fn)
        torch.cuda.synchronize()
        barrier(mesh.device)
        times.append(time.perf_counter() - t0)
    result["poses_per_s"] = N_POSES * STEPS / min(times)
    result["times"] = times
    (out / f"rank{rank}.json").write_text(json.dumps(result))


def grid_farm_rank(rank, out):
    """Phase 22 on one rank: the 32-swarm farm on a (2, 2) mesh through
    ``run_swarm_farm(n_atom_shards=2, energy_mode='kernel')``, then the
    same steps timed through ``sharded.run_multi_swarm_2d_kernel``."""
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.parallel import sharded
    from lightdock_tpu_torch.parallel.farm import run_swarm_farm
    from lightdock_tpu_torch.parallel.mesh import make_mesh
    from lightdock_tpu_torch.parallel.multihost import (barrier, stack_swarm_states,
                                                        swarm_randoms)

    n_swarm, n_atoms = SHARD_GRID
    backend, device = rank_start(rank, n_swarm * n_atoms, 22)
    mesh = make_mesh(n_swarm=n_swarm, n_atoms=n_atoms, device=device)
    params, pos, _ = standin.toy_system(*DFIRE_ATOMS, FARM_SWARMS * N_POSES)
    swarms = [pos[i * N_POSES:(i + 1) * N_POSES] for i in range(FARM_SWARMS)]
    counters = pair_kernels()
    written = record_writes()
    for c in counters:
        c.launches = 0
    barrier(mesh.device)
    t0 = time.perf_counter()
    run_swarm_farm(params, swarms, list(range(FARM_SWARMS)), SEED, SHARD_FARM_STEPS,
                   False, 0, 0, torch.float32, output_root=str(out / "farm"),
                   energy_mode="kernel", n_atom_shards=n_atoms, mesh=mesh)
    torch.cuda.synchronize()
    barrier(mesh.device)
    run_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    only(launches, "dfire_pairs", SHARD_FARM_STEPS, f"phase 22 rank {rank}")
    block = mesh.swarm_block(FARM_SWARMS)
    states = stack_swarm_states(swarms[block.start:block.stop], False, 0, 0, torch.float32,
                                mesh.device)
    randoms = torch.as_tensor(swarm_randoms(SEED, SHARD_FARM_STEPS, len(block), N_POSES),
                              dtype=torch.float32, device=mesh.device)
    times = []
    for _ in range(3):
        barrier(mesh.device)
        t0 = time.perf_counter()
        final, _ = sharded.run_multi_swarm_2d_kernel(mesh, params, states, randoms)
        torch.cuda.synchronize()
        barrier(mesh.device)
        times.append(time.perf_counter() - t0)
    torch.save({f: x.cpu() for f, x in final._asdict().items()}, out / f"final_rank{rank}.pt")
    say(f"phase 22: rank {rank} of {n_swarm * n_atoms} ({backend}, {mesh.device}, mesh "
        f"coordinate {mesh.coord}, swarms {block.start}-{block.stop - 1}): "
        f"{SHARD_FARM_STEPS} steps in {run_s:.3f} s with the writes; kernel launches "
        f"{launches}; {len(written)} snapshots written")
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        backend=backend, device=str(mesh.device), coord=mesh.coord,
        block=[block.start, block.stop], launches=launches["dfire_pairs"],
        written=written, run_s=run_s, times=times)))


def cli_rank(rank, work, argv):
    """Phase 23 on one rank: ``lightdock_tpu_torch.cli.main`` in ``work``
    with torchrun's environment for the rank: the command line starts the
    process group itself (gloo where two ranks share the card)."""
    from lightdock_tpu_torch import cli

    counters = pair_kernels()
    written = record_writes()
    for c in counters:
        c.launches = 0
    out = io.StringIO()
    with working_directory(work), contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    launches = {c.__name__: c.launches for c in counters}
    check(rc == 0, f"phase 23 rank {rank}: exit {rc}")
    only(launches, "dfire_pairs", SHARD_FARM_STEPS, f"phase 23 rank {rank}")
    lines = [x for x in out.getvalue().splitlines() if x.startswith(("Running", "Rank", "Done"))]
    say(f"phase 23: rank {rank}: kernel launches {launches}; {len(written)} snapshots "
        "written; its output: " + " | ".join(lines))
    (work / f"rank{rank}.json").write_text(json.dumps(dict(
        launches=launches["dfire_pairs"], written=written, said=lines)))


def final_states_equal(out, a, b, prefix):
    import torch
    x, y = (torch.load(out / f"{prefix}_rank{r}.pt") for r in (a, b))
    return all(torch.equal(x[f], y[f]) for f in x)


def sharded_swarm_phase(card, dfire_poses_s):
    """Phase 21 (``sharded_swarm_rank`` on 2 ranks); returns K1's and K3's
    launches a rank and their max error against plain on a slice."""
    with tempfile.TemporaryDirectory() as out:
        out = pathlib.Path(out)
        t0 = time.perf_counter()
        spawn(sharded_swarm_rank, SHARD_RANKS, out)
        phase_s = time.perf_counter() - t0
        res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(SHARD_RANKS)]
        same = {tag: final_states_equal(out, 0, 1, tag) for tag in ("dfire", "dna")}
    say(f"phase 21: {SHARD_RANKS} ranks ({res[0]['backend']}; devices "
        f"{[r['device'] for r in res]}) in {phase_s:.1f} s with their start; final states "
        f"of the two ranks bit-equal: 1ppe DFIRE {same['dfire']}, 1azp DNA + ANM "
        f"{same['dna']}")
    check(all(same.values()), "phase 21: the ranks' final states differ")
    best = [r["poses_per_s"] for r in res]
    say(f"phase 21: [{card}] 1ppe DFIRE, receptor atoms over {SHARD_RANKS} ranks sharing "
        f"the card: {STEPS} GSO steps x {N_POSES} poses, min of 3 {min(best):.1f} poses/s "
        f"(rank 0's runs {', '.join(f'{x:.4f}' for x in res[0]['times'])} s); phase 4 "
        f"on one rank {dfire_poses_s:.1f} poses/s.  Ranks on one card time the "
        "correctness of the path, not its scaling")
    labels = {"dfire_pairs": "1ppe DFIRE", "elec_vdw_pairs": "1azp DNA + ANM"}
    return {name: ([r[f"{label} on rank {i} of {SHARD_RANKS}"]["launches"]
                    for i, r in enumerate(res)],
                   max(r[f"{label} on rank {i} of {SHARD_RANKS}"]["plain_err"]
                       for i, r in enumerate(res)))
            for name, label in labels.items()}


def grid_farm_phase(card, farm_step1, farm_poses_s):
    """Phase 22 (``grid_farm_rank`` on a (2, 2) mesh); returns K1's
    launches a rank."""
    import numpy as np

    n_swarm, n_atoms = SHARD_GRID
    world = n_swarm * n_atoms
    with tempfile.TemporaryDirectory() as out:
        out = pathlib.Path(out)
        t0 = time.perf_counter()
        spawn(grid_farm_rank, world, out)
        phase_s = time.perf_counter() - t0
        res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
        farm = out / "farm"
        dirs = sorted(q.name for q in farm.iterdir())
        step1 = np.stack([sidecar_scores(farm / f"swarm_{i}", 1) for i in range(FARM_SWARMS)])
        same = [final_states_equal(out, s * n_atoms, s * n_atoms + 1, "final")
                for s in range(n_swarm)]
    writers = {}
    for r, x in enumerate(res):
        for path in x["written"]:
            writers.setdefault(pathlib.Path(path).parent.name, set()).add(r)
    one_writer = (sorted(writers) == dirs and all(len(w) == 1 for w in writers.values()))
    err = float(np.abs(step1 - farm_step1).max())
    floor = score_floor("dfire")
    close = bool(np.allclose(step1, farm_step1, rtol=RTOL, atol=floor))
    best = min(max(x["times"][i] for x in res) for i in range(3))
    n_all = FARM_SWARMS * N_POSES
    say(f"phase 22: {n_swarm} x {n_atoms} mesh of {world} ranks ({res[0]['backend']}; "
        f"devices {[x['device'] for x in res]}) in {phase_s:.1f} s with their start; "
        f"`run_swarm_farm(n_atom_shards={n_atoms}, energy_mode='kernel')`: "
        f"{len(dirs)} swarm directories, each written by one rank {one_writer} "
        f"(writers: rank 0 {len(res[0]['written'])}, rank 1 {len(res[1]['written'])}, "
        f"rank 2 {len(res[2]['written'])}, rank 3 {len(res[3]['written'])} snapshots); "
        f"step-1 scores against phase 16's farm max|diff| {err:.3e} (rtol {RTOL:g}, atol "
        f"{floor:.3g}: {close}); the two ranks of each row bit-equal {same}")
    say(f"phase 22: [{card}] {FARM_SWARMS} x {N_POSES} farm on the {n_swarm} x {n_atoms} "
        f"mesh: {SHARD_FARM_STEPS} GSO steps x {n_all} poses, min of 3 (the slowest rank) "
        f"{best:.4f} s = {n_all * SHARD_FARM_STEPS / best:.1f} aggregate poses/s; phase 16 "
        f"on one rank {farm_poses_s:.1f}.  Four processes share one H100: this times the "
        "path's correctness, not its scaling")
    check(dirs == sorted(f"swarm_{i}" for i in range(FARM_SWARMS)) and one_writer,
          f"phase 22: swarm directories {dirs[:4]}..., writers {writers}")
    check(close, "phase 22: step-1 scores differ from phase 16's farm")
    check(all(same), "phase 22: the ranks of a mesh row ended with different states")
    return [x["launches"] for x in res]


def cli_ranks_phase(card, counters):
    """Phase 23: the command line under ``SHARD_RANKS`` ranks (swarms only)
    on the 32-file glob, against one process on the same files; returns
    K1's launches a rank."""
    import numpy as np

    from lightdock_tpu_torch import standin

    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        setup, _ = standin.write_complex(work, "dfire", *DFIRE_ATOMS, N_POSES,
                                         n_swarms=FARM_SWARMS, seed=SEED)
        glob = str(work / "initial_positions_*.dat")
        files = sorted(str(f.name) for f in work.glob("initial_positions_*.dat"))
        one, ranks = work / "one", work / "ranks"
        one.mkdir()
        ranks.mkdir()
        launches, one_s, _ = cli_run(counters, one, [setup, glob, SHARD_FARM_STEPS, "dfire"])
        only(launches, "dfire_pairs", SHARD_FARM_STEPS, "phase 23: one process")
        metrics = ranks / "metrics.jsonl"
        t0 = time.perf_counter()
        spawn(cli_rank, SHARD_RANKS, ranks, [setup, glob, SHARD_FARM_STEPS, "dfire",
                                             "--metrics", metrics])
        ranks_s = time.perf_counter() - t0
        res = [json.loads((ranks / f"rank{r}.json").read_text()) for r in range(SHARD_RANKS)]
        a = np.stack([sidecar_scores(ranks / f"swarm_{i}", SHARD_FARM_STEPS)
                      for i in range(FARM_SWARMS)])
        b = np.stack([sidecar_scores(one / f"swarm_{i}", SHARD_FARM_STEPS)
                      for i in range(FARM_SWARMS)])
        same = all((ranks / f"swarm_{i}" / f"gso_{s}.out").read_text()
                   == (one / f"swarm_{i}" / f"gso_{s}.out").read_text()
                   for i in range(FARM_SWARMS) for s in (1, 10, SHARD_FARM_STEPS))
        summary = json.loads(metrics.read_text().splitlines()[-1])
    per_rank = [sorted({int(pathlib.Path(p).parent.name[6:]) for p in x["written"]})
                for x in res]
    # The command line takes the glob's files in sorted order (initial_positions_0,
    # _1, _10, ...), and rank r its r-th block of them.
    ids = [int(f.rsplit("_", 1)[1].split(".")[0]) for f in files]
    half = FARM_SWARMS // SHARD_RANKS
    want = [sorted(ids[:half]), sorted(ids[half:])]
    err = float(np.abs(a - b).max())
    close = bool(np.allclose(a, b, rtol=RTOL, atol=ATOL)) and bool(np.isfinite(a).all())
    say(f"phase 23: `lightdock-tpu-torch setup.json 'initial_positions_*.dat' "
        f"{SHARD_FARM_STEPS} dfire --metrics` on {SHARD_RANKS} ranks in {ranks_s:.1f} s "
        f"with their start ({one_s:.3f} s in one process): rank 0 wrote swarms "
        f"{per_rank[0]}, rank 1 {per_rank[1]}; gso_{SHARD_FARM_STEPS} "
        f"scores against one process max|diff| {err:.3e} (allclose {close}); gso_1, gso_10 "
        f"and gso_{SHARD_FARM_STEPS} byte-identical {same} (a rank's call scores "
        f"{FARM_SWARMS // SHARD_RANKS} swarms' poses, one process's {FARM_SWARMS}); rank 0's "
        f"metrics: {summary['total_poses_scored']} poses, {summary['poses_per_s']} poses/s "
        f"[{card}]")
    check(per_rank == want, f"phase 23: swarms written {per_rank}, expected {want}")
    check(close, "phase 23: gso_20 scores differ from one process's")
    check(summary["total_poses_scored"] == FARM_SWARMS * N_POSES * SHARD_FARM_STEPS,
          f"phase 23: rank 0's metrics count {summary['total_poses_scored']} poses")
    return [x["launches"] for x in res]


def mixed_path(label, system, energy_mode, steps, counters, kernel, card, dq_bf16=False):
    """Phase 24 (a) on one path: ``steps`` steps of ``GsoTorchRunner(dtype=
    float64, energy_dtype=float32)`` through ``run_segmented`` with every
    kernel count set to 0 just before and read just after, and its checks.
    Returns the path kernel's launches."""
    import numpy as np
    import torch

    from lightdock_tpu_torch.engine.runner import GsoTorchRunner

    params, pos, k = system
    f32, f64 = torch.float32, torch.float64

    def runner(dtype, energy_dtype=None, out_dir=None):
        return GsoTorchRunner(params, pos, SEED, use_anm=k > 0, anm_rec=k, anm_lig=k,
                              output_directory=out_dir, dtype=dtype, device="cuda",
                              energy_mode=energy_mode, dq_bf16=dq_bf16,
                              energy_dtype=energy_dtype)

    with tempfile.TemporaryDirectory() as out_dir:
        mixed = runner(f64, f32, out_dir)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        final, outs = mixed.run_segmented(steps, SEGMENT)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        step1 = sidecar_scores(out_dir, 1)
    only(launches, kernel.__name__, steps, f"phase 24: {label}")
    floats = {name: x.dtype for name, x in final._asdict().items() if x.is_floating_point()}
    check(all(d == f64 for d in floats.values()) and step1.dtype == np.float64,
          f"phase 24: {label}: state dtypes {floats}, step-1 scores {step1.dtype}")
    check(all(bool(torch.isfinite(x).all()) for x in final if x.is_floating_point()),
          f"phase 24: {label}: non-finite state")
    ref = runner(f32).run(1)[1].scoring[0].to(f64).cpu().numpy()
    same = bool(np.array_equal(step1, ref))
    # The segment's unmoved poses keep their stored score.
    unmoved = outs.num_neighbors[:-1] == 0
    kept = bool(torch.equal(outs.scoring[1:][unmoved], outs.scoring[:-1][unmoved]))
    # A stored float64 score with bits below float32's passes the gate as
    # float64(float32(score)), as in JAX.
    t, q, a_rec, a_lig = final.t, final.q, final.a_rec, final.a_lig
    gate = torch.arange(N_POSES, device="cuda") % 2 == 0
    prev = final.scoring * (1.0 + 2.0 ** -40)
    gated = mixed.energy_fn(mixed.params, t, q, a_rec, a_lig, moved=gate, prev_scoring=prev)
    passed = bool(torch.equal(gated[~gate], prev[~gate].to(f32).to(f64)))
    dq = mixed.params.dfire_dq.dtype if mixed.params.dfire_dq is not None else None
    times = {"float32": [], "float64 state": []}
    timers = {"float32": runner(f32), "float64 state": runner(f64, f32)}
    for rep in range(5):
        for name in (list(timers) if rep % 2 == 0 else list(timers)[::-1]):
            timers[name].reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timers[name].run(steps)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    rate = {name: N_POSES * steps / min(x) for name, x in times.items()}
    say(f"phase 24: {label}: {steps} steps in {run_s:.3f} s (first run, with snapshots); "
        f"kernel launches {launches}; state {sorted(set(map(str, floats.values())))}; "
        f"step-1 scores bit-equal to the float32 runner's {same}; "
        f"{int(unmoved.sum())} unmoved pose-steps in the last segment kept their score "
        f"{kept}; a float64 score through the gate is float64(float32(score)) {passed}"
        + (f"; step tables {dq}" if dq is not None else ""))
    say(f"phase 24: [{card}] {label}: {steps} GSO steps x {N_POSES} poses, min of 5 in "
        f"turns: float64 state {rate['float64 state']:.1f} poses/s, float32 "
        f"{rate['float32']:.1f} poses/s (float64 state: "
        f"{', '.join(f'{x:.4f}' for x in times['float64 state'])} s; float32: "
        f"{', '.join(f'{x:.4f}' for x in times['float32'])} s)")
    check(same, f"phase 24: {label}: step-1 scores differ from the float32 runner's")
    check(kept, f"phase 24: {label}: an unmoved pose's score changed")
    check(passed, f"phase 24: {label}: the gate did not pass float64(float32(score))")
    check(not dq_bf16 or dq == torch.bfloat16, f"phase 24: {label}: step tables {dq}")
    return launches[kernel.__name__]


def f64_card_vs_cpu(work, counters):
    """Phase 24 (b): the float64 dense run of the 1ppe stand-in files,
    ``MIXED_CPU_STEPS`` steps on the card and on the CPU; gso_1 and gso_10
    must be text-identical and no kernel may launch."""
    import torch

    from lightdock_tpu_torch import precision_fidelity as pf

    sim, _, _ = pf.load_example("1ppe", work / "inputs")
    seconds = {}
    for c in counters:
        c.launches = 0
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pf.run_engine(sim, work / f"f64_{device}", "f64", "dense", torch.device(device),
                      steps=MIXED_CPU_STEPS)
        torch.cuda.synchronize()
        seconds[device] = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    same = {s: (work / "f64_cuda" / f"gso_{s}.out").read_text()
            == (work / "f64_cpu" / f"gso_{s}.out").read_text() for s in (1, MIXED_CPU_STEPS)}
    say(f"phase 24: 1ppe stand-in files, float64 dense, {MIXED_CPU_STEPS} steps: card "
        f"{seconds['cuda']:.3f} s, CPU {seconds['cpu']:.3f} s; text-identical "
        f"{same}; kernel launches {launches}")
    check(all(same.values()), f"phase 24: the card's float64 dense run differs from the "
          f"CPU's: {same}")
    check(sum(launches.values()) == 0, f"phase 24: the dense runs launched {launches}")


# The fields of scripts/precision_fidelity.py's rows, with the port's mode
# names; a row of the card also names it.
PRECISION_COMPARED = {"horizon", "first_rendered_divergence_step", f"step{STEPS}"}
PRECISION_ROWS = {
    "kernel": {"example", "method", "backend", "engine_f32", "energy_accuracy", "card"},
    "control_f64_seedB": {"example", "note"},
    "hybrid": {"example", "state_dtype", "energy_dtype", "engine", "backend", "card"},
}
PRECISION_RESULT = {"best_score_f64", "best_score_f32", "best_score_rel_diff",
                    "best_pose_same", "top10_overlap", "kendall_tau", "n_clusters_f64",
                    "n_clusters_f32", "cluster_rep_overlap"}


def precision_tool(work, counters, card):
    """Phase 24 (c): ``precision_fidelity.main`` with ``--standin`` and
    ``--hybrids`` at ``STEPS`` steps on the card; checks and prints every
    row.  Returns (K1's, K3's) launches."""
    from lightdock_tpu_torch import precision_fidelity as pf

    out = work / "PRECISION_torch.json"
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        rc = pf.main(["--standin", str(work / "inputs"), "--hybrids", "--steps", str(STEPS),
                      "--out", str(out)])
    except Exception as exc:  # a leg's failure fails the phase
        fail(f"phase 24: precision_fidelity: {type(exc).__name__}: {exc}")
    run_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    rows = json.loads(out.read_text())
    check(rc == 0, f"phase 24: precision_fidelity exit {rc}")
    say(f"phase 24: `python -m lightdock_tpu_torch.precision_fidelity --standin DIR "
        f"--hybrids --steps {STEPS}` in {run_s:.1f} s; kernel launches {launches}")
    names = {"kernel": [f"{x}_cuda_kernel" for x in pf.EXAMPLES],
             "control_f64_seedB": [f"{x}_control_f64_seedB" for x in pf.EXAMPLES],
             "hybrid": [f"{x}_hybrid_{h}" for x in pf.EXAMPLES
                        for h in ("f32_state_f64_energy", "f64_state_f32_energy")]}
    want = {key: fields | PRECISION_COMPARED for kind, keys in names.items()
            for key in keys for fields in [PRECISION_ROWS[kind]]}
    check(set(rows) == set(want), f"phase 24: rows {sorted(rows)}, expected {sorted(want)}")
    for key, fields in want.items():
        row = rows[key]
        check(set(row) == fields and set(row[f"step{STEPS}"]) == PRECISION_RESULT,
              f"phase 24: row {key} has fields {sorted(row)}")
        by_step = {h["step"]: h for h in row["horizon"]}
        end = row[f"step{STEPS}"]
        line = (f"phase 24: [{card}] {key}: first rendered divergence step "
                f"{row['first_rendered_divergence_step']}; max_dscore/max_dt step 1 "
                f"{by_step[1]['max_dscore']:.3e}/{by_step[1]['max_dt']:.3e}, step 10 "
                f"{by_step[10]['max_dscore']:.3e}/{by_step[10]['max_dt']:.3e}, step {STEPS} "
                f"{by_step[STEPS]['max_dscore']:.3e}/{by_step[STEPS]['max_dt']:.3e}; "
                f"step {STEPS}: Kendall tau {end['kendall_tau']:.4f}, top-10 overlap "
                f"{end['top10_overlap']}, cluster representatives {end['cluster_rep_overlap']} "
                f"of {end['n_clusters_f64']}/{end['n_clusters_f32']}, best score rel diff "
                f"{end['best_score_rel_diff']:.3e}")
        if "energy_accuracy" in row:
            acc = row["energy_accuracy"]
            line += "; part A " + ", ".join(
                f"{m} max {acc[m]['max']:.3e} median {acc[m]['median']:.3e}"
                for m in ("dense_f32_rel_err", "kernel_f32_rel_err"))
            for m in ("dense_f32_rel_err", "kernel_f32_rel_err"):
                check(acc[m]["median"] <= PART_A_MEDIAN,
                      f"phase 24: {key}: part A {m} median {acc[m]['median']:.3e}")
        say(line)
        if key.endswith("control_f64_seedB"):
            check(by_step[1]["max_dscore"] == 0.0,
                  f"phase 24: {key}: step-1 max_dscore {by_step[1]['max_dscore']}")
    # Each example's float32 kernel leg (STEPS launches) and part A (one).
    check(launches["dfire_pairs"] == STEPS + 1 and launches["elec_vdw_pairs"] == STEPS + 1
          and sum(launches.values()) == 2 * (STEPS + 1),
          f"phase 24: precision_fidelity launched {launches}")
    return launches["dfire_pairs"], launches["elec_vdw_pairs"]


def mixed_phase(card, counters):
    """Phase 24: a float64 state scored at float32 by K1, K3 and K4, the
    float64 dense leg on the card against the CPU, and the precision tool.
    Returns each kernel's launches by site."""
    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4
    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev

    t_phase = time.perf_counter()
    sites = {
        "dfire_pairs": {"phase 24 float64 state": mixed_path(
            "1ppe DFIRE, float64 state, float32 K1",
            standin.toy_system(*DFIRE_ATOMS, N_POSES), "kernel", STEPS, counters,
            dp.dfire_pairs, card)},
        "elec_vdw_pairs": {"phase 24 float64 state": mixed_path(
            "1azp DNA + ANM, float64 state, float32 K3",
            standin.toy_system(*DNA_ATOMS, N_POSES, num_anm=DNA_ANM, method="dna"),
            "kernel", STEPS, counters, ev.elec_vdw_pairs, card)},
        "dfire_pairs_v1": {"phase 24 float64 state": mixed_path(
            "1ppe DFIRE v1, float64 state, float32 K4, bfloat16 step tables",
            standin.toy_system(*DFIRE_ATOMS, N_POSES, dfire_mode="steps"), "kernel_v1",
            MIXED_V1_STEPS, counters, k4.dfire_pairs_v1, card, dq_bf16=True)},
    }
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        f64_card_vs_cpu(work, counters)
        k1, k3 = precision_tool(work, counters, card)
    sites["dfire_pairs"]["phase 24 precision tool"] = k1
    sites["elec_vdw_pairs"]["phase 24 precision tool"] = k3
    say(f"phase 24: done in {time.perf_counter() - t_phase:.1f} s")
    return sites


# -- phase 25: the workflow around a run on the card --------------------------

def writer_timings(card, work):
    """Phase 25: ms a snapshot of the native writer and of its plain version
    (``format_gso_output`` and the write), in turns (native, plain, plain,
    native), at N_POSES x 7 and N_POSES x (7 + 2 DNA_ANM) pose columns from
    a float32 state, with the two texts equal; the ``.npz`` sidecar timed
    apart.  Returns {columns: (native, plain, sidecar) medians in ms}."""
    import numpy as np

    from lightdock_tpu_torch.utils import output

    rng = np.random.RandomState(SEED)
    result = {}
    for n_anm in (0, DNA_ANM):
        g = N_POSES
        state = {"t": rng.uniform(-40, 40, (g, 3)), "q": rng.standard_normal((g, 4)),
                 "a_rec": rng.standard_normal((g, n_anm)),
                 "a_lig": rng.standard_normal((g, n_anm)), "luciferin": rng.uniform(0, 9, g),
                 "num_neighbors": rng.randint(0, 6, g), "vision": rng.uniform(0, 5, g),
                 "scoring": rng.standard_normal(g) * 50}
        state = {k: v.astype(np.int32 if k == "num_neighbors" else np.float32)
                 for k, v in state.items()}
        cols = (np.concatenate([state[k] for k in ("t", "q", "a_rec", "a_lig")],
                               axis=1).astype(np.float64),
                *(state[k].astype(np.float64) if k != "num_neighbors" else state[k]
                  for k in ("luciferin", "num_neighbors", "vision", "scoring")))
        native_path, plain_path = work / f"native_{n_anm}.out", work / f"plain_{n_anm}.out"
        forms = {
            "native": lambda: output.write_gso_output(native_path, *cols),
            "plain": lambda: plain_path.write_text(output.format_gso_output(*cols)),
            "sidecar": lambda: output.write_state_sidecar(native_path, 1, **state)}
        times = {k: [] for k in forms}
        for name in forms:
            forms[name]()                                     # warm-up
        for _ in range(WRITER_REPS):
            for name in ("native", "plain", "plain", "native", "sidecar"):
                t0 = time.perf_counter()
                forms[name]()
                times[name].append((time.perf_counter() - t0) * 1e3)
        check(native_path.read_text() == plain_path.read_text(),
              f"phase 25: the native writer's text differs from format_gso_output's "
              f"at {cols[0].shape}")
        medians = tuple(float(np.median(times[k])) for k in ("native", "plain", "sidecar"))
        result[cols[0].shape[1]] = medians
        say(f"phase 25: [{card}] writer at {g} x {cols[0].shape[1]}: native "
            f"{medians[0]:.4f} ms, format_gso_output + write {medians[1]:.4f} ms "
            f"({medians[1] / medians[0]:.2f}x), .npz sidecar {medians[2]:.4f} ms a snapshot "
            f"(medians of {2 * WRITER_REPS}, {2 * WRITER_REPS} and {WRITER_REPS}; mins "
            f"{min(times['native']):.4f}, {min(times['plain']):.4f}, "
            f"{min(times['sidecar']):.4f})")
    return result


def held_snapshots(root) -> int:
    """Every gso_N.out under ``root`` against ``format_gso_output`` of the
    state its sidecar holds (the arrays the writer was given); returns the
    count held."""
    import numpy as np

    from lightdock_tpu_torch.utils import output

    count = 0
    for path in sorted(pathlib.Path(root).rglob("gso_*.out")):
        _, data = output.read_state_sidecar(path)
        poses = np.concatenate([data[k] for k in ("t", "q", "a_rec", "a_lig")
                                if data[k].shape[-1] > 0], axis=1).astype(np.float64)
        text = output.format_gso_output(poses, data["luciferin"].astype(np.float64),
                                        data["num_neighbors"],
                                        data["vision"].astype(np.float64),
                                        data["scoring"].astype(np.float64))
        check(path.read_text() == text,
              f"phase 25: {path} differs from format_gso_output of its sidecar")
        count += 1
    return count


def analysis_run(counters, argv):
    """``lightdock_tpu_torch.cli_analysis.main(argv)``, ended by the card's
    synchronize; no pair kernel launched.  Returns (seconds, output)."""
    import torch

    from lightdock_tpu_torch import cli_analysis

    for c in counters:
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_analysis.main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"lightdock-tpu-torch-analysis {' '.join(map(str, argv))}: exit {rc}")
    check(sum(c.launches for c in counters) == 0,
          f"lightdock-tpu-torch-analysis {argv[0]} launched a pair kernel")
    return seconds, out.getvalue().strip()


def tree_bytes(root):
    return {q.relative_to(root).as_posix(): q.read_bytes()
            for q in sorted(pathlib.Path(root).rglob("*")) if q.is_file()}


def workflow_setup(counters, work, name, method, atoms, swarms, num_anm=0):
    """Raw PDB files of a stand-in complex (``standin.write_complex``'s
    working copies as rec.pdb and lig.pdb), then ``lightdock-tpu-torch-tools
    setup`` for ``swarms`` x N_POSES (with ``num_anm`` + ``num_anm`` modes
    and the stand-in's mode files beside setup.json).  Returns (run
    directory, setup.json, positions glob, seconds of the setup)."""
    from lightdock_tpu_torch import cli_tools, standin

    src, run = work / f"{name}_src", work / name
    standin.write_complex(src, method, *atoms, N_POSES, num_anm=num_anm, seed=SEED)
    raw = work / f"{name}_raw"
    raw.mkdir()
    for side in ("rec", "lig"):
        shutil.copy(src / f"lightdock_{side}.pdb", raw / f"{side}.pdb")
    argv = ["setup", raw / "rec.pdb", raw / "lig.pdb", "-s", swarms, "-g", N_POSES,
            "--workdir", run]
    if num_anm:
        argv += ["--anm", "--anm-rec", num_anm, "--anm-lig", num_anm]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_tools.main([str(a) for a in argv])
    setup_s = time.perf_counter() - t0
    check(rc == 0, f"lightdock-tpu-torch-tools setup ({name}): exit {rc}")
    for f in src.glob("*_nm.npy"):
        shutil.copy(f, run / f.name)
    init = sorted((run / "init").glob("initial_positions_*.dat"))
    check(len(init) == swarms and all(len(f.read_text().splitlines()) == N_POSES
                                      for f in init),
          f"phase 25: tools setup wrote {len(init)} positions files")
    return run, run / "setup.json", run / "init" / "initial_positions_*.dat", setup_s


def card_against_cpu(counters, run, setup, step, label, extra=()):
    """Copies of the first WORKFLOW_SUBSET swarm directories of ``run`` (made
    before any analysis there); on each, ``rank`` with metrics over every
    pose (its list kept as rank_all_poses.list), then ``all``, on the card
    and with ``--platform cpu``.  Checks the files equal byte for byte and
    returns {platform: (rank s, all s)}."""
    seconds, trees = {}, {}
    for platform in ("cuda", "cpu"):
        root = run.parent / f"{run.name}_subset_{platform}"
        for s in range(WORKFLOW_SUBSET):
            shutil.copytree(run / f"swarm_{s}", root / f"swarm_{s}")
        common = [step, "--setup", setup, "--platform", platform, *extra]
        rank_s, _ = analysis_run(counters, ["rank", root, *common])
        (root / "rank_by_scoring.list").rename(root / "rank_all_poses.list")
        all_s, _ = analysis_run(counters, ["all", root, *common])
        seconds[platform] = (rank_s, all_s)
        trees[platform] = tree_bytes(root)
    names = sorted(trees["cuda"])
    differ = [n for n in names if trees["cuda"][n] != trees["cpu"].get(n)]
    check(not differ and names == sorted(trees["cpu"]) and "top/top_1.pdb" in names,
          f"phase 25: {label}: the card's analysis files differ from the CPU's: {differ[:5]}")
    return seconds


def glob_writer_turns(counters, run, setup, glob):
    """The glob for STEPS steps through the command line, WORKFLOW_AB_RUNS
    times in turns (plain, native, native, plain): the snapshots written by
    the plain writer (``format_gso_output`` and the write, in place of
    ``parallel.multihost.write_gso_output``) or by the native one.  One K1
    launch a step each.  Returns {writer: [--metrics poses/s]}."""
    import numpy as np

    from lightdock_tpu_torch.parallel import multihost
    from lightdock_tpu_torch.utils import output

    native = multihost.write_gso_output

    def plain(path, poses, luciferin, num_neighbors, vision, scoring):
        pathlib.Path(path).write_text(output.format_gso_output(
            np.asarray(poses, dtype=np.float64), luciferin, num_neighbors, vision, scoring))

    result = {"plain": [], "native": []}
    for i in range(WORKFLOW_AB_RUNS):
        writer = "plain" if i % 4 in (0, 3) else "native"
        work = run.parent / f"{run.name}_turn_{i}"
        work.mkdir()
        metrics = work / "metrics.jsonl"
        multihost.write_gso_output = plain if writer == "plain" else native
        try:
            launches, _, _ = cli_run(counters, work, [setup, glob, STEPS, "dfire",
                                                      "--metrics", metrics])
        finally:
            multihost.write_gso_output = native
        only(launches, "dfire_pairs", STEPS, f"phase 25: the glob, turn {i} ({writer})")
        result[writer].append(json.loads(metrics.read_text().splitlines()[-1])["poses_per_s"])
    return result


def clash_timing(card, run, step):
    """The clash count on the card over every pose of the glob's gso_{step}
    (CUDA events, CLASH_REPS calls after a warm-up) beside its bound, and
    the pose transform and one swarm's RMSD matrix.  Returns (clash ms,
    bound ms, bound_by, pairs)."""
    import numpy as np
    import torch

    from lightdock_tpu_torch import analysis
    from lightdock_tpu_torch.utils.output import read_gso_output
    from lightdock_tpu_torch.utils.pdb import parse_pdb

    rec = parse_pdb(run / "lightdock_rec.pdb")
    lig = parse_pdb(run / "lightdock_lig.pdb")
    poses = np.concatenate([read_gso_output(run / f"swarm_{s}" / f"gso_{step}.out")[0]
                            for s in range(WORKFLOW_SWARMS)])
    none = np.zeros((0, lig.num_atoms, 3))
    coords = analysis.transform_ligand_batch(lig.coordinates, none, poses, False, 0, 0, "cuda")
    rec_t = torch.as_tensor(rec.coordinates, dtype=torch.float64, device="cuda")
    clash_ms = cuda_ms(lambda: analysis.count_clashes(rec_t, coords, 1.9, "cuda"), CLASH_REPS)
    transform_ms = cuda_ms(lambda: analysis.transform_ligand_batch(
        lig.coordinates, none, poses, False, 0, 0, "cuda"), CLASH_REPS)
    rmsd_ms = cuda_ms(lambda: analysis.pose_rmsd_matrix(coords[:N_POSES], "cuda"), CLASH_REPS)
    g = poses.shape[0]
    pairs = g * rec.num_atoms * lig.num_atoms
    # each coordinate read once, each count written once
    ops, nbytes = FLOPS_CLASH * pairs, 8 * (3 * rec.num_atoms + 3 * g * lig.num_atoms + g)
    by_ops, by_bytes = ops / PEAK_F64 * 1e3, nbytes / PEAK_BYTES * 1e3
    bnd, by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    chunks = analysis.clash_chunks(g, rec.num_atoms, lig.num_atoms)
    clashes = analysis.count_clashes(rec_t, coords, 1.9, "cuda")
    say(f"phase 25: [{card}] clash count on the card, {g} poses x {rec.num_atoms} x "
        f"{lig.num_atoms} atoms = {pairs:.4g} pairs (float64, chunks of {chunks[0]} poses x "
        f"{chunks[1]} receptor atoms): {clash_ms:.3f} ms a call, bound {bnd:.4f} ms "
        f"({by}: {ops:.4g} float64 operations over {PEAK_F64 / 1e12:.0f} TFLOP/s, "
        f"{nbytes} bytes over {PEAK_BYTES / 1e12:.2f} TB/s), {clash_ms / bnd:.1f}x its "
        f"bound; {int(clashes.sum())} clashes in all, {int((clashes > 0).sum())} poses with "
        f"one; pose transform of the {g} poses {transform_ms:.3f} ms, one swarm's "
        f"{N_POSES} x {N_POSES} RMSD matrix {rmsd_ms:.3f} ms")
    return clash_ms, bnd, by, pairs


def workflow_phase(card, counters, glob_poses_s):
    """Phase 25: raw PDB files -> ``lightdock-tpu-torch-tools setup`` ->
    ``lightdock-tpu-torch`` (the glob) -> ``lightdock-tpu-torch-analysis``
    on the card, the native writer held and timed.  ``glob_poses_s`` is
    phase 20's resumed glob.  Returns each kernel's launches by site."""
    import numpy as np

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        writer = writer_timings(card, work)

        # 1ppe DFIRE: setup, the glob with --metrics, the writer in turns.
        run, setup, glob, setup_s = workflow_setup(counters, work, "dfire", "dfire",
                                                   DFIRE_ATOMS, WORKFLOW_SWARMS)
        label = f"workflow 1ppe DFIRE {WORKFLOW_SWARMS} x {N_POSES}"
        metrics = run / "metrics.jsonl"
        launches, run_s, _ = cli_run(counters, run, [setup, glob, STEPS, "dfire",
                                                     "--metrics", metrics])
        only(launches, "dfire_pairs", STEPS, label)
        summary = json.loads(metrics.read_text().splitlines()[-1])
        dirs = sorted(q.name for q in run.glob("swarm_*"))
        check(dirs == sorted(f"swarm_{i}" for i in range(WORKFLOW_SWARMS)),
              f"{label}: swarm directories {dirs[:4]}...")
        last = np.stack([sidecar_scores(run / f"swarm_{i}", STEPS)
                         for i in range(WORKFLOW_SWARMS)])
        check(bool(np.isfinite(last).all()), f"{label}: non-finite scores")
        held = held_snapshots(run)
        check(held == WORKFLOW_SWARMS * (1 + STEPS // 10), f"{label}: {held} snapshots")
        say(f"phase 25: [{card}] {label}: tools setup ({DFIRE_ATOMS[0]} x {DFIRE_ATOMS[1]}"
            f"-atom PDB files, {WORKFLOW_SWARMS} swarms x {N_POSES} glowworms) "
            f"{setup_s:.3f} s; "
            f"`lightdock-tpu-torch setup.json 'init/initial_positions_*.dat' {STEPS} dfire "
            f"--metrics` in {run_s:.3f} s, kernel launches {launches}; --metrics summary "
            f"{summary['poses_per_s']} poses/s with the native writer (phase 20's resumed "
            f"glob in this run: {glob_poses_s}); {held} snapshots equal to "
            f"format_gso_output of their sidecars")
        for s in range(WORKFLOW_SUBSET):      # before any analysis writes there
            shutil.copytree(run / f"swarm_{s}", work / "dfire_copy" / f"swarm_{s}")
        turns = glob_writer_turns(counters, run, setup, glob)
        held += sum(held_snapshots(run.parent / f"{run.name}_turn_{i}")
                    for i in range(WORKFLOW_AB_RUNS))
        say(f"phase 25: [{card}] {label}: the glob's --metrics poses/s in turns, plain "
            f"writer {turns['plain']}, native writer {turns['native']} (native / plain "
            f"{np.mean(turns['native']) / np.mean(turns['plain']):.3f}x)")

        # The analysis on the card: rank over every pose, cluster, all.
        rank_s, rank_out = analysis_run(counters, ["rank", run, STEPS, "--setup", setup])
        ranked = (run / "rank_by_scoring.list").read_text().splitlines()
        check(len(ranked) == WORKFLOW_SWARMS * N_POSES + 1,
              f"{label}: rank listed {len(ranked) - 1} poses")
        cluster_s, cluster_out = analysis_run(counters, ["cluster", run, STEPS, "--setup", setup])
        all_s, all_out = analysis_run(counters, ["all", run, STEPS, "--setup", setup])
        reprs = [run / f"swarm_{i}" / "cluster.repr" for i in range(WORKFLOW_SWARMS)]
        n_reprs = sum(len(f.read_text().splitlines()) for f in reprs)
        tops = sorted(q.name for q in (run / "top").glob("top_*.pdb"))
        ranked = (run / "rank_by_scoring.list").read_text().splitlines()
        check(len(ranked) == n_reprs + 1 and len(tops) == 10,
              f"{label}: {len(ranked) - 1} ranked of {n_reprs} representatives, tops {tops}")
        say(f"phase 25: [{card}] {label}: analysis on the card: rank with metrics over "
            f"{WORKFLOW_SWARMS * N_POSES} poses {rank_s:.3f} s ({rank_out}); cluster "
            f"{cluster_s:.3f} s ({cluster_out}); all {all_s:.3f} s ({n_reprs} "
            f"representatives ranked, {len(tops)} top complexes); no kernel launched")
        clash_ms, clash_bound, clash_by, pairs = clash_timing(card, run, STEPS)

        # The card's files against the CPU's on the first swarms.
        by_platform = card_against_cpu(counters, work / "dfire_copy", setup, STEPS,
                                       f"1ppe DFIRE, {WORKFLOW_SUBSET} swarms")
        say(f"phase 25: [{card}] 1ppe DFIRE, {WORKFLOW_SUBSET} swarms: rank with metrics "
            f"over {WORKFLOW_SUBSET * N_POSES} poses then all, card "
            f"{by_platform['cuda'][0]:.3f} s + {by_platform['cuda'][1]:.3f} s, CPU "
            f"{by_platform['cpu'][0]:.3f} s + {by_platform['cpu'][1]:.3f} s; every file "
            f"byte-identical")

        # DNA + ANM at full width: the ligand ANM transform on the card.
        dna, dna_setup, dna_glob, dna_setup_s = workflow_setup(
            counters, work, "dna", "dna", DNA_ATOMS, WORKFLOW_SUBSET, num_anm=DNA_ANM)
        label = (f"workflow 1azp DNA + ANM ({DNA_ATOMS[0]} x {DNA_ATOMS[1]}, {DNA_ANM} + "
                 f"{DNA_ANM} modes, {WORKFLOW_SUBSET} x {N_POSES})")
        dna_launches, dna_s, _ = cli_run(counters, dna, [dna_setup, dna_glob,
                                                         CLI_SHORT_STEPS, "dna"])
        only(dna_launches, "elec_vdw_pairs", CLI_SHORT_STEPS, label)
        cols = snapshot_columns(dna / "swarm_0" / f"gso_{CLI_SHORT_STEPS}.out")
        check(cols == 7 + 2 * DNA_ANM, f"{label}: {cols} pose columns")
        dna_held = held_snapshots(dna)
        held += dna_held
        dna_platform = card_against_cpu(counters, dna, dna_setup, CLI_SHORT_STEPS, label,
                                        extra=("--anm-dir", dna))
        say(f"phase 25: [{card}] {label}: tools setup {dna_setup_s:.3f} s; "
            f"{CLI_SHORT_STEPS} steps in {dna_s:.3f} s, kernel launches {dna_launches}, "
            f"{cols} pose columns, {dna_held} snapshots equal to format_gso_output of "
            f"their sidecars; rank over {WORKFLOW_SUBSET * N_POSES} poses then all, card "
            f"{dna_platform['cuda'][0]:.3f} s + {dna_platform['cuda'][1]:.3f} s, CPU "
            f"{dna_platform['cpu'][0]:.3f} s + {dna_platform['cpu'][1]:.3f} s; every file "
            f"byte-identical")
    say(f"phase 25: [{card}] done in {time.perf_counter() - t_phase:.1f} s: {held} "
        f"snapshots held; writer ms (native, plain, sidecar) {writer}; clash count "
        f"{clash_ms:.3f} ms against a {clash_bound:.4f} ms bound ({clash_by}) over "
        f"{pairs:.4g} pairs")
    return ({"phase 25 glob": STEPS, "phase 25 writer turns": WORKFLOW_AB_RUNS * STEPS},
            {"phase 25 DNA + ANM": CLI_SHORT_STEPS})


def bench_process(args):
    """``python -m lightdock_tpu_torch.bench ARGS`` in a process of its own
    from the checkout, with the default energy mode; returns (the parsed
    last line of its standard output, the other lines, its standard
    error)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("LIGHTDOCK_BENCH_MODE", "LIGHTDOCK_BENCH_MULTISWARM")}
    proc = subprocess.run([sys.executable, "-m", "lightdock_tpu_torch.bench", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    label = f"python -m lightdock_tpu_torch.bench {' '.join(args)}"
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"{label}: the last line is not one JSON object: {proc.stdout[-500:]!r}")
    return last, lines[:-1], proc.stderr


def stderr_value(stderr, prefix, label):
    """The rest of the first standard-error line that starts with
    ``prefix``."""
    found = [ln[len(prefix):].strip() for ln in stderr.splitlines() if ln.startswith(prefix)]
    check(bool(found), f"{label}: no '{prefix}' line on standard error")
    return found[0]


def bench_phase(card):
    """Phase 26: the port's benchmark entry point, as a user runs it, and
    the crossover map behind ``energy_mode='auto'``.  Returns each bench
    system's pair-kernel launches (the timed runs; the farm's apart)."""
    import types

    import numpy as np
    import torch

    from lightdock_tpu_torch import bench
    from lightdock_tpu_torch.engine.runner import CROSSOVER_TIE, pick_energy_mode

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    sites = {}
    for system in bench.METRICS:
        t0 = time.perf_counter()
        args = [] if system == "1ppe" else ["--system", system]
        label = f"bench {system}"
        last, _, err = bench_process(args)
        check(set(last) == BENCH_KEYS, f"{label}: keys {sorted(last)}")
        check(last["metric"] == bench.METRICS[system] and last["unit"] == "poses/s",
              f"{label}: metric {last['metric']!r}, unit {last['unit']!r}")
        check(last["value"] > 0 and last["vs_baseline"] > 0, f"{label}: {last}")
        check(name in last["device"], f"{label}: device {last['device']!r} is not {name}")
        params, positions, _, _ = bench.system(system)
        picked = pick_energy_mode(params, "cuda", positions.shape[0], replayed=True)
        mode = stderr_value(err, "energy mode:", label)
        check(mode == f"{picked} (requested auto)",
              f"{label}: energy mode {mode!r}, pick_energy_mode {picked!r}")
        launches = json.loads(stderr_value(err, "kernel launches in the timed runs:", label))
        kernel = BENCH_KERNELS[system]
        runs = bench.STEPS * bench.REPEATS
        if picked == "kernel":
            only(launches, kernel, runs, label)
        else:
            check(sum(launches.values()) == 0, f"{label}: dense, yet {launches}")
        sites[kernel] = {f"phase 26 bench {system}": launches[kernel]}
        extra = ""
        if system == "1ppe":
            farm_picked = pick_energy_mode(params, "cuda",
                                           bench.FARM_SWARMS * positions.shape[0])
            farm_mode = stderr_value(err, "multi-swarm energy mode:", label)
            check(farm_mode == f"{farm_picked} (requested auto)",
                  f"{label}: farm {farm_mode!r}, pick_energy_mode {farm_picked!r}")
            farm = json.loads(stderr_value(
                err, "multi-swarm kernel launches in the timed run:", label))
            if farm_picked == "kernel":
                only(farm, kernel, bench.FARM_STEPS, f"{label} farm")
            sites[kernel]["phase 26 bench 1ppe farm"] = farm[kernel]
            extra = "; " + stderr_value(err, "multi-swarm aggregate:", label)
        say(f"phase 26: [{card}] {label} ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(last)}; energy mode {picked}; "
            f"{stderr_value(err, f'{bench.STEPS}-step wall-clock:', label)}; launches "
            f"{launches[kernel]} of {kernel}{extra}")

    t0 = time.perf_counter()
    rows = []
    for swarms, labels in BENCH_CROSSOVERS:
        table, lines, _ = bench_process(["--crossover", "--swarms", str(swarms),
                                         "--points", ",".join(labels)])
        for line in lines:
            say(f"phase 26: [{card}] {line}")
        say(json.dumps(table))
        check([row["point"] for row in table["crossover"]] == list(labels)
              and table["swarms"] == swarms and name in table["device"],
              f"crossover: {table['crossover']} on {table['device']!r}")
        rows += table["crossover"]
    for row in rows:
        shape = types.SimpleNamespace(
            method=row["method"], use_anm=row["rec_anm"],
            rec_nmodes=np.zeros((row["anm_modes"], 0, 3)),
            rec_coords=np.zeros((row["rec_atoms"], 3)),
            lig_coords=np.zeros((row["lig_atoms"], 3)))
        pick = pick_energy_mode(shape, "cuda", row["poses"], replayed=row["swarms"] == 1)
        check(row["pick"] == pick, f"crossover {row['point']}: pick {row['pick']} "
              f"in the bench, {pick} here")
        check(row["pick_lost_by"] <= CROSSOVER_TIE,
              f"crossover {row['point']} x{row['swarms']}: auto picks {pick}, which "
              f"lost by {row['pick_lost_by']:.3f}x (kernel {row['kernel_poses_s']:.1f}, "
              f"dense {row['dense_poses_s']:.1f} poses/s)")
    say(f"phase 26: [{card}] crossover at {len(rows)} points in "
        f"{time.perf_counter() - t0:.1f} s: pick_energy_mode loses by at most "
        f"{max(r['pick_lost_by'] for r in rows):.3f}x (tie {CROSSOVER_TIE}x); phase 26 done "
        f"in {time.perf_counter() - t_phase:.1f} s")
    return sites


# -- phase 27: the float64 host parity engine ----------------------------------

@contextlib.contextmanager
def host_engine_probe():
    """While open, ``GsoHostEngine.run`` records the engine it runs
    (``engine``) and each step's seconds (``steps``), and its scoring each
    call's (poses scored, seconds) (``energy``): the engine brings every
    score back to the host, so a call's wall time holds its device work."""
    import numpy as np

    from lightdock_tpu_torch.engine.gso_host import GsoHostEngine

    rec = types.SimpleNamespace(engine=None, steps=[], energy=[])
    run, score = GsoHostEngine.run, GsoHostEngine._recompute_energies

    def timed_score(self):
        n = int((self.moved | (self.step == 0)).sum())
        t0 = time.perf_counter()
        score(self)
        rec.energy.append((n, time.perf_counter() - t0))

    def recorded_run(self, steps, on_step=None):
        rec.engine = self
        marks = [time.perf_counter()]

        def step_done(engine, step):
            marks.append(time.perf_counter())
            if on_step is not None:
                on_step(engine, step)

        run(self, steps, step_done)
        rec.steps = np.diff(marks)

    GsoHostEngine.run, GsoHostEngine._recompute_energies = recorded_run, timed_score
    try:
        yield rec
    finally:
        GsoHostEngine.run, GsoHostEngine._recompute_energies = run, score


def host_scorer_card_vs_cpu(card, work):
    """Phase 27 (a): ``Simulation.host_scorer`` on the card against the CPU
    on ``HOST_SCORER_POSES`` poses of each method's stand-in files."""
    import numpy as np
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.simulation import load_simulation
    from lightdock_tpu_torch.utils.positions import split_positions

    for method, atoms, num_anm in (("dfire", DFIRE_ATOMS, 0), ("dna", DNA_ATOMS, DNA_ANM),
                                   ("pydock", DNA_ATOMS, 0)):
        root = work / f"scorer_{method}"
        setup, (pos,) = standin.write_complex(root, method, *atoms, HOST_SCORER_POSES,
                                              num_anm=num_anm, seed=SEED)
        sim = load_simulation(setup, pos, method, anm_dir=root)
        poses = list(zip(*split_positions(sim.positions, sim.use_anm, sim.setup.anm_rec,
                                          sim.setup.anm_lig)))
        scores, ms = {}, {}
        for device in ("cuda", "cpu"):
            scorer = sim.host_scorer(device)
            scorer.energy(*poses[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores[device] = np.array([scorer.energy(*p) for p in poses])
            ms[device] = (time.perf_counter() - t0) * 1e3 / len(poses)
        rel = float((np.abs(scores["cuda"] - scores["cpu"]) / np.abs(scores["cpu"])).max())
        say(f"phase 27: [{card}] HostScorer {method} ({atoms[0]} x {atoms[1]} atoms, "
            f"{num_anm} + {num_anm} modes, restraints on both sides): card against CPU on "
            f"{len(poses)} poses max rel diff {rel:.3e} (rtol {HOST_SCORER_RTOL:g}); "
            f"{ms['cuda']:.3f} ms a pose on the card, {ms['cpu']:.3f} ms on the CPU")
        check(bool(np.isfinite(scores["cpu"]).all()), f"phase 27: {method}: non-finite scores")
        check(rel <= HOST_SCORER_RTOL,
              f"phase 27: HostScorer {method}: the card differs from the CPU by {rel:.3e}")


def host_engine_phase(card, counters):
    """Phase 27: the float64 host parity engine's scorer, then its command
    line on the card and on the CPU (see the module docstring)."""
    import numpy as np

    from lightdock_tpu_torch import standin

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        host_scorer_card_vs_cpu(card, work)
        setup, (pos,) = standin.write_complex(work, "dfire", *DFIRE_ATOMS, N_POSES, seed=SEED)
        label = (f"`lightdock-tpu-torch --engine host` 1ppe DFIRE ({DFIRE_ATOMS[0]} x "
                 f"{DFIRE_ATOMS[1]} atoms, {N_POSES} glowworms, {HOST_STEPS} steps)")
        runs = {}
        for device in ("cuda", "cpu"):
            argv = [setup, pos, HOST_STEPS, "dfire", "--engine", "host",
                    "--output-dir", work / f"swarm_{device}"]
            with host_engine_probe() as probe:
                launches, run_s, _ = cli_run(counters, work, argv + (
                    ["--platform", "cpu"] if device == "cpu" else []))
            runs[device] = probe
            energy, later = probe.energy, probe.energy[1:]
            where = "card" if device == "cuda" else "CPU"
            say(f"phase 27: [{card}] {label} on the {where}: {run_s:.3f} s (parsing and "
                f"model building included); {np.mean(probe.steps) * 1e3:.3f} ms a step "
                f"(steps {', '.join(f'{x * 1e3:.1f}' for x in probe.steps)} ms); energy: "
                f"step 1 {energy[0][1] * 1e3:.3f} ms for {energy[0][0]} poses, then "
                f"{np.mean([x[1] for x in later]) * 1e3:.3f} ms a step for "
                f"{np.mean([x[0] for x in later]):.1f} poses on average; kernel launches "
                f"{launches}")
            check(sum(launches.values()) == 0,
                  f"phase 27: the host engine on the {where} launched {launches}")
            check(probe.engine is not None and probe.engine.device.type == device,
                  f"phase 27: the {where} run did not build a GsoHostEngine there")
        card_run, cpu_run = runs["cuda"].engine, runs["cpu"].engine
        same = {s: (work / "swarm_cuda" / f"gso_{s}.out").read_text()
                == (work / "swarm_cpu" / f"gso_{s}.out").read_text() for s in (1, HOST_STEPS)}
        diffs = {name: float(np.abs(getattr(card_run, name) - getattr(cpu_run, name)).max(
            initial=0.0)) for name in HOST_STATE}
        neighbours = bool(np.array_equal(card_run.num_neighbors, cpu_run.num_neighbors))
        say(f"phase 27: {label}: card against CPU: text-identical {same}; final state "
            f"max|diff| " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f" (atol {HOST_STATE_ATOL:g}); neighbour counts equal {neighbours}")
        check(same[1], "phase 27: the card's gso_1.out differs from the CPU's")
        check(max(diffs.values()) <= HOST_STATE_ATOL and neighbours,
              f"phase 27: the card's final state differs from the CPU's: {diffs}")
        check(all(np.isfinite(getattr(card_run, k)).all() for k in HOST_STATE),
              "phase 27: non-finite state on the card")
        # Every pose rescored on a warm card, as at step 1: the run's first
        # call also grew the allocator's pool.
        card_run.moved[:] = True
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            card_run._recompute_energies()
            warm.append(time.perf_counter() - t0)
        say(f"phase 27: [{card}] {label}: all {N_POSES} poses rescored on the warm card, "
            f"{card_run.energy_chunk} a call: {min(warm) * 1e3:.3f} ms (min of 3; "
            f"{', '.join(f'{x * 1e3:.3f}' for x in warm)})")
    say(f"phase 27: [{card}] done in {time.perf_counter() - t_phase:.1f} s")


# -- phase 28: the box cull kernel against its plain version -------------------

def cull_args(path, n, t=None, moved=None):
    """The arguments the path's energy function hands ``cull_tile_bits``
    for its first ``n`` poses (translations ``t`` if given), in its pose
    order, taken from one ``kernel_args`` call."""
    from lightdock_tpu_torch.engine import energy_kernel

    seen, real = [], energy_kernel.cull_tile_bits

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    energy_kernel.cull_tile_bits = spy
    try:
        path.energy_fn.kernel_args(path.tp, *path.pose(n, t), moved)
    finally:
        energy_kernel.cull_tile_bits = real
    check(len(seen) == 1, f"{path.label}: {len(seen)} cull calls in one kernel_args")
    return seen[0]


def cull_min_d2_f64(args):
    """Per cutoff: the float64 lower bound of each output entry of
    ``cull_tile_bits(*args)``, the least over its sub-box pairs (and over
    its chunk's poses where that cutoff is chunked); inf for a pose the
    gate leaves out."""
    import torch
    import torch.nn.functional as F

    from lightdock_tpu_torch.ops import cull
    from lightdock_tpu_torch.ops.dfire_pairs import POSE_BLOCK

    rc, rh, lc, lh, t, rot, slack, _, (rg, lg), chunked, moved = args
    g = t.shape[0]
    n_r, n_l = rc.shape[0] // rg, lc.shape[0] // lg
    f64 = [x.double() for x in (rc, rh, lc, lh, t, rot)]
    s = (torch.zeros(g, dtype=torch.float64, device=t.device) if slack is None
         else slack.double())
    per_pose = torch.empty((g, n_r, n_l), dtype=torch.float64, device=t.device)
    for a in range(0, g, 400):
        b = min(g, a + 400)
        d2 = cull.box_d2_lower_bound(*f64[:4], f64[4][a:b], f64[5][a:b], s[a:b],
                                     torch.zeros_like(s[a:b]))
        per_pose[a:b] = d2.reshape(b - a, n_r, rg, n_l, lg).amin(dim=(2, 4))
    if moved is not None:
        per_pose[~moved] = float("inf")
    per_pose = per_pose.permute(1, 2, 0)
    gp = -(-g // POSE_BLOCK) * POSE_BLOCK
    chunks = F.pad(per_pose, (0, gp - g), value=float("inf")).reshape(
        n_r, n_l, gp // POSE_BLOCK, POSE_BLOCK).amin(dim=-1)
    return [chunks if c else per_pose for c in chunked]


def cull_case(label, args):
    """The cull kernel against its plain version on ``args``: every bit
    equal but where the entry's float64 lower bound lies within
    ``CULL_EDGE_REL`` of the cutoff^2, no entry that bound keeps dropped,
    two launches equal, one launch a call, and the counts equal to the
    per-pose bits' sums.  Returns the max |kernel - plain| off that band."""
    import torch

    from lightdock_tpu_torch.ops import cull

    rc, rh, lc, lh, t, rot, slack, cuts, groups, chunked, moved = args
    before = cull.cull_tile_bits.launches
    bits, counts = cull.cull_tile_bits(*args, count=True)
    again, _ = cull.cull_tile_bits(*args)
    per_pose, _ = cull.cull_tile_bits(*args[:9], (False,) * len(cuts), moved)
    torch.cuda.synchronize()
    check(cull.cull_tile_bits.launches == before + 3, f"{label}: the cull kernel did not launch")
    plain = cull.cull_tile_bits_plain(*args)
    bound = cull_min_d2_f64(args)
    err, notes = 0, []
    for k, c in enumerate(cuts):
        c2 = float(c) ** 2
        keep = bound[k] <= c2
        edge = (bound[k] - c2).abs() <= CULL_EDGE_REL * c2
        kern, ref = bits[k] != 0, plain[k] != 0
        check(bits[k].shape == plain[k].shape and bits[k].dtype == torch.int32,
              f"{label}: cutoff {c}: bits {tuple(bits[k].shape)} {bits[k].dtype}, plain "
              f"{tuple(plain[k].shape)}")
        check(torch.equal(bits[k], again[k]), f"{label}: cutoff {c}: two launches differ")
        check(not bool((keep & ~kern).any()),
              f"{label}: cutoff {c}: the kernel drops an entry the float64 bound keeps")
        off = (kern != ref) & ~edge
        err = max(err, int(off.any()))
        notes.append(f"{c} A {int((kern != ref).sum())} of {kern.numel()} differ "
                     f"({int(edge.sum())} on the edge), {int(kern.sum())} set")
    g = t.shape[0]
    n_r, n_l = rc.shape[0] // groups[0], lc.shape[0] // groups[1]
    live = g if moved is None else int(moved.sum())
    checked, kept = (int(x) for x in counts.to(torch.int64).sum(dim=0))
    say(f"phase 28: {label}: cutoffs " + "; ".join(notes)
        + f"; counts checked {checked}, kept {kept}")
    check(err == 0, f"{label}: the cull kernel's bits differ from plain off the cutoff edge")
    check(checked == live * n_r * n_l and kept == int(per_pose[0].sum()),
          f"{label}: counts {checked}, {kept} against {live * n_r * n_l}, "
          f"{int(per_pose[0].sum())}")
    return err


def cull_bound(args, out):
    """The cull kernel's bound on one call (``bound``'s contract): the
    sub-box pairs of real boxes and live poses at ``FLOPS_CULL`` and a
    compare a cutoff each, against the bytes it reads and writes."""
    import torch

    rc, rh, lc, lh, t, rot, slack, cuts, _, _, moved = args
    live = t.shape[0] if moved is None else int(moved.sum())
    real = (int(torch.isfinite(rh).all(dim=1).sum())
            * int(torch.isfinite(lh).all(dim=1).sum()))
    ops = live * real * (FLOPS_CULL + len(cuts))
    nbytes = sum(x.numel() * x.element_size()
                 for x in (rc, rh, lc, lh, t, rot, slack, moved, *out) if x is not None)
    ms_ops, ms_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ms_ops, "operations") if ms_ops >= ms_bytes else (ms_bytes, "bytes")


def cull_phase(card, paths, culls):
    """Phase 28: the box cull kernel (``ops.cull.cull_tile_bits``) against
    its plain version on the inputs the energy path builds: the 1k4c
    stand-in at 6,400 poses (the membrane cell's call) and each driven
    path at 200 poses, with and without the moved gate; its launches in
    each path's main run (one a step); none with ``cull=False``; its ms a
    call, its plain version's and its bound at 6,400 and 200 poses.
    Returns the cull's entry of the kernels line."""
    import torch

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.engine.energy_kernel import (kernel_params,
                                                          make_kernel_energy_fn)
    from lightdock_tpu_torch.ops import cull

    t_phase = time.perf_counter()
    say(f"phase 28: [{card}] cull launches in the paths' main runs: {culls}")
    big = KernelPath("1k4c DFIRE membrane, a farm call",
                     (*standin.membrane_system(CULL_BATCH), 0))
    gen = torch.Generator(device="cuda").manual_seed(28)
    err, mains = 0, {}
    for path, n in [(big, CULL_BATCH)] + [(p, N_POSES) for p in paths]:
        # One swarm 45 A out along x at the path's own pose spread: part
        # of each tile grid culled at 200 poses; the 6,400 farm poses as
        # they are.
        t = None if n == CULL_BATCH else path.pos[:n, :3] * 0.5 + [45.0, 0.0, 0.0]
        for gated in (False, True):
            moved = (torch.rand(n, generator=gen, device="cuda") < 0.6) if gated else None
            args = cull_args(path, n, t, moved)
            check(len(args[7]) in (2, 3), f"{path.label}: {len(args[7])} cutoffs")
            err = max(err, cull_case(f"{path.label} G={n} moved_gate={gated}", args))
            if not gated and path in (big, paths[0]):
                mains[n] = args
    # cull=False: all-ones bits and no kernel launch.
    p = paths[0]
    gen_name = "v1" if p.energy_mode == "kernel_v1" else "v2"
    fn = make_kernel_energy_fn(kernel_params(p.params, gen_name), "cuda", torch.float32,
                               cull=False, kernel=gen_name)
    before = cull.cull_tile_bits.launches
    args, _ = fn.kernel_args(p.tp, *p.pose(N_POSES))
    torch.cuda.synchronize()
    check(cull.cull_tile_bits.launches == before and bool((args[-2] == 1).all())
          and bool((args[-1] == 1).all()),
          f"{p.label}: cull=False launched the cull kernel or culled")
    say(f"phase 28: {p.label} cull=False: no cull launch, every bit 1")
    times = {}
    for n, args in sorted(mains.items(), reverse=True):
        ms = cuda_ms(lambda: cull.cull_tile_bits(*args), 200)
        ms_count = cuda_ms(lambda: cull.cull_tile_bits(*args, count=True), 200)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain_ms = cuda_ms(lambda: cull.cull_tile_bits_plain(*args), 5)
        temps = torch.cuda.max_memory_allocated() - base
        out, _ = cull.cull_tile_bits(*args)
        bnd = cull_bound(args, out)
        rc, lc, (rg, lg) = args[0], args[2], args[8]
        times[n] = (ms, plain_ms, bnd)
        say(f"phase 28: [{card}] cull kernel at G={n} ({rc.shape[0]} x {lc.shape[0]} "
            f"sub-boxes, groups {rg} x {lg}, {len(args[7])} cutoffs): {ms:.4f} ms a call "
            f"({ms_count:.4f} ms counting; CUDA events, mean of 200), plain "
            f"{plain_ms:.3f} ms (mean of 5; {temps / 1e9:.2f} GB of temporaries), bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.1f}x the bound")
    total = sum(culls.values())
    say(f"phase 28: [{card}] done in {time.perf_counter() - t_phase:.1f} s")
    ms, plain_ms, bnd = times[CULL_BATCH]
    return record("cull_bits", "lightdock_tpu_torch/csrc/cull_bits.cu",
                  "lightdock_tpu/ops/pallas_energy.py:1661", total, float(err),
                  ms, plain_ms, bnd)


def record(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None,
           rank_launches=None, mixed_launches=None, workflow_launches=None,
           bench_launches=None):
    """A kernel's entry of the kernels line; ``rank_launches`` maps each
    sharded phase to the kernel's launches on each of its ranks,
    ``mixed_launches`` each of phase 24's sites (a float64 state scored at
    float32), ``workflow_launches`` each of phase 25's runs and
    ``bench_launches`` each of phase 26's bench runs to the kernel's
    launches there."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
            "rank_launches": rank_launches or {}, "mixed_launches": mixed_launches or {},
            "workflow_launches": workflow_launches or {},
            "bench_launches": bench_launches or {}}


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

    from lightdock_tpu_torch import standin
    from lightdock_tpu_torch.ops import _build
    from lightdock_tpu_torch.ops import dfire_pairs as dp
    from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4
    from lightdock_tpu_torch.ops import elec_vdw_pairs as ev
    from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()

    # -- 1. the card and the build ------------------------------------------
    say(card)
    say(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.load_all(["dfire_pairs", "elec_vdw_pairs", "dfire_pairs_v1",
                             "elec_vdw_pairs_v1", "probes", "cull_bits", "io_native"])
    build_s = time.perf_counter() - t0
    for name, lib in built.items():
        if name == "io_native":
            say(f"phase 1: built {lib.path.name} (the host IO library, "
                f"{_build.find_cxx()} {lib.build_seconds:.2f} s)")
            continue
        ptxas = [ln.strip() for ln in lib.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        say(f"phase 1: built {lib.path.name} (nvcc {lib.build_seconds:.2f} s); "
            f"ptxas: {' | '.join(ptxas) or 'reused'}")
    say(f"phase 1: all {len(built)} sources built in {build_s:.2f} s")
    occ = occupancy(built["dfire_pairs"].lib)
    say("phase 1: DFIRE kernels: " + "; ".join(
        f"{k} {regs} registers, {warps} resident warps an SM"
        for k, (regs, warps) in occ.items()))
    occ_ev = ev_occupancy(built)
    say("phase 1: elec/vdw kernels: " + "; ".join(
        f"{k} {regs} registers, {local} B local, {warps} resident warps an SM"
        for k, (regs, local, warps) in occ_ev.items()))
    blocks, regs, smem = (ctypes.c_int() for _ in range(3))
    check(built["cull_bits"].lib.cull_bits_occupancy(
        ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(smem)) == 0,
        "cull_bits_occupancy failed")
    say(f"phase 1: box cull kernel: {regs.value} registers, {smem.value} B shared, "
        f"{blocks.value * 4} resident warps an SM")
    occ_k4 = k4_occupancy(built, 21, 32)
    say("phase 1: step-form DFIRE kernel (21 channels, 32-row tiles): " + "; ".join(
        f"{k} {regs} registers, {local} B local, {warps} resident warps an SM"
        for k, (regs, local, warps) in occ_k4.items()))

    counters = pair_kernels()
    culls = {}   # the box cull's launches in each path's main run
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.RandomState(SEED)

    # -- 2-5. the DFIRE path and K1 -----------------------------------------
    dfire = KernelPath("1ppe DFIRE", standin.toy_system(*DFIRE_ATOMS, N_POSES))
    check(dfire.kernel is dp.dfire_pairs, "the 1ppe path did not choose K1")
    k1_err, k1_main = kernel_cases(dfire, 2, gen, rng)
    k1_edge_err, k2_edge_err = edge_cases(2)
    k1_err = max(k1_err, k1_edge_err)
    k1_launches, step1, culls[dfire.label] = drive(dfire, counters, 3)
    oracle(dfire, step1, 3)
    k1_ms, k1_plain_ms = timing(dfire, k1_main, card, (4, 5))
    occupancy_report(4, card, f"1ppe DFIRE, K1 at G={N_POSES}", dp.dfire_pairs, k1_main,
                     occ)

    # -- 6-8. the DNA + ANM path and K3 --------------------------------------
    rigid = KernelPath("1azp DNA rigid", standin.toy_system(*DNA_ATOMS, N_POSES,
                                                            method="dna"))
    k3_err, k3_rigid_main = kernel_cases(rigid, 6, gen, rng)
    dna = KernelPath("1azp DNA + ANM", standin.toy_system(
        *DNA_ATOMS, N_POSES, num_anm=DNA_ANM, method="dna"))
    err, k3_main = kernel_cases(dna, 6, gen, rng)
    k3_err = max(k3_err, err, cutoff_edges(6, ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain,
                                           pose_bits=False))
    f64_errors(dna, k3_main, 6)
    coincident_pair(6, ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain, "K3")
    k3_launches, step1, culls[dna.label] = drive(dna, counters, 7)
    oracle(dna, step1, 7)
    k3_ms, k3_plain_ms = timing(dna, k3_main, card, (8, 8))
    ev_systems = {"rigid": standin.toy_system(*DNA_ATOMS, EV_BATCH, method="dna"),
                  "per-pose": standin.toy_system(*DNA_ATOMS, EV_BATCH, num_anm=DNA_ANM,
                                                 method="dna")}
    err = ev_sizes(8, card, "K3", ev.elec_vdw_pairs, ev.elec_vdw_pairs_plain, {
        f"rigid G={N_POSES}": k3_rigid_main, f"per-pose G={N_POSES}": k3_main,
        **ev_batch_mains(ev_systems, "kernel")}, occ_ev)
    k3_err = max(k3_err, err)

    # -- 9. K1 with a per-pose receptor: the DFIRE + ANM path ----------------
    anm = KernelPath("1ppe DFIRE + ANM", standin.toy_system(
        *DFIRE_ATOMS, N_POSES, num_anm=DNA_ANM))
    check(anm.kernel is dp.dfire_pairs, "the DFIRE + ANM path did not choose K1")
    err, anm_main = kernel_cases(anm, 9, gen, rng)
    k1_err = max(k1_err, err)
    anm_launches, step1, culls[anm.label] = drive(anm, counters, 9, steps=ANM_STEPS)
    oracle(anm, step1, 9)

    # -- 10. K2 against plain, K1 and an empty list at the 1k4c shapes -------
    k4c = KernelPath("1k4c DFIRE membrane", (*standin.membrane_system(N_POSES), 0))
    check(k4c.kernel is dp.dfire_pairs_worklist, "the 1k4c path did not choose K2")
    k2_err, k2_main = kernel_cases(k4c, 10, gen, rng)
    k2_err = max(k2_err, k2_edge_err, worklist_checks(k4c, anm, gen, k2_main, 10))

    # -- 11. the 1k4c-shaped DFIRE membrane path -----------------------------
    active_share(k4c, 11)
    k2_launches, step1, culls[k4c.label] = drive(k4c, counters, 11)
    oracle(k4c, step1, 11)

    # -- 12. K2's timings ----------------------------------------------------
    k2_ms, k1_same_ms = worklist_timing(k4c, k2_main, card, 12)
    k1_pp_ms = cuda_ms(lambda: dp.dfire_pairs(*anm_main[0], **anm_main[1]), 200)
    _, k2_plain_ms = timing(k4c, k2_main, card, (12, 12), plain_reps=2)
    occupancy_report(12, card, f"1k4c DFIRE membrane, K2 at G={N_POSES}",
                     dp.dfire_pairs_worklist, k2_main, occ)
    # -- 13-14. the 1ppe v1 DFIRE path and K4 ---------------------------------
    dfire_v1 = KernelPath("1ppe DFIRE v1", standin.toy_system(
        *DFIRE_ATOMS, N_POSES, dfire_mode="steps"), energy_mode="kernel_v1")
    check(dfire_v1.kernel is k4.dfire_pairs_v1, "the 1ppe v1 path did not choose K4")
    k4_err, k4_main = v1_kernel_cases(dfire_v1, 13, gen, rng)
    k4_launches, step1, culls[dfire_v1.label] = drive(dfire_v1, counters, 14)
    oracle(dfire_v1, step1, 14)
    k4_ms, k4_plain_ms = timing(dfire_v1, k4_main, card, (14, 14))
    k4_err = max(k4_err, k4_phase(14, card, dfire_v1, occ_k4))

    # -- 15. K5 and the 1azp DNA + ANM v1 path ---------------------------------
    rigid_v1 = KernelPath("1azp DNA rigid v1", standin.toy_system(
        *DNA_ATOMS, N_POSES, method="dna"), energy_mode="kernel_v1")
    k5_err, k5_rigid_main = v1_kernel_cases(rigid_v1, 15, gen, rng)
    dna_v1 = KernelPath("1azp DNA + ANM v1", standin.toy_system(
        *DNA_ATOMS, N_POSES, num_anm=DNA_ANM, method="dna"), energy_mode="kernel_v1")
    check(dna_v1.kernel is k5.elec_vdw_pairs_v1, "the 1azp v1 path did not choose K5")
    err, k5_main = v1_kernel_cases(dna_v1, 15, gen, rng)
    k5_err = max(k5_err, err, cutoff_edges(15, k5.elec_vdw_pairs_v1,
                                           k5.elec_vdw_pairs_v1_plain, pose_bits=True))
    coincident_pair(15, k5.elec_vdw_pairs_v1, k5.elec_vdw_pairs_v1_plain, "K5")
    k5_launches, step1, culls[dna_v1.label] = drive(dna_v1, counters, 15)
    oracle(dna_v1, step1, 15)
    k5_ms, k5_plain_ms = timing(dna_v1, k5_main, card, (15, 15))
    err = ev_sizes(15, card, "K5", k5.elec_vdw_pairs_v1, k5.elec_vdw_pairs_v1_plain, {
        f"rigid G={N_POSES}": k5_rigid_main, f"per-pose G={N_POSES}": k5_main,
        **ev_batch_mains(ev_systems, "kernel_v1")}, occ_ev)
    k5_err = max(k5_err, err)

    # -- 16-17. the farm -------------------------------------------------------
    err, err_v1, farm_step1, farm_poses_s = farm_phases(card, counters, occ)
    k1_err, k4_err = max(k1_err, err), max(k4_err, err_v1)

    # -- 18. the table-selection probes P1-P6 ------------------------------------
    probe_records = probe_phase(card, built["probes"])

    # -- 19-20. the command line ------------------------------------------------
    cli_path_phase(card, counters)
    glob_poses_s = cli_rest_phase(card, counters)

    # -- 21-23. ranks of torch.distributed on the card ---------------------------
    by_rank = sharded_swarm_phase(card, dfire.poses_per_s)
    k1_err = max(k1_err, by_rank["dfire_pairs"][1])
    k3_err = max(k3_err, by_rank["elec_vdw_pairs"][1])
    k1_sites = {"phase 21": by_rank["dfire_pairs"][0],
                "phase 22": grid_farm_phase(card, farm_step1, farm_poses_s),
                "phase 23": cli_ranks_phase(card, counters)}
    k3_sites = {"phase 21": by_rank["elec_vdw_pairs"][0]}

    # -- 24. a float64 state scored at float32; the precision tool ----------------
    mixed_sites = mixed_phase(card, counters)

    # -- 25. setup, the run and the analysis from raw PDB files ------------------
    k1_workflow, k3_workflow = workflow_phase(card, counters, glob_poses_s)

    # -- 26. the benchmark entry point and the crossover map ----------------------
    bench_sites = bench_phase(card)

    # -- 27. the float64 host parity engine --------------------------------------
    host_engine_phase(card, counters)

    # -- 28. the box cull kernel ---------------------------------------------------
    cull_record = cull_phase(card, [dfire, dna, k4c, dfire_v1, dna_v1], culls)

    check("jax" not in sys.modules and not any(
        m == "lightdock_tpu" or m.startswith("lightdock_tpu.") for m in sys.modules),
        "the port imported jax or the JAX package")

    out = dp.dfire_pairs(*k1_main[0], **k1_main[1])
    k1_bound = bound(k1_main, out)
    out = ev.elec_vdw_pairs(*k3_main[0], **k3_main[1])
    k3_bound = bound(k3_main, out, ev=True)
    out = dp.dfire_pairs_worklist(*k2_main[0], **k2_main[1])
    k2_bound = bound(k2_main, out)
    out = dp.dfire_pairs(*anm_main[0], **anm_main[1])
    pp_bound = bound(anm_main, out)
    out = k4.dfire_pairs_v1(*k4_main[0], **k4_main[1])
    k4_bound = bound_v1(k4_main, out, FLOPS_DFIRE)
    out = k5.elec_vdw_pairs_v1(*k5_main[0], **k5_main[1])
    k5_bound = bound_v1(k5_main, out, FLOPS_EV_NEAR)
    say(f"phase 15: [{card}] bounds: K4 {k4_bound[0]:.4f} ms ({k4_bound[1]}), "
        f"K5 {k5_bound[0]:.4f} ms ({k5_bound[1]})")
    say(f"phase 12: [{card}] bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), "
        f"K3 {k3_bound[0]:.4f} ms ({k3_bound[1]}), K2 {k2_bound[0]:.4f} ms "
        f"({k2_bound[1]}); K1 on K2's inputs {k1_same_ms:.4f} ms; K1 with a "
        f"per-pose receptor (phase 9 inputs, G={N_POSES}) {k1_pp_ms:.4f} ms a "
        f"call, bound {pp_bound[0]:.4f} ms ({pp_bound[1]}); DFIRE + ANM path "
        f"K1 launches {anm_launches} in {ANM_STEPS} steps; whole run "
        f"{time.perf_counter() - t_start:.1f} s")

    pallas = "lightdock_tpu/ops/pallas_energy.py"
    say(json.dumps({"kernels": [
        record("dfire_pairs", "lightdock_tpu_torch/csrc/dfire_pairs.cu",
               f"{pallas}:1088", k1_launches, k1_err, k1_ms, k1_plain_ms, k1_bound,
               rank_launches=k1_sites, mixed_launches=mixed_sites["dfire_pairs"],
               workflow_launches=k1_workflow,
               bench_launches=bench_sites.get("dfire_pairs")),
        record("elec_vdw_pairs", "lightdock_tpu_torch/csrc/elec_vdw_pairs.cu",
               f"{pallas}:1325", k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound,
               rank_launches=k3_sites, mixed_launches=mixed_sites["elec_vdw_pairs"],
               workflow_launches=k3_workflow,
               bench_launches=bench_sites.get("elec_vdw_pairs")),
        record("dfire_pairs_worklist", "lightdock_tpu_torch/csrc/dfire_pairs.cu",
               f"{pallas}:1115", k2_launches, k2_err, k2_ms, k2_plain_ms, k2_bound,
               bench_launches=bench_sites.get("dfire_pairs_worklist")),
        record("dfire_pairs_v1", "lightdock_tpu_torch/csrc/dfire_pairs_v1.cu",
               f"{pallas}:213", k4_launches, k4_err, k4_ms, k4_plain_ms, k4_bound,
               mixed_launches=mixed_sites["dfire_pairs_v1"]),
        record("elec_vdw_pairs_v1", "lightdock_tpu_torch/csrc/elec_vdw_pairs_v1.cu",
               f"{pallas}:364", k5_launches, k5_err, k5_ms, k5_plain_ms, k5_bound),
        cull_record,
        *probe_records,
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
