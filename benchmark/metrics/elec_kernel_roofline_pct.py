"""K3's share of its roofline: 100 x the time the H100 needs at least for
the work K3 was asked to do (``ldbench.k3_work``: the poses the program
counted as scored, ``poses_scored``, against every atom pair) over the
device time of the kernels ``elec_kernel_ms.step`` names.  The work is
counted from poses and atom pairs, not from the kernel's tiles, so a later
K3 is read against the same work and the share cannot pass 100%.  A
program without the kernels or the counter gives nothing."""

from ldbench import k3_work, manifest, program_trace

NAME = "elec_kernel_roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "pair kernel K3"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    ns = manifest.metric("elec_kernel_ms.step").device_ns(run)
    jobs = program_trace.traced(run)
    poses = sum(c.get("poses_scored", 0) for _, _, c in jobs)
    if ns is None or not poses:
        return None
    n_rec, n_lig = k3_work.atoms(jobs[0][0]["dir"])
    calls = sum(j["steps"] for j, _, _ in jobs)
    ops, nbytes = k3_work.work(poses, n_rec, n_lig, calls)
    return 100.0 * k3_work.bound_s(ops, nbytes) / (ns * 1e-9)
