"""Poses docked a second: swarms x glowworms x steps of every job that
finished, over the time from the first job's start to the last job's end
(the window's whole time, preparation, steps and writes)."""

NAME = "poses_per_s"
UNIT = "poses/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if not run.done:
        return None
    return sum(j["poses"] for j in run.done) / run.window_s()
