"""Device kernel time in the traced part over the group steps dispatched
in it (a closed loop).  Kernels whose records the profiler dropped count
at their recorded time per launch times their counted launches."""

from perfbench.metrics import _kernels


def read(run):
    t = run.trace
    if run.loop != "closed" or t is None or not t.steps():
        return None
    total = _kernels.all_kernels_s(t)
    return None if total is None else total / t.steps() * 1e3
