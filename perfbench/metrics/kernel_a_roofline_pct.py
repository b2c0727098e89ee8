"""Kernel A's share of its roofline in the traced part: the least time
the chip needs for A's operations and bytes at the group's shape
(``counts/emformer.py``), times the steps, over A's device time."""

from perfbench.counts.emformer import emformer_bytes, stack_flops, stack_geometry
from perfbench.counts.peaks import bound_s
from perfbench.metrics import _kernels


def read(run):
    t = run.trace
    if t is None or not t.steps():
        return None
    secs = _kernels.kernel_a_s(t)
    if not secs:
        return None
    geo = stack_geometry(run.model["emformer"], run.slots_per_group)
    bound = bound_s(stack_flops(*geo), emformer_bytes(*geo))
    return 100.0 * bound * t.steps() / secs
