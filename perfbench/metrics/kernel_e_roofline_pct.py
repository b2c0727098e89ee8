"""Kernel E's (the row top-k's) share of its roofline in the traced part:
the least time for its bytes over the counted launches
(``counts/topk.py``), over its device time."""

from perfbench.counts.peaks import HBM_BYTES
from perfbench.counts.topk import beam_step
from perfbench.metrics import _kernels


def read(run):
    t, m = run.trace, run.model
    if t is None or m["kind"] != "rnnt":
        return None
    launches = t.counted.get("call.row_topk", 0)
    secs = _kernels.kernel_e_s(t)
    if not launches or not secs:
        return None
    per_step, step_bytes = beam_step(
        run.slots_per_group, m["beam_width"], m["vocab_size"],
        m["max_symbols_per_frame"], m["emformer"]["segment_length"])
    return 100.0 * (launches / per_step) * step_bytes / HBM_BYTES / secs
