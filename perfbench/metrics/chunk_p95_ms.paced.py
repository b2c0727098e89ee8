"""The 95th percentile of a paced chunk's time from its due time to the
tick that returned its result, over the chunks that ``dispatch_wait_ms.paced``
reads: those due in the window and harvested, outside the profiled part and
the profiler's stop (and a segment period each side)."""

from perfbench.stats import percentile


def read(run):
    if run.loop != "open" or not run.quiet_latencies_s:
        return None
    return percentile(run.quiet_latencies_s, 95) * 1e3
