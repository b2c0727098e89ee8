"""The 95th percentile of the same samples as ``chunk_p50_ms``."""

from perfbench.stats import percentile


def read(run):
    if run.loop != "open" or not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95) * 1e3
