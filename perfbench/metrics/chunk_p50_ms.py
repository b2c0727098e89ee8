"""Median, over every chunk due in a paced window, of the time from its
due time to the tick that returned its result (a chunk never harvested
counts with the drain deadline)."""

from perfbench.stats import percentile


def read(run):
    if run.loop != "open" or not run.latencies_s:
        return None
    return percentile(run.latencies_s, 50) * 1e3
