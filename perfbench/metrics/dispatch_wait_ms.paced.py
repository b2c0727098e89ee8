"""Mean time from a paced chunk's due time to the dispatch of the batch
that carried it, over the chunks due in the window that were harvested,
outside the profiled part and the profiler's stop (and a segment
period each side)."""


def read(run):
    if run.loop != "open" or not run.waits_s:
        return None
    return sum(run.waits_s) / len(run.waits_s) * 1e3
