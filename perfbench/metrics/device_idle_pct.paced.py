"""The card's idle share in the traced part of a paced window."""


def read(run):
    t = run.trace
    if run.loop != "open" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
