"""The card's idle share in the traced part of a closed loop: 100 x (1 -
union of device operations / traced seconds)."""


def read(run):
    t = run.trace
    if run.loop != "closed" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
