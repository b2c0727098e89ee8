"""Streams one card keeps at real time, in a closed loop: seconds of
audio in every chunk harvested in the window, over the window's wall
seconds (stalls included)."""


def read(run):
    if run.loop != "closed" or run.window_s <= 0:
        return None
    return run.chunks * run.period / run.window_s
