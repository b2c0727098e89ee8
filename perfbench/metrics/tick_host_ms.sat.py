"""Host wall time per ``GroupedScheduler.tick()`` in a closed loop: the
total over the count, every tick of the window outside the profiled
part."""


def read(run):
    if run.loop != "closed" or not run.tick_s:
        return None
    return sum(run.tick_s) / len(run.tick_s) * 1e3
