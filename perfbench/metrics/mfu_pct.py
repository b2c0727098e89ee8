"""The serving step's share of the card's bf16 peak: model operations of
the chunks harvested in the window (``counts/model.py``) over the window
times 989 TFLOP/s."""

from perfbench.counts.peaks import BF16_FLOPS


def read(run):
    if run.loop != "closed" or run.window_s <= 0:
        return None
    return 100.0 * run.chunks * run.chunk_flops() / (run.window_s * BF16_FLOPS)
