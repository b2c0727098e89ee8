"""Bytes of kernel E (the row top-k, ``csrc/row_topk.cu``) in the device
beam's group step, from the beam's shapes (``models/rnnt_beam.py`` as of
the benchmark's first version): each frame runs K rounds of a preselect
over [B * W, V] rows (k = min(W, V)) and a flat top-W over [B, W * kcap],
then one end-of-frame top-W over [B, (K + 1) * W]."""


def launch_bytes(rows: int, cols: int, k: int) -> float:
    """Each input value read once (f32), each output written once (an f32
    value and an int32 index)."""
    return float(rows * cols * 4 + rows * k * 8)


def beam_step(B: int, W: int, V: int, K: int, U: int) -> tuple:
    """(launches, bytes) of E in one group step of U frames."""
    kcap = min(W, V)
    frame = K * (launch_bytes(B * W, V, kcap) + launch_bytes(B, W * kcap, W)) \
        + launch_bytes(B, (K + 1) * W, W)
    return U * (2 * K + 1), U * frame
