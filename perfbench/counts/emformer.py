"""Operations and bytes of one step of kernel A (the whole Emformer stack
in one call).  Frozen copies of ``chip_smoke.py::emformer_flops``,
``stack_flops`` and ``emformer_bytes`` as of the benchmark's first
version."""


def emformer_flops(B, L, D, F, U, R, M, Lc):
    """(product operations, attention operations) of one step, 2 per
    multiply-add: the five projections of every layer, QK^T and PV."""
    T = U + R
    Q = T + (1 if M else 0)
    K = M + R + Lc + U
    proj = 2 * B * (Q * D * D + (M + T) * D * 2 * D + Q * D * D
                    + 2 * T * D * F)
    return float(L * proj), float(L * 2 * 2 * B * Q * K * D)


def stack_flops(B, L, D, F, U, R, M, Lc) -> float:
    return sum(emformer_flops(B, L, D, F, U, R, M, Lc))


def emformer_bytes(B, L, D, F, U, R, M, Lc, wbytes=2) -> float:
    """Bytes one step must move: the weights once (products at ``wbytes``
    a value, biases in bf16, LN f32), the carried state read and written
    (bf16), the chunk in and the output out (f32)."""
    T = U + R
    w = L * (wbytes * (4 * D * D + 2 * D * F) + 2 * (5 * D + F) + 4 * 6 * D)
    state = 2 * L * B * (M + 2 * Lc) * D
    return float(w + 2 * state + 4 * B * T * D + 4 * B * U * D + 6 * B)


def stack_geometry(em: dict, batch: int) -> tuple:
    """(B, L, D, F, U, R, M, Lc) of a configuration's ``emformer``."""
    return (batch, em["num_layers"], em["d_model"], em["ffn_dim"],
            em["segment_length"], em["right_context_length"],
            em["max_memory_size"], em["left_context_length"])
