"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12       # bf16 / fp16 tensor cores
INT8_OPS = 1979e12        # int8 tensor cores
F32_FLOPS = 67e12         # f32 outside the tensor cores
HBM_BYTES = 3.35e12       # HBM3 bytes per second


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS):
    """The least time the chip could take: the larger of the operations
    over the compute peak and the bytes over the memory peak."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
