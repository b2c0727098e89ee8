"""Row-wise top-k: the CUDA kernel's wrapper.

Counterpart of asr_streaming_tpu/ops/pallas_topk.py::pallas_row_topk, the
RNNT beam's per-hypothesis candidate preselect.  Top-k along the last
axis for k <= 128 and N >= k (both raise otherwise, as the JAX wrapper
does), N <= ``max_n(k)``: values descending, ties to the lowest index,
the input cast to f32, values returned in the input's dtype, indices
int32, any leading shape.  Domain: finite f32 (and -inf, selected by position like any
value); NaN is not supported.

``cuda_row_topk`` launches ``csrc/row_topk.cu`` and takes CUDA tensors
only.  Its plain version is ``ops/topk.py::iter_topk``, which computes
the same values and indices; ``ops/topk.py::row_topk`` picks between the
two by the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from asr_streaming_tpu_torch.ops import _cuda

# launches of the CUDA kernel
LAUNCHES = 0

MAX_K = 128
# The widest row the kernel takes: rows up to 256 go to the narrow kernel
# at any k; wider ones with k <= 16 to the wide kernel, which streams a
# row through registers (capped at 2^24 values, 64 MB a row, one block
# walking it), and with k > 16 to the block kernel, which stages the row
# in shared memory at 5 bytes a value (46,000 within a block's 227 KB).
MAX_N = 1 << 24
MAX_N_LARGE_K = 46_000
WIDE_K = 16


def max_n(k: int) -> int:
    """The widest row the kernel takes at this k."""
    return MAX_N if k <= WIDE_K else MAX_N_LARGE_K


def check_args(shape, k: int) -> None:
    """Raise ValueError for a shape [..., N] and k the kernel does not
    take (any device: the limits are the kernel's contract)."""
    if len(shape) < 1:
        raise ValueError(f"row_topk: shape {tuple(shape)}")
    if k > MAX_K or k < 1:
        raise ValueError(f"row_topk: k={k} not in 1..{MAX_K}")
    N = shape[-1]
    if N < k:
        raise ValueError(f"row_topk: N={N} < k={k}")
    if N > max_n(k):
        raise ValueError(f"row_topk kernel: N={N} > {max_n(k)} at k={k}")


def cuda_row_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(values [..., k] x.dtype, indices [..., k] int32) of a CUDA tensor
    x [..., N]; raises for anything the kernel does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"cuda_row_topk: tensor on {x.device}, not on a "
                         "CUDA device (ops/topk.py::row_topk dispatches)")
    if not x.is_floating_point() or x.ndim < 1:
        raise ValueError(f"cuda_row_topk: {x.dtype} {tuple(x.shape)}")
    check_args(x.shape, k)
    _cuda.refuse_grad("row_topk", x)
    lead, N = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, N).to(torch.float32).contiguous()
    R = xf.shape[0]
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    if R:
        _cuda.launch(
            x.device, "asr_row_topk", "row_topk",
            xf.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, N, k,
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
    return vals.to(x.dtype).reshape(*lead, k), idx.reshape(*lead, k)
