"""In-place per-slot emission append: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_append.py::emission_append.
For every slot with ``decode[b]``: ``buf[b, pos[b]:pos[b]+U] = rows[b]``
(rounded to the buffer's float16), other rows untouched, in place.  The
buffer is native ``torch.float16 [B, MAX_T, V]`` (the JAX package's f32
bit-pair packing exists only for Mosaic).  ``pos`` should lie in
``[0, MAX_T - U]`` (the serving step clips it); a slot whose pos does not
is left as it is, by the kernel and the plain version alike.

On a CUDA tensor it launches ``csrc/emission_append.cu``; on a CPU tensor
it runs ``emission_append_plain``.
"""

from __future__ import annotations

import torch

from asr_streaming_tpu_torch.ops import _cuda

# launches of the CUDA kernel
LAUNCHES = 0


def emission_append_plain(buf: torch.Tensor, rows: torch.Tensor,
                          pos: torch.Tensor,
                          decode: torch.Tensor) -> torch.Tensor:
    """Gather each slot's U rows at pos, select the new rows where decode,
    scatter back (the JAX package's emission_append_xla) — in place.  A
    slot whose pos lies outside [0, MAX_T - U] keeps its rows."""
    B, max_t, V = buf.shape
    U = rows.shape[1]
    pos = pos.to(torch.int64).view(B, 1)
    write = decode.view(B).bool() & (pos[:, 0] >= 0) & (pos[:, 0] <= max_t - U)
    t_idx = pos.clamp(0, max_t - U) + torch.arange(
        U, device=buf.device).view(1, U)                       # [B, U]
    b_idx = torch.arange(B, device=buf.device).view(B, 1).expand(B, U)
    existing = buf[b_idx, t_idx]                               # [B, U, V]
    new_rows = torch.where(write.view(B, 1, 1), rows.to(buf.dtype), existing)
    buf[b_idx, t_idx] = new_rows
    return buf


def emission_append(buf: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                    decode: torch.Tensor) -> torch.Tensor:
    """Append in place and return ``buf``.  CUDA tensor -> kernel, CPU
    tensor -> plain version."""
    global LAUNCHES
    if buf.device.type == "cpu":
        return emission_append_plain(buf, rows, pos, decode)
    if buf.device.type != "cuda":
        raise ValueError(f"emission_append: unsupported device {buf.device}")
    _cuda.refuse_grad("emission_append", buf, rows)
    B, max_t, V = buf.shape
    U = rows.shape[1]
    if buf.dtype != torch.float16 or not buf.is_contiguous():
        raise ValueError("emission_append kernel: buf must be contiguous "
                         f"float16, got {buf.dtype}")
    if tuple(rows.shape) != (B, U, V):
        raise ValueError(f"rows {tuple(rows.shape)} != {(B, U, V)}")
    if U > max_t:
        raise ValueError(f"U={U} > MAX_T={max_t}")
    for name, t in (("rows", rows), ("pos", pos), ("decode", decode)):
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")
    rows = rows.to(torch.float32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    decode = decode.to(torch.uint8).contiguous()
    _cuda.launch(
        buf.device, "asr_emission_append", "emission_append",
        buf.data_ptr(), rows.data_ptr(), pos.data_ptr(), decode.data_ptr(),
        B, max_t, U, V, torch.cuda.current_stream(buf.device).cuda_stream)
    LAUNCHES += 1
    return buf
