"""Exact row-wise top-k with the ``lax.top_k`` contract.

Counterpart of asr_streaming_tpu/ops/topk.py.  Values descending, ties
to the lowest index, indices int32: ``torch.topk`` promises no tie order,
and the RNNT beam's dedupe ("earliest wins") depends on one, so nothing
here calls it.

``iter_topk`` is the JAX function's twin, line by line: one block-max
pass over the row, then k selection rounds that each pick the winning
128-wide block, take its first-occurrence max and knock the pick out by
recomputing that block's max over the remaining lanes.  It is the plain
version of the CUDA kernel in ``ops/row_topk.py`` and the CPU path.

``row_topk`` is what callers use: a CUDA tensor goes to the kernel, a
CPU tensor to ``iter_topk``; both compute the same function, values and
indices.

Input domain: finite f32 values and -inf; NaN is not supported.  With
k > 128 a row that holds -inf cannot be selected correctly (an exhausted
block's cached max, -inf, ties the real -inf entries of later blocks and
wins by its lower index): such input raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_BLOCK = 128


def iter_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis.

    x: [..., N] floating point, N >= k.  Returns (values [..., k] x.dtype,
    indices [..., k] int32), descending, ties to the lowest index.
    """
    if x.ndim == 1:
        v, i = iter_topk(x[None], k)
        return v[0], i[0]
    lead = x.shape[:-1]
    N = x.shape[-1]
    if N < k:
        raise ValueError(f"iter_topk: N={N} < k={k}")
    xf = x.reshape(-1, N).to(torch.float32)
    R = xf.shape[0]
    if k > _BLOCK and bool(torch.isneginf(xf).any()):
        raise ValueError(
            f"iter_topk: k={k} > {_BLOCK} on rows that hold -inf is not "
            "supported (an emptied block would tie them)")
    NB = -(-N // _BLOCK)
    pad = NB * _BLOCK - N
    if pad:
        xf = F.pad(xf, (0, pad), value=float("-inf"))
    xb = xf.reshape(R, NB, _BLOCK)
    bm = xb.amax(-1)                                            # [R, NB]

    dev = x.device
    iota_nb = torch.arange(NB, device=dev).expand(R, NB)
    iota_bk = torch.arange(_BLOCK, device=dev).expand(R, _BLOCK)
    nb_fill = torch.full_like(iota_nb, NB)
    bk_fill = torch.full_like(iota_bk, _BLOCK)
    neg_inf = torch.full((), float("-inf"), device=dev)

    vals, idxs, picks = [], [], []
    for _ in range(k):
        m = bm.amax(-1)                                         # [R]
        # winning block: first block holding the max (ties -> lower index)
        bidx = torch.where(bm == m[:, None], iota_nb, nb_fill).amin(-1)
        block = torch.gather(
            xb, 1, bidx[:, None, None].expand(R, 1, _BLOCK))[:, 0]  # [R, 128]
        # eligibility is positional (no value sentinel): in-range lanes of
        # this block that no earlier round picked
        elig = (bidx[:, None] * _BLOCK + iota_bk) < N
        for pb, pw in picks:
            elig = elig & ~((pb == bidx)[:, None] & (iota_bk == pw[:, None]))
        widx = torch.where((block == m[:, None]) & elig, iota_bk,
                           bk_fill).amin(-1)
        vals.append(m)
        idxs.append(bidx * _BLOCK + widx)
        picks.append((bidx, widx))
        # knock the pick out of the block-max cache: this block's max over
        # its remaining eligible lanes (xb itself is never written)
        rem = elig & (iota_bk != widx[:, None])
        new_bm = torch.where(rem, block, neg_inf).amax(-1)
        bm = torch.where(iota_nb == bidx[:, None], new_bm[:, None], bm)

    v = torch.stack(vals, -1).to(x.dtype).reshape(*lead, k)
    i = torch.stack(idxs, -1).to(torch.int32).reshape(*lead, k)
    return v, i


def iter_topk_values(x: torch.Tensor, k: int) -> torch.Tensor:
    """Values-only top-k (the contract of ``iter_topk(x, k)[0]``)."""
    return iter_topk(x, k)[0]


def row_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, by the tensor's device: the CUDA kernel
    (``ops/row_topk.py``) on the card, ``iter_topk`` on the CPU.  Same
    values and indices either way."""
    if x.device.type == "cpu":
        return iter_topk(x, k)
    from asr_streaming_tpu_torch.ops.row_topk import cuda_row_topk
    return cuda_row_topk(x, k)
