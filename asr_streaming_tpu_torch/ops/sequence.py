"""Sequence tensor utilities.

Counterpart of asr_streaming_tpu/ops/sequence.py: padding masks, masked
statistics, length regulation (duration -> frame expansion by a 0/1
alignment matrix product), word-level pooling by a one-hot product, and
FFT convolution on ``torch.fft`` (used for RIR augmentation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def make_padding_mask(lens: torch.Tensor, max_time: int) -> torch.Tensor:
    """[B, T] True = valid."""
    return torch.arange(max_time, device=lens.device)[None, :] < lens[:, None]


def compute_statistic(x: torch.Tensor, lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-sequence mean and std over time.  x [B, T, D]."""
    mask = make_padding_mask(lens, x.shape[1])[:, :, None].to(x.dtype)
    T = mask.sum(1)
    mean = (x * mask).sum(1) / T
    var = ((x - mean[:, None]).square() * mask).sum(1) / T
    return mean, torch.sqrt(var)


def length_regulator(x: torch.Tensor, x_mask: torch.Tensor,
                     durs: torch.Tensor, max_out: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand tokens by durations through a 0/1 alignment matrix.
    x [B, Tx, D], x_mask [B, Tx], durs [B, Tx] int; the output has
    ``max_out`` frames (default: the longest expansion)."""
    y_lens = durs.sum(1)
    t_y = int(max_out) if max_out is not None else int(y_lens.max())
    cum = torch.cumsum(durs, 1)                            # [B, Tx]
    # align[b, i, j] = 1 iff sum(durs[:i]) <= j < sum(durs[:i+1])
    j = torch.arange(t_y, device=x.device)[None, None, :]
    upper = cum[:, :, None]
    lower = F.pad(cum[:, :-1], (1, 0))[:, :, None]
    align = ((j >= lower) & (j < upper)).to(x.dtype)
    align = align * x_mask[:, :, None].to(x.dtype)
    return torch.einsum("bxy,bxd->byd", align, x), y_lens


def word_level_pooling(x: torch.Tensor, word_ids: torch.Tensor,
                       reduction: str = "sum",
                       num_words: Optional[int] = None) -> torch.Tensor:
    """Pool token features [B, Tp, D] into word slots; word_ids [B, Tp]
    int, -1 = padding.  ``num_words`` defaults to the largest id + 1."""
    if num_words is not None:
        Tw = num_words
    else:
        Tw = int(word_ids.max()) + 1 if word_ids.numel() else 0
    ids = torch.where(word_ids < 0, Tw, word_ids).long()
    onehot = F.one_hot(ids, Tw + 1).to(x.dtype)            # [B, Tp, Tw+1]
    pooled = torch.einsum("btw,btd->bwd", onehot, x)[:, :-1]
    if reduction == "mean":
        counts = onehot.sum(1)[:, :-1, None]
        pooled = pooled / torch.clamp(counts, min=1)
    return pooled


def fft_convolution(signal: torch.Tensor, kernel: torch.Tensor,
                    mode: str = "full") -> torch.Tensor:
    """1-D convolution along the last axis through the FFT."""
    n = signal.shape[-1] + kernel.shape[-1] - 1
    n_fft = 1 << (n - 1).bit_length()
    S = torch.fft.rfft(signal, n=n_fft)
    K = torch.fft.rfft(kernel, n=n_fft)
    out = torch.fft.irfft(S * K, n=n_fft)[..., :n]
    if mode == "full":
        return out
    if mode == "same":
        start = (kernel.shape[-1] - 1) // 2
        return out[..., start:start + signal.shape[-1]]
    if mode == "valid":
        length = signal.shape[-1] - kernel.shape[-1] + 1
        start = kernel.shape[-1] - 1
        return out[..., start:start + length]
    raise ValueError(mode)
