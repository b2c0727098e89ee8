"""Inverse STFT (overlap-add).

Counterpart of asr_streaming_tpu/ops/istft.py, the equivalent of
torchaudio's InverseSpectrogram used by the reference vocoder head
(reference: lightspeech/modules/decoder.py:110-131, datas/audio.py:47-64):
windowed inverse real DFT, overlap-add, division by the overlap-added
squared window (clipped at 1e-11), ``n_fft // 2`` trimmed at each end
(center=True).  It is the JAX function's math, not ``torch.istft``,
whose envelope check and trimming are another contract.

The overlap-add is ``F.fold`` (col2im: each output sample sums its
frames in one thread, no atomics), so the result does not depend on
the order in which the card schedules threads: two runs on the card
agree bit for bit (``chip_smoke.py`` phase 13 (a) checks it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _overlap_add(frames: torch.Tensor, hop_length: int,
                 out_len: int) -> torch.Tensor:
    """frames [B, T, n] -> [B, out_len], frame t added at t * hop."""
    n = frames.shape[-1]
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n), stride=(1, hop_length))
    return out[:, 0, 0]


def inverse_stft(spec: torch.Tensor, n_fft: int, win_length: int,
                 hop_length: int) -> torch.Tensor:
    """spec: [B, n_fft//2+1, T] complex -> [B, (T-1)*hop] real (float32
    for complex64)."""
    B, _, T = spec.shape
    window = np.zeros(n_fft)
    left = (n_fft - win_length) // 2 if win_length < n_fft else 0
    window[left:left + win_length] = 0.5 * (1 - np.cos(
        2 * np.pi * np.arange(win_length) / win_length))
    window = torch.from_numpy(window).to(spec.real.dtype).to(spec.device)

    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    frames = frames * window                               # [B, T, n_fft]

    out_len = n_fft + hop_length * (T - 1)
    audio = _overlap_add(frames, hop_length, out_len)
    norm = _overlap_add((window ** 2).expand(1, T, n_fft), hop_length,
                        out_len)
    audio = audio / torch.clamp(norm, min=1e-11)

    pad = n_fft // 2   # center=True trimming
    return audio[:, pad:out_len - pad]
