"""Log-mel filterbank frontend in plain PyTorch.

Counterpart of asr_streaming_tpu/ops/frontend.py.  One precomputed
real-DFT basis (window folded in) and one mel filterbank matrix; the
frontend is framing + one matmul + power + one matmul:

    frames = unfold(wave, n_fft, hop)            # [B, frames, n_fft]
    spec   = frames @ [cos|sin] basis            # [B, frames, 2F]
    power  = re^2 + im^2
    mel    = power @ mel_fb
    out    = log(clamp(mel))  or piecewise-linear-log (+ global stats)

This is the JAX package's matmul spelling (frontend.py:191-212), which
computes the same function as its strided-conv spelling (:213-227); the
tests hold it against the conv spelling.  Not a TPU kernel, so the
products go to torch.matmul.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel spectrogram geometry (defaults: the Vietnamese path)."""

    sample_rate: int = 16000
    n_fft: int = 800
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 128
    f_min: float = 0.0
    f_max: Optional[float] = None          # default sr/2
    center: bool = False
    power: float = 2.0
    mel_scale: str = "htk"
    # Output transform: "clamp_log" (vi) or "piecewise_linear_log" (en).
    output_transform: str = "clamp_log"
    clamp_min: float = 1e-5
    # Pre-log gain on the power spectrogram (en: int16 full-scale power).
    pre_gain: float = 1.0

    @classmethod
    def for_vietnamese(cls) -> "MelConfig":
        return cls()

    @classmethod
    def for_english(cls) -> "MelConfig":
        return cls(
            n_fft=400, win_length=400, hop_length=160, n_mels=80,
            center=True, output_transform="piecewise_linear_log",
            pre_gain=math.pow(10, 0.05 * (2 * 20 * math.log10(32767))),
        )

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            return 1 + num_samples // self.hop_length
        return 1 + (num_samples - self.n_fft) // self.hop_length


def _hann_window(win_length: int) -> np.ndarray:
    # torch.hann_window default is periodic.
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def _mel_frequencies(n_mels: int, f_min: float, f_max: float,
                     scale: str) -> np.ndarray:
    if scale != "htk":          # the only scale the serving configs use
        raise ValueError(f"unsupported mel scale {scale}")
    mels = np.linspace(2595.0 * np.log10(1.0 + f_min / 700.0),
                       2595.0 * np.log10(1.0 + f_max / 700.0), n_mels + 2)
    return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] (torchaudio semantics,
    norm=None)."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_freqs)
    f_pts = _mel_frequencies(cfg.n_mels, cfg.f_min, f_max, cfg.mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def make_mel_params(cfg: MelConfig, device=None) -> dict:
    """The fused window+DFT basis and the mel matrix, as the JAX package
    stores them: dft_kernel [2F, 1, n_fft] (cos rows then sin rows),
    mel_fb [n_freqs, n_mels]; on ``device`` (default CUDA; raises without
    it)."""
    device = resolve_device(device)
    n_fft, win = cfg.n_fft, cfg.win_length
    window = _hann_window(win)
    if win < n_fft:
        left = (n_fft - win) // 2
        padded = np.zeros(n_fft, dtype=np.float64)
        padded[left:left + win] = window
        window = padded
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(cfg.n_freqs, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(k, n) / n_fft
    cos_b = np.cos(angle) * window[None, :]
    sin_b = -np.sin(angle) * window[None, :]
    kernel = np.concatenate([cos_b, sin_b], axis=0)[:, None, :]
    return {
        "dft_kernel": torch.tensor(kernel, dtype=torch.float32,
                                   device=device),
        "mel_fb": torch.tensor(mel_filterbank(cfg), device=device),
    }


def log_mel(params: dict, cfg: MelConfig, waveform: torch.Tensor,
            mean: Optional[torch.Tensor] = None,
            invstddev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """waveform [B, T] float32 -> log-mel [B, cfg.num_frames(T), n_mels]."""
    waveform = waveform.to(torch.float32)
    if cfg.center:
        pad = cfg.n_fft // 2
        waveform = F.pad(waveform[:, None], (pad, pad),
                         mode="reflect")[:, 0]
    n_freqs = cfg.n_freqs
    frames = waveform.unfold(1, cfg.n_fft, cfg.hop_length)   # [B, Tf, n_fft]
    dft_mat = params["dft_kernel"][:, 0, :].T                # [n_fft, 2F]
    spec = torch.matmul(frames, dft_mat)                     # [B, Tf, 2F]
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = re * re + im * im
    if cfg.power == 1.0:
        power = torch.sqrt(power)
    mel = torch.matmul(power, params["mel_fb"])

    if cfg.output_transform == "clamp_log":
        out = torch.log(torch.clamp(mel, min=cfg.clamp_min))
    elif cfg.output_transform == "piecewise_linear_log":
        x = mel * cfg.pre_gain
        out = torch.where(x > math.e, torch.log(torch.clamp(x, min=1e-20)),
                          x / math.e)
    else:
        raise ValueError(cfg.output_transform)
    if mean is not None:
        out = (out - mean) * invstddev
    return out


def load_global_stats(path: str, device=None):
    """torchaudio-style global stats JSON {mean, invstddev}, on ``device``
    (default CUDA; raises without it)."""
    device = resolve_device(device)
    with open(path) as f:
        blob = json.load(f)
    return (torch.tensor(blob["mean"], dtype=torch.float32, device=device),
            torch.tensor(blob["invstddev"], dtype=torch.float32,
                         device=device))
