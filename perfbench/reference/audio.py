"""Plain reference of the serving step's audio stages, in float32.

Frozen copies of the port's arithmetic (``models/serving.py``: the mu-law
upload and the carried context; ``models/vad.py``: the energy gate, the
per-window energy stand-in for Silero and the silence runs;
``ops/frontend.py``: the log-mel frontend), written against plain torch
and numpy.  Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MU = 255.0


def _mulaw_lut() -> np.ndarray:
    i16 = np.arange(65536, dtype=np.uint16).view(np.int16)
    v = i16.astype(np.float64) / 32767.0
    y = np.sign(v) * np.log1p(MU * np.abs(np.clip(v, -1, 1))) / np.log1p(MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


_LUT = _mulaw_lut()


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 mu-law, as the client uploads it."""
    scaled = np.clip(np.asarray(x, np.float32) * 32767.0, -32768, 32767)
    return _LUT[scaled.astype(np.int16).view(np.uint16)]


def mulaw_decode(u8: torch.Tensor) -> torch.Tensor:
    y = u8.to(torch.float32) / 127.5 - 1.0
    return torch.sign(y) * (torch.pow(1.0 + MU, torch.abs(y)) - 1.0) / MU


def assemble(seg_u8, ctx, active, new_stream):
    """The chunk window [carried context | new segment] and the context
    carried to the next chunk (it advances for active slots only)."""
    seg = mulaw_decode(seg_u8)
    ctx = torch.where(new_stream[:, None], torch.zeros_like(ctx), ctx)
    wave = torch.cat([ctx, seg], 1)
    new_ctx = torch.where(active[:, None], seg[:, -ctx.shape[1]:], ctx)
    return wave, new_ctx


def energy_gate(new_audio, sample_rate, threshold_db, frame_seconds=0.03):
    """Any 30 ms frame of the new audio above an absolute dBFS floor."""
    frame = int(frame_seconds * sample_rate)
    n = (new_audio.shape[1] // frame) * frame
    frames = new_audio[:, :n].reshape(new_audio.shape[0], -1, frame)
    db = 10.0 * torch.log10((frames ** 2).mean(-1) + 1e-12)
    return (db > threshold_db).any(1)


def window_speech(wave, window, threshold_db):
    """The energy stand-in for Silero: a window of ``window`` samples is
    speech when its mean power is above the floor.  [B, n_win] bool."""
    n_win = wave.shape[1] // window
    frames = wave[:, :n_win * window].reshape(wave.shape[0], n_win, window)
    return 10.0 * torch.log10((frames ** 2).mean(-1) + 1e-12) > threshold_db


def silence_runs(speech, window_seconds):
    """Leading and trailing runs of silent windows, in seconds."""
    not_speech = (~speech).to(torch.int32)
    lead = torch.cumprod(not_speech, 1).sum(1)
    trail = torch.cumprod(not_speech.flip(1), 1).sum(1)
    return lead.float() * window_seconds, trail.float() * window_seconds


def _hann(win):
    n = np.arange(win, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win))


def mel_params(mel: dict, device) -> dict:
    """The windowed real-DFT basis [n_fft, 2F] and the HTK mel filterbank
    [F, n_mels] (torchaudio semantics, norm None) of a ``mel`` geometry."""
    n_fft, win, sr = mel["n_fft"], mel["win_length"], mel["sample_rate"]
    window = _hann(win)
    if win < n_fft:
        left = (n_fft - win) // 2
        padded = np.zeros(n_fft)
        padded[left:left + win] = window
        window = padded
    n_freqs = n_fft // 2 + 1
    angle = 2.0 * np.pi * np.outer(np.arange(n_freqs), np.arange(n_fft)) / n_fft
    basis = np.concatenate([np.cos(angle) * window, -np.sin(angle) * window])
    f_max = sr / 2.0
    mels = np.linspace(0.0, 2595.0 * np.log10(1.0 + f_max / 700.0),
                       mel["n_mels"] + 2)
    f_pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return {"basis": torch.tensor(basis.T, dtype=torch.float32, device=device),
            "fb": torch.tensor(fb, dtype=torch.float32, device=device)}


def log_mel(mp: dict, mel: dict, wave: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, frames, n_mels]: clamp-log (Vietnamese) or the
    piecewise-linear log of int16 full-scale power (English)."""
    if mel["center"]:
        pad = mel["n_fft"] // 2
        wave = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = wave.unfold(1, mel["n_fft"], mel["hop_length"])
    spec = frames @ mp["basis"]
    n_freqs = mel["n_fft"] // 2 + 1
    power = spec[..., :n_freqs] ** 2 + spec[..., n_freqs:] ** 2
    m = power @ mp["fb"]
    if mel["transform"] == "clamp_log":
        return torch.log(torch.clamp(m, min=1e-5))
    x = m * math.pow(10, 0.05 * (2 * 20 * math.log10(32767)))
    return torch.where(x > math.e, torch.log(torch.clamp(x, min=1e-20)),
                       x / math.e)
