"""GAN discriminators for vocoder training.

Counterpart of asr_streaming_tpu/models/discriminators.py, the
reference's discriminator zoo (reference:
streaming_decoder_v1/lightspeech/modules/discriminator.py:14-437), used
with the least-squares GAN losses in train/losses.py:

  * PeriodWaveformDiscriminator (+ multi-period ensemble) — reshape the
    waveform into [T/p, p] and run strided 2-D convs (HiFi-GAN MPD).
  * ResolutionSpectrogramDiscriminator (+ multi-resolution ensemble) —
    2-D convs over log-magnitude spectrograms at several STFT
    resolutions.
  * PQMF analysis filterbank + multi-band discriminator — near-perfect
    reconstruction cosine-modulated filterbank splitting the waveform
    into subbands, each judged by a small 1-D conv stack.

The JAX package's convolutions pad by XLA's ``"SAME"`` rule at strides
of 2 and 4; ``blocks.same_pad`` computes those pads.  LeakyReLU slope
0.1 throughout.  Plain PyTorch: no TPU kernel lies under them.  The
``init_*`` functions draw on the CPU from a ``torch.Generator``; the
ensemble inits place the tree on ``device`` (default CUDA; raises
without it) and keep the static periods / resolutions beside it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.blocks import same_pad
from asr_streaming_tpu_torch.models.emformer import _uniform
from asr_streaming_tpu_torch.train.losses import (
    STFTResolution, _magnitude_stft,
)
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


def _conv_init(gen, cout, cin, kh, kw=None):
    shape = (cout, cin, kh) if kw is None else (cout, cin, kh, kw)
    fan = cin * kh * (1 if kw is None else kw)
    return {"w": _uniform(gen, shape, 1.0 / math.sqrt(fan)),
            "b": torch.zeros(cout)}


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv2d_same(x, conv, stride, bias=True):
    """XLA ``"SAME"`` 2-D conv at ``stride`` on both dims, x NCHW."""
    kh, kw = conv["w"].shape[2:]
    ph, pw = same_pad(x.shape[2], kh, stride), same_pad(x.shape[3], kw,
                                                        stride)
    return F.conv2d(F.pad(x, pw + ph), conv["w"],
                    conv["b"] if bias else None, stride=stride)


def _conv1d_same(x, conv, stride, bias=True):
    """XLA ``"SAME"`` 1-D conv at ``stride``, x NCW."""
    x = F.pad(x, same_pad(x.shape[-1], conv["w"].shape[-1], stride))
    return F.conv1d(x, conv["w"], conv["b"] if bias else None, stride=stride)


# ------------------------------------------------- multi-period (waveform)

PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = (32, 128, 512, 1024)


def init_period_discriminator(gen: torch.Generator,
                              channels=_MPD_CHANNELS) -> dict:
    convs, cin = [], 1
    for c in channels:
        convs.append(_conv_init(gen, c, cin, 5, 1))
        cin = c
    return {"convs": convs, "out": _conv_init(gen, 1, cin, 3, 1)}


def _reflect_right(wave: torch.Tensor, pad: int) -> torch.Tensor:
    """[B, T] padded by ``pad`` on the right in numpy's "reflect" mode
    (periodic for pads past T - 1, where ``F.pad`` refuses)."""
    T = wave.shape[1]
    period = 2 * (T - 1)
    idx = torch.arange(T, T + pad, device=wave.device) % period
    idx = torch.where(idx >= T, period - idx, idx)
    return torch.cat([wave, wave[:, idx]], 1)


def period_discriminator(p: dict, wave: torch.Tensor, period: int
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """wave: [B, T] -> (score map, feature maps)."""
    B, T = wave.shape
    pad = (period - T % period) % period
    if pad:
        x = _reflect_right(wave, pad) if T > 1 else F.pad(wave, (0, pad))
    else:
        x = wave
    x = x.reshape(B, 1, -1, period)                    # [B, 1, T/p, p]
    fmaps = []
    for conv in p["convs"]:
        x = _leaky(F.conv2d(x, conv["w"], conv["b"], stride=(3, 1),
                            padding=(2, 0)))
        fmaps.append(x)
    x = F.conv2d(x, p["out"]["w"], p["out"]["b"], padding=(1, 0))
    return x.reshape(B, -1), fmaps


def init_multi_period_discriminator(gen: torch.Generator, periods=PERIODS,
                                    device=None) -> dict:
    discs = [init_period_discriminator(gen) for _ in periods]
    return {"periods": list(periods),
            "discs": params_from_numpy(discs, resolve_device(device))}


def multi_period_discriminator(p: dict, wave: torch.Tensor):
    outs, fmaps = [], []
    for disc, period in zip(p["discs"], p["periods"]):
        o, f = period_discriminator(disc, wave, period)
        outs.append(o)
        fmaps.extend(f)
    return outs, fmaps


# --------------------------------------------- multi-resolution (spectral)

RESOLUTIONS = ((1024, 600, 120), (2048, 1200, 240), (512, 240, 50))
def init_resolution_discriminator(gen: torch.Generator,
                                  channels=(32, 64, 128, 256)) -> dict:
    convs, cin = [], 1
    for c in channels:
        convs.append(_conv_init(gen, c, cin, 3, 3))
        cin = c
    return {"convs": convs, "out": _conv_init(gen, 1, cin, 3, 3)}


def resolution_discriminator(p: dict, wave: torch.Tensor,
                             res: Tuple[int, int, int]):
    spec = _magnitude_stft(wave, STFTResolution(*res))   # [B, F, T]
    x = torch.log(spec + 1e-7)[:, None]                  # [B, 1, F, T]
    fmaps = []
    for conv in p["convs"]:
        x = _leaky(_conv2d_same(x, conv, 2))
        fmaps.append(x)
    # the JAX package adds no bias after the output conv (the leaf is in
    # the tree, its gradient 0): the same here
    x = _conv2d_same(x, p["out"], 1, bias=False)
    return x.reshape(x.shape[0], -1), fmaps


def init_multi_resolution_discriminator(gen: torch.Generator,
                                        resolutions=RESOLUTIONS,
                                        device=None) -> dict:
    discs = [init_resolution_discriminator(gen) for _ in resolutions]
    return {"resolutions": [tuple(r) for r in resolutions],
            "discs": params_from_numpy(discs, resolve_device(device))}


def multi_resolution_discriminator(p: dict, wave: torch.Tensor):
    outs, fmaps = [], []
    for disc, res in zip(p["discs"], p["resolutions"]):
        o, f = resolution_discriminator(disc, wave, res)
        outs.append(o)
        fmaps.extend(f)
    return outs, fmaps


# ------------------------------------------------------- PQMF / multi-band

def pqmf_filterbank(subbands: int = 4, taps: int = 62,
                    cutoff: float = 0.142, beta: float = 9.0) -> np.ndarray:
    """Cosine-modulated near-PR analysis filterbank [subbands, taps+1]."""
    n = np.arange(taps + 1)
    # Kaiser-windowed lowpass prototype
    h_ideal = np.where(n == taps / 2, 2 * cutoff,
                       np.sin(2 * np.pi * cutoff * (n - taps / 2) + 1e-12)
                       / (np.pi * (n - taps / 2) + 1e-12))
    proto = h_ideal * np.kaiser(taps + 1, beta)
    H = np.zeros((subbands, taps + 1))
    for k in range(subbands):
        H[k] = 2 * proto * np.cos(
            (2 * k + 1) * np.pi / (2 * subbands) * (n - taps / 2)
            + (-1) ** k * np.pi / 4)
    return H.astype(np.float32)


def pqmf_analysis(wave: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, subbands, T/subbands]."""
    subbands, taps = filters.shape
    pad = (taps - 1) // 2
    x = F.pad(wave, (pad, taps - 1 - pad))
    return F.conv1d(x[:, None, :], filters[:, None, :], stride=subbands)


def init_band_discriminator(gen: torch.Generator,
                            channels=(32, 64, 128)) -> dict:
    convs, cin = [], 1
    for c in channels:
        convs.append(_conv_init(gen, c, cin, 15))
        cin = c
    return {"convs": convs, "out": _conv_init(gen, 1, cin, 3)}


def init_multi_band_discriminator(gen: torch.Generator, subbands: int = 4,
                                  device=None) -> dict:
    return params_from_numpy(
        {"filters": pqmf_filterbank(subbands),
         "discs": [init_band_discriminator(gen) for _ in range(subbands)]},
        resolve_device(device))


def multi_band_discriminator(p: dict, wave: torch.Tensor):
    bands = pqmf_analysis(wave, p["filters"])
    outs, fmaps = [], []
    for i, disc in enumerate(p["discs"]):
        x = bands[:, i:i + 1]
        for conv in disc["convs"]:
            x = _leaky(_conv1d_same(x, conv, 4))
            fmaps.append(x)
        x = _conv1d_same(x, disc["out"], 1, bias=False)    # as the MRD's
        outs.append(x.reshape(x.shape[0], -1))
    return outs, fmaps
