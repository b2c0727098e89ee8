"""Data augmentation.

Counterpart of asr_streaming_tpu/train/augment.py (the reference's
streaming_decoder_v1/lightspeech/datas/augment.py:13-221):

  * SpecAugment (time and frequency masking) on the device, batched.  Its
    random draws come from an explicit ``torch.Generator`` and cannot
    equal ``jax.random``'s, so the draw (``spec_augment_draws``) is apart
    from the masking (``apply_spec_masks``), which equals the JAX
    function's given the same starts and widths.
  * Waveform augmentations on the host in numpy (background noise at a
    sampled SNR, overlapped speech at a sampled energy ratio, RIR reverb
    by FFT convolution), copies of the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from asr_streaming_tpu_torch.ops.sequence import fft_convolution


# ----------------------------------------------------------- device-side

class SpecDraws(NamedTuple):
    """Mask starts and widths, each [B, n_masks] int64."""
    t_starts: torch.Tensor
    t_widths: torch.Tensor
    f_starts: torch.Tensor
    f_widths: torch.Tensor


def spec_augment_draws(gen: torch.Generator, B: int, T: int, F: int,
                       time_masks: int = 10, time_width: float = 0.05,
                       freq_masks: int = 1, freq_width: int = 27,
                       device="cpu") -> SpecDraws:
    """Starts uniform in [0, length), widths uniform in [0, width]; the
    time width is relative to T (reference TimeMasking, augment.py:
    190-204), the frequency width absolute bins (FrequencyMasking)."""
    t_width = max(int(time_width * T), 1)

    def draw(n_masks, length, width):
        starts = torch.randint(0, length, (B, n_masks), generator=gen)
        widths = torch.randint(0, width + 1, (B, n_masks), generator=gen)
        return starts.to(device), widths.to(device)

    return SpecDraws(*draw(time_masks, T, t_width),
                     *draw(freq_masks, F, freq_width))


def _hit(starts: torch.Tensor, widths: torch.Tensor,
         length: int) -> torch.Tensor:
    idx = torch.arange(length, device=starts.device)[None, None, :]
    hit = (idx >= starts[:, :, None]) & (idx < (starts + widths)[:, :, None])
    return hit.any(1)                                   # [B, length]


def apply_spec_masks(feats: torch.Tensor, draws: SpecDraws,
                     mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, F] with every drawn time and frequency span set to
    ``mask_value``."""
    B, T, F = feats.shape
    tmask = _hit(draws.t_starts, draws.t_widths, T)
    fmask = _hit(draws.f_starts, draws.f_widths, F)
    fill = torch.tensor(mask_value, dtype=feats.dtype, device=feats.device)
    out = torch.where(tmask[:, :, None], fill, feats)
    return torch.where(fmask[:, None, :], fill, out)


def spec_augment(gen: torch.Generator, feats: torch.Tensor,
                 time_masks: int = 10, time_width: float = 0.05,
                 freq_masks: int = 1, freq_width: int = 27,
                 mask_value: float = 0.0) -> torch.Tensor:
    """Batched SpecAugment of feats [B, T, F]."""
    B, T, F = feats.shape
    draws = spec_augment_draws(gen, B, T, F, time_masks, time_width,
                               freq_masks, freq_width, feats.device)
    return apply_spec_masks(feats, draws, mask_value)


# ------------------------------------------------------------- host-side

def add_background_noise(rng: np.random.Generator, speech: np.ndarray,
                         noise: np.ndarray, min_snr_db: float = 0.0,
                         max_snr_db: float = 30.0) -> np.ndarray:
    """Mix noise at a sampled SNR, keeping the speech's norm
    (reference augment.py:131-188)."""
    speech = np.asarray(speech, np.float32)
    noise = np.asarray(noise, np.float32)
    T = len(speech)
    if len(noise) >= T:
        off = rng.integers(0, len(noise) - T + 1)
        noise = noise[off:off + T]
    else:
        off = rng.integers(0, T - len(noise) + 1)
        noise = np.pad(noise, (off, T - len(noise) - off))

    snr_db = rng.uniform(min_snr_db, max_snr_db)
    rms_speech = np.sqrt(np.mean(speech ** 2)) + 1e-9
    rms_noise = np.sqrt(np.mean(noise ** 2)) + 1e-9
    scale = 10 ** (-snr_db / 20) * rms_speech / rms_noise
    noisy = speech + scale * noise
    noisy *= np.linalg.norm(speech) / (np.linalg.norm(noisy) + 1e-9)
    return np.clip(noisy, -1.0, 1.0)


def overlap_speech(rng: np.random.Generator, speech: np.ndarray,
                   secondary: np.ndarray, min_energy_ratio: float = -5.0,
                   max_energy_ratio: float = 5.0) -> np.ndarray:
    """Overlay a random slice of a second utterance at a sampled energy
    ratio (reference augment.py:13-70)."""
    speech = np.array(speech, np.float32, copy=True)
    T = len(speech)
    mix_len = rng.integers(1, T // 2 + 1)
    mix_len = min(len(secondary) - 1, int(mix_len))
    if mix_len <= 0:
        return speech
    p_start = rng.integers(0, T - mix_len)
    s_start = rng.integers(0, len(secondary) - mix_len)
    ratio = rng.uniform(min_energy_ratio, max_energy_ratio)
    e_p = np.sqrt(np.mean(speech ** 2))
    e_s = np.sqrt(np.mean(secondary ** 2))
    coeff = np.sqrt(10 ** (ratio / 10))
    scale = e_p / (coeff * e_s + 1e-9)
    speech[p_start:p_start + mix_len] += \
        scale * secondary[s_start:s_start + mix_len]
    return speech


def apply_impulse_response(speech: np.ndarray, rir: np.ndarray,
                           sample_rate: int = 16000,
                           second_before_peak: float = 0.01,
                           second_after_peak: float = 0.5) -> np.ndarray:
    """Reverberate with a trimmed, normalised RIR by FFT convolution
    (reference augment.py:73-128)."""
    speech = np.asarray(speech, np.float32)
    rir = np.asarray(rir, np.float32)
    peak = int(np.argmax(np.abs(rir)))
    start = max(0, peak - int(second_before_peak * sample_rate))
    end = min(len(rir), peak + int(second_after_peak * sample_rate))
    rir = rir[start:end]
    rir = rir / (np.linalg.norm(rir) + 1e-9)
    rir = rir[::-1].copy()

    padded = np.pad(speech, (len(rir) - 1, 0))
    rev = fft_convolution(torch.from_numpy(padded), torch.from_numpy(rir),
                          mode="valid").numpy()
    rev = rev * (np.linalg.norm(speech) / (np.linalg.norm(rev) + 1e-9))
    return np.clip(rev, -1.0, 1.0).astype(np.float32)
