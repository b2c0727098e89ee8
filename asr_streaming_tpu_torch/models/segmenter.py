"""Offline VAD segmentation for long audio.

Counterpart of asr_streaming_tpu/models/segmenter.py, the reference's
offline Silero segmenter (reference:
streaming_decoder_v1/lightspeech/models/detection.py:17-292 and the
timestamp extractor in streaming_decoder/vad_silero.py:139-248):
hysteresis-thresholded speech regions from per-window VAD probabilities,
then grouped into 3-15 s chunks.  The probabilities come from the port's
batched Silero (models/vad.py) on the device its weights lie on; the
state machine and the grouping (host, numpy) are copied from that module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from asr_streaming_tpu_torch.models.vad import SileroConfig, silero_chunk_probs


def speech_timestamps_from_probs(
        probs: np.ndarray, window: int = 512, sample_rate: int = 16000,
        threshold: float = 0.5, neg_threshold: Optional[float] = None,
        min_speech_duration_ms: int = 250,
        max_speech_duration_s: float = float("inf"),
        min_silence_duration_ms: int = 100,
        speech_pad_ms: int = 30, audio_length_samples: Optional[int] = None,
) -> List[Dict[str, float]]:
    """Per-window probs -> [{'start','end'} in seconds] with the
    reference's hysteresis semantics (vad_silero.py:139-248)."""
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)
    if audio_length_samples is None:
        audio_length_samples = len(probs) * window
    min_speech = sample_rate * min_speech_duration_ms / 1000
    pad = int(sample_rate * speech_pad_ms / 1000)
    max_speech = (sample_rate * max_speech_duration_s - window - 2 * pad
                  if math.isfinite(max_speech_duration_s) else float("inf"))
    min_silence = sample_rate * min_silence_duration_ms / 1000
    min_sil_at_max = sample_rate * 98 / 1000

    triggered = False
    speeches: List[dict] = []
    cur: dict = {}
    temp_end = prev_end = next_start = 0

    for i, p in enumerate(probs):
        pos = window * i
        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos
        if p >= threshold and not triggered:
            triggered = True
            cur = {"start": pos}
            continue
        if triggered and pos - cur["start"] > max_speech:
            if prev_end:
                cur["end"] = prev_end
                speeches.append(cur)
                cur = {}
                if next_start < prev_end:
                    triggered = False
                else:
                    cur = {"start": next_start}
                prev_end = next_start = temp_end = 0
            else:
                cur["end"] = pos
                speeches.append(cur)
                cur = {}
                prev_end = next_start = temp_end = 0
                triggered = False
            continue
        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end > min_sil_at_max:
                prev_end = temp_end
            if pos - temp_end < min_silence:
                continue
            cur["end"] = temp_end
            if cur["end"] - cur["start"] > min_speech:
                speeches.append(cur)
            cur = {}
            prev_end = next_start = temp_end = 0
            triggered = False

    if cur and audio_length_samples - cur.get("start", 0) > min_speech:
        cur["end"] = audio_length_samples
        speeches.append(cur)

    # pad and de-overlap (reference vad_silero.py:225-241)
    for i, sp in enumerate(speeches):
        if i == 0:
            sp["start"] = max(0, sp["start"] - pad)
        if i != len(speeches) - 1:
            gap = speeches[i + 1]["start"] - sp["end"]
            if gap < 2 * pad:
                sp["end"] += gap // 2
                speeches[i + 1]["start"] = max(
                    0, speeches[i + 1]["start"] - gap // 2)
            else:
                sp["end"] = min(audio_length_samples, sp["end"] + pad)
                speeches[i + 1]["start"] = max(
                    0, speeches[i + 1]["start"] - pad)
        else:
            sp["end"] = min(audio_length_samples, sp["end"] + pad)

    out = []
    for sp in speeches:
        out.append({
            "start": max(round(sp["start"] / sample_rate, 1), 0.0),
            "end": min(round(sp["end"] / sample_rate, 1),
                       audio_length_samples / sample_rate),
        })
    return out


def get_speech_timestamps(vad_params: dict, cfg: SileroConfig,
                          wave: np.ndarray, **kwargs) -> List[Dict]:
    """Full-audio timestamp extraction with the port's Silero, on the
    device of ``vad_params``."""
    dev = vad_params["lstm_wi"].device
    audio = torch.as_tensor(np.asarray(wave, np.float32), device=dev)[None]
    probs = silero_chunk_probs(vad_params, cfg, audio)[0].cpu().numpy()
    return speech_timestamps_from_probs(
        probs, window=cfg.window, sample_rate=cfg.sample_rate,
        audio_length_samples=len(wave), **kwargs)


def group_segments(segments: Sequence[Dict[str, float]],
                   min_seconds: float = 3.0, max_seconds: float = 15.0
                   ) -> List[Dict[str, float]]:
    """Merge adjacent speech segments into min..max-second groups for
    training-corpus slicing (reference detection.py group_segments)."""
    groups: List[dict] = []
    cur: Optional[dict] = None
    for seg in segments:
        if cur is None:
            cur = dict(seg)
            continue
        if seg["end"] - cur["start"] <= max_seconds:
            cur["end"] = seg["end"]
        else:
            groups.append(cur)
            cur = dict(seg)
    if cur is not None:
        groups.append(cur)
    # drop groups that stayed too short
    return [g for g in groups if g["end"] - g["start"] >= min_seconds]
