"""Segment SNR / volume statistics from word alignments.

NumPy re-implementation of the reference's ``compute_stats_audio``
(reference: streaming_decoder/compute_noise.py:4-52): the final word
alignment splits the segment audio into speech (inside word spans) vs
noise (gaps + flanks), and SNR / vol_speech / vol_noise are reported in dB
on the final result.  Powers the low-volume ``filter_noise`` drop
(streaming_server.py:538-541).

Copied from asr_streaming_tpu/utils/noise.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def compute_stats_audio(audio: np.ndarray, offset_seconds: float,
                        word_alignment: List[dict],
                        segment_start: float, segment_length: float,
                        sample_rate: int = 16000,
                        ) -> Tuple[float, float, float]:
    """Returns (snr_db, vol_speech_db, vol_noise_db).

    Args:
      audio: the stream's retained waveform (starts at offset_seconds).
      word_alignment: [{word, start, length, ...}] in absolute seconds.
      segment_start/segment_length: segment bounds in absolute seconds.
    """
    audio = np.asarray(audio, dtype=np.float32)
    to_idx = lambda t: int((t - offset_seconds) * sample_rate)

    if not word_alignment:
        power = float(np.mean(audio ** 2) + 1e-9) if audio.size else 1e-9
        db = 10.0 * np.log10(power)
        return 0.0, db, db

    speech_parts, noise_parts = [], []
    prev_end = None
    first_start = to_idx(word_alignment[0]["start"])
    last_end = to_idx(word_alignment[-1]["start"]
                      + word_alignment[-1]["length"])
    for wa in word_alignment:
        ws = to_idx(wa["start"])
        we = to_idx(wa["start"] + wa["length"])
        speech_parts.append(audio[max(0, ws):max(0, we)])
        if prev_end is not None:
            noise_parts.append(audio[max(0, prev_end):max(0, ws)])
        prev_end = we

    seg_s = max(0, to_idx(segment_start))
    seg_e = max(0, to_idx(segment_start + segment_length))
    noise_parts.insert(0, audio[seg_s:max(seg_s, first_start)])
    noise_parts.append(audio[last_end:seg_e])

    speech = (np.concatenate(speech_parts) if speech_parts
              else np.zeros(0, np.float32))
    noise = (np.concatenate(noise_parts) if noise_parts
             else np.zeros(0, np.float32))

    speech_power = float(np.mean(speech ** 2)) + 1e-9 if speech.size else 1e-9
    noise_power = float(np.mean(noise ** 2)) + 1e-9 if noise.size else 1e-9

    snr = 10.0 * np.log10(speech_power / noise_power)
    vol_speech = 10.0 * np.log10(speech_power)
    vol_noise = 10.0 * np.log10(noise_power)
    return round(float(snr), 2), round(float(vol_speech), 2), \
        round(float(vol_noise), 2)
