"""Audio stream geometry, and the WAV reader of the speaker enrolment.

Copied from asr_streaming_tpu/utils/audio.py (AudioConfig, VI_AUDIO,
EN_AUDIO); ``read_wav`` is copied from asr_streaming_tpu/train/data.py
(the server's ``speaker_wav``).

For the Vietnamese production geometry:

  segment_length = 64*160      = 10240 samples of *new* audio per step
  buffer_length  = (16+4)*160  = 3200 samples of carried context
  chunk_length   = 13440 samples fed to the model per step
                 -> 80 mel frames (win 400/fft 800/hop 160, center=False)
                 -> 20 frames after stride-4 time reduction
                 -> 16 utterance frames + 4 right-context frames
                 -> 16 CTC emission frames of 40 ms each (0.64 s)
"""

from __future__ import annotations

import dataclasses
import wave as wave_mod

import numpy as np


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Stream chunk geometry (all lengths in samples unless noted)."""

    sample_rate: int = 16000
    hop_seconds: float = 0.01
    segment_size: int = 64      # frames of new audio per decode step
    context_size: int = 16      # frames of lookahead context
    bias: int = 4               # extra frames so the STFT window fits
    framerate: int = 4          # encoder time-reduction stride (frames/emission)

    @property
    def hop_length(self) -> int:
        return int(self.hop_seconds * self.sample_rate)

    @property
    def segment_length(self) -> int:
        """New samples consumed per decode step."""
        return self.segment_size * self.hop_length

    @property
    def buffer_length(self) -> int:
        """Carried (context + bias) samples prepended to each chunk."""
        return (self.context_size + self.bias) * self.hop_length

    @property
    def chunk_length(self) -> int:
        """Total samples fed to the model per decode step."""
        return self.segment_length + self.buffer_length

    @property
    def segment_seconds(self) -> float:
        """Seconds of new audio per decode step."""
        return self.segment_length / self.sample_rate

    @property
    def emission_frames_per_chunk(self) -> int:
        """CTC emission frames produced per decode step."""
        return self.segment_size // self.framerate

    @property
    def emission_frame_seconds(self) -> float:
        """Seconds per emission frame (reference FRAMERATE=0.04)."""
        return self.hop_seconds * self.framerate

    @property
    def initial_offset(self) -> int:
        """Initial emission-frame offset for timestamp alignment."""
        return -(self.context_size // self.framerate + 1)


VI_AUDIO = AudioConfig(sample_rate=16000, hop_seconds=0.01, segment_size=64,
                       context_size=16, bias=4, framerate=4)
EN_AUDIO = AudioConfig(sample_rate=16000, hop_seconds=0.01, segment_size=16,
                       context_size=4, bias=0, framerate=1)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """16-bit PCM WAV -> (float32 mono [-1,1], sample_rate)."""
    with wave_mod.open(path) as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch)[:, 0]
    return pcm.astype(np.float32) / 32768.0, sr
