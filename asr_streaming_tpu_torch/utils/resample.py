"""Input-rate resampling (host side).

The reference shells out to ffmpeg via pydub per message
(reference: streaming_decoder/streaming_server.py:348-360); here a
polyphase resampler (scipy.signal.resample_poly) with a small stateless
wrapper.  For streaming use the chunk edges get a continuity buffer so
per-message resampling doesn't click at boundaries.

Copied from asr_streaming_tpu/utils/resample.py.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

try:
    from scipy.signal import resample_poly
    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    _HAVE_SCIPY = False


def resample(wave: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Resample float32 audio [T] from in_rate to out_rate."""
    if in_rate == out_rate:
        return np.asarray(wave, np.float32)
    frac = Fraction(out_rate, in_rate).limit_denominator(1000)
    if _HAVE_SCIPY:
        out = resample_poly(np.asarray(wave, np.float64),
                            frac.numerator, frac.denominator)
        return out.astype(np.float32)
    # linear-interpolation fallback
    n_out = int(round(len(wave) * out_rate / in_rate))
    x_out = np.linspace(0, len(wave) - 1, n_out)
    return np.interp(x_out, np.arange(len(wave)),
                     np.asarray(wave, np.float64)).astype(np.float32)


class StreamingResampler:
    """Per-connection resampler keeping edge context across packets.

    Global input/output sample accounting (not per-call rounding) keeps
    the streamed output aligned with an offline resample of the whole
    signal — per-call rounding drifts by a sample every few packets and
    accumulates."""

    def __init__(self, in_rate: int, out_rate: int, context: int = 128):
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.context = context
        # the carried tail must start on a polyphase-period boundary so the
        # filter phase matches an offline resample of the whole signal
        self._period = in_rate // math.gcd(in_rate, out_rate)
        self._tail = np.zeros(0, np.float32)
        self._in_total = 0    # input samples consumed (excluding tail)
        self._out_total = 0   # output samples emitted

    def process(self, samples: np.ndarray) -> np.ndarray:
        if self.in_rate == self.out_rate:
            return np.asarray(samples, np.float32)
        new = np.asarray(samples, np.float32)
        joined = np.concatenate([self._tail, new])
        base_in = self._in_total - len(self._tail)
        self._in_total += len(new)

        out_full = resample(joined, self.in_rate, self.out_rate)
        base_out = (base_in * self.out_rate) // self.in_rate
        start = self._out_total - base_out
        end = (self._in_total * self.out_rate) // self.in_rate - base_out
        emit = out_full[max(0, start):max(0, end)]
        self._out_total += len(emit)

        # tail length L with (in_total - L) % period == 0 and L >= context
        L = self.context + (self._in_total - self.context) % self._period
        self._tail = joined[-L:] if len(joined) >= L else joined
        return emit
