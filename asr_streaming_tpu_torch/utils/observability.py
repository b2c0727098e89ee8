"""Per-stage timers and counters, a profiler hook, Audacity labels.

Copied from asr_streaming_tpu/utils/observability.py (StageTimers,
AudioArchiver, export_audacity_labels); ``torch_profile`` is the
counterpart of its ``jax_profile``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import wave as wave_mod
from collections import defaultdict
from typing import Dict

import numpy as np


class StageTimers:
    """Per-stage latency tracking with percentile snapshots."""

    def __init__(self, window: int = 512):
        self.window = window
        self._samples: Dict[str, list] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(stage, time.perf_counter() - t0)

    def observe(self, stage: str, seconds: float) -> None:
        buf = self._samples[stage]
        buf.append(seconds)
        if len(buf) > self.window:
            del buf[:len(buf) - self.window]
        self._counts[stage] += 1

    def increment(self, counter: str, by: int = 1) -> None:
        self._counts[counter] += by

    def snapshot(self) -> dict:
        out = {"counters": dict(self._counts), "stages": {}}
        for stage, buf in self._samples.items():
            if not buf:
                continue
            arr = np.asarray(buf)
            out["stages"][stage] = {
                "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 2),
                "p95_ms": round(float(np.percentile(arr, 95)) * 1e3, 2),
                "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 2),
                "mean_ms": round(float(arr.mean()) * 1e3, 2),
                "n": len(buf),
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot())


@contextlib.contextmanager
def torch_profile(log_dir: str, trace_name: str = "trace.json"):
    """Profile a block with ``torch.profiler`` (the CPU, and the CUDA
    card when there is one) and write its Chrome trace to
    ``log_dir/trace_name``; yields the profiler, whose ``key_averages()``
    give the time by kernel once the block has ended."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, trace_name))


class AudioArchiver:
    """Per-stream WAV capture (reference save_audio feature)."""

    def __init__(self, directory: str, sample_rate: int = 16000):
        self.directory = directory
        self.sample_rate = sample_rate
        os.makedirs(directory, exist_ok=True)
        self._files: Dict[str, wave_mod.Wave_write] = {}

    def append(self, stream_id: str, samples: np.ndarray) -> None:
        f = self._files.get(stream_id)
        if f is None:
            f = wave_mod.open(
                os.path.join(self.directory, f"{stream_id}.wav"), "wb")
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.sample_rate)
            self._files[stream_id] = f
        pcm = (np.clip(np.asarray(samples), -1, 1) * 32767).astype(np.int16)
        f.writeframes(pcm.tobytes())

    def close(self, stream_id: str) -> None:
        f = self._files.pop(stream_id, None)
        if f is not None:
            f.close()


def export_audacity_labels(segments, output_file: str) -> None:
    """Write Audacity label-track lines (reference export_audacity.py:1-23).
    segments: iterable of (start_s, end_s, label)."""
    with open(output_file, "w", encoding="utf-8") as f:
        for start, end, label in segments:
            f.write(f"{start}\t{end}\t{label}\n")
