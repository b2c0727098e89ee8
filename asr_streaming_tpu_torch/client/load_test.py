"""Concurrent-stream load harness.

Generalizes the reference's single-stream paced harness
(reference: test/asr_test.py:21-115) to N concurrent real-time streams
against a running server, reporting sustained stream count, per-stream
completion, and partial-latency percentiles — the reference's "≥500
concurrent connections" capacity claim, measured instead of configured.

  python -m asr_streaming_tpu_torch.client.load_test --streams 100 \
      --wav test.wav --url ws://localhost:6006/...

Copied from asr_streaming_tpu/client/load_test.py.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import List

import numpy as np

from asr_streaming_tpu_torch.client.asr_client import (
    DEFAULT_PATH, TranscriptionResult, load_pcm, stream_audio,
)


async def run_load(url: str, pcm: bytes, n_streams: int,
                   ramp_seconds: float = 2.0,
                   chunks_per_second: int = 4) -> dict:
    async def one(i: int):
        await asyncio.sleep(ramp_seconds * i / max(n_streams, 1))
        try:
            return await stream_audio(
                url, pcm, realtime=True,
                chunks_per_second=chunks_per_second,
                request_id=f"load-{i}")
        except Exception as e:  # connection refused / overload
            return e

    t0 = time.perf_counter()
    results = await asyncio.gather(*[one(i) for i in range(n_streams)])
    wall = time.perf_counter() - t0

    ok: List[TranscriptionResult] = [
        r for r in results if isinstance(r, TranscriptionResult)
        and r.completed]
    errors = [r for r in results if not isinstance(r, TranscriptionResult)]
    latencies = [r.first_partial_latency for r in ok
                 if r.first_partial_latency is not None]
    audio_seconds = len(pcm) / 2 / 16000

    return {
        "streams_requested": n_streams,
        "streams_completed": len(ok),
        "errors": len(errors),
        "audio_seconds_per_stream": round(audio_seconds, 2),
        "wall_seconds": round(wall, 2),
        "rtf": round(wall / audio_seconds, 3) if audio_seconds else None,
        "first_partial_p50_s": round(float(np.percentile(latencies, 50)), 3)
        if latencies else None,
        "first_partial_p95_s": round(float(np.percentile(latencies, 95)), 3)
        if latencies else None,
        "finals_per_stream": round(
            float(np.mean([len(r.finals) for r in ok])), 2) if ok else 0,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", required=True)
    parser.add_argument("--url", default="ws://localhost:6006" + DEFAULT_PATH)
    parser.add_argument("--streams", type=int, default=50)
    parser.add_argument("--ramp-seconds", type=float, default=2.0)
    args = parser.parse_args()
    pcm = load_pcm(args.wav)
    report = asyncio.run(run_load(args.url, pcm, args.streams,
                                  args.ramp_seconds))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
