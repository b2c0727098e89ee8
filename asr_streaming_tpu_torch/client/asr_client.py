"""Streaming ASR websocket client.

Equivalent of the reference's CLI clients (reference: asrclient.py,
asrclient_copy.py:357-456 WAV-file mode, dual_asr_client.py, and the paced
E2E harness test/asr_test.py:21-115): streams 16-bit PCM over the
reference URL at real-time (or faster) pacing, collects partial/final
JSON results, and ends with the EOS command.

Usable as a library (LoadClient below powers the load harness) or CLI:
  python -m asr_streaming_tpu_torch.client.asr_client file.wav --url ws://...

Copied from asr_streaming_tpu/client/asr_client.py.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
import wave as wave_mod
from typing import List, Optional

import numpy as np

import websockets

from asr_streaming_tpu_torch.server.protocol import (
    CMD_EOS, CMD_SET_AUDIO_FORMAT, MSG_REQUEST_COMPLETED,
)
from asr_streaming_tpu_torch.utils.resample import resample

DEFAULT_PATH = ("/voice/api/asr/v1/ws/decode_online?content-type="
                "audio/x-raw,+layout=(string)interleaved,+rate=(int)16000")


@dataclasses.dataclass
class TranscriptionResult:
    partials: List[dict]
    finals: List[dict]
    first_partial_latency: Optional[float] = None
    total_seconds: float = 0.0
    completed: bool = False

    @property
    def transcript(self) -> str:
        return " ".join(
            f["result"]["hypotheses"][0].get("transcript", "")
            for f in self.finals).strip()


def load_pcm(path: str, target_rate: int = 16000) -> bytes:
    with wave_mod.open(path) as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch)[:, 0]
    if sr != target_rate:
        wavef = resample(pcm.astype(np.float32) / 32768.0, sr, target_rate)
        pcm = (np.clip(wavef, -1, 1) * 32767).astype(np.int16)
    return pcm.tobytes()


async def stream_audio(url: str, pcm: bytes, realtime: bool = True,
                       chunks_per_second: int = 4,
                       sample_rate: int = 16000,
                       request_id: str = "",
                       recv_timeout: float = 60.0) -> TranscriptionResult:
    """Stream PCM at the reference harness pacing (test/asr_test.py:39-65:
    chunks_per_second sender throttle -> RTF=1)."""
    result = TranscriptionResult(partials=[], finals=[])
    bytes_per_chunk = 2 * sample_rate // chunks_per_second
    t_start = time.perf_counter()

    async with websockets.connect(url) as ws:
        if request_id:
            await ws.send(json.dumps({
                "__COMMAND__": CMD_SET_AUDIO_FORMAT,
                "__ARGUMENT__": {"sample_rate": sample_rate},
                "request-id": request_id}))

        async def sender():
            for i in range(0, len(pcm), bytes_per_chunk):
                await ws.send(pcm[i:i + bytes_per_chunk])
                if realtime:
                    await asyncio.sleep(1.0 / chunks_per_second)
            await ws.send(json.dumps({"__COMMAND__": CMD_EOS}))

        send_task = asyncio.create_task(sender())
        try:
            while True:
                msg = await asyncio.wait_for(ws.recv(),
                                             timeout=recv_timeout)
                if msg == MSG_REQUEST_COMPLETED:
                    result.completed = True
                    break
                blob = json.loads(msg)
                if blob.get("result", {}).get("final"):
                    result.finals.append(blob)
                else:
                    result.partials.append(blob)
                    if result.first_partial_latency is None:
                        result.first_partial_latency = \
                            time.perf_counter() - t_start
        finally:
            send_task.cancel()
    result.total_seconds = time.perf_counter() - t_start
    return result


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("wav")
    parser.add_argument("--url", default="ws://localhost:6006" + DEFAULT_PATH)
    parser.add_argument("--no-realtime", action="store_true",
                        help="stream as fast as possible")
    parser.add_argument("--request-id", default="")
    args = parser.parse_args()

    pcm = load_pcm(args.wav)
    result = asyncio.run(stream_audio(
        args.url, pcm, realtime=not args.no_realtime,
        request_id=args.request_id))
    for p in result.partials:
        print("partial:", p["result"]["hypotheses"][0]["transcript"])
    for f in result.finals:
        print("FINAL:", f["result"]["hypotheses"][0]["transcript"])
    print(f"done in {result.total_seconds:.2f}s "
          f"(completed={result.completed})")


if __name__ == "__main__":
    main()
