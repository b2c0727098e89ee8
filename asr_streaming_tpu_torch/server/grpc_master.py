"""gRPC master façade: load-balancing front door over websocket workers.

The reference's README describes a "master: gRPC server forward requests
to workers" whose code is absent from the snapshot (reference README.md:5;
SURVEY.md §5 "distributed communication backend").  This implements it:
a bidirectional-streaming gRPC service that forwards audio to one of N
websocket ASR workers (round-robin with failover) and streams the JSON
results back.

grpcio-tools (protoc codegen) is not in the image, so the service is
registered with generic bytes handlers; the wire contract is:

  service AsrMaster {
    rpc Decode (stream bytes) returns (stream bytes);
    //   client -> server frames: raw int16 PCM, or a UTF-8 JSON command
    //     ({"__COMMAND__": ...}) — same payloads as the websocket protocol
    //   server -> client frames: UTF-8 DecodedResult JSON /
    //     "__REQUEST_COMPLETED__"
  }

(equivalent .proto in native/proto/asr_master.proto for codegen users).

Copied from asr_streaming_tpu/server/grpc_master.py.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from typing import List, Sequence

import grpc
import websockets

logger = logging.getLogger("asr_streaming_tpu_torch.grpc_master")

SERVICE = "asr.AsrMaster"
METHOD = "Decode"


def _identity(b: bytes) -> bytes:
    return b


class AsrMaster:
    """Round-robin forwarder with failover across worker ws endpoints."""

    def __init__(self, worker_urls: Sequence[str]):
        self.worker_urls: List[str] = list(worker_urls)
        self._rr = itertools.cycle(range(len(self.worker_urls)))

    def pick_workers(self) -> List[str]:
        start = next(self._rr)
        n = len(self.worker_urls)
        return [self.worker_urls[(start + i) % n] for i in range(n)]

    async def Decode(self, request_iterator, context):
        ws = None
        last_err = None
        for url in self.pick_workers():
            try:
                ws = await websockets.connect(url)
                break
            except OSError as e:
                last_err = e
                logger.warning("worker %s unavailable: %s", url, e)
        if ws is None:
            await context.abort(grpc.StatusCode.UNAVAILABLE,
                                f"no worker available: {last_err}")
            return

        out_queue: asyncio.Queue = asyncio.Queue()
        done = asyncio.Event()

        async def pump_results():
            try:
                async for msg in ws:
                    text = msg.decode() if isinstance(msg, bytes) else msg
                    out_queue.put_nowait(text.encode())
                    # completion arrives as a JSON result whose
                    # message_type is __REQUEST_COMPLETED__ (protocol.py);
                    # a bytes/str-mismatched == here used to keep the pump
                    # alive until connection close
                    if "__REQUEST_COMPLETED__" in text:
                        break
            except websockets.exceptions.ConnectionClosed:
                pass
            finally:
                done.set()

        async def pump_audio():
            try:
                async for frame in request_iterator:
                    # JSON command frames pass through as text
                    if frame[:1] == b"{":
                        try:
                            json.loads(frame)
                            await ws.send(frame.decode())
                            continue
                        except (ValueError, UnicodeDecodeError):
                            pass
                    await ws.send(frame)
            except (websockets.exceptions.ConnectionClosed,
                    grpc.aio.AioRpcError):
                pass

        results = asyncio.create_task(pump_results())
        audio = asyncio.create_task(pump_audio())
        try:
            while not (done.is_set() and out_queue.empty()):
                try:
                    msg = await asyncio.wait_for(out_queue.get(), timeout=0.2)
                    yield msg
                except asyncio.TimeoutError:
                    continue
        finally:
            audio.cancel()
            results.cancel()
            await ws.close()


def make_server(worker_urls: Sequence[str], port: int) -> grpc.aio.Server:
    master = AsrMaster(worker_urls)
    handler = grpc.stream_stream_rpc_method_handler(
        master.Decode, request_deserializer=_identity,
        response_serializer=_identity)
    generic = grpc.method_handlers_generic_handler(
        SERVICE, {METHOD: handler})
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((generic,))
    server.add_insecure_port(f"[::]:{port}")
    return server


async def serve(worker_urls: Sequence[str], port: int):
    server = make_server(worker_urls, port)
    await server.start()
    logger.info("gRPC master on :%d -> %s", port, list(worker_urls))
    await server.wait_for_termination()


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50051)
    parser.add_argument("--workers", nargs="+", required=True,
                        help="worker websocket URLs")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args.workers, args.port))


if __name__ == "__main__":
    main()
