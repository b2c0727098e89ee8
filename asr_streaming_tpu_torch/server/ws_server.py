"""Websocket streaming ASR server fronting the continuous-batching scheduler.

Counterpart of asr_streaming_tpu/server/ws_server.py, the same protocol
byte for byte: binary int16-PCM frames in (RIFF header zeroed), input-rate
resampling from the URL's ``rate=`` or ``__SET_AUDIO_FORMAT__``,
``DecodedResult`` JSON out with partials (send_internal) and finals, the
v1 commands (``__EOS__`` / ``Done`` / ``EOS`` answered by
``__REQUEST_COMPLETED__``), ``/metrics.json``, static files on the same
port, 503 admission control and TLS via ``certificate``.

Connections only feed audio into per-stream buffers; one free-running tick
thread batches every ready chunk into the scheduler's fixed-shape step
(in process, or in the device-worker child) and fans the events back out
to per-connection outboxes.  Final segments are rescored (lexicon+LM beam,
or the RNNT beam for English greedy partials) in a thread pool, so ticks
never wait on host LM work.
"""

from __future__ import annotations

import asyncio
import http
import logging
import ssl
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Callable, List, Optional

import numpy as np
import websockets
from websockets.asyncio.server import serve, ServerConnection
from websockets.http11 import Request, Response
from websockets.datastructures import Headers

from asr_streaming_tpu_torch.server.http_static import StaticFiles
from asr_streaming_tpu_torch.server.protocol import (
    DecodedResult, MSG_REQUEST_COMPLETED, create_hypotheses,
    hypotheses_from_alignment, hypotheses_en, parse_text_message,
)
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler, StreamEvent
from asr_streaming_tpu_torch.streaming.stream import FinalSegment, Stream
from asr_streaming_tpu_torch.utils.noise import compute_stats_audio
from asr_streaming_tpu_torch.utils.resample import StreamingResampler

logger = logging.getLogger("asr_streaming_tpu_torch.server")


class StreamingServer:
    def __init__(
        self,
        scheduler: Scheduler,
        rescorer: Optional[Callable[[FinalSegment], List[dict]]] = None,
        normalizer: Optional[Callable[[str], str]] = None,
        speaker_verifier: Optional[Callable[[np.ndarray], bool]] = None,
        doc_root: Optional[str] = None,
        certificate: Optional[str] = None,
        send_internal: bool = True,
        filter_noise: bool = False,
        noise_threshold_db: float = -40.0,
        max_message_size: int = 1 << 20,
        max_queue_size: int = 32,
        tick_idle_sleep: float = 0.005,
        save_audio_dir: Optional[str] = None,
        en_rescorer: Optional[Callable[[FinalSegment], str]] = None,
        rescorers: Optional[dict] = None,
    ):
        self.scheduler = scheduler
        self.rescorer = rescorer
        # named Linguistic_Model registry (reference streaming_server.py:
        # 165-169): finals pick rescorers[stream.sw_model], falling back
        # to the single `rescorer` for unknown names
        self.rescorers = rescorers or {}
        self.normalizer = normalizer
        self.speaker_verifier = speaker_verifier
        self.static = StaticFiles(doc_root)
        self.certificate = certificate
        self.send_internal = send_internal
        self.filter_noise = filter_noise
        self.noise_threshold_db = noise_threshold_db
        self.max_message_size = max_message_size
        self.max_queue_size = max_queue_size
        self.tick_idle_sleep = tick_idle_sleep
        self.en_rescorer = en_rescorer

        self._outboxes: dict[str, asyncio.Queue] = {}
        # rotating asyncio.Event: set + replaced at every tick boundary
        self._tick_boundary: Optional[asyncio.Event] = None
        self.archiver = None
        if save_audio_dir:   # reference's save_audio / audio_cache feature
            from asr_streaming_tpu_torch.utils.observability import AudioArchiver
            self.archiver = AudioArchiver(
                save_audio_dir, scheduler.cfg.asr.audio.sample_rate)
        self._rescore_pool = ThreadPoolExecutor(max_workers=4,
                                                thread_name_prefix="rescore")
        # Dedicated free-running tick THREAD (see _tick_thread_main for
        # why it is not an asyncio task driving run_in_executor).
        self._tick_thread: Optional[object] = None
        self._tick_stop = False   # set via stop_ticks()
        self.language = scheduler.language
        # the bound port (``run(0)`` picks a free one), and an event set
        # once connections are accepted; run() creates it on its loop
        self.port: Optional[int] = None
        self.serving: Optional[asyncio.Event] = None

    # -------------------------------------------------------------- requests

    async def process_request(self, connection: ServerConnection,
                              request: Request) -> Optional[Response]:
        if "Sec-WebSocket-Key" not in request.headers:
            path = request.path.split("?")[0]
            if path == "/metrics.json":
                snap = self.scheduler.timers.snapshot()
                snap["active_streams"] = self.scheduler.num_active
                snap["max_slots"] = self.scheduler.max_slots
                snap["ticks"] = self.scheduler.ticks
                import json as _json
                return Response(200, "OK",
                                Headers([("Content-Type",
                                          "application/json")]),
                                _json.dumps(snap).encode())
            # plain HTTP: static files (reference streaming_server.py:223-236)
            found, body, mime = self.static.lookup(path)
            status = http.HTTPStatus.OK if found else http.HTTPStatus.NOT_FOUND
            return Response(status.value, status.phrase,
                            Headers([("Content-Type", mime)]), body)
        if self.scheduler.num_active >= self.scheduler.max_slots:
            # admission control (reference streaming_server.py:238-247)
            return Response(
                http.HTTPStatus.SERVICE_UNAVAILABLE.value,
                "Service Unavailable",
                Headers([("Hint",
                          "The server is overloaded. Please retry later.")]),
                b"The server is busy. Please retry later.")
        return None

    # ------------------------------------------------------------- tick loop

    def _tick_thread_main(self, loop, compiled):
        """Free-running tick thread: warmup, then ticks forever; survive
        per-tick failures (log-and-continue, the reference's per-stage
        resilience posture — streaming_server.py:393-465).

        A dedicated plain thread, not an asyncio task awaiting
        run_in_executor per tick, so the loop never waits on the device.
        Events and tick-boundary notifications cross back into the loop
        via call_soon_threadsafe.  A failed warm-up (a kernel that does
        not build or launch) fails ``run``; nothing falls back.
        """
        import time as _time

        try:
            secs = self.scheduler.warmup()
            loop.call_soon_threadsafe(compiled.set_result, secs)
        except BaseException as e:
            loop.call_soon_threadsafe(compiled.set_exception, e)
            return
        while not self._tick_stop and not loop.is_closed():
            try:
                if self.scheduler.has_work():
                    events = self.scheduler.tick()
                    loop.call_soon_threadsafe(self._deliver_events, events)
                else:
                    loop.call_soon_threadsafe(self._notify_boundary)
                    _time.sleep(self.tick_idle_sleep)
            except RuntimeError:
                if loop.is_closed():    # call_soon_threadsafe after close
                    return
                logger.exception("tick failed; continuing")
                _time.sleep(0.05)
            except Exception:
                logger.exception("tick failed; continuing")
                _time.sleep(0.05)

    def stop_ticks(self, timeout: float = 10.0) -> None:
        """Stop the tick thread (lets any in-flight device work finish —
        hard-killing mid-device-op can wedge remote backends)."""
        self._tick_stop = True
        t = self._tick_thread
        if t is not None and getattr(t, "is_alive", lambda: False)():
            t.join(timeout=timeout)

    def _deliver_events(self, events):
        """Runs on the loop thread: route events + release boundary
        waiters."""
        for ev in events:
            q = self._outboxes.get(ev.stream_id)
            if q is not None:
                q.put_nowait(ev)
        self._notify_boundary()

    def _notify_boundary(self):
        """Rotate the boundary event (loop thread only): everyone who
        grabbed the previous event wakes; later waiters get the next."""
        ev = self._tick_boundary
        self._tick_boundary = asyncio.Event()
        if ev is not None:
            ev.set()

    async def _wait_tick_boundary(self):
        """Await the next tick-loop iteration boundary (or a short sleep
        when no tick thread is running — unit tests)."""
        ev = self._tick_boundary
        if ev is not None:
            await ev.wait()
        else:
            await asyncio.sleep(0.002)

    # -------------------------------------------------------------- handlers

    async def handler(self, connection: ServerConnection):
        stream_id = datetime.now().strftime("%f_%S_%M_%H_%m_%d_%Y")
        stream = self.scheduler.admit(stream_id)
        if stream is None:
            await connection.close(1013, "overloaded")
            return
        # input sample rate from URL query (?...rate=(int)44100...)
        in_rate = _rate_from_path(connection.request.path
                                  if connection.request else "")
        resampler = StreamingResampler(
            in_rate, self.scheduler.cfg.asr.audio.sample_rate) \
            if in_rate else None

        outbox: asyncio.Queue = asyncio.Queue()
        self._outboxes[stream_id] = outbox
        sender = asyncio.create_task(self._sender(connection, stream, outbox))
        logger.info("connected %s (%d/%d active)", stream_id,
                    self.scheduler.num_active, self.scheduler.max_slots)
        try:
            async for message in connection:
                if isinstance(message, bytes):
                    samples = np.frombuffer(message, dtype=np.int16)
                    samples = samples.astype(np.float32) / 32768.0
                    if b"RIFF" in message[:64]:
                        samples = samples.copy()
                        samples[:22] = 0.0   # zero the WAV header
                    if resampler is not None:
                        samples = resampler.process(samples)
                    stream.accept_waveform(samples)
                    if self.archiver is not None:
                        self.archiver.append(stream_id, samples)
                else:
                    cmd = parse_text_message(str(message))
                    if cmd.kind == "set_format":
                        if cmd.request_id:
                            # client-facing id; internal slot/outbox keys
                            # keep the server-assigned stream_id
                            stream.client_id = cmd.request_id
                        if cmd.sample_rate and cmd.sample_rate != \
                                self.scheduler.cfg.asr.audio.sample_rate:
                            resampler = StreamingResampler(
                                cmd.sample_rate,
                                self.scheduler.cfg.asr.audio.sample_rate)
                    elif cmd.kind == "set_lm_model":
                        # select the stream's Linguistic_Model registry
                        # entry (rescorer + endpoint ruleset via
                        # Mapping_rule); unknown names keep the current
                        # model and tell the client
                        # valid names are Linguistic_Model keys only
                        # (rescorer registry / Mapping_rule domain) —
                        # NOT endpoint-ruleset names, which live in the
                        # map's range (accepting those would silently
                        # select a model that does not exist)
                        known = (cmd.lm_model == "GENERAL"
                                 or cmd.lm_model in self.rescorers
                                 or cmd.lm_model in stream.mapping_rule)
                        if cmd.lm_model and known:
                            stream.sw_model = cmd.lm_model
                        else:
                            logger.warning(
                                "%s: unknown lm model %r (have %s)",
                                stream_id, cmd.lm_model,
                                sorted(self.rescorers) or ["GENERAL"])
                            result = DecodedResult()
                            result.id = (getattr(stream, "client_id", None)
                                         or stream_id)
                            result.status = 1
                            result.msg = (f"unknown lm model "
                                          f"{cmd.lm_model!r}")
                            await connection.send(result.to_json())
                    elif cmd.kind == "eos":
                        stream.is_eos = True
                        stream.add_tail_padding()
                        await self._flush_eos(connection, stream, outbox)
        except websockets.exceptions.ConnectionClosed:
            pass
        finally:
            sender.cancel()
            self._outboxes.pop(stream_id, None)
            if self.archiver is not None:
                self.archiver.close(stream_id)
            self.scheduler.release(stream)
            logger.info("disconnected %s (%d/%d active)", stream_id,
                        self.scheduler.num_active, self.scheduler.max_slots)

    async def _flush_eos(self, connection: ServerConnection, stream: Stream,
                         outbox: asyncio.Queue):
        """v1 EOS semantics: decode the padded tail, emit a final for any
        残 emission, confirm with __REQUEST_COMPLETED__ (reference v1
        streaming_server.py:500-538)."""
        # drain pending chunks, then pad-and-flush any残 tail audio that is
        # shorter than a chunk (v1 tail-flush semantics, reference v1
        # streaming_server.py:500-538; padding at EOS-arrival time is not
        # enough because the buffer may still hold whole chunks then)
        for _ in range(4):
            while stream.has_chunk() or \
                    self.scheduler.is_pending(stream):
                # wake once per tick instead of busy-polling (the 2 ms
                # sleep loop degraded under load); the sleep fallback only
                # applies when no tick loop is running (unit tests)
                await self._wait_tick_boundary()
            if stream.buffer.size <= stream.audio.buffer_length:
                break   # only carried context left — nothing undecoded
            stream.add_tail_padding()
        # wait for two tick-loop iteration boundaries so the tick that
        # consumed the last chunk has fully enqueued its events (the
        # buffer empties mid-tick, before events are enqueued)
        for _ in range(2):
            await self._wait_tick_boundary()
        # barrier through the outbox: guarantees every already-queued
        # event (including in-flight finals) is fully sent first
        barrier = asyncio.Event()
        ev = StreamEvent(stream_id=stream.id, kind="__barrier__")
        ev._barrier = barrier
        outbox.put_nowait(ev)
        # The sender services barriers even on a dead connection.  A LIVE
        # connection waits as long as it takes (a backlogged rescore must
        # not trigger a premature force-final + __REQUEST_COMPLETED__
        # ahead of the real final — a protocol-order violation); only a
        # CLOSED connection gets a bounded grace so a stuck sender can't
        # strand the handler and leak the slot.
        while not barrier.is_set():
            try:
                await asyncio.wait_for(barrier.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                if connection.close_code is not None:   # connection dead
                    try:
                        await asyncio.wait_for(barrier.wait(), timeout=30.0)
                    except asyncio.TimeoutError:
                        logger.warning("EOS flush barrier abandoned for "
                                       "dead connection %s", stream.id)
                    break
        if stream.emission_length > 0:
            # force-final the remaining utterance
            utt = stream.total_seconds_decoded
            stream.transcript = stream.transcript_internal
            stream.transcript_internal = ""
            seg = stream.take_final_segment(utt)
            ev = StreamEvent(stream_id=stream.id, kind="final",
                             text=seg.transcript_greedy, is_final=True,
                             segment=seg, utterance_seconds=utt,
                             stream=stream)
            await self._send_final(connection, ev)
        await connection.send(MSG_REQUEST_COMPLETED)

    async def _sender(self, connection: ServerConnection, stream: Stream,
                      outbox: asyncio.Queue):
        # Keep consuming after the connection dies instead of returning:
        # the handler may be parked in _flush_eos awaiting a __barrier__
        # event, and an exited sender would strand it forever — the slot,
        # the admission count, and the outbox all leak (observed as a
        # whole load-test's connections still "active" after the clients
        # vanished).  The handler cancels this task in its finally.
        closed = False
        while True:
            ev: StreamEvent = await outbox.get()
            if ev.kind == "__barrier__":
                ev._barrier.set()
                continue
            if closed:
                continue
            try:
                if ev.is_final:
                    await self._send_final(connection, ev)
                elif self.send_internal and ev.text.strip():
                    result = DecodedResult()
                    result.result = {
                        "hypotheses": [create_hypotheses(ev.text)],
                        "final": False,
                    }
                    await connection.send(result.to_json())
            except websockets.exceptions.ConnectionClosed:
                closed = True
            except Exception:
                logger.exception("send failed for %s", ev.stream_id)

    async def _send_final(self, connection: ServerConnection,
                          ev: StreamEvent):
        loop = asyncio.get_running_loop()
        stream, seg = ev.stream, ev.segment

        # per-stream rescorer from the Linguistic_Model registry
        # (reference streaming_server.py:511-513: list_searcher[
        # stream.sw_model] at every final); single-LM fallback otherwise
        rescorer = self.rescorer
        if self.rescorers and stream is not None:
            rescorer = self.rescorers.get(
                getattr(stream, "sw_model", "GENERAL"), self.rescorer)
        if rescorer is not None and seg is not None and seg.length > 0:
            alignment = await loop.run_in_executor(
                self._rescore_pool, rescorer, seg)
        else:
            alignment = []

        if self.language == "vi":
            if alignment:
                normalized = None
                if self.normalizer is not None:
                    transcript = " ".join(
                        a["word"].replace("<<", "").replace(">>", "")
                        for a in alignment)
                    normalized = await loop.run_in_executor(
                        self._rescore_pool, self.normalizer, transcript)
                hypotheses = hypotheses_from_alignment(alignment, normalized)
            else:
                hypotheses = create_hypotheses(ev.text)
        else:
            text = ev.text
            if self.en_rescorer is not None and seg is not None and \
                    seg.length > 0:
                beam_text = await loop.run_in_executor(
                    self._rescore_pool, self.en_rescorer, seg)
                if beam_text.strip():
                    text = beam_text
            hypotheses = hypotheses_en(text)

        result = DecodedResult()
        result.id = getattr(stream, "client_id", None) or ev.stream_id
        result.segment_length = ev.utterance_seconds
        result.segment = stream.segment if stream else 0
        result.result = {"hypotheses": [hypotheses], "final": True}
        if stream is not None:
            result.total_length = stream.total_seconds_decoded
            wa = hypotheses.get("word_alignment") or []
            if wa:
                result.segment_start = round(
                    result.total_length - result.segment_length, 2)
                result.word_start = wa[0]["start"]
                result.word_end = round(wa[-1]["start"] + wa[-1]["length"], 2)
                snr, vs, vn = compute_stats_audio(
                    stream.total_audio, stream.offset_compute_stats, wa,
                    result.segment_start, result.segment_length,
                    stream.audio.sample_rate)
                result.snr, result.vol_speech, result.vol_noise = snr, vs, vn
                if self.speaker_verifier is not None:
                    sr = stream.audio.sample_rate
                    s0 = int((result.word_start
                              - stream.offset_compute_stats) * sr)
                    s1 = int((result.word_end
                              - stream.offset_compute_stats) * sr)
                    speech = stream.total_audio[max(0, s0):max(0, s1)]
                    result.is_speaker = await loop.run_in_executor(
                        self._rescore_pool, self.speaker_verifier, speech)

        text = hypotheses.get("transcript", "")
        if text.strip():
            if self.filter_noise and result.vol_speech <= \
                    self.noise_threshold_db:
                logger.debug("filtered low-volume segment (%.1f dB)",
                             result.vol_speech)
            else:
                await connection.send(result.to_json())
        if stream is not None:
            stream.discard_decoded_segment(ev.utterance_seconds)

    # ------------------------------------------------------------------ run

    async def run(self, port: int, host: str = ""):
        ssl_context = None
        if self.certificate:
            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(self.certificate)
        logger.info("warming up the %d-slot serving step...",
                    self.scheduler.max_slots)
        import threading

        loop = asyncio.get_running_loop()
        self.serving = asyncio.Event()
        self._tick_boundary = asyncio.Event()
        compiled: asyncio.Future = loop.create_future()
        self._tick_thread = threading.Thread(
            target=self._tick_thread_main, args=(loop, compiled),
            name="tick", daemon=True)
        self._tick_thread.start()
        warm_s = await compiled
        logger.info("serving step warmed up in %.1fs", warm_s)
        async with serve(
            self.handler, host=host or None, port=port,
            max_size=self.max_message_size,
            max_queue=self.max_queue_size,
            process_request=self.process_request,
            ssl=ssl_context,
            ping_interval=20, ping_timeout=500, close_timeout=500,
        ) as server:
            self.port = server.sockets[0].getsockname()[1]
            logger.info("serving on port %d", self.port)
            self.serving.set()
            await asyncio.Future()


def _rate_from_path(path: str) -> Optional[int]:
    """Parse '+rate=(int)16000' from the reference client URL
    (asrclient.py:86)."""
    import re
    m = re.search(r"rate=(?:\(int\))?(\d+)", path or "")
    return int(m.group(1)) if m else None
