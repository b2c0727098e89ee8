"""The port's websocket server end to end on the CPU, over real sockets.

The trained fixtures (assets/test_fixtures/overfit_{ctc,rnnt}.npz) at the
tiny geometry serve through ``StreamingServer`` on a loopback port; the
clients are ``websockets``' own.  The finals that arrive over the wire
must be those of the port's ``Scheduler`` driven directly on the same
audio (the int16 samples the server decodes), with the fixtures' golden
sentences among them.  Also: a connection at 8 kHz (resampled by the
server), ``/metrics.json`` and the static-file fallback, the 503 of
admission control, and ``build_server`` handing ``quant`` to the device
worker child.
"""

import asyncio
import dataclasses
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import websockets
from scipy.signal import resample_poly

from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
from asr_streaming_tpu_torch.models.serving import (
    ServingConfig, init_serving_params,
)
from asr_streaming_tpu_torch.server.protocol import MSG_REQUEST_COMPLETED
from asr_streaming_tpu_torch.server.ws_server import StreamingServer
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, overlay_params,
)
from tests.fixture_assets import asset_path

SR = 16000
URL = ("/voice/api/asr/v1/ws/decode_online?content-type=audio/x-raw,"
       "+layout=(string)interleaved,+rate=(int){rate}")
CTC_VOCAB = ["-", "|", "a", "b", "c", "d"]
EN_PIECES = ["▁a", "▁b", "▁c", "▁d", "<b>"]
RULES = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
GATES_OFF = dict(use_energy_gate=False, energy_threshold_db=-200.0)
_ID = re.compile(r'^\{"id": "[^"]*"')   # drawn from the clock at connect


def _tones(s, total, hz, sr=SR):
    """One 0.24 s tone per letter, 80 ms gaps, zero-padded to ``total`` s
    (the fixtures' training sentences)."""
    parts = []
    for ch in s:
        if ch not in hz:
            continue
        t = np.arange(int(sr * 0.24)) / sr
        wave = 0.3 * np.sin(2 * np.pi * hz[ch] * t)
        ramp = np.minimum(1.0, np.arange(len(t)) / (0.010 * sr))
        parts.extend([(wave * ramp * ramp[::-1]).astype(np.float32),
                      np.zeros(int(sr * 0.08), np.float32)])
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(sr * total) - len(audio)))


def _pcm(audio):
    return (np.clip(audio, -1, 1) * 32767).astype(np.int16)


def _as_served(pcm):
    """The float samples the server hands its streams for int16 frames."""
    return pcm.astype(np.float32) / 32768.0


class Running:
    """A StreamingServer of either package (this port's or the JAX
    package's) serving on a free loopback port from a thread with its own
    event loop; ready once ``/metrics.json`` answers.

    ``serve`` feeds it in lockstep.  A final reads its stream's
    ``total_seconds_decoded`` when it is sent, after the rescorer's thread
    returns, and so do the fields derived from it; the tick thread goes on
    decoding meanwhile, so under a free-running client those fields depend
    on timing, in both packages (ROADMAP fault 12).  ``serve`` therefore
    sends packets of half a chunk, so that one packet completes at most
    one chunk, and sends every connection's next packet only once the
    server is quiet: each packet taken in, no chunk waiting, every tick's
    events handed to the outboxes, the outboxes empty and no final being
    sent.  The counters for that wrap methods of this server and its
    scheduler, on these instances only, at the first ``serve``.
    """

    def __init__(self, server):
        self.server = server
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True)
        self._thread.start()
        self._run = asyncio.run_coroutine_threadsafe(
            server.run(self.port, host="127.0.0.1"), self._loop)
        self._counting = False
        for _ in range(2400):
            if self._run.done():
                self._run.result()          # the server failed to start
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/metrics.json",
                    timeout=5).close()
                return
            except OSError:
                time.sleep(0.05)
        raise TimeoutError("server did not start")

    def _count(self):
        server, sched = self.server, self.server.scheduler
        tick, deliver, send_final, admit = (
            sched.tick, server._deliver_events, server._send_final,
            sched.admit)
        self.accepted = {}          # stream -> packets taken in
        self.in_tick = False
        self.ticked = self.delivered = self.finals = 0

        def ticked():
            self.in_tick = True
            try:
                return tick()
            finally:
                self.ticked += 1
                self.in_tick = False

        def delivered(events):
            deliver(events)
            self.delivered += 1

        async def final(connection, ev):
            self.finals += 1
            try:
                await send_final(connection, ev)
            finally:
                self.finals -= 1

        def admitted(stream_id):
            stream = admit(stream_id)
            accept = stream.accept_waveform

            def accepted(samples):
                accept(samples)
                self.accepted[stream] += 1
            self.accepted[stream] = 0
            stream.accept_waveform = accepted
            return stream

        sched.tick, sched.admit = ticked, admitted
        server._deliver_events, server._send_final = delivered, final
        self._counting = True

    def _quiet(self, sent):
        return (sorted(self.accepted.values()) == sorted(sent)
                and not self.in_tick and self.ticked == self.delivered
                and not self.server.scheduler.has_work()
                and self.finals == 0
                and not any(q.qsize()
                            for q in self.server._outboxes.values()))

    async def _until_quiet(self, sent):
        for _ in range(60000):
            if self._quiet(sent):
                await asyncio.sleep(0.002)
                if self._quiet(sent):
                    return
            await asyncio.sleep(0.002)
        raise TimeoutError("the server did not go quiet")

    @staticmethod
    async def _read(ws):
        messages = []
        while not messages or messages[-1] != MSG_REQUEST_COMPLETED:
            messages.append(await asyncio.wait_for(ws.recv(), 120))
        return [_ID.sub('{"id": "*"', m) for m in messages]

    def serve(self, pcms, rate=SR):
        """Each connection's messages, the ``id`` masked: half-chunk
        packets to all connections in lockstep, then EOS, then every
        message to __REQUEST_COMPLETED__."""
        if not self._counting:          # idle between connections here
            self._count()
        url = f"ws://127.0.0.1:{self.port}" + URL.format(rate=rate)
        audio = self.server.scheduler.cfg.asr.audio
        step = rate * audio.segment_length // audio.sample_rate // 2

        async def run():
            self.accepted.clear()
            conns = []
            try:
                for _ in pcms:
                    conns.append(await websockets.connect(url))
                readers = [asyncio.ensure_future(self._read(ws))
                           for ws in conns]
                await self._until_quiet([0] * len(conns))
                sent = [0] * len(conns)
                for i in range(0, max(map(len, pcms)), step):
                    for c, (ws, pcm) in enumerate(zip(conns, pcms)):
                        if i < len(pcm):
                            await ws.send(pcm[i:i + step].tobytes())
                            sent[c] += 1
                    await self._until_quiet(sent)
                for ws in conns:
                    await ws.send(json.dumps({"__COMMAND__": "__EOS__"}))
                return await asyncio.gather(*readers)
            finally:
                for ws in conns:
                    await ws.close()
        return asyncio.run(run())

    async def _cancel_all(self):
        tasks = asyncio.all_tasks() - {asyncio.current_task()}
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def close(self):
        asyncio.run_coroutine_threadsafe(self._cancel_all(),
                                         self._loop).result(60)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()
        self._loop.close()
        self.server.stop_ticks()
        self.server.scheduler.close()


async def _stream(port, pcm, rate=SR):
    """Send ``pcm`` in 0.25 s packets (the reference client's), then EOS;
    every message until
    __REQUEST_COMPLETED__."""
    messages = []
    step = rate // 4
    async with websockets.connect(
            f"ws://127.0.0.1:{port}" + URL.format(rate=rate)) as ws:
        for i in range(0, len(pcm), step):
            await ws.send(pcm[i:i + step].tobytes())
            await asyncio.sleep(0.005)
        await ws.send(json.dumps({"__COMMAND__": "__EOS__"}))
        while True:
            msg = await asyncio.wait_for(ws.recv(), timeout=120)
            messages.append(msg)
            if msg == MSG_REQUEST_COMPLETED:
                return messages


def _serve_all(port, pcms, rate=SR):
    async def run():
        return await asyncio.gather(*(_stream(port, p, rate) for p in pcms))
    return asyncio.run(run())


def _wire(messages):
    """(finals, partials) transcripts of one connection."""
    assert messages[-1] == MSG_REQUEST_COMPLETED
    finals, partials = [], []
    for m in map(json.loads, messages[:-1]):
        text = m["result"]["hypotheses"][0]["transcript"].strip()
        (finals if m["result"]["final"] else partials).append(text)
    return finals, partials


def _direct(sched, audios):
    """The Scheduler driven directly: per stream, its non-empty final and
    partial texts."""
    streams = [sched.admit(f"s{i}") for i in range(len(audios))]
    for s, a in zip(streams, audios):
        s.accept_waveform(a)
        s.add_tail_padding()
    events = sched.drain()
    out = []
    for s in streams:
        ev = [e for e in events if e.stream_id == s.id and e.text.strip()]
        out.append(([e.text.strip() for e in ev if e.kind == "final"],
                    [e.text.strip() for e in ev if e.kind == "partial"]))
    for s in streams:
        sched.release(s)
    return out


# ------------------------------------------------------------- Vietnamese

CTC_HZ = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0, " ": 1000.0}


def _ctc_setup():
    path = asset_path("overfit_ctc")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(CTC_VOCAB)),
                        use_silero=False, **GATES_OFF)
    params = overlay_params(init_serving_params(1, cfg, "cpu"),
                            load_params(path))
    return golden, cfg, params


def _ctc_streams(golden):
    """The fixture's three streams: the sentence; silence then the
    sentence; the sentence twice."""
    one = _tones(golden, 3.84, CTC_HZ)
    return [_pcm(a) for a in (
        one, np.concatenate([np.zeros(10240, np.float32), one]),
        np.concatenate([one, one]))]


@pytest.fixture(scope="module")
def vi():
    golden, cfg, params = _ctc_setup()
    sched = Scheduler(params, cfg, CTC_VOCAB, max_slots=3, rules=RULES,
                      device="cpu")
    st = Running(StreamingServer(sched, tick_idle_sleep=0.002))
    direct = Scheduler(params, cfg, CTC_VOCAB, max_slots=3, rules=RULES,
                       device="cpu")
    pcms = _ctc_streams(golden)
    want = _direct(direct, [_as_served(p) for p in pcms])
    direct.close()
    yield golden, st, pcms, want
    st.close()


def test_vi_finals_over_the_wire_equal_the_scheduler(vi):
    golden, st, pcms, want = vi
    got = [_wire(m) for m in _serve_all(st.port, pcms)]
    assert got == want
    assert golden in [f for finals, _ in got for f in finals]
    assert got[0][0] == [golden]


def test_vi_8khz_connection_is_resampled_to_the_same_final(vi):
    golden, st, pcms, want = vi
    pcm8k = _pcm(resample_poly(_as_served(pcms[0]), 1, 2))
    [messages] = _serve_all(st.port, [pcm8k], rate=8000)
    finals, _ = _wire(messages)
    assert finals == want[0][0] == [golden]


def test_metrics_json_and_static_fallback(vi):
    _, st, pcms, _ = vi
    _serve_all(st.port, [pcms[0][:SR]])        # at least one tick
    base = f"http://127.0.0.1:{st.port}"
    with urllib.request.urlopen(base + "/metrics.json", timeout=30) as r:
        assert r.headers["Content-Type"] == "application/json"
        snap = json.loads(r.read())
    assert snap["max_slots"] == 3 and snap["ticks"] > 0
    assert {"counters", "stages", "active_streams"} <= set(snap)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/missing.html", timeout=30)
    assert e.value.code == 404


def test_connection_beyond_max_slots_gets_503(vi):
    _, st, _, _ = vi
    url = f"ws://127.0.0.1:{st.port}/x"

    async def run():
        held = [await websockets.connect(url) for _ in range(3)]
        try:
            for _ in range(500):
                if st.server.scheduler.num_active == 3:
                    break
                await asyncio.sleep(0.01)
            with pytest.raises(websockets.exceptions.InvalidStatus) as e:
                await websockets.connect(url)
            return e.value.response
        finally:
            for ws in held:
                await ws.close()

    response = asyncio.run(run())
    assert response.status_code == 503
    assert response.body == b"The server is busy. Please retry later."
    assert response.headers["Hint"] == \
        "The server is overloaded. Please retry later."


# ---------------------------------------------------------------- English

EN_HZ = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0}


def test_en_beam_partials_golden_over_the_wire():
    """server-en.yaml's mode: the device beam (width 4 at this size) over
    the trained VAD; the finals are the Scheduler's, the golden "a b"."""
    path = asset_path("overfit_rnnt")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["beam_golden"]
    cfg = ServingConfig(
        asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
        model_kind="rnnt", rnnt=RNNTConfig.tiny(vocab_size=len(EN_PIECES)),
        use_silero=True, **GATES_OFF)
    params = overlay_params(init_serving_params(1, cfg, "cpu"),
                            load_params(path))
    params = overlay_params(params,
                            {"vad": load_params(asset_path("overfit_rnnt_vad"))})
    kw = dict(max_slots=2, language="en", rules=RULES, device="cpu",
              en_beam_partials=True, en_beam_width=4)
    one = _tones(golden, 3.84, EN_HZ)
    pcms = [_pcm(one), _pcm(np.concatenate([one, one]))]
    direct = Scheduler(params, cfg, EN_PIECES, **kw)
    want = _direct(direct, [_as_served(p) for p in pcms])
    direct.close()
    st = Running(StreamingServer(Scheduler(params, cfg, EN_PIECES, **kw),
                                      tick_idle_sleep=0.002))
    try:
        got = [_wire(m) for m in _serve_all(st.port, pcms)]
    finally:
        st.close()
    assert [f for f, _ in got] == [f for f, _ in want] == \
        [[golden], [golden, golden]]


# ---------------------------------------------------- speaker verification

def test_is_speaker_at_finals_with_the_fixture_verifier():
    """The trained speaker fixture's verifier in the port's server: every
    final with a word window carries a boolean is_speaker, true on the
    enrolled voice's connection and false on the other voice's
    (tests/test_speaker_loop.py's server check, on the port).  A stub
    rescorer gives each final a fixed word window, the audio that the
    verifier embeds."""
    from asr_streaming_tpu_torch.models.ecapa import (
        EcapaConfig, SpeakerVerifier, load_ecapa_weights,
    )
    from tests.test_torch_ecapa import _utt

    path = asset_path("speaker_loop")
    with np.load(path) as z:
        threshold = json.loads(str(z["__meta__"]))["threshold"]
    ecfg = EcapaConfig.tiny()
    verifier = SpeakerVerifier(load_ecapa_weights(path, ecfg), ecfg,
                               _utt("A", 200), threshold=threshold,
                               device="cpu")
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=4), use_silero=False,
                        use_energy_gate=False)
    sched = Scheduler(init_serving_params(0, cfg, "cpu"), cfg,
                      ["-", "|", "a", "b"], max_slots=2,
                      rules={"flush": EndpointRule(True, 0.0, 1.5,
                                                   float("inf"))},
                      device="cpu")

    def stub_rescorer(seg):
        return [{"beg": 0.10, "end": 1.80, "word": "x", "confidence": 1.0}]

    st = Running(StreamingServer(sched, rescorer=stub_rescorer,
                                 speaker_verifier=verifier,
                                 tick_idle_sleep=0.002))
    try:
        got = _serve_all(st.port, [_pcm(_utt("A", 103)),
                                   _pcm(_utt("B", 103))])
    finally:
        st.close()
    first = []
    for messages in got:
        finals = [m for m in map(json.loads, messages[:-1])
                  if m["result"]["final"] and m.get("word_start") is not None]
        assert finals, messages
        assert all(isinstance(m["is_speaker"], bool) for m in finals)
        first.append(finals[0]["is_speaker"])
    # the first final's window [0.1, 1.8] s is the voice; a later final's
    # fixed window lies before the audio the stream still keeps (an empty
    # slice, which never verifies)
    assert first == [True, False]
