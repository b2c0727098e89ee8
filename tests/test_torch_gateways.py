"""The gRPC master and the browser gateway (copies of the JAX package's,
``server/{grpc_master,web_gateway}.py``) in front of the port's websocket
server, with tests/test_gateways.py's expectations.

The worker is the port's ``StreamingServer`` serving the trained CTC
fixture at the tiny geometry on a loopback port (tests/test_torch_server.py's
``Running``); the fixture's golden sentence streams through each front
door and must come back in a final: over gRPC, over the gateway's plain
websocket, and as Socket.IO events over the websocket transport and after
the polling handshake and upgrade.
"""

import asyncio
import base64
import json
import socket

import grpc
import pytest
from aiohttp import ClientSession, WSMsgType
from aiohttp.test_utils import TestServer

from asr_streaming_tpu_torch.server.grpc_master import (
    METHOD, SERVICE, make_server,
)
from asr_streaming_tpu_torch.server.protocol import MSG_REQUEST_COMPLETED
from asr_streaming_tpu_torch.server.web_gateway import WebGateway
from asr_streaming_tpu_torch.server.ws_server import StreamingServer
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from tests.torch_train_common import one_torch_thread  # noqa: F401
from tests.test_torch_server import (
    CTC_HZ, CTC_VOCAB, RULES, URL, Running, _ctc_setup, _pcm, _tones,
)

STEP = 8000          # bytes: a quarter second of int16 at 16 kHz


@pytest.fixture(scope="module")
def worker():
    golden, cfg, params = _ctc_setup()
    sched = Scheduler(params, cfg, CTC_VOCAB, max_slots=4, rules=RULES,
                      device="cpu")
    st = Running(StreamingServer(sched, tick_idle_sleep=0.002))
    audio = _pcm(_tones(golden, 3.84, CTC_HZ)).tobytes()
    yield golden, f"ws://127.0.0.1:{st.port}" + URL.format(rate=16000), \
        audio, st
    st.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _transcript(result):
    return result["hypotheses"][0]["transcript"].strip()


def test_grpc_master_end_to_end(worker):
    golden, url, audio, st = worker
    port = _free_port()

    async def run():
        gserver = make_server([url], port)
        await gserver.start()
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{port}") as channel:
                call = channel.stream_stream(
                    f"/{SERVICE}/{METHOD}",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)

                async def frames():
                    for i in range(0, len(audio), STEP):
                        yield audio[i:i + STEP]
                    yield json.dumps({"__COMMAND__": "__EOS__"}).encode()

                # to the stream's end: the master closes its worker
                # connection after __REQUEST_COMPLETED__
                messages = [reply async for reply in call(frames())]
            await _released(st)
            return messages
        finally:
            await gserver.stop(None)

    messages = asyncio.run(run())
    assert messages[-1] == MSG_REQUEST_COMPLETED.encode()
    parsed = [json.loads(m) for m in messages[:-1]]
    finals = [_transcript(p["result"]) for p in parsed
              if p["result"].get("final")]
    assert golden in finals, finals


def test_web_gateway_end_to_end(worker):
    golden, url, audio, st = worker
    port = _free_port()

    async def run():
        gw = WebGateway(vi_url=url)
        test_server = TestServer(gw.app(), port=port)
        await test_server.start_server()
        got = []
        try:
            async with ClientSession() as session:
                async with session.ws_connect(
                        f"http://127.0.0.1:{port}/ws") as ws:
                    await ws.send_bytes(audio)
                    await ws.send_str("Done")
                    while True:
                        msg = await asyncio.wait_for(ws.receive(),
                                                     timeout=60)
                        if msg.type != WSMsgType.TEXT:
                            break
                        blob = json.loads(msg.data)
                        got.append(blob)
                        if blob.get("completed"):
                            break
            await _released(st)
        finally:
            await test_server.close()
        return got

    got = asyncio.run(run())
    assert any(b.get("language") == "vi" and "result" in b for b in got)
    assert got[-1].get("completed")
    finals = [_transcript(b["result"]) for b in got
              if "result" in b and b["result"].get("final")]
    assert golden in finals, finals


async def _released(st):
    """Wait until the worker holds no connection: the gateway closed its
    backend connection for the session."""
    for _ in range(3000):
        if not st.server._outboxes:
            return
        await asyncio.sleep(0.01)
    raise TimeoutError("the gateway kept its worker connection")


async def _socketio_events(ws, audio):
    """Audio as ``audio_data`` events, server pings answered, until the
    first final ``asr_result``; the (name, data) events received."""
    events = []
    deadline = asyncio.get_event_loop().time() + 60
    sent = 0
    while asyncio.get_event_loop().time() < deadline:
        if sent < len(audio):
            await ws.send_str("42" + json.dumps(
                ["audio_data", {"audio": base64.b64encode(
                    audio[sent:sent + STEP]).decode()}]))
            sent += STEP
        try:
            msg = await asyncio.wait_for(ws.receive(), timeout=0.25)
        except asyncio.TimeoutError:
            continue
        if msg.type != WSMsgType.TEXT:
            break
        if msg.data == "2":                    # server ping
            await ws.send_str("3")
        elif msg.data.startswith("42"):
            name, data = json.loads(msg.data[2:])
            events.append((name, data))
            if data.get("isFinal") and data.get("text", "").strip():
                break
    return events


def test_socketio_websocket_transport_end_to_end(worker):
    """Hand-rolled Socket.IO 4.x frames over the direct websocket
    transport: open packet, namespace connect, base64 ``audio_data``
    events in, ``asr_result`` events out."""
    golden, url, audio, st = worker
    port = _free_port()

    async def run():
        gw = WebGateway(vi_url=url)
        test_server = TestServer(gw.app(), port=port)
        await test_server.start_server()
        try:
            async with ClientSession() as session:
                async with session.ws_connect(
                        f"http://127.0.0.1:{port}/socket.io/"
                        "?EIO=4&transport=websocket") as ws:
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    assert msg.data.startswith("0{"), msg.data
                    assert json.loads(msg.data[1:])["pingInterval"] > 0
                    await ws.send_str("40")        # namespace connect
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    assert msg.data.startswith("40{"), msg.data
                    events = await _socketio_events(ws, audio)
                    await ws.send_str("41")        # namespace disconnect
                    await _released(st)
                    return events
        finally:
            await test_server.close()

    events = asyncio.run(run())
    assert events, "no asr_result events"
    assert all(name == "asr_result" and data["type"] == "vi"
               for name, data in events)
    finals = [data["text"].strip() for _, data in events if data["isFinal"]]
    assert golden in finals, events


def test_socketio_polling_handshake_and_upgrade(worker):
    """Engine.IO v4 polling handshake, then the websocket upgrade (2probe
    / 3probe, the pending long-poll released with a noop, 5 commits),
    then events over the upgraded websocket."""
    golden, url, audio, st = worker
    port = _free_port()

    async def run():
        gw = WebGateway(vi_url=url, poll_timeout_s=5.0)
        test_server = TestServer(gw.app(), port=port)
        await test_server.start_server()
        base = f"http://127.0.0.1:{port}/socket.io/?EIO=4"
        try:
            async with ClientSession() as session:
                async with session.get(base + "&transport=polling") as r:
                    body = await r.text()
                assert body.startswith("0{"), body
                sid = json.loads(body[1:])["sid"]
                assert "websocket" in json.loads(body[1:])["upgrades"]

                poll = base + "&transport=polling&sid=" + sid
                async with session.post(poll, data="40") as r:
                    assert await r.text() == "ok"
                async with session.get(poll) as r:
                    body = await r.text()
                assert body.split("\x1e")[0].startswith("40{"), body

                pending = asyncio.create_task(session.get(poll))
                await asyncio.sleep(0.1)
                async with session.ws_connect(
                        base + "&transport=websocket&sid=" + sid) as ws:
                    await ws.send_str("2probe")
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    assert msg.data == "3probe"
                    r = await asyncio.wait_for(pending, timeout=10)
                    released = await r.text()
                    assert "6" in released.split("\x1e"), released
                    await ws.send_str("5")       # upgrade commit
                    events = await _socketio_events(ws, audio)
                    await ws.send_str("41")      # namespace disconnect
                    await _released(st)
                    return events
        finally:
            await test_server.close()

    events = asyncio.run(run())
    finals = [data["text"].strip() for name, data in events
              if name == "asr_result" and data.get("isFinal")]
    assert golden in finals, events
