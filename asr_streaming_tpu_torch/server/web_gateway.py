"""Browser demo gateway: Socket.IO-compatible bridge to the ASR workers.

Re-design of the reference's Flask+SocketIO demo app (reference:
asr_web_app/app.py:22-213), which bridges browser audio to BOTH language
servers and relays results per session.  Two front doors:

  * ``/socket.io/`` — a dependency-free Engine.IO v4 + Socket.IO v5
    server (polling handshake, websocket transport, probe/upgrade,
    server ping) speaking the exact wire protocol of the reference's
    browser assets (templates/index.html:118 loads socket.io-client
    4.5.4): ``connect`` opens per-session vi/en worker websockets
    (app.py:186-189 / 105-148), ``42["audio_data",{"audio":<b64>}]``
    fans the decoded PCM out to both workers (app.py:191-213), and
    worker results come back as ``42["asr_result",{"type","text",
    "isFinal"}]`` — vi finals carrying transcript_normalized
    (app.py:23-56), en carrying transcript (app.py:57-88).
  * ``/ws`` — a plain-websocket bridge for the in-repo demo page.

Flask/flask_socketio aren't in this image (and aren't needed): the
protocol layer below implements the Engine.IO v4 framing itself —
``0{open-json}``, ping ``2``/pong ``3``, message ``4`` + Socket.IO
packet (``0`` connect / ``2`` event), '\\x1e'-separated polling
payloads, and the 2probe/3probe/5 upgrade dance.

Copied from asr_streaming_tpu/server/web_gateway.py.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import uuid
from typing import Dict, Optional

from aiohttp import web, WSMsgType
import websockets

logger = logging.getLogger("asr_streaming_tpu_torch.web_gateway")

RS = "\x1e"                  # Engine.IO polling record separator

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ASR demo</title></head>
<body>
<h3>Streaming ASR demo</h3>
<button id="rec">Record</button>
<div><b>vi:</b> <span id="vi"></span></div>
<div><b>en:</b> <span id="en"></span></div>
<script>
let ws, ctx, proc, recording = false;
document.getElementById('rec').onclick = async () => {
  if (recording) { ws.send('Done'); recording = false; return; }
  ws = new WebSocket(`ws://${location.host}/ws`);
  ws.onmessage = (e) => {
    const m = JSON.parse(e.data);
    if (m.language && m.result)
      document.getElementById(m.language).textContent =
        m.result.hypotheses[0].transcript;
  };
  ctx = new AudioContext({sampleRate: 16000});
  const src = ctx.createMediaStreamSource(
    await navigator.mediaDevices.getUserMedia({audio: true}));
  proc = ctx.createScriptProcessor(4096, 1, 1);
  proc.onaudioprocess = (e) => {
    const f = e.inputBuffer.getChannelData(0);
    const i16 = new Int16Array(f.length);
    for (let i = 0; i < f.length; i++) i16[i] = f[i] * 32767;
    if (ws.readyState === 1) ws.send(i16.buffer);
  };
  src.connect(proc); proc.connect(ctx.destination);
  recording = true;
};
</script></body></html>"""


class SocketIOSession:
    """One Engine.IO session = one browser tab = one pair of worker
    connections (the reference's active_connections entry,
    app.py:105-148)."""

    def __init__(self, gateway: "WebGateway"):
        self.sid = uuid.uuid4().hex
        self.gateway = gateway
        self.out: asyncio.Queue = asyncio.Queue()
        self.backends: Dict[str, websockets.ClientConnection] = {}
        self.relays: list = []
        self.upgraded = False            # websocket is the live transport
        self.closed = False
        self._ping_task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- outgoing

    def send(self, packet: str) -> None:
        if not self.closed:
            self.out.put_nowait(packet)

    def emit(self, event: str, data) -> None:
        """Socket.IO EVENT on the default namespace: 4 (EIO message) +
        2 (SIO event) + JSON array."""
        self.send("42" + json.dumps([event, data]))

    # ------------------------------------------------------------- incoming

    async def handle_payload(self, body: str) -> None:
        for packet in body.split(RS):
            await self.handle_packet(packet)

    async def handle_packet(self, pkt: str) -> None:
        if not pkt or self.closed:
            return
        kind = pkt[0]
        if kind == "3":                       # pong — liveness only
            return
        if kind == "1":                       # engine.io close
            await self.close()
            return
        if kind == "4":                       # engine.io message
            await self._sio_packet(pkt[1:])

    async def _sio_packet(self, pkt: str) -> None:
        if not pkt:
            return
        kind = pkt[0]
        if kind == "0":
            # CONNECT (default namespace; payload may carry auth) ->
            # open the per-session worker connections (the reference's
            # @socketio.on('connect') handler, app.py:180-184)
            await self._open_backends()
            self.send("40" + json.dumps({"sid": uuid.uuid4().hex}))
        elif kind == "1":                     # namespace DISCONNECT
            await self._close_backends()
        elif kind == "2":                     # EVENT
            try:
                arr = json.loads(pkt[1:])
            except ValueError:
                return
            if isinstance(arr, list) and arr:
                await self._event(arr[0], arr[1] if len(arr) > 1 else None)

    async def _event(self, name: str, data) -> None:
        # @socketio.on('audio_data'): base64 PCM fanned out to both
        # workers as binary frames (app.py:191-213)
        if name == "audio_data" and isinstance(data, dict):
            try:
                payload = base64.b64decode(data.get("audio", ""))
            except (ValueError, TypeError):
                return
            for conn in list(self.backends.values()):
                try:
                    await conn.send(payload)
                except websockets.exceptions.ConnectionClosed:
                    pass

    # ------------------------------------------------------------- backends

    async def _open_backends(self) -> None:
        for lang, url in self.gateway.urls.items():
            if lang in self.backends:
                continue
            try:
                conn = await websockets.connect(url)
            except OSError as e:
                logger.warning("backend %s (%s) unavailable: %s",
                               lang, url, e)
                continue
            self.backends[lang] = conn
            self.relays.append(asyncio.create_task(
                self._relay(lang, conn)))

    async def _relay(self, lang: str, conn) -> None:
        """Worker results -> 'asr_result' events with the reference's
        response shape (on_vi_message/on_en_message, app.py:23-88):
        vi finals surface transcript_normalized."""
        try:
            async for msg in conn:
                if isinstance(msg, bytes):
                    continue
                try:
                    blob = json.loads(msg)
                except ValueError:
                    continue                    # e.g. __REQUEST_COMPLETED__
                result = blob.get("result")
                if not result:
                    continue
                hyps = result.get("hypotheses") or [{}]
                final = bool(result.get("final"))
                text = None
                if lang == "vi" and final:
                    text = hyps[0].get("transcript_normalized")
                if text is None:
                    text = hyps[0].get("transcript", "")
                self.emit("asr_result",
                          {"type": lang, "text": text, "isFinal": final})
        except (websockets.exceptions.ConnectionClosed,
                ConnectionResetError, asyncio.CancelledError):
            pass

    async def _close_backends(self) -> None:
        for task in self.relays:
            task.cancel()
        self.relays.clear()
        for conn in self.backends.values():
            try:
                await conn.close()
            except Exception:
                pass
        self.backends.clear()

    # -------------------------------------------------------------- control

    def start_ping(self) -> None:
        if self._ping_task is None:
            self._ping_task = asyncio.create_task(self._pinger())

    async def _pinger(self) -> None:
        # Engine.IO v4: the SERVER pings
        try:
            while not self.closed:
                await asyncio.sleep(self.gateway.ping_interval_ms / 1e3)
                self.send("2")
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._ping_task is not None:
            self._ping_task.cancel()
        await self._close_backends()
        self.out.put_nowait("1")          # release any pending long-poll
        self.gateway.sessions.pop(self.sid, None)


class WebGateway:
    def __init__(self, vi_url: Optional[str] = None,
                 en_url: Optional[str] = None,
                 ping_interval_ms: int = 25000,
                 ping_timeout_ms: int = 20000,
                 poll_timeout_s: float = 20.0):
        self.urls = {}
        if vi_url:
            self.urls["vi"] = vi_url
        if en_url:
            self.urls["en"] = en_url
        self.sessions: Dict[str, SocketIOSession] = {}
        self.ping_interval_ms = ping_interval_ms
        self.ping_timeout_ms = ping_timeout_ms
        self.poll_timeout_s = poll_timeout_s

    # --------------------------------------------------- Engine.IO transport

    def _open_packet(self, sid: str, upgrades: list) -> str:
        return "0" + json.dumps({
            "sid": sid, "upgrades": upgrades,
            "pingInterval": self.ping_interval_ms,
            "pingTimeout": self.ping_timeout_ms,
            "maxPayload": 1_000_000,
        })

    async def socketio_handler(self, request: web.Request):
        """GET/POST /socket.io/ — polling transport + websocket upgrade
        (the URL space socket.io-client 4.x speaks, EIO=4)."""
        transport = request.query.get("transport")
        sid = request.query.get("sid")
        if transport == "websocket":
            return await self._sio_websocket(request, sid)
        if transport != "polling":
            return web.Response(status=400, text="unknown transport")

        if request.method == "POST":
            sess = self.sessions.get(sid or "")
            if sess is None:
                return web.Response(status=400, text="unknown sid")
            await sess.handle_payload(await request.text())
            return web.Response(text="ok")

        if sid is None:                       # handshake
            sess = SocketIOSession(self)
            self.sessions[sess.sid] = sess
            sess.start_ping()
            return web.Response(
                text=self._open_packet(sess.sid, ["websocket"]),
                content_type="text/plain", charset="utf-8")

        sess = self.sessions.get(sid)
        if sess is None:
            return web.Response(status=400, text="unknown sid")
        # long poll: first packet blocks, the rest drain
        try:
            first = await asyncio.wait_for(sess.out.get(),
                                           timeout=self.poll_timeout_s)
            packets = [first]
        except asyncio.TimeoutError:
            packets = ["6"]                   # noop keeps the client polling
        while True:
            try:
                packets.append(sess.out.get_nowait())
            except asyncio.QueueEmpty:
                break
        return web.Response(text=RS.join(packets),
                            content_type="text/plain", charset="utf-8")

    async def _sio_websocket(self, request: web.Request, sid: Optional[str]):
        ws = web.WebSocketResponse()
        await ws.prepare(request)

        if sid is None:
            # direct websocket connect (transports: ['websocket'])
            sess = SocketIOSession(self)
            self.sessions[sess.sid] = sess
            sess.upgraded = True
            sess.start_ping()
            await ws.send_str(self._open_packet(sess.sid, []))
        else:
            sess = self.sessions.get(sid)
            if sess is None:
                await ws.close()
                return ws
        writer: Optional[asyncio.Task] = None

        async def pump():
            try:
                while True:
                    pkt = await sess.out.get()
                    await ws.send_str(pkt)
                    if pkt == "1":
                        break
            except (asyncio.CancelledError, ConnectionResetError):
                pass

        if sess.upgraded:
            writer = asyncio.create_task(pump())
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    break
                pkt = msg.data
                if pkt == "2probe":           # upgrade probe
                    await ws.send_str("3probe")
                    sess.send("6")            # noop releases a pending poll
                elif pkt == "5":              # upgrade commit
                    sess.upgraded = True
                    if writer is None:
                        writer = asyncio.create_task(pump())
                else:
                    await sess.handle_packet(pkt)
        finally:
            if writer is not None:
                writer.cancel()
            await sess.close()
        return ws

    async def index(self, request: web.Request) -> web.Response:
        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def ws_handler(self, request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)

        backends: Dict[str, websockets.ClientConnection] = {}
        relays = []
        for lang, url in self.urls.items():
            try:
                conn = await websockets.connect(url)
                backends[lang] = conn
                relays.append(asyncio.create_task(
                    self._relay(lang, conn, ws)))
            except OSError as e:
                logger.warning("backend %s (%s) unavailable: %s",
                               lang, url, e)

        try:
            async for msg in ws:
                if msg.type == WSMsgType.BINARY:
                    payload = msg.data
                elif msg.type == WSMsgType.TEXT:
                    text = msg.data
                    if text.startswith("{"):
                        blob = json.loads(text)
                        if "audio" in blob:   # base64 audio (reference app)
                            payload = base64.b64decode(blob["audio"])
                        else:
                            for conn in backends.values():
                                await conn.send(text)
                            continue
                    else:
                        for conn in backends.values():
                            await conn.send(text)
                        continue
                else:
                    break
                for conn in backends.values():
                    await conn.send(payload)
        finally:
            for task in relays:
                task.cancel()
            for conn in backends.values():
                await conn.close()
        return ws

    @staticmethod
    async def _relay(lang: str, conn, ws: web.WebSocketResponse):
        try:
            async for msg in conn:
                if isinstance(msg, bytes):
                    continue
                if msg == "__REQUEST_COMPLETED__":
                    await ws.send_json({"language": lang, "completed": True})
                    continue
                blob = json.loads(msg)
                blob["language"] = lang
                await ws.send_json(blob)
        except (websockets.exceptions.ConnectionClosed,
                ConnectionResetError, asyncio.CancelledError):
            pass

    def app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/", self.index)
        app.router.add_get("/ws", self.ws_handler)
        # Socket.IO URL space (socket.io-client appends the trailing /)
        app.router.add_get("/socket.io/", self.socketio_handler)
        app.router.add_post("/socket.io/", self.socketio_handler)
        return app


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--vi-url", default=None)
    parser.add_argument("--en-url", default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    gw = WebGateway(args.vi_url, args.en_url)
    web.run_app(gw.app(), port=args.port)


if __name__ == "__main__":
    main()
