"""Device-process isolation: the serving step in a dedicated child process.

Counterpart of asr_streaming_tpu/streaming/device_worker.py.  The parent
keeps the Scheduler's host half (streams, gather/scatter, endpointing);
the audio staging buffers live in POSIX shared memory that the parent
writes directly, and a pipe carries small control messages tagged with
request ids:

    parent                         worker (spawned, fresh torch)
    ------                         -----------------------------
    gather -> staging shm
    "stage idx"           ----->   staging[idx] -> device (async copy)
    "dispatch idx,flags"  ----->   serving step; pack copy to host started
    "harvest"             ----->   wait for the oldest pack -> pack shm
    pack shm <-----------------    "pack"
    "fetch slot,len"      ----->   emission rows -> fetch shm
    "stats reset"         ----->   the child's kernel launch counts

The child serves whatever the pickled ServingConfig names: the CTC tick,
or the English RNNT ticks (greedy or the device beam) with their RNNT
params, state and float16 encoding buffer, the transcriber's Emformer on
the route the config carries (the stack route by default, which the JAX
worker forces for the RNNT Emformer on its device).

The child rebuilds the params from (seed, checkpoint, vad_weights): the
port's random init draws from a seeded ``torch.Generator`` on the CPU, so
parent and child agree.  The route, ``quant`` and every other choice come
in the pickled ServingConfig the parent built, and the child decides
nothing again (the JAX worker re-derives the Pallas route and drops
``quant``; ROADMAP reference fault 8).  An error in the child is raised
in the parent; nothing falls back to running in process.

``PipelinedWorkerClient`` serves several ``GroupedScheduler`` groups from
one child, one batch in flight per group, pushing packs back through a
ring of shared-memory buffers.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import pickle
import sys
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkerInit:
    """Everything the worker needs to rebuild the device side."""
    cfg_bytes: bytes            # pickled ServingConfig
    max_slots: int
    seed: int = 0
    checkpoint: Optional[str] = None
    vad_weights: Optional[str] = None
    device: str = "cuda"        # the tests pass "cpu"
    pipeline_depth: int = 1


def _seg_dtype(cfg):
    return np.uint8 if cfg.upload_encoding == "mulaw" else np.int16


def _foreign_modules() -> list:
    """Loaded modules of jax or the JAX package (the child must have none)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "asr_streaming_tpu"))


class DeviceWorkerClient:
    """Parent-side handle; the call surface the Scheduler's device
    phases map onto."""

    # harvest_async() exists only on PipelinedWorkerClient group views
    supports_pipelining = False

    def __init__(self, cfg, max_slots: int, *, seed: int = 0,
                 checkpoint: Optional[str] = None,
                 vad_weights: Optional[str] = None, device: str = "cuda",
                 pipeline_depth: int = 1):
        from asr_streaming_tpu_torch.models.serving import emission_width

        self.cfg = cfg
        self.max_slots = max_slots
        seg_len = cfg.asr.audio.segment_length
        dt = _seg_dtype(cfg)
        depth = max(1, pipeline_depth) + 1
        self._staging_shm = shared_memory.SharedMemory(
            create=True, size=depth * max_slots * seg_len * dt().nbytes)
        self.staging = np.ndarray((depth, max_slots, seg_len), dt,
                                  buffer=self._staging_shm.buf)
        width = emission_width(cfg)
        self._fetch_shm = shared_memory.SharedMemory(
            create=True, size=cfg.max_emission_frames * width * 4)
        self._fetch_arr = np.ndarray((cfg.max_emission_frames, width),
                                     np.float32, buffer=self._fetch_shm.buf)

        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._req_id = 0
        init = WorkerInit(cfg_bytes=pickle.dumps(cfg), max_slots=max_slots,
                          seed=seed, checkpoint=checkpoint,
                          vad_weights=vad_weights, device=device,
                          pipeline_depth=pipeline_depth)
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child_conn, init, self._staging_shm.name,
                  self._fetch_shm.name),
            name="asr-device-worker", daemon=True)
        self._proc.start()
        child_conn.close()
        self._pack_shm = None
        self._pack_arr = None

    # ------------------------------------------------------------- calls

    def warmup(self, timeout: float = 900.0) -> float:
        rid = self._send(("warmup",))
        kind, payload = self._recv(rid, timeout)
        assert kind == "warm", payload
        secs, pack_shm_name, pack_shape = payload
        self._pack_shm = shared_memory.SharedMemory(name=pack_shm_name)
        self._pack_arr = np.ndarray(tuple(pack_shape), np.float32,
                                    buffer=self._pack_shm.buf)
        return secs

    def stage(self, staging_idx: int) -> None:
        """Non-blocking: the worker starts the host->device copy of this
        staging buffer now, so the upload overlaps the parent's harvest."""
        self._send(("stage", staging_idx))

    def dispatch(self, staging_idx: int, contain, active, new_stream,
                 reset) -> None:
        """Non-blocking: the worker enqueues the serving step."""
        self._send(("dispatch", staging_idx, np.packbits(contain),
                    np.packbits(active), np.packbits(new_stream),
                    np.packbits(reset)))

    def harvest(self, timeout: float = 600.0) -> np.ndarray:
        """Blocks until the OLDEST in-flight step's pack is host-side."""
        rid = self._send(("harvest",))
        kind, payload = self._recv(rid, timeout)
        assert kind == "pack", payload
        return self._pack_arr.copy()

    def fetch_emission(self, slot: int, length: int,
                       timeout: float = 600.0) -> np.ndarray:
        rid = self._send(("fetch", int(slot), int(length)))
        kind, n = self._recv(rid, timeout)
        assert kind == "emission", n
        return self._fetch_arr[:n].copy()

    def stats(self, reset: bool = False, timeout: float = 600.0) -> dict:
        """The child's {"launches": {kernel: count}, "foreign_modules":
        [...], "emformer": {"route", "quant"}}; ``reset`` zeroes the counts
        after reading."""
        rid = self._send(("stats", bool(reset)))
        kind, payload = self._recv(rid, timeout)
        assert kind == "stats", payload
        return payload

    def close(self) -> None:
        try:
            self._send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)
        _unlink(self._staging_shm, self._fetch_shm, self._pack_shm)

    # ----------------------------------------------------------- internal

    def _send(self, msg) -> int:
        """Tag the request with a sequence id the worker echoes back."""
        self._req_id += 1
        self._conn.send((self._req_id,) + msg)
        return self._req_id

    def _recv(self, rid: int, timeout: float):
        """The reply to request ``rid``, dropping stale replies of earlier
        timed-out requests (without ids one timeout would pair every later
        reply with the wrong request)."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._conn.poll(remaining):
                raise TimeoutError(
                    f"device worker unresponsive after {timeout}s "
                    f"(alive={self._proc.is_alive()})")
            msg = self._conn.recv()
            got_rid, rest = msg[0], msg[1:]
            if rest[0] == "error":
                raise RuntimeError(f"device worker error:\n{rest[1]}")
            if got_rid == rid:
                return rest


def _unlink(*shms) -> None:
    for shm in shms:
        if shm is not None:
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass


class _DeviceSide:
    """What a child process holds: device, params, step, flag decoding."""

    def __init__(self, cfg_bytes, seed, checkpoint, vad_weights, device):
        import torch

        from asr_streaming_tpu_torch import resolve_device
        from asr_streaming_tpu_torch.models.serving import (
            init_serving_params, make_emission_fetcher, make_serving_step,
        )
        from asr_streaming_tpu_torch.models.vad import load_vad_weights
        from asr_streaming_tpu_torch.utils.checkpoint import (
            load_params_auto, overlay_params,
        )

        self.torch = torch
        self.cfg = pickle.loads(cfg_bytes)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)      # "cuda" keeps card 0
        params = init_serving_params(seed, self.cfg, self.device)
        if checkpoint:
            # an .npz of the JAX package's layout, possibly partial (a
            # fixture's frontend + encoder), or a reference .ckpt / .pt
            # converted at load: its keys replace the random ones
            params = load_params_auto(checkpoint, like=params)
        if vad_weights:
            params = overlay_params(params,
                                    {"vad": load_vad_weights(vad_weights,
                                                             self.cfg)})
        self.params = params
        self.fetcher = make_emission_fetcher(self.cfg)
        self.step_fn = make_serving_step(self.cfg)
        self.seg_dtype = _seg_dtype(self.cfg)
        self.seg_len = self.cfg.asr.audio.segment_length

    def buffers(self, B):
        from asr_streaming_tpu_torch.models.serving import (
            init_audio_context, init_emission_buffer, init_serving_state,
        )
        return (init_serving_state(self.cfg, B, self.device),
                init_audio_context(self.cfg, B, self.device),
                init_emission_buffer(self.cfg, B, self.device))

    def upload(self, arr: np.ndarray):
        # a pageable source: the copy has read it when .to() returns
        return self.torch.from_numpy(np.array(arr)).to(self.device,
                                                       non_blocking=True)

    def flags(self, bits, B):
        return self.upload(np.unpackbits(bits, count=B).astype(bool))

    def step(self, seg, contain, active, new_stream, reset, bufs, B):
        state, ctx, emission = bufs
        out = self.step_fn(self.params, self.cfg, seg,
                           self.flags(contain, B), self.flags(active, B),
                           self.flags(new_stream, B), self.flags(reset, B),
                           state, ctx, emission)
        return out, (out.state, out.ctx, out.emission)

    def idle_step(self, bufs, B):
        torch = self.torch
        seg = torch.zeros((B, self.seg_len), device=self.device,
                          dtype=torch.uint8 if self.seg_dtype == np.uint8
                          else torch.int16)
        zeros = np.packbits(np.zeros(B, bool))
        return self.step(seg, zeros, zeros, zeros, zeros, bufs, B)

    def synchronize(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def stats(self, reset: bool) -> dict:
        from asr_streaming_tpu_torch.ops import _cuda
        emf = (self.cfg.rnnt if self.cfg.model_kind == "rnnt"
               else self.cfg.asr.encoder).emformer
        return {"launches": _cuda.launch_counts(reset),
                "foreign_modules": _foreign_modules(),
                "emformer": {"route": emf.route, "quant": emf.quant}}


def _worker_main(conn, init: WorkerInit, staging_name: str,
                 fetch_name: str) -> None:
    """Child process: owns params, device state and the serving step."""
    import traceback

    try:
        from asr_streaming_tpu_torch.models.serving import emission_width
        from asr_streaming_tpu_torch.streaming.scheduler import (
            start_pack_copy, wait_pack,
        )

        dev = _DeviceSide(init.cfg_bytes, init.seed, init.checkpoint,
                          init.vad_weights, init.device)
        cfg, B = dev.cfg, init.max_slots
        bufs = dev.buffers(B)
        depth = max(1, init.pipeline_depth) + 1
        staging_shm = shared_memory.SharedMemory(name=staging_name)
        staging = np.ndarray((depth, B, dev.seg_len), dev.seg_dtype,
                             buffer=staging_shm.buf)
        fetch_shm = shared_memory.SharedMemory(name=fetch_name)
        fetch_arr = np.ndarray((cfg.max_emission_frames, emission_width(cfg)),
                               np.float32, buffer=fetch_shm.buf)
        pack_shm = None
        pack_arr = None
        pending = []            # (pack host copy, event), oldest first
        staged = {}             # staging idx -> device tensor

        while True:
            msg = conn.recv()
            rid, op = msg[0], msg[1]
            if op == "stop":
                break
            elif op == "warmup":
                t0 = time.perf_counter()
                out, bufs = dev.idle_step(bufs, B)
                dev.synchronize()
                pw = out.pack.cpu().numpy()
                pack_shm = shared_memory.SharedMemory(create=True,
                                                      size=pw.nbytes)
                pack_arr = np.ndarray(pw.shape, np.float32,
                                      buffer=pack_shm.buf)
                conn.send((rid, "warm", (time.perf_counter() - t0,
                                         pack_shm.name, pw.shape)))
            elif op == "stage":
                staged[msg[2]] = dev.upload(staging[msg[2]])
            elif op == "dispatch":
                _, _, idx, contain, active, new_stream, reset = msg
                seg = staged.pop(idx, None)
                if seg is None:
                    seg = dev.upload(staging[idx])
                out, bufs = dev.step(seg, contain, active, new_stream, reset,
                                     bufs, B)
                pending.append(start_pack_copy(out.pack))
            elif op == "harvest":
                pack_arr[...] = wait_pack(*pending.pop(0))
                conn.send((rid, "pack", None))
            elif op == "fetch":
                _, _, slot, length = msg
                rows = dev.fetcher(bufs[2], slot, length)
                fetch_arr[:len(rows), :rows.shape[1]] = rows
                conn.send((rid, "emission", len(rows)))
            elif op == "stats":
                conn.send((rid, "stats", dev.stats(msg[2])))
            else:
                conn.send((rid, "error", f"unknown op {op!r}"))
        if pack_shm is not None:
            pack_shm.close()
    except BaseException:
        try:
            conn.send((0, "error", traceback.format_exc()))
        except Exception:
            pass


# --------------------------------------------------------------------------
# Pipelined multi-group worker
# --------------------------------------------------------------------------
#
# The classic client above is strict request/reply: one batch in flight.
# The pipelined client multiplexes ALL GroupedScheduler groups through ONE
# child, keeps one batch in flight per group, and PUSHES pack results
# back through a ring of shared-memory buffers:
#
#     parent tick thread                 child
#     ------------------                 -----
#     dispatch g=A  ------------------>  step(state[A]); queue its pack
#     dispatch g=B  ------------------>  step(state[B]); queue its pack
#                     <---------------  "pack_ready rid_A, ring slot i"
#     (receiver thread copies ring[i], acks, resolves future A)
#
# A harvest thread in the child waits for each pack in dispatch order
# while the child's main loop keeps taking dispatches; a receiver thread
# in the parent resolves the per-request futures.


@dataclasses.dataclass(frozen=True)
class PipelinedWorkerInit:
    cfg_bytes: bytes
    per_slots: int              # slots per group
    n_groups: int
    ring_size: int
    seed: int = 0
    checkpoint: Optional[str] = None
    vad_weights: Optional[str] = None
    device: str = "cuda"
    staging_depth: int = 2      # buffers per group (depth + 1)


class _GroupView:
    """The Scheduler-facing surface for one group of a shared
    PipelinedWorkerClient (the call shape of DeviceWorkerClient)."""

    supports_pipelining = True

    def __init__(self, client: "PipelinedWorkerClient", group: int):
        self._c = client
        self._g = group
        self.staging = client.staging[group]
        self._futures = []      # FIFO of in-flight dispatch futures

    def warmup(self, timeout: float = 900.0) -> float:
        return self._c.warmup(timeout)

    def stage(self, staging_idx: int) -> None:
        self._c.stage(self._g, staging_idx)

    def dispatch(self, staging_idx: int, contain, active, new_stream,
                 reset) -> None:
        self._futures.append(self._c.dispatch(
            self._g, staging_idx, contain, active, new_stream, reset))

    def harvest_async(self):
        """Future for the OLDEST in-flight dispatch of this group."""
        return self._futures.pop(0)

    def harvest(self, timeout: float = 600.0) -> np.ndarray:
        return self._futures.pop(0).result(timeout)

    def fetch_emission(self, slot: int, length: int,
                       timeout: float = 600.0) -> np.ndarray:
        return self._c.fetch_emission(self._g, slot, length, timeout)

    def close(self) -> None:
        self._c.release()


class PipelinedWorkerClient:
    """One spawned device process serving N scheduler groups with
    pipelined dispatch/harvest (see the notes above)."""

    def __init__(self, cfg, per_slots: int, n_groups: int = 1, *,
                 seed: int = 0, checkpoint: Optional[str] = None,
                 vad_weights: Optional[str] = None, device: str = "cuda",
                 pipeline_depth: int = 1):
        import threading
        from concurrent.futures import Future

        from asr_streaming_tpu_torch.models.serving import emission_width

        self.cfg = cfg
        self.per_slots = per_slots
        self.n_groups = n_groups
        seg_len = cfg.asr.audio.segment_length
        dt = _seg_dtype(cfg)
        depth = max(1, pipeline_depth) + 1
        self.ring_size = n_groups + 2
        self._staging_shm = shared_memory.SharedMemory(
            create=True,
            size=n_groups * depth * per_slots * seg_len * dt().nbytes)
        self.staging = np.ndarray((n_groups, depth, per_slots, seg_len), dt,
                                  buffer=self._staging_shm.buf)
        width = emission_width(cfg)
        self._fetch_shm = shared_memory.SharedMemory(
            create=True, size=cfg.max_emission_frames * width * 4)
        self._fetch_arr = np.ndarray((cfg.max_emission_frames, width),
                                     np.float32, buffer=self._fetch_shm.buf)

        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._req_id = 0
        self._send_lock = threading.Lock()
        self._fetch_lock = threading.Lock()
        self._futures: dict = {}          # rid -> Future
        self._futures_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        init = PipelinedWorkerInit(
            cfg_bytes=pickle.dumps(cfg), per_slots=per_slots,
            n_groups=n_groups, ring_size=self.ring_size, seed=seed,
            checkpoint=checkpoint, vad_weights=vad_weights, device=device,
            staging_depth=depth)
        self._proc = ctx.Process(
            target=_pipelined_worker_main,
            args=(child_conn, init, self._staging_shm.name,
                  self._fetch_shm.name),
            name="asr-device-worker", daemon=True)
        self._proc.start()
        child_conn.close()
        self._pack_shm = None
        self._ring = None
        self._refs = n_groups
        self._warm: Optional[float] = None
        self._Future = Future
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="worker-recv", daemon=True)
        self._recv_thread.start()

    def group_view(self, group: int) -> _GroupView:
        return _GroupView(self, group)

    # ------------------------------------------------------------- calls

    def warmup(self, timeout: float = 900.0) -> float:
        """The first caller runs the child's warm-up step; later group
        views return 0 at once."""
        if self._warm is not None:
            return 0.0
        kind, payload = self._request(("warmup",)).result(timeout)
        assert kind == "warm", payload
        secs, pack_shm_name, ring_shape = payload
        self._pack_shm = shared_memory.SharedMemory(name=pack_shm_name)
        self._ring = np.ndarray(tuple(ring_shape), np.float32,
                                buffer=self._pack_shm.buf)
        self._warm = secs
        return secs

    def stage(self, group: int, staging_idx: int) -> None:
        self._post(("stage", group, staging_idx))

    def dispatch(self, group: int, staging_idx: int, contain, active,
                 new_stream, reset):
        """Non-blocking; returns a Future resolving to the pack."""
        return self._request(("dispatch", group, staging_idx,
                              np.packbits(contain), np.packbits(active),
                              np.packbits(new_stream), np.packbits(reset)))

    def fetch_emission(self, group: int, slot: int, length: int,
                       timeout: float = 600.0) -> np.ndarray:
        # one fetch buffer: hold the lock across request and copy-out
        with self._fetch_lock:
            kind, n = self._request(("fetch", group, int(slot),
                                     int(length))).result(timeout)
            assert kind == "emission", n
            return self._fetch_arr[:n].copy()

    def stats(self, reset: bool = False, timeout: float = 600.0) -> dict:
        """The child's {"launches": {kernel: count}, "foreign_modules":
        [...], "emformer": {"route", "quant"}}; ``reset`` zeroes the counts
        after reading."""
        kind, payload = self._request(("stats", bool(reset))).result(timeout)
        assert kind == "stats", payload
        return payload

    def release(self) -> None:
        """Called once per group view; the last release closes the child."""
        self._refs -= 1
        if self._refs <= 0:
            self.close()

    def close(self) -> None:
        try:
            with self._send_lock:
                self._conn.send((0, "stop"))
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)
        _unlink(self._staging_shm, self._fetch_shm, self._pack_shm)

    # ----------------------------------------------------------- internal

    def _post(self, msg) -> None:
        """Fire-and-forget message (no reply expected)."""
        if self._dead is not None:
            raise RuntimeError("device worker died") from self._dead
        with self._send_lock:
            self._req_id += 1
            self._conn.send((self._req_id,) + msg)

    def _request(self, msg):
        """Send a message and register a Future for its reply."""
        if self._dead is not None:
            raise RuntimeError("device worker died") from self._dead
        fut = self._Future()
        with self._send_lock:
            self._req_id += 1
            rid = self._req_id
            with self._futures_lock:
                self._futures[rid] = fut
            self._conn.send((rid,) + msg)
        return fut

    def _recv_loop(self) -> None:
        """Single reader of the pipe: resolves futures, copies packs out
        of the ring and acks the ring slot back to the child."""
        try:
            while True:
                try:
                    msg = self._conn.recv()
                except (EOFError, OSError):
                    raise RuntimeError(
                        "device worker pipe closed (child exited?)")
                rid, kind = msg[0], msg[1]
                if kind == "error":
                    raise RuntimeError(f"device worker error:\n{msg[2]}")
                if kind == "pack_ready":
                    ring_slot = msg[2]
                    payload = self._ring[ring_slot].copy()
                    with self._send_lock:
                        self._conn.send((0, "ack", ring_slot))
                else:
                    payload = (kind,) + tuple(msg[2:])
                with self._futures_lock:
                    fut = self._futures.pop(rid, None)
                if fut is not None:
                    fut.set_result(payload)
        except BaseException as e:
            self._dead = e
            with self._futures_lock:
                pending = list(self._futures.values())
                self._futures.clear()
            for fut in pending:
                if not fut.done():
                    fut.set_exception(e)


def _pipelined_worker_main(conn, init: PipelinedWorkerInit,
                           staging_name: str, fetch_name: str) -> None:
    """Child: G serving states, one step function, a harvest thread that
    streams packs back through the shm ring in dispatch order."""
    import queue
    import threading
    import traceback

    send_lock = threading.Lock()

    def send(msg):
        with send_lock:
            conn.send(msg)

    try:
        from asr_streaming_tpu_torch.models.serving import emission_width
        from asr_streaming_tpu_torch.streaming.scheduler import (
            start_pack_copy, wait_pack,
        )

        dev = _DeviceSide(init.cfg_bytes, init.seed, init.checkpoint,
                          init.vad_weights, init.device)
        cfg, G, B = dev.cfg, init.n_groups, init.per_slots
        bufs = [dev.buffers(B) for _ in range(G)]
        staging_shm = shared_memory.SharedMemory(name=staging_name)
        staging = np.ndarray((G, init.staging_depth, B, dev.seg_len),
                             dev.seg_dtype, buffer=staging_shm.buf)
        fetch_shm = shared_memory.SharedMemory(name=fetch_name)
        fetch_arr = np.ndarray((cfg.max_emission_frames, emission_width(cfg)),
                               np.float32, buffer=fetch_shm.buf)

        pack_shm = None
        ring = None
        free_slots: "queue.Queue[int]" = queue.Queue()
        harvest_q: "queue.Queue" = queue.Queue()
        staged = {}                     # (group, idx) -> device tensor

        def harvest_loop():
            while True:
                item = harvest_q.get()
                if item is None:
                    return
                rid, host, event = item
                try:
                    pack = wait_pack(host, event)
                    slot = free_slots.get()
                    ring[slot][...] = pack
                    send((rid, "pack_ready", slot))
                except BaseException:
                    send((0, "error", traceback.format_exc()))
                    return

        harvest_thread = None
        while True:
            msg = conn.recv()
            rid, op = msg[0], msg[1]
            if op == "stop":
                if harvest_thread is not None:
                    harvest_q.put(None)
                    harvest_thread.join(timeout=60)
                break
            elif op == "warmup":
                t0 = time.perf_counter()
                out, bufs[0] = dev.idle_step(bufs[0], B)
                dev.synchronize()
                pw = out.pack.cpu().numpy()
                pack_shm = shared_memory.SharedMemory(
                    create=True, size=init.ring_size * pw.nbytes)
                ring_shape = (init.ring_size,) + pw.shape
                ring = np.ndarray(ring_shape, np.float32, buffer=pack_shm.buf)
                for i in range(init.ring_size):
                    free_slots.put(i)
                harvest_thread = threading.Thread(
                    target=harvest_loop, name="pack-harvest", daemon=True)
                harvest_thread.start()
                send((rid, "warm", (time.perf_counter() - t0, pack_shm.name,
                                    ring_shape)))
            elif op == "stage":
                g, idx = msg[2], msg[3]
                staged[(g, idx)] = dev.upload(staging[g, idx])
            elif op == "dispatch":
                _, _, g, idx, contain, active, new_stream, reset = msg
                seg = staged.pop((g, idx), None)
                if seg is None:
                    seg = dev.upload(staging[g, idx])
                out, bufs[g] = dev.step(seg, contain, active, new_stream,
                                        reset, bufs[g], B)
                harvest_q.put((rid, *start_pack_copy(out.pack)))
            elif op == "ack":
                free_slots.put(msg[2])
            elif op == "fetch":
                _, _, g, slot, length = msg
                rows = dev.fetcher(bufs[g][2], slot, length)
                fetch_arr[:len(rows), :rows.shape[1]] = rows
                send((rid, "emission", len(rows)))
            elif op == "stats":
                send((rid, "stats", dev.stats(msg[2])))
            else:
                send((rid, "error", f"unknown op {op!r}"))
        if pack_shm is not None:
            pack_shm.close()
    except BaseException:
        try:
            send((0, "error", traceback.format_exc()))
        except Exception:
            pass
