"""Continuous-batching scheduler: N streams -> one fixed-shape step per tick.

Counterpart of asr_streaming_tpu/streaming/scheduler.py, for the
Vietnamese CTC tick and the English RNNT ticks.  Streams occupy fixed
slots of a ``[max_slots, ...]`` device-resident state.  Each tick:

  1. gather one ready chunk per stream (from streams with no chunk in
     flight when ``pipeline_depth`` > 1), encode it (mu-law or int16)
     into a staging buffer and start its host->device copy.  The encode
     is the native fused gather (utils/codec_native.py: each stream's
     segment view straight into its staging row, as the JAX scheduler
     does) unless ``ASR_NO_FUSED_GATHER`` is set or no C++ compiler is
     there, then the numpy LUT; ``stats()`` names the one that ran;
  2. harvest the OLDEST in-flight batch (its ``[B, 5 + U]`` pack) and
     scatter it to the ``Stream`` state machines, which produce partial
     and final ``StreamEvent``s;
  3. dispatch the new batch: per-slot flags, the serving step
     (models/serving.py), and the pack's device->host copy started at
     once.

A chunk's events surface one tick after its gather, as in the JAX
package.  The pack is waited for on a harvest thread unless
``ASR_NO_ASYNC_HARVEST`` is set.  With ``device_worker`` (or a ``worker``
view) the serving step runs in a spawned child process
(streaming/device_worker.py) and this object keeps the host half.
``GroupedScheduler`` ticks several such schedulers round-robin.

English (``model_kind="rnnt"``): the pack's data columns are the chunk's
greedy tokens, or, with ``en_beam_partials`` (``en_beam_impl="device"``,
the default), the device beam's best hypothesis ``[n_tokens, tokens...]``;
``en_beam_impl="host"`` runs the host oracle ``RNNTBeamDecoder`` on every
chunk instead (parity and debugging; needs the device in this process).

With ``mesh`` (parallel/mesh.py) the slots are split over the mesh's
cards (parallel/serving.py): each shard's state, context and emission
buffer live on its card, each tick uploads every shard's block of the
staging rows to its card and runs the step once per shard, and the
shards' packs are joined in slot order on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.rnnt import (
    RNNTBeamDecoder, detokenize_pieces,
)
from asr_streaming_tpu_torch.models.serving import (
    PACK_DATA, PACK_DECODED, PACK_LEAD, PACK_TRAIL, ServingConfig,
    init_audio_context,
    init_emission_buffer, init_serving_state, make_emission_fetcher,
    make_serving_step, mulaw_encode_host, slot_rows,
)
from asr_streaming_tpu_torch.parallel.serving import (
    make_sharded_stepper, replicate_params, shard_serving_arrays, split_rows,
)
from asr_streaming_tpu_torch.streaming.endpoint import NgramEndpointCost
from asr_streaming_tpu_torch.streaming.stream import FinalSegment, Stream
from asr_streaming_tpu_torch.utils import codec_native
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy
from asr_streaming_tpu_torch.utils.observability import StageTimers


@dataclasses.dataclass
class StreamEvent:
    """One event to deliver to a client."""
    stream_id: str
    kind: str                   # "partial" | "final"
    text: str = ""
    is_final: bool = False
    segment: Optional[FinalSegment] = None
    utterance_seconds: float = 0.0
    stream: Optional[Stream] = None
    # perf_counter timestamp of the dispatch that produced this event
    dispatched_at: float = 0.0


def _apply_beam_cfg(cfg: ServingConfig, en_beam_partials: bool,
                    en_beam_width: int, en_beam_impl: str) -> ServingConfig:
    """Resolve the EN beam-partials mode into the ServingConfig: the device
    implementation changes the step (serving_step_rnnt_beam) and the pack
    width, so it must happen before ANY consumer of cfg (device state,
    emission buffer, worker client) is built."""
    if (en_beam_partials and en_beam_impl == "device"
            and cfg.model_kind == "rnnt" and not cfg.en_beam_width_device):
        return dataclasses.replace(cfg, en_beam_width_device=en_beam_width)
    return cfg


def start_pack_copy(pack):
    """Start the pack's device->host copy without waiting: returns (host
    tensor, CUDA event or None).  On the CPU the pack is already there.
    A sharded pack (a list, one per shard) gives the lists of both."""
    if isinstance(pack, list):
        copies = [start_pack_copy(p) for p in pack]
        return [h for h, _ in copies], [e for _, e in copies]
    if pack.device.type != "cuda":
        return pack, None
    host = torch.empty(pack.shape, dtype=pack.dtype, pin_memory=True)
    host.copy_(pack, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(pack.device))
    return host, event


def wait_pack(host, event) -> np.ndarray:
    """Block until a started pack copy has landed; a numpy copy of it
    (the shards' packs joined in slot order)."""
    if isinstance(host, list):
        return np.concatenate([wait_pack(h, e) for h, e in zip(host, event)])
    if event is not None:
        event.synchronize()
    return host.numpy().copy()


def _landed(event) -> bool:
    """Has a started pack copy (of every shard) landed?"""
    if isinstance(event, list):
        return all(map(_landed, event))
    return event is None or event.query()


def _flag_columns(flags):
    """The uploaded [B, 4] flags (or one block per shard) as (contain,
    active, new_stream, reset)."""
    if isinstance(flags, list):
        return [[f[:, j] for f in flags] for j in range(4)]
    return [flags[:, j] for j in range(4)]


class Scheduler:
    def __init__(self, params: dict, cfg: ServingConfig,
                 vocab: Sequence[str], max_slots: int = 8,
                 language: str = "vi",
                 rules: Optional[dict] = None,
                 ngram_cost: Optional[NgramEndpointCost] = None,
                 rulesets: Optional[dict] = None,
                 mapping_rule: Optional[dict] = None,
                 device=None,
                 pipeline_depth: int = 1,
                 mesh=None,
                 device_worker: Optional[dict] = None,
                 worker=None,
                 en_beam_partials: bool = False,
                 en_beam_width: int = 10,
                 en_beam_impl: str = "device"):
        """``device_worker``: keyword arguments of
        ``DeviceWorkerClient`` (seed, checkpoint, vad_weights, device): the
        serving step runs in a child process that rebuilds the params from
        them, and ``params`` / ``device`` are not used here.  ``worker``:
        a ready client or ``PipelinedWorkerClient`` group view.
        ``en_beam_partials`` (RNNT only): the carried-hypothesis beam on
        every chunk, partials being true deltas of the best hypothesis's
        text; ``en_beam_impl`` "device" rides the serving step, "host" is
        the per-stream oracle loop.  ``mesh``: split the slots over its
        cards (parallel/serving.py; ``device`` is then not used)."""
        if mesh is not None and (device_worker is not None
                                 or worker is not None):
            raise ValueError(
                "device_worker and mesh are exclusive: the worker child "
                "owns the device(s); use data_parallel without "
                "device_worker, or device_worker alone")
        if mesh is not None and max_slots % mesh.shape["data"]:
            raise ValueError(f"max_slots={max_slots} is not a multiple of "
                             f"the mesh's data axis ({mesh.shape['data']})")
        cfg = _apply_beam_cfg(cfg, en_beam_partials, en_beam_width,
                              en_beam_impl)
        self.step_fn = make_serving_step(cfg)
        self.is_rnnt = cfg.model_kind == "rnnt"
        self.en_beam_partials = en_beam_partials and self.is_rnnt
        self._beam_device = bool(cfg.en_beam_width_device)
        self._beam = None               # the host oracle, built below
        self.cfg = cfg
        self.vocab = list(vocab)
        self.max_slots = max_slots
        self.language = language
        self.rules = rules
        self.ngram_cost = ngram_cost
        self.rulesets = rulesets
        self.mapping_rule = mapping_rule
        self.pipeline_depth = max(1, pipeline_depth)
        self.mesh = mesh

        self.worker = worker
        if device_worker is not None and worker is None:
            from asr_streaming_tpu_torch.streaming.device_worker import (
                DeviceWorkerClient,
            )
            self.worker = DeviceWorkerClient(
                cfg, max_slots, pipeline_depth=self.pipeline_depth,
                **device_worker)
        if (self.worker is not None and self.en_beam_partials
                and not self._beam_device):
            raise ValueError(
                "en_beam_partials host impl needs in-process device access; "
                "use en_beam_impl='device' (default) with a device worker")

        # staging: depth + 1 buffers [B, segment_length], because the
        # upload of an in-flight batch may still read its buffer while
        # later ticks stage; flags [B, 4] beside them, written at dispatch
        self._mulaw = cfg.upload_encoding == "mulaw"
        self._seg_len = cfg.asr.audio.segment_length
        n_stage = self.pipeline_depth + 1
        if self.worker is None:
            if mesh is None:
                self.device = resolve_device(device)
                self.params = params_from_numpy(params, self.device)
            else:
                self.device = mesh.devices[0]
                self.step_fn = make_sharded_stepper(cfg, mesh, params)
                self.params = self.step_fn.params
            self.device_state = init_serving_state(cfg, max_slots,
                                                   self.device)
            self.emission_buf = init_emission_buffer(cfg, max_slots,
                                                     self.device)
            self.audio_ctx = init_audio_context(cfg, max_slots, self.device)
            if mesh is not None:
                self.device_state, self.audio_ctx, self.emission_buf = \
                    shard_serving_arrays(cfg, mesh, self.device_state,
                                         self.audio_ctx, self.emission_buf)
            self._fetch_emission = make_emission_fetcher(cfg)
            if self.en_beam_partials and not self._beam_device:
                self._beam = RNNTBeamDecoder(
                    self.params if mesh is None else self.params[0],
                    cfg.rnnt, beam_width=en_beam_width)
            pin = self.device.type == "cuda"
            self._staging = torch.zeros(
                (n_stage, max_slots, self._seg_len),
                dtype=torch.uint8 if self._mulaw else torch.int16,
                pin_memory=pin)
            self._segment = self._staging.numpy()
            self._flags = torch.zeros((n_stage, max_slots, 4),
                                      dtype=torch.bool, pin_memory=pin)
            self._flags_np = self._flags.numpy()
        else:
            self.device = None
            self.params = params
            self.device_state = self.emission_buf = self.audio_ctx = None
            self._fetch_emission = \
                lambda _buf, slot, ln: self.worker.fetch_emission(slot, ln)
            self._segment = self.worker.staging
        self._staging_idx = 0
        self._seg_dev = None            # this tick's uploaded segment

        self.streams: Dict[int, Stream] = {}     # slot -> stream
        self._free = list(range(max_slots))[::-1]
        self._needs_reset = np.zeros(max_slots, bool)
        self._new_stream = np.zeros(max_slots, bool)

        # in-flight batches, oldest first: (pack host copy, its event,
        # ready list, dispatch time, harvest future)
        self._pending: deque = deque()
        self.pending_slots: set = set()
        # the pack is waited for on a thread, submitted at dispatch, so a
        # GroupedScheduler's other groups tick while it is in flight
        self._async_harvest = not os.environ.get("ASR_NO_ASYNC_HARVEST")
        self._harvest_pool: Optional[ThreadPoolExecutor] = None

        self.timers = StageTimers()
        self.last_tick_seconds = 0.0
        self.ticks = 0
        # the encoder of the newest gather: "native" (the fused C++ pass,
        # utils/codec_native.py) or "numpy" (the LUT; no compiler, or
        # ASR_NO_FUSED_GATHER set); None before the first gather
        self.gather_encoder: Optional[str] = None

    # ------------------------------------------------------------- lifecycle

    @property
    def num_active(self) -> int:
        return len(self.streams)

    def admit(self, stream_id: str) -> Optional[Stream]:
        """Allocate a slot; None if the server is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        stream = Stream(self.cfg.asr.audio, self.vocab,
                        language=self.language, rules=self.rules,
                        ngram_cost=self.ngram_cost, stream_id=stream_id,
                        keep_emission=False,  # emissions live on device
                        rulesets=self.rulesets,
                        mapping_rule=self.mapping_rule)
        stream._slot = slot
        self.streams[slot] = stream
        self._needs_reset[slot] = True
        self._new_stream[slot] = True   # zero the device audio context
        return stream

    def release(self, stream: Stream) -> None:
        slot = stream._slot
        if self.streams.get(slot) is stream:
            del self.streams[slot]
            self._needs_reset[slot] = True
            self._free.append(slot)

    def close(self) -> None:
        """Stop the harvest thread and the device worker, if any."""
        if self._harvest_pool is not None:
            self._harvest_pool.shutdown(wait=True)
            self._harvest_pool = None
        if self.worker is not None:
            self.worker.close()

    def stats(self) -> dict:
        """What this scheduler ran: the encoder of its newest gather
        (``gather_encoder``) and its tick count."""
        return {"gather_encoder": self.gather_encoder, "ticks": self.ticks}

    def warmup(self) -> float:
        """Run one all-idle step (builds the CUDA kernels on first use)
        and return its seconds.  Idle slots' state, context and emissions
        are unchanged by it."""
        if self.worker is not None:
            return self.worker.warmup()
        t0 = time.perf_counter()
        seg = self._upload(torch.zeros(self._staging.shape[1:],
                                       dtype=self._staging.dtype))
        idle = self._upload(torch.zeros((self.max_slots, 4),
                                        dtype=torch.bool))
        self._run_step(seg, *_flag_columns(idle))
        for dev in set(self.mesh.devices if self.mesh else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def _upload(self, host: torch.Tensor):
        """Start a per-slot host tensor's copy to the device (to each
        shard's device, its block of rows, with a mesh)."""
        if self.mesh is not None:
            return split_rows(host, self.mesh)
        if self.device.type == "cuda":
            return host.to(self.device, non_blocking=True)
        return host.clone()             # the staging buffer is reused

    def _run_step(self, seg, contain, active, new_stream, reset):
        out = self.step_fn(self.params, self.cfg, seg, contain, active,
                           new_stream, reset, self.device_state,
                           self.audio_ctx, self.emission_buf)
        self.device_state = out.state
        self.audio_ctx = out.ctx
        self.emission_buf = out.emission
        return out

    # ------------------------------------------------------------------ tick

    def has_work(self) -> bool:
        return bool(self._pending) or \
            any(s.has_chunk() for s in self.streams.values())

    def harvest_ready(self) -> bool:
        """True when the OLDEST in-flight batch's pack is already on the
        host, so a tick now surfaces its events without blocking."""
        if not self._pending:
            return False
        _, event, _, _, fut = self._pending[0]
        if fut is not None:
            return fut.done()
        if self.worker is not None:
            return False
        return _landed(event)

    def is_pending(self, stream: Stream) -> bool:
        """Is this stream's chunk in an in-flight batch?"""
        return getattr(stream, "_slot", None) in self.pending_slots

    def tick(self) -> List[StreamEvent]:
        """One pipelined cycle: gather + encode + start the upload of the
        new batch; harvest the oldest in-flight batch (always at depth 1,
        at deeper pipelines once the queue is full or nothing is new) and
        scatter it; dispatch the new batch.  A chunk's events surface one
        tick after its gather (depth 1)."""
        t0 = time.perf_counter()

        # ---- phase 1: gather + encode + upload.  Depth 1 gathers every
        # ready stream (its flags are read at dispatch, after this tick's
        # harvest settled them); deeper pipelines skip streams with a
        # chunk in flight.
        if self.pipeline_depth == 1:
            ready = [(slot, s) for slot, s in self.streams.items()
                     if s.has_chunk()]
        else:
            ready = [(slot, s) for slot, s in self.streams.items()
                     if s.has_chunk() and slot not in self.pending_slots]
        staged_idx = self._staging_idx
        if ready:
            self._staging_idx = (staged_idx + 1) % len(self._segment)
            # encode only the ready rows; idle rows keep stale bytes,
            # which the step ignores (not active: no decode, no context)
            staging = self._segment[staged_idx]
            if (not os.environ.get("ASR_NO_FUSED_GATHER")
                    and codec_native.native_available()):
                # each ready stream's segment view straight into its
                # staging row, in one native pass
                views = [s.pop_chunk_view() for _, s in ready]
                slots = np.array([slot for slot, _ in ready], np.int32)
                codec_native.gather_encode_into(views, slots, staging,
                                                self._mulaw)
                del views
                self.gather_encoder = "native"
            else:
                slots = np.array([slot for slot, _ in ready])
                audio = np.stack([s.pop_chunk() for _, s in ready])
                if self._mulaw:
                    encoded = mulaw_encode_host(audio)
                else:
                    encoded = np.clip(audio * 32767.0, -32768,
                                      32767).astype(np.int16)
                staging[slots] = encoded
                self.gather_encoder = "numpy"
            self.timers.observe("gather_encode", time.perf_counter() - t0)
            if self.worker is None:
                self._seg_dev = self._upload(self._staging[staged_idx])
            else:
                self.worker.stage(staged_idx)   # the child starts the copy
            self.timers.observe("gather_upload", time.perf_counter() - t0)

        # ---- phase 2: harvest the oldest in-flight batch
        events: List[StreamEvent] = []
        if self._pending and (len(self._pending) >= self.pipeline_depth
                              or not ready):
            host, event, ready_prev, t_dispatch, fut = \
                self._pending.popleft()
            if fut is not None:
                pack = fut.result()
            elif self.worker is not None:
                pack = self.worker.harvest()
            else:
                pack = wait_pack(host, event)
            self.pending_slots = {slot for _, _, batch, _, _ in self._pending
                                  for slot, _ in batch}
            self.timers.observe("device_step",
                                time.perf_counter() - t_dispatch)
            events = self._scatter(pack, ready_prev,
                                   dispatched_at=t_dispatch)

        # ---- phase 3: dispatch the new batch
        if ready:
            active = np.zeros(self.max_slots, bool)
            contain = np.zeros(self.max_slots, bool)
            for slot, s in ready:
                active[slot] = True
                contain[slot] = s.is_contain_token
            t_dispatch = time.perf_counter()
            host = event = fut = None
            if self.worker is not None:
                self.worker.dispatch(staged_idx, contain, active,
                                     self._new_stream, self._needs_reset)
                if self._async_harvest and self.worker.supports_pipelining:
                    fut = self.worker.harvest_async()
            else:
                flags = self._flags_np[staged_idx]
                flags[:, 0], flags[:, 1] = contain, active
                flags[:, 2], flags[:, 3] = self._new_stream, self._needs_reset
                f = self._upload(self._flags[staged_idx])
                out = self._run_step(self._seg_dev, *_flag_columns(f))
                host, event = start_pack_copy(out.pack)
                if self._async_harvest:
                    if self._harvest_pool is None:
                        self._harvest_pool = ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="pack-harvest")
                    fut = self._harvest_pool.submit(wait_pack, host, event)
            self._needs_reset[:] = False
            self._new_stream[:] = False
            self._pending.append((host, event, ready, t_dispatch, fut))
            self.pending_slots |= {slot for slot, _ in ready}

        self.ticks += 1
        self.last_tick_seconds = time.perf_counter() - t0
        self.timers.observe("tick", self.last_tick_seconds)
        return events

    def _scatter(self, pack: np.ndarray, ready,
                 dispatched_at: float = 0.0) -> List[StreamEvent]:
        t_host = time.perf_counter()
        decoded = pack[:, PACK_DECODED] > 0.5
        lead = pack[:, PACK_LEAD]
        trail = pack[:, PACK_TRAIL]
        data = pack[:, PACK_DATA:].astype(np.int32)   # argmax / rnnt tokens
        events: List[StreamEvent] = []
        partial_update = {}
        for slot, s in ready:
            if decoded[slot] and self.is_rnnt:
                partial_update[slot] = self._apply_en(
                    s, slot, data[slot], trail[slot], lead[slot])
            elif decoded[slot]:
                s.apply_decode(data[slot])
                partial_update[slot] = True
            else:
                s.skip_silence()
            is_final, utt_len = s.check_endpoint(advance=False)
            if is_final:
                self._needs_reset[slot] = True  # zero state on the next tick
                if self._beam is not None:
                    # a new segment starts a fresh hypothesis (device impl:
                    # the reset flag re-initialises the beam on the card)
                    s.hypotheses = None
                emission_len = s.emission_length
                seg = s.take_final_segment(utt_len)
                if emission_len > 0:
                    # fetch this segment's device rows before the slot
                    # resets and overwrites them
                    seg.emission = self._fetch_emission(
                        self.emission_buf, slot, emission_len)
                    seg.length = emission_len
                events.append(StreamEvent(
                    stream_id=s.id, kind="final", text=seg.transcript_greedy,
                    is_final=True, segment=seg, utterance_seconds=utt_len,
                    stream=s, dispatched_at=dispatched_at))
            elif decoded[slot] and partial_update.get(slot) and \
                    s.transcript_internal.strip():
                # (EN sends partials only on nonempty deltas)
                events.append(StreamEvent(
                    stream_id=s.id, kind="partial",
                    text=s.transcript_internal, stream=s,
                    dispatched_at=dispatched_at))
        self.timers.observe("host_scatter", time.perf_counter() - t_host)
        self.timers.increment("chunks_processed", len(ready))
        self.timers.increment(
            "chunks_decoded", int(sum(1 for slot, _ in ready if decoded[slot])))
        self.timers.increment("finals", sum(1 for e in events if e.is_final))
        return events

    def _apply_en(self, s: Stream, slot: int, data: np.ndarray,
                  trail: float, lead: float) -> bool:
        """One decoded EN chunk into its stream; True when the transcript
        changed (a partial is due)."""
        U = self.cfg.rnnt.emformer.segment_length
        if not self.en_beam_partials:
            blank = self.cfg.rnnt.blank
            delta = detokenize_pieces([int(t) for t in data if t != blank],
                                      self.vocab, lstrip=False)
            s.apply_decode_en(delta, trail, lead, enc_frames=U)
            return bool(delta.strip())
        prev = s.transcript_internal
        if self._beam_device:
            # the pack carries the best hypothesis [n_tokens, tokens...];
            # the host only detokenizes
            n = int(data[0])
            full = detokenize_pieces([int(t) for t in data[1:1 + n]],
                                     self.vocab, lstrip=False)
        else:
            # host-impl oracle: the carried-hypothesis beam over this
            # chunk's device-buffered transcriber encodings
            pos = int(s.emission_length)
            buf, row = slot_rows(self.emission_buf, slot)
            enc = buf[row, pos:pos + U].to(torch.float32).cpu().numpy()
            try:
                s.hypotheses = self._beam.step_chunk(
                    enc, getattr(s, "hypotheses", None))
                full = detokenize_pieces(s.hypotheses[0].tokens, self.vocab,
                                         lstrip=False)
            except IndexError:
                # the reference's rule: an IndexError resets the hypothesis
                s.hypotheses = None
                full = prev
        delta = full[len(prev):] if full.startswith(prev) else full
        s.apply_decode_en(delta, trail, lead, enc_frames=U, full_text=full)
        return full != prev

    def drain(self, max_ticks: int = 10_000) -> List[StreamEvent]:
        """Run ticks until no stream has a ready chunk."""
        events: List[StreamEvent] = []
        for _ in range(max_ticks):
            if not self.has_work():
                break
            events.extend(self.tick())
        return events


class GroupedScheduler:
    """N slot groups ticked round-robin: the latency-oriented serving mode
    (the JAX package's GroupedScheduler).

    Each group is a Scheduler with its own device state, all sharing one
    step shape; a chunk waits at most one small group-tick to be gathered,
    and the groups' host work and device steps interleave on one card.
    With ``device_worker`` all groups share ONE child process
    (``PipelinedWorkerClient``), which keeps one batch in flight per group
    and pushes packs back through a shared-memory ring.
    """

    def __init__(self, params: dict, cfg: ServingConfig,
                 vocab: Sequence[str], max_slots: int = 512,
                 groups: int = 4, **kwargs):
        # resolve the EN beam mode BEFORE the shared worker client is built
        # (it sizes the pack's shared memory from cfg); each group's
        # Scheduler applies it again, idempotently
        cfg = _apply_beam_cfg(cfg, kwargs.get("en_beam_partials", False),
                              kwargs.get("en_beam_width", 10),
                              kwargs.get("en_beam_impl", "device"))
        groups = max(1, min(groups, max_slots))
        per = -(-max_slots // groups)          # ceil; capacity >= max_slots
        mesh = kwargs.get("mesh")
        if mesh is not None:
            # each group's slots split over the mesh's data axis: round the
            # group size up so any (groups, data_parallel) pair works
            dp = mesh.shape["data"]
            per = -(-per // dp) * dp
        device_worker = kwargs.pop("device_worker", None)
        if device_worker is not None and mesh is not None:
            raise ValueError("device_worker and mesh are exclusive")
        self.client = None
        if device_worker is not None:
            from asr_streaming_tpu_torch.streaming.device_worker import (
                PipelinedWorkerClient,
            )
            self.client = PipelinedWorkerClient(
                cfg, per, groups,
                pipeline_depth=kwargs.get("pipeline_depth", 1),
                **device_worker)
            self.groups = [Scheduler(params, cfg, vocab, max_slots=per,
                                     worker=self.client.group_view(g),
                                     **kwargs)
                           for g in range(groups)]
        else:
            if kwargs.get("worker") is None and mesh is not None:
                # one copy of the weights per card for every group
                params = replicate_params(params, mesh)
            elif kwargs.get("worker") is None:
                # one device copy of the weights for every group
                params = params_from_numpy(
                    params, resolve_device(kwargs.get("device")))
            self.groups = [Scheduler(params, cfg, vocab, max_slots=per,
                                     **kwargs) for _ in range(groups)]
        self.cfg = cfg
        self.vocab = self.groups[0].vocab
        self.language = self.groups[0].language
        self.max_slots = per * groups
        self._next = 0

    @property
    def num_active(self) -> int:
        return sum(g.num_active for g in self.groups)

    @property
    def ticks(self) -> int:
        return sum(g.ticks for g in self.groups)

    @property
    def timers(self):
        outer = self

        class _Merged:
            def snapshot(self):
                snaps = [g.timers.snapshot() for g in outer.groups]
                out = snaps[0]
                for s in snaps[1:]:
                    for k, v in s["counters"].items():
                        out["counters"][k] = out["counters"].get(k, 0) + v
                return out

        return _Merged()

    def stats(self) -> dict:
        """The groups' stats: ``gather_encoder`` is the one encoder every
        group that gathered used, or their names joined by "+"."""
        encoders = sorted({g.gather_encoder for g in self.groups}
                          - {None})
        return {"gather_encoder": "+".join(encoders) or None,
                "ticks": self.ticks}

    def warmup(self) -> float:
        return sum(g.warmup() for g in self.groups)

    def admit(self, stream_id: str) -> Optional[Stream]:
        # the least-loaded group keeps batches balanced
        for g in sorted(self.groups, key=lambda g: g.num_active):
            s = g.admit(stream_id)
            if s is not None:
                s._group = g
                return s
        return None

    def release(self, stream: Stream) -> None:
        getattr(stream, "_group", self.groups[0]).release(stream)

    def is_pending(self, stream: Stream) -> bool:
        g = getattr(stream, "_group", None)
        return g.is_pending(stream) if g is not None else False

    def has_work(self) -> bool:
        return any(g.has_work() for g in self.groups)

    def tick(self) -> List[StreamEvent]:
        """Tick ONE group: first a group whose in-flight pack is already
        on the host (its events surface now), else the next round-robin
        group with work."""
        n = len(self.groups)
        for k in range(n):
            g = self.groups[(self._next + k) % n]
            if g.harvest_ready():
                self._next = (self._next + k + 1) % n
                return g.tick()
        for k in range(n):
            g = self.groups[(self._next + k) % n]
            if g.has_work():
                self._next = (self._next + k + 1) % n
                return g.tick()
        g = self.groups[self._next]
        self._next = (self._next + 1) % n
        return g.tick()

    def drain(self, max_ticks: int = 10_000) -> List[StreamEvent]:
        events: List[StreamEvent] = []
        for _ in range(max_ticks):
            if not self.has_work():
                break
            events.extend(self.tick())
        return events

    def close(self) -> None:
        for g in self.groups:
            g.close()
