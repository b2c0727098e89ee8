"""Continuous-batching scheduler: N streams -> one fixed-shape step per tick.

Counterpart of asr_streaming_tpu/streaming/scheduler.py for the CTC path,
in process, one batch in flight, harvested synchronously.  Streams occupy
fixed slots of a ``[max_slots, ...]`` device-resident state.  Each tick:

  1. gather one ready chunk per stream and encode it (mu-law LUT or
     int16) into a pinned host staging array, with the four per-slot
     flags in its last columns;
  2. one non-blocking host->device copy of that array;
  3. run the serving step (models/serving.py) on the device;
  4. read the ``[B, 5 + U]`` pack back and scatter it to the ``Stream``
     state machines, which produce partial and final ``StreamEvent``s.

The JAX scheduler surfaces a chunk's events one tick after its gather;
here they surface in the same tick.  The sequence of events ``drain()``
returns is the same.  Grouped scheduling, meshes, the device worker,
pipelining and the English beam are not ported yet and raise if asked.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.serving import (
    PACK_DATA, PACK_DECODED, ServingConfig, init_audio_context,
    init_emission_buffer, init_serving_state, make_emission_fetcher,
    make_serving_step, mulaw_encode_host,
)
from asr_streaming_tpu_torch.streaming.endpoint import NgramEndpointCost
from asr_streaming_tpu_torch.streaming.stream import FinalSegment, Stream
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy
from asr_streaming_tpu_torch.utils.observability import StageTimers

# staging columns after the segment: per-slot flags
_FLAG_CONTAIN, _FLAG_ACTIVE, _FLAG_NEW, _FLAG_RESET = range(4)


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
                 en_beam_partials: bool = False):
        for name, given in (("pipeline_depth > 1", pipeline_depth != 1),
                            ("mesh", mesh is not None),
                            ("device_worker", device_worker is not None),
                            ("en_beam_partials", en_beam_partials)):
            if given:
                raise NotImplementedError(
                    f"{name} is not ported yet (in-process, depth-1, CTC "
                    "scheduling only)")
        self.device = resolve_device(device)
        self.step_fn = make_serving_step(cfg)
        self.params = params_from_numpy(params, self.device)
        self.cfg = cfg
        self.vocab = list(vocab)
        self.max_slots = max_slots
        self.language = language
        self.rules = rules
        self.ngram_cost = ngram_cost
        self.rulesets = rulesets
        self.mapping_rule = mapping_rule

        self.device_state = init_serving_state(cfg, max_slots, self.device)
        self.emission_buf = init_emission_buffer(cfg, max_slots, self.device)
        self.audio_ctx = init_audio_context(cfg, max_slots, self.device)
        self._fetch_emission = make_emission_fetcher(cfg)

        self.streams: Dict[int, Stream] = {}     # slot -> stream
        self._free = list(range(max_slots))[::-1]
        self._needs_reset = np.zeros(max_slots, bool)
        self._new_stream = np.zeros(max_slots, bool)

        # pinned staging: [B, segment_length + 4] (segment, then flags);
        # one non-blocking copy per tick moves all of it
        self._mulaw = cfg.upload_encoding == "mulaw"
        self._seg_len = cfg.asr.audio.segment_length
        seg_dtype = torch.uint8 if self._mulaw else torch.int16
        self._staging = torch.zeros(
            (max_slots, self._seg_len + 4), dtype=seg_dtype,
            pin_memory=self.device.type == "cuda")
        self._staging_np = self._staging.numpy()

        self.timers = StageTimers()
        self.last_tick_seconds = 0.0
        self.ticks = 0

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
        """Nothing to shut down in process; kept for the JAX surface."""

    def warmup(self) -> float:
        """Run one all-idle step (builds the CUDA kernels on first use)
        and return its seconds.  Idle slots' state, context and emissions
        are unchanged by it."""
        t0 = time.perf_counter()
        self._staging_np[:] = 0
        self._run_step(self._staging.to(self.device, non_blocking=True))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _run_step(self, staged: torch.Tensor):
        seg = staged[:, :self._seg_len]
        flags = staged[:, self._seg_len:] != 0
        out = self.step_fn(self.params, self.cfg, seg,
                           flags[:, _FLAG_CONTAIN], flags[:, _FLAG_ACTIVE],
                           flags[:, _FLAG_NEW], flags[:, _FLAG_RESET],
                           self.device_state, self.audio_ctx,
                           self.emission_buf)
        self.device_state = out.state
        self.audio_ctx = out.ctx
        self.emission_buf = out.emission
        return out

    # ------------------------------------------------------------------ tick

    def has_work(self) -> bool:
        return any(s.has_chunk() for s in self.streams.values())

    def tick(self) -> List[StreamEvent]:
        """Gather, upload, step, harvest, scatter."""
        t0 = time.perf_counter()
        ready = [(slot, s) for slot, s in self.streams.items()
                 if s.has_chunk()]
        if not ready:
            self.ticks += 1
            self.last_tick_seconds = time.perf_counter() - t0
            return []

        # encode only the ready rows; idle rows keep stale bytes, which
        # the step ignores (not active: no decode, no context update)
        slots = np.array([slot for slot, _ in ready])
        audio = np.stack([s.pop_chunk() for _, s in ready])
        if self._mulaw:
            encoded = mulaw_encode_host(audio)
        else:
            encoded = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        self._staging_np[slots, :self._seg_len] = encoded
        flags = self._staging_np[:, self._seg_len:]
        flags[:] = 0
        for slot, s in ready:
            flags[slot, _FLAG_ACTIVE] = 1
            flags[slot, _FLAG_CONTAIN] = s.is_contain_token
        flags[:, _FLAG_NEW] = self._new_stream
        flags[:, _FLAG_RESET] = self._needs_reset
        self.timers.observe("gather_encode", time.perf_counter() - t0)

        t_dispatch = time.perf_counter()
        staged = self._staging.to(self.device, non_blocking=True)
        out = self._run_step(staged)
        self._needs_reset[:] = False
        self._new_stream[:] = False
        pack = out.pack.cpu().numpy()          # synchronous harvest
        self.timers.observe("device_step", time.perf_counter() - t_dispatch)
        events = self._scatter(pack, ready, dispatched_at=t_dispatch)

        self.ticks += 1
        self.last_tick_seconds = time.perf_counter() - t0
        self.timers.observe("tick", self.last_tick_seconds)
        return events

    def _scatter(self, pack: np.ndarray, ready,
                 dispatched_at: float = 0.0) -> List[StreamEvent]:
        t_host = time.perf_counter()
        decoded = pack[:, PACK_DECODED] > 0.5
        data = pack[:, PACK_DATA:].astype(np.int32)
        events: List[StreamEvent] = []
        for slot, s in ready:
            if decoded[slot]:
                s.apply_decode(data[slot])
            else:
                s.skip_silence()
            is_final, utt_len = s.check_endpoint(advance=False)
            if is_final:
                self._needs_reset[slot] = True  # zero state on the next tick
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
            elif decoded[slot] and s.transcript_internal.strip():
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

    def drain(self, max_ticks: int = 10_000) -> List[StreamEvent]:
        """Run ticks until no stream has a ready chunk."""
        events: List[StreamEvent] = []
        for _ in range(max_ticks):
            if not self.has_work():
                break
            events.extend(self.tick())
        return events
