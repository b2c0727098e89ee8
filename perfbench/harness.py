"""One run of one cell: build the port's serving path from the cell's
files, warm it up, drive the window, trace it, check it.

The window drives ``asr_streaming_tpu_torch.streaming.scheduler.
GroupedScheduler`` in this process (``device_worker`` off): streams are
admitted with ``admit``, fed with ``Stream.accept_waveform`` and released
with ``release``; the window times the ``tick()`` calls and what they
return.  Two small wrappers on each group, installed after its warm-up
step, record what the check needs: at dispatch the host flags of the
sampled streams' slots (and, for the device beam, their beam as the
previous step left it), at harvest the pack rows (and, at a final, the
emission rows the scheduler fetched) of the sampled streams, and the
harvested batches themselves (for each chunk's harvest time and, in the
closed loop, its refill).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import traffic as traffic_mod
from perfbench.counts import model as model_counts

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "asr_streaming_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def process_age_s() -> float:
    """Seconds since this process started (from /proc), so that set-up
    counts the interpreter's start and the imports."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict             # the cell's entry in BENCHMARK.json
    work: dict              # perfbench/workloads/<name>.json
    model: dict             # perfbench/configs/<config>.json
    mix: dict               # perfbench/traffic/<traffic>.json


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    work = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: workload file and BENCHMARK.json disagree")
    model = load_json(os.path.join(HERE, "configs", f"{entry['config']}.json"))
    return Cell(name, entry, work, model, traffic_mod.load_mix(entry["traffic"]))


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit; a number the run could not read fails."""
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------- the system

def serving_setup(model: dict, serving: dict, device, seed: int, tr,
                  quant: Optional[str] = None):
    """(params, ServingConfig, scheduler kwargs, vocab) for a
    configuration file's model and serving settings; the weights from
    ``seed``, calibrated on the traffic ``tr``."""
    from asr_streaming_tpu_torch.models.asr import (
        ASRConfig, emformer_route, with_kernel_route,
    )
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.models.encoder import EncoderConfig
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    from asr_streaming_tpu_torch.ops.frontend import MelConfig, make_mel_params
    from asr_streaming_tpu_torch.streaming.endpoint import load_endpoint_rules
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    from asr_streaming_tpu_torch.utils.audio import AudioConfig
    from perfbench.calibrate import calibrate
    from perfbench.weights import ctc_weights, rnnt_weights

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        serving["compute_dtype"]]
    quant = quant or serving["quant"]
    a = model["audio"]
    audio = AudioConfig(sample_rate=a["sample_rate"],
                        hop_seconds=a["hop_seconds"],
                        segment_size=a["segment_size"],
                        context_size=a["context_size"], bias=a["bias"],
                        framerate=a["framerate"])
    if (audio.segment_length, audio.buffer_length) != (
            a["segment_length"], a["buffer_length"]):
        raise ValueError("audio geometry disagrees with its lengths")
    e = model["emformer"]
    em = EmformerConfig(
        d_model=e["d_model"], num_heads=e["num_heads"], ffn_dim=e["ffn_dim"],
        num_layers=e["num_layers"], segment_length=e["segment_length"],
        left_context_length=e["left_context_length"],
        right_context_length=e["right_context_length"],
        max_memory_size=e["max_memory_size"], compute_dtype=dtype)
    m = model["mel"]
    mel_fields = dict(n_fft=m["n_fft"], win_length=m["win_length"],
                      hop_length=m["hop_length"], n_mels=m["n_mels"],
                      center=m["center"], output_transform=m["transform"])
    common = dict(use_silero=serving["use_silero"],
                  upload_encoding=serving["upload_encoding"],
                  energy_threshold_db=model["energy_threshold_db"])
    rules = load_endpoint_rules(model["endpoint_rules"])
    kwargs = dict(language=model["language"], rules=rules,
                  pipeline_depth=serving["pipeline_depth"], device=device)
    vocab = placeholder_vocab(model["vocab_size"])
    if model["kind"] == "ctc":
        mel = dataclasses.replace(MelConfig.for_vietnamese(), **mel_fields)
        enc = EncoderConfig(input_dim=model["n_mels"], d_model=model["d_model"],
                            vocab_size=model["vocab_size"],
                            ctc_hidden_dim=model["ctc_hidden_dim"], emformer=em)
        asr = with_kernel_route(ASRConfig(audio=audio, mel=mel, encoder=enc),
                                serving["route"], quant)
        cfg = ServingConfig(asr=asr, **common)
        params = {"frontend": make_mel_params(mel, device),
                  "encoder": ctc_weights(seed, model, device)}
        calibrate(params["encoder"], model, tr, device)
        return params, cfg, kwargs, vocab
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    mel = dataclasses.replace(MelConfig.for_english(), **mel_fields)
    rnnt = RNNTConfig(
        n_mels=model["n_mels"], input_linear_dim=model["input_linear_dim"],
        d_model=model["d_model"], encoding_dim=model["encoding_dim"],
        vocab_size=model["vocab_size"], blank=model["blank"],
        pred_embed_dim=model["pred_embed_dim"],
        pred_hidden=model["pred_hidden"], pred_layers=model["pred_layers"],
        max_symbols_per_frame=model["max_symbols_per_frame"],
        emformer=emformer_route(em, serving["route"], quant))
    asr = dataclasses.replace(ASRConfig.vietnamese(dtype), audio=audio)
    cfg = ServingConfig(asr=asr, model_kind="rnnt", rnnt=rnnt,
                        en_beam_cap=model["beam_cap"], **common)
    params = rnnt_weights(seed, model, device)
    calibrate(params, model, tr, device)
    params["en_frontend"] = make_mel_params(mel, device)
    kwargs.update(en_beam_partials=serving["en_beam_partials"],
                  en_beam_width=model["beam_width"],
                  en_beam_impl=serving["en_beam_impl"])
    return params, cfg, kwargs, vocab


# ---------------------------------------------------------------- recording

class StreamRecord:
    """What the check needs of one sampled stream: per chunk it
    processed, the dispatched flags (contain, active, new_stream, reset;
    a reset or new-stream flag set while the stream had no chunk in the
    batch carries to its next chunk) and the harvested pack row; the
    emission rows of each final, by the index of the chunk that ended
    its segment.  With the device beam, ``beams`` holds the stream's beam
    (tokens, lengths, scores) as each dispatch of its group found it, and
    ``beam_at[k]`` the index in it of chunk k's dispatch: the beam chunk
    k started from, and at ``beam_at[k] + 1`` the one it left."""

    def __init__(self, stream, offset: int):
        self.stream = stream
        self.offset = offset
        self.flags: List[tuple] = []
        self.packs: List[np.ndarray] = []
        self.finals: Dict[int, np.ndarray] = {}
        self.beams: list = []
        self.beam_at: List[int] = []
        self._new = self._reset = False

    def dispatch(self, row, beam=None):
        contain, active, new, reset = (bool(x) for x in row)
        if active:
            self.flags.append((contain, True, new or self._new,
                               reset or self._reset))
            self._new = self._reset = False
            if beam is not None:
                self.beam_at.append(len(self.beams))
        else:
            self._new |= new
            self._reset |= reset
        if beam is not None:
            self.beams.append(beam)


class BeamCapture:
    """A group's device beam at the sampled slots, copied on the card at
    each dispatch (stream-ordered before the step, so it holds what the
    previous step left), with the encodings the step's beam then reads
    there (float32, before kernel B rounds them to float16); brought to
    the host after the window."""

    def __init__(self):
        self.slots: tuple = ()
        self.idx = None
        self.taken: list = []           # (tokens, lengths, scores) on the card
        self.encs: list = []            # [slots, U, E], one a dispatch
        self.host: Optional[tuple] = None

    def take(self, g, slots) -> int:
        if slots != self.slots:
            self.slots = slots
            self.idx = torch.tensor(slots, dtype=torch.long,
                                    device=g.device_state.beam.scores.device)
        b = g.device_state.beam
        self.taken.append((b.tokens.index_select(0, self.idx),
                           b.lengths.index_select(0, self.idx),
                           b.scores.index_select(0, self.idx)))
        return len(self.taken) - 1

    def get(self, i: int, row: int):
        """(tokens, lengths, scores, encodings or None) of capture i."""
        if self.host is None:
            self.host = tuple([x[n].cpu().numpy() for x in self.taken]
                              for n in range(3)) + (
                [x.cpu().numpy() for x in self.encs],)
        enc = self.host[3][i][row] if i < len(self.host[3]) else None
        return tuple(f[i][row] for f in self.host[:3]) + (enc,)


class BeamRef:
    """One stream's beam at one capture, read on the host when needed."""
    __slots__ = ("cap", "i", "row")

    def __init__(self, cap: BeamCapture, i: int, row: int):
        self.cap, self.i, self.row = cap, i, row

    def read(self):
        return self.cap.get(self.i, self.row)


class Recorder:
    def __init__(self):
        self.by_slot: Dict[object, Dict[int, StreamRecord]] = defaultdict(dict)
        self.records: List[StreamRecord] = []
        self.harvests: list = []
        self.captures: Dict[object, BeamCapture] = {}
        self.stepping: Optional[BeamCapture] = None
        self.restore = None
        self.tracing = False

    def span(self, name):
        if self.tracing:
            return torch.profiler.record_function("bench." + name)
        return _NULL

    def follow(self, stream, offset: int) -> StreamRecord:
        rec = StreamRecord(stream, offset)
        self.by_slot[stream._group][stream._slot] = rec
        self.records.append(rec)
        return rec

    def unfollow(self, stream):
        slots = self.by_slot[stream._group]
        if stream._slot in slots and slots[stream._slot].stream is stream:
            del slots[stream._slot]

    def fetch_tails(self):
        """After the window: the emission rows of each sampled stream's
        segment in progress, as its scheduler would fetch them at a final
        (rows of the chunks harvested so far)."""
        for r in self.records:
            s, g = r.stream, r.stream._group
            if r.packs and g.streams.get(s._slot) is s and s.emission_length:
                r.finals[len(r.packs) - 1] = np.asarray(g._fetch_emission(
                    g.emission_buf, s._slot, s.emission_length), np.float32)

    def install(self, sched):
        for g in sched.groups:
            if hasattr(g.device_state, "beam"):
                self.captures[g] = BeamCapture()
            self._wrap(g)
        if self.captures:
            self._hook_beam_step()

    def _hook_beam_step(self):
        """The serving step's call of the device beam, wrapped to copy the
        encodings it is given at the sampled slots (one gather on the
        card); ``uninstall`` puts the program's function back."""
        from asr_streaming_tpu_torch.models import serving
        step = serving.rnnt_beam_chunk_step
        rec = self

        def beam_step(params, cfg, enc, state, *args, **kwargs):
            cap = rec.stepping
            if cap is not None and cap.idx is not None:
                cap.encs.append(enc.index_select(0, cap.idx))
            return step(params, cfg, enc, state, *args, **kwargs)

        serving.rnnt_beam_chunk_step = beam_step
        self.restore = lambda: setattr(serving, "rnnt_beam_chunk_step", step)

    def uninstall(self):
        if self.restore is not None:
            self.restore()
            self.restore = None

    def capture_beams(self):
        """After the last step: each group's beam at its sampled streams'
        slots, the beam their last chunks left."""
        for g, cap in self.captures.items():
            self._capture(g, cap, None)

    def _capture(self, g, cap, flags):
        sampled = self.by_slot[g]
        live = {slot: r for slot, r in sampled.items()
                if g.streams.get(slot) is r.stream}
        slots = tuple(sorted(sampled))
        i = cap.take(g, slots) if (cap is not None and slots) else None
        for slot, r in live.items():
            beam = BeamRef(cap, i, slots.index(slot)) if i is not None \
                else None
            if flags is not None:
                r.dispatch(flags[slot], beam)
            elif beam is not None:
                r.beams.append(beam)

    def _wrap(self, g):
        run_step, scatter = g._run_step, g._scatter
        sampled = self.by_slot[g]
        cap = self.captures.get(g)
        rec = self

        def dispatch(seg, contain, active, new_stream, reset):
            if sampled:
                rec._capture(g, cap, g._flags_np[
                    (g._staging_idx - 1) % len(g._flags_np)])
            rec.stepping = cap if sampled else None
            try:
                with rec.span("dispatch"):
                    return run_step(seg, contain, active, new_stream, reset)
            finally:
                rec.stepping = None

        def harvest(pack, ready, dispatched_at=0.0):
            with rec.span("scatter"):
                events = scatter(pack, ready, dispatched_at)
            rec.harvests.append((ready, dispatched_at))
            if sampled:
                for slot, s in ready:
                    r = sampled.get(slot)
                    if r is not None and r.stream is s:
                        r.packs.append(pack[slot].copy())
                        for e in events:
                            if e.is_final and e.stream is s and \
                                    e.segment.emission is not None:
                                r.finals[len(r.packs) - 1] = np.asarray(
                                    e.segment.emission, np.float32)
            return events

        g._run_step = dispatch
        g._scatter = harvest


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _Null()


# ------------------------------------------------------------------ the run

@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader may read."""
    cell: str
    loop: str
    model: dict
    slots_per_group: int
    period: float
    setup_s: float = 0.0
    window_s: float = 0.0
    chunks: int = 0                 # chunks harvested in the window
    tick_s: List[float] = dataclasses.field(default_factory=list)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    waits_s: List[float] = dataclasses.field(default_factory=list)
    # the latencies of the chunks counted in ``waits_s``; and of every
    # chunk due in the window, by 5 s part of it (for the log)
    quiet_latencies_s: List[float] = dataclasses.field(default_factory=list)
    latency_parts: List[List[float]] = dataclasses.field(
        default_factory=list)
    attempted: int = 0
    failed: int = 0
    lateness_s: List[float] = dataclasses.field(default_factory=list)
    gc_pauses_s: List[float] = dataclasses.field(default_factory=list)
    host: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    def chunk_flops(self) -> float:
        return model_counts.chunk_flops(self.model)


class GCWatch:
    """The interpreter's collection pauses while installed."""

    def __init__(self):
        self.pauses: List[float] = []
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *a):
        gc.callbacks.remove(self._cb)
        return False


class HostLoad:
    """What can be read of the load over the window: this process's CPU
    seconds (``getrusage``: the host side is one busy thread and the
    harvest thread) and, at the close, the card's clocks, power and
    throttle reasons (``nvidia-smi``, where there is one).  The machine's
    own counters (``/proc/stat``, the load average) read as constants
    inside the sandbox that runs the cells, so they are not kept."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    def read(self) -> dict:
        wall = time.perf_counter() - self.t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"wall_s": wall,
               "process_cpu_s": (ru.ru_utime - self.ru0.ru_utime)
               + (ru.ru_stime - self.ru0.ru_stime)}
        try:
            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,temperature.gpu,clocks_throttle_reasons.active",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().replace(" ", "")
        except (OSError, subprocess.SubprocessError):
            pass
        return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace_turn(tracer, rec, now, trace_at):
    """Start the profiler once ``now`` reaches ``trace_at[0]``; stop it
    ``trace_at[1]`` seconds after it started."""
    if not tracer.active and not tracer.done and now >= trace_at[0]:
        tracer.start()
        rec.tracing = True
    elif tracer.active and time.perf_counter() - tracer.t0 >= trace_at[1]:
        rec.tracing = False
        tracer.stop()


class Loop:
    """Offers a cell's traffic to a GroupedScheduler."""

    def __init__(self, sched, traffic, rec: Recorder, sample_rng, n_sample):
        self.sched = sched
        self.tr = traffic
        self.rec = rec
        self.seg = traffic.segment
        self.n_sample = n_sample
        self.rng = sample_rng

    # ---- closed loop: backlogged streams
    def closed_start(self):
        """Admit the streams, each with ``backlog`` chunks queued; from
        then on every chunk harvested is replaced by the stream's next,
        so the backlog stays whole and the client's work is one chunk a
        harvested chunk, spread over the ticks as the harvests are."""
        mix, n = self.tr.mix, int(self.tr.mix["streams"])
        sampled = set(self.rng.choice(n, size=min(self.n_sample, n),
                                      replace=False).tolist())
        self.streams, self.fed = [], np.zeros(n, np.int64)
        self.feeding = True
        for i in range(n):
            s = self.sched.admit(f"s{i}")
            if s is None:
                raise RuntimeError(f"admission {i} of {n} refused")
            s.keep_audio_total = False
            s._bench_index = i
            if i in sampled:
                self.rec.follow(s, int(self.tr.offsets[i]))
            self.streams.append(s)
            for _ in range(int(mix["backlog"])):
                self._feed(i)

    def _feed(self, i):
        self.streams[i].accept_waveform(
            self.tr.chunk(int(self.tr.offsets[i]), int(self.fed[i])))
        self.fed[i] += 1

    def offered(self) -> int:
        return int(self.fed.sum())

    def closed_until(self, t_end, run: Optional[RunRecord] = None,
                     tracer=None, trace_at=(None, None)):
        sched, rec = self.sched, self.rec
        while True:
            t = time.perf_counter()
            if t >= t_end:
                return
            if tracer is not None:
                _trace_turn(tracer, rec, t, trace_at)
                t = time.perf_counter()
            with rec.span("tick"):
                sched.tick()
            dt = time.perf_counter() - t
            if run is not None and not rec.tracing:
                run.tick_s.append(dt)
            if self.feeding:
                for ready, _ in rec.harvests:
                    for _, s in ready:
                        self._feed(s._bench_index)
            rec.harvests.clear()

    def closed_drain(self, t_end):
        """After the window: no more feeding; tick until every chunk
        offered is harvested, or ``t_end``."""
        self.feeding = False
        sched = self.sched
        while sched.has_work() and time.perf_counter() < t_end:
            sched.tick()
            self.rec.harvests.clear()

    # ---- open loop: paced streams with churn
    def open_start(self, sample_until_s):
        """The arrival schedule as arrays (few Python objects: the
        collector's pauses stay the program's own)."""
        p, period = self.tr.paced, self.tr.period
        cands = [x.index for x in p if x.start < sample_until_s]
        self.sampled = set()
        if self.n_sample > 0:
            longest = max(cands, key=lambda i: min(p[i].n_chunks, int(
                (sample_until_s - p[i].start) / period)))
            self.sampled = set(self.rng.choice(
                cands, size=min(self.n_sample - 1, len(cands)),
                replace=False).tolist()) | {longest}
        n = np.array([x.n_chunks for x in p], np.int64)
        self.start = np.array([x.start for x in p])
        self.n_chunks = n
        self.base = np.concatenate([[0], np.cumsum(n)[:-1]])
        idx = np.repeat(np.arange(len(p)), n)
        k = np.arange(int(n.sum())) - np.repeat(self.base, n)
        due = self.start[idx] + k * period
        order = np.argsort(due, kind="stable")
        self.arr_due, self.arr_i, self.arr_k = due[order], idx[order], k[order]
        self.ai = 0
        total = int(n.sum())
        self.due_t = np.full(total, np.nan)      # fed at, by chunk
        self.fed_t = np.full(total, np.nan)
        self.done_t = np.full(total, np.nan)     # harvested at
        self.disp_t = np.full(total, np.nan)     # dispatched at
        self.n_done = np.zeros(len(p), np.int64)
        self.live: Dict[int, object] = {}
        self.refused: set = set()
        self.longest_tick = 0.0

    def open_until(self, origin, end_s, tracer=None, trace_at=(None, None)):
        sched, rec, p = self.sched, self.rec, self.tr.paced
        due_a, i_a, k_a = self.arr_due, self.arr_i, self.arr_k
        n_arr = len(due_a)
        while True:
            now = time.perf_counter() - origin
            if now >= end_s:
                return
            if tracer is not None:
                _trace_turn(tracer, rec, now, trace_at)
            while self.ai < n_arr and due_a[self.ai] <= now:
                i, k = int(i_a[self.ai]), int(k_a[self.ai])
                j = self.base[i] + k
                self.due_t[j] = due_a[self.ai]
                self.ai += 1
                if k == 0:
                    s = sched.admit(f"p{i}")
                    if s is None:
                        self.refused.add(i)
                        continue
                    s.keep_audio_total = False
                    s._bench_index = i
                    self.live[i] = s
                    if i in self.sampled:
                        rec.follow(s, p[i].offset)
                s = self.live.get(i)
                if s is None:
                    continue
                s.accept_waveform(self.tr.chunk(p[i].offset, k))
                self.fed_t[j] = now
            if sched.has_work():
                with rec.span("tick"):
                    sched.tick()
                t = time.perf_counter() - origin
                self.longest_tick = max(self.longest_tick, t - now)
                for ready, dispatched_at in rec.harvests:
                    for _, s in ready:
                        i = s._bench_index
                        j = self.base[i] + self.n_done[i]
                        self.done_t[j] = t
                        self.disp_t[j] = dispatched_at - origin
                        self.n_done[i] += 1
                        if self.n_done[i] == self.n_chunks[i]:
                            rec.unfollow(s)
                            sched.release(s)
                            del self.live[i]
                rec.harvests.clear()
            else:
                nxt = due_a[self.ai] if self.ai < n_arr else end_s
                time.sleep(max(0.0, min(0.002, nxt - now)))

    def open_stats(self, run: RunRecord, w0, w1, deadline, skip=None):
        """Latency of every chunk due in [w0, w1): harvest time minus due
        time; a chunk not harvested by ``deadline`` (or of a stream whose
        admission was refused) is failed and counts with the deadline as
        its harvest."""
        due = self.start[np.repeat(np.arange(len(self.n_chunks)),
                                   self.n_chunks)] \
            + (np.arange(len(self.done_t)) - np.repeat(self.base,
                                                       self.n_chunks)) \
            * self.tr.period
        in_w = (due >= w0) & (due < w1)
        done = self.done_t[in_w]
        ok = ~np.isnan(done) & (done <= deadline)
        lat = np.where(ok, done - due[in_w], deadline - due[in_w])
        run.latencies_s = lat.tolist()
        quiet = ok
        if skip is not None:            # the profiled part and its stop,
            d = due[in_w]               # and a period each side
            quiet = ok & ((d < skip[0] - self.tr.period)
                          | (d > skip[1] + self.tr.period))
        run.waits_s = (self.disp_t[in_w][quiet] - due[in_w][quiet]).tolist()
        run.quiet_latencies_s = lat[quiet].tolist()
        d = due[in_w]
        run.latency_parts = [
            lat[(d >= a) & (d < a + 5.0)].tolist()
            for a in np.arange(w0, w1, 5.0)]
        run.attempted, run.failed = int(in_w.sum()), int((~ok).sum())
        fed = self.fed_t[in_w]
        run.lateness_s = (fed[~np.isnan(fed)]
                          - due[in_w][~np.isnan(fed)]).tolist()


def warm_path(sched, tr) -> None:
    """Set-up: one idle step per group (the kernels' first launches), then
    a chunk through every group's whole tick path (the native gather's
    build, the pinned pack copies, the harvest thread), its streams
    released after."""
    sched.warmup()
    probes = [sched.admit(f"warm{g}") for g in range(len(sched.groups))]
    for s in probes:
        s.accept_waveform(tr.chunk(0, 0))
    sched.drain()
    for s in probes:
        sched.release(s)


def build_scheduler(cell: Cell, params, cfg, kwargs, vocab, device):
    from asr_streaming_tpu_torch.streaming.scheduler import GroupedScheduler
    serving = {**cell.model["serving"], **cell.work.get("serving", {})}
    return GroupedScheduler(params, cfg, vocab,
                            max_slots=serving["max_active_connections"],
                            groups=serving["scheduler_groups"], **kwargs)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             quant: Optional[str] = None, t_start: float = 0.0):
    """One run.  Returns (RunRecord, check numbers, memory peak bytes,
    tracer or None)."""
    from perfbench import check as check_mod
    device = torch.device(device)
    serving = {**cell.model["serving"], **cell.work.get("serving", {})}
    mix = cell.mix
    seg = cell.model["audio"]["segment_length"]
    sr = cell.model["audio"]["sample_rate"]
    warm, drain = mix["warm_s"], mix.get("drain_s", 0.0)
    tr = traffic_mod.make_traffic(mix, seed, sr, seg,
                                  horizon_s=warm + seconds + drain + 1.0)
    params, cfg, kwargs, vocab = serving_setup(cell.model, serving, device,
                                               seed, tr, quant)
    sched = build_scheduler(cell, params, cfg, kwargs, vocab, device)
    run = RunRecord(cell.name, mix["loop"], cell.model,
                    sched.groups[0].max_slots, seg / sr)
    rec = Recorder()
    sample_rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed), 7]))
    tracer = None
    if trace:
        from perfbench.trace import Tracer
        tracer = Tracer()
    tw = cell.work["trace"]
    try:
        warm_path(sched, tr)
        if tracer is not None:
            tracer.warm()
        sync(device)
        rec.install(sched)
        loop = Loop(sched, tr, rec, sample_rng,
                     cell.work["check"]["sample_streams"])
        if mix["loop"] == "closed":
            p_start = _processed(sched)
            loop.closed_start()
            loop.closed_until(time.perf_counter() + warm)
            sync(device)
            run.setup_s = process_age_s() - t_start
            c0, o0 = _processed(sched), loop.offered()
            load = HostLoad()
            t0 = time.perf_counter()
            with GCWatch() as gcw:
                loop.closed_until(t0 + seconds, run, tracer,
                                  (t0 + tw["offset_s"], tw["seconds"]))
            t1 = time.perf_counter()
            run.host = load.read()
            run.gc_pauses_s = gcw.pauses
            run.window_s = t1 - t0
            run.chunks = _processed(sched) - c0
            # offered by the close and not yet harvested at the open; of
            # those, the ones still unharvested after the drain failed
            run.attempted = loop.offered() - (c0 - p_start)
            loop.closed_drain(time.perf_counter() + drain)
            run.failed = run.attempted - (_processed(sched) - c0)
        else:
            origin = time.perf_counter()
            loop.open_start(warm + seconds)
            loop.open_until(origin, warm)
            run.setup_s = process_age_s() - t_start
            load = HostLoad()
            with GCWatch() as gcw:
                loop.open_until(origin, warm + seconds + drain, tracer,
                               (warm + tw["offset_s"], tw["seconds"]))
            run.host = load.read()
            run.gc_pauses_s = gcw.pauses
            run.window_s = seconds
            skip = None
            if tracer is not None and tracer.done:
                skip = (tracer.t0 - origin, tracer.t_end - origin)
            loop.open_stats(run, warm, warm + seconds, warm + seconds + drain,
                           skip)
            run.chunks = len(run.latencies_s) - run.failed
        if tracer is not None:
            if tracer.active:
                rec.tracing = False
                tracer.stop()
            tracer.finish()
            run.trace = tracer.summary
        sync(device)
        rec.capture_beams()
        rec.fetch_tails()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        records = [r for r in rec.records if r.packs]
        weights = (params["encoder"] if cell.model["kind"] == "ctc" else
                   {k: v for k, v in params.items() if k != "en_frontend"})
    finally:
        rec.uninstall()
        sched.close()
    del sched, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_mod.check(cell.model, weights, tr, records, device,
                              cell.work["check"])
    return run, numbers, peak, tracer


def _processed(sched) -> int:
    return sched.timers.snapshot()["counters"].get("chunks_processed", 0)
