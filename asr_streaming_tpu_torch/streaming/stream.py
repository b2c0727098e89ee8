"""Per-stream decode state machine.

Copied from asr_streaming_tpu/streaming/stream.py, pointed at this
package's greedy, endpoint and audio modules.

Host-side pure logic mirroring the reference's ``Stream``
(reference: streaming_decoder/stream.py:10-188) and the per-chunk counter
updates the server performs inline (streaming_server.py:371-470):

  * ring-buffered audio with buffer_length of leading zeros; one decode
    step consumes chunk_length samples and advances by segment_length,
  * emission-frame offset arithmetic for word timestamps (offset starts
    at -(context//framerate+1); first decoded chunk rebases it; silence
    chunks advance it by segment_size/bias when emission exists),
  * trailing-silence / utterance-length counters feeding endpointing,
  * segment lifecycle (snapshot transcript, reset, advance segment idx).

The device work (VAD, encoder, CTC) happens elsewhere; this object only
consumes their results, so it stays trivially testable.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from asr_streaming_tpu_torch.decode.greedy import StreamingGreedyDecoder
from asr_streaming_tpu_torch.streaming.endpoint import (
    EndpointRule, NgramEndpointCost, detect_endpointing, VI_DEFAULT_RULES,
)
from asr_streaming_tpu_torch.utils.audio import AudioConfig


@dataclasses.dataclass
class FinalSegment:
    """Everything the final-rescore stage needs for one endpointed segment."""
    emission: np.ndarray        # [T, V] accumulated CTC log-probs
    length: int                 # valid emission frames
    offset: int                 # emission-frame offset for timestamps
    transcript_greedy: str      # greedy transcript snapshot
    segment_index: int
    utterance_seconds: float    # decoded utterance length (endpoint arg)
    trailing_silence: float


class Stream:
    def __init__(self, audio: AudioConfig, vocab: Sequence[str],
                 language: str = "vi",
                 rules: Optional[dict] = None,
                 ngram_cost: Optional[NgramEndpointCost] = None,
                 stream_id: str = "",
                 keep_audio_total: bool = True,
                 keep_emission: bool = True,
                 rulesets: Optional[dict] = None,
                 mapping_rule: Optional[dict] = None):
        self.audio = audio
        self.language = language
        self.rules = rules if rules is not None else VI_DEFAULT_RULES
        # Multi-LM registry (reference stream.py:32,61,139): sw_model
        # names the stream's rescorer; mapping_rule maps it to one of the
        # named endpoint rulesets.  Unmapped / unknown names fall back to
        # self.rules (the DEFAULT set).
        self.sw_model = "GENERAL"
        self.rulesets = rulesets or {}
        self.mapping_rule = mapping_rule or {}
        self.ngram_cost = ngram_cost or NgramEndpointCost()
        self.id = stream_id
        self.keep_audio_total = keep_audio_total
        self.keep_emission = keep_emission

        # ring buffer starts with buffer_length zeros (reference stream.py:23)
        # Guarded by _buffer_lock: the server appends from the event loop
        # while the scheduler's tick thread pops — both are
        # read-modify-write on self.buffer (the reference is purely
        # single-threaded asyncio and has no such race; SURVEY.md §5 flags
        # its fragile shared-state invariants, so ours are locked+tested).
        self._buffer_lock = threading.Lock()
        self.buffer = np.zeros(audio.buffer_length, dtype=np.float32)
        self.audio_total: List[np.ndarray] = []
        self.offset_compute_stats = 0.0

        self.greedy = StreamingGreedyDecoder(
            vocab, frame_seconds=audio.emission_frame_seconds)
        self._emission_chunks: List[np.ndarray] = []
        self.emission_length = 0

        # counters (reference stream.py:26-49)
        self.chunk_processed = 0
        self.chunk_processed_total = 0
        self.trailing_blank_duration = 0.0
        self.offset = audio.initial_offset
        self.transcript_internal = ""
        self.transcript = ""
        self.is_contain_token = False
        self.segment = 0
        self.segment_start = 0.0
        self.segment_end = 0.0
        self.is_eos = False

    # ------------------------------------------------------------------ audio

    def accept_waveform(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, dtype=np.float32)
        if samples.size <= 100:  # reference stream.py:82 drops tiny packets
            return
        with self._buffer_lock:
            self.buffer = np.concatenate([self.buffer, samples])
            if self.keep_audio_total:
                self.audio_total.append(samples)

    def add_tail_padding(self) -> None:
        """Zero-pad so the final partial segment can be flushed
        (reference stream.py:96-107)."""
        with self._buffer_lock:
            n = self.audio.chunk_length - self.buffer.size
            if n > 0:
                self.buffer = np.concatenate(
                    [self.buffer, np.zeros(n, dtype=np.float32)])

    def has_chunk(self) -> bool:
        return self.buffer.size >= self.audio.chunk_length

    def chunk(self) -> np.ndarray:
        return self.buffer[:self.audio.chunk_length]

    def new_segment_audio(self) -> np.ndarray:
        """The new-audio part of the current chunk (what first-stage VAD
        inspects, reference stream.py:167)."""
        return self.buffer[self.audio.buffer_length:self.audio.chunk_length]

    def pop_chunk(self) -> np.ndarray:
        """Take the current chunk's new-segment audio and slide the window
        (used by the pipelined scheduler, which gathers audio before the
        previous batch's results have been scattered)."""
        with self._buffer_lock:
            seg = self.new_segment_audio().copy()
            self.buffer = self.buffer[self.audio.segment_length:]
        return seg

    def pop_chunk_view(self) -> np.ndarray:
        """Zero-copy :meth:`pop_chunk` for the fused native gather+encode
        path: returns a VIEW of the new-segment audio and slides the
        window.  Safe against concurrent ``accept_waveform`` because
        appends build a NEW array (np.concatenate) rather than writing
        in place — the returned view keeps the old backing array alive
        and immutable-in-practice until the caller drops it."""
        with self._buffer_lock:
            seg = self.new_segment_audio()
            self.buffer = self.buffer[self.audio.segment_length:]
        return seg

    def _advance_window(self) -> None:
        with self._buffer_lock:
            self.buffer = self.buffer[self.audio.segment_length:]

    # ------------------------------------------------------------ chunk paths

    def skip_silence(self) -> None:
        """VAD declared the chunk silent; bookkeeping only
        (reference stream.py:181-187 / streaming_server.py:406-411)."""
        self.trailing_blank_duration += self.audio.segment_seconds
        self.chunk_processed += 1
        self.chunk_processed_total += 1
        # offset drives vi word-alignment timestamps (reference
        # stream.py:186-187); EN geometry has bias=0 and no alignments
        if self.emission_length != 0 and self.audio.bias > 0:
            self.offset += self.audio.segment_size // self.audio.bias

    def apply_decode(self, argmax: np.ndarray,
                     log_probs: Optional[np.ndarray] = None) -> str:
        """Consume one decoded chunk's per-frame argmax (and optionally the
        log-probs for later rescoring); replicates update_stream
        (reference stream.py:110-125)."""
        if self.keep_emission and log_probs is not None:
            self._emission_chunks.append(np.asarray(log_probs))
        n_frames = len(np.asarray(argmax).reshape(-1))
        self.emission_length += n_frames

        text, last_blank = self.greedy.update(argmax)

        if self.emission_length == self.audio.emission_frames_per_chunk:
            # first decoded chunk: rebase offset (reference stream.py:111-113)
            self.offset = (self.chunk_processed_total
                           * self.audio.segment_size // self.audio.bias
                           ) + self.audio.initial_offset
        if self.language == "vi":
            self.transcript_internal = text
        else:
            self.transcript_internal += text
        self.chunk_processed += 1
        self.chunk_processed_total += 1

        if text:
            self.trailing_blank_duration = last_blank
            self.is_contain_token = True
        else:
            self.trailing_blank_duration += self.audio.segment_seconds
        return text

    def apply_decode_en(self, text_delta: str, trail_silence: float,
                        lead_silence: float = 0.0,
                        enc_frames: int = 0,
                        full_text: Optional[str] = None) -> str:
        """EN/RNNT chunk outcome: incremental transcript deltas + Silero
        timing (reference streaming_server.py:444-455 + stream.py:114-125).
        enc_frames counts device-buffered transcriber encodings (for the
        host beam rescore at finals).  full_text (beam-partials mode)
        REPLACES the running transcript — the carried-hypothesis beam may
        revise earlier tokens, so the authoritative text is the best
        hypothesis's full decode, not an append."""
        if text_delta.strip() and not self.transcript_internal:
            self.segment_start = lead_silence
        self.emission_length += enc_frames
        if full_text is not None:
            self.transcript_internal = full_text
        else:
            self.transcript_internal += text_delta
        self.chunk_processed += 1
        self.chunk_processed_total += 1
        if text_delta:
            self.trailing_blank_duration = trail_silence
            self.is_contain_token = True
        else:
            self.trailing_blank_duration += self.audio.segment_seconds
        return text_delta

    def check_endpoint(self, advance: bool = True) -> Tuple[bool, float]:
        """Endpoint rules + window advance (reference stream.py:127-163).

        Pass advance=False when the window was already slid by
        ``pop_chunk`` (pipelined scheduler).
        Returns (is_final, utterance_seconds)."""
        utterance_seconds = (self.chunk_processed
                             * self.audio.segment_length
                             / self.audio.sample_rate)
        relative_cost = self.ngram_cost.relative_cost(self.transcript_internal)
        self.trailing_blank_duration = round(self.trailing_blank_duration, 2)
        # per-model ruleset (reference stream.py:139: EndpointingRule[
        # mapping_endpointing_rule[sw_model]]); DEFAULT rules otherwise
        rules = self.rulesets.get(
            self.mapping_rule.get(self.sw_model), self.rules) \
            if self.rulesets else self.rules
        detected, _rule = detect_endpointing(
            rules, utterance_seconds, self.trailing_blank_duration,
            relative_cost)
        if detected:
            self.segment_end = self.trailing_blank_duration
            self.transcript = self.transcript_internal
            self.chunk_processed = 0
            self.is_contain_token = False
            self.trailing_blank_duration = 0.0
            self.segment += 1
            self.transcript_internal = ""
        if advance:
            self._advance_window()
        return detected, utterance_seconds

    # -------------------------------------------------------------- segments

    def take_final_segment(self, utterance_seconds: float) -> FinalSegment:
        """Snapshot + clear the accumulated emission for final rescoring
        (reference streaming_server.py:511-515)."""
        if self._emission_chunks:
            emission = np.concatenate(self._emission_chunks, axis=0)
        else:
            emission = np.zeros((0, len(self.greedy.vocab)), np.float32)
        seg = FinalSegment(
            emission=emission,
            length=self.emission_length,
            offset=self.offset,
            transcript_greedy=self.transcript,
            segment_index=self.segment,
            utterance_seconds=utterance_seconds,
            trailing_silence=self.segment_end,
        )
        self._emission_chunks = []
        self.emission_length = 0
        self.greedy.reset()
        return seg

    def discard_decoded_segment(self, segment_seconds: float) -> np.ndarray:
        """Trim audio_total past the decoded segment; returns the trimmed
        segment audio (reference stream.py:89-94)."""
        if not self.keep_audio_total:
            self.offset_compute_stats += segment_seconds
            return np.zeros(0, np.float32)
        with self._buffer_lock:
            total = (np.concatenate(self.audio_total) if self.audio_total
                     else np.zeros(0, np.float32))
            n = int(segment_seconds * self.audio.sample_rate)
            segment, rest = total[:n], total[n:]
            self.audio_total = [rest] if rest.size else []
        self.offset_compute_stats += segment_seconds
        return segment

    @property
    def total_audio(self) -> np.ndarray:
        with self._buffer_lock:
            return (np.concatenate(self.audio_total) if self.audio_total
                    else np.zeros(0, np.float32))

    @property
    def total_seconds_decoded(self) -> float:
        return (self.chunk_processed_total * self.audio.segment_length
                / self.audio.sample_rate)
