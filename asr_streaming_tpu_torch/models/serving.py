"""The per-tick serving step (CTC / Vietnamese path).

Counterpart of asr_streaming_tpu/models/serving.py::serving_step.  Every
stage runs for every slot in one fixed-shape step, and the routing
decision is computed on the device:

    decode[b] = active[b] & (contain_token[b] | (gate[b] & silero[b]))

  1. mu-law (or int16) decode of the new segment, joined to the carried
     audio context (``_assemble_wave``);
  2. energy gate + Silero or its per-window energy stand-in (``_vad_stage``);
  3. log-mel -> input_linear + stride-4 reduction -> the 20-layer Emformer
     (CUDA kernel ``csrc/emformer_stack.cu``) -> CTC head + argmax;
  4. in-place append of each decoding slot's rows to its device-resident
     float16 emission buffer (CUDA kernel ``csrc/emission_append.cu``),
     then one packed ``[B, 5 + U]`` float32 result.

Encoder state advances only where decode; slots flagged ``reset`` start
from zero state.  The English transducer tick waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.asr import (
    ASRConfig, asr_stream_step, init_asr_params, init_asr_state,
)
from asr_streaming_tpu_torch.models.emformer import EmformerState
from asr_streaming_tpu_torch.models.vad import (
    SileroConfig, energy_gate, init_silero_params, silence_runs,
    silero_chunk_probs,
)
from asr_streaming_tpu_torch.ops.emission_append import emission_append


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    asr: ASRConfig = dataclasses.field(default_factory=ASRConfig)
    silero: SileroConfig = dataclasses.field(default_factory=SileroConfig)
    vad_threshold: float = 0.5
    energy_threshold_db: float = -55.0
    use_energy_gate: bool = True
    # neural VAD for the second stage; False substitutes per-window energy
    use_silero: bool = True
    # "ctc" only in this package so far ("rnnt" raises)
    model_kind: str = "ctc"
    # device-resident emission ring buffer length (frames); 1024 frames =
    # 40.96 s > the 40 s hard endpoint flush
    max_emission_frames: int = 1024
    emission_dtype: str = "float16"
    # host->device audio encoding: "int16" PCM or 8-bit "mulaw"
    upload_encoding: str = "int16"


# Host-pack layout: one [B, 5 + n] float32 array per tick.
PACK_DECODED, PACK_GATE, PACK_SILERO, PACK_LEAD, PACK_TRAIL, PACK_DATA = \
    0, 1, 2, 3, 4, 5


class ServingTickOutput(NamedTuple):
    pack: torch.Tensor              # [B, 5+n] f32 (flags, lead, trail, data)
    state: EmformerState
    emission: torch.Tensor          # [B, MAX_T, V] float16, updated in place
    ctx: torch.Tensor               # [B, buffer_length] carried audio


def _check_kind(cfg: ServingConfig) -> None:
    if cfg.model_kind != "ctc":
        raise NotImplementedError(
            f"model_kind={cfg.model_kind!r}: only the CTC serving tick is "
            "ported so far")


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def init_serving_params(seed, cfg: ServingConfig, device=None) -> dict:
    """Random weights from ``seed`` (an int or a CPU torch.Generator), on
    ``device`` (default CUDA; raises without it)."""
    _check_kind(cfg)
    dev = resolve_device(device)
    gen = _generator(seed)
    return {**init_asr_params(gen, cfg.asr, dev),
            "vad": init_silero_params(gen, cfg.silero, dev)}


def init_serving_state(cfg: ServingConfig, max_slots: int,
                       device=None) -> EmformerState:
    _check_kind(cfg)
    return init_asr_state(cfg.asr, max_slots, resolve_device(device))


def init_audio_context(cfg: ServingConfig, max_slots: int,
                       device=None) -> torch.Tensor:
    """Device-resident carried audio context [B, buffer_length]."""
    return torch.zeros((max_slots, cfg.asr.audio.buffer_length),
                       dtype=torch.float32, device=resolve_device(device))


def init_emission_buffer(cfg: ServingConfig, max_slots: int,
                         device=None) -> torch.Tensor:
    """Per-slot CTC log-prob buffer [B, MAX_T, V], native float16."""
    if cfg.emission_dtype != "float16":
        raise ValueError("the emission buffer is float16 "
                         f"(got {cfg.emission_dtype!r})")
    return torch.zeros((max_slots, cfg.max_emission_frames,
                        cfg.asr.encoder.vocab_size), dtype=torch.float16,
                       device=resolve_device(device))


def emission_width(cfg: ServingConfig) -> int:
    """Per-frame width of the emission buffer: V, the CTC vocabulary.

    The JAX package stores float16 rows as packed f32 bit-pairs (Mosaic
    has no f16 lanes) and unpacks them on the host (``_emission_packed``,
    ``_unpack_f16_rows``).  This buffer is native float16 and holds V
    columns, so neither has a counterpart here."""
    _check_kind(cfg)
    return cfg.asr.encoder.vocab_size


def make_emission_fetcher(cfg: ServingConfig):
    """fetch(buf, slot, length) -> np [length, V] float32."""
    def fetch(buf: torch.Tensor, slot: int, length: int) -> np.ndarray:
        return buf[int(slot), :int(length)].to(torch.float32).cpu().numpy()
    return fetch


MU = 255.0
_MULAW_LUT = None


def mulaw_encode_host(x: np.ndarray) -> np.ndarray:
    """float [-1,1] -> uint8 G.711-style mu-law (host side): int16
    quantize + 64K-entry lookup.  Copied from
    asr_streaming_tpu/models/serving.py::mulaw_encode_host."""
    global _MULAW_LUT
    if _MULAW_LUT is None:
        i16 = np.arange(65536, dtype=np.uint16).view(np.int16)
        v = i16.astype(np.float64) / 32767.0
        y = np.sign(v) * np.log1p(MU * np.abs(np.clip(v, -1, 1))) \
            / np.log1p(MU)
        _MULAW_LUT = np.round((y + 1.0) * 127.5).astype(np.uint8)
    scaled = np.clip(x * 32767.0, -32768, 32767)
    return _MULAW_LUT[scaled.astype(np.int16).view(np.uint16)]


def _mulaw_decode(u8: torch.Tensor) -> torch.Tensor:
    y = u8.to(torch.float32) / 127.5 - 1.0
    return torch.sign(y) * (torch.pow(1.0 + MU, torch.abs(y)) - 1.0) / MU


def _assemble_wave(cfg: ServingConfig, segment: torch.Tensor,
                   ctx: torch.Tensor, active: torch.Tensor,
                   new_stream: torch.Tensor):
    """Encoded new segment + carried context -> float chunk window, and
    the updated context (advances only for active slots)."""
    if cfg.upload_encoding == "mulaw":
        seg = _mulaw_decode(segment)
    else:
        seg = segment.to(torch.float32) / 32768.0
    ctx = torch.where(new_stream[:, None], torch.zeros_like(ctx), ctx)
    wave = torch.cat([ctx, seg], 1)
    buffer_len = ctx.shape[1]
    new_ctx = torch.where(active[:, None], seg[:, -buffer_len:], ctx)
    return wave, new_ctx


def _vad_stage(params: dict, cfg: ServingConfig, wave: torch.Tensor,
               buffer_length: int, sample_rate: int):
    new_segment = wave[:, buffer_length:]
    if cfg.use_energy_gate:
        gate = energy_gate(new_segment, sample_rate,
                           threshold_db=cfg.energy_threshold_db)
    else:
        gate = torch.ones(wave.shape[0], dtype=torch.bool, device=wave.device)
    if cfg.use_silero:
        probs = silero_chunk_probs(params["vad"], cfg.silero, wave)
        speech_windows = probs > cfg.vad_threshold
    else:
        w = cfg.silero.window
        n_win = wave.shape[1] // w
        frames = wave[:, :n_win * w].reshape(wave.shape[0], n_win, w)
        db = 10.0 * torch.log10((frames ** 2).mean(-1) + 1e-12)
        speech_windows = db > cfg.energy_threshold_db
    silero_speech = speech_windows.any(1)
    window_seconds = cfg.silero.window / cfg.silero.sample_rate
    lead, trail = silence_runs(speech_windows, window_seconds)
    return gate, silero_speech, lead, trail


def _append(emission_buf, rows, pos, decode):
    """Per-slot row append (CUDA kernel on the card, plain version on the
    CPU — ops/emission_append.py)."""
    return emission_append(emission_buf, rows, pos, decode)


def _pack(decode, gate, silero, lead, trail, data_f32):
    cols = [decode.to(torch.float32)[:, None],
            gate.to(torch.float32)[:, None],
            silero.to(torch.float32)[:, None],
            lead.to(torch.float32)[:, None],
            trail.to(torch.float32)[:, None],
            data_f32]
    return torch.cat(cols, 1)


def serving_step(params: dict, cfg: ServingConfig, segment: torch.Tensor,
                 contain_token: torch.Tensor, active: torch.Tensor,
                 new_stream: torch.Tensor, reset: torch.Tensor,
                 state: EmformerState, ctx: torch.Tensor,
                 emission_buf: torch.Tensor) -> ServingTickOutput:
    """One batched decode tick.

    segment: [B, segment_length] uint8 (mulaw) or int16 — each slot's NEW
      audio; contain_token / active / new_stream / reset: [B] bool.
    emission_buf is updated in place (and returned).
    """
    wave, new_ctx = _assemble_wave(cfg, segment, ctx, active, new_stream)
    audio_cfg = cfg.asr.audio
    gate, silero_speech, lead, trail = _vad_stage(
        params, cfg, wave, audio_cfg.buffer_length, audio_cfg.sample_rate)
    decode = active & (contain_token | (gate & silero_speech))

    out = asr_stream_step(params, cfg.asr, wave, state, reset=reset,
                          advance=decode)

    # append at each slot's PRE-step length
    U = out.log_probs.shape[1]
    pre_len = torch.where(reset, torch.zeros_like(state.length), state.length)
    pos = torch.clamp(pre_len, 0, cfg.max_emission_frames - U)
    emission_buf = _append(emission_buf, out.log_probs, pos, decode)

    pack = _pack(decode, gate, silero_speech, lead, trail,
                 out.argmax.to(torch.float32))
    return ServingTickOutput(pack=pack, state=out.state,
                             emission=emission_buf, ctx=new_ctx)


def make_serving_step(cfg: ServingConfig):
    """The step function for this config's model kind."""
    _check_kind(cfg)
    return serving_step
