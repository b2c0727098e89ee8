"""The per-tick serving steps: Vietnamese CTC and English RNNT.

Counterpart of asr_streaming_tpu/models/serving.py.  Every stage runs for
every slot in one fixed-shape step, and the routing decision is computed
on the device:

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
from zero state.

The English ticks (``model_kind="rnnt"``) share stages 1 and 2, then run
the EN log-mel and the Emformer-RNNT transcriber (kernel A at M=0), and
decode on the device: ``serving_step_rnnt`` greedily (models/rnnt.py),
``serving_step_rnnt_beam`` with the device-batched beam
(models/rnnt_beam.py, whose row top-k is the CUDA kernel
``csrc/row_topk.cu``) when ``en_beam_width_device`` is set.  Both append
the transcriber encodings to a float16 ring buffer (kernel B) for the
finals' host rescorer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.asr import (
    ASRConfig, asr_stream_step, init_asr_params, init_asr_state,
)
from asr_streaming_tpu_torch.models.emformer import (
    EmformerState, init_emformer_state,
)
from asr_streaming_tpu_torch.models.rnnt import (
    PredictorState, RNNTConfig, RNNTStreamState, _hold_encoder, init_rnnt_params,
    init_rnnt_state, rnnt_greedy_stream_step, transcriber_step,
)
from asr_streaming_tpu_torch.models.rnnt_beam import (
    BeamState, init_beam_state, rnnt_beam_chunk_step,
)
from asr_streaming_tpu_torch.models.vad import (
    SileroConfig, energy_gate, init_silero_params, silence_runs,
    silero_chunk_probs,
)
from asr_streaming_tpu_torch.ops.emission_append import emission_append
from asr_streaming_tpu_torch.ops.frontend import (
    MelConfig, load_global_stats, log_mel, make_mel_params,
)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    asr: ASRConfig = dataclasses.field(default_factory=ASRConfig)
    silero: SileroConfig = dataclasses.field(default_factory=SileroConfig)
    vad_threshold: float = 0.5
    energy_threshold_db: float = -55.0
    use_energy_gate: bool = True
    # neural VAD for the second stage; False substitutes per-window energy
    use_silero: bool = True
    # "ctc" (the Vietnamese path) or "rnnt" (the English Emformer-RNNT)
    model_kind: str = "ctc"
    rnnt: Optional[RNNTConfig] = None
    # device-resident emission ring buffer length (frames); 1024 frames =
    # 40.96 s > the 40 s hard endpoint flush
    max_emission_frames: int = 1024
    emission_dtype: str = "float16"
    # host->device audio encoding: "int16" PCM or 8-bit "mulaw"
    upload_encoding: str = "int16"
    # path of the EN pipeline's global-stats JSON ({mean, invstddev}): when
    # set, the en_frontend params carry them and the featurizer applies
    # (x - mean) * invstddev after the piecewise-linear log
    en_global_stats: Optional[str] = None
    # device-batched per-chunk RNNT beam (models/rnnt_beam.py): the beam
    # width, or None for greedy partials + beam-rescored finals.  When set
    # the pack carries the best hypothesis's token buffer.
    en_beam_width_device: Optional[int] = None
    # per-segment token-buffer capacity of the device beam; overflow drops
    # tokens at the buffer's tail
    en_beam_cap: int = 256


# Host-pack layout: one [B, 5 + n] float32 array per tick.
PACK_DECODED, PACK_GATE, PACK_SILERO, PACK_LEAD, PACK_TRAIL, PACK_DATA = \
    0, 1, 2, 3, 4, 5


class BeamServingState(NamedTuple):
    """EN beam-partials device state: the encoder's stream state and the
    carried B x W hypothesis beam (the greedy path's predictor and
    last_token live inside the beam's hypotheses instead)."""
    encoder: EmformerState
    beam: BeamState


ServingState = Union[EmformerState, RNNTStreamState, BeamServingState]


class ServingTickOutput(NamedTuple):
    pack: torch.Tensor              # [B, 5+n] f32 (flags, lead, trail, data)
    state: ServingState
    # [B, MAX_T, V or E] float16, updated in place (None: no buffer given)
    emission: Optional[torch.Tensor]
    ctx: torch.Tensor               # [B, buffer_length] carried audio


def _check_kind(cfg: ServingConfig) -> None:
    if cfg.model_kind not in ("ctc", "rnnt"):
        raise ValueError(f"model_kind={cfg.model_kind!r}")
    if cfg.model_kind == "rnnt" and cfg.rnnt is None:
        raise ValueError("model_kind='rnnt' needs ServingConfig.rnnt")


def _en_mel(cfg: ServingConfig) -> MelConfig:
    """The EN featurizer's geometry (n_mels follows a tiny test model)."""
    mel = MelConfig.for_english()
    if cfg.rnnt.n_mels != mel.n_mels:
        mel = dataclasses.replace(mel, n_mels=cfg.rnnt.n_mels)
    return mel


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
    if cfg.model_kind == "rnnt":
        en_frontend = make_mel_params(_en_mel(cfg), dev)
        if cfg.en_global_stats:
            en_frontend["mean"], en_frontend["invstddev"] = \
                load_global_stats(cfg.en_global_stats, dev)
        return {**init_rnnt_params(gen, cfg.rnnt, dev),
                "en_frontend": en_frontend,
                "vad": init_silero_params(gen, cfg.silero, dev)}
    return {**init_asr_params(gen, cfg.asr, dev),
            "vad": init_silero_params(gen, cfg.silero, dev)}


def init_serving_state(cfg: ServingConfig, max_slots: int,
                       device=None) -> ServingState:
    _check_kind(cfg)
    dev = resolve_device(device)
    if cfg.model_kind == "rnnt":
        if cfg.en_beam_width_device:
            return BeamServingState(
                encoder=init_emformer_state(cfg.rnnt.emformer, max_slots, dev),
                beam=init_beam_state(cfg.rnnt, max_slots,
                                     cfg.en_beam_width_device,
                                     cap=cfg.en_beam_cap, device=dev))
        return init_rnnt_state(cfg.rnnt, max_slots, dev)
    return init_asr_state(cfg.asr, max_slots, dev)


def init_audio_context(cfg: ServingConfig, max_slots: int,
                       device=None) -> torch.Tensor:
    """Device-resident carried audio context [B, buffer_length]."""
    return torch.zeros((max_slots, cfg.asr.audio.buffer_length),
                       dtype=torch.float32, device=resolve_device(device))


def init_emission_buffer(cfg: ServingConfig, max_slots: int,
                         device=None) -> torch.Tensor:
    """Per-slot device-resident buffer, native float16: CTC log-probs
    [B, MAX_T, V] (CTC) or transcriber encodings [B, MAX_T, E] (RNNT, read
    by the host beam rescorer at finals)."""
    if cfg.emission_dtype != "float16":
        raise ValueError("the emission buffer is float16 "
                         f"(got {cfg.emission_dtype!r})")
    return torch.zeros((max_slots, cfg.max_emission_frames,
                        emission_width(cfg)), dtype=torch.float16,
                       device=resolve_device(device))


def emission_width(cfg: ServingConfig) -> int:
    """Per-frame width of the emission buffer: V, the CTC vocabulary, or
    E, the RNNT encoding dim.

    The JAX package stores float16 rows as packed f32 bit-pairs (Mosaic
    has no f16 lanes) and unpacks them on the host (``_emission_packed``,
    ``_unpack_f16_rows``).  This buffer is native float16 and holds V
    columns, so neither has a counterpart here."""
    _check_kind(cfg)
    return (cfg.rnnt.encoding_dim if cfg.model_kind == "rnnt"
            else cfg.asr.encoder.vocab_size)


def slot_rows(buf, slot: int):
    """(tensor, row) holding ``slot`` of a per-slot device buffer: the
    buffer itself, or with a mesh (a list of the shards' blocks, in slot
    order) the block of the shard that owns it."""
    if isinstance(buf, list):
        shard, row = divmod(int(slot), buf[0].shape[0])
        return buf[shard], row
    return buf, int(slot)


def make_emission_fetcher(cfg: ServingConfig):
    """fetch(buf, slot, length) -> np [length, V] float32."""
    def fetch(buf, slot: int, length: int) -> np.ndarray:
        buf, row = slot_rows(buf, slot)
        return buf[row, :int(length)].to(torch.float32).cpu().numpy()
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


def _reset_encoder(reset: torch.Tensor, state: EmformerState
                   ) -> EmformerState:
    """Zero state where reset (the RNNT ticks reset outside the step)."""
    m4 = reset.view(1, -1, 1, 1)
    return EmformerState(
        mem=torch.where(m4, torch.zeros_like(state.mem), state.mem),
        lc_k=torch.where(m4, torch.zeros_like(state.lc_k), state.lc_k),
        lc_v=torch.where(m4, torch.zeros_like(state.lc_v), state.lc_v),
        length=torch.where(reset, torch.zeros_like(state.length),
                           state.length))


def _rnnt_feats(params: dict, cfg: ServingConfig,
                wave: torch.Tensor) -> torch.Tensor:
    """EN log-mel of the chunk window, trimmed to (segment + rc) * 4
    frames so it reduces to segment + rc (center=True yields one more)."""
    fe = params["en_frontend"]
    feats = log_mel(fe, _en_mel(cfg), wave, mean=fe.get("mean"),
                    invstddev=fe.get("invstddev"))
    em = cfg.rnnt.emformer
    return feats[:, :(em.segment_length + em.right_context_length) * 4]


def _append_encodings(emission_buf, enc, pre_length, decode):
    """Append the chunk's encodings at each slot's PRE-step length, clipped
    to the last whole segment of the buffer."""
    U = enc.shape[1]
    max_t = emission_buf.shape[1]
    pos = torch.clamp(pre_length, 0, max_t - max_t % U - U)
    return _append(emission_buf, enc, pos, decode)


def serving_step_rnnt(params: dict, cfg: ServingConfig,
                      segment: torch.Tensor, contain_token: torch.Tensor,
                      active: torch.Tensor, new_stream: torch.Tensor,
                      reset: torch.Tensor, state: RNNTStreamState,
                      ctx: torch.Tensor,
                      emission_buf: Optional[torch.Tensor] = None
                      ) -> ServingTickOutput:
    """English tick, greedy partials: VAD + batched greedy RNNT decode on
    the device (the host beam rescoring the finals).  The pack's data
    columns are the chunk's [segment * max_symbols] tokens (blank = none).
    """
    wave, new_ctx = _assemble_wave(cfg, segment, ctx, active, new_stream)
    rnnt = cfg.rnnt
    zero = init_rnnt_state(rnnt, wave.shape[0], wave.device)
    r3 = reset.view(1, -1, 1)
    state = RNNTStreamState(
        encoder=_reset_encoder(reset, state.encoder),
        predictor=PredictorState(
            h=torch.where(r3, zero.predictor.h, state.predictor.h),
            c=torch.where(r3, zero.predictor.c, state.predictor.c)),
        last_token=torch.where(reset, zero.last_token, state.last_token))

    audio_cfg = cfg.asr.audio
    gate, silero_speech, lead, trail = _vad_stage(
        params, cfg, wave, audio_cfg.buffer_length, audio_cfg.sample_rate)
    decode = active & (contain_token | (gate & silero_speech))

    out = rnnt_greedy_stream_step(params, rnnt, _rnnt_feats(params, cfg, wave),
                                  state, active=decode)
    if emission_buf is not None:
        emission_buf = _append_encodings(emission_buf, out.encodings,
                                         state.encoder.length, decode)
    pack = _pack(decode, gate, silero_speech, lead, trail,
                 out.tokens.to(torch.float32))
    return ServingTickOutput(pack=pack, state=out.state,
                             emission=emission_buf, ctx=new_ctx)


def serving_step_rnnt_beam(params: dict, cfg: ServingConfig,
                           segment: torch.Tensor,
                           contain_token: torch.Tensor, active: torch.Tensor,
                           new_stream: torch.Tensor, reset: torch.Tensor,
                           state: BeamServingState, ctx: torch.Tensor,
                           emission_buf: Optional[torch.Tensor] = None
                           ) -> ServingTickOutput:
    """English tick, beam partials: VAD + transcriber + the device-batched
    beam on every chunk with carried hypotheses.  The pack's data columns
    carry the best hypothesis per stream: [n_tokens, token_0 ..
    token_{CAP-1}] (f32 holds token ids <= 4096 exactly).
    """
    wave, new_ctx = _assemble_wave(cfg, segment, ctx, active, new_stream)
    rnnt = cfg.rnnt
    enc_state = _reset_encoder(reset, state.encoder)

    audio_cfg = cfg.asr.audio
    gate, silero_speech, lead, trail = _vad_stage(
        params, cfg, wave, audio_cfg.buffer_length, audio_cfg.sample_rate)
    decode = active & (contain_token | (gate & silero_speech))

    enc, stepped = transcriber_step(params, rnnt,
                                    _rnnt_feats(params, cfg, wave), enc_state)
    new_enc_state = _hold_encoder(decode, stepped, enc_state)

    beam_state, best_toks, best_len = rnnt_beam_chunk_step(
        params, rnnt, enc.to(torch.float32), state.beam, active=decode,
        reset=reset)

    if emission_buf is not None:
        emission_buf = _append_encodings(emission_buf, enc, enc_state.length,
                                         decode)
    data = torch.cat([best_len[:, None].to(torch.float32),
                      best_toks.to(torch.float32)], 1)
    pack = _pack(decode, gate, silero_speech, lead, trail, data)
    return ServingTickOutput(
        pack=pack,
        state=BeamServingState(encoder=new_enc_state, beam=beam_state),
        emission=emission_buf, ctx=new_ctx)


def make_serving_step(cfg: ServingConfig):
    """The step function for this config's model kind."""
    _check_kind(cfg)
    if cfg.model_kind == "rnnt":
        if cfg.en_beam_width_device:
            return serving_step_rnnt_beam
        return serving_step_rnnt
    return serving_step
