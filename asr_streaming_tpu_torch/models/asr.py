"""Streaming ASR step: waveform chunk -> CTC log-probs.

Counterpart of asr_streaming_tpu/models/asr.py: mel frontend -> streaming
Emformer -> CTC head, with per-frame argmax / max taken on the device so
the host only reads small per-chunk tensors.  The offline path runs the
same step over chunk windows framed exactly like the server's ring buffer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.emformer import (
    EmformerConfig, EmformerState,
)
from asr_streaming_tpu_torch.models.encoder import (
    EncoderConfig, encoder_stream_step, init_encoder_params,
    init_encoder_state,
)
from asr_streaming_tpu_torch.ops.frontend import (
    MelConfig, log_mel, make_mel_params,
)
from asr_streaming_tpu_torch.utils.audio import VI_AUDIO, AudioConfig


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    audio: AudioConfig = VI_AUDIO
    mel: MelConfig = dataclasses.field(default_factory=MelConfig.for_vietnamese)
    encoder: EncoderConfig = dataclasses.field(
        default_factory=EncoderConfig.vietnamese)

    @classmethod
    def vietnamese(cls, compute_dtype: torch.dtype = torch.float32
                   ) -> "ASRConfig":
        return cls(encoder=EncoderConfig.vietnamese(compute_dtype))

    @classmethod
    def tiny(cls, vocab_size: int = 21) -> "ASRConfig":
        """Small geometry for tests: same chunking, 2 layers, d_model 64."""
        emf = EmformerConfig(d_model=64, num_heads=4, ffn_dim=96,
                             num_layers=2)
        return cls(encoder=EncoderConfig(vocab_size=vocab_size,
                                         ctc_hidden_dim=48, d_model=64,
                                         emformer=emf))


# ASR_PALLAS_MODE values -> EmformerConfig.route
_MODE_ROUTES = {"stack": "stack", "layer": "layer", "off": "eager"}


def with_kernel_route(cfg: ASRConfig, mode: str = "stack",
                      quant: str = "none") -> ASRConfig:
    """Choose the Emformer's kernels (models/asr.py::with_pallas_layer).

    mode "stack" (default): kernel A, all layers in one call; "layer":
    kernel C, one call per layer; "off": the eager route.  quant "int8"
    runs the five projection/FFN products W8A8, "int8_ffn" only the FFN
    two (the stack only; the layer route honours "int8" alone, the eager
    route neither).  The environment overrides both, as operators set it
    for the JAX server: ASR_PALLAS_MODE=stack|layer|off and
    ASR_PALLAS_QUANT=none|int8|int8_ffn.  There is no backend test: the
    route is a field of the config, and a CUDA tensor always takes the
    kernel."""
    emf = emformer_route(cfg.encoder.emformer, mode, quant)
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, emformer=emf))


def emformer_route(emf: EmformerConfig, mode: str = "stack",
                   quant: str = "none") -> EmformerConfig:
    """``with_kernel_route`` on a bare EmformerConfig (the English
    transcriber's), with the same environment overrides."""
    mode = os.environ.get("ASR_PALLAS_MODE", mode)
    quant = os.environ.get("ASR_PALLAS_QUANT", quant)
    if mode not in _MODE_ROUTES:
        raise ValueError(f"mode {mode!r} not in {tuple(_MODE_ROUTES)}")
    return dataclasses.replace(emf, route=_MODE_ROUTES[mode],
                               quant="none" if mode == "off" else quant)


class StepOutput(NamedTuple):
    log_probs: torch.Tensor   # [B, U, V] f32
    argmax: torch.Tensor      # [B, U] int32 per-frame best token
    frame_max: torch.Tensor   # [B, U] f32 per-frame best log-prob
    state: EmformerState


def init_asr_params(gen: torch.Generator, cfg: ASRConfig,
                    device=None) -> dict:
    """Frontend buffers and random encoder weights on ``device`` (default
    CUDA; raises without it)."""
    device = resolve_device(device)
    return {
        "frontend": make_mel_params(cfg.mel, device),
        "encoder": init_encoder_params(gen, cfg.encoder, device),
    }


def init_asr_state(cfg: ASRConfig, batch_size: int,
                   device=None) -> EmformerState:
    return init_encoder_state(cfg.encoder, batch_size,
                              resolve_device(device))


def asr_stream_step(params: dict, cfg: ASRConfig, wave: torch.Tensor,
                    state: EmformerState, reset=None,
                    advance=None) -> StepOutput:
    """wave [B, chunk_length] f32 (carried context + new segment)."""
    feats = log_mel(params["frontend"], cfg.mel, wave)
    log_probs, new_state = encoder_stream_step(
        params["encoder"], cfg.encoder, feats, state,
        reset=reset, advance=advance)
    return StepOutput(log_probs=log_probs,
                      argmax=torch.argmax(log_probs, -1).to(torch.int32),
                      frame_max=torch.amax(log_probs, -1), state=new_state)


def frame_waveform(wave: np.ndarray, audio: AudioConfig) -> np.ndarray:
    """Frame a full waveform [T] into server-identical chunk windows
    [n_chunks, chunk_length] (buffer_length leading zeros, zero tail)."""
    seg, chunk = audio.segment_length, audio.chunk_length
    padded = np.concatenate([np.zeros(audio.buffer_length, np.float32),
                             np.asarray(wave, np.float32)])
    n_chunks = max(1, -(-(len(padded) - chunk) // seg) + 1)
    total = (n_chunks - 1) * seg + chunk
    padded = np.pad(padded, (0, max(0, total - len(padded))))
    idx = np.arange(n_chunks)[:, None] * seg + np.arange(chunk)[None, :]
    return padded[idx]


def asr_offline_logprobs(params: dict, cfg: ASRConfig,
                         chunks: torch.Tensor) -> torch.Tensor:
    """Decode pre-framed chunks [n_chunks, B, chunk_length] by running the
    streaming step over them; returns emissions [B, n_chunks * U, V]."""
    B = chunks.shape[1]
    state = init_asr_state(cfg, B, device=chunks.device)
    outs = []
    for chunk in chunks:
        out = asr_stream_step(params, cfg, chunk, state)
        state = out.state
        outs.append(out.log_probs)
    return torch.cat(outs, 1)
