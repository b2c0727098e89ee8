"""Device-side VAD: Silero-v5-shaped neural VAD + energy first-stage gate.

Counterpart of asr_streaming_tpu/models/vad.py: 512-sample windows at
16 kHz with 64 samples of carried context, STFT-magnitude frontend ->
4-block conv encoder -> LSTM cell -> sigmoid head, state reset per chunk;
plus the energy gate over 30 ms frames and the leading/trailing silence
runs; and ``silero_params_from_onnx``, the name map from a
silero_vad.onnx file's initializers (tools/onnx_weights.py) to these params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SileroConfig:
    """Silero-v5 16 kHz graph geometry."""
    sample_rate: int = 16000
    window: int = 512            # samples per decision window
    context: int = 64            # carried samples prepended to each window
    n_fft: int = 256
    hop: int = 128
    encoder_channels: tuple = (128, 64, 64, 128)
    encoder_strides: tuple = (1, 2, 2, 1)
    lstm_hidden: int = 128
    threshold: float = 0.5
    stft_pad_left: int = 64
    stft_pad_right: int = 0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def encoder_dim(self) -> int:
        return self.encoder_channels[-1]


def init_silero_params(gen: torch.Generator,
                       cfg: SileroConfig = SileroConfig(),
                       device=None) -> dict:
    """Random parameters in the v5 graph's shapes (fixed STFT basis), on
    ``device`` (default CUDA; raises without it)."""
    device = resolve_device(device)
    Fq, H = cfg.n_freqs, cfg.lstm_hidden

    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * b

    n = np.arange(cfg.n_fft)
    k_ = np.arange(cfg.n_freqs)
    angle = 2 * np.pi * np.outer(k_, n) / cfg.n_fft
    win = 0.5 * (1 - np.cos(2 * np.pi * n / cfg.n_fft))
    basis = np.concatenate([np.cos(angle) * win, -np.sin(angle) * win])
    params = {
        "stft_basis": torch.tensor(basis[:, None, :], dtype=torch.float32),
        "lstm_wi": u((cfg.encoder_dim, 4 * H), cfg.encoder_dim),
        "lstm_wh": u((H, 4 * H), H),
        "lstm_b": torch.zeros(4 * H),
        "out_w": u((H, 1), H), "out_b": torch.zeros(1),
    }
    in_ch = Fq
    for i, out_ch in enumerate(cfg.encoder_channels):
        params[f"conv{i}_w"] = u((out_ch, in_ch, 3), in_ch * 3)
        params[f"conv{i}_b"] = torch.zeros(out_ch)
        in_ch = out_ch
    return {k: v.to(device) for k, v in params.items()}


def silero_params_from_onnx(initializers: dict,
                            cfg: SileroConfig = SileroConfig()) -> dict:
    """Name-map silero_vad.onnx (v5) initializers onto the VAD's params,
    as a tree of float32 numpy arrays (``overlay_params`` puts them on the
    device).  The names are those of the JAX package's loader
    (models/vad.py::silero_params_from_onnx):

      _model.stft.forward_basis_buffer            [258, 1, 256]
      _model.encoder.{i}.reparam_conv.weight/bias i=0..3
      _model.decoder.rnn.weight_ih / weight_hh    [512, 128]
      _model.decoder.rnn.bias_ih / bias_hh        [512]
      _model.decoder.decoder.2.weight / bias      [1, 128, 1] / [1]

    The LSTM weights are transposed to ``[in, 4H]`` (gate order i, f, g,
    o, as torch keeps them) and the two biases summed."""
    g = initializers

    def pick(*names):
        for n in names:
            if n in g:
                return np.asarray(g[n], np.float32)
        raise KeyError(f"none of {names} in ONNX initializers "
                       f"(have: {sorted(g)[:8]}...)")

    basis = pick("_model.stft.forward_basis_buffer")
    if basis.ndim == 2:
        basis = basis[:, None, :]
    if basis.shape != (2 * cfg.n_freqs, 1, cfg.n_fft):
        raise ValueError(f"STFT basis shape {basis.shape}")
    params = {"stft_basis": basis}
    for i, out_ch in enumerate(cfg.encoder_channels):
        w = pick(f"_model.encoder.{i}.reparam_conv.weight")
        if w.shape[0] != out_ch:
            raise ValueError(f"encoder {i} weight shape {w.shape}")
        params[f"conv{i}_w"] = w
        params[f"conv{i}_b"] = pick(f"_model.encoder.{i}.reparam_conv.bias")
    params["lstm_wi"] = np.ascontiguousarray(
        pick("_model.decoder.rnn.weight_ih").T)            # [E, 4H]
    params["lstm_wh"] = np.ascontiguousarray(
        pick("_model.decoder.rnn.weight_hh").T)            # [H, 4H]
    params["lstm_b"] = (pick("_model.decoder.rnn.bias_ih")
                        + pick("_model.decoder.rnn.bias_hh"))
    head_w = pick("_model.decoder.decoder.2.weight")       # [1, H, 1]
    params["out_w"] = np.ascontiguousarray(head_w.reshape(1, -1).T)
    params["out_b"] = pick("_model.decoder.decoder.2.bias")
    return params


def load_vad_weights(path: str, cfg) -> dict:
    """Trained Silero weights as a host tree: an ``.npz`` with a ``vad``
    subtree (tools/onnx_weights.py writes one) or a raw silero_vad.onnx,
    converted on the fly.  ``cfg`` is the ServingConfig."""
    if path.endswith(".onnx"):
        from asr_streaming_tpu_torch.tools.onnx_weights import (
            load_onnx_initializers,
        )
        return silero_params_from_onnx(load_onnx_initializers(path),
                                       cfg.silero)
    from asr_streaming_tpu_torch.utils.checkpoint import load_params
    return load_params(path)["vad"]


def _window_features(params: dict, cfg: SileroConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """x [B, context + window] -> [B, encoder_dim]."""
    if cfg.stft_pad_left or cfg.stft_pad_right:
        x = F.pad(x[:, None], (cfg.stft_pad_left, cfg.stft_pad_right),
                  mode="reflect")[:, 0]
    spec = F.conv1d(x[:, None, :], params["stft_basis"], stride=cfg.hop)
    Fq = cfg.n_freqs
    h = torch.sqrt(spec[:, :Fq] ** 2 + spec[:, Fq:2 * Fq] ** 2 + 1e-12)
    for i, stride in enumerate(cfg.encoder_strides):
        h = F.conv1d(h, params[f"conv{i}_w"], stride=stride, padding=1) \
            + params[f"conv{i}_b"][:, None]
        h = F.relu(h)
    return h.mean(-1)


def silero_chunk_probs(params: dict, cfg: SileroConfig,
                       wave: torch.Tensor) -> torch.Tensor:
    """Per-window speech probabilities, state reset at chunk start.
    wave [B, T] -> [B, ceil(T / window)]."""
    B, T = wave.shape
    n_win = -(-T // cfg.window)
    pad = n_win * cfg.window - T
    wave = F.pad(wave, (cfg.context, pad))
    # windows with leading context: [n_win, B, context + window]
    windows = wave.unfold(1, cfg.context + cfg.window,
                          cfg.window).transpose(0, 1)
    feats = _window_features(
        params, cfg, windows.reshape(n_win * B, -1)).reshape(n_win, B, -1)
    h = torch.zeros((B, cfg.lstm_hidden), dtype=torch.float32,
                    device=wave.device)
    c = torch.zeros_like(h)
    probs = []
    for f in feats:                  # only the LSTM cell is sequential
        gates = (f @ params["lstm_wi"] + h @ params["lstm_wh"]
                 + params["lstm_b"])
        i, fg, g, o = torch.chunk(gates, 4, dim=-1)   # torch LSTM gate order
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        probs.append(torch.sigmoid(F.relu(h) @ params["out_w"]
                                   + params["out_b"])[:, 0])
    return torch.stack(probs, 1)


def silence_runs(speech: torch.Tensor, window_seconds: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leading/trailing silent-window runs in seconds, per stream.
    speech: [B, n_win] bool."""
    not_speech = (~speech).to(torch.int32)
    lead = torch.cumprod(not_speech, 1).sum(1)
    trail = torch.cumprod(not_speech.flip(1), 1).sum(1)
    w = torch.tensor(window_seconds, dtype=torch.float32, device=speech.device)
    return lead.to(torch.float32) * w, trail.to(torch.float32) * w


def energy_gate(wave: torch.Tensor, sample_rate: int = 16000,
                frame_seconds: float = 0.03,
                threshold_db: float = -55.0) -> torch.Tensor:
    """Any 30 ms frame above an absolute dBFS floor.  [B, T] -> [B] bool."""
    frame = int(frame_seconds * sample_rate)
    n = (wave.shape[1] // frame) * frame
    frames = wave[:, :n].reshape(wave.shape[0], -1, frame)
    power = (frames ** 2).mean(-1)
    db = 10.0 * torch.log10(power + 1e-12)
    return (db > threshold_db).any(1)
