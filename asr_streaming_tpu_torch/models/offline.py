"""Offline (non-streaming) encoders and auxiliary decoder heads.

Counterpart of asr_streaming_tpu/models/offline.py, the reference's
training-lineage models:

  * AcousticEncoder — Conv2d subsampling + N SqueezeformerBlocks with
    full-context masks (reference: lightspeech/modules/encoder.py:18-70)
  * LinguisticEncoder — phoneme/word two-level Squeezeformer encoder with
    duration predictor, length regulator and word->phoneme attention
    (encoder.py:150-274; TTS front half)
  * PredictorNetwork (GRU) + JointNetwork — RNN-T heads
    (modules/decoder.py:12-57)
  * WaveformDecoder — Squeezeformer + iSTFT vocoder (decoder.py:73-137)
  * TemporalPoolingDecoder — speaker-embedding head (decoder.py:140-159)

Plain PyTorch (no TPU kernel lies under them), the JAX package's
parameter trees.  The ``init_*`` functions here draw on the CPU from a
``torch.Generator`` and place the tree on ``device`` (default CUDA;
raises without it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.blocks import (
    conv_subsampling, init_squeezeformer_block_params,
    init_subsampling_params, same_pad, squeezeformer_block,
)
from asr_streaming_tpu_torch.models.emformer import (
    _layer_norm, _linear_init, _uniform,
)
from asr_streaming_tpu_torch.ops.istft import inverse_stft
from asr_streaming_tpu_torch.ops.sequence import (
    compute_statistic, length_regulator, make_padding_mask,
    word_level_pooling,
)
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


def _placed(tree, device):
    return params_from_numpy(tree, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class SqueezeformerConfig:
    d_model: int = 256
    num_layers: int = 8
    attn_num_heads: int = 4
    attn_group_size: int = 1
    attn_max_pos_encoding: int = 512
    conv_kernel_size: int = 31
    input_dim: int = 128
    subsampling_num_filters: int = 128
    subsampling_kernel_size: int = 5


def _blocks(gen, cfg, n):
    return [init_squeezeformer_block_params(
        gen, cfg.d_model, cfg.attn_num_heads, cfg.attn_group_size,
        cfg.attn_max_pos_encoding, cfg.conv_kernel_size) for _ in range(n)]


def _stack(layers, cfg, x, attn_mask, conv_mask, training):
    for layer in layers:
        x = squeezeformer_block(layer, x, attn_mask, conv_mask,
                                cfg.attn_num_heads, cfg.attn_group_size,
                                cfg.attn_max_pos_encoding, training)
    return x


def init_acoustic_encoder_params(gen: torch.Generator,
                                 cfg: SqueezeformerConfig,
                                 device=None) -> dict:
    return _placed({
        "subsampling": init_subsampling_params(
            gen, cfg.input_dim, cfg.d_model, cfg.subsampling_num_filters,
            cfg.subsampling_kernel_size),
        "layers": _blocks(gen, cfg, cfg.num_layers),
    }, device)


def _full_masks(lens: torch.Tensor, T: int):
    """attn mask [B,T,T] (True = masked) + conv mask [B,T] (True = masked),
    matching the reference mask construction (encoder.py:60-65)."""
    valid = make_padding_mask(lens, T)
    attn = valid[:, None, :] & valid[:, :, None]
    return ~attn, ~valid


def acoustic_encoder(params: dict, cfg: SqueezeformerConfig,
                     x: torch.Tensor, x_lens: torch.Tensor,
                     training: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline encoder forward (reference encoder.py:54-70)."""
    x, x_lens = conv_subsampling(params["subsampling"], x, x_lens, training)
    attn_mask, conv_mask = _full_masks(x_lens, x.shape[1])
    return _stack(params["layers"], cfg, x, attn_mask, conv_mask,
                  training), x_lens


# -------------------------------------------------------- linguistic encoder

@dataclasses.dataclass(frozen=True)
class LinguisticConfig:
    vocab_size: int = 256
    d_model: int = 256
    num_layers: int = 4
    attn_num_heads: int = 4
    attn_group_size: int = 1
    attn_max_pos_encoding: int = 512
    conv_kernel_size: int = 15


def _conv1d_init(gen, cin, cout, k):
    return {"w": _uniform(gen, (cout, cin, k), 1.0 / math.sqrt(cin * k)),
            "b": torch.zeros(cout)}


def _bn_init(dim):
    return {"scale": torch.ones((dim, 1)), "bias": torch.zeros((dim, 1)),
            "mean": torch.zeros((dim, 1)), "var": torch.ones((dim, 1))}


def init_linguistic_encoder_params(gen: torch.Generator,
                                   cfg: LinguisticConfig,
                                   device=None) -> dict:
    D, k = cfg.d_model, cfg.conv_kernel_size
    emb = torch.randn((cfg.vocab_size, D), generator=gen)
    blocks_p = _blocks(gen, cfg, cfg.num_layers)
    blocks_w = _blocks(gen, cfg, cfg.num_layers)
    wq, bq = _linear_init(gen, D, 3 * D)
    wo, bo = _linear_init(gen, D, D)
    return _placed({
        "embedding": emb,
        "phoneme_layers": blocks_p,
        "word_layers": blocks_w,
        "w2p_qkv": {"w": wq, "b": bq},
        "w2p_out": {"w": wo, "b": bo},
        "dur1": _conv1d_init(gen, D, D, k), "dur2": _conv1d_init(gen, D, D, k),
        "dur3": _conv1d_init(gen, D, 1, 3),
        "dur_bn1": _bn_init(D), "dur_bn2": _bn_init(D),
    }, device)


def _conv1d(p, x):
    """Stride-1 ``"SAME"`` conv, x [B, C, T]."""
    x = F.pad(x, same_pad(x.shape[-1], p["w"].shape[-1]))
    return F.conv1d(x, p["w"], p["b"])


def _bn1d(p, x, training):
    if training:
        mean = x.mean(dim=(0, 2), keepdim=True)[0]
        var = x.var(dim=(0, 2), keepdim=True, correction=0)[0]
    else:
        mean, var = p["mean"], p["var"]
    return ((x - mean) * torch.rsqrt(var + 1e-5)) * p["scale"] + p["bias"]


def linguistic_encoder(params: dict, cfg: LinguisticConfig,
                       token_idxs: torch.Tensor, token_lens: torch.Tensor,
                       word_idxs: torch.Tensor,
                       word_durs: Optional[torch.Tensor] = None,
                       max_out: Optional[int] = None,
                       training: bool = False):
    """Phoneme encode -> duration predict -> word pool/encode -> length
    regulate -> word->phoneme attention (reference encoder.py:209-274).

    The word count is bounded statically by Tp (>= 1 token per word):
    teacher-forced durations are padded to that bound, and the predicted
    ones are exp(log-duration) pooled per word.
    Returns (w_enc_outs, w_enc_lens, predicted_word_durs).
    """
    B, Tp = token_idxs.shape
    p_embs = params["embedding"][token_idxs.long()]
    attn_mask, conv_mask = _full_masks(token_lens, Tp)
    p_enc = _stack(params["phoneme_layers"], cfg, p_embs, attn_mask,
                   conv_mask, training)

    # duration predictor (conv-bn-relu x2 + conv head)
    d = p_enc.transpose(1, 2)
    d = F.relu(_bn1d(params["dur_bn1"], _conv1d(params["dur1"], d), training))
    d = F.relu(_bn1d(params["dur_bn2"], _conv1d(params["dur2"], d), training))
    p_durs = _conv1d(params["dur3"], d)[:, 0]              # [B, Tp] (log)
    p_durs = p_durs.masked_fill(conv_mask, 0.0)

    w_embs = word_level_pooling(p_enc, word_idxs, reduction="mean",
                                num_words=Tp)
    w_lens = word_idxs.max(dim=1).values + 1
    w_durs_pred = word_level_pooling(
        torch.exp(p_durs)[:, :, None], word_idxs, num_words=Tp)[:, :, 0]

    Tw = w_embs.shape[1]
    w_attn_mask, w_conv_mask = _full_masks(w_lens, Tw)
    w_enc = _stack(params["word_layers"], cfg, w_embs, w_attn_mask,
                   w_conv_mask, training)

    if word_durs is None:
        word_durs = torch.clamp(torch.ceil(w_durs_pred), min=10).to(
            torch.int32)
        word_durs = word_durs.masked_fill(w_conv_mask, 0)
    elif word_durs.shape[1] < Tw:
        word_durs = F.pad(word_durs, (0, Tw - word_durs.shape[1]))

    valid_w = make_padding_mask(w_lens, Tw)
    w_out, w_out_lens = length_regulator(w_enc, valid_w.to(w_enc.dtype),
                                         word_durs, max_out=max_out)

    # word->phoneme cross attention (standard multi-head attention)
    D, H = cfg.d_model, cfg.attn_num_heads
    Dh = D // H
    w, b = params["w2p_qkv"]["w"], params["w2p_qkv"]["b"]
    q = w_out @ w[:, :D] + b[:D]
    k = p_enc @ w[:, D:2 * D] + b[D:2 * D]
    v = p_enc @ w[:, 2 * D:] + b[2 * D:]

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, Dh).transpose(1, 2)

    logits = (heads(q) / math.sqrt(Dh)) @ heads(k).transpose(-1, -2)
    key_mask = make_padding_mask(token_lens, Tp)
    logits = torch.where(key_mask[:, None, None, :], logits,
                         torch.tensor(-1e9, dtype=logits.dtype,
                                      device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    out = (attn @ heads(v)).transpose(1, 2).reshape(q.shape[0], q.shape[1], D)
    out = out @ params["w2p_out"]["w"] + params["w2p_out"]["b"]
    return out, w_out_lens, w_durs_pred


# ------------------------------------------------------------- RNN-T heads

def init_predictor_params(gen: torch.Generator, num_embeddings: int,
                          embedding_dim: int, d_model: int,
                          device=None) -> dict:
    emb = torch.randn((num_embeddings, embedding_dim), generator=gen)
    wi, bi = _linear_init(gen, embedding_dim, 3 * d_model)
    wh, bh = _linear_init(gen, d_model, 3 * d_model)
    return _placed({"embedding": emb, "gru_wi": wi, "gru_bi": bi,
                    "gru_wh": wh, "gru_bh": bh,
                    "norm_scale": torch.ones(d_model),
                    "norm_bias": torch.zeros(d_model)}, device)


def gru_cell(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch.nn.GRU cell semantics."""
    gi = x @ p["gru_wi"] + p["gru_bi"]
    gh = h @ p["gru_wh"] + p["gru_bh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def predictor_network(p: dict, token_idxs: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU predictor (reference decoder.py:12-38).  token_idxs: [B, U]."""
    B, U = token_idxs.shape
    D = p["norm_scale"].shape[0]
    h = state if state is not None else torch.zeros(
        (B, D), dtype=p["gru_wh"].dtype, device=p["gru_wh"].device)
    embs = p["embedding"][token_idxs.long()]
    hs = []
    for u in range(U):
        h = gru_cell(p, embs[:, u], h)
        hs.append(h)
    out = _layer_norm(torch.stack(hs, 1), p["norm_scale"], p["norm_bias"])
    return out, h


def init_joint_params(gen: torch.Generator, input_dim: int, output_dim: int,
                      device=None) -> dict:
    w, b = _linear_init(gen, input_dim, output_dim)
    return _placed({"w": w, "b": b}, device)


def joint_network(p: dict, enc: torch.Tensor,
                  pred: torch.Tensor) -> torch.Tensor:
    """SiLU(enc[:, :, None] + pred[:, None]) @ W (reference
    decoder.py:41-57).  enc: [B, T, D]; pred: [B, U, D] -> [B, T, U, V]."""
    joint = F.silu(enc[:, :, None, :] + pred[:, None, :, :])
    return joint @ p["w"] + p["b"]


# --------------------------------------------------------- speaker head

def init_temporal_pooling_params(gen: torch.Generator, d_model: int,
                                 device=None) -> dict:
    w1, b1 = _linear_init(gen, 2 * d_model, d_model)
    w2, b2 = _linear_init(gen, d_model, d_model)
    return _placed({"w1": w1, "b1": b1, "w2": w2, "b2": b2}, device)


def temporal_pooling_decoder(p: dict, x: torch.Tensor,
                             x_lens: torch.Tensor) -> torch.Tensor:
    """Mean+std pooling -> MLP speaker embedding (reference
    decoder.py:140-159)."""
    mean, std = compute_statistic(x, x_lens)
    h = torch.cat([mean, std], dim=1)
    return F.silu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


# --------------------------------------------------------- waveform decoder

def init_waveform_decoder_params(gen: torch.Generator,
                                 cfg: SqueezeformerConfig, n_fft: int,
                                 device=None) -> dict:
    layers = _blocks(gen, cfg, cfg.num_layers)
    return _placed({"layers": layers,
                    "out_conv": _conv1d_init(gen, cfg.d_model, n_fft + 2, 3)},
                   device)


def waveform_decoder(params: dict, cfg: SqueezeformerConfig,
                     x: torch.Tensor, x_lens: torch.Tensor, n_fft: int,
                     win_length: int, hop_length: int,
                     training: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squeezeformer stack -> (log-magnitude, phase) -> iSTFT vocoder
    (reference decoder.py:73-137).  Returns (audio [B, 1, samples],
    audio_lens [B] int32)."""
    attn_mask, conv_mask = _full_masks(x_lens, x.shape[1])
    x = _stack(params["layers"], cfg, x, attn_mask, conv_mask, training)
    h = _conv1d(params["out_conv"], x.transpose(1, 2))     # [B, n_fft+2, T]
    n_bins = n_fft // 2 + 1
    mags, phases = h[:, :n_bins], h[:, n_bins:]
    spec = torch.exp(mags) * torch.complex(torch.cos(phases),
                                           torch.sin(phases))
    spec = spec.masked_fill(conv_mask[:, None, :], 0.0)

    audio = inverse_stft(spec, n_fft, win_length, hop_length)
    # the JAX package computes this in f32 (a Python float times int32)
    # and truncates: the same here, for the same integers
    ratio = torch.tensor(audio.shape[1] / x.shape[1], dtype=torch.float32)
    audio_lens = (ratio.to(x_lens.device) * x_lens.to(torch.float32)).to(
        torch.int32)
    return audio[:, None, :], audio_lens
