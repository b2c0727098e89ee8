"""Squeezeformer building blocks (offline/training lineage).

Counterpart of asr_streaming_tpu/models/blocks.py (the reference's
streaming_decoder/lightspeech/layers/):

  * ScaleBiasNorm                         (normalization.py:9-20)
  * grouped rel-pos multi-head attention  (attention.py:64-254)
    with relative sinusoidal encodings    (attention.py:6-62)
    and the rel->abs indexing trick       (attention.py:216-254)
  * FeedForward / Attention / Convolution blocks and the post-LN
    SqueezeformerBlock                    (block.py:9-171)
  * Conv2d subsampling (x4)               (sampling.py:10-76)
  * Adaptive / MixStyle norms             (normalization.py:23-78)

Params are plain dicts of tensors in the JAX package's tree (weights
``[in, out]``, convolutions OIW / OIHW), so ``params_from_numpy`` carries
a JAX tree over.  The relative-position table ``pe`` and the BatchNorm
running statistics (``bn_mean``/``bn_var``) are leaves of that tree:
they are read from it, never rebuilt.  BatchNorm takes the batch's
statistics with ``training=True`` (population variance, as ``jnp.var``),
else the carried ones.  No TPU kernel lies under these blocks: they are
plain PyTorch.  The ``init_*`` functions draw on the CPU from a
``torch.Generator`` (the JAX package's distributions; the values differ
from ``jax.random``'s); the model-level inits (models/offline.py) place
the tree on a device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch.models.emformer import (
    _layer_norm, _linear_init, _uniform,
)
from asr_streaming_tpu_torch.ops.sequence import (
    compute_statistic, make_padding_mask,
)


# ------------------------------------------------------------------ helpers

def scale_bias_norm(x, scale, bias):
    return x * scale + bias


def same_pad(n: int, k: int, stride: int = 1) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (left, right) for
    size n, kernel k and stride s, total max((ceil(n/s)-1)*s + k - n, 0)
    with the odd element on the right.  ``F.conv*(padding="same")``
    refuses a stride above 1, so the strided convolutions pad by hand."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _batch_norm(x, p, prefix: str, training: bool, dims=(0, 1), eps=1e-5):
    """x normalized over ``dims``; scale/bias + running stats in params."""
    if training:
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, correction=0)
    else:
        mean = p[f"{prefix}_mean"]
        var = p[f"{prefix}_var"]
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p[f"{prefix}_scale"] + p[f"{prefix}_bias"]


# -------------------------------------------------- relative position encode

def rel_pos_encoding(max_len: int, d_model: int, group_size: int
                     ) -> np.ndarray:
    """Relative sinusoidal PE table [2*max_len - G%2, D]
    (reference attention.py:6-62)."""
    pos_left = np.arange(max_len - 1, group_size % 2 - 1, -1, dtype=np.float64)
    pos_right = np.arange(0, -max_len, -1, dtype=np.float64)
    pos = np.concatenate([pos_left, pos_right])[:, None]
    steps = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angles = pos / 10000 ** (2 * steps / d_model)
    pe = np.zeros((pos.shape[0], d_model), np.float32)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return pe


def _slice_pe(pe: torch.Tensor, max_len: int, group_size: int,
              seq_len: int) -> torch.Tensor:
    left = max_len - seq_len + group_size // 2
    right = max_len - group_size % 2 + seq_len - group_size // 2
    return pe[left:right]


def _rel_to_abs(scores: torch.Tensor) -> torch.Tensor:
    """Relative->absolute indexing (Bello et al.; reference
    attention.py:216-254).  scores: [B, H, T, 2T-1] -> [B, H, T, T]."""
    B, H, T1, T2 = scores.shape
    s = F.pad(scores, (0, 1)).reshape(B, H, -1)
    s = F.pad(s, (0, T2 - T1)).reshape(B, H, 1 + T1, T2)
    return s[:, :, :T1, T1 - 1:]


# ------------------------------------------------------------ grouped MHSA

def init_mhsa_params(gen: torch.Generator, d_model: int, num_heads: int,
                     group_size: int, max_pos_encoding: int) -> dict:
    out = {}
    for name in ("q", "k", "v", "o", "p"):
        out[f"w{name}"], out[f"b{name}"] = _linear_init(gen, d_model, d_model)
    bound = math.sqrt(6.0 / (num_heads + d_model // num_heads))
    out["u"] = _uniform(gen, (d_model,), bound)
    out["v"] = _uniform(gen, (d_model,), bound)
    out["pe"] = torch.from_numpy(rel_pos_encoding(max_pos_encoding, d_model,
                                                  group_size))
    return out


def grouped_mhsa(p: dict, x: torch.Tensor, mask: torch.Tensor,
                 num_heads: int, group_size: int,
                 max_pos_encoding: int) -> torch.Tensor:
    """Grouped rel-pos MHSA (reference attention.py:115-188).

    Args:
      x: [B, T, D]; mask: [B, T, T] True = MASKED (reference convention).
    T is padded to a multiple of the group size G, the padding masked,
    and the mask subsampled to the groups as ``mask[:, ::G, ::G]``.
    """
    B, T, D = x.shape
    G = group_size
    d_head = (G * D) // num_heads

    q = x @ p["wq"] + p["bq"]
    k = x @ p["wk"] + p["bk"]
    v = x @ p["wv"] + p["bv"]

    pad = (G - T % G) % G
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        mask = F.pad(mask, (0, pad, 0, pad), value=True)
    Tp = T + pad

    def heads(t):
        return t.reshape(B, Tp // G, num_heads, d_head).transpose(1, 2)

    qu, qv = heads(q + p["u"]), heads(q + p["v"])
    kh, vh = heads(k), heads(v)

    pe = _slice_pe(p["pe"], max_pos_encoding, G, Tp)
    e = pe @ p["wp"] + p["bp"]
    e = e.reshape(1, -1, num_heads, d_head).transpose(1, 2)

    scores_k = qu @ kh.transpose(-1, -2)
    scores_e = _rel_to_abs(qv @ e.transpose(-1, -2))
    scores = (scores_k + scores_e) / math.sqrt(d_head)

    gmask = mask[:, ::G, ::G][:, None]
    scores = scores.masked_fill(gmask, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores, dim=-1)
    out = (weights @ vh).transpose(1, 2).reshape(B, Tp, D)[:, :T]
    return out @ p["wo"] + p["bo"]


# ------------------------------------------------------------------- blocks

def init_ffn_params(gen: torch.Generator, d_model: int) -> dict:
    w1, b1 = _linear_init(gen, d_model, 4 * d_model)
    w2, b2 = _linear_init(gen, 4 * d_model, d_model)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2,
            "pre_scale": torch.ones(d_model),
            "pre_bias": torch.zeros(d_model)}


def ffn_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = scale_bias_norm(x, p["pre_scale"], p["pre_bias"])
    return F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def init_conv_block_params(gen: torch.Generator, d_model: int,
                           kernel_size: int) -> dict:
    bound = 1.0 / math.sqrt(d_model)
    pw1 = _uniform(gen, (d_model, d_model), bound)
    pw2 = _uniform(gen, (d_model, d_model), bound)
    dw = _uniform(gen, (d_model, 1, kernel_size), 1.0 / math.sqrt(kernel_size))
    zeros, ones = torch.zeros(d_model), torch.ones(d_model)
    return {
        "pw1_w": pw1, "pw1_b": zeros.clone(),
        "dw_w": dw, "dw_b": zeros.clone(),
        "pw2_w": pw2, "pw2_b": zeros.clone(),
        "bn_scale": ones.clone(), "bn_bias": zeros.clone(),
        "bn_mean": zeros.clone(), "bn_var": ones.clone(),
        "pre_scale": ones.clone(), "pre_bias": zeros.clone(),
    }


def conv_block(p: dict, x: torch.Tensor, conv_mask: torch.Tensor,
               training: bool = False) -> torch.Tensor:
    """Pointwise -> (mask) -> depthwise -> BN -> pointwise
    (reference block.py:127-171).  conv_mask: [B, T] True = MASKED."""
    x = scale_bias_norm(x, p["pre_scale"], p["pre_bias"])
    x = F.silu(x @ p["pw1_w"] + p["pw1_b"])
    x = x.masked_fill(conv_mask[:, :, None], 0.0)

    # depthwise "SAME" conv over time: [B, T, D] -> NCW
    k = p["dw_w"].shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), same_pad(x.shape[1], k)),
                 p["dw_w"], p["dw_b"], groups=x.shape[-1]).transpose(1, 2)
    y = _batch_norm(y, p, "bn", training)
    y = F.silu(y)
    return y @ p["pw2_w"] + p["pw2_b"]


def init_squeezeformer_block_params(gen: torch.Generator, d_model: int,
                                    num_heads: int, group_size: int,
                                    max_pos_encoding: int,
                                    conv_kernel_size: int) -> dict:
    def norm(name):
        return {f"norm_{name}_scale": torch.ones(d_model),
                f"norm_{name}_bias": torch.zeros(d_model)}

    return {
        "attn": {**init_mhsa_params(gen, d_model, num_heads, group_size,
                                    max_pos_encoding),
                 "pre_scale": torch.ones(d_model),
                 "pre_bias": torch.zeros(d_model)},
        **norm("attn"),
        "ffn1": init_ffn_params(gen, d_model), **norm("ffn1"),
        "conv": init_conv_block_params(gen, d_model, conv_kernel_size),
        **norm("conv"),
        "ffn2": init_ffn_params(gen, d_model), **norm("ffn2"),
    }


def squeezeformer_block(p: dict, x: torch.Tensor, attn_mask: torch.Tensor,
                        conv_mask: torch.Tensor, num_heads: int,
                        group_size: int, max_pos_encoding: int,
                        training: bool = False) -> torch.Tensor:
    """MHSA + FFN + Conv + FFN, each post-LN with residual
    (reference block.py:51-77)."""
    a = p["attn"]
    h = scale_bias_norm(x, a["pre_scale"], a["pre_bias"])
    h = grouped_mhsa(a, h, attn_mask, num_heads, group_size,
                     max_pos_encoding)
    x = _layer_norm(x + h, p["norm_attn_scale"], p["norm_attn_bias"])

    x = _layer_norm(x + ffn_block(p["ffn1"], x),
                    p["norm_ffn1_scale"], p["norm_ffn1_bias"])
    x = _layer_norm(x + conv_block(p["conv"], x, conv_mask, training),
                    p["norm_conv_scale"], p["norm_conv_bias"])
    x = _layer_norm(x + ffn_block(p["ffn2"], x),
                    p["norm_ffn2_scale"], p["norm_ffn2_bias"])
    return x


# -------------------------------------------------------------- subsampling

def init_subsampling_params(gen: torch.Generator, input_dim: int,
                            output_dim: int, num_filters: int,
                            kernel_size: int = 5) -> dict:
    bound = 1 / math.sqrt(kernel_size * kernel_size)
    shape = (num_filters, 1, kernel_size, kernel_size)
    c1 = _uniform(gen, shape, bound)
    c2 = _uniform(gen, shape, bound)
    proj_in = num_filters * math.ceil(input_dim / 4)
    pw, pb = _linear_init(gen, proj_in, output_dim)
    chan = (num_filters, 1, 1)
    return {
        "c1_w": c1, "c1_b": torch.zeros(num_filters),
        "bn_scale": torch.ones(chan), "bn_bias": torch.zeros(chan),
        "bn_mean": torch.zeros(chan), "bn_var": torch.ones(chan),
        "c2_w": c2, "c2_b": torch.zeros(num_filters),
        "proj_w": pw, "proj_b": pb,
    }


def conv_subsampling(p: dict, x: torch.Tensor, x_lens: torch.Tensor,
                     training: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x Conv2d stride-2, pads (2, 2) (x4 in time; the second conv
    depthwise) + projection (reference sampling.py:10-76).  x: [B, T, F]."""
    B, T, _ = x.shape
    masks = make_padding_mask(x_lens, T)[:, None, :, None].to(x.dtype)

    h = x[:, None]                                            # [B,1,T,F]
    masks = masks[:, :, ::2, :]
    h = F.conv2d(h, p["c1_w"], p["c1_b"], stride=2, padding=2)
    h = _batch_norm(h, p, "bn", training, dims=(0, 2, 3))
    h = F.silu(h) * masks
    masks = masks[:, :, ::2, :]
    h = F.silu(F.conv2d(h, p["c2_w"], p["c2_b"], stride=2, padding=2,
                        groups=h.shape[1])) * masks

    b, c, t, f = h.shape
    h = h.transpose(1, 2).reshape(b, t, c * f)
    h = h @ p["proj_w"] + p["proj_b"]
    new_lens = torch.div(x_lens - 1, 4, rounding_mode="floor") + 1
    return h, new_lens


# --------------------------------------------------------------- pixel ops

def init_downsampling_pixel_params(gen: torch.Generator, d_model: int,
                                   factor: int) -> dict:
    """Strided Conv1d downsampler (reference sampling.py:79-113)."""
    if factor <= 1:
        return {}
    k = int(2 * factor + 1)
    w = _uniform(gen, (d_model, d_model, k), 1.0 / math.sqrt(d_model * k))
    return {"w": w, "b": torch.zeros(d_model)}


def downsampling_pixel(p: dict, x: torch.Tensor, x_lens: torch.Tensor,
                       attn_mask: torch.Tensor, conv_mask: torch.Tensor,
                       factor: int):
    """[B, T, D] -> [B, ceil(T/factor), D] with mask subsampling."""
    if factor <= 1:
        return x, x_lens, attn_mask, conv_mask
    y = F.conv1d(x.transpose(1, 2), p["w"], p["b"], stride=factor,
                 padding=factor).transpose(1, 2)
    new_lens = torch.div(x_lens - 1, factor, rounding_mode="floor") + 1
    return (y, new_lens, attn_mask[:, ::factor, ::factor],
            conv_mask[:, ::factor])


def upsampling_pixel(x: torch.Tensor, x_lens: torch.Tensor,
                     attn_mask: torch.Tensor, conv_mask: torch.Tensor,
                     factor: int):
    """repeat_interleave upsampling (reference sampling.py:116-140)."""
    return (x.repeat_interleave(factor, 1), x_lens * factor,
            attn_mask.repeat_interleave(factor, 1).repeat_interleave(
                factor, 2),
            conv_mask.repeat_interleave(factor, 1))


# ------------------------------------------------------- style-conditioned

def init_adaptive_norm_params(gen: torch.Generator, d_model: int,
                              style_dim: int) -> dict:
    """Style-conditioned affine norm (reference normalization.py:23-42)."""
    return {"w": _uniform(gen, (style_dim, 2 * d_model),
                          1.0 / math.sqrt(style_dim))}


def _instance_norm(x: torch.Tensor, x_lens: torch.Tensor) -> torch.Tensor:
    mean, std = compute_statistic(x, x_lens)
    return (x - mean[:, None]) / (std[:, None] + 1e-5)


def adaptive_norm(p: dict, x: torch.Tensor, x_lens: torch.Tensor,
                  styles: torch.Tensor) -> torch.Tensor:
    """Instance-normalize over time, then apply style-derived scale/bias."""
    d = x.shape[-1]
    coeff = styles @ p["w"]
    scale, bias = coeff[:, :d], coeff[:, d:]
    return scale[:, None] * _instance_norm(x, x_lens) + bias[:, None]


class MixStyleDraws(NamedTuple):
    """MixStyle's random draws: the batch permutation [B] int64, the Beta
    (0.1, 0.1) mixing weights [B, 1] f32 and the apply flag (0-dim
    bool)."""
    perm: torch.Tensor
    weight: torch.Tensor
    apply: torch.Tensor


def mixstyle_draws(gen: torch.Generator, batch: int,
                   probability: float = 0.2) -> MixStyleDraws:
    """The draws of ``jax.random.permutation``, ``jax.random.beta(0.1,
    0.1)`` and ``uniform() <= probability`` from ``gen``.  torch draws
    Beta only from the global RNG, so the weights come from a numpy
    Generator seeded by ``gen``."""
    perm = torch.randperm(batch, generator=gen)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    weight = np.random.default_rng(seed).beta(0.1, 0.1, (batch, 1))
    apply = torch.rand((), generator=gen) <= probability
    return MixStyleDraws(perm, torch.from_numpy(weight.astype(np.float32)),
                         apply)


def mixstyle_norm(p: dict, draws: MixStyleDraws, x: torch.Tensor,
                  x_lens: torch.Tensor, styles: torch.Tensor,
                  training: bool = True) -> torch.Tensor:
    """MixStyle: blend style affine params across the batch (reference
    normalization.py:45-78) with the given draws; identity at
    inference."""
    if not training:
        return x
    d = x.shape[-1]
    coeff = styles @ p["w"]
    mu1, sig1 = coeff[:, :d], coeff[:, d:]
    perm = draws.perm.to(x.device)
    mu2, sig2 = mu1[perm], sig1[perm]
    weight = draws.weight.to(x.device)
    scale = weight * mu1 + (1 - weight) * mu2
    bias = weight * sig1 + (1 - weight) * sig2
    mixed = scale[:, None] * _instance_norm(x, x_lens) + bias[:, None]
    return torch.where(draws.apply.to(x.device), mixed, x)
