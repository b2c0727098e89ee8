"""ECAPA-TDNN speaker embedding and the enrolled-speaker verifier.

Counterpart of asr_streaming_tpu/models/ecapa.py (speechbrain's
``ECAPA_TDNN`` module for module, so a converted ``spkrec-ecapa-voxceleb``
checkpoint loads: tools/convert_ecapa.py):

  TDNNBlock(k5) = Conv1d(reflect "same" pad) + ReLU + BN
  -> 3x SE-Res2Net block (tdnn1 k1 -> Res2Net k3, dilations 2, 3, 4 ->
     tdnn2 k1 -> squeeze-excitation over the masked time mean; residual)
  -> mfa TDNNBlock(k1) over the concatenated block outputs
  -> attentive statistics pooling with global context (tdnn k1 + ReLU +
     BN -> tanh -> conv, -1e9 outside the mask) -> BN -> Linear
  -> the embedding, unit-normed (the norm clipped at 1e-9).

BatchNorm uses the running statistics (eps 1e-5), or the batch's with
``training=True``.  Everything runs in f32 with TF32
off (the package's switches); no TPU kernel lies under ECAPA, so the
convolutions are ``torch.nn.functional.conv1d``.  The parameter tree is
the JAX package's: ``blocks``, ``res2`` and ``res2_bn`` are lists, and an
``.npz`` of that layout (list items keyed "0", "1", ...) loads through
``ecapa_params_from_numpy``.

``SpeakerVerifier`` embeds a final segment's word window on the device
and compares its cosine with the enrolled speaker's against a strict
threshold (reference streaming_server.py:575-586).  Audio is padded to
power-of-two buckets up to 16 s and truncated past it; as in the JAX
package the bucket's zero padding counts as frames (no ``feat_lens``).
Every bucket is run once at construction, so no final pays a first call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.ops.frontend import (
    MelConfig, log_mel, make_mel_params,
)
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    n_mels: int = 80
    channels: int = 512
    res2net_scale: int = 8
    se_bottleneck: int = 128
    attention_channels: int = 128
    embedding_dim: int = 192
    dilations: Tuple[int, ...] = (2, 3, 4)

    @classmethod
    def tiny(cls) -> "EcapaConfig":
        return cls(n_mels=16, channels=32, res2net_scale=4,
                   se_bottleneck=16, attention_channels=16,
                   embedding_dim=24)


def _conv_init(gen, cout, cin, k):
    bound = 1.0 / math.sqrt(cin * k)
    w = (torch.rand((cout, cin, k), generator=gen) * 2.0 - 1.0) * bound
    return {"w": w, "b": torch.zeros(cout)}


def _bn_init(c):
    return {"scale": torch.ones((c, 1)), "bias": torch.zeros((c, 1)),
            "mean": torch.zeros((c, 1)), "var": torch.ones((c, 1))}


def init_ecapa_params(seed, cfg: EcapaConfig = EcapaConfig(),
                      device=None) -> dict:
    """Random weights from ``seed`` (an int or a CPU torch.Generator) in
    the JAX package's tree, on ``device`` (default CUDA; raises without
    it)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    C, S = cfg.channels, cfg.res2net_scale
    width = C // S
    params = {
        "in_conv": _conv_init(gen, C, cfg.n_mels, 5),
        "in_bn": _bn_init(C),
        "blocks": [{
            "conv1": _conv_init(gen, C, C, 1), "bn1": _bn_init(C),
            "res2": [_conv_init(gen, width, width, 3) for _ in range(S - 1)],
            "res2_bn": [_bn_init(width) for _ in range(S - 1)],
            "conv3": _conv_init(gen, C, C, 1), "bn3": _bn_init(C),
            "se_down": _conv_init(gen, cfg.se_bottleneck, C, 1),
            "se_up": _conv_init(gen, C, cfg.se_bottleneck, 1),
        } for _ in cfg.dilations],
    }
    cat = C * len(cfg.dilations)
    params["mfa"] = _conv_init(gen, cat, cat, 1)
    params["mfa_bn"] = _bn_init(cat)
    params["att_conv1"] = _conv_init(gen, cfg.attention_channels, 3 * cat, 1)
    params["att_bn"] = _bn_init(cfg.attention_channels)
    params["att_conv2"] = _conv_init(gen, cat, cfg.attention_channels, 1)
    params["out_bn"] = _bn_init(2 * cat)
    bound = 1.0 / math.sqrt(2 * cat)
    params["out_w"] = (torch.rand((2 * cat, cfg.embedding_dim), generator=gen)
                       * 2.0 - 1.0) * bound
    params["out_b"] = torch.zeros(cfg.embedding_dim)
    return params_from_numpy(params, resolve_device(device))


def _as_lists(tree):
    """A JAX-layout tree with its lists back: an ``.npz`` load keys list
    items "0", "1", ...; such dicts become lists (in index order)."""
    if isinstance(tree, dict):
        if tree and all(str(k).isdigit() for k in tree):
            return [_as_lists(tree[k]) for k in
                    sorted(tree, key=lambda k: int(k))]
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_lists(v) for v in tree]
    return tree


def ecapa_params_from_numpy(tree, device=None) -> dict:
    """ECAPA params of the JAX package's layout (numpy arrays, as
    ``load_params`` or ``convert_ecapa_state_dict`` give them) -> f32
    tensors on ``device`` (default CUDA; raises without it)."""
    return params_from_numpy(_as_lists(tree), resolve_device(device),
                             torch.float32)


def load_ecapa_weights(path: str, cfg: EcapaConfig = EcapaConfig()) -> dict:
    """Trained ECAPA weights as a numpy tree of the JAX layout, each leaf
    checked against ``cfg``'s shapes: an ``.npz`` of that layout, or a
    speechbrain ``embedding_model.ckpt`` (``.ckpt``/``.pt``) converted at
    load (tools/convert_ecapa.py; an ``embedding_model.`` prefix is
    stripped)."""
    if path.endswith((".ckpt", ".pt")):
        from asr_streaming_tpu_torch.tools.convert_ecapa import (
            convert_ecapa_state_dict,
        )
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        sd = {k.removeprefix("embedding_model."): v for k, v in sd.items()}
        tree = convert_ecapa_state_dict(sd, cfg)
    else:
        from asr_streaming_tpu_torch.utils.checkpoint import load_params
        tree = _as_lists(load_params(path))
    _check_shapes(init_ecapa_params(0, cfg, "cpu"), tree, "")
    return tree


def _check_shapes(like, tree, path: str) -> None:
    if isinstance(like, dict):
        for k, v in like.items():
            if k not in tree:
                raise KeyError(f"ECAPA weights lack {path + k!r}")
            _check_shapes(v, tree[k], path + k + "::")
    elif isinstance(like, list):
        if len(tree) != len(like):
            raise ValueError(f"ECAPA weights {path!r}: {len(tree)} items, "
                             f"{len(like)} expected")
        for i, (a, b) in enumerate(zip(like, tree)):
            _check_shapes(a, b, f"{path}{i}::")
    elif tuple(np.shape(tree)) != tuple(like.shape):
        raise ValueError(f"ECAPA weights {path[:-2]!r}: shape "
                         f"{np.shape(tree)} != {tuple(like.shape)}")


def _conv1d(p, x, dilation=1):
    """Conv1d with reflect "same" padding (speechbrain CNN.Conv1d
    defaults: padding="same", padding_mode="reflect")."""
    k = p["w"].shape[-1]
    pad = dilation * (k - 1) // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(x, p["w"], dilation=dilation) + p["b"][:, None]


def _bn(p, x, training=False):
    """BatchNorm over [B, C, T] with [C, 1] statistics: the running ones,
    or with ``training`` the batch's (mean and biased variance over batch
    and time, as models/ecapa.py:78-84 of the JAX package)."""
    if training:
        mean = x.mean(dim=(0, 2), keepdim=True)[0]
        var = x.var(dim=(0, 2), unbiased=False, keepdim=True)[0]
    else:
        mean, var = p["mean"], p["var"]
    return (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _masked_mean(x, mask, denom):
    return torch.sum(x * mask, dim=2, keepdim=True) / denom


def _se_res2block(p, x, dilation, scale, mask, denom, training=False):
    """SE-Res2Net block.  x: [B, C, T]; mask: [B, 1, T] (0/1)."""
    residual = x
    h = _bn(p["bn1"], F.relu(_conv1d(p["conv1"], x)), training)
    # Res2Net: `scale` channel groups, each conv fed the previous output
    chunks = torch.chunk(h, scale, dim=1)
    outs = [chunks[0]]
    prev = None
    for i in range(1, scale):
        inp = chunks[i] if prev is None else chunks[i] + prev
        y = _bn(p["res2_bn"][i - 1],
                F.relu(_conv1d(p["res2"][i - 1], inp, dilation)), training)
        outs.append(y)
        prev = y
    h = torch.cat(outs, dim=1)
    h = _bn(p["bn3"], F.relu(_conv1d(p["conv3"], h)), training)
    # squeeze-excitation over the masked mean over time
    s = F.relu(_conv1d(p["se_down"], _masked_mean(h, mask, denom)))
    s = torch.sigmoid(_conv1d(p["se_up"], s))
    return h * s + residual


def ecapa_embed(params: dict, cfg: EcapaConfig, feats: torch.Tensor,
                feat_lens: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
    """feats [B, T, n_mels] -> unit-norm embeddings [B, embedding_dim].
    ``training`` normalises with the batch's statistics (speaker
    training); serving uses the running ones."""
    B, T, _ = feats.shape
    if feat_lens is None:
        feat_lens = torch.full((B,), T, device=feats.device)
    mask = (torch.arange(T, device=feats.device)[None, :]
            < feat_lens.to(feats.device)[:, None])[:, None, :]
    denom = torch.clamp(mask.sum(dim=2, keepdim=True), min=1).to(
        feats.dtype)
    maskf = mask.to(feats.dtype)
    x = feats.transpose(1, 2) * maskf                   # [B, F, T]

    h = _bn(params["in_bn"], F.relu(_conv1d(params["in_conv"], x)),
            training) * maskf
    outs = []
    for block, d in zip(params["blocks"], cfg.dilations):
        h = _se_res2block(block, h, d, cfg.res2net_scale, maskf,
                          denom, training) * maskf
        outs.append(h)
    h = _bn(params["mfa_bn"],
            F.relu(_conv1d(params["mfa"], torch.cat(outs, dim=1))), training)

    # attentive statistics pooling with global context
    mean = _masked_mean(h, maskf, denom)
    var = _masked_mean((h - mean) ** 2, maskf, denom)
    std = torch.sqrt(torch.clamp(var, min=1e-9))
    ctx = torch.cat([h, mean.expand_as(h), std.expand_as(h)], dim=1)
    att = _bn(params["att_bn"], F.relu(_conv1d(params["att_conv1"], ctx)),
              training)
    att = _conv1d(params["att_conv2"], torch.tanh(att))
    att = torch.where(mask, att, torch.full_like(att, -1e9))
    att = torch.softmax(att, dim=2)

    mu = torch.sum(h * att, dim=2)
    sg = torch.sqrt(torch.clamp(torch.sum((h ** 2) * att, dim=2) - mu ** 2,
                                min=1e-9))
    pooled = _bn(params["out_bn"], torch.cat([mu, sg], dim=1)[:, :, None],
                 training)
    emb = pooled[:, :, 0] @ params["out_w"] + params["out_b"]
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-9)


class SpeakerVerifier:
    """Enrolled-speaker cosine verification on ``device`` (default CUDA;
    raises without it), one fixed shape per bucket (reference
    StreamingServer._verify_speaker, streaming_server.py:575-586)."""

    BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)   # seconds

    def __init__(self, params: dict, cfg: EcapaConfig,
                 enrolled_wave: np.ndarray, threshold: float = 0.45,
                 sample_rate: int = 16000, device=None):
        self.device = resolve_device(device)
        self.params = ecapa_params_from_numpy(params, self.device)
        self.cfg = cfg
        self.threshold = threshold
        self.sample_rate = sample_rate
        self.mel_cfg = MelConfig(
            n_fft=512, win_length=400, hop_length=160, n_mels=cfg.n_mels,
            center=True)
        self.mel_params = make_mel_params(self.mel_cfg, self.device)
        for b in self.BUCKETS:          # no final pays a first call
            self.embed(np.zeros(int(b * sample_rate), np.float32))
        self.enrolled = self.embed(np.asarray(enrolled_wave, np.float32))

    def _bucket(self, wave: np.ndarray) -> np.ndarray:
        secs = max(len(wave), 1) / self.sample_rate
        for b in self.BUCKETS:
            if secs <= b:
                n = int(b * self.sample_rate)
                break
        else:
            n = int(self.BUCKETS[-1] * self.sample_rate)
            wave = wave[:n]
        out = np.zeros(n, np.float32)
        out[:len(wave)] = wave[:n]
        return out

    def embed(self, wave: np.ndarray) -> np.ndarray:
        """The unit-norm embedding [embedding_dim] of ``wave``'s bucket."""
        x = torch.from_numpy(self._bucket(np.asarray(wave, np.float32)))
        with torch.no_grad():
            feats = log_mel(self.mel_params, self.mel_cfg,
                            x[None].to(self.device))
            emb = ecapa_embed(self.params, self.cfg, feats)
        return emb[0].cpu().numpy()

    def score(self, wave: np.ndarray) -> float:
        return float(np.dot(self.embed(wave), self.enrolled))

    def __call__(self, wave: np.ndarray) -> bool:
        if len(wave) == 0:
            return False
        return self.score(wave) > self.threshold
