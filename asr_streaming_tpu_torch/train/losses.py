"""Training losses.

Counterpart of asr_streaming_tpu/train/losses.py (the reference's
criterion zoo, streaming_decoder_v1/lightspeech/modules/criterion.py):
AM-softmax, BEST-RQ random quantisation, the RNN-T loss, CTC + RNN-T, the
least-squares GAN losses, the (multi-resolution) STFT loss and the
log-domain duration loss; plus ``ctc_loss``, the counterpart of the
``optax.ctc_loss`` the JAX package calls.

No TPU kernel lies under any of them: they are plain PyTorch, and
autograd differentiates the recursions.  ``ctc_loss`` is optax's forward
recursion step for step (so an impossible alignment gives a large finite
loss with a gradient, not inf as ``F.ctc_loss`` would).  ``rnnt_loss``
computes a frame's vertical (emission) closure in one pass, a
``logcumsumexp`` over the label axis, where the JAX package scans it
label by label: the same sum of paths, U times fewer launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch.ops.sequence import make_padding_mask


# ---------------------------------------------------------------- AM-softmax

def init_am_softmax_params(gen: torch.Generator, input_dim: int,
                           output_dim: int, device="cpu") -> dict:
    std = (2.0 / (input_dim + output_dim)) ** 0.5
    w = torch.randn((input_dim, output_dim), generator=gen) * std
    return {"W": w.to(device)}


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-9)


def _am_logits(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
               margin: float, scale: float) -> torch.Tensor:
    # the reference normalises W along dim 1 (the class axis of the
    # [D, C] matrix), i.e. per-feature rows; mirrored
    costh = _unit_rows(x) @ _unit_rows(w)
    delta = F.one_hot(labels.long(), costh.shape[1]).to(costh.dtype) * margin
    return scale * (costh - delta)


def additive_margin_softmax_loss(params: dict, x: torch.Tensor,
                                 labels: torch.Tensor, margin: float = 0.2,
                                 scale: float = 30.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, predictions).  x: [N, D]; labels: [N]."""
    logits = _am_logits(params["W"], x, labels, margin, scale)
    loss = F.cross_entropy(logits, labels.long())
    return loss, torch.argmax(logits, 1)


# ------------------------------------------------------------------ BEST-RQ

def init_random_quantizer(gen: torch.Generator, feature_dim: int,
                          encoder_dim: int, quantizer_size: int,
                          vocabulary_size: int, device="cpu") -> dict:
    std = (2.0 / (feature_dim + quantizer_size)) ** 0.5
    return {
        "projection": (torch.randn((quantizer_size, feature_dim),
                                   generator=gen) * std).to(device),
        "codebook": torch.randn((vocabulary_size, quantizer_size),
                                generator=gen).to(device),
        "am": init_am_softmax_params(gen, encoder_dim, vocabulary_size,
                                     device),
    }


def random_quantization_loss(params: dict, encoded: torch.Tensor,
                             lens: torch.Tensor, features: torch.Tensor,
                             pos_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """BEST-RQ loss: targets are the nearest codebook entries of the
    random projection; AM-softmax over the valid (and ``pos_mask``)
    frames.  encoded [B, T, E], features [B, T, F]."""
    q = features @ params["projection"].T
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-9)
    cb = params["codebook"]
    cb = cb / torch.clamp(torch.linalg.norm(cb, dim=-1, keepdim=True),
                          min=1e-9)
    d2 = (q.square().sum(-1, keepdim=True) - 2 * q @ cb.T
          + cb.square().sum(-1))
    targets = torch.argmin(d2, -1)                      # [B, T]

    mask = make_padding_mask(lens, encoded.shape[1])
    if pos_mask is not None:
        mask = mask & pos_mask
    flat_x = encoded.reshape(-1, encoded.shape[-1])
    flat_t = targets.reshape(-1)
    flat_m = mask.reshape(-1).to(encoded.dtype)
    logits = _am_logits(params["am"]["W"], flat_x, flat_t, 0.2, 30.0)
    ce = F.cross_entropy(logits, flat_t, reduction="none")
    return (ce * flat_m).sum() / torch.clamp(flat_m.sum(), min=1)


# ----------------------------------------------------------------- CTC loss

def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0, log_epsilon: float = -1e5) -> torch.Tensor:
    """Per-sequence CTC loss [B], not normalised (optax.ctc_loss).

    logits [B, T, K] (log_softmax is applied here), logit_paddings [B, T]
    and label_paddings [B, N] float masks (1.0 = padding; labels
    right-padded), labels [B, N] int.  ``log_epsilon`` stands for log(0),
    so an impossible alignment costs about -T * log_epsilon, finite."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, -1)
    labels = labels.long()
    label_lens = N - label_paddings.sum(1).to(torch.int64)
    # repeat[b, n] = 1 when label n equals label n + 1
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    lp_phi = logprobs[:, :, blank_id]                           # [B, T]
    lp_emit = torch.gather(logprobs, 2,
                           labels[:, None, :].expand(B, T, N))  # [B, T, N]
    pads = logit_paddings.to(logprobs.dtype)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], 1)

    full = dict(dtype=logprobs.dtype, device=logits.device)
    phi = torch.full((B, N + 1), log_epsilon, **full)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, **full)
    for t in range(T):
        prev_phi_orig = phi
        # emit-to-phi epsilon move, except onto a repeated label
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        e_t, p_t = lp_emit[:, t], lp_phi[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, emit + e_t)
        next_phi = prev_phi + p_t
        # emit-to-phi blank move only when the next label repeats
        next_phi = update_phi(next_phi,
                              emit + p_t + log_epsilon * (1.0 - repeat))
        pad = pads[:, t:t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, label_lens[:, None])[:, 0]


# ----------------------------------------------------------------- RNNT loss

def rnnt_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
              targets: torch.Tensor, target_lens: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """RNN-T forward-algorithm loss (natural log), the mean of -log P
    over the batch (torchaudio rnnt_loss semantics).  logits
    [B, T, U+1, V] joint outputs, targets [B, U].

    Frame t's emissions close alpha vertically: alpha'[u] = logsumexp
    over k <= u of alpha[k] + sum_{k <= j < u} emit[t, j], that is
    E[u] + logcumsumexp_k(alpha[k] - E[k]) with E the exclusive cumsum
    of the frame's emit log-probs; then the blank consumes the frame."""
    B, T, U1, V = logits.shape
    logp = torch.log_softmax(logits, -1)
    blank_lp = logp[..., blank]                                  # [B, T, U+1]
    idx = F.pad(targets.long(), (0, 1))                          # [B, U+1]
    emit_lp = torch.gather(logp, 3, idx[:, None, :, None].expand(
        B, T, U1, 1))[..., 0]                                    # [B, T, U+1]

    NEG = -1e30
    alpha = torch.full((B, U1), NEG, dtype=logp.dtype, device=logits.device)
    alpha[:, 0] = 0.0
    alphas = []
    for t in range(T):
        E = F.pad(torch.cumsum(emit_lp[:, t, :-1], 1), (1, 0))
        alpha_emit = E + torch.logcumsumexp(alpha - E, 1)
        alphas.append(alpha_emit)
        alpha = alpha_emit + blank_lp[:, t]
    # alphas[t]: after frame t's emissions, before its blank
    alphas = torch.stack(alphas)                                 # [T, B, U+1]
    t_idx = torch.clamp(logit_lens.long() - 1, 0, T - 1)
    rows = torch.arange(B, device=logits.device)
    u_idx = target_lens.long()[:, None]
    final = torch.gather(alphas[t_idx, rows], 1, u_idx)[:, 0]
    final_blank = torch.gather(blank_lp[rows, t_idx], 1, u_idx)[:, 0]
    return -(final + final_blank).mean()


def sequence_to_sequence_loss(ctc_log_probs: torch.Tensor,
                              rnnt_logits: torch.Tensor,
                              logit_lens: torch.Tensor,
                              targets: torch.Tensor,
                              target_lens: torch.Tensor,
                              ctc_weight: float = 1.0,
                              rnnt_weight: float = 1.0, blank: int = 0):
    """Joint CTC + RNN-T objective (reference criterion.py:86-126).
    Returns (total, ctc, rnnt)."""
    T = ctc_log_probs.shape[1]
    logit_pad = (~make_padding_mask(logit_lens, T)).to(torch.float32)
    label_pad = (~make_padding_mask(target_lens, targets.shape[1])).to(
        torch.float32)
    ctc = ctc_loss(ctc_log_probs, logit_pad, targets, label_pad,
                   blank_id=blank).mean()
    rnnt = rnnt_loss(rnnt_logits, logit_lens, targets, target_lens, blank)
    return ctc_weight * ctc + rnnt_weight * rnnt, ctc, rnnt


# ------------------------------------------------------------------ GAN

def least_squares_generative_loss(disc_outs: Sequence[torch.Tensor]
                                  ) -> torch.Tensor:
    loss = sum(torch.mean((1.0 - dg) ** 2) for dg in disc_outs)
    return loss / len(disc_outs)


def least_squares_adversarial_loss(disc_outs: Sequence[torch.Tensor],
                                   disc_tgts: Sequence[torch.Tensor]
                                   ) -> torch.Tensor:
    loss = sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
               for dg, dr in zip(disc_outs, disc_tgts))
    return loss / len(disc_tgts)


# ------------------------------------------------------------------ STFT

@dataclasses.dataclass(frozen=True)
class STFTResolution:
    n_fft: int
    win_length: int
    hop_length: int


def _magnitude_stft(wave: torch.Tensor, res: STFTResolution) -> torch.Tensor:
    """[B, T] -> [B, n_bins, frames] magnitude (center=True hann)."""
    n = np.arange(res.n_fft)
    k = np.arange(res.n_fft // 2 + 1)
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(res.win_length)
                            / res.win_length))
    padded = np.zeros(res.n_fft)
    left = (res.n_fft - res.win_length) // 2
    padded[left:left + res.win_length] = win
    angle = 2 * np.pi * np.outer(k, n) / res.n_fft
    kernel = np.concatenate([np.cos(angle) * padded,
                             -np.sin(angle) * padded])[:, None, :]
    pad = res.n_fft // 2
    x = F.pad(wave[:, None, :], (pad, pad), mode="reflect")
    spec = F.conv1d(x, torch.tensor(kernel, dtype=wave.dtype,
                                    device=wave.device),
                    stride=res.hop_length)
    nb = res.n_fft // 2 + 1
    return torch.sqrt(spec[:, :nb] ** 2 + spec[:, nb:] ** 2 + 1e-12)


def stft_loss(audio_outs: torch.Tensor, audio_tgts: torch.Tensor,
              audio_lens: torch.Tensor, res: STFTResolution) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1 (criterion.py:155-216)."""
    so = _magnitude_stft(audio_outs, res)
    st = _magnitude_stft(audio_tgts, res)
    frames = st.shape[2]
    frame_lens = torch.clamp(torch.div(audio_lens, res.hop_length,
                                       rounding_mode="floor") + 1, 0, frames)
    mask = (torch.arange(frames, device=st.device)[None, None, :]
            < frame_lens[:, None, None]).to(st.dtype)
    sc = torch.linalg.norm(((st - so) * mask).flatten()) / torch.clamp(
        torch.linalg.norm((st * mask).flatten()), min=1e-9)
    full_mask = mask.expand(st.shape)
    mag = (torch.abs(torch.log(so + 1e-9) - torch.log(st + 1e-9))
           * full_mask).sum() / torch.clamp(full_mask.sum(), min=1)
    return sc + mag


def multi_resolution_stft_loss(
        audio_outs: torch.Tensor, audio_tgts: torch.Tensor,
        audio_lens: torch.Tensor,
        resolutions: Sequence[Tuple[int, int, int]] = (
            (1024, 600, 120), (2048, 1200, 240), (512, 240, 50)),
) -> torch.Tensor:
    loss = 0.0
    for fs, wl, hl in resolutions:
        loss = loss + stft_loss(audio_outs, audio_tgts, audio_lens,
                                STFTResolution(fs, wl, hl))
    return loss / len(resolutions)


# --------------------------------------------------------------- durations

def temporal_prediction_loss(outs: torch.Tensor, tgts: torch.Tensor,
                             min_value: float = -100.0) -> torch.Tensor:
    """Log-domain duration MSE, masked where the target is at the floor
    (criterion.py:242-253): log(0) = -inf clamps to ``min_value``, which
    marks the mask, as the reference clamps."""
    lo = torch.clamp(torch.log(torch.where(outs > 0, outs,
                                           torch.zeros_like(outs))),
                     min=min_value)
    lt = torch.clamp(torch.log(torch.where(tgts > 0, tgts,
                                           torch.zeros_like(tgts))),
                     min=min_value)
    mask = (lt != min_value).to(lo.dtype)
    return (((lo - lt) ** 2) * mask).sum() / torch.clamp(mask.sum(), min=1)
