"""Silero-shaped VAD training: per-window BCE and a self-labelling CLI.

Counterpart of asr_streaming_tpu/train/vad.py.  The reference ships
Silero's ONNX and never trains a VAD; this trains the same v5-shaped
graph (models/vad.py) from scratch on labelled (or energy self-labelled)
audio, with the serving geometry: one probability per 512-sample window
from ``silero_chunk_probs`` (64 samples of carried context, the LSTM
state reset at chunk start).

Run: ``python -m asr_streaming_tpu_torch.train.vad --manifest audio.jsonl``
(lines: {"audio_filepath": ..., optional "label_windows": [0/1, ...]};
windows without labels are self-labelled by peak amplitude).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from asr_streaming_tpu_torch.models.vad import (
    SileroConfig, init_silero_params, silero_chunk_probs,
)
from asr_streaming_tpu_torch.train import optim


@dataclasses.dataclass(frozen=True)
class VadTrainConfig:
    silero: SileroConfig = dataclasses.field(default_factory=SileroConfig)
    base_lr: float = 1e-3
    weight_decay: float = 0.0
    # self-labelling: a window is speech when its peak exceeds this linear
    # amplitude (clean or synthetic audio; give label_windows otherwise)
    label_amplitude: float = 0.01


def window_labels(wave: np.ndarray, cfg: SileroConfig,
                  amplitude: float = 0.01) -> np.ndarray:
    """Energy self-labels aligned with silero_chunk_probs' windows: window
    k covers samples [k*window, (k+1)*window) of the chunk.
    wave [T] or [B, T] -> [n_win] / [B, n_win] float32 in {0, 1}."""
    squeeze = wave.ndim == 1
    if squeeze:
        wave = wave[None]
    B, T = wave.shape
    n_win = -(-T // cfg.window)
    pad = n_win * cfg.window - T
    w = np.pad(wave, ((0, 0), (0, pad)))
    peaks = np.abs(w.reshape(B, n_win, cfg.window)).max(axis=-1)
    labels = (peaks > amplitude).astype(np.float32)
    return labels[0] if squeeze else labels


def vad_loss_fn(params: dict, cfg: SileroConfig, waves: torch.Tensor,
                labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-window binary cross-entropy through the serving forward (conv
    encoder + LSTM).  waves [B, T], labels [B, n_win]."""
    probs = torch.clamp(silero_chunk_probs(params, cfg, waves), 1e-6,
                        1.0 - 1e-6)
    bce = -(labels * torch.log(probs) + (1.0 - labels) * torch.log1p(-probs))
    if mask is not None:
        return (bce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return bce.mean()


def make_optimizer(cfg: VadTrainConfig) -> optim.GradientTransformation:
    if cfg.weight_decay > 0.0:
        return optim.adamw(cfg.base_lr, weight_decay=cfg.weight_decay)
    return optim.adam(cfg.base_lr)


def make_train_step(cfg: VadTrainConfig, optimizer):
    def train_step(params: dict, opt_state, waves: torch.Tensor,
                   labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
        loss, grads = optim.value_and_grad(
            lambda p: vad_loss_fn(p, cfg.silero, waves, labels, mask), params)
        # the STFT basis is a fixed buffer: a zero gradient, but it stays
        # in the optimizer, so adamw's weight decay still reaches it
        grads["stft_basis"] = torch.zeros_like(grads["stft_basis"])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss

    return train_step


def train_vad(waves: np.ndarray, labels: np.ndarray,
              cfg: VadTrainConfig = VadTrainConfig(), steps: int = 200,
              seed: int = 0, log_every: int = 0, device=None
              ) -> Tuple[dict, optim.TrainLog]:
    """The training loop (the CLI uses it).  waves [N, T] float32, labels
    [N, n_win]; returns (params, TrainLog)."""
    params = init_silero_params(torch.Generator().manual_seed(seed),
                                cfg.silero, device)
    device = params["stft_basis"].device
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer)
    w = torch.as_tensor(waves, dtype=torch.float32).to(device)
    lab = torch.as_tensor(labels, dtype=torch.float32).to(device)
    losses, seconds = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, w, lab)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if log_every and step % log_every == 0:
            print(f"step {step}: bce {losses[-1]:.4f}")
    return params, optim.TrainLog(losses, seconds)


def main(argv=None):
    import argparse
    import json

    from asr_streaming_tpu_torch.train.data import read_wav
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", required=True,
                    help="jsonl: {audio_filepath, optional label_windows}")
    ap.add_argument("--out", default="vad.npz")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seconds", type=float, default=0.84,
                    help="training chunk length (serving window: 0.2 s "
                         "context + 0.64 s segment)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)

    cfg = VadTrainConfig(base_lr=args.lr)
    T = int(cfg.silero.sample_rate * args.seconds)
    waves, labels = [], []
    with open(args.manifest) as f:
        for line in f:
            if not line.strip():
                continue
            item = json.loads(line)
            audio, sr = read_wav(item["audio_filepath"])
            if sr != cfg.silero.sample_rate:
                raise ValueError(f"{item['audio_filepath']}: expected "
                                 f"{cfg.silero.sample_rate} Hz, got {sr}")
            for off in range(0, max(1, len(audio) - T + 1), T):
                chunk = np.zeros(T, np.float32)
                piece = audio[off:off + T]
                chunk[:len(piece)] = piece
                waves.append(chunk)
                if "label_windows" in item:
                    n_win = -(-T // cfg.silero.window)
                    lw = np.zeros(n_win, np.float32)
                    src = item["label_windows"][
                        off // cfg.silero.window:
                        off // cfg.silero.window + n_win]
                    lw[:len(src)] = src
                    labels.append(lw)
                else:
                    labels.append(window_labels(chunk, cfg.silero,
                                                cfg.label_amplitude))
    params, train_log = train_vad(np.stack(waves), np.stack(labels), cfg,
                                  steps=args.steps, seed=args.seed,
                                  log_every=50, device=args.device)
    save_params(args.out, {"vad": params})
    print(f"saved {args.out} (final bce {train_log.loss:.4f}, "
          f"{len(waves)} chunks)")
    return train_log


if __name__ == "__main__":
    main()
