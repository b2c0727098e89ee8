"""Speaker-ID (ECAPA-TDNN) training: AM-softmax classification + CLI.

Counterpart of asr_streaming_tpu/train/speaker.py: the ECAPA embedding
(models/ecapa.py, BatchNorm on the batch's statistics while training),
the AdditiveMarginSoftmaxLoss (train/losses.py) and the
SpeechClassificationDataset (train/data.py) in a speaker-classification
loop.  The trained embedding params load into ``SpeakerVerifier``
(server ``speaker_weights:``).

Run: ``python -m asr_streaming_tpu_torch.train.speaker --manifest spk.jsonl``
(lines: {"audio_filepath", "label"}).
"""

from __future__ import annotations

import dataclasses

import torch

from asr_streaming_tpu_torch.models.ecapa import (
    EcapaConfig, ecapa_embed, init_ecapa_params,
)
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.losses import (
    additive_margin_softmax_loss, init_am_softmax_params,
)


@dataclasses.dataclass(frozen=True)
class SpeakerTrainConfig:
    ecapa: EcapaConfig = dataclasses.field(default_factory=EcapaConfig)
    num_speakers: int = 1000
    margin: float = 0.2
    scale: float = 30.0

    @classmethod
    def tiny(cls, num_speakers: int = 4) -> "SpeakerTrainConfig":
        return cls(ecapa=EcapaConfig.tiny(), num_speakers=num_speakers)


def init_speaker_params(gen: torch.Generator, cfg: SpeakerTrainConfig,
                        device=None) -> dict:
    ecapa = init_ecapa_params(gen, cfg.ecapa, device)
    am = init_am_softmax_params(gen, cfg.ecapa.embedding_dim,
                                cfg.num_speakers, ecapa["out_w"].device)
    return {"ecapa": ecapa, "am": am}


def speaker_loss_fn(params: dict, cfg: SpeakerTrainConfig,
                    feats: torch.Tensor, feat_lens: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    emb = ecapa_embed(params["ecapa"], cfg.ecapa, feats, feat_lens,
                      training=True)
    loss, _preds = additive_margin_softmax_loss(
        params["am"], emb, labels, margin=cfg.margin, scale=cfg.scale)
    return loss


def make_speaker_train_step(cfg: SpeakerTrainConfig, optimizer):
    def train_step(params, opt_state, feats, feat_lens, labels):
        loss, grads = optim.value_and_grad(
            lambda p: speaker_loss_fn(p, cfg, feats, feat_lens, labels),
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss

    return train_step


# -------------------------------------------------------------------- CLI

def main(argv=None):
    """The speaker training CLI; returns the TrainLog."""
    import argparse
    import logging
    import time

    import numpy as np

    from asr_streaming_tpu_torch import resolve_device
    from asr_streaming_tpu_torch.ops.frontend import (
        MelConfig, log_mel, make_mel_params,
    )
    from asr_streaming_tpu_torch.train.data import SpeechClassificationDataset
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="fixed crop/pad per example")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--save", default="ecapa.npz")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("speaker")

    ds = SpeechClassificationDataset(args.manifest)
    n_spk = len(ds.label_index)
    cfg = (SpeakerTrainConfig.tiny(n_spk) if args.tiny
           else SpeakerTrainConfig(num_speakers=n_spk))
    # SpeakerVerifier's frontend geometry (models/ecapa.py)
    mel = MelConfig(n_fft=512, win_length=400, hop_length=160,
                    n_mels=cfg.ecapa.n_mels, center=True)
    mel_params = make_mel_params(mel, device)

    params = init_speaker_params(torch.Generator().manual_seed(args.seed),
                                 cfg, device)
    optimizer = optim.adamw(args.lr, weight_decay=1e-4)
    opt_state = optimizer.init(params)
    step = make_speaker_train_step(cfg, optimizer)

    n_samples = int(args.seconds * 16000)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(ds))
    waves = np.zeros((args.batch_size, n_samples), np.float32)
    lens_s = np.zeros(args.batch_size, np.int32)
    labels = np.zeros(args.batch_size, np.int64)

    i = 0
    losses, seconds = [], []
    for it in range(args.steps):
        t0 = time.perf_counter()
        for b in range(args.batch_size):
            w, lab = ds[int(order[i % len(ds)])]
            i += 1
            n = min(len(w), n_samples)
            waves[b, :n] = w[:n]
            waves[b, n:] = 0.0
            lens_s[b] = n
            labels[b] = lab
        with torch.no_grad():
            feats = log_mel(mel_params, mel, torch.from_numpy(waves).to(device))
        frame_lens = np.minimum(lens_s // mel.hop_length + 1, feats.shape[1])
        params, opt_state, loss = step(
            params, opt_state, feats, torch.from_numpy(frame_lens).to(device),
            torch.from_numpy(labels).to(device))
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if it % 50 == 0 or it == args.steps - 1:
            log.info("step %d loss %.4f (%.3f s/step)", it, losses[-1],
                     seconds[-1])
        if args.save and (it + 1) % args.save_every == 0:
            save_params(args.save, params["ecapa"])
    if args.save:
        # the embedding net alone, in SpeakerVerifier's layout
        save_params(args.save, params["ecapa"])
        log.info("saved %s", args.save)
    return optim.TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
