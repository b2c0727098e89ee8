"""BEST-RQ self-supervised pretraining: masking, train step, CLI.

Counterpart of asr_streaming_tpu/train/ssl.py, which wires the
reference's unassembled pieces (the random-projection quantization loss,
streaming_decoder_v1/lightspeech/modules/criterion.py:47-96, ours
train/losses.py::random_quantization_loss; the unlabeled-audio dataset,
train/data.py; the offline Squeezeformer encoder, models/offline.py)
into the BEST-RQ procedure: mask contiguous feature spans with noise,
encode, and classify each masked frame's random-projection codebook
index with the AM-softmax head.  Projection and codebook stay frozen
(random); the encoder and head train.

The JAX loss draws its span starts and noise from a key; here they are
drawn apart (``ssl_draws``, from a ``torch.Generator``) and applied by
``ssl_loss_fn``, which equals the JAX function given the same draws.
Plain PyTorch, no kernel: the encoder is models/offline.py's.

Run: ``python -m asr_streaming_tpu_torch.train.ssl --manifest
unlabeled.jsonl [--tiny] [--device cuda|cpu]``; the ``.npz`` holds
{"trainable", "frozen"} in the JAX package's key layout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.encoder import _time_reduction
from asr_streaming_tpu_torch.models.offline import (
    SqueezeformerConfig, acoustic_encoder, init_acoustic_encoder_params,
)
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.losses import (
    init_random_quantizer, random_quantization_loss,
)


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    encoder: SqueezeformerConfig = dataclasses.field(
        default_factory=SqueezeformerConfig)
    # BEST-RQ masking: each frame starts a masked span with prob
    # mask_prob; spans cover mask_span consecutive feature frames
    # (40 x 10 ms = the paper's 400 ms at our 10 ms hop).
    mask_prob: float = 0.01
    mask_span: int = 40
    mask_noise_std: float = 0.1
    # random-projection quantizer (frozen) + AM-softmax head (trained)
    quantizer_size: int = 16
    codebook_size: int = 8192
    # feature->encoder time reduction of conv_subsampling (2x stride-2)
    reduction: int = 4

    @classmethod
    def tiny(cls) -> "SSLConfig":
        return cls(encoder=SqueezeformerConfig(
            d_model=32, num_layers=2, attn_num_heads=2, input_dim=16,
            subsampling_num_filters=8, conv_kernel_size=7),
            mask_span=8, codebook_size=64, quantizer_size=8)


def init_ssl_params(gen: torch.Generator, cfg: SSLConfig,
                    device=None) -> tuple[dict, dict]:
    """Returns (trainable, frozen): the encoder + AM head train; the
    random projection/codebook are fixed buffers (the point of BEST-RQ)."""
    device = resolve_device(device)
    encoder = init_acoustic_encoder_params(gen, cfg.encoder, device)
    quant = init_random_quantizer(
        gen, feature_dim=cfg.encoder.input_dim * cfg.reduction,
        encoder_dim=cfg.encoder.d_model,
        quantizer_size=cfg.quantizer_size,
        vocabulary_size=cfg.codebook_size, device=device)
    return {"encoder": encoder, "am": quant.pop("am")}, quant


class SSLDraws(NamedTuple):
    """One step's random draws: span starts [B, T] bool (Bernoulli at
    ``mask_prob``) and standard-normal noise [B, T, F]."""
    starts: torch.Tensor
    noise: torch.Tensor


def ssl_draws(gen: torch.Generator, cfg: SSLConfig, shape: tuple,
              device="cpu") -> SSLDraws:
    """Draws for features of ``shape`` [B, T, F] (on the CPU, from the
    CPU generator ``gen``, then moved to ``device``)."""
    B, T, _ = shape
    starts = torch.rand((B, T), generator=gen) < cfg.mask_prob
    noise = torch.randn(tuple(shape), generator=gen)
    return SSLDraws(starts.to(device), noise.to(device))


def span_mask(starts: torch.Tensor, span: int,
              lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] bool: frame t is masked when a start falls in
    [t - span + 1, t] (the JAX ``reduce_window`` max, left pad span-1)."""
    x = F.pad(starts.to(torch.float32)[:, None], (span - 1, 0))
    mask = F.max_pool1d(x, span, stride=1)[:, 0] > 0
    if lens is not None:
        mask = mask & (torch.arange(starts.shape[1], device=starts.device)
                       [None, :] < lens[:, None])
    return mask


def ssl_loss_fn(trainable: dict, frozen: dict, cfg: SSLConfig,
                feats: torch.Tensor, lens: torch.Tensor,
                draws: SSLDraws) -> torch.Tensor:
    """feats: [B, T, F] log-mel; lens: [B] valid frames."""
    mask = span_mask(draws.starts, cfg.mask_span, lens)
    noise = cfg.mask_noise_std * draws.noise
    masked = torch.where(mask[..., None], noise, feats)

    enc, enc_lens = acoustic_encoder(trainable["encoder"], cfg.encoder,
                                     masked, lens, training=True)
    # quantization targets from the UNMASKED features at encoder rate
    red = _time_reduction(feats, cfg.reduction)      # [B, T//r, r*F]
    T4 = min(enc.shape[1], red.shape[1])
    red_mask = _time_reduction(
        mask[..., None].to(torch.float32), cfg.reduction
    ).amax(dim=-1) > 0                               # [B, T//r]
    q = {"projection": frozen["projection"], "codebook": frozen["codebook"],
         "am": trainable["am"]}
    return random_quantization_loss(
        q, enc[:, :T4], torch.clamp(enc_lens, max=T4), red[:, :T4],
        pos_mask=red_mask[:, :T4])


def make_ssl_train_step(cfg: SSLConfig, optimizer):
    """(trainable, frozen, opt_state, feats, lens, draws) ->
    (trainable, opt_state, loss)."""
    def train_step(trainable, frozen, opt_state, feats, lens, draws):
        loss, grads = optim.value_and_grad(
            lambda p: ssl_loss_fn(p, frozen, cfg, feats, lens, draws),
            trainable)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return optim.apply_updates(trainable, updates), opt_state, loss

    return train_step


# -------------------------------------------------------------------- CLI

def main(argv=None):
    """The BEST-RQ training CLI; returns the TrainLog."""
    import argparse
    import logging
    import time

    import numpy as np

    from asr_streaming_tpu_torch.ops.frontend import (
        MelConfig, log_mel, make_mel_params,
    )
    from asr_streaming_tpu_torch.train.data import SpeechRepresentationDataset
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=16.0,
                        help="fixed crop/pad length per example")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--save", default="ssl.npz")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("ssl")

    cfg = SSLConfig.tiny() if args.tiny else SSLConfig()
    mel = MelConfig.for_vietnamese() if not args.tiny else \
        dataclasses.replace(MelConfig.for_vietnamese(),
                            n_mels=cfg.encoder.input_dim)
    mel_params = make_mel_params(mel, device)

    gen = torch.Generator().manual_seed(args.seed)
    trainable, frozen = init_ssl_params(gen, cfg, device)
    optimizer = optim.adamw(args.lr, weight_decay=1e-4)
    opt_state = optimizer.init(trainable)
    step = make_ssl_train_step(cfg, optimizer)

    def save():
        save_params(args.save, {"trainable": trainable, "frozen": frozen})

    ds = SpeechRepresentationDataset(args.manifest)
    n_samples = int(args.seconds * 16000)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(ds))
    waves = np.zeros((args.batch_size, n_samples), np.float32)
    lens_s = np.zeros(args.batch_size, np.int32)

    i = 0
    losses, seconds = [], []
    for it in range(args.steps):
        t0 = time.perf_counter()
        for b in range(args.batch_size):
            w = ds[int(order[i % len(ds)])]
            i += 1
            n = min(len(w), n_samples)
            waves[b, :n] = w[:n]
            waves[b, n:] = 0.0
            lens_s[b] = n
        with torch.no_grad():
            feats = log_mel(mel_params, mel,
                            torch.from_numpy(waves).to(device))
        frame_lens = torch.from_numpy(lens_s // mel.hop_length).to(device)
        draws = ssl_draws(gen, cfg, tuple(feats.shape), device)
        trainable, opt_state, loss = step(trainable, frozen, opt_state,
                                          feats, frame_lens, draws)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if it % 50 == 0 or it == args.steps - 1:
            log.info("step %d loss %.4f (%.3f s/step)", it, losses[-1],
                     seconds[-1])
        if args.save and (it + 1) % args.save_every == 0:
            save()
    if args.save:
        save()
        log.info("saved %s", args.save)
    return optim.TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
