"""TTS adversarial (vocoder) training: generator/discriminator steps + CLI.

Counterpart of asr_streaming_tpu/train/gan.py, which assembles the
reference's GAN training lineage (LS-GAN losses + multi-resolution STFT
loss, streaming_decoder_v1/lightspeech/modules/criterion.py:119-253,
ours train/losses.py; the MPD/MRD discriminators, v1
modules/discriminator.py:14-437, ours models/discriminators.py; the
text->waveform TTS model, v1 models/synthesis.py, ours models/tts.py)
into alternating train steps with teacher-forced durations:

  gen:  MR-STFT(fake, real) * w_stft + LSGAN-gen(D(fake)) * w_adv
        + duration-prediction loss * w_dur
  disc: LSGAN-adv(D(fake.detach()), D(real))

Plain PyTorch, no kernel.  The discriminators' periods and resolutions
are static structure, kept out of the differentiated tree.

Run: ``python -m asr_streaming_tpu_torch.train.gan --manifest tts.jsonl
[--tiny] [--device cuda|cpu]`` (a manifest from
tools/make_tts_manifest.py); the ``.npz`` holds the generator in the JAX
package's key layout and loads into either package's ``TTSModel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asr_streaming_tpu_torch.models.discriminators import (
    init_multi_period_discriminator, init_multi_resolution_discriminator,
    multi_period_discriminator, multi_resolution_discriminator,
)
from asr_streaming_tpu_torch.models.tts import (
    TTSConfig, init_tts_params, synthesize,
)
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.data import TTSBatch
from asr_streaming_tpu_torch.train.losses import (
    least_squares_adversarial_loss, least_squares_generative_loss,
    multi_resolution_stft_loss, temporal_prediction_loss,
)


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    tts: TTSConfig = dataclasses.field(default_factory=TTSConfig)
    stft_weight: float = 2.5
    adv_weight: float = 1.0
    dur_weight: float = 1.0
    # smaller resolutions for short training clips
    stft_resolutions: tuple = ((1024, 600, 120), (2048, 1200, 240),
                               (512, 240, 50))

    @classmethod
    def tiny(cls) -> "GANTrainConfig":
        return cls(tts=TTSConfig.tiny(),
                   stft_resolutions=((256, 128, 32), (128, 64, 16)))


def init_discriminators(gen: torch.Generator,
                        device=None) -> tuple[dict, dict]:
    """Returns (trainable_params, static_meta): the periods/resolutions
    lists are static structure, kept out of the differentiated tree."""
    mpd = init_multi_period_discriminator(gen, device=device)
    mrd = init_multi_resolution_discriminator(gen, device=device)
    static = {"periods": mpd.pop("periods"),
              "resolutions": mrd.pop("resolutions")}
    return {"mpd": mpd, "mrd": mrd}, static


def tts_batch_to(batch: TTSBatch, device) -> TTSBatch:
    """A collated (numpy) batch as tensors on ``device``."""
    return TTSBatch(*(torch.from_numpy(np.asarray(x)).to(device)
                      for x in batch))


def _disc_outs(disc: dict, static: dict, wave: torch.Tensor):
    mpd_o, _ = multi_period_discriminator(
        {**disc["mpd"], "periods": static["periods"]}, wave)
    mrd_o, _ = multi_resolution_discriminator(
        {**disc["mrd"], "resolutions": static["resolutions"]}, wave)
    return mpd_o + mrd_o


def _generate(gen: dict, cfg: GANTrainConfig, batch: TTSBatch) -> tuple:
    """Teacher-forced synthesis; returns (fake [B,T], durs_pred)."""
    audio, _audio_lens, durs_pred = synthesize(
        gen, cfg.tts, batch.tokens, batch.token_lens, batch.word_idxs,
        word_durs=batch.word_durs, training=True)
    return audio[:, 0, :], durs_pred


def gen_loss_fn(gen: dict, disc: dict, static: dict, cfg: GANTrainConfig,
                batch: TTSBatch):
    fake, durs_pred = _generate(gen, cfg, batch)
    T = min(fake.shape[1], batch.audio.shape[1])
    real = batch.audio[:, :T]
    fake = fake[:, :T]
    lens = torch.clamp(batch.audio_lens, max=T)
    stft = multi_resolution_stft_loss(fake, real, lens,
                                      resolutions=cfg.stft_resolutions)
    adv = least_squares_generative_loss(_disc_outs(disc, static, fake))
    Tw = batch.word_durs.shape[1]
    dur = temporal_prediction_loss(durs_pred[:, :Tw],
                                   batch.word_durs.to(durs_pred.dtype))
    loss = (cfg.stft_weight * stft + cfg.adv_weight * adv
            + cfg.dur_weight * dur)
    return loss, {"stft": stft, "adv": adv, "dur": dur, "fake": fake,
                  "real": real}


def disc_loss_fn(disc: dict, static: dict, fake: torch.Tensor,
                 real: torch.Tensor):
    return least_squares_adversarial_loss(
        _disc_outs(disc, static, fake), _disc_outs(disc, static, real))


def make_gan_train_steps(cfg: GANTrainConfig, gen_opt, disc_opt,
                         static: dict):
    """Returns (gen_step, disc_step).

    gen_step(gen, disc, gen_opt_state, batch)
        -> (gen, gen_opt_state, metrics, fake, real)   (fake detached)
    disc_step(disc, disc_opt_state, fake, real)
        -> (disc, disc_opt_state, d_loss)
    """
    def gen_step(gen, disc, opt_state, batch):
        (loss, aux), grads = optim.value_and_grad(
            lambda g: gen_loss_fn(g, disc, static, cfg, batch), gen,
            has_aux=True)
        updates, opt_state = gen_opt.update(grads, opt_state, gen)
        gen = optim.apply_updates(gen, updates)
        metrics = {"g_loss": loss, "stft": aux["stft"], "adv": aux["adv"],
                   "dur": aux["dur"]}
        return gen, opt_state, metrics, aux["fake"], aux["real"]

    def disc_step(disc, opt_state, fake, real):
        d_loss, grads = optim.value_and_grad(
            lambda d: disc_loss_fn(d, static, fake, real), disc)
        updates, opt_state = disc_opt.update(grads, opt_state, disc)
        return optim.apply_updates(disc, updates), opt_state, d_loss

    return gen_step, disc_step


# -------------------------------------------------------------------- CLI

def main(argv=None):
    """The TTS GAN training CLI; returns the TrainLog (the generator's
    loss and the wall seconds of each generator + discriminator step)."""
    import argparse
    import logging
    import time

    from asr_streaming_tpu_torch import resolve_device
    from asr_streaming_tpu_torch.train.data import (
        SpeechSynthesisDataset, tts_batches,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--gen-lr", type=float, default=2e-4)
    parser.add_argument("--disc-lr", type=float, default=2e-4)
    parser.add_argument("--save", default="tts.npz")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("gan")

    cfg = GANTrainConfig.tiny() if args.tiny else GANTrainConfig()
    g = torch.Generator().manual_seed(args.seed)
    gen = init_tts_params(g, cfg.tts, device)
    disc, disc_static = init_discriminators(g, device)
    gen_opt = optim.adamw(args.gen_lr, b1=0.8, b2=0.99)
    disc_opt = optim.adamw(args.disc_lr, b1=0.8, b2=0.99)
    gen_state = gen_opt.init(gen)
    disc_state = disc_opt.init(disc)
    gen_step, disc_step = make_gan_train_steps(cfg, gen_opt, disc_opt,
                                               disc_static)

    ds = SpeechSynthesisDataset(args.manifest)
    it = 0
    losses, seconds = [], []
    while it < args.steps:
        for batch in tts_batches(ds, args.batch_size,
                                 hop_length=cfg.tts.hop_length,
                                 max_frames=cfg.tts.max_frames,
                                 shuffle_seed=args.seed + it):
            t0 = time.perf_counter()
            gen, gen_state, metrics, fake, real = gen_step(
                gen, disc, gen_state, tts_batch_to(batch, device))
            disc, disc_state, d_loss = disc_step(disc, disc_state, fake,
                                                 real)
            losses.append(float(metrics["g_loss"]))
            d_loss = float(d_loss)
            seconds.append(time.perf_counter() - t0)
            if it % 50 == 0 or it == args.steps - 1:
                log.info("step %d g=%.4f (stft %.3f adv %.3f dur %.3f) "
                         "d=%.4f (%.3f s/step)", it, losses[-1],
                         float(metrics["stft"]), float(metrics["adv"]),
                         float(metrics["dur"]), d_loss, seconds[-1])
            if args.save and (it + 1) % args.save_every == 0:
                save_params(args.save, gen)
            it += 1
            if it >= args.steps:
                break
    if args.save:
        save_params(args.save, gen)
        log.info("saved %s", args.save)
    return optim.TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
