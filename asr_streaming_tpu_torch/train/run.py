"""CTC training CLI: ``python -m asr_streaming_tpu_torch.train.run``.

Counterpart of asr_streaming_tpu/train/run.py:

  JSONL manifest -> SpeechRecognitionDataset (the corpus tokenizer, or
  the placeholder vocab) -> duration-bucketed fixed-shape batches ->
  log-mel on the device, outside the gradient -> the CTC train step
  (train/ctc.py: Noam, clip, AdamW; the eager Emformer route) -> ``.npz``
  checkpoints in the JAX package's key layout, which its ``load_params``
  and the port's server both load.

  python -m asr_streaming_tpu_torch.train.run --manifest train.jsonl \\
      [--steps 1000] [--batch-size 8] [--save ckpt.npz] [--resume ckpt.npz]
      [--tiny] [--device cuda|cpu]

It trains on one device.  ``--model-parallel`` above 1 raises, as
``parallel/mesh.py::make_mesh`` does: data- and tensor-parallel training
is not ported.

Feature lengths: the batch's ``feat_lens`` count mel frames, and the
encoder divides by its stride.  The JAX package's run.py divides by the
stride here as well, so its CTC loss reads only a quarter of the emission
frames (ROADMAP.md, section 3, fault 17); this one divides once.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--save", default="ckpt.npz")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--base-lr", type=float, default=1.0)
    parser.add_argument("--warmup-steps", type=int, default=10_000)
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--token-bucket", type=int, default=256)
    parser.add_argument("--buckets-seconds", type=float, nargs="+",
                        default=[4.0, 8.0, 16.0, 32.0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model geometry (tests/smoke)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the TrainLog (the loss and wall seconds of each
    step)."""
    args = parse_args(argv)

    from asr_streaming_tpu_torch import resolve_device
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.ops.frontend import log_mel
    from asr_streaming_tpu_torch.text.corpus import load_corpus
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    from asr_streaming_tpu_torch.train.ctc import (
        Batch, make_optimizer, make_train_step,
    )
    from asr_streaming_tpu_torch.train.data import (
        SpeechRecognitionDataset, bucket_batches,
    )
    from asr_streaming_tpu_torch.train.optim import TrainLog
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, save_params,
    )

    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: tensor-parallel "
            "training is not ported (ROADMAP.md, queue 1, item 7.5)")
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train")

    vocab, lexicon = load_corpus()
    if args.tiny or vocab is None:
        vocab = vocab or placeholder_vocab(24)
    if lexicon is None:
        lexicon = {}
    if args.tiny:
        cfg = ASRConfig.tiny(vocab_size=len(vocab))
    else:
        cfg = ASRConfig.vietnamese()
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, vocab_size=len(vocab)))

    dataset = SpeechRecognitionDataset(args.manifest, vocab, lexicon)
    log.info("dataset: %d examples, vocab %d, device %s", len(dataset),
             len(vocab), device)

    params = init_asr_params(torch.Generator().manual_seed(args.seed), cfg,
                             device)
    if args.resume:
        params = load_params(args.resume, like=params)
        log.info("resumed from %s", args.resume)
    optimizer = make_optimizer(cfg, base_lr=args.base_lr,
                               warmup_steps=args.warmup_steps)
    train_step = make_train_step(cfg, optimizer)
    mel = cfg.mel

    def featurize(b):
        waves = torch.from_numpy(b.waves).to(device)
        with torch.no_grad():
            feats = log_mel(params["frontend"], mel, waves)
        wave_lens = torch.from_numpy(b.wave_lens).to(device)
        feat_lens = torch.clamp(
            1 + torch.div(wave_lens - mel.n_fft, mel.hop_length,
                          rounding_mode="floor"), min=0)
        return Batch(feats=feats, feat_lens=feat_lens,
                     labels=torch.from_numpy(b.tokens).to(device),
                     label_lens=torch.from_numpy(b.token_lens).to(device))

    opt_state = optimizer.init(params["encoder"])
    losses, seconds = [], []
    step = 0
    while step < args.steps:
        for b in bucket_batches(dataset, args.batch_size,
                                buckets_seconds=args.buckets_seconds,
                                token_bucket=args.token_bucket,
                                shuffle_seed=args.seed + step):
            t0 = time.perf_counter()
            params, opt_state, loss = train_step(params, opt_state,
                                                 featurize(b))
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            step += 1
            if step % 10 == 0 or step == 1:
                log.info("step %d  loss %.4f  (%.3f s/step)", step,
                         losses[-1], seconds[-1])
            if step % args.save_every == 0 or step >= args.steps:
                save_params(args.save, params)
                log.info("saved %s @ step %d", args.save, step)
            if step >= args.steps:
                break
    log.info("done: %d steps, final loss %.4f", step, losses[-1])
    return TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
