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

Without a launcher it trains on one device.  Under ``torchrun`` (one
process per rank, ``WORLD_SIZE`` set) it trains data- and
tensor-parallel, as the JAX driver does over its ('data', 'model') mesh:

  python -m torch.distributed.run --nproc-per-node 4 \\
      -m asr_streaming_tpu_torch.train.run --manifest train.jsonl \\
      --model-parallel 2

  * the data axis is the JAX rule: the largest divisor of the batch size
    that fits ``WORLD_SIZE // model_parallel``; ranks beyond the mesh log
    it and exit 0;
  * every rank builds the whole model from the seed (then ``--resume``),
    keeps its shard (parallel/mesh.py::shard_params) and takes its rows
    of each batch (``shard_batch``); parallel/collectives.py reduces;
  * NCCL with ``cuda:LOCAL_RANK`` where every local rank has its own
    card, else ``gloo`` (``--device cpu``, or several ranks sharing the
    cards: NCCL refuses two ranks on one card);
  * rank 0 logs and writes the checkpoint, gathered to whole leaves in
    the JAX key layout.

``--model-parallel`` above the number of processes raises, naming
torchrun.

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


def init_distributed(args, log):
    """(rank, device): under torchrun the process group is initialised
    and the rank's device chosen; without a launcher the rank is None."""
    import os

    import torch.distributed as dist

    from asr_streaming_tpu_torch import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < args.model_parallel:
        raise ValueError(
            f"--model-parallel {args.model_parallel} needs that many "
            f"processes, and this world has {world}: launch it with "
            "torchrun (python -m torch.distributed.run --nproc-per-node "
            f"{args.model_parallel} -m asr_streaming_tpu_torch.train.run "
            "...)")
    device = resolve_device(args.device)
    if "WORLD_SIZE" not in os.environ:
        return None, device
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards >= local_world:
            backend = "nccl"
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend)
    log.info("rank %d of %d on %s over %s", rank, world, device, backend)
    return rank, device


def main(argv=None):
    """Train; returns the TrainLog (the loss and wall seconds of each
    step)."""
    args = parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train")
    rank, device = init_distributed(args, log)
    try:
        return _train(args, log, rank, device)
    finally:
        if rank is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, log, rank, device):
    import torch.distributed as dist

    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.ops.frontend import log_mel
    from asr_streaming_tpu_torch.parallel.collectives import (
        all_gather_model, make_groups,
    )
    from asr_streaming_tpu_torch.parallel.mesh import (
        data_parallel_for_batch, make_mesh, shard_batch, shard_params,
    )
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

    groups = None
    if rank is not None:
        world = dist.get_world_size()
        mp = args.model_parallel
        dp = data_parallel_for_batch(world, mp, args.batch_size)
        mesh = make_mesh(devices=[device] * (dp * mp), model_parallel=mp)
        groups = make_groups(mesh, rank)
        if rank == 0:
            log.info("mesh: %s of %d ranks", mesh.shape, world)
        if groups is None:
            return TrainLog([], [])
    lead = rank in (None, 0)

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
    if lead:
        log.info("dataset: %d examples, vocab %d, device %s", len(dataset),
                 len(vocab), device)

    params = init_asr_params(torch.Generator().manual_seed(args.seed), cfg,
                             device)
    if args.resume:
        params = load_params(args.resume, like=params)
        if lead:
            log.info("resumed from %s", args.resume)
    optimizer = make_optimizer(cfg, base_lr=args.base_lr,
                               warmup_steps=args.warmup_steps, groups=groups)
    train_step = make_train_step(cfg, optimizer, groups)   # checks the split
    if groups is not None:
        params = shard_params(params, groups.mesh, rank)
    mel = cfg.mel

    def featurize(b):
        arrays = (b.waves, b.wave_lens, b.tokens, b.token_lens)
        if groups is not None:
            arrays = shard_batch(arrays, groups.mesh, rank)
        waves, wave_lens, tokens, token_lens = (
            torch.from_numpy(a).to(device) for a in arrays)
        with torch.no_grad():
            feats = log_mel(params["frontend"], mel, waves)
        feat_lens = torch.clamp(
            1 + torch.div(wave_lens - mel.n_fft, mel.hop_length,
                          rounding_mode="floor"), min=0)
        return Batch(feats=feats, feat_lens=feat_lens, labels=tokens,
                     label_lens=token_lens)

    def save():
        whole = params if groups is None else {
            **params, "encoder": all_gather_model(params["encoder"], groups)}
        if lead:
            save_params(args.save, whole)

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
            if lead and (step % 10 == 0 or step == 1):
                log.info("step %d  loss %.4f  (%.3f s/step)", step,
                         losses[-1], seconds[-1])
            if step % args.save_every == 0 or step >= args.steps:
                save()
                if lead:
                    log.info("saved %s @ step %d", args.save, step)
            if step >= args.steps:
                break
    peak = (torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else float("nan"))
    log.info("done: rank %s, %d steps, final loss %.4f, median %.1f ms/step, "
             "peak memory %.1f MiB", 0 if rank is None else rank, step,
             losses[-1], 1e3 * sorted(seconds)[len(seconds) // 2], peak)
    return TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
