"""RNN-T training for the English Emformer-RNNT model.

Counterpart of asr_streaming_tpu/train/rnnt.py (the reference's joint
objective, streaming_decoder_v1/lightspeech/modules/criterion.py:86-126):
the transcriber is the serving step over chunks (train == serve), the
predictor reads blank-prepended targets, and the lattice loss is
train/losses.py::rnnt_loss.  The Emformer runs its eager route
(train/ctc.py::eager_emformer): the kernels have no backward.

  python -m asr_streaming_tpu_torch.train.rnnt --manifest en.jsonl \\
      --spm spm_bpe_4096.model [--streaming-features] [--device cuda|cpu]
  (or --tiny with a character vocab)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from asr_streaming_tpu_torch.models.emformer import (
    _layer_norm, emformer_forward, init_emformer_state,
)
from asr_streaming_tpu_torch.models.encoder import _time_reduction
from asr_streaming_tpu_torch.models.rnnt import (
    PredictorState, RNNTConfig, joiner, predictor_step, transcriber_step,
)
from asr_streaming_tpu_torch.ops.frontend import log_mel
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.ctc import eager_emformer
from asr_streaming_tpu_torch.train.losses import rnnt_loss


class RNNTBatch(NamedTuple):
    feats: torch.Tensor        # [B, T_mel, n_mels] or [B, C, want, n_mels]
    feat_lens: torch.Tensor    # [B] mel frames, or valid chunks
    targets: torch.Tensor      # [B, U] int
    target_lens: torch.Tensor  # [B]


def training_config(cfg: RNNTConfig) -> RNNTConfig:
    return dataclasses.replace(cfg, emformer=eager_emformer(cfg.emformer))


def transcriber_forward(params: dict, cfg: RNNTConfig,
                        feats: torch.Tensor) -> torch.Tensor:
    """Offline transcriber: the streaming step over chunks (the serving
    math).  Returns [B, T_out, encoding_dim]."""
    x = feats @ params["input_linear"]["w"]
    x = _time_reduction(x, 4)
    enc, _ = emformer_forward(params["emformer"], cfg.emformer, x)
    enc = enc[:, :x.shape[1]]
    p = params["enc_out"]
    return _layer_norm(enc @ p["w"] + p["b"], p["ln_scale"], p["ln_bias"])


def streaming_features(mel_params: dict, mel_cfg, waves: torch.Tensor,
                       segment_len: int, buffer_len: int,
                       want: int) -> torch.Tensor:
    """Per-chunk features exactly as the serving tick computes them: each
    chunk's wave is [the previous chunk's last buffer_len samples (zeros
    for the first) | segment_len new samples], its center=True mel
    computed on its own and cut to ``want`` frames.  All chunks go
    through one ``log_mel`` call.  waves [B, n] with n a multiple of
    segment_len -> [B, n_chunks, want, n_mels]."""
    B, n = waves.shape
    n_chunks = n // segment_len
    segs = waves[:, :n_chunks * segment_len].reshape(B, n_chunks,
                                                     segment_len)
    ctx = torch.cat([torch.zeros((B, 1, buffer_len), dtype=waves.dtype,
                                 device=waves.device),
                     segs[:, :-1, -buffer_len:]], 1)
    wins = torch.cat([ctx, segs], 2)                    # [B, C, buf+seg]
    feats = log_mel(mel_params, mel_cfg, wins.reshape(B * n_chunks, -1))
    return feats.reshape(B, n_chunks, *feats.shape[1:])[:, :, :want]


def transcriber_forward_streaming(params: dict, cfg: RNNTConfig,
                                  chunk_feats: torch.Tensor) -> torch.Tensor:
    """The transcriber over per-chunk features through the serving
    encoder step (``transcriber_step`` with the Emformer state carried):
    chunk_feats [B, n_chunks, want, n_mels] from ``streaming_features``
    -> [B, n_chunks * segment_length, encoding_dim]."""
    B, C = chunk_feats.shape[:2]
    state = init_emformer_state(cfg.emformer, B, chunk_feats.device)
    encs = []
    for c in range(C):
        enc, state = transcriber_step(params, cfg, chunk_feats[:, c], state)
        encs.append(enc)
    return torch.cat(encs, 1)


def predictor_forward(params: dict, cfg: RNNTConfig,
                      targets: torch.Tensor) -> torch.Tensor:
    """The predictor over blank-prepended targets -> [B, U+1,
    encoding_dim]."""
    B, U = targets.shape
    bos = torch.full((B, 1), cfg.blank, dtype=targets.dtype,
                     device=targets.device)
    tokens = torch.cat([bos, targets], 1)               # [B, U+1]
    shape = (cfg.pred_layers, B, cfg.pred_hidden)
    state = PredictorState(h=torch.zeros(shape, device=targets.device),
                           c=torch.zeros(shape, device=targets.device))
    outs = []
    for u in range(U + 1):
        out, state = predictor_step(params, tokens[:, u], state)
        outs.append(out)
    return torch.stack(outs, 1)


def rnnt_loss_fn(params: dict, cfg: RNNTConfig,
                 batch: RNNTBatch) -> torch.Tensor:
    """The joint loss.  batch.feats is [B, T_mel, n_mels] (the offline
    featurizer) or [B, n_chunks, want, n_mels] (``streaming_features``;
    batch.feat_lens then counts valid chunks)."""
    cfg = training_config(cfg)
    if batch.feats.ndim == 4:
        enc = transcriber_forward_streaming(params, cfg, batch.feats)
        t_lens = torch.clamp(batch.feat_lens * cfg.emformer.segment_length,
                             max=enc.shape[1])
    else:
        enc = transcriber_forward(params, cfg, batch.feats)
        t_lens = torch.clamp(torch.div(batch.feat_lens - 1, 4,
                                       rounding_mode="floor") + 1,
                             max=enc.shape[1])
    pred = predictor_forward(params, cfg, batch.targets)
    logits = joiner(params, enc[:, :, None, :], pred[:, None, :, :])
    return rnnt_loss(logits, t_lens, batch.targets, batch.target_lens,
                     blank=cfg.blank)


def make_rnnt_train_step(cfg: RNNTConfig,
                         optimizer: optim.GradientTransformation):
    def train_step(params, opt_state, batch: RNNTBatch):
        loss, grads = optim.value_and_grad(
            lambda p: rnnt_loss_fn(p, cfg, batch), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss

    return train_step


# -------------------------------------------------------------------- CLI

def main(argv=None):
    """The EN Emformer-RNNT training CLI; returns the TrainLog."""
    import argparse
    import logging
    import time

    import numpy as np

    from asr_streaming_tpu_torch import resolve_device
    from asr_streaming_tpu_torch.models.rnnt import init_rnnt_params
    from asr_streaming_tpu_torch.ops.frontend import (
        MelConfig, make_mel_params,
    )
    from asr_streaming_tpu_torch.train.data import load_manifest, read_wav
    from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--spm", default=None,
                        help="SentencePiece .model (greedy encoding); "
                        "omit with --tiny for a character vocab")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--token-bucket", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--save", default="rnnt.npz")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--streaming-features", action="store_true",
                        help="featurize with the serving tick's per-chunk "
                        "mel (train == serve, no chunk-edge skew)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("rnnt")

    entries = load_manifest(args.manifest)
    if args.spm:
        from asr_streaming_tpu_torch.text.spm import (
            encode_pieces, load_spm_pieces,
        )
        pieces = load_spm_pieces(args.spm)

        def encode(text):
            return encode_pieces(text, pieces)
        vocab_size = len(pieces) + 1          # + blank (reference: 4097)
    else:
        chars = sorted({c for e in entries for c in e["text"].lower()})
        index = {c: i for i, c in enumerate(chars)}

        def encode(text):
            return [index[c] for c in text.lower() if c in index]
        vocab_size = len(chars) + 1

    cfg = RNNTConfig.tiny(vocab_size=max(vocab_size, 8)) if args.tiny \
        else RNNTConfig(vocab_size=vocab_size, blank=vocab_size - 1)
    mel = MelConfig.for_english()
    if cfg.n_mels != mel.n_mels:
        mel = dataclasses.replace(mel, n_mels=cfg.n_mels)
    mel_params = make_mel_params(mel, device)

    params = init_rnnt_params(torch.Generator().manual_seed(args.seed), cfg,
                              device)
    optimizer = optim.adamw(args.lr, weight_decay=1e-4)
    opt_state = optimizer.init(params)
    step = make_rnnt_train_step(cfg, optimizer)
    want = (cfg.emformer.segment_length
            + cfg.emformer.right_context_length) * 4

    def featurize(w):
        with torch.no_grad():
            if args.streaming_features:
                # the serving featurizer: per-chunk center=True mel
                return streaming_features(mel_params, mel, w,
                                          EN_AUDIO.segment_length,
                                          EN_AUDIO.buffer_length, want)
            return log_mel(mel_params, mel, w)

    n_samples = int(args.seconds * 16000)
    if args.streaming_features:
        n_samples -= n_samples % EN_AUDIO.segment_length  # whole chunks
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(entries))
    waves = np.zeros((args.batch_size, n_samples), np.float32)
    wave_lens = np.zeros(args.batch_size, np.int32)
    targets = np.zeros((args.batch_size, args.token_bucket), np.int32)
    target_lens = np.zeros(args.batch_size, np.int32)

    i = 0
    losses, seconds = [], []
    for it in range(args.steps):
        t0 = time.perf_counter()
        for b in range(args.batch_size):
            e = entries[int(order[i % len(entries)])]
            i += 1
            w, _sr = read_wav(e["audio_filepath"])
            n = min(len(w), n_samples)
            waves[b, :n] = w[:n]
            waves[b, n:] = 0.0
            wave_lens[b] = n
            toks = encode(e["text"])[:args.token_bucket]
            targets[b, :len(toks)] = toks
            targets[b, len(toks):] = 0
            target_lens[b] = len(toks)
        feats = featurize(torch.from_numpy(waves).to(device))
        if args.streaming_features:
            # feat_lens counts valid chunks in streaming mode
            frame_lens = np.minimum(-(-wave_lens // EN_AUDIO.segment_length),
                                    feats.shape[1])
        else:
            frame_lens = np.minimum(wave_lens // mel.hop_length + 1,
                                    feats.shape[1])
        batch = RNNTBatch(
            feats=feats,
            feat_lens=torch.from_numpy(frame_lens.astype(np.int64)).to(device),
            targets=torch.from_numpy(targets).to(device),
            target_lens=torch.from_numpy(target_lens).to(device))
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if it % 50 == 0 or it == args.steps - 1:
            log.info("step %d loss %.4f (%.3f s/step)", it, losses[-1],
                     seconds[-1])
        if args.save and (it + 1) % args.save_every == 0:
            save_params(args.save, params)
    if args.save:
        save_params(args.save, params)
        log.info("saved %s", args.save)
    return optim.TrainLog(losses, seconds)


if __name__ == "__main__":
    main()
