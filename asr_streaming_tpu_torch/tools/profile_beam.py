"""Attribute the device RNNT beam chunk step's time on the CUDA card.

Counterpart of the repository's tools/profile_beam.py.  Times the full
``rnnt_beam_chunk_step`` at the serving shape (512 slots x beam 10,
vocabulary 4097) and its parts at the per-round shapes, so the per-frame
budget can be attributed op family by op family:

  joiner      one [B, W, V] joiner evaluation
  logsoftmax  log_softmax over the [B, W, V] logits
  topk_row    the per-hypothesis preselection, kernel E
              (csrc/row_topk.cu through ops/topk.py::row_topk)
  topk_iter   the same preselection by iter_topk, its plain version
  topk_flat   iter_topk over the flattened [B, W*V] candidates
  predictor   one batched [B*W] predictor (3-layer LN-LSTM) step
  frame       one _beam_frame (all K+1 rounds, dedupe and gathers)
  chunk       the full chunk step over U frames (what serving pays a tick)

Each row re-runs the same fixed inputs (not chained), timed with CUDA
events over ``--reps`` launches after two warm-up calls; the first call
is timed apart with the host clock (it includes the kernel build).  It
needs the card and raises without one.

  python -m asr_streaming_tpu_torch.tools.profile_beam [--slots 512] \\
      [--beam 10] [--reps 10]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Tuple

import numpy as np
import torch


def _time(fn: Callable, reps: int, warmup: int = 2) -> Tuple[float, float]:
    """(ms per call on the card, seconds of the first call)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, first


def profile_beam(slots: int = 512, beam: int = 10, reps: int = 10,
                 seed: int = 0) -> List[Tuple[str, float, float]]:
    """[(row, ms per call, first-call seconds)] on the CUDA card at the
    RNNTConfig defaults."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_beam times the CUDA card and found none")
    from asr_streaming_tpu_torch.models.rnnt import (
        PredictorState, RNNTConfig, init_rnnt_params, joiner, predictor_step,
    )
    from asr_streaming_tpu_torch.models.rnnt_beam import (
        _beam_frame, _fresh_beam, rnnt_beam_chunk_step,
    )
    from asr_streaming_tpu_torch.ops.topk import iter_topk, row_topk

    dev = torch.device("cuda")
    cfg = RNNTConfig()
    B, W, V = slots, beam, cfg.vocab_size
    D, H, L = cfg.encoding_dim, cfg.pred_hidden, cfg.pred_layers
    U = cfg.emformer.segment_length
    params = init_rnnt_params(torch.Generator().manual_seed(seed), cfg, dev)
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    enc = randn(B, U, D)
    enc_t = enc[:, 0]
    po = randn(B, W, D)
    logits = randn(B, W, V)
    logp = torch.log_softmax(logits, -1)
    tok = torch.from_numpy(rng.integers(0, V, B * W).astype(np.int32)).to(dev)
    ps = PredictorState(h=randn(L, B * W, H), c=randn(L, B * W, H))
    state = _fresh_beam(params, cfg, B, W, 256)

    rows = [
        ("joiner", lambda: joiner(params, enc_t[:, None, :], po)),
        ("logsoftmax", lambda: torch.log_softmax(logits, -1)),
        ("topk_row", lambda: row_topk(logp, W)),
        ("topk_iter", lambda: iter_topk(logp, W)),
        ("topk_flat", lambda: iter_topk(logp.reshape(B, W * V), W)),
        ("predictor", lambda: predictor_step(params, tok, ps, cfg)),
        ("frame", lambda: _beam_frame(params, cfg, enc_t, state, 10.0)),
        ("chunk", lambda: rnnt_beam_chunk_step(params, cfg, enc, state)),
    ]
    return [(name, *_time(fn, reps)) for name, fn in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    rows = profile_beam(args.slots, args.beam, args.reps)
    cfg = RNNTConfig()
    print(f"B={args.slots} W={args.beam} V={cfg.vocab_size} "
          f"K={cfg.max_symbols_per_frame} U={cfg.emformer.segment_length} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    for name, ms, first in rows:
        print(f"{name:11s} {ms:9.4f} ms  (first call {first:.2f} s)",
              flush=True)


if __name__ == "__main__":
    main()
