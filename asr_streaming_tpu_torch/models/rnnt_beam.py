"""Device-batched RNNT beam search: the beam as a batch axis.

Counterpart of asr_streaming_tpu/models/rnnt_beam.py.  All B streams x W
hypotheses advance together in one chunk step:

  * hypotheses live on the device as fixed-shape tensors [B, W, ...]:
    token buffer, rolling 64-bit hash (two int32 lanes) of the token
    sequence, log-prob score, predictor LSTM state, cached predictor
    output;
  * each frame runs (max_symbols + 1) expansion rounds; every round is one
    batched joiner over [B, W, V] and one batched predictor over [B * W];
  * blank-finished hypotheses are kept per round; the end-of-frame top-W
    selection dedupes by sequence hash with the score/order tie rules of
    the host oracle's stable sort + first-seen-key dedupe;
  * the host receives only the best hypothesis's token buffer.

Semantics are pinned to the host oracle (models/rnnt.py::RNNTBeamDecoder),
including its quirks: per-hypothesis top-W candidate preselection over the
FULL logp row (blank included, then dropped), and the
``best_finished - 10.0`` pruning threshold applied to the global top-W
slice only.

The three selections (the row preselect over [B, W, V], the flat top-W
over the [B, W * kcap] survivor table, the end-of-frame top-W) all go
through ``ops/topk.py::row_topk``: on the card the CUDA kernel of
``ops/row_topk.py``, on the CPU its plain twin ``iter_topk``.  The dead
slots' NEG scores tie exactly, the dedupe keeps the earliest, so the tie
order (lowest index) is part of the result; ``torch.topk`` promises none.
The JAX package keeps ``iter_topk`` at the preselect because XLA fuses its
first pass into the joiner; eager PyTorch fuses nothing across calls, and
both functions have one contract, so the choice changes no output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.rnnt import (
    PredictorState, RNNTConfig, init_predictor_state, joiner, predictor_step,
)
from asr_streaming_tpu_torch.ops.topk import row_topk

# Scores are plain f32 log-probs; NEG marks dead beam slots.  A large
# finite sentinel (not -inf) keeps every arithmetic path NaN-free.
# VALID_FLOOR separates a real hypothesis from sentinel residue (a dead
# slot's score only ever moves by adding logp <= 0).
NEG = -1.0e30
VALID_FLOOR = -1.0e29

# Rolling polynomial hash of the token sequence, two independent int32
# lanes; the multiplies wrap (two's complement), on the CPU and on the
# card.  Equal sequences always collide; unequal ones with ~2^-64
# probability: the dedupe granularity of the oracle's tuple(tokens) keys.
_HASH_M1 = 1_000_003
_HASH_M2 = 69_069
_HASH_INIT1 = 17
_HASH_INIT2 = 29


class BeamState(NamedTuple):
    """Carried per-stream beam: W hypotheses per stream, slot 0 = best."""
    tokens: torch.Tensor    # [B, W, CAP] int32 token buffer (prefix valid)
    lengths: torch.Tensor   # [B, W] int32 valid token count
    scores: torch.Tensor    # [B, W] f32 log-prob (NEG = dead slot)
    h1: torch.Tensor        # [B, W] int32 rolling hash lane 1
    h2: torch.Tensor        # [B, W] int32 rolling hash lane 2
    pred_h: torch.Tensor    # [L, B, W, H] predictor LSTM hidden
    pred_c: torch.Tensor    # [L, B, W, H] predictor LSTM cell
    pred_out: torch.Tensor  # [B, W, D] cached predictor output (post-LN)


def init_beam_state(cfg: RNNTConfig, batch: int, width: int,
                    cap: int = 256, device=None) -> BeamState:
    """Placeholder with every slot dead.  A stream's first tick always
    carries reset=True (the scheduler sets it at admit), and
    rnnt_beam_chunk_step makes the real fresh beam, which needs the
    predictor params, for reset slots."""
    dev = resolve_device(device)
    L, H, D = cfg.pred_layers, cfg.pred_hidden, cfg.encoding_dim
    i32 = dict(dtype=torch.int32, device=dev)
    return BeamState(
        tokens=torch.zeros((batch, width, cap), **i32),
        lengths=torch.zeros((batch, width), **i32),
        scores=torch.full((batch, width), NEG, dtype=torch.float32,
                          device=dev),
        h1=torch.full((batch, width), _HASH_INIT1, **i32),
        h2=torch.full((batch, width), _HASH_INIT2, **i32),
        pred_h=torch.zeros((L, batch, width, H), device=dev),
        pred_c=torch.zeros((L, batch, width, H), device=dev),
        pred_out=torch.zeros((batch, width, D), device=dev),
    )


def _fresh_beam(params: dict, cfg: RNNTConfig, batch: int, width: int,
                cap: int) -> BeamState:
    """One live empty hypothesis in slot 0: score 0, predictor having
    consumed the BOS blank from zeros (the oracle's init_hypothesis)."""
    dev = params["joiner"]["w"].device
    L, H, D = cfg.pred_layers, cfg.pred_hidden, cfg.encoding_dim
    po, ps = predictor_step(
        params, torch.full((1,), cfg.blank, dtype=torch.int32, device=dev),
        init_predictor_state(cfg, 1, dev), cfg)
    bs = init_beam_state(cfg, batch, width, cap, dev)
    bs.scores[:, 0] = 0.0
    return bs._replace(
        pred_h=ps.h[:, 0][:, None, None, :].expand(L, batch, width, H),
        pred_c=ps.c[:, 0][:, None, None, :].expand(L, batch, width, H),
        pred_out=po[0].expand(batch, width, D))


def _where_stream(mask: torch.Tensor, new: BeamState,
                  old: BeamState) -> BeamState:
    """Per-stream select over the batch axis (axis 0, except pred_h/c's
    axis 1)."""
    m2, m3, m4 = mask[:, None], mask[:, None, None], mask[None, :, None, None]
    return BeamState(
        tokens=torch.where(m3, new.tokens, old.tokens),
        lengths=torch.where(m2, new.lengths, old.lengths),
        scores=torch.where(m2, new.scores, old.scores),
        h1=torch.where(m2, new.h1, old.h1),
        h2=torch.where(m2, new.h2, old.h2),
        pred_h=torch.where(m4, new.pred_h, old.pred_h),
        pred_c=torch.where(m4, new.pred_c, old.pred_c),
        pred_out=torch.where(m3, new.pred_out, old.pred_out),
    )


def _take(a: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.take_along_axis``: idx (int64) has a's rank, size 1 on the
    axes it broadcasts over."""
    shape = [a.shape[d] if idx.shape[d] == 1 and d != dim else idx.shape[d]
             for d in range(a.ndim)]
    return torch.gather(a, dim, idx.expand(shape))


def _beam_frame(params: dict, cfg: RNNTConfig, enc_t: torch.Tensor,
                bs: BeamState, threshold: float) -> BeamState:
    """Advance every stream's beam by one encoder frame.

    Mirrors the host oracle's frame loop exactly:
      for k in 0..K: every active hypothesis contributes a blank-finished
      entry; rounds k < K then expand the global top-W non-blank candidates
      (drawn from each hypothesis's top-W logp entries, blank dropped)
      that clear best_finished - threshold.  End of frame: stable-order
      dedupe by sequence, keep top W.
    """
    B, W = bs.scores.shape
    V = cfg.vocab_size
    K = cfg.max_symbols_per_frame
    L = bs.pred_h.shape[0]
    CAP = bs.tokens.shape[2]
    kcap = min(W, V)   # host: min(beam_width, len(logp)) preselection
    dev = enc_t.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)

    # Active set: within a frame, hypotheses are (entering slot `parent`)
    # + (the <= K tokens appended this frame, in `app`).  Full token
    # buffers are rebuilt only for the W end-of-frame survivors.
    act_score = bs.scores
    act_parent = torch.arange(W, dtype=torch.int32, device=dev).expand(B, W)
    act_app = torch.zeros((B, W, max(K, 1)), dtype=torch.int32, device=dev)
    act_h1, act_h2 = bs.h1, bs.h2
    act_ph, act_pc, act_po = bs.pred_h, bs.pred_c, bs.pred_out

    fin_score, fin_parent, fin_app = [], [], []
    fin_h1, fin_h2, fin_ph, fin_pc, fin_po = [], [], [], [], []
    run_max = torch.full((B,), NEG, dtype=torch.float32, device=dev)

    for k in range(K + 1):
        logits = joiner(params, enc_t[:, None, :], act_po)      # [B, W, V]
        logp = torch.log_softmax(logits, -1)

        # blank move: the hypothesis finishes this frame as it is
        blank_sc = act_score + logp[..., cfg.blank]
        fin_score.append(blank_sc)
        fin_parent.append(act_parent)
        fin_app.append(act_app)
        fin_h1.append(act_h1)
        fin_h2.append(act_h2)
        fin_ph.append(act_ph)
        fin_pc.append(act_pc)
        fin_po.append(act_po)
        run_max = torch.maximum(run_max, blank_sc.amax(1))
        if k == K:
            break

        # Host parity: each hypothesis offers EXACTLY its top-kcap logp
        # entries, blank included in the ranking and then dropped as a
        # candidate (the oracle's np.argpartition(logp, -k)[-k:], whose tie
        # membership is arbitrary; ties -> lowest index is a deterministic
        # refinement).  One row top-k, then a flat top-W over the small
        # [B, W * kcap] survivor table: any flat winner lies inside its
        # row's top-kcap, and both tie orders agree, so the [B, W, V]
        # candidate tensor is never built.
        row_v, row_i = row_topk(logp, kcap)                 # [B, W, kcap]
        cand_sm = act_score[..., None] + row_v
        cand_sm = torch.where(row_i == cfg.blank, neg, cand_sm)
        top_sc, flat = row_topk(cand_sm.reshape(B, W * kcap), W)
        flat = flat.long()
        src = flat // kcap
        tok = torch.gather(row_i.reshape(B, W * kcap), 1, flat)     # int32
        keep = (top_sc >= run_max[:, None] - threshold) & \
               (top_sc > VALID_FLOOR)
        act_score = torch.where(keep, top_sc, neg)

        act_parent = torch.gather(act_parent, 1, src)
        act_h1 = torch.gather(act_h1, 1, src) * _HASH_M1 + (tok + 1)
        act_h2 = torch.gather(act_h2, 1, src) * _HASH_M2 + (tok + 1)
        act_app = _take(act_app, src[..., None], 1).clone()
        act_app[:, :, k] = tok
        src_lw = src[None, :, :, None]
        act_ph = _take(act_ph, src_lw, 2)
        act_pc = _take(act_pc, src_lw, 2)

        # consume the appended token (one batched predictor step)
        ps = PredictorState(h=act_ph.reshape(L, B * W, -1),
                            c=act_pc.reshape(L, B * W, -1))
        po, ps2 = predictor_step(params, tok.reshape(B * W), ps, cfg)
        act_po = po.reshape(B, W, -1)
        act_ph = ps2.h.reshape(L, B, W, -1)
        act_pc = ps2.c.reshape(L, B, W, -1)

    # ---- end of frame: dedupe finished by sequence, keep top W.
    # Finished index f = k * W + w is the host's append order (round-major,
    # active order within a round), so the equal-score tie rule "keep the
    # earliest" reproduces the oracle's stable sort.
    F = (K + 1) * W
    fscore = torch.stack(fin_score, 1).reshape(B, F)
    fh1 = torch.stack(fin_h1, 1).reshape(B, F)
    fh2 = torch.stack(fin_h2, 1).reshape(B, F)

    eq = (fh1[:, :, None] == fh1[:, None, :]) & \
         (fh2[:, :, None] == fh2[:, None, :])                  # [B, i, j]
    idx = torch.arange(F, device=dev)
    s_i = fscore[:, :, None]
    s_j = fscore[:, None, :]
    better = (s_j > s_i) | ((s_j == s_i) &
                            (idx[None, :] < idx[:, None])[None])
    dup = (eq & better).any(2)
    fscore = torch.where(dup, neg, fscore)

    top_sc, top_f = row_topk(fscore, W)                         # [B, W]
    top_f = top_f.long()
    n_app = (top_f // W).to(torch.int32)   # finished at round k: k appended

    def gat(lst):
        return torch.gather(torch.stack(lst, 1).reshape(B, F), 1, top_f)

    parent = gat(fin_parent).long()
    new_h1 = gat(fin_h1)
    new_h2 = gat(fin_h2)
    app = _take(torch.stack(fin_app, 1).reshape(B, F, -1),
                top_f[..., None], 1)                            # [B, W, K]
    # Survivor predictor states: per-round masked gathers.  Stacking the
    # round lists first ([L, B, F, H] for h and c) would hold ~400 MB per
    # frame at 512 x 10; instead gather each round's [L, B, W, H] block by
    # the survivor's within-round column and select by its round.
    col = top_f % W                                             # [B, W]
    new_ph = new_pc = new_po = None
    for k in range(K + 1):
        g_ph = _take(fin_ph[k], col[None, :, :, None], 2)
        g_pc = _take(fin_pc[k], col[None, :, :, None], 2)
        g_po = _take(fin_po[k], col[..., None], 1)
        if k == 0:
            new_ph, new_pc, new_po = g_ph, g_pc, g_po
        else:
            in_k = n_app == k
            new_ph = torch.where(in_k[None, :, :, None], g_ph, new_ph)
            new_pc = torch.where(in_k[None, :, :, None], g_pc, new_pc)
            new_po = torch.where(in_k[..., None], g_po, new_po)

    # token buffers: survivor = entering parent's buffer + appended run
    par_buf = _take(bs.tokens, parent[..., None], 1)
    par_len = torch.gather(bs.lengths, 1, parent)
    pos = torch.arange(CAP, dtype=torch.int32, device=dev)[None, None, :]
    new_buf = par_buf
    for j in range(K):
        write = ((j < n_app)[..., None] &
                 (pos == (par_len + j)[..., None]))  # overflow: never hits
        new_buf = torch.where(write, app[:, :, j:j + 1], new_buf)
    new_len = torch.clamp(par_len + n_app, max=CAP)

    return BeamState(tokens=new_buf, lengths=new_len, scores=top_sc,
                     h1=new_h1, h2=new_h2, pred_h=new_ph, pred_c=new_pc,
                     pred_out=new_po)


def rnnt_beam_chunk_step(params: dict, cfg: RNNTConfig, enc: torch.Tensor,
                         state: BeamState,
                         active: Optional[torch.Tensor] = None,
                         reset: Optional[torch.Tensor] = None,
                         threshold: float = 10.0
                         ) -> Tuple[BeamState, torch.Tensor, torch.Tensor]:
    """Advance all streams' beams over one chunk's encodings.

    enc: [B, U, D] f32 transcriber encodings of this chunk; active: [B]
    bool, advance this stream (False holds its state); reset: [B] bool,
    a fresh beam before the chunk (segment start).

    Returns (state, best_tokens [B, CAP] int32, best_len [B] int32): the
    best hypothesis's full token sequence per stream (beam slot 0).
    """
    B, U, _ = enc.shape
    W = state.scores.shape[1]
    CAP = state.tokens.shape[2]
    if reset is not None:
        state = _where_stream(reset, _fresh_beam(params, cfg, B, W, CAP),
                              state)
    new_state = state
    for t in range(U):
        new_state = _beam_frame(params, cfg, enc[:, t], new_state, threshold)
    if active is not None:
        new_state = _where_stream(active, new_state, state)
    return new_state, new_state.tokens[:, 0], new_state.lengths[:, 0]
