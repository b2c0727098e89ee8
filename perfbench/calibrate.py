"""Give random output layers what a trained model's have: the blank on
silence, and tokens on a fixed share of voiced frames.

Random weights emit on a share of frames that changes with the seed, and
on silence as readily as on speech, so one seed's endpointer never fires
and another's fires everywhere: the host's work (events, finals and
their emission fetches) would change with the seed.  In set-up, before
the port sees the weights, the plain reference runs a few streams of the
run's own traffic; each emission frame is labelled silent (its audio is
digital silence) or voiced (RMS above 0.05).  The blank's output weights
then get a direction that separates the two: ``d``, the mean output-layer
input on silent frames minus that on voiced ones, scaled so that the
blank leads every other token by ``silence_margin`` on all but the worst
2% of silent frames.  Last the blank's bias is set so that it is the best
token on ``blank_share`` of the voiced frames.  For the transducer the
joiner's input also depends on the predictor: the frames are paired with
predictor states after the blank and after random tokens; pooled so, the
share says little of what a decoder starting from the blank does (one
seed's empty hypothesis never takes a token, another's always does), so
the blank's bias is then moved, by bisection, until the reference's
greedy decoding of the same streams, predictor carried, emits on
``1 - blank_share`` of the voiced frames.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import audio


def _frame_labels(tr, offset, k, model):
    """+1 voiced, -1 silent, 0 mixed, for chunk k's emission frames of a
    stream reading the pool at ``offset``."""
    a, em, mel = model["audio"], model["emformer"], model["mel"]
    U, hop = em["segment_length"], mel["hop_length"]
    span = 4 * hop                                  # samples a frame adds
    width = span + (mel["n_fft"] if not mel["center"] else 0)
    lead = -a["buffer_length"] - (mel["n_fft"] // 2 if mel["center"] else 0)
    n = len(tr.pool)
    out = []
    for u in range(U):
        start = offset + k * tr.segment + lead + u * span
        idx = np.arange(start, start + width) % n
        x = tr.pool[idx]
        rms = float(np.sqrt(np.mean(x * x)))
        out.append(-1 if not x.any() else (1 if rms > 0.05 else 0))
    return out


def _frames(ref, model, tr, device, streams, chunks):
    """Run the reference over ``streams`` streams of the traffic for
    ``chunks`` chunks, every chunk decoded: (per-frame outputs of
    ``ref.encode``-level features [N, ...], labels [N])."""
    rng = np.random.default_rng(0)
    offs = (rng.integers(0, len(tr.pool), streams) // tr.segment) * tr.segment
    carry = ref.zero_carry(streams)
    yes = torch.ones(streams, dtype=torch.bool, device=device)
    feats, labels = [], []
    for k in range(chunks):
        seg = np.stack([audio.mulaw_encode(tr.chunk(int(o), k)) for o in offs])
        first = yes if k == 0 else ~yes
        _, y, carry = ref.encode(torch.from_numpy(seg).to(device), yes, yes,
                                 first, first, carry)
        feats.append(y.reshape(-1, y.shape[-1]))
        labels += [lab for o in offs for lab in
                   _frame_labels(tr, int(o), k, model)]
    return torch.cat(feats), torch.tensor(labels, device=device)


def _fit(x, logits, labels, blank, share, margin):
    """(column, bias) to add to the blank's output column and bias."""
    sil, voi = labels < 0, labels > 0
    if not sil.any() or not voi.any():
        raise ValueError("calibration frames lack silence or voice")
    d = x[sil].mean(0) - x[voi].mean(0)
    s = x @ d
    mu = s[voi].mean()
    others = logits.clone()
    others[:, blank] = float("-inf")
    lead = others.amax(1) - logits[:, blank]      # best other over blank
    sep = s[sil] - mu
    need = torch.where(sep > 0, (lead[sil] + margin) / sep.clamp(min=1e-6),
                       torch.zeros_like(sep))
    alpha = float(torch.quantile(need.clamp(min=0.0), 0.98))
    lead_voi = lead[voi] - alpha * (s[voi] - mu)
    bias = float(torch.quantile(lead_voi, share)) - alpha * float(mu)
    return alpha * d, bias


def calibrate(weights: dict, model: dict, tr, device, streams=4,
              chunks=None) -> None:
    """Set, in place, the blank's output column and bias (module doc)."""
    from perfbench.reference.ctc import CTCReference
    from perfbench.reference.rnnt import RNNTReference
    w = model["weights"]
    share, margin, blank = w["blank_share"], w["silence_margin"], model["blank"]
    with torch.no_grad():
        if model["kind"] == "ctc":
            ref = CTCReference(weights, model, device)
            y, labels = _frames(ref, model, tr, device, streams, chunks or 12)
            c = weights["ctc"]
            h = ref.hidden(y)
            col, bias = _fit(h, h @ c["w2"] + c["b2"], labels, blank, share,
                             margin)
            c["w2"][:, blank] += col
            c["b2"][blank] += bias
            return
        ref = RNNTReference(weights, model, device)
        enc, labels = _frames(ref, model, tr, device, streams, chunks or 40)
        h, cst = ref._zero_pred(1)
        po, h, cst = ref.predictor(torch.full((1,), blank, device=device), h,
                                   cst)
        g = torch.Generator(device=device)
        g.manual_seed(1)
        toks = torch.randint(0, blank, (15,), generator=g, device=device)
        pos, _, _ = ref.predictor(toks, h.expand(-1, 15, -1).contiguous(),
                                  cst.expand(-1, 15, -1).contiguous())
        pred = torch.cat([po, pos])                          # [P, E]
        j = weights["joiner"]
        x = torch.relu(enc[:, None] + pred[None]).reshape(-1, enc.shape[-1])
        lab = labels[:, None].expand(-1, pred.shape[0]).reshape(-1)
        col, bias = _fit(x, x @ j["w"] + j["b"], lab, blank, share, margin)
        j["w"][:, blank] += col
        j["b"][blank] += bias
        _match_emission(ref, enc, labels, streams, 1.0 - share)


def _greedy_emits(ref, enc) -> torch.Tensor:
    """Greedy decoding of ``enc`` [S, T, E] from the blank, at most
    ``ref.K`` tokens a frame: whether each frame emitted [S, T]."""
    S, T, _ = enc.shape
    h, c = ref._zero_pred(S)
    po, h, c = ref.predictor(torch.full((S,), ref.blank, device=enc.device),
                             h, c)
    out = torch.zeros((S, T), dtype=torch.bool, device=enc.device)
    for t in range(T):
        open_ = torch.ones(S, dtype=torch.bool, device=enc.device)
        for _ in range(ref.K):                  # no host sync: all K rounds
            tok = ref.logp(enc[:, t], po).argmax(-1)
            emit = open_ & (tok != ref.blank)
            out[:, t] |= emit
            po2, h2, c2 = ref.predictor(tok, h, c)
            po = torch.where(emit[:, None], po2, po)
            h = torch.where(emit[None, :, None], h2, h)
            c = torch.where(emit[None, :, None], c2, c)
            open_ = emit
    return out


def _match_emission(ref, enc, labels, streams, target, steps=12, span=16.0):
    """Move the blank's bias until greedy decoding emits on ``target`` of
    the voiced frames (bisection over +-``span`` nats)."""
    chunks = enc.shape[0] // (streams * ref.m["emformer"]["segment_length"])
    U = ref.m["emformer"]["segment_length"]
    # ``_frames`` lays frames out chunk-major: [chunks, streams, U]
    seq = enc.reshape(chunks, streams, U, -1).permute(1, 0, 2, 3).reshape(
        streams, chunks * U, -1)
    voiced = (labels.reshape(chunks, streams, U).permute(1, 0, 2)
              .reshape(streams, -1) > 0)
    b = ref.w["joiner"]["b"]
    base = float(b[ref.blank])
    lo, hi = -span, span                    # emission falls as the bias rises
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        b[ref.blank] = base + mid
        rate = float(_greedy_emits(ref, seq)[voiced].float().mean())
        if rate > target:
            lo = mid
        else:
            hi = mid
    b[ref.blank] = base + 0.5 * (lo + hi)
