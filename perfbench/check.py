"""Whether the timed path was right: the sampled streams replayed through
the plain reference, once the window has closed and the program's state
is freed.

The reference gets the same weights and makes its own inputs: each
chunk's audio from the traffic (``Traffic.chunk``), mu-law encoded by its
own table.  It follows the scheduler's host decisions, which come from the
host state machine and not from the device step: which chunks each stream
sent (every one, in order), and the contain, new-stream and reset flags
dispatched with them.  Everything the device step decides it works out
again and compares:

* ``route_mismatches``: chunks whose gate, VAD verdict, decode decision or
  leading / trailing silence differ from the pack's (exact: limit 0);
* CTC: ``chunk_err_share``, the share of decoded chunks with a frame whose
  served token lies more than ``tol`` below the reference's best log-prob
  in that frame, or whose emission row (kernel B's, as the scheduler
  fetched it at the segment's final or after the window) misses one of the
  reference's five best log-probs by more than ``tol``;
* RNN-T: ``encoding_err_share``, the share of the transcriber encodings
  kernel B wrote whose relative L2 error against the reference's exceeds
  ``tol``; ``beam_err_share``, the share of decoded chunks whose beam
  step (predictor, joiner, kernel E's selections, dedupe) the reference
  does not repeat within ``beam_tol``.  The beam is followed chunk by
  chunk: the reference starts each chunk from the beam the program held
  before it (its hypotheses' tokens and scores, captured on the card at
  dispatch; their predictor states and hashes the reference works out
  from the tokens), runs the chunk's frames over the encodings the
  program's beam read (captured on the card; the transcriber that made
  them is judged apart, by ``encoding_err_share`` on kernel B's rows),
  and compares the program's beam after the
  chunk: the best score, and the served hypothesis, which has to be a
  hypothesis of the reference's beam scoring within ``beam_tol`` of its
  best.  A chunk that starts a segment starts from the reference's own
  fresh beam.

Diagnostics beside them (not compared): the widest gaps and errors,
relative L2 errors, counts.

The routing flags, the decode decisions and the emission rows are mapped
to chunks by the pack's own decode column only after the route check has
compared it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench.reference import audio as ref_audio

PACK_DATA = 5


def _batches(records, n):
    for i in range(0, len(records), n):
        yield records[i:i + n]


def _chunk_inputs(tr, recs, k, device):
    seg, flags = [], []
    for r in recs:
        if k < len(r.packs):
            seg.append(ref_audio.mulaw_encode(tr.chunk(r.offset, k)))
            flags.append(r.flags[k])
        else:
            seg.append(np.zeros(tr.segment, np.uint8))
            flags.append((False, False, False, False))
    f = torch.tensor(flags, dtype=torch.bool, device=device)
    return (torch.from_numpy(np.stack(seg)).to(device), f[:, 0], f[:, 1],
            f[:, 2], f[:, 3])


def _route_mismatch(routed, packs, live):
    gate, speech, lead, trail, decode = (t.cpu().numpy() for t in routed)
    bad = 0
    for b, p in enumerate(packs):
        if not live[b]:
            continue
        bad += int(bool(decode[b]) != (p[0] > 0.5)
                   or bool(gate[b]) != (p[1] > 0.5)
                   or bool(speech[b]) != (p[2] > 0.5)
                   or abs(lead[b] - p[3]) > 1e-6 or abs(trail[b] - p[4]) > 1e-6)
    return bad


class _RelErr:
    def __init__(self):
        self.num = self.den = self.worst = 0.0
        self.rows = 0

    def add(self, got: np.ndarray, want: torch.Tensor):
        w = want.double()
        g = torch.from_numpy(got).to(w.device).double()
        num, den = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        self.num += num
        self.den += den
        self.worst = max(self.worst, (num / den) ** 0.5 if den else 0.0)
        self.rows += got.shape[0]

    def value(self):
        return (self.num / self.den) ** 0.5 if self.den else None


def check(model: dict, weights: dict, tr, records: List, device,
          tols: dict, batch: int = 16) -> dict:
    """The compared numbers of one run (``{name: value}``) and what was
    checked; ``tols``: the cell's check settings, ``tol`` the per-frame
    tolerance of the error shares, ``beam_tol`` the beam's."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            if model["kind"] == "ctc":
                return _check_ctc(model, weights, tr, records, device,
                                  tols["tol"], batch)
            return _check_rnnt(model, weights, tr, records, device,
                               tols["tol"], tols["beam_tol"], batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _check_ctc(model, weights, tr, records, device, tol, batch):
    from perfbench.reference.ctc import CTCReference
    ref = CTCReference(weights, model, device)
    U = model["emformer"]["segment_length"]
    max_rows = 1024 // U                    # chunks the emission ring holds
    mism = chunks = tokens = segments = 0
    gap_max = 0.0
    err = _RelErr()
    frame_errs: List[torch.Tensor] = []

    def flush(seg, got=None):
        """One segment's frames: their gap, and where the scheduler's rows
        are at hand, their rows' top log-prob error too."""
        nonlocal segments
        if not seg:
            return
        gaps = torch.cat([g for g, _ in seg])
        if got is not None:
            want = torch.cat([row for _, row in seg[:max_rows]])
            n = min(len(got), len(want))
            if len(seg) >= max_rows:                 # the ring's last rows
                n = min(n, (max_rows - 1) * U)       # were overwritten
            if n:
                err.add(got[:n], want[:n])
                gaps[:n] = torch.maximum(gaps[:n], _top_errs(got[:n],
                                                             want[:n]))
            segments += 1
        frame_errs.append(gaps)

    for recs in _batches(records, batch):
        carry = ref.zero_carry(len(recs))
        segs = [[] for _ in recs]
        for k in range(max(len(r.packs) for r in recs)):
            inputs = _chunk_inputs(tr, recs, k, device)
            routed, lp, carry = ref.step(*inputs, carry)
            live = [k < len(r.packs) for r in recs]
            packs = [r.packs[k] if live[b] else None
                     for b, r in enumerate(recs)]
            mism += _route_mismatch(routed, packs, live)
            for b, r in enumerate(recs):
                if not live[b]:
                    continue
                chunks += 1
                if r.flags[k][3]:
                    flush(segs[b])
                    segs[b] = []
                if packs[b][0] > 0.5:
                    served = torch.from_numpy(
                        packs[b][PACK_DATA:PACK_DATA + U].astype(np.int64)
                    ).to(device)
                    row = lp[b]
                    gap = row.max(-1).values - row.gather(
                        1, served[:, None])[:, 0]
                    tokens += int((served != model["blank"]).sum())
                    gap_max = max(gap_max, float(gap.max()))
                    segs[b].append((gap, row))
                if k in r.finals:
                    flush(segs[b], r.finals[k])
                    segs[b] = []
                if k == len(r.packs) - 1:
                    flush(segs[b])
                    segs[b] = []
    e = torch.cat(frame_errs) if frame_errs else torch.zeros(0)
    worst = e.reshape(-1, U).amax(1) if len(e) else e   # by chunk
    return {"route_mismatches": mism,
            "chunk_err_share": float((worst > tol).float().mean())
            if len(worst) else None,
            "chunk_err_max": float(worst.max()) if len(worst) else None,
            "token_gap": gap_max,
            "emission_rel_err": err.value(), "token_share":
            tokens / max(len(e), 1), "segments": segments,
            "streams": len(records), "chunks": chunks, "frames": len(e),
            "rows": err.rows, "_items": {"frame_err": e.cpu().numpy()}}


def _top_errs(got: np.ndarray, want: torch.Tensor, k: int = 5):
    """Each row's widest error over its k best reference log-probs."""
    top = want.topk(k, -1).indices
    g = torch.from_numpy(got).to(want.device).gather(1, top)
    return (g - want.gather(1, top)).abs().amax(1)


def _follow_beam(ref, recs, k, follow, known, packs, W, cap, beam_tol,
                 device):
    """The beam step of chunk k for the streams ``follow``: one error per
    stream compared (|best score gap|, or inf where the served hypothesis
    is no hypothesis of the reference's beam within ``beam_tol`` of its
    best), and the number skipped because a token buffer was full."""
    from perfbench.reference.rnnt import NEG, VALID_FLOOR
    B = len(follow)
    toks = np.zeros((B, W, cap), np.int32)
    lens = np.zeros((B, W), np.int32)
    scs = np.full((B, W), NEG, np.float32)
    encs = []
    for i, b in enumerate(follow):
        r = recs[b]
        t, n, sc, e = r.beams[r.beam_at[k]].read()
        encs.append(e)
        if r.flags[k][3]:                   # the step starts a fresh beam
            known[b].keep({})
            scs[i, 0] = 0.0
        else:
            toks[i], lens[i], scs[i] = t, n, sc
    enc = torch.from_numpy(np.stack(encs)).to(device)
    beam = ref.follow(enc, [known[b] for b in follow], toks, lens, scs)
    r_toks, r_lens, r_sc = (x.cpu().numpy() for x in beam[:3])
    errs, overflow = [], 0
    for i, b in enumerate(follow):
        r, pack = recs[b], packs[b]
        _, a_lens, a_sc, _ = r.beams[r.beam_at[k] + 1].read()
        n_p = int(pack[PACK_DATA])
        if n_p >= cap or max(lens[i].max(), a_lens.max(),
                             r_lens[i].max()) >= cap:
            overflow += 1
            continue
        served = pack[PACK_DATA + 1:PACK_DATA + 1 + n_p].astype(np.int64)
        near = [w for w in range(W) if r_sc[i, w] > VALID_FLOOR
                and r_sc[i, w] >= r_sc[i, 0] - beam_tol
                and r_lens[i, w] == n_p
                and np.array_equal(r_toks[i, w, :n_p], served)]
        errs.append(abs(float(a_sc[0]) - float(r_sc[i, 0])) if near
                    else float("inf"))
    return errs, overflow


def _check_rnnt(model, weights, tr, records, device, tol, beam_tol, batch):
    from perfbench.reference.rnnt import Known, RNNTReference
    ref = RNNTReference(weights, model, device)
    U = model["emformer"]["segment_length"]
    W, cap = model["beam_width"], model["beam_cap"]
    max_rows = 1024 // U
    mism = chunks = overflow = segments = computed = 0
    err = _RelErr()
    frame_errs: List[torch.Tensor] = []
    beam_errs: List[float] = []
    for recs in _batches(records, batch):
        carry = ref.zero_carry(len(recs))
        known = [Known(ref) for _ in recs]
        seg_enc = [[] for _ in recs]
        for k in range(max(len(r.packs) for r in recs)):
            inputs = _chunk_inputs(tr, recs, k, device)
            routed, enc, carry = ref.step(*inputs, carry)
            live = [k < len(r.packs) for r in recs]
            packs = [r.packs[k] if live[b] else None
                     for b, r in enumerate(recs)]
            mism += _route_mismatch(routed, packs, live)
            follow = []
            for b, r in enumerate(recs):
                if not live[b]:
                    continue
                chunks += 1
                if r.flags[k][3]:
                    seg_enc[b] = []
                if packs[b][0] > 0.5:
                    seg_enc[b].append(enc[b])
                    if r.beams:
                        follow.append(b)
                if k in r.finals and seg_enc[b]:
                    segments += 1
                    keep = max_rows - 1 if len(seg_enc[b]) >= max_rows \
                        else max_rows
                    want = torch.cat(seg_enc[b][:keep])
                    n = min(len(r.finals[k]), len(want))
                    if n:
                        got = r.finals[k][:n]
                        err.add(got, want[:n])
                        g = torch.from_numpy(got).to(device)
                        frame_errs.append((g - want[:n]).norm(dim=1)
                                          / want[:n].norm(dim=1))
                if k in r.finals:
                    seg_enc[b] = []
            if follow:
                e, o = _follow_beam(ref, recs, k, follow, known, packs, W,
                                    cap, beam_tol, device)
                beam_errs.extend(e)
                overflow += o
        computed += sum(kn.computed for kn in known)
    e = torch.cat(frame_errs) if frame_errs else torch.zeros(0)
    h = np.asarray(beam_errs, np.float64)
    finite = h[np.isfinite(h)]
    return {"route_mismatches": mism,
            "encoding_err_share": float((e > tol).float().mean()) if len(e)
            else None,
            "beam_err_share": float((h > beam_tol).mean()) if len(h)
            else None,
            "encoding_err_max": float(e.max()) if len(e) else None,
            "encoding_rel_err": err.value(),
            "beam_score_gap_max": float(finite.max()) if len(finite)
            else None,
            "beam_token_misses": int((~np.isfinite(h)).sum()),
            "beam_chunks": len(h), "beam_tokens_recomputed": computed,
            "segments": segments, "overflowed": overflow,
            "streams": len(records), "chunks": chunks, "rows": err.rows,
            "_items": {"encoding_err": e.cpu().numpy(), "beam_err": h}}
