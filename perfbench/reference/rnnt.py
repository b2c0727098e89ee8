"""Plain reference of the English Emformer-RNNT serving step, in float32.

The transcriber (log-mel, ``input_linear``, the stride-4 reduction, the
streaming Emformer at M = 0, the output projection and its LayerNorm),
torchaudio's layer-normed LSTM predictor, the joiner and one frame of the
carried beam of the device tick, with the predictor state and sequence
hash of a hypothesis worked out from its tokens.  Frozen copies of the
port's ``models/rnnt.py`` and ``models/rnnt_beam.py`` at float32; the
beam's row top-k is a stable sort (ties to the lowest index, the port's
contract), not a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import audio, emformer
from perfbench.reference.emformer import layer_norm

NEG = -1.0e30
VALID_FLOOR = -1.0e29
_M1, _M2, _INIT1, _INIT2 = 1_000_003, 69_069, 17, 29


def topk(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


class Beam(NamedTuple):
    tokens: torch.Tensor    # [B, W, CAP] int32
    lengths: torch.Tensor   # [B, W] int32
    scores: torch.Tensor    # [B, W] f32
    h1: torch.Tensor
    h2: torch.Tensor
    pred_h: torch.Tensor    # [L, B, W, H]
    pred_c: torch.Tensor
    pred_out: torch.Tensor  # [B, W, E]


def _take(a, idx, dim):
    shape = [a.shape[d] if idx.shape[d] == 1 and d != dim else idx.shape[d]
             for d in range(a.ndim)]
    return torch.gather(a, dim, idx.expand(shape))


class RNNTReference:
    def __init__(self, weights: dict, model: dict, device):
        self.w = weights
        self.m = model
        self.mel = audio.mel_params(model["mel"], device)
        self.device = device
        self.blank = model["blank"]
        self.K = model["max_symbols_per_frame"]

    # ------------------------------------------------------ transcriber
    def zero_carry(self, batch: int) -> dict:
        a = self.m["audio"]
        return {"ctx": torch.zeros((batch, a["buffer_length"]),
                                   device=self.device),
                "state": emformer.zero_state(self.m["emformer"], batch,
                                             self.device)}

    def route(self, wave, active, contain):
        a, thr = self.m["audio"], self.m["energy_threshold_db"]
        gate = audio.energy_gate(wave[:, a["buffer_length"]:],
                                 a["sample_rate"], thr)
        windows = audio.window_speech(wave, self.m["vad_window"], thr)
        lead, trail = audio.silence_runs(
            windows, self.m["vad_window"] / a["sample_rate"])
        speech = windows.any(1)
        return gate, speech, lead, trail, active & (contain | (gate & speech))

    def encode(self, seg_u8, contain, active, new_stream, reset, carry):
        return self.step(seg_u8, contain, active, new_stream, reset, carry)

    def step(self, seg_u8, contain, active, new_stream, reset, carry):
        """One chunk: (route tuple, encodings [B, U, E], carry)."""
        wave, ctx = audio.assemble(seg_u8, carry["ctx"], active, new_stream)
        routed = self.route(wave, active, contain)
        em = self.m["emformer"]
        feats = audio.log_mel(self.mel, self.m["mel"], wave)
        feats = feats[:, :(em["segment_length"]
                           + em["right_context_length"]) * 4]
        x = emformer.time_reduction(feats @ self.w["input_linear"]["w"], 4)
        y, state = emformer.step(self.w["emformer"], em, x, carry["state"],
                                 reset, routed[-1])
        p = self.w["enc_out"]
        enc = layer_norm(y @ p["w"] + p["b"], p["ln_scale"], p["ln_bias"])
        return routed, enc, {"ctx": ctx, "state": state}

    # ------------------------------------------------ predictor, joiner
    def predictor(self, tokens, h, c):
        """tokens [N] -> (out [N, E], h, c), h and c [layers, N, H]."""
        p = self.w["predictor"]
        x = layer_norm(p["embedding"][tokens.long()], p["input_ln_scale"],
                       p["input_ln_bias"])
        lstm, hs, cs = p["lstm"], [], []
        for i in range(h.shape[0]):
            g = x @ lstm["wi"][i] + lstm["bi"][i] + h[i] @ lstm["wh"][i] \
                + lstm["bh"][i]
            g = layer_norm(g, lstm["g_scale"][i], lstm["g_bias"][i], eps=1e-3)
            ii, ff, gg, oo = torch.chunk(g, 4, -1)
            ci = torch.sigmoid(ff) * c[i] + torch.sigmoid(ii) * torch.tanh(gg)
            ci = layer_norm(ci, lstm["c_scale"][i], lstm["c_bias"][i],
                            eps=1e-3)
            hi = torch.sigmoid(oo) * torch.tanh(ci)
            hs.append(hi)
            cs.append(ci)
            x = hi
        out = layer_norm(x @ p["out_w"] + p["out_b"], p["ln_scale"],
                         p["ln_bias"])
        return out, torch.stack(hs), torch.stack(cs)

    def logp(self, enc, pred):
        j = self.w["joiner"]
        return torch.log_softmax(torch.relu(enc + pred) @ j["w"] + j["b"], -1)

    def _zero_pred(self, n):
        L, H = self.m["pred_layers"], self.m["pred_hidden"]
        z = torch.zeros((L, n, H), device=self.device)
        return z, z.clone()

    # ------------------------------------------------------------ beam
    def beam_frame(self, enc_t, bs: Beam, threshold=10.0) -> Beam:
        """One encoder frame of the carried beam (the port's
        ``_beam_frame``, step for step)."""
        B, W = bs.scores.shape
        K, V, blank = self.K, self.m["vocab_size"], self.blank
        L, CAP = bs.pred_h.shape[0], bs.tokens.shape[2]
        kcap = min(W, V)
        dev = enc_t.device
        neg = torch.full((), NEG, device=dev)
        act_score = bs.scores
        act_parent = torch.arange(W, dtype=torch.int32, device=dev).expand(B, W)
        act_app = torch.zeros((B, W, max(K, 1)), dtype=torch.int32, device=dev)
        act_h1, act_h2 = bs.h1, bs.h2
        act_ph, act_pc, act_po = bs.pred_h, bs.pred_c, bs.pred_out
        fin = {k: [] for k in ("score", "parent", "app", "h1", "h2", "ph",
                               "pc", "po")}
        run_max = torch.full((B,), NEG, device=dev)
        for k in range(K + 1):
            logp = self.logp(enc_t[:, None, :], act_po)
            blank_sc = act_score + logp[..., blank]
            for key, v in (("score", blank_sc), ("parent", act_parent),
                           ("app", act_app), ("h1", act_h1), ("h2", act_h2),
                           ("ph", act_ph), ("pc", act_pc), ("po", act_po)):
                fin[key].append(v)
            run_max = torch.maximum(run_max, blank_sc.amax(1))
            if k == K:
                break
            row_v, row_i = topk(logp, kcap)
            cand = torch.where(row_i == blank, neg, act_score[..., None] + row_v)
            top_sc, flat = topk(cand.reshape(B, W * kcap), W)
            flat = flat.long()
            src = flat // kcap
            tok = torch.gather(row_i.reshape(B, W * kcap), 1, flat)
            keep = (top_sc >= run_max[:, None] - threshold) & \
                (top_sc > VALID_FLOOR)
            act_score = torch.where(keep, top_sc, neg)
            act_parent = torch.gather(act_parent, 1, src)
            act_h1 = torch.gather(act_h1, 1, src) * _M1 + (tok + 1)
            act_h2 = torch.gather(act_h2, 1, src) * _M2 + (tok + 1)
            act_app = _take(act_app, src[..., None], 1).clone()
            act_app[:, :, k] = tok
            act_ph = _take(act_ph, src[None, :, :, None], 2)
            act_pc = _take(act_pc, src[None, :, :, None], 2)
            po, h, c = self.predictor(tok.reshape(B * W),
                                      act_ph.reshape(L, B * W, -1),
                                      act_pc.reshape(L, B * W, -1))
            act_po = po.reshape(B, W, -1)
            act_ph = h.reshape(L, B, W, -1)
            act_pc = c.reshape(L, B, W, -1)

        Fn = (K + 1) * W
        fscore = torch.stack(fin["score"], 1).reshape(B, Fn)
        fh1 = torch.stack(fin["h1"], 1).reshape(B, Fn)
        fh2 = torch.stack(fin["h2"], 1).reshape(B, Fn)
        eq = (fh1[:, :, None] == fh1[:, None, :]) & \
            (fh2[:, :, None] == fh2[:, None, :])
        idx = torch.arange(Fn, device=dev)
        better = (fscore[:, None, :] > fscore[:, :, None]) | (
            (fscore[:, None, :] == fscore[:, :, None])
            & (idx[None, :] < idx[:, None])[None])
        fscore = torch.where((eq & better).any(2), neg, fscore)
        top_sc, top_f = topk(fscore, W)
        top_f = top_f.long()
        n_app = (top_f // W).to(torch.int32)
        gat = lambda key: torch.gather(
            torch.stack(fin[key], 1).reshape(B, Fn), 1, top_f)
        parent = gat("parent").long()
        app = _take(torch.stack(fin["app"], 1).reshape(B, Fn, -1),
                    top_f[..., None], 1)
        col = top_f % W
        new_ph = new_pc = new_po = None
        for k in range(K + 1):
            g_ph = _take(fin["ph"][k], col[None, :, :, None], 2)
            g_pc = _take(fin["pc"][k], col[None, :, :, None], 2)
            g_po = _take(fin["po"][k], col[..., None], 1)
            if k == 0:
                new_ph, new_pc, new_po = g_ph, g_pc, g_po
            else:
                in_k = n_app == k
                new_ph = torch.where(in_k[None, :, :, None], g_ph, new_ph)
                new_pc = torch.where(in_k[None, :, :, None], g_pc, new_pc)
                new_po = torch.where(in_k[..., None], g_po, new_po)
        par_buf = _take(bs.tokens, parent[..., None], 1)
        par_len = torch.gather(bs.lengths, 1, parent)
        pos = torch.arange(CAP, dtype=torch.int32, device=dev)[None, None, :]
        new_buf = par_buf
        for j in range(K):
            write = (j < n_app)[..., None] & (pos == (par_len + j)[..., None])
            new_buf = torch.where(write, app[:, :, j:j + 1], new_buf)
        return Beam(new_buf, torch.clamp(par_len + n_app, max=CAP), top_sc,
                    gat("h1"), gat("h2"), new_ph, new_pc, new_po)

    def follow(self, enc, known, tokens, lengths, scores) -> Beam:
        """The beam after one chunk's encodings ``enc`` [B, U, E], from the
        beam the program held before it (``tokens`` [B, W, CAP],
        ``lengths`` and ``scores`` [B, W], numpy): each live hypothesis's
        predictor state and hash worked out from its tokens by
        ``known[b]``, which then keeps those of the hypotheses the chunk
        started and ended with."""
        B, W = scores.shape
        hyps = [[known[b].get(tuple(tokens[b, w, :lengths[b, w]].tolist()))
                 if scores[b, w] > VALID_FLOOR else None for w in range(W)]
                for b in range(B)]
        beam = self.beam_of(hyps, tokens, lengths, scores)
        for t in range(enc.shape[1]):
            beam = self.beam_frame(enc[:, t], beam)
        toks, lens, sc, h1, h2 = (x.cpu().numpy() for x in beam[:5])
        for b in range(B):
            keep = {tuple(tokens[b, w, :lengths[b, w]].tolist()): hyps[b][w]
                    for w in range(W) if hyps[b][w] is not None}
            for w in range(W):
                if sc[b, w] > VALID_FLOOR:
                    keep[tuple(toks[b, w, :lens[b, w]].tolist())] = (
                        int(h1[b, w]), int(h2[b, w]), beam.pred_h[:, b, w],
                        beam.pred_c[:, b, w], beam.pred_out[b, w])
            known[b].keep(keep)
        return beam

    # ------------------------------------------- a hypothesis's state
    def bos(self) -> tuple:
        """The empty hypothesis: (hash lane 1, lane 2, h [L, H], c [L, H],
        predictor output [E]) after the start blank from zeros."""
        h, c = self._zero_pred(1)
        po, h, c = self.predictor(
            torch.full((1,), self.blank, device=self.device), h, c)
        return (_INIT1, _INIT2, h[:, 0], c[:, 0], po[0])

    def advance(self, hyp: tuple, token: int) -> tuple:
        """``hyp`` (as ``bos`` gives it) with ``token`` appended."""
        h1, h2, h, c, _ = hyp
        po, h, c = self.predictor(
            torch.tensor([token], device=self.device), h[:, None], c[:, None])
        return (_wrap32(h1 * _M1 + token + 1), _wrap32(h2 * _M2 + token + 1),
                h[:, 0], c[:, 0], po[0])

    def beam_of(self, hyps, tokens, lengths, scores) -> Beam:
        """A beam [B, W] of given hypotheses: ``tokens`` [B, W, CAP],
        ``lengths`` and ``scores`` [B, W] as numpy arrays, ``hyps[b][w]``
        the slot's state from ``bos`` / ``advance``, None for a dead slot
        (score NEG)."""
        B, W = scores.shape
        L, H = self.m["pred_layers"], self.m["pred_hidden"]
        E = self.m["encoding_dim"]
        dev, zero = self.device, torch.zeros((), device=self.device)
        h1 = torch.full((B, W), _INIT1, dtype=torch.int32)
        h2 = torch.full((B, W), _INIT2, dtype=torch.int32)
        sc = torch.full((B, W), NEG)
        ph, pc, po = [], [], []
        for b in range(B):
            for w in range(W):
                hyp = hyps[b][w]
                if hyp is None:
                    ph.append(zero.expand(L, H))
                    pc.append(zero.expand(L, H))
                    po.append(zero.expand(E))
                    continue
                h1[b, w], h2[b, w] = hyp[0], hyp[1]
                sc[b, w] = float(scores[b, w])
                ph.append(hyp[2])
                pc.append(hyp[3])
                po.append(hyp[4])
        i32 = dict(dtype=torch.int32, device=dev)
        return Beam(torch.as_tensor(tokens, **i32),
                    torch.as_tensor(lengths, **i32), sc.to(dev),
                    h1.to(dev), h2.to(dev),
                    torch.stack(ph, 1).reshape(L, B, W, H),
                    torch.stack(pc, 1).reshape(L, B, W, H),
                    torch.stack(po).reshape(B, W, E))


class Known:
    """One stream's hypotheses' reference states by token sequence: a
    sequence not kept is worked out from the longest kept prefix of it,
    the empty one always kept."""

    def __init__(self, ref: RNNTReference):
        self.ref = ref
        self.bos = ref.bos()
        self.states = {(): self.bos}
        self.computed = 0           # tokens the predictor consumed anew

    def get(self, toks: tuple) -> tuple:
        hyp = self.states.get(toks)
        if hyp is None:
            n = len(toks) - 1
            while toks[:n] not in self.states:
                n -= 1
            hyp = self.states[toks[:n]]
            for t in toks[n:]:
                hyp = self.ref.advance(hyp, int(t))
                self.computed += 1
            self.states[toks] = hyp
        return hyp

    def keep(self, states: dict) -> None:
        self.states = {(): self.bos, **states}


def _wrap32(x: int) -> int:
    """Two's-complement int32 wrap of a Python int (the card's multiply)."""
    return (x + 2**31) % 2**32 - 2**31
