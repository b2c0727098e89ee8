"""Streaming Emformer-RNNT (the English path) in PyTorch.

Counterpart of asr_streaming_tpu/models/rnnt.py (torchaudio's
``emformer_rnnt_base(num_symbols=4097)`` geometry):

  transcriber: mel(80) -> input_linear(80->128) -> time reduction x4 (512)
               -> 20-layer streaming Emformer (segment 4, rc 1, lc 30, no
               memory) -> linear 512->1024 + LayerNorm
  predictor:   embedding(512) -> layer-normed LSTM stack -> linear -> LN
  joiner:      ReLU(enc + pred) -> linear(V)

The transcriber's Emformer is the fixed-shape masked step the Vietnamese
path uses (``max_memory_size=0``): on the card, kernel A
(``ops/emformer_stack.py``).  Greedy decoding runs batched over streams on
the device: the JAX package's ``lax.scan`` over frames and ``fori_loop``
over symbol expansions are Python loops here with the same masked updates.
``RNNTBeamDecoder`` is the host-side beam (width 10), the parity oracle of
the device-batched beam in ``models/rnnt_beam.py``.

The predictor and the joiner run in float32 (TF32 is off package-wide): a
flipped argmax or beam order is a different transcript.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.emformer import (
    EmformerConfig, EmformerState, _layer_norm, _linear_init,
    emformer_stream_step, init_emformer_params, init_emformer_state,
)
from asr_streaming_tpu_torch.models.encoder import _time_reduction


@dataclasses.dataclass(frozen=True)
class RNNTConfig:
    n_mels: int = 80
    input_linear_dim: int = 128     # pre-reduction dim (x4 -> d_model)
    d_model: int = 512
    encoding_dim: int = 1024        # transcriber/predictor output dim
    vocab_size: int = 4097
    blank: int = 4096
    pred_embed_dim: int = 512
    pred_hidden: int = 512
    # torchaudio emformer_rnnt_base: 3 LSTM layers with layer-normed
    # custom cells (eps 1e-3); converted checkpoints need exactly this
    pred_layers: int = 3
    lstm_layer_norm: bool = True
    lstm_ln_eps: float = 1e-3
    max_symbols_per_frame: int = 4
    emformer: EmformerConfig = dataclasses.field(
        default_factory=lambda: EmformerConfig(
            d_model=512, num_heads=8, ffn_dim=2048, num_layers=20,
            segment_length=4, left_context_length=30,
            right_context_length=1, max_memory_size=0, tanh_on_mem=True))

    @classmethod
    def tiny(cls, vocab_size: int = 32) -> "RNNTConfig":
        return cls(
            n_mels=16, input_linear_dim=16, d_model=64, encoding_dim=48,
            vocab_size=vocab_size, blank=vocab_size - 1, pred_embed_dim=24,
            pred_hidden=32, pred_layers=1,
            emformer=EmformerConfig(
                d_model=64, num_heads=4, ffn_dim=96, num_layers=2,
                segment_length=4, left_context_length=8,
                right_context_length=1, max_memory_size=0))


def transcriber_segment_frames(audio) -> int:
    """Emformer segment length (frames after the x4 time reduction) of an
    EN audio geometry: segment_size mel frames per chunk / stride 4.  The
    standard EN geometry (segment_size 16) gives 4, the reduced one
    (segment_size 8) gives 2."""
    return max(1, audio.segment_size // 4)


def rnnt_config_for_audio(base: "RNNTConfig", audio) -> "RNNTConfig":
    """Re-derive the transcriber's streaming segment from the serving
    audio geometry, so model and stream machine stay in lockstep."""
    seg = transcriber_segment_frames(audio)
    if base.emformer.segment_length == seg:
        return base
    return dataclasses.replace(
        base, emformer=dataclasses.replace(base.emformer,
                                           segment_length=seg))


class PredictorState(NamedTuple):
    h: torch.Tensor   # [layers, B, H]
    c: torch.Tensor   # [layers, B, H]


class RNNTStreamState(NamedTuple):
    encoder: EmformerState
    predictor: PredictorState
    last_token: torch.Tensor   # [B] int32


def init_rnnt_params(gen: torch.Generator, cfg: RNNTConfig,
                     device=None) -> dict:
    """Random weights drawn on the CPU from ``gen`` (the JAX package's
    distributions), placed on ``device`` (default CUDA; raises without
    it).  The tree and layouts are the JAX package's, so its ``.npz``
    checkpoints load unchanged."""
    device = resolve_device(device)
    w_in, _ = _linear_init(gen, cfg.n_mels, cfg.input_linear_dim)
    w_out, b_out = _linear_init(gen, cfg.d_model, cfg.encoding_dim)
    emb = torch.randn((cfg.vocab_size, cfg.pred_embed_dim), generator=gen) \
        * (cfg.pred_embed_dim ** -0.5)
    H = cfg.pred_hidden
    lstms = []
    for i in range(cfg.pred_layers):
        in_dim = cfg.pred_embed_dim if i == 0 else H
        wi, bi = _linear_init(gen, in_dim, 4 * H)
        wh, bh = _linear_init(gen, H, 4 * H)
        lstms.append({"wi": wi, "bi": bi, "wh": wh, "bh": bh,
                      "g_scale": torch.ones(4 * H),
                      "g_bias": torch.zeros(4 * H),
                      "c_scale": torch.ones(H), "c_bias": torch.zeros(H)})
    w_pred, b_pred = _linear_init(gen, H, cfg.encoding_dim)
    w_joint, b_joint = _linear_init(gen, cfg.encoding_dim, cfg.vocab_size)
    E = cfg.encoding_dim

    def dev(tree):
        if isinstance(tree, dict):
            return {k: dev(v) for k, v in tree.items()}
        return tree.to(device)

    return dev({
        "input_linear": {"w": w_in},
        "emformer": init_emformer_params(gen, cfg.emformer, "cpu"),
        "enc_out": {"w": w_out, "b": b_out, "ln_scale": torch.ones(E),
                    "ln_bias": torch.zeros(E)},
        "predictor": {
            "embedding": emb,
            "input_ln_scale": torch.ones(cfg.pred_embed_dim),
            "input_ln_bias": torch.zeros(cfg.pred_embed_dim),
            # the layers' dicts stacked along dim 0, as the JAX tree is
            "lstm": {k: torch.stack([l[k] for l in lstms])
                     for k in lstms[0]},
            "out_w": w_pred, "out_b": b_pred,
            "ln_scale": torch.ones(E), "ln_bias": torch.zeros(E),
        },
        "joiner": {"w": w_joint, "b": b_joint},
    })


def init_predictor_state(cfg: RNNTConfig, batch_size: int,
                         device=None) -> PredictorState:
    shape = (cfg.pred_layers, batch_size, cfg.pred_hidden)
    device = resolve_device(device)
    return PredictorState(h=torch.zeros(shape, device=device),
                          c=torch.zeros(shape, device=device))


def init_rnnt_state(cfg: RNNTConfig, batch_size: int,
                    device=None) -> RNNTStreamState:
    """Fresh stream state.  ``predictor`` holds the LSTM state from BEFORE
    consuming ``last_token`` (zeros before the BOS blank): see
    rnnt_greedy_stream_step for why that convention survives chunk
    boundaries."""
    device = resolve_device(device)
    return RNNTStreamState(
        encoder=init_emformer_state(cfg.emformer, batch_size, device),
        predictor=init_predictor_state(cfg, batch_size, device),
        last_token=torch.full((batch_size,), cfg.blank, dtype=torch.int32,
                              device=device))


# ---------------------------------------------------------------- components

def transcriber_step(params: dict, cfg: RNNTConfig, feats: torch.Tensor,
                     state: EmformerState
                     ) -> Tuple[torch.Tensor, EmformerState]:
    """feats: [B, T_mel, n_mels] reducing to segment + rc frames.
    Returns (encodings [B, segment, encoding_dim] f32, state).  The
    Emformer step takes no reset/advance masks: the serving ticks reset
    the state before the step and hold it after."""
    x = torch.matmul(feats, params["input_linear"]["w"])
    x = _time_reduction(x, 4)
    em = cfg.emformer
    assert x.shape[1] == em.segment_length + em.right_context_length, \
        tuple(x.shape)
    enc, new_state = emformer_stream_step(params["emformer"], em, x, state)
    p = params["enc_out"]
    enc = _layer_norm(torch.matmul(enc, p["w"]) + p["b"], p["ln_scale"],
                      p["ln_bias"])
    return enc, new_state


def predictor_step(params: dict, tokens: torch.Tensor, state: PredictorState,
                   cfg: Optional[RNNTConfig] = None
                   ) -> Tuple[torch.Tensor, PredictorState]:
    """One predictor step (torchaudio _Predictor semantics, one timestep).

    tokens: [B] integer -> (out [B, encoding_dim], state).

    torchaudio's _CustomLSTM cell (gate order i, f, g, o):
        gates = g_norm(x2g(x) + p2g(h))
        c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
        c     = c_norm(c)          # the CARRIED cell is the normed one
        h     = sigmoid(o) * tanh(c)
    ``cfg=None`` means layer norm on with eps 1e-3 (emformer_rnnt_base).
    """
    use_ln = cfg is None or cfg.lstm_layer_norm
    eps = 1e-3 if cfg is None else cfg.lstm_ln_eps
    p = params["predictor"]
    x = p["embedding"][tokens.long()]
    x = _layer_norm(x, p["input_ln_scale"], p["input_ln_bias"])
    lstm = p["lstm"]
    hs, cs = [], []
    for i in range(state.h.shape[0]):
        gates = (torch.matmul(x, lstm["wi"][i]) + lstm["bi"][i]
                 + torch.matmul(state.h[i], lstm["wh"][i]) + lstm["bh"][i])
        if use_ln:
            gates = _layer_norm(gates, lstm["g_scale"][i], lstm["g_bias"][i],
                                eps=eps)
        ii, ff, gg, oo = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(ff) * state.c[i] + torch.sigmoid(ii) * torch.tanh(gg)
        if use_ln:
            c = _layer_norm(c, lstm["c_scale"][i], lstm["c_bias"][i], eps=eps)
        h = torch.sigmoid(oo) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        x = h
    out = _layer_norm(torch.matmul(x, p["out_w"]) + p["out_b"], p["ln_scale"],
                      p["ln_bias"])
    return out, PredictorState(h=torch.stack(hs), c=torch.stack(cs))


def joiner(params: dict, enc: torch.Tensor, pred: torch.Tensor
           ) -> torch.Tensor:
    """ReLU(enc + pred) @ W -> logits (torchaudio joiner semantics)."""
    return torch.matmul(torch.relu(enc + pred), params["joiner"]["w"]) \
        + params["joiner"]["b"]


# ---------------------------------------------------- device greedy decoding

class GreedyChunkOutput(NamedTuple):
    tokens: torch.Tensor     # [B, segment * max_symbols] int32 (blank = none)
    n_emitted: torch.Tensor  # [B] int32
    encodings: torch.Tensor  # [B, segment, encoding_dim] transcriber outputs
    state: RNNTStreamState


def _hold_encoder(active: torch.Tensor, new: EmformerState,
                  old: EmformerState) -> EmformerState:
    """``new`` where active, ``old`` elsewhere ([L, B, ...] state tensors,
    the [B] length)."""
    m4 = active.view(1, -1, 1, 1)
    return EmformerState(mem=torch.where(m4, new.mem, old.mem),
                         lc_k=torch.where(m4, new.lc_k, old.lc_k),
                         lc_v=torch.where(m4, new.lc_v, old.lc_v),
                         length=torch.where(active, new.length, old.length))


def rnnt_greedy_stream_step(params: dict, cfg: RNNTConfig,
                            feats: torch.Tensor, state: RNNTStreamState,
                            active: Optional[torch.Tensor] = None
                            ) -> GreedyChunkOutput:
    """Batched greedy RNNT decode of one chunk, on the device.

    Per frame: up to max_symbols_per_frame expansions; a stream whose
    argmax is blank stops expanding (masked updates keep shapes fixed).
    """
    B = feats.shape[0]
    K = cfg.max_symbols_per_frame
    dev = feats.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)

    enc, enc_state = transcriber_step(params, cfg, feats, state.encoder)
    # Predictor-state convention: state.predictor is the LSTM state from
    # BEFORE consuming state.last_token (zeros before the BOS blank), so
    # re-consuming last_token here reproduces the exact predictor output
    # the previous chunk's final emission saw: the joiner is conditioned
    # on [..., last] exactly once.  Storing the AFTER-consume state and
    # re-consuming on the next chunk would condition on [..., last, last],
    # and emissions would die after the first chunk that produced a token.
    pred_stored = state.predictor
    last_token = state.last_token
    pred_out, pred_next = predictor_step(params, last_token, pred_stored)

    frames = []
    for t in range(enc.shape[1]):
        enc_t = enc[:, t]
        toks = torch.full((B, K), cfg.blank, dtype=torch.int32, device=dev)
        alive = torch.ones((B,), dtype=torch.bool, device=dev)
        for k in range(K):
            logits = joiner(params, enc_t, pred_out)
            tok = torch.argmax(logits, -1).to(torch.int32)
            emit = alive & (tok != cfg.blank) & active
            toks[:, k] = torch.where(emit, tok, torch.full_like(tok, cfg.blank))
            # consume the new token from the after-everything state;
            # remember that state as the new "before-last" for emitters
            new_pred_out, new_next = predictor_step(
                params, torch.where(emit, tok, last_token), pred_next)
            e3 = emit.view(1, -1, 1)
            pred_stored = PredictorState(
                h=torch.where(e3, pred_next.h, pred_stored.h),
                c=torch.where(e3, pred_next.c, pred_stored.c))
            pred_next = PredictorState(
                h=torch.where(e3, new_next.h, pred_next.h),
                c=torch.where(e3, new_next.c, pred_next.c))
            pred_out = torch.where(emit[:, None], new_pred_out, pred_out)
            last_token = torch.where(emit, tok, last_token)
            alive = emit
        frames.append(toks)

    tokens = torch.stack(frames, 1).reshape(B, -1)              # [B, U*K]
    n_emitted = (tokens != cfg.blank).sum(1).to(torch.int32)

    # inactive streams keep their old state
    a3 = active.view(1, -1, 1)
    new_state = RNNTStreamState(
        encoder=_hold_encoder(active, enc_state, state.encoder),
        predictor=PredictorState(
            h=torch.where(a3, pred_stored.h, state.predictor.h),
            c=torch.where(a3, pred_stored.c, state.predictor.c)),
        last_token=torch.where(active, last_token, state.last_token))
    return GreedyChunkOutput(tokens=tokens, n_emitted=n_emitted,
                             encodings=enc, state=new_state)


# ------------------------------------------------------- host beam decoding

@dataclasses.dataclass
class Hypothesis:
    tokens: List[int]
    score: float
    pred_state: Any       # PredictorState with B=1
    pred_out: np.ndarray  # [encoding_dim]


class RNNTBeamDecoder:
    """Host-side beam search (width 10), carrying the hypotheses across
    chunks: one predictor or joiner call per hypothesis expansion.  The
    parity oracle of models/rnnt_beam.py and the finals' rescorer."""

    def __init__(self, params: dict, cfg: RNNTConfig, beam_width: int = 10):
        self.params = params
        self.cfg = cfg
        self.beam_width = beam_width
        self.device = params["joiner"]["w"].device

    def _pred(self, tokens, state):
        with torch.no_grad():
            return predictor_step(self.params, tokens, state)

    def _join(self, enc, pred):
        with torch.no_grad():
            return torch.log_softmax(joiner(self.params, enc, pred), -1)

    def init_hypothesis(self) -> Hypothesis:
        state = init_predictor_state(self.cfg, 1, self.device)
        out, state = self._pred(
            torch.tensor([self.cfg.blank], device=self.device), state)
        return Hypothesis(tokens=[], score=0.0, pred_state=state,
                          pred_out=out[0].cpu().numpy())

    def step_chunk(self, encodings: np.ndarray,
                   hypos: Optional[List[Hypothesis]] = None
                   ) -> List[Hypothesis]:
        """Advance the beam over one chunk's encodings [U, D]."""
        if not hypos:
            hypos = [self.init_hypothesis()]
        cfg = self.cfg
        dev = self.device
        for t in range(encodings.shape[0]):
            enc_t = torch.from_numpy(
                np.asarray(encodings[t], np.float32)).to(dev)[None]
            finished: List[Hypothesis] = []
            active = list(hypos)
            for _ in range(cfg.max_symbols_per_frame + 1):
                if not active:
                    break
                scored = []
                for h in active:
                    logp = self._join(
                        enc_t, torch.from_numpy(h.pred_out).to(dev)[None]
                    )[0].cpu().numpy()
                    # blank: hypothesis moves to the next frame
                    finished.append(Hypothesis(
                        h.tokens, h.score + float(logp[cfg.blank]),
                        h.pred_state, h.pred_out))
                    # beam width can exceed the vocab (tiny test configs)
                    k = min(self.beam_width, len(logp))
                    top = np.argpartition(logp, -k)[-k:]
                    for tok in top:
                        tok = int(tok)
                        if tok == cfg.blank:
                            continue
                        scored.append((h.score + float(logp[tok]), h, tok))
                scored.sort(key=lambda x: -x[0])
                best_finished = max(h.score for h in finished)
                expanded = []
                for score, h, tok in scored[:self.beam_width]:
                    if score < best_finished - 10.0:
                        continue
                    out, st = self._pred(torch.tensor([tok], device=dev),
                                         h.pred_state)
                    expanded.append(Hypothesis(
                        h.tokens + [tok], score, st, out[0].cpu().numpy()))
                active = expanded
            finished.sort(key=lambda h: -h.score)
            # dedupe by token sequence, keep best
            seen, hypos = set(), []
            for h in finished:
                key = tuple(h.tokens)
                if key not in seen:
                    seen.add(key)
                    hypos.append(h)
                if len(hypos) >= self.beam_width:
                    break
        return hypos


def make_rnnt_rescorer(params: dict, cfg: RNNTConfig,
                       pieces: Sequence[str], beam_width: int = 10):
    """FinalSegment -> transcript via beam search over the segment's
    device-buffered transcriber encodings (greedy partials, beam finals)."""
    beam = RNNTBeamDecoder(params, cfg, beam_width=beam_width)

    def rescore(segment) -> str:
        enc = np.asarray(segment.emission[:segment.length], np.float32)
        if not len(enc):
            return ""
        hypos = beam.step_chunk(enc)
        return detokenize_pieces(hypos[0].tokens, pieces, lstrip=False)

    return rescore


def detokenize_pieces(tokens: Sequence[int], pieces: Sequence[str],
                      lstrip: bool = False) -> str:
    """SentencePiece-style detokenization: pieces starting with '▁' begin
    a new word."""
    text = "".join(pieces[t] for t in tokens if 0 <= t < len(pieces))
    text = text.replace("▁", " ")
    return text.lstrip() if lstrip else text
