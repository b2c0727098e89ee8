"""Lexicon-constrained CTC beam search with n-gram LM rescoring.

Host-side re-implementation of the reference's flashlight-text
``ctc_decoder`` + KenLM stack (reference: lightspeech/models/
recognition.py:220-300; invocation streaming_server.py:511-513), which the
reference exercises once per endpointed segment — latency-insensitive host
work, so it lives off-device by design (the emission leaves TPU once per
final).  Semantics mirrored:

  * lexicon trie over subword tokens; entries terminate in the silence
    token '|' (reference lexicon.txt format: "word<TAB>sub sub |"),
  * beam_size / beam_size_token / beam_threshold / lm_weight / word_score
    hyperparameters (reference config asr-online.yaml:18-27),
  * word-boundary LM scoring with backoff ARPA n-gram,
  * word alignments with (timestep + offset) * 0.04 s timestamps and
    exp(score / (n_tokens + 1)) confidence
    (reference recognition.py:267-300).

A C++ implementation with the same API lives in native/ for production
throughput; this module is the reference-correct fallback and its test
oracle.

Copied from asr_streaming_tpu/decode/beam.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from asr_streaming_tpu_torch.decode.greedy import BLANK_ID, SILENCE_ID, FRAME_SECONDS

LOG10 = math.log(10.0)


# ------------------------------------------------------------------- ARPA LM

class ArpaLM:
    """Backoff n-gram LM from an ARPA file.  Scores in natural log."""

    def __init__(self, order: int,
                 ngrams: Dict[Tuple[str, ...], Tuple[float, float]]):
        self.order = order
        self.ngrams = ngrams      # tuple(words) -> (logprob_e, backoff_e)

    @classmethod
    def from_arpa(cls, path: str) -> "ArpaLM":
        ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        order = 1
        current_n = 0
        with open(path, encoding="utf-8", errors="replace") as f:
            for raw in f:
                line = raw.strip()
                if line.startswith("\\") and "-grams:" in line:
                    current_n = int(line[1:line.index("-")])
                    order = max(order, current_n)
                    continue
                if not line or line.startswith("\\") or line.startswith(
                        "ngram "):
                    continue
                if current_n == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                logp = float(parts[0]) * LOG10
                words = tuple(parts[1].split(" "))
                backoff = float(parts[2]) * LOG10 if len(parts) > 2 else 0.0
                ngrams[words] = (logp, backoff)
        return cls(order, ngrams)

    def start_state(self) -> Tuple[str, ...]:
        return ("<s>",)

    def score(self, state: Tuple[str, ...], word: str
              ) -> Tuple[float, Tuple[str, ...]]:
        """Backoff-scored logP(word | state); returns (logp, next_state)."""
        logp = self._backoff_score(state + (word,))
        next_state = (state + (word,))[-(self.order - 1):] \
            if self.order > 1 else ()
        return logp, next_state

    def finish(self, state: Tuple[str, ...]) -> float:
        return self._backoff_score(state + ("</s>",))

    def _backoff_score(self, words: Tuple[str, ...]) -> float:
        words = words[-self.order:]
        while len(words) > 1:
            hit = self.ngrams.get(words)
            if hit is not None:
                return hit[0]
            context = words[:-1]
            ctx_hit = self.ngrams.get(context)
            backoff = ctx_hit[1] if ctx_hit is not None else 0.0
            return backoff + self._backoff_score(words[1:])
        hit = self.ngrams.get(words)
        if hit is not None:
            return hit[0]
        unk = self.ngrams.get(("<unk>",))
        return unk[0] if unk is not None else -23.0   # ~1e-10


# -------------------------------------------------------------- lexicon trie

class TrieNode:
    __slots__ = ("children", "words")

    def __init__(self):
        self.children: Dict[int, TrieNode] = {}
        self.words: List[str] = []


def build_trie(lexicon: Dict[str, Sequence[str]],
               vocab: Sequence[str]) -> TrieNode:
    index = {tok: i for i, tok in enumerate(vocab)}
    root = TrieNode()
    for word, tokens in lexicon.items():
        node = root
        ok = True
        for tok in tokens:
            idx = index.get(tok)
            if idx is None:
                ok = False
                break
            node = node.children.setdefault(idx, TrieNode())
        if ok:
            node.words.append(word)
    return root


# ------------------------------------------------------------- beam decoding

@dataclasses.dataclass
class _Emit:
    """Backpointer chain node: one emitted token (or committed word)."""
    parent: Optional["_Emit"]
    token: int
    timestep: int
    word: Optional[str] = None


@dataclasses.dataclass
class _Hyp:
    node: TrieNode
    lm_state: Tuple[str, ...]
    last_token: int
    score: float           # am + lm_weight*lm + word_score*n_words
    am_score: float
    emits: Optional[_Emit]
    n_words: int


@dataclasses.dataclass
class BeamResult:
    transcript: str
    words: List[str]
    tokens: List[int]
    timesteps: List[int]
    score: float
    alignment: List[dict]


class LexiconBeamDecoder:
    def __init__(self, vocab: Sequence[str],
                 lexicon: Dict[str, Sequence[str]],
                 lm: Optional[ArpaLM] = None,
                 lm_weight: float = 1.0, beam_size: int = 50,
                 beam_size_token: int = 5, beam_threshold: float = 50.0,
                 word_score: float = 0.5, blank: int = BLANK_ID,
                 silence: int = SILENCE_ID,
                 frame_seconds: float = FRAME_SECONDS):
        self.vocab = list(vocab)
        self.trie = build_trie(lexicon, vocab)
        self.lm = lm
        self.lm_weight = lm_weight
        self.beam_size = beam_size
        self.beam_size_token = beam_size_token
        self.beam_threshold = beam_threshold
        self.word_score = word_score
        self.blank = blank
        self.silence = silence
        self.frame_seconds = frame_seconds

    def decode(self, emission: np.ndarray, offset: int = 0) -> BeamResult:
        """emission: [T, V] log-probs.  Returns the best hypothesis with
        reference-format word alignment."""
        T, V = emission.shape
        lm_start = self.lm.start_state() if self.lm else ()
        hyps: Dict[tuple, _Hyp] = {}
        root = self.trie
        h0 = _Hyp(node=root, lm_state=lm_start, last_token=self.blank,
                  score=0.0, am_score=0.0, emits=None, n_words=0)
        hyps[(id(root), lm_start, self.blank)] = h0

        for t in range(T):
            frame = emission[t]
            top_tokens = np.argpartition(
                frame, -min(self.beam_size_token, V)
            )[-self.beam_size_token:]
            new_hyps: Dict[tuple, _Hyp] = {}

            def push(key, cand: _Hyp):
                old = new_hyps.get(key)
                if old is None or cand.score > old.score:
                    new_hyps[key] = cand

            for h in hyps.values():
                # 1) blank: stay
                s = frame[self.blank]
                push((id(h.node), h.lm_state, self.blank),
                     _Hyp(h.node, h.lm_state, self.blank,
                          h.score + s, h.am_score + s, h.emits, h.n_words))
                # 2) repeat last non-blank token: stay (CTC collapse)
                if h.last_token != self.blank:
                    s = frame[h.last_token]
                    push((id(h.node), h.lm_state, h.last_token),
                         _Hyp(h.node, h.lm_state, h.last_token,
                              h.score + s, h.am_score + s, h.emits,
                              h.n_words))
                # 3) advance with a new token along the trie
                for tok in top_tokens:
                    tok = int(tok)
                    if tok == self.blank or tok == h.last_token:
                        continue
                    child = h.node.children.get(tok)
                    if child is None:
                        continue
                    s = frame[tok]
                    emit = _Emit(h.emits, tok, t)
                    if child.words:
                        # word completion(s): commit word, back to root
                        for word in child.words:
                            if self.lm is not None:
                                lm_s, lm_next = self.lm.score(h.lm_state,
                                                              word)
                            else:
                                lm_s, lm_next = 0.0, h.lm_state
                            score = (h.score + s
                                     + self.lm_weight * lm_s
                                     + self.word_score)
                            wemit = _Emit(emit, -1, t, word=word)
                            push((id(root), lm_next, tok),
                                 _Hyp(root, lm_next, tok, score,
                                      h.am_score + s, wemit, h.n_words + 1))
                    if child.children:
                        push((id(child), h.lm_state, tok),
                             _Hyp(child, h.lm_state, tok, h.score + s,
                                  h.am_score + s, emit, h.n_words))

            # prune: threshold + beam
            if not new_hyps:
                break
            ranked = sorted(new_hyps.values(), key=lambda h: -h.score)
            cutoff = ranked[0].score - self.beam_threshold
            pruned = [h for h in ranked[:self.beam_size] if h.score >= cutoff]
            hyps = {}
            for h in pruned:
                hyps[(id(h.node), h.lm_state, h.last_token)] = h

        # finish: prefer completed-word hypotheses; add LM </s>
        best, best_score = None, -math.inf
        for h in hyps.values():
            score = h.score
            if self.lm is not None:
                score += self.lm_weight * self.lm.finish(h.lm_state)
            if h.node is not self.trie:
                score -= 1e4     # dangling partial word: strongly discourage
            if score > best_score:
                best, best_score = h, score
        if best is None:
            return BeamResult("", [], [], [], -math.inf, [])

        tokens, timesteps, words = [], [], []
        e = best.emits
        while e is not None:
            if e.word is not None:
                words.append(e.word)
            else:
                tokens.append(e.token)
                timesteps.append(e.timestep)
            e = e.parent
        tokens.reverse()
        timesteps.reverse()
        words.reverse()

        alignment = self._alignment(tokens, timesteps, best_score, offset)
        return BeamResult(
            transcript=" ".join(words), words=words, tokens=tokens,
            timesteps=timesteps, score=best_score, alignment=alignment)

    def _alignment(self, tokens: List[int], timesteps: List[int],
                   score: float, offset: int) -> List[dict]:
        """Group tokens between silences into words with timestamps
        (reference recognition.py:267-300)."""
        confidence = round(math.exp(score / (len(tokens) + 1)), 2) \
            if tokens else 0.0
        alignment = []
        item = {"beg": 0.0, "end": 0.0, "word": [], "confidence": 0.0}
        toks = [self.vocab[i] for i in tokens]
        sil = self.vocab[self.silence]
        for i, tok in enumerate(toks):
            if (i == 0 and tok != sil) or (i != 0 and toks[i - 1] == sil):
                item["beg"] = round(
                    (timesteps[i] + offset) * self.frame_seconds, 2)
            if tok != sil:
                item["word"].append(tok)
            elif i != 0:
                item["end"] = round(
                    (timesteps[i] + offset) * self.frame_seconds, 2)
                item["word"] = "".join(item["word"])
                item["confidence"] = confidence
                alignment.append(item)
                item = {"beg": 0.0, "end": 0.0, "word": [],
                        "confidence": 0.0}
        return [a for a in alignment if a["word"] != ""]


def make_rescorer(vocab: Sequence[str], lexicon_path: str, lm_path: str,
                  **kwargs):
    """Build a FinalSegment -> alignment callable for the server."""
    from asr_streaming_tpu_torch.text.vocab import load_lexicon

    from asr_streaming_tpu_torch.decode.kenlm_binary import load_lm

    lexicon = load_lexicon(lexicon_path)
    # text ARPA or KenLM PROBING binary (the reference's production LM
    # asset, `lm: 3gram.bin` asr-online.yaml:22) — sniffed by magic
    lm = load_lm(lm_path) if lm_path else None
    decoder = LexiconBeamDecoder(vocab, lexicon, lm, **kwargs)

    def rescore(segment) -> List[dict]:
        emission = segment.emission[:segment.length]
        return decoder.decode(emission, offset=segment.offset).alignment

    return rescore
