"""In-repo n-gram language-model library.

Copy of asr_streaming_tpu/text/ngram_lm.py (pure Python).  Compact
re-design of the reference's NLTK-derived n-gram stack
(reference: streaming_decoder/lightspeech/layers/ngram.py:1-730 —
FreqDist / NgramCounter / Vocabulary / smoothing / NgramLanguageModel):
vocabulary with UNK cutoff, n-gram counting, and MLE / Witten-Bell /
Kneser-Ney interpolated scoring with fit / score / logscore / perplexity.
Powers the OOV recognizer (text/oov.py) and any host-side LM work that
doesn't warrant the ARPA-file beam decoder.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PAD_LEFT = "<s>"
PAD_RIGHT = "</s>"
UNK = "<UNK>"


def pad_sequence(seq: Sequence[str], n: int,
                 left: bool = True, right: bool = True) -> List[str]:
    out = list(seq)
    if n > 1:
        if left:
            out = [PAD_LEFT] * (n - 1) + out
        if right:
            out = out + [PAD_RIGHT] * (n - 1)
    return out


def ngrams(seq: Sequence[str], n: int) -> Iterable[Tuple[str, ...]]:
    for i in range(len(seq) - n + 1):
        yield tuple(seq[i:i + n])


def everygrams(seq: Sequence[str], max_len: int
               ) -> Iterable[Tuple[str, ...]]:
    """All n-grams for n = 1..max_len (reference ngram.py everygrams)."""
    for n in range(1, max_len + 1):
        yield from ngrams(seq, n)


class Vocabulary:
    """Count-cutoff vocabulary mapping rare words to UNK."""

    def __init__(self, words: Optional[Iterable[str]] = None,
                 unk_cutoff: int = 1):
        self.unk_cutoff = unk_cutoff
        self.counts = Counter(words or ())

    def update(self, words: Iterable[str]) -> None:
        self.counts.update(words)

    def __contains__(self, word: str) -> bool:
        return self.counts[word] >= self.unk_cutoff

    def lookup(self, word: str) -> str:
        return word if word in self else UNK

    def __len__(self) -> int:
        return sum(1 for w, c in self.counts.items()
                   if c >= self.unk_cutoff) + 1   # + UNK


class NgramCounter:
    """order -> context(tuple) -> Counter(word)."""

    def __init__(self):
        self.by_order: Dict[int, Dict[tuple, Counter]] = defaultdict(
            lambda: defaultdict(Counter))

    def update(self, grams: Iterable[Tuple[str, ...]]) -> None:
        for gram in grams:
            n = len(gram)
            self.by_order[n][tuple(gram[:-1])][gram[-1]] += 1

    def context_counts(self, context: Tuple[str, ...]) -> Counter:
        return self.by_order.get(len(context) + 1, {}).get(tuple(context),
                                                           Counter())


class NgramLanguageModel:
    """Base n-gram LM with fit / score / logscore / entropy / perplexity
    (reference NgramLanguageModel semantics)."""

    def __init__(self, order: int):
        self.order = order
        self.counts = NgramCounter()
        self.vocab = Vocabulary()

    def fit(self, text_ngrams: Iterable[Iterable[Tuple[str, ...]]],
            vocabulary_words: Optional[Iterable[str]] = None) -> None:
        if vocabulary_words is not None:
            self.vocab.update(vocabulary_words)
        for sent in text_ngrams:
            sent = list(sent)
            for gram in sent:
                if len(gram) == 1:
                    self.vocab.update(gram)
            self.counts.update(sent)

    def context_counts(self, context: Tuple[str, ...]) -> Counter:
        return self.counts.context_counts(context)

    # --------------------------------------------------------------- scoring

    def unmasked_score(self, word: str, context: Tuple[str, ...]) -> float:
        raise NotImplementedError

    def score(self, word: str, context: Tuple[str, ...] = ()) -> float:
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        return self.unmasked_score(word, context)

    def logscore(self, word: str, context: Tuple[str, ...] = ()) -> float:
        s = self.score(word, context)
        return math.log2(s) if s > 0 else float("-inf")

    def entropy(self, text_ngrams: Iterable[Tuple[str, ...]]) -> float:
        logs = [self.logscore(g[-1], g[:-1]) for g in text_ngrams]
        return -sum(logs) / len(logs) if logs else 0.0

    def perplexity(self, text_ngrams: Iterable[Tuple[str, ...]]) -> float:
        return 2.0 ** self.entropy(list(text_ngrams))


class MLE(NgramLanguageModel):
    def unmasked_score(self, word, context):
        counts = self.context_counts(context)
        total = sum(counts.values())
        return counts[word] / total if total else 0.0


class WittenBellInterpolated(NgramLanguageModel):
    """Witten-Bell interpolated smoothing (the class the reference's OOV
    adapter imports but ngram.py never defined — implemented here)."""

    def unmasked_score(self, word, context):
        if not context:
            counts = self.context_counts(())
            total = sum(counts.values())
            if total == 0:
                return 1.0 / max(len(self.vocab), 1)
            # interpolate unigram with uniform for unseen mass
            gamma = len(counts) / (len(counts) + total)
            return ((1 - gamma) * counts[word] / total
                    + gamma / max(len(self.vocab), 1))
        counts = self.context_counts(context)
        total = sum(counts.values())
        if total == 0:
            return self.unmasked_score(word, context[1:])
        unique = len(counts)
        gamma = unique / (unique + total)
        return ((1 - gamma) * counts[word] / total
                + gamma * self.unmasked_score(word, context[1:]))


class KneserNeyInterpolated(NgramLanguageModel):
    """Interpolated Kneser-Ney with absolute discounting."""

    def __init__(self, order: int, discount: float = 0.1):
        super().__init__(order)
        self.discount = discount

    def _continuation_counts(self, word: str) -> Tuple[int, int]:
        """(#distinct bigram contexts word appears in, #distinct bigrams)."""
        bigrams = self.counts.by_order.get(2, {})
        appears = sum(1 for ctx, c in bigrams.items() if c[word] > 0)
        total = sum(len(c) for c in bigrams.values())
        return appears, total

    def unmasked_score(self, word, context):
        if not context:
            appears, total = self._continuation_counts(word)
            if total == 0:
                counts = self.context_counts(())
                tot = sum(counts.values())
                return counts[word] / tot if tot else \
                    1.0 / max(len(self.vocab), 1)
            return appears / total
        counts = self.context_counts(context)
        total = sum(counts.values())
        if total == 0:
            return self.unmasked_score(word, context[1:])
        unique = len(counts)
        discounted = max(counts[word] - self.discount, 0.0) / total
        lam = self.discount * unique / total
        return discounted + lam * self.unmasked_score(word, context[1:])
