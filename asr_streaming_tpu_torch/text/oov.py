"""OOV (out-of-vocabulary) word recognizer.

Copy of asr_streaming_tpu/text/oov.py (pure Python), on this package's
text/ngram_lm.py.  Working implementation of the feature the reference
*intended*: its ``OOVRecognizer`` (reference:
streaming_decoder_v1/lightspeech/modules/adapter.py:1-139) imports
symbols its ngram library never defined (``WittenBellInterpolated``,
``Sym``) and is dead code (SURVEY.md §2.6 T5).
Capabilities re-created here:

  * a character-level Witten-Bell LM over known OOV words (wrapped in
    << >> markers) that biases decoding toward enrollable names/terms,
  * SymSpell-style spelling correction of decoded OOV spans against the
    enrolled OOV dictionary (delete-distance index),
  * sound-like substitution: replace phonetic transliterations with the
    canonical OOV surface form.

OOV file format: one entry per line, ``word | soundlike1, soundlike2``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from asr_streaming_tpu_torch.text.ngram_lm import (
    WittenBellInterpolated, everygrams,
)

START_OOV, END_OOV = "<<", ">>"


class SpellIndex:
    """SymSpell-style delete-distance index for candidate lookup."""

    def __init__(self, max_edit_distance: int = 2):
        self.max_ed = max_edit_distance
        self.index: Dict[str, set] = {}
        self.words: Dict[str, int] = {}

    def _deletes(self, word: str, depth: int) -> set:
        out = {word}
        frontier = {word}
        for _ in range(depth):
            nxt = set()
            for w in frontier:
                for i in range(len(w)):
                    nxt.add(w[:i] + w[i + 1:])
            out |= nxt
            frontier = nxt
        return out

    def add(self, word: str, count: int = 1) -> None:
        self.words[word] = self.words.get(word, 0) + count
        for d in self._deletes(word, self.max_ed):
            self.index.setdefault(d, set()).add(word)

    def lookup(self, query: str) -> Optional[str]:
        """Best dictionary word within max edit distance (frequency-then-
        distance ranked)."""
        candidates = set()
        for d in self._deletes(query, self.max_ed):
            candidates |= self.index.get(d, set())
        best, best_key = None, None
        for cand in candidates:
            dist = _levenshtein(query, cand, self.max_ed)
            if dist is None:
                continue
            key = (dist, -self.words.get(cand, 0))
            if best_key is None or key < best_key:
                best, best_key = cand, key
        return best


def _levenshtein(a: str, b: str, cap: int) -> Optional[int]:
    if abs(len(a) - len(b)) > cap:
        return None
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        if min(cur) > cap:
            return None
        prev = cur
    return prev[-1] if prev[-1] <= cap else None


class OOVRecognizer:
    def __init__(self, oov_entries: Iterable[str],
                 max_order: int = 5, max_edit_distance: int = 2):
        """oov_entries: lines of 'word | soundlike1, soundlike2'."""
        self.max_order = max_order
        words, soundlikes = self._parse(oov_entries)
        self.words = words
        self.soundlikes = soundlikes

        self.lm = WittenBellInterpolated(max_order)
        charseqs = ([START_OOV] + list(w) + [END_OOV] for w in words)
        self.lm.fit((everygrams(c, max_len=max_order) for c in charseqs))

        self.spell = SpellIndex(max_edit_distance)
        for w in words:
            self.spell.add(w)

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "OOVRecognizer":
        with open(path, encoding="utf-8") as f:
            return cls([l for l in f.read().split("\n") if l.strip()],
                       **kwargs)

    @staticmethod
    def _parse(entries: Iterable[str]
               ) -> Tuple[List[str], List[Tuple[str, str]]]:
        words, soundlikes = [], []
        for line in entries:
            cols = line.split("|")
            word = cols[0].strip()
            if not word:
                continue
            words.append(word)
            if len(cols) == 2:
                for sound in cols[1].split(","):
                    sound = sound.strip()
                    if sound:
                        soundlikes.append((sound, word))
        return sorted(set(words)), sorted(set(soundlikes), reverse=True)

    # ------------------------------------------------------------- scoring

    def char_score(self, char: str, context: Tuple[str, ...]) -> float:
        """P(next char | context chars) under the OOV char LM."""
        return self.lm.score(char, context[-(self.max_order - 1):])

    # ----------------------------------------------------------- correction

    def correct_spelling(self, sentence: str) -> str:
        """Replace <<...>> OOV spans with the closest enrolled OOV word
        (reference adapter.py correct_spelling intent)."""
        def fix(match):
            raw = match.group(1).replace("▁", "")
            best = self.spell.lookup(raw)
            return best if best is not None else raw

        return re.sub(rf"{START_OOV}(.*?){END_OOV}", fix, sentence)

    def capture_soundlike(self, sentence: str) -> str:
        """Substitute phonetic transliterations with canonical OOV words
        (longest soundlike first)."""
        for sound, word in self.soundlikes:
            sentence = re.sub(rf"\b{re.escape(sound)}\b", word, sentence)
        return sentence

    def __call__(self, sentence: str) -> str:
        return self.capture_soundlike(self.correct_spelling(sentence))
