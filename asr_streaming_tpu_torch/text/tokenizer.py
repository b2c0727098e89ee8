"""Vietnamese subword tokenizer.

Re-implementation of the reference tokenizer semantics (reference:
streaming_decoder/lightspeech/datas/text.py:6-89):

  * sentences are lowercased, punctuation-stripped, words joined by '|',
  * out-of-lexicon words are split into characters wrapped in << >>,
  * words starting with 'gi'/'qu' whose remainder is a special subword get
    a delimiter inserted so the subword regex splits them correctly,
  * tone marks are refactored to a trailing tone-mark digit for the
    special-case check,
  * final tokenization greedily matches the longest vocab entries.

Copied from asr_streaming_tpu/text/tokenizer.py.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

DELIMITER = "▁"  # ▁
VOWELS = "aăâeêioôơuưy"
TONE_CHARS = ("àằầèềìòồờùừỳáắấéếíóốớúứý"
              "ảẳẩẻểỉỏổởủửỷạặậẹệịọộợụựỵãẵẫẽễĩõỗỡũữỹ")
TONE_MARKS = ["1_", "2_", "3_", "4_", "5_"]
SPECIAL_SUBWORDS = {
    "uôc", "uych", "uyn", "uynh", "uyp", "uyt", "uyên", "uyêt",
    "i", "in", "iêt", "iêu", "iêng",
}


def refactor_tone_mark(word: str) -> str:
    """Strip tone marks from vowels and append the (first) tone as a
    trailing mark (reference text.py:41-57)."""
    found = [c for c in word if c in TONE_CHARS]
    for c in set(found):
        plain = VOWELS[TONE_CHARS.index(c) % len(VOWELS)]
        word = word.replace(c, plain)
    mark = ""
    if found:
        mark = TONE_MARKS[TONE_CHARS.index(found[0]) // len(VOWELS)]
    return word + mark


def tokenize(sentence: str, vocab: Sequence[str],
             lexicon: Dict[str, List[str]]) -> List[str]:
    """Sentence -> subword token list matching the reference semantics."""
    sentence = re.sub(r"[^\w\s<>]", "", sentence)
    sentence = re.sub(r"\s+", "|", sentence)
    sentence = sentence.lower().strip("|")

    words = sentence.split("|")
    for word in set(words):
        if word and word not in lexicon:
            wrapped = "<<" + DELIMITER.join(word) + ">>"
            sentence = re.sub(rf"\b{re.escape(word)}\b", wrapped, sentence)

    for word in set(re.findall(r"\bgi\w*\b|\bqu\w+\b", sentence)):
        plain = re.sub("|".join(TONE_MARKS), "", refactor_tone_mark(word))
        if plain[1:] in SPECIAL_SUBWORDS:
            fixed = word[0] + DELIMITER + word[1:]
            sentence = re.sub(rf"\b{re.escape(word)}\b", fixed, sentence)

    pattern = "|".join(map(re.escape, sorted(vocab, reverse=True)))
    return re.findall(pattern, sentence)
