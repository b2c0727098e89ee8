"""Vocabulary loading.

Copied from asr_streaming_tpu/text/vocab.py (load_vocab, load_lexicon,
placeholder_vocab).

  vocab:   one token per line; index 0 = blank '-', index 1 = silence '|'
  lexicon: word<TAB>subword subword ... per line
"""

from __future__ import annotations

from typing import Dict, List


def load_vocab(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return f.read().split("\n")


def load_lexicon(path: str) -> Dict[str, List[str]]:
    lex: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().split("\n"):
            if not line:
                continue
            parts = line.split("\t", 1)
            if len(parts) == 2:
                lex[parts[0]] = parts[1].split(" ")
    return lex


def placeholder_vocab(size: int = 803) -> List[str]:
    """Structurally-valid stand-in vocab when no real corpus is configured
    (random-weight serving, tests): '-', '|', then synthetic subwords."""
    toks = ["-", "|"]
    i = 0
    while len(toks) < size:
        toks.append(f"t{i}")
        i += 1
    return toks[:size]
