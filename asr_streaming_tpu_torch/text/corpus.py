"""Locate and load the production Vietnamese corpus (vocab + lexicon).

The reference ships its corpus as package resources and loads them with
``build_vocab``/``build_lexicon`` (reference: lightspeech/datas/text.py:27-38,
corpus files at lightspeech/corpus/{vocab.txt,lexicon.txt} plus the
107-character ``vocab-character.txt``/``lexicon-character.txt`` variants).
These are deploy-time model assets, like checkpoints; this module resolves
a corpus directory from (in order):

  1. the ``ASR_CORPUS_DIR`` environment variable,
  2. an explicit path passed by the caller (config ``corpus_dir``),
  3. ``assets/corpus`` next to the repository root.

Parsing matches the reference exactly: ``read().split("\\n")`` for the
vocab (the shipped file has NO trailing newline, so the real token list
has 804 entries — index 0 = blank '-', 1 = silence '|'), and
``word<TAB>subword subword ...`` lines for the lexicon (17,949 entries).

Copied from asr_streaming_tpu/text/corpus.py, without its fourth,
machine-specific candidate directory.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from asr_streaming_tpu_torch.text.vocab import load_lexicon, load_vocab


def find_corpus_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Return the first existing corpus directory (must contain vocab.txt)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.environ.get("ASR_CORPUS_DIR"),
        explicit,
        os.path.join(here, "assets", "corpus"),
    ]
    for cand in candidates:
        if cand and os.path.isfile(os.path.join(cand, "vocab.txt")):
            return cand
    return None


def load_corpus(corpus_dir: Optional[str] = None,
                character: bool = False):
    """-> (vocab, lexicon) from the resolved corpus dir, or (None, None).

    ``character=True`` selects the 107-char character-level variant
    (reference corpus/vocab-character.txt + lexicon-character.txt).
    """
    d = find_corpus_dir(corpus_dir)
    if d is None:
        return None, None
    suffix = "-character" if character else ""
    vocab_path = os.path.join(d, f"vocab{suffix}.txt")
    lexicon_path = os.path.join(d, f"lexicon{suffix}.txt")
    vocab = load_vocab(vocab_path) if os.path.isfile(vocab_path) else None
    lexicon = (load_lexicon(lexicon_path)
               if os.path.isfile(lexicon_path) else None)
    return vocab, lexicon


def corpus_paths(corpus_dir: Optional[str] = None) -> Dict[str, str]:
    """Resolved file paths for configs that want explicit paths."""
    d = find_corpus_dir(corpus_dir)
    if d is None:
        return {}
    out = {}
    for key, name in (("vocab", "vocab.txt"), ("lexicon", "lexicon.txt"),
                      ("vocab_character", "vocab-character.txt"),
                      ("lexicon_character", "lexicon-character.txt")):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            out[key] = p
    return out
