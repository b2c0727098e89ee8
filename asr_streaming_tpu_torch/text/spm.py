"""Minimal SentencePiece ``.model`` piece extractor (no sentencepiece dep).

The reference's EN path detokenizes with a SentencePiece BPE-4096 model
(reference: recognition.py:119 loads ``spm_bpe_4096.model``).  This image
ships no sentencepiece library, so the piece table is pulled straight out
of the serialized ModelProto wire format:

  ModelProto.pieces (field 1, repeated SentencePiece)
  SentencePiece: piece (1, string), score (2, float), type (3, enum)

The returned list is ordered by id, which is exactly what
``detokenize_pieces`` (models/rnnt.py) consumes; control pieces keep
their surface form (``<unk>``, ``<s>``, ``</s>``) — the detokenizer's
callers filter ids, like the reference's token processor.

Copied from asr_streaming_tpu/text/spm.py.
"""

from __future__ import annotations

import struct
from typing import List

from asr_streaming_tpu_torch.tools.onnx_weights import _fields


def load_spm_pieces(path: str) -> List[str]:
    with open(path, "rb") as f:
        data = f.read()
    return parse_spm_pieces(data)


def parse_spm_pieces(data: bytes) -> List[str]:
    pieces: List[str] = []
    for field, wire, val in _fields(data):
        if field == 1 and wire == 2:          # ModelProto.pieces
            piece = None
            for pfield, pwire, pval in _fields(val):
                if pfield == 1 and pwire == 2:
                    piece = pval.decode("utf-8", errors="replace")
            if piece is not None:
                pieces.append(piece)
    return pieces


def encode_test_model(pieces: List[str]) -> bytes:
    """Serialize a piece list into ModelProto bytes (test helper)."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(num: int, payload: bytes) -> bytes:
        return varint((num << 3) | 2) + varint(len(payload)) + payload

    blob = b""
    for p in pieces:
        enc = p.encode("utf-8")
        sp = ld(1, enc) + varint((2 << 3) | 5) + struct.pack("<f", 0.0)
        blob += ld(1, sp)
    return blob


def encode_pieces(text: str, pieces: List[str],
                  unk: str = "<unk>") -> List[int]:
    """Greedy longest-match piece encoding (word-boundary "▁" marking).

    The image has no sentencepiece library for true unigram-Viterbi
    encoding; greedy longest-match is the standard deterministic
    approximation and round-trips through ``detokenize_pieces``
    (models/rnnt.py) exactly.  Unknown characters map to ``unk`` when
    present, else are skipped.
    """
    index = {p: i for i, p in enumerate(pieces)}
    unk_id = index.get(unk)
    out: List[int] = []
    for word in text.split():
        s = "▁" + word       # SentencePiece word-boundary marker
        i = 0
        while i < len(s):
            for j in range(len(s), i, -1):
                pid = index.get(s[i:j])
                if pid is not None:
                    out.append(pid)
                    i = j
                    break
            else:
                if unk_id is not None:
                    out.append(unk_id)
                i += 1
    return out
