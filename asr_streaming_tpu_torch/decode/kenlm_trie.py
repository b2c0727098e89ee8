"""KenLM TRIE binary n-gram format: reader (scoring + enumeration) and
twin writer.

Companion to :mod:`asr_streaming_tpu_torch.decode.kenlm_binary` (PROBING): the
reference's production rescorer config names a KenLM binary (``lm:
3gram.bin``, reference: streaming_decoder/config/asr-online.yaml:22,
loaded through flashlight at lightspeech/models/recognition.py:236-245).
``build_binary`` emits PROBING by default but TRIE (``build_binary trie``)
is the common choice for deployment because it is several times smaller;
a migrated asset can be either.  This module covers model types 2 (TRIE)
and 3 (QUANT_TRIE); the Bhiksha-compressed ARRAY variants (4, 5) remain
detected-and-rejected — their pointer compression adds another layer of
bit-level layout that we refuse to guess at (see ``KenLMTrie.__init__``).

On-disk layout after the shared header (Sanity + FixedWidthParameters +
counts, see kenlm_binary.read_header):

  [SortedVocabulary]  region of 8 + 8*counts[0] bytes: a u64 entry count E
                      (counts[0] minus <unk>, which is implicit id 0),
                      then E MurmurHash64A(word, 0) hashes sorted
                      ascending, then slack.  Word id = sorted position+1;
                      an unknown word is id 0; bound = E + 1.
  [Quant tables]      QUANT_TRIE only: u8 prob_bits, u8 backoff_bits,
                      6 pad bytes; then per middle order (2..order-1) a
                      prob table (2**prob_bits f32) and a backoff table
                      (2**backoff_bits f32); then the longest order's
                      prob table.  Stored field values are table indices.
  [Unigram]           (counts[0] + 2) x {prob f32, backoff f32, next u64}
                      indexed by word id; entry ``bound`` holds the end
                      sentinel next.  next points into the order-2 array.
  [Middle arrays]     for n in 2..order-1: a bit-packed array of
                      (counts[n-1] + 1) entries of
                      word(word_bits) | prob | backoff | next(next_bits),
                      where word_bits = bit_length(counts[0]), next_bits =
                      bit_length(counts[n]), prob is 31 bits (float with
                      the always-set sign bit dropped; quantized:
                      prob_bits) and backoff 32 raw float bits (quantized:
                      backoff_bits).  Byte size = ceil((entries *
                      total_bits) / 8) + 8 guard bytes.  The final entry
                      carries the end-sentinel next.
  [Longest array]     (counts[order-1] + 1) entries of word | prob.
  [vocab strings]     when has_vocabulary: NUL-terminated words in id
                      order starting with "<unk>" (same as PROBING).

The trie is suffix-directed: n-gram (w1 .. wn) lives on the path
unigram[wn] -> w_{n-1} -> ... -> w1, so each array is sorted by the
REVERSED n-gram (KenLM's SuffixOrder) — children of a node are a
contiguous range [entry.next, following_entry.next) in the next order's
array, sorted ascending by word field (binary-searchable).

Epistemic status — same as the PROBING module: reconstructed from the
published KenLM format (kheafield.com/code/kenlm, lm/trie.cc,
lm/vocab.cc, lm/quantize.cc); no kenlm build exists in this image, so
reader and writer validate each other (identical beam outputs text vs
trie vs probing) and a real ``build_binary trie`` asset check is gated on
ASR_KENLM_BIN in tests/test_kenlm_trie.py.  Known real-asset caveats,
each chosen to fail loudly rather than silently mis-score:
  * build_binary inserts "blank" middle entries when an ARPA lacks a
    prefix of a stored n-gram (impossible in lmplz output); blanks carry
    copied suffix probabilities that enumeration cannot distinguish from
    real n-grams.  Scoring is unaffected (KenLM itself scores through
    them); trie->probing conversion of such a file adds those entries as
    real n-grams.
  * The writer does not reproduce kenlm's quantization binning (any
    legal tables are a valid file; ours are exact when an order has
    <= 2**bits distinct values, which makes the quantized tests lossless).

The scoring class is an ArpaLM drop-in (same score/finish duck type as
decode.beam.ArpaLM, natural-log) with KenLM's id-0 OOV semantics.  For
the native C++ rescorer (probing/ARPA only), ``ensure_native_lm``
converts a trie asset to its probing twin once and caches it.

Copied from asr_streaming_tpu/decode/kenlm_trie.py; the fallback LM cache
lives under the package's ``_build/`` instead of the home directory.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from asr_streaming_tpu_torch.decode.kenlm_binary import (
    LOG10, MODEL_TYPES, _PARAMS, _SANITY_SIZE, _align8, _Arpa, _parse_arpa,
    MAGIC, murmur64a, read_header,
)

logger = logging.getLogger(__name__)

_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def _required_bits(max_value: int) -> int:
    """util::RequiredBits — bits to hold max_value itself."""
    return max_value.bit_length()


def _f32_bits(x: float) -> int:
    return _U32.unpack(_F32.pack(x))[0]


def _bits_f32(b: int) -> float:
    return _F32.unpack(_U32.pack(b & 0xFFFFFFFF))[0]


def _prob31_encode(prob10: float) -> int:
    """Non-positive float stored without its (always set) sign bit."""
    if prob10 > 0.0:
        raise ValueError(f"trie probabilities must be <= 0, got {prob10}")
    return _f32_bits(prob10) & 0x7FFFFFFF


def _prob31_decode(code: int) -> float:
    return _bits_f32(code | 0x80000000)


class _BitArray:
    """Little-endian bit-packed fixed-width entry array (util/bit_packing:
    field value = (u64 at byte(bit_off >> 3)) >> (bit_off & 7), masked)."""

    def __init__(self, buf, entries: int, total_bits: int):
        self.buf = buf
        self.entries = entries
        self.total_bits = total_bits

    @staticmethod
    def byte_size(entries: int, total_bits: int) -> int:
        # one extra entry for the trailing end-sentinel next pointer +
        # 8 guard bytes so word-sized reads near the end stay in bounds
        # (lm/trie.cc BitPacked::BaseSize)
        return ((entries + 1) * total_bits + 7) // 8 + 8

    def read(self, index: int, bit_off_in_entry: int, nbits: int) -> int:
        bit = index * self.total_bits + bit_off_in_entry
        byte = bit >> 3
        shift = bit & 7
        nbytes = (shift + nbits + 7) >> 3
        window = int.from_bytes(self.buf[byte:byte + nbytes], "little")
        return (window >> shift) & ((1 << nbits) - 1)

    def write(self, index: int, bit_off_in_entry: int, nbits: int,
              value: int) -> None:
        bit = index * self.total_bits + bit_off_in_entry
        byte = bit >> 3
        shift = bit & 7
        nbytes = (shift + nbits + 7) >> 3
        window = int.from_bytes(self.buf[byte:byte + nbytes], "little")
        mask = ((1 << nbits) - 1) << shift
        window = (window & ~mask) | ((value << shift) & mask)
        self.buf[byte:byte + nbytes] = window.to_bytes(nbytes, "little")


@dataclasses.dataclass
class _MiddleLayout:
    word_bits: int
    prob_bits: int       # 31 plain, config prob_bits quantized
    backoff_bits: int    # 32 plain, config backoff_bits quantized
    next_bits: int

    @property
    def total_bits(self) -> int:
        return (self.word_bits + self.prob_bits + self.backoff_bits
                + self.next_bits)


def _quant_size(order: int, prob_bits: int, backoff_bits: int) -> int:
    middle = ((1 << prob_bits) + (1 << backoff_bits)) * 4
    return 8 + (order - 2) * middle + (1 << prob_bits) * 4


# -------------------------------------------------------------------- writer

def _build_quant_tables(arpa: _Arpa, prob_bits: int, backoff_bits: int
                        ) -> Tuple[List[List[float]], List[List[float]],
                                   List[float]]:
    """Per-middle-order prob/backoff tables + the longest prob table.

    Policy (writer-side freedom — see module docstring): distinct values
    in sorted order, exact when they fit; equal-count binning otherwise.
    Backoff code 0 is reserved for 0.0 (KenLM's kNoExtensionQuant /
    kExtensionQuant pair occupies codes 0 and 1)."""

    def bins(values: List[float], nbits: int, reserve: int = 0
             ) -> List[float]:
        room = (1 << nbits) - reserve
        uniq = sorted(set(values))
        if len(uniq) <= room:
            table = uniq + [uniq[-1] if uniq else 0.0] * (room - len(uniq))
        else:
            sv = sorted(values)
            per = len(sv) / room
            table = [sv[min(len(sv) - 1, int((i + 0.5) * per))]
                     for i in range(room)]
        return table

    probs: List[List[float]] = []
    backoffs: List[List[float]] = []
    for n in range(2, arpa.order):
        grams = arpa.grams[n - 1]
        probs.append(bins([lp for _, lp, _ in grams] or [0.0], prob_bits))
        bo = bins([b for _, _, b in grams if b != 0.0] or [0.0],
                  backoff_bits, reserve=2)
        backoffs.append([-0.0, 0.0] + bo)
    longest = bins([lp for _, lp, _ in arpa.grams[arpa.order - 1]] or [0.0],
                   prob_bits)
    return probs, backoffs, longest


def _encode_to_table(table: List[float], value: float, start: int = 0
                     ) -> int:
    """Index of the closest table entry at/after ``start``."""
    best, best_d = start, float("inf")
    for i in range(start, len(table)):
        d = abs(table[i] - value)
        if d < best_d:
            best, best_d = i, d
    return best


def write_trie(arpa_path: str, out_path: str, quantize: bool = False,
               prob_bits: int = 8, backoff_bits: int = 8,
               include_vocab_strings: bool = True) -> None:
    """Build a KenLM TRIE (or QUANT_TRIE) binary from a text ARPA — the
    test twin of ``build_binary [quantize] trie in.arpa out.bin``.

    Requires every n-gram's prefixes to be present (lmplz and
    tools/build_lm.py ARPAs satisfy this); raises otherwise instead of
    synthesizing KenLM's blank entries."""
    arpa = _parse_arpa(arpa_path)
    write_trie_from(arpa, out_path, quantize=quantize, prob_bits=prob_bits,
                    backoff_bits=backoff_bits,
                    include_vocab_strings=include_vocab_strings)


def write_trie_from(arpa: _Arpa, out_path: str, quantize: bool = False,
                    prob_bits: int = 8, backoff_bits: int = 8,
                    include_vocab_strings: bool = True) -> None:
    order = arpa.order
    if order < 2:
        raise ValueError("TRIE needs order >= 2 (unigram-only LMs load "
                         "as text ARPA or PROBING)")
    counts = list(arpa.counts)

    # ---- vocabulary: ids by sorted murmur hash, <unk> implicit id 0
    unk_values = (-100.0, 0.0)
    words: List[str] = []
    for (w,), lp, bo in ((g[0], g[1], g[2]) for g in arpa.grams[0]):
        if w in ("<unk>", "<UNK>"):
            unk_values = (lp, bo)
            continue
        words.append(w)
    hashed = sorted((murmur64a(w.encode("utf-8")), w) for w in words)
    if len({h for h, _ in hashed}) != len(hashed):
        raise ValueError("vocabulary murmur hash collision (astronomically "
                         "unlikely); cannot build a sorted-vocab trie")
    word_id: Dict[str, int] = {"<unk>": 0}
    id_word: List[str] = ["<unk>"]
    for h, w in hashed:
        word_id[w] = len(id_word)
        id_word.append(w)
    bound = len(id_word)

    def ids_of(ws: Tuple[str, ...]) -> Tuple[int, ...]:
        return tuple(word_id.get(w, 0) for w in ws)

    # ---- sort every order by reversed ids (SuffixOrder); validate prefixes
    by_order: List[List[Tuple[Tuple[int, ...], float, float]]] = []
    node_index: List[Dict[Tuple[int, ...], int]] = []  # ids -> position
    for n in range(2, order + 1):
        entries = sorted(
            ((ids_of(ws), lp, bo) for ws, lp, bo in arpa.grams[n - 1]),
            key=lambda e: tuple(reversed(e[0])))
        for i in range(1, len(entries)):
            if entries[i][0] == entries[i - 1][0]:
                raise ValueError(
                    f"duplicate {n}-gram after id mapping (OOV fold): "
                    f"{entries[i][0]}")
        by_order.append(entries)
        node_index.append({ids: i for i, (ids, _, _) in enumerate(entries)})
    # every (w1..wn) needs its parent node (w2..wn) so the trie can
    # address it
    for n in range(3, order + 1):
        parents = node_index[n - 3]
        for ids, _, _ in by_order[n - 2]:
            if ids[1:] not in parents:
                raise ValueError(
                    f"ARPA is missing the prefix {ids[1:]} of a stored "
                    f"{n}-gram; KenLM inserts blank entries here — "
                    "rebuild the LM with lmplz/tools/build_lm.py (all "
                    "prefixes present) or use the PROBING format")

    quant_tables = _build_quant_tables(arpa, prob_bits, backoff_bits) \
        if quantize else None

    # ---- layouts
    word_bits = _required_bits(counts[0])
    middles: List[_MiddleLayout] = []
    for n in range(2, order):
        middles.append(_MiddleLayout(
            word_bits=word_bits,
            prob_bits=prob_bits if quantize else 31,
            backoff_bits=backoff_bits if quantize else 32,
            next_bits=_required_bits(counts[n])))
    longest_bits = word_bits + (prob_bits if quantize else 31)

    out = bytearray()
    out += MAGIC + b"\0" * (_align8(len(MAGIC)) - len(MAGIC))
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\0" * 4
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    out += _PARAMS.pack(order, 1.5, 3 if quantize else 2,
                        1 if include_vocab_strings else 0, 1)
    for c in counts:
        out += struct.pack("<Q", c)
    out += b"\0" * (_align8(len(out)) - len(out))

    # ---- SortedVocabulary region: 8 + 8 * counts[0] bytes
    vocab_region = bytearray(8 + 8 * counts[0])
    vocab_region[0:8] = struct.pack("<Q", len(hashed))
    for i, (h, _) in enumerate(hashed):
        vocab_region[8 + 8 * i:16 + 8 * i] = struct.pack("<Q", h)
    out += vocab_region

    # ---- quant tables
    if quantize:
        qprobs, qbackoffs, qlongest = quant_tables
        # SeparatelyQuantize header (lm/quantize.cc FinishedLoading /
        # UpdateConfigFromBinary): u8 version (=2), u8 prob_bits,
        # u8 backoff_bits, padded to 8 bytes.
        out += struct.pack("<BBB5x", 2, prob_bits, backoff_bits)
        for i in range(order - 2):
            for v in qprobs[i]:
                out += _F32.pack(v)
            for v in qbackoffs[i]:
                out += _F32.pack(v)
        for v in qlongest:
            out += _F32.pack(v)

    # ---- unigram array with next pointers into the order-2 array
    uni_by_id: Dict[int, Tuple[float, float]] = {0: unk_values}
    for (w,), lp, bo in ((g[0], g[1], g[2]) for g in arpa.grams[0]):
        if w not in ("<unk>", "<UNK>"):
            uni_by_id[word_id[w]] = (lp, bo)
    # children of unigram[id] = bigrams whose ids[-1] == id; by_order[0]
    # is sorted by (w2, w1) so groups appear in ascending parent id
    uni = bytearray((counts[0] + 2) * 16)
    pos = 0
    bigrams = by_order[0]
    for wid in range(bound):
        lp, bo = uni_by_id.get(wid, (-100.0, 0.0))
        uni[wid * 16:wid * 16 + 16] = struct.pack("<ffQ", lp, bo, pos)
        while pos < len(bigrams) and bigrams[pos][0][-1] == wid:
            pos += 1
    uni[bound * 16:bound * 16 + 16] = struct.pack("<ffQ", 0.0, 0.0, pos)
    assert pos == len(bigrams)
    out += uni

    # ---- middle arrays
    for n in range(2, order):
        lay = middles[n - 2]
        entries = by_order[n - 2]
        children = by_order[n - 1]
        buf = bytearray(_BitArray.byte_size(len(entries), lay.total_bits))
        arr = _BitArray(buf, len(entries), lay.total_bits)
        cpos = 0
        for i, (ids, lp, bo) in enumerate(entries):
            arr.write(i, 0, lay.word_bits, ids[0])
            if quantize:
                pcode = _encode_to_table(qprobs[n - 2], lp)
                bcode = 0 if bo == 0.0 else _encode_to_table(
                    qbackoffs[n - 2], bo, start=2)
                arr.write(i, lay.word_bits, lay.prob_bits, pcode)
                arr.write(i, lay.word_bits + lay.prob_bits,
                          lay.backoff_bits, bcode)
            else:
                arr.write(i, lay.word_bits, 31, _prob31_encode(lp))
                arr.write(i, lay.word_bits + 31, 32, _f32_bits(bo))
            arr.write(i, lay.word_bits + lay.prob_bits + lay.backoff_bits,
                      lay.next_bits, cpos)
            # advance child cursor past this node's children: (n+1)-grams
            # whose suffix == ids
            while cpos < len(children) and children[cpos][0][1:] == ids:
                cpos += 1
        arr.write(len(entries), lay.word_bits + lay.prob_bits
                  + lay.backoff_bits, lay.next_bits, cpos)
        assert cpos == len(children)
        out += buf

    # ---- longest array
    entries = by_order[order - 2]
    buf = bytearray(_BitArray.byte_size(len(entries), longest_bits))
    arr = _BitArray(buf, len(entries), longest_bits)
    for i, (ids, lp, _) in enumerate(entries):
        arr.write(i, 0, word_bits, ids[0])
        if quantize:
            arr.write(i, word_bits, prob_bits,
                      _encode_to_table(qlongest, lp))
        else:
            arr.write(i, word_bits, 31, _prob31_encode(lp))
    out += buf

    if include_vocab_strings:
        for w in id_word:
            out += w.encode("utf-8") + b"\0"

    with open(out_path, "wb") as f:
        f.write(bytes(out))


# -------------------------------------------------------------------- reader

class KenLMTrie:
    """KenLM TRIE / QUANT_TRIE binary, scoring in natural log — an ArpaLM
    drop-in (decode.beam.ArpaLM duck type) with KenLM's id-0 OOV
    semantics, plus full n-gram enumeration for format conversion."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = f.read()
        data = memoryview(self._data)
        h = read_header(self._data)
        if h.model_type not in (2, 3):
            if h.model_type in (4, 5):
                raise ValueError(
                    f"KenLM {MODEL_TYPES[h.model_type]} uses Bhiksha "
                    "pointer compression, which this reader does not "
                    "implement; rebuild as trie/probing or convert from "
                    "the text ARPA with tools/build_lm.py")
            raise ValueError(
                f"not a TRIE-family binary (model type "
                f"{MODEL_TYPES.get(h.model_type, h.model_type)}); use "
                "kenlm_binary.load_lm for format routing")
        if h.search_version not in (0, 1):
            logger.warning("KenLM trie search version %d (expected 1); "
                           "layout may differ", h.search_version)
        self.header = h
        self.order = h.order
        self.quantized = h.model_type == 3
        counts = h.counts
        off = h.data_offset

        # SortedVocabulary
        (nhashes,) = struct.unpack_from("<Q", data, off)
        if nhashes > counts[0]:
            raise ValueError(f"corrupt trie vocabulary: {nhashes} hashes "
                             f"> {counts[0]} unigrams")
        self._hashes = data[off + 8: off + 8 + 8 * nhashes].cast("Q")
        self.bound = nhashes + 1
        off += 8 + 8 * counts[0]

        # quant tables
        self._qprob: List[memoryview] = []
        self._qbackoff: List[memoryview] = []
        self._qlongest: Optional[memoryview] = None
        prob_bits = backoff_bits = 0
        if self.quantized:
            # lm/quantize.cc stores {u8 version, u8 prob_bits,
            # u8 backoff_bits} in the first 3 of the 8 header bytes;
            # SeparatelyQuantize's version is 2.  Reject anything else
            # loudly rather than mis-size every downstream table.
            qversion, prob_bits, backoff_bits = struct.unpack_from(
                "<BBB", data, off)
            if qversion != 2:
                raise ValueError(
                    f"KenLM quantization header version {qversion} "
                    "(expected 2, SeparatelyQuantize); refusing to guess "
                    "the table layout")
            if not (0 < prob_bits <= 25 and 0 < backoff_bits <= 25):
                raise ValueError(
                    f"implausible quantization widths ({prob_bits}, "
                    f"{backoff_bits}) — layout mismatch?")
            off += 8
            for _ in range(h.order - 2):
                self._qprob.append(
                    data[off:off + 4 * (1 << prob_bits)].cast("f"))
                off += 4 * (1 << prob_bits)
                self._qbackoff.append(
                    data[off:off + 4 * (1 << backoff_bits)].cast("f"))
                off += 4 * (1 << backoff_bits)
            self._qlongest = data[off:off + 4 * (1 << prob_bits)].cast("f")
            off += 4 * (1 << prob_bits)

        # unigram
        self._unigram = data[off:off + (counts[0] + 2) * 16]
        off += (counts[0] + 2) * 16

        # middle + longest bit-packed arrays
        word_bits = _required_bits(counts[0])
        self._middles: List[Tuple[_BitArray, _MiddleLayout]] = []
        for n in range(2, h.order):
            lay = _MiddleLayout(
                word_bits=word_bits,
                prob_bits=prob_bits if self.quantized else 31,
                backoff_bits=backoff_bits if self.quantized else 32,
                next_bits=_required_bits(counts[n]))
            size = _BitArray.byte_size(counts[n - 1], lay.total_bits)
            self._middles.append(
                (_BitArray(data[off:off + size], counts[n - 1],
                           lay.total_bits), lay))
            off += size
        lbits = word_bits + (prob_bits if self.quantized else 31)
        lsize = _BitArray.byte_size(counts[h.order - 1], lbits)
        self._longest = _BitArray(data[off:off + lsize],
                                  counts[h.order - 1], lbits)
        self._word_bits = word_bits
        self._lprob_bits = prob_bits if self.quantized else 31
        off += lsize
        if off > len(self._data):
            raise ValueError(
                f"KenLM trie truncated (expected {off} bytes of data, file "
                f"has {len(self._data)}) — layout mismatch or corrupt file")

        self.words: List[str] = []
        if h.has_vocabulary:
            raw = self._data[off:]
            self.words = [w.decode("utf-8", errors="replace")
                          for w in raw.split(b"\0") if w]
            if self.words and self.words[0] != "<unk>":
                self.words = ["<unk>"] + self.words

    # ------------------------------------------------------------- lookups

    def word_id(self, word: str) -> int:
        key = murmur64a(word.encode("utf-8"))
        lo, hi = 0, len(self._hashes)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._hashes[mid] < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self._hashes) and self._hashes[lo] == key:
            return lo + 1
        return 0

    def _uni(self, wid: int) -> Tuple[float, float, int, int]:
        lp, bo, nxt = struct.unpack_from("<ffQ", self._unigram, wid * 16)
        _, _, end = struct.unpack_from("<ffQ", self._unigram,
                                       (wid + 1) * 16)
        return lp, bo, nxt, end

    def _middle_read(self, k: int, i: int) -> Tuple[int, float, float,
                                                    int, int]:
        """(word, prob10, backoff10, child_begin, child_end) of entry i in
        the order-(k) array, k in 2..order-1."""
        arr, lay = self._middles[k - 2]
        word = arr.read(i, 0, lay.word_bits)
        pcode = arr.read(i, lay.word_bits, lay.prob_bits)
        bcode = arr.read(i, lay.word_bits + lay.prob_bits, lay.backoff_bits)
        if self.quantized:
            prob = self._qprob[k - 2][pcode]
            backoff = self._qbackoff[k - 2][bcode]
        else:
            prob = _prob31_decode(pcode)
            backoff = _bits_f32(bcode)
        nxt_off = lay.word_bits + lay.prob_bits + lay.backoff_bits
        begin = arr.read(i, nxt_off, lay.next_bits)
        end = arr.read(i + 1, nxt_off, lay.next_bits)
        return word, prob, backoff, begin, end

    def _longest_read(self, i: int) -> Tuple[int, float]:
        word = self._longest.read(i, 0, self._word_bits)
        pcode = self._longest.read(i, self._word_bits, self._lprob_bits)
        prob = self._qlongest[pcode] if self.quantized \
            else _prob31_decode(pcode)
        return word, prob

    def _find_in_range(self, k: int, lo: int, hi: int, word: int
                       ) -> Optional[int]:
        """Binary search the order-k array's [lo, hi) by word field."""
        read = (lambda i: self._longest_read(i)[0]) if k == self.order \
            else (lambda i: self._middles[k - 2][0].read(
                i, 0, self._word_bits))
        while lo < hi:
            mid = (lo + hi) // 2
            w = read(mid)
            if w < word:
                lo = mid + 1
            elif w > word:
                hi = mid
            else:
                return mid
        return None

    def _lookup(self, ids: Sequence[int]) -> Optional[Tuple[float, float]]:
        """(prob10, backoff10) of the exact n-gram, or None.  Walks the
        suffix trie: unigram[ids[-1]] then ids[-2] .. ids[0]."""
        n = len(ids)
        if ids[-1] >= self.bound:
            return None
        lp, bo, lo, hi = self._uni(ids[-1])
        if n == 1:
            return lp, bo
        for k in range(2, n + 1):
            hit = self._find_in_range(k, lo, hi, ids[n - k])
            if hit is None:
                return None
            if k == self.order:
                _, lp = self._longest_read(hit)
                return lp, 0.0
            _, lp, bo, lo, hi = self._middle_read(k, hit)
        return lp, bo

    # ----------------------------------------------- ArpaLM-compatible API

    def start_state(self) -> Tuple[str, ...]:
        return ("<s>",)

    def score(self, state: Tuple[str, ...], word: str
              ) -> Tuple[float, Tuple[str, ...]]:
        logp = self._backoff_score(state + (word,))
        next_state = (state + (word,))[-(self.order - 1):] \
            if self.order > 1 else ()
        return logp, next_state

    def finish(self, state: Tuple[str, ...]) -> float:
        return self._backoff_score(state + ("</s>",))

    def _backoff_score(self, words: Tuple[str, ...]) -> float:
        return self._backoff_ids(
            [self.word_id(w) for w in words[-self.order:]])

    def _backoff_ids(self, ids: List[int]) -> float:
        if len(ids) > 1:
            hit = self._lookup(ids)
            if hit is not None:
                return hit[0] * LOG10
            ctx = self._lookup(ids[:-1])
            backoff = ctx[1] if ctx is not None else 0.0
            return backoff * LOG10 + self._backoff_ids(ids[1:])
        hit = self._lookup([ids[0] if ids[0] < self.bound else 0])
        return hit[0] * LOG10

    # ----------------------------------------------------------- conversion

    def iter_ngrams(self) -> Iterator[Tuple[int, Tuple[str, ...],
                                            float, float]]:
        """Yield (order_n, words, prob10, backoff10) for every stored
        n-gram.  Requires vocabulary strings (has_vocabulary)."""
        if not self.words:
            raise ValueError(
                "trie was built without vocabulary strings; word ids "
                "cannot be inverted (hashes only) — rebuild the binary "
                "with vocabulary or keep the text ARPA")
        words = self.words

        def walk(k: int, lo: int, hi: int, suffix: Tuple[str, ...]):
            for i in range(lo, hi):
                if k == self.order:
                    w, lp = self._longest_read(i)
                    yield k, (words[w],) + suffix, lp, 0.0
                else:
                    w, lp, bo, clo, chi = self._middle_read(k, i)
                    gram = (words[w],) + suffix
                    yield k, gram, lp, bo
                    yield from walk(k + 1, clo, chi, gram)

        for wid in range(self.bound):
            lp, bo, lo, hi = self._uni(wid)
            yield 1, (words[wid],), lp, bo
            if self.order > 1:
                yield from walk(2, lo, hi, (words[wid],))

    def to_arpa(self) -> _Arpa:
        grams: List[List[Tuple[Tuple[str, ...], float, float]]] = \
            [[] for _ in range(self.order)]
        for n, ws, lp, bo in self.iter_ngrams():
            grams[n - 1].append((ws, lp, bo))
        return _Arpa(order=self.order, counts=[len(g) for g in grams],
                     grams=grams)

    def to_probing(self, out_path: str) -> None:
        """Write the PROBING twin of this trie (for the native C++
        rescorer, which loads text ARPA and PROBING only)."""
        from asr_streaming_tpu_torch.decode.kenlm_binary import write_probing_from
        write_probing_from(self.to_arpa(), out_path)


def _convert_atomic(lm_path: str, cache: str) -> None:
    """Convert ``lm_path`` (trie) into ``cache`` (probing) atomically:
    write into a tempfile in the destination directory and os.replace()
    it into place, so a killed or concurrent process can never leave a
    truncated cache that later freshness checks would trust."""
    import tempfile
    trie = KenLMTrie(lm_path)
    logger.info(
        "converting trie LM %s (%s n-grams) to its probing twin at %s — "
        "one-time cost, proportional to model size",
        lm_path, "+".join(str(c) for c in trie.header.counts), cache)
    fd, tmp = tempfile.mkstemp(
        suffix=".tmp", prefix=os.path.basename(cache) + ".",
        dir=os.path.dirname(cache) or ".")
    os.close(fd)
    try:
        trie.to_probing(tmp)
        os.replace(tmp, cache)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _cache_valid(cache: str, lm_path: str) -> bool:
    """Fresh AND loadable as PROBING (header-validated, so a corrupt or
    foreign file at the cache path is never trusted)."""
    from asr_streaming_tpu_torch.decode.kenlm_binary import sniff
    try:
        if os.path.getmtime(cache) < os.path.getmtime(lm_path):
            return False
        return sniff(cache) == "PROBING"
    except (OSError, ValueError):
        return False


def ensure_native_lm(lm_path: str) -> str:
    """Path the native C++ decoder can load: ``lm_path`` itself for text
    ARPA / PROBING, a cached PROBING conversion for TRIE-family binaries
    (sibling ``<name>.as_probing.bin`` when the directory is writable,
    else a cache under ``ASR_LM_CACHE_DIR`` or the package's ``_build/lm``
    keyed by source path + mtime, so read-only LM directories don't redo
    the conversion every process start)."""
    from asr_streaming_tpu_torch.decode.kenlm_binary import sniff
    kind = sniff(lm_path)
    if kind not in ("TRIE", "QUANT_TRIE"):
        return lm_path
    cache = lm_path + ".as_probing.bin"
    try:
        if _cache_valid(cache, lm_path):
            return cache
        _convert_atomic(lm_path, cache)
        return cache
    except OSError:
        cache_dir = os.environ.get(
            "ASR_LM_CACHE_DIR",
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "_build", "lm"))
        os.makedirs(cache_dir, exist_ok=True)
        key = f"{murmur64a(os.path.abspath(lm_path).encode(), 0):016x}"
        cache = os.path.join(cache_dir, f"{key}.as_probing.bin")
        if _cache_valid(cache, lm_path):
            return cache
        _convert_atomic(lm_path, cache)
        logger.info("converted trie LM to probing at %s (source dir not "
                    "writable)", cache)
        return cache
