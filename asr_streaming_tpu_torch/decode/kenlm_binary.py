"""KenLM binary n-gram format: reader (scoring oracle) and writer.

The reference's production rescorer loads a KenLM *binary* LM — config
``lm: 3gram.bin`` (reference: streaming_decoder/config/asr-online.yaml:22)
consumed through flashlight's ``ctc_decoder`` (reference:
lightspeech/models/recognition.py:236-245).  To make that asset a drop-in
here, this module implements KenLM's on-disk PROBING format (the default
``build_binary`` data structure, format version 5) and its REST_PROBING
sibling (model_type 1 — entries widened by one f32 rest cost that
full-context scoring never reads):

  [Sanity header]          88 bytes: magic string (53 bytes, 8-aligned to
                           56) + float/int endianness probes
                           (0.0f, 1.0f, -0.5f, 1u32, max u32, 1u64)
  [FixedWidthParameters]   20 bytes: order u8, probing_multiplier f32,
                           model_type i32 (0=PROBING, 1=REST_PROBING,
                           2=TRIE, 3=QUANT_TRIE, 4=ARRAY_TRIE,
                           5=QUANT_ARRAY_TRIE), has_vocabulary u8,
                           search_version u32
  [counts]                 order x u64 n-gram counts; header padded to 8
  [ProbingVocabulary]      8-byte header {version u32 = 0, bound u32} +
                           open-addressing hash table of 12-byte entries
                           {MurmurHash64A(word, seed 0) u64, word_id u32};
                           buckets = max(n+1, floor(1.5 * n)); empty key 0
  [Unigram]                (counts[0] + 1) x {prob f32, backoff f32}
                           indexed by word id (id 0 = <unk>)
  [Middle tables]          for n in 2..order-1: probing table of 16-byte
                           entries {key u64, prob f32, backoff f32}
  [Longest table]          probing table of packed 12-byte entries
                           {key u64, prob f32}
  [vocab strings]          when has_vocabulary: NUL-terminated words in
                           id order starting with "<unk>"

Middle/longest keys chain word ids newest-first through KenLM's
CombineWordHash: h = uint64(w_n); for k = n-1..1:
h = (h * 8978948897894561157) ^ ((1 + w_k) * 17894857484156487943).
Probing tables are zero-initialized, linear-probing, ideal bucket =
key % buckets, wrap at end.

Probabilities are stored as the ARPA file's log10 floats; this reader
converts to natural log so the class is a drop-in for
:class:`asr_streaming_tpu_torch.decode.beam.ArpaLM` (same ``score`` /
``finish`` / ``_backoff_score`` duck type, same Katz backoff recursion).
One deliberate semantic difference, inherited from KenLM itself: an OOV
word maps to id 0 = ``<unk>``, so stored n-grams that *contain*
``<unk>`` can match OOV contexts (the string-keyed ArpaLM can never
match them).

TRIE-family binaries (model_type 2/3: sorted-vocab bit-packed arrays,
optional quantization tables) load through the companion module
``decode/kenlm_trie.py``; only the Bhiksha ARRAY variants (4/5) remain
detected-and-rejected with a precise message.  ``load_lm`` routes by
model type.

The writer exists so deployments (and tests) can build the binary twin
of any text ARPA without KenLM installed: the native C++ reader
(native/beamsearch/beam_decoder.cc) and this oracle are validated by
asserting identical beam outputs for text vs binary in
tests/test_kenlm_binary.py.  The struct layout was reconstructed from
the published KenLM format (kheafield.com/code/kenlm); the magic string,
sanity probes and every width above follow it, so real ``build_binary``
probing outputs load here.

Copied from asr_streaming_tpu/decode/kenlm_binary.py.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

LOG10 = math.log(10.0)

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\0"
MAGIC_V4 = b"mmap lm http://kheafield.com/code format version 4\n\0"
INCOMPLETE = b"mmap lm http://kheafield.com/code incomplete"

MODEL_TYPES = {0: "PROBING", 1: "REST_PROBING", 2: "TRIE", 3: "QUANT_TRIE",
               4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE"}

_MUL_A = 8978948897894561157
_MUL_B = 17894857484156487943
_MASK = (1 << 64) - 1


def _align8(n: int) -> int:
    return (n + 7) & ~7


_SANITY_SIZE = _align8(len(MAGIC)) + 12 + 8 + 4 + 8  # 56+12+8+(pad)4+8 = 88
_PARAMS = struct.Struct("<B3xfiB3xI")                # FixedWidthParameters


def murmur64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A (Appleby) — KenLM's util::MurmurHashNative on
    little-endian 64-bit hosts; used for vocabulary word hashing."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(data) * m)) & _MASK
    n8 = len(data) & ~7
    for off in range(0, n8, 8):
        k = int.from_bytes(data[off:off + 8], "little")
        k = (k * m) & _MASK
        k ^= k >> r
        k = (k * m) & _MASK
        h ^= k
        h = (h * m) & _MASK
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK
    h ^= h >> r
    h = (h * m) & _MASK
    h ^= h >> r
    return h


def chained_key(ids: Sequence[int]) -> int:
    """KenLM detail::CombineWordHash chain over word ids, newest first:
    the table key of n-gram (w1 .. wn) folds from wn back to w1."""
    h = ids[-1] & _MASK
    for w in reversed(ids[:-1]):
        h = ((h * _MUL_A) ^ (((1 + w) * _MUL_B) & _MASK)) & _MASK
    return h


def _buckets(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(multiplier * entries))


# --------------------------------------------------------------- ARPA parse

@dataclasses.dataclass
class _Arpa:
    order: int
    counts: List[int]
    # per order n (1-based): list of (words_tuple, logprob10, backoff10)
    grams: List[List[Tuple[Tuple[str, ...], float, float]]]


def _parse_arpa(path: str) -> _Arpa:
    grams: List[List[Tuple[Tuple[str, ...], float, float]]] = []
    counts: List[int] = []
    current_n = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip("\r\n")
            s = line.strip()
            if s.startswith("ngram "):
                counts.append(int(s.split("=")[1]))
                continue
            if s.startswith("\\") and "-grams:" in s:
                current_n = int(s[1:s.index("-")])
                while len(grams) < current_n:
                    grams.append([])
                continue
            if not s or s.startswith("\\"):
                continue
            if current_n == 0:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            logp = float(parts[0])
            words = tuple(parts[1].split(" "))
            backoff = float(parts[2]) if len(parts) > 2 else 0.0
            if len(words) == current_n:
                grams[current_n - 1].append((words, logp, backoff))
    order = len(grams)
    if not counts:
        counts = [len(g) for g in grams]
    return _Arpa(order=order, counts=[len(g) for g in grams], grams=grams)


# -------------------------------------------------------------------- writer

def write_probing(arpa_path: str, out_path: str,
                  probing_multiplier: float = 1.5,
                  include_vocab_strings: bool = True) -> None:
    """Build a KenLM PROBING-format binary from a text ARPA file — the
    twin of ``build_binary probing in.arpa out.bin``."""
    write_probing_from(_parse_arpa(arpa_path), out_path,
                       probing_multiplier=probing_multiplier,
                       include_vocab_strings=include_vocab_strings)


def write_probing_from(arpa: "_Arpa", out_path: str,
                       probing_multiplier: float = 1.5,
                       include_vocab_strings: bool = True,
                       model_type: int = 0) -> None:
    """write_probing from an in-memory n-gram table (used by the TRIE
    reader's trie->probing conversion, decode/kenlm_trie.py).

    model_type 1 writes the REST_PROBING layout (``build_binary
    rest_probing``): unigram and middle entries carry a third f32 — the
    rest cost (lm/weights.hh RestWeights {prob, backoff, rest},
    packed to 4).  Full-context scoring never reads rest (it exists for
    KenLM's incomplete-context FullScoreForgotState API), so this writer
    stores prob as a placeholder rest value; real build_binary computes
    lower-order rest estimates there.  The READER side ignores the field
    entirely, so a real rest_probing artifact scores identically."""
    order = arpa.order
    rest = model_type == 1
    counts = list(arpa.counts)

    # word ids: <unk> is always 0; other words numbered in ARPA unigram
    # order (KenLM ProbingVocabulary insertion order)
    word_id: Dict[str, int] = {"<unk>": 0}
    id_word: List[str] = ["<unk>"]
    unk_values = (-100.0, 0.0)        # KenLM convention when <unk> absent
    for words, logp, bo in arpa.grams[0]:
        w = words[0]
        if w in ("<unk>", "<UNK>"):
            unk_values = (logp, bo)
            continue
        if w not in word_id:
            word_id[w] = len(id_word)
            id_word.append(w)
    bound = len(id_word)

    out = bytearray()
    # ---- Sanity
    magic = MAGIC + b"\0" * (_align8(len(MAGIC)) - len(MAGIC))
    out += magic
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\0" * 4                                   # align one_uint64
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    # ---- FixedWidthParameters + counts
    out += _PARAMS.pack(order, probing_multiplier, model_type,
                        1 if include_vocab_strings else 0, 0)
    for c in counts:
        out += struct.pack("<Q", c)
    out += b"\0" * (_align8(len(out)) - len(out))

    # ---- ProbingVocabulary
    out += struct.pack("<II", 0, bound)                # version, bound
    vb = _buckets(counts[0], probing_multiplier)
    vtable = bytearray(vb * 12)
    for w, wid in word_id.items():
        if wid == 0:
            continue                                   # <unk> never stored
        key = murmur64a(w.encode("utf-8"))
        slot = key % vb
        while True:
            if int.from_bytes(vtable[slot * 12:slot * 12 + 8],
                              "little") == 0:
                vtable[slot * 12:slot * 12 + 12] = struct.pack(
                    "<QI", key, wid)
                break
            slot = (slot + 1) % vb
    out += vtable

    # ---- Unigram array: (counts[0] + 1) entries by id — ProbBackoff
    # (8 B) for PROBING, RestWeights {prob, backoff, rest} (12 B) for
    # REST_PROBING
    ustride = 12 if rest else 8
    uni = bytearray((counts[0] + 1) * ustride)

    def pack_uni(lp, bo):
        return (struct.pack("<fff", lp, bo, lp) if rest
                else struct.pack("<ff", lp, bo))

    uni[0:ustride] = pack_uni(*unk_values)
    by_word = {w: (lp, bo) for (w,), lp, bo in
               ((g[0], g[1], g[2]) for g in arpa.grams[0])}
    for wid, w in enumerate(id_word):
        if wid == 0:
            continue
        lp, bo = by_word[w]
        uni[wid * ustride:(wid + 1) * ustride] = pack_uni(lp, bo)
    out += uni

    # ---- middle + longest probing tables
    def fill_table(entries, entry_size, pack_fn):
        nb = _buckets(len(entries), probing_multiplier)
        table = bytearray(nb * entry_size)
        for key, payload in entries:
            slot = key % nb
            while True:
                off = slot * entry_size
                if int.from_bytes(table[off:off + 8], "little") == 0:
                    table[off:off + entry_size] = pack_fn(key, payload)
                    break
                slot = (slot + 1) % nb
        return table

    def ids_of(words: Tuple[str, ...]) -> List[int]:
        return [word_id.get(w, 0) for w in words]

    mid_size = 20 if rest else 16
    mid_pack = ((lambda k, p: struct.pack("<Qfff", k, p[0], p[1], p[0]))
                if rest else
                (lambda k, p: struct.pack("<Qff", k, p[0], p[1])))
    for n in range(2, order):
        entries = [(chained_key(ids_of(words)), (lp, bo))
                   for words, lp, bo in arpa.grams[n - 1]]
        out += fill_table(entries, mid_size, mid_pack)
    if order > 1:
        entries = [(chained_key(ids_of(words)), lp)
                   for words, lp, _ in arpa.grams[order - 1]]
        out += fill_table(entries, 12,
                          lambda k, p: struct.pack("<Qf", k, p))

    # ---- vocabulary strings
    if include_vocab_strings:
        for w in id_word:
            out += w.encode("utf-8") + b"\0"

    with open(out_path, "wb") as f:
        f.write(bytes(out))


# -------------------------------------------------------------------- reader

def sniff(path: str) -> Optional[str]:
    """Return the KenLM model-type name if ``path`` is a KenLM binary,
    None if it looks like text ARPA / anything else."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
    except OSError:
        return None
    if head[:len(INCOMPLETE)] == INCOMPLETE:
        return "INCOMPLETE"
    if head not in (MAGIC, MAGIC_V4):
        return None
    with open(path, "rb") as f:
        f.seek(_SANITY_SIZE)
        fixed = f.read(_PARAMS.size)
    if len(fixed) < _PARAMS.size:
        return "TRUNCATED"
    _, _, model_type, _, _ = _PARAMS.unpack(fixed)
    return MODEL_TYPES.get(model_type, f"UNKNOWN({model_type})")


@dataclasses.dataclass
class Header:
    order: int
    probing_multiplier: float
    model_type: int
    has_vocabulary: bool
    search_version: int
    counts: List[int]
    data_offset: int            # first byte after the aligned header


def read_header(data: bytes) -> Header:
    if data[:len(MAGIC)] != MAGIC:
        if data[:len(MAGIC_V4)] == MAGIC_V4:
            raise ValueError(
                "KenLM binary format version 4 (pre-2013) is not "
                "supported; rebuild with a current build_binary or "
                "convert via tools/build_lm.py from the text ARPA")
        if data[:len(INCOMPLETE)] == INCOMPLETE:
            raise ValueError("KenLM binary is marked incomplete "
                             "(build_binary was interrupted)")
        raise ValueError("not a KenLM binary (magic mismatch)")
    z, one, mhalf = struct.unpack_from("<fff", data, _align8(len(MAGIC)))
    w1, wmax = struct.unpack_from("<II", data, _align8(len(MAGIC)) + 12)
    (u1,) = struct.unpack_from("<Q", data, _align8(len(MAGIC)) + 24)
    if (z, one, mhalf, w1, wmax, u1) != (0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1):
        raise ValueError(
            "KenLM sanity block mismatch: the binary was built on an "
            "incompatible platform (endianness or width)")
    order, mult, model_type, has_vocab, version = _PARAMS.unpack_from(
        data, _SANITY_SIZE)
    counts = list(struct.unpack_from(
        f"<{order}Q", data, _SANITY_SIZE + _PARAMS.size))
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"unknown KenLM model type {model_type}; known types are "
            f"{sorted(MODEL_TYPES.values())}")
    data_offset = _align8(_SANITY_SIZE + _PARAMS.size + 8 * order)
    return Header(order=order, probing_multiplier=mult,
                  model_type=model_type, has_vocabulary=bool(has_vocab),
                  search_version=version, counts=counts,
                  data_offset=data_offset)


class _ProbingTable:
    """Read-side open-addressing table over a memoryview."""

    __slots__ = ("mv", "entry_size", "buckets")

    def __init__(self, mv: memoryview, entry_size: int, buckets: int):
        self.mv = mv
        self.entry_size = entry_size
        self.buckets = buckets

    def find(self, key: int) -> Optional[int]:
        """Return the byte offset of the entry or None."""
        slot = key % self.buckets
        for _ in range(self.buckets):
            off = slot * self.entry_size
            got = int.from_bytes(self.mv[off:off + 8], "little")
            if got == key:
                return off
            if got == 0:
                return None
            slot = (slot + 1) % self.buckets
        return None


class KenLMBinary:
    """KenLM PROBING binary, scoring in natural log — an ArpaLM drop-in
    (asr_streaming_tpu_torch.decode.beam.ArpaLM duck type) for the Python beam
    decoder; the production C++ twin lives in
    native/beamsearch/beam_decoder.cc (KenLMProbing)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = f.read()
        data = memoryview(self._data)
        h = read_header(self._data)
        if h.model_type not in (0, 1):
            raise ValueError(
                f"KenLM model type {MODEL_TYPES[h.model_type]} is not a "
                "PROBING-family binary; open through load_lm "
                "(TRIE/QUANT_TRIE route to decode.kenlm_trie.KenLMTrie; "
                "Bhiksha ARRAY variants must be rebuilt or converted "
                "from the text ARPA with tools/build_lm.py)")
        self.header = h
        self.order = h.order
        # REST_PROBING (model_type 1) carries an extra f32 rest cost in
        # unigram and middle entries (lm/weights.hh RestWeights, packed
        # to 4).  prob/backoff occupy the same leading bytes and rest is
        # only consumed by KenLM's incomplete-context API, so standard
        # full-context scoring ignores it — this reader just widens the
        # strides.
        self._rest = h.model_type == 1
        self._ustride = 12 if self._rest else 8
        self._mid_size = 20 if self._rest else 16
        off = h.data_offset

        _version, self.bound = struct.unpack_from("<II", data, off)
        off += 8
        vb = _buckets(h.counts[0], h.probing_multiplier)
        self._vocab_table = _ProbingTable(data[off:off + vb * 12], 12, vb)
        off += vb * 12

        us = self._ustride
        self._unigram = data[off:off + (h.counts[0] + 1) * us]
        off += (h.counts[0] + 1) * us

        self._middles: List[_ProbingTable] = []
        ms = self._mid_size
        for n in range(2, h.order):
            nb = _buckets(h.counts[n - 1], h.probing_multiplier)
            self._middles.append(
                _ProbingTable(data[off:off + nb * ms], ms, nb))
            off += nb * ms
        self._longest = None
        if h.order > 1:
            nb = _buckets(h.counts[h.order - 1], h.probing_multiplier)
            self._longest = _ProbingTable(data[off:off + nb * 12], 12, nb)
            off += nb * 12

        self.words: List[str] = []
        if h.has_vocabulary:
            raw = self._data[off:]
            self.words = [w.decode("utf-8", errors="replace")
                          for w in raw.split(b"\0") if w]
            # tolerate both layouts seen in the wild: strings starting
            # at "<unk>" (id 0) or at id 1
            if self.words and self.words[0] != "<unk>":
                self.words = ["<unk>"] + self.words

    # ------------------------------------------------------------- lookups

    def word_id(self, word: str) -> int:
        key = murmur64a(word.encode("utf-8"))
        hit = self._vocab_table.find(key)
        if hit is None:
            return 0
        (wid,) = struct.unpack_from("<I", self._vocab_table.mv, hit + 8)
        return wid

    def _uni(self, wid: int) -> Tuple[float, float]:
        lp, bo = struct.unpack_from("<ff", self._unigram,
                                    wid * self._ustride)
        return lp, bo

    def _lookup(self, ids: Sequence[int]) -> Optional[Tuple[float, float]]:
        """(prob10, backoff10) of the exact n-gram, or None."""
        n = len(ids)
        if n == 1:
            if ids[0] >= self.bound:
                return None
            return self._uni(ids[0])
        key = chained_key(ids)
        if n == self.order:
            hit = self._longest.find(key)
            if hit is None:
                return None
            (lp,) = struct.unpack_from("<f", self._longest.mv, hit + 8)
            return lp, 0.0
        table = self._middles[n - 2]
        hit = table.find(key)
        if hit is None:
            return None
        lp, bo = struct.unpack_from("<ff", table.mv, hit + 8)
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
        return self._uni(ids[0])[0] * LOG10 if ids[0] < self.bound \
            else self._uni(0)[0] * LOG10


def load_lm(path: str):
    """Open ``path`` as a KenLM binary when it carries the format magic
    (PROBING here; TRIE/QUANT_TRIE via decode.kenlm_trie), else as text
    ARPA — the polymorphic entry the rescorer config uses (reference
    loads either through kenlm, recognition.py:236-245)."""
    kind = sniff(path)
    if kind is None:
        from asr_streaming_tpu_torch.decode.beam import ArpaLM
        return ArpaLM.from_arpa(path)
    if kind in ("TRIE", "QUANT_TRIE"):
        from asr_streaming_tpu_torch.decode.kenlm_trie import KenLMTrie
        return KenLMTrie(path)
    if kind in ("ARRAY_TRIE", "QUANT_ARRAY_TRIE"):
        raise ValueError(
            f"KenLM {kind} uses Bhiksha pointer compression, which is "
            "not implemented; rebuild the LM as probing/trie "
            "(build_binary [quantize] trie) or convert from the text "
            "ARPA with tools/build_lm.py")
    return KenLMBinary(path)
