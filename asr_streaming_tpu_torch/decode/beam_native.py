"""ctypes bindings for the C++ lexicon+LM beam decoder.

Counterpart of asr_streaming_tpu/decode/beam_native.py, with the same API
(``NativeBeamDecoder``, ``make_native_rescorer``): the final-segment
rescorer of the Vietnamese server.  The library is built from
``native/beamsearch/beam_decoder.cc`` with that directory's Makefile flags
into this package's ``_build/`` (git-ignored), named by a hash of the
compiler, flags, source and the host CPU's feature flags
(utils/native_build.py), at first use and under a file lock, with the
``g++`` on ``PATH`` (libstdc++ linked dynamically); nothing is built in
``native/``.  Without a C++ compiler ``make_native_rescorer`` returns
None and the server takes the Python beam (decode/beam.py).
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from asr_streaming_tpu_torch.decode.greedy import (
    BLANK_ID, FRAME_SECONDS, SILENCE_ID,
)
from asr_streaming_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "beamsearch",
                      "beam_decoder.cc")
BUILD_DIR = native_build.BUILD_DIR

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> str:
    return native_build.library_path(SOURCE, "asrbeam")


def build() -> Optional[str]:
    """Compile the decoder (once; a later call finds the library).
    Returns its path, or None when there is no C++ compiler.  Raises with
    the compiler's output when the compile fails."""
    return native_build.build(SOURCE, "asrbeam")


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.asr_decoder_create.restype = ctypes.c_void_p
        lib.asr_decoder_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.asr_decoder_decode.restype = ctypes.c_int
        lib.asr_decoder_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.asr_decoder_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_library() is not None


class NativeBeamDecoder:
    def __init__(self, vocab: Sequence[str], lexicon_path: str,
                 lm_path: Optional[str] = None, lm_weight: float = 1.0,
                 beam_size: int = 50, beam_size_token: int = 5,
                 beam_threshold: float = 50.0, word_score: float = 0.5,
                 blank: int = BLANK_ID, silence: int = SILENCE_ID,
                 frame_seconds: float = FRAME_SECONDS):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("no C++ compiler: libasrbeam unavailable")
        self._lib = lib
        if lm_path:
            # the C++ LM loader reads text ARPA and KenLM PROBING; a
            # TRIE-family asset is converted to its probing twin once
            # and cached (decode/kenlm_trie.py)
            from asr_streaming_tpu_torch.decode.kenlm_trie import (
                ensure_native_lm,
            )
            lm_path = ensure_native_lm(lm_path)
        self.vocab = list(vocab)
        arr = (ctypes.c_char_p * len(self.vocab))(
            *[t.encode("utf-8") for t in self.vocab])
        self._handle = lib.asr_decoder_create(
            lexicon_path.encode(), (lm_path or "").encode(), arr,
            len(self.vocab), lm_weight, beam_size, beam_size_token,
            beam_threshold, word_score, blank, silence, frame_seconds)
        if not self._handle:
            raise RuntimeError(
                f"decoder init failed (lexicon={lexicon_path}, lm={lm_path})")

    def decode_full(self, emission: np.ndarray, offset: int = 0) -> Dict:
        """emission: [T, V] float32 log-probs ->
        {transcript, score, alignment} (alignment in reference format)."""
        em = np.ascontiguousarray(emission, dtype=np.float32)
        T, V = em.shape
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.asr_decoder_decode(
            self._handle, em.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, V, offset, buf, cap)
        if n < 0:
            raise RuntimeError("output buffer too small")
        return json.loads(buf.value.decode("utf-8"))

    def decode(self, emission: np.ndarray, offset: int = 0) -> List[Dict]:
        return self.decode_full(emission, offset)["alignment"]

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.asr_decoder_destroy(self._handle)
            self._handle = None


def make_native_rescorer(vocab: Sequence[str], lexicon_path: str,
                         lm_path: Optional[str] = None, **kwargs):
    """FinalSegment -> alignment callable (native), or None when there is
    no C++ compiler to build the library."""
    if not native_available():
        return None
    decoder = NativeBeamDecoder(vocab, lexicon_path, lm_path, **kwargs)

    def rescore(segment) -> List[Dict]:
        emission = segment.emission[:segment.length]
        return decoder.decode(emission, offset=segment.offset)

    return rescore
