"""ctypes bindings for the native host audio codec (mu-law / int16 encode).

Copied from asr_streaming_tpu/utils/codec_native.py (its fused gather
entry, the one the scheduler calls), with the port's build: the library
is compiled from ``native/audio/mulaw.cc`` with that directory's
Makefile flags into this package's ``_build/`` (git-ignored),
named by a hash of the compiler, flags, source and the host CPU's feature
flags (``-march=native`` code must not run on another CPU), at first use
and under a file lock, with the ``g++`` on ``PATH``.  The committed
``native/audio/`` tree is never built into or loaded from, and ``$CXX`` is
not used: a g++ that links libstdc++ statically gives a library that
crashes inside Python.

The scheduler's tick encodes every ready stream's new-segment audio; the
fused entry (``gather_encode_into``) reads each stream's float32 view and
writes its staging row in one pass, fanned out over the library's
persistent row pool.  That pool takes one caller at a time (its ``Run``
is not reentrant), so every gather call here holds one process-wide lock:
the groups of a ``GroupedScheduler`` and a server's tick thread may call
it from different threads.  The numpy LUT (models/serving.py) is the
bit-identical fallback.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from asr_streaming_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "audio", "mulaw.cc")
BUILD_DIR = native_build.BUILD_DIR

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()
# RowPool::Run (native/audio/mulaw.cc) takes one caller at a time
_pool_lock = threading.Lock()


def library_path() -> str:
    return native_build.library_path(SOURCE, "asrcodec")


def build() -> Optional[str]:
    """Compile the codec (once; a later call finds the library).  Returns
    its path, or None when there is no C++ compiler.  Raises with the
    compiler's output when the compile fails."""
    return native_build.build(SOURCE, "asrcodec")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        P, n = ctypes.POINTER, ctypes.c_int64
        for name, out in (("asr_mulaw_gather_encode", ctypes.c_uint8),
                          ("asr_pcm16_gather_encode", ctypes.c_int16)):
            fn = getattr(lib, name)
            fn.argtypes = [P(ctypes.c_uint64), P(out), P(ctypes.c_int32),
                           n, n, n]
            fn.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def gather_encode_into(views, slots: np.ndarray, out: np.ndarray,
                       mulaw: bool) -> bool:
    """Fused per-stream gather + encode (one C++ pass).

    Row i of the call encodes ``views[i]`` (a stream's new-segment float32
    view, zero-copy) straight into ``out[slots[i]]``.  Callers check
    :func:`native_available` FIRST and only then pop the stream views —
    the pops are destructive, so there is no in-call fallback.  Rows of
    ``out`` not named in ``slots`` are untouched."""
    lib = _load()
    if lib is None:
        return False
    rows = len(views)
    if rows == 0:
        return True
    # the native loop trusts every pointer, length and slot it is given
    cols = out.shape[1]
    want = np.uint8 if mulaw else np.int16
    if (out.ndim != 2 or out.dtype != want or not out.flags.c_contiguous
            or slots.dtype != np.int32 or slots.shape != (rows,)
            or slots.min() < 0 or slots.max() >= out.shape[0]):
        raise ValueError("gather_encode_into: out must be a C-contiguous "
                         f"[slots, n] {np.dtype(want)} matrix and slots "
                         "int32 row indices into it, one per view")
    ptrs = np.empty(rows, np.uint64)
    for i, v in enumerate(views):
        if not (v.dtype == np.float32 and v.flags.c_contiguous
                and v.size == cols):
            raise ValueError(f"gather_encode_into: view {i} is not "
                             f"{cols} contiguous float32 samples")
        ptrs[i] = v.ctypes.data
    p_ptrs = ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    p_slots = slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    with _pool_lock:
        if mulaw:
            lib.asr_mulaw_gather_encode(
                p_ptrs, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                p_slots, rows, cols, out.strides[0])
        else:
            lib.asr_pcm16_gather_encode(
                p_ptrs, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                p_slots, rows, cols, out.strides[0] // 2)
    return True
