"""ctypes bindings for the native frame VAD (``native/vad/frame_vad.cc``).

Host-side first-stage speech gate with the reference's webrtcvad API shape
(reference: stream.py:54-55 ``webrtcvad.Vad(aggressiveness)``,
``is_speech(frame_bytes, sample_rate)`` over 30 ms frames).  The default
serving path gates on device (models/vad.py); this native VAD serves
host-side tools (offline segmentation, clients) and deployments that want
the reference's exact gating topology.

Copied from asr_streaming_tpu/models/frame_vad.py, with the port's build
(utils/native_build.py): the library is compiled from the source into
this package's ``_build/`` with the ``g++`` on ``PATH``.  The committed
``native/vad/libframevad.so`` (built for another CPU) is never loaded and
``make`` (whose Makefile honours ``$CXX``) is never run.  Without a C++
compiler ``FrameVad`` raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from asr_streaming_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "vad", "frame_vad.cc")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> str:
    return native_build.library_path(SOURCE, "framevad")


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = native_build.build(SOURCE, "framevad")
        if path is None:
            raise RuntimeError(f"no g++ on PATH to build {SOURCE}")
        lib = ctypes.CDLL(path)
        lib.frame_vad_create.restype = ctypes.c_void_p
        lib.frame_vad_create.argtypes = [ctypes.c_int]
        lib.frame_vad_is_speech.restype = ctypes.c_int
        lib.frame_vad_is_speech.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
            ctypes.c_int]
        lib.frame_vad_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class FrameVad:
    """webrtcvad-compatible surface: Vad(aggressiveness).is_speech(...)"""

    def __init__(self, aggressiveness: int = 2):
        lib = _load()
        self._lib = lib
        self._handle = lib.frame_vad_create(aggressiveness)
        if not self._handle:
            raise ValueError(f"bad aggressiveness {aggressiveness}")

    def is_speech(self, frame: bytes, sample_rate: int) -> bool:
        buf = np.frombuffer(frame, dtype=np.int16)
        r = self._lib.frame_vad_is_speech(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(buf), sample_rate)
        if r < 0:
            raise ValueError(
                f"invalid frame length {len(buf)} @ {sample_rate} Hz")
        return bool(r)

    def contains_speech(self, audio: np.ndarray, sample_rate: int = 16000,
                        frame_ms: int = 30) -> bool:
        """Early-exit scan over 30 ms frames (the reference's
        Stream.detect_speech loop, stream.py:166-188)."""
        n = int(sample_rate * frame_ms / 1000)
        pcm = (np.clip(np.asarray(audio), -1, 1) * 32767).astype(np.int16)
        for i in range(0, len(pcm) - n + 1, n):
            if self.is_speech(pcm[i:i + n].tobytes(), sample_rate):
                return True
        return False

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.frame_vad_destroy(self._handle)
            self._handle = None
