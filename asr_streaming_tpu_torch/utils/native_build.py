"""Builds the repository's host C++ libraries (``native/*/*.cc``) for the
port: into this package's ``_build/`` (git-ignored), named by a hash of
the compiler, the flags, the source and the host CPU's feature flags
(the code is built with ``-march=native`` and must not run on another
CPU), at first use and under a file lock, with the ``g++`` on ``PATH``.
Nothing is built in or loaded from ``native/``, and ``$CXX`` is not used:
a compiler driver that links libstdc++ statically gives a library that
loads into Python and then crashes in its first call.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# native/*/Makefile's CXXFLAGS, plus -shared
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")


def compiler() -> Optional[str]:
    return shutil.which("g++")


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return ""


def library_path(source: str, name: str) -> str:
    h = hashlib.sha256(" ".join((compiler() or "",) + CXX_FLAGS).encode())
    h.update(_cpu_flags().encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(source: str, name: str) -> Optional[str]:
    """Compile ``source`` into ``_build/lib<name>_<hash>.so`` (once; a
    later call finds the library).  Returns its path, or None when there
    is no C++ compiler.  Raises with the compiler's output when the
    compile fails."""
    target = library_path(source, name)
    if os.path.exists(target):
        return target
    cxx = compiler()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}_lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if os.path.exists(target):            # another process built it
            return target
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = os.path.join(tmp, "lib.so")
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_lib, source],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {source}:\n{out.stdout}")
            os.replace(tmp_lib, target)
    return target
