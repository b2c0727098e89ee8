"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with nvcc for ``sm_90a`` into one
shared library with a plain C interface, bound with ctypes.  Each source
compiles in its own nvcc process, all started together, then one link.
The library is built at first use into ``_build/`` (git-ignored), named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already there.  The build holds a file
lock, so a device-worker child and its parent never run nvcc into the
same directory at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without nvcc never builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("emformer_stack.cu", "emission_append.cu", "emformer_attention.cu",
           "row_topk.cu")
# the wrapper modules whose LAUNCHES counters make up launch_counts():
# {row name: (module, counter attribute)}
COUNTERS = {
    "emformer_stack": ("emformer_stack", "LAUNCHES"),
    "emformer_stack_int8": ("emformer_stack", "LAUNCHES_INT8"),
    "emission_append": ("emission_append", "LAUNCHES"),
    "emformer_layer": ("emformer_layer", "LAUNCHES"),
    "emformer_attention": ("emformer_attention", "LAUNCHES"),
    "row_topk": ("row_topk", "LAUNCHES"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None      # the process's loaded library
# every entry's launches by CUDA device ordinal: which cards a mesh's
# shards really ran on
DEVICE_LAUNCHES: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libasr_kernels_{h.hexdigest()[:16]}.so")


def build() -> Tuple[str, float, str]:
    """Compile the sources (in parallel) and link the library.  Returns
    (path, build seconds, compiler output with the ptxas -v report);
    (path, 0.0, "") when the library for these sources already exists.
    Raises with the compiler output when nvcc fails."""
    target = _library_path()
    if os.path.exists(target):
        return target, 0.0, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if os.path.exists(target):            # another process built it
            return target, 0.0, ""
        return _build_locked(nvcc, target)


def _build_locked(nvcc: str, target: str) -> Tuple[str, float, str]:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs: List[str] = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, target)
    return target, time.perf_counter() - t0, "\n".join(logs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build()[0])
        for name in ("asr_emformer_stack", "asr_emformer_layer"):
            getattr(handle, name).argtypes = [ctypes.c_void_p]
            getattr(handle, name).restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        handle.asr_emformer_rows.argtypes = [ptr, i32]
        handle.asr_emformer_rows.restype = i32
        handle.asr_launch_counts.argtypes = [ptr]
        handle.asr_launch_counts.restype = i32
        handle.asr_quantize_rows.argtypes = [i32] + [ptr] * 3 + [i32] * 2 + [
            ptr]
        handle.asr_quantize_rows.restype = i32
        handle.asr_w8a8_linear.argtypes = [i32, i32] + [ptr] * 7 + [i32] * 5 \
            + [ptr]
        handle.asr_w8a8_linear.restype = i32
        handle.asr_emformer_attention.argtypes = [ptr] * 6 + [i32] * 9 + [
            ctypes.c_float, i32, i32, ptr]
        handle.asr_emformer_attention.restype = i32
        handle.asr_emformer_attention_plan.argtypes = [i32] * 11 + [ptr]
        handle.asr_emformer_attention_plan.restype = i32
        handle.asr_stack_attention_plan.argtypes = [i32] * 9 + [ptr]
        handle.asr_stack_attention_plan.restype = i32
        handle.asr_gemm_bf16.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        handle.asr_gemm_bf16.restype = i32
        handle.asr_gemm_bf16_pair.argtypes = [ptr] * 4 + [i32] * 2 + \
            [ptr] * 4 + [i32] * 4 + [ptr]
        handle.asr_gemm_bf16_pair.restype = i32
        handle.asr_gemm_f32.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        handle.asr_gemm_f32.restype = i32
        handle.asr_gemm_act_table.argtypes = [i32, ptr, ptr]
        handle.asr_gemm_act_table.restype = i32
        handle.asr_gemm_config.argtypes = [i32] * 4
        handle.asr_gemm_config.restype = i32
        handle.asr_emission_append.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        handle.asr_emission_append.restype = ctypes.c_int
        handle.asr_row_topk.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        handle.asr_row_topk.restype = i32
        handle.asr_cuda_error_string.argtypes = [ctypes.c_int]
        handle.asr_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a non-zero CUDA (or argument) code."""
    if code != 0:
        msg = lib().asr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: {msg} (code {code})")


def launch(device: torch.device, entry: str, what: str, *args) -> None:
    """Call the library's C entry ``entry`` with ``device`` the current
    CUDA device, and raise if it returned an error.  The kernels launch on
    the runtime's current device, so a stream of another card would be an
    invalid handle, and the per-device setup (``gemm_setup``) would read
    the wrong card."""
    with torch.cuda.device(device):
        check(getattr(lib(), entry)(*args), what)
        ordinal = torch.cuda.current_device()
    DEVICE_LAUNCHES[ordinal] = DEVICE_LAUNCHES.get(ordinal, 0) + 1


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        yield from _tensors(list(tree.values()))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def refuse_grad(what: str, *inputs) -> None:
    """Raise when autograd would record a kernel call: gradients are on
    and an input (a tensor, or a dict/list/tuple of them, such as a
    parameter tree) requires grad.  The kernels have no backward, and
    their outputs leave the graph, so every weight behind them would get
    no gradient at all; training runs the eager route instead."""
    if not torch.is_grad_enabled():
        return
    for t in _tensors(inputs):
        if t.requires_grad:
            raise RuntimeError(
                f"{what}: the CUDA kernel has no backward, and an input "
                "requires grad; train on the eager route "
                "(EmformerConfig(route='eager')) or call under "
                "torch.no_grad()")


def launch_counts(reset: bool = False) -> dict:
    """Each kernel's launch count in this process ({row name: count});
    ``reset`` sets them to 0 after reading."""
    out = {}
    for row, (mod_name, attr) in COUNTERS.items():
        mod = importlib.import_module(f"asr_streaming_tpu_torch.ops.{mod_name}")
        out[row] = getattr(mod, attr)
        if reset:
            setattr(mod, attr, 0)
    return out
