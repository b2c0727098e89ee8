"""The traced part of a ``--trace 1`` run: torch.profiler over a bounded
steady part of the window, reduced to what the per-layer readers need.

The profiler's Chrome trace is written to a temporary file, read back and
deleted.  From it: every device operation's interval (kernels, copies and
fills: their union is ``busy_s``), each kernel's records and time by its
base name (``void gemm_bf16_wgmma_kernel<...>(...)`` -> ``gemm_bf16_wgmma``)
and the benchmark's own host spans (``bench.*``), which name the longest
idle gaps.  The profiler drops kernel records now and then, so the
library's own launch counters are read at both ends of the traced part;
``kernel_time`` scales a kernel's recorded time per launch to the counted
launches and reports the number missing.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.stats import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def base_name(name: str) -> str:
    """A kernel's name without return type, namespace, template arguments,
    parameters and ``_kernel`` suffix."""
    n = name.replace("(anonymous namespace)::", "").split("(")[0]
    n = n.split("<")[0].replace("void ", "").strip()
    n = n.split("::")[-1]
    return n[:-len("_kernel")] if n.endswith("_kernel") else n


def counters() -> dict:
    """The port's launch counters: its wrappers' calls and, on the card,
    the kernel library's own per-kernel counts."""
    from asr_streaming_tpu_torch.ops import _cuda
    out = {f"call.{k}": v for k, v in _cuda.launch_counts().items()}
    if torch.cuda.is_available():
        from asr_streaming_tpu_torch.ops import emformer_stack as es
        out.update({f"kernel.{k}": v
                    for k, v in es.kernel_launch_counts().items()})
    return out


class TraceSummary:
    def __init__(self, window_s, busy_s, kernels, gaps, counted):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels          # base name -> [records, seconds]
        self.gaps = gaps                # [(seconds, span name)] longest first
        self.counted = counted          # counter -> launches in the part

    def steps(self, name="call.emformer_stack") -> int:
        return int(self.counted.get(name, 0))

    def kernel_time(self, names, counter: Optional[str] = None,
                    counted: Optional[int] = None) -> Optional[float]:
        """Seconds of the kernels ``names`` (base names) in the traced
        part, each scaled to its counted launches when records are
        missing.  ``counter`` maps a base name to its library counter
        (``kernel.<x>``) or ``counted`` gives the launches of one name.
        None when a counted kernel has no record at all."""
        total = 0.0
        for name in names:
            rec, secs = self.kernels.get(name, (0, 0.0))
            n = counted if counted is not None else (
                self.counted.get(counter(name)) if counter else None)
            if n is None:
                total += secs
                continue
            if n and not rec:
                print(f"[trace] {name}: {n} launches counted, no record",
                      file=sys.stderr)
                return None
            if rec < n:
                print(f"[trace] {name}: {n - rec} of {n} records missing; "
                      "its time scaled to the counted launches",
                      file=sys.stderr)
                secs = secs / rec * n
            total += secs
        return total

    def device_ops(self, top=10) -> List[list]:
        rows = sorted(((v[1], k) for k, v in self.kernels.items()),
                      reverse=True)[:top]
        return [[k, s] for s, k in rows]


def summarize(events: List[dict], window_s: float, counted: dict) -> TraceSummary:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "dur" in e]
    busy_us, merged = union_seconds((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                    for e in dev)
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels[base_name(e["name"])]
            k[0] += 1
            k[1] += float(e["dur"]) * 1e-6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"][len(SPAN_PREFIX):]) for e in events
                   if e.get("ph") == "X" and str(e.get("name", "")).startswith(SPAN_PREFIX))
    longest = sorted(((b - a, a, b) for (_, a), (b, _) in
                      zip(merged, merged[1:])), reverse=True)[:10]
    gaps: List[Tuple[float, str]] = []
    for length, a, b in longest:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid < s[1]]
        # the innermost span: the latest to start
        gaps.append((length * 1e-6, inner[-1][2] if inner else "outside tick"))
    return TraceSummary(window_s, busy_us * 1e-6, dict(kernels), gaps, counted)


class Tracer:
    """Profiles from ``start`` to ``stop``; ``summary`` afterwards."""

    def __init__(self):
        self.summary: Optional[TraceSummary] = None
        self.active = False
        self.done = False

    def warm(self):
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's initialisation) stays out of the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu").add_(1)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.c0 = counters()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.t_end = time.perf_counter()     # stopping takes a while
        self.active = False
        self.done = True
        c1 = counters()
        self._part = (t1 - self.t0, {k: c1[k] - self.c0.get(k, 0) for k in c1})

    def finish(self):
        """Read the profile back (after the window: it takes seconds)."""
        if not self.done:
            return
        window_s, counted = self._part
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        self.summary = summarize(events, window_s, counted)
