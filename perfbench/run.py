"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its files are found by name:
``perfbench/workloads/<cell>.json`` (serving overrides, the traced part,
the check's sample and limits), ``perfbench/configs/<config>.json`` (the
model and its serving settings), ``perfbench/traffic/<traffic>.json`` (the
mix) and ``perfbench/metrics/<metric>.py`` (one reader a metric).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the traced part's device time.
Either way the sampled streams are checked against the plain reference
after the window; each compared number is printed beside its limit as the
last lines on standard error and under ``checks``, the line's last key.

Options for defining the benchmark, which a measured run never passes:
``--control int8`` runs the program's own W8A8 path, the precision below
the configuration's bf16 encoder, and ``--control tf32`` the program with
TF32 on, the precision below its float32 products (the predictor and the
joiner of the device beam): the controls that have to fail the check;
``--sweep N1,N2,...`` runs a paced cell at each stream count without the
check and prints one line each (the knee search); ``--dump F.npz`` keeps
the check's per-frame and per-hypothesis errors.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), without the port's package, or when a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports in a run of this kind."""
    if not trace:
        return [m for m in manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def read_metrics(entries, run) -> dict:
    out = {}
    for m in entries:
        value = load_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            print(f"[metric] {m['name']}: nothing to read in this run",
                  file=sys.stderr)
    return out


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not readable"
    return f"[device] {out}"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8", "tf32"), default=None)
    p.add_argument("--sweep", default=None)
    p.add_argument("--dump", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    entry = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import asr_streaming_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        print(f"the port's package is missing: {e}", file=sys.stderr)
        return 2
    from perfbench import harness

    cell = harness.load_cell(args.workload, manifest)
    print(power_line(), file=sys.stderr)
    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if args.sweep:
        from perfbench.sweep import sweep
        for line in sweep(cell, args.seed, args.seconds,
                          [int(x) for x in args.sweep.split(",")]):
            print(json.dumps(line), flush=True)
        return 0
    run, numbers, peak, tracer = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda",
        quant="int8" if args.control == "int8" else None)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    if run.lateness_s:
        from perfbench.stats import percentile
        late = [x * 1e3 for x in run.lateness_s]
        print(f"[traffic] generator lateness ms: p50 {percentile(late, 50)} "
              f"p95 {percentile(late, 95)} max {max(late)} over {len(late)} "
              "chunks", file=sys.stderr)
    if run.latency_parts:
        from perfbench.stats import percentile
        parts = [(percentile(x, 50) * 1e3, percentile(x, 95) * 1e3)
                 for x in run.latency_parts if x]
        print("[latency] p50/p95 ms by 5 s part of the window: " + " ".join(
            f"{a:.2f}/{b:.2f}" for a, b in parts), file=sys.stderr)
    if run.tick_s:
        from perfbench.stats import percentile
        ms = [x * 1e3 for x in run.tick_s]
        print(f"[host] ticks {len(ms)}: p50 {percentile(ms, 50)} ms, p99 "
              f"{percentile(ms, 99)} ms, longest {max(ms)} ms",
              file=sys.stderr)
    if run.host:
        print("[host] window: " + " ".join(f"{k} {v}" for k, v in
                                           run.host.items()), file=sys.stderr)
    if run.gc_pauses_s:
        print(f"[host] collector pauses in the window: "
              f"{len(run.gc_pauses_s)}, {sum(run.gc_pauses_s)} s in all, "
              f"longest {max(run.gc_pauses_s)} s", file=sys.stderr)
    items = numbers.pop("_items", {})
    if args.dump:
        import numpy as np
        np.savez_compressed(args.dump, **items)
    print("[check] " + " ".join(f"{k} {v}" for k, v in numbers.items()),
          file=sys.stderr)
    correct, checks = harness.judge(numbers, cell.work["check"]["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(run.attempted),
              "failed": int(run.failed),
              "metrics": read_metrics(cell_metrics(
                  manifest, args.workload, bool(args.trace)), run),
              "device": device}
    if args.trace:
        t = run.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {
            "device_ops": t.device_ops(),
            "idle_gaps": [[name, secs] for secs, name in t.gaps]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"[limit] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
