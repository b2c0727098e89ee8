#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a), with the
     ptxas register / shared-memory report;
  3. kernels vs their plain PyTorch versions at the serving shapes, with
     device times (torch.profiler, kernel execution only), the plain
     version's time, the card's bound and a library yardstick where one
     PyTorch call computes the same function, plus a device-time
     breakdown by kernel;
  4. the Vietnamese CTC serving tick at full width (512 slots, 20 layers,
     bf16, random weights from --seed), 10 ticks;
  5. the scheduler answering requests: 4 full-width streams get partials
     and finals; then the committed overfit fixture
     (assets/test_fixtures/overfit_ctc.npz) served on the card must give
     its exact golden transcript.
The kernels' launch counts are zeroed before phase 4 and read after the
full-width scheduler run.  The last line is the result JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # HBM3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int = 1):
    """Device time per call of fn, by kernel name, from torch.profiler's
    CUDA activity (kernel execution only: host gaps between launches do
    not count).  Returns (ms per call, [(ms per call, launches, name)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][-70:]
            rows.append((t / 1e3 / iters, e.count // iters, name))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def profile_top(fn, label: str, n: int = 8) -> None:
    total, rows = device_times(fn)
    log(f"[profile] {label}: device time {total:.3f} ms in "
        f"{sum(r[1] for r in rows)} kernel launches")
    for t, c, name in rows[:n]:
        log(f"[profile]   {t:8.3f} ms {100 * t / total:5.1f}% x{c:<4d} {name}")


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return card


def phase_build():
    from asr_streaming_tpu_torch.ops import _cuda
    path, seconds, build_log = _cuda.build()
    _cuda.lib()
    log(f"[build] {os.path.relpath(path, HERE)} in {seconds:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "bytes smem" in line or "spill" in line \
                or "Compiling entry" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")


def stack_flops(B, L, D, F, U, R, M, Lc) -> float:
    """Operations (2 per multiply-add) of one Emformer step, from the
    shapes: the five projections of every layer plus QK^T and PV."""
    T = U + R
    Q = T + (1 if M else 0)
    K = M + R + Lc + U
    per_layer = (2 * B * (Q * D * D + (M + T) * D * 2 * D + Q * D * D
                          + 2 * T * D * F) + 2 * 2 * B * Q * K * D)
    return float(L * per_layer)


def _stack_inputs(cfg, B, gen, device):
    import torch
    L, D = cfg.num_layers, cfg.d_model
    M, Lc = cfg.max_memory_size, cfg.left_context_length
    cdt = cfg.compute_dtype

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)

    mem = randn(L, B, M, D, dtype=cdt)
    lck = randn(L, B, Lc, D, dtype=cdt)
    lcv = randn(L, B, Lc, D, dtype=cdt)
    length = (torch.randint(0, 8, (B,), generator=gen) * cfg.segment_length
              + torch.randint(0, 3, (B,), generator=gen)).to(
        device=device, dtype=torch.int32)
    return mem, lck, lcv, length


def _mm_split_k(x2d, w, cdt):
    """The plain version's product summed as two half-K products: another
    valid f32 accumulation order, for the bf16 noise floor."""
    import torch
    h = x2d.shape[1] // 2
    a, b = x2d.to(cdt).float(), w.to(cdt).float()
    return (torch.matmul(a[:, :h], b[:h])
            + torch.matmul(a[:, h:], b[h:])).to(cdt)


def check_stack(cfg, B, n_ticks, tol, gen, device, label, relative=False):
    """Kernel A vs its plain version over chained ticks (state carried
    from the plain version, so each tick compares one step).

    relative=False: elementwise, |k - p| <= tol + tol * |p|.
    relative=True: ||k - p|| / ||p|| <= tol per tensor — for bf16 at 20
    layers, where two valid f32 accumulation orders already differ by more
    than tol in a few elements (rounding flips compound through the
    layers); the noise floor between two plain versions is printed."""
    import torch
    from asr_streaming_tpu_torch.models.emformer import init_emformer_params
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    params = init_emformer_params(gen, cfg, device)
    mem, lck, lcv, length = _stack_inputs(cfg, B, gen, device)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cfg.compute_dtype)
    T = cfg.segment_length + cfg.right_context_length
    worst = worst_rel = 0.0
    last = None
    for tick in range(n_ticks):
        x = torch.randn((B, T, cfg.d_model), generator=gen).to(device)
        reset = (torch.rand(B, generator=gen) < 0.15).to(device)
        advance = (torch.rand(B, generator=gen) < 0.8).to(device)
        eff = torch.where(reset, torch.zeros_like(length), length)
        got = es.emformer_stack(params, x, mem, lck, lcv, eff, reset,
                                advance, **kw)
        torch.cuda.synchronize()
        want = es.emformer_stack_plain(params, x, mem, lck, lcv, eff, reset,
                                       advance, **kw)
        for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{label} tick {tick} {name}: {g.shape} {g.dtype} vs "
                     f"{w.shape} {w.dtype}")
            if g.numel() == 0:
                continue
            gf, wf = g.float(), w.float()
            if not torch.isfinite(gf).all():
                fail(f"{label} tick {tick} {name}: non-finite kernel output")
            err = (gf - wf).abs().max().item()
            rel = ((gf - wf).norm() / wf.norm()).item()
            worst = max(worst, err)
            worst_rel = max(worst_rel, rel)
            if relative and rel > tol:
                fail(f"{label} tick {tick} {name}: relative error {rel:.3e}"
                     f" > {tol}")
            if not relative and not torch.allclose(gf, wf, rtol=tol,
                                                   atol=tol):
                bad = ((gf - wf).abs() > tol + tol * wf.abs()).sum().item()
                fail(f"{label} tick {tick} {name}: max |err| {err:.3e}, "
                     f"{bad} elements beyond rtol=atol={tol}")
        if relative and tick == 0:
            plain_mm = es._mm
            es._mm = _mm_split_k
            try:
                other = es.emformer_stack_plain(params, x, mem, lck, lcv, eff,
                                                reset, advance, **kw)
            finally:
                es._mm = plain_mm
            floor = max((o.float() - w.float()).abs().max().item()
                        for o, w in zip(other, want) if w.numel())
            log(f"[kernels] {label}: noise floor, max |plain(split-K) - "
                f"plain| = {floor:.3e}")
        _, mem, lck, lcv = want
        length = torch.where(advance, eff + cfg.segment_length, eff)
        last = (params, x, mem, lck, lcv, eff, reset, advance, kw)
    log(f"[kernels] {label}: {n_ticks} ticks, max |kernel - plain| = "
        f"{worst:.3e}, max relative L2 {worst_rel:.3e} "
        f"({'relative' if relative else 'elementwise'} tol {tol})")
    return worst, last


def phase_kernels(gen, device):
    import torch
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    from asr_streaming_tpu_torch.ops import emission_append as ea
    results = []

    # ---- kernel A at VI full width (B=512, D=512, H=8, F=2048, U=16, R=4,
    # Lc=32, M=4), 3 chained ticks with reset/advance churn and lengths
    # growing from mixed fills.
    B = 512
    # f32, 20 layers, elementwise 1e-4: only the f32 summation order
    # differs (two plain versions differ by ~1e-5 here)
    check_stack(EmformerConfig(compute_dtype=torch.float32), B, 3, 1e-4, gen,
                device, "A vi f32 L=20")
    # bf16 at the JAX package's own bf16 tolerance, elementwise 3e-2
    # (tests/test_pallas_emformer.py), at that test's depth of 3 layers
    check_stack(EmformerConfig(compute_dtype=torch.bfloat16, num_layers=3),
                B, 3, 3e-2, gen, device, "A vi bf16 L=3")
    # bf16, all 20 layers: relative L2 3e-2 per tensor (see check_stack)
    vi = EmformerConfig(compute_dtype=torch.bfloat16)
    err_a, last = check_stack(vi, B, 3, 3e-2, gen, device, "A vi bf16 L=20",
                              relative=True)
    # M=0 (no memory, the EN transcriber's layout) at VI widths
    en = EmformerConfig(compute_dtype=torch.bfloat16, max_memory_size=0,
                        num_layers=4, segment_length=4,
                        right_context_length=1, left_context_length=12)
    check_stack(en, 64, 2, 3e-2, gen, device, "A M=0 bf16 L=4")

    params, x, mem, lck, lcv, eff, reset, advance, kw = last

    def kernel_a():
        return es.emformer_stack(params, x, mem, lck, lcv, eff, reset,
                                 advance, **kw)

    def plain_a():
        return es.emformer_stack_plain(params, x, mem, lck, lcv, eff, reset,
                                       advance, **kw)

    wall_ms = cuda_ms(kernel_a, 10)
    ms = device_times(kernel_a, 5)[0]
    plain_ms = device_times(plain_a, 2)[0]
    profile_top(kernel_a, "A emformer_stack, one VI step at 512 slots")
    L, D, Fd = vi.num_layers, vi.d_model, vi.ffn_dim
    flops = stack_flops(B, L, D, Fd, vi.segment_length,
                        vi.right_context_length, vi.max_memory_size,
                        vi.left_context_length)
    w_bytes = 2 * L * (4 * D * D + 2 * D * Fd + 5 * D + Fd) + 4 * L * 6 * D
    state_bytes = 2 * (mem.numel() + lck.numel() + lcv.numel())
    io_bytes = (x.numel() * 4 + B * 6 + B * vi.segment_length * D * 4
                + 2 * state_bytes + w_bytes)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = io_bytes / PEAK_BYTES * 1e3
    log(f"[kernels] A: {ms:.3f} ms/step device time, {wall_ms:.3f} ms "
        f"between CUDA events (plain {plain_ms:.3f} ms device), "
        f"{flops / 1e12:.3f} TFLOP, {io_bytes / 1e9:.3f} GB, "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    results.append({
        "name": "emformer_stack", "route": "cuda",
        "source": "asr_streaming_tpu_torch/csrc/emformer_stack.cu",
        "replaces": "asr_streaming_tpu/ops/pallas_emformer.py:642",
        "launches": 0, "max_abs_err": err_a, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None})

    # ---- kernel B: VI serving shape, exact equality with the plain version
    max_t, U, V = 1024, 16, 803
    buf0 = torch.randn((B, max_t, V), generator=gen).to(
        device=device, dtype=torch.float16)
    rows = torch.randn((B, U, V), generator=gen).to(device)
    pos = (torch.randint(0, max_t // U, (B,), generator=gen) * U).to(
        device=device, dtype=torch.int32)
    decode = (torch.rand(B, generator=gen) < 0.8).to(device)
    got = ea.emission_append(buf0.clone(), rows, pos, decode)
    want = ea.emission_append_plain(buf0.clone(), rows, pos, decode)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("B: kernel differs from the plain version")
    del got, want
    buf = buf0.clone()
    ms_b = device_times(lambda: ea.emission_append(buf, rows, pos, decode),
                        100)[0]
    plain_b = device_times(lambda: ea.emission_append_plain(buf, rows, pos,
                                                            decode), 20)[0]
    dec_b = decode.nonzero()[:, 0]
    b_idx = dec_b.view(-1, 1)
    t_idx = pos[dec_b].long().view(-1, 1) + torch.arange(U, device=device)
    rows_sel = rows[dec_b]

    def library():
        # advanced-index assignment (index_put_ takes the buffer's dtype,
        # so the f32 -> f16 cast is part of the yardstick)
        buf.index_put_((b_idx, t_idx), rows_sel.to(torch.float16))

    lib_b = device_times(library, 100)[0]
    nd = int(dec_b.numel())
    bytes_b = nd * U * V * (4 + 2) + B * (4 + 1)
    log(f"[kernels] B: exact; {ms_b * 1e3:.1f} us (plain {plain_b * 1e3:.1f}"
        f" us, index_put {lib_b * 1e3:.1f} us), {nd} of {B} slots decode")
    results.append({
        "name": "emission_append", "route": "cuda",
        "source": "asr_streaming_tpu_torch/csrc/emission_append.cu",
        "replaces": "asr_streaming_tpu/ops/pallas_append.py:109",
        "launches": 0, "max_abs_err": 0.0, "ms": ms_b, "plain_ms": plain_b,
        "bound_ms": bytes_b / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": lib_b})
    del buf0, buf
    torch.cuda.empty_cache()
    return results


def phase_serving(gen, device, n_ticks=10):
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.serving import (
        PACK_DATA, ServingConfig, init_audio_context, init_emission_buffer,
        init_serving_params, init_serving_state, serving_step,
    )
    B = 512
    cfg = ServingConfig(asr=ASRConfig.vietnamese(torch.bfloat16),
                        use_silero=False, upload_encoding="mulaw")
    params = init_serving_params(gen, cfg, device)
    state = init_serving_state(cfg, B, device)
    ctx = init_audio_context(cfg, B, device)
    buf = init_emission_buffer(cfg, B, device)
    seg_len = cfg.asr.audio.segment_length
    U = cfg.asr.encoder.emformer.segment_length
    ones = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, dtype=torch.bool, device=device)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for t in range(n_ticks):
        seg = torch.randint(0, 256, (B, seg_len), generator=gen,
                            dtype=torch.uint8).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serving_step(params, cfg, seg, ones if t else zeros, ones,
                           zeros if t else ones, zeros if t else ones,
                           state, ctx, buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        state, ctx, buf = out.state, out.ctx, out.emission
        pack = out.pack
        if tuple(pack.shape) != (B, PACK_DATA + U):
            fail(f"pack shape {tuple(pack.shape)}")
        if not torch.isfinite(pack).all():
            fail("non-finite pack")
    profile_top(lambda: serving_step(params, cfg, seg, ones, ones, zeros,
                                     zeros, state, ctx, buf),
                "one serving tick at 512 slots", n=12)
    decoded = int(pack[:, 0].sum().item())
    rows = buf[:, :n_ticks * U].float()
    if not torch.isfinite(rows).all():
        fail("non-finite emission rows")
    lse = torch.logsumexp(rows, -1)
    if (lse - 0.0).abs().max().item() > 5e-2:
        fail(f"emission rows are not log-probs (max |logsumexp| "
             f"{(lse).abs().max().item():.3e})")
    if int(state.length.min().item()) != n_ticks * U:
        fail(f"lengths {state.length.min().item()} != {n_ticks * U}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(times[1:])
    log(f"[serving] {n_ticks} ticks x {B} slots: first {times[0] * 1e3:.1f} "
        f"ms, median {steady[len(steady) // 2] * 1e3:.2f} ms, min "
        f"{steady[0] * 1e3:.2f} ms; {decoded} slots decoded on the last "
        f"tick; peak {peak:.2f} GiB")
    return params, cfg


def phase_scheduler(params, cfg, device):
    import numpy as np
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    # hard flush at 1.9 s: random weights emit no trailing silence
    rules = {"flush": EndpointRule(must_contain_nonsilence=False,
                                   min_trailing_silence=0.0,
                                   min_utterance_length=1.9,
                                   max_relative_cost=float("inf"))}
    sched = Scheduler(params, cfg, placeholder_vocab(cfg.asr.encoder.vocab_size),
                      max_slots=512, rules=rules, device=device)
    warm = sched.warmup()
    rng = np.random.default_rng(7)
    streams = []
    for i in range(4):
        s = sched.admit(f"s{i}")
        t = np.arange(int(16000 * 3.2)) / 16000
        audio = (0.2 * np.sin(2 * np.pi * (300 + 200 * i) * t)
                 + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
        s.accept_waveform(audio)
        s.add_tail_padding()
        streams.append(s)
    t0 = time.perf_counter()
    events = sched.drain()
    dt = time.perf_counter() - t0
    for s in streams:
        partials = [e for e in events if e.stream_id == s.id
                    and e.kind == "partial"]
        finals = [e for e in events if e.stream_id == s.id
                  and e.kind == "final"]
        if not partials or not finals:
            fail(f"stream {s.id}: {len(partials)} partials, {len(finals)} "
                 "finals")
        seg = finals[0].segment
        if seg.length and not np.isfinite(seg.emission).all():
            fail(f"stream {s.id}: non-finite fetched emission")
    log(f"[scheduler] 4 streams x 3.2 s at 512 slots: {sched.ticks} ticks in "
        f"{dt:.2f} s (warmup {warm:.2f} s), {len(events)} events, "
        f"tick p50 {sched.timers.snapshot()['stages']['tick']['p50_ms']} ms")


def _sentence_audio(s, total, sr=16000):
    """The tone sentences of tests/test_overfit_e2e.py."""
    import numpy as np
    tone_hz = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0, " ": 1000.0}
    parts = []
    for ch in s:
        t = np.arange(int(sr * 0.24)) / sr
        wave = 0.3 * np.sin(2 * np.pi * tone_hz[ch] * t)
        ramp = np.minimum(1.0, np.arange(len(t)) / (0.010 * sr))
        parts.extend([(wave * ramp * ramp[::-1]).astype(np.float32),
                      np.zeros(int(sr * 0.08), np.float32)])
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(sr * total) - len(audio)))


def phase_golden(device):
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.serving import (
        ServingConfig, init_serving_params,
    )
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, params_from_numpy,
    )
    path = os.path.join(HERE, "assets", "test_fixtures", "overfit_ctc.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    loaded = params_from_numpy(load_params(path), device)
    vocab = ["-", "|", "a", "b", "c", "d"]
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(vocab)),
                        use_silero=False, use_energy_gate=False,
                        energy_threshold_db=-200.0)
    params = init_serving_params(1, cfg, device)
    params["frontend"] = loaded["frontend"]
    params["encoder"] = loaded["encoder"]
    rules = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
    sched = Scheduler(params, cfg, vocab, max_slots=2, rules=rules,
                      device=device)
    s = sched.admit("t0")
    s.accept_waveform(_sentence_audio(golden, 3.84))
    s.add_tail_padding()
    events = sched.drain()
    finals = [e.text.strip() for e in events if e.kind == "final"]
    partials = [e.text.strip() for e in events
                if e.kind == "partial" and e.text.strip()]
    if golden not in finals:
        fail(f"golden {golden!r} not among finals {finals}")
    if not partials or not all(golden.startswith(p) for p in partials):
        fail(f"partials do not grow toward {golden!r}: {partials}")
    log(f"[golden] overfit_ctc on the card: final {finals}, partials "
        f"{partials}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "asr_streaming_tpu_torch")):
        fail("asr_streaming_tpu_torch/ is not beside this script")
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    device = torch.device("cuda", 0)
    import asr_streaming_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    from asr_streaming_tpu_torch.ops import emission_append as ea
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    kernels = phase_kernels(gen, device)

    # the main path: the counts cover the full-width ticks and the
    # full-width scheduler run
    es.LAUNCHES = 0
    ea.LAUNCHES = 0
    params, cfg = phase_serving(gen, device)
    phase_scheduler(params, cfg, device)
    launches = {"emformer_stack": es.LAUNCHES, "emission_append": ea.LAUNCHES}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            fail(f"kernel {k['name']} was not launched on the main path")
    del params
    torch.cuda.empty_cache()
    phase_golden(device)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
