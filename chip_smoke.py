#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a), with the
     ptxas register / shared-memory report;
  3. kernels vs their plain PyTorch versions at the serving shapes (512
     slots, chained ticks with reset/advance churn): A (the Emformer
     stack) in f32/bf16 and in its W8A8 modes, B (emission append), C
     (one Emformer layer) against its plain version and bit for bit
     against A, in bf16 and int8, and D (the f32 attention core); with
     device times (torch.profiler, kernel execution only), the plain
     version's time, the card's bound and a library yardstick where one
     PyTorch call computes the same function, plus a device-time
     breakdown by kernel and the int8 product beside torch._int_mm;
  4. the Vietnamese CTC serving tick at full width (512 slots, 20 layers,
     bf16, random weights from --seed): 10 ticks of the default route
     (stack), then a few of each other route: stack+int8,
     stack+int8_ffn, layer, layer+int8, eager+fused_attention;
  5. the scheduler answering requests: 4 full-width streams get partials
     and finals in process, then through GroupedScheduler(groups=2) over
     the device worker (server-vi.yaml's serving loop: a spawned child
     runs the step); the committed overfit fixture
     (assets/test_fixtures/overfit_ctc.npz) served on the card at 512
     slots in process and through the grouped worker gives the same
     events and its exact golden transcript.
Every path is driven with the kernels' launch counts set to 0 just
before it and read just after, the worker child's counts included; a
kernel that no path launched fails the run.  The last line is the result
JSON.
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
PEAK_INT8_OPS = 1979e12       # dense int8 tensor-core peak
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3
B_SLOTS = 512                 # server-vi.yaml's max_active_connections


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


def emformer_flops(B, L, D, F, U, R, M, Lc):
    """Operations (2 per multiply-add) of one Emformer step, from the
    shapes: (the five projections of every layer, QK^T and PV)."""
    T = U + R
    Q = T + (1 if M else 0)
    K = M + R + Lc + U
    proj = 2 * B * (Q * D * D + (M + T) * D * 2 * D + Q * D * D
                    + 2 * T * D * F)
    return float(L * proj), float(L * 2 * 2 * B * Q * K * D)


def stack_flops(B, L, D, F, U, R, M, Lc) -> float:
    return sum(emformer_flops(B, L, D, F, U, R, M, Lc))


def emformer_bytes(cfg, B, L, wbytes) -> float:
    """Bytes one step of L layers must move: the weights once (products
    at ``wbytes`` per value, biases in bf16, LN f32), the carried state
    read and written (bf16), the chunk in and the output out (f32)."""
    D, Fd = cfg.d_model, cfg.ffn_dim
    M, Lc, U = cfg.max_memory_size, cfg.left_context_length, cfg.segment_length
    T = U + cfg.right_context_length
    w = L * (wbytes * (4 * D * D + 2 * D * Fd) + 2 * (5 * D + Fd) + 4 * 6 * D)
    state = 2 * L * B * (M + 2 * Lc) * D
    return float(w + 2 * state + 4 * B * T * D + 4 * B * U * D + 6 * B)


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


def _ln_split(x, scale, bias, eps=1e-5):
    """The plain version's LN with its sums taken as two halves: another
    valid f32 order (moves int8 roundings, for the W8A8 noise floor)."""
    import torch
    x = x.to(torch.float32)
    h, n = x.shape[-1] // 2, x.shape[-1]
    mean = (x[..., :h].sum(-1, keepdim=True) + x[..., h:].sum(-1, keepdim=True)) / n
    c = (x - mean).square()
    var = (c[..., :h].sum(-1, keepdim=True) + c[..., h:].sum(-1, keepdim=True)) / n
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _plain_split(es, *args, **kw):
    """The plain version with its products' and LNs' sums split in two:
    another valid f32 summation order."""
    plain_mm, plain_ln = es._mm, es._ln
    es._mm, es._ln = _mm_split_k, _ln_split
    try:
        return es.emformer_stack_plain(*args, **kw)
    finally:
        es._mm, es._ln = plain_mm, plain_ln


def check_stack(cfg, B, n_ticks, tol, gen, device, label, relative=False,
                quant="none"):
    """Kernel A vs its plain version over chained ticks (state carried
    from the plain version, so each tick compares one step).

    relative=False: elementwise, |k - p| <= atol + tol * |p|.
    relative=True: ||k - p|| / ||p|| <= bound per tensor — for bf16 at 20
    layers, where two valid f32 accumulation orders already differ by more
    than tol in a few elements (rounding flips compound through the
    layers).  The noise floor, the same distance between two plain
    versions that sum in other orders, is printed.  In the W8A8 modes it
    is measured on every tick and the bound (atol, or the relative bound)
    is max(tol, 2 x floor): an int8 value flips wherever two valid f32
    orders put an activation row on a rounding boundary, and at 512 slots
    some rows always are, so kernel and plain version differ by what two
    plain versions differ by."""
    import torch
    from asr_streaming_tpu_torch.models.emformer import init_emformer_params
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    params = init_emformer_params(gen, cfg, device)
    mem, lck, lcv, length = _stack_inputs(cfg, B, gen, device)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cfg.compute_dtype, quant=quant)
    T = cfg.segment_length + cfg.right_context_length
    worst = worst_rel = floor_abs = floor_rel = 0.0
    last = None
    for tick in range(n_ticks):
        x = torch.randn((B, T, cfg.d_model), generator=gen).to(device)
        reset = (torch.rand(B, generator=gen) < 0.15).to(device)
        advance = (torch.rand(B, generator=gen) < 0.8).to(device)
        eff = torch.where(reset, torch.zeros_like(length), length)
        args = (params, x, mem, lck, lcv, eff, reset, advance)
        got = es.emformer_stack(*args, **kw)
        torch.cuda.synchronize()
        want = es.emformer_stack_plain(*args, **kw)
        floors = {}
        if quant != "none" or (relative and tick == 0):
            other = _plain_split(es, *args, **kw)
            for name, o, w in zip(("y", "mem", "lc_k", "lc_v"), other, want):
                if w.numel():
                    d = o.float() - w.float()
                    floors[name] = (d.abs().max().item(),
                                    (d.norm() / w.float().norm()).item())
            floor_abs = max([floor_abs] + [f[0] for f in floors.values()])
            floor_rel = max([floor_rel] + [f[1] for f in floors.values()])
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
            f_abs, f_rel = floors.get(name, (0.0, 0.0))
            if quant == "none":
                f_abs = f_rel = 0.0
            bound_rel, atol = max(tol, 2 * f_rel), max(tol, 2 * f_abs)
            if relative and rel > bound_rel:
                fail(f"{label} tick {tick} {name}: relative error {rel:.3e}"
                     f" > {bound_rel:.3e}")
            if not relative and not torch.allclose(gf, wf, rtol=tol,
                                                   atol=atol):
                bad = ((gf - wf).abs() > atol + tol * wf.abs()).sum().item()
                fail(f"{label} tick {tick} {name}: max |err| {err:.3e}, "
                     f"{bad} elements beyond rtol={tol}, atol={atol:.3e}")
        _, mem, lck, lcv = want
        length = torch.where(advance, eff + cfg.segment_length, eff)
        last = (params, x, mem, lck, lcv, eff, reset, advance, kw)
    if floor_abs:
        log(f"[kernels] {label}: noise floor, max |plain(split sums) - "
            f"plain| = {floor_abs:.3e}, relative L2 {floor_rel:.3e}")
    log(f"[kernels] {label}: {n_ticks} ticks, max |kernel - plain| = "
        f"{worst:.3e}, max relative L2 {worst_rel:.3e} "
        f"({'relative' if relative else 'elementwise'} tol {tol}"
        f"{', or 2 x the floor' if quant != 'none' else ''})")
    return worst, last


def _state_of(cfg, B, gen, device):
    from asr_streaming_tpu_torch.models.emformer import EmformerState
    return EmformerState(*_stack_inputs(cfg, B, gen, device))


def _tick_inputs(cfg, B, gen, device):
    import torch
    T = cfg.segment_length + cfg.right_context_length
    x = torch.randn((B, T, cfg.d_model), generator=gen).to(device)
    reset = (torch.rand(B, generator=gen) < 0.15).to(device)
    advance = (torch.rand(B, generator=gen) < 0.8).to(device)
    return x, reset, advance


def check_layer_vs_stack(cfg, B, n_ticks, gen, device, label):
    """Kernel C (the layer route, one call per layer) against kernel A (the
    stack route) over chained ticks: torch.equal on y and the states.
    Both run the same chain of csrc/emformer_stack.cu."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.emformer import (
        emformer_stream_step, init_emformer_params,
    )
    params = init_emformer_params(gen, cfg, device)
    state = _state_of(cfg, B, gen, device)
    layer = dataclasses.replace(cfg, route="layer")
    for tick in range(n_ticks):
        x, reset, advance = _tick_inputs(cfg, B, gen, device)
        ya, sa = emformer_stream_step(params, cfg, x, state, reset, advance)
        yc, sc = emformer_stream_step(params, layer, x, state, reset, advance)
        torch.cuda.synchronize()
        for name, g, w in zip(("y", "mem", "lc_k", "lc_v", "length"),
                              (yc, *sc), (ya, *sa)):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{label} tick {tick} {name}: C differs from A")
        state = sa
    log(f"[kernels] {label}: {n_ticks} ticks, C == A bit for bit on y, mem, "
        f"lc_k, lc_v")
    return params


def check_layer_plain(cfg, params, B, n_ticks, tol, gen, device, label):
    """Kernel C against its plain version, one layer (layer 0) per tick,
    elementwise rtol = atol = tol.  Returns the last call's inputs."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_layer as el
    U, R, D = cfg.segment_length, cfg.right_context_length, cfg.d_model
    kw = dict(U=U, R=R, M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cfg.compute_dtype,
              quant=cfg.quant == "int8")
    p = {k: v[0] for k, v in params.items()}
    st = _state_of(cfg, B, gen, device)
    worst = 0.0
    for tick in range(n_ticks):
        x, reset, advance = _tick_inputs(cfg, B, gen, device)
        row = torch.randn((B, 1, D), generator=gen).to(device).tanh()
        eff = torch.where(reset, torch.zeros_like(st.length), st.length)
        args = (p, x[:, :U], x[:, U:], row, st.mem[0], st.lc_k[0],
                st.lc_v[0], eff, reset, advance)
        got = el.emformer_layer(*args, **kw)
        torch.cuda.synchronize()
        want = el.emformer_layer_plain(*args[:8], reset.bool(),
                                       advance.bool(), **kw)
        for name, g, w in zip(("utt", "rc", "mem_row", "mem", "lc_k",
                               "lc_v"), got, want):
            gf, wf = g.float(), w.float()
            err = (gf - wf).abs().max().item()
            worst = max(worst, err)
            if not torch.isfinite(gf).all() or not torch.allclose(
                    gf, wf, rtol=tol, atol=tol):
                fail(f"{label} tick {tick} {name}: max |err| {err:.3e} "
                     f"beyond rtol=atol={tol}")
    log(f"[kernels] {label}: {n_ticks} one-layer calls, max |kernel - "
        f"plain| = {worst:.3e} (elementwise tol {tol})")
    return worst, args, kw


def check_attention(cfg, B, gen, device):
    """Kernel D against its plain version in f32 at rtol = atol = 1e-4,
    at the VI serving shape; times beside SDPA with the boolean mask."""
    import torch
    import torch.nn.functional as F
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    U, R = cfg.segment_length, cfg.right_context_length
    M, Lc, D, H = (cfg.max_memory_size, cfg.left_context_length,
                   cfg.d_model, cfg.num_heads)
    Q, K = R + U + 1, M + R + Lc + U
    q = torch.randn((B, Q, D), generator=gen).to(device)
    k = torch.randn((B, K, D), generator=gen).to(device)
    v = torch.randn((B, K, D), generator=gen).to(device)
    length = (torch.randint(0, 8, (B,), generator=gen) * U
              + torch.randint(0, 3, (B,), generator=gen)).to(device)
    m_kv = torch.clamp(length, max=Lc).int()
    m_m = torch.clamp(length // U, max=M).int()
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=True,
              neg_inf=cfg.negative_inf)
    got = ek.emformer_attention(q, k, v, m_m, m_kv, **kw)
    torch.cuda.synchronize()
    want = ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"D: max |kernel - plain| {err:.3e} beyond rtol=atol=1e-4")
    mask = ek.attention_mask(m_m, m_kv, Q=Q, K=K, M=M, R=R, Lc=Lc,
                             use_mem=True)[:, None]
    q4, k4, v4 = (t.view(B, -1, H, D // H).transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    sdpa_err = (library().transpose(1, 2).reshape(B, Q, D)
                - want).abs().max().item()
    ms = device_times(lambda: ek.emformer_attention(q, k, v, m_m, m_kv, **kw),
                      20)[0]
    plain_ms = device_times(
        lambda: ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw), 5)[0]
    lib_ms = device_times(library, 20)[0]
    nbytes = 4 * (2 * B * Q * D + 2 * B * K * D) + 8 * B
    flops = 2 * 2 * B * Q * K * D
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    log(f"[kernels] D: max |kernel - plain| = {err:.3e} (tol 1e-4; SDPA vs "
        f"plain {sdpa_err:.3e}); {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f}"
        f" us, SDPA {lib_ms * 1e3:.1f} us), {nbytes / 1e6:.1f} MB, bound "
        f"{max(t_bytes, t_ops) * 1e3:.1f} us")
    return {"name": "emformer_attention", "route": "cuda",
            "source": "asr_streaming_tpu_torch/csrc/emformer_attention.cu",
            "replaces": "asr_streaming_tpu/ops/pallas_attention.py:119",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


def time_int8_product(cfg, B, gen, device):
    """The W8A8 product at the FFN1 shape (rows B*(U+R), K = D, N = F):
    the int8 GEMM and the row quantiser by kernel, beside torch._int_mm
    on the same int8 operands and a bf16 torch.matmul."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    M = B * (cfg.segment_length + cfg.right_context_length)
    K, N = cfg.d_model, cfg.ffn_dim
    x = torch.randn((M, K), generator=gen).to(device)
    w = (torch.randn((K, N), generator=gen) * 0.05).to(device)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    bias = torch.zeros(N, device=device)
    _, rows = device_times(lambda: es.w8a8_linear(x, q, bias,
                                                  torch.bfloat16), 20)
    by = {name: t for t, _, name in rows}
    gemm = sum(t for n, t in by.items() if "gemm_int8" in n)
    quant = sum(t for n, t in by.items() if "quantize_rows" in n)
    a8 = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                       generator=gen).to(device)
    b8 = q[2].t()                          # [K, N], column-major
    try:                                   # a yardstick only
        int_mm = f"{device_times(lambda: torch._int_mm(a8, b8), 20)[0] * 1e3:.1f} us"
    except RuntimeError as e:
        int_mm = f"not measured ({str(e).splitlines()[0][:80]})"
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    bf16 = device_times(lambda: torch.matmul(xb, wb), 20)[0]
    ops = 2.0 * M * K * N
    log(f"[kernels] int8 product {M}x{K}x{N}: gemm_int8 {gemm * 1e3:.1f} us "
        f"({ops / (gemm * 1e-3) / 1e12:.0f} TOP/s) + row quantiser "
        f"{quant * 1e3:.1f} us; torch._int_mm {int_mm}; bf16 "
        f"matmul {bf16 * 1e3:.1f} us; bound {ops / PEAK_INT8_OPS * 1e6:.1f} us")


def phase_kernels(gen, device):
    import dataclasses
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

    # ---- A's W8A8 modes: 3 layers elementwise at the bf16 tolerance, 20
    # layers by relative L2 with the noise floor (two plain versions whose
    # sums run in other orders, which moves int8 roundings too)
    for quant in ("int8", "int8_ffn"):
        check_stack(EmformerConfig(compute_dtype=torch.bfloat16, num_layers=3),
                    B, 3, 3e-2, gen, device, f"A-{quant} vi bf16 L=3",
                    quant=quant)
    err_q, _ = check_stack(vi, B, 2, 3e-2, gen, device,
                           "A-int8_ffn vi bf16 L=20", relative=True,
                           quant="int8_ffn")
    err_q, last = check_stack(vi, B, 3, 3e-2, gen, device,
                              "A-int8 vi bf16 L=20", relative=True,
                              quant="int8")
    params, x, mem, lck, lcv, eff, reset, advance, kw = last
    ms_q = device_times(kernel_a, 5)[0]
    plain_q = device_times(plain_a, 2)[0]
    profile_top(kernel_a, "A emformer_stack int8, one VI step at 512 slots")
    proj, attn = emformer_flops(B, L, D, Fd, vi.segment_length,
                                vi.right_context_length, vi.max_memory_size,
                                vi.left_context_length)
    t_ops = (proj / PEAK_INT8_OPS + attn / PEAK_BF16_FLOPS) * 1e3
    t_bytes = emformer_bytes(vi, B, L, 1) / PEAK_BYTES * 1e3
    log(f"[kernels] A-int8: {ms_q:.3f} ms/step device time (plain "
        f"{plain_q:.3f} ms), bound {max(t_ops, t_bytes):.3f} ms")
    results.append({
        "name": "emformer_stack_int8", "route": "cuda",
        "source": "asr_streaming_tpu_torch/csrc/emformer_stack.cu",
        "replaces": "asr_streaming_tpu/ops/pallas_emformer.py:642",
        "launches": 0, "max_abs_err": err_q, "ms": ms_q, "plain_ms": plain_q,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None})
    del params, mem, lck, lcv, last
    torch.cuda.empty_cache()
    time_int8_product(vi, B, gen, device)

    # ---- C: bit for bit against A over the full stack (bf16 and int8),
    # and against its plain version one layer at a time
    params = check_layer_vs_stack(vi, B, 2, gen, device, "C vs A vi bf16 L=20")
    check_layer_vs_stack(dataclasses.replace(vi, quant="int8"), B, 2, gen,
                         device, "C-int8 vs A-int8 vi bf16 L=20")
    check_layer_plain(dataclasses.replace(vi, compute_dtype=torch.float32),
                      params, B, 2, 1e-4, gen, device, "C vi f32 one layer")
    err_c, args, kw_c = check_layer_plain(vi, params, B, 3, 3e-2, gen, device,
                                          "C vi bf16 one layer")
    from asr_streaming_tpu_torch.ops import emformer_layer as el
    ms_c = device_times(lambda: el.emformer_layer(*args, **kw_c), 10)[0]
    plain_c = device_times(
        lambda: el.emformer_layer_plain(*args[:8], args[8].bool(),
                                        args[9].bool(), **kw_c), 3)[0]
    t_ops = stack_flops(B, 1, D, Fd, vi.segment_length,
                        vi.right_context_length, vi.max_memory_size,
                        vi.left_context_length) / PEAK_BF16_FLOPS * 1e3
    t_bytes = (emformer_bytes(vi, B, 1, 2) + 4 * B * D * 2
               + 4 * B * vi.right_context_length * D) / PEAK_BYTES * 1e3
    log(f"[kernels] C: {ms_c:.3f} ms per layer call (plain {plain_c:.3f} ms),"
        f" bound {max(t_ops, t_bytes):.3f} ms")
    results.append({
        "name": "emformer_layer", "route": "cuda",
        "source": "asr_streaming_tpu_torch/csrc/emformer_stack.cu",
        "replaces": "asr_streaming_tpu/ops/pallas_emformer.py:401",
        "launches": 0, "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None})
    del params, args
    torch.cuda.empty_cache()

    # ---- D at the VI serving shape
    results.append(check_attention(vi, B, gen, device))
    torch.cuda.empty_cache()
    return results


def vi_serving_cfg(mode="stack", quant="none", fused_attention=False):
    """server-vi.yaml's model and tick: bf16, mu-law upload, no Silero;
    the route and quant as the server picks them (with_kernel_route)."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig, with_kernel_route
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    asr = with_kernel_route(ASRConfig.vietnamese(torch.bfloat16), mode, quant)
    if fused_attention:
        emf = dataclasses.replace(asr.encoder.emformer, fused_attention=True)
        asr = dataclasses.replace(
            asr, encoder=dataclasses.replace(asr.encoder, emformer=emf))
    return ServingConfig(asr=asr, use_silero=False, upload_encoding="mulaw")


def run_ticks(params, cfg, B, n_ticks, gen, device):
    """n_ticks serving ticks, every slot decoding from the second; checks
    the pack, the emission rows and the lengths.  Returns (host seconds
    per tick, state, ctx, emission buffer, last segment)."""
    import torch
    from asr_streaming_tpu_torch.models.serving import (
        PACK_DATA, init_audio_context, init_emission_buffer,
        init_serving_state, serving_step,
    )
    state = init_serving_state(cfg, B, device)
    ctx = init_audio_context(cfg, B, device)
    buf = init_emission_buffer(cfg, B, device)
    seg_len = cfg.asr.audio.segment_length
    U = cfg.asr.encoder.emformer.segment_length
    ones = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, dtype=torch.bool, device=device)
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
        if tuple(out.pack.shape) != (B, PACK_DATA + U):
            fail(f"pack shape {tuple(out.pack.shape)}")
        if not torch.isfinite(out.pack).all():
            fail("non-finite pack")
    rows = buf[:, :n_ticks * U].float()
    if not torch.isfinite(rows).all():
        fail("non-finite emission rows")
    lse = torch.logsumexp(rows, -1)
    if lse.abs().max().item() > 5e-2:
        fail(f"emission rows are not log-probs (max |logsumexp| "
             f"{lse.abs().max().item():.3e})")
    if int(state.length.min().item()) != n_ticks * U:
        fail(f"lengths {state.length.min().item()} != {n_ticks * U}")
    return times, state, ctx, buf, seg


def _median_ms(times):
    steady = sorted(times[1:])
    return steady[len(steady) // 2] * 1e3


def phase_serving(gen, device, n_ticks=10):
    import torch
    from asr_streaming_tpu_torch.models.serving import (
        init_serving_params, serving_step,
    )
    B = B_SLOTS
    cfg = vi_serving_cfg()
    params = init_serving_params(gen, cfg, device)
    torch.cuda.reset_peak_memory_stats()
    times, state, ctx, buf, seg = run_ticks(params, cfg, B, n_ticks, gen,
                                            device)
    ones = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, dtype=torch.bool, device=device)
    profile_top(lambda: serving_step(params, cfg, seg, ones, ones, zeros,
                                     zeros, state, ctx, buf),
                "one serving tick at 512 slots", n=12)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(times[1:])
    log(f"[serving] stack: {n_ticks} ticks x {B} slots: first "
        f"{times[0] * 1e3:.1f} ms, median {_median_ms(times):.2f} ms, min "
        f"{steady[0] * 1e3:.2f} ms; peak {peak:.2f} GiB")
    return params, cfg


def phase_routes(params, gen, device, n_ticks=3):
    """A few full-width ticks of every other route, each its own path."""
    from asr_streaming_tpu_torch.ops import _cuda
    counts = {}
    for label, mode, quant, fused in (
            ("stack+int8", "stack", "int8", False),
            ("stack+int8_ffn", "stack", "int8_ffn", False),
            ("layer", "layer", "none", False),
            ("layer+int8", "layer", "int8", False),
            ("eager+fused_attention", "off", "none", True)):
        cfg = vi_serving_cfg(mode, quant, fused)
        _cuda.launch_counts(reset=True)
        times = run_ticks(params, cfg, B_SLOTS, n_ticks, gen, device)[0]
        got = _cuda.launch_counts()
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        log(f"[serving] {label}: {n_ticks} ticks x {B_SLOTS} slots, median "
            f"{_median_ms(times):.2f} ms (first {times[0] * 1e3:.1f} ms); "
            f"launches {({k: v for k, v in got.items() if v})}")
    return counts


def _flush_rules():
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    # hard flush at 1.9 s: random weights emit no trailing silence
    return {"flush": EndpointRule(must_contain_nonsilence=False,
                                  min_trailing_silence=0.0,
                                  min_utterance_length=1.9,
                                  max_relative_cost=float("inf"))}


def _drive_four_streams(sched, label):
    """4 streams of 3.2 s tones + noise; each must get partials and a
    final with a finite emission.  Returns (events, drain seconds)."""
    import numpy as np
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
            fail(f"{label} stream {s.id}: {len(partials)} partials, "
                 f"{len(finals)} finals")
        seg = finals[0].segment
        if seg.length and not np.isfinite(seg.emission).all():
            fail(f"{label} stream {s.id}: non-finite fetched emission")
    return events, dt


def phase_scheduler(params, cfg, device):
    from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    sched = Scheduler(params, cfg, placeholder_vocab(cfg.asr.encoder.vocab_size),
                      max_slots=B_SLOTS, rules=_flush_rules(), device=device)
    warm = sched.warmup()
    events, dt = _drive_four_streams(sched, "in process")
    sched.close()
    p50 = sched.timers.snapshot()["stages"]["tick"]["p50_ms"]
    log(f"[scheduler] in process, 4 streams x 3.2 s at {B_SLOTS} slots: "
        f"{sched.ticks} ticks in {dt:.2f} s (warmup {warm:.2f} s), "
        f"{len(events)} events, tick p50 {p50} ms")
    return p50


def phase_worker(seed, inproc_p50, device):
    """server-vi.yaml's serving loop: GroupedScheduler(groups=2) over the
    device worker at 512 slots; the child rebuilds the weights from the
    seed and runs the step.  Returns the child's launch counts."""
    from asr_streaming_tpu_torch.streaming.scheduler import GroupedScheduler
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    cfg = vi_serving_cfg()
    t0 = time.perf_counter()
    sched = GroupedScheduler(None, cfg,
                             placeholder_vocab(cfg.asr.encoder.vocab_size),
                             max_slots=B_SLOTS, groups=2,
                             rules=_flush_rules(),
                             device_worker={"seed": seed,
                                            "device": str(device)})
    try:
        warm = sched.warmup()
        stats = sched.client.stats(reset=True)
        if stats["foreign_modules"]:
            fail(f"the worker child imported {stats['foreign_modules'][:5]}")
        events, dt = _drive_four_streams(sched, "grouped worker")
        launches = sched.client.stats()["launches"]
        p50 = sched.timers.snapshot()["stages"]["tick"]["p50_ms"]
    finally:
        sched.close()
    log(f"[scheduler] GroupedScheduler(groups=2) over the device worker, 4 "
        f"streams x 3.2 s at {B_SLOTS} slots: {sched.ticks} group ticks in "
        f"{dt:.2f} s (child start + warmup {time.perf_counter() - t0 - dt:.1f}"
        f" s, warm step {warm:.2f} s), {len(events)} events, group tick p50 "
        f"{p50} ms (in process: {inproc_p50} ms); child launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches


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


def _fixture_events(sched, golden):
    """The fixture's three streams (the sentence; silence then the
    sentence; the sentence twice): per-stream [(kind, text)]."""
    import numpy as np
    one = _sentence_audio(golden, 3.84)
    audio = [one, np.concatenate([np.zeros(10240, np.float32), one]),
             np.concatenate([one, one])]
    streams = [sched.admit(f"t{i}") for i in range(len(audio))]
    for s, a in zip(streams, audio):
        s.accept_waveform(a)
        s.add_tail_padding()
    out = {}
    for e in sched.drain():
        out.setdefault(e.stream_id, []).append((e.kind, e.text.strip()))
    return out


def phase_golden(device):
    """The overfit fixture at 512 slots: in process, then through the
    grouped worker; the same events stream by stream and the golden
    final.  Returns the worker child's launch counts."""
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.serving import (
        ServingConfig, init_serving_params,
    )
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import (
        GroupedScheduler, Scheduler,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, overlay_params,
    )
    path = os.path.join(HERE, "assets", "test_fixtures", "overfit_ctc.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    vocab = ["-", "|", "a", "b", "c", "d"]
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(vocab)),
                        use_silero=False, use_energy_gate=False,
                        energy_threshold_db=-200.0)
    params = overlay_params(init_serving_params(1, cfg, device),
                            load_params(path))
    rules = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
    sched = Scheduler(params, cfg, vocab, max_slots=B_SLOTS, rules=rules,
                      device=device)
    want = _fixture_events(sched, golden)
    sched.close()
    finals = [t for s in want.values() for k, t in s if k == "final"]
    partials = [t for k, t in want["t0"] if k == "partial" and t]
    if golden not in finals:
        fail(f"golden {golden!r} not among finals {finals}")
    if not partials or not all(golden.startswith(p) for p in partials):
        fail(f"partials do not grow toward {golden!r}: {partials}")
    wk = GroupedScheduler(None, cfg, vocab, max_slots=B_SLOTS, groups=2,
                          rules=rules,
                          device_worker={"seed": 1, "checkpoint": path,
                                         "device": str(device)})
    try:
        wk.warmup()
        wk.client.stats(reset=True)
        got = _fixture_events(wk, golden)
        launches = wk.client.stats()["launches"]
    finally:
        wk.close()
    if got != want:
        fail(f"grouped worker events {got} != in process {want}")
    log(f"[golden] overfit_ctc at {B_SLOTS} slots on the card: finals "
        f"{finals}, partials of t0 {partials}; GroupedScheduler(groups=2) "
        f"over the device worker gives the same events for all 3 streams")
    return launches


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
    from asr_streaming_tpu_torch.ops import _cuda
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    kernels = phase_kernels(gen, device)

    # the paths: each driven with the counts set to 0 just before it and
    # read just after; the worker phases add their child's counts
    totals = {k: 0 for k in _cuda.COUNTERS}

    def path(fn, *fargs):
        _cuda.launch_counts(reset=True)
        out = fn(*fargs)
        for k, v in _cuda.launch_counts().items():
            totals[k] += v
        return out

    params, cfg = path(phase_serving, gen, device)
    p50 = path(phase_scheduler, params, cfg, device)
    # each route is a path of its own (counts zeroed and read around it)
    routes = phase_routes(params, gen, device)
    del params
    torch.cuda.empty_cache()
    for counts in (routes, path(phase_worker, args.seed, p50, device),
                   path(phase_golden, device)):
        for k, v in counts.items():
            totals[k] += v
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["launches"] == 0:
            fail(f"kernel {k['name']} was not launched on any path")
    log(f"[launches] {totals}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
