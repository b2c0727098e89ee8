#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --compare checkouts/parent . . checkouts/parent
                                     # kernel A's and B's times, a parent's
                                     # package against this one

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a), with the
     ptxas register / shared-memory report, and A's attention and D at
     the serving shapes: registers a thread, shared memory a block, blocks
     resident an SM and the persistent core's plan (``[resources]``);
  3. kernels vs their plain PyTorch versions at the serving shapes (512
     slots, chained ticks with reset/advance churn): A (the Emformer
     stack) in f32/bf16 and in its W8A8 modes, B (emission append), C
     (one Emformer layer) against its plain version and bit for bit
     against A, in bf16 and int8, and D (the f32 attention core); with
     device times (torch.profiler, kernel execution only), the plain
     version's time, the card's bound and a library yardstick where one
     PyTorch call computes the same function, plus a device-time
     breakdown by kernel;
     A's parts (its bf16 GEMMs, its attention with its launches, bytes
     bound and one scaled_dot_product_attention call a layer beside it,
     its row kernels with their launches and bytes bound, the rest) from
     the profile at VI and EN (and at B=1 in f32, phase 11);
     each of A's row kernels alone (rows_first, rows_residual,
     rows_boundary, rows_last) against its plain version (check_rows: the
     roll's rows bit for bit, LN outputs within f32 rounding; in W8A8 the
     int8 rows and scales they write for q, kv and ffn1 bit for bit the
     quantisation of their own rows), beside F.layer_norm and
     Tensor.copy_; B at any position (odd offsets, both ends, out of
     range); and D in bf16 in/out (bit for bit the
     f32 kernel on the widened inputs, then cast) beside SDPA on the same
     tensors;
  3b. A's bf16 product alone (the wgmma GEMM, entry asr_gemm_bf16) at the
     ten serving product shapes (five at VI, five at EN), a ragged shape
     and each activation, on the tile run_layer picks and on each tile
     forced, within gemm_bf16_error_bound of its plain version (only the
     f32 sum order differs), timed beside its plain version and
     torch.matmul on the same bf16 operands; then A's f32 product alone
     (entry asr_gemm_f32) at the offline API's five shapes at B = 1 and
     B = 3, a 512-slot shape, two ragged shapes and each activation,
     within gemm_f32_error_bound of gemm_f32_plain, twice bit for bit,
     timed beside the tiled kernel forced, the plain version, the f32
     torch.matmul and the bound (``[gemm] f32`` lines; ``--only gemm``:
     this phase alone);
  3c. A-int8's product alone (the row quantiser and the int8 wgmma GEMM,
     entry asr_w8a8_linear) at the same ten shapes, a ragged one and the
     tiny test geometry, on the picked tile and each tile forced, equal
     bit for bit to _qdot + bias, the GEMM and the quantiser timed apart,
     beside torch._int_mm on the same int8 operands, a bf16 torch.matmul
     and the bound at the int8 peak; the quantiser alone (entry
     asr_quantize_rows) bit for bit quantize_rows_plain, beside its bytes
     bound, its plain version and torch's amax and round
     (``--only int8``: this phase alone);
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
     events and its exact golden transcript;
  6. the English Emformer-RNNT path of server-en.yaml: kernel E (the row
     top-k of csrc/row_topk.cu) against its plain version iter_topk,
     values and indices exactly, at the beam's [5120, 4097] k=10 rows and
     on tie, sentinel, narrow and k=128 rows, beside torch.topk; A and B
     at the EN geometry (U=4, R=1, Lc=30, M=0; encodings [512, 4, 1024]);
     the int32 hash on the card against numpy; full-width greedy and beam
     ticks at 512 slots (RNNTConfig defaults, bf16, beam width 10), the
     beam tick with E against the same tick with iter_topk forced; four
     streams through the in-process scheduler and through
     GroupedScheduler(groups=2) over the device worker in beam mode; and
     assets/test_fixtures/overfit_rnnt.npz serving its golden sentence in
     greedy and beam mode, in process and through the worker;
  7. the websocket server (``--only server``: this phase with the golden
     phases it compares with): (a) StreamingServer around
     GroupedScheduler(groups=2) over the device worker at 512 slots on a
     loopback socket, the overfit fixtures' streams sent as 0.25 s int16
     packets then EOS: every connection completes and its finals over the
     wire are the golden phases' ("ab cd"; "a b" in beam mode); (b)
     ``python -m asr_streaming_tpu_torch.server`` with configs/server-vi.yaml
     (16 connections) and server-en.yaml (8; its joiner sharpened through a
     checkpoint, as the EN phases do) at full width, clients streaming 6 s
     at real-time pace: start-up, chunk-to-partial p50/p95 and
     EOS-to-completed, /metrics.json, no failed tick, exit 0 on SIGINT with
     no child left, the kernel launches the server logs at shutdown; (c)
     the VI finals' native C++ beam (decode/beam_native.py); and the VI
     CLI once more with ``speaker_wav`` (ECAPA on the card in the server
     process) and a reference ``.ckpt`` checkpoint (converted at load in
     the worker child, its CTC bias raised so finals get word windows
     from a one-word lexicon): every final carries a boolean is_speaker;
     the VI CLI's run also streams once through the port's own client
     (client/asr_client.py::stream_audio);
  8. the port's bench (``--only bench``: this phase alone; it runs
     first, right after the build): bench.py's three phases at full
     width on the stack route with Silero on, the trained VAD fixture and
     the native gather-encode, one window of A and of B, then C; a
     ``[bench]`` line with its keys;
  9. ECAPA (with the server phase): the full-width verifier's embedding
     on the card against the CPU plain version at every bucket, timed;
 10. multi-GPU serving (``--only mesh``: this phase with the VI golden
     phase): make_serving_mesh(0) over every card; the VI, EN greedy and
     EN beam ticks at 512 slots, 3 chained ticks with churn, split 1, 2
     and 4 ways on ``[cuda:0] * n`` (the split's cost, not scaling)
     against the unsplit tick: flags, argmax and tokens exact, floats
     bit for bit or within 3e-2 relative L2 (printed which), A, B (and E)
     launched, each split's tick time; the overfit fixture through
     Scheduler(mesh=...) and GroupedScheduler(groups=2, mesh=...) gives
     phase 5's events; the CLI with server-vi.yaml, ``device_worker:
     false`` and ``data_parallel: 0`` answers a connection and exits 0 on
     SIGINT; with two cards or more, every tick also split over all of
     them (make_serving_mesh(0)), every card launching;
 11. the offline API (``--only offline``): A at batch 1 and 3 in f32
     against its plain version (1e-4), slot 0 of the B = 3 step bit for
     bit a B = 1 step of that slot, the B = 1 step by part beside its 100
     products on the f32 torch.matmul, A's row kernels alone at B = 1;
     ASRModel at full width (VI f32)
     against the CPU plain version (1e-3 on log-probs) and its time per
     second of audio; the fixture's golden text and word windows through
     ASRModel; ``python -m asr_streaming_tpu_torch.tools.transcribe``
     printing the in-process greedy line; tools/profile_beam.py's table
     (kernel E launched); a torch_profile Chrome trace;
 12. the training stack (``--only train``): (a) the kernels refuse a call
     autograd would record (fault 16) and the eager route gives every
     encoder leaf a finite, nonzero gradient; (b) one step of the CTC,
     RNNT, VAD and speaker trainers on the card against the CPU at tiny
     geometry (loss 1e-5 relative, each leaf's gradient 1e-4 relative
     L2); (c) ``train.run`` at full width (ASRConfig.vietnamese, f32,
     batch 8, 4 s) for 5 steps, its checkpoint through the server's
     loader into a 512-slot tick; (d) ``train.rnnt`` (RNNTConfig(),
     V=4097, streaming features), ``train.vad`` and ``train.speaker``
     (EcapaConfig()) for 3 steps each, ms per step and peak memory; (e)
     the tiny model trained on the overfit task, then the Scheduler's
     transcript from its ``.npz`` equal to the offline greedy decode;
 13. the SSL and TTS-GAN trainers and the TTS manifest (``--only tts``):
     (a) card against CPU at tiny geometry: one SSL step and one GAN
     discriminator step (loss 1e-5 relative, each leaf's gradient 1e-4
     relative L2), one GAN generator step (loss 1e-5 in f32, gradients
     1e-4 in float64: its f32 gradient is ill-conditioned), inverse_stft
     (1e-5; two card runs bit for bit) and synthesize (1e-5, lengths and
     durations exact); (b) ``train.ssl`` at full width (SSLConfig(),
     batch 8 of 4 s, 3 steps), ms per step and peak memory; (c) the TTS
     manifest: the overfit fixture's ASRModel aligns the tone sentences
     through the tool's functions (kernel A), then the tool's CLI at full
     width (ASRConfig.vietnamese, seeded weights) exits 0 and launches A;
     (d) ``train.gan`` at full width (GANTrainConfig(), batch 4 from (c)'s
     manifest, 3 steps), its ``.npz`` into TTSModel;
 14. data- and tensor-parallel CTC training (``--only dist``): (a) four
     ranks spawned from here (train/dist_check.py) run dp = 2, tp = 2 and
     dp = 2 x tp = 2 steps at the JAX sharded-step test's geometry, each
     against the single-process step on the card (loss 1e-5 relative,
     gathered gradients 1e-4 relative L2, updated weights 1e-5), over
     NCCL where there are four cards, else gloo with every rank on
     cuda:0; (b) ``python -m torch.distributed.run ... train.run`` at
     full width (ASRConfig.vietnamese(), f32, batch 8 of 4 s, 3 steps) at
     tp = 2 (2 ranks), dp = 2 (2 ranks) and dp = 2 x tp = 2 (4 ranks), ms
     per step and peak memory per rank; (c) the tp = 2 run's gathered
     checkpoint through the server's loader into a 512-slot VI tick on
     the stack route (A and B launched); (d) gather_params(shard_params(x))
     == x bit for bit at full width, mp = 2 and 4.
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
# A's row kernels (csrc/emformer_stack.cu): two a layer (the residual,
# with the left-context roll, and the boundary between layers, with the
# next layer's memory rows), the first layer's input and the last layer's
# output
ROW_KERNELS = ("rows_first", "rows_residual", "rows_boundary", "rows_last")


def row_launches(L: int) -> dict:
    """Each row kernel's launches in one step of A with L layers."""
    return {"rows_first": 1, "rows_residual": L, "rows_boundary": L - 1,
            "rows_last": 1}


# kernels one call of A launches (device_times' ``need``): its GEMM,
# attention and row kernels, in bf16 and in W8A8 mode; kernel C (one
# layer) launches no boundary
A_KERNELS = ("gemm_bf16_wgmma", "attention_kernel") + ROW_KERNELS
A_INT8_KERNELS = ("gemm_int8_wgmma", "quantize_rows",
                  "attention_kernel") + ROW_KERNELS
C_KERNELS = ("gemm_bf16_wgmma", "attention_kernel", "rows_residual")


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


def event_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn, which queues device work only (one
    kernel, say), between CUDA events: a spin kernel holds the stream
    until every call is queued, so the host's launch time is not counted.
    If the spin ended before the last call was queued, it is taken again,
    four times longer; eight such tries fail the run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 21
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail(f"{getattr(fn, '__name__', 'a call')}: the spin kernel never held "
         f"the stream until {iters} calls were queued")


def device_times(fn, iters: int = 1, need=""):
    """Device time per call of fn, by kernel name, from torch.profiler's
    CUDA activity (kernel execution only: host gaps between launches do
    not count).  Returns (ms per call, [(ms per call, launches per call,
    name)]): a kernel's mean time per launch times its launches per call
    (its records over ``iters``, rounded), so a dropped record does not
    bias it.
    Each call is waited for before the next is queued: with the launch
    queue full, the profiler dropped kernel records.  A profile with no
    kernel record (or none whose name holds ``need``, or one of the names
    of a tuple ``need``) is taken again, up to five times: a profile of
    short calls now and then records nothing.  Five such profiles fail
    the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(0.1)
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
                per_call = max(1, round(e.count / iters))
                rows.append((t / 1e3 / e.count * per_call, per_call, name))
        needs = (need,) if isinstance(need, str) else need
        if rows and all(any(n in r[2] for r in rows) for n in needs):
            rows.sort(reverse=True)
            return sum(r[0] for r in rows), rows
    fail(f"five profiles of {getattr(fn, '__name__', 'a call')} held no "
         f"kernel records{' of ' + str(need) if need else ''}")


def stack_parts(fn, label: str, geo, need=None, itemsize=2, reset=None,
                advance=None, quant="none", F=2048, H=8):
    """Device time of one call of kernel A by part, from the profile: its
    bf16 or f32 GEMMs, its int8 GEMMs and row quantiser (W8A8 mode, beside
    the quantiser's bytes bound, ``quantise_bytes``), its attention
    (beside its bytes bound, ``attention_bytes``), its row kernels
    (``ROW_KERNELS``: their launches, and beside them their bytes bound,
    ``row_bytes``, and the design's extra writes, ``row_duplicate_bytes``)
    and the rest (anything else the call launches).  ``geo`` is (B, L, D,
    U, R, M, Lc), F the FFN width; ``itemsize``, the masks and ``quant``
    as ``row_bytes``'.  ``need`` as device_times' (None: ``A_KERNELS``).
    The row kernels' launches in one call come from the library's own
    counters (``es.kernel_launch_counts``), and the run fails unless they
    are ``row_launches(L)``; a row kernel's time is its mean time per
    profiled launch times those launches.  The quantiser's and the int8
    GEMMs' launches come from those counters too, and the attention's (L a
    step, or the run fails), beside one scaled_dot_product_attention call a
    layer on the same shapes (``attention_sdpa_ms``, H heads).  Returns
    {part: {"ms": ms}}, the attention's, the rows' and the quantiser's with
    their "bound_ms", the attention's, the rows', the quantiser's and the
    int8 GEMMs' with their "launches", the attention's with its
    "library_ms", the rows' with their "duplicate_ms"."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    torch.cuda.synchronize()
    before = es.kernel_launch_counts()
    fn()
    torch.cuda.synchronize()
    by_kernel = {k: n - before[k]
                 for k, n in es.kernel_launch_counts().items()}
    if {k: by_kernel[k] for k in ROW_KERNELS} != row_launches(geo[1]):
        fail(f"{label}: row kernel launches {by_kernel}, expected "
             f"{row_launches(geo[1])}")
    if by_kernel["attention"] != geo[1]:
        fail(f"{label}: {by_kernel['attention']} attention launches, "
             f"expected {geo[1]}")
    total, rows = device_times(fn, 3, need=A_KERNELS if need is None else need)
    parts = {"gemm": 0.0, "gemm_int8": 0.0, "quantise": 0.0, "attention": 0.0,
             "rows": 0.0}
    recorded = 0
    for t, c, name in rows:
        key = ("gemm" if "gemm_bf16_wgmma" in name or "gemm_f32" in name else
               "gemm_int8" if "gemm_int8_wgmma" in name else
               "quantise" if "quantize_rows" in name else
               "attention" if "attention_kernel" in name else
               "rows" if any(k in name for k in ROW_KERNELS) else None)
        if key == "rows":
            kernel = next(k for k in ROW_KERNELS if k in name)
            total += t / c * by_kernel[kernel] - t
            t = t / c * by_kernel[kernel]
            recorded += c
        if key:
            parts[key] += t
    row_launches_step = sum(by_kernel[k] for k in ROW_KERNELS)
    launches = {"quantise": by_kernel["quantize_rows"],
                "gemm_int8": by_kernel["gemm_int8"]}
    parts["rest"] = total - sum(parts.values())
    bound = attention_bytes(*geo, itemsize=itemsize) / PEAK_BYTES * 1e3
    sdpa_call, sdpa_step = attention_sdpa_ms(
        *geo, H, torch.bfloat16 if itemsize == 2 else torch.float32)
    q_bound = quantise_bytes(*geo, F, itemsize, quant) / PEAK_BYTES * 1e3
    int8 = (f"int8 GEMMs {parts['gemm_int8']:.3f} ms in "
            f"{launches['gemm_int8']} launches, row quantiser "
            f"{parts['quantise']:.3f} ms in {launches['quantise']} launches "
            f"(bytes bound {q_bound:.3f} ms), " if parts["gemm_int8"] else "")
    rows_bound = row_bytes(*geo, itemsize, reset, advance,
                           quant) / PEAK_BYTES * 1e3
    dup = row_duplicate_bytes(*geo, itemsize, quant) / PEAK_BYTES * 1e3
    log(f"[profile] {label} by part: GEMMs {parts['gemm']:.3f} ms, {int8}"
        f"attention {parts['attention']:.3f} ms in {by_kernel['attention']} "
        f"launches (bytes bound {bound:.3f} ms; SDPA {sdpa_step:.3f} ms, "
        f"{geo[1]} calls of {sdpa_call * 1e3:.1f} us), row kernels {parts['rows']:.3f} ms in {row_launches_step} "
        f"launches ({recorded} a call in the profile; bytes bound {rows_bound:.3f} ms, and {dup:.3f} ms of "
        f"the LN rows written twice, into q_in and kv_in), the rest "
        f"{parts['rest']:.3f} ms, of {total:.3f} ms")
    out = {k: {"ms": v} for k, v in parts.items()}
    out["attention"].update(bound_ms=bound, launches=by_kernel["attention"],
                            library_ms=sdpa_step, library_call_ms=sdpa_call)
    out["rows"].update(launches=row_launches_step, bound_ms=rows_bound,
                       duplicate_ms=dup)
    out["quantise"].update(launches=launches["quantise"], bound_ms=q_bound)
    out["gemm_int8"]["launches"] = launches["gemm_int8"]
    return out


def attention_bytes(B, L, D, U, R, M, Lc, itemsize=2) -> float:
    """Bytes A's attention must move in one step of L layers: q and the
    output [B, Q, D], the kv rows [B, M+T, 2D] and the left context
    [B, Lc, D] twice."""
    T = U + R
    Q = T + (1 if M else 0)
    return float(L * itemsize * B * D * (2 * Q + 2 * (M + T) + 2 * Lc))


def attention_sdpa_ms(B, L, D, U, R, M, Lc, H, dtype):
    """The attention part's library yardstick: one
    F.scaled_dot_product_attention call with the boolean mask on q [B, H,
    Q, Dh] and k, v [B, H, K, Dh] of one layer of A's attention in
    ``dtype`` (fill counts from seeded lengths), timed here and used nowhere
    in the port.  Returns (ms a call, ms for L calls: a step)."""
    import torch
    import torch.nn.functional as F
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    dev = torch.device("cuda", 0)
    Q, K = R + U + (1 if M else 0), M + R + Lc + U
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((B, H, n, D // H), generator=gen).to(dev, dtype)
               for n in (Q, K, K))
    length = (torch.randint(0, 8, (B,), generator=gen) * U).to(dev)
    mask = ek.attention_mask(torch.clamp(length // U, max=M).int(),
                             torch.clamp(length, max=Lc).int(), Q=Q, K=K,
                             M=M, R=R, Lc=Lc, use_mem=M > 0)[:, None]
    ms = sdpa_ms(q, k, v, mask, f"A's attention B={B} Q={Q} K={K}")
    return ms, ms * L


def sdpa_ms(q, k, v, mask, label) -> float:
    """Device ms of one F.scaled_dot_product_attention call with the
    boolean mask, on q [B, H, Q, Dh], k and v [B, H, K, Dh] as given and,
    where K is not a multiple of 8, with the keys padded to one (zero k
    and v rows the mask leaves out: the same function).  Logs the kernels
    each ran (the backend PyTorch chose) and returns the faster."""
    import torch
    import torch.nn.functional as F
    K = k.shape[2]
    runs = {"as given": (q, k, v, mask)}
    pad = -K % 8
    if pad:
        runs["keys padded to 8"] = (
            q, F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)),
            F.pad(mask, (0, pad), value=False))
    times = []
    for name, (qq, kk, vv, mm) in runs.items():
        ms, rows = device_times(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm), 20)
        log(f"[sdpa] {label}, {name}: {ms * 1e3:.1f} us in "
            + ", ".join(f"{n} x{c} {t * 1e3:.1f} us" for t, c, n in rows[:3]))
        times.append(ms)
    return min(times)


# A's attention and D at the serving shapes: name -> (kernel, B, D, H, U,
# R, M, Lc, dtype)
ATTENTION_SHAPES = {
    "A vi bf16": ("A", B_SLOTS, 512, 8, 16, 4, 4, 32, "bf16"),
    "A en bf16": ("A", B_SLOTS, 512, 8, 4, 1, 0, 30, "bf16"),
    "A vi f32 B=1": ("A", 1, 512, 8, 16, 4, 4, 32, "f32"),
    "A vi f32": ("A", B_SLOTS, 512, 8, 16, 4, 4, 32, "f32"),
    "D vi f32": ("D", B_SLOTS, 512, 8, 16, 4, 4, 32, "f32"),
    "D vi bf16": ("D", B_SLOTS, 512, 8, 16, 4, 4, 32, "bf16"),
}


def attention_resources():
    """Registers a thread, shared memory a block and blocks resident an SM
    of A's attention and of D at ``ATTENTION_SHAPES``, with the plan, for
    the package first on sys.path, from its library's own report
    (``kernel_attention_plan``).  Logs a ``[resources]`` line each; returns
    {name: report}."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    out = {}
    for name, (kind, B, D, H, U, R, M, Lc, dt) in ATTENTION_SHAPES.items():
        Q, K = R + U + (1 if M else 0), M + R + Lc + U
        r = ek.kernel_attention_plan(
            kind, B=B, Q=Q, K=K, D=D, H=H, M=M, R=R, Lc=Lc, use_mem=M > 0,
            dtype=torch.bfloat16 if dt == "bf16" else torch.float32,
            out_dtype=torch.bfloat16 if dt == "bf16" else torch.float32)
        log(f"[resources] {name}: {r['registers']} registers a thread, "
            f"{r['smem']} bytes of shared memory a block of {r['warps']} "
            f"warps, {r['resident']} blocks resident an SM, grid "
            f"{r['grid']}, {r['groups']} groups of "
            f"{r['warps'] // r['groups']} warps, {r['hpu']} heads x "
            f"{r['wph']} warps a unit, {r['stages']} stages of "
            f"{r['stage_bytes']} bytes, {r['units']} units")
        out[name] = r
    return out


def quantise_bytes(B, L, D, U, R, M, Lc, F, itemsize=2,
                   quant="none") -> float:
    """Bytes the W8A8 row quantiser kernel must move in one step of L
    layers: the rows the row kernels do not quantise, out's [B, Q, D] (the
    attention's) and ffn2's [B, T, F] (ffn1's), each read once in the
    compute type and written once as int8 rows with an f32 scale a row."""
    from asr_streaming_tpu_torch.ops.emformer_stack import _kernel_quant_names
    T = U + R
    Q = T + (1 if M else 0)
    names = _kernel_quant_names(quant)
    per_layer = sum(rows * (K * itemsize + K + 4) for name, rows, K in (
        ("w_out", B * Q, D), ("ff_w2", B * T, F)) if name in names)
    return float(L * per_layer)


def row_bytes(B, L, D, U, R, M, Lc, itemsize=2, reset=None, advance=None,
              quant="none") -> float:
    """Bytes A's row kernels must move in one step of L layers, each tensor
    they read or write counted once (f32 rows 4 bytes a value, the compute
    type ``itemsize``).  Each layer: the residual (out and hin in; the
    FFN input and the memory row out), the roll (the memory and
    left-context rows written, and read where this step's masks take them
    from: the layer's input state unless reset, its kv for the new rows
    where advance is set; the memory row where advance is set) and the
    memory rows of kv_in; each boundary (out's rows, hin and h2 in; hin,
    the next layer's LN rows and summary row out); the first layer's chunk
    in, hin, LN rows, summary and memory row out; the last layer's out
    rows, hin and h2 in, hin and y out.  The LN rows count once: the
    kernels write them twice, into q_in and kv_in, as the q and kv
    products read them (``row_duplicate_bytes``).  In W8A8 (``quant``)
    the rows of a quantised product are written as int8 with an f32 scale
    a row: q's (the LN rows and the summary, from the f32 values) and
    kv's (the memory and LN rows, rounded to the compute type first: other
    values, so both count), ffn1's.  Masks None: no slot reset, every
    slot advancing."""
    import torch
    T, c = U + R, itemsize
    Q = T + (1 if M else 0)
    keep = max(0, Lc - U)
    rs = torch.zeros(B, dtype=torch.bool) if reset is None else \
        reset.bool().cpu()
    adv = torch.ones(B, dtype=torch.bool) if advance is None else \
        advance.bool().cpu()
    live, n_adv = int((~rs).sum()), int(adv.sum())
    lc_read = 2 * D * c * (int((adv & ~rs).sum()) * keep
                           + n_adv * (Lc - keep)
                           + int((~adv & ~rs).sum()) * Lc)
    from asr_streaming_tpu_torch.ops.emformer_stack import _kernel_quant_names
    names, q8 = _kernel_quant_names(quant), D + 4   # an int8 row, its scale
    if "w_q" in names:                          # with w_kv
        ln_rows, mem_rows = B * (Q + T) * q8, B * M * q8
    else:
        ln_rows = B * T * D * c + (B * D * c if M else 0)
        mem_rows = B * M * D * c
    ff_rows = B * T * (q8 if "ff_w1" in names else D * c)
    residual = B * Q * D * c + B * T * D * 4 + ff_rows + (B * D * 4 if M else 0)
    roll = (lc_read + 2 * B * Lc * D * c + live * M * D * c
            + B * M * D * c + mem_rows + (n_adv * D * 4 if M else 0))
    into_layer = B * T * D * 4 + ln_rows
    output_ln = B * T * D * (c + 4 + c)         # out's rows, hin, h2
    boundary = output_ln + into_layer
    first = B * T * D * 4 + into_layer + (B * D * 4 if M else 0)
    last = output_ln + B * T * D * 4 + B * U * D * 4
    return float(L * (residual + roll) + (L - 1) * boundary + first + last)


def row_duplicate_bytes(B, L, D, U, R, M, Lc, itemsize=2,
                        quant="none") -> float:
    """Bytes A's row kernels write beyond ``row_bytes`` in one step: each
    layer's input LN rows a second time (q_in [rc; utt; summary] and kv_in
    [mem; rc; utt] hold the same rows).  One buffer [mem; rc; utt;
    summary] read by both products would save them.  None in W8A8, whose
    q and kv rows differ."""
    from asr_streaming_tpu_torch.ops.emformer_stack import _kernel_quant_names
    if "w_q" in _kernel_quant_names(quant):
        return 0.0
    return float(L * B * (U + R) * D * itemsize)


def row_library_ms(B, L, D, U, R, M, Lc, cdt, device) -> dict:
    """The row kernels' library yardsticks on the card: one F.layer_norm
    on [B·T, D] f32 rows, one Tensor.copy_ of a layer's rolled state
    [B, M + 2 Lc, D] in ``cdt``, and a step of them (3 LNs and the copy a
    layer, L layers), each call timed alone (``event_ms``).
    {"layer_norm_ms", "copy_ms", "ms"}."""
    import torch
    import torch.nn.functional as F
    T = U + R
    x = torch.randn((B * T, D), device=device)
    w, b = torch.randn(D, device=device), torch.randn(D, device=device)
    ln = event_ms(lambda: F.layer_norm(x, (D,), w, b, 1e-5))
    src = torch.randn((B, M + 2 * Lc, D), device=device).to(cdt)
    dst = torch.empty_like(src)
    copy = event_ms(lambda: dst.copy_(src))
    return {"layer_norm_ms": ln, "copy_ms": copy, "ms": L * (3 * ln + copy)}


def _us(ms):
    return f"{ms * 1e3:.2f} us"


def check_rows(label, B, D, U, R, M, Lc, cdt, gen, device,
               tanh_on_mem=True) -> dict:
    """Each of A's row kernels alone (``emformer_stack.rows_*``, as the
    chain launches them) against its plain version on the same inputs on
    the card: the roll's rows (the rolled state, kv_in's memory rows) and
    the chunk's copy bit for bit; the LN outputs, the summary and memory
    rows within f32 rounding (f32 1e-4; the compute type one of its ulps,
    rtol 2^-7, atol 1e-4).  Then in W8A8 (``quant="int8"``): the int8 rows
    and scales of q, kv and ffn1 bit for bit ``quantize_rows_plain`` of
    the rows the same kernel makes unquantised (q's and ffn1's f32 rows
    from the same call in f32 on the widened inputs, kv's compute-type
    rows), within one int8 step of the plain version's.  Each timed alone
    (``event_ms`` of ``es.rows_relaunch``'s launch: the kernel without the
    wrapper's copies), unquantised and in W8A8, beside its plain version
    (``cuda_ms``).  Returns {kind: {ms, int8_ms, plain_ms,
    max_abs_err}}."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    T = U + R
    Q = T + (1 if M else 0)
    use_mem = M > 0

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device=device,
                                                               dtype=dtype)

    reset = (torch.rand(B, generator=gen) < 0.15).to(device)
    advance = (torch.rand(B, generator=gen) < 0.8).to(device)
    ln = [(1 + randn(D, scale=0.1), randn(D, scale=0.1)) for _ in range(3)]
    x, hin = randn(B, T, D), randn(B, T, D)
    mem, memrow = randn(B, M, D, dtype=cdt), randn(B, D).tanh()
    out, h2 = randn(B, Q, D, dtype=cdt), randn(B, T, D, dtype=cdt)
    kv = randn(B, M + T, 2 * D, dtype=cdt)
    lck, lcv = randn(B, Lc, D, dtype=cdt), randn(B, Lc, D, dtype=cdt)
    g = dict(U=U, R=R, use_mem=use_mem)
    calls = {
        "first": (es.rows_first, es.rows_first_plain,
                  (x, mem, reset, advance, *ln[0]), dict(g, cdt=cdt),
                  ("hin", "q_in", "kv_in", "q8", "memrow", "mem"),
                  ("hin", "mem")),
        "residual": (es.rows_residual, es.rows_residual_plain,
                     (out, hin, kv, lck, lcv, reset, advance, *ln[1]),
                     dict(U=U, R=R, M=M, Lc=Lc, use_mem=use_mem,
                          tanh_on_mem=tanh_on_mem),
                     ("ff_in", "q8", "memrow", "lc_k", "lc_v"),
                     ("lc_k", "lc_v")),
        "boundary": (es.rows_boundary, es.rows_boundary_plain,
                     (out, hin, h2, mem, memrow, reset, advance, *ln[2],
                      *ln[0]),
                     g, ("hin", "q_in", "kv_in", "q8", "mem"), ("mem",)),
        "last": (es.rows_last, es.rows_last_plain, (out, hin, h2, *ln[2]),
                 dict(U=U, R=R), ("hin", "y"), ()),
    }
    result = {}
    for kind, (kernel, plain, args, kw, names, exact) in calls.items():
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        if kind == "first" and use_mem:
            # the rolled memory's last row is the memory row the kernel
            # computed (held to the plain one within f32 rounding)
            want = (*want[:5], plain(*args, got[4], **kw)[5])
        worst = 0.0
        for name, a, b in zip(names, got, want):
            if (a is None and b is None) or name == "q8":
                continue
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"{label} rows_{kind} {name}: {tuple(a.shape)} "
                     f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
            if a.numel() == 0:
                continue
            if name in exact or name == "kv_in":
                # kv_in's memory rows are the roll's copies
                sl = (slice(None), slice(0, M)) if name == "kv_in" else ...
                if not torch.equal(a[sl], b[sl]):
                    fail(f"{label} rows_{kind} {name}: not bit for bit its "
                         f"plain version")
            if name in exact:
                continue
            err = (a.float() - b.float()).abs().max().item()
            worst = max(worst, err)
            rtol = 1e-4 if a.dtype == torch.float32 else 2.0 ** -7
            if not torch.isfinite(a.float()).all() or not torch.allclose(
                    a.float(), b.float(), rtol=rtol, atol=1e-4):
                fail(f"{label} rows_{kind} {name}: max |err| {err:.3e} "
                     f"beyond rtol={rtol:.2e}, atol=1e-4")
        int8_ms = None
        if kind != "last":
            check_rows_int8(f"{label} rows_{kind}", kernel, plain, args, kw,
                            names, got)
            int8_ms = event_ms(es.rows_relaunch(kernel, *args, **kw,
                                                quant="int8")[1])
        # the kernel alone (the wrappers of the boundary and the last
        # layer copy hin first), as the bf16 and f32 chains launch it
        ms = event_ms(es.rows_relaunch(kernel, *args, **kw)[1])
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 3)
        result[kind] = {"ms": ms, "int8_ms": int8_ms, "plain_ms": plain_ms,
                        "max_abs_err": worst}
        log(f"[kernels] {label} rows_{kind}: device time {_us(ms)}"
            + (f", W8A8 {_us(int8_ms)}" if int8_ms else "")
            + f" (plain {_us(plain_ms)}), the roll's rows bit for bit, LN "
            f"outputs max |err| {worst:.3e}"
            + (", int8 rows exact" if int8_ms else ""))
    return result


def check_rows_int8(label, kernel, plain, args, kw, names, own):
    """A row kernel in W8A8 (``quant="int8"``) against ``check_rows``'
    rule; ``own`` is the same call's unquantised outputs."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    got = kernel(*args, **kw, quant="int8")
    wide_args = [a.float() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args]
    wide = kernel(*wide_args, **(dict(kw, cdt=torch.float32) if "cdt" in kw
                                 else kw))
    torch.cuda.synchronize()
    want = plain(*args, **kw, quant="int8")
    slot = names.index("q8")
    sources = ({"ff_w1": wide[0]} if "ff_in" in names
               else {"w_q": wide[1], "w_kv": own[2]})
    if set(got[slot]) != set(sources) or set(want[slot]) != set(sources):
        fail(f"{label}: int8 rows of {sorted(got[slot])}, expected "
             f"{sorted(sources)}")
    for name, (xq, sc) in got[slot].items():
        ref_q, ref_s = es.quantize_rows_plain(sources[name])
        if not (torch.equal(xq, ref_q) and torch.equal(sc, ref_s)):
            fail(f"{label} {name}: int8 rows or scales not bit for bit "
                 f"quantize_rows_plain of the kernel's own rows")
        step = (xq.int() - want[slot][name][0].int()).abs().max().item()
        if step > 1:
            fail(f"{label} {name}: int8 rows {step} steps from the plain "
                 f"version's")
    for name, g, o in zip(names, got, own):
        if name in ("q_in", "kv_in", "ff_in") and g is not None:
            fail(f"{label}: {name} written in W8A8")
        if name not in ("q_in", "kv_in", "ff_in", "q8") and o is not None \
                and not torch.equal(g, o):
            fail(f"{label}: {name} differs between W8A8 and unquantised")


def profile_top(fn, label: str, n: int = 8, also=()):
    """Logs the top n kernels, and below them those whose name holds one of
    ``also``; returns (device ms, kernel launches)."""
    total, rows = device_times(fn)
    launches = sum(r[1] for r in rows)
    log(f"[profile] {label}: device time {total:.3f} ms in "
        f"{launches} kernel launches")
    for i, (t, c, name) in enumerate(rows):
        if i < n or any(a in name for a in also):
            log(f"[profile]   {t:8.3f} ms {100 * t / total:5.1f}% x{c:<4d} "
                f"{name}")
    return total, launches


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
    attention_resources()


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


def _stack_kw(cfg, quant="none"):
    return dict(U=cfg.segment_length, R=cfg.right_context_length,
                M=cfg.max_memory_size, Lc=cfg.left_context_length,
                H=cfg.num_heads, use_mem=cfg.use_mem,
                tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
                activation=cfg.activation, cdt=cfg.compute_dtype, quant=quant)


def stack_digest(cfg, B, seed, device, label, parts=False, quant="none"):
    """One step of kernel A (bf16, ``cfg``'s geometry; W8A8 with
    ``quant``) on weights, state and inputs made from ``seed`` alone: the
    sha256 of its outputs' bytes and its device ms (and with ``parts`` the
    step's device time by part, ``stack_parts``).  A commit whose kernel
    computes the same bits gives the same digest: the fingerprint by which
    two commits' A are held equal (run this function with either
    checkout's package first on sys.path)."""
    import hashlib
    import torch
    from asr_streaming_tpu_torch.models.emformer import init_emformer_params
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    gen = torch.Generator().manual_seed(seed)
    params = init_emformer_params(gen, cfg, device)
    mem, lck, lcv, length = _stack_inputs(cfg, B, gen, device)
    T = cfg.segment_length + cfg.right_context_length
    x = torch.randn((B, T, cfg.d_model), generator=gen).to(device)
    reset = (torch.rand(B, generator=gen) < 0.15).to(device)
    advance = (torch.rand(B, generator=gen) < 0.8).to(device)
    eff = torch.where(reset, torch.zeros_like(length), length)
    kw = _stack_kw(cfg, quant)
    need = A_KERNELS if quant == "none" else A_INT8_KERNELS

    def kernel_a():
        return es.emformer_stack(params, x, mem, lck, lcv, eff, reset,
                                 advance, **kw)

    h = hashlib.sha256()
    for t in kernel_a():
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    ms = device_times(kernel_a, 5, need=need)[0]
    log(f"[kernels] {label}, one step from seed {seed}: outputs' sha256 "
        f"{h.hexdigest()[:16]}, {ms:.3f} ms device time")
    if not parts:
        return h.hexdigest(), ms
    geo = (B, cfg.num_layers, cfg.d_model, cfg.segment_length,
           cfg.right_context_length, cfg.max_memory_size,
           cfg.left_context_length)
    return h.hexdigest(), ms, stack_parts(kernel_a, label, geo, need=need,
                                          reset=reset, advance=advance,
                                          quant=quant, F=cfg.ffn_dim)


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
    kw = _stack_kw(cfg, quant)
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


def attention_inputs(cfg, B, gen, device):
    """Kernel D's inputs at ``cfg``'s geometry with memory, B slots, f32:
    q, k, v, the fill counts from seeded lengths, the wrapper's keywords
    and the boolean mask [B, 1, Q, K] (SDPA's)."""
    import torch
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
    mask = ek.attention_mask(m_m, m_kv, Q=Q, K=K, M=M, R=R, Lc=Lc,
                             use_mem=True)[:, None]
    return q, k, v, m_m, m_kv, kw, mask


def check_attention(cfg, B, gen, device):
    """Kernel D against its plain version in f32 at rtol = atol = 1e-4,
    at the VI serving shape; times beside SDPA with the boolean mask.  Then
    with bf16 inputs and output, as the eager route calls it: bit for bit
    the f32 kernel on the widened inputs, then cast; timed beside SDPA on
    the same bf16 tensors."""
    import torch
    import torch.nn.functional as F
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    q, k, v, m_m, m_kv, kw, mask = attention_inputs(cfg, B, gen, device)
    (B, Q, D), K, H = q.shape, k.shape[1], kw["num_heads"]
    got = ek.emformer_attention(q, k, v, m_m, m_kv, **kw)
    torch.cuda.synchronize()
    want = ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"D: max |kernel - plain| {err:.3e} beyond rtol=atol=1e-4")
    q4, k4, v4 = (t.view(B, -1, H, D // H).transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    sdpa_err = (library().transpose(1, 2).reshape(B, Q, D)
                - want).abs().max().item()
    ms = device_times(lambda: ek.emformer_attention(q, k, v, m_m, m_kv, **kw),
                      20, need="attention")[0]
    plain_ms = device_times(
        lambda: ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw), 5)[0]
    lib_ms = sdpa_ms(q4, k4, v4, mask, f"D B={B} Q={Q} K={K} f32")
    nbytes = 4 * (2 * B * Q * D + 2 * B * K * D) + 8 * B
    flops = 2 * 2 * B * Q * K * D
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    log(f"[kernels] D: max |kernel - plain| = {err:.3e} (tol 1e-4; SDPA vs "
        f"plain {sdpa_err:.3e}); {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f}"
        f" us, SDPA {lib_ms * 1e3:.1f} us), {nbytes / 1e6:.1f} MB, bound "
        f"{max(t_bytes, t_ops) * 1e3:.1f} us")

    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    bf = ek.emformer_attention(qb, kb, vb, m_m, m_kv,
                               out_dtype=torch.bfloat16, **kw)
    wide = ek.emformer_attention(qb.float(), kb.float(), vb.float(), m_m,
                                 m_kv, **kw)
    torch.cuda.synchronize()
    if bf.dtype != torch.bfloat16 or not torch.equal(bf, wide.to(bf.dtype)):
        fail("D: bf16 in/out differs from the f32 kernel on the widened "
             "inputs, then cast")
    q4b, k4b, v4b = (t.view(B, -1, H, D // H).transpose(1, 2)
                     for t in (qb, kb, vb))
    ms_bf = device_times(lambda: ek.emformer_attention(
        qb, kb, vb, m_m, m_kv, out_dtype=torch.bfloat16, **kw), 20,
        need="attention")[0]
    lib_bf = sdpa_ms(q4b, k4b, v4b, mask, f"D B={B} Q={Q} K={K} bf16")
    bound_bf = (2 * (2 * B * Q * D + 2 * B * K * D) + 8 * B) / PEAK_BYTES * 1e3
    log(f"[kernels] D bf16 in/out: == the f32 kernel on the widened inputs "
        f"then cast, bit for bit; {ms_bf * 1e3:.1f} us (SDPA on the bf16 "
        f"tensors {lib_bf * 1e3:.1f} us), bound {bound_bf * 1e3:.1f} us")
    return {"name": "emformer_attention", "route": "cuda",
            "source": "asr_streaming_tpu_torch/csrc/emformer_attention.cu",
            "replaces": "asr_streaming_tpu/ops/pallas_attention.py:119",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "bf16": {"ms": ms_bf, "library_ms": lib_bf, "bound_ms": bound_bf}}


def gemm_shapes(B, U, R, M, D, Fd, act):
    """The five products of one layer, (name, rows, K, N, activation): q
    on the Q query rows, kv on the M + T key rows, out, ffn1 (with the
    activation) and ffn2 on the T frames, T = U + R."""
    T = U + R
    Q = T + (1 if M else 0)
    return [("q", B * Q, D, D, None), ("kv", B * (M + T), D, 2 * D, None),
            ("out", B * Q, D, D, None), ("ffn1", B * T, D, Fd, act),
            ("ffn2", B * T, Fd, D, None)]


def check_gemm(label, M, K, N, act, gen, device):
    """A's bf16 product (the wgmma GEMM of csrc/emformer_stack.cu) at one
    shape against its plain version (``_mm`` + ``epilogue<bf16>``) within
    ``gemm_bf16_error_bound``: two bf16 ulps and the sum-order slack,
    doubled through an activation (only the f32 sum order differs); each
    tile forced gives the picked tile's bits.  Times it beside its main
    loop alone (``main_loop_only``: no epilogue), the plain version and
    ``torch.matmul`` on the same bf16 operands (no bias: the yardstick)."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    x = torch.randn((M, K), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(device,
                                                           torch.bfloat16)
    bias = torch.randn((N,), generator=gen).to(device, torch.bfloat16)
    want = es.gemm_bf16_plain(x, w, bias, act)
    bound = es.gemm_bf16_error_bound(x, w, want, act)
    # the tile run_layer picks (None), then each tile forced
    errs, tile_ms, tile_main, picked = [], {}, {}, None
    for config in [None] + list(range(len(es.GEMM_TILES))):
        got = es.gemm_bf16(x, w, bias, act, config)
        torch.cuda.synchronize()
        if picked is None:
            picked = got
        elif not torch.equal(got, picked):
            fail(f"GEMM {label}, tile {config}: {int((got != picked).sum())}"
                 f" outputs differ from the picked tile's")
        err = (got.float() - want.float()).abs()
        worst = (err / bound).max().item()
        if not torch.isfinite(got.float()).all() or worst > 1:
            fail(f"GEMM {label}, tile {config}: {worst:.2f} x its error "
                 f"bound from the plain version")
        errs.append((worst, err.max().item()))
        if config is not None:
            tile_ms["%dx%d" % es.GEMM_TILES[config]] = device_times(
                lambda c=config: es.gemm_bf16(x, w, bias, act, c), 20,
                need="gemm_bf16_wgmma")[0]
            tile_main["%dx%d" % es.GEMM_TILES[config]] = device_times(
                lambda c=config: es.gemm_bf16(x, w, bias, act, c,
                                              main_loop_only=True), 20,
                need="gemm_bf16_wgmma")[0]
    worst, max_err = max(errs)
    tile = "%dx%d" % es.GEMM_TILES[es.gemm_config(M, N)]
    ms = device_times(lambda: es.gemm_bf16(x, w, bias, act), 20,
                      need="gemm_bf16_wgmma")[0]
    # the same launch without its epilogue (no bias, activation or
    # stores): what the main loops alone take on the picked tile
    main_ms = tile_main[tile]
    plain_ms = device_times(lambda: es.gemm_bf16_plain(x, w, bias, act), 5)[0]
    lib_ms = device_times(lambda: torch.matmul(x, w), 20)[0]
    flops = 2.0 * M * K * N
    nbytes = 2.0 * (M * K + K * N + N + M * N)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"[gemm] {label} {M}x{K}x{N}{' +' + act if act else ''}: "
        f"{ms * 1e3:.1f} us on {tile} ({flops / ms / 1e9:.0f} TFLOP/s; "
        + ", ".join(f"{t} {v * 1e3:.1f} (main loop {tile_main[t] * 1e3:.1f})"
                    for t, v in tile_ms.items())
        + f" us; main loop alone {main_ms * 1e3:.1f} us), torch.matmul "
        f"{lib_ms * 1e3:.1f} us ({flops / lib_ms / 1e9:.0f} TFLOP/s), plain "
        f"{plain_ms * 1e3:.1f} us, bound {max(t_ops, t_bytes) * 1e3:.1f} us; "
        f"max error {worst:.2f} x bound, {max_err:.2e}; every tile's bits "
        f"equal")
    return {"product": label, "m": M, "k": K, "n": N, "tile": tile, "ms": ms,
            "main_loop_ms": main_ms, "tiles_main_loop_ms": tile_main,
            "tiles_ms": tile_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes),
            "tflops": flops / ms / 1e9, "max_abs_err": max_err}


def check_gemm_pair(label, q, kv, gen, device):
    """A layer's q and kv products as ``run_layer`` runs them in bf16, one
    launch over both products' tiles (``gemm_bf16_pair``): equal bit for
    bit to the two products launched alone, and timed beside them and
    beside ``torch.matmul`` of each.  q and kv are (rows, K, N)."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    ops = []
    for M, K, N in (q, kv):
        ops.append((torch.randn((M, K), generator=gen).to(device,
                                                          torch.bfloat16),
                    (torch.randn((K, N), generator=gen) / K ** 0.5).to(
                        device, torch.bfloat16),
                    torch.randn((N,), generator=gen).to(device,
                                                        torch.bfloat16)))
    y0, y1 = es.gemm_bf16_pair(*ops[0], *ops[1])
    torch.cuda.synchronize()
    if not (torch.equal(y0, es.gemm_bf16(*ops[0]))
            and torch.equal(y1, es.gemm_bf16(*ops[1]))):
        fail(f"GEMM pair {label}: differs from the products launched alone")
    ms = device_times(lambda: es.gemm_bf16_pair(*ops[0], *ops[1]), 20,
                      need="gemm_bf16_wgmma")[0]
    alone = sum(device_times(lambda o=o: es.gemm_bf16(*o), 20,
                             need="gemm_bf16_wgmma")[0] for o in ops)
    lib_ms = sum(device_times(lambda o=o: torch.matmul(o[0], o[1]), 20)[0]
                 for o in ops)
    tile = "%dx%d" % es.GEMM_TILES[es.gemm_config(q[0], q[2],
                                                   pair=(kv[0], kv[2]))]
    log(f"[gemm] {label} q + kv in one launch on {tile}: {ms * 1e3:.1f} us "
        f"(alone {alone * 1e3:.1f} us, torch.matmul {lib_ms * 1e3:.1f} us); "
        f"equal bits")
    return {"product": f"{label} q+kv", "tile": tile, "ms": ms,
            "alone_ms": alone, "library_ms": lib_ms}


def kernel_ms(fn, name, iters=20):
    """Device ms per call of fn's kernels whose name holds ``name`` (the
    wrapper's own allocations and fills left out)."""
    _, rows = device_times(fn, iters, need=name)
    return sum(t for t, _, n in rows if name in n)


def check_gemm_f32(label, M, K, N, act, gen, device):
    """A's f32 product alone (entry asr_gemm_f32) at one shape, in the
    regime ``gemm_f32_config`` picks, against ``gemm_f32_plain`` summed in
    the kernel's K-slice order, within ``gemm_f32_error_bound`` (only the
    f32 sum order differs); a second call equal bit for bit.  Timed beside
    the tiled kernel forced (the small regime's former kernel), the plain
    version, ``torch.matmul`` on the same f32 operands (TF32 off) and the
    bound (x, w, bias and y once over 3.35 TB/s, or the FMAs at the f32
    peak)."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    x = torch.randn((M, K), generator=gen).to(device)
    w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(device)
    bias = torch.randn((N,), generator=gen).to(device)
    ks = es.gemm_f32_config(M, N, K)
    splits = -(-K // ks) if ks else 0
    got = es.gemm_f32(x, w, bias, act)
    again = es.gemm_f32(x, w, bias, act)
    torch.cuda.synchronize()
    want = es.gemm_f32_plain(x, w, bias, act, splits=ks)
    err = (got - want).abs()
    worst = (err / es.gemm_f32_error_bound(x, w, want, act)).max().item()
    if not torch.isfinite(got).all() or worst > 1:
        fail(f"f32 GEMM {label}: {worst:.2f} x its error bound from the "
             f"plain version")
    if not torch.equal(got, again):
        fail(f"f32 GEMM {label}: two calls differ")
    ms = kernel_ms(lambda: es.gemm_f32(x, w, bias, act), "gemm_f32")
    tiled_ms = (kernel_ms(lambda: es.gemm_f32(x, w, bias, act, 0),
                          "gemm_f32") if ks else ms)
    plain_ms = device_times(lambda: es.gemm_f32_plain(x, w, bias, act), 5)[0]
    lib_ms = device_times(lambda: torch.matmul(x, w), 20)[0]
    flops = 2.0 * M * K * N
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * (M * K + K * N + N + M * N) / PEAK_BYTES * 1e3
    regime = "small" if ks else "tiled"
    blocks = (-(-N // es.F32_TILE_N) * splits if ks
              else -(-N // 64) * -(-M // 64))
    how = f"{splits} splits of {ks}" if ks else "64x64 tiles"
    log(f"[gemm] f32 {label} {M}x{K}x{N}{' +' + act if act else ''}: "
        f"{ms * 1e3:.1f} us {regime} ({how}, {blocks} blocks; tiled "
        f"{tiled_ms * 1e3:.1f} us), torch.matmul {lib_ms * 1e3:.1f} us, "
        f"plain {plain_ms * 1e3:.1f} us, bound {max(t_ops, t_bytes) * 1e3:.2f}"
        f" us ({'bytes' if t_bytes >= t_ops else 'operations'}); max error "
        f"{worst:.2f} x bound, {err.max().item():.2e}")
    return {"product": label, "m": M, "k": K, "n": N, "regime": regime,
            "splits": splits, "k_slice": ks, "blocks": blocks,
            "ms": ms, "tiled_ms": tiled_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
            "max_abs_err": err.max().item()}


def phase_gemm(gen, device):
    """A's bf16 product at the ten serving product shapes (VI and EN, five
    each), a ragged shape and each activation; A's f32 product at the
    offline API's five shapes at B = 1 and B = 3, one 512-slot shape, two
    ragged ones (N and K off the tile and slice edges; K no multiple of 4,
    so tiled) and each activation; each language's q and kv in one
    launch.  Returns (the ten bf16 serving shapes' entries and the two
    pairs', the f32 entries)."""
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    out = []
    for lang, c in (("vi", EmformerConfig()), ("en", RNNTConfig().emformer)):
        shapes = gemm_shapes(B_SLOTS, c.segment_length,
                             c.right_context_length, c.max_memory_size,
                             c.d_model, c.ffn_dim, c.activation)
        for name, M, K, N, act in shapes:
            out.append(check_gemm(f"{lang} {name}", M, K, N, act, gen, device))
        out.append(check_gemm_pair(lang, shapes[0][1:4], shapes[1][1:4], gen,
                                   device))
    for label, act in (("ragged", None), ("relu", "relu"), ("gelu", "gelu"),
                       ("silu", "silu")):
        check_gemm(label, 300, 200 if act is None else 512, 136, act, gen,
                   device)
    f32 = []
    c = EmformerConfig()
    for B in (1, 3):
        for name, M, K, N, act in gemm_shapes(
                B, c.segment_length, c.right_context_length,
                c.max_memory_size, c.d_model, c.ffn_dim, c.activation):
            f32.append(check_gemm_f32(f"B={B} {name}", M, K, N, act, gen,
                                      device))
    f32.append(check_gemm_f32("512 slots q", B_SLOTS * 21, 512, 512, None,
                              gen, device))
    for label, M, K, N, act in (("ragged", 37, 200, 136, None),
                                ("ragged, K % 4 = 2", 30, 202, 130, None),
                                ("relu", 45, 512, 264, "relu"),
                                ("gelu", 45, 512, 264, "gelu"),
                                ("silu", 45, 512, 264, "silu")):
        f32.append(check_gemm_f32(label, M, K, N, act, gen, device))
    return out, f32


def _int8_operands(M, K, N, x_f32, gen, device):
    """x [M, K] (f32 where the chain quantises f32 rows: the q and ffn1
    products; else bf16), the int8 weights of a random [K, N] f32 weight,
    and a bias."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    x = (torch.randn((M, K), generator=gen) * 2).to(device)
    if not x_f32:
        x = x.to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(device)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    bias = torch.randn((N,), generator=gen).to(device)
    return x, w, q, bias


def w8a8_times(x, q, bias, act=None, config=None, main_loop_only=False):
    """Device time of one W8A8 product (``w8a8_linear``, bf16 out) by
    kernel: (the int8 GEMM's ms, the row quantiser's ms), on the tile the
    chain picks or on ``GEMM_TILES[config]``; with ``main_loop_only``
    the GEMM without its epilogue."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    kw = {} if config is None else {"config": config}
    if main_loop_only:
        kw["main_loop_only"] = True
    _, rows = device_times(lambda: es.w8a8_linear(
        x, q, bias, torch.bfloat16, act, **kw), 20,
        need=("gemm_int8", "quantize_rows"))
    return (sum(t for t, _, n in rows if "gemm_int8" in n),
            sum(t for t, _, n in rows if "quantize_rows" in n))


def int_mm_step(params, cfg, B, gen, device):
    """Device ms of the W8A8 step's int8 sums on torch._int_mm: one call
    that issues the five products of each layer (the layer's int8
    weights, int8 activations of the step's row counts), 5 x L launches,
    no quantiser, dequant or bias."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    qw = es.quantized_weights(params, es._MAT)
    shapes = gemm_shapes(B, cfg.segment_length, cfg.right_context_length,
                         cfg.max_memory_size, cfg.d_model, cfg.ffn_dim, None)
    a8 = [torch.randint(-127, 128, (M, K), dtype=torch.int8,
                        generator=gen).to(device) for _, M, K, _, _ in shapes]
    b8 = [[qw[n][2][l].t() for n in es._MAT]
          for l in range(cfg.num_layers)]   # [K, N], column-major

    def step():
        for w in b8:
            for a, b in zip(a8, w):
                torch._int_mm(a, b)

    ms, rows = device_times(step, 3)
    log(f"[kernels] A-int8's 100 products on torch._int_mm: {ms:.3f} ms in "
        f"{sum(r[1] for r in rows)} launches")
    return ms


def matmul_step(params, cfg, B, gen, device, dtype="bf16", label="A"):
    """Device ms of the step's products on torch.matmul: one call that
    issues the five products of each of cfg's layers (the layer's weights
    and activations of the step's row counts in ``dtype``, "bf16" or
    "f32"), 5 x L launches, no bias or activation: the yardstick of A's
    GEMMs.  In f32 the products run in full f32: TF32 off, as the
    package sets it."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    if dt == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the f32 "
             "yardstick would run in TF32")
    shapes = gemm_shapes(B, cfg.segment_length, cfg.right_context_length,
                         cfg.max_memory_size, cfg.d_model, cfg.ffn_dim, None)
    acts = [torch.randn((M, K), generator=gen).to(device, dt)
            for _, M, K, _, _ in shapes]
    ws = [[params[n][l].to(dt) for n in es._MAT]
          for l in range(cfg.num_layers)]

    def step():
        for w in ws:
            for a, b in zip(acts, w):
                torch.matmul(a, b)

    ms, rows = device_times(step, 3)
    log(f"[kernels] {label}'s {len(shapes) * cfg.num_layers} {dtype} "
        f"products at B={B} on torch.matmul: {ms:.3f} ms in "
        f"{sum(r[1] for r in rows)} launches")
    return ms


def check_int8(label, M, K, N, act, x_f32, gen, device):
    """A-int8's product (the row quantiser and the int8 wgmma GEMM of
    csrc/emformer_stack.cu) at one shape, bf16 out: equal bit for bit to
    _qdot(...).to(bf16) + bias on the tile run_layer picks and on each tile
    forced (an exact s32 sum, the same f32 dequant); with an activation,
    that exact value through the kernel's activation within one bf16 ulp
    of torch's (other f32 operation orders).  Times the GEMM and the
    quantiser by kernel beside torch._int_mm on the same int8 operands
    (no dequant: the yardstick), a bf16 torch.matmul of the same shape and
    the bound at the int8 peak; the quantiser alone (``quantize_rows``)
    bit for bit ``quantize_rows_plain``, beside its bytes bound, its plain
    version and torch's amax and round of the rows in one call (the
    yardstick: no single call quantises rows)."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    x, w, q, bias = _int8_operands(M, K, N, x_f32, gen, device)
    cdt = torch.bfloat16
    want = es._qdot(x.float(), q[0], q[1]).to(cdt) + bias.to(cdt)
    want_act = es._act(act)(want) if act else want
    tile_ms, quant_ms = {}, []
    for config in [None] + list(range(len(es.GEMM_TILES))):
        got = es.w8a8_linear(x, q, bias, cdt, None, config)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"int8 {label}, tile {config}: {int((got != want).sum())} "
                 f"of {got.numel()} outputs differ from _qdot + bias")
        if act:
            got = es.w8a8_linear(x, q, bias, cdt, act, config)
            ulp = torch.exp2(torch.floor(torch.log2(
                want_act.float().abs().clamp(min=2.0 ** -126))) - 7)
            if not bool(((got.float() - want_act.float()).abs()
                         <= ulp).all()):
                fail(f"int8 {label}, tile {config}: the {act} output is "
                     f"more than one bf16 ulp from torch's")
        gemm, quant = w8a8_times(x, q, bias, act, config)
        quant_ms.append(quant)
        tile_ms["picked" if config is None else
                "%dx%d" % es.GEMM_TILES[config]] = gemm
    ms = tile_ms.pop("picked")
    quant = min(quant_ms)
    # with an activation: the same product without it, on the same tile
    no_act_ms = w8a8_times(x, q, bias)[0] if act else None
    main_ms = w8a8_times(x, q, bias, main_loop_only=True)[0]
    tile = "%dx%d" % es.GEMM_TILES[es.gemm_config(M, N)]
    plain_ms = device_times(lambda: es._act(act)(
        es._qdot(x.float(), q[0], q[1]).to(cdt) + bias.to(cdt)) if act else
        es._qdot(x.float(), q[0], q[1]).to(cdt) + bias.to(cdt), 3)[0]
    a8 = torch.round(x.float() / (x.float().abs().amax(-1, keepdim=True)
                                  .clamp(min=1e-8) / 127)).to(torch.int8)
    b8 = q[2].t()                          # [K, N], column-major
    lib_ms = device_times(lambda: torch._int_mm(a8, b8), 20)[0]
    if not torch.equal(torch._int_mm(a8, b8).double(),
                       a8.double() @ q[0].double()):
        fail(f"int8 {label}: torch._int_mm differs from the exact product")
    xb, wb = x.to(cdt), w.to(cdt)
    bf16_ms = device_times(lambda: torch.matmul(xb, wb), 20)[0]
    ops = 2.0 * M * K * N
    nbytes = M * K + K * N + 4 * M + 4 * N + 2 * N + 2 * M * N
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    q_bytes = M * K * (4 if x_f32 else 2) + M * K + 4 * M
    q_bound = q_bytes / PEAK_BYTES * 1e3
    xq, xs = es.quantize_rows(x)
    torch.cuda.synchronize()
    ref_q, ref_s = es.quantize_rows_plain(x)
    if not (torch.equal(xq, ref_q) and torch.equal(xs, ref_s)):
        fail(f"int8 {label}: quantize_rows differs from quantize_rows_plain")
    q_plain = device_times(lambda: es.quantize_rows_plain(x), 5)[0]

    def amax_round():
        xf = x.float()
        return torch.round(xf * (127.0 / xf.abs().amax(-1, keepdim=True)))

    q_lib = device_times(amax_round, 5)[0]
    log(f"[int8] {label} {M}x{K}x{N}{' +' + act if act else ''}: "
        f"{ms * 1e3:.1f} us on {tile} ({ops / ms / 1e9:.0f} TOP/s; "
        + ", ".join(f"{t} {v * 1e3:.1f}" for t, v in tile_ms.items())
        + (f"; without the {act} {no_act_ms * 1e3:.1f}" if act else "")
        + f"; main loop alone {main_ms * 1e3:.1f}"
        + f" us), torch._int_mm {lib_ms * 1e3:.1f} us "
        f"({ops / lib_ms / 1e9:.0f} TOP/s), bf16 torch.matmul "
        f"{bf16_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{max(t_ops, t_bytes) * 1e3:.1f} us; row quantiser "
        f"({'f32' if x_f32 else 'bf16'} rows) {quant * 1e3:.1f} us, bound "
        f"{q_bound * 1e3:.1f} us, plain {q_plain * 1e3:.1f} us, torch amax "
        f"+ round {q_lib * 1e3:.1f} us; exact on every tile")
    return {"product": label, "m": M, "k": K, "n": N, "tile": tile, "ms": ms,
            "tiles_ms": tile_ms, "no_act_ms": no_act_ms,
            "main_loop_ms": main_ms,
            "quantise": {"ms": quant, "bound_ms": q_bound,
                         "plain_ms": q_plain, "library_ms": q_lib},
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "bf16_matmul_ms": bf16_ms,
            "bound_ms": max(t_ops, t_bytes), "tops": ops / ms / 1e9,
            "max_abs_err": 0.0}


def quantiser_step(gen, device, layers=20):
    """The row quantiser's work in one A-int8 VI step at 512 slots, timed
    as a step: out's rows [B·Q, D] and ffn2's [B·T, F] in bf16, a tensor
    each for each of ``layers`` layers, quantised in layer order (40
    calls) by the kernel, by its plain version and by torch's amax and
    round of the same rows (the yardstick: no one call quantises rows).
    Each loop is timed between CUDA events behind a spin kernel
    (``event_ms``; the best of three), so the host's launches do not
    count.  The rows, 1.06 GB in all, come from HBM; in the step ffn2's
    are left in L2 by ffn1's epilogue, so the kernel's ms in the kernels
    line stays the step's profiled part (``stack_parts``) and its loop
    time here is logged and kept beside it (``loop_ms``).  Returns
    {"plain_ms", "library_ms", "loop_ms"}."""
    import torch
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    c = EmformerConfig()
    T = c.segment_length + c.right_context_length
    Q = T + (1 if c.max_memory_size else 0)
    dev_gen = torch.Generator(device=device).manual_seed(gen.initial_seed())
    xs = [torch.randn((B_SLOTS * rows, K), generator=dev_gen, device=device,
                      dtype=torch.bfloat16)
          for _ in range(layers) for rows, K in ((Q, c.d_model),
                                                 (T, c.ffn_dim))]

    def amax_round(x):
        xf = x.float()
        return torch.round(xf * (127.0 / xf.abs().amax(-1, keepdim=True)))

    step = {key: min(event_ms(lambda: [f(x) for x in xs], 1)
                     for _ in range(3))
            for key, f in (("loop_ms", es.quantize_rows),
                           ("plain_ms", es.quantize_rows_plain),
                           ("library_ms", amax_round))}
    log(f"[kernels] A-int8's row quantiser, a VI step's {len(xs)} calls "
        f"(out's and ffn2's rows of {layers} layers at {B_SLOTS} slots, "
        f"from HBM): the kernel {step['loop_ms']:.3f} ms, plain "
        f"{step['plain_ms']:.3f} ms, torch amax + round "
        f"{step['library_ms']:.3f} ms")
    del xs
    torch.cuda.empty_cache()
    return step


def phase_int8(gen, device):
    """A-int8's product at the ten serving product shapes (VI and EN, five
    each), then a ragged shape (K = 208) and the tiny test geometry.
    Returns the ten serving shapes' entries."""
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    out = []
    for lang, c in (("vi", EmformerConfig()), ("en", RNNTConfig().emformer)):
        for name, M, K, N, act in gemm_shapes(
                B_SLOTS, c.segment_length, c.right_context_length,
                c.max_memory_size, c.d_model, c.ffn_dim, c.activation):
            out.append(check_int8(f"{lang} {name}", M, K, N, act,
                                  name in ("q", "ffn1"), gen, device))
    for label, M, K, N, act in (("ragged", 300, 208, 136, None),
                                ("tiny ffn1", 60, 64, 96, "gelu"),
                                ("tiny kv", 84, 64, 128, None)):
        check_int8(label, M, K, N, act, False, gen, device)
    return out


def append_traffic(B, max_t, U, V, gen, device):
    """Kernel B's serving traffic at one shape: the buffer [B, max_t, V]
    f16 (drawn on the card, up to 1 GB of it), the rows [B, U, V] f32, the
    positions as the ticks clip them (whole segments, the last one at
    max_t - max_t % U - U) and 80% of the slots decoding, from ``gen``.
    Returns (buf, rows, pos, decode)."""
    import torch
    dev_gen = torch.Generator(device=device).manual_seed(gen.initial_seed())
    buf = torch.randn((B, max_t, V), generator=dev_gen, device=device,
                      dtype=torch.float16)
    rows = torch.randn((B, U, V), generator=gen).to(device)
    pos = (torch.randint(0, max_t // U, (B,), generator=gen) * U).to(
        device=device, dtype=torch.int32)
    decode = (torch.rand(B, generator=gen) < 0.8).to(device)
    return buf, rows, pos, decode


def append_times(buf, rows, pos, decode):
    """Kernel B's device time per launch on ``append_traffic``'s tensors
    (100 launches profiled) and its bytes bound: each decoding slot's U
    rows read as f32 and written as f16, every slot's pos and decode flag
    read once.  Returns (ms, bound ms)."""
    from asr_streaming_tpu_torch.ops import emission_append as ea
    B, U, V = rows.shape
    ms = device_times(lambda: ea.emission_append(buf, rows, pos, decode),
                      100, need="emission_append")[0]
    nbytes = int(decode.sum()) * U * V * (4 + 2) + B * (4 + 1)
    return ms, nbytes / PEAK_BYTES * 1e3


def check_append(B, max_t, U, V, gen, device, label):
    """Kernel B against its plain version (exact) at one serving shape,
    at the positions the ticks give and at any position (pos not a
    multiple of U: the runs start off every 16-byte boundary where V is
    odd), at both ends and out of range (no write), with its device time
    beside the plain version's, index_put_'s and its bytes bound, and the
    kernel's time with no slot decoding (every block reads its flags and
    stops: the launch's floor).  Returns the kernel's line entry."""
    import torch
    from asr_streaming_tpu_torch.ops import emission_append as ea
    buf0, rows, pos, decode = append_traffic(B, max_t, U, V, gen, device)
    anywhere = torch.randint(0, max_t - U + 1, (B,), generator=gen)
    anywhere[:4] = torch.tensor([0, max_t - U, -1, max_t - U + 1])
    anywhere = anywhere.to(device=device, dtype=torch.int32)
    for where, p in (("the ticks' positions", pos), ("any position", anywhere)):
        got = ea.emission_append(buf0.clone(), rows, p, decode)
        want = ea.emission_append_plain(buf0.clone(), rows, p, decode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{label}: kernel differs from the plain version at {where}")
        del got, want
    buf = buf0
    ms_b, bound = append_times(buf, rows, pos, decode)
    idle = torch.zeros_like(decode)
    floor_b = device_times(lambda: ea.emission_append(buf, rows, pos, idle),
                           100, need="emission_append")[0]
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
    log(f"[kernels] {label}: exact at buf [{B}, {max_t}, {V}], rows U={U}, "
        f"and at any position; {ms_b * 1e3:.2f} us (plain "
        f"{plain_b * 1e3:.1f} us, index_put {lib_b * 1e3:.1f} us, bound "
        f"{bound * 1e3:.2f} us; no slot decoding {floor_b * 1e3:.2f} us), "
        f"{nd} of {B} slots decode")
    del buf0, buf
    torch.cuda.empty_cache()
    return {"name": "emission_append", "route": "cuda",
            "source": "asr_streaming_tpu_torch/csrc/emission_append.cu",
            "replaces": "asr_streaming_tpu/ops/pallas_append.py:109",
            "launches": 0, "max_abs_err": 0.0, "ms": ms_b,
            "plain_ms": plain_b, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_b, "floor_ms": floor_b}


def phase_kernels(gen, device):
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    results = []

    # ---- kernel A at VI full width (B=512, D=512, H=8, F=2048, U=16, R=4,
    # Lc=32, M=4), 3 chained ticks with reset/advance churn and lengths
    # growing from mixed fills.
    B = 512
    # f32, 20 layers, elementwise 1e-4: only the f32 summation order
    # differs (two plain versions differ by ~1e-5 here); every product has
    # more than 128 rows, so the tiled f32 kernel runs them
    _, last = check_stack(EmformerConfig(compute_dtype=torch.float32), B, 3,
                          1e-4, gen, device, "A vi f32 L=20")
    ms_f32 = f32_step_ms(last, "A vi f32 L=20, one step at 512 slots",
                         "gemm_f32_kernel")
    del last
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
    ms = device_times(kernel_a, 5, need=A_KERNELS)[0]
    plain_ms = device_times(plain_a, 2)[0]
    digest = stack_digest(vi, B, 0, device, "A vi bf16 L=20")[0]
    profile_top(kernel_a, "A emformer_stack, one VI step at 512 slots")
    L, D, Fd = vi.num_layers, vi.d_model, vi.ffn_dim
    geo = (B, L, D, vi.segment_length, vi.right_context_length,
           vi.max_memory_size, vi.left_context_length)
    parts = stack_parts(kernel_a, "A, one VI step", geo, reset=reset,
                        advance=advance)
    # the row kernels alone against their plain versions, and their
    # library yardsticks (F.layer_norm, Tensor.copy_)
    row_check = check_rows("A vi bf16", B, D, vi.segment_length,
                           vi.right_context_length, vi.max_memory_size,
                           vi.left_context_length, torch.bfloat16, gen,
                           device)
    parts["rows"].update(library=row_library_ms(*geo, torch.bfloat16,
                                                device))
    parts["rows"]["library_ms"] = parts["rows"]["library"]["ms"]
    lib = parts["rows"]["library"]
    log(f"[kernels] A vi row kernels: {parts['rows']['ms']:.3f} ms a step in "
        f"{parts['rows']['launches']} launches, bound "
        f"{parts['rows']['bound_ms']:.3f} ms; library yardstick "
        f"{_us(lib['ms'])} a step (F.layer_norm on [B*T, D] f32 "
        f"{_us(lib['layer_norm_ms'])}, copy_ of a layer's roll "
        f"{_us(lib['copy_ms'])})")
    # the yardstick of the bf16 GEMMs: the step's 100 products on
    # torch.matmul, timed together (no single call computes the step)
    parts["gemm"]["library_ms"] = matmul_step(params, vi, B, gen, device)
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
        "library_ms": None, "parts": parts, "sha256": digest,
        "vi_f32_ms": ms_f32, "rows": row_check})

    # ---- kernel B: VI serving shape, exact equality with the plain version
    results.append(check_append(B, 1024, 16, 803, gen, device, "B"))

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
    ms_q = device_times(kernel_a, 5, need=A_INT8_KERNELS)[0]
    plain_q = device_times(plain_a, 2)[0]
    profile_top(kernel_a, "A emformer_stack int8, one VI step at 512 slots")
    parts_q = stack_parts(kernel_a, "A-int8, one VI step", geo,
                          need=A_INT8_KERNELS, reset=reset, advance=advance,
                          quant="int8", F=Fd)
    # the yardstick of the int8 GEMMs: the step's 100 products on
    # torch._int_mm, timed together (no single call computes the step)
    parts_q["gemm_int8"]["library_ms"] = int_mm_step(params, vi, B, gen,
                                                     device)
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
        "library_ms": None, "parts": parts_q})
    del params, mem, lck, lcv, last
    torch.cuda.empty_cache()

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
    ms_c = device_times(lambda: el.emformer_layer(*args, **kw_c), 10,
                        need=C_KERNELS)[0]
    plain_c = device_times(
        lambda: el.emformer_layer_plain(*args[:8], args[8].bool(),
                                        args[9].bool(), **kw_c), 3)[0]
    t_ops = stack_flops(B, 1, D, Fd, vi.segment_length,
                        vi.right_context_length, vi.max_memory_size,
                        vi.left_context_length) / PEAK_BF16_FLOPS * 1e3
    t_bytes = (emformer_bytes(vi, B, 1, 2) + 4 * B * D * 2
               + 4 * B * vi.right_context_length * D) / PEAK_BYTES * 1e3
    # the yardstick of C's products: one layer's five on torch.matmul
    lib_c = matmul_step(params, dataclasses.replace(vi, num_layers=1), B,
                        gen, device, label="C")
    log(f"[kernels] C: {ms_c:.3f} ms per layer call (plain {plain_c:.3f} ms),"
        f" bound {max(t_ops, t_bytes):.3f} ms")
    results.append({
        "name": "emformer_layer", "route": "cuda",
        "source": "asr_streaming_tpu_torch/csrc/emformer_stack.cu",
        "replaces": "asr_streaming_tpu/ops/pallas_emformer.py:401",
        "launches": 0, "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "gemm": {"library_ms": lib_c}})
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


def _sentence_audio(s, total, sr=16000, lead=0.0):
    """The tone sentences of tests/test_overfit_e2e.py (``lead`` seconds
    of silence first)."""
    import numpy as np
    tone_hz = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0, " ": 1000.0}
    parts = [np.zeros(int(sr * lead), np.float32)]
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
    final.  Returns the worker child's launch counts and the in-process
    events, stream by stream."""
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
    return launches, want


# ------------------------------------------------- the English (RNNT) path

def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_row_topk(gen, device):
    """Kernel E against its plain version iter_topk, values and indices
    exactly, and against the stable descending sort (indices), on the
    beam's rows and the tie / sentinel / narrow / wide-k / k=1 / k=N /
    unaligned / -inf / widest-row cases; device times at the wide and the
    two narrow beam shapes beside iter_topk's and torch.topk's.  Returns
    E's line entry."""
    import torch
    from asr_streaming_tpu_torch.models.rnnt_beam import NEG
    from asr_streaming_tpu_torch.ops import row_topk as rk
    from asr_streaming_tpu_torch.ops.topk import iter_topk

    def same(x, k, label):
        gv, gi = rk.cuda_row_topk(x, k)
        torch.cuda.synchronize()
        wv, wi = iter_topk(x, k)
        if (gv.dtype, gi.dtype, gv.shape) != (wv.dtype, wi.dtype, wv.shape):
            fail(f"E {label}: {gv.dtype} {gi.dtype} {tuple(gv.shape)} vs "
                 f"{wv.dtype} {wi.dtype} {tuple(wv.shape)}")
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            bad = int(((gv != wv) | (gi != wi)).any(-1).sum())
            fail(f"E {label}: {bad} rows differ from iter_topk")
        si = torch.sort(x.float(), dim=-1, descending=True, stable=True)[1]
        if not torch.equal(gi.long(), si[..., :k]):
            fail(f"E {label}: indices differ from the stable sort's")
        log(f"[kernels] E {label}: {tuple(x.shape)} {x.dtype} k={k} == "
            f"iter_topk (values, indices) == stable sort (indices)")
        return gv

    B, W, V, k = B_SLOTS, 10, 4097, 10
    logp = torch.log_softmax(
        torch.randn((B, W, V), generator=gen).to(device) * 3.0, -1)
    gv = same(logp, k, "beam rows (log-softmax)")
    ties = torch.randint(0, 40, (1024, V), generator=gen).to(device).float()
    same(ties, k, "rows of ties")
    dead = logp[:64].clone()
    dead[torch.rand((64, W, V), generator=gen).to(device) < 0.95] = NEG
    dead[0] = NEG                                   # whole rows of the sentinel
    same(dead, k, "rows heavy with -1e30")
    inf = logp[:16].clone()
    inf[..., ::3] = float("-inf")
    inf[0, 0, 5:] = float("-inf")
    same(inf, k, "rows holding -inf")
    for n in (W * k, 50):                           # the beam's flat tables
        flat = torch.randn((B, n), generator=gen).to(device) * 20.0
        flat[torch.rand((B, n), generator=gen).to(device) < 0.5] = NEG
        same(flat, W, f"flat table N={n}")
    same(logp[:32], 128, "k=128")
    same(logp[:64].to(torch.bfloat16), k, "bf16 rows")
    same(logp[:64], 1, "k=1")
    same(logp[:64, :, :40], 40, "k=N=40")
    same(logp[:64, :, :20], 5, "N=20")
    rows = logp[:16].reshape(-1, V)
    shifted = torch.empty(rows.numel() + 1, device=device)
    shifted[1:] = rows.reshape(-1)
    same(shifted[1:].view(rows.shape), k, "rows 4 bytes off alignment")
    same(torch.full((8, V), float("-inf"), device=device), k,
         "whole rows of -inf")
    same(torch.randn((2, rk.MAX_N), generator=gen).to(device), k,
         f"N={rk.MAX_N}")
    for bad_k, bad_x in ((129, logp[:1]), (60, logp[:1, :1, :50])):
        try:
            rk.cuda_row_topk(bad_x, bad_k)
        except ValueError:
            continue
        fail(f"E: k={bad_k} on N={bad_x.shape[-1]} did not raise")

    ms = device_times(lambda: rk.cuda_row_topk(logp, k), 20,
                      need="row_topk")[0]
    plain_ms = device_times(lambda: iter_topk(logp, k), 3)[0]
    lib_ms = device_times(lambda: torch.topk(logp, k, dim=-1), 20)[0]
    if not torch.equal(torch.topk(logp, k, dim=-1).values, gv):
        fail("E: torch.topk's values differ")
    nbytes = B * W * V * 4 + B * W * k * 8
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[kernels] E: [{B * W}, {V}] k={k}: {ms * 1e3:.1f} us (plain "
        f"iter_topk {plain_ms * 1e3:.1f} us, torch.topk {lib_ms * 1e3:.1f} "
        f"us, values equal), {nbytes / 1e6:.1f} MB, bound {bound * 1e3:.1f}"
        f" us")
    # the beam's two narrow selections: top-W of the [B, W * kcap]
    # survivor table and of the [B, (K + 1) * W] end-of-frame table
    narrow = {}
    for n in (W * k, 50):
        flat = torch.randn((B, n), generator=gen).to(device)
        n_ms = device_times(lambda: rk.cuda_row_topk(flat, W), 50,
                            need="row_topk")[0]
        n_plain = device_times(lambda: iter_topk(flat, W), 5)[0]
        n_lib = device_times(lambda: torch.topk(flat, W, dim=-1), 50)[0]
        n_bound = (B * n * 4 + B * W * 8) / PEAK_BYTES * 1e3
        log(f"[kernels] E narrow [{B}, {n}] k={W}: {n_ms * 1e3:.1f} us "
            f"(plain {n_plain * 1e3:.1f} us, torch.topk {n_lib * 1e3:.1f} "
            f"us, bound {n_bound * 1e3:.2f} us)")
        narrow[f"{B}x{n}"] = {"ms": n_ms, "plain_ms": n_plain,
                              "library_ms": n_lib, "bound_ms": n_bound}
    return {"name": "row_topk", "route": "cuda",
            "source": "asr_streaming_tpu_torch/csrc/row_topk.cu",
            "replaces": "asr_streaming_tpu/ops/pallas_topk.py:82",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms, "narrow": narrow}


def check_stack_en(gen, device):
    """Kernel A at the EN transcriber's geometry (B=512, L=20, U=4, R=1,
    Lc=30, M=0: 35 keys, 5 queries, 2,560 GEMM rows) against its plain
    version, as at the VI geometry: f32 elementwise 1e-4, bf16 at 3 layers
    elementwise 3e-2, bf16 at 20 layers by relative L2 with the noise
    floor; then with the masks absent, as the RNNT ticks call it.
    Returns {"en": {ms, plain_ms, bound_ms, bound_by, max_abs_err,
    parts}}."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    B = B_SLOTS
    em = RNNTConfig().emformer
    check_stack(dataclasses.replace(em, compute_dtype=torch.float32), B, 2,
                1e-4, gen, device, "A en f32 L=20")
    bf = dataclasses.replace(em, compute_dtype=torch.bfloat16)
    check_stack(dataclasses.replace(bf, num_layers=3), B, 3, 3e-2, gen,
                device, "A en bf16 L=3")
    err, last = check_stack(bf, B, 3, 3e-2, gen, device, "A en bf16 L=20",
                            relative=True)
    params, x, mem, lck, lcv, eff, reset, advance, kw = last
    got = es.emformer_stack(params, x, mem, lck, lcv, eff, **kw)
    torch.cuda.synchronize()
    want = es.emformer_stack_plain(
        params, x, mem, lck, lcv, eff, torch.zeros_like(reset),
        torch.ones_like(advance), **kw)
    for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
        if g.numel():
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            if not rel <= 3e-2:
                fail(f"A en, masks absent, {name}: relative error {rel:.3e}")
    log("[kernels] A en bf16 L=20: masks absent == reset none, advance all "
        "(relative L2 within 3e-2 of the plain version)")

    def kernel_a():
        return es.emformer_stack(params, x, mem, lck, lcv, eff, reset,
                                 advance, **kw)

    ms = device_times(kernel_a, 5, need=A_KERNELS)[0]
    plain_ms = device_times(
        lambda: es.emformer_stack_plain(params, x, mem, lck, lcv, eff, reset,
                                        advance, **kw), 2)[0]
    profile_top(kernel_a, "A emformer_stack, one EN step at 512 slots")
    geo = (B, bf.num_layers, bf.d_model, bf.segment_length,
           bf.right_context_length, 0, bf.left_context_length)
    parts = stack_parts(kernel_a, "A, one EN step", geo, reset=reset,
                        advance=advance)
    row_check = check_rows("A en bf16", B, bf.d_model, bf.segment_length,
                           bf.right_context_length, 0, bf.left_context_length,
                           torch.bfloat16, gen, device,
                           tanh_on_mem=bf.tanh_on_mem)
    parts["rows"].update(library=row_library_ms(*geo, torch.bfloat16,
                                                device))
    parts["rows"]["library_ms"] = parts["rows"]["library"]["ms"]
    parts["gemm"]["library_ms"] = matmul_step(params, bf, B, gen, device,
                                              label="A en")
    flops = stack_flops(B, bf.num_layers, bf.d_model, bf.ffn_dim,
                        bf.segment_length, bf.right_context_length, 0,
                        bf.left_context_length)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = emformer_bytes(bf, B, bf.num_layers, 2) / PEAK_BYTES * 1e3
    log(f"[kernels] A en: {ms:.3f} ms/step device time (plain {plain_ms:.3f}"
        f" ms), {flops / 1e12:.3f} TFLOP, bound {max(t_ops, t_bytes):.3f} ms"
        f" ({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"en": {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "max_abs_err": err, "parts": parts, "rows": row_check,
                   "sha256": stack_digest(bf, B, 0, device,
                                          "A en bf16 L=20")[0]}}


def check_hash(gen, device):
    """The beam's rolling hash relies on int32 products that wrap: the
    card's result against numpy's two's-complement arithmetic, 8 chained
    updates of both lanes."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models import rnnt_beam as rb
    n = 4096
    for mult, init in ((rb._HASH_M1, rb._HASH_INIT1),
                       (rb._HASH_M2, rb._HASH_INIT2)):
        h = torch.full((n,), init, dtype=torch.int32, device=device)
        want = np.full(n, init, np.int64)
        for _ in range(8):
            tok = torch.randint(0, 4097, (n,), generator=gen,
                                dtype=torch.int32)
            h = h * mult + (tok.to(device) + 1)
            want = (want * mult + tok.numpy() + 1 + 2**31) % 2**32 - 2**31
        if h.dtype != torch.int32 or not np.array_equal(
                h.cpu().numpy(), want.astype(np.int32)):
            fail(f"int32 hash lane x{mult} does not wrap as numpy's on "
                 f"{device}")
    log("[kernels] int32 rolling hash: 8 chained wrapping updates of both "
        "lanes equal numpy's two's complement")


def phase_kernels_en(gen, device, kernels):
    """E, and A and B at the EN geometry; adds E's entry and the "en"
    sub-entries of A's and B's."""
    e = check_row_topk(gen, device)
    by_name = {k["name"]: k for k in kernels}
    a_en = check_stack_en(gen, device)
    b_en = check_append(B_SLOTS, 1024, 4, 1024, gen, device, "B en")
    # (a run of the EN phases alone has no A or B entry to extend)
    by_name.get("emformer_stack", {}).update(a_en)
    by_name.get("emission_append", {}).update(
        {"en": {k: b_en[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}})
    check_hash(gen, device)
    kernels.append(e)


# The raw random init gives every token a log-prob near -log(4097): an
# emission always costs more than it gains, and the beam's best hypothesis
# stays empty.  The full-width EN phases scale the joiner's weights by this
# gain, so the random model's distribution is peaked as a trained one's is
# and the beams hold tokens.
EN_JOINER_GAIN = 6.0


def en_random_params(seed, cfg, device):
    """The EN phases' weights: random from ``seed``, the joiner sharpened
    (EN_JOINER_GAIN)."""
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    params = init_serving_params(seed, cfg, device)
    params["joiner"] = dict(params["joiner"],
                            w=params["joiner"]["w"] * EN_JOINER_GAIN)
    return params


def en_serving_cfg(beam_width=None):
    """server-en.yaml's model and tick: RNNTConfig defaults (D=512, H=8,
    F=2048, 20 layers, U=4, R=1, Lc=30, M=0, encoding 1024, V=4097, 3 LSTM
    layers), bf16 Emformer, mu-law upload, no Silero; ``beam_width`` sets
    the device beam."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.rnnt import (
        RNNTConfig, rnnt_config_for_audio,
    )
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
    rnnt = RNNTConfig()
    rnnt = rnnt_config_for_audio(dataclasses.replace(
        rnnt, emformer=dataclasses.replace(
            rnnt.emformer, compute_dtype=torch.bfloat16)), EN_AUDIO)
    asr = dataclasses.replace(ASRConfig.vietnamese(torch.bfloat16),
                              audio=EN_AUDIO)
    return ServingConfig(asr=asr, model_kind="rnnt", rnnt=rnnt,
                         use_silero=False, upload_encoding="mulaw",
                         en_beam_width_device=beam_width)


def run_en_ticks(params, cfg, B, segs, device):
    """One EN serving tick per segment batch, every slot decoding (the
    first tick resets); checks the pack, the tokens and the encoding rows.
    Returns (host seconds per tick, packs, state, ctx, buffer)."""
    import torch
    from asr_streaming_tpu_torch.models.serving import (
        PACK_DATA, init_audio_context, init_emission_buffer,
        init_serving_state, make_serving_step,
    )
    step = make_serving_step(cfg)
    state = init_serving_state(cfg, B, device)
    ctx = init_audio_context(cfg, B, device)
    buf = init_emission_buffer(cfg, B, device)
    rnnt = cfg.rnnt
    U = rnnt.emformer.segment_length
    beam = bool(cfg.en_beam_width_device)
    width = PACK_DATA + (1 + cfg.en_beam_cap if beam
                         else U * rnnt.max_symbols_per_frame)
    ones = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, dtype=torch.bool, device=device)
    times, packs = [], []
    for t, seg in enumerate(segs):
        _sync(device)
        t0 = time.perf_counter()
        out = step(params, cfg, seg, ones if t else zeros, ones,
                   zeros if t else ones, zeros if t else ones, state, ctx,
                   buf)
        _sync(device)
        times.append(time.perf_counter() - t0)
        state, ctx, buf = out.state, out.ctx, out.emission
        if tuple(out.pack.shape) != (B, width):
            fail(f"EN pack shape {tuple(out.pack.shape)} != {(B, width)}")
        if not torch.isfinite(out.pack).all():
            fail("non-finite EN pack")
        data = out.pack[:, PACK_DATA:]
        if beam and (data[:, 0].min() < 0 or data[:, 0].max() > cfg.en_beam_cap):
            fail("beam token count out of range")
        toks = data[:, 1:] if beam else data
        if toks.min() < 0 or toks.max() >= rnnt.vocab_size:
            fail("EN token out of the vocabulary")
        packs.append(out.pack)
    if not bool(packs[-1][:, 0].all()):
        fail("not every slot decoded in the last EN tick")
    rows = buf[:, :len(segs) * U].float()
    if not torch.isfinite(rows).all() or not bool((rows != 0).any()):
        fail("EN encoding rows are not finite, non-zero values")
    if int(state.encoder.length.min().item()) != len(segs) * U:
        fail(f"EN lengths {state.encoder.length.min().item()} != "
             f"{len(segs) * U}")
    return times, packs, state, ctx, buf


def phase_en_serving(seed, gen, device, n_greedy=6, n_beam=4):
    """Full-width EN ticks at 512 slots: greedy, then the device beam with
    kernel E and once more with iter_topk forced at its three selections
    (equal packs and beams, exactly).  Returns the params."""
    import torch
    from asr_streaming_tpu_torch.models import rnnt_beam
    from asr_streaming_tpu_torch.models.serving import make_serving_step
    from asr_streaming_tpu_torch.ops.topk import iter_topk
    B = B_SLOTS
    greedy, beam = en_serving_cfg(), en_serving_cfg(10)
    # an int seed: the worker child rebuilds the same weights from it
    params = en_random_params(seed, greedy, device)
    seg_len = greedy.asr.audio.segment_length
    segs = [torch.randint(0, 256, (B, seg_len), generator=gen,
                          dtype=torch.uint8).to(device)
            for _ in range(max(n_greedy, n_beam))]
    ones = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, dtype=torch.bool, device=device)

    def report(label, cfg, times, state, ctx, buf):
        step = make_serving_step(cfg)
        dev_ms, launches = profile_top(
            lambda: step(params, cfg, segs[0], ones, ones, zeros, zeros,
                         state, ctx, buf),
            f"one EN {label} tick at {B} slots", n=12, also=("row_topk",))
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = sorted(times[1:])
        log(f"[en serving] {label}: {len(times)} ticks x {B} slots: first "
            f"{times[0] * 1e3:.1f} ms, median {_median_ms(times):.2f} ms, "
            f"min {steady[0] * 1e3:.2f} ms; device time {dev_ms:.2f} ms in "
            f"{launches} kernel launches per tick; peak {peak:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    times, _, state, ctx, buf = run_en_ticks(params, greedy, B,
                                             segs[:n_greedy], device)
    report("greedy", greedy, times, state, ctx, buf)
    del state, ctx, buf
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    times, packs, state, ctx, buf = run_en_ticks(params, beam, B,
                                                 segs[:n_beam], device)
    report("beam (width 10)", beam, times, state, ctx, buf)
    del ctx, buf
    kernel_topk = rnnt_beam.row_topk
    rnnt_beam.row_topk = iter_topk          # the plain version, forced
    try:
        times_p, packs_p, state_p, _, _ = run_en_ticks(params, beam, B,
                                                       segs[:n_beam], device)
    finally:
        rnnt_beam.row_topk = kernel_topk
    for t, (a, b) in enumerate(zip(packs, packs_p)):
        if not torch.equal(a, b):
            fail(f"beam tick {t}: the pack with kernel E differs from the "
                 f"pack with iter_topk")
    for name in ("tokens", "lengths", "h1", "h2"):
        if not torch.equal(getattr(state.beam, name),
                           getattr(state_p.beam, name)):
            fail(f"beam {name} with kernel E differ from iter_topk's")
    n_tok = packs[-1][:, 5]
    if n_tok.max().item() < 1:
        fail("no beam holds a token: the E vs iter_topk comparison is empty")
    log(f"[en serving] beam with kernel E == beam with iter_topk over "
        f"{n_beam} ticks: packs, token buffers, lengths and hashes equal; "
        f"best hypotheses hold {n_tok.min().item():.0f}-"
        f"{n_tok.max().item():.0f} tokens; iter_topk-forced tick median "
        f"{_median_ms(times_p):.2f} ms against {_median_ms(times):.2f} ms")
    del state, state_p, packs, packs_p
    torch.cuda.empty_cache()
    return params


def _event_list(events):
    return [(e.stream_id, e.kind, e.text) for e in events]


def _per_stream(events):
    """{stream: [(kind, text)]} in event order: what each stream's client
    sees.  Across groups the order in which packs surface follows the
    device's timing (GroupedScheduler ticks the group whose pack is ready
    first), so only each stream's own sequence is the scheduler's result."""
    out = {}
    for sid, kind, text in _event_list(events):
        out.setdefault(sid, []).append((kind, text))
    return out


def phase_en_scheduler(params, seed, device):
    """server-en.yaml's default mode (beam partials, width 10) answering
    requests: 4 streams through the in-process Scheduler at 512 slots,
    through an in-process GroupedScheduler(groups=2), and through
    GroupedScheduler(groups=2) over the device worker.  The two grouped
    runs see the same batch shapes and must give each stream the same
    events.  Returns
    the worker child's launch counts."""
    from asr_streaming_tpu_torch.streaming.scheduler import (
        GroupedScheduler, Scheduler,
    )
    import tempfile
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    from asr_streaming_tpu_torch.utils.checkpoint import save_params
    cfg = en_serving_cfg()
    vocab = placeholder_vocab(cfg.rnnt.vocab_size)
    kw = dict(max_slots=B_SLOTS, language="en", rules=_flush_rules(),
              en_beam_partials=True, en_beam_width=10)
    sched = Scheduler(params, cfg, vocab, device=device, **kw)
    warm = sched.warmup()
    single, dt = _drive_four_streams(sched, "EN in process")
    sched.close()
    p50 = sched.timers.snapshot()["stages"]["tick"]["p50_ms"]
    log(f"[en scheduler] in process, beam mode, 4 streams x 3.2 s at "
        f"{B_SLOTS} slots: {sched.ticks} ticks in {dt:.2f} s (warmup "
        f"{warm:.2f} s), {len(single)} events, tick p50 {p50} ms")

    grouped = GroupedScheduler(params, cfg, vocab, groups=2, device=device,
                               **kw)
    grouped.warmup()
    want, _ = _drive_four_streams(grouped, "EN grouped in process")
    grouped.close()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the child rebuilds the weights from the seed; the sharpened
        # joiner reaches it as a partial checkpoint
        ckpt = os.path.join(tmp, "joiner.npz")
        save_params(ckpt, {"joiner": {"w": params["joiner"]["w"]}})
        wk = GroupedScheduler(None, cfg, vocab, groups=2,
                              device_worker={"seed": seed, "checkpoint": ckpt,
                                             "device": str(device)}, **kw)
        try:
            warm = wk.warmup()
            stats = wk.client.stats(reset=True)
            if stats["foreign_modules"]:
                fail("the EN worker child imported "
                     f"{stats['foreign_modules'][:5]}")
            got, dt = _drive_four_streams(wk, "EN grouped worker")
            launches = wk.client.stats()["launches"]
            p50w = wk.timers.snapshot()["stages"]["tick"]["p50_ms"]
        finally:
            wk.close()
    if _per_stream(got) != _per_stream(want):
        fail(f"EN grouped worker events differ from the in-process grouped "
             f"scheduler's: {_per_stream(got)} vs {_per_stream(want)}")
    same = sorted(_event_list(single)) == sorted(_event_list(got))
    log(f"[en scheduler] GroupedScheduler(groups=2) over the device worker, "
        f"beam mode: {wk.ticks} group ticks in {dt:.2f} s (child start + "
        f"warmup {time.perf_counter() - t0 - dt:.1f} s, warm step "
        f"{warm:.2f} s), {len(got)} events, each stream's equal to the "
        f"in-process grouped scheduler's ({'also' if same else 'not'} the 512-slot scheduler's "
        f"set), group tick p50 {p50w} ms (in process: {p50} ms); child "
        f"launches {({k: v for k, v in launches.items() if v})}")
    return launches


EN_PIECES = ["\u2581a", "\u2581b", "\u2581c", "\u2581d", "<b>"]


def _en_sentence_audio(s, total=3.84, sr=16000):
    """The tone sentences of tests/test_overfit_rnnt_e2e.py: one tone per
    letter (each a word piece), 80 ms gaps, no tone for the space."""
    import numpy as np
    tone_hz = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0}
    parts = []
    for ch in s.replace(" ", ""):
        t = np.arange(int(sr * 0.24)) / sr
        wave = 0.3 * np.sin(2 * np.pi * tone_hz[ch] * t)
        ramp = np.minimum(1.0, np.arange(len(t)) / (0.010 * sr))
        parts.extend([(wave * ramp * ramp[::-1]).astype(np.float32),
                      np.zeros(int(sr * 0.08), np.float32)])
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(sr * total) - len(audio)))


def _en_fixture_events(sched, golden):
    """Two streams: the sentence; the sentence twice (a final, a reset, a
    second final).  Per-stream [(kind, text)]."""
    import numpy as np
    one = _en_sentence_audio(golden)
    streams = [sched.admit(f"t{i}") for i in range(2)]
    for s, a in zip(streams, (one, np.concatenate([one, one]))):
        s.accept_waveform(a)
        s.add_tail_padding()
    out = {}
    for e in sched.drain():
        out.setdefault(e.stream_id, []).append((e.kind, e.text.strip()))
    return out


def phase_en_golden(device):
    """The RNNT overfit fixture at 512 slots on the card: greedy mode and
    beam mode (width 4, the trained VAD gating silence, as the fixture was
    accepted), each in process and through the grouped worker: the same
    events, and the golden sentence as every non-empty final.  Returns the
    worker children's launch counts and the beam mode's in-process
    events."""
    import dataclasses
    import tempfile
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    from asr_streaming_tpu_torch.models.serving import (
        ServingConfig, init_serving_params,
    )
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import (
        GroupedScheduler, Scheduler,
    )
    from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, overlay_params, save_params,
    )
    fixtures = os.path.join(HERE, "assets", "test_fixtures")
    path = os.path.join(fixtures, "overfit_rnnt.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["beam_golden"]
    vad = load_params(os.path.join(fixtures, "overfit_rnnt_vad.npz"))
    base = ServingConfig(
        asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
        model_kind="rnnt", rnnt=RNNTConfig.tiny(vocab_size=len(EN_PIECES)),
        use_silero=False, use_energy_gate=False, energy_threshold_db=-200.0)
    rules = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the worker reads VAD weights from an .npz with a "vad" subtree
        vad_path = os.path.join(tmp, "vad.npz")
        save_params(vad_path, {"vad": vad})
        for label, cfg, kw, worker_kw in (
                ("greedy", base, {}, {}),
                ("beam", dataclasses.replace(base, use_silero=True),
                 {"en_beam_partials": True, "en_beam_width": 4},
                 {"vad_weights": vad_path})):
            params = overlay_params(init_serving_params(1, cfg, device),
                                    load_params(path))
            if cfg.use_silero:
                params = overlay_params(params, {"vad": vad})
            kw = dict(kw, max_slots=B_SLOTS, language="en", rules=rules)
            sched = Scheduler(params, cfg, EN_PIECES, device=device, **kw)
            want = _en_fixture_events(sched, golden)
            sched.close()
            finals = {sid: [t for k, t in ev if k == "final" and t]
                      for sid, ev in want.items()}
            if finals != {"t0": [golden], "t1": [golden, golden]}:
                fail(f"EN {label}: finals {finals}, golden {golden!r}")
            partials = [t for k, t in want["t0"] if k == "partial" and t]
            if not partials or not all(golden.startswith(p) for p in partials):
                fail(f"EN {label}: partials do not grow toward {golden!r}: "
                     f"{partials}")
            wk = GroupedScheduler(
                None, cfg, EN_PIECES, groups=2,
                device_worker=dict(worker_kw, seed=1, checkpoint=path,
                                   device=str(device)), **kw)
            try:
                wk.warmup()
                wk.client.stats(reset=True)
                got = _en_fixture_events(wk, golden)
                for k, v in wk.client.stats()["launches"].items():
                    totals[k] = totals.get(k, 0) + v
            finally:
                wk.close()
            if got != want:
                fail(f"EN {label}: grouped worker events {got} != in "
                     f"process {want}")
            log(f"[en golden] overfit_rnnt, {label} mode at {B_SLOTS} slots: "
                f"finals {finals}, partials of t0 {partials}; "
                f"GroupedScheduler(groups=2) over the device worker gives "
                f"the same events")
    return totals, want


# ------------------------------------------------------- the websocket server

SERVER_PACKET_S = 0.25          # the reference client's packet


class ServerThread:
    """A StreamingServer on a free loopback port, its event loop on a
    thread of this process (the in-process half of the server phase)."""

    def __init__(self, server):
        import asyncio
        import threading
        self.server = server
        self._loop = asyncio.new_event_loop()
        self._task = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()
        if not self._ready.wait(900):
            fail("the in-process server did not start serving")
        self.port = server.port

    def _main(self):
        import asyncio

        async def run():
            self._task = asyncio.ensure_future(
                self.server.run(0, host="127.0.0.1"))
            while self.server.serving is None or \
                    not self.server.serving.is_set():
                if self._task.done():
                    self._ready.set()
                    self._task.result()
                await asyncio.sleep(0.01)
            self._ready.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._loop.run_until_complete(run())

    def close(self):
        if self._task is not None:
            self._loop.call_soon_threadsafe(self._task.cancel)
        self._thread.join(timeout=60)
        self.server.stop_ticks()
        self.server.scheduler.close()


async def _ws_stream(url, pcm, paced, rate=16000):
    """One client connection: ``pcm`` (int16) in 0.25 s binary packets
    (at real-time pace when ``paced``), then EOS.  Returns the messages
    with their arrival times, each segment's completion time (the send of
    the packet that completed it), the EOS send time and the
    __REQUEST_COMPLETED__ arrival time."""
    import asyncio
    import numpy as np
    import websockets
    step = int(rate * SERVER_PACKET_S)
    loop = asyncio.get_running_loop()
    got = []
    async with websockets.connect(url, max_size=None) as ws:
        async def receive():
            while True:
                msg = await asyncio.wait_for(ws.recv(), timeout=600)
                got.append((loop.time(), msg))
                if msg == "__REQUEST_COMPLETED__":
                    return
        rx = asyncio.create_task(receive())
        t0 = loop.time()
        sends = []
        for k, i in enumerate(range(0, len(pcm), step)):
            if paced:
                await asyncio.sleep(max(0.0, t0 + k * SERVER_PACKET_S
                                        - loop.time()))
            await ws.send(np.ascontiguousarray(pcm[i:i + step]).tobytes())
            sends.append((loop.time(), min(i + step, len(pcm))))
        t_eos = loop.time()
        await ws.send(json.dumps({"__COMMAND__": "__EOS__"}))
        await rx
    return got, sends, t_eos


def _wire_texts(got):
    """(finals, partials) transcripts of one connection's messages."""
    if not got or got[-1][1] != "__REQUEST_COMPLETED__":
        fail(f"a connection got no __REQUEST_COMPLETED__: {got[-3:]}")
    finals, partials = [], []
    for _, m in got[:-1]:
        r = json.loads(m)["result"]
        text = r["hypotheses"][0]["transcript"].strip()
        (finals if r["final"] else partials).append(text)
    return finals, partials


def _serve_clients(port, pcms, paced, rate=16000):
    import asyncio
    url = (f"ws://127.0.0.1:{port}/voice/api/asr/v1/ws/decode_online?"
           f"content-type=audio/x-raw,+layout=(string)interleaved,"
           f"+rate=(int){rate}")

    async def run():
        return await asyncio.gather(*(_ws_stream(url, p, paced, rate)
                                      for p in pcms))
    return asyncio.run(run())


def _pcm16(audio):
    import numpy as np
    return (np.clip(audio, -1, 1) * 32767).astype(np.int16)


def _need_launched(label, launches, names):
    """Fail unless every kernel in ``names`` was launched on this path."""
    missing = [k for k in names if not launches.get(k)]
    if missing:
        fail(f"{label}: no launch of {missing} on this path "
             f"(launches {launches})")


def server_golden_vi(device, want):
    """(a) VI: the overfit fixture behind a StreamingServer over
    GroupedScheduler(groups=2) and the device worker at 512 slots; three
    connections stream phase_golden's audio over a loopback socket.  The
    finals over the wire are phase_golden's.  Returns the child's launch
    counts over the served streams."""
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    from asr_streaming_tpu_torch.server.ws_server import StreamingServer
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import GroupedScheduler
    path = os.path.join(HERE, "assets", "test_fixtures", "overfit_ctc.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    vocab = ["-", "|", "a", "b", "c", "d"]
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(vocab)),
                        use_silero=False, use_energy_gate=False,
                        energy_threshold_db=-200.0)
    sched = GroupedScheduler(
        None, cfg, vocab, max_slots=B_SLOTS, groups=2,
        rules={"trained": EndpointRule(True, 0.8, 0.0, float("inf"))},
        device_worker={"seed": 1, "checkpoint": path, "device": str(device)})
    st = ServerThread(StreamingServer(sched, tick_idle_sleep=0.002))
    try:
        sched.client.stats(reset=True)
        one = _sentence_audio(golden, 3.84)
        audio = [one, np.concatenate([np.zeros(10240, np.float32), one]),
                 np.concatenate([one, one])]
        t0 = time.perf_counter()
        results = _serve_clients(st.port, [_pcm16(a) for a in audio],
                                 paced=False)
        dt = time.perf_counter() - t0
        launches = sched.client.stats()["launches"]
    finally:
        st.close()
    got = [_wire_texts(got)[0] for got, _, _ in results]
    expect = [[t for k, t in want[f"t{i}"] if k == "final" and t]
              for i in range(len(audio))]
    if got != expect:
        fail(f"server VI finals over the wire {got} != phase_golden's "
             f"{expect}")
    if golden not in got[0]:
        fail(f"server VI: golden {golden!r} not among {got}")
    _need_launched("server VI (a)", launches,
                   ("emformer_stack", "emission_append"))
    log(f"[server] (a) VI overfit_ctc over a loopback socket, "
        f"GroupedScheduler(groups=2) over the device worker at {B_SLOTS} "
        f"slots: 3 connections completed in {dt:.2f} s, finals {got} = "
        f"phase_golden's; child launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches


def server_golden_en(device, want):
    """(a) EN: overfit_rnnt in beam-partials mode (width 4, the trained
    VAD), as phase_en_golden's beam mode, behind the server over the
    grouped worker; finals "a b" / "a b", "a b" as in process."""
    import dataclasses
    import tempfile
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    from asr_streaming_tpu_torch.server.ws_server import StreamingServer
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import GroupedScheduler
    from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, save_params,
    )
    fixtures = os.path.join(HERE, "assets", "test_fixtures")
    path = os.path.join(fixtures, "overfit_rnnt.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["beam_golden"]
    cfg = ServingConfig(
        asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
        model_kind="rnnt", rnnt=RNNTConfig.tiny(vocab_size=len(EN_PIECES)),
        use_silero=True, use_energy_gate=False, energy_threshold_db=-200.0)
    with tempfile.TemporaryDirectory() as tmp:
        vad_path = os.path.join(tmp, "vad.npz")
        save_params(vad_path, {"vad": load_params(
            os.path.join(fixtures, "overfit_rnnt_vad.npz"))})
        sched = GroupedScheduler(
            None, cfg, EN_PIECES, max_slots=B_SLOTS, groups=2, language="en",
            rules={"trained": EndpointRule(True, 0.8, 0.0, float("inf"))},
            en_beam_partials=True, en_beam_width=4,
            device_worker={"seed": 1, "checkpoint": path,
                           "vad_weights": vad_path, "device": str(device)})
        st = ServerThread(StreamingServer(sched, tick_idle_sleep=0.002))
        try:
            sched.client.stats(reset=True)
            one = _en_sentence_audio(golden)
            t0 = time.perf_counter()
            results = _serve_clients(
                st.port, [_pcm16(one), _pcm16(np.concatenate([one, one]))],
                paced=False)
            dt = time.perf_counter() - t0
            launches = sched.client.stats()["launches"]
        finally:
            st.close()
    got = [_wire_texts(got)[0] for got, _, _ in results]
    expect = [[t for k, t in want[f"t{i}"] if k == "final" and t]
              for i in range(2)]
    if got != expect or got != [[golden], [golden, golden]]:
        fail(f"server EN finals over the wire {got} != in process {expect} "
             f"(golden {golden!r})")
    _need_launched("server EN (a)", launches,
                   ("emformer_stack", "emission_append", "row_topk"))
    log(f"[server] (a) EN overfit_rnnt, beam partials, over a loopback "
        f"socket at {B_SLOTS} slots: 2 connections completed in {dt:.2f} s, "
        f"finals {got}; child launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid: int) -> list:
    """Pids whose parent is ``pid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, IndexError, ValueError):
                pass
    return out


def _alive(pids) -> dict:
    """{pid: command line} of the pids still running (zombies, which an
    init that does not reap may keep, count as gone)."""
    out = {}
    for p in pids:
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    continue
            with open(f"/proc/{p}/cmdline", "rb") as f:
                out[p] = f.read().replace(b"\0", b" ").decode()[:200]
        except (OSError, IndexError):
            pass
    return out


def _speechlike(seconds, seed, sr=16000):
    """Tones with vibrato plus noise, well above the energy gate."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 150 + 100 * rng.random()
    audio = sum(0.08 * np.sin(2 * np.pi * f0 * h * t
                              + 3 * np.sin(2 * np.pi * 4 * t))
                for h in (1, 2, 3))
    audio = audio + 0.03 * rng.standard_normal(t.size)
    return audio.astype(np.float32)


def _latencies(results, seg_samples):
    """Per connection: chunk-to-partial seconds, EOS-to-completed seconds
    and the (partials, segments) counts.  Partials come in chunk order,
    at most one per chunk, but a chunk whose text did not change sends
    none, so each partial is timed from the newest segment completed when
    it arrived (exact while the server keeps up)."""
    lat, eos, counts = [], [], []
    for got, sends, t_eos in results:
        done = [t for t, m in got if m == "__REQUEST_COMPLETED__"][0]
        eos.append(done - t_eos)
        seg_times = []
        for t, n in sends:
            while (len(seg_times) + 1) * seg_samples <= n:
                seg_times.append(t)
        partials = [t for t, m in got if m != "__REQUEST_COMPLETED__"
                    and not json.loads(m)["result"]["final"] and t <= t_eos]
        counts.append((len(partials), len(seg_times)))
        for r in partials:
            newest = sum(1 for t in seg_times if t <= r) - 1
            if newest >= 0:
                lat.append(r - seg_times[newest])
    return lat, eos, counts


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def _port_client(port, label):
    """The port's own client (client/asr_client.py::stream_audio) on a
    running server: one connection of 4 s at full speed under a request
    id, which must complete with partials, every final under that id."""
    import asyncio
    from asr_streaming_tpu_torch.client.asr_client import (
        DEFAULT_PATH, stream_audio,
    )
    pcm = _pcm16(_speechlike(4.0, seed=99)).tobytes()
    result = asyncio.run(stream_audio(
        f"ws://127.0.0.1:{port}" + DEFAULT_PATH, pcm, realtime=False,
        request_id="chip-smoke-client", recv_timeout=120.0))
    ids = {m["id"] for m in result.finals}
    if not (result.completed and result.partials
            and ids <= {"chip-smoke-client"}):
        fail(f"{label}: the port's client: completed {result.completed}, "
             f"{len(result.partials)} partials, ids {ids}")
    return {"port_client_partials": len(result.partials),
            "port_client_finals": len(result.finals),
            "port_client_first_partial_ms":
                result.first_partial_latency * 1e3,
            "port_client_total_s": result.total_seconds}


def server_entry_point(config, n_conn, card, label, seconds=6.0,
                       inspect=None, port_client=False):
    """(b) ``python -m asr_streaming_tpu_torch.server --config <config>``
    at full width (512 slots, device worker, groups 2, the bf16 stack
    route, mu-law upload) as a subprocess; ``n_conn`` connections stream
    ``seconds`` of audio each at real-time pace.  ``inspect(results,
    lines)``, when given, runs once the clients are done, while the server
    is up; the dict it returns joins the numbers.  With ``port_client``
    the port's own client then streams once (``_port_client``).  Returns
    the server's kernel launch counts (from its shutdown log line) and the
    numbers."""
    import signal
    import tempfile
    import threading
    import urllib.request
    from asr_streaming_tpu_torch.server.config import ServerSettings
    settings = ServerSettings.load(config, env={})
    seg_samples = settings.audio.segment_length
    port = _free_port()
    lines = []
    with tempfile.TemporaryDirectory() as logdir:
        env = {k: v for k, v in os.environ.items()
               if k not in ("PORT", "LANGUAGE", "NORM_PORT")}
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "asr_streaming_tpu_torch.server",
             "--config", config, "--port", str(port),
             "--allow-random-weights", "--log-dir", logdir],
            cwd=HERE, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        serving = threading.Event()

        def read():
            for line in proc.stderr:
                lines.append(line.rstrip("\n"))
                if "serving on port" in line:
                    serving.set()
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            while not serving.wait(0.5):
                if proc.poll() is not None or time.perf_counter() - t0 > 600:
                    fail(f"{label}: the server did not come up:\n"
                         + "\n".join(lines[-40:]))
            startup = time.perf_counter() - t0
            base = f"http://127.0.0.1:{port}/metrics.json"
            with urllib.request.urlopen(base, timeout=30) as r:
                before = json.loads(r.read())
            pcms = [_pcm16(_speechlike(seconds, seed=i))
                    for i in range(n_conn)]
            results = _serve_clients(port, pcms, paced=True)
            inspected = inspect(results, lines) if inspect else {}
            if port_client:
                inspected.update(_port_client(port, label))
            with urllib.request.urlopen(base, timeout=30) as r:
                after = json.loads(r.read())
            children = _children(proc.pid)
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                fail(f"{label}: the server did not exit within 60 s of SIGINT")
            reader.join(timeout=10)
    for got, _, _ in results:
        _wire_texts(got)                 # every connection completed
    if rc != 0:
        fail(f"{label}: the server exited {rc}:\n" + "\n".join(lines[-40:]))
    failed = [ln for ln in lines if "tick failed" in ln]
    if failed:
        fail(f"{label}: the server logged failed ticks: {failed[:3]}")
    if after.get("ticks", 0) <= 0 or after.get("max_slots") != B_SLOTS:
        fail(f"{label}: /metrics.json after the run: {after}")
    deadline = time.perf_counter() + 15
    while _alive(children) and time.perf_counter() < deadline:
        time.sleep(0.2)
    if _alive(children):
        fail(f"{label}: the server left processes behind: {_alive(children)}")
    launch_lines = [ln for ln in lines if "kernel launches:" in ln]
    if not launch_lines:
        fail(f"{label}: no kernel launch line in the server's log")
    launches = json.loads(launch_lines[-1].split("kernel launches:", 1)[1])
    lat, eos, counts = _latencies(results, seg_samples)
    if not lat:
        fail(f"{label}: no partial arrived before EOS ({counts})")
    numbers = {
        "connections": n_conn, "audio_s": seconds,
        "segment_s": seg_samples / 16000, "startup_s": startup,
        "chunk_to_partial_p50_ms": _pct(lat, 50),
        "chunk_to_partial_p95_ms": _pct(lat, 95),
        "eos_to_completed_p50_ms": _pct(eos, 50),
        "eos_to_completed_max_ms": max(eos) * 1e3,
        "partials_vs_segments": [list(c) for c in counts],
        "ticks": after["ticks"], "ticks_before_clients": before.get("ticks"),
        "tick_p50_ms": after.get("stages", {}).get("tick", {}).get("p50_ms"),
        **inspected,
    }
    log(f"[server] (b) {label} | {card} | {json.dumps(numbers)}")
    log(f"[server] (b) {label}: exit {rc} after SIGINT, no failed tick, "
        f"its {len(children)} child processes gone; server-side launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches, numbers


def _en_sharpened_config(tmp):
    """server-en.yaml with a checkpoint of the seed-0 joiner scaled by
    EN_JOINER_GAIN (the rest of the weights stay the worker's seed-0
    draw), so the random beam holds tokens and partials flow."""
    import torch
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.server.__main__ import build_config
    from asr_streaming_tpu_torch.server.config import ServerSettings
    from asr_streaming_tpu_torch.utils.checkpoint import save_params
    src = os.path.join(HERE, "configs", "server-en.yaml")
    cfg = build_config(ServerSettings.load(src, env={}))
    params = init_serving_params(0, cfg, torch.device("cpu"))
    ckpt = os.path.join(tmp, "en_joiner.npz")
    save_params(ckpt, {"joiner": {"w": params["joiner"]["w"]
                                  * EN_JOINER_GAIN}})
    with open(src) as f:
        text = f.read()
    if "\ncheckpoint: null" not in text:
        fail("configs/server-en.yaml has no 'checkpoint: null' line")
    path = os.path.join(tmp, "server-en.yaml")
    with open(path, "w") as f:
        f.write(text.replace("\ncheckpoint: null", f"\ncheckpoint: {ckpt}"))
    return path


# torch Linear names of the reference encoder's Emformer layer
# (tools/convert_checkpoint.py), by the port's parameter
_CKPT_LAYER = {
    "w_kv": "attention.emb_to_key_value.weight",
    "b_kv": "attention.emb_to_key_value.bias",
    "w_q": "attention.emb_to_query.weight",
    "b_q": "attention.emb_to_query.bias",
    "w_out": "attention.out_proj.weight", "b_out": "attention.out_proj.bias",
    "ln_in_scale": "layer_norm_input.weight",
    "ln_in_bias": "layer_norm_input.bias",
    "ff_ln_scale": "pos_ff.0.weight", "ff_ln_bias": "pos_ff.0.bias",
    "ff_w1": "pos_ff.1.weight", "ff_b1": "pos_ff.1.bias",
    "ff_w2": "pos_ff.4.weight", "ff_b2": "pos_ff.4.bias",
    "ln_out_scale": "layer_norm_output.weight",
    "ln_out_bias": "layer_norm_output.bias",
}


def _vi_speaker_config(tmp):
    """server-vi.yaml with speaker verification and a reference checkpoint:
    ``speaker_wav`` a wav written here (random ECAPA weights, as the CLI
    warns); ``checkpoint`` a reference Lightning ``.ckpt`` holding the
    seed-0 encoder, its CTC bias raised on '|' and the first subword so
    the random model emits words; a one-word lexicon and unigram LM, so
    the native beam gives every final a word window for the verifier."""
    import wave
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.server.__main__ import build_config
    from asr_streaming_tpu_torch.server.config import ServerSettings
    src = os.path.join(HERE, "configs", "server-vi.yaml")
    cfg = build_config(ServerSettings.load(src, env={}))
    enc = init_serving_params(0, cfg, torch.device("cpu"))["encoder"]

    def lin(t):                     # [in, out] -> a torch Linear's [out, in]
        return t.float().T.contiguous()

    em = enc["emformer"]
    enc_sd = {"input_linear.weight": lin(enc["input_linear"]["w"])}
    for i in range(em["w_q"].shape[0]):
        for k, name in _CKPT_LAYER.items():
            t = em[k][i]
            enc_sd[f"encoder_layers.emformer_layers.{i}.{name}"] = \
                lin(t) if t.dim() == 2 else t.float().clone()
    ctc = enc["ctc"]
    b2 = ctc["b2"].float().clone()
    b2[1:3] += 8.0                  # '|' and 't0' lead every frame
    dec_sd = {"linear1.weight": lin(ctc["w1"]),
              "linear1.bias": ctc["b1"].float().clone(),
              "linear2.weight": lin(ctc["w2"]), "linear2.bias": b2}
    ckpt = os.path.join(tmp, "asr-online.ckpt")
    torch.save({"state_dict": {"encoder": enc_sd, "decoder": dec_sd}}, ckpt)
    wav = os.path.join(tmp, "enrolled.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(_pcm16(_speechlike(3.0, seed=77)).tobytes())
    lex = os.path.join(tmp, "lexicon.txt")
    with open(lex, "w") as f:
        f.write("t0\tt0 |\n")
    arpa = os.path.join(tmp, "lm.arpa")
    with open(arpa, "w") as f:
        f.write("\\data\\\nngram 1=3\n\n\\1-grams:\n-0.5\tt0\t0.0\n"
                "-0.5\t</s>\n-99\t<s>\t0.0\n\n\\end\\\n")
    with open(src) as f:
        text = f.read()
    for key, value in (("checkpoint", ckpt), ("lm_path", arpa),
                       ("speaker_wav", wav)):
        if f"\n{key}: null" not in text:
            fail(f"configs/server-vi.yaml has no '{key}: null' line")
        text = text.replace(f"\n{key}: null", f"\n{key}: {value}")
    path = os.path.join(tmp, "server-vi-speaker.yaml")
    with open(path, "w") as f:
        f.write(text.rstrip("\n") + f"\nlexicon_path: {lex}\n")
    return path


def _card_used_mib():
    """The card's used memory in MiB (nvidia-smi), all processes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    return float(out) if out else None


def server_speaker(card):
    """(b) The VI CLI with ``speaker_wav`` and a ``.ckpt`` checkpoint
    (converted at load in the worker child): every final carries a
    boolean is_speaker, the verifier ran on finals (they carry word
    windows), and the CLI logs the verifier on cuda, with what its CUDA
    context in the parent costs (the build seconds and torch's reserved
    MiB of the log line; phase_ecapa measures the whole context)."""
    import re
    import tempfile

    def inspect(results, lines):
        finals = [json.loads(m) for got, _, _ in results for _, m in got
                  if m != "__REQUEST_COMPLETED__"
                  and json.loads(m)["result"]["final"]]
        if not finals:
            fail("server-vi.yaml + speaker_wav: no final arrived")
        bad = [f for f in finals if not isinstance(f.get("is_speaker"), bool)]
        if bad:
            fail(f"finals without a boolean is_speaker: {bad[:2]}")
        windows = [f for f in finals if f.get("word_start") is not None]
        if not windows:
            fail("no final carried a word window: the verifier never ran "
                 f"({finals[:2]})")
        built = [ln for ln in lines if "speaker verifier on" in ln]
        if not built or "speaker verifier on cuda" not in built[0]:
            fail(f"the CLI did not log the verifier on cuda: {built}")
        m = re.search(r"built in ([0-9.]+) s, ([0-9.]+) MiB", built[0])
        if not any("loaded checkpoint" in ln or ".ckpt" in ln
                   for ln in lines):
            fail("the CLI's log does not name the .ckpt checkpoint")
        return {"finals": len(finals), "finals_with_window": len(windows),
                "is_speaker_true": sum(f["is_speaker"] for f in windows),
                "verifier_build_s": float(m.group(1)) if m else None,
                "verifier_torch_mib": float(m.group(2)) if m else None}

    with tempfile.TemporaryDirectory() as tmp:
        return server_entry_point(_vi_speaker_config(tmp), 4, card,
                                  "server-vi.yaml + speaker_wav + .ckpt",
                                  seconds=4.0, inspect=inspect)


def server_native_rescorer():
    """(c) The VI finals' beam decoder on this machine is the C++ one."""
    import tempfile
    import types
    import numpy as np
    from asr_streaming_tpu_torch.decode.beam_native import (
        library_path, make_native_rescorer,
    )
    vocab = ["-", "|", "a", "b", "c"]
    with tempfile.TemporaryDirectory() as tmp:
        lex = os.path.join(tmp, "lexicon.txt")
        with open(lex, "w") as f:
            f.write("ab\ta b |\nba\tb a |\nabc\ta b c |\na\ta |")
        arpa = os.path.join(tmp, "lm.arpa")
        with open(arpa, "w") as f:
            f.write("\\data\\\nngram 1=6\nngram 2=2\n\n\\1-grams:\n"
                    "-0.3\tab\t-0.2\n-0.9\tba\t-0.1\n-1.2\tabc\t0.0\n"
                    "-0.8\ta\t-0.3\n-0.5\t</s>\n-99\t<s>\t-0.4\n\n"
                    "\\2-grams:\n-0.1\tab ba\n-0.2\t<s> ab\n\n\\end\\\n")
        rescore = make_native_rescorer(vocab, lex, arpa, lm_weight=1.5)
        if rescore is None:
            fail("make_native_rescorer returned None: no native beam")
        em = np.full((6, 5), -12.0, np.float32)
        em[np.arange(6), [2, 3, 1, 3, 2, 1]] = 0.0
        words = [a["word"] for a in rescore(types.SimpleNamespace(
            emission=em, length=6, offset=0))]
    if words != ["ab", "ba"]:
        fail(f"native rescorer words {words} != ['ab', 'ba']")
    log(f"[server] (c) VI finals rescore with the native C++ beam "
        f"({os.path.relpath(library_path(), HERE)}): {words}")


def phase_server(device, card, vi_want, en_want, counted):
    """The websocket server: (a) exact transcripts over a real socket in
    process, (b) full width through the normal entry point, (c) the native
    rescorer.  ``counted(fn, *args)`` runs a path with the counts zeroed
    before and read after; the worker's and the subprocess's counts are
    returned and added by the caller."""
    import tempfile
    import torch
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    add(counted(server_golden_vi, device, vi_want))
    add(counted(server_golden_en, device, en_want))
    torch.cuda.empty_cache()
    vi_launches, vi_numbers = server_entry_point(
        os.path.join(HERE, "configs", "server-vi.yaml"), 16, card,
        "server-vi.yaml", port_client=True)
    _need_launched("server-vi.yaml (b)", vi_launches,
                   ("emformer_stack", "emission_append"))
    add(vi_launches)
    with tempfile.TemporaryDirectory() as tmp:
        en_launches, en_numbers = server_entry_point(
            _en_sharpened_config(tmp), 8, card, "server-en.yaml")
    _need_launched("server-en.yaml (b)", en_launches,
                   ("emformer_stack", "emission_append", "row_topk"))
    add(en_launches)
    sp_launches, sp_numbers = server_speaker(card)
    _need_launched("server-vi.yaml + speaker_wav (b)", sp_launches,
                   ("emformer_stack", "emission_append"))
    add(sp_launches)
    server_native_rescorer()
    return totals, {"vi": vi_numbers, "en": en_numbers,
                    "vi_speaker": sp_numbers}


# ------------------------------------------------ the bench and ECAPA

def phase_bench(device, card):
    """8. The port's bench (asr_streaming_tpu_torch/bench.py) at full width
    on the stack route, Silero on with the trained VAD fixture, the native
    gather-encode: one phase-A window, one phase-B window and phase C (the
    full run is ``python -m asr_streaming_tpu_torch.bench``).  Fails
    unless the gather ran natively, streams > 0 and A and B launched."""
    import math
    import torch
    from asr_streaming_tpu_torch.bench import run_bench
    from asr_streaming_tpu_torch.ops import _cuda
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = run_bench(device, route="stack", slots=B_SLOTS, groups=2, depth=1,
                    passes_a=1, passes_b=1, seconds_a=2.0, seconds_b=3.84)
    ex = out["extra"]
    launches = _cuda.launch_counts()
    _need_launched("bench", launches, ("emformer_stack", "emission_append"))
    if ex["gather_encoder"] != "native":
        fail(f"bench: the gather ran {ex['gather_encoder']!r}, not native")
    if not out["value"] > 0:
        fail(f"bench: {out['value']} streams")
    if not (ex["use_silero"] and ex["route"] == "stack"
            and ex["weights_mode"].startswith("trained")):
        fail(f"bench: not the configured path: {ex}")
    nums = [ex[k] for k in ("paced_p50_ms", "paced_p95_ms", "device_exec_ms",
                            "pcie_tick_ms", "full_service_round_ms")]
    if not all(math.isfinite(x) and x > 0 for x in nums):
        fail(f"bench: a latency or time is not positive and finite: {nums}")
    log(f"[bench] {card} | {json.dumps(out)}")
    log(f"[bench] {time.perf_counter() - t0:.1f} s; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return out


def phase_ecapa(device, card, seed):
    """9. ECAPA-TDNN at full width (EcapaConfig(): 512 channels, 80 mels,
    192-dim embeddings) with seeded random weights: the verifier's
    embedding on the card against the same on the CPU (the plain
    version) at every bucket and past 16 s, atol 1e-4 on the unit-norm
    embedding; ms per bucket (device time of log-mel + ECAPA, and the
    verifier's call on the host clock, copies included)."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.ecapa import (
        EcapaConfig, SpeakerVerifier, ecapa_embed, init_ecapa_params,
    )
    from asr_streaming_tpu_torch.ops.frontend import log_mel
    cfg = EcapaConfig()
    params = init_ecapa_params(seed, cfg, "cpu")
    enrol = _speechlike(3.0, seed=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_v = SpeakerVerifier(params, cfg, enrol, device=device)
    build_s = time.perf_counter() - t0
    cpu_v = SpeakerVerifier(params, cfg, enrol, device="cpu")
    rows = []
    for i, b in enumerate(SpeakerVerifier.BUCKETS + (20.0,)):
        wave = _speechlike(b * 0.9, seed=60 + i)
        got, want = card_v.embed(wave), cpu_v.embed(wave)
        err = float(np.abs(got - want).max())
        if not err <= 1e-4:
            fail(f"ECAPA at {b} s: card vs CPU max |diff| {err:.3g} > 1e-4")
        score_err = abs(card_v.score(wave) - cpu_v.score(wave))
        x = torch.from_numpy(card_v._bucket(wave))[None].to(device)

        def run():
            with torch.no_grad():
                ecapa_embed(card_v.params, cfg,
                            log_mel(card_v.mel_params, card_v.mel_cfg, x))
        ms = cuda_ms(run, iters=5)
        t1 = time.perf_counter()
        verdict = card_v(wave)
        call_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        cpu_v.embed(wave)
        plain_ms = (time.perf_counter() - t1) * 1e3
        rows.append({"seconds": b, "bucket_s": len(card_v._bucket(wave))
                     / 16000, "max_abs_err": err, "score_err": score_err,
                     "device_ms": ms, "call_ms": call_ms,
                     "cpu_plain_ms": plain_ms, "is_speaker": verdict})
    log(f"[ecapa] {card} | EcapaConfig() seed {seed}: verifier built on "
        f"the card in {build_s:.2f} s (weights, mel, one embedding per "
        f"bucket) | {json.dumps(rows)}")
    log(f"[ecapa] {card} | the server's verifier in a process of its own "
        f"(what speaker_wav adds to the server's parent): "
        f"{json.dumps(_verifier_context_cost(enrol))}")
    return rows


_VERIFIER_PROCESS = r"""
import dataclasses, json, sys, time
import torch
from asr_streaming_tpu_torch.server.__main__ import build_speaker_verifier
from asr_streaming_tpu_torch.server.config import ServerSettings
settings = dataclasses.replace(
    ServerSettings.load(sys.argv[1], env={}), speaker_wav=sys.argv[2])
t0 = time.perf_counter()
verifier = build_speaker_verifier(settings, torch.device("cuda", 0))
torch.cuda.synchronize()
print(json.dumps({"build_s": time.perf_counter() - t0,
                  "torch_reserved_mib":
                  torch.cuda.memory_reserved(0) / 2 ** 20}), flush=True)
sys.stdin.readline()
"""


def _card_used_mib():
    """The card's used memory in MiB (nvidia-smi), all processes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    return float(out.splitlines()[0])


def _verifier_context_cost(enrol):
    """build_speaker_verifier (server/__main__.py) on the card in a fresh
    process, as the server's parent runs it with speaker_wav: the seconds
    it takes (CUDA context, weights, one embedding per bucket) and the
    card memory it holds, read by nvidia-smi before it starts and while
    it holds the verifier (this process idle meanwhile)."""
    import tempfile
    import wave
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "enrolled.wav")
        with wave.open(wav, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(_pcm16(enrol).tobytes())
        before = _card_used_mib()
        proc = subprocess.Popen(
            [sys.executable, "-c", _VERIFIER_PROCESS,
             os.path.join(HERE, "configs", "server-vi.yaml"), wav],
            cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        try:
            line = proc.stdout.readline()
            if not line:
                fail("the verifier process ended without a result")
            out = json.loads(line)
            out["card_mib"] = _card_used_mib() - before
        finally:
            proc.stdin.close()
            proc.wait(timeout=60)
    return out


# ------------------------------------- multi-GPU serving and the offline API

MESH_SPLITS = (1, 2, 4)
SPLIT_REL_L2 = 3e-2            # A's relative L2 bound (bf16 at 20 layers)


def _churn_inputs(cfg, B, n_ticks, gen):
    """n_ticks of pinned host inputs (segment, contain, active,
    new_stream, reset): every slot fresh on the first tick, then random
    holds (15%), resets with new streams (10%) and contain flags."""
    import torch
    seg_len = cfg.asr.audio.segment_length
    out = []
    for t in range(n_ticks):
        seg = torch.randint(0, 256, (B, seg_len), generator=gen,
                            dtype=torch.uint8)
        contain = torch.rand(B, generator=gen) < 0.5
        active = torch.rand(B, generator=gen) >= (0.15 if t else 0.0)
        reset = torch.rand(B, generator=gen) < (0.1 if t else 2.0)
        out.append([x.pin_memory() if torch.cuda.is_available() else x
                    for x in (seg, contain, active, reset.clone(), reset)])
    return out


def run_split(params, cfg, ticks, device, mesh):
    """Chained serving ticks over ``ticks`` (``_churn_inputs``) at
    len(rows) slots, unsplit on ``device`` (mesh None) or split over
    ``mesh``'s shards.  Returns (packs per tick, final
    state, ctx, emission, host seconds per tick, the CTC head's f32
    log-probs per tick or None for RNNT), the split ones joined in slot
    order.  The log-probs are read by wrapping models/encoder.py's
    ``ctc_head`` for the run, here only."""
    import torch
    from asr_streaming_tpu_torch.models import encoder as enc_mod
    from asr_streaming_tpu_torch.models.serving import (
        init_audio_context, init_emission_buffer, init_serving_state,
        make_serving_step,
    )
    from asr_streaming_tpu_torch.parallel import serving as ps
    B = ticks[0][0].shape[0]
    arrays = (init_serving_state(cfg, B, device),
              init_audio_context(cfg, B, device),
              init_emission_buffer(cfg, B, device))
    if mesh is None:
        step, p = make_serving_step(cfg), params
        state, ctx, em = arrays
    else:
        step = ps.make_sharded_stepper(cfg, mesh, params)
        p = step.params
        state, ctx, em = ps.shard_serving_arrays(cfg, mesh, *arrays)
        del arrays
    heads, head = [], enc_mod.ctc_head

    def recording_head(*args, **kw):
        out = head(*args, **kw)
        heads.append(out.clone())
        return out

    packs, times, logps = [], [], []
    enc_mod.ctc_head = recording_head
    try:
        cards = set(mesh.devices) if mesh is not None else {device}
        for tick in ticks:
            for d in cards:
                _sync(d)
            t0 = time.perf_counter()
            if mesh is None:
                host = [x.to(device, non_blocking=True) for x in tick]
            else:
                host = [ps.split_rows(x, mesh) for x in tick]
            out = step(p, cfg, *host, state, ctx, em)
            for d in cards:
                _sync(d)
            times.append(time.perf_counter() - t0)
            state, ctx, em = out.state, out.ctx, out.emission
            packs.append(out.pack.clone() if mesh is None
                         else ps.join_shards(out.pack, 0, device))
            logps.append(torch.cat([h.to(device) for h in heads])
                         if heads else None)
            heads.clear()
    finally:
        enc_mod.ctc_head = head
    if mesh is not None:
        axes = ps.serving_state_slot_axes(cfg)
        state = ps.join_shards(state, axes, device)
        ctx, em = ps.join_shards(ctx, 0, device), ps.join_shards(em, 0,
                                                                 device)
    return packs, state, ctx, em, times, logps


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple):
        return [x for name, part in zip(tree._fields, tree)
                for x in _leaves(part, prefix + name + ".")]
    return [(prefix.rstrip("."), tree)]


def _near_ties(label, t, want_lp, got_lp, wa, ga):
    """Every CTC argmax that differs between two runs is a near-tie
    their log-probs explain: in the unsplit run the split's pick trails
    the best by at most twice the frame's largest log-prob difference
    between the runs (a flip needs each run's noise to close half the
    gap).  Fails otherwise; returns the number of flips."""
    import torch
    flips = (wa != ga).nonzero().tolist()
    for s, u in flips:
        w, g = want_lp[s, u], got_lp[s, u]
        gap = (w[int(wa[s, u])] - w[int(ga[s, u])]).item()
        noise = (w - g).abs().max().item()
        if not gap <= 2 * noise:
            fail(f"{label} tick {t}: slot {s} frame {u}: argmax "
                 f"{int(wa[s, u])} -> {int(ga[s, u])} with a log-prob gap "
                 f"{gap:.3e} > 2 x the runs' difference {noise:.3e}")
    return len(flips)


def compare_split(label, want, got):
    """The split run against the unsplit one.  Exact: the pack's flags,
    lead and trail, every integer state leaf, the RNNT token columns and
    the CTC argmax where the CTC head's log-probs are bit for bit; where
    they are not (cuBLAS may pick another algorithm for its products at
    another row count), each argmax that differs must be a near-tie that
    the two runs' log-probs explain (``_near_ties``).  Floats: bit for
    bit or within SPLIT_REL_L2.  Returns what held, as a phrase."""
    import torch
    from asr_streaming_tpu_torch.models.serving import PACK_DATA
    flips = 0
    for t, (w, g) in enumerate(zip(want[0], got[0])):
        if not torch.equal(w[:, :PACK_DATA], g[:, :PACK_DATA]):
            fail(f"{label} tick {t}: pack flags / lead / trail differ")
        if torch.equal(w[:, PACK_DATA:], g[:, PACK_DATA:]):
            continue
        bad = int((w[:, PACK_DATA:] != g[:, PACK_DATA:]).sum())
        if want[5][t] is None:
            fail(f"{label} tick {t}: {bad} token entries differ (the RNNT "
                 "tokens are held exact)")
        if torch.equal(want[5][t], got[5][t]):
            fail(f"{label} tick {t}: {bad} argmax entries differ with the "
                 "same log-probs behind them")
        flips += _near_ties(label, t, want[5][t], got[5][t],
                            w[:, PACK_DATA:], g[:, PACK_DATA:])
    worst, diffs = 0.0, []
    named = _leaves(want[1]) + [("ctx", want[2]), ("emission", want[3])]
    for (name, w), (_, g) in zip(named, _leaves(got[1]) + [
            ("ctx", got[2]), ("emission", got[3])]):
        if torch.equal(w, g):
            continue
        if not w.is_floating_point():
            fail(f"{label}: integer state {name} differs")
        rel = ((g.float() - w.float()).norm()
               / w.float().norm().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        diffs.append(name)
        if not rel <= SPLIT_REL_L2:
            fail(f"{label}: {name} relative L2 {rel:.3e} > {SPLIT_REL_L2}")
    if want[5][0] is not None and any(
            not torch.equal(a, b) for a, b in zip(want[5], got[5])):
        diffs.append("CTC log-probs")
    if not diffs:
        return "bit for bit"
    return (f"{', '.join(diffs)} within relative L2 {worst:.3e}, integers "
            f"exact" + (f" but {flips} argmax near-tie flip(s)" if flips
                        else ""))


def check_splits(label, params, cfg, ticks, device, card, need=()):
    """The unsplit ticks, then the same ticks split 1, 2 and 4 ways on
    one card and, on a host with two cards or more, over all of them
    (make_serving_mesh(0), every card launching): equal results, each
    split's tick time; ``need``: kernels every split run must launch."""
    import torch
    from asr_streaming_tpu_torch.ops import _cuda
    from asr_streaming_tpu_torch.parallel.mesh import make_mesh
    from asr_streaming_tpu_torch.parallel.serving import make_serving_mesh
    want = run_split(params, cfg, ticks, device, None)
    times = {"unsplit": _median_ms(want[4])}
    verdicts = {}
    meshes = [(str(n), make_mesh(devices=[device] * n)) for n in MESH_SPLITS]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshes.append((f"{n_cards} cards", make_serving_mesh(0)))
    for name, mesh in meshes:
        before = _cuda.launch_counts()
        on_card = dict(_cuda.DEVICE_LAUNCHES)
        got = run_split(params, cfg, ticks, device, mesh)
        ran = {k: v - before[k] for k, v in _cuda.launch_counts().items()}
        _need_launched(f"{label} split {name}", ran, need)
        idle = sorted({d.index for d in mesh.devices if d.type == "cuda"
                       and _cuda.DEVICE_LAUNCHES.get(d.index, 0)
                       <= on_card.get(d.index, 0)})
        if idle:
            fail(f"{label} split {name}: cards {idle} launched nothing")
        verdicts[name] = compare_split(f"{label} split {name}", want, got)
        times[name] = _median_ms(got[4])
        del got
    log(f"[mesh] {label}: {len(ticks)} chained ticks x "
        f"{ticks[0][0].shape[0]} slots with churn, split n ways on one card "
        f"({card}; the split's cost, not scaling)"
        + (f" and over all {n_cards} cards" if n_cards >= 2 else "") + ": "
        + "; ".join(f"n={k} {v}" for k, v in verdicts.items())
        + "; tick median ms " + json.dumps(
            {k: round(v, 3) for k, v in times.items()}))
    return times


def _mesh_golden(device, want):
    """The overfit fixture through Scheduler(mesh=...) and
    GroupedScheduler(groups=2, mesh=...) on ``[device] * 2``: the events
    of phase_golden's in-process scheduler."""
    import numpy as np
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.serving import (
        ServingConfig, init_serving_params,
    )
    from asr_streaming_tpu_torch.parallel.mesh import make_mesh
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
    mesh = make_mesh(devices=[device] * 2)
    for label, sched in (
            ("Scheduler(mesh)", Scheduler(params, cfg, vocab,
                                          max_slots=B_SLOTS, rules=rules,
                                          mesh=mesh)),
            ("GroupedScheduler(groups=2, mesh)", GroupedScheduler(
                params, cfg, vocab, max_slots=B_SLOTS, groups=2,
                rules=rules, mesh=mesh))):
        got = _fixture_events(sched, golden)
        sched.close()
        if got != want:
            fail(f"{label}: events {got} != in process {want}")
    log(f"[mesh] overfit_ctc at {B_SLOTS} slots through Scheduler(mesh=...)"
        f" and GroupedScheduler(groups=2, mesh=...) on {[str(device)] * 2}: "
        f"the in-process events, golden {golden!r}")


def _dp_config(tmp):
    """server-vi.yaml with the step in process and data_parallel: 0."""
    src = os.path.join(HERE, "configs", "server-vi.yaml")
    with open(src) as f:
        text = f.read()
    for old, new in (("\ndevice_worker: true", "\ndevice_worker: false"),
                     ("\n# data_parallel: 0", "\ndata_parallel: 0")):
        if old not in text:
            fail(f"configs/server-vi.yaml has no {old.strip()!r} line")
        text = text.replace(old, new)
    path = os.path.join(tmp, "server-vi-dp.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_mesh(seed, device, card, vi_want):
    """Multi-GPU serving (parallel/): the serving mesh over every card;
    the VI, EN greedy and EN beam ticks split 1, 2 and 4 ways on one
    card (and, on two cards or more, over all of them) against the
    unsplit tick; the fixture through both schedulers with a mesh; the
    CLI with data_parallel: 0.  Returns the CLI's launches."""
    import tempfile
    import torch
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.parallel.serving import make_serving_mesh
    n_cards = torch.cuda.device_count()
    mesh = make_serving_mesh(0)
    if mesh.shape["data"] != n_cards:
        fail(f"make_serving_mesh(0): {mesh.shape} on {n_cards} cards")
    # the phase's own generator: its inputs do not depend on which other
    # phases ran before it
    gen = torch.Generator().manual_seed(seed + 8)
    cfg = vi_serving_cfg()
    params = init_serving_params(gen, cfg, device)
    ticks = _churn_inputs(cfg, B_SLOTS, 3, gen)
    times = {"vi": check_splits("VI stack", params, cfg, ticks, device,
                                card, need=("emformer_stack",
                                            "emission_append"))}
    del params
    for label, width in (("EN greedy", None), ("EN beam", 10)):
        cfg = en_serving_cfg(width)
        params = en_random_params(seed, cfg, device)
        need = ("emformer_stack", "emission_append") + (
            ("row_topk",) if width else ())
        times[label] = check_splits(label, params, cfg,
                                    _churn_inputs(cfg, B_SLOTS, 3, gen),
                                    device, card, need=need)
        del params
    torch.cuda.empty_cache()
    _mesh_golden(device, vi_want)
    with tempfile.TemporaryDirectory() as tmp:
        launches, numbers = server_entry_point(
            _dp_config(tmp), 1, card, "server-vi.yaml, device_worker: "
            "false, data_parallel: 0", seconds=3.0)
    _need_launched("the data_parallel: 0 CLI", launches,
                   ("emformer_stack", "emission_append"))
    log(f"[mesh] {card} | " + json.dumps({"tick_ms": times}))
    return launches


def f32_step_ms(last, label, gemm_name):
    """Device ms of one f32 step of kernel A on ``last`` (check_stack's
    last inputs); logs it with the step's launches."""
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    params, x, mem, lck, lcv, eff, reset, advance, kw = last
    ms, rows = device_times(lambda: es.emformer_stack(
        params, x, mem, lck, lcv, eff, reset, advance, **kw), 3,
        need=(gemm_name, "attention_kernel"))
    log(f"[kernels] {label}: {ms:.3f} ms device time in "
        f"{sum(r[1] for r in rows)} launches")
    return ms


def slot_bits_check(last, label):
    """Slot 0 of a B = 3 step of kernel A equals, bit for bit, a B = 1
    step fed that slot alone (the f32 split depends on N and K only)."""
    import torch
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    params, x, mem, lck, lcv, eff, reset, advance, kw = last
    three = es.emformer_stack(params, x, mem, lck, lcv, eff, reset, advance,
                              **kw)
    one = es.emformer_stack(params, x[:1], mem[:, :1], lck[:, :1],
                            lcv[:, :1], eff[:1], reset[:1], advance[:1], **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "mem", "lc_k", "lc_v"), three, one):
        slot = a[:1] if name == "y" else a[:, :1]
        if not torch.equal(slot, b):
            fail(f"{label}: slot 0 of the B=3 step differs from the B=1 "
                 f"step in {name} (max |diff| "
                 f"{(slot - b).abs().max().item():.3e})")
    log(f"[kernels] {label}: slot 0 of a B=3 step == the B=1 step of that "
        f"slot, bit for bit (y and the three states)")


def offline_kernel_checks(gen, device):
    """A at batch 1 and 3 in f32 (``ASRModel``'s shape) against its plain
    version at 1e-4 (f32: summation order only); slot 0 of the B=3 step
    bit for bit a B=1 step of that slot; A at batch 1 timed beside its
    plain version, its bound, its parts (the split-K GEMMs, the attention,
    the rest) and its 100 products on ``torch.matmul`` in f32.  Returns
    A's entry for the kernels line: {"b1_f32": {ms, launches, plain_ms,
    bound_ms, bound_by, max_abs_err, parts (the products' with their
    library_ms and bound_ms)}}."""
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    emf = ASRConfig.vietnamese().encoder.emformer
    errs, lasts = {}, {}
    for B in (1, 3):
        errs[B], lasts[B] = check_stack(emf, B, 3, 1e-4, gen, device,
                                        f"A f32 B={B} (offline)")
    slot_bits_check(lasts[3], "A f32 (offline)")
    params, x, mem, lck, lcv, eff, reset, advance, kw = lasts[1]
    args = (params, x, mem, lck, lcv, eff, reset, advance)
    need = ("gemm_f32_splitk", "attention_kernel")
    ms, rows = device_times(lambda: es.emformer_stack(*args, **kw), 3,
                            need=need)
    plain_ms = cuda_ms(lambda: es.emformer_stack_plain(*args, **kw), 3)
    L, D, Fd = emf.num_layers, emf.d_model, emf.ffn_dim
    U, R = emf.segment_length, emf.right_context_length
    M, Lc = emf.max_memory_size, emf.left_context_length
    parts = stack_parts(lambda: es.emformer_stack(*args, **kw),
                        "A f32, one B=1 step", (1, L, D, U, R, M, Lc),
                        need=need + ROW_KERNELS, itemsize=4, reset=reset,
                        advance=advance)
    row_check = check_rows("A f32 B=1", 1, D, U, R, M, Lc, torch.float32,
                           gen, device)
    parts["rows"].update(library=row_library_ms(1, L, D, U, R, M, Lc,
                                                torch.float32, device))
    parts["rows"]["library_ms"] = parts["rows"]["library"]["ms"]
    # the 100 products alone: their bound, and torch.matmul in f32
    shapes = gemm_shapes(1, U, R, M, D, Fd, None)
    g_bytes = 4.0 * L * sum(m * k + k * n + n + m * n
                            for _, m, k, n, _ in shapes)
    g_ops = 2.0 * L * sum(m * k * n for _, m, k, n, _ in shapes)
    parts["gemm"]["bound_ms"] = max(g_bytes / PEAK_BYTES,
                                    g_ops / PEAK_F32_FLOPS) * 1e3
    parts["gemm"]["library_ms"] = matmul_step(params, emf, 1, gen, device,
                                              "f32")
    t_ops = stack_flops(1, L, D, Fd, U, R, M, Lc) / PEAK_F32_FLOPS * 1e3
    t_bytes = emformer_bytes(emf, 1, L, 4) / PEAK_BYTES * 1e3
    entry = {"ms": ms, "launches": sum(r[1] for r in rows),
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "max_abs_err": max(errs.values()), "parts": parts,
             "rows": row_check}
    log(f"[kernels] A f32 at B=1 (the offline API's shape): {ms:.3f} ms "
        f"device in {entry['launches']} launches, plain {plain_ms:.3f} ms, "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); its 100 "
        f"products {parts['gemm']['ms']:.3f} ms against torch.matmul f32 "
        f"{parts['gemm']['library_ms']:.3f} ms and their bound "
        f"{parts['gemm']['bound_ms']:.4f} ms")
    return {"b1_f32": entry}


def phase_offline(seed, device, card):
    """The offline API and its tools on the card: ASRModel at full width
    (VI f32, kernel A at batch 1) against the CPU plain version and
    timed; the overfit fixture's golden text and word windows through
    ASRModel; the transcribe CLI's greedy line against ASRModel in
    process; profile_beam's table (kernel E); a torch_profile trace."""
    import tempfile
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.ops import _cuda
    from asr_streaming_tpu_torch.tools.profile_beam import main as beam_main
    from asr_streaming_tpu_torch.utils.audio import read_wav
    from asr_streaming_tpu_torch.utils.observability import torch_profile
    model = ASRModel(seed=seed, device=device)
    wave = _speechlike(10.0, seed=3)
    t0 = time.perf_counter()
    first = model.emissions(wave)
    first_s = time.perf_counter() - t0
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em = model.emissions(wave)
        runs.append(time.perf_counter() - t0)
    if not np.array_equal(em, first):
        fail("ASRModel.emissions differs between two calls on the card")
    cpu = ASRModel(seed=seed, device="cpu").emissions(wave)
    err = float(np.abs(em - cpu).max())
    if em.shape != cpu.shape or not err <= 1e-3:
        fail(f"ASRModel emissions card vs CPU: {em.shape} vs {cpu.shape}, "
             f"max |err| {err:.3e} > 1e-3")
    n_chunks = len(em) // model.cfg.encoder.emformer.segment_length
    steady = sorted(runs)[1]
    log(f"[offline] ASRModel (VI f32, 20 layers, kernel A at B=1) | {card}"
        f" | 10 s of audio, {n_chunks} chunks: {steady * 1e3:.2f} ms "
        f"(median of 3; first call {first_s:.2f} s), "
        f"{steady * 1e3 / n_chunks:.3f} ms a chunk, "
        f"{steady * 1e3 / 10.0:.3f} ms per second of audio; card vs CPU "
        f"max |err| {err:.3e} (check 1e-3)")
    profile_top(lambda: model.emissions(wave[:16000]),
                "ASRModel.emissions, 1 s of audio (3 chunks, B=1, f32)",
                n=8)

    path = os.path.join(HERE, "assets", "test_fixtures", "overfit_ctc.npz")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    tiny = ASRModel(cfg=ASRConfig.tiny(vocab_size=6), checkpoint=path,
                    vocab=["-", "|", "a", "b", "c", "d"],
                    lexicon={"ab": ["a", "b", "|"], "cd": ["c", "d", "|"]},
                    use_corpus=False, device=device)
    sentence = _sentence_audio(golden, 3.84)
    text = tiny.transcribe(sentence)
    if text != golden:
        fail(f"ASRModel on the fixture: {text!r} != golden {golden!r}")
    _, words = tiny.force_alignment(sentence, golden)
    bounds = [x for w in words for x in (w.start, w.end)]
    if [w.label for w in words] != golden.split() or \
            bounds != sorted(bounds) or bounds[0] < 0 or bounds[-1] > 3.84:
        fail(f"force_alignment word windows {[vars(w) for w in words]}")
    log(f"[offline] overfit_ctc through ASRModel on the card: {text!r}; "
        f"word windows " + ", ".join(f"{w.label} {w.start:.2f}-{w.end:.2f} s"
                                     for w in words))

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "speech.wav")
        import wave as wave_mod
        with wave_mod.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(_pcm16(_speechlike(3.0, seed=4)).tobytes())
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "asr_streaming_tpu_torch.tools.transcribe",
             wav], cwd=HERE, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            fail(f"transcribe CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
        want = "greedy: " + ASRModel(seed=0, device=device).transcribe(
            read_wav(wav)[0])
        lines = cli.stdout.splitlines()
        if lines != [want]:
            fail(f"transcribe CLI printed {lines[:3]}, in process {want!r}")
        log(f"[offline] python -m asr_streaming_tpu_torch.tools.transcribe "
            f"(3 s, seed-0 weights) in {cli_s:.1f} s prints the in-process "
            f"greedy line ({len(want) - 8} characters)")

        before = _cuda.launch_counts()["row_topk"]
        beam_main(["--reps", "5"])
        if _cuda.launch_counts()["row_topk"] <= before:
            fail("profile_beam launched no kernel E")

        with torch_profile(tmp) as prof:
            model.emissions(wave[:16000])
        trace = os.path.join(tmp, "trace.json")
        names = [e.key for e in prof.key_averages()]
        if not os.path.getsize(trace) or not any(
                "attention_kernel" in k for k in names):
            fail(f"torch_profile: trace {os.path.getsize(trace)} bytes, "
                 f"no kernel A among {names[:8]}")
        log(f"[offline] torch_profile wrote a {os.path.getsize(trace)}-byte "
            f"Chrome trace holding kernel A's kernels")


# ------------------------------------------------- the training stack

TRAIN_VOCAB = ["-", "|", "a", "b", "c", "d"]
TRAIN_SENTENCES = ["a", "b", "c", "d",
                   "ab cd", "dc ba", "ad bc", "ca db", "bd", "acd b"]
GOLDEN_CANDIDATES = ["ab cd", "dc ba", "ad bc", "acd b", "ca db"]
# leaves (by path suffix) whose gradient is 0 in exact arithmetic (both
# sides hold rounding noise): att_conv2's bias shifts a channel's
# attention logits alike over time, and the softmax over time removes it;
# the Squeezeformer's key and positional biases shift a query's scores
# alike; a conv bias right before a BatchNorm on the batch's statistics
# is removed by its mean
ZERO_GRADS = ("ecapa/att_conv2/b", "attn/bk", "attn/bp", "conv/dw_b",
              "subsampling/c1_b", "dur1/b", "dur2/b")


def _tree_pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _tree_pairs(a[k], b[k], f"{path}/{k}" if path else k)
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _tree_pairs(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def _grad_errors(got, want):
    """{leaf: relative L2 of got against want} (both on the CPU), the
    leaves of ZERO_GRADS as their peak over the tree's largest peak."""
    import torch
    pairs = [(p, g.detach().cpu().double(), w.detach().cpu().double())
             for p, g, w in _tree_pairs(got, want)]
    scale = max(float(w.abs().max()) for _, _, w in pairs)
    out = {}
    for p, g, w in pairs:
        if p.endswith(ZERO_GRADS):
            out[p] = float(torch.maximum(g.abs().max(), w.abs().max())) / scale
        elif float(w.norm()) == 0.0:
            out[p] = float(g.norm())
        else:
            out[p] = float((g - w).norm() / w.norm())
    return out


def _check_grads(label, grads, need_nonzero=True):
    """Every leaf finite and (unless it is a running statistic) nonzero."""
    import torch
    bad = []
    for p, g, _ in _tree_pairs(grads, grads):
        if not torch.isfinite(g).all():
            bad.append((p, "non-finite"))
        elif need_nonzero and not bool(g.abs().max() > 0) and \
                not p.endswith(("/mean", "/var")):
            bad.append((p, "zero"))
    if bad:
        fail(f"{label}: gradients {bad[:6]}")


def _wav(path, audio, sr=16000):
    import wave as wave_mod
    with wave_mod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(_pcm16(audio).tobytes())


def _manifest(tmp, name, entries):
    """Write each entry's audio as a wav; returns the manifest's path."""
    lines = []
    for i, (audio, extra) in enumerate(entries):
        path = os.path.join(tmp, f"{name}{i}.wav")
        _wav(path, audio)
        lines.append(json.dumps({"audio_filepath": path,
                                 "duration": len(audio) / 16000, **extra}))
    path = os.path.join(tmp, f"{name}.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def _train_log(label, log_, steps, card, tag="[train]"):
    """Check a trainer CLI's TrainLog; print ms per step and the peak."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(log_.losses) != steps or not np.isfinite(log_.losses).all():
        fail(f"{label}: losses {log_.losses}")
    ms = float(np.median(log_.seconds[1:])) * 1e3
    log(f"{tag} {label} | {card} | {steps} steps: losses "
        + ", ".join(f"{x:.4f}" for x in log_.losses)
        + f"; {ms:.1f} ms per step (median after the first, "
        f"{log_.seconds[0] * 1e3:.1f} ms first), peak "
        f"{peak:.2f} GiB (max_memory_allocated)")
    return {"ms_per_step": ms, "first_ms": log_.seconds[0] * 1e3,
            "peak_gib": peak, "losses": log_.losses}


def train_guard(device):
    """(a) fault 16: with gradients on, the stack, layer and fused
    attention routes refuse on the card; the eager route trains every
    encoder leaf."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.models.encoder import encoder_forward
    from asr_streaming_tpu_torch.train import optim
    from asr_streaming_tpu_torch.train.ctc import Batch, ctc_loss_fn
    cfg = ASRConfig.tiny(vocab_size=24)
    params = init_asr_params(torch.Generator().manual_seed(0), cfg, device)
    feats = torch.randn((2, 100, 128), generator=torch.Generator()
                        .manual_seed(1)).to(device)
    enc = optim.tree_map(lambda t: t.clone().requires_grad_(True),
                         params["encoder"])
    emf = cfg.encoder.emformer
    for route, fused in (("stack", False), ("layer", False),
                         ("eager", True)):
        e = dataclasses.replace(emf, route=route, fused_attention=fused)
        ecfg = dataclasses.replace(cfg.encoder, emformer=e)
        try:
            encoder_forward(enc, ecfg, feats)
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
        else:
            fail(f"route {route} (fused_attention={fused}) ran a kernel "
                 "under autograd on the card")
    with torch.no_grad():
        encoder_forward(enc, cfg.encoder, feats)     # serving: no refusal
    batch = Batch(feats, torch.tensor([100, 71], device=device),
                  torch.tensor([[3, 4, 5], [6, 7, 0]], device=device),
                  torch.tensor([3, 2], device=device))
    loss, grads = optim.value_and_grad(       # the stack route's cfg
        lambda p: ctc_loss_fn({"encoder": p}, cfg, batch), params["encoder"])
    _check_grads("(a) eager route", grads)
    n = len(optim.tree_leaves(grads))
    log(f"[train] (a) fault 16: the stack, layer and fused-attention "
        f"routes raise under autograd on the card; the eager route's loss "
        f"{float(loss):.4f}, all {n} encoder leaves finite and nonzero")


def _card_vs_cpu(label, loss_fn, params_cpu, args_cpu, device,
                 tag="[train] (b)"):
    """One loss and gradient on the CPU and on the card from the same
    weights and batch: (relative loss error, worst leaf, its error)."""
    from asr_streaming_tpu_torch.train import optim
    args_gpu = optim.tree_map(lambda x: x.to(device), args_cpu)
    l_cpu, g_cpu = optim.value_and_grad(
        lambda p: loss_fn(p, *args_cpu), params_cpu)
    l_gpu, g_gpu = optim.value_and_grad(
        lambda p: loss_fn(p, *args_gpu),
        optim.tree_map(lambda x: x.to(device), params_cpu))
    _check_grads(f"{tag} {label} on the card", g_gpu, need_nonzero=False)
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    errs = _grad_errors(g_gpu, g_cpu)
    worst = max(errs, key=errs.get)
    if not rel <= 1e-5 or not errs[worst] <= 1e-4:
        fail(f"{tag} {label}: loss {float(l_gpu)} vs {float(l_cpu)} (rel "
             f"{rel:.2e}, check 1e-5); worst gradient {worst} "
             f"{errs[worst]:.2e} (check 1e-4)")
    log(f"{tag} {label}, card vs CPU: loss {float(l_gpu):.6f} rel "
        f"{rel:.2e} (1e-5); worst leaf {worst} rel L2 {errs[worst]:.2e} "
        f"(1e-4) over {len(errs)} leaves")
    return {"loss_rel": rel, "grad_rel_l2": errs[worst]}


def train_card_vs_cpu(device):
    """(b) one step's loss and gradients, card against CPU, tiny
    geometry, TF32 off."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.models.rnnt import (
        RNNTConfig, init_rnnt_params,
    )
    from asr_streaming_tpu_torch.models.vad import (
        SileroConfig, init_silero_params,
    )
    from asr_streaming_tpu_torch.train import ctc, rnnt, speaker, vad
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    rng = np.random.default_rng(0)
    out = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    cfg = ASRConfig.tiny(vocab_size=24)
    p = init_asr_params(gen(1), cfg, "cpu")
    batch = ctc.Batch(t(rng.standard_normal((2, 100, 128), np.float32)),
                      t(np.array([100, 63])),
                      t(rng.integers(1, 24, (2, 6))), t(np.array([6, 4])))
    out["ctc"] = _card_vs_cpu(
        "CTC (ASRConfig.tiny)",
        lambda e, b: ctc.ctc_loss_fn({"encoder": e}, cfg, b),
        p["encoder"], (batch,), device)
    rcfg = RNNTConfig.tiny()
    p = init_rnnt_params(gen(2), rcfg, "cpu")
    batch = rnnt.RNNTBatch(t(rng.standard_normal((2, 40, 16), np.float32)),
                           t(np.array([40, 29])),
                           t(rng.integers(0, rcfg.blank, (2, 4))),
                           t(np.array([4, 2])))
    out["rnnt"] = _card_vs_cpu(
        "RNNT (RNNTConfig.tiny, offline)",
        lambda q, b: rnnt.rnnt_loss_fn(q, rcfg, b), p, (batch,), device)
    scfg = SileroConfig()
    p = init_silero_params(gen(3), scfg, "cpu")
    waves = (rng.standard_normal((2, 3000)) * 0.005).astype(np.float32)
    waves[0, 600:1500] += 0.4
    labels = vad.window_labels(waves, scfg)
    out["vad"] = _card_vs_cpu(
        "VAD (SileroConfig)",
        lambda q, w, lab: vad.vad_loss_fn(q, scfg, w, lab),
        p, (t(waves), t(labels)), device)
    kcfg = speaker.SpeakerTrainConfig.tiny(4)
    p = speaker.init_speaker_params(gen(4), kcfg, "cpu")
    out["speaker"] = _card_vs_cpu(
        "speaker (SpeakerTrainConfig.tiny)",
        lambda q, f, n, lab: speaker.speaker_loss_fn(q, kcfg, f, n, lab),
        p, (t(rng.standard_normal((4, 50, 16), np.float32)),
            t(np.array([50, 41, 50, 33])), t(np.array([0, 1, 2, 1]))),
        device)
    return out


def train_full_ctc(tmp, device, card, seed):
    """(c) the CTC CLI at full width (ASRConfig.vietnamese, f32, eager,
    the placeholder vocab): 5 steps, batch 8, a 4 s bucket; every encoder
    leaf's gradient finite and nonzero; the checkpoint through the
    server's loader into one serving tick at 512 slots."""
    import dataclasses
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    from asr_streaming_tpu_torch.train import optim
    from asr_streaming_tpu_torch.train.ctc import Batch, ctc_loss_fn
    from asr_streaming_tpu_torch.train.data import (
        SpeechRecognitionDataset, bucket_batches,
    )
    from asr_streaming_tpu_torch.train.run import main as run_main
    from asr_streaming_tpu_torch.ops.frontend import log_mel
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, load_params_auto,
    )
    rng = np.random.default_rng(seed)
    entries = [(_speechlike(3.0 + 0.1 * i, seed=10 + i),
                {"text": " ".join(f"t{k}" for k in rng.integers(0, 22, 12))})
               for i in range(8)]
    manifest = _manifest(tmp, "vi", entries)
    ckpt = os.path.join(tmp, "vi_ctc.npz")
    torch.cuda.reset_peak_memory_stats()
    log_ = run_main(["--manifest", manifest, "--steps", "5", "--batch-size",
                     "8", "--buckets-seconds", "4", "--save", ckpt,
                     "--seed", str(seed), "--device", str(device)])
    out = _train_log("(c) CTC CLI, ASRConfig.vietnamese() f32 eager "
                     "(D=512, H=8, F=2048, 20 layers, V=24), batch 8, 4 s",
                     log_, 5, card)

    vocab = placeholder_vocab(24)
    cfg = ASRConfig.vietnamese()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, vocab_size=len(vocab)))
    params = load_params(ckpt, like=init_asr_params(
        torch.Generator().manual_seed(0), cfg, device))
    b = next(bucket_batches(SpeechRecognitionDataset(manifest, vocab, {}),
                            8, buckets_seconds=[4.0], token_bucket=256))
    with torch.no_grad():
        feats = log_mel(params["frontend"], cfg.mel,
                        torch.from_numpy(b.waves).to(device))
    wl = torch.from_numpy(b.wave_lens).to(device)
    batch = Batch(feats, torch.clamp(1 + torch.div(
        wl - cfg.mel.n_fft, cfg.mel.hop_length, rounding_mode="floor"), min=0),
        torch.from_numpy(b.tokens).to(device),
        torch.from_numpy(b.token_lens).to(device))
    loss, grads = optim.value_and_grad(
        lambda e: ctc_loss_fn({"encoder": e}, cfg, batch), params["encoder"])
    if not np.isfinite(float(loss)):
        fail(f"(c) loss {float(loss)}")
    _check_grads("(c) full-width CTC", grads)
    n = len(optim.tree_leaves(grads))

    scfg = vi_serving_cfg()
    scfg = dataclasses.replace(scfg, asr=dataclasses.replace(
        scfg.asr, encoder=dataclasses.replace(scfg.asr.encoder,
                                              vocab_size=len(vocab))))
    sparams = load_params_auto(ckpt, init_serving_params(seed, scfg, device))
    gen = torch.Generator().manual_seed(seed)
    times = run_ticks(sparams, scfg, B_SLOTS, 2, gen, device)[0]
    log(f"[train] (c) checkpoint {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB: "
        f"all {n} encoder leaves' gradients finite and nonzero (loss "
        f"{float(loss):.4f} on the saved weights); load_params_auto into "
        f"server-vi.yaml's tick (bf16, stack route) at {B_SLOTS} slots: "
        f"{times[-1] * 1e3:.2f} ms a tick")
    return out


def _spm_model(tmp):
    """A 4096-piece SentencePiece model (the EN vocab's size, V=4097
    with the blank): the letters with and without the word marker,
    then filler pieces."""
    from asr_streaming_tpu_torch.text.spm import encode_test_model
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = ["<unk>", "<s>", "</s>"] + ["▁" + c for c in letters] \
        + list(letters)
    pieces += [f"▁w{i}" for i in range(4096 - len(pieces))]
    path = os.path.join(tmp, "spm_4096.model")
    with open(path, "wb") as f:
        f.write(encode_test_model(pieces))
    return path


def train_full_others(tmp, device, card, seed):
    """(d) the RNNT CLI on RNNTConfig() with --streaming-features (batch 4,
    4 s), the VAD CLI on SileroConfig(), the speaker CLI on
    EcapaConfig(): 3 steps each."""
    import torch
    from asr_streaming_tpu_torch.train import rnnt, speaker, vad
    words = "the quick brown fox jumps over a lazy dog".split()
    entries = [(_speechlike(3.5 + 0.1 * i, seed=20 + i),
                {"text": " ".join(words[i:] + words[:i]),
                 "label": f"spk{i % 4}"}) for i in range(8)]
    manifest = _manifest(tmp, "en", entries)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    out["rnnt"] = _train_log(
        "(d) RNNT CLI, RNNTConfig() (encoding 1024, V=4097, 20 layers) "
        "eager, --streaming-features, batch 4, 4 s",
        rnnt.main(["--manifest", manifest, "--spm", _spm_model(tmp),
                   "--steps", "3", "--batch-size", "4", "--seconds", "4",
                   "--streaming-features", "--save",
                   os.path.join(tmp, "rnnt.npz"), "--seed", str(seed),
                   "--device", str(device)]), 3, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["vad"] = _train_log(
        "(d) VAD CLI, SileroConfig(), 8 files in 0.84 s chunks",
        vad.main(["--manifest", manifest, "--steps", "3", "--out",
                  os.path.join(tmp, "vad.npz"), "--seed", str(seed),
                  "--device", str(device)]), 3, card)
    torch.cuda.reset_peak_memory_stats()
    out["speaker"] = _train_log(
        "(d) speaker CLI, EcapaConfig() (512 channels, 192-dim), "
        "batch 16, 3 s",
        speaker.main(["--manifest", manifest, "--steps", "3", "--save",
                      os.path.join(tmp, "ecapa.npz"), "--seed", str(seed),
                      "--device", str(device)]), 3, card)
    return out


def train_then_serve(tmp, device, card):
    """(e) the tiny CTC model trained on tests/test_overfit_e2e.py's task
    on the card (both stream alignments, lr 0.5, warmup 100, wd 0, up to
    1000 steps over seeds 3, 5, 0, 7, stopping once a golden candidate
    decodes at both alignments); then the transcript the Scheduler serves
    from the saved .npz equals the offline greedy decode (ASRModel) of
    the same audio."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.decode.greedy import greedy_search_full
    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.models.encoder import encoder_forward
    from asr_streaming_tpu_torch.models.serving import (
        ServingConfig, init_serving_params,
    )
    from asr_streaming_tpu_torch.ops.frontend import log_mel
    from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
    from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
    from asr_streaming_tpu_torch.train.ctc import (
        Batch, make_optimizer, make_train_step, training_config,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params_auto, save_params,
    )
    cfg = training_config(ASRConfig.tiny(vocab_size=len(TRAIN_VOCAB)))
    lead = cfg.audio.buffer_length / 16000
    pairs = [(s, off) for s in TRAIN_SENTENCES for off in (0.0, lead)]
    waves = np.stack([_sentence_audio(s, 2.56, lead=off) for s, off in pairs])
    probe = init_asr_params(torch.Generator().manual_seed(0), cfg, device)
    with torch.no_grad():
        feats = log_mel(probe["frontend"], cfg.mel,
                        torch.from_numpy(waves).to(device))
    labs = [[1 if ch == " " else TRAIN_VOCAB.index(ch) for ch in s]
            for s, _ in pairs]
    lab = np.zeros((len(labs), max(map(len, labs))), np.int64)
    for i, l in enumerate(labs):
        lab[i, :len(l)] = l
    batch = Batch(feats, torch.full((len(pairs),), feats.shape[1],
                                    device=device),
                  torch.from_numpy(lab).to(device),
                  torch.tensor([len(l) for l in labs], device=device))

    def decode(params, sentences, off):
        w = np.stack([_sentence_audio(s, 2.56, lead=off) for s in sentences])
        with torch.no_grad():
            f = log_mel(params["frontend"], cfg.mel,
                        torch.from_numpy(w).to(device))
            lp = encoder_forward(params["encoder"], cfg.encoder, f)[0]
        lp = lp.cpu().numpy()
        return [greedy_search_full(lp[i], TRAIN_VOCAB)[0].strip()
                for i in range(len(sentences))]

    def golden_of(params):
        at0 = decode(params, GOLDEN_CANDIDATES, 0.0)
        atl = decode(params, GOLDEN_CANDIDATES, lead)
        for s, a, b in zip(GOLDEN_CANDIDATES, at0, atl):
            if a == s == b:
                return s
        return None

    optimizer = make_optimizer(cfg, base_lr=0.5, warmup_steps=100,
                               weight_decay=0.0)
    step_fn = make_train_step(cfg, optimizer)
    t0 = time.perf_counter()
    steps = 0
    best = None
    # the JAX fixture's four seeds; the port draws its init from a
    # torch.Generator, not jax.random, so their order is this phase's
    # own: seed 3 verifies a candidate first on the card
    for seed in (3, 5, 0, 7):
        params = init_asr_params(torch.Generator().manual_seed(seed), cfg,
                                 device)
        opt_state = optimizer.init(params["encoder"])
        golden = None
        for step in range(1000):
            params, opt_state, loss = step_fn(params, opt_state, batch)
            steps += 1
            if step >= 300 and step % 150 == 0 and float(loss) < 0.5:
                golden = golden_of(params)
                if golden is not None:
                    break
        if golden is None and float(loss) < 0.5:
            golden = golden_of(params)
        if best is None or (golden is not None, -float(loss)) > \
                (best[2] is not None, -best[1]):
            best = (params, float(loss), golden, seed, step + 1)
        if golden is not None:
            break
    train_s = time.perf_counter() - t0
    params, loss, golden, seed, seed_steps = best
    log(f"[train] (e) tiny CTC on the overfit task | {card}: seed {seed}, "
        f"{seed_steps} steps, final loss {loss:.4f}; golden candidate "
        f"{'verified: ' + repr(golden) if golden else 'none verified'}; "
        f"{steps} steps in {train_s:.1f} s ({train_s / steps * 1e3:.1f} ms "
        f"a step)")

    path = os.path.join(tmp, "overfit_trained.npz")
    save_params(path, params)
    sentence = golden or GOLDEN_CANDIDATES[0]
    audio = _sentence_audio(sentence, 3.84)
    offline = ASRModel(cfg=ASRConfig.tiny(vocab_size=len(TRAIN_VOCAB)),
                       checkpoint=path, vocab=TRAIN_VOCAB, use_corpus=False,
                       device=device).transcribe(audio).strip()
    scfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(TRAIN_VOCAB)),
                         use_silero=False, use_energy_gate=False,
                         energy_threshold_db=-200.0)
    sparams = load_params_auto(path, init_serving_params(1, scfg, device))
    rules = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
    sched = Scheduler(sparams, scfg, TRAIN_VOCAB, max_slots=8, rules=rules,
                      device=device)
    s = sched.admit("t0")
    s.accept_waveform(audio)
    s.add_tail_padding()
    events = sched.drain()
    sched.close()
    finals = [e.text.strip() for e in events
              if e.kind == "final" and e.text.strip()]
    served = " ".join(finals)
    if served != offline:
        fail(f"(e) served {finals} != offline greedy {offline!r} "
             f"({sentence!r})")
    log(f"[train] (e) train == serve: the Scheduler (stack route) serves "
        f"{served!r} from the saved .npz, the offline greedy decode "
        f"(ASRModel) gives {offline!r} for {sentence!r}")
    return {"seed": seed, "steps": seed_steps, "loss": loss,
            "golden": golden, "served": served, "train_s": train_s,
            "ms_per_step": train_s / steps * 1e3}


def phase_train(seed, device, card):
    """The training stack on the card: (a) the fault-16 guard, (b) one
    step card against CPU for each trainer, (c) the CTC CLI at full
    width, (d) the RNNT, VAD and speaker CLIs at full width, (e) train
    then serve.  Returns its numbers for the ``[train]`` line."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {}
    train_guard(device)
    out["card_vs_cpu"] = train_card_vs_cpu(device)
    with tempfile.TemporaryDirectory() as tmp:
        out["ctc"] = train_full_ctc(tmp, device, card, seed)
        torch.cuda.empty_cache()
        out.update(train_full_others(tmp, device, card, seed))
        torch.cuda.empty_cache()
        out["train_then_serve"] = train_then_serve(tmp, device, card)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train": out}), flush=True)


# ------------------------------------------------ SSL, GAN and TTS (13)

TTS_SENTENCES = ["ab cd", "dc ba", "ad bc", "ca db", "acd b"]


def _gan_tiny():
    """GANTrainConfig.tiny's generator and full-width discriminators on
    the CPU, and a batch of tests/test_ssl_gan_train.py's shape."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.tts import init_tts_params
    from asr_streaming_tpu_torch.train import gan
    from asr_streaming_tpu_torch.train.data import TTSBatch
    cfg = gan.GANTrainConfig.tiny()
    g = torch.Generator().manual_seed(0)
    params = init_tts_params(g, cfg.tts, "cpu")
    disc, static = gan.init_discriminators(g, "cpu")
    rng = np.random.default_rng(0)
    B, Tp = 2, 12
    tokens = rng.integers(1, cfg.tts.linguistic.vocab_size, (B, Tp))
    word_idxs = np.repeat(np.arange(Tp // 3), 3)[None].repeat(B, 0)
    word_durs = np.zeros((B, Tp), np.int32)
    word_durs[:, :Tp // 3] = rng.integers(8, 16, (B, Tp // 3))
    audio = np.zeros((B, cfg.tts.max_frames * cfg.tts.hop_length),
                     np.float32)
    audio_lens = (word_durs.sum(1) * cfg.tts.hop_length).astype(np.int32)
    for b in range(B):
        audio[b, :audio_lens[b]] = rng.standard_normal(audio_lens[b]) * 0.1
    batch = TTSBatch(tokens.astype(np.int32), np.full(B, Tp, np.int32),
                     word_idxs.astype(np.int32), word_durs, audio, audio_lens)
    return cfg, params, disc, static, gan.tts_batch_to(batch, "cpu")


def _widened(tree, dtype):
    from asr_streaming_tpu_torch.train import optim
    return optim.tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def tts_card_vs_cpu(device):
    """(a) card against CPU at tiny geometry, TF32 off: one SSL step and
    one GAN discriminator step (loss 1e-5 relative, each leaf's gradient
    1e-4 relative L2, in f32); one GAN generator step (its loss and parts
    1e-5 in f32; its gradients 1e-4 in float64: the generator's f32
    gradient is ill-conditioned, another sum order moving the decoder
    attention's leaves by far more than 1e-4, so the f32 spread is
    printed, not held); inverse_stft (1e-5, and two card runs
    bit for bit); synthesize (audio 1e-5, lengths and durations exact)."""
    import dataclasses
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.tts import synthesize
    from asr_streaming_tpu_torch.ops.istft import inverse_stft
    from asr_streaming_tpu_torch.train import gan, optim, ssl
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    out = {}

    scfg = dataclasses.replace(ssl.SSLConfig.tiny(), mask_prob=0.1)
    g = torch.Generator().manual_seed(1)
    trainable, frozen = ssl.init_ssl_params(g, scfg, "cpu")
    feats = torch.randn((2, 64, scfg.encoder.input_dim), generator=g)
    draws = ssl.ssl_draws(g, scfg, tuple(feats.shape))
    out["ssl"] = _card_vs_cpu(
        "SSL step (SSLConfig.tiny, mask_prob 0.1)",
        lambda t, f, x, n, d: ssl.ssl_loss_fn(t, f, scfg, x, n, d),
        trainable, (frozen, feats, torch.tensor([64, 45]), draws), device,
        tag="[tts] (a)")

    cfg, params, disc, static, batch = _gan_tiny()
    fake = gan.gen_loss_fn(params, disc, static, cfg, batch)[1]["fake"]
    out["gan_disc"] = _card_vs_cpu(
        "GAN discriminator step (MPD 5 periods to 1024 channels, MRD 3 "
        "resolutions)",
        lambda d, f, r: gan.disc_loss_fn(d, static, f, r), disc,
        (fake.detach(), batch.audio[:, :fake.shape[1]]), device,
        tag="[tts] (a)")

    def gen_loss(dtype, dev):
        d = optim.tree_map(lambda t: t.to(dev), _widened(disc, dtype))
        b = optim.tree_map(lambda t: t.to(dev), _widened(batch, dtype))
        return optim.value_and_grad(
            lambda p: gan.gen_loss_fn(p, d, static, cfg, b),
            optim.tree_map(lambda t: t.to(dev), _widened(params, dtype)),
            has_aux=True)

    (l_cpu, a_cpu), g_cpu = gen_loss(torch.float32, "cpu")
    (l_gpu, a_gpu), g_gpu = gen_loss(torch.float32, device)
    parts = {k: abs(float(a_gpu[k]) - float(a_cpu[k])) / abs(float(a_cpu[k]))
             for k in ("stft", "adv", "dur")}
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    e32 = _grad_errors(g_gpu, g_cpu)
    (l64c, _), g64c = gen_loss(torch.float64, "cpu")
    (l64g, _), g64g = gen_loss(torch.float64, device)
    _check_grads("(a) GAN generator on the card", g64g, need_nonzero=False)
    e64 = _grad_errors(g64g, g64c)
    worst32, worst64 = max(e32, key=e32.get), max(e64, key=e64.get)
    rel64 = abs(float(l64g) - float(l64c)) / abs(float(l64c))
    if not rel <= 1e-5 or max(parts.values()) > 1e-5 or not rel64 <= 1e-5 \
            or not e64[worst64] <= 1e-4:
        fail(f"(a) GAN generator: loss rel {rel:.2e}, parts {parts} (1e-5); "
             f"float64 loss rel {rel64:.2e}, worst gradient {worst64} "
             f"{e64[worst64]:.2e} (1e-4)")
    log(f"[tts] (a) GAN generator step (GANTrainConfig.tiny), card vs CPU: "
        f"loss {float(l_gpu):.6f} rel {rel:.2e}, parts max "
        f"{max(parts.values()):.2e} (1e-5, f32); gradients in float64: worst "
        f"{worst64} {e64[worst64]:.2e} (1e-4) over {len(e64)} leaves; in f32 "
        f"(not held): worst {worst32} {e32[worst32]:.2e}")
    out["gan_gen"] = {"loss_rel": rel, "grad_rel_l2_f64": e64[worst64],
                      "grad_rel_l2_f32": e32[worst32]}

    g = torch.Generator().manual_seed(2)
    errs = []
    for n_fft, win, hop, T in ((800, 400, 160, 301), (128, 128, 32, 255),
                               (30, 20, 7, 13)):
        spec = torch.complex(torch.randn((3, n_fft // 2 + 1, T), generator=g),
                             torch.randn((3, n_fft // 2 + 1, T), generator=g))
        want = inverse_stft(spec, n_fft, win, hop)
        got = inverse_stft(spec.to(device), n_fft, win, hop)
        again = inverse_stft(spec.to(device), n_fft, win, hop)
        if not torch.equal(got, again):
            fail(f"(a) inverse_stft: two card runs differ at {n_fft}/{hop}")
        err = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5):
            fail(f"(a) inverse_stft {n_fft}/{win}/{hop}: max |err| {err:.2e}")
        errs.append(err)
    out["istft_max_abs_err"] = max(errs)

    tokens = torch.tensor([[3, 5, 7, 2, 9, 11, 4, 0, 0],
                           [8, 1, 6, 13, 0, 0, 0, 0, 0]])
    lens = torch.tensor([7, 4])
    words = torch.tensor([[0, 0, 1, 1, 1, 2, 3, -1, -1],
                          [0, 1, 1, 2, -1, -1, -1, -1, -1]])
    durs = torch.tensor([[30, 50, 20, 40], [60, 10, 25, 0]])
    gdev = optim.tree_map(lambda t: t.to(device), params)
    serr = []
    with torch.no_grad():
        for d in (durs, None):
            want = synthesize(params, cfg.tts, tokens, lens, words, d)
            got = synthesize(gdev, cfg.tts, tokens.to(device), lens.to(device),
                             words.to(device),
                             None if d is None else d.to(device))
            if not torch.equal(got[1].cpu(), want[1]) or \
                    got[0].shape != want[0].shape:
                fail(f"(a) synthesize lengths {got[1].tolist()} vs "
                     f"{want[1].tolist()}")
            pred = torch.clamp(torch.ceil(got[2].cpu()), min=10)
            if not torch.equal(pred, torch.clamp(torch.ceil(want[2]), min=10)):
                fail("(a) synthesize: predicted durations differ")
            if not torch.allclose(got[0].cpu(), want[0], rtol=1e-5,
                                  atol=1e-5):
                fail(f"(a) synthesize audio: max |err| "
                     f"{float((got[0].cpu() - want[0]).abs().max()):.2e}")
            serr.append(float((got[0].cpu() - want[0]).abs().max()))
    out["synthesize_max_abs_err"] = max(serr)
    log(f"[tts] (a) inverse_stft card vs CPU max |err| {max(errs):.2e} "
        f"(1e-5), two card runs bit for bit; synthesize (TTSConfig.tiny, "
        f"forced and predicted durations) audio max |err| {max(serr):.2e} "
        f"(1e-5), lengths and durations exact")
    return out


def _step_profile(label, fn):
    """One call of a training step, warm: its host-clock ms (ending in a
    synchronize), its device ms and launches (torch.profiler) and the
    device's busy share of the host clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev, launches = profile_top(fn, label, n=6)
    log(f"[tts] {label}: {wall:.1f} ms host clock, {dev:.1f} ms of device "
        f"time in {launches} launches: the device busy {100 * dev / wall:.0f}%"
        f" of the step")
    return {"wall_ms": wall, "device_ms": dev, "launches": launches}


def tts_full_ssl(tmp, device, card, seed):
    """(b) the SSL CLI at full width: SSLConfig() (256-d, 8 layers, 128
    mels, codebook 8192), batch 8 of 4 s, 3 steps.  The 4 s crop is cut
    from the CLI's 16 s default to keep the phase inside the script's
    time limit."""
    import torch
    from asr_streaming_tpu_torch.train import optim, ssl
    manifest = _manifest(tmp, "ssl", [(_speechlike(3.6 + 0.1 * i, seed=30 + i),
                                       {}) for i in range(8)])
    torch.cuda.reset_peak_memory_stats()
    out = _train_log(
        "(b) SSL CLI, SSLConfig() (256-d, 8 layers, 128 mels, codebook "
        "8192), batch 8, 4 s", ssl.main([
            "--manifest", manifest, "--steps", "3", "--batch-size", "8",
            "--seconds", "4", "--save", os.path.join(tmp, "ssl.npz"),
            "--seed", str(seed), "--device", str(device)]),
        3, card, tag="[tts]")
    cfg = ssl.SSLConfig()
    g = torch.Generator().manual_seed(seed)
    trainable, frozen = ssl.init_ssl_params(g, cfg, device)
    feats = torch.randn((8, 401, 128), generator=g).to(device)
    lens = torch.full((8,), 401, device=device)
    draws = ssl.ssl_draws(g, cfg, tuple(feats.shape), device)
    opt = optim.adamw(3e-4, weight_decay=1e-4)
    state = opt.init(trainable)
    step = ssl.make_ssl_train_step(cfg, opt)
    out["profile"] = _step_profile(
        "(b) one SSL step (SSLConfig(), 8 x 401 frames)",
        lambda: step(trainable, frozen, state, feats, lens, draws))
    return out


def tts_manifest(tmp, device, card):
    """(c) the TTS manifest: the overfit fixture's ASRModel aligns the
    tone sentences through the tool's functions, in its main's order
    (every entry written, durations tiling the audio, kernel A launched);
    then the CLI once at full width (ASRConfig.vietnamese, seed-0 random
    weights) exits 0 and launches A.  With no corpus in the repository
    its model has the placeholder vocab and no lexicon, so no word of a
    transcript tokenizes and every utterance is skipped as unaligned: the
    CLI's run checks the entry point, the in-process run the pipeline.
    Returns (the manifest's path, the CLI's kernel launches)."""
    import numpy as np
    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.ops import _cuda
    from asr_streaming_tpu_torch.tools import make_tts_manifest as mk
    fixture = os.path.join(HERE, "assets", "test_fixtures", "overfit_ctc.npz")
    lexicon = {w: list(w) + ["|"] for s in TTS_SENTENCES for w in s.split()}
    model = ASRModel(cfg=ASRConfig.tiny(vocab_size=len(TRAIN_VOCAB)),
                     checkpoint=fixture, vocab=TRAIN_VOCAB, lexicon=lexicon,
                     use_corpus=False, device=device)
    before = _cuda.launch_counts()["emformer_stack"]
    t0 = time.perf_counter()
    lines = []
    for i, text in enumerate(TTS_SENTENCES):
        wave = _sentence_audio(text, 3.84)
        path = os.path.join(tmp, f"tone{i}.wav")
        _wav(path, wave)
        _, word_segs = model.force_alignment(wave, text)
        token_ids, word_idxs = mk.tokens_and_words(text, model.vocab,
                                                   model.lexicon)
        durs = mk.word_durations_from_alignment(
            word_segs, len(wave) / 16000, 16000, 160)
        if max(word_idxs) + 1 != len(word_segs) or not durs or \
                sum(durs) != int(3.84 * 16000) // 160:
            fail(f"(c) {text!r}: words {word_idxs}, segments "
                 f"{len(word_segs)}, durations {durs}")
        lines.append(json.dumps({"audio_filepath": path, "text": text,
                                 "tokens": token_ids, "word_idxs": word_idxs,
                                 "word_durations": durs}))
    launched = _cuda.launch_counts()["emformer_stack"] - before
    if launched <= 0:
        fail("(c) the manifest's alignments launched no kernel A")
    manifest = os.path.join(tmp, "tts.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"[tts] (c) manifest of {len(lines)} tone sentences through the "
        f"overfit fixture on the card in {time.perf_counter() - t0:.2f} s: "
        f"every entry written, durations tile 3.84 s ({int(3.84 * 100)} "
        f"frames at hop 160), kernel A launched {launched} times; e.g. "
        f"{json.loads(lines[0])['word_durations']}")

    asr = os.path.join(tmp, "asr_vi.jsonl")
    with open(asr, "w") as f:
        for i, text in enumerate(("xin chào các bạn", "hôm nay trời đẹp")):
            path = os.path.join(tmp, f"vi{i}.wav")
            _wav(path, _speechlike(2.5, seed=40 + i))
            f.write(json.dumps({"audio_filepath": path, "text": text}) + "\n")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "asr_streaming_tpu_torch.tools."
         "make_tts_manifest", "--manifest", asr, "--out",
         os.path.join(tmp, "tts_vi.jsonl")], cwd=HERE, capture_output=True,
        text=True, timeout=300)
    if cli.returncode != 0:
        fail(f"(c) make_tts_manifest CLI exited {cli.returncode}:\n"
             f"{cli.stderr[-2000:]}")
    counts = [ln for ln in cli.stderr.splitlines() if "kernel launches:" in ln]
    if not counts:
        fail("(c) the manifest CLI logged no kernel launches")
    launches = json.loads(counts[-1].split("kernel launches:", 1)[1])
    if launches.get("emformer_stack", 0) <= 0:
        fail(f"(c) the manifest CLI launched no kernel A: {launches}")
    wrote = [ln for ln in cli.stderr.splitlines() if "wrote" in ln]
    skipped = [ln for ln in cli.stderr.splitlines()
               if "skipped" in ln or "failed" in ln or "no aligned" in ln]
    log(f"[tts] (c) python -m asr_streaming_tpu_torch.tools.make_tts_manifest "
        f"(ASRConfig.vietnamese, seed-0 weights) exits 0 in "
        f"{time.perf_counter() - t0:.1f} s: {wrote[-1] if wrote else ''}"
        f"{' (' + skipped[0][:160] + ')' if skipped else ''}; "
        f"kernel A launched {launches['emformer_stack']} times")
    return manifest, launches


def tts_full_gan(tmp, manifest, device, card, seed):
    """(d) the GAN CLI at full width: GANTrainConfig() (TTSConfig(): 4+4
    linguistic layers, 4 decoder layers, 256-d, n_fft 800; the MPD over 5
    periods to 1024 channels, the MRD at 3 resolutions), batch 4 from (c)'s
    manifest, 3 steps; then its .npz in TTSModel synthesizes finite audio
    of the length its predicted durations give; one generator +
    discriminator step profiled."""
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.tts import TTSModel, synthesize
    from asr_streaming_tpu_torch.train import gan, optim
    from asr_streaming_tpu_torch.train.data import (
        SpeechSynthesisDataset, tts_batches,
    )
    ckpt = os.path.join(tmp, "tts.npz")
    torch.cuda.reset_peak_memory_stats()
    out = _train_log(
        "(d) GAN CLI, GANTrainConfig() (TTSConfig(): 256-d, 4+4 linguistic "
        "and 4 decoder layers, n_fft 800; MPD to 1024 channels, MRD 3 "
        "resolutions), batch 4, 20.48 s buckets", gan.main([
            "--manifest", manifest, "--steps", "3", "--batch-size", "4",
            "--save", ckpt, "--seed", str(seed), "--device", str(device)]),
        3, card, tag="[tts]")
    gcfg = gan.GANTrainConfig()
    g = torch.Generator().manual_seed(seed)
    params = gan.init_tts_params(g, gcfg.tts, device)
    disc, static = gan.init_discriminators(g, device)
    batch = gan.tts_batch_to(next(tts_batches(
        SpeechSynthesisDataset(manifest), 4, gcfg.tts.hop_length,
        gcfg.tts.max_frames)), device)
    g_opt = optim.adamw(2e-4, b1=0.8, b2=0.99)
    d_opt = optim.adamw(2e-4, b1=0.8, b2=0.99)
    g_state, d_state = g_opt.init(params), d_opt.init(disc)
    gen_step, disc_step = gan.make_gan_train_steps(gcfg, g_opt, d_opt,
                                                   static)

    def both():
        fake, real = gen_step(params, disc, g_state, batch)[3:]
        return disc_step(disc, d_state, fake, real)

    out["profile"] = _step_profile(
        "(d) one GAN generator + discriminator step (GANTrainConfig(), "
        "batch 4)", both)
    del params, disc, g_state, d_state, batch
    torch.cuda.empty_cache()
    cfg = gcfg.tts
    model = TTSModel(cfg, checkpoint=ckpt, device=device)
    entry = json.loads(open(manifest).readline())
    tokens = np.asarray(entry["tokens"], np.int32)
    words = np.asarray(entry["word_idxs"], np.int32)
    audio = model(tokens, words)
    with torch.no_grad():
        t = torch.as_tensor(tokens, device=device)[None]
        w = torch.as_tensor(words, device=device)[None]
        _, _, pred = synthesize(model.params, cfg, t, torch.tensor(
            [len(tokens)], device=device), w)
    n_words = int(words.max()) + 1
    frames = int(torch.clamp(torch.ceil(pred[0, :n_words]), min=10).to(
        torch.int64).sum().clamp(1, cfg.max_frames))
    out_len = (cfg.max_frames - 1) * cfg.hop_length
    want = int(np.float32(out_len / cfg.max_frames) * np.float32(frames))
    if len(audio) != want or not np.isfinite(audio).all():
        fail(f"(d) TTSModel from the GAN's .npz: {len(audio)} samples "
             f"(want {want} for {frames} frames), finite "
             f"{bool(np.isfinite(audio).all())}")
    log(f"[tts] (d) the GAN's {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB .npz "
        f"in TTSModel: {len(audio)} finite samples for {frames} predicted "
        f"frames ({n_words} words)")
    out["synth_samples"] = len(audio)
    return out


def phase_tts(seed, device, card):
    """The SSL and TTS-GAN trainers and the TTS manifest on the card: (a)
    card vs CPU at tiny geometry, (b) the SSL CLI at full width, (c) the
    manifest in process (kernel A) and its CLI, (d) the GAN CLI at full
    width and its checkpoint in TTSModel.  Returns the CLI's launches."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {"card_vs_cpu": tts_card_vs_cpu(device)}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        out["ssl"] = tts_full_ssl(tmp, device, card, seed)
        torch.cuda.empty_cache()
        manifest, launches = tts_manifest(tmp, device, card)
        out["gan"] = tts_full_gan(tmp, manifest, device, card, seed)
    out["seconds"] = time.perf_counter() - t0
    log(f"[tts] phase {out['seconds']:.1f} s")
    print(json.dumps({"tts": out}), flush=True)
    return launches


# --------------------------------- data- and tensor-parallel training (14)

def _dict_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _dict_leaves(v, f"{path}/{k}")]
    return [(path, tree)]


def dist_parity(device, card):
    """(a) dp = 2, tp = 2 and dp = 2 x tp = 2 CTC steps at the geometry of
    the JAX package's sharded-step test (train/dist_check.py), four ranks
    spawned from here: NCCL over distinct cards where there are four, else
    gloo with every rank on cuda:0; each layout against the single-process
    step on the same card (loss 1e-5 relative, gathered gradient leaves
    1e-4 relative L2, updated weights 1e-5 max abs)."""
    import torch
    from asr_streaming_tpu_torch.models.asr import init_asr_params
    from asr_streaming_tpu_torch.train import ctc, dist_check
    cfg = ctc.training_config(dist_check.tiny_config())
    enc = init_asr_params(torch.Generator().manual_seed(0), cfg,
                          "cpu")["encoder"]
    arrays = dist_check.tiny_batch()
    want = dist_check.reference(enc, cfg, arrays, device)
    t0 = time.perf_counter()
    got = dist_check.run_layouts(enc, cfg, arrays, device)
    seconds = time.perf_counter() - t0
    if got["foreign_modules"]:
        fail(f"(a) a spawned rank imported {got['foreign_modules']}")
    bounds = dist_check.bounds(cfg)
    errors = {}
    for dp, mp in dist_check.LAYOUTS:
        err = dist_check.compare(got[(dp, mp)], want)
        errors[f"{dp}x{mp}"] = err
        bad = {k: v for k, v in err.items() if not v <= bounds[k]}
        if bad:
            fail(f"(a) {dp}x{mp} over {got['backend']}: {bad} past {bounds}")
    where = ("NCCL, one card a rank" if got["backend"] == "nccl" else
             f"gloo, all four ranks on {device}")
    log(f"[dist] (a) {card} | 4 ranks over {where} ({seconds:.1f} s with "
        f"the spawn): each layout equals the single-process step on the "
        f"card: {json.dumps(errors)} (bounds {json.dumps(bounds)})")
    return {"backend": got["backend"], "errors": errors}


def _torchrun(label, nproc, mp, manifest, ckpt, seed, card, device,
              extra=()):
    """``python -m torch.distributed.run`` of the CTC CLI at full width
    (ASRConfig.vietnamese(), f32, batch 8 in the 4 s bucket, 3 steps);
    ms per step and peak memory per rank from the ranks' last lines."""
    import re
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(nproc), "--master-port", str(_free_port()),
           "-m", "asr_streaming_tpu_torch.train.run", "--manifest", manifest,
           "--steps", "3", "--batch-size", "8", "--buckets-seconds", "4",
           "--save", ckpt, "--seed", str(seed), "--device", device.type,
           "--model-parallel", str(mp), *extra]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"(b) {label}: exit {out.returncode}\n{out.stderr[-4000:]}")
    done = re.findall(r"done: rank (\d+), 3 steps, final loss ([\d.]+), "
                      r"median ([\d.]+) ms/step, peak memory ([\d.]+|nan) MiB",
                      out.stderr)
    backend = sorted(set(re.findall(r" on \S+ over (\w+)", out.stderr)))
    mesh = re.findall(r"mesh: (\{[^}]*\}) of", out.stderr)
    if len(done) != nproc or not mesh or len(backend) != 1:
        fail(f"(b) {label}: {done} {mesh} {backend}\n{out.stderr[-3000:]}")
    ranks = {int(r): {"final_loss": float(loss), "ms_per_step": float(ms),
                      "peak_mib": float(peak)} for r, loss, ms, peak in done}
    log(f"[dist] (b) {label} | {card} | {nproc} ranks, mesh {mesh[0]}, "
        f"{backend[0]}, {wall:.1f} s with the launch: "
        + "; ".join(f"rank {r}: {v['ms_per_step']:.1f} ms/step (median of "
                    f"3), peak {v['peak_mib']:.0f} MiB, final loss "
                    f"{v['final_loss']:.4f}" for r, v in sorted(ranks.items())))
    return {"backend": backend[0], "mesh": mesh[0], "wall_s": wall,
            "ranks": ranks}


def dist_cli(tmp, seed, card, device, extra=()):
    """(b) the CLI under torchrun at full width: tensor-parallel (2 ranks,
    --model-parallel 2), data-parallel (2 ranks, --model-parallel 1) and
    both (4 ranks, --model-parallel 2).  ``extra`` joins the CLI's
    arguments (``--tiny`` rehearses it on the CPU).  Returns the numbers
    and the checkpoints' paths."""
    import numpy as np
    rng = np.random.default_rng(seed)
    entries = [(_speechlike(3.0 + 0.1 * i, seed=10 + i),
                {"text": " ".join(f"t{k}" for k in rng.integers(0, 22, 12))})
               for i in range(8)]
    manifest = _manifest(tmp, "dist", entries)
    out, ckpts = {}, {}
    for label, nproc, mp in (("tp=2", 2, 2), ("dp=2", 2, 1),
                             ("dp=2 x tp=2", 4, 2)):
        ckpts[label] = os.path.join(tmp, f"ctc_{nproc}_{mp}.npz")
        out[label] = _torchrun(label, nproc, mp, manifest, ckpts[label],
                               seed, card, device, extra)
    return out, ckpts


def dist_serve(ckpts, seed, device, card):
    """(c) train == serve across the layout: the tensor-parallel run's
    gathered checkpoint through the server's loader into server-vi.yaml's
    tick (bf16, kernel A's stack route) at 512 slots; A and B must launch.
    Beside it, the largest difference between the checkpoints of the
    three layouts (the key half of b_kv apart: its gradient is rounding
    noise that Adam scales to the learning rate)."""
    import dataclasses
    import numpy as np
    import torch
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.ops import _cuda
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, load_params_auto,
    )
    vocab = placeholder_vocab(24)
    scfg = vi_serving_cfg()
    scfg = dataclasses.replace(scfg, asr=dataclasses.replace(
        scfg.asr, encoder=dataclasses.replace(scfg.asr.encoder,
                                              vocab_size=len(vocab))))
    sparams = load_params_auto(ckpts["tp=2"],
                               init_serving_params(seed, scfg, device))
    gen = torch.Generator().manual_seed(seed)
    before = _cuda.launch_counts()
    times = run_ticks(sparams, scfg, B_SLOTS, 2, gen, device)[0]
    after = _cuda.launch_counts()
    _need_launched("(c) the tp checkpoint's tick",
                   {k: after[k] - before.get(k, 0) for k in after},
                   ("emformer_stack", "emission_append"))
    trees = {k: dict(_dict_leaves(load_params(v))) for k, v in ckpts.items()}
    diffs = {}
    for other in ("dp=2", "dp=2 x tp=2"):
        worst = 0.0
        for path, a in trees["tp=2"].items():
            b = trees[other][path]
            if a.shape != b.shape:
                fail(f"(c) {path}: {a.shape} against {b.shape} ({other})")
            d = np.abs(np.asarray(a, np.float64) - b)
            if path.endswith("b_kv"):
                d = np.split(d, 2, -1)[1]
            worst = max(worst, float(d.max()))
        diffs[other] = worst
    log(f"[dist] (c) {card} | the tp=2 checkpoint "
        f"({os.path.getsize(ckpts['tp=2']) / 2 ** 20:.1f} MiB, whole leaves "
        f"in the JAX key layout) served by server-vi.yaml's tick at "
        f"{B_SLOTS} slots: {times[-1] * 1e3:.2f} ms a tick; largest weight "
        f"difference after 3 steps against the other layouts' checkpoints "
        f"(b_kv's key half apart): {json.dumps(diffs)}")
    return {"tick_ms": times[-1] * 1e3, "max_diff": diffs}


def dist_round_trip(device, card):
    """(d) gather_params(shard_params(x)) == x bit for bit at full width
    (ASRConfig.vietnamese()), mp = 2 and 4, on the card."""
    import torch
    from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
    from asr_streaming_tpu_torch.parallel.mesh import (
        gather_params, make_mesh, shard_params,
    )
    whole = init_asr_params(torch.Generator().manual_seed(0),
                            ASRConfig.vietnamese(), device)
    leaves = dict(_dict_leaves(whole))
    n = sum(t.numel() for t in leaves.values())
    for mp in (2, 4):
        mesh = make_mesh(devices=[device] * mp, model_parallel=mp)
        back = dict(_dict_leaves(gather_params(
            [shard_params(whole, mesh, r) for r in range(mp)], mesh)))
        for path, a in leaves.items():
            b = back[path]
            if a.shape != b.shape or not torch.equal(a, b):
                fail(f"(d) mp={mp}: {path} differs after the round trip")
    log(f"[dist] (d) {card} | gather_params(shard_params(x)) == x bit for "
        f"bit at ASRConfig.vietnamese() ({n} parameters), mp = 2 and 4")


def phase_dist(seed, device, card):
    """Data- and tensor-parallel CTC training: (a) parity on the card, (b)
    the CLI under torchrun at full width, (c) its checkpoint served at 512
    slots (kernels A and B), (d) the shard/gather round trip at full
    width.  Returns its numbers."""
    import tempfile
    out = {"parity": dist_parity(device, card)}
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"], ckpts = dist_cli(tmp, seed, card, device)
        out["serve"] = dist_serve(ckpts, seed, device, card)
    dist_round_trip(device, card)
    log(f"[dist] {json.dumps(out)}")
    return out


# ------------------------------------------- two checkouts, side by side

def kernel_a_times():
    """Kernel A's times on the card for the package first on sys.path:
    one f32 step at 512 slots (the tiled f32 kernel), the bf16 VI and EN
    steps (``stack_digest``, with their products' share), the A-int8 and
    A-int8_ffn VI steps (``stack_digest`` with ``quant``: their digests,
    and by part the row quantiser, the int8 GEMMs, the row kernels and the
    attention, with their launches from the library's counters), one f32
    step at B=1, each step's attention part beside its bytes bound and
    scaled_dot_product_attention (``stack_parts``), and
    ``ASRModel.emissions`` on 10 s of audio.  Logs one
    ``[compare]`` line.  To compare two commits, call it from a small
    driver with either checkout's package first on sys.path (parent,
    change, change, parent, a process each)."""
    import dataclasses
    import torch
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.emformer import (
        EmformerConfig, init_emformer_params,
    )
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    dev = torch.device("cuda", 0)

    def step(cfg, B, seed, quant="none"):
        gen = torch.Generator().manual_seed(seed)
        params = init_emformer_params(gen, cfg, dev)
        mem, lck, lcv, length = _stack_inputs(cfg, B, gen, dev)
        T = cfg.segment_length + cfg.right_context_length
        x = torch.randn((B, T, cfg.d_model), generator=gen).to(dev)
        kw = _stack_kw(cfg, quant)
        return lambda: es.emformer_stack(params, x, mem, lck, lcv, length,
                                         **kw)

    f32_512 = step(EmformerConfig(compute_dtype=torch.float32), B_SLOTS, 1)
    ms_512 = device_times(f32_512, 3, need="gemm_f32")[0]
    del f32_512
    torch.cuda.empty_cache()
    digest, ms_bf16, vi_parts = stack_digest(
        EmformerConfig(compute_dtype=torch.bfloat16), B_SLOTS, 0, dev,
        "A vi bf16 L=20", parts=True)
    en_digest, ms_en, en_parts = stack_digest(
        dataclasses.replace(RNNTConfig().emformer,
                            compute_dtype=torch.bfloat16), B_SLOTS, 0, dev,
        "A en bf16 L=20", parts=True)
    vi = EmformerConfig(compute_dtype=torch.bfloat16)
    int8 = {q: stack_digest(vi, B_SLOTS, 0, dev, f"A-{q} vi bf16 L=20",
                            parts=True, quant=q)
            for q in ("int8", "int8_ffn")}
    torch.cuda.empty_cache()
    emf = ASRConfig.vietnamese().encoder.emformer
    b1 = step(emf, 1, 2)
    dev_b1 = device_times(b1, 5, need="attention")[0]
    geo = (1, emf.num_layers, emf.d_model, emf.segment_length,
           emf.right_context_length, emf.max_memory_size,
           emf.left_context_length)
    b1_parts = stack_parts(b1, "A f32 B=1", geo,
                           need=("attention_kernel",) + ROW_KERNELS,
                           itemsize=4)
    model = ASRModel(seed=0, device=dev)
    wave = _speechlike(10.0, seed=3)
    model.emissions(wave)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.emissions(wave)
        runs.append(time.perf_counter() - t0)
    pkg = os.path.relpath(os.path.dirname(os.path.dirname(es.__file__)), HERE)
    def rows(p):
        return (f"row part {p['rows']['ms']:.3f} in {p['rows']['launches']}"
                f", attention {p['attention']['ms']:.3f} in "
                f"{p['attention']['launches']} (bound "
                f"{p['attention']['bound_ms']:.3f}, SDPA "
                f"{p['attention']['library_ms']:.3f})")

    def quantised(q):
        digest_q, ms_q, p = int8[q]
        return (f"A-{q} vi {ms_q:.3f} ms device, sha256 {digest_q[:16]}, "
                f"quantiser {p['quantise']['ms']:.3f} in "
                f"{p['quantise']['launches']} (bound "
                f"{p['quantise']['bound_ms']:.3f}), int8 products "
                f"{p['gemm_int8']['ms']:.3f} in {p['gemm_int8']['launches']}, "
                f"bf16 products {p['gemm']['ms']:.3f}, {rows(p)}; rows' "
                f"bound {p['rows']['bound_ms']:.3f}")

    log(f"[compare] {pkg}: A vi f32 L=20 at 512 slots {ms_512:.3f} ms device; A vi bf16 "
        f"{ms_bf16:.3f} ms device, its products "
        f"{vi_parts['gemm']['ms']:.3f}, {rows(vi_parts)}, sha256 "
        f"{digest[:16]}; A en bf16 "
        f"{ms_en:.3f} ms device, its products {en_parts['gemm']['ms']:.3f},"
        f" {rows(en_parts)}, sha256 {en_digest[:16]}; {quantised('int8')}; "
        f"{quantised('int8_ffn')}; A f32 B=1 "
        f"{dev_b1:.3f} ms device, {rows(b1_parts)}; "
        f"ASRModel {sorted(runs)[2] * 100:.3f} ms per second of audio "
        f"(median of 5)")


def kernel_b_times():
    """Kernel B's device time on the card for the package first on
    sys.path, at the VI and EN serving shapes (512 slots, MAX_T 1024,
    U=16 V=803 and U=4 V=1024, the ticks' positions, 80% of the slots
    decoding, ``append_traffic`` from seed 7), beside its bytes bound
    (``append_times``).  Logs a ``[kernels] B`` line each."""
    import torch
    dev = torch.device("cuda", 0)
    for U, V in ((16, 803), (4, 1024)):
        buf, rows, pos, decode = append_traffic(
            B_SLOTS, 1024, U, V, torch.Generator().manual_seed(7), dev)
        ms, bound = append_times(buf, rows, pos, decode)
        log(f"[kernels] B U={U} V={V}: {ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us")
        del buf
        torch.cuda.empty_cache()


def kernel_d_times():
    """Kernel D's device time on the card for the package first on
    sys.path, at the VI serving shape (512 slots, inputs from seed 5), f32
    in and out and bf16 in and out, each beside one
    scaled_dot_product_attention call with the boolean mask on the same
    tensors and the bytes bound.  Logs one ``[compare] D`` line."""
    import torch
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    dev = torch.device("cuda", 0)
    q, k, v, m_m, m_kv, kw, mask = attention_inputs(
        EmformerConfig(), B_SLOTS, torch.Generator().manual_seed(5), dev)
    B, Q, D = q.shape
    H, K = kw["num_heads"], k.shape[1]
    parts = []
    for dt, isz in ((torch.float32, 4), (torch.bfloat16, 2)):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        ms = device_times(lambda: ek.emformer_attention(
            qd, kd, vd, m_m, m_kv, out_dtype=dt, **kw), 20,
            need="attention")[0]
        q4, k4, v4 = (t.view(B, -1, H, D // H).transpose(1, 2)
                      for t in (qd, kd, vd))
        lib = sdpa_ms(q4, k4, v4, mask, f"D B={B} Q={Q} K={K} {dt}")
        bound = (isz * (2 * B * Q * D + 2 * B * K * D) + 8 * B) / PEAK_BYTES
        parts.append(f"{'f32' if isz == 4 else 'bf16'} {ms * 1e3:.1f} us "
                     f"(SDPA {lib * 1e3:.1f}, bound {bound * 1e6:.1f})")
    log(f"[compare] D vi at 512 slots: {'; '.join(parts)}")


def compare(roots) -> None:
    """``attention_resources``, ``kernel_a_times``, ``kernel_b_times`` and
    ``kernel_d_times`` for the package of each checkout root in turn (a
    directory that holds ``asr_streaming_tpu_torch/``, e.g. an unpacked
    ``git archive`` of a parent, whose library reports the attention's plan
    and counts its launches), a process each with that package first on sys.path and the
    functions of this script: give them as parent, change, change,
    parent to compare two commits in one call.  Fails if a run fails."""
    here = os.path.join(HERE, "chip_smoke.py")
    for root in roots:
        root = os.path.abspath(root)
        code = (f"import importlib.util, sys\nsys.path.insert(0, {root!r})\n"
                f"spec = importlib.util.spec_from_file_location('cs', {here!r})"
                "\ncs = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(cs)\n"
                "cs.attention_resources()\ncs.kernel_a_times()\n"
                "cs.kernel_b_times()\ncs.kernel_d_times()\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, cwd=root)
        log(f"[compare] == {root} rc={r.returncode}")
        for line in (r.stdout + r.stderr).splitlines():
            if line.startswith(("[compare]", "[profile]", "[kernels]",
                                "[resources]", "[sdpa]")) or \
                    r.returncode:
                log(line)
        if r.returncode:
            fail(f"the comparison run of {root} failed")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("vi", "en", "gemm", "int8", "server",
                                       "bench", "mesh", "offline", "train",
                                       "tts", "dist"),
                    default=None,
                    help="run one language's phases, the bf16 or the int8 "
                         "GEMM phase, the server phase (with the golden "
                         "phases it compares with and ECAPA's), the bench "
                         "phase, the multi-GPU serving phase (with the VI "
                         "golden phase), the offline API's phase, the "
                         "training phase, the SSL/TTS phase or the data- "
                         "and tensor-parallel training phase alone (a "
                         "partial run: the result line says so and the exit "
                         "code is 4)")
    ap.add_argument("--compare", nargs="+", metavar="ROOT",
                    help="time kernel A's steps (kernel_a_times) and B "
                         "(kernel_b_times) for the package under each "
                         "checkout root, a process each (a partial run, "
                         "exit code 4)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "asr_streaming_tpu_torch")):
        fail("asr_streaming_tpu_torch/ is not beside this script")
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    if args.compare:
        compare(args.compare)
        sys.exit(4)
    device = torch.device("cuda", 0)
    import asr_streaming_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from asr_streaming_tpu_torch.ops import _cuda
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    vi, en = args.only in (None, "vi"), args.only in (None, "en")
    server = args.only in (None, "server")
    mesh, offline = args.only in (None, "mesh"), args.only in (None, "offline")
    train, tts = args.only in (None, "train"), args.only in (None, "tts")
    dist = args.only in (None, "dist")
    if args.only in ("gemm", "int8"):
        (phase_gemm if args.only == "gemm" else phase_int8)(gen, device)
        sys.exit(4)

    # the paths: each driven with the counts set to 0 just before it and
    # read just after; the worker phases add their child's counts
    totals = {k: 0 for k in _cuda.COUNTERS}

    def path(fn, *fargs):
        _cuda.launch_counts(reset=True)
        t0 = time.perf_counter()
        out = fn(*fargs)
        for k, v in _cuda.launch_counts().items():
            totals[k] += v
        log(f"[time] {fn.__name__} {time.perf_counter() - t0:.1f} s (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    if args.only in (None, "bench"):
        # first, while nothing else has run in this process: run after
        # the other phases, the bench's chained steps took 12.6 ms each on
        # an H100 80GB HBM3 at 700 W, against 8.7-9.2 ms in a process of
        # its own (cause not isolated)
        path(phase_bench, device, card)
        torch.cuda.empty_cache()
    kernels = phase_kernels(gen, device) if vi else []
    if en:
        phase_kernels_en(gen, device, kernels)
    if vi or en:
        gemm, gemm_f32 = phase_gemm(gen, device)
        int8 = phase_int8(gen, device)
        for k in kernels:
            if k["name"] == "emformer_stack":
                k["gemm"] = gemm
                k["gemm_f32"] = gemm_f32
            if k["name"] == "emformer_stack_int8":
                k["int8"] = int8
                k["parts"]["quantise"].update(quantiser_step(gen, device))

    if vi:
        params, cfg = path(phase_serving, gen, device)
        p50 = path(phase_scheduler, params, cfg, device)
        # each route is a path of its own (counts zeroed and read around it)
        add(phase_routes(params, gen, device))
        del params
        torch.cuda.empty_cache()
        add(path(phase_worker, args.seed, p50, device))
    if vi or server or mesh:
        launches, vi_want = path(phase_golden, device)
        add(launches)
    if en:
        params = path(phase_en_serving, args.seed, gen, device)
        add(path(phase_en_scheduler, params, args.seed, device))
        del params
        torch.cuda.empty_cache()
    if en or server:
        launches, en_want = path(phase_en_golden, device)
        add(launches)
    if server:
        phase_ecapa(device, card, args.seed)
        torch.cuda.empty_cache()
        # the worker's and the server subprocesses' counts come back
        launches, _ = phase_server(device, card, vi_want, en_want, path)
        add(launches)
    if mesh:
        torch.cuda.empty_cache()
        # the CLI's server process reports its own counts
        add(path(phase_mesh, args.seed, device, card, vi_want))
    if offline:
        torch.cuda.empty_cache()
        a_offline = offline_kernel_checks(gen, device)
        for k in kernels:
            if k["name"] == "emformer_stack":
                k.update(a_offline)
        path(phase_offline, args.seed, device, card)
    if train:
        torch.cuda.empty_cache()
        path(phase_train, args.seed, device, card)
    if tts:
        torch.cuda.empty_cache()
        # the manifest CLI's process reports its own counts
        add(path(phase_tts, args.seed, device, card))
    if dist:
        torch.cuda.empty_cache()
        path(phase_dist, args.seed, device, card)
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["launches"] == 0 and args.only is None:
            fail(f"kernel {k['name']} was not launched on any path")
    log(f"[launches] {totals}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": args.only is None, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    if args.only is not None:
        sys.exit(4)


if __name__ == "__main__":
    main()
