"""Time A's f32 split-K product against a variant whose weights stream
through a cp.async ring in shared memory, on the CUDA card.

The shipped kernel (``csrc/emformer_stack.cu``, ``gemm_f32_splitk_kernel``,
through ``ops/emformer_stack.py::gemm_f32``) loads each lane's weights
from global memory straight into registers.  The variant built here
(``ring_kernel`` below) keeps everything else the same: the grid (N tiles
of 32 columns times the K slices ``gemm_f32_config`` picks), the rows'
slice in shared memory, the warps' sums and the split-K reduction.  Only
the weights' path differs: the block's [k_slice, 32] tile of W streams
into shared memory as 16-byte ``cp.async`` copies along N, in stages of
32 rows of K (one commit group each, all in flight at once), and each
warp takes 4 rows of every stage into registers as the stage lands, so
that the FMAs of one stage overlap the copies of the next; each row's
running sum lives in shared memory between stages.

Each product of a VI step at B = 1 and B = 3 (the offline API's shapes)
runs once on each of 20 layers' own weights (as in a step: 251.7 MB of
weights at B = 1, more than the L2 holds), shipped, ring, ring, shipped;
device time per launch from torch.profiler.  Both are checked against
``gemm_f32_plain`` within ``gemm_f32_error_bound`` first.  Needs the card
and nvcc, and raises without them.

  python -m asr_streaming_tpu_torch.tools.gemm_f32_ring
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from typing import Callable, Tuple

import torch

_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256, kWarps = 8, kTileN = 32, kStageK = 32, kMaxSplits = 16;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// wait until at most n of this thread's commit groups are in flight
__device__ __forceinline__ void wait_pending(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::);
  else asm volatile("cp.async.wait_group 3;\n" ::);
}

// C [M, N] = A [M, K] . W [K, N] + bias, k_slice a multiple of kStageK up
// to 4 kStageK; ws [splits, M, N] and tiles [N / 32] as the shipped kernel
__global__ void __launch_bounds__(kThreads)
ring_kernel(const float* __restrict__ A, const float* __restrict__ W,
            const float* __restrict__ bias, float* __restrict__ C, float* __restrict__ ws,
            int* __restrict__ tiles, int M, int N, int K, int k_slice) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                          // [M][k_slice]
  float* w_s = a_s + M * k_slice;             // [k_slice][kTileN]: the ring's stages
  float* sums = w_s + k_slice * kTileN;       // [kWarps][M][kTileN]
  __shared__ int last;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * kTileN, k0 = split * k_slice, stages = k_slice / kStageK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // group 0: the rows' slice (zero past K)
  for (int i = tid; i < M * (k_slice / 4); i += kThreads) {
    const int m = i / (k_slice / 4), k = 4 * (i % (k_slice / 4));
    const bool ok = k0 + k < K;
    cp_async16(a_s + m * k_slice + k, ok ? A + (size_t)m * K + k0 + k : A, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // groups 1..stages: W's stages, kStageK rows of 32 columns, one 16-byte
  // copy a thread each (zero past K and N)
  for (int s = 0; s < stages; ++s) {
    const int r = s * kStageK + tid / (kTileN / 4), c = 4 * (tid % (kTileN / 4));
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(w_s + r * kTileN + c, ok ? W + (size_t)(k0 + r) * N + n0 + c : W, ok);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = tid; i < kWarps * M * kTileN; i += kThreads) sums[i] = 0.f;

  // stage by stage as it lands: this warp's 4 rows of it, every row
  for (int s = 0; s < stages; ++s) {
    wait_pending(stages - 1 - s);
    __syncthreads();
    const int kr = s * kStageK + 4 * warp;
    const float w0 = w_s[kr * kTileN + lane], w1 = w_s[(kr + 1) * kTileN + lane];
    const float w2 = w_s[(kr + 2) * kTileN + lane], w3 = w_s[(kr + 3) * kTileN + lane];
    float* acc = sums + warp * M * kTileN + lane;
    for (int m = 0; m < M; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + m * k_slice + kr);
      float v = acc[m * kTileN];
      v = fmaf(a.x, w0, v);
      v = fmaf(a.y, w1, v);
      v = fmaf(a.z, w2, v);
      v = fmaf(a.w, w3, v);
      acc[m * kTileN] = v;
    }
  }
  __syncthreads();

  // from here as the shipped kernel: the warps' sums in warp order, the
  // partial, the tile's counter and the last block's ordered sum
  for (int i = tid; i < M * kTileN; i += kThreads) {
    const int m = i / kTileN, c = i % kTileN, nn = n0 + c;
    float v = sums[m * kTileN + c];
    for (int j = 1; j < kWarps; ++j) v += sums[(j * M + m) * kTileN + c];
    if (nn >= N) continue;
    if (splits == 1)
      C[(size_t)m * N + nn] = v + bias[nn];
    else
      __stcg(ws + ((size_t)split * M + m) * N + nn, v);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tiles[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < M * kTileN / 4; e += kThreads) {
    const int m = e / (kTileN / 4), n = n0 + 4 * (e % (kTileN / 4));
    if (n >= N) continue;
    float4 p[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits)
        p[s] = __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)s * M + m) * N + n));
    float4 v = p[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s)
      if (s < splits) {
        v.x += p[s].x; v.y += p[s].y; v.z += p[s].z; v.w += p[s].w;
      }
    *reinterpret_cast<float4*>(C + (size_t)m * N + n) =
        make_float4(v.x + bias[n], v.y + bias[n + 1], v.z + bias[n + 2], v.w + bias[n + 3]);
  }
  if (tid == 0) tiles[tile] = 0;
}
}  // namespace

extern "C" int ring_gemm(const float* A, const float* W, const float* bias, float* C,
                         float* ws, int32_t* tiles, int M, int N, int K, int k_slice,
                         void* stream) {
  if (M <= 0 || N % 4 || K % 4 || k_slice <= 0 || k_slice % kStageK || k_slice > 4 * kStageK)
    return -2;
  const int splits = (K + k_slice - 1) / k_slice;
  if (splits > kMaxSplits) return -2;
  const size_t smem =
      ((size_t)M * k_slice + (size_t)k_slice * kTileN + (size_t)kWarps * M * kTileN) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ring_kernel<<<dim3((N + kTileN - 1) / kTileN, splits), kThreads, smem,
                (cudaStream_t)stream>>>(A, W, bias, C, ws, tiles, M, N, K, k_slice);
  return (int)cudaGetLastError();
}
"""


def _library() -> ctypes.CDLL:
    """The variant, built with the package's nvcc flags into ``_build/``."""
    from asr_streaming_tpu_torch.ops import _cuda
    tag = hashlib.sha256((_SOURCE + " ".join(_cuda.NVCC_FLAGS)).encode())
    target = os.path.join(_cuda.BUILD_DIR,
                          f"libgemm_f32_ring_{tag.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
        src = target[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(_SOURCE)
        out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                              "-o", target, src], capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    handle = ctypes.CDLL(target)
    handle.ring_gemm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    handle.ring_gemm.restype = ctypes.c_int
    return handle


def _kernel_us(fn: Callable, name: str, reps: int = 3) -> Tuple[float, int]:
    """(device us per launch of the kernels whose name holds ``name``,
    their launches per call of fn), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # a profile now and then holds no record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in rows)
        if n:
            t = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0) for e in rows)
            return t / n, round(n / reps)
    raise RuntimeError(f"five profiles held no {name} kernel")


def main() -> None:
    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    if not torch.cuda.is_available():
        raise SystemExit("gemm_f32_ring needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    emf = ASRConfig.vietnamese().encoder.emformer
    L, D, Fd = emf.num_layers, emf.d_model, emf.ffn_dim
    T = emf.segment_length + emf.right_context_length
    Q, NKV = T + (1 if emf.use_mem else 0), emf.max_memory_size + T
    gen = torch.Generator().manual_seed(0)
    names = ("q", "kv", "out", "ffn1", "ffn2")
    result = {"card": card, "products": []}
    for B in (1, 3):
        step = {"shipped": [0.0, 0.0], "ring": [0.0, 0.0]}
        for name, (M, N, K) in zip(names,
                                   es._product_shapes(B, Q, NKV, T, D, Fd)):
            ks = es.gemm_f32_config(M, N, K)
            splits = -(-K // ks)
            x = torch.randn((M, K), generator=gen).to(dev)
            w = (torch.randn((L, K, N), generator=gen) / K ** 0.5).to(dev)
            bias = torch.randn((N,), generator=gen).to(dev)
            y = torch.empty((M, N), device=dev)
            ws = torch.empty(splits * M * N, device=dev)
            tiles = torch.zeros(-(-N // 32), dtype=torch.int32, device=dev)

            def ring(layer):
                rc = lib.ring_gemm(x.data_ptr(), w[layer].data_ptr(),
                                   bias.data_ptr(), y.data_ptr(),
                                   ws.data_ptr(), tiles.data_ptr(), M, N, K,
                                   ks, stream)
                if rc:
                    raise RuntimeError(f"ring_gemm {M}x{K}x{N}: error {rc}")
                return y

            want = es.gemm_f32_plain(x, w[0], bias, splits=ks)
            bound = es.gemm_f32_error_bound(x, w[0], want)
            for label, got in (("shipped", es.gemm_f32(x, w[0], bias)),
                               ("ring", ring(0).clone())):
                worst = float(((got - want).abs() / bound).max())
                if not worst <= 1:
                    raise RuntimeError(f"{label} B={B} {name}: {worst:.2f} "
                                       f"x its error bound")
            fns = {"shipped": lambda: [es.gemm_f32(x, w[l], bias)
                                       for l in range(L)],
                   "ring": lambda: [ring(l) for l in range(L)]}
            kernel = {"shipped": "gemm_f32_splitk", "ring": "ring_kernel"}
            us = {}
            for i, label in enumerate(("shipped", "ring", "ring", "shipped")):
                t, n = _kernel_us(fns[label], kernel[label])
                if n != L:
                    raise RuntimeError(f"{label}: {n} launches, not {L}")
                us.setdefault(label, []).append(t)
                step[label][i // 2 if label == "shipped" else i - 1] += \
                    t * L / 1e3
            entry = {"B": B, "product": name, "m": M, "k": K, "n": N,
                     "k_slice": ks, "blocks": -(-N // 32) * splits, **us}
            result["products"].append(entry)
            print(f"B={B} {name} {M}x{K}x{N} (k-slice {ks}, "
                  f"{entry['blocks']} blocks): shipped "
                  f"{' / '.join(f'{t:.2f}' for t in us['shipped'])} us, "
                  f"ring {' / '.join(f'{t:.2f}' for t in us['ring'])} us "
                  f"a launch (mean of {L} layers)")
            del x, w, ws
            torch.cuda.empty_cache()
        result[f"b{B}_step_ms"] = step
        print(f"B={B}: a step's {5 * L} products, shipped "
              f"{step['shipped'][0]:.3f} / {step['shipped'][1]:.3f} ms, ring "
              f"{step['ring'][0]:.3f} / {step['ring'][1]:.3f} ms")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
