"""Time kernel A's bf16 GEMM (the ping-pong epilogue) against a variant
whose epilogue leaves by an asynchronous TMA store, on the CUDA card.

The shipped kernel (``csrc/emformer_stack.cu``, ``gemm90::gemm_body``,
through ``ops/emformer_stack.py::gemm_bf16``) gives each of a block's two
consumer warpgroups whole tiles in turn, so that one warpgroup's epilogue
(bias, rounding, activation, stores) runs while the other's wgmma do.  The
variant built here (``tma_store_kernel`` below, compiled in one unit with
the shipped source, whose ring, producer, main loop and activation table
it reuses) is the other way to take the epilogue off the tensor cores'
path: both warpgroups on one 128 x 256 tile (64 rows each), as the
kernel was before on its largest tile, but an epilogue of one pass that
applies the activation in registers (the shipped kernel's table
lookups) while it writes the tile into a 128-byte-swizzled output tile,
a proxy fence, and one thread's ``cp.async.bulk.tensor`` stores of it; the
warpgroups go back to their wgmma at once.  The tile is written again
only once those stores have read it (``cp.async.bulk.wait_group.read``),
a whole main loop later: a second buffer, which would not fit beside a
ring of three stages, would not be waited on.

Both give the same bits (each output's sum runs over the same wgmma k
steps in order; the same epilogue_v<bf16> and table): the script checks
that, then times each of the ten serving products (VI and EN, 512 slots),
shipped, variant, variant, shipped, device us per launch from
torch.profiler, and the shipped kernel's main loop alone
(``main_loop_only``).  Needs the card and nvcc, and raises without them.

  python -m asr_streaming_tpu_torch.tools.gemm_epilogue
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
#include "emformer_stack.cu"

namespace {
namespace variant {
using namespace gemm90;

constexpr int BM = 128, BN = 256, ST = 3;
constexpr uint32_t kStageA = BM * kBK * 2, kStageB = BN * kBK * 2, kTile = BM * BN * 2;

// D[64 x 256] += A[64 x 16] . B[256 x 16]^T, both K-major in shared
// memory (the shipped kernel's tiles are 128 columns wide)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

constexpr size_t smem_bytes() {
  return (size_t)ST * (kStageA + kStageB) + kTile + kLutEntries * sizeof(uint16_t) +
         kConsumers * kEpBytes + 2 * ST * sizeof(uint64_t) + 1024;
}

// the epilogue in one pass: a warpgroup's 64 rows of accumulators to
// round(v) + bias, then the activation (the shipped table lookups), into
// the swizzled tile
__device__ __forceinline__ void stage_act(const float (&d)[BN / 2], unsigned char* tile, int r0,
                                          const unsigned char* ep, int act, const uint16_t* lut,
                                          const uint16_t* table) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int rl = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = 8 * j + 2 * q;
    const __nv_bfloat162 bb = reinterpret_cast<const __nv_bfloat162*>(ep)[nl / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w = attn_core::pack_bf16x2(
          epilogue_v<bf16>(d[4 * j + 2 * h], __low2float(bb), ACT_NONE),
          epilogue_v<bf16>(d[4 * j + 2 * h + 1], __high2float(bb), ACT_NONE));
      if (act != ACT_NONE) w = act_pair(w, act, lut, table);
      *reinterpret_cast<uint32_t*>(tile + out_offset<BM>(rl + 8 * h, nl)) = w;
    }
  }
}

// both consumer warpgroups on one 128 x 256 tile, 64 rows each; one pass
// into the output tile, then TMA stores, and straight back to the next
// tile's wgmma
__global__ void __launch_bounds__(kGemmThreads, 1)
tma_store_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                 const __grid_constant__ CUtensorMap tma_c, const bf16* __restrict__ bias, int M,
                 int N, int K, int act) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* sa = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* sb = sa + ST * kStageA;
  unsigned char* ct = sb + ST * kStageB;
  uint16_t* lut = reinterpret_cast<uint16_t*>(ct + kTile);
  unsigned char* eps = reinterpret_cast<unsigned char*>(lut + kLutEntries);
  uint64_t* full = reinterpret_cast<uint64_t*>(eps + kConsumers * kEpBytes);
  uint64_t* empty = full + ST;
  const int n_tiles = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * n_tiles;
  const int nk = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4 * kConsumers) {
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(&empty[s], ((it / ST) + 1) & 1);
          mbar_expect_tx(&full[s], kStageA + kStageB);
          tma_load_3d(sa + s * kStageA, &tma_a, &full[s], kt * kBK, m0, 0);
          tma_load_3d(sb + s * kStageB, &tma_b, &full[s], kt * kBK, n0, 0);
        }
      }
    }
    return;
  }
  const uint16_t* table = g_act_table[act == ACT_SILU ? 1 : 0];
  if (act == ACT_GELU || act == ACT_SILU) {
    load_act_lut(lut, act, threadIdx.x, kConsumers * 128);
    bar_sync(1, kConsumers * 128);
  }
  const int wg = warp >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
    unsigned char* ep = eps + wg * kEpBytes;
    load_ep<BM, BN, false>(ep, bias, nullptr, nullptr, m0, n0, M, N, threadIdx.x & 127);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    fence_acc(d);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const unsigned char* a = sa + s * kStageA + wg * 64 * 128;
      const unsigned char* b = sb + s * kStageB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % ST]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (leader) mbar_arrive(&empty[(it - 1) % ST]);
    // the tile's stores of the tile before have read it
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    bar_sync(1, kConsumers * 128);
    stage_act(d, ct, wg * 64, ep, act, lut, table);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, kConsumers * 128);
    if (threadIdx.x == 0) {
      for (int bx = 0; bx < BN / 64; ++bx)
        if (n0 + 64 * bx < N) tma_store_3d(&tma_c, ct + bx * BM * 128, n0 + 64 * bx, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace variant
}  // namespace

extern "C" int tma_store_gemm(const void* x, const void* wt, const void* bias, void* y, int M,
                              int N, int K, int act, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || M <= 0 || act < 0 || act > ACT_SILU) return kErrShape;
  const GemmSetup& s = gemm_setup();
  CHECK_RC(s.status);
  static std::once_flag once;
  static int attr = 0;
  std::call_once(once, [] {
    attr = (int)cudaFuncSetAttribute(variant::tma_store_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)variant::smem_bytes());
  });
  CHECK_RC(attr);
  CUtensorMap ta, tb, tc;
  CHECK_RC(tensor_map(&ta, x, K, M, 1, variant::BM, 2));
  CHECK_RC(tensor_map(&tb, wt, K, N, 1, variant::BN, 2));
  CHECK_RC(tensor_map(&tc, y, N, M, 1, variant::BM, 2));
  const long tiles = (long)((M + variant::BM - 1) / variant::BM) * ((N + variant::BN - 1) / variant::BN);
  const int grid = (int)(tiles < s.sms ? tiles : s.sms);
  variant::tma_store_kernel<<<grid, gemm90::kGemmThreads, variant::smem_bytes(),
                              (cudaStream_t)stream>>>(ta, tb, tc, (const bf16*)bias, M, N, K, act);
  return (int)cudaGetLastError();
}
"""

# the ten serving products at 512 slots, (rows, K, N, activation): VI
# (Q = 21 queries, 24 key rows, 20 frames) and EN (5 each, no memory)
SHAPES = {
    "vi q": (10752, 512, 512, None), "vi kv": (12288, 512, 1024, None),
    "vi out": (10752, 512, 512, None), "vi ffn1": (10240, 512, 2048, "gelu"),
    "vi ffn2": (10240, 2048, 512, None),
    "en q": (2560, 512, 512, None), "en kv": (2560, 512, 1024, None),
    "en out": (2560, 512, 512, None), "en ffn1": (2560, 512, 2048, "gelu"),
    "en ffn2": (2560, 2048, 512, None),
}
_ACTS = {None: 0, "relu": 1, "gelu": 2, "silu": 3}


def _library() -> ctypes.CDLL:
    """The variant with the shipped source, built with the package's nvcc
    flags into ``_build/``."""
    from asr_streaming_tpu_torch.ops import _cuda
    tag = hashlib.sha256((_SOURCE + " ".join(_cuda.NVCC_FLAGS)).encode())
    with open(os.path.join(_cuda.CSRC_DIR, "emformer_stack.cu"), "rb") as f:
        tag.update(f.read())
    target = os.path.join(_cuda.BUILD_DIR,
                          f"libgemm_epilogue_{tag.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
        src = target[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(_SOURCE)
        out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                              _cuda.CSRC_DIR, "-shared", "-o", target, src],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    handle = ctypes.CDLL(target)
    handle.tma_store_gemm.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    handle.tma_store_gemm.restype = ctypes.c_int
    return handle


def _kernel_us(fn: Callable, name: str, reps: int = 20) -> Tuple[float, int]:
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
    from asr_streaming_tpu_torch.ops import emformer_stack as es
    if not torch.cuda.is_available():
        raise SystemExit("gemm_epilogue needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "products": []}
    for label, (M, K, N, act) in SHAPES.items():
        x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(
            dev, torch.bfloat16)
        bias = torch.randn((N,), generator=gen).to(dev, torch.bfloat16)
        wt = es._kernel_tensor(w, torch.bfloat16, transpose=True)

        def variant():
            y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            rc = lib.tma_store_gemm(x.data_ptr(), wt.data_ptr(),
                                    bias.data_ptr(), y.data_ptr(), M, N, K,
                                    _ACTS[act], stream)
            if rc:
                raise RuntimeError(f"tma_store_gemm {label}: error {rc}")
            return y

        shipped = es.gemm_bf16(x, w, bias, act)
        got = variant()
        torch.cuda.synchronize()
        if not torch.equal(got, shipped):
            raise RuntimeError(f"{label}: the variant differs from the "
                               f"shipped kernel in {int((got != shipped).sum())}"
                               f" of {got.numel()} outputs")
        fns = {"shipped": (lambda: es.gemm_bf16(x, w, bias, act),
                           "gemm_bf16_wgmma"),
               "variant": (variant, "tma_store_kernel")}
        us = {}
        for name in ("shipped", "variant", "variant", "shipped"):
            fn, kernel = fns[name]
            us.setdefault(name, []).append(_kernel_us(fn, kernel)[0])
        main_loop = _kernel_us(lambda: es.gemm_bf16(
            x, w, bias, act, main_loop_only=True), "gemm_bf16_wgmma")[0]
        tile = "%dx%d" % es.GEMM_TILES[es.gemm_config(M, N)]
        entry = {"product": label, "m": M, "k": K, "n": N, "act": act,
                 "tile": tile, "main_loop_us": main_loop, **us}
        result["products"].append(entry)
        print(f"{label} {M}x{K}x{N}{' +' + act if act else ''}: shipped "
              f"(ping-pong, {tile}) "
              f"{' / '.join(f'{t:.2f}' for t in us['shipped'])} us (main "
              f"loop alone {main_loop:.2f}), variant (TMA store, 128x256) "
              f"{' / '.join(f'{t:.2f}' for t in us['variant'])} us; equal "
              f"bits")
        del x, w, wt
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
