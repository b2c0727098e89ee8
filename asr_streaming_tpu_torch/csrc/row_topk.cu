// Row-wise top-k with the lax.top_k contract, hand-written for Hopper
// (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_topk.py::pallas_row_topk (Pallas
// body _topk_kernel).  For every row of x [R, N] (f32) it returns the k
// largest values in descending order and their indices (int32), ties to
// the lowest index: the RNNT beam's per-hypothesis candidate preselect,
// [512 * 10, 4097] log-prob rows with k = 10.  The Pallas program's
// 128-lane output padding and its row tiles are TPU tiling rules and are
// not carried over: the outputs are [R, k].
//
// Domain: finite f32 and -inf; NaN is not supported.  Picks are knocked
// out by POSITION (a byte flag beside each value), not by a value
// sentinel, so a row that holds -inf (or the beam's -1e30 dead slots, all
// tied) is selected exactly as ops/topk.py::iter_topk selects it.
//
// What bounds it on this card: bytes.  The beam shape reads 83.9 MB once
// (~25 us at 3.35 TB/s) and writes 0.4 MB.
//
// What the design does about it: one block per row.  The row is read from
// device memory once, coalesced, into shared memory; while loading, each
// thread keeps the best (value, index) of the strided lanes it owns.  A
// selection round is then one block-wide reduction of those cached pairs
// in the order (value descending, index ascending) and a rescan by the
// ONE thread that owned the winner of its own N / threads lanes; the other
// threads' cached pairs stay valid.  k rounds touch shared memory only.
// Rows up to 46,000 wide fit (5 bytes of shared memory per value).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0x7fffffff;       // "no candidate" index
constexpr int kMaxWarps = 8;

struct Cand {
  float v;
  int i;
};

// does a come before b in (value descending, index ascending) order?
__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  if (a.i == kNone) return false;
  if (b.i == kNone) return true;
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
    if (before(o, c)) c = o;
  }
  return c;
}

__global__ void row_topk_kernel(const float* __restrict__ x,
                                float* __restrict__ vals,
                                int32_t* __restrict__ idx, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* row = reinterpret_cast<float*>(smem_raw);              // [N]
  unsigned char* taken = smem_raw + (size_t)N * sizeof(float);  // [N]
  __shared__ Cand red[2][kMaxWarps];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float* src = x + (size_t)blockIdx.x * N;

  // one coalesced pass: stage the row, keep this thread's best lane
  Cand mine{0.f, kNone};
  for (int j = tid; j < N; j += nt) {
    const float v = src[j];
    row[j] = v;
    taken[j] = 0;
    if (mine.i == kNone || v > mine.v) mine = Cand{v, j};   // first wins ties
  }

  for (int r = 0; r < k; ++r) {
    Cand c = warp_best(mine);
    if (lane == 0) red[r & 1][warp] = c;
    __syncthreads();
    Cand best = red[r & 1][0];
    for (int w = 1; w < nw; ++w) {
      const Cand o = red[r & 1][w];
      if (before(o, best)) best = o;
    }
    if (tid == 0) {
      vals[(size_t)blockIdx.x * k + r] = best.v;
      idx[(size_t)blockIdx.x * k + r] = best.i;
    }
    // the owner of the winner knocks it out and rescans its own lanes
    if (best.i != kNone && best.i % nt == tid) {
      taken[best.i] = 1;
      mine = Cand{0.f, kNone};
      for (int j = tid; j < N; j += nt) {
        const float v = row[j];
        if (!taken[j] && (mine.i == kNone || v > mine.v)) mine = Cand{v, j};
      }
    }
  }
}

}  // namespace

// x [R, N] f32 contiguous -> vals [R, k] f32, idx [R, k] int32.
// Returns a cudaError_t code (0 = launched).
extern "C" int asr_row_topk(const float* x, float* vals, int32_t* idx, int R,
                            int N, int k, void* stream) {
  if (R <= 0 || N <= 0 || k <= 0 || k > N) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * (sizeof(float) + 1);
  if (smem > 232448 - 256) return (int)cudaErrorInvalidValue;  // 227 KB less `red`
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // narrow rows (the beam's flat [B, W * kcap] tables) take one warp
  const int threads = N <= 256 ? 32 : (N <= 1024 ? 128 : 256);
  row_topk_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(x, vals, idx, N, k);
  return (int)cudaGetLastError();
}
