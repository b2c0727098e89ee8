// Row-wise top-k with the lax.top_k contract, hand-written for Hopper
// (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_topk.py::pallas_row_topk (Pallas
// body _topk_kernel).  For every row of x [R, N] (f32) it returns the k
// largest values in descending order and their indices (int32), ties to
// the lowest index: the RNNT beam's per-hypothesis candidate preselect,
// [512 * 10, 4097] log-prob rows with k = 10, and its two narrow top-10
// selections over [512, 100] and [512, 50] tables.  The Pallas program's
// 128-lane output padding and its row tiles are TPU tiling rules and are
// not carried over: the outputs are [R, k].
//
// Domain: finite f32 and -inf; NaN is not supported.  Every selection
// orders (value descending, index ascending) and removes a pick by its
// POSITION, never by a value sentinel, so a row that holds -inf (or the
// beam's -1e30 dead slots, all tied) is selected exactly as
// ops/topk.py::iter_topk selects it.  -0.0 and +0.0 compare equal, as in
// iter_topk.
//
// What bounds it on this card: bytes.  The beam shape reads 83.9 MB once
// (~25 us at 3.35 TB/s) and writes 0.4 MB; the narrow tables are a few
// hundred KB (launch and latency bound).
//
// What the design does about it: three kernels by shape.
// - Wide rows, k <= 16 (row_topk_wide_kernel, the beam's preselect): one
//   warp a row, four rows a block, no shared memory and no block barrier.
//   The row start is only 4-byte aligned (4097 floats a row), so up to
//   three head and three tail values are peeled off and the body is read
//   in chunks of 1,024 values as 16-byte vectors, eight a lane in flight
//   (4 KB a warp, tens of KB an SM), held in registers.  The first chunk
//   gives a threshold: the k-th largest of the lanes' two largest values
//   is a value that at least k of the row's values reach, so nothing
//   below it can be in the row's top k.  The values that pass it (a few a
//   chunk) go into each lane's sorted list in registers, through one
//   insertion site.  The 32 lists then merge in k warp rounds (a max and
//   a min over the lanes), round r's pick landing in lane r.  The lists
//   hold 4 entries, enough unless one lane owns more than 4 of the top k;
//   a warp that cannot rule that out (a lane lost a value and its last
//   entry is among the picks) walks its row again with lists of k entries
//   (k <= 16; rare on the beam's rows, every row of ties in the worst
//   case).
// - Narrow rows, N <= 256 (row_topk_narrow_kernel, the beam's tables):
//   one warp a row, four rows a block, up to eight values a lane in
//   registers, k warp rounds, any k <= N.
// - Wide rows with k > 16 (row_topk_block_kernel, not on the beam's path):
//   one block a row staged in shared memory, k block-wide rounds (rows up
//   to 46,000 wide).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0x7fffffff;       // "no candidate" index

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

// An unsigned key in the order of the float values (-0.0 taken as +0.0);
// 0 means "no value" and is below every key of a value (NaN excluded).
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t b = __float_as_uint(v + 0.f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the lowest index among the lanes whose key is the warp's largest: the
// warp's first pick in (value descending, index ascending) order
__device__ __forceinline__ void warp_pick(uint32_t key, int idx, uint32_t& best_key,
                                          int& best_idx) {
  best_key = __reduce_max_sync(0xffffffffu, key);
  best_idx = (int)__reduce_min_sync(0xffffffffu,
                                    key == best_key ? (uint32_t)idx : (uint32_t)kNone);
}

// ---------------------------------------------------------------- wide rows

constexpr int kWideRows = 4;            // rows (warps) a block
constexpr int kVecs = 8;                // 16-byte vectors a lane a chunk

// insert c into the sorted list L (the last entry falls off)
template <int KL>
__device__ __forceinline__ void list_insert(Cand (&L)[KL], const Cand& c) {
#pragma unroll
  for (int i = KL - 1; i >= 0; --i)
    if (before(c, L[i])) L[i] = (i > 0 && before(c, L[i - 1])) ? L[i - 1] : c;
}

// the value of a key of key_of (-0.0 comes back as +0.0)
__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The k-th largest of the warp's 64 keys, each lane's two largest
// (a >= b): k rounds of a max over the lanes, the winning lane giving up
// its first; 0 when the warp holds fewer than k keys.
__device__ __forceinline__ uint32_t warp_kth_key(uint32_t a, uint32_t b, int k) {
  const int lane = threadIdx.x & 31;
  uint32_t m = 0;
  for (int r = 0; r < k; ++r) {
    m = __reduce_max_sync(0xffffffffu, a);
    if (m == 0) break;
    if (lane == __ffs(__ballot_sync(0xffffffffu, a == m)) - 1) {
      a = b;
      b = 0;
    }
  }
  return m;
}

// One lane's walk of the row (the body in chunks of 32 x kVecs vectors,
// the head and tail values one a lane with the first chunk): the values
// at or above `thresh` go into the lane's sorted list L.  With `first`,
// the first chunk sets thresh: the k-th largest of the lanes' two largest
// values, a value that k of the row's values reach.  Returns whether a
// passing value was lost: kept out of, or pushed off, a full list (every
// lost value comes after the list's last entry).
template <int KL>
__device__ __forceinline__ bool scan_row(const float* __restrict__ src, int N, int k,
                                         bool first, float& thresh, Cand (&L)[KL]) {
  const int lane = threadIdx.x & 31;
  // the peel: head values up to the first 16-byte boundary, the body in
  // vectors, the tail (each at most three values)
  const int head = min(N, (int)((16u - ((uint32_t)(uintptr_t)src & 15u)) & 15u) >> 2);
  const int nvec = (N - head) >> 2, tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(src + head);
  const float neg_inf = __int_as_float(0xff800000);
  bool lost = false;
#pragma unroll
  for (int i = 0; i < KL; ++i) L[i] = Cand{0.f, kNone};
  for (int v0 = 0; v0 < nvec || v0 == 0; v0 += 32 * kVecs) {
    float4 f[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = v0 + 32 * j + lane;
      f[j] = v < nvec ? __ldg(body + v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float e = neg_inf;
    int ei = -1;
    if (v0 == 0) {
      if (lane < head) ei = lane;
      else if (lane - head < N - tail0) ei = tail0 + lane - head;
      if (ei >= 0) e = src[ei];
    }
    if (first && v0 == 0) {
      // this lane's two largest values
      float m1 = e, m2 = neg_inf;
      int cnt = ei >= 0;
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        if (32 * j + lane < nvec) {
          const float w[4] = {f[j].x, f[j].y, f[j].z, f[j].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            m2 = fmaxf(m2, fminf(m1, w[u]));
            m1 = fmaxf(m1, w[u]);
          }
          cnt += 4;
        }
      const uint32_t kth = warp_kth_key(cnt >= 1 ? key_of(m1) : 0u,
                                        cnt >= 2 ? key_of(m2) : 0u, k);
      if (kth != 0) thresh = value_of(kth);
    }
    // the values that pass, bit 4j + c of vector j's component c and bit
    // 32 for the head or tail value; then one insertion site for the few
    // that do (an insertion inlined for each of the 33 values swamped the
    // instruction cache)
    uint32_t pass = 0;
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (v0 + 32 * j + lane < nvec)
        pass |= ((uint32_t)(f[j].x >= thresh) | (uint32_t)(f[j].y >= thresh) << 1 |
                 (uint32_t)(f[j].z >= thresh) << 2 | (uint32_t)(f[j].w >= thresh) << 3)
                << (4 * j);
    uint64_t todo = pass | (ei >= 0 && e >= thresh ? 1ull << 32 : 0ull);
    while (todo) {
      const int s = __ffsll((long long)todo) - 1;
      todo &= todo - 1;
      Cand c{e, ei};
      if (s < 32) {
        // read again (from L1): picking it from the registers by s put
        // the chunk in local memory
        c.i = head + 4 * (v0 + 32 * (s >> 2) + lane) + (s & 3);
        c.v = __ldg(src + c.i);
      }
      // a full list loses a passing value: c or its own last entry
      lost |= L[KL - 1].i != kNone;
      if (before(c, L[KL - 1])) list_insert(L, c);
    }
  }
  return lost;
}

// The warp's first k in (value descending, index ascending) order from
// the 32 sorted lists, k rounds of a max and a min over the lanes' heads:
// round r's pick lands in lane r (`mine`), the winning lane drops its
// head.  Returns the number of rounds that found a value.
template <int KL>
__device__ __forceinline__ int merge_lists(Cand (&L)[KL], int k, Cand& mine, Cand& last) {
  const int lane = threadIdx.x & 31;
  mine = Cand{0.f, kNone};
  int r = 0;
  for (; r < k; ++r) {
    uint32_t bk;
    int bi;
    warp_pick(L[0].i == kNone ? 0u : key_of(L[0].v), L[0].i, bk, bi);
    if (bk == 0) break;
    const bool win = L[0].i == bi;
    last = Cand{__shfl_sync(0xffffffffu, L[0].v, __ffs(__ballot_sync(0xffffffffu, win)) - 1),
                bi};
    if (lane == r) mine = last;
    if (win) {
#pragma unroll
      for (int i = 0; i < KL - 1; ++i) L[i] = L[i + 1];
      L[KL - 1] = Cand{0.f, kNone};
    }
  }
  return r;
}

// Lists of KS entries first.  A lane that lost values could have lost one
// of the row's top k only if its own last entry is among them (a lost
// value comes after it); a warp with such a lane (or with fewer than k
// picks) walks the row again with lists of KB >= k entries, which hold
// every top-k value a lane owns.
template <int KS, int KB>
__global__ void __launch_bounds__(32 * kWideRows)
row_topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int32_t* __restrict__ idx, int R, int N, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWideRows + (threadIdx.x >> 5);
  if (row >= R) return;                 // a whole warp leaves
  const float* src = x + (size_t)row * N;
  float thresh = __int_as_float(0xff800000);
  Cand mine, kth{0.f, kNone};
  bool redo = true;
  if (KS < KB) {
    Cand L[KS];
    const bool lost = scan_row(src, N, k, true, thresh, L);
    const Cand own_last = L[KS - 1];
    const int got = merge_lists(L, k, mine, kth);
    redo = __any_sync(0xffffffffu, lost && !before(kth, own_last)) || got < k;
  }
  if (redo) {
    Cand L[KB];
    scan_row(src, N, k, KS == KB, thresh, L);
    merge_lists(L, k, mine, kth);
  }
  if (lane < k) {
    vals[(size_t)row * k + lane] = mine.v;
    idx[(size_t)row * k + lane] = mine.i;
  }
}

// -------------------------------------------------------------- narrow rows

constexpr int kNarrowPerLane = 8, kNarrowMaxN = 32 * kNarrowPerLane;
constexpr int kNarrowRows = 4;          // rows (warps) a block

__global__ void __launch_bounds__(32 * kNarrowRows)
row_topk_narrow_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int32_t* __restrict__ idx, int R, int N, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNarrowRows + (threadIdx.x >> 5);
  if (row >= R) return;                 // a whole warp leaves
  const float* src = x + (size_t)row * N;
  float v[kNarrowPerLane];
  uint32_t live = 0;                    // bit s: value s of this lane not taken
#pragma unroll
  for (int s = 0; s < kNarrowPerLane; ++s) {
    const int j = s * 32 + lane;
    v[s] = j < N ? src[j] : 0.f;
    if (j < N) live |= 1u << s;
  }
  // this lane's best: the first of its largest (lanes' values in index order)
  auto lane_best = [&](uint32_t& key, int& at) {
    key = 0;
    at = kNone;
#pragma unroll
    for (int s = 0; s < kNarrowPerLane; ++s)
      if ((live >> s) & 1u) {
        const uint32_t kk = key_of(v[s]);
        if (kk > key) {
          key = kk;
          at = s * 32 + lane;
        }
      }
  };
  uint32_t key;
  int at;
  lane_best(key, at);
  for (int r = 0; r < k; ++r) {
    uint32_t bk;
    int bi;
    warp_pick(key, at, bk, bi);
    if (bk == 0) break;                 // (k <= N: not reached)
    if (at == bi) {                     // the winning lane
      float bv = 0.f;
#pragma unroll
      for (int s = 0; s < kNarrowPerLane; ++s)
        if (s * 32 + lane == bi) bv = v[s];
      vals[(size_t)row * k + r] = bv;
      idx[(size_t)row * k + r] = bi;
      live &= ~(1u << (bi >> 5));
      lane_best(key, at);
    }
  }
}

// ------------------------------------------- wide rows, k > 16 (slower path)

constexpr int kMaxWarps = 8;

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

// The row is read once, coalesced, into shared memory; while loading,
// each thread keeps the best (value, index) of the strided lanes it owns.
// A selection round is one block-wide reduction of those cached pairs and
// a rescan by the ONE thread that owned the winner of its own lanes.
__global__ void row_topk_block_kernel(const float* __restrict__ x,
                                      float* __restrict__ vals,
                                      int32_t* __restrict__ idx, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* row = reinterpret_cast<float*>(smem_raw);              // [N]
  unsigned char* taken = smem_raw + (size_t)N * sizeof(float);  // [N]
  __shared__ Cand red[2][kMaxWarps];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float* src = x + (size_t)blockIdx.x * N;

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

constexpr int kBlockMaxN = 46000;       // 5 bytes of shared memory a value

template <int KS, int KB>
cudaError_t launch_wide(const float* x, float* vals, int32_t* idx, int R, int N, int k,
                        cudaStream_t st) {
  row_topk_wide_kernel<KS, KB><<<(R + kWideRows - 1) / kWideRows, 32 * kWideRows, 0, st>>>(
      x, vals, idx, R, N, k);
  return cudaGetLastError();
}

}  // namespace

// x [R, N] f32 contiguous (rows 4-byte aligned) -> vals [R, k] f32, idx
// [R, k] int32.  N <= 256: any k <= N; wider rows: k <= 16 at any N,
// k in 17..128 for N <= 46,000.  Returns a cudaError_t code (0 =
// launched).
extern "C" int asr_row_topk(const float* x, float* vals, int32_t* idx, int R,
                            int N, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || N <= 0 || k <= 0 || k > N || k > 128 || ((uintptr_t)x & 3u))
    return (int)cudaErrorInvalidValue;
  if (N <= kNarrowMaxN) {
    row_topk_narrow_kernel<<<(R + kNarrowRows - 1) / kNarrowRows, 32 * kNarrowRows, 0, st>>>(
        x, vals, idx, R, N, k);
    return (int)cudaGetLastError();
  }
  if (k <= 4) return (int)launch_wide<4, 4>(x, vals, idx, R, N, k, st);
  if (k <= 8) return (int)launch_wide<4, 8>(x, vals, idx, R, N, k, st);
  if (k <= 12) return (int)launch_wide<4, 12>(x, vals, idx, R, N, k, st);
  if (k <= 16) return (int)launch_wide<4, 16>(x, vals, idx, R, N, k, st);
  if (N > kBlockMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_topk_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  row_topk_block_kernel<<<R, N <= 1024 ? 128 : 256, smem, st>>>(x, vals, idx, N, k);
  return (int)cudaGetLastError();
}
