// In-place per-slot emission append, hand-written for Hopper (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_append.py::emission_append
// (Pallas body _append_kernel).  For every slot with decode[b]:
//     buf[b, pos[b] + u, :] = half(rows[b, u, :])      for u < U
// and no other row of the [B, MAX_T, V] buffer is touched.  The buffer is
// native float16 here: the JAX package packs f16 pairs into f32 words only
// because Mosaic has no f16 lanes, and its lcm(U, 8) block constraint is a
// TPU tiling rule; neither is carried over.  f32 -> f16 rounds to nearest
// even (__float2half_rn), as torch's .to(float16) does.
//
// What bounds it on this card: bytes.  At the Vietnamese serving shape
// (B=512 slots, U=16 rows, V=803) a tick reads 26 MB of f32 rows and
// writes 13 MB of f16 into an 842 MB buffer: ~12 us at 3.35 TB/s (the
// decoding slots' share of it, ~80%, in a tick).
//
// What the design does about it: a slot's U destination rows follow one
// another in buf, and its source rows in rows, so each decoding slot is
// one contiguous run of U * V values on both sides.  A run is split over
// blocks of kAppendPerBlock values (grid: blocks a run by slots), a
// thread moving groups of 8 values: two 16-byte f32 loads and one 16-byte
// f16 store.  The run's head, up to buf's first 16-byte boundary, and its
// tail (under a group) go a value at a time in the run's first block;
// where the source is then not 16-byte aligned (an odd V * U, say) the
// groups load their values one by one and still store 16 bytes.  A slot
// that does not decode, or whose pos lies outside [0, MAX_T - U], reads
// its flags and writes nothing.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kAppendThreads = 256;
constexpr int kAppendGroup = 8;       // values a thread moves at once
constexpr int kAppendGroups = 2;      // groups a thread
constexpr int kAppendPerBlock = kAppendThreads * kAppendGroup * kAppendGroups;

__global__ void __launch_bounds__(kAppendThreads)
emission_append_kernel(__half* __restrict__ buf, const float* __restrict__ rows,
                       const int32_t* __restrict__ pos, const uint8_t* __restrict__ decode,
                       int max_t, int U, int V) {
  const int b = blockIdx.y;
  // both flags read at once (one memory round trip before the run's loads)
  const int p = pos[b];
  const bool dec = decode[b] != 0;
  // callers clip pos into [0, MAX_T - U]; anything else writes nothing
  if (!dec || p < 0 || p > max_t - U) return;
  const long n = (long)U * V;
  const float* src = rows + (size_t)b * n;
  __half* dst = buf + ((size_t)b * max_t + p) * V;
  const long to16 = (long)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(__half));
  const long head = to16 < n ? to16 : n;
  const long groups = (n - head) / kAppendGroup;
  const float* gsrc = src + head;
  __half* gdst = dst + head;
  const bool vec = ((uintptr_t)gsrc & 15) == 0;

  float v[kAppendGroups][kAppendGroup];
#pragma unroll
  for (int k = 0; k < kAppendGroups; ++k) {
    const long g = ((long)blockIdx.x * kAppendGroups + k) * kAppendThreads + threadIdx.x;
    if (g >= groups) continue;
    const float* s = gsrc + g * kAppendGroup;
    if (vec) {
      const float4 lo = reinterpret_cast<const float4*>(s)[0];
      const float4 hi = reinterpret_cast<const float4*>(s)[1];
      v[k][0] = lo.x; v[k][1] = lo.y; v[k][2] = lo.z; v[k][3] = lo.w;
      v[k][4] = hi.x; v[k][5] = hi.y; v[k][6] = hi.z; v[k][7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < kAppendGroup; ++e) v[k][e] = s[e];
    }
  }
#pragma unroll
  for (int k = 0; k < kAppendGroups; ++k) {
    const long g = ((long)blockIdx.x * kAppendGroups + k) * kAppendThreads + threadIdx.x;
    if (g >= groups) continue;
    uint32_t w[kAppendGroup / 2];
#pragma unroll
    for (int j = 0; j < kAppendGroup / 2; ++j) {
      const __half2 h = __floats2half2_rn(v[k][2 * j], v[k][2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(gdst)[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (blockIdx.x != 0) return;
  // the head, and the tail after the last whole group
  const long tail = head + groups * kAppendGroup;
  if (threadIdx.x < head) dst[threadIdx.x] = __float2half_rn(src[threadIdx.x]);
  if (tail + threadIdx.x < n) dst[tail + threadIdx.x] = __float2half_rn(src[tail + threadIdx.x]);
}

}  // namespace

extern "C" int asr_emission_append(void* buf, const float* rows, const int32_t* pos,
                                   const uint8_t* decode, int B, int max_t, int U,
                                   int V, void* stream) {
  if (B <= 0 || B > 65535 || U <= 0 || V <= 0 || U > max_t) return (int)cudaErrorInvalidValue;
  const long n = (long)U * V;
  const dim3 grid((unsigned)((n + kAppendPerBlock - 1) / kAppendPerBlock), (unsigned)B);
  emission_append_kernel<<<grid, kAppendThreads, 0, (cudaStream_t)stream>>>(
      (__half*)buf, rows, pos, decode, max_t, U, V);
  return (int)cudaGetLastError();
}
