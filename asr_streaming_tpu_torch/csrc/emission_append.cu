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
// writes 13 MB of f16 into an 842 MB buffer: ~12 us at 3.35 TB/s.
//
// What the design does about it: one block per (slot, row); a slot that
// does not decode exits before touching memory, so the traffic is only
// the decoding slots' rows.  Threads walk the row with unit stride, so
// both the f32 reads and the f16 writes are coalesced.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__global__ void emission_append_kernel(__half* __restrict__ buf,
                                       const float* __restrict__ rows,
                                       const int32_t* __restrict__ pos,
                                       const uint8_t* __restrict__ decode,
                                       int max_t, int U, int V) {
  const int b = blockIdx.x, u = blockIdx.y;
  if (!decode[b]) return;
  const int p = pos[b];
  // callers clip pos into [0, MAX_T - U]; anything else writes nothing
  if (p < 0 || p > max_t - U) return;
  const float* src = rows + ((size_t)b * U + u) * V;
  __half* dst = buf + ((size_t)b * max_t + p + u) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) dst[v] = __float2half_rn(src[v]);
}

}  // namespace

extern "C" int asr_emission_append(void* buf, const float* rows, const int32_t* pos,
                                   const uint8_t* decode, int B, int max_t, int U,
                                   int V, void* stream) {
  if (B <= 0 || U <= 0 || V <= 0 || U > max_t) return (int)cudaErrorInvalidValue;
  emission_append_kernel<<<dim3(B, U), 256, 0, (cudaStream_t)stream>>>(
      (__half*)buf, rows, pos, decode, max_t, U, V);
  return (int)cudaGetLastError();
}
