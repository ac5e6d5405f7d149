// Dispatch window scoring for Hopper (sm_90a): two fp32 SIMT kernels.
//
// Replaces the TPU kernels in src/repro/kernels/dispatch_score/dispatch_score.py:
//   * dispatch_score_pallas / _score_kernel (K1):
//       out[W,E] = demand[W,O] @ presence[E,O]^T
//   * dispatch_score_update_pallas / _update_kernel (K2):
//       out[W,E] = scores[W,E] + mult[W,K] @ delta[K,E]
//     (the accumulator is seeded from the resident scores, as the Pallas
//     kernel seeds its VMEM accumulator from the score tile).
//
// K1, window scoring sized to the window (score_rows_kernel).  Both operands
// are row-major along O, so every output is the dot product of two
// contiguous rows.  A block is EW warps; warp x owns executor e = EW * by + x
// and RW rows of the window, w = RW * bx .. RW * bx + RW - 1.  Each lane
// holds a strided part of the dot products and the warp sums its lanes with
// __shfl_xor_sync.  Rows are read in passes of CH = 256 elements: 16-byte
// __ldg loads (two float4 per lane and row) when O % 4 == 0 and both bases
// are 16-byte aligned, else scalar loads of the same elements (ragged O, an
// unaligned view); the last pass is masked in the kernel, nothing is padded.
// The next pass's loads are issued before the current pass's FMAs, a
// register double buffer, so at O = 256 (the serving shape: one pass) a warp
// waits on device memory once.  The grid grows with W x E: W = 8, E = 16 is
// 4 x 2 = 8 blocks, and no multiply-add falls on a masked slot.
//
// Exactness stays the contract, max|out - float64| == 0.0, in any summation
// order: demand entries are small integers and presence weights dyadic
// (0.5**tier), so every product and every partial sum is an integer multiple
// of the smallest weight, below 2**24 of those units, and therefore exact in
// fp32.  The lanes' order and the shuffle tree change nothing.  TF32 would
// round general operands to 10 mantissa bits, so the arithmetic is fp32 FMA.
//
// K2, the rank-K update sized to the output (update_kernel).  Each thread
// owns V outputs of one row, out[w, e .. e+V-1]: V = 4 (one float4) when
// E % 4 == 0 and the bases of scores, delta and out are 16-byte aligned,
// else V = 1.  It reads its scores, then walks K with mult[w, k] (one
// address for all threads of the row: a broadcast) and delta[k, e ..]
// (neighbouring threads on neighbouring addresses) straight from global
// memory through __ldg, four steps' loads issued together.  No shared
// memory, no barrier; the grid is ceil(W E / V / 128) blocks of 128, so at
// the serving shape (W = 256, K = 2, E = 16) every thread computes live
// outputs and waits on device memory once.  The same exactness argument as
// K1's holds, max|out - float64| == 0.0 in any summation order: scores are
// dyadic multiples, mult small integers and delta dyadic (+-0.5**tier), so
// every product and partial sum is an integer multiple of the smallest
// weight below 2**24 of them, exact in fp32.
//
// What bounds them on the H100.  The serving shapes are tiny (W <= 256 rows
// of the window, E <= 16 executors, O = 256 object columns, K = 2): 24 KB of
// operands for K1, far below both the bytes floor (3.35 TB/s) and the fp32
// floor (67 TFLOP/s).  The launch and one device-memory round trip bound
// them; each design leaves that one round trip a warp (K1) or a thread
// (K2).  At large extents K1 is bound by L2 reads (each demand row is read
// by E / EW blocks, each presence row by W / RW blocks) and then by the
// fp32 rate.
//
// C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UT = 128;  // K2: threads a block

constexpr int RW = 2;    // K1: window rows per block
constexpr int EW = 8;    // K1: executors per block, one a warp
constexpr int CH = 256;  // K1: elements of a row per pass (8 a lane)

// Lane's 8 elements of the pass at c0: float4 loads at c0 + 4 lane and
// c0 + 128 + 4 lane (VEC), or scalars at c0 + lane + 32 q.  Masked past O.
template <bool VEC>
__device__ __forceinline__ void load_pass(const float* __restrict__ p, int c0, int O,
                                          int lane, float (&x)[8]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = c0 + h * 128 + lane * 4;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < O) q = __ldg(reinterpret_cast<const float4*>(p + idx));
      x[4 * h] = q.x; x[4 * h + 1] = q.y; x[4 * h + 2] = q.z; x[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = c0 + lane + 32 * q;
      x[q] = idx < O ? __ldg(p + idx) : 0.f;
    }
  }
}

// out[W,E] = A[W,O] @ B[E,O]^T
template <bool VEC>
__global__ void __launch_bounds__(32 * EW)
score_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ out, int W, int E, int O) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.y * EW + warp;
  const int w0 = blockIdx.x * RW;
  if (e >= E) return;                     // a whole warp; no barrier follows
  const float* b = B + (long)e * O;
  const float* a[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) a[r] = A + (long)(w0 + r < W ? w0 + r : w0) * O;

  float acc[RW], xb[8], xa[RW][8];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = 0.f;
  load_pass<VEC>(b, 0, O, lane, xb);
#pragma unroll
  for (int r = 0; r < RW; ++r) load_pass<VEC>(a[r], 0, O, lane, xa[r]);
  for (int c0 = 0; c0 < O; c0 += CH) {
    float nb[8], na[RW][8];
    const bool more = c0 + CH < O;
    if (more) {                           // in flight during this pass's FMAs
      load_pass<VEC>(b, c0 + CH, O, lane, nb);
#pragma unroll
      for (int r = 0; r < RW; ++r) load_pass<VEC>(a[r], c0 + CH, O, lane, na[r]);
    }
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r] = fmaf(xa[r][q], xb[q], acc[r]);
    if (more) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        xb[q] = nb[q];
#pragma unroll
        for (int r = 0; r < RW; ++r) xa[r][q] = na[r][q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], m);
    if (lane == 0 && w0 + r < W) out[(long)(w0 + r) * E + e] = acc[r];
  }
}

// out[W,E] = S[W,E] + M[W,K] @ Dl[K,E]; out may alias S (each element is
// read and then written by the same thread, so S is read without __ldg).
template <int V>
__global__ void __launch_bounds__(UT)
update_kernel(const float* S, const float* __restrict__ M,
              const float* __restrict__ Dl, float* out, int W, int E, int K) {
  const int per_row = E / V;
  const long i = (long)blockIdx.x * UT + threadIdx.x;
  if (i >= (long)W * per_row) return;
  const int w = (int)(i / per_row);
  const int e = (int)(i % per_row) * V;
  const long o = (long)w * E + e;
  float acc[V];
  if constexpr (V == 4) {
    const float4 s = *reinterpret_cast<const float4*>(S + o);
    acc[0] = s.x; acc[1] = s.y; acc[2] = s.z; acc[3] = s.w;
  } else {
    acc[0] = S[o];
  }
  const float* m = M + (long)w * K;
  const float* d = Dl + e;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float mk = __ldg(m + k);
    if constexpr (V == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(d + (long)k * E));
      acc[0] = fmaf(mk, q.x, acc[0]);
      acc[1] = fmaf(mk, q.y, acc[1]);
      acc[2] = fmaf(mk, q.z, acc[2]);
      acc[3] = fmaf(mk, q.w, acc[3]);
    } else {
      acc[0] = fmaf(mk, __ldg(d + (long)k * E), acc[0]);
    }
  }
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(out + o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    out[o] = acc[0];
}

}  // namespace

extern "C" int dispatch_scores_f32(const void* demand, const void* presence,
                                   void* out, int W, int E, int O, void* stream) {
  cudaGetLastError();
  if (W <= 0 || E <= 0 || O < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + RW - 1) / RW, (E + EW - 1) / EW);
  const bool vec = O % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(demand) | reinterpret_cast<uintptr_t>(presence)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(demand);
  const float* p = static_cast<const float*>(presence);
  if (vec)
    score_rows_kernel<true><<<grid, 32 * EW, 0, s>>>(d, p, static_cast<float*>(out), W, E, O);
  else
    score_rows_kernel<false><<<grid, 32 * EW, 0, s>>>(d, p, static_cast<float*>(out), W, E, O);
  return (int)cudaGetLastError();
}

extern "C" int dispatch_score_update_f32(const void* scores, const void* mult,
                                         const void* delta, void* out, int W,
                                         int E, int K, void* stream) {
  cudaGetLastError();
  if (W <= 0 || E <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = E % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(scores) | reinterpret_cast<uintptr_t>(delta) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long threads = (long)W * (vec ? E / 4 : E);
  const unsigned grid = (unsigned)((threads + UT - 1) / UT);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  const float* m = static_cast<const float*>(mult);
  const float* d = static_cast<const float*>(delta);
  if (vec)
    update_kernel<4><<<grid, UT, 0, s>>>(sc, m, d, static_cast<float*>(out), W, E, K);
  else
    update_kernel<1><<<grid, UT, 0, s>>>(sc, m, d, static_cast<float*>(out), W, E, K);
  return (int)cudaGetLastError();
}
