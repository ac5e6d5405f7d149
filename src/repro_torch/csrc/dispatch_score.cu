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
// K2 (update_kernel) is a tiled kernel: one block of 256 threads per
// 64x64 output tile, the contraction in 16-deep slices staged in shared
// memory, a 4x4 register micro-tile a thread.  At the serving rank (K = 2)
// it is one slice, one round trip.
//
// What bounds them on the H100.  The serving shapes are tiny (W <= 256 rows
// of the window, E <= 16 executors, O = 256 object columns, K = 2): 24 KB of
// operands for K1, far below both the bytes floor (3.35 TB/s) and the fp32
// floor (67 TFLOP/s).  The launch and one device-memory round trip bound
// them; K1's design leaves that one round trip a warp.  At large extents K1
// is bound by L2 reads (each demand row is read by E / EW blocks, each
// presence row by W / RW blocks) and then by the fp32 rate.
//
// C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;   // K2: output rows per block
constexpr int TE = 64;   // K2: output columns per block
constexpr int TK = 16;   // K2: contraction slice
constexpr int NT = 256;

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
// read and written by the same thread).
__global__ void __launch_bounds__(NT)
update_kernel(const float* S, const float* __restrict__ M,
              const float* __restrict__ Dl, float* out, int W, int E, int K) {
  __shared__ float As[TK][TW + 1];
  __shared__ float Bs[TK][TE + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int w0 = blockIdx.y * TW, e0 = blockIdx.x * TE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = w0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      acc[i][j] = (w < W && e < E) ? S[(long)w * E + e] : 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TW * TK; i += NT) {
      const int r = i / TK, kk = i % TK;
      const int w = w0 + r, kidx = k0 + kk;
      As[kk][r] = (w < W && kidx < K) ? M[(long)w * K + kidx] : 0.f;
      const int kb = i / TE, c = i % TE;     // delta rows are E-contiguous
      const int e = e0 + c, kidx2 = k0 + kb;
      Bs[kb][c] = (e < E && kidx2 < K) ? Dl[(long)kidx2 * E + e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = w0 + ty + 16 * i;
    if (w >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < E) out[(long)w * E + e] = acc[i][j];
    }
  }
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
  dim3 grid((E + TE - 1) / TE, (W + TW - 1) / TW);
  update_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(mult),
      static_cast<const float*>(delta), static_cast<float*>(out), W, E, K);
  return (int)cudaGetLastError();
}
