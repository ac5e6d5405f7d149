// Dispatch window scoring for Hopper (sm_90a): two tiled fp32 SIMT GEMMs.
//
// Replaces the TPU kernels in src/repro/kernels/dispatch_score/dispatch_score.py:
//   * dispatch_score_pallas / _score_kernel:
//       out[W,E] = demand[W,O] @ presence[E,O]^T   (B read transposed)
//   * dispatch_score_update_pallas / _update_kernel:
//       out[W,E] = scores[W,E] + mult[W,K] @ delta[K,E]
//     (the accumulator is seeded from the resident scores, as the Pallas
//     kernel seeds its VMEM accumulator from the score tile).
//
// Design.  One block of 256 threads per 64x64 output tile; the contraction
// (the Pallas kernel's sequential grid axis) is a loop inside the block over
// 16-deep slices staged in shared memory, and each thread keeps a 4x4
// register micro-tile (rows ty+16i, columns tx+16j).  Ragged edges on every
// axis are masked in the kernel (out-of-range operands load as zero, out-of-
// range outputs are not stored), so nothing is padded.
//
// Arithmetic is fp32 FMA on purpose, not TF32 tensor cores: the dispatch
// plane's contract is max|out - float64| == 0.0.  Demand entries are small
// integers and presence weights dyadic (0.5**tier), so every product and
// partial sum is exact in fp32 below 2**24; TF32 would round general
// operands to 10 mantissa bits.
//
// What bounds it on the H100.  The serving shapes are tiny (W <= 256 rows of
// the window, E <= 16 executors, O = 256 object columns): the launch and one
// partial tile dominate, far above both the bytes floor and the fp32 floor.
// At large extents the kernel is bound by the fp32 SIMT rate (67 TFLOP/s),
// which is the price of exactness.
//
// C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;   // output rows per block
constexpr int TE = 64;   // output columns per block
constexpr int TK = 16;   // contraction slice
constexpr int NT = 256;

// out[W,E] = A[W,O] @ B[E,O]^T
__global__ void __launch_bounds__(NT)
score_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ out, int W, int E, int O) {
  __shared__ float As[TK][TW + 1];
  __shared__ float Bs[TK][TE + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int w0 = blockIdx.y * TW, e0 = blockIdx.x * TE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < O; k0 += TK) {
    for (int i = tid; i < TW * TK; i += NT) {
      const int r = i / TK, kk = i % TK;
      const int w = w0 + r, kidx = k0 + kk;
      As[kk][r] = (w < W && kidx < O) ? A[(long)w * O + kidx] : 0.f;
      const int e = e0 + r;
      Bs[kk][r] = (e < E && kidx < O) ? B[(long)e * O + kidx] : 0.f;
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
  dim3 grid((E + TE - 1) / TE, (W + TW - 1) / TW);
  score_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demand), static_cast<const float*>(presence),
      static_cast<float*>(out), W, E, O);
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
