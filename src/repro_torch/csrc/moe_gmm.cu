// Grouped expert GEMM for Hopper (sm_90a), SIMT fp32 arithmetic.
//
// Replaces the TPU kernel `gmm_pallas` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm/moe_gmm.py.  Same function: per expert e,
// out[e] = x[e] @ w[e] with x [E,C,D], w [E,D,F], out [E,C,F], products
// summed in fp32.  The output type is the caller's choice (x's dtype, as the
// Pallas kernel writes, or fp32): the MoE FFN keeps the gate and up products
// in fp32 and rounds only the down product, as the reference's einsums do.
//
// Design.  The Pallas grid walks D as a sequential axis accumulating into a
// VMEM tile.  Here one block of 256 threads owns a tile of BC capacity rows
// by 128 output columns of one expert, and the D walk is a loop inside the
// block over 32-deep slices staged in shared memory (converted to fp32).
// Thread (ty, tx) keeps rows ty + 8i and columns tx + 32j in registers: a
// warp shares its rows, so the x reads are broadcasts and the w reads are 32
// consecutive floats.  BC is 8 when C <= 8 (decode and short prefills, where
// the capacity layout holds 8 slots per expert) and 32 otherwise.  Ragged C,
// D and F are masked in the kernel (the Pallas kernel asserts divisibility).
//
// What bounds it on the H100.  At the serving shapes (E = 64, C = 8,
// D x F = 2048 x 1024) the work is 2*E*C*D*F = 2.1 GFLOP against 268 MB of
// expert weights that must be read once: bytes-bound, 0.080 ms at 3.35 TB/s.
// This version reads w with 2-byte scalar loads through shared memory and
// runs the FMAs on the SIMT pipes; it is far from that floor.  Later work:
// 16-byte (or TMA) loads of w, skipping experts with no filled slot (at one
// decode token only 8 of 64 experts hold tokens), and wgmma once C is large.
//
// C entry point: moe_gmm_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BF = 128;   // output columns per block
constexpr int BD = 32;    // contraction slice
constexpr int NT = 256;   // threads per block (8 rows x 32 lanes)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TX, typename TO, int RM>
__global__ void __launch_bounds__(NT)
gmm_kernel(const TX* __restrict__ x, const TX* __restrict__ w, TO* __restrict__ out,
           int C, int D, int F) {
  constexpr int BC = 8 * RM;
  __shared__ float xs[BC][BD + 1];
  __shared__ float ws[BD][BF];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int f0 = blockIdx.x * BF, c0 = blockIdx.y * BC, e = blockIdx.z;
  const TX* xe = x + (long)e * C * D;
  const TX* we = w + (long)e * D * F;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += BD) {
    for (int i = tid; i < BC * BD; i += NT) {
      const int r = i / BD, c = i % BD;
      const int ci = c0 + r, di = d0 + c;
      xs[r][c] = (ci < C && di < D) ? to_f(xe[(long)ci * D + di]) : 0.f;
    }
    for (int i = tid; i < BD * BF; i += NT) {
      const int r = i / BF, c = i % BF;
      const int di = d0 + r, fi = f0 + c;
      ws[r][c] = (di < D && fi < F) ? to_f(we[(long)di * F + fi]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < BD; ++d) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[d][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = xs[ty + 8 * i][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  TO* oe = out + (long)e * C * F;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int ci = c0 + ty + 8 * i;
    if (ci >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fi = f0 + tx + 32 * j;
      if (fi < F) oe[(long)ci * F + fi] = from_f<TO>(acc[i][j]);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int D,
                   int F, cudaStream_t stream) {
  const dim3 block(NT);
  if (C <= 8) {
    const dim3 grid((F + BF - 1) / BF, (C + 7) / 8, E);
    gmm_kernel<TX, TO, 1><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(w), static_cast<TO*>(out),
        C, D, F);
  } else {
    const dim3 grid((F + BF - 1) / BF, (C + 31) / 32, E);
    gmm_kernel<TX, TO, 4><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(w), static_cast<TO*>(out),
        C, D, F);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_out(const void* x, const void* w, void* out, int E, int C,
                         int D, int F, int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return launch<TX, float>(x, w, out, E, C, D, F, stream);
  if (out_dtype == 1) return launch<TX, __nv_bfloat16>(x, w, out, E, C, D, F, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x [E,C,D] and w [E,D,F] share
// in_dtype; out [E,C,F] is out_dtype.  All contiguous.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int E, int C,
                           int D, int F, int in_dtype, int out_dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || (C + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0)
    err = dispatch_out<float>(x, w, out, E, C, D, F, out_dtype, s);
  else if (in_dtype == 1)
    err = dispatch_out<__nv_bfloat16>(x, w, out, E, C, D, F, out_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
