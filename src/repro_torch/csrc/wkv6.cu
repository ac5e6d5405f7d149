// WKV6 recurrence (RWKV-6 time mix) for Hopper (sm_90a), exact per-step form.
//
// Replaces the TPU kernel `wkv6_pallas` / `_wkv6_kernel` in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py.  Same function: per (batch,
// head), with an N x N fp32 state S (key dim i, value dim j),
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// over r, k, v, w [B,T,H,N] and u [H,N], output in fp32.  The state is
// carried in and out: the Pallas kernel starts from S = 0 and returns only
// out, but the model's prefill and decode steps continue a session's state,
// so this kernel reads s0 [B,H,N,N] (or zeros when it is null) and writes sT.
//
// Design.  The Pallas kernel evaluates each 16-step sub-chunk in matmul form
// with log-space decay exponents (the MXU wants matrices).  This version is
// the exact per-step recurrence, the same arithmetic as the plain version,
// so it needs none of those exponents and no clamp: one block per (batch,
// head) of N threads, thread j owning value column j of S in N registers.
// Each step stages r_t, k_t and w_t (the key-dim vectors every column
// reads) in shared memory, beside u staged once; thread j reads v_t[j]
// itself.  r, k and v are read as float32 or bfloat16 (the model's
// projections are bf16); w, u and the states are float32.  Any T; N in
// {16, 32, 64}.
//
// What bounds it on the H100.  Bytes at the serving shapes (B=1, H=40,
// N=64, T=16, bf16 r/k/v): 0.58 MB of inputs and outputs plus 1.3 MB of
// state in and out, 0.00056 ms at 3.35 TB/s; at T = 1 in decode, the state
// alone.  With one block per head only 40 blocks of 64 threads run, and the
// time walk is serial: the launch and the step latency dominate.  Later work
// (the chunked tensor-core form): sub-chunks of 16 steps as mma products,
// which is what the Pallas kernel does on the MXU.
//
// C entry point: wkv6_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ out,
            float* __restrict__ sT, int Tn, int H) {
  __shared__ float rs[N], ks[N], ws[N], us[N];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long sbase = (long)bh * N * N;
  us[j] = u[(long)h * N + j];  // read after the first step's barriers

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 != nullptr ? s0[sbase + (long)i * N + j] : 0.f;

  for (int t = 0; t < Tn; ++t) {
    const long off = (((long)b * Tn + t) * H + h) * N;
    const float rj = to_f(r[off + j]);
    const float kj = to_f(k[off + j]);
    const float vj = to_f(v[off + j]);
    const float wj = w[off + j];
    __syncthreads();            // the previous step's reads of the stage are done
    rs[j] = rj;
    ks[j] = kj;
    ws[j] = wj;
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = ks[i] * vj;
      acc = fmaf(rs[i], S[i] + us[i] * kv, acc);
      S[i] = fmaf(ws[i], S[i], kv);
    }
    out[off + j] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sT[sbase + (long)i * N + j] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sT, int B,
                   int Tn, int H, int N, cudaStream_t stream) {
  const dim3 grid(B * H);
#define WKV6_ARGS                                                               \
  static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), \
      static_cast<const float*>(w), static_cast<const float*>(u),               \
      static_cast<const float*>(s0), static_cast<float*>(out),                  \
      static_cast<float*>(sT), Tn, H
  switch (N) {
    case 16: wkv6_kernel<T, 16><<<grid, 16, 0, stream>>>(WKV6_ARGS); break;
    case 32: wkv6_kernel<T, 32><<<grid, 32, 0, stream>>>(WKV6_ARGS); break;
    case 64: wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(WKV6_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef WKV6_ARGS
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  r, k, v, w, out: contiguous
// [B,T,H,N]; u: [H,N]; s0 (may be null) and sT: [B,H,N,N]; w, u, s0, out and
// sT are float32.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* out, void* sT, int B,
                        int T, int H, int N, int dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (B <= 0 || H <= 0 || T < 0 || (long)B * H > 2147483647L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(r, k, v, w, u, s0, out, sT, B, T, H, N, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, B, T, H, N, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
