// RG-LRU diagonal recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_pallas` / `_rglru_kernel` in
// src/repro/kernels/rglru_scan/rglru_scan.py.  Same recurrence,
// h_t = a_t * h_{t-1} + b_t per channel over a, b [B,T,W] in fp32, with the
// state carried in and out: the Pallas kernel starts from h = 0 and returns
// only y, but the model's prefill and decode steps continue a session's
// state, so this kernel reads h0 [B,W] (or zeros when it is null) and writes
// hT [B,W] beside y [B,T,W].
//
// Design.  The Pallas grid walks time as a sequential axis with h in VMEM
// scratch.  The recurrence has no work across channels, so here one thread
// owns one (batch row, channel) and walks the whole time axis with h in a
// register; neighbouring threads own neighbouring channels, so every load
// and store of a time step is one coalesced row.  The product and the sum
// round separately (no fused multiply-add), as the plain version's two
// elementwise operations do.  Ragged T and W are handled by the loop bound
// and a channel mask (the Pallas kernel asserts divisibility).
//
// What bounds it on the H100.  Bytes: a and b read once, y written once
// (12 bytes per element, plus the two states): 0.82 MB, 0.00024 ms at B=1,
// T=16, W=4096 against 3.35 TB/s.  At those serving shapes (and T = 1 in decode)
// the launch dominates, and only W/256 = 16 blocks run: the card is mostly
// idle.  Later work: fuse the gate arithmetic that builds a and b (sigmoid,
// softplus, exp, sqrt) into this kernel, and split T across blocks with a
// second pass for long prompts.
//
// C entry point: rglru_scan_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ hT, int T, int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= W) return;
  float h = h0 != nullptr ? h0[(long)bi * W + c] : 0.f;
  const long base = (long)bi * T * W + c;
  for (int t = 0; t < T; ++t) {
    const long o = base + (long)t * W;
    h = __fadd_rn(__fmul_rn(a[o], h), b[o]);
    y[o] = h;
  }
  hT[(long)bi * W + c] = h;
}

}  // namespace

// a, b, y: contiguous float32 [B,T,W]; h0 (may be null), hT: float32 [B,W].
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* y, void* hT, int B, int T, int W,
                              void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (B <= 0 || B > 65535 || T < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), T, W);
  return (int)cudaGetLastError();
}
