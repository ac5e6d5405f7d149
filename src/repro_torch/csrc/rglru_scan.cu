// RG-LRU diagonal recurrence for Hopper (sm_90a), plain and with the gates
// fused in.
//
// Replaces the TPU kernel `rglru_pallas` / `_rglru_kernel` in
// src/repro/kernels/rglru_scan/rglru_scan.py.  Same recurrence,
// h_t = a_t * h_{t-1} + b_t per channel over [B,T,W] in fp32, with the state
// carried in and out: the Pallas kernel starts from h = 0 and returns only y,
// but the model's prefill and decode steps continue a session's state, so
// this kernel reads h0 [B,W] (or zeros when it is null) and writes hT [B,W]
// beside y [B,T,W].
//
// Two entries share one kernel template, whose operand type says where a_t
// and b_t come from:
//   * rglru_scan_fwd (the Pallas kernel's counterpart): a and b, fp32;
//   * rglru_gated_scan_fwd: the RG-LRU's gate chain of models/rglru.py,
//     computed per element inside the scan from xi, r_logit and i_logit
//     (bf16 or fp32) and lam (fp32 [W]):
//       r = sigmoid(r_logit), i = sigmoid(i_logit)
//       a = exp(-8 softplus(lam) r),  b = sqrt(clamp(1 - a^2, 0, 1)) (i xi)
//     with accurate expf / log1pf / sqrtf, IEEE division and every product
//     and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into
//     fused multiply-adds), in the order of the plain version's tensor
//     operations; softplus is torch's (x > 20 ? x : log1p(exp(x))).  The
//     decode step then launches this one kernel where it launched fifteen
//     elementwise kernels and the scan, and a prompt's gates never go
//     through device memory.
//
// Design.  The Pallas grid walks time as a sequential axis with h in VMEM
// scratch.  Here one thread owns one (batch row, channel) and walks time
// with h in a register; neighbouring threads own neighbouring channels, so
// every load and store of a time step is one coalesced row.  A thread walks
// time in groups of U = 8 steps: it issues the next group's loads (clamped
// to the last step, so they are unconditional and all in flight together), then
// runs the current group's gate arithmetic and the dependent chain of h, so
// memory latency is paid once for the first group and then hidden behind
// the arithmetic of the one before.
//
// Every call is one launch over the whole time axis: decode (T = 1) and the
// 16-token serving prefill alike.  A prompt's length sets only how long a
// thread walks; long prompts (recurrentgemma's window is 2,048) still run
// W / 128 blocks, 32 of 132 SMs at W = 4,096.  Splitting T into chunks over
// more blocks waits for a served workload that sends such prompts (ROADMAP
// K5).
//
// What bounds it on the H100.  Bytes.  Plain: a and b read once, y written
// once (12 bytes per element, plus the two states): 100.7 MB, 0.030 ms, at
// B = 1, T = 2,048, W = 4,096 against 3.35 TB/s.  Gated, bf16 logits: 10
// bytes per element, 84 MB, 0.025 ms.  At T = 1 (decode) the launch
// dominates.
//
// C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // channels a block
constexpr int U = 8;     // steps whose loads are issued together

// Each operand type loads a group of U steps' raw values (load: loads only,
// so that all of them are in flight before anything waits on one) and turns
// them into a_t and b_t (compute).  Indices past the last step are clamped
// to it by the caller; those steps are masked in the recurrence.
struct PlainAB {
  const float* __restrict__ a;
  const float* __restrict__ b;
  struct Raw { float a[U], b[U]; };
  __device__ __forceinline__ float channel_raw(int) const { return 0.f; }
  __device__ __forceinline__ float channel(float) const { return 0.f; }
  __device__ __forceinline__ void load(Raw& q, const long (&o)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) { q.a[u] = __ldg(a + o[u]); q.b[u] = __ldg(b + o[u]); }
  }
  __device__ __forceinline__ void compute(const Raw& q, float, float (&av)[U],
                                          float (&bv)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) { av[u] = q.a[u]; bv[u] = q.b[u]; }
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {     // bf16 bits -> fp32, exact
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

__device__ __forceinline__ float clamp01(float v) {   // NaN passes, as torch.clamp
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

// a_t and b_t from the gate logits; E is float or uint16_t (bf16 bits).
template <typename E>
struct GatedAB {
  const E* __restrict__ x;
  const E* __restrict__ r;
  const E* __restrict__ i;
  const float* __restrict__ lam;
  struct Raw { E x[U], r[U], i[U]; };
  __device__ __forceinline__ float channel_raw(int c) const { return __ldg(lam + c); }
  // -8 softplus(lam[c]), rounded as the plain version's [W] tensor is
  __device__ __forceinline__ float channel(float l) const {
    return __fmul_rn(-8.f, l > 20.f ? l : log1pf(expf(l)));
  }
  __device__ __forceinline__ void load(Raw& q, const long (&o)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      q.x[u] = __ldg(x + o[u]); q.r[u] = __ldg(r + o[u]); q.i[u] = __ldg(i + o[u]);
    }
  }
  __device__ __forceinline__ void compute(const Raw& q, float neg_c, float (&av)[U],
                                          float (&bv)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float rg = sigmoid_rn(to_f(q.r[u]));
      const float ig = sigmoid_rn(to_f(q.i[u]));
      av[u] = expf(__fmul_rn(neg_c, rg));
      const float keep = sqrtf(clamp01(__fsub_rn(1.f, __fmul_rn(av[u], av[u]))));
      bv[u] = __fmul_rn(keep, __fmul_rn(ig, to_f(q.x[u])));
    }
  }
};

// Element offsets of the U steps from t (clamped to T - 1).
__device__ __forceinline__ void step_offsets(long (&o)[U], long base, int t, int T, int W) {
#pragma unroll
  for (int u = 0; u < U; ++u) o[u] = base + (long)min(t + u, T - 1) * W;
}

// One thread walks the whole time axis of one (batch row, channel).  The
// next group's loads are issued before the current group's arithmetic.
template <class AB>
__global__ void __launch_bounds__(NT)
rglru_kernel(AB ab, const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ hT, int T, int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= W) return;
  const long base = (long)bi * T * W + c;

  const float lam_raw = ab.channel_raw(c);
  typename AB::Raw cur;
  long o[U];
  if (T > 0) {
    step_offsets(o, base, 0, T, W);
    ab.load(cur, o);
  }
  float h = h0 != nullptr ? h0[(long)bi * W + c] : 0.f;
  const float neg_c = ab.channel(lam_raw);
  for (int t = 0; t < T; t += U) {
    typename AB::Raw nxt;
    const bool more = t + U < T;
    if (more) {
      step_offsets(o, base, t + U, T, W);
      ab.load(nxt, o);
    }
    float av[U], bv[U];
    ab.compute(cur, neg_c, av, bv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < T) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        y[base + (long)(t + u) * W] = h;
      }
    }
    if (more) cur = nxt;
  }
  hT[(long)bi * W + c] = h;
}

template <class AB>
int launch(const AB& ab, const void* h0, void* y, void* hT, int B, int T, int W,
           void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (B <= 0 || B > 65535 || T < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<AB><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ab, static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT), T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, y: contiguous float32 [B,T,W]; h0 (may be null), hT: float32 [B,W].
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* y, void* hT, int B, int T, int W, void* stream) {
  const PlainAB ab{static_cast<const float*>(a), static_cast<const float*>(b)};
  return launch(ab, h0, y, hT, B, T, W, stream);
}

// x, r_logit, i_logit: contiguous [B,T,W], bf16 when bf16 != 0, else
// float32; lam: float32 [W]; the rest as rglru_scan_fwd.
extern "C" int rglru_gated_scan_fwd(const void* x, const void* r_logit,
                                    const void* i_logit, const void* lam,
                                    const void* h0, void* y, void* hT, int B,
                                    int T, int W, int bf16, void* stream) {
  const float* l = static_cast<const float*>(lam);
  if (bf16) {
    const GatedAB<uint16_t> ab{static_cast<const uint16_t*>(x),
                               static_cast<const uint16_t*>(r_logit),
                               static_cast<const uint16_t*>(i_logit), l};
    return launch(ab, h0, y, hT, B, T, W, stream);
  }
  const GatedAB<float> ab{static_cast<const float*>(x), static_cast<const float*>(r_logit),
                          static_cast<const float*>(i_logit), l};
  return launch(ab, h0, y, hT, B, T, W, stream);
}
