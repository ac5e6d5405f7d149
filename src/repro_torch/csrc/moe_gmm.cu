// Grouped expert GEMM for Hopper (sm_90a): bf16 on the tensor cores, f32 on
// the SIMT pipes, experts with no filled slot skipped.
//
// Replaces the TPU kernel `gmm_pallas` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm/moe_gmm.py.  Same function: per expert e,
// out[e] = x[e] @ w[e] with x [E,C,D], w [E,D,F], out [E,C,F], products
// summed in fp32.  The output type is the caller's choice (x's dtype, as the
// Pallas kernel writes, or fp32): the MoE FFN keeps the gate and up products
// in fp32 and rounds only the down product, as the reference's einsums do.
// With per-expert fill counts (int32 [E], optional) the function is
// out[e, c] = x[e, c] @ w[e] for c < counts[e] and exactly 0 for the rest.
//
// What bounds it on the H100, at olmoe's shapes (E = 64, D x F = 2048 x 1024
// for the gate and up products, 1024 x 2048 for the down product):
//  - decode (T = 1, C = 8): one token routed to 8 of 64 experts.  The work
//    is 2 * 8 * D * F = 34 MFLOP against the live experts' weights, 33.6 MB:
//    bytes-bound, 0.010 ms at 3.35 TB/s (0.080 ms if all 64 experts' weights
//    are read, as the capacity layout alone would have it).
//  - the 16-token prefill (C = 8 as well): up to 64 experts live, bytes-bound
//    at 0.080 ms.
//  - a 2,048-token prefill (C = 320): 85.9 GFLOP against 436 MB; bytes-bound
//    at 0.130 ms on the card's peaks, and about 1.3 ms on the fp32 SIMT pipes.
//
// Design.
//  - Counts: a block reads counts[e] first; a block whose rows all lie at or
//    past the count writes its zeros and returns before loading any of w[e].
//    A partly filled tile loads its dead rows of x as zeros and stores zeros
//    there.  The output is written in full (uninitialised rows would reach
//    silu(g) * u and, as NaN * 0, the gather).  The grid is sized without
//    knowing which experts are live (no host sync, graph-safe): narrow
//    column tiles make the live blocks alone fill the card at decode, 8
//    experts x F / 64 = 128 blocks for the gate and up products and 256 for
//    the down product, while dead blocks retire in a few hundred cycles.
//    Narrow tiles keep one kernel and no second pass, which a split over D
//    would need.
//  - bf16 (x, w and all pointers 16-byte aligned, D and F multiples of 8):
//    tiles of x and w stream into shared memory by 16-byte cp.async through
//    a ring of stages, so the copy of later D slices overlaps the product of
//    this one; ldmatrix feeds mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//    C <= 16 (decode and short prefills): a block is one m16 tile by 64
//    columns, four warps of 16 columns, 128-deep D slices in a 4-stage ring
//    (48 KB of w in flight a block: the launch is bytes-bound, and the rows
//    an m16 tile wastes at C = 8 cost nothing).  C > 16: 64 rows by 256
//    columns, four warps of 64 x 64, 64-deep slices double-buffered: the
//    fastest at C = 320 of the tile shapes and stage depths tried (64 to
//    256 rows, 128 or 256 columns, 2 to 4 stages; operand fragments loaded
//    a step ahead changed nothing).  It reaches about a quarter of the bf16
//    peak; the way further is wgmma fed by TMA.
//  - f32 and unaligned bf16: the SIMT kernel of the first port, one block of
//    256 threads per (expert, 8 or 32 rows, 128 columns), products in fp32
//    FMAs.  TF32 tensor cores would keep about three decimal digits, and the
//    f32 contract is 1e-5, so f32 stays on the SIMT pipes.
//
// C entry point: moe_gmm_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int live_rows(const int* counts, int e, int C) {
  return counts == nullptr ? C : min(max(counts[e], 0), C);
}

// Zeros for rows [r0, r1) x columns [f0, f1) of one expert's output.
template <typename TO>
__device__ void zero_tile(TO* oe, int F, int r0, int r1, int f0, int f1) {
  const int w = f1 - f0;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += blockDim.x)
    oe[(long)(r0 + i / w) * F + f0 + i % w] = from_f<TO>(0.f);
}

// ------------------------------------------------------------------ SIMT
constexpr int S_BF = 128;   // output columns per block
constexpr int S_BD = 32;    // contraction slice
constexpr int S_NT = 256;   // threads per block (8 rows x 32 lanes)

template <typename TX, typename TO, int RM>
__global__ void __launch_bounds__(S_NT)
gmm_simt_kernel(const TX* __restrict__ x, const TX* __restrict__ w, TO* __restrict__ out,
                const int* __restrict__ counts, int C, int D, int F) {
  constexpr int BC = 8 * RM;
  __shared__ float xs[BC][S_BD + 1];
  __shared__ float ws[S_BD][S_BF];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int f0 = blockIdx.x * S_BF, c0 = blockIdx.y * BC, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  TO* oe = out + (long)e * C * F;
  if (c0 >= live) {
    zero_tile(oe, F, c0, min(c0 + BC, C), f0, min(f0 + S_BF, F));
    return;
  }
  const TX* xe = x + (long)e * C * D;
  const TX* we = w + (long)e * D * F;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += S_BD) {
    for (int i = tid; i < BC * S_BD; i += S_NT) {
      const int r = i / S_BD, c = i % S_BD;
      const int ci = c0 + r, di = d0 + c;
      xs[r][c] = (ci < live && di < D) ? to_f(xe[(long)ci * D + di]) : 0.f;
    }
    for (int i = tid; i < S_BD * S_BF; i += S_NT) {
      const int r = i / S_BF, c = i % S_BF;
      const int di = d0 + r, fi = f0 + c;
      ws[r][c] = (di < D && fi < F) ? to_f(we[(long)di * F + fi]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < S_BD; ++d) {
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

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int ci = c0 + ty + 8 * i;
    if (ci >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fi = f0 + tx + 32 * j;
      if (fi < F) oe[(long)ci * F + fi] = from_f<TO>(ci < live ? acc[i][j] : 0.f);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch_simt(const void* x, const void* w, void* out, const int* counts,
                        int E, int C, int D, int F, cudaStream_t stream) {
  const dim3 block(S_NT);
  if (C <= 8) {
    const dim3 grid((F + S_BF - 1) / S_BF, (C + 7) / 8, E);
    gmm_simt_kernel<TX, TO, 1><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(w), static_cast<TO*>(out),
        counts, C, D, F);
  } else {
    const dim3 grid((F + S_BF - 1) / S_BF, (C + 31) / 32, E);
    gmm_simt_kernel<TX, TO, 4><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(w), static_cast<TO*>(out),
        counts, C, D, F);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ tensor cores
// Block tile BM x BN of one expert's output; warps of WM x WN; D walked in
// BK-deep slices through a STAGES-deep cp.async ring.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_, STAGES = STAGES_;
  static constexpr int NWARP = (BM / WM) * (BN / WN);
  static constexpr int NT = NWARP * 32;
  static constexpr int MT = WM / 16;     // m16 tiles a warp
  static constexpr int NTL = WN / 8;     // n8 tiles a warp
  static constexpr int LDX = BK + 8;     // padded rows: conflict-free ldmatrix
  static constexpr int LDW = BN + 8;
  static constexpr int X_STAGE = BM * LDX;
  static constexpr int W_STAGE = BK * LDW;
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)STAGES * (X_STAGE + W_STAGE);
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma tile shape");
};
using SmallC = Tile<16, 64, 16, 16, 128, 4>;   // C <= 16: 128 threads, 91,136 B
using LargeC = Tile<64, 256, 64, 64, 64, 2>;   // C > 16: 128 threads, 86,016 B

template <typename T, typename TO>
__global__ void __launch_bounds__(T::NT)
gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, TO* __restrict__ out,
               const int* __restrict__ counts, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);       // [STAGES][BM][LDX]
  bf16* Ws = Xs + T::STAGES * T::X_STAGE;              // [STAGES][BK][LDW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  TO* oe = out + (long)e * C * F;
  if (m0 >= live) {          // nothing of w[e] is read for an empty tile
    zero_tile(oe, F, m0, min(m0 + T::BM, C), n0, min(n0 + T::BN, F));
    return;
  }
  const bf16* xe = x + (long)e * C * D;
  const bf16* we = w + (long)e * D * F;
  const int wm = (warp / (T::BN / T::WN)) * T::WM;
  const int wn = (warp % (T::BN / T::WN)) * T::WN;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * T::BK;
    bf16* xs = Xs + stage * T::X_STAGE;
    bf16* ws = Ws + stage * T::W_STAGE;
    constexpr int XC = T::BK / 8;                     // 16-byte chunks a row
    for (int i = tid; i < T::BM * XC; i += T::NT) {
      const int r = i / XC, c = (i % XC) * 8;
      const bool ok = m0 + r < live && k0 + c < D;
      tc::cp_async16(xs + r * T::LDX + c, ok ? xe + (long)(m0 + r) * D + k0 + c : xe, ok);
    }
    constexpr int WC = T::BN / 8;
    for (int i = tid; i < T::BK * WC; i += T::NT) {
      const int r = i / WC, c = (i % WC) * 8;
      const bool ok = k0 + r < D && n0 + c < F;
      tc::cp_async16(ws + r * T::LDW + c, ok ? we + (long)(k0 + r) * F + n0 + c : we, ok);
    }
  };

  float acc[T::MT][T::NTL][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (D + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();                 // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<T::STAGES - 2>();    // slice kt has landed (this thread's part)
    __syncthreads();                       // ... everyone's; slice kt-1 is consumed
    const int nxt = kt + T::STAGES - 1;
    if (nxt < nk) load(nxt % T::STAGES, nxt);
    tc::cp_async_commit();
    const bf16* xs = Xs + (kt % T::STAGES) * T::X_STAGE;
    const bf16* ws = Ws + (kt % T::STAGES) * T::W_STAGE;
#pragma unroll
    for (int ks = 0; ks < T::BK; ks += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        tc::ldsm_x4(a[i], tc::a_frag_ptr(xs, T::LDX, wm + 16 * i, ks, lane));
#pragma unroll
      for (int j = 0; j < T::NTL; j += 2) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, tc::bt_frag_ptr(ws, T::LDW, ks, wn + 8 * j, lane));
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          tc::mma_bf16(acc[i][j], a[i], b[0], b[1]);
          tc::mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= C) continue;
      const bool keep = r < live;
#pragma unroll
      for (int j = 0; j < T::NTL; ++j) {
        const int f = n0 + wn + 8 * j + 2 * t;
        if (f >= F) continue;              // F % 8 == 0: f + 1 < F too
        const float v0 = keep ? acc[i][j][2 * h] : 0.f;
        const float v1 = keep ? acc[i][j][2 * h + 1] : 0.f;
        TO* p = oe + (long)r * F + f;
        if constexpr (sizeof(TO) == 4) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <typename T, typename TO>
cudaError_t launch_mma(const void* x, const void* w, void* out, const int* counts, int E,
                       int C, int D, int F, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + T::BN - 1) / T::BN, (C + T::BM - 1) / T::BM, E);
  gmm_mma_kernel<T, TO><<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<TO*>(out),
      counts, C, D, F);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* w, void* out, const int* counts, int E,
                   int C, int D, int F, cudaStream_t stream) {
  if constexpr (sizeof(TX) == 2) {
    if (D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out)) {
      if (C <= 16) return launch_mma<SmallC, TO>(x, w, out, counts, E, C, D, F, stream);
      return launch_mma<LargeC, TO>(x, w, out, counts, E, C, D, F, stream);
    }
  }
  return launch_simt<TX, TO>(x, w, out, counts, E, C, D, F, stream);
}

template <typename TX>
cudaError_t dispatch_out(const void* x, const void* w, void* out, const int* counts, int E,
                         int C, int D, int F, int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return launch<TX, float>(x, w, out, counts, E, C, D, F, stream);
  if (out_dtype == 1) return launch<TX, bf16>(x, w, out, counts, E, C, D, F, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x [E,C,D] and w [E,D,F] share
// in_dtype; out [E,C,F] is out_dtype.  All contiguous.  counts: int32 [E] on
// the device, or null for every row live.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, const void* counts,
                           int E, int C, int D, int F, int in_dtype, int out_dtype,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || (C + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  cudaError_t err;
  if (in_dtype == 0)
    err = dispatch_out<float>(x, w, out, cnt, E, C, D, F, out_dtype, s);
  else if (in_dtype == 1)
    err = dispatch_out<bf16>(x, w, out, cnt, E, C, D, F, out_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
