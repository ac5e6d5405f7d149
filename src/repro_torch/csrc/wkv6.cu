// WKV6 recurrence (RWKV-6 time mix) for Hopper (sm_90a), with each head's
// state spread over the card.
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
// r, k and v are float32 or bfloat16 (the model's projections are bf16); w,
// u and the states are float32.  Any T; N in {16, 32, 64}.
//
// The exact per-step recurrence, as the kernel it replaces and the plain
// version: each step's decay is applied as it comes, so no exponent of a
// cumulative log decay is ever formed and strong decay cannot overflow (the
// Pallas form's e^{-L} overflows fp32 once -sum(log w) over its 16-step
// sub-chunk passes about 88).  The Pallas kernel's sub-chunk matrix form was
// built here too, with every decay factor the exponent of a difference <= 0,
// and timed by kernel_ab.py at 1.7-3.2x this form's time at T = 16 and 2,048
// on the H100 (700 W; fp32 SIMT: its pairwise exponents and five barriers a
// sub-chunk cost more than the per-step reduction they replace); the tests
// keep that algebra as a plain mirror (test_torch_kernels.py).
//
// Spreading the state.  Column j of S, and out[:, j], depend only on v[:, j]
// and on the key-side vectors r, k, w and u, so a head's value columns split
// over blocks with no reduction between them: CGW = 32 columns a block at
// N = 64, a grid of (B*H) x (N / CGW) = 80 blocks of 512 threads at rwkv6-3b.
// Inside a block, LPC = 16 lanes own a column, lane l its R = N / 16 key rows
// R*l .. R*l + R - 1 in registers, so a column's out sum is a reduction over
// 16 lanes of one warp and no step needs a barrier.  The state moves between
// device memory and registers through a shared tile in coalesced float4s.
//   * T < 16 (every decode step, short prompts): each step's r, k, w rows
//     and v element are loaded straight into registers, the next step's in
//     flight during this one, and the first step's loads are issued before
//     anything waits on the state, so decode costs one memory round trip.
//     out is summed with four xor shuffles a step.
//   * T >= 16 (prompts): windows of 16 steps of r, k, w and the block's v
//     columns are staged in shared memory with 16-byte cp.async, double-
//     buffered, so no step waits on device memory.  A full window's 16 steps
//     are unrolled and their 16 out sums reduced together by a reduce-scatter
//     over the column's lanes, 15 shuffles for 16 sums, after which lane l
//     holds and stores step l's output.
//
// What bounds it on the H100.  At T = 1 (decode, B=1, H=40, N=64) bytes: the
// state in and out, 1.3 MB, 0.00041 ms at 3.35 TB/s; the launch and one
// memory round trip are several times that.  At long T the fp32 operations
// the function needs (five per state element and step: two for r.S, three
// for w*S + k*v; the bonus term v_j * sum_i r_i u_i k_i is O(N) a step;
// 0.025 ms at T = 2,048 against 67 TFLOP/s) and the bytes (0.022 ms) are both
// far under the time.  The kernel issues seven flops per element (four
// instructions: it forms u*k*v per element rather than the O(N) bonus sum)
// and is bound by instruction issue on the SMs that hold its blocks, plus
// the loads and the per-step reduction.
//
// C entry point: wkv6_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int SUB = 16;   // steps a staged window
constexpr int LPC = 16;   // lanes a value column
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage steps [t0, t0 + SUB) of r, k, w (N each) and of the block's CGW
// columns of v into shared memory with 16-byte cp.async; steps at and past T
// are zero-filled.  The caller commits the group.
template <typename T, int N, int CGW, int NT>
__device__ __forceinline__ void stage_window(T* rs, T* ks, float* ws, T* vs,
                                             const T* __restrict__ r,
                                             const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             const float* __restrict__ w, int b, int h,
                                             int g, int t0, int Tn, int H) {
  constexpr int E16 = 16 / sizeof(T);     // elements in 16 bytes
  constexpr int RC = N / E16;             // 16-byte pieces of an r or k row
  constexpr int WC = N / 4;
  constexpr int VC = CGW / E16;
  static_assert(VC >= 1, "a v slice is at least 16 bytes");
  constexpr int PER = 2 * RC + WC + VC;
  for (int c = threadIdx.x; c < SUB * PER; c += NT) {
    const int t = c / PER;
    int q = c % PER;
    const bool live = t0 + t < Tn;
    const long row = (((long)b * Tn + (live ? t0 + t : 0)) * H + h) * N;
    if (q < RC) {
      tc::cp_async16(rs + t * N + q * E16, r + row + q * E16, live);
    } else if ((q -= RC) < RC) {
      tc::cp_async16(ks + t * N + q * E16, k + row + q * E16, live);
    } else if ((q -= RC) < WC) {
      tc::cp_async16(ws + t * N + q * 4, w + row + q * 4, live);
    } else {
      q -= WC;
      tc::cp_async16(vs + t * CGW + q * E16, v + row + g * CGW + q * E16, live);
    }
  }
}

// R consecutive elements at p (aligned to R elements) as floats, in one load
// where they fill 4, 8 or 16 bytes.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = p[q];
  }
}
template <int R>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    x[0] = a.x; x[1] = a.y; x[2] = c.x; x[3] = c.y;
  } else if constexpr (R == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = __bfloat162float(p[q]);
  }
}

// ------------------------------------------------------------ per-step form
// One step on the thread's R rows of one column; returns its part of out.
template <int R>
__device__ __forceinline__ float wkv_step(float (&S)[R], const float (&ui)[R],
                                          const float (&rt)[R], const float (&kt)[R],
                                          const float (&wt)[R], float vj) {
  float p = 0.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float kv = kt[q] * vj;
    p = fmaf(rt[q], S[q] + ui[q] * kv, p);
    S[q] = fmaf(wt[q], S[q], kv);
  }
  return p;
}

// The sum of p over a column's 16 lanes.
__device__ __forceinline__ float column_sum(float p) {
#pragma unroll
  for (int m = 1; m < LPC; m <<= 1) p += __shfl_xor_sync(FULL, p, m);
  return p;
}

// One round of a reduce-scatter: lane l keeps the M sums whose index has
// bit M of l, taking its partner's half with a shuffle.
template <int M>
__device__ __forceinline__ void scatter_round(float (&p)[SUB], int l) {
  const bool hi = (l & M) != 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float send = hi ? p[j] : p[j + M];
    const float keep = hi ? p[j + M] : p[j];
    p[j] = keep + __shfl_xor_sync(FULL, send, M);
  }
}
// Lane l of a column returns the column's sum of p[l]: 15 shuffles for the
// 16 sums.
__device__ __forceinline__ float reduce_scatter16(float (&p)[SUB], int l) {
  scatter_round<8>(p, l);
  scatter_round<4>(p, l);
  scatter_round<2>(p, l);
  scatter_round<1>(p, l);
  return p[0];
}

// CGW value columns a block, 16 lanes a column (half a warp), each lane
// R = N / 16 consecutive key rows of its column, so a column's out sum stays
// inside a warp and no step needs a barrier.
template <typename T, int N, int CGW>
__global__ void __launch_bounds__(CGW * LPC)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ sT, int Tn, int H) {
  constexpr int NT = CGW * LPC, R = N / LPC, C4 = CGW / 4;
  __shared__ __align__(16) T rs[2][SUB * N];
  __shared__ __align__(16) T ks[2][SUB * N];
  __shared__ __align__(16) T vs[2][SUB * CGW];
  __shared__ __align__(16) float ws[2][SUB * N];
  __shared__ float st[N][CGW + 1];        // the state tile, for coalesced copies
  const int tid = threadIdx.x, cl = tid % LPC, jl = tid / LPC, i0 = cl * R;
  const int bh = blockIdx.x, g = blockIdx.y, b = bh / H, h = bh % H;
  const long HN = (long)H * N, obase = (long)h * N + g * CGW + jl;
  const long tile = (long)bh * N * N + g * CGW;
  constexpr int TL = (N * C4 + NT - 1) / NT;   // float4s of the tile a thread
  float4 tq[TL];
#pragma unroll
  for (int m = 0; m < TL; ++m) {
    const int e = tid + m * NT, ti = e / C4, c4 = (e % C4) * 4;
    tq[m] = s0 != nullptr && e < N * C4
        ? *reinterpret_cast<const float4*>(s0 + tile + (long)ti * N + c4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float ui[R], S[R];
#pragma unroll
  for (int q = 0; q < R; ++q) ui[q] = u[(long)h * N + i0 + q];
  // the first step's (or window's) inputs are requested before anything
  // waits on the state, so the two loads share one round trip
  float rt[R], kt[R], wt[R], vj = 0.f;
  auto fetch = [&](int t) {
    const long row = ((long)b * Tn + t) * HN + (long)h * N;
    load_rows<R>(r + row + i0, rt);
    load_rows<R>(k + row + i0, kt);
    load_rows<R>(w + row + i0, wt);
    vj = to_f(v[row + g * CGW + jl]);
  };
  if (Tn < SUB) {
    if (Tn > 0) fetch(0);
  } else {
    stage_window<T, N, CGW, NT>(rs[0], ks[0], ws[0], vs[0], r, k, v, w, b, h, g, 0, Tn, H);
    tc::cp_async_commit();
  }
#pragma unroll
  for (int m = 0; m < TL; ++m) {
    const int e = tid + m * NT, ti = e / C4, c4 = (e % C4) * 4;
    if (e < N * C4) {
      st[ti][c4] = tq[m].x; st[ti][c4 + 1] = tq[m].y;
      st[ti][c4 + 2] = tq[m].z; st[ti][c4 + 3] = tq[m].w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < R; ++q) S[q] = st[i0 + q][jl];

  if (Tn < SUB) {
    // decode and short prompts: each step's rows straight from device
    // memory, the next step's loads in flight during this one
    for (int t = 0; t < Tn; ++t) {
      const float p = wkv_step<R>(S, ui, rt, kt, wt, vj);
      if (t + 1 < Tn) fetch(t + 1);
      const float o = column_sum(p);
      if (cl == 0) out[((long)b * Tn + t) * HN + obase] = o;
    }
  } else {
    // windows of 16 steps staged in shared memory, the next one in flight
    const int nwin = (Tn + SUB - 1) / SUB;
    for (int c = 0; c < nwin; ++c) {
      const int cur = c & 1, t0 = c * SUB, Tc = min(SUB, Tn - t0);
      if (c + 1 < nwin) {
        stage_window<T, N, CGW, NT>(rs[cur ^ 1], ks[cur ^ 1], ws[cur ^ 1], vs[cur ^ 1], r,
                                    k, v, w, b, h, g, t0 + SUB, Tn, H);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      if (Tc == SUB) {
        // all 16 steps unrolled, their out parts summed once at the end
        float p[SUB];
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          float rt[R], kt[R], wt[R];
          load_rows<R>(rs[cur] + t * N + i0, rt);
          load_rows<R>(ks[cur] + t * N + i0, kt);
          load_rows<R>(ws[cur] + t * N + i0, wt);
          p[t] = wkv_step<R>(S, ui, rt, kt, wt, to_f(vs[cur][t * CGW + jl]));
        }
        const float o = reduce_scatter16(p, cl);         // the sum for step cl
        out[((long)b * Tn + t0 + cl) * HN + obase] = o;
      } else {
        for (int t = 0; t < Tc; ++t) {
          float rt[R], kt[R], wt[R];
          load_rows<R>(rs[cur] + t * N + i0, rt);
          load_rows<R>(ks[cur] + t * N + i0, kt);
          load_rows<R>(ws[cur] + t * N + i0, wt);
          const float o = column_sum(
              wkv_step<R>(S, ui, rt, kt, wt, to_f(vs[cur][t * CGW + jl])));
          if (cl == 0) out[((long)b * Tn + t0 + t) * HN + obase] = o;
        }
      }
      __syncthreads();           // the next window's copy overwrites this buffer
    }
  }
  __syncthreads();               // every read of the tile is done
#pragma unroll
  for (int q = 0; q < R; ++q) st[i0 + q][jl] = S[q];
  __syncthreads();
  for (int e = tid; e < N * C4; e += NT) {
    const int ti = e / C4, c4 = (e % C4) * 4;
    *reinterpret_cast<float4*>(sT + tile + (long)ti * N + c4) =
        make_float4(st[ti][c4], st[ti][c4 + 1], st[ti][c4 + 2], st[ti][c4 + 3]);
  }
}

// Columns a block for head size N: at rwkv6-3b (N = 64) 32, so 512 threads
// and 80 blocks, the fastest of the shapes timed on the H100 at T = 1, 16,
// 64 and 2,048 (8, 16 or 32 columns; 16 or 32 lanes a column).
template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* out, void* sT, int B, int Tn,
                     int H, cudaStream_t stream) {
  constexpr int CGW = N < 32 ? N : 32;
  wkv6_step_kernel<T, N, CGW><<<dim3(B * H, N / CGW), CGW * LPC, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sT),
      Tn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sT, int B, int Tn,
                   int H, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_n<T, 16>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 32: return launch_n<T, 32>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 64: return launch_n<T, 64>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  r, k, v, w, out: contiguous
// [B,T,H,N]; u: [H,N]; s0 (may be null) and sT: [B,H,N,N]; w, u, s0, out and
// sT are float32.  r, k, v, w, s0 and sT start on 16 bytes.
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
