// Forward GQA flash attention for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on the SIMT pipes.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py.  Same function:
// q [B,Sq,H,D], k and v [B,Skv,Hkv,D] (head h reads kv head h / (H/Hkv)),
// online softmax with m, l and the accumulator in fp32, causal and
// sliding-window masks on absolute positions, output in q's dtype.  Query
// row i sits at position q_offset + i (the Pallas body's `q_offset`): the
// wrapper passes Skv - Sq (aligned ends, a whole prefill) or, for one
// sequence shard of a prefill, Skv - S plus the shard's first row.  Beyond
// the Pallas kernel: values may be narrower than keys (v [B,Skv,Hkv,DV],
// out [B,Sq,H,DV]; latent attention's expanded prefill is qk 192 / v 128),
// and the softmax scale is an argument (0 means 1/sqrt(D)).  Each (D, DV)
// is its own instantiation, so the key width's products and the value
// width's accumulator are sized apart: nothing is padded.
//
// Design.  The Pallas grid walks KV blocks as a sequential grid axis with
// the running max/sum/accumulator in VMEM scratch.  Blocks here run in
// parallel and in no order, so the KV walk is a loop inside one thread
// block, one block per (q tile of 64 rows, head, batch).  KV tiles that lie
// wholly outside the causal or window mask are never visited (the loop
// bounds are computed from the tile's positions, as `pl.when(run)` skips
// them on the TPU).  Ragged tails are masked in the kernel: rows past Sq are
// loaded as zeros and never stored, columns past Skv are masked out, so no
// shape has to divide the tile (the Pallas kernel asserts it does).
//
//  - bf16 (pointers 16-byte aligned): four warps, each owning 16 query rows.
//    Q, and K and V tiles of 64 keys (32 at D = 256), come into shared
//    memory by 16-byte cp.async, K and V double-buffered so that the copy of
//    tile j+1 overlaps the products of tile j.  S = Q.K^T and O += P.V run
//    on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix; S, the
//    online softmax (m, l, alpha) and O stay in fp32 registers, and l is
//    summed from the fp32 p, as in the Pallas kernel.  The S accumulator of
//    two n8 tiles is, lane for lane, the A fragment of the next product, so
//    P never leaves registers.  P enters P.V as two bf16 terms, hi = bf16(p)
//    and lo = bf16(p - hi), about 16 significant bits: the Pallas kernel
//    rounds p to bf16 once, but with that rounding the reduced decoders'
//    card-vs-CPU check (whose plain attention keeps P in fp32) failed on
//    gemma3 (logits 2.6e-2 apart, a greedy token flipped).  The lo term
//    costs one more mma per P.V mma.  Q tiles are the slowest grid
//    axis, issued last tile first, so the causal tiles with the most KV
//    tiles start first on every head; a KV tile wholly inside the mask skips
//    the per-element test.  At D = 256 the O accumulator alone is 128 fp32
//    registers a thread, hence the narrower KV tile there (255 registers and
//    a 24-byte spill remain at D = 256; none at D <= 128).
//  - f32: the SIMT kernel of the first port.  K and V tiles of 64 rows staged
//    in shared memory (fp32), the 64x64 score tile computed by 256 threads
//    as 4x4 register micro-tiles, P through shared memory, the output
//    accumulator in registers.  TF32 would miss the 2e-5 f32 contract, so f32
//    stays off the tensor cores.
//
// What bounds it on the H100.  At the serving prefill (Sq = Skv = 16) the
// launch and the single partial tile dominate.  At a 2,048-token causal
// prompt (H = 16, Hkv = 8, D = 128) the work is 17.2 GFLOP against 25 MB:
// operations-bound, 0.0174 ms at the 989 TFLOP/s bf16 peak.  mma.sync issues
// at a fraction of that peak; wgmma fed by TMA, with warp specialisation, is
// the way to the rest.  Head dims 16, 32, 64, 128 and 256 are instantiated
// with DV = D, and (192, 128).  At a 16,384-token MLA prefill (H = Hkv = 16,
// qk 192, v 128) the work is 2 * 16 * (192 + 128) operations a (query, key)
// pair over 134 M causal pairs: 1.37 TFLOP, 1.39 ms at the bf16 peak.
//
// C entry point: flash_attention_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * DV + BQ * (BK + 1));
}
// The largest head dim keeps the same fp32 layout: 213,760 bytes at D = 256
// (recurrentgemma's local-attention blocks), under the 232,448-byte opt-in.
static_assert(smem_bytes<256, 256>() <= 232448, "flash tile exceeds the smem opt-in");

template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  int Sq, int Skv, int H, int Hkv, int q_offset, int causal,
                  int window, float scale) {
  constexpr int DP = D + 1;        // padded row: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int DJ = DV / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][DP]
  float* Ks = Qs + BQ * DP;        // [BK][DP]
  float* Vs = Ks + BK * DP;        // [BK][DV]
  float* Ps = Vs + BK * DV;        // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long q_rs = (long)H * D;
  const long kv_rs = (long)Hkv * D;
  const long v_rs = (long)Hkv * DV;
  const long o_rs = (long)H * DV;
  const T* qb = q + (long)b * Sq * q_rs + (long)h * D;
  const T* kb = k + (long)b * Skv * kv_rs + (long)hk * D;
  const T* vb = v + (long)b * Skv * v_rs + (long)hk * DV;
  T* ob = o + (long)b * Sq * o_rs + (long)h * DV;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < Sq ? to_f(qb[(long)qi * q_rs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that can hold an unmasked entry for some row of this q tile.
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window) kt_begin = max(0, q_first - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // previous tile's Ks/Vs/Ps reads are done
    if constexpr (D == DV) {
      for (int i = tid; i < BK * D; i += NT) {
        const int r = i / D, d = i % D;
        const int ki = k0 + r;
        const bool in = ki < Skv;
        Ks[r * DP + d] = in ? to_f(kb[(long)ki * kv_rs + d]) : 0.f;
        Vs[r * D + d] = in ? to_f(vb[(long)ki * kv_rs + d]) : 0.f;
      }
    } else {
      for (int i = tid; i < BK * D; i += NT) {
        const int r = i / D, d = i % D;
        const int ki = k0 + r;
        Ks[r * DP + d] = ki < Skv ? to_f(kb[(long)ki * kv_rs + d]) : 0.f;
      }
      for (int i = tid; i < BK * DV; i += NT) {
        const int r = i / DV, d = i % DV;
        const int ki = k0 + r;
        Vs[r * DV + d] = ki < Skv ? to_f(vb[(long)ki * v_rs + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[r * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * DV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long)qi * o_rs + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

// ------------------------------------------------------------ tensor cores
using bf16 = __nv_bfloat16;
constexpr int TC_NT = 128;    // four warps of 16 query rows

template <int D, int DV>
struct FlashTC {
  // keys a tile: the O accumulator (DV / 2 fp32 registers a thread) sets it
  static constexpr int BKV = DV > 128 ? 32 : 64;
  static constexpr int LD = D + 8;                // padded rows: conflict-free ldmatrix
  static constexpr int LDV = DV + 8;
  static constexpr size_t SMEM =
      sizeof(bf16) * (size_t)(BQ * LD + 2 * BKV * LD + 2 * BKV * LDV);
};
static_assert(FlashTC<256, 256>::SMEM <= 232448, "flash tile exceeds the smem opt-in");

template <int D, int DV>
__global__ void __launch_bounds__(TC_NT)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv,
                int H, int Hkv, int q_offset, int causal, int window,
                float scale_log2) {
  constexpr int BKV = FlashTC<D, DV>::BKV, LD = FlashTC<D, DV>::LD;
  constexpr int LDV = FlashTC<D, DV>::LDV;
  constexpr int NST = BKV / 8;     // n8 tiles of S a warp
  constexpr int NDT = DV / 8;      // n8 tiles of O a warp
  constexpr int CH = D / 8;        // 16-byte chunks a q or k row
  constexpr int CHV = DV / 8;      // 16-byte chunks a v row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                         // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                    // [2][BKV][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // q tiles are the slowest grid axis, issued last tile first: the causal
  // tiles with the most KV tiles start first on every head
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const long q_rs = (long)H * D;
  const long kv_rs = (long)Hkv * D;
  const long v_rs = (long)Hkv * DV;
  const long o_rs = (long)H * DV;
  const bf16* qb = q + (long)b * Sq * q_rs + (long)h * D;
  const bf16* kb = k + (long)b * Skv * kv_rs + (long)hk * D;
  const bf16* vb = v + (long)b * Skv * v_rs + (long)hk * DV;
  bf16* ob = o + (long)b * Sq * o_rs + (long)h * DV;

  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < Sq;
    tc::cp_async16(Qs + r * LD + c, ok ? qb + (long)(q0 + r) * q_rs + c : qb, ok);
  }
  auto load_kv = [&](int buf, int kt) {
    const int k0 = kt * BKV;
    bf16* ks = Ks + buf * BKV * LD;
    bf16* vs = Vs + buf * BKV * LDV;
    if constexpr (D == DV) {
      for (int i = tid; i < BKV * CH; i += TC_NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = k0 + r < Skv;
        const long off = ok ? (long)(k0 + r) * kv_rs + c : 0;
        tc::cp_async16(ks + r * LD + c, kb + off, ok);
        tc::cp_async16(vs + r * LD + c, vb + off, ok);
      }
    } else {
      for (int i = tid; i < BKV * CH; i += TC_NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = k0 + r < Skv;
        tc::cp_async16(ks + r * LD + c, kb + (ok ? (long)(k0 + r) * kv_rs + c : 0), ok);
      }
      for (int i = tid; i < BKV * CHV; i += TC_NT) {
        const int r = i / CHV, c = (i % CHV) * 8;
        const bool ok = k0 + r < Skv;
        tc::cp_async16(vs + r * LDV + c, vb + (ok ? (long)(k0 + r) * v_rs + c : 0), ok);
      }
    }
  };

  // KV tiles that can hold an unmasked entry for some row of this q tile.
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  int kt_end = (Skv + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, q_last / BKV + 1);
  int kt_begin = 0;
  if (window) kt_begin = max(0, q_first - window + 1) / BKV;

  if (kt_begin < kt_end) load_kv(0, kt_begin);
  tc::cp_async_commit();                       // group: Q and the first KV tile

  // this lane's rows: row0 (accumulator pairs c0, c1) and row0 + 8 (c2, c3)
  const int row0 = q0 + warp * 16 + g;
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(buf ^ 1, kt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                    // tile kt (and Q) landed
    __syncthreads();
    const bf16* ks = Ks + buf * BKV * LD;
    const bf16* vs = Vs + buf * BKV * LDV;

    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      tc::ldsm_x4(a, tc::a_frag_ptr(Qs, LD, warp * 16, kk, lane));
#pragma unroll
      for (int j = 0; j < NST; j += 2) {
        uint32_t bb[4];
        tc::ldsm_x4(bb, tc::bn_frag_ptr(ks, LD, j * 8, kk, lane));
        tc::mma_bf16(s[j], a, bb[0], bb[1]);
        tc::mma_bf16(s[j + 1], a, bb[2], bb[3]);
      }
    }

    // mask, scale to log2 units, online softmax over this lane's two rows; a
    // tile wholly inside the mask for every row of the block skips the test
    const int k0 = kt * BKV;
    const bool inside = k0 + BKV <= Skv && (!causal || k0 + BKV - 1 <= q_first) &&
                        (!window || k0 > q_last - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale_log2;
        if (!inside) {
          const int qpos = row0 + 8 * (c >> 1) + q_offset;
          const int kpos = k0 + j * 8 + 2 * t + (c & 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && kpos > qpos - window;
          if (!ok) x = NEG_INF;
        }
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c >> 1]);
        sum[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P.V straight from the S accumulator (the C fragments of n8 tiles
    // 2kk and 2kk+1 are the A fragment of keys 16kk..16kk+15), P entering as
    // two bf16 terms, hi + lo, against the same V fragments
#pragma unroll
    for (int kk = 0; kk < NST / 2; ++kk) {
      uint32_t hi[4], lo[4];
      tc::split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      tc::split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        uint32_t bb[4];
        tc::ldsm_x4_trans(bb, tc::bt_frag_ptr(vs, LDV, kk * 16, j * 8, lane));
        tc::mma_bf16(acc[j], hi, bb[0], bb[1]);
        tc::mma_bf16(acc[j + 1], hi, bb[2], bb[3]);
        tc::mma_bf16(acc[j], lo, bb[0], bb[1]);
        tc::mma_bf16(acc[j + 1], lo, bb[2], bb[3]);
      }
    }
    __syncthreads();                           // buf is free for tile kt + 2
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)qi * o_rs + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int Hkv, int q_offset, int causal,
                   int window, float scale, cudaStream_t stream) {
  const bool given = scale > 0.f;
  if constexpr (sizeof(T) == 2) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    if ((any & 15) == 0) {            // cp.async moves 16-byte chunks
      constexpr size_t smem = FlashTC<D, DV>::SMEM;
      cudaError_t err = cudaFuncSetAttribute(
          flash_tc_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
      flash_tc_kernel<D, DV><<<grid, TC_NT, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, Hkv, q_offset,
          causal, window,            // log2(e) times the scale, 1 / sqrt(D) by default
          given ? 1.4426950408889634f * scale : 1.4426950408889634f / sqrtf((float)D));
      return cudaGetLastError();
    }
  }
  constexpr size_t smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_simt_kernel<T, D, DV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, q_offset, causal, window,
      given ? scale : 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Skv, int H, int Hkv, int D, int DV, int q_offset,
                       int causal, int window, float scale, cudaStream_t stream) {
#define FLASH_CASE(DQ, DVV)                                                            \
  if (D == DQ && DV == DVV)                                                            \
    return launch<T, DQ, DVV>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, \
                              scale, stream);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)      // latent attention's expanded prefill
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous [B,S,heads,width]:
// q and k of width D, v and o of width DV.  Query row i is at position
// q_offset + i; a masked call needs 0 <= q_offset and q_offset + Sq <= Skv.
// scale multiplies the scores; 0 means 1/sqrt(D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int Hkv, int D, int DV, int dtype, int q_offset,
                                   int causal, int window, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if ((causal || window) && (q_offset < 0 || q_offset > Skv - Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, DV, q_offset, causal, window,
                            scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, DV, q_offset, causal,
                                    window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
