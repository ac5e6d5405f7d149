// Forward GQA flash attention for Hopper (sm_90a), SIMT fp32 arithmetic.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py.  Same function:
// q [B,Sq,H,D], k and v [B,Skv,Hkv,D] (head h reads kv head h / (H/Hkv)),
// online softmax with m, l and the accumulator in fp32, causal and
// sliding-window masks on absolute positions with aligned ends
// (q_offset = Skv - Sq), output in q's dtype.
//
// Design.  The Pallas grid walks KV blocks as a sequential grid axis with
// the running max/sum/accumulator in VMEM scratch.  Blocks here run in
// parallel and in no order, so the KV walk is a loop inside one thread
// block: one block per (q tile of 64 rows, head, batch), K and V tiles of 64
// rows staged in shared memory (converted to fp32), the 64x64 score tile
// computed by 256 threads as 4x4 register micro-tiles (thread (ty, tx) owns
// rows ty+16i and columns tx+16j), row max and row sum reduced with
// shuffles across the 16 lanes that share a row, P written to shared memory
// for the P@V product, and the output accumulator (rows ty+16i, columns
// tx+16j of D) kept in registers across the whole KV walk.  KV tiles that
// lie wholly outside the causal or window mask are never visited (the loop
// bounds are computed from the tile's positions, as `pl.when(run)` skips
// them on the TPU).  Ragged tails are masked in the kernel: rows past Sq are
// loaded as zeros and never stored, columns past Skv are masked out, so no
// shape has to divide the tile (the Pallas kernel asserts it does).
//
// What bounds it on the H100.  At the serving prefill (Sq = Skv = 16) the
// launch and the single partial tile dominate; at long prompts the score and
// P@V products dominate and this kernel does them on the fp32 SIMT pipes
// (67 TFLOP/s peak) from shared memory, not on the tensor cores (989 TFLOP/s
// bf16), so it is bound by operations far above the card's floor.  The next
// step is mma/wgmma on bf16 tiles fed by TMA; this version is the simple
// right one.
//
// C entry point: flash_attention_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Skv, int H, int Hkv, int causal, int window,
                 float scale) {
  constexpr int DP = D + 1;        // padded row: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][DP]
  float* Ks = Qs + BQ * DP;        // [BK][DP]
  float* Vs = Ks + BK * DP;        // [BK][D]
  float* Ps = Vs + BK * D;         // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q_offset = Skv - Sq;
  const long q_rs = (long)H * D;
  const long kv_rs = (long)Hkv * D;
  const T* qb = q + (long)b * Sq * q_rs + (long)h * D;
  const T* kb = k + (long)b * Skv * kv_rs + (long)hk * D;
  const T* vb = v + (long)b * Skv * kv_rs + (long)hk * D;
  T* ob = o + (long)b * Sq * q_rs + (long)h * D;

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
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      const bool in = ki < Skv;
      Ks[r * DP + d] = in ? to_f(kb[(long)ki * kv_rs + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[(long)ki * kv_rs + d]) : 0.f;
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
        const float vv = Vs[c * D + tx + 16 * j];
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
      ob[(long)qi * q_rs + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, causal, window, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Skv, int H, int Hkv, int D, int causal,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous [B,S,heads,D].
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int Hkv, int D, int dtype, int causal,
                                   int window, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
