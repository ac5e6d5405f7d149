// AdamW over a tree of tensors in two launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's optimizer (src/repro/optim/adamw.py)
// is jnp code that XLA fuses.  It was added because the port's plain update
// (kernels/adamw/ref.py) launches about 21 elementwise kernels a leaf over f32
// temporaries, plus 3 a leaf for the global norm: about 202 bytes of device
// memory a bf16 parameter, where the update needs 24.
//
// What bounds it on the H100.  Bytes.  The update reads g, p, m and v and
// writes p, m and v: 2 + 2 + 4 + 4 + 2 + 4 + 4 = 22 bytes a bf16 parameter
// with f32 moments; the global norm reads g once more, 2 bytes: 24 in all.
// At internlm2-1.8b's 1.89 B parameters that is 45.4 GB, 13.5 ms at 3.35 TB/s.
// Nothing is computed twice and no intermediate goes through device memory,
// so the design's whole task is to keep the loads streaming:
//
//   * The tree is cut into chunks of CHUNK elements, each inside one leaf.  A
//     block takes one chunk and finds its leaf by the first-chunk indices of
//     the leaf table; its threads walk the chunk 8 elements at a time with
//     16-byte loads and stores (one of bf16, two of f32), neighbouring threads
//     on neighbouring addresses.  A leaf whose pointers are not all 16-byte
//     aligned, and a leaf's last group of fewer than 8, go element by element.
//     Every load and store is streaming (evict-first): nothing is read twice
//     within a pass.
//   * The leaf table (pointers, element counts, dtype codes) travels by value
//     in the kernel's parameters (__grid_constant__, under 4 KB), so nothing is
//     uploaded a step; a tree of more than MAX_LEAVES leaves takes one launch
//     a table.  Element offsets are 64-bit: a tree may hold more than 2^31.
//   * adamw_norm: each block writes the f64 sum of squares of its chunk's
//     gradients into a scratch buffer; the block that finishes last (a counter
//     zeroed before the launch) sums every partial in a fixed order and writes
//     gnorm and clip = min(grad_clip / max(gnorm, 1e-9), 1) as device scalars.
//     The partition into chunks is fixed, so a run gives the same bits every
//     time, and the f64 sums keep gnorm within 1e-5 of the plain f32 sum.
//   * adamw_update: reads clip, the bias corrections b1c, b2c and the learning
//     rate from device pointers (no host sync), and follows the plain
//     version's tensor expression in its order, each product, sum, quotient
//     and square root rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
//     __fsqrt_rn: nvcc's default contraction into fused multiply-adds would
//     change bits).  The f32 constants are those PyTorch applies: b1, 1 - b1
//     (computed in double by the caller), b2, 1 - b2, eps and the weight decay,
//     each rounded to f32.  Given the same clip, p, m and v come out equal bit
//     for bit to the plain version's on the card.  p goes back to its dtype
//     with __float2bfloat16_rn, as PyTorch's cast does.
//
// Dtypes: p bf16 or f32, g bf16 or f32 (independently: accumulated
// microbatch gradients are f32), m and v f32.
//
// C entry points return cudaGetLastError() (or the error of the call that
// failed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                                   // threads a block
constexpr int VEC = 8;                                    // elements a thread takes at once
constexpr int ITERS = 16;                                 // groups of VEC a thread walks a chunk
constexpr long long CHUNK = (long long)NT * VEC * ITERS;  // 32,768 elements a block
constexpr int MAX_LEAVES = 48;                            // an update table: 48 x 72 bytes

constexpr int P_BF16 = 1, G_BF16 = 2, ALIGNED = 4;        // leaf codes

struct NormLeaf {
  const void* g;
  long long n;
  int first_chunk;
  int code;
};

struct NormTable {
  NormLeaf leaf[MAX_LEAVES];
  int count;
  int chunks;
};

struct UpdLeaf {
  const void* g;
  const void* p;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long n;
  int first_chunk;
  int code;
};

struct UpdTable {
  UpdLeaf leaf[MAX_LEAVES];
  int count;
  int chunks;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr_value;
  const float* clip;
  const float* b1c;
  const float* b2c;
  const float* lr;   // null: lr_value
};

// The leaf that holds chunk c (leaves of no elements hold no chunk).
template <class Table>
__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int l = 0;
  while (l + 1 < t.count && c >= t.leaf[l + 1].first_chunk) ++l;
  return l;
}

// ---------------------------------------------------------------- loads, stores
// uint16_t holds bf16 bits; bf16 -> f32 is exact.
__device__ __forceinline__ float bf16_to_f(uint32_t bits) { return __uint_as_float(bits << 16); }
__device__ __forceinline__ uint32_t f_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const uint16_t* p, float (&x)[VEC]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {            // element 2i in the low half of word i
    x[2 * i] = bf16_to_f(w[i] & 0xffffu);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ void store8(uint16_t* p, const float (&x)[VEC]) {
  uint4 u;
  u.x = f_to_bf16(x[0]) | (f_to_bf16(x[1]) << 16);
  u.y = f_to_bf16(x[2]) | (f_to_bf16(x[3]) << 16);
  u.z = f_to_bf16(x[4]) | (f_to_bf16(x[5]) << 16);
  u.w = f_to_bf16(x[6]) | (f_to_bf16(x[7]) << 16);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return bf16_to_f(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store1(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store1(uint16_t* p, float x) {
  __stcs(reinterpret_cast<unsigned short*>(p), static_cast<unsigned short>(f_to_bf16(x)));
}

// --------------------------------------------------------------------- the norm
// Sum over the block's threads; thread 0 holds the result.  Fixed order.
__device__ __forceinline__ double block_sum(double s, double* shm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) shm[w] = s;
  __syncthreads();
  s = threadIdx.x < NT / 32 ? shm[threadIdx.x] : 0.0;
  if (w == 0) {
#pragma unroll
    for (int o = NT / 64; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

template <typename G>
__device__ __forceinline__ double sumsq_chunk(const G* g, long long lo, long long hi,
                                              bool aligned) {
  double s = 0.0;
  for (long long i = lo + (long long)threadIdx.x * VEC; i < hi; i += (long long)NT * VEC) {
    float q = 0.f;
    if (aligned && i + VEC <= hi) {
      float x[VEC];
      load8(g + i, x);
#pragma unroll
      for (int u = 0; u < VEC; ++u) q = __fmaf_rn(x[u], x[u], q);
    } else {
      const int e = (int)min((long long)VEC, hi - i);
      for (int u = 0; u < e; ++u) {
        const float x = load1(g + i + u);
        q = __fmaf_rn(x, x, q);
      }
    }
    s += (double)q;
  }
  return s;
}

__global__ void __launch_bounds__(NT)
norm_kernel(const __grid_constant__ NormTable t, double* __restrict__ partials,
            int part_offset, unsigned* __restrict__ counter, int finish, float grad_clip,
            float* __restrict__ gnorm, float* __restrict__ clip) {
  __shared__ double shm[NT / 32];
  __shared__ bool last;
  const int c = blockIdx.x;
  double s = 0.0;
  if (c < t.chunks) {
    const NormLeaf& L = t.leaf[leaf_of(t, c)];
    const long long lo = (long long)(c - L.first_chunk) * CHUNK;
    const long long hi = min(lo + CHUNK, L.n);
    const bool aligned = (L.code & ALIGNED) != 0;
    s = (L.code & G_BF16) ? sumsq_chunk(static_cast<const uint16_t*>(L.g), lo, hi, aligned)
                          : sumsq_chunk(static_cast<const float*>(L.g), lo, hi, aligned);
  }
  s = block_sum(s, shm);
  if (!finish) {
    if (threadIdx.x == 0) partials[part_offset + c] = s;
    return;
  }
  if (threadIdx.x == 0) {
    partials[part_offset + c] = s;
    __threadfence();                       // the partial is visible before the ticket
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int total = part_offset + (int)gridDim.x;
  double a = 0.0;
  for (int i = threadIdx.x; i < total; i += NT) a += __ldcg(partials + i);
  a = block_sum(a, shm);
  if (threadIdx.x == 0) {
    const float n = (float)sqrt(a);
    *gnorm = n;
    // torch.clamp(gnorm, min=1e-9), then grad_clip / it as PyTorch computes
    // a scalar over a tensor (reciprocal, then product), then clamp(max=1);
    // NaN passes both clamps, as in torch.clamp
    const float d = n < 1e-9f ? 1e-9f : n;
    const float r = __fmul_rn(__frcp_rn(d), grad_clip);
    *clip = r > 1.f ? 1.f : r;
  }
}

// ------------------------------------------------------------------- the update
struct Consts {
  float b1, omb1, b2, omb2, eps, wd, clip, b1c, b2c, lr;
};

// One element: the plain version's
//   g = g * clip; m = b1 m + (1 - b1) g; v = b2 v + ((1 - b2) g) g
//   p' = p - lr ((m / b1c) / (sqrt(v / b2c) + eps) + wd p)
__device__ __forceinline__ float adamw1(float g, float p, float& m, float& v, const Consts& k) {
  g = __fmul_rn(g, k.clip);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.b2c)), k.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, k.b1c), den), __fmul_rn(k.wd, p));
  return __fsub_rn(p, __fmul_rn(k.lr, delta));
}

template <typename P, typename G>
__device__ __forceinline__ void update_chunk(const UpdLeaf& L, long long lo, long long hi,
                                             const Consts& k) {
  const G* g = static_cast<const G*>(L.g);
  const P* p = static_cast<const P*>(L.p);
  P* po = static_cast<P*>(L.p_out);
  const bool aligned = (L.code & ALIGNED) != 0;
  for (long long i = lo + (long long)threadIdx.x * VEC; i < hi; i += (long long)NT * VEC) {
    if (aligned && i + VEC <= hi) {
      float gv[VEC], pv[VEC], mv[VEC], vv[VEC];
      load8(g + i, gv);
      load8(p + i, pv);
      load8(L.m + i, mv);
      load8(L.v + i, vv);
#pragma unroll
      for (int u = 0; u < VEC; ++u) pv[u] = adamw1(gv[u], pv[u], mv[u], vv[u], k);
      store8(po + i, pv);
      store8(L.m_out + i, mv);
      store8(L.v_out + i, vv);
    } else {
      const int e = (int)min((long long)VEC, hi - i);
      for (int u = 0; u < e; ++u) {
        const long long j = i + u;
        float m = load1(L.m + j), v = load1(L.v + j);
        store1(po + j, adamw1(load1(g + j), load1(p + j), m, v, k));
        store1(L.m_out + j, m);
        store1(L.v_out + j, v);
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
update_kernel(const __grid_constant__ UpdTable t, const __grid_constant__ Hyper h) {
  const int c = blockIdx.x;
  const UpdLeaf& L = t.leaf[leaf_of(t, c)];
  const Consts k{h.b1, h.omb1, h.b2, h.omb2, h.eps, h.wd, __ldg(h.clip), __ldg(h.b1c),
                 __ldg(h.b2c), h.lr != nullptr ? __ldg(h.lr) : h.lr_value};
  const long long lo = (long long)(c - L.first_chunk) * CHUNK;
  const long long hi = min(lo + CHUNK, L.n);
  switch (L.code & (P_BF16 | G_BF16)) {
    case 0: update_chunk<float, float>(L, lo, hi, k); break;
    case P_BF16: update_chunk<uint16_t, float>(L, lo, hi, k); break;
    case G_BF16: update_chunk<float, uint16_t>(L, lo, hi, k); break;
    default: update_chunk<uint16_t, uint16_t>(L, lo, hi, k); break;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// First-chunk indices of a table's leaves; false when a count is negative or
// the chunks overflow an int.
template <class Leaf>
bool lay_out(Leaf* leaf, const long long* n, int count, int* chunks) {
  long long c = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0) return false;
    leaf[i].n = n[i];
    leaf[i].first_chunk = (int)c;
    c += (n[i] + CHUNK - 1) / CHUNK;
    if (c > INT_MAX) return false;
  }
  *chunks = (int)c;
  return true;
}

}  // namespace

// The table size and the chunk, for the wrapper's tables and scratch.
extern "C" int adamw_limits(int* max_leaves, long long* chunk) {
  *max_leaves = MAX_LEAVES;
  *chunk = CHUNK;
  return 0;
}

// Pass 1 over one table of gradients: g[i] holds n[i] elements, bfloat16 when
// g_bf16[i] != 0, else float32.  Block b writes partials[part_offset + b]
// (float64; one block a chunk, or one block for a table of no elements).
// With finish != 0 the last block also sums partials[0 .. part_offset +
// blocks) and writes gnorm and clip (float32 scalars); counter is 4 bytes of
// device memory, zeroed here before the launch.  Launch the tables in order,
// finish on the last one.
extern "C" int adamw_norm(const void* const* g, const long long* n, const int* g_bf16,
                          int count, void* partials, int part_offset, int finish,
                          void* counter, float grad_clip, void* gnorm, void* clip,
                          void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this call's
  if (count < 0 || count > MAX_LEAVES || part_offset < 0) return (int)cudaErrorInvalidValue;
  NormTable t{};
  if (!lay_out(t.leaf, n, count, &t.chunks)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    t.leaf[i].g = g[i];
    t.leaf[i].code = (g_bf16[i] ? G_BF16 : 0) | (aligned16(g[i]) ? ALIGNED : 0);
  }
  t.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (finish) {
    const cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
  }
  norm_kernel<<<t.chunks > 0 ? t.chunks : 1, NT, 0, s>>>(
      t, static_cast<double*>(partials), part_offset, static_cast<unsigned*>(counter), finish,
      grad_clip, static_cast<float*>(gnorm), static_cast<float*>(clip));
  return (int)cudaGetLastError();
}

// Pass 2 over one table: ptrs holds 7 a leaf (g, p, m, v, p_out, m_out,
// v_out), n[i] elements each; codes[i] is 1 for a bfloat16 p (else float32)
// plus 2 for a bfloat16 g (else float32); m, v and their outputs are float32.
// clip, b1c, b2c: float32 device scalars; lr: one too, or null for lr_value.
// A table of no elements launches nothing.
extern "C" int adamw_update(const void* const* ptrs, const long long* n, const int* codes,
                            int count, float b1, float omb1, float b2, float omb2, float eps,
                            float wd, const void* clip, const void* b1c, const void* b2c,
                            const void* lr, float lr_value, void* stream) {
  cudaGetLastError();
  if (count < 0 || count > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  UpdTable t{};
  if (!lay_out(t.leaf, n, count, &t.chunks)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    const void* const* q = ptrs + 7 * i;
    UpdLeaf& L = t.leaf[i];
    L.g = q[0];
    L.p = q[1];
    L.m = static_cast<const float*>(q[2]);
    L.v = static_cast<const float*>(q[3]);
    L.p_out = const_cast<void*>(q[4]);
    L.m_out = static_cast<float*>(const_cast<void*>(q[5]));
    L.v_out = static_cast<float*>(const_cast<void*>(q[6]));
    bool al = true;
    for (int j = 0; j < 7; ++j) al = al && aligned16(q[j]);
    L.code = (codes[i] & (P_BF16 | G_BF16)) | (al ? ALIGNED : 0);
  }
  t.count = count;
  if (t.chunks == 0) return 0;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, lr_value,
                static_cast<const float*>(clip), static_cast<const float*>(b1c),
                static_cast<const float*>(b2c), static_cast<const float*>(lr)};
  update_kernel<<<t.chunks, NT, 0, static_cast<cudaStream_t>(stream)>>>(t, h);
  return (int)cudaGetLastError();
}
