// Decode attention of one new token per sequence, in place over the KV cache:
// RoPE of the new q and k, the append of k and v into the cache's slot, and
// attention over the cache's valid slots.
//
// It replaces no TPU kernel.  The reference's decode attention
// (src/repro/models/layers.py, attention_decode) is jnp under jit, which XLA
// fuses; the port's eager version (repro_torch/models/layers.py,
// decode_attend, kept as the plain version) upcast the whole cache to fp32,
// scored every slot, copied V and spent some 49 launches a layer on it.
//
// Bound: bytes.  A step reads each attended K and V row once (2 * D * 2
// bytes a row in bf16) and does 2 * D multiply-adds a row and head on it,
// far under the ridge of the card.  What the design does about it:
//   * one block per (sequence, KV head) reads its K rows, then its V rows,
//     once each, in the cache's dtype and in place (batch and slot strides
//     are operands, so a sliced cache needs no copy), with 16-byte loads
//     of neighbouring threads on neighbouring addresses, UNROLL rows a
//     thread in flight before it computes on them;
//   * the n_rep query heads of a KV head share the block (a team of
//     threads per row, one per head and 16-byte slice of it), so GQA / MQA
//     read K and V once: the lanes of one row load the same addresses;
//   * only the valid slots are read: n_valid of them from `first` on,
//     modulo the cache (a local layer's ring);
//   * the fp32 scores stay in shared memory between the two passes.  Where
//     they do not fit, or where the sequences times KV heads give too few
//     blocks to fill the card, the host splits the slots into chunks: a
//     first launch writes the chunks' scores and their max and sum to
//     scratch (L2), a second normalizes with the softmax of all chunks,
//     sums its chunk's values, and the last chunk of a row to finish adds
//     the chunks' partial sums in order.
//
// The reference's rounding points are kept: q and k after RoPE rounded to
// the cache dtype, q * scale rounded to it, scores accumulated in fp32, the
// fp32 softmax normalized and then rounded to the cache dtype, the value sum
// accumulated in fp32 and rounded to the cache dtype.  RoPE uses the angles
// and the separately rounded products of the plain version (no fused
// multiply-add), so the appended keys equal its keys bit for bit.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/decode_attn.py,
// which checks the operands.  The kernel launches on the caller's stream
// and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rows a thread loads before it computes on them.
constexpr int UNROLL = 4;
// Dynamic shared memory one block may use on the H100.
constexpr int MAX_SHARED = 232448;
// Threads of a block at most (the host sizes blocks to whole rows of heads).
constexpr int MAX_THREADS = 512;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;      // (B, KV * n_rep, D) before RoPE
  const void* k_new;  // (B, KV, D) before RoPE
  const void* v_new;  // (B, KV, D)
  void* k_cache;      // (B, S, KV, D), each slot's KV * D elements contiguous
  void* v_cache;
  long long k_sb, k_ss, v_sb, v_ss;  // batch and slot strides, in elements
  const float* inv_freq;             // (D / 2,) RoPE's inverse frequencies
  void* out;                         // (B, KV * n_rep, D)
  float* scratch;                    // split launches only
  int n_bg, kv_heads, n_rep, head_dim;
  int pos, first, n_valid, s_cache;
  int n_split, chunk;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A 16-byte vector of the cache dtype as floats.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address holds the lower half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Element e of a row after RoPE at `pos`, in fp32: split halves, each
// product rounded on its own as the plain version's eager ops round them.
template <typename T>
__device__ __forceinline__ float rope(const T* row, int e, int d, int pos, const float* inv_freq) {
  const int half = d >> 1;
  const bool lo = e < half;
  const int j = lo ? e : e - half;
  const float ang = __fmul_rn(static_cast<float>(pos), inv_freq[j]);
  const float c = cosf(ang), s = sinf(ang);
  const float x = to_f(row[e]), y = to_f(row[lo ? e + half : j]);
  return lo ? __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s))
            : __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// The block's max (MAX) or sum of v, the same value in every thread.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* buf) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int nw = blockDim.x >> 5;
  __syncthreads();  // buf's previous use is over
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  v = buf[0];
  for (int i = 1; i < nw; ++i) v = MAX ? fmaxf(v, buf[i]) : v + buf[i];
  return v;
}

// One (sequence, KV head) and one chunk of its valid slots.  phase 0: the
// whole row in one launch; 1 and 2: the two launches of a split row.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) decode_attn_kernel(const Params p, const int phase) {
  using P = Pack<T>;
  constexpr int EV = P::N;                    // elements of a 16-byte vector
  constexpr int NVM = sizeof(T) == 4 ? 2 : 1;  // most vectors a thread takes of a row
  extern __shared__ __align__(16) float smem[];

  const int d = p.head_dim, nrep = p.n_rep, nslot = p.s_cache;
  const int row_vecs = d / EV;
  const int tpr = row_vecs < 32 ? row_vecs : 32;  // threads of a row and head
  const int nv = row_vecs / tpr;                  // vectors a thread takes of a row
  const int team = nrep * tpr;                    // threads of a row
  const int rpi = blockDim.x / team;              // rows the block takes at once
  const int tid = threadIdx.x;
  const int rg = tid / team, h = (tid % team) / tpr, sl = tid % tpr;
  const int bg = blockIdx.x, c = blockIdx.y;
  const int b = bg / p.kv_heads, g = bg % p.kv_heads;
  const int j0 = c * p.chunk, j1 = min(p.n_valid, j0 + p.chunk), nj = j1 - j0;
  const long long heads = (long long)p.kv_heads * nrep;

  float* qs = smem;                  // nrep * d: q after RoPE and scale
  float* sc = qs + nrep * d;         // nrep * chunk: scores, then probabilities
  float* red = sc + nrep * p.chunk;  // rpi * nrep * d: the value sums of the row groups
  float* buf = red + rpi * nrep * d;  // 32: block reductions
  float* stat = buf + 32;             // 2 * nrep: a head's max and sum (phase 2)
  int* ticket = reinterpret_cast<int*>(stat + 2 * nrep);

  // Split scratch: scores (B*KV, nrep, n_valid), chunk stats (B*KV, n_split,
  // nrep, 2), partial sums (B*KV, n_split, nrep, d), tickets (B*KV).
  float* g_sc = p.scratch;
  float* g_stat = g_sc + (size_t)p.n_bg * nrep * p.n_valid;
  float* g_part = g_stat + (size_t)p.n_bg * p.n_split * nrep * 2;
  int* g_ticket = reinterpret_cast<int*>(g_part + (size_t)p.n_bg * p.n_split * nrep * d);

  const T* kbase = static_cast<const T*>(p.k_cache) + b * p.k_sb + (long long)g * d;
  const T* vbase = static_cast<const T*>(p.v_cache) + b * p.v_sb + (long long)g * d;
  T* out = static_cast<T*>(p.out) + ((long long)b * heads + (long long)g * nrep) * d;

  if (phase != 2) {
    const T* qrow = static_cast<const T*>(p.q) + ((long long)b * heads + (long long)g * nrep) * d;
    for (int i = tid; i < nrep * d; i += blockDim.x) {
      const T r = round_to<T>(rope(qrow + (i / d) * d, i % d, d, p.pos, p.inv_freq));
      qs[i] = to_f(round_to<T>(__fmul_rn(to_f(r), p.scale)));
    }
    if (c == gridDim.y - 1) {  // the chunk of the newest slot appends it
      int slot = p.first + p.n_valid - 1;
      if (slot >= nslot) slot -= nslot;
      T* kd = static_cast<T*>(p.k_cache) + b * p.k_sb + slot * p.k_ss + (long long)g * d;
      T* vd = static_cast<T*>(p.v_cache) + b * p.v_sb + slot * p.v_ss + (long long)g * d;
      const T* kn = static_cast<const T*>(p.k_new) + ((long long)b * p.kv_heads + g) * d;
      const T* vn = static_cast<const T*>(p.v_new) + ((long long)b * p.kv_heads + g) * d;
      for (int e = tid; e < d; e += blockDim.x) {
        kd[e] = round_to<T>(rope(kn, e, d, p.pos, p.inv_freq));
        vd[e] = vn[e];
      }
    }
    if (phase == 1 && c == 0 && tid == 0) g_ticket[bg] = 0;
    __syncthreads();  // q in shared memory, the appended slot visible to the block

    float qr[NVM * EV];
#pragma unroll
    for (int v = 0; v < NVM; ++v)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        qr[v * EV + e] = v < nv ? qs[h * d + (v * tpr + sl) * EV + e] : 0.f;

    for (int base = j0; base < j1; base += rpi * UNROLL) {
      uint4 kv[UNROLL][NVM];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * rpi + rg;
        if (j < j1) {
          int idx = p.first + j;
          if (idx >= nslot) idx -= nslot;
          const uint4* src = reinterpret_cast<const uint4*>(kbase + idx * p.k_ss) + sl;
#pragma unroll
          for (int v = 0; v < NVM; ++v)
            if (v < nv) kv[u][v] = src[v * tpr];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * rpi + rg;
        float s = 0.f;
        if (j < j1) {
#pragma unroll
          for (int v = 0; v < NVM; ++v) {
            if (v < nv) {
              float f[EV];
              P::unpack(kv[u][v], f);
#pragma unroll
              for (int e = 0; e < EV; ++e) s = fmaf(qr[v * EV + e], f[e], s);
            }
          }
        }
        for (int o = tpr >> 1; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (sl == 0 && j < j1) sc[h * p.chunk + (j - j0)] = s;
      }
    }
    __syncthreads();

    for (int hh = 0; hh < nrep; ++hh) {
      float* row = sc + hh * p.chunk;
      float m = -INFINITY;
      for (int j = tid; j < nj; j += blockDim.x) m = fmaxf(m, row[j]);
      m = block_reduce<true>(m, buf);
      float l = 0.f;
      for (int j = tid; j < nj; j += blockDim.x) {
        const float e = expf(row[j] - m);
        l += e;
        if (phase == 0) row[j] = e;
      }
      l = block_reduce<false>(l, buf);
      if (phase == 0) {
        for (int j = tid; j < nj; j += blockDim.x) row[j] = to_f(round_to<T>(row[j] / l));
      } else {
        if (tid == 0) {
          float* st = g_stat + (((size_t)bg * p.n_split + c) * nrep + hh) * 2;
          st[0] = m;
          st[1] = l;
        }
        float* dst = g_sc + ((size_t)bg * nrep + hh) * p.n_valid + j0;
        for (int j = tid; j < nj; j += blockDim.x) dst[j] = row[j];
      }
    }
    if (phase == 1) return;
  } else {
    // The softmax over every chunk of the row, then this chunk's probabilities.
    for (int hh = tid; hh < nrep; hh += blockDim.x) {
      float m = -INFINITY, l = 0.f;
      for (int cc = 0; cc < p.n_split; ++cc)
        m = fmaxf(m, g_stat[(((size_t)bg * p.n_split + cc) * nrep + hh) * 2]);
      for (int cc = 0; cc < p.n_split; ++cc) {
        const float* st = g_stat + (((size_t)bg * p.n_split + cc) * nrep + hh) * 2;
        l += st[1] * expf(st[0] - m);
      }
      stat[2 * hh] = m;
      stat[2 * hh + 1] = l;
    }
    __syncthreads();
    for (int i = tid; i < nrep * nj; i += blockDim.x) {
      const int hh = i / nj, j = i % nj;
      const float s = g_sc[((size_t)bg * nrep + hh) * p.n_valid + j0 + j];
      sc[hh * p.chunk + j] = to_f(round_to<T>(expf(s - stat[2 * hh]) / stat[2 * hh + 1]));
    }
  }
  __syncthreads();  // probabilities in shared memory

  float acc[NVM * EV];
#pragma unroll
  for (int i = 0; i < NVM * EV; ++i) acc[i] = 0.f;
  for (int base = j0; base < j1; base += rpi * UNROLL) {
    uint4 vv[UNROLL][NVM];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * rpi + rg;
      if (j < j1) {
        int idx = p.first + j;
        if (idx >= nslot) idx -= nslot;
        const uint4* src = reinterpret_cast<const uint4*>(vbase + idx * p.v_ss) + sl;
#pragma unroll
        for (int v = 0; v < NVM; ++v)
          if (v < nv) vv[u][v] = src[v * tpr];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * rpi + rg;
      if (j < j1) {
        const float pj = sc[h * p.chunk + (j - j0)];
#pragma unroll
        for (int v = 0; v < NVM; ++v) {
          if (v < nv) {
            float f[EV];
            P::unpack(vv[u][v], f);
#pragma unroll
            for (int e = 0; e < EV; ++e) acc[v * EV + e] = fmaf(pj, f[e], acc[v * EV + e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NVM; ++v)
    if (v < nv)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        red[(rg * nrep + h) * d + (v * tpr + sl) * EV + e] = acc[v * EV + e];
  __syncthreads();

  for (int i = tid; i < nrep * d; i += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rpi; ++r) s += red[r * nrep * d + i];
    if (phase == 0)
      out[i] = round_to<T>(s);
    else
      g_part[((size_t)bg * p.n_split + c) * nrep * d + i] = s;
  }
  if (phase == 0) return;

  // The last chunk of the row to finish adds the chunks' sums in order.
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(g_ticket + bg, 1);
  __syncthreads();
  if (*ticket != p.n_split - 1) return;
  __threadfence();
  const float* parts = g_part + (size_t)bg * p.n_split * nrep * d;
  for (int i = tid; i < nrep * d; i += blockDim.x) {
    float s = 0.f;
    for (int cc = 0; cc < p.n_split; ++cc) s += __ldcg(parts + (size_t)cc * nrep * d + i);
    out[i] = round_to<T>(s);
  }
}

template <typename T>
int launch(const Params& p, int threads, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};  // the kernel's shared memory limit, a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SHARED);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int row_vecs = p.head_dim / Pack<T>::N;
  const int tpr = row_vecs < 32 ? row_vecs : 32;
  const int rpi = threads / (p.n_rep * tpr);
  const size_t smem = sizeof(float) * ((size_t)p.n_rep * p.head_dim * (1 + rpi) +
                                       (size_t)p.n_rep * p.chunk + 32 + 2 * p.n_rep + 4);
  if (smem > (size_t)MAX_SHARED || threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.n_bg, p.n_split);
  if (p.n_split == 1) {
    decode_attn_kernel<T><<<grid, threads, smem, stream>>>(p, 0);
    return (int)cudaGetLastError();
  }
  decode_attn_kernel<T><<<grid, threads, smem, stream>>>(p, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_kernel<T><<<grid, threads, smem, stream>>>(p, 2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0: launched).
int decode_attn(int fp32, const void* q, const void* k_new, const void* v_new, void* k_cache,
                void* v_cache, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                const float* inv_freq, void* out, float* scratch, int batch, int kv_heads,
                int n_rep, int head_dim, int pos, int first, int n_valid, int s_cache,
                int n_split, int chunk, float scale, int threads, void* stream) {
  Params p;
  p.q = q;
  p.k_new = k_new;
  p.v_new = v_new;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.inv_freq = inv_freq;
  p.out = out;
  p.scratch = scratch;
  p.n_bg = batch * kv_heads;
  p.kv_heads = kv_heads;
  p.n_rep = n_rep;
  p.head_dim = head_dim;
  p.pos = pos;
  p.first = first;
  p.n_valid = n_valid;
  p.s_cache = s_cache;
  p.n_split = n_split;
  p.chunk = chunk;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(p, threads, st) : launch<__nv_bfloat16>(p, threads, st);
}

}  // extern "C"
