// K1: bit-packed AIG cone simulator for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_fn` / `eval_batch` of
// src/repro/kernels/aig_sim.py (the Pallas kernel that evaluated every
// query of up to 14 support variables against the whole graph in a VMEM
// scratch), and serves the two contracts the reference's jnp engine
// defines, batched over the chunks of one call:
//
//   eval_mega(waves (L,M,4), pin_rows (N,), elem (K,W), rootp (Q,),
//             meta (C,6))                                  -> (Q,W)
//   sig_eval (waves (L,M,4), vals0 (N,W), meta (C,4))      -> (N,W)
//
// `waves` is the host's mega-program: every query's cone owns its own
// rows of a chunk's row space, and the instructions [kind, a, b, o] are
// packed into waves by AIG level, so the instructions of one wave are
// independent.  Each instruction computes
//     row[o] = (row[a] ^ -(kind & 1)) & (row[b] ^ -((kind >> 1) & 1)).
// Chunk c owns waves [wave_off, wave_off + wave_cnt), rows
// [row_base, row_base + row_cnt) of pin_rows / vals0 (row indices inside
// the waves and rootp are local to the chunk) and, for eval_mega, output
// rows [root_off, root_off + root_cnt).  Padding slots are
// [0, 0, 0, row_cnt - 1]: they store const0 into the chunk's last row,
// which no query reads; the duplicate writes store one value.
//
// What bounds it on the H100: not bytes or integer operations (a call
// moves a few MB at most) but latency.  Waves must run in order, and
// each wave is a dependent gather -> AND -> scatter through the row
// space.  The design attacks that latency and the card's width:
//  * Queries are independent and every instruction touches word column
//    c alone, so a launch runs one block per (chunk, word-column slice
//    [c0, c0 + cw)) and no block ever waits on another.  The host sizes
//    chunks so the grid spreads over the 132 SMs.
//  * The block's rows x cw words live in dynamic shared memory, so the
//    dependent chain runs at shared-memory latency, not L2's.  A launch
//    whose blocks would need more than 227 KB runs the same code on a
//    global-memory row space (kShared = false); the wrapper picks the
//    variant by size alone.
//  * Wave l+1's instructions are copied into a shared double buffer with
//    cp.async while wave l computes; one __syncthreads() per wave both
//    publishes the copy and orders the row writes.
// Threads take (slot, column) pairs with the column fastest, so a warp
// touches neighbouring words of a row; a ragged last slice is masked.

#include <cuda_runtime.h>
#include <stdint.h>

// Bytes of dynamic shared memory one block of the shared-row-space
// variant needs: the instruction double buffer plus max_rows x cw words.
extern "C" long k1_shared_bytes(int wave_m, int max_rows, int cw_shift) {
  return 2L * wave_m * (long)sizeof(int4) +
         (long)max_rows * (1L << cw_shift) * (long)sizeof(int32_t);
}

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy one wave's wave_m instructions into a shared buffer.
__device__ __forceinline__ void fetch_wave(int4* dst, const int4* src, int wave_m) {
  for (int s = threadIdx.x; s < wave_m; s += blockDim.x) cp_async16(dst + s, src + s);
  cp_async_commit();
}

// kMega: eval_mega (rows pinned to elementary tables, roots gathered
// out) or sig_eval (rows start from vals0, every row goes out).
// kShared: the block's row space in shared memory, else in `grows`
// (eval_mega: a (sum row_cnt, W) scratch; sig_eval: `out` itself).
template <bool kMega, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
k1_kernel(const int4* __restrict__ waves, int wave_m,
          const int32_t* __restrict__ meta, int n_slices, int cw_shift, int w,
          const int32_t* __restrict__ src, const int32_t* __restrict__ elem,
          int k, const int32_t* __restrict__ rootp, int32_t* grows,
          int32_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ibuf = reinterpret_cast<int4*>(smem);  // 2 x wave_m instructions
  const int chunk = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x - chunk * n_slices) << cw_shift;
  const int cw = 1 << cw_shift;
  const int ncol = min(cw, w - c0);
  const int32_t* m = meta + chunk * (kMega ? 6 : 4);
  const int wave_off = m[0], n_waves = m[1], row_base = m[2], n_rows = m[3];
  int32_t* rows;
  size_t stride;
  if (kShared) {
    rows = reinterpret_cast<int32_t*>(ibuf + 2 * wave_m);
    stride = cw;
  } else {
    rows = grows + (size_t)row_base * w + c0;
    stride = w;
  }
  const int4* wv = waves + (size_t)wave_off * wave_m;
  if (n_waves > 0) fetch_wave(ibuf, wv, wave_m);

  // Initial rows.  eval_mega: support rows hold elementary tables, every
  // other row 0 (the jnp engine's `where(pin >= 0, elem[clip(pin)], 0)`).
  const int n_init = n_rows << cw_shift;
  for (int p = threadIdx.x; p < n_init; p += blockDim.x) {
    const int r = p >> cw_shift;
    const int c = p & (cw - 1);
    if (c >= ncol) continue;
    int32_t v;
    if (kMega) {
      const int pin = src[row_base + r];
      v = pin >= 0 ? elem[(size_t)min(pin, k - 1) * w + c0 + c] : 0;
    } else {
      v = src[(size_t)(row_base + r) * w + c0 + c];
    }
    rows[(size_t)r * stride + c] = v;
  }

  const int total = wave_m << cw_shift;
  for (int l = 0; l < n_waves; ++l) {
    cp_async_wait_all();
    // Publishes wave l's instructions and the previous wave's rows, and
    // retires every read of the buffer the next copy overwrites.
    __syncthreads();
    if (l + 1 < n_waves) {
      fetch_wave(ibuf + ((l + 1) & 1) * wave_m, wv + (size_t)(l + 1) * wave_m, wave_m);
    }
    const int4* ins_buf = ibuf + (l & 1) * wave_m;
    for (int p = threadIdx.x; p < total; p += blockDim.x) {
      const int s = p >> cw_shift;
      const int c = p & (cw - 1);
      if (c >= ncol) continue;
      const int4 ins = ins_buf[s];  // x=kind, y=a, z=b, w=o
      const int32_t va = rows[(size_t)ins.y * stride + c] ^ -(ins.x & 1);
      const int32_t vb = rows[(size_t)ins.z * stride + c] ^ -((ins.x >> 1) & 1);
      rows[(size_t)ins.w * stride + c] = va & vb;
    }
  }
  __syncthreads();

  if (kMega) {
    // Root gather with phase: out[q] = row[rootp >> 1] ^ -(rootp & 1).
    const int root_off = m[4];
    const int n_out = m[5] << cw_shift;
    for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
      const int q = p >> cw_shift;
      const int c = p & (cw - 1);
      if (c >= ncol) continue;
      const int rp = rootp[root_off + q];
      out[(size_t)(root_off + q) * w + c0 + c] =
          rows[(size_t)(rp >> 1) * stride + c] ^ -(rp & 1);
    }
  } else if (kShared) {
    for (int p = threadIdx.x; p < n_init; p += blockDim.x) {
      const int r = p >> cw_shift;
      const int c = p & (cw - 1);
      if (c >= ncol) continue;
      out[(size_t)(row_base + r) * w + c0 + c] = rows[(size_t)r * stride + c];
    }
  }
}

int threads_for(int wave_m, int cw_shift) {
  const int pairs = wave_m << cw_shift;
  const int t = (pairs + 31) / 32 * 32;
  return t < 128 ? 128 : (t > kMaxThreads ? kMaxThreads : t);
}

template <bool kMega>
int launch(const void* waves, int wave_m, const void* meta, int n_chunks,
           int n_slices, int cw_shift, int w, const void* src,
           const void* elem, int k, const void* rootp, int max_rows,
           void* grows, void* out, void* stream) {
  const dim3 grid(n_chunks * n_slices);
  const int threads = threads_for(wave_m, cw_shift);
  const int ibuf = 2 * wave_m * (int)sizeof(int4);
  cudaStream_t st = (cudaStream_t)stream;
  if (grows == nullptr) {
    const int smem = (int)k1_shared_bytes(wave_m, max_rows, cw_shift);
    cudaError_t err = cudaFuncSetAttribute(
        k1_kernel<kMega, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    k1_kernel<kMega, true><<<grid, threads, smem, st>>>(
        (const int4*)waves, wave_m, (const int32_t*)meta, n_slices, cw_shift, w,
        (const int32_t*)src, (const int32_t*)elem, k, (const int32_t*)rootp,
        nullptr, (int32_t*)out);
  } else {
    k1_kernel<kMega, false><<<grid, threads, ibuf, st>>>(
        (const int4*)waves, wave_m, (const int32_t*)meta, n_slices, cw_shift, w,
        (const int32_t*)src, (const int32_t*)elem, k, (const int32_t*)rootp,
        (int32_t*)grows, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// grows: NULL for the shared-memory row space, else a (sum row_cnt, w)
// int32 scratch from the caller.
extern "C" int k1_eval_mega(const void* waves, int wave_m, const void* meta,
                            int n_chunks, int n_slices, int cw_shift, int w,
                            const void* pin_rows, const void* elem, int k,
                            const void* rootp, int max_rows, void* grows,
                            void* out, void* stream) {
  return launch<true>(waves, wave_m, meta, n_chunks, n_slices, cw_shift, w,
                      pin_rows, elem, k, rootp, max_rows, grows, out, stream);
}

// global_rows != 0 runs the rows in `out` itself (global memory).
extern "C" int k1_sig_eval(const void* waves, int wave_m, const void* meta,
                           int n_chunks, int n_slices, int cw_shift, int w,
                           const void* vals0, int max_rows, int global_rows,
                           void* out, void* stream) {
  return launch<false>(waves, wave_m, meta, n_chunks, n_slices, cw_shift, w,
                       vals0, nullptr, 0, nullptr, max_rows,
                       global_rows ? out : nullptr, out, stream);
}
