// K1: bit-packed AIG cone simulator for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_fn` / `eval_batch` of
// src/repro/kernels/aig_sim.py (the Pallas kernel that evaluated every
// query against the whole graph in a VMEM scratch), and serves the two
// contracts the reference's jnp engine defines:
//
//   eval_mega(waves (L,M,4), pin_rows (N,), elem (K,W), rootp (Q,)) -> (Q,W)
//   sig_eval(waves (L,M,4), vals0 (N,W))                            -> (N,W)
//
// `waves` is the host's mega-program: every query's cone owns its own
// rows of one flat row space, and the instructions [kind, a, b, o] are
// packed into waves by AIG level, so the instructions of one wave are
// independent and device work is proportional to the useful cone work.
// Each instruction computes
//     row[o] = (row[a] ^ -(kind & 1)) & (row[b] ^ -((kind >> 1) & 1)).
// Padding slots are [0, 0, 0, N-1]: they all store const0 into the
// scratch row N-1, which no query reads.  Those duplicate writes store
// the same value, so their order does not matter.
//
// What bounds it on the H100: not bytes or integer operations (a mega
// chunk moves a few MB at most) but latency.  Waves must run in order,
// and each wave is a dependent gather -> AND -> scatter through the row
// space.  The row space (<= 1 MB at W=1, <= 4 MB at W=32, the
// _MEGA_BUDGETs) exceeds a block's 227 KB of shared memory but sits in
// the 50 MB L2, so it lives in a global scratch.  Design of this first
// version: one thread block per mega chunk, threads striding over the
// (instruction slot, word column) pairs of a wave with the word column
// fastest (neighbouring threads touch neighbouring words of a row),
// and __syncthreads() between waves, which also makes the block's
// global-memory writes visible to the next wave.  One block per launch
// uses one SM of 132: the host packs chunks one at a time, and how far
// this starves the card is recorded in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void run_waves(const int4* __restrict__ waves,
                                          int n_waves, int wave_m,
                                          int32_t* rows, int w) {
  const int total = wave_m * w;
  for (int l = 0; l < n_waves; ++l) {
    const int4* wv = waves + (size_t)l * wave_m;
    for (int p = threadIdx.x; p < total; p += blockDim.x) {
      const int s = p / w;
      const int c = p - s * w;
      const int4 ins = wv[s];  // x=kind, y=a, z=b, w=o
      const int32_t va = rows[(size_t)ins.y * w + c] ^ -(ins.x & 1);
      const int32_t vb = rows[(size_t)ins.z * w + c] ^ -((ins.x >> 1) & 1);
      rows[(size_t)ins.w * w + c] = va & vb;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
eval_mega_kernel(const int4* __restrict__ waves, int n_waves, int wave_m,
                 const int32_t* __restrict__ pin_rows, int n_rows,
                 const int32_t* __restrict__ elem, int k, int w,
                 const int32_t* __restrict__ rootp, int n_q,
                 int32_t* rows, int32_t* __restrict__ out) {
  // Pin pass: support rows hold elementary tables, every other row 0
  // (the jnp engine's `where(pin >= 0, elem[clip(pin)], 0)`).
  const int n_init = n_rows * w;
  for (int p = threadIdx.x; p < n_init; p += blockDim.x) {
    const int r = p / w;
    const int c = p - r * w;
    const int pin = pin_rows[r];
    rows[p] = pin >= 0 ? elem[(size_t)min(pin, k - 1) * w + c] : 0;
  }
  __syncthreads();
  run_waves(waves, n_waves, wave_m, rows, w);
  // Root gather with phase: out[q] = row[rootp >> 1] ^ -(rootp & 1).
  const int n_out = n_q * w;
  for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
    const int q = p / w;
    const int c = p - q * w;
    const int rp = rootp[q];
    out[p] = rows[(size_t)(rp >> 1) * w + c] ^ -(rp & 1);
  }
}

__global__ void __launch_bounds__(kThreads)
sig_eval_kernel(const int4* __restrict__ waves, int n_waves, int wave_m,
                const int32_t* __restrict__ vals0, int n_rows, int w,
                int32_t* out) {
  const int n_init = n_rows * w;
  for (int p = threadIdx.x; p < n_init; p += blockDim.x) out[p] = vals0[p];
  __syncthreads();
  run_waves(waves, n_waves, wave_m, out, w);
}

}  // namespace

extern "C" int k1_eval_mega(const void* waves, int n_waves, int wave_m,
                            const void* pin_rows, int n_rows,
                            const void* elem, int k, int w,
                            const void* rootp, int n_q,
                            void* scratch, void* out, void* stream) {
  eval_mega_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)waves, n_waves, wave_m, (const int32_t*)pin_rows, n_rows,
      (const int32_t*)elem, k, w, (const int32_t*)rootp, n_q,
      (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k1_sig_eval(const void* waves, int n_waves, int wave_m,
                           const void* vals0, int n_rows, int w, void* out,
                           void* stream) {
  sig_eval_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)waves, n_waves, wave_m, (const int32_t*)vals0, n_rows, w,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
