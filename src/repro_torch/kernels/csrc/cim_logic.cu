// K2: CiM bit-plane logic engine for Hopper (sm_90a).
//
// Replaces the TPU kernel `cim_pallas_call` / `_cim_kernel` of
// src/repro/kernels/cim_logic.py.  Same contract:
//   instrs (n_gates + n_pos, 4) int32 [kind, a, b, out]; kind 0 = NAND2,
//          1 = NOR2, 2 = NOT (encoded as NAND2 with b = a); the last n_pos
//          slots are kind-3 gathers whose column 3 names a PO row;
//   planes (n_rows_p, n_words) int32, 32 test vectors per word, PI rows
//          pre-placed and the const1 row set to -1 by the host;
//   out    (n_pos_p, n_words) int32, PO rows gathered (padding rows 0).
//
// What bounds it on the H100: the instruction stream is strictly
// sequential while word columns are independent, so the work is one
// dependent chain of (2 reads, 1 logic op, 1 write) per gate per word.
// The bytes it must move (planes in, PO rows out) take microseconds; the
// chain's latency is the limit.  Design: one thread per word, each
// thread walks the whole stream; the register file of a block's words
// lives in shared memory as [row][thread] (neighbouring threads hit
// neighbouring banks), so every operand read is a shared-memory access
// and no barrier is needed.  Row reuse in the host compiler keeps
// n_rows_p small; when n_rows_p * block_threads words do not fit the
// 227 KB a block may use, the register file moves to a global scratch
// laid out [row][word] (coalesced, L2-resident).  One warp per block
// gives the most blocks for a given n_words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
cim_kernel(const int4* __restrict__ instrs, int n_gates, int n_pos,
           const int32_t* __restrict__ planes, int n_rows_p, int n_words,
           int32_t* __restrict__ out, int n_pos_p, int32_t* gscratch) {
  extern __shared__ int32_t smem[];
  const int word = blockIdx.x * blockDim.x + threadIdx.x;
  if (word >= n_words) return;
  int32_t* rf;
  size_t stride;
  if (kShared) {
    rf = smem + threadIdx.x;
    stride = blockDim.x;
  } else {
    rf = gscratch + word;
    stride = n_words;
  }
  for (int r = 0; r < n_rows_p; ++r) rf[r * stride] = planes[(size_t)r * n_words + word];
  for (int i = 0; i < n_gates; ++i) {
    const int4 ins = instrs[i];
    const int32_t a = rf[ins.y * stride];
    const int32_t b = rf[ins.z * stride];
    rf[ins.w * stride] = ins.x == 1 ? ~(a | b) : ~(a & b);
  }
  for (int j = 0; j < n_pos; ++j) {
    out[(size_t)j * n_words + word] = rf[instrs[n_gates + j].w * stride];
  }
  for (int j = n_pos; j < n_pos_p; ++j) out[(size_t)j * n_words + word] = 0;
}

}  // namespace

// Bytes of shared memory the register file needs for one block.
extern "C" long k2_shared_bytes(int n_rows_p) {
  return (long)n_rows_p * kThreads * (long)sizeof(int32_t);
}

// gscratch: NULL for the shared-memory register file, else an
// (n_rows_p, n_words) int32 buffer from the caller.
extern "C" int k2_cim(const void* instrs, int n_gates, int n_pos,
                      const void* planes, int n_rows_p, int n_words,
                      void* out, int n_pos_p, void* gscratch, void* stream) {
  const dim3 grid((n_words + kThreads - 1) / kThreads);
  if (gscratch == nullptr) {
    const int smem = (int)k2_shared_bytes(n_rows_p);
    cudaError_t err = cudaFuncSetAttribute(
        cim_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cim_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int4*)instrs, n_gates, n_pos, (const int32_t*)planes, n_rows_p,
        n_words, (int32_t*)out, n_pos_p, nullptr);
  } else {
    cim_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)instrs, n_gates, n_pos, (const int32_t*)planes, n_rows_p,
        n_words, (int32_t*)out, n_pos_p, (int32_t*)gscratch);
  }
  return (int)cudaGetLastError();
}
