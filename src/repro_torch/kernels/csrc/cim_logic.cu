// K2: CiM bit-plane logic engine for Hopper (sm_90a).
//
// Replaces the TPU kernel `cim_pallas_call` / `_cim_kernel` of
// src/repro/kernels/cim_logic.py, whose operands the wrapper keeps:
//   planes (n_rows_p, n_words) int32, 32 test vectors per word, PI rows
//          pre-placed and the const1 row set to -1 by the host;
//   out    (n_pos_p, n_words) int32, PO rows gathered (padding rows 0).
// The reference's instruction stream (NAND2 / NOR2 / NOT over reused
// rows, one gate after another) is not walked here.  The host turns it
// into a program (ops.cim_program, cim_logic.CimProgram), one int32
// vector of five sections:
//   slots (n_slots) int4 [op, a, b, out] over a renamed register file:
//          op ~0 = NOR2, 0 = NAND2 (NOT is NAND2 with b = a); level by
//          level, each level padded to a multiple of kBatch with no-op
//          slots on the pad row;
//   steps  (n_steps + 1) slot offsets: a step is a level (or a chunk-sized
//          piece of one), and its gates are independent: no gate reads a
//          row the step writes, and no two write one row;
//   chunks (n_chunks + 1) step offsets: a chunk's slots fit chunk_slots;
//   in_rows (n_in): the planes row loaded into renamed row i;
//   po_rows (n_pos): the renamed row of each PO at the end.
//
// What bounds it on the H100: the bytes (planes rows in, PO rows out, the
// program) take about a tenth of a microsecond, and one 32-bit logic op
// per gate and word is less still.  What is left is the chain: a gate
// reads what an earlier level wrote, so each level costs at least one
// shared-memory round trip (load, logic op, store), and the number of
// levels (the netlist's depth) times that round trip, plus the issue of
// about a dozen instructions a gate, bounds a block.  The serial kernel
// this replaces paid the round trip per gate: the reference's reused
// rows order nearly every gate after the one before (659 levels on the
// mac8 tile if its rows are kept, against 54 of true dependence).
//
// Design: one block per 32 words, one word per lane, the renamed register
// file in shared memory as [row][lane] (each lane reads and writes its
// own bank).  Renaming removes every hazard inside a
// level, so a warp issues a level's gates kBatch at a time: 2 kBatch
// operand loads, the slots of its next batch (two register sets take
// turns), then kBatch logic ops (the op is a mask: one LOP3 a gate) and
// kBatch stores.  The program is staged in shared memory a chunk ahead
// with cp.async (two buffers of chunk_slots), so a slot read is a
// broadcast from shared memory.  The kWarps = 4 warps of a block split
// each step's batches over the same 32 words, one barrier a step: they
// keep all four schedulers of the SM busy (1 and 2 warps measured slower
// on every netlist, PERF.md), and 2**16 vectors are 64 blocks.  The
// inputs load and the POs gather kPrologue rows at a time.  A register
// file that does not fit shared memory next to the two buffers lives in a
// global scratch laid out [row][word] (coalesced, L2-resident).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kBatch = 8;
// Warps a block: each takes every kWarps-th batch of a step.
constexpr int kWarps = 4;
// Input rows loaded (and PO rows gathered) together by one warp.
constexpr int kPrologue = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Every thread of the block copies its share of slots [lo, hi) into buf
// and commits one group (empty for a thread with no share).
__device__ __forceinline__ void stage(int4* buf, const int4* slots, int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) cp_async16(buf + (i - lo), slots + i);
  cp_async_commit();
}

// A lane's view of the register file: row r of its word.
template <bool kShared>
struct Rf;

template <>
struct Rf<true> {
  int32_t* p;
  __device__ __forceinline__ int32_t& operator[](int row) const { return p[row * kLanes]; }
};

template <>
struct Rf<false> {
  int32_t* p;
  size_t ld;
  __device__ __forceinline__ int32_t& operator[](int row) const { return p[(size_t)row * ld]; }
};

// ~(x & y) for m = 0, ~(x | y) for m = ~0: not-majority, one LOP3.
__device__ __forceinline__ int32_t nand_nor(int32_t x, int32_t y, int32_t m) {
#ifdef __CUDA_ARCH__
  int32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x17;" : "=r"(d) : "r"(x), "r"(y), "r"(m));
  return d;
#else
  return ~((x & y) | (m & (x | y)));
#endif
}

// One batch: the operand loads of the gates in `cur`, then (if `more`)
// the slots of the warp's next batch into `nxt`, then logic and stores.
template <class R>
__device__ __forceinline__ void run_batch(const int4 (&cur)[kBatch], int4 (&nxt)[kBatch],
                                          const int4* next_slots, bool more, const R& rf) {
  int32_t x[kBatch], y[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    x[j] = rf[cur[j].y];
    y[j] = rf[cur[j].z];
  }
  if (more) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) nxt[j] = next_slots[j];
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) rf[cur[j].w] = nand_nor(x[j], y[j], cur[j].x);
}

// One warp's share of a step: batches first, first + kWarps, ... of the
// step's slots [lo, hi) in the staged chunk `ins`, two register sets of
// slots taking turns.
template <class R>
__device__ __forceinline__ void run_step(const int4* ins, int lo, int hi, int warp, const R& rf) {
  constexpr int kStride = kWarps * kBatch;
  int b = lo + warp * kBatch;
  if (b >= hi) return;
  int4 g[kBatch], h[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) g[j] = ins[b + j];
  while (true) {
    b += kStride;
    run_batch(g, h, ins + b, b < hi, rf);
    if (b >= hi) break;
    b += kStride;
    run_batch(h, g, ins + b, b < hi, rf);
    if (b >= hi) break;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kWarps * kLanes)
cim_kernel(const int4* __restrict__ slots, const int* __restrict__ step_off,
           const int* __restrict__ chunk_off, int n_chunks,
           const int* __restrict__ in_rows, int n_in,
           const int* __restrict__ po_rows, int n_pos,
           const int32_t* __restrict__ planes, int n_words,
           int32_t* __restrict__ out, int n_pos_p,
           int32_t* gscratch, size_t ld, int chunk_slots) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int word = blockIdx.x * kLanes + lane;
  const bool valid = word < n_words;
  Rf<kShared> rf;
  if constexpr (kShared) {
    rf.p = reinterpret_cast<int32_t*>(smem + 2 * chunk_slots) + lane;
  } else {
    rf.p = gscratch + (size_t)blockIdx.x * kLanes + lane;
    rf.ld = ld;
  }

  // The first chunk loads while the inputs do, kPrologue plane loads in
  // flight before a warp stores one.
  if (n_chunks > 0) stage(smem, slots, step_off[chunk_off[0]], step_off[chunk_off[1]]);
  for (int i0 = warp * kPrologue; i0 < n_in; i0 += kWarps * kPrologue) {
    int32_t v[kPrologue];
#pragma unroll
    for (int j = 0; j < kPrologue; ++j) {
      const int i = i0 + j;
      v[j] = (i < n_in && valid) ? planes[(size_t)in_rows[i] * n_words + word] : 0;
    }
#pragma unroll
    for (int j = 0; j < kPrologue; ++j) {
      if (i0 + j < n_in) rf[i0 + j] = v[j];
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = chunk_off[c], s1 = chunk_off[c + 1];
    if (c + 1 < n_chunks) {
      stage(smem + ((c + 1) & 1) * chunk_slots, slots, step_off[s1],
            step_off[chunk_off[c + 2]]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c, and before it the inputs, seen by every warp
    const int4* ins = smem + (c & 1) * chunk_slots;
    const int base = step_off[s0];
    for (int s = s0; s < s1; ++s) {
      run_step(ins, step_off[s] - base, step_off[s + 1] - base, warp, rf);
      __syncthreads();  // this level's rows before the next reads them
    }
    __syncthreads();  // every warp is done with this buffer before chunk c + 2 lands there
  }
  __syncthreads();
  if (!valid) return;
  for (int j0 = warp * kPrologue; j0 < n_pos_p; j0 += kWarps * kPrologue) {
    int r[kPrologue];
#pragma unroll
    for (int j = 0; j < kPrologue; ++j) r[j] = j0 + j < n_pos ? po_rows[j0 + j] : -1;
#pragma unroll
    for (int j = 0; j < kPrologue; ++j) {
      if (j0 + j < n_pos_p) out[(size_t)(j0 + j) * n_words + word] = r[j] < 0 ? 0 : rf[r[j]];
    }
  }
}

template <bool kShared>
cudaError_t launch(const int* code, int n_slots, int n_steps, int n_chunks, int n_in, int n_pos,
                   const int32_t* planes, int n_words, int32_t* out, int n_pos_p,
                   int32_t* gscratch, int chunk_slots, int smem, cudaStream_t stream) {
  auto kernel = cim_kernel<kShared>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int* step_off = code + 4 * (size_t)n_slots;
  const int* chunk_off = step_off + n_steps + 1;
  const int* in_rows = chunk_off + n_chunks + 1;
  const int* po_rows = in_rows + n_in;
  const int blocks = (n_words + kLanes - 1) / kLanes;
  const size_t ld = (size_t)blocks * kLanes;
  kernel<<<blocks, kWarps * kLanes, smem, stream>>>(
      reinterpret_cast<const int4*>(code), step_off, chunk_off, n_chunks, in_rows, n_in,
      po_rows, n_pos, planes, n_words, out, n_pos_p, gscratch, ld, chunk_slots);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one block needs with the register file there:
// the two staged chunks and n_rows rows of 32 words.
extern "C" long k2_shared_bytes(int n_rows, int chunk_slots) {
  return 2L * chunk_slots * (long)sizeof(int4) + (long)n_rows * kLanes * (long)sizeof(int32_t);
}

// code: the program (see the top of this file), 16-byte aligned.
// gscratch: NULL for the shared-memory register file, else an
// (n_rows, round_up(n_words, 32)) int32 buffer from the caller.
extern "C" int k2_cim(const void* code, int n_slots, int n_steps, int n_chunks, int n_in,
                      int n_pos, int n_rows, const void* planes, int n_words, void* out,
                      int n_pos_p, void* gscratch, int chunk_slots, void* stream) {
  if (chunk_slots <= 0 || n_words <= 0) return (int)cudaErrorInvalidValue;
  const int* c = static_cast<const int*>(code);
  const int32_t* p = static_cast<const int32_t*>(planes);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gscratch == nullptr) {
    const int smem = (int)k2_shared_bytes(n_rows, chunk_slots);
    return (int)launch<true>(c, n_slots, n_steps, n_chunks, n_in, n_pos, p, n_words, o,
                             n_pos_p, nullptr, chunk_slots, smem, s);
  }
  const int smem = (int)k2_shared_bytes(0, chunk_slots);
  return (int)launch<false>(c, n_slots, n_steps, n_chunks, n_in, n_pos, p, n_words, o, n_pos_p,
                            static_cast<int32_t*>(gscratch), chunk_slots, smem, s);
}
