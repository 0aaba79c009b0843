// Speculative DFA chunk scan for Hopper (sm_90a): the one-lookup kernel.
//
// Replaces the JAX package's TPU kernels ops/pallas_scan.py::_kernel
// (the narrow 128-entry table), ::_kernel_wide (tables of R rows of 128)
// and their launch ::_dispatch_kernel, and, with the table left in global
// memory, ops/pallas_big.py::_kernel_big with its row loop _lookup_rows
// (tables of up to 2^17 entries).  It serves the wide tier and the tables
// the redesigned kernels do not hold: the narrow
// tier's 3- and 4-bit tables run pair_scan.cu (one lookup per two class
// codes), the big tables that fit 16 bits an entry big_scan.cu.  It
// computes what they compute; it does not copy their structure:
//
//   - one thread owns one chunk stream; a block of 1024 threads is one
//     (b, g) tile of the [B, Jw, G, 8, 128] layout, so thread t reads
//     word data[b, w, g, t] and the loads of a warp are coalesced;
//   - the whole fused table (any size up to the shared-memory cap) is
//     copied into dynamic shared memory once per block.  On the TPU a
//     gather reached only one 128-lane row, hence the narrow/wide split
//     and the row-select chain; here both tiers are one lookup per step;
//   - the big tier (sre_big_scan) reads its table, up to 512 KB, from
//     global memory through the read-only path instead: it does not fit
//     the 227 KB of shared memory, and the 50 MB L2 holds it.  The TPU's
//     min/max-bounded row loop existed only because a Mosaic gather
//     reaches one 128-lane row; here it is one load per step;
//   - warmup: W units from state0, frozen while j < j0; the state after
//     it is the speculative entry (swarm);
//   - main loop: one lookup per unit; COUNT adds the match field
//     (e >> 20), otherwise the entries are ORed and macc >> 20 is stored.
//
// What bounds it: the integer pipe.  A step runs ~9.6 instructions,
// ~6.9 on the integer pipe (tools/sass_loops.py): the class extract, the
// index add, the guard below (a compare, a mask and a select), the
// address, the match fold and the state mask; at 64 lanes a clock an SM
// those need 0.84 ms of the narrow table's 1.03 ms at [120, 260, 8, 8,
// 128], against 0.31 ms to read the 4-bit words.  The chain's latency
// is hidden by occupancy (1024 streams a block, two blocks an SM), and
// the narrow table's few live entries sit on distinct banks
// (tools/bank_conflicts.py: one wavefront a warp's load on the
// headline's corpus).  The wide tier's 8-bit tables reach half their
// byte bound; pair_scan.cu removes the guard, the add and the mask from
// the narrow tier's steps.  The big tier's chain is one of dependent
// loads through L1 and L2: 2.07 ms for the 500-keyword dictionary where
// the same steps from shared memory take 1.07 (big_scan.cu).

// Bounds: a table index is (state + class) and is in range for any
// input the prep produces.  For any other input the kernel stays inside
// the table: an index outside [0, table_len) reads entry (index & 127),
// which is what the TPU kernels' masked lane gather and row-select chain
// (an out-of-range row falls to row 0) return, so the result still
// equals the TPU kernels'.  table_len is a multiple of 128.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace {

using namespace sre_scan;

template <int BITS, bool COUNT, bool SMEM>
__global__ void __launch_bounds__(kTile)
spec_scan_kernel(const int32_t* __restrict__ data,
                 const int32_t* __restrict__ state0,
                 const int32_t* __restrict__ j0,
                 const int32_t* __restrict__ table, int table_len,
                 int32_t* __restrict__ phi, int32_t* __restrict__ fm,
                 int32_t* __restrict__ swarm, int Jw, int G, int W_units) {
  constexpr int CPW = Packing<BITS>::kCpw;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  extern __shared__ int32_t smem_tab[];
  const int32_t* tab = table;
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < table_len; i += blockDim.x)
      smem_tab[i] = table[i];
    __syncthreads();
    tab = smem_tab;
  }

  const int64_t tile = blockIdx.x;                 // b * G + g
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int64_t plane = tile * kTile + threadIdx.x;  // [B, G, 8, 128] index
  const int64_t wstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * Jw * G + g) * kTile + threadIdx.x;
  const uint32_t n = static_cast<uint32_t>(table_len);

  int32_t s = state0[plane];
  const int32_t jz = j0[plane];
  const int warm_words = W_units / CPW;
  for (int w = 0; w < warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t cls = (word >> (BITS * k)) & kClassMask;
      const int32_t e = lookup<SMEM>(tab, static_cast<uint32_t>(s) + cls, n);
      if (w * CPW + k >= jz) s = e & kStateMask;
    }
  }
  swarm[plane] = s;

  uint32_t acc = 0;
#pragma unroll 2
  for (int w = warm_words; w < Jw; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t cls = (word >> (BITS * k)) & kClassMask;
      const int32_t e = lookup<SMEM>(tab, static_cast<uint32_t>(s) + cls, n);
      if (COUNT) {
        acc += static_cast<uint32_t>(e >> kMatchShift);
      } else {
        acc |= static_cast<uint32_t>(e);
      }
      s = e & kStateMask;
    }
  }
  phi[plane] = s;
  fm[plane] = COUNT ? static_cast<int32_t>(acc)
                    : (static_cast<int32_t>(acc) >> kMatchShift);
}

template <int BITS, bool COUNT, bool SMEM>
cudaError_t launch(const int32_t* data, const int32_t* state0,
                   const int32_t* j0, const int32_t* table, int table_len,
                   int32_t* phi, int32_t* fm, int32_t* swarm, int B, int Jw,
                   int G, int W_units, cudaStream_t stream) {
  auto kernel = spec_scan_kernel<BITS, COUNT, SMEM>;
  size_t smem = 0;
  if constexpr (SMEM) {
    smem = static_cast<size_t>(table_len) * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * G, kTile, smem, stream>>>(data, state0, j0, table, table_len,
                                         phi, fm, swarm, Jw, G, W_units);
  return cudaGetLastError();
}

template <bool SMEM>
int dispatch(const void* data, const void* state0, const void* j0,
             const void* table, int table_len, void* phi, void* fm,
             void* swarm, int B, int Jw, int G, int W_units, int CPW,
             int BITS, int COUNT, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* s0 = static_cast<const int32_t*>(state0);
  const auto* jz = static_cast<const int32_t*>(j0);
  const auto* t = static_cast<const int32_t*>(table);
  auto* p = static_cast<int32_t*>(phi);
  auto* f = static_cast<int32_t*>(fm);
  auto* sw = static_cast<int32_t*>(swarm);
  auto st = static_cast<cudaStream_t>(stream);
  if (table_len <= 0 || table_len % 128 != 0 || B <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits)                                                  \
  (COUNT ? launch<bits, true, SMEM>(d, s0, jz, t, table_len, p, f, sw, B,  \
                                    Jw, G, W_units, st)                    \
         : launch<bits, false, SMEM>(d, s0, jz, t, table_len, p, f, sw, B, \
                                     Jw, G, W_units, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 3 && CPW == Packing<3>::kCpw) {
    if constexpr (SMEM) err = SRE_LAUNCH(3);   // the big tier packs 4 or 8
  } else if (BITS == 4 && CPW == Packing<4>::kCpw) {
    err = SRE_LAUNCH(4);
  } else if (BITS == 8 && CPW == Packing<8>::kCpw) {
    err = SRE_LAUNCH(8);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, fm, swarm int32
// [B, G, 8, 128]; table int32 [table_len].  W_units is the warmup length
// in kernel units (bytes, or byte pairs for the pair tier).  Returns the
// cudaError_t of the launch (0 on success); the caller checks shapes.
// sre_spec_scan copies the table to shared memory (table_len * 4 bytes
// must fit a block); sre_big_scan reads it from global memory.
extern "C" int sre_spec_scan(const void* data, const void* state0,
                             const void* j0, const void* table,
                             int table_len, void* phi, void* fm, void* swarm,
                             int B, int Jw, int G, int W_units, int CPW,
                             int BITS, int COUNT, void* stream) {
  return dispatch<true>(data, state0, j0, table, table_len, phi, fm, swarm,
                        B, Jw, G, W_units, CPW, BITS, COUNT, stream);
}

extern "C" int sre_big_scan(const void* data, const void* state0,
                            const void* j0, const void* table, int table_len,
                            void* phi, void* fm, void* swarm, int B, int Jw,
                            int G, int W_units, int CPW, int BITS, int COUNT,
                            void* stream) {
  return dispatch<false>(data, state0, j0, table, table_len, phi, fm, swarm,
                         B, Jw, G, W_units, CPW, BITS, COUNT, stream);
}
