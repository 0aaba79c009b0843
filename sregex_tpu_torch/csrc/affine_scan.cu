// Piecewise-affine speculative DFA chunk scan for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_affine.py::_kernel_affine
// (launched by its driver _spec_scan_affine).  Counted repetitions make
// automata of hundreds of states whose transition function is piecewise
// affine in the (premultiplied) state:
//
//   pid  = number of breakpoints <= state          (P pieces, P <= 48)
//   e    = tab[pid * ncls + cls]                    (P * ncls entries)
//   val  = e & (2^27 - 1), rel = bit 28, match = bit 30
//   next = rel ? state + val - off : val
//
// so a step costs the same whatever the state count.  The layout, the
// warmup freeze (j < j0), the speculative entry (swarm) and the exit
// (phi) are those of the speculative scan (spec_scan.cu): one thread owns
// one chunk stream, a block of 1024 threads is one (b, g) tile of the
// [B, Jw, G, 8, 128] layout.  Unlike that scan the match field is one bit
// and fm holds the accumulated bit unshifted in both modes: the count in
// COUNT mode, else the OR.  States are not masked; they reach 2^26.
//
// Per block the breakpoints and the table (at most 48 * 256 entries,
// 48 KB) are copied into shared memory; the breakpoints are an argument,
// not compile-time constants, so one build serves every pattern.  Every
// thread reads the same breakpoint at the same time (a broadcast), so
// the piece search costs P - 1 compares without bank conflicts.
//
// What bounds it: as for the speculative scan, each stream's chain of
// dependent steps, now a few compares, one shared-memory lookup and a
// select per unit, against 0.5 B of 4-bit packed input per corpus byte.
// Occupancy (1024 streams per block) hides the chain; the next word's
// load does not depend on it.
//
// Bounds: an index outside [0, table_len) reads entry (index & 127), as
// the TPU kernel's select chain does (a row past the table falls to row
// 0).  Arithmetic wraps as int32 does on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr uint32_t kValMask = (1u << 27) - 1u;
constexpr int kModeBit = 28;
constexpr int kMatchBit = 30;

template <int BITS> struct Packing;
template <> struct Packing<4> { static constexpr int kCpw = 8; };
template <> struct Packing<8> { static constexpr int kCpw = 4; };

// One step: returns the next state and sets *mbit to the match bit.
__device__ __forceinline__ int32_t step(const int32_t* tab, uint32_t n,
                                        const int32_t* bp, int nbp,
                                        uint32_t ncls, uint32_t off,
                                        int32_t s, uint32_t cls,
                                        uint32_t* mbit) {
  uint32_t pid = 0;
  for (int i = 0; i < nbp; ++i) pid += (s >= bp[i]) ? 1u : 0u;
  uint32_t idx = pid * ncls + cls;
  idx = idx < n ? idx : (idx & 127u);
  const uint32_t e = static_cast<uint32_t>(tab[idx]);
  const uint32_t val = e & kValMask;
  *mbit = (e >> kMatchBit) & 1u;
  return static_cast<int32_t>(((e >> kModeBit) & 1u)
                                  ? static_cast<uint32_t>(s) + val - off
                                  : val);
}

template <int BITS, bool COUNT>
__global__ void __launch_bounds__(kTile)
affine_scan_kernel(const int32_t* __restrict__ data,
                   const int32_t* __restrict__ state0,
                   const int32_t* __restrict__ j0,
                   const int32_t* __restrict__ table, int table_len,
                   const int32_t* __restrict__ bp, int nbp, int ncls, int off,
                   int32_t* __restrict__ phi, int32_t* __restrict__ fm,
                   int32_t* __restrict__ swarm, int Jw, int G, int W_units) {
  constexpr int CPW = Packing<BITS>::kCpw;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  extern __shared__ int32_t smem[];
  int32_t* tab = smem;
  int32_t* bps = smem + table_len;
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) tab[i] = table[i];
  for (int i = threadIdx.x; i < nbp; i += blockDim.x) bps[i] = bp[i];
  __syncthreads();

  const int64_t tile = blockIdx.x;                 // b * G + g
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int64_t plane = tile * kTile + threadIdx.x;  // [B, G, 8, 128] index
  const int64_t wstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * Jw * G + g) * kTile + threadIdx.x;
  const uint32_t n = static_cast<uint32_t>(table_len);
  const uint32_t nc = static_cast<uint32_t>(ncls);
  const uint32_t of = static_cast<uint32_t>(off);
  uint32_t mbit;

  int32_t s = state0[plane];
  const int32_t jz = j0[plane];
  const int warm_words = W_units / CPW;
  for (int w = 0; w < warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t cls = (word >> (BITS * k)) & kClassMask;
      const int32_t nxt = step(tab, n, bps, nbp, nc, of, s, cls, &mbit);
      if (w * CPW + k >= jz) s = nxt;
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
      s = step(tab, n, bps, nbp, nc, of, s, cls, &mbit);
      if (COUNT) {
        acc += mbit;
      } else {
        acc |= mbit;
      }
    }
  }
  phi[plane] = s;
  fm[plane] = static_cast<int32_t>(acc);
}

template <int BITS, bool COUNT>
cudaError_t launch(const int32_t* data, const int32_t* state0,
                   const int32_t* j0, const int32_t* table, int table_len,
                   const int32_t* bp, int nbp, int ncls, int off,
                   int32_t* phi, int32_t* fm, int32_t* swarm, int B, int Jw,
                   int G, int W_units, cudaStream_t stream) {
  auto kernel = affine_scan_kernel<BITS, COUNT>;
  const size_t smem = static_cast<size_t>(table_len + nbp) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * G, kTile, smem, stream>>>(data, state0, j0, table, table_len,
                                         bp, nbp, ncls, off, phi, fm, swarm,
                                         Jw, G, W_units);
  return cudaGetLastError();
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, fm, swarm int32
// [B, G, 8, 128]; table int32 [table_len]; bp int32 [nbp], the sorted
// premultiplied breakpoints (P - 1 of them); off = S * ncls.  W_units is
// the warmup length in bytes.  The arguments up to COUNT are those of
// sre_spec_scan.  Returns the cudaError_t of the launch (0 on success);
// the caller checks shapes.
extern "C" int sre_affine_scan(const void* data, const void* state0,
                               const void* j0, const void* table,
                               int table_len, void* phi, void* fm,
                               void* swarm, int B, int Jw, int G, int W_units,
                               int CPW, int BITS, int COUNT, const void* bp,
                               int nbp, int ncls, int off, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* s0 = static_cast<const int32_t*>(state0);
  const auto* jz = static_cast<const int32_t*>(j0);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* b = static_cast<const int32_t*>(bp);
  auto* p = static_cast<int32_t*>(phi);
  auto* f = static_cast<int32_t*>(fm);
  auto* sw = static_cast<int32_t*>(swarm);
  auto st = static_cast<cudaStream_t>(stream);
  if (table_len <= 0 || table_len % 128 != 0 || nbp < 0 || ncls <= 0 ||
      B <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits)                                                     \
  (COUNT ? launch<bits, true>(d, s0, jz, t, table_len, b, nbp, ncls, off, p, \
                              f, sw, B, Jw, G, W_units, st)                  \
         : launch<bits, false>(d, s0, jz, t, table_len, b, nbp, ncls, off,   \
                               p, f, sw, B, Jw, G, W_units, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4 && CPW == Packing<4>::kCpw) {
    err = SRE_LAUNCH(4);
  } else if (BITS == 8 && CPW == Packing<8>::kCpw) {
    err = SRE_LAUNCH(8);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}
