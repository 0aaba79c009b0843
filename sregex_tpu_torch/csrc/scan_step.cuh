// One step of the speculative DFA scan, shared by the one-lookup kernel
// (spec_scan.cu), the 16-bit big kernel (big_scan.cu) and the gated
// phase-2 kernel (gated_scan.cu): the class codes of a packed word, the
// guarded lookup of a fused int32 table (next * ncls | match << 20), and
// the lookup of the 16-bit table of ops/big.big16_table (next state id |
// match << 14).  Device functions only; each source compiles its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sre_scan {

constexpr int kTile = 1024;                  // streams of a (b, g) tile
constexpr int kMatchShift = 20;
constexpr int32_t kStateMask = (1 << kMatchShift) - 1;
constexpr uint32_t kSidMask = (1u << 14) - 1u;
constexpr int kSmemMax = 232448;             // a block's shared memory

template <int BITS> struct Packing;
template <> struct Packing<3> { static constexpr int kCpw = 10; };
template <> struct Packing<4> { static constexpr int kCpw = 8; };
template <> struct Packing<8> { static constexpr int kCpw = 4; };

// Entry idx of a fused table of n entries, from shared memory (SMEM) or
// through the read-only data cache.  An index outside [0, n) reads entry
// (idx & 127), what the TPU kernels' masked lane gather and row-select
// chain (an out-of-range row falls to row 0) return.
template <bool SMEM>
__device__ __forceinline__ int32_t lookup(const int32_t* tab, uint32_t idx,
                                          uint32_t n) {
  const uint32_t i = idx < n ? idx : (idx & 127u);
  if constexpr (SMEM) {
    return tab[i];
  } else {
    return __ldg(tab + i);
  }
}

// a * b + c on the FMA pipe (see affine_scan.cu)
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// Code k of a word (k is a compile-time constant once the loops are
// unrolled): an 8-bit code is one byte permute.
template <int BITS>
__device__ __forceinline__ uint32_t code(uint32_t word, int k) {
  if constexpr (BITS == 8) {
    return __byte_perm(word, 0u, 0x4440u | static_cast<uint32_t>(k));
  } else {
    return (word >> (BITS * k)) & ((1u << BITS) - 1u);
  }
}

// One 16-bit step: the entry of state id sid on class code c, at byte
// 2 * c + sid * 2 ncls, two multiply-adds on the FMA pipe.
__device__ __forceinline__ uint32_t step16(const char* tab, uint32_t sid,
                                           uint32_t ncls2, uint32_t c) {
  return *reinterpret_cast<const uint16_t*>(
      tab + mad_lo(c, 2u, mad_lo(sid, ncls2, 0u)));
}

// A premultiplied state that is a row of the 16-bit table: a multiple of
// ncls below rows * ncls.
__device__ __forceinline__ bool is_row(int32_t s, int ncls, int rows) {
  return s >= 0 && s % ncls == 0 && s / ncls < rows;
}

}  // namespace sre_scan
