// Two-code speculative DFA chunk scan for Hopper (sm_90a): the narrow
// tier's kernel.
//
// Replaces the JAX package's TPU kernel ops/pallas_scan.py::_kernel (the
// narrow 128-entry table, launched by ::_dispatch_kernel) wherever the
// host's pair_table (ops/spec_scan.py) holds the table exactly: 3- and
// 4-bit class codes, match fields in [0, 7].  It computes what the
// one-lookup kernel (spec_scan.cu, sre_spec_scan) computes, phi, fm and
// swarm bit for bit, in the same layout: one thread owns one chunk
// stream; a block of 256 threads is a quarter of a (b, g) tile of the
// [B, Jw, G, 8, 128] layout (blocks smaller than a tile even out the last
// wave), so thread t reads word data[b, w, g, t] and a warp's loads are
// coalesced.
//
// What bounds the one-lookup kernel: the integer pipe, not latency or
// bank conflicts.  At [120, 260, 8, 8, 128] it makes 2.0e9 dependent
// lookups in 1.03 ms, ~7.6 steps a clock an SM.  Its step runs ~9.6
// instructions, ~6.9 of them on the integer pipe (tools/sass_loops.py):
// the class extract, the index add, the guard (idx < n ? idx : idx &
// 127), the address, the match fold and the state mask; at 64 lanes a
// clock an SM those need 0.84 ms.  The headline's few live entries sit
// on distinct banks (tools/bank_conflicts.py: one wavefront a warp's
// load).  This design:
//
//   - one lookup per two class codes: the host composes the exact
//     one-step function (guard included) over every pair of codes, for
//     every state value the table produces and every multiple of ncls
//     below the machine's state count.  The entry of (row, pair) holds
//     the next row as a byte offset (bits 0-23), the OR of the two match
//     fields (bits 24-27) and their sum (bits 28-31).  At 4-bit packing a
//     pair is one byte of the word: one byte permute extracts it and one
//     multiply-add on the FMA pipe forms the address, so no guard, no
//     state add and no class mask are left on the integer pipe;
//   - a row holds 2^(2 BITS) entries and a pad entry, the row's
//     premultiplied state (phi is read from it at the end).  The pad
//     also shifts each row by one bank of shared memory, so streams in
//     different rows on the same pair do not collide;
//   - COUNT adds the sum field (entry >> 28); scan ORs whole entries and
//     keeps bits 24-27 at the end;
//   - warmup: streams entered at a row with no freeze (every speculative
//     stream) walk it in pairs too; the others take one-code steps
//     through the fused table, which is staged beside the pair table,
//     freezing while j < j0 as the one-lookup kernel does;
//   - each thread loads its words two ahead of the one it walks;
//   - a stream whose state after the warmup has no row (an entry state
//     that is neither a table value nor a multiple of ncls below the
//     state count, with the whole warmup frozen) scans on in one-code
//     steps, so the result is exact on every input.  The host's
//     entry states always have a row.
//
// What bounds it now: reading the words.  A code pair runs ~7
// instructions, ~3.6 of them on the integer pipe, and its load needs two
// wavefronts on the headline's corpus (tools/bank_conflicts.py); at
// 0.38 ms the kernel reads its 1.02 GB of words at 81% of the card's
// 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kBlock = 256;        // a quarter tile a block
constexpr int kMatchShift = 20;
constexpr int32_t kStateMask = (1 << kMatchShift) - 1;
constexpr uint32_t kRowMask = (1u << 24) - 1u;
constexpr int kSmemMax = 232448;

template <int BITS> struct Packing;
template <> struct Packing<3> { static constexpr int kCpw = 10; };
template <> struct Packing<4> { static constexpr int kCpw = 8; };

// entries of a row of the pair table, the pad entry included
template <int BITS>
constexpr int kRow = (1 << (2 * BITS)) + 1;

// a * b + c on the FMA pipe (see affine_scan.cu)
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// Pair k of a word: codes 2k (low bits) and 2k + 1.
template <int BITS>
__device__ __forceinline__ uint32_t pair_code(uint32_t word, int k) {
  if constexpr (BITS == 4) {
    return __byte_perm(word, 0u, 0x4440u | static_cast<uint32_t>(k));
  } else {
    return (word >> (2 * BITS * k)) & ((1u << (2 * BITS)) - 1u);
  }
}

// The row offset (bytes) of premultiplied state s, or -1 when s has none.
__device__ __forceinline__ int32_t row_of(const int32_t* rowmap,
                                          int map_len, int32_t s) {
  return static_cast<uint32_t>(s) < static_cast<uint32_t>(map_len)
             ? __ldg(rowmap + s)
             : -1;
}

// Words [w0, w1) from row offset nb, one lookup a code pair.  ACC folds
// each entry into acc (COUNT: the sum field; else the whole entry).
template <int BITS, bool COUNT, bool ACC>
__device__ __forceinline__ uint32_t pair_walk(const char* ptab,
                                              const int32_t* src,
                                              int64_t wstride, int w0,
                                              int w1, uint32_t nb,
                                              uint32_t* acc) {
  constexpr int kPairs = Packing<BITS>::kCpw / 2;
  const int32_t* p = src + w0 * wstride;
  // two words ahead: each word's load is in flight while the two
  // before it are walked
  uint32_t q0 = w0 < w1 ? static_cast<uint32_t>(__ldg(p)) : 0u;
  p += wstride;
  uint32_t q1 = w0 + 1 < w1 ? static_cast<uint32_t>(__ldg(p)) : 0u;
  p += wstride;
#pragma unroll 2
  for (int w = w0; w < w1; ++w, p += wstride) {
    const uint32_t word = q0;
    q0 = q1;
    q1 = w + 2 < w1 ? static_cast<uint32_t>(__ldg(p)) : 0u;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const uint32_t e = *reinterpret_cast<const uint32_t*>(
          ptab + mad_lo(pair_code<BITS>(word, k), 4u, nb));
      nb = e & kRowMask;
      if (ACC) {
        if (COUNT) {
          *acc += e >> 28;
        } else {
          *acc |= e;
        }
      }
    }
  }
  return nb;
}

// One-code step through the fused table: an index outside the table
// reads entry index & 127, as the one-lookup kernel does.
__device__ __forceinline__ int32_t one_code(const int32_t* tab, uint32_t idx,
                                            uint32_t n) {
  return tab[idx < n ? idx : (idx & 127u)];
}

template <int BITS, bool COUNT>
__global__ void __launch_bounds__(kBlock)
spec_pair_kernel(const int32_t* __restrict__ data,
                 const int32_t* __restrict__ state0,
                 const int32_t* __restrict__ j0,
                 const int32_t* __restrict__ table, int table_len,
                 const int32_t* __restrict__ pairs, int pairs_len,
                 const int32_t* __restrict__ rowmap, int map_len,
                 int32_t* __restrict__ phi, int32_t* __restrict__ fm,
                 int32_t* __restrict__ swarm, int Jw, int G, int W_units) {
  constexpr int CPW = Packing<BITS>::kCpw;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  constexpr int kPad = kRow<BITS> - 1;
  extern __shared__ int32_t smem[];
  int32_t* tab = smem;                 // the one-code (fused) table
  int32_t* ptab = smem + table_len;    // the pair table
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) tab[i] = table[i];
  for (int i = threadIdx.x; i < pairs_len; i += blockDim.x)
    ptab[i] = pairs[i];
  __syncthreads();
  const char* pt = reinterpret_cast<const char*>(ptab);

  // block = tile * 4 + quarter, the tile b * G + g; t = the stream's
  // index in the tile (sublane * 128 + lane)
  const int64_t tile = blockIdx.x / (kTile / kBlock);
  const int t = static_cast<int>(blockIdx.x % (kTile / kBlock)) * kBlock +
                threadIdx.x;
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int64_t plane = tile * kTile + t;          // [B, G, 8, 128] index
  const int64_t wstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * Jw * G + g) * kTile + t;
  const uint32_t n = static_cast<uint32_t>(table_len);

  int32_t s = state0[plane];
  const int32_t jz = j0[plane];
  const int warm_words = W_units / CPW;
  int32_t nb = row_of(rowmap, map_len, s);
  uint32_t acc = 0;
  if (jz <= 0 && nb >= 0) {
    nb = static_cast<int32_t>(pair_walk<BITS, COUNT, false>(
        pt, src, wstride, 0, warm_words, static_cast<uint32_t>(nb), &acc));
    s = ptab[(nb >> 2) + kPad];
  } else {
    for (int w = 0; w < warm_words; ++w) {
      const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const uint32_t cls = (word >> (BITS * k)) & kClassMask;
        const int32_t e = one_code(tab, static_cast<uint32_t>(s) + cls, n);
        if (w * CPW + k >= jz) s = e & kStateMask;
      }
    }
    nb = row_of(rowmap, map_len, s);
  }
  swarm[plane] = s;

  if (nb >= 0) {
    nb = static_cast<int32_t>(pair_walk<BITS, COUNT, true>(
        pt, src, wstride, warm_words, Jw, static_cast<uint32_t>(nb), &acc));
    phi[plane] = ptab[(nb >> 2) + kPad];
    fm[plane] = static_cast<int32_t>(COUNT ? acc : (acc >> 24) & 15u);
    return;
  }
  // no row: the one-lookup kernel's walk
  for (int w = warm_words; w < Jw; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t cls = (word >> (BITS * k)) & kClassMask;
      const int32_t e = one_code(tab, static_cast<uint32_t>(s) + cls, n);
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

template <int BITS, bool COUNT>
cudaError_t launch(const int32_t* data, const int32_t* state0,
                   const int32_t* j0, const int32_t* table, int table_len,
                   const int32_t* pairs, int pairs_len,
                   const int32_t* rowmap, int map_len, int32_t* phi,
                   int32_t* fm, int32_t* swarm, int B, int Jw, int G,
                   int W_units, cudaStream_t stream) {
  auto kernel = spec_pair_kernel<BITS, COUNT>;
  const size_t smem =
      (static_cast<size_t>(table_len) + pairs_len) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * G * (kTile / kBlock), kBlock, smem, stream>>>(
      data, state0, j0, table, table_len, pairs, pairs_len, rowmap, map_len,
      phi, fm, swarm, Jw, G, W_units);
  return cudaGetLastError();
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, fm, swarm int32
// [B, G, 8, 128]; table int32 [table_len], the fused table; pairs int32
// [pairs_len], rows of 2^(2 BITS) + 1 entries, and rowmap int32
// [map_len], each premultiplied state's row offset in bytes or -1: the
// pair table of ops/spec_scan.pair_table for this fused table.  W_units
// is the warmup length in kernel units.  Both tables must fit one
// block's shared memory.  Returns the cudaError_t of the launch (0 on
// success); the caller checks shapes.
extern "C" int sre_spec_scan_pair(const void* data, const void* state0,
                                  const void* j0, const void* table,
                                  int table_len, void* phi, void* fm,
                                  void* swarm, int B, int Jw, int G,
                                  int W_units, int CPW, int BITS, int COUNT,
                                  const void* pairs, int pairs_len,
                                  const void* rowmap, int map_len,
                                  void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* s0 = static_cast<const int32_t*>(state0);
  const auto* jz = static_cast<const int32_t*>(j0);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* pt = static_cast<const int32_t*>(pairs);
  const auto* rm = static_cast<const int32_t*>(rowmap);
  auto* p = static_cast<int32_t*>(phi);
  auto* f = static_cast<int32_t*>(fm);
  auto* sw = static_cast<int32_t*>(swarm);
  auto st = static_cast<cudaStream_t>(stream);
  if (table_len <= 0 || table_len % 128 != 0 || pairs_len <= 0 ||
      map_len <= 0 || B <= 0 || G <= 0 ||
      (static_cast<int64_t>(table_len) + pairs_len) * 4 > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits)                                                   \
  (pairs_len % kRow<bits> != 0                                             \
       ? cudaErrorInvalidValue                                             \
       : COUNT ? launch<bits, true>(d, s0, jz, t, table_len, pt, pairs_len, \
                                    rm, map_len, p, f, sw, B, Jw, G,       \
                                    W_units, st)                           \
               : launch<bits, false>(d, s0, jz, t, table_len, pt,          \
                                     pairs_len, rm, map_len, p, f, sw, B,  \
                                     Jw, G, W_units, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 3 && CPW == Packing<3>::kCpw) {
    err = SRE_LAUNCH(3);
  } else if (BITS == 4 && CPW == Packing<4>::kCpw) {
    err = SRE_LAUNCH(4);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}
