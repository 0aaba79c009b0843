// Piecewise-affine speculative DFA chunk scan for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_affine.py::_kernel_affine
// (launched by its driver _spec_scan_affine).  Counted repetitions make
// automata of hundreds of states whose transition function is piecewise
// affine in the (premultiplied) state: with pid the number of breakpoints
// <= state (P pieces, P <= 48) and e = tab[pid * ncls + cls] (bits 0-26
// val, bit 28 rel, bit 30 match),
//
//   next = rel ? state + val - off : val
//
// so a step costs the same whatever the state count.  The layout, the
// warmup freeze (j < j0), the speculative entry (swarm) and the exit
// (phi) are those of the speculative scan (spec_scan.cu): one thread owns
// one chunk stream; a block of 256 threads is a quarter of a (b, g) tile
// of the [B, Jw, G, 8, 128] layout (blocks smaller than a tile even out
// the last wave).  Unlike that scan the match field is one bit and fm
// holds the accumulated bit unshifted in both modes: the count in COUNT
// mode, else the OR.  States are not masked; they reach 2^26.
//
// What bounds it: the integer pipe.  A stream's steps form one dependent
// chain, and enough streams run on each SM to hide its latency; what is
// left is the integer instructions a step (64 lanes a clock an SM)
// against 0.5 B of 4-bit packed input a corpus byte.  A step that
// searches its piece in a runtime loop over breakpoints in shared
// memory, forms pid * ncls + cls, guards it against the table end and
// extracts three bit fields runs ten times longer than its input takes
// to read.  This design:
//
//   - the host re-lays the table (ops/affine.relay_table): one 8-byte
//     entry {add, y} for every piece and every class code < 2^BITS, so
//     no code needs a guard (where pid * ncls + cls is past the fused
//     table the plain version reads entry index & 127: the entry staged
//     there is that one) and no multiply forms the index.  add folds
//     -off into a relative entry (exact under int32 wrap); y holds rel
//     at bit 31 and the match bit at bit 0.  A step is next = s * (y >> 31) + add, one multiply-add,
//     and the count is the low 31 bits of the sum of the y (the OR's bit
//     0 in scan mode);
//   - the row of piece pid starts at byte pid << (BITS + 3), and its
//     entries are swizzled: code c sits at c ^ sw(pid), sw(pid) = pid
//     times ncls rounded up to a power of two (mod 16), so the entries
//     of different pieces for the same code lie on different banks of
//     shared memory and streams in different pieces do not conflict.
//     The byte address is then (code << 3) ^ off[pid], one logic op on
//     the shifted word;
//   - the breakpoints and the P row offsets come by value in the
//     kernel's parameters (the constant bank), and the kernel is
//     templated on the breakpoint count for P <= 8, so the piece search
//     is P - 1 unrolled compare-and-selects against constant operands;
//   - a generic variant serves 9 <= P <= 48 with both arrays in shared
//     memory and a runtime loop over them.
//
// Arithmetic wraps as int32 does on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kBlock = 256;        // a quarter tile a block
constexpr int kMaxTemplated = 7;   // breakpoints of a templated kernel

template <int BITS> struct Packing;
template <> struct Packing<4> { static constexpr int kCpw = 8; };
template <> struct Packing<8> { static constexpr int kCpw = 4; };

// The pieces of a templated kernel, passed by value: the breakpoints and
// the byte offset (with the swizzle) of each piece's row.
struct Pieces {
  int32_t bp[kMaxTemplated];
  uint32_t off[kMaxTemplated + 1];
};

// Code k of a word, shifted to a byte offset in a row of 8-byte entries
// (k is a compile-time constant once the loops are unrolled).
template <int BITS>
__device__ __forceinline__ uint32_t code_offset(uint32_t word, int k) {
  constexpr uint32_t kMask = ((1u << BITS) - 1u) << 3;
  const int sh = BITS * k - 3;
  return (sh >= 0 ? word >> sh : word << -sh) & kMask;
}

// a * b + c on the FMA pipe.  Written plainly with b = 0 or 1, the
// compiler turns the multiply into a mask and an add, two instructions
// on the integer pipe.
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// One step from state s on the code at byte offset x; y is the entry's
// second word.  NBP >= 0: that many breakpoints from pc; NBP < 0: nbp of
// them, and the offsets, from shared memory.
template <int NBP>
__device__ __forceinline__ int32_t step(const char* tab, const Pieces& pc,
                                        const int32_t* bps,
                                        const uint32_t* offs, int nbp,
                                        int32_t s, uint32_t x, uint32_t* y) {
  uint32_t off;
  if (NBP >= 0) {
    off = pc.off[0];
#pragma unroll
    for (int i = 0; i < (NBP > 0 ? NBP : 0); ++i)
      off = s >= pc.bp[i] ? pc.off[i + 1] : off;
  } else {
    off = offs[0];
    for (int i = 0; i < nbp; ++i) off = s >= bps[i] ? offs[i + 1] : off;
  }
  const int2 e = *reinterpret_cast<const int2*>(tab + (x ^ off));
  *y = static_cast<uint32_t>(e.y);
  return static_cast<int32_t>(mad_lo(static_cast<uint32_t>(s), *y >> 31,
                                     static_cast<uint32_t>(e.x)));
}

template <int BITS, bool COUNT, int NBP>
__global__ void __launch_bounds__(kBlock)
affine_scan_kernel(const int32_t* __restrict__ data,
                   const int32_t* __restrict__ state0,
                   const int32_t* __restrict__ j0,
                   const int2* __restrict__ table, int entries, Pieces pc,
                   const int32_t* __restrict__ pieces, int nbp,
                   int32_t* __restrict__ phi, int32_t* __restrict__ fm,
                   int32_t* __restrict__ swarm, int Jw, int G,
                   int W_units) {
  constexpr int CPW = Packing<BITS>::kCpw;
  extern __shared__ int2 smem[];
  int2* tab2 = smem;
  // the generic kernel's breakpoints, then its P offsets
  int32_t* bps = reinterpret_cast<int32_t*>(smem + entries);
  const uint32_t* offs = reinterpret_cast<const uint32_t*>(bps + nbp);
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tab2[i] = table[i];
  if (NBP < 0)
    for (int i = threadIdx.x; i < 2 * nbp + 1; i += blockDim.x)
      bps[i] = pieces[i];
  __syncthreads();
  const char* tab = reinterpret_cast<const char*>(tab2);

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
  uint32_t y;

  int32_t s = state0[plane];
  const int32_t jz = j0[plane];
  const int warm_words = W_units / CPW;
  for (int w = 0; w < warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
    if (w * CPW >= jz) {
      // the whole word past the freeze (every word where j0 is 0)
#pragma unroll
      for (int k = 0; k < CPW; ++k)
        s = step<NBP>(tab, pc, bps, offs, nbp, s,
                      code_offset<BITS>(word, k), &y);
    } else {
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const int32_t nxt = step<NBP>(tab, pc, bps, offs, nbp, s,
                                      code_offset<BITS>(word, k), &y);
        if (w * CPW + k >= jz) s = nxt;
      }
    }
  }
  swarm[plane] = s;

  // COUNT: the sum of the y, whose low 31 bits count the matches (the rel
  // bits carry out at bit 31); scan: the OR, whose bit 0 is the match
  uint32_t acc = 0;
#pragma unroll 2
  for (int w = warm_words; w < Jw; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      s = step<NBP>(tab, pc, bps, offs, nbp, s, code_offset<BITS>(word, k),
                    &y);
      if (COUNT) {
        acc += y;
      } else {
        acc |= y;
      }
    }
  }
  phi[plane] = s;
  fm[plane] = static_cast<int32_t>(acc & (COUNT ? 0x7FFFFFFFu : 1u));
}

template <int BITS, bool COUNT, int NBP>
cudaError_t launch(const int32_t* data, const int32_t* state0,
                   const int32_t* j0, const int2* table, int entries,
                   const Pieces& pc, const int32_t* pieces, int nbp,
                   int32_t* phi, int32_t* fm, int32_t* swarm, int B, int Jw,
                   int G, int W_units, cudaStream_t stream) {
  auto kernel = affine_scan_kernel<BITS, COUNT, NBP>;
  const size_t smem = static_cast<size_t>(entries) * sizeof(int2) +
                      (NBP < 0 ? static_cast<size_t>(2 * nbp + 1) * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * G * (kTile / kBlock), kBlock, smem, stream>>>(
      data, state0, j0, table, entries, pc, pieces, nbp, phi, fm, swarm, Jw,
      G, W_units);
  return cudaGetLastError();
}

template <int BITS, bool COUNT>
cudaError_t launch_p(int nbp, bool generic, const int32_t* d,
                     const int32_t* s0, const int32_t* jz, const int2* t,
                     int entries, const Pieces& pc, const int32_t* pieces,
                     int32_t* p, int32_t* f, int32_t* sw, int B, int Jw,
                     int G, int W_units, cudaStream_t st) {
#define SRE_LAUNCH(n)                                                       \
  launch<BITS, COUNT, n>(d, s0, jz, t, entries, pc, pieces, nbp, p, f, sw, \
                         B, Jw, G, W_units, st)
  if (generic || nbp > kMaxTemplated) return SRE_LAUNCH(-1);
  switch (nbp) {
    case 0: return SRE_LAUNCH(0);
    case 1: return SRE_LAUNCH(1);
    case 2: return SRE_LAUNCH(2);
    case 3: return SRE_LAUNCH(3);
    case 4: return SRE_LAUNCH(4);
    case 5: return SRE_LAUNCH(5);
    case 6: return SRE_LAUNCH(6);
    default: return SRE_LAUNCH(7);
  }
#undef SRE_LAUNCH
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, fm, swarm int32
// [B, G, 8, 128]; table int32 [table_len = 2 * P * 2^BITS], the re-laid
// table of ops/affine.relay_table; pieces int32 [2 * nbp + 1] on the
// device and host_pieces the same on the host: the nbp = P - 1 sorted
// premultiplied breakpoints, then the P row offsets (the generic kernel
// reads the first, the templated ones take the second by value).
// W_units is the warmup length in bytes.  GENERIC = 1 takes the generic
// kernel whatever P (to time it).  Returns the cudaError_t of the launch
// (0 on success); the caller checks shapes.
extern "C" int sre_affine_scan(const void* data, const void* state0,
                               const void* j0, const void* table,
                               int table_len, void* phi, void* fm,
                               void* swarm, int B, int Jw, int G, int W_units,
                               int CPW, int BITS, int COUNT,
                               const void* pieces, const void* host_pieces,
                               int nbp, int GENERIC, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* s0 = static_cast<const int32_t*>(state0);
  const auto* jz = static_cast<const int32_t*>(j0);
  const auto* t = static_cast<const int2*>(table);
  const auto* pcs = static_cast<const int32_t*>(pieces);
  auto* p = static_cast<int32_t*>(phi);
  auto* f = static_cast<int32_t*>(fm);
  auto* sw = static_cast<int32_t*>(swarm);
  auto st = static_cast<cudaStream_t>(stream);
  const int entries = table_len / 2;
  if (nbp < 0 || nbp > 47 || B <= 0 || G <= 0 || (BITS != 4 && BITS != 8) ||
      table_len != 2 * (nbp + 1) * (1 << BITS))
    return static_cast<int>(cudaErrorInvalidValue);
  Pieces pc{};
  const auto* hp = static_cast<const int32_t*>(host_pieces);
  if (nbp <= kMaxTemplated) {
    for (int i = 0; i < nbp; ++i) pc.bp[i] = hp[i];
    for (int i = 0; i <= nbp; ++i)
      pc.off[i] = static_cast<uint32_t>(hp[nbp + i]);
  }
  const bool gen = GENERIC != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4 && CPW == Packing<4>::kCpw) {
    err = COUNT ? launch_p<4, true>(nbp, gen, d, s0, jz, t, entries, pc, pcs,
                                    p, f, sw, B, Jw, G, W_units, st)
                : launch_p<4, false>(nbp, gen, d, s0, jz, t, entries, pc, pcs,
                                     p, f, sw, B, Jw, G, W_units, st);
  } else if (BITS == 8 && CPW == Packing<8>::kCpw) {
    err = COUNT ? launch_p<8, true>(nbp, gen, d, s0, jz, t, entries, pc, pcs,
                                    p, f, sw, B, Jw, G, W_units, st)
                : launch_p<8, false>(nbp, gen, d, s0, jz, t, entries, pc, pcs,
                                     p, f, sw, B, Jw, G, W_units, st);
  }
  return static_cast<int>(err);
}
