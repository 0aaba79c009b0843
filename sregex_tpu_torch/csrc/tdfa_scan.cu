// Tagged-DFA chunk scan for Hopper (sm_90a): the state, R capture
// registers and a bank of T tracked tag slots plus the regex id, per
// chunk stream.
//
// Replaces the JAX package's TPU kernel ops/tdfa_scan.py::_tdfa_kernel
// with its select chain _resolve (launched by _tdfa_scan).  It computes
// what they compute:
//
//   - init: state0; registers j0 where j0 > 0 (the true-entry stream),
//     else BAD = -2^30; the bank BAD for the T tag slots, -1 for the id;
//   - warmup, window positions j in [0, W): the STATE only advances,
//     frozen while j < j0.  Registers and the bank stay BAD, so a value
//     that traces to the entry or the warmup stays BAD and cannot be
//     certified (the certification rule of the JAX package);
//   - scan, j in [W, J): per byte, look up next, cmeta, the register-
//     source and (on a commit) the commit-source code planes at
//     state + class; every new register is resolved from the OLD
//     registers (code k < R: reg k; a code in [R, UNSET): BAD; UNSET:
//     -1; CUR: j; NEXT: j + 1); where cmeta & 1, the bank takes the T
//     resolved commit sources and the id cmeta >> 1;
//   - out: phi (the exit state), swarm (the state at j = W), bank[T+1]
//     and regs[R], in window positions (the host adds c*K - W).
//
// An index outside [0, entries) reads entry (index & 127), what the TPU
// kernel's masked lane gather and row-select chain return.
//
// What bounds it: like the speculative scan (spec_scan.cu), each stream
// is a chain of dependent table lookups plus the R-slot register rebuild
// per byte, against 0.5 B of 4-bit packed input per corpus byte; the
// kernel is bound by instruction throughput and latency, not by memory.
// One stream per thread, 256 threads per block (four blocks per (b, g)
// tile of 1024 streams).
//
// The design for Hopper (tdfa_fast_kernel, 4- and 8-bit codes whose
// planes fit shared memory, which covers every such machine at the
// card's 2048-entry budget):
//
//   - registers in registers: the kernel is templated on R exactly up
//     to 8 registers, else on a bucket of 13 or 24 (slots past R
//     guarded), and holds a bank of the code width's 13 or 24 tags; the
//     arrays are only indexed by unrolled compile-time indices, so they
//     stay in registers.  A source code is resolved by a select over
//     them.  One bucket of 8 in place of the exact R, its slots past R
//     guarded or rebuilt as "keep", was slower at the find shape
//     (PERF.md, tools/time_tdfa_variants.py);
//   - one lookup a byte: each block stages a step array, per table entry
//     the next state and the register rebuild re-coded per slot in 4
//     bits (0 keep: the code is the slot's own register; 1 BAD; 2 UNSET;
//     3 CUR; 4 NEXT), with a commit flag and a "gather" flag (some slot
//     takes another register).  A slot's rebuild is then branch-free:
//     keep, else min(j + c - 3, c * (2^30 - 1) + 2^31 + 1) in 32 bits,
//     which is j (CUR), j + 1 (NEXT), -1 (UNSET) or BAD.  A slot whose
//     code is its own register keeps its value through that select, so
//     an identity word needs no branch of its own (a word-level skip was
//     slower at the find shape, where no word is the identity: PERF.md);
//     only a commit (read from cmeta and the commit-source planes,
//     resolved from the OLD registers) or a gather (the general select
//     over the original register-source planes) takes the slow branch.
//
// 16-bit codes (up to 48 slots) and planes past shared memory keep the
// first design (tdfa_scan_kernel): every plane in shared memory when
// they fit, else read through __ldg (16-bit codes, up to 50 planes); the
// registers and the bank in per-thread arrays sized for the code width,
// which a code-indexed read (regs[code]) puts in local memory (L1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int32_t kBad = -(1 << 30);
constexpr size_t kSmemMax = 232448;   // 227 KB, a block's shared memory

// registers / tags a code width can address (ids below UNSET)
template <int CODE> struct Slots;
template <> struct Slots<4> { static constexpr int kMax = 13; };
template <> struct Slots<8> { static constexpr int kMax = 24; };
template <> struct Slots<16> { static constexpr int kMax = 48; };

template <bool SMEM>
__device__ __forceinline__ int32_t load(const int32_t* tab, uint32_t i) {
  if constexpr (SMEM) {
    return tab[i];
  } else {
    return __ldg(tab + i);
  }
}

template <int CODE>
__device__ __forceinline__ int32_t resolve(uint32_t code,
                                           const int32_t* regs, int R,
                                           int32_t j) {
  constexpr uint32_t kTop = (1u << CODE) - 1u;
  if (code == kTop - 2u) return -1;         // UNSET
  if (code == kTop - 1u) return j;          // CUR
  if (code == kTop) return j + 1;           // NEXT
  return code < static_cast<uint32_t>(R) ? regs[code] : kBad;
}

template <int BITS, int CODE, bool SMEM>
__global__ void __launch_bounds__(kThreads)
tdfa_scan_kernel(const int32_t* __restrict__ data,
                 const int32_t* __restrict__ state0,
                 const int32_t* __restrict__ j0,
                 const int32_t* __restrict__ g_next,
                 const int32_t* __restrict__ g_regsrc,
                 const int32_t* __restrict__ g_csrc,
                 const int32_t* __restrict__ g_cmeta, int entries, int PR,
                 int PT, int32_t* __restrict__ phi,
                 int32_t* __restrict__ swarm, int32_t* __restrict__ bank_out,
                 int32_t* __restrict__ regs_out, int Jw, int G, int W_units,
                 int R, int T, int64_t planes) {
  constexpr int CPW = 32 / BITS;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  constexpr int SPP = 32 / CODE;
  constexpr uint32_t kCodeMask = (1u << CODE) - 1u;
  constexpr int kMax = Slots<CODE>::kMax;

  const int32_t* t_next = g_next;
  const int32_t* t_cmeta = g_cmeta;
  const int32_t* t_regsrc = g_regsrc;
  const int32_t* t_csrc = g_csrc;
  if constexpr (SMEM) {
    // next | cmeta | regsrc[PR] | csrc[PT], each `entries` long
    extern __shared__ int32_t smem[];
    const int n2 = 2 * entries;
    for (int i = threadIdx.x; i < entries; i += blockDim.x) {
      smem[i] = g_next[i];
      smem[entries + i] = g_cmeta[i];
    }
    for (int i = threadIdx.x; i < PR * entries; i += blockDim.x)
      smem[n2 + i] = g_regsrc[i];
    for (int i = threadIdx.x; i < PT * entries; i += blockDim.x)
      smem[n2 + PR * entries + i] = g_csrc[i];
    __syncthreads();
    t_next = smem;
    t_cmeta = smem + entries;
    t_regsrc = smem + n2;
    t_csrc = smem + n2 + PR * entries;
  }

  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;                   // [B, G, 8, 128] index
  const int64_t tile = p / kTile;                  // b * G + g
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int64_t wstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * Jw * G + g) * kTile + (p % kTile);
  const uint32_t n = static_cast<uint32_t>(entries);
  const int pr = (R + SPP - 1) / SPP;              // planes R reaches
  const int pt = (T + SPP - 1) / SPP;

  int32_t s = state0[p];
  const int32_t jz = j0[p];
  const int warm_words = W_units / CPW;
  for (int w = 0; w < warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t idx =
          static_cast<uint32_t>(s) + ((word >> (BITS * k)) & kClassMask);
      const int32_t e = load<SMEM>(t_next, idx < n ? idx : (idx & 127u));
      if (w * CPW + k >= jz) s = e;
    }
  }
  swarm[p] = s;

  int32_t ra[kMax], rb[kMax], bank[kMax + 1];
  int32_t* regs = ra;     // the registers before this byte
  int32_t* nregs = rb;    // the registers after it
  for (int q = 0; q < R; ++q) regs[q] = jz > 0 ? jz : kBad;
  for (int q = 0; q < T; ++q) bank[q] = kBad;
  bank[T] = -1;

  for (int w = warm_words; w < Jw; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
    for (int k = 0; k < CPW; ++k) {
      const int32_t j = w * CPW + k;
      uint32_t idx =
          static_cast<uint32_t>(s) + ((word >> (BITS * k)) & kClassMask);
      idx = idx < n ? idx : (idx & 127u);
      const int32_t e = load<SMEM>(t_next, idx);
      const int32_t cm = load<SMEM>(t_cmeta, idx);
      if (cm & 1) {
        // a commit: the bank takes the sources resolved from the OLD
        // registers, and the regex id
        for (int pl = 0; pl < pt; ++pl) {
          const uint32_t cw = static_cast<uint32_t>(
              load<SMEM>(t_csrc + pl * entries, idx));
          for (int sl = 0; sl < SPP && pl * SPP + sl < T; ++sl)
            bank[pl * SPP + sl] =
                resolve<CODE>((cw >> (CODE * sl)) & kCodeMask, regs, R, j);
        }
        bank[T] = cm >> 1;
      }
      for (int pl = 0; pl < pr; ++pl) {
        const uint32_t cw = static_cast<uint32_t>(
            load<SMEM>(t_regsrc + pl * entries, idx));
        for (int sl = 0; sl < SPP && pl * SPP + sl < R; ++sl)
          nregs[pl * SPP + sl] =
              resolve<CODE>((cw >> (CODE * sl)) & kCodeMask, regs, R, j);
      }
      int32_t* old = regs;
      regs = nregs;
      nregs = old;
      s = e;
    }
  }
  phi[p] = s;
  for (int q = 0; q <= T; ++q) bank_out[q * planes + p] = bank[q];
  for (int q = 0; q < R; ++q) regs_out[q * planes + p] = regs[q];
}

// The re-coded rebuild of one slot (tdfa_fast_kernel): 0 keep, 1 BAD,
// 2 UNSET, 3 CUR, 4 NEXT, in the low 3 bits of each nibble.
constexpr uint32_t kKeep = 0, kRBad = 1, kRUnset = 2, kRCur = 3, kRNext = 4;
constexpr uint32_t kCommitBit = 1u << 3;   // nibble 0's top bit
constexpr uint32_t kGatherBit = 1u << 7;   // nibble 1's top bit

// The register variants of tdfa_fast_kernel: NR = R exactly up to 8
// registers (no per-slot guard), else a bucket of 13 or 24 registers
// (slots past R guarded).  The bank holds up to the code width's tags.
template <int NR> struct StepOf { using T = int2; };   // next | rebuild
template <> struct StepOf<13> { using T = int4; };
template <> struct StepOf<24> { using T = int4; };

__device__ __forceinline__ uint32_t rebuild_word(const int4& st, int i) {
  return static_cast<uint32_t>(i == 0 ? st.y : i == 1 ? st.z : st.w);
}
__device__ __forceinline__ uint32_t rebuild_word(const int2& st, int) {
  return static_cast<uint32_t>(st.y);
}

// The general resolve of a source code over the first R of N registers.
template <int CODE, int N>
__device__ __forceinline__ int32_t resolve_sel(uint32_t code,
                                               const int32_t (&regs)[N],
                                               int R, int32_t j) {
  constexpr uint32_t kTop = (1u << CODE) - 1u;
  int32_t v = code == kTop - 2u ? -1
              : code == kTop - 1u ? j
              : code == kTop ? j + 1 : kBad;
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q < R && code == static_cast<uint32_t>(q)) v = regs[q];
  return v;
}

template <int BITS, int CODE, int NR>
__global__ void __launch_bounds__(kThreads)
tdfa_fast_kernel(const int32_t* __restrict__ data,
                 const int32_t* __restrict__ state0,
                 const int32_t* __restrict__ j0,
                 const int32_t* __restrict__ g_next,
                 const int32_t* __restrict__ g_regsrc,
                 const int32_t* __restrict__ g_csrc,
                 const int32_t* __restrict__ g_cmeta, int entries, int PR,
                 int PT, int32_t* __restrict__ phi,
                 int32_t* __restrict__ swarm, int32_t* __restrict__ bank_out,
                 int32_t* __restrict__ regs_out, int Jw, int G, int W_units,
                 int R_arg, int T, int64_t planes, uint32_t y0) {
  using Step = typename StepOf<NR>::T;
  constexpr bool kExact = NR <= 8;
  constexpr int RN = NR > 0 ? NR : 1;        // the register array's size
  constexpr int TB = Slots<CODE>::kMax;      // the bank's
  constexpr int CPW = 32 / BITS;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  constexpr int SPP = 32 / CODE;
  constexpr uint32_t kCodeMask = (1u << CODE) - 1u;
  constexpr uint32_t kTop = (1u << CODE) - 1u;
  const int R = kExact ? NR : R_arg;

  // steps | cmeta | csrc[PT] | regsrc[PR], each `entries` long
  extern __shared__ int4 smem4[];
  Step* step = reinterpret_cast<Step*>(smem4);
  int32_t* t_cmeta = reinterpret_cast<int32_t*>(step + entries);
  int32_t* t_csrc = t_cmeta + entries;
  int32_t* t_regsrc = t_csrc + PT * entries;
  for (int i = threadIdx.x; i < PT * entries; i += blockDim.x)
    t_csrc[i] = g_csrc[i];
  for (int i = threadIdx.x; i < PR * entries; i += blockDim.x)
    t_regsrc[i] = g_regsrc[i];
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const int32_t cm = g_cmeta[i];
    t_cmeta[i] = cm;
    uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
    bool gather = false;
    for (int k = 0; k < R; ++k) {
      const uint32_t code =
          (static_cast<uint32_t>(g_regsrc[(k / SPP) * entries + i]) >>
           (CODE * (k % SPP))) & kCodeMask;
      uint32_t c = kRBad;
      if (code == static_cast<uint32_t>(k)) c = kKeep;
      else if (code == kTop - 2u) c = kRUnset;
      else if (code == kTop - 1u) c = kRCur;
      else if (code == kTop) c = kRNext;
      else if (static_cast<int>(code) < R) gather = true;
      c <<= 4 * (k % 8);
      if (k < 8) w0 |= c;
      else if (k < 16) w1 |= c;
      else w2 |= c;
    }
    w0 |= ((cm & 1) ? kCommitBit : 0u) | (gather ? kGatherBit : 0u);
    Step st;
    st.x = g_next[i];
    st.y = static_cast<int32_t>(w0);
    if constexpr (!kExact) {
      st.z = static_cast<int32_t>(w1);
      st.w = static_cast<int32_t>(w2);
    }
    step[i] = st;
  }
  __syncthreads();

  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;                   // [B, G, 8, 128] index
  const int64_t tile = p / kTile;                  // b * G + g
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int64_t wstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * Jw * G + g) * kTile + (p % kTile);
  const uint32_t n = static_cast<uint32_t>(entries);

  int32_t s = state0[p];
  const int32_t jz = j0[p];
  const int warm_words = W_units / CPW;
  for (int w = 0; w < warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(src + w * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      uint32_t idx =
          static_cast<uint32_t>(s) + ((word >> (BITS * k)) & kClassMask);
      idx = idx < n ? idx : (idx & 127u);
      const int32_t e = step[idx].x;
      if (w * CPW + k >= jz) s = e;
    }
  }
  swarm[p] = s;

  int32_t regs[RN], bank[TB];
#pragma unroll
  for (int q = 0; q < RN; ++q) regs[q] = jz > 0 ? jz : kBad;
#pragma unroll
  for (int q = 0; q < TB; ++q) bank[q] = kBad;
  int32_t rid = -1;

  uint32_t next_word =
      warm_words < Jw ? static_cast<uint32_t>(__ldg(src + warm_words *
                                                          wstride))
                      : 0u;
  for (int w = warm_words; w < Jw; ++w) {
    const uint32_t word = next_word;
    if (w + 1 < Jw)
      next_word = static_cast<uint32_t>(__ldg(src + (w + 1) * wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int32_t j = w * CPW + k;
      uint32_t idx =
          static_cast<uint32_t>(s) + ((word >> (BITS * k)) & kClassMask);
      idx = idx < n ? idx : (idx & 127u);
      const Step st = step[idx];
      const uint32_t r0 = rebuild_word(st, 0);
      bool gather = false;
      if (r0 & (kCommitBit | kGatherBit)) {
        if (r0 & kCommitBit) {
          // a commit: the bank takes the sources resolved from the OLD
          // registers, and the regex id
#pragma unroll
          for (int q = 0; q < TB; ++q) {
            if (q < T) {
              const uint32_t code =
                  (static_cast<uint32_t>(t_csrc[(q / SPP) * entries + idx])
                   >> (CODE * (q % SPP))) & kCodeMask;
              bank[q] = resolve_sel<CODE, RN>(code, regs, R, j);
            }
          }
          rid = t_cmeta[idx] >> 1;
        }
        gather = (r0 & kGatherBit) != 0;
      }
      if (gather) {
        // some slot takes another register: the general rebuild
        int32_t nregs[RN];
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          nregs[q] = regs[q];
          if (q < R) {
            const uint32_t code =
                (static_cast<uint32_t>(t_regsrc[(q / SPP) * entries + idx])
                 >> (CODE * (q % SPP))) & kCodeMask;
            nregs[q] = resolve_sel<CODE, RN>(code, regs, R, j);
          }
        }
#pragma unroll
        for (int q = 0; q < RN; ++q) regs[q] = nregs[q];
      } else {
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          if (kExact || q < R) {
            const uint32_t c =
                (rebuild_word(st, q / 8) >> (4 * (q % 8))) & 7u;
            const int32_t x = j + static_cast<int32_t>(c) - 3;
            const int32_t y = static_cast<int32_t>(c * 0x3FFFFFFFu + y0);
            regs[q] = c == kKeep ? regs[q] : min(x, y);
          }
        }
      }
      s = st.x;
    }
  }
  phi[p] = s;
#pragma unroll
  for (int q = 0; q < TB; ++q)
    if (q < T) bank_out[q * planes + p] = bank[q];
#pragma unroll
  for (int q = 0; q < RN; ++q)
    if (q < R) regs_out[q * planes + p] = regs[q];
  bank_out[static_cast<int64_t>(T) * planes + p] = rid;
}

template <int BITS, int CODE, int NR>
cudaError_t launch_fast(const int32_t* data, const int32_t* state0,
                        const int32_t* j0, const int32_t* t_next,
                        const int32_t* t_regsrc, const int32_t* t_csrc,
                        const int32_t* t_cmeta, int entries, int PR, int PT,
                        int32_t* phi, int32_t* swarm, int32_t* bank,
                        int32_t* regs, unsigned blocks, int Jw, int G,
                        int W_units, int R, int T, int64_t planes,
                        size_t smem, cudaStream_t stream) {
  auto kernel = tdfa_fast_kernel<BITS, CODE, NR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // y0 = 0x80000001 is the rebuild's constant term; as a parameter it
  // rides the multiply-add from the constant bank
  kernel<<<blocks, kThreads, smem, stream>>>(
      data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, entries, PR, PT,
      phi, swarm, bank, regs, Jw, G, W_units, R, T, planes, 0x80000001u);
  return cudaGetLastError();
}

template <int BITS, int CODE>
cudaError_t launch(const int32_t* data, const int32_t* state0,
                   const int32_t* j0, const int32_t* t_next,
                   const int32_t* t_regsrc, const int32_t* t_csrc,
                   const int32_t* t_cmeta, int entries, int PR, int PT,
                   int32_t* phi, int32_t* swarm, int32_t* bank,
                   int32_t* regs, int B, int Jw, int G, int W_units, int R,
                   int T, cudaStream_t stream) {
  if (R > Slots<CODE>::kMax || T > Slots<CODE>::kMax) {
    return cudaErrorInvalidValue;
  }
  const int64_t planes = static_cast<int64_t>(B) * G * kTile;
  const unsigned blocks = static_cast<unsigned>(planes / kThreads);
  if constexpr (CODE != 16) {
    const size_t fast_smem =
        static_cast<size_t>(R <= 8 ? 2 : 4) * entries * sizeof(int32_t) +
        static_cast<size_t>(1 + PR + PT) * entries * sizeof(int32_t);
    if (fast_smem <= kSmemMax) {
#define SRE_FAST(nr)                                                         \
  launch_fast<BITS, CODE, nr>(data, state0, j0, t_next, t_regsrc, t_csrc,    \
                              t_cmeta, entries, PR, PT, phi, swarm, bank,    \
                              regs, blocks, Jw, G, W_units, R, T, planes,    \
                              fast_smem, stream)
      switch (R) {
        case 0: return SRE_FAST(0);
        case 1: return SRE_FAST(1);
        case 2: return SRE_FAST(2);
        case 3: return SRE_FAST(3);
        case 4: return SRE_FAST(4);
        case 5: return SRE_FAST(5);
        case 6: return SRE_FAST(6);
        case 7: return SRE_FAST(7);
        case 8: return SRE_FAST(8);
        default: break;
      }
      if (R <= 13) return SRE_FAST(13);
      if constexpr (CODE == 8) return SRE_FAST(24);
#undef SRE_FAST
    }
  }
  const size_t smem =
      static_cast<size_t>(2 + PR + PT) * entries * sizeof(int32_t);
  if (smem <= kSmemMax) {
    auto kernel = tdfa_scan_kernel<BITS, CODE, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(
        data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, entries, PR,
        PT, phi, swarm, bank, regs, Jw, G, W_units, R, T, planes);
  } else {
    auto kernel = tdfa_scan_kernel<BITS, CODE, false>;
    kernel<<<blocks, kThreads, 0, stream>>>(
        data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, entries, PR,
        PT, phi, swarm, bank, regs, Jw, G, W_units, R, T, planes);
  }
  return cudaGetLastError();
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, swarm int32
// [B, G, 8, 128]; t_next, t_cmeta int32 [entries]; t_regsrc int32
// [PR, entries], t_csrc int32 [PT, entries] (CODE bits per slot);
// bank int32 [T+1, B, G, 8, 128]; regs int32 [R, B, G, 8, 128].
// W_units is the warmup in bytes.  Returns the cudaError_t of the launch
// (0 on success); the caller checks shapes.
extern "C" int sre_tdfa_scan(const void* data, const void* state0,
                             const void* j0, const void* t_next,
                             const void* t_regsrc, const void* t_csrc,
                             const void* t_cmeta, int entries, int PR,
                             int PT, void* phi, void* swarm, void* bank,
                             void* regs, int B, int Jw, int G, int W_units,
                             int CPW, int BITS, int CODE, int R, int T,
                             void* stream) {
  if (entries <= 0 || entries % 128 != 0 || B <= 0 || G <= 0 || R < 0 ||
      T < 0 || PR < 1 || PT < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const int32_t*>(data);
  const auto* s0 = static_cast<const int32_t*>(state0);
  const auto* jz = static_cast<const int32_t*>(j0);
  const auto* tn = static_cast<const int32_t*>(t_next);
  const auto* tr = static_cast<const int32_t*>(t_regsrc);
  const auto* tc = static_cast<const int32_t*>(t_csrc);
  const auto* tm = static_cast<const int32_t*>(t_cmeta);
  auto* ph = static_cast<int32_t*>(phi);
  auto* sw = static_cast<int32_t*>(swarm);
  auto* bk = static_cast<int32_t*>(bank);
  auto* rg = static_cast<int32_t*>(regs);
  auto st = static_cast<cudaStream_t>(stream);
#define SRE_TDFA(bits, code)                                                \
  launch<bits, code>(d, s0, jz, tn, tr, tc, tm, entries, PR, PT, ph, sw,    \
                     bk, rg, B, Jw, G, W_units, R, T, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4 && CPW == 8) {
    if (CODE == 4) err = SRE_TDFA(4, 4);
    else if (CODE == 8) err = SRE_TDFA(4, 8);
    else if (CODE == 16) err = SRE_TDFA(4, 16);
  } else if (BITS == 8 && CPW == 4) {
    if (CODE == 4) err = SRE_TDFA(8, 4);
    else if (CODE == 8) err = SRE_TDFA(8, 8);
    else if (CODE == 16) err = SRE_TDFA(8, 16);
  }
#undef SRE_TDFA
  return static_cast<int>(err);
}
