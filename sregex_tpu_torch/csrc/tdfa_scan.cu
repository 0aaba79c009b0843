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
// is a chain of dependent table lookups, here four per byte (next,
// cmeta, the register planes) plus the R-slot rebuild, against 0.5 B of
// 4-bit packed input per corpus byte; the kernel is bound by issue and
// latency, not by memory.  The simple design: one stream per thread,
// 256 threads per block (four blocks per (b, g) tile of 1024 streams),
// every plane in shared memory when they fit (all 4- and 8-bit-code
// machines at the card's 2048-entry budget: at most 14 planes, 112 KB),
// else read from global memory through __ldg (16-bit codes, up to 50
// planes); the registers and the bank in per-thread arrays sized for
// the code width.  A code-indexed read (regs[code]) puts those arrays in
// local memory (L1); keeping them in registers (a select chain, or
// templates per R) and skipping the register planes of a state with no
// rebuild are left for later.

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
