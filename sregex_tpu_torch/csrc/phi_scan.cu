// Exact transfer-composition (phi) chunk scans for Hopper (sm_90a).
//
// Replace the JAX package's TPU kernels ops/pallas_phi.py::_phi_kernel
// (the lane-packed layout, S <= 128 plain states; launched by _phi_run)
// and ::_phi_kernel_big (the sublane-group layout, 128 < S <= 1024;
// launched by _phi_run_big).  For every chunk and EVERY entry state they
// compute the exit state and either the number of match boundaries
// (COUNT) or the offset in the chunk of the first one (kSent when none),
// so the chunks compose exactly on the device with no speculation.
//
// Both write slot t = sublane * 128 + lane of a (b, g) tile of the
// [B, G, 8, 128] phi / acc planes (the exit state premultiplied by
// ncls) from the tile's words in the [B, P, G, 8, 128] layout.
//
//   lane-packed: a lane row holds nseg = 128 / S segments of S lanes,
//     one chunk each, seg = lane / S, entry = lane % S; the segment's
//     word w lies at plane w / WL, lane (w % WL) * nseg + seg.  Lanes
//     >= nseg * S are padding: the kernel leaves them unwritten.
//   sublane-group: a chunk's entry states are striped over SB sublanes,
//     entry = (sublane % SB) * 128 + lane (padding slots, entry >= S, run
//     from S - 1 and are not used); word w lies at plane w / 128, lane
//     w % 128 of the slot's own sublane (the prep copies it into each of
//     the group's SB sublanes).
//
// The TPU could only gather within one 128-lane row, so its lookup was a
// select chain over the table's rows; here the whole fused table (at most
// 1024 entries lane-packed, 64 rows = 8192 entries sublane-group on the
// card; 32 KB) is staged once per block in shared memory and a lookup is
// one shared-memory load.  Per class: e = tab[state + cls]; acc += e >> 20
// (COUNT) or latch w * CPW + k the first time e >> 20 > 0 (scan); state =
// e & (2^20 - 1).  An index past the table reads entry (index & 127), as
// the TPU's chain does (a row past the table falls to row 0).
//
// What bounds it: each slot's chain of dependent shared-memory loads,
// S slots per chunk, so both kernels do O(S) operations per corpus byte
// by construction; per slot-step the integer instructions that form
// the address and fold the match (64 lanes a clock an SM) and the
// shared-memory wavefronts (one a clock an SM) share the bound, and a
// thread that loads one word at a time waits on device memory.
//
// The lane-packed kernel's design for Hopper (phi_lane_stride_kernel):
//
//   - several slots per thread: a thread owns NS = 4 (S <= 4) or 8
//     slots of one chunk, T = ceil(S / NS) threads a chunk, neighbouring
//     threads on neighbouring chunks, so a warp's word loads are the
//     layout's neighbouring lanes.  A thread loads each word of its chunk
//     once, 8 words at a time ahead of their steps, decodes it once and
//     runs its slots as independent chains; blocks are persistent and
//     stage the tables once;
//   - KS classes a lookup through the k-gram table, as below, KS = 8
//     (one lookup a word and slot) where S * ncls^8 fits;
//   - the decode of a 4-bit word: the even and odd class nibbles as
//     bytes, one multiply-add makes the pairs c_2j + ncls * c_2j+1 as
//     bytes (ncls <= 16) and a SWAR add tests every class against ncls
//     at once; the k-gram indices are the pairs' Horner sums;
//   - exact on every input, as the sublane-group kernel: a word with a
//     class code >= ncls steps its classes one at a time through the
//     padded fused table (per thread: each thread owns its own chunk).
//
// The sublane-group kernel's design for Hopper (phi_big_stride_kernel):
//
//   - several slots per thread: a half-warp owns one sublane row, and a
//     thread the 8 slots at lanes l + 16 i of it.  The row's words are
//     loaded 16 at a time (lane j of the half loads word w0 + j,
//     coalesced), decoded once and broadcast with a shuffle; the 8 slots
//     are 8 independent load chains.  The second half takes its slots in
//     an order rotated by one, so that at each load the two halves' rows
//     (128 states apart) sit 16 banks apart for an odd ncls^KS instead
//     of on the same banks.  Blocks are persistent (one wave of SMs x
//     occupancy) and stage the tables once;
//   - a stride of KS classes a lookup: the host builds, from the fused
//     table, the KS-gram table tabk[q * ncls^KS + g] of every state q
//     and every KS classes g (mixed radix, first class lowest), whose
//     entry holds the state after the KS steps as a byte offset into
//     tabk (q' * ncls^KS * 4) at bit 14 and, below it, the match count
//     (COUNT) or 1 + the offset of the first match in the KS steps
//     (scan).  A chain step is one shift-add for the address, one
//     shared-memory load and, for COUNT, one add of the whole entry: the
//     low bits of the sum are the count (flushed every 16 words, before
//     they could reach bit 14);
//   - exact on every input: a word whose classes are not all below ncls
//     (the plain version takes any class code) steps its classes one at
//     a time through the fused table, staged padded so that the index
//     past the table reads entry (index & 127) with no guard.  The branch
//     is per word and uniform across a half-warp (one chunk; across the
//     warp too, where both rows are copies of one chunk's words).
//
// The k-gram table needs valid premultiplied states in every entry of
// the fused table (a multiple of ncls below S * ncls), as every table
// PhiTables and PhiTablesBig build has; ops/phi.stride_table checks it.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kMatchShift = 20;
constexpr int32_t kStateMask = (1 << kMatchShift) - 1;
constexpr int32_t kSent = 1 << 30;
constexpr size_t kSmemMax = 232448;   // 227 KB, a block's shared memory

// Step one slot through the CPW classes of one data word (word index w).
// GUARD: an index past the n-entry table reads entry (index & 127); a
// table staged padded with those entries needs no guard.
template <int BITS, bool COUNT, bool GUARD = true>
__device__ __forceinline__ void step_word(const int32_t* tab, uint32_t n,
                                          uint32_t word, int w, int32_t& s,
                                          int32_t& acc) {
  constexpr int CPW = 32 / BITS;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    uint32_t idx = static_cast<uint32_t>(s) + ((word >> (BITS * k)) &
                                               kClassMask);
    if (GUARD) idx = idx < n ? idx : (idx & 127u);
    const int32_t e = tab[idx];
    if (COUNT) {
      acc += e >> kMatchShift;
    } else if ((e >> kMatchShift) > 0 && acc == kSent) {
      acc = w * CPW + k;
    }
    s = e & kStateMask;
  }
}

constexpr int kSlots = 8;   // slots a thread owns in the stride kernels
constexpr int kBatch = 8;   // words a lane-packed thread loads at once
// a k-gram entry: the next row's byte offset at bit 14, the count or the
// first match in the k steps below it
constexpr int kOffShift = 14;
constexpr uint32_t kFieldMask = (1u << kOffShift) - 1u;

// Stage a stride kernel's tables in shared memory: the k-gram table, then
// the fused table padded with 2^BITS entries (index & 127), so that the
// single steps of the slow path need no guard.
template <int BITS>
__device__ __forceinline__ void stage_stride(int32_t* smem,
                                             const int32_t* stride,
                                             int stride_len,
                                             const int32_t* table,
                                             int table_len) {
  for (int i = threadIdx.x; i < stride_len; i += blockDim.x)
    smem[i] = stride[i];
  int32_t* tab1 = smem + stride_len;
  const int pad_len = table_len + (1 << BITS);
  for (int i = threadIdx.x; i < pad_len; i += blockDim.x)
    tab1[i] = table[i < table_len ? i : (i & 127)];
  __syncthreads();
}

// The k-gram indices of a word's CPW / KS groups (mixed radix, first
// class lowest); false when a class code is >= ncls.  SWAR (4-bit codes,
// KS >= 2, ncls <= 16): the even and odd nibbles as bytes; the pairs
// c_2j + ncls * c_2j+1 as bytes, one multiply-add (at most 255: no carry
// between bytes); a byte b >= ncls iff b + 128 - ncls reaches bit 7.
template <int BITS, int KS>
__device__ __forceinline__ bool decode(uint32_t word, bool swar,
                                       uint32_t ncls, uint32_t k4,
                                       const uint32_t (&pw)[KS],
                                       uint32_t (&g)[32 / BITS / KS]) {
  constexpr int CPW = 32 / BITS;
  constexpr int GPW = CPW / KS;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  if (BITS == 4 && KS >= 2 && swar) {
    const uint32_t ev = word & 0x0F0F0F0Fu;
    const uint32_t od = (word >> 4) & 0x0F0F0F0Fu;
    const uint32_t pairs = ev + od * ncls;
    const uint32_t n2 = ncls * ncls;
#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      uint32_t gs = 0;
#pragma unroll
      for (int t = KS / 2 - 1; t >= 0; --t)
        gs = gs * n2 + ((pairs >> (8 * (gi * KS / 2 + t))) & 0xFFu);
      g[gi] = gs;
    }
    return (((ev + k4) | (od + k4)) & 0x80808080u) == 0;
  }
  bool ok = true;
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi) {
    uint32_t gs = 0;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      const uint32_t c = (word >> (BITS * (gi * KS + t))) & kClassMask;
      ok &= c < ncls;
      gs += c * pw[t];
    }
    g[gi] = gs;
  }
  return ok;
}

// The lane-packed layout through the k-gram table: a thread owns NS slots
// (entry states j * NS + i, clamped to S - 1) of one chunk; item = chunk
// * T + j.  The state of a slot is a k-gram entry (its row's byte offset
// at bit 14), as in phi_big_stride_kernel.
template <int BITS, int KS, int NS, bool COUNT>
__global__ void __launch_bounds__(kTile)
phi_lane_stride_kernel(const int32_t* __restrict__ data,
                       const int32_t* __restrict__ table, int table_len,
                       const int32_t* __restrict__ stride, int stride_len,
                       int32_t* __restrict__ phi,
                       int32_t* __restrict__ acc_out, int P, int G, int Kw,
                       int WL, int S, int nseg, int T, int ncls,
                       int64_t items, uint32_t unit, int ushift,
                       uint32_t uinv) {
  constexpr int CPW = 32 / BITS;
  constexpr int GPW = CPW / KS;
  extern __shared__ int32_t smem[];
  stage_stride<BITS>(smem, stride, stride_len, table, table_len);
  const char* tk = reinterpret_cast<const char*>(smem);
  const int32_t* tab1 = smem + stride_len;
  // a slot's premultiplied state from its k-gram entry: (s >> 14) / unit,
  // an exact division, as a shift and a multiply by the inverse of unit's
  // odd part (a division the compiler would hoist onto the fast path)
  const auto premult = [=](uint32_t e) {
    return ((e >> kOffShift) >> ushift) * uinv;
  };

  // a word's offset from the chunk's first: nseg a word, and past the
  // plane's WL words the jump to the next plane
  const int jump = G * kTile - WL * nseg;
  const uint32_t ncu = static_cast<uint32_t>(ncls);
  const bool swar = ncu <= 16u;
  const uint32_t k4 = (128u - (swar ? ncu : 16u)) * 0x01010101u;
  const uint32_t rowb = unit * ncu;             // a k-gram row's bytes
  const int per_tile = 8 * nseg;
  uint32_t pw[KS];                              // ncls^t
  pw[0] = 1u;
#pragma unroll
  for (int t = 1; t < KS; ++t) pw[t] = pw[t - 1] * ncu;

  for (int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       item < items; item += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t chunk = item / T;
    const int j = static_cast<int>(item - chunk * T);
    const int64_t tile = chunk / per_tile;
    const int r = static_cast<int>(chunk - tile * per_tile);
    const int sub = r / nseg;
    const int seg = r - sub * nseg;
    const int64_t b = tile / G;
    const int64_t g = tile % G;
    const int32_t* src = data + (b * P * G + g) * kTile + sub * 128 + seg;
    // COUNT sums whole entries in raw: their low kOffShift bits add up to
    // the count of a 16-word batch, which stays below 2^14
    uint32_t s[NS], raw[NS];
    int32_t acc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int e = min(j * NS + i, S - 1);
      s[i] = (static_cast<uint32_t>(e) * rowb) << kOffShift;
      acc[i] = COUNT ? 0 : kSent;
      raw[i] = 0u;
    }
    // the chunk's words in batches of kBatch, each batch's loads issued
    // before its steps: at is the next word's offset, o its lane offset
    // in the plane
    int at = 0, o = 0;
    for (int w0 = 0; w0 < Kw; w0 += kBatch) {
      uint32_t words[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        words[u] = w0 + u < Kw ? static_cast<uint32_t>(__ldg(src + at)) : 0u;
        at += nseg;
        if (++o == WL) {
          o = 0;
          at += jump;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int w = w0 + u;
        if (w >= Kw) break;
        const uint32_t word = words[u];
        uint32_t gq[GPW];
        if (decode<BITS, KS>(word, swar, ncu, k4, pw, gq)) {
#pragma unroll
          for (int gi = 0; gi < GPW; ++gi) {
            const char* row_base = tk + (gq[gi] << 2);
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              const uint32_t e = *reinterpret_cast<const uint32_t*>(
                  row_base + (s[i] >> kOffShift));
              if (COUNT) {
                raw[i] += e;
              } else if ((e & kFieldMask) != 0 && acc[i] == kSent) {
                acc[i] = w * CPW + gi * KS +
                         static_cast<int32_t>(e & kFieldMask) - 1;
              }
              s[i] = e;
            }
          }
        } else {
          // a class code >= ncls: single steps through the padded table
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            int32_t s1 = static_cast<int32_t>(premult(s[i]));
            step_word<BITS, COUNT, false>(tab1, 0u, word, w, s1, acc[i]);
            s[i] = (static_cast<uint32_t>(s1) * unit) << kOffShift;
          }
        }
      }
      if (COUNT && (w0 & 15) == 16 - kBatch) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          acc[i] += static_cast<int32_t>(raw[i] & kFieldMask);
          raw[i] = 0u;
        }
      }
    }
    int32_t* po = phi + tile * kTile + sub * 128 + seg * S;
    int32_t* ao = acc_out + tile * kTile + sub * 128 + seg * S;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int e = j * NS + i;
      if (e < S) {
        po[e] = static_cast<int32_t>(premult(s[i]));
        ao[e] = acc[i] + (COUNT ? static_cast<int32_t>(raw[i] & kFieldMask)
                                : 0);
      }
    }
  }
}

template <int BITS, int KS, bool COUNT>
__global__ void __launch_bounds__(kTile)
phi_big_stride_kernel(const int32_t* __restrict__ data,
                      const int32_t* __restrict__ table, int table_len,
                      const int32_t* __restrict__ stride, int stride_len,
                      int32_t* __restrict__ phi,
                      int32_t* __restrict__ acc_out, int P, int G, int Kw,
                      int S, int SB, int ncls, int64_t items, uint32_t unit) {
  constexpr int CPW = 32 / BITS;
  constexpr int GPW = CPW / KS;                 // k-grams a word
  constexpr int GB = BITS * KS;                 // bits of a k-gram index
  constexpr uint32_t kGramMask = GB >= 32 ? ~0u : (1u << GB) - 1u;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  extern __shared__ int32_t smem[];
  stage_stride<BITS>(smem, stride, stride_len, table, table_len);
  const char* tk = reinterpret_cast<const char*>(smem);  // the k-gram table
  const int32_t* tab1 = smem + stride_len;      // the fused table, padded
  const int half = (threadIdx.x >> 4) & 1;      // the warp's row of a pair
  const int hl = threadIdx.x & 15;              // the lane in the half
  const unsigned hm = 0xFFFFu << (16 * half);   // the half's shuffle mask
  const int wpb = blockDim.x >> 5;
  const int64_t pstride = static_cast<int64_t>(G) * kTile;
  const uint32_t ncu = static_cast<uint32_t>(ncls);
  uint32_t pw[KS];                              // ncls^t
  pw[0] = 1u;
#pragma unroll
  for (int t = 1; t < KS; ++t) pw[t] = pw[t - 1] * ncu;

  for (int64_t item = static_cast<int64_t>(blockIdx.x) * wpb +
                      (threadIdx.x >> 5);
       item < items; item += static_cast<int64_t>(gridDim.x) * wpb) {
    const int64_t tile = item >> 2;             // four row pairs a tile
    const int row = static_cast<int>(item & 3) * 2 + half;
    const int64_t b = tile / G;
    const int64_t g = tile % G;
    const int32_t* src = data + (b * P * G + g) * kTile + row * 128;
    // a slot's state, in the k-gram entry's form: the byte offset in tabk
    // of its row, q * ncls^KS * 4, at bit kOffShift (the low bits are not
    // read); slot i of the thread is lane hl + 16 * ((i + half) % 8) of
    // the row.  COUNT sums whole entries in raw: their low kOffShift bits
    // add up to the count of a 16-word batch, which stays below 2^14
    uint32_t s[kSlots], raw[kSlots];
    int32_t acc[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int e = min((row % SB) * 128 + hl + 16 * ((i + half) & 7),
                        S - 1);
      s[i] = (static_cast<uint32_t>(e) * ncu * unit) << kOffShift;
      acc[i] = COUNT ? 0 : kSent;
      raw[i] = 0u;
    }
    for (int w0 = 0; w0 < Kw; w0 += 16) {
      const int wl = w0 + hl;
      const uint32_t word =
          wl < Kw ? static_cast<uint32_t>(
                        __ldg(src + (wl >> 7) * pstride + (wl & 127)))
                  : 0u;
      // this lane's word: its k-gram indices, and whether every class is
      // below ncls
      uint32_t gw = 0;
      bool ok = true;
#pragma unroll
      for (int gi = 0; gi < GPW; ++gi) {
        uint32_t gs = 0;
#pragma unroll
        for (int t = 0; t < KS; ++t) {
          const uint32_t c = (word >> (BITS * (gi * KS + t))) & kClassMask;
          ok &= c < ncu;
          gs += c * pw[t];
        }
        if (GB < 32) gw |= gs << ((GB * gi) & 31);
        else gw = gs;
      }
      const uint32_t fast = __ballot_sync(~0u, ok) >> (16 * half);
      const int nw = min(16, Kw - w0);
      for (int jj = 0; jj < nw; ++jj) {
        const int pos = (w0 + jj) * CPW;
        const uint32_t gq = __shfl_sync(~0u, gw, jj, 16);
        if ((fast >> jj) & 1u) {
#pragma unroll
          for (int gi = 0; gi < GPW; ++gi) {
            const char* row_base =
                tk + (((gq >> ((GB * gi) & 31)) & kGramMask) << 2);
#pragma unroll
            for (int i = 0; i < kSlots; ++i) {
              const uint32_t e = *reinterpret_cast<const uint32_t*>(
                  row_base + (s[i] >> kOffShift));
              if (COUNT) {
                raw[i] += e;
              } else if ((e & kFieldMask) != 0 && acc[i] == kSent) {
                acc[i] = pos + gi * KS + static_cast<int32_t>(e & kFieldMask)
                         - 1;
              }
              s[i] = e;
            }
          }
        } else {
          // a class code >= ncls: single steps through the padded table
          const uint32_t wd = __shfl_sync(hm, word, jj, 16);
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            int32_t s1 = static_cast<int32_t>((s[i] >> kOffShift) / unit);
            step_word<BITS, COUNT, false>(tab1, 0u, wd, w0 + jj, s1, acc[i]);
            s[i] = (static_cast<uint32_t>(s1) * unit) << kOffShift;
          }
        }
      }
      if (COUNT) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          acc[i] += static_cast<int32_t>(raw[i] & kFieldMask);
          raw[i] = 0u;
        }
      }
    }
    int32_t* po = phi + tile * kTile + row * 128 + hl;
    int32_t* ao = acc_out + tile * kTile + row * 128 + hl;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int o = 16 * ((i + half) & 7);
      po[o] = static_cast<int32_t>((s[i] >> kOffShift) / unit);
      ao[o] = acc[i];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch a stride kernel on persistent blocks: one wave of SMs x
// occupancy, or fewer when ``threads`` need fewer.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, size_t smem, int64_t threads,
                              cudaStream_t stream, Args... args) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kTile,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int64_t wanted = (threads + kTile - 1) / kTile;
  const int blocks = static_cast<int>(
      std::min<int64_t>(wanted, static_cast<int64_t>(sms) * std::max(occ, 1)));
  kernel<<<blocks, kTile, smem, stream>>>(args...);
  return cudaGetLastError();
}

size_t stride_smem(int stride_len, int table_len, int bits) {
  return (static_cast<size_t>(stride_len) + table_len + (1 << bits)) *
         sizeof(int32_t);
}

template <int BITS, int KS, bool COUNT>
cudaError_t launch_lane(const int32_t* d, const int32_t* t, int table_len,
                        const int32_t* k, int stride_len, int32_t* phi,
                        int32_t* acc, int B, int P, int G, int Kw, int WL,
                        int S, int nseg, int ncls, uint32_t unit,
                        cudaStream_t stream) {
  // unit = odd << ushift; uinv = odd^-1 mod 2^32 (Newton's iteration,
  // each step doubling the correct low bits from 3)
  int ushift = 0;
  while (!((unit >> ushift) & 1u)) ++ushift;
  const uint32_t odd = unit >> ushift;
  uint32_t uinv = odd;
  for (int i = 0; i < 5; ++i) uinv *= 2u - odd * uinv;
  const int ns = S <= 4 ? 4 : kSlots;
  const int T = (S + ns - 1) / ns;
  const int64_t items = static_cast<int64_t>(B) * G * 8 * nseg * T;
  const size_t smem = stride_smem(stride_len, table_len, BITS);
  if (ns == 4)
    return launch_persistent(phi_lane_stride_kernel<BITS, KS, 4, COUNT>,
                             smem, items, stream, d, t, table_len, k,
                             stride_len, phi, acc, P, G, Kw, WL, S, nseg, T,
                             ncls, items, unit, ushift, uinv);
  return launch_persistent(phi_lane_stride_kernel<BITS, KS, kSlots, COUNT>,
                           smem, items, stream, d, t, table_len, k,
                           stride_len, phi, acc, P, G, Kw, WL, S, nseg, T,
                           ncls, items, unit, ushift, uinv);
}

template <int BITS, int KS, bool COUNT>
cudaError_t launch_big(const int32_t* d, const int32_t* t, int table_len,
                       const int32_t* k, int stride_len, int32_t* phi,
                       int32_t* acc, int B, int P, int G, int Kw, int S,
                       int SB, int ncls, uint32_t unit, cudaStream_t stream) {
  // an item is a warp: two sublane rows of a tile
  const int64_t items = static_cast<int64_t>(B) * G * 4;
  return launch_persistent(phi_big_stride_kernel<BITS, KS, COUNT>,
                           stride_smem(stride_len, table_len, BITS),
                           items * 32, stream, d, t, table_len, k,
                           stride_len, phi, acc, P, G, Kw, S, SB, ncls,
                           items, unit);
}

// The k-gram table's length S * ncls^KS and unit = 4 * ncls^(KS - 1);
// false unless stride_len is that length.
bool stride_shape(int S, int ncls, int KS, int stride_len, uint32_t* unit) {
  int64_t mk = 1;                                 // ncls^KS
  for (int i = 0; i < KS && mk <= stride_len; ++i) mk *= ncls;
  *unit = static_cast<uint32_t>(4 * (mk / ncls));
  return stride_len > 0 && static_cast<int64_t>(S) * mk == stride_len;
}

bool bad_common(int table_len, int B, int P, int G, int Kw, int ncls) {
  return table_len <= 0 || table_len % 128 != 0 || B <= 0 || P <= 0 ||
         G <= 0 || Kw <= 0 || ncls <= 0;
}

}  // namespace

// data int32 [B, P, G, 8, 128] in the lane-packed layout (Kw words of
// 32 / BITS classes per chunk, WL words per plane); table int32
// [table_len], the fused table; phi, acc int32 [B, G, 8, 128].  S plain
// states, nseg = 128 / S segments, ncls classes; COUNT selects the match
// count over the first-match offset.  stride int32 [stride_len = S *
// ncls^KS], the k-gram table of the fused table for this COUNT mode (KS
// 8, 4, 2 or 1 with 4-bit words, 4, 2 or 1 with 8-bit words;
// ops/phi.stride_table).  Returns the cudaError_t of the launch (0 on
// success); the caller checks shapes.
extern "C" int sre_phi_scan(const void* data, const void* table,
                            int table_len, void* phi, void* acc, int B, int P,
                            int G, int Kw, int WL, int BITS, int S, int nseg,
                            int ncls, int COUNT, const void* stride,
                            int stride_len, int KS, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* k = static_cast<const int32_t*>(stride);
  auto* p = static_cast<int32_t*>(phi);
  auto* a = static_cast<int32_t*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  uint32_t unit = 0;
  if (bad_common(table_len, B, P, G, Kw, ncls) || S <= 0 || S > 128 ||
      nseg <= 0 || nseg * S > 128 || WL <= 0 || WL * nseg > 128 ||
      Kw > P * WL || !stride_shape(S, ncls, KS, stride_len, &unit))
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits, ks)                                                \
  (COUNT ? launch_lane<bits, ks, true>(d, t, table_len, k, stride_len, p, a, \
                                       B, P, G, Kw, WL, S, nseg, ncls, unit, \
                                       st)                                   \
         : launch_lane<bits, ks, false>(d, t, table_len, k, stride_len, p,   \
                                        a, B, P, G, Kw, WL, S, nseg, ncls,   \
                                        unit, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4) {
    err = KS == 8   ? SRE_LAUNCH(4, 8)
          : KS == 4 ? SRE_LAUNCH(4, 4)
          : KS == 2 ? SRE_LAUNCH(4, 2)
          : KS == 1 ? SRE_LAUNCH(4, 1)
                    : cudaErrorInvalidValue;
  } else if (BITS == 8) {
    err = KS == 4   ? SRE_LAUNCH(8, 4)
          : KS == 2 ? SRE_LAUNCH(8, 2)
          : KS == 1 ? SRE_LAUNCH(8, 1)
                    : cudaErrorInvalidValue;
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}

// The sublane-group layout: data int32 [B, P, G, 8, 128] with 128 words
// per plane, the S entry states of a chunk striped over SB sublanes (SB
// a power of two, S <= SB * 128).  stride int32 [stride_len = S * ncls^KS],
// the k-gram table of the fused table for this COUNT mode (KS 1, 2 or 4,
// dividing the classes per word; ops/phi.stride_table).  Other arguments
// as sre_phi_scan.
extern "C" int sre_phi_big_scan(const void* data, const void* table,
                                int table_len, void* phi, void* acc, int B,
                                int P, int G, int Kw, int BITS, int S, int SB,
                                int ncls, int COUNT, const void* stride,
                                int stride_len, int KS, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* k = static_cast<const int32_t*>(stride);
  auto* p = static_cast<int32_t*>(phi);
  auto* a = static_cast<int32_t*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  uint32_t unit = 0;
  if (bad_common(table_len, B, P, G, Kw, ncls) || S <= 0 || SB <= 0 ||
      SB > 8 || (SB & (SB - 1)) != 0 || S > SB * 128 || Kw > P * 128 ||
      (BITS != 4 && BITS != 8) || (KS != 1 && KS != 2 && KS != 4) ||
      !stride_shape(S, ncls, KS, stride_len, &unit))
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits, ks)                                                 \
  (COUNT ? launch_big<bits, ks, true>(d, t, table_len, k, stride_len, p, a,  \
                                      B, P, G, Kw, S, SB, ncls, unit, st)    \
         : launch_big<bits, ks, false>(d, t, table_len, k, stride_len, p, a, \
                                       B, P, G, Kw, S, SB, ncls, unit, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4) {
    err = KS == 4 ? SRE_LAUNCH(4, 4) : KS == 2 ? SRE_LAUNCH(4, 2)
                                               : SRE_LAUNCH(4, 1);
  } else {
    err = KS == 4 ? SRE_LAUNCH(8, 4) : KS == 2 ? SRE_LAUNCH(8, 2)
                                               : SRE_LAUNCH(8, 1);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}
