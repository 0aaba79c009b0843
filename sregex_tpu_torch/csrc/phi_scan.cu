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
// One thread owns one phi slot, a (chunk, entry state) pair; a block of
// 1024 threads is one (b, g) tile of the [B, P, G, 8, 128] layout,
// thread t = sublane * 128 + lane, and writes slot t of the [B, G, 8,
// 128] phi / acc planes (the exit state premultiplied by ncls).
//
//   lane-packed: a lane row holds nseg = 128 / S segments of S lanes,
//     seg = lane / S, entry = lane % S; the segment's word w lies at
//     plane w / WL, lane (w % WL) * nseg + seg.  Lanes >= nseg * S are
//     padding: they read lane min(seg + o * nseg, 127) and their result
//     is not used.
//   sublane-group: a chunk's entry states are striped over SB sublanes,
//     entry = (sublane % SB) * 128 + lane (padding slots, entry >= S, run
//     from S - 1 and are not used); word w lies at plane w / 128, lane
//     w % 128 of the thread's own sublane (the prep copies it into each
//     of the group's SB sublanes), so a warp reads one word, broadcast.
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
// S slots per chunk, so the sublane-group kernel does O(S) operations per
// corpus byte by construction.  Neighbouring slots of one chunk hold
// neighbouring entry states, so their first lookups hit distinct banks;
// the word loads coalesce (lane-packed) or broadcast (sublane-group).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kMatchShift = 20;
constexpr int32_t kStateMask = (1 << kMatchShift) - 1;
constexpr int32_t kSent = 1 << 30;

// Step one slot through the CPW classes of one data word (word index w).
template <int BITS, bool COUNT>
__device__ __forceinline__ void step_word(const int32_t* tab, uint32_t n,
                                          uint32_t word, int w, int32_t& s,
                                          int32_t& acc) {
  constexpr int CPW = 32 / BITS;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    uint32_t idx = static_cast<uint32_t>(s) + ((word >> (BITS * k)) &
                                               kClassMask);
    idx = idx < n ? idx : (idx & 127u);
    const int32_t e = tab[idx];
    if (COUNT) {
      acc += e >> kMatchShift;
    } else if ((e >> kMatchShift) > 0 && acc == kSent) {
      acc = w * CPW + k;
    }
    s = e & kStateMask;
  }
}

__device__ __forceinline__ void stage_table(int32_t* tab,
                                            const int32_t* table,
                                            int table_len) {
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
}

template <int BITS, bool COUNT>
__global__ void __launch_bounds__(kTile)
phi_scan_kernel(const int32_t* __restrict__ data,
                const int32_t* __restrict__ table, int table_len,
                int32_t* __restrict__ phi, int32_t* __restrict__ acc_out,
                int P, int G, int Kw, int WL, int S, int nseg, int ncls) {
  extern __shared__ int32_t tab[];
  stage_table(tab, table, table_len);
  const int64_t tile = blockIdx.x;                 // b * G + g
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int sub = threadIdx.x >> 7;
  const int lane = threadIdx.x & 127;
  const int seg = lane / S;
  const int64_t pstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * P * G + g) * kTile + sub * 128;
  const uint32_t n = static_cast<uint32_t>(table_len);
  int32_t s = (lane - seg * S) * ncls;
  int32_t acc = COUNT ? 0 : kSent;
  int w = 0;
  for (int p = 0; p < P; ++p) {
    const int32_t* row = src + p * pstride;
    for (int o = 0; o < WL && w < Kw; ++o, ++w) {
      const int d = min(seg + o * nseg, 127);
      const uint32_t word = static_cast<uint32_t>(__ldg(row + d));
      step_word<BITS, COUNT>(tab, n, word, w, s, acc);
    }
  }
  phi[tile * kTile + threadIdx.x] = s;
  acc_out[tile * kTile + threadIdx.x] = acc;
}

template <int BITS, bool COUNT>
__global__ void __launch_bounds__(kTile)
phi_big_scan_kernel(const int32_t* __restrict__ data,
                    const int32_t* __restrict__ table, int table_len,
                    int32_t* __restrict__ phi, int32_t* __restrict__ acc_out,
                    int P, int G, int Kw, int S, int SB, int ncls) {
  extern __shared__ int32_t tab[];
  stage_table(tab, table, table_len);
  const int64_t tile = blockIdx.x;
  const int64_t b = tile / G;
  const int64_t g = tile % G;
  const int sub = threadIdx.x >> 7;
  const int lane = threadIdx.x & 127;
  const int64_t pstride = static_cast<int64_t>(G) * kTile;
  const int32_t* src = data + (b * P * G + g) * kTile + sub * 128;
  const uint32_t n = static_cast<uint32_t>(table_len);
  int32_t s = min((sub % SB) * 128 + lane, S - 1) * ncls;
  int32_t acc = COUNT ? 0 : kSent;
  int w = 0;
  for (int p = 0; p < P; ++p) {
    const int32_t* row = src + p * pstride;
    for (int o = 0; o < 128 && w < Kw; ++o, ++w) {
      const uint32_t word = static_cast<uint32_t>(__ldg(row + o));
      step_word<BITS, COUNT>(tab, n, word, w, s, acc);
    }
  }
  phi[tile * kTile + threadIdx.x] = s;
  acc_out[tile * kTile + threadIdx.x] = acc;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BITS, bool COUNT>
cudaError_t launch_lane(const int32_t* d, const int32_t* t, int table_len,
                        int32_t* phi, int32_t* acc, int B, int P, int G,
                        int Kw, int WL, int S, int nseg, int ncls,
                        cudaStream_t stream) {
  auto kernel = phi_scan_kernel<BITS, COUNT>;
  const size_t smem = static_cast<size_t>(table_len) * sizeof(int32_t);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * G, kTile, smem, stream>>>(d, t, table_len, phi, acc, P, G, Kw,
                                         WL, S, nseg, ncls);
  return cudaGetLastError();
}

template <int BITS, bool COUNT>
cudaError_t launch_big(const int32_t* d, const int32_t* t, int table_len,
                       int32_t* phi, int32_t* acc, int B, int P, int G,
                       int Kw, int S, int SB, int ncls, cudaStream_t stream) {
  auto kernel = phi_big_scan_kernel<BITS, COUNT>;
  const size_t smem = static_cast<size_t>(table_len) * sizeof(int32_t);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * G, kTile, smem, stream>>>(d, t, table_len, phi, acc, P, G, Kw,
                                         S, SB, ncls);
  return cudaGetLastError();
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
// count over the first-match offset.  Returns the cudaError_t of the
// launch (0 on success); the caller checks shapes.
extern "C" int sre_phi_scan(const void* data, const void* table,
                            int table_len, void* phi, void* acc, int B, int P,
                            int G, int Kw, int WL, int BITS, int S, int nseg,
                            int ncls, int COUNT, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* t = static_cast<const int32_t*>(table);
  auto* p = static_cast<int32_t*>(phi);
  auto* a = static_cast<int32_t*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (bad_common(table_len, B, P, G, Kw, ncls) || S <= 0 || S > 128 ||
      nseg <= 0 || nseg * S > 128 || WL <= 0 || WL * nseg > 128 ||
      Kw > P * WL)
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits)                                                   \
  (COUNT ? launch_lane<bits, true>(d, t, table_len, p, a, B, P, G, Kw, WL, \
                                   S, nseg, ncls, st)                      \
         : launch_lane<bits, false>(d, t, table_len, p, a, B, P, G, Kw, WL, \
                                    S, nseg, ncls, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4) {
    err = SRE_LAUNCH(4);
  } else if (BITS == 8) {
    err = SRE_LAUNCH(8);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}

// The sublane-group layout: data int32 [B, P, G, 8, 128] with 128 words
// per plane, the S entry states of a chunk striped over SB sublanes (SB
// a power of two, S <= SB * 128).  Other arguments as sre_phi_scan.
extern "C" int sre_phi_big_scan(const void* data, const void* table,
                                int table_len, void* phi, void* acc, int B,
                                int P, int G, int Kw, int BITS, int S, int SB,
                                int ncls, int COUNT, void* stream) {
  const auto* d = static_cast<const int32_t*>(data);
  const auto* t = static_cast<const int32_t*>(table);
  auto* p = static_cast<int32_t*>(phi);
  auto* a = static_cast<int32_t*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (bad_common(table_len, B, P, G, Kw, ncls) || S <= 0 || SB <= 0 ||
      SB > 8 || (SB & (SB - 1)) != 0 || S > SB * 128 || Kw > P * 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define SRE_LAUNCH(bits)                                                      \
  (COUNT ? launch_big<bits, true>(d, t, table_len, p, a, B, P, G, Kw, S, SB,  \
                                  ncls, st)                                   \
         : launch_big<bits, false>(d, t, table_len, p, a, B, P, G, Kw, S, SB, \
                                   ncls, st))
  cudaError_t err = cudaErrorInvalidValue;
  if (BITS == 4) {
    err = SRE_LAUNCH(4);
  } else if (BITS == 8) {
    err = SRE_LAUNCH(8);
  }
#undef SRE_LAUNCH
  return static_cast<int>(err);
}
