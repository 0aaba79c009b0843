// Gated phase-2 scan of the fused two-phase core tier for Hopper (sm_90a).
//
// Replaces the JAX package's TPU launch ops/pallas_core.py::
// _dispatch_kernel_gated: the full machine redoes the chunks that escaped
// the core, compacted into a prefix of CAP chunk slots (B2 block rows of
// G*1024 slots), and block rows past ceil(n_esc / (G*1024)) are gated off
// by the TPU's scalar prefetch.  It computes what that launch computes,
// for every table kind: the COUNT-mode speculative scan of each slot (W
// warmup units from state0, frozen while j < j0, then K units), phi, fm
// and swarm bit for bit as spec_scan_ref gives them, in every slot of the
// rows b < min(B2, ceil(n_esc / (G*1024))); the other rows are left
// unwritten.  It does not copy the first port's structure (one block of
// 1024 threads a (b, g) tile, 32 blocks at CAP 32768 on 132 SMs, fed by
// a window gather):
//
//   - one wave of persistent blocks, sized from the SM count and the
//     occupancy.  Every block reads n_esc on the device (no host sync,
//     and the grid does not grow with B2) and deals the warp items (32
//     slots each) of the active rows block-major: item i goes to block
//     i mod grid, so the ~1,000 warps of 30,000 escapes run ~8 to an SM
//     on every SM, whatever the block size;
//   - the windows are read in place: slot i walks chunk sel[i] of the
//     full corpus [B, Jw, G, 8, 128] (word w of chunk c at ((c / GT) * Jw
//     + w) * GT + c % GT, GT = G*1024; padding slots map to chunk 0), or
//     chunk i of a block-layout input without a map.  No 68 MB copy of
//     the windows precedes the kernel;
//   - ~8 warps an SM cannot hide a word load's latency behind other
//     warps, so each lane keeps the next kAhead words of its chunk in
//     flight in registers (a ring that the main loop, unrolled by
//     kAhead, renames away; the warmup's few words stay a plain loop,
//     which measured faster than unrolled);
//   - the table is staged into shared memory with cp.async, all of it in
//     flight at once;
//   - the walk by table kind (route): an int32 table in shared memory
//     with the one-lookup step (narrow and wide tables); the 16-bit table
//     of ops/big.big16_table in shared memory, the state being the state
//     id (big_scan.cu's walk, with one multiply-add on the chain of
//     lookups instead of two; the 500-keyword dictionary's 208 KB); or,
//     for big tables past it, the fused table read from global memory.
//     A big16 stream whose entry is not a row walks the fused table in
//     global memory until its state is one, as big_scan.cu does.
//
// What bounds it, read in place: the scattered words.  Word w of chunk c
// shares its 32-byte sector with the 7 chunks of c's group of 8 only, so
// escapes far apart (the dictionary's: one chunk in 32) fetch a sector a
// word a stream: 30,652 x 520 x 32 B = 510 MB for 64 MB of words,
// 0.48 ms on an NVIDIA H100 80GB HBM3 at 700 W, whatever the ring's depth
// (2, 8 or 16 words).
// The window gather it replaces paid the same reads (0.49 ms) and a copy
// on top.  On gathered windows the same walk takes 0.076 ms: the chain of
// dependent lookups, 2,080 a stream at the dictionary's W + K, and the
// ring's loads in flight (tools/time_kernel_variants.py gated).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace {

using namespace sre_scan;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 8;          // words in flight a lane

enum Route { kSmem32 = 0, kGlobal32 = 1, kBig16 = 2 };

struct Args {
  const int32_t* data;      // [B, Jw, G, 8, 128], or the windows
  const int32_t* sel;       // [B2 * GT] slot -> chunk, or null: slot i
  const int32_t* n_esc;     // one int32 on the device
  const int32_t* state0;    // [B2, G, 8, 128]
  const int32_t* j0;
  const int32_t* table;     // the fused int32 table
  int32_t* phi;
  int32_t* fm;
  int32_t* swarm;
  const void* stage;        // what goes to shared memory (16-byte units)
  int stage_bytes;
  uint32_t n, ncls2, chunks, gt;
  int ncls, rows, B2, Jw, warm_words;
};

// The next kAhead words of one chunk, loaded ahead of their use.
struct Ring {
  uint32_t buf[kAhead];
  const int32_t* next;
  int64_t stride;
  int left;

  __device__ __forceinline__ Ring(const int32_t* p, int64_t s, int n)
      : next(p), stride(s), left(n) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) buf[d] = load();
  }
  __device__ __forceinline__ uint32_t load() {
    const uint32_t w = left > 0 ? static_cast<uint32_t>(__ldg(next)) : 0u;
    next += stride;
    --left;
    return w;
  }
  __device__ __forceinline__ uint32_t pop() {
    const uint32_t w = buf[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) buf[d] = buf[d + 1];
    buf[kAhead - 1] = load();
    return w;
  }
};

// Stage the block's table into shared memory: 16-byte cp.async copies,
// every one in flight before the wait.
__device__ __forceinline__ void stage(void* smem, const void* src,
                                      int bytes) {
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const char* g = static_cast<const char*>(src);
  for (int off = threadIdx.x * 16; off < bytes; off += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(base + off), "l"(g + off) : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One slot on a fused int32 table (in shared memory where SMEM).
template <int BITS, bool SMEM>
__device__ __forceinline__ void walk32(const Args& a, const int32_t* tab,
                                       const int32_t* src, int64_t slot) {
  constexpr int CPW = Packing<BITS>::kCpw;
  Ring ring(src, a.gt, a.Jw);
  int32_t s = a.state0[slot];
  const int32_t jz = a.j0[slot];
  for (int w = 0; w < a.warm_words; ++w) {
    const uint32_t word = ring.pop();
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int32_t e = lookup<SMEM>(
          tab, static_cast<uint32_t>(s) + code<BITS>(word, k), a.n);
      if (w * CPW + k >= jz) s = e & kStateMask;
    }
  }
  a.swarm[slot] = s;
  uint32_t acc = 0;
#pragma unroll kAhead
  for (int w = a.warm_words; w < a.Jw; ++w) {
    const uint32_t word = ring.pop();
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int32_t e = lookup<SMEM>(
          tab, static_cast<uint32_t>(s) + code<BITS>(word, k), a.n);
      acc += static_cast<uint32_t>(e >> kMatchShift);
      s = e & kStateMask;
    }
  }
  a.phi[slot] = s;
  a.fm[slot] = static_cast<int32_t>(acc);
}

// step16 with the code's byte offset c2 = 2 * code formed off the chain:
// one multiply-add between a lookup and the next.
__device__ __forceinline__ uint32_t step16c(const char* tab, uint32_t sid,
                                            uint32_t ncls2, uint32_t c2) {
  return *reinterpret_cast<const uint16_t*>(tab + mad_lo(sid, ncls2, c2));
}

// One slot on the 16-bit table in shared memory: by state id from a row
// entry, else through the fused table in global memory until the state
// after the warmup is a row (every state the table produces is one).
template <int BITS>
__device__ __forceinline__ void walk16(const Args& a, const char* tab,
                                       const int32_t* src, int64_t slot) {
  constexpr int CPW = Packing<BITS>::kCpw;
  Ring ring(src, a.gt, a.Jw);
  int32_t s = a.state0[slot];
  const int32_t jz = a.j0[slot];
  bool fast = is_row(s, a.ncls, a.rows);
  uint32_t sid = fast ? static_cast<uint32_t>(s / a.ncls) : 0u;
  for (int w = 0; w < a.warm_words; ++w) {
    const uint32_t word = ring.pop();
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      if (fast) {
        const uint32_t nxt =
            step16c(tab, sid, a.ncls2, code<BITS>(word, k) << 1) & kSidMask;
        if (w * CPW + k >= jz) sid = nxt;
      } else {
        const int32_t e = lookup<false>(
            a.table, static_cast<uint32_t>(s) + code<BITS>(word, k), a.n);
        if (w * CPW + k >= jz) s = e & kStateMask;
      }
    }
  }
  if (fast) {
    s = static_cast<int32_t>(sid) * a.ncls;
  } else {
    fast = is_row(s, a.ncls, a.rows);
    sid = fast ? static_cast<uint32_t>(s / a.ncls) : 0u;
  }
  a.swarm[slot] = s;
  uint32_t acc = 0;
  if (fast) {
#pragma unroll kAhead
    for (int w = a.warm_words; w < a.Jw; ++w) {
      const uint32_t word = ring.pop();
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const uint32_t e =
            step16c(tab, sid, a.ncls2, code<BITS>(word, k) << 1);
        sid = e & kSidMask;
        acc += e >> 14;
      }
    }
    s = static_cast<int32_t>(sid) * a.ncls;
  } else {
    for (int w = a.warm_words; w < a.Jw; ++w) {
      const uint32_t word = ring.pop();
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const int32_t e = lookup<false>(
            a.table, static_cast<uint32_t>(s) + code<BITS>(word, k), a.n);
        acc += static_cast<uint32_t>(e >> kMatchShift);
        s = e & kStateMask;
      }
    }
  }
  a.phi[slot] = s;
  a.fm[slot] = static_cast<int32_t>(acc);
}

template <int ROUTE, int BITS>
__global__ void __launch_bounds__(kThreads, 1)
gated_scan_kernel(const Args a) {
  extern __shared__ uint4 smem[];
  // the gate: the items (32 slots) of the rows below ceil(n_esc / GT)
  const int64_t gt = a.gt;
  const int64_t ne = *a.n_esc;
  const int64_t need = (ne + gt - 1) / gt;
  const int64_t items = (need < a.B2 ? need : a.B2) * gt / 32;
  if (static_cast<int64_t>(blockIdx.x) >= items) return;
  if constexpr (ROUTE != kGlobal32) stage(smem, a.stage, a.stage_bytes);
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t item = blockIdx.x +
                      static_cast<int64_t>(gridDim.x) * (threadIdx.x >> 5);
       item < items; item += step) {
    const int64_t slot = item * 32 + lane;
    uint32_t c = a.sel ? static_cast<uint32_t>(__ldg(a.sel + slot))
                       : static_cast<uint32_t>(slot);
    if (c >= a.chunks) c = 0;
    const int32_t* src =
        a.data + static_cast<int64_t>(c / a.gt) * a.Jw * gt + c % a.gt;
    if constexpr (ROUTE == kBig16) {
      walk16<BITS>(a, reinterpret_cast<const char*>(smem), src, slot);
    } else {
      walk32<BITS, ROUTE == kSmem32>(
          a, ROUTE == kSmem32 ? reinterpret_cast<const int32_t*>(smem)
                              : a.table,
          src, slot);
    }
  }
}

// One wave: SMs x occupancy blocks, or fewer when the rows hold fewer
// items.
template <int ROUTE, int BITS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = gated_scan_kernel<ROUTE, BITS>;
  const size_t smem = ROUTE == kGlobal32 ? 0 : a.stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int64_t most = static_cast<int64_t>(a.B2) * a.gt / 32;
  const int blocks = static_cast<int>(std::min<int64_t>(
      most, static_cast<int64_t>(sms) * std::max(occ, 1)));
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int ROUTE>
cudaError_t launch_bits(const Args& a, int BITS, cudaStream_t stream) {
  if (BITS == 4) return launch<ROUTE, 4>(a, stream);
  if (BITS == 8) return launch<ROUTE, 8>(a, stream);
  if constexpr (ROUTE == kSmem32) {
    if (BITS == 3) return launch<ROUTE, 3>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The gated COUNT scan.  data int32 [B, Jw, G, 8, 128]: with sel (int32
// [B2 * G * 1024], device) the full corpus of chunks = B * G * 1024
// chunks, slot i reading chunk sel[i] (an entry outside [0, chunks) reads
// chunk 0); without it (null) the windows, B = B2 and slot i reading
// chunk i.  state0, j0, phi, fm, swarm int32 [B2, G, 8, 128]; table int32
// [table_len], the fused table; n_esc a device pointer to one int32.
// route 0: the table in shared memory (table_len * 4 bytes must fit a
// block); 1: the table in global memory; 2: t16 (uint16 [len16]) the
// 16-bit table of ops/big.big16_table for this fused table, ncls and rows
// as there (checked as sre_big_scan_smem checks them).  table and t16
// 16-byte aligned.  W_units is the warmup in bytes.  Rows past
// ceil(*n_esc / (G*1024)) are left unwritten.  Returns the cudaError_t
// of the launch (0 on success); the caller checks shapes.
extern "C" int sre_gated_scan(const void* data, const void* state0,
                              const void* j0, const void* table,
                              int table_len, void* phi, void* fm,
                              void* swarm, int B2, int Jw, int G,
                              int W_units, int CPW, int BITS,
                              const void* n_esc, const void* sel, int chunks,
                              int route, const void* t16, int len16,
                              int ncls, int rows, void* stream) {
  const bool bits_ok =
      (BITS == 3 && CPW == Packing<3>::kCpw && route == kSmem32) ||
      (BITS == 4 && CPW == Packing<4>::kCpw) ||
      (BITS == 8 && CPW == Packing<8>::kCpw);
  if (!bits_ok || table_len <= 0 || table_len % 128 != 0 || B2 <= 0 ||
      G <= 0 || Jw <= 0 || chunks <= 0 || n_esc == nullptr ||
      W_units < 0 || W_units % CPW != 0 || W_units / CPW > Jw)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.data = static_cast<const int32_t*>(data);
  a.sel = static_cast<const int32_t*>(sel);
  a.n_esc = static_cast<const int32_t*>(n_esc);
  a.state0 = static_cast<const int32_t*>(state0);
  a.j0 = static_cast<const int32_t*>(j0);
  a.table = static_cast<const int32_t*>(table);
  a.phi = static_cast<int32_t*>(phi);
  a.fm = static_cast<int32_t*>(fm);
  a.swarm = static_cast<int32_t*>(swarm);
  a.n = static_cast<uint32_t>(table_len);
  a.chunks = static_cast<uint32_t>(chunks);
  a.gt = static_cast<uint32_t>(G) * kTile;
  a.B2 = B2;
  a.Jw = Jw;
  a.warm_words = W_units / CPW;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kSmem32) {
    if (static_cast<int64_t>(table_len) * 4 > kSmemMax)
      return static_cast<int>(err);
    a.stage = table;
    a.stage_bytes = table_len * 4;
    err = launch_bits<kSmem32>(a, BITS, st);
  } else if (route == kGlobal32) {
    err = launch_bits<kGlobal32>(a, BITS, st);
  } else if (route == kBig16) {
    if (t16 == nullptr || ncls <= 0 || rows <= 0 || rows > (1 << 14) ||
        len16 % 8 != 0 || static_cast<int64_t>(len16) * 2 > kSmemMax ||
        static_cast<int64_t>(rows - 1) * ncls + (1 << BITS) > len16)
      return static_cast<int>(err);
    a.stage = t16;
    a.stage_bytes = len16 * 2;
    a.ncls = ncls;
    a.ncls2 = 2u * static_cast<uint32_t>(ncls);
    a.rows = rows;
    err = launch_bits<kBig16>(a, BITS, st);
  }
  return static_cast<int>(err);
}
