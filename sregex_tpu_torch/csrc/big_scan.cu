// Big-table speculative DFA chunk scan for Hopper (sm_90a) with a 16-bit
// table in shared memory.
//
// Replaces the JAX package's TPU kernel ops/pallas_big.py::_kernel_big
// with its row loop _lookup_rows wherever the host's big16_table
// (ops/big.py) holds the table: up to 2^14 states, next states that are
// multiples of ncls, match fields in [0, 3], and at most 116,224 entries
// with the wrap padding (the 500-keyword dictionary: 3,844 states x 27
// classes + 256 = 104,017).  Other big tables keep the global-memory
// kernel (spec_scan.cu, sre_big_scan).  It computes what that kernel
// computes, phi, fm and swarm bit for bit, in the same layout.
//
// What bounds the global-memory kernel: its table, 415 KB of int32
// entries, does not fit shared memory, so every step is a dependent load
// through L1 and L2 that the SM's L1 shares with nothing it can hold;
// at [120, 520, 8, 8, 128] it takes 2.07 ms for the steps the wide kernel
// (table in shared memory) makes in 1.18.  This design:
//
//   - the host re-lays the table at 16 bits an entry: the next state's
//     id (bits 0-13) and the match field (bits 14-15), padded with the
//     entries an index past the fused table reads (index & 127) up to
//     the last index a row and a class code can form.  It is staged once
//     per block into dynamic shared memory (208 KB for the dictionary);
//   - the kernel's state is the state id, not the premultiplied state:
//     the byte address of (sid, code) is sid * 2 ncls + 2 code, formed
//     by two multiply-adds on the FMA pipe beside one byte permute for
//     an 8-bit code; no guard is left (the padding covers every index);
//   - one block of 1024 threads an SM (the table takes the SM's shared
//     memory), persistent: the grid is one wave, the table is staged 132
//     times instead of once per tile, and each warp takes 32-stream
//     items in turn, so the SMs finish together instead of in a last
//     partial wave of tiles;
//   - 32 warps an SM leave the shared-memory pipe idle between a chain's
//     dependent loads, so each lane walks two streams side by side,
//     two independent chains of loads (side by side, 1.15-1.20 ms
//     against 1.35-1.41 for one, tools/time_kernel_variants.py);
//   - the premultiplied entry state becomes a state id at the stream's
//     start and the exit state is premultiplied again at its end, so the
//     planes are those of the one-lookup kernels.  A stream whose entry
//     is not a row (not a multiple of ncls, or past the table's rows)
//     walks its warmup through the fused table in global memory, as
//     sre_big_scan does, and goes on in 16-bit steps when the state it
//     reaches is a row (every state the table produces is one), or in
//     one-code steps to the end when the whole warmup was frozen.
//
// What bounds it now: shared-memory bank conflicts.  Lanes in different
// states of the dictionary read ~27 distinct words a load, which need
// ~3.4 wavefronts (tools/bank_conflicts.py), 0.84 ms of the 1.07 at one
// wavefront a clock an SM; a step runs ~7.4 instructions, ~3.5 on the
// integer pipe (tools/sass_loops.py).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace {

using namespace sre_scan;

constexpr int kWarps = kTile / 32;

// One stream of a warp item: where its words and planes are, and its
// state (premultiplied s on the one-code walk, the id sid on the 16-bit
// one) and fold after the warmup.
struct Stream {
  const int32_t* src;
  int64_t plane;
  int32_t s;
  uint32_t sid;
  bool fast, live;
};

// The kernel's arguments but the 16-bit table.
struct Args {
  const int32_t* data;
  const int32_t* state0;
  const int32_t* j0;
  const int32_t* table;       // the fused table in global memory
  int32_t* phi;
  int32_t* fm;
  int32_t* swarm;
  uint32_t n, ncls2;
  int ncls, rows, Jw, G, warm_words, items;
  int64_t wstride;
};

// Item ``item``'s stream of this lane: its warmup from state0, frozen
// while j < j0, through the 16-bit table when the entry is a row, else
// through the fused table; swarm is written here.
template <int BITS>
__device__ __forceinline__ Stream enter(const Args& a, const char* tab,
                                        int item) {
  constexpr int CPW = Packing<BITS>::kCpw;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  Stream st{};
  st.live = item < a.items;
  if (!st.live) return st;
  const int64_t tile = item / kWarps;                    // b * G + g
  const int t = (item % kWarps) * 32 + (threadIdx.x & 31);
  st.plane = tile * kTile + t;                           // [B, G, 8, 128]
  st.src = a.data + ((tile / a.G) * a.Jw * a.G + tile % a.G) * kTile + t;
  int32_t s = a.state0[st.plane];
  const int32_t jz = a.j0[st.plane];
  bool fast = is_row(s, a.ncls, a.rows);
  uint32_t sid = fast ? static_cast<uint32_t>(s / a.ncls) : 0u;
  for (int w = 0; w < a.warm_words; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(st.src + w * a.wstride));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      if (fast) {
        const uint32_t nxt =
            step16(tab, sid, a.ncls2, code<BITS>(word, k)) & kSidMask;
        if (w * CPW + k >= jz) sid = nxt;
      } else {
        const uint32_t cls = (word >> (BITS * k)) & kClassMask;
        const int32_t e =
            lookup<false>(a.table, static_cast<uint32_t>(s) + cls, a.n);
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
  a.swarm[st.plane] = s;
  st.s = s;
  st.sid = sid;
  st.fast = fast;
  return st;
}

template <bool COUNT>
__device__ __forceinline__ void fold16(uint32_t* acc, uint32_t e) {
  if (COUNT) {
    *acc += e >> 14;
  } else {
    *acc |= e;
  }
}

template <bool COUNT>
__device__ __forceinline__ void store16(const Args& a, const Stream& st,
                                        uint32_t sid, uint32_t acc) {
  a.phi[st.plane] = static_cast<int32_t>(sid) * a.ncls;
  a.fm[st.plane] = static_cast<int32_t>(COUNT ? acc : acc >> 14);
}

// The rest of one stream alone: 16-bit steps, or sre_big_scan's walk when
// its state after the warmup is not a row.
template <int BITS, bool COUNT>
__device__ __forceinline__ void finish(const Args& a, const char* tab,
                                       const Stream& st) {
  constexpr int CPW = Packing<BITS>::kCpw;
  constexpr uint32_t kClassMask = (1u << BITS) - 1u;
  if (!st.live) return;
  uint32_t acc = 0;
  const int32_t* p = st.src + a.warm_words * a.wstride;
  if (st.fast) {
    uint32_t sid = st.sid;
#pragma unroll 2
    for (int w = a.warm_words; w < a.Jw; ++w, p += a.wstride) {
      const uint32_t word = static_cast<uint32_t>(__ldg(p));
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const uint32_t e = step16(tab, sid, a.ncls2, code<BITS>(word, k));
        sid = e & kSidMask;
        fold16<COUNT>(&acc, e);
      }
    }
    store16<COUNT>(a, st, sid, acc);
    return;
  }
  int32_t s = st.s;
  for (int w = a.warm_words; w < a.Jw; ++w, p += a.wstride) {
    const uint32_t word = static_cast<uint32_t>(__ldg(p));
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const uint32_t cls = (word >> (BITS * k)) & kClassMask;
      const int32_t e =
          lookup<false>(a.table, static_cast<uint32_t>(s) + cls, a.n);
      if (COUNT) {
        acc += static_cast<uint32_t>(e >> kMatchShift);
      } else {
        acc |= static_cast<uint32_t>(e);
      }
      s = e & kStateMask;
    }
  }
  a.phi[st.plane] = s;
  a.fm[st.plane] = COUNT ? static_cast<int32_t>(acc)
                         : (static_cast<int32_t>(acc) >> kMatchShift);
}

// Each warp takes two items at a time (a lane, two streams) and walks
// them side by side: two independent chains of shared-memory loads.
template <int BITS, bool COUNT>
__global__ void __launch_bounds__(kTile, 1)
big_smem_kernel(const Args a, const uint4* __restrict__ t16, int len16) {
  constexpr int CPW = Packing<BITS>::kCpw;
  extern __shared__ uint4 smem16[];
  for (int i = threadIdx.x; i < len16 / 8; i += blockDim.x)
    smem16[i] = t16[i];
  __syncthreads();
  const char* tab = reinterpret_cast<const char*>(smem16);
  const int stride = gridDim.x * kWarps;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < a.items;
       item += 2 * stride) {
    const Stream x = enter<BITS>(a, tab, item);
    const Stream y = enter<BITS>(a, tab, item + stride);
    if (!(x.fast && y.fast && y.live)) {
      finish<BITS, COUNT>(a, tab, x);
      finish<BITS, COUNT>(a, tab, y);
      continue;
    }
    uint32_t sx = x.sid, sy = y.sid, ax = 0, ay = 0;
    const int32_t* px = x.src + a.warm_words * a.wstride;
    const int32_t* py = y.src + a.warm_words * a.wstride;
#pragma unroll 2
    for (int w = a.warm_words; w < a.Jw;
         ++w, px += a.wstride, py += a.wstride) {
      const uint32_t wx = static_cast<uint32_t>(__ldg(px));
      const uint32_t wy = static_cast<uint32_t>(__ldg(py));
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const uint32_t ex = step16(tab, sx, a.ncls2, code<BITS>(wx, k));
        const uint32_t ey = step16(tab, sy, a.ncls2, code<BITS>(wy, k));
        sx = ex & kSidMask;
        sy = ey & kSidMask;
        fold16<COUNT>(&ax, ex);
        fold16<COUNT>(&ay, ey);
      }
    }
    store16<COUNT>(a, x, sx, ax);
    store16<COUNT>(a, y, sy, ay);
  }
}

// Persistent launch: one wave of SMs x occupancy, or fewer blocks when
// the items need fewer.
template <int BITS, bool COUNT>
cudaError_t launch(const Args& args, const uint4* t16, int len16,
                   cudaStream_t stream) {
  auto kernel = big_smem_kernel<BITS, COUNT>;
  const size_t smem = static_cast<size_t>(len16) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kTile,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(std::min<int64_t>(
      args.items / kWarps, static_cast<int64_t>(sms) * std::max(occ, 1)));
  kernel<<<blocks, kTile, smem, stream>>>(args, t16, len16);
  return cudaGetLastError();
}

}  // namespace

// data int32 [B, Jw, G, 8, 128]; state0, j0, phi, fm, swarm int32
// [B, G, 8, 128]; table int32 [table_len], the fused table (the walk of
// streams whose entry is not a row reads it); t16 uint16 [len16], the
// 16-bit table of ops/big.big16_table for this fused table: rows state
// ids of ncls classes, len16 a multiple of 8, at least (rows - 1) * ncls
// + 2^BITS entries and at most one block's shared memory.  W_units is the
// warmup length in bytes.  Returns the cudaError_t of the launch (0 on
// success); the caller checks shapes.
extern "C" int sre_big_scan_smem(const void* data, const void* state0,
                                 const void* j0, const void* table,
                                 int table_len, void* phi, void* fm,
                                 void* swarm, int B, int Jw, int G,
                                 int W_units, int CPW, int BITS, int COUNT,
                                 const void* t16, int len16, int ncls,
                                 int rows, void* stream) {
  if ((BITS != 4 && BITS != 8) || table_len <= 0 || table_len % 128 != 0 ||
      B <= 0 || G <= 0 || ncls <= 0 || rows <= 0 || rows > (1 << 14) ||
      len16 % 8 != 0 || static_cast<int64_t>(len16) * 2 > kSmemMax ||
      static_cast<int64_t>(rows - 1) * ncls + (1 << BITS) > len16 ||
      CPW != (BITS == 4 ? Packing<4>::kCpw : Packing<8>::kCpw))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.data = static_cast<const int32_t*>(data);
  a.state0 = static_cast<const int32_t*>(state0);
  a.j0 = static_cast<const int32_t*>(j0);
  a.table = static_cast<const int32_t*>(table);
  a.phi = static_cast<int32_t*>(phi);
  a.fm = static_cast<int32_t*>(fm);
  a.swarm = static_cast<int32_t*>(swarm);
  a.n = static_cast<uint32_t>(table_len);
  a.ncls2 = 2u * static_cast<uint32_t>(ncls);
  a.ncls = ncls;
  a.rows = rows;
  a.Jw = Jw;
  a.G = G;
  a.warm_words = W_units / CPW;
  a.items = B * G * kWarps;
  a.wstride = static_cast<int64_t>(G) * kTile;
  const auto* t2 = static_cast<const uint4*>(t16);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (BITS == 4) {
    err = COUNT ? launch<4, true>(a, t2, len16, st)
                : launch<4, false>(a, t2, len16, st);
  } else {
    err = COUNT ? launch<8, true>(a, t2, len16, st)
                : launch<8, false>(a, t2, len16, st);
  }
  return static_cast<int>(err);
}
