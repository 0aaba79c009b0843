// The validation summary of a speculative scan for Hopper (sm_90a): one
// kernel in place of the eager torch ops that followed every scan.
//
// Replaces the JAX package's ops/pallas_scan.py::_summarize (jnp ops that
// XLA fuses on the TPU; no Pallas kernel) and its repair-plane packing
// (_summarize's uint8 planes, the int32 stack of a wide table).  Its
// plain version is ops/spec_scan.py::_summarize with _pack_planes, which
// CPU tensors keep.  It reads the scan's planes phi, fm and swarm (int32,
// Cp chunks each, in chunk order) and writes the int32 [10] summary:
//
//   [0] all_ok  [1] first_bad (0 when every chunk validated)
//   [2] entry, [3] phi, [4] swarm, [5] fm at first_bad  [6] phi[C-1]
//   [7] the fm sum over the validated prefix below C, mod 2^32
//   [8] the last chunk of that prefix with fm != 0 (-1 none)
//   [9] the entry of chunk max([8], 0)
//
// where chunk i's entry is phi[i-1] (state0[0] for chunk 0) and chunk i
// validates when swarm[i] equals its entry, phi[i] is not the escape
// state (HAS_ESC), fm[i] is 0 (scan mode), or i >= C; chunk bad_tail
// never validates.
//
// What bounds it: bytes, 12 read and 12 (wide) or 4 written a chunk
// (23.6 MB at the wide tier's 983,040 chunks, a few microseconds at the
// card's rate); what it replaces cost the host ~40 launches and
// allocations a query.  The design is one pass and one launch: a block
// validates a span of 1024 chunks, writing the packed repair planes as
// it reads, and leaves a record (its first bad chunk, its fm sum and last
// firing chunk below that and below C); the block that takes the last
// ticket folds the records in chunk order and writes the summary, then
// resets the ticket for the next launch on the stream.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 1024;                  // chunks a block validates
                                             // (SUMMARY_SPAN in Python)
constexpr int32_t kNone = INT_MAX;           // no bad chunk

struct MinOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};
struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

// The block's reduction of v under op, returned to every thread.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T ident) {
  __shared__ T part[kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                           // part is free again
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? part[lane] : ident;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) part[kWarps] = v;
  }
  __syncthreads();
  return part[kWarps];
}

// The pack: WIDE int32 [3, Cp] (phi, fm, swarm), else uint8 [4, Cp]
// (phi, fm & 0xFF, swarm, fm >> 8 & 0xFF).  summary null: pack only.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
spec_summary_kernel(const int32_t* __restrict__ phi,
                    const int32_t* __restrict__ fm,
                    const int32_t* __restrict__ swarm,
                    const int32_t* __restrict__ state0, int Cp, int C,
                    int bad_tail, int count, int has_esc, int32_t esc,
                    int4* __restrict__ records,
                    unsigned int* __restrict__ ticket,
                    int32_t* __restrict__ summary, void* __restrict__ packed) {
  __shared__ bool last_block;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int hi = static_cast<int>(lo + kSpan < Cp ? lo + kSpan : Cp);
  const int32_t entry0 = __ldg(state0);
  const int64_t n = Cp;

  int32_t bad = kNone;
  for (int i = static_cast<int>(lo) + threadIdx.x; i < hi; i += kThreads) {
    const int32_t p = __ldg(phi + i);
    const int32_t f = __ldg(fm + i);
    const int32_t s = __ldg(swarm + i);
    if constexpr (WIDE) {
      auto* i32 = static_cast<int32_t*>(packed);
      i32[i] = p;
      i32[n + i] = f;
      i32[2 * n + i] = s;
    } else {
      auto* u8 = static_cast<uint8_t*>(packed);
      u8[i] = static_cast<uint8_t>(p);
      u8[n + i] = static_cast<uint8_t>(f);
      u8[2 * n + i] = static_cast<uint8_t>(s);
      u8[3 * n + i] = static_cast<uint8_t>(f >> 8);
    }
    const int32_t entry = i ? __ldg(phi + i - 1) : entry0;
    bool ok = s == entry;
    if (has_esc) ok = ok && p != esc;
    if (!count) ok = ok && f == 0;
    ok = (ok || i >= C) && i != bad_tail;
    // a thread's chunks rise, so its first bad one is its least
    if (!ok && bad == kNone) bad = i;
  }
  if (summary == nullptr) return;
  bad = block_reduce(bad, MinOp(), kNone);

  // the block's validated prefix: below its first bad chunk and below C
  const int stop = bad < C ? bad : C;
  uint32_t sum = 0;
  int32_t fire = -1;
  for (int i = static_cast<int>(lo) + threadIdx.x; i < hi && i < stop;
       i += kThreads) {
    const int32_t f = __ldg(fm + i);
    sum += static_cast<uint32_t>(f);
    if (f) fire = i;
  }
  sum = block_reduce(sum, AddOp(), 0u);
  fire = block_reduce(fire, MaxOp(), -1);
  if (threadIdx.x == 0) {
    records[blockIdx.x] = make_int4(bad, static_cast<int32_t>(sum), fire, 0);
    __threadfence();                         // the record before the ticket
    last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the fold, in chunk order: the first bad chunk of all; every record up
  // to its block's (its block's record stops at it), all where none
  const int nb = static_cast<int>(gridDim.x);
  int32_t gbad = kNone;
  for (int r = threadIdx.x; r < nb; r += kThreads) {
    const int32_t b = __ldcg(&records[r]).x;
    gbad = b < gbad ? b : gbad;
  }
  gbad = block_reduce(gbad, MinOp(), kNone);
  const int upto = gbad == kNone ? nb - 1 : gbad / kSpan;
  uint32_t total = 0;
  int32_t last = -1;
  for (int r = threadIdx.x; r <= upto; r += kThreads) {
    const int4 rec = __ldcg(&records[r]);
    total += static_cast<uint32_t>(rec.y);
    last = rec.z > last ? rec.z : last;
  }
  total = block_reduce(total, AddOp(), 0u);
  last = block_reduce(last, MaxOp(), -1);
  if (threadIdx.x == 0) {
    const bool all_ok = gbad == kNone;
    const int fb = all_ok ? 0 : gbad;
    const int lf = last > 0 ? last : 0;
    summary[0] = all_ok ? 1 : 0;
    summary[1] = fb;
    summary[2] = fb ? phi[fb - 1] : entry0;
    summary[3] = phi[fb];
    summary[4] = swarm[fb];
    summary[5] = fm[fb];
    summary[6] = phi[C - 1];
    summary[7] = static_cast<int32_t>(total);
    summary[8] = last;
    summary[9] = lf ? phi[lf - 1] : entry0;
    *ticket = 0u;                            // ready for the next launch
  }
}

}  // namespace

// phi, fm, swarm: int32 [Cp] each; state0: int32, entry [0] read.  C in
// [1, Cp]; bad_tail -1 or a chunk that never validates; esc read where
// has_esc.  records: int4 [ceil(Cp / 1024)] of scratch; ticket: one
// unsigned int, 0 between launches (the kernel leaves it 0).  summary:
// int32 [10], or null to write the pack alone (records and ticket
// unread).  packed: int32 [3, Cp] where wide, else uint8 [4, Cp].
// Launches on stream without synchronising; returns the cudaError_t of
// the launch (0 on success).
extern "C" int sre_spec_summary(const void* phi, const void* fm,
                                const void* swarm, const void* state0,
                                int Cp, int C, int bad_tail, int count,
                                int has_esc, int esc, void* records,
                                void* ticket, void* summary, void* packed,
                                int wide, void* stream) {
  if (Cp <= 0 || !packed || (summary && (C < 1 || C > Cp)) ||
      (summary && (!records || !ticket)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (static_cast<int64_t>(Cp) + kSpan - 1) / kSpan;
  const auto* p = static_cast<const int32_t*>(phi);
  const auto* f = static_cast<const int32_t*>(fm);
  const auto* s = static_cast<const int32_t*>(swarm);
  const auto* s0 = static_cast<const int32_t*>(state0);
  auto* rec = static_cast<int4*>(records);
  auto* tk = static_cast<unsigned int*>(ticket);
  auto* out = static_cast<int32_t*>(summary);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (wide)
    spec_summary_kernel<true><<<grid, kThreads, 0, st>>>(
        p, f, s, s0, Cp, C, bad_tail, count, has_esc, esc, rec, tk, out,
        packed);
  else
    spec_summary_kernel<false><<<grid, kThreads, 0, st>>>(
        p, f, s, s0, Cp, C, bad_tail, count, has_esc, esc, rec, tk, out,
        packed);
  return static_cast<int>(cudaGetLastError());
}
