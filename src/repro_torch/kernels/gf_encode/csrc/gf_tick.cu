// Pipeline-tick kernels of the RapidRAID chain, for Hopper (sm_90a).
//
// Both kernels work on packed GF(2^l) words: one 32-bit lane holds 4 words
// of GF(2^8) or 2 of GF(2^16).
//
// One launch is one tick of the pipeline over a (lane tile, object, active
// node) grid. Node i works chunk ch = t - i of its stream; the kernel works
// ch out itself from the tick t, so a tick needs no host-to-device copy.
// The wire between neighbours is a buffer with one row per node: node i
// reads row i of the incoming buffer and writes row i + 1 of the outgoing
// one (the host keeps row 0 zero, the head of the chain).
//
// chain_tick replaces chain_step_kernel / _chain_step_body
// (src/repro/kernels/gf_encode/kernel.py), the encode tick (Eqs. 3-4):
//     c     = x_in ^ sum_s xi[i, s]  * block(i, s)    (kept codeword chunk)
//     x_out = x_in ^ sum_s psi[i, s] * block(i, s)    (forwarded wire)
// Bound: memory. Per active node and lane it reads the wire and each
// replica slot and writes the codeword and the wire, 16-20 bytes. On the
// (16,11) GF(2^16) main path that is 1.4 ms of HBM; the field arithmetic
// below, about 18 instructions per slot and lane, is about 0.2 ms of issue,
// and the tables' reads, about 3-way bank conflicts, about 0.5 ms of
// shared-memory cycles, both under the HBM roof (estimates; chip_smoke.py
// measured 1.70 ms, PERF.md).
// Design:
// - The replica blocks are read in place: slot s of node i is block
//   slots[i, s] of the object (src), or nothing when it is -1, so the
//   placement is never copied. The slot table and the launch's node order
//   come by value in the kernel's parameters.
// - A multiply is a table lookup. Per (node, slot) the host builds, once
//   per code, tables of the products of every byte value v by the slot's
//   two coefficients: entry = xi * (v << 8j) | psi * (v << 8j) << 16, one
//   table for each byte j of a word. A word's products are the xor of its
//   bytes' entries, so one lookup per byte yields the kept and the
//   forwarded term together, and two byte permutes per lane (four for
//   GF(2^8)) put the kept and the forwarded halves back into lanes. A
//   block stages its node's tables (at most 4 KB) in shared memory.
// - The tables stay 256-entry byte tables in shared memory, bank conflicts
//   and all: 16-entry tables per 4-bit nibble, copied into all 32 banks and
//   read at the thread's own bank, have no conflicts but twice the lookups,
//   and were slower on the H100 in every run (PERF.md).
// - 16 bytes (4 lanes) per load and store wherever the chunk's rows are
//   16-byte aligned, every load of a step issued before the first lookup,
//   and two tiles per block, so the tables are staged once per 2048 lanes
//   (or 512 where rows are not aligned).
// - Two-block nodes (n - k <= i < k) go first in the launch, so the blocks
//   left at a launch's tail are the lighter one-block nodes.
// - The last node's psi is zero and the next tick reads no row past n - 1:
//   with an n-row wire_out that store is skipped.
//
// repair_tick replaces repair_step_kernel / _repair_step_body (same file),
// the decode tick: node i adds sum_b mask_b(local_i) * bp[i, :, b] to the
// rows partial sums it received; the last node writes them to the output
// chunk. A multiply by a coefficient c is
//     c * x = xor_b ((x >> b) & LSB) * (c * alpha^b),
// where LSB has the lowest bit of every packed word set. The mask lanes are
// 0 or 1 and c * alpha^b < 2^l, so the 32-bit product never carries from one
// packed word into the next; it wraps mod 2^32 as it does on the TPU.
// Bound: memory. Each lane carries `rows` partial sums in and out per node,
// 8 * rows bytes of wire traffic against 4 bytes of local data. Design:
// one mask per bit, built once per lane and shared by all rows; the planes
// sit in shared memory and are read as broadcasts; consecutive threads
// touch consecutive lanes so every load and store is coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// chain_tick
// ---------------------------------------------------------------------------

constexpr int kTilesPerBlock = 2;   // grid-stride steps a block's staging serves
constexpr int kMaxTickNodes = 256;  // active nodes one launch takes

// The launch's active nodes, two-block nodes first, and their replica
// slots: slot[z * max_b + s] is a block of src or -1. Passed by value.
struct TickNodes {
  int node[kMaxTickNodes];
  int slot[2 * kMaxTickNodes];
};

// words of one slot's tables: a 256-entry table per byte of a word
template <int L>
constexpr int kSlotWords = L / 8 * 256;

// e[w] ^= the packed (xi, psi) products of word w of lane v, from one
// slot's tables.
template <int L>
__device__ __forceinline__ void add_products(const uint32_t* s_slot, uint32_t v,
                                             uint32_t (&e)[32 / L]) {
#pragma unroll
  for (int w = 0; w < 32 / L; ++w) {
#pragma unroll
    for (int j = 0; j < L / 8; ++j)
      e[w] ^= s_slot[j * 256 + ((v >> (w * L + 8 * j)) & 255u)];
  }
}

// The kept (low halves) and forwarded (high halves) lanes of the products.
template <int L>
__device__ __forceinline__ void split_products(const uint32_t (&e)[32 / L],
                                               uint32_t& kept, uint32_t& fwd) {
  if constexpr (L == 16) {
    kept = __byte_perm(e[0], e[1], 0x5410);
    fwd = __byte_perm(e[0], e[1], 0x7632);
  } else {
    const uint32_t lo = __byte_perm(e[0], e[1], 0x6240);
    const uint32_t hi = __byte_perm(e[2], e[3], 0x6240);
    kept = __byte_perm(lo, hi, 0x5410);
    fwd = __byte_perm(lo, hi, 0x7632);
  }
}

template <int VEC>
__device__ __forceinline__ void load_lanes(const uint32_t* p, uint32_t (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    r[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_lanes(uint32_t* p, const uint32_t (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

// wire_in (>= active rows, O, S), wire_out (fwd_rows, O, S), src (O, R, Bp),
// out (n, O, Bp), tables (n, MAXB, L/8, 256). Node i writes wire_out row
// i + 1 when i + 1 < fwd_rows.
template <int L, int MAXB, int VEC>
__global__ void __launch_bounds__(kThreads)
    chain_tick_kernel(const uint32_t* __restrict__ wire_in,
                      uint32_t* __restrict__ wire_out,
                      const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ tables, const TickNodes nodes,
                      int O, int R, long long Bp, long long S, int t,
                      int fwd_rows) {
  constexpr int kWords = MAXB * kSlotWords<L>;
  __shared__ uint32_t s_tab[kWords];
  const int z = static_cast<int>(blockIdx.z);
  const int i = nodes.node[z];
  const int o = static_cast<int>(blockIdx.y);
  const int ch = t - i;
  const uint32_t* tab = tables + static_cast<size_t>(i) * kWords;  // node i's tables
  for (int e = threadIdx.x; e < kWords; e += kThreads) s_tab[e] = tab[e];
  __syncthreads();

  const size_t row = static_cast<size_t>(i) * O + o;
  const uint32_t* wi = wire_in + row * S;
  uint32_t* wo = i + 1 < fwd_rows ? wire_out + (row + O) * S : nullptr;
  uint32_t* dst = out + row * Bp + static_cast<size_t>(ch) * S;
  const uint32_t* blk[MAXB];
  bool has[MAXB];
#pragma unroll
  for (int s = 0; s < MAXB; ++s) {
    const int b = nodes.slot[z * MAXB + s];
    has[s] = b >= 0;  // uniform across the block
    blk[s] = src + (static_cast<size_t>(o) * R + (b < 0 ? 0 : b)) * Bp +
             static_cast<size_t>(ch) * S;
  }
  const long long steps = S / VEC;  // VEC divides S (checked by the launcher)
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       j < steps; j += stride) {
    // every load of the step is in flight before the first lookup
    uint32_t x[VEC];
    uint32_t d[MAXB][VEC];
    load_lanes<VEC>(wi + j * VEC, x);
#pragma unroll
    for (int s = 0; s < MAXB; ++s)
      if (has[s]) load_lanes<VEC>(blk[s] + j * VEC, d[s]);
    uint32_t c[VEC], xo[VEC];
#pragma unroll
    for (int r = 0; r < VEC; ++r) {
      uint32_t e[32 / L] = {};
#pragma unroll
      for (int s = 0; s < MAXB; ++s)
        if (has[s]) add_products<L>(s_tab + s * kSlotWords<L>, d[s][r], e);
      uint32_t kept, fwd;
      split_products<L>(e, kept, fwd);
      c[r] = x[r] ^ kept;
      xo[r] = x[r] ^ fwd;
    }
    store_lanes<VEC>(dst + j * VEC, c);
    if (wo) store_lanes<VEC>(wo + j * VEC, xo);
  }
}

// ---------------------------------------------------------------------------
// repair_tick
// ---------------------------------------------------------------------------

// Lane tiles per (node, object): beyond this the grid-stride loop takes over.
constexpr long long kMaxTiles = 1024;

template <int L>
struct Lsb;
template <>
struct Lsb<8> {
  static constexpr uint32_t value = 0x01010101u;
};
template <>
struct Lsb<16> {
  static constexpr uint32_t value = 0x00010001u;
};

// wire_in / wire_out (n, O, rows, S), local (n, O, Bp), out (O, rows, Bp),
// bp (n, rows, L). Node n - 1 writes `out` instead of the wire.
template <int L>
__global__ void __launch_bounds__(kThreads)
    repair_tick_kernel(const uint32_t* __restrict__ wire_in,
                       uint32_t* __restrict__ wire_out,
                       const uint32_t* __restrict__ local,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ bp, int n, int O, int rows,
                       long long Bp, long long S, int t, int num_chunks,
                       int node_lo) {
  extern __shared__ uint32_t s_bp[];  // (rows, L)
  const int i = node_lo + static_cast<int>(blockIdx.z);
  const int o = static_cast<int>(blockIdx.y);
  const int ch = t - i;
  for (int j = threadIdx.x; j < rows * L; j += blockDim.x)
    s_bp[j] = bp[static_cast<size_t>(i) * rows * L + j];
  __syncthreads();
  if (ch < 0 || ch >= num_chunks) return;  // whole block: no chunk this tick

  const uint32_t lsb = Lsb<L>::value;
  const size_t row = static_cast<size_t>(i) * O + o;
  const uint32_t* wi = wire_in + row * rows * S;
  const uint32_t* loc = local + row * Bp + static_cast<size_t>(ch) * S;
  uint32_t* dst;
  long long dst_stride;
  if (i == n - 1) {
    dst = out + static_cast<size_t>(o) * rows * Bp + static_cast<size_t>(ch) * S;
    dst_stride = Bp;
  } else {
    dst = wire_out + (row + O) * rows * S;  // row i + 1, same object
    dst_stride = S;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < S; j += stride) {
    const uint32_t v = loc[j];
    uint32_t m[L];
#pragma unroll
    for (int b = 0; b < L; ++b) m[b] = (v >> b) & lsb;  // shared by all rows
    for (int r = 0; r < rows; ++r) {
      uint32_t acc = wi[static_cast<size_t>(r) * S + j];
      const uint32_t* c = s_bp + r * L;
#pragma unroll
      for (int b = 0; b < L; ++b) acc ^= m[b] * c[b];
      dst[static_cast<size_t>(r) * dst_stride + j] = acc;
    }
  }
}

dim3 tick_grid(long long S, int O, int node_count) {
  long long tiles = (S + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(O),
              static_cast<unsigned>(node_count));
}

template <int L, int MAXB, int VEC>
int launch_chain_tick(const uint32_t* wi, uint32_t* wo, const uint32_t* src,
                      uint32_t* out, const uint32_t* tab, const TickNodes& nodes,
                      int O, int R, long long Bp, long long S, int t,
                      int node_count, int fwd_rows, cudaStream_t st) {
  const long long tile = static_cast<long long>(kThreads) * kTilesPerBlock;
  const long long tiles = (S / VEC + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(O),
                  static_cast<unsigned>(node_count));
  chain_tick_kernel<L, MAXB, VEC><<<grid, kThreads, 0, st>>>(
      wi, wo, src, out, tab, nodes, O, R, Bp, S, t, fwd_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int MAXB>
int dispatch_chain_tick(bool vec4, const uint32_t* wi, uint32_t* wo,
                        const uint32_t* src, uint32_t* out, const uint32_t* tab,
                        const TickNodes& nodes, int O, int R, long long Bp,
                        long long S, int t, int node_count, int fwd_rows,
                        cudaStream_t st) {
#define GF_CHAIN_ARGS wi, wo, src, out, tab, nodes, O, R, Bp, S, t, node_count, fwd_rows, st
  return vec4 ? launch_chain_tick<L, MAXB, 4>(GF_CHAIN_ARGS)
              : launch_chain_tick<L, MAXB, 1>(GF_CHAIN_ARGS);
#undef GF_CHAIN_ARGS
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous int32 tensors, except `slots`, the host (n, max_b) slot table;
// the caller has checked shapes and slot values. Each function launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gf_chain_tick(const void* wire_in, void* wire_out,
                             const void* src, void* out, const void* tables,
                             const int* slots, int l, int max_b, int O, int R, long long Bp, long long S, int t,
                             int node_lo, int node_count, int fwd_rows,
                             void* stream) {
  if (node_count < 1 || node_count > kMaxTickNodes || max_b < 1 || max_b > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the active nodes by falling block count (two-block nodes first), each
  // with its slots
  TickNodes tn;
  int z = 0;
  for (int blocks = max_b; blocks >= 0; --blocks) {
    for (int i = node_lo; i < node_lo + node_count; ++i) {
      int has = 0;
      for (int s = 0; s < max_b; ++s) has += slots[i * max_b + s] >= 0;
      if (has != blocks) continue;
      tn.node[z] = i;
      for (int s = 0; s < max_b; ++s) tn.slot[z * max_b + s] = slots[i * max_b + s];
      ++z;
    }
  }
  // 16-byte lanes when every row of the chunk starts on a 16-byte boundary
  const bool vec4 = S % 4 == 0 && Bp % 4 == 0 && aligned16(wire_in) &&
                    aligned16(wire_out) && aligned16(src) && aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const uint32_t*>(wire_in);
  auto wo = static_cast<uint32_t*>(wire_out);
  auto sr = static_cast<const uint32_t*>(src);
  auto ou = static_cast<uint32_t*>(out);
  auto tb = static_cast<const uint32_t*>(tables);
#define GF_CHAIN_ARGS vec4, wi, wo, sr, ou, tb, tn, O, R, Bp, S, t, node_count, fwd_rows, st
  if (l == 8 && max_b == 1) return dispatch_chain_tick<8, 1>(GF_CHAIN_ARGS);
  if (l == 8 && max_b == 2) return dispatch_chain_tick<8, 2>(GF_CHAIN_ARGS);
  if (l == 16 && max_b == 1) return dispatch_chain_tick<16, 1>(GF_CHAIN_ARGS);
  if (l == 16 && max_b == 2) return dispatch_chain_tick<16, 2>(GF_CHAIN_ARGS);
#undef GF_CHAIN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gf_repair_tick(const void* wire_in, void* wire_out,
                              const void* local, void* out, const void* bp,
                              int l, int n, int O, int rows, long long Bp,
                              long long S, int t, int num_chunks, int node_lo,
                              int node_count, void* stream) {
  const dim3 grid = tick_grid(S, O, node_count);
  const dim3 block(kThreads);
  const size_t smem = static_cast<size_t>(rows) * l * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const uint32_t*>(wire_in);
  auto wo = static_cast<uint32_t*>(wire_out);
  auto lo = static_cast<const uint32_t*>(local);
  auto ou = static_cast<uint32_t*>(out);
  auto b = static_cast<const uint32_t*>(bp);
  if (l == 8) {
    repair_tick_kernel<8><<<grid, block, smem, st>>>(
        wi, wo, lo, ou, b, n, O, rows, Bp, S, t, num_chunks, node_lo);
  } else if (l == 16) {
    repair_tick_kernel<16><<<grid, block, smem, st>>>(
        wi, wo, lo, ou, b, n, O, rows, Bp, S, t, num_chunks, node_lo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
