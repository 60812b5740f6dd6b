// Pipeline-tick kernels of the RapidRAID chain, for Hopper (sm_90a).
//
// Every kernel works on packed GF(2^l) words: one 32-bit lane holds 4 words
// of GF(2^8) or 2 of GF(2^16).
//
// A launch of a tick kernel is one tick of the pipeline over a (lane tile,
// window slot, active node) grid. The wire between neighbours is a buffer
// with one row per node and W window slots a row: node i reads row i of the
// incoming buffer and writes row i + 1 of the outgoing one (the host keeps
// row 0 zero, the head of the chain). The block (slot w, node i) works out which
// object b and which chunk ch it works from the tick t itself, so a tick
// needs no host-to-device copy:
// - lockstep (stagger 0): slot w is object w, every object at ch = t - i;
// - staggered (stagger s >= 1, the multi-object archival of paper §VI):
//   object b's chains start s ticks after object b - 1's, so node i works
//   chunk ch = t - i - b * s of object b; the objects active at (i, t) are
//   at most W = min(B_obj, (C - 1) / s + 1) consecutive ones, and object b
//   rides slot b % W, so no two active objects share a slot and sender and
//   receiver agree on it. A slot with no active object exits at once.
// The objects' inputs and outputs are read and written in place through
// the strides of their object and node (or row) axes, so a batch laid out
// object-major is never transposed.
//
// chain_tick replaces chain_step_kernel / _chain_step_body
// (src/repro/kernels/gf_encode/kernel.py), the encode tick (Eqs. 3-4) of a
// chain placed on devices or laid out over cards, whose wire crosses them
// (an unplaced encode is one encode_chain launch, below):
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
// - Any slot count: max_b of 1 and 2 (RapidRAID's placements) have their
//   own instances with the slot loop unrolled; a larger max_b takes an
//   instance that walks the node's slots at run time and stages their
//   tables in dynamic shared memory, all at once where they fit 48 KB and
//   one group after another where they do not. A launch takes at most
//   256 nodes and 512 slots (the slot table travels by value); the host
//   wrapper splits a larger tick into launches over node sub-ranges.
//
// repair_tick replaces repair_step_kernel / _repair_step_body (same file),
// the decode and repair tick: node i adds D[r, i] * shard_i to each of the
// `rows` partial sums it receives and forwards them to wire row i + 1, or,
// as the last node n - 1, writes them to chunk t - i of `out`. With
// last_forwards the last node forwards too (to wire row n): a launch over
// one position in the middle of a chain placed on the devices of a mesh,
// whose successor is another launch.
// Bound: memory. Per node and lane it reads its shard lane and `rows` sums
// and writes `rows` sums, (1 + 2 rows) * 4 bytes: 4.8-5.1 ms of HBM over
// the (16,11) GF(2^16) decode's 18 ticks. The bit-plane arithmetic of the
// TPU kernel, l masks and rows * l multiply-xors a lane (384 at rows = 11),
// would be about 2 ms of INT32 issue beside it, competing with the loads.
// Design:
// - Products from packed tables. Per (node, row pack, byte j) the host
//   builds a 256-entry table of the products of every byte value v by the
//   pack's coefficients, one 32-bit entry holding every row of the pack:
//   GF(2^16) packs two rows (D[2p] * (v << 8j) | D[2p+1] * (v << 8j) << 16),
//   GF(2^8) four (D[4p+r] * v << 8r). A lane costs 4 lookups per row pair
//   and two byte permutes (GF(2^16)), or 4 lookups per row quad and a 4 x 4
//   byte transpose in 8 permutes (GF(2^8)). The tables are built once per
//   survivor set or repair plan, from the bit-planes by linearity; nothing
//   is compiled per code or per survivor set.
// - Any rows. A block stages its node's tables in shared memory (1 KB a
//   row at GF(2^16), 256 B at GF(2^8)), all at once where they fit the
//   227 KB a block may opt in to, else in stages of whole row groups, one
//   after another, rereading the shard lane for each stage. Within a step
//   the rows go in groups of kGroupRows held in registers, unrolled.
// - Memory in flight: 16-byte lanes wherever the chunk's rows are 16-byte
//   aligned, and the shard load and every wire load of a group issued
//   before the first lookup.
// - The survivors' shards are read in place: node i's shard is row
//   shard_rows[i] of the callers' shards, laid out (R, B_obj, Bp) or, for
//   a batch, (B_obj, R, Bp), through the strides of the row and object
//   axes; the row table comes by value in the kernel's parameters.
// - Node 0 of a pipelined run reads wire row 0, which the pipeline never
//   writes: with head_zero the kernel starts node 0 from zero sums and
//   skips that read. Without it, row 0 is read like any other.
//
// repair_chain replaces the whole chain of repair_step_kernel ticks of an
// unplaced decode or repair (every chunk of every object, every position)
// with one launch. On one card every chain position shares one memory, so
// the partial sums need not cross HBM between positions: per lane tile they
// start at zero, take each position's products in chain order, in
// registers, and only the last position's sums are stored. Per lane it
// reads h shard lanes and writes `rows` sums, the result's own bytes: on the
// (16,11) GF(2^16) decode of a 704 MiB object 1.48 GB, 0.44 ms of HBM,
// against about 16 GB through the ticks' wires (PERF.md).
// Bound: shared memory. With the bytes gone, the lookups are what is left:
// 11 positions x 2^24 lanes x 24 byte lookups, 4.4e9, for that decode. The
// ticks' 256-entry byte tables take about 3.5 wavefronts a warp's lookup
// (random bytes hit 8 entries of each bank), about 2 ms of the H100's
// shared-memory pipe. The design:
// - Nibble tables for a row group of several packs. A block stages 16-entry
//   tables per 4-bit nibble of a word, taken by linearity from the same
//   byte tables (entries v and v << 4 of byte m / 2's table for nibble m).
//   A table fills 16 banks once, so a warp's lookup is one wavefront: twice
//   the lookups at 1 wavefront each, against 3.5, and 8x less shared memory
//   (256 B a GF(2^16) row pack). The decode took 1.36-1.41 ms, against
//   1.86 ms with byte tables (PERF.md).
// - Byte tables for a group of one pack (a repair of one lost row): there a
//   nibble's index costs more issue than its conflicts save. Repair-16's
//   chain took 5.28-5.36 ms with byte tables, 6.17-6.29 ms with nibbles and
//   5.43 ms with the low byte's table and the high byte's nibbles (its HBM
//   floor is 3.85 ms); its fewer registers fit two blocks an SM.
// - Persistent blocks of 512 threads walk (object, lane tile) items. A
//   block stages every position's tables once where they fit 227 KB (the
//   decode's 16.5 KB), else, per item and row group, `group` positions at
//   a time: the sums stay in registers across those stages.
// - Rows in groups of kGroupRows held in registers, the shards reread once
//   a group, as in repair_tick.
// - The next position's shard lanes are loaded before the current one's
//   lookups, the next two positions' for a group of one pack: one depth
//   for every group cost the decode 3-6% and the one-pack repair 1-3%, two
//   for every group the decode 7% (PERF.md); 16-byte lanes where every row
//   is 16-byte aligned.
// - A launch takes 256 positions (its row table travels by value); a longer
//   chain is several launches, each after the first starting from the sums
//   the one before left in `out`.
//
// encode_chain replaces the whole chain of chain_step_kernel ticks of an
// unplaced encode (every chunk of every object, every node) with one
// launch, as repair_chain does for decode and repair. Per lane tile the
// running combination x starts at zero and walks the n nodes in chain
// order, in registers:
//     c_i = x ^ sum_s xi[i, s]  * block(i, s)    (stored once, row i of out)
//     x   = x ^ sum_s psi[i, s] * block(i, s)
// so no wire exists. Per lane it reads each block once and writes n
// codeword lanes: on the (16,11) GF(2^16) archival of 16 objects of 704 MiB
// 29 GB, 8.65 ms of HBM, against about 75 GB through the ticks' wires.
// Bound: memory, with the lookups and their issue close behind: 16 objects
// x 2^24 lanes x 22 slots x 8 nibble lookups, 47e9 (PERF.md). The design:
// - A plan made on the host from the slot table (kernel.encode_plan): each
//   node's terms, one a slot that holds a block, in chain order. Block j of
//   RapidRAID is held by nodes j and j + n - k; its first term keeps the
//   lanes it read in a lane cache in shared memory (each thread its own 16
//   bytes, so no barrier) and its second reads them there, so a block
//   crosses HBM once. Without the caches the second reads missed L2 (their
//   reuse distance is about 27 MB of traffic) and the chain moved 41 GB:
//   14.4 ms in nibbles, 13.6 ms in bytes. A node's cached reads come first,
//   so the (16,11) code keeps 5 caches (40 KB a block).
// - Nibble tables: 16-entry tables per 4-bit nibble, taken from the ticks'
//   combined xi | psi byte tables, so one lookup gives the kept and the
//   forwarded term and a warp's lookup is one wavefront. The nibbles come
//   out as bytes of two masked words, each a byte offset, so a lookup is
//   one byte permute and one load at a uniform base. The 256-entry byte
//   tables take half the lookups at about 3 wavefronts each; a build of
//   this kernel on them (tools/ab_encode_chain.py) was slower at the
//   benchmark's shape: 12.5-12.8 ms against 11.1-11.8 ms for
//   archival, 0.85-0.87 ms against 0.82-0.84 ms for one object (PERF.md).
// - Persistent blocks of 512 threads walk (object, lane tile) items, two a
//   multiprocessor (64 registers). A block stages every term's tables and
//   plan in shared memory once where they fit 227 KB beside the caches (the
//   (16,11) code's 22 terms take 6 KB), else `group` terms at a time for
//   each item, x and the node's products kept in registers across the
//   stages.
// - The next two terms' global lanes are loaded before a term's lookups:
//   three or four ahead, or a stream of loads running on into the next
//   item, were slower; 16-byte lanes where every row is 16-byte aligned,
//   else 4-byte lanes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTilesPerBlock = 2;      // grid-stride steps a block's staging serves
constexpr int kMaxTickNodes = 256;     // active nodes one launch takes
constexpr int kMaxTickSlots = 512;     // replica slots one chain_tick launch takes
constexpr int kStaticSmem = 48 * 1024;    // shared memory a block has without opting in
constexpr int kMaxSmem = 227 * 1024;      // what a block may opt in to on the H100

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (lane tiles, window slots, nodes): each block walks kTilesPerBlock steps
// of kThreads x VEC lanes
dim3 tick_grid(long long steps, int W, int node_count) {
  const long long tile = static_cast<long long>(kThreads) * kTilesPerBlock;
  return dim3(static_cast<unsigned>((steps + tile - 1) / tile), static_cast<unsigned>(W),
              static_cast<unsigned>(node_count));
}

// The object window: how a launch's blocks find their object and chunk.
struct Window {
  int W;         // slots (gridDim.y)
  int n_obj;     // objects in the batch
  int stagger;   // ticks between two objects' starts; 0: lockstep
  int C;         // chunks a stream
};

// ceil(a / s) for s > 0 and any a
__device__ __forceinline__ int ceil_div(int a, int s) {
  return a >= 0 ? (a + s - 1) / s : -((-a) / s);
}

// The object b that slot w of node i works at tick t, and its chunk ch;
// false where the slot holds no active object (uniform across the block).
__device__ __forceinline__ bool slot_object(const Window& win, int t, int i, int w,
                                            int& b, int& ch) {
  const int d = t - i;
  if (win.stagger == 0) {
    b = w;
    ch = d;
    return true;
  }
  // the first object not yet past its last chunk, then the one in slot w
  const int first = max(0, ceil_div(d - win.C + 1, win.stagger));
  b = first + ((w - first) % win.W + win.W) % win.W;
  ch = d - b * win.stagger;
  return b < win.n_obj && ch >= 0;
}

// ---------------------------------------------------------------------------
// chain_tick
// ---------------------------------------------------------------------------

// The launch's active nodes, two-block nodes first, and their replica
// slots: slot[z * max_b + s] is a block of src or -1. Passed by value.
struct TickNodes {
  int node[kMaxTickNodes];
  int slot[kMaxTickSlots];
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

// wire_in (>= active rows, W, S), wire_out (fwd_rows, W, S), src (B_obj, R,
// Bp), out: object b's row of node i at out + i * out_node + b * out_obj,
// tables (n, MAXB, L/8, 256). Node i writes wire_out row i + 1 when
// i + 1 < fwd_rows.
template <int L, int MAXB, int VEC>
__global__ void __launch_bounds__(kThreads)
    chain_tick_kernel(const uint32_t* __restrict__ wire_in,
                      uint32_t* __restrict__ wire_out,
                      const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ tables, const TickNodes nodes,
                      const Window win, int R, long long Bp, long long S,
                      long long out_node, long long out_obj, int t, int fwd_rows) {
  constexpr int kWords = MAXB * kSlotWords<L>;
  __shared__ uint32_t s_tab[kWords];
  const int z = static_cast<int>(blockIdx.z);
  const int i = nodes.node[z];
  const int w = static_cast<int>(blockIdx.y);
  int o, ch;
  if (!slot_object(win, t, i, w, o, ch)) return;  // an idle window slot
  const uint32_t* tab = tables + static_cast<size_t>(i) * kWords;  // node i's tables
  for (int e = threadIdx.x; e < kWords; e += kThreads) s_tab[e] = tab[e];
  __syncthreads();

  const size_t row = static_cast<size_t>(i) * win.W + w;
  const uint32_t* wi = wire_in + row * S;
  uint32_t* wo = i + 1 < fwd_rows ? wire_out + (row + win.W) * S : nullptr;
  uint32_t* dst = out + i * out_node + o * out_obj + static_cast<long long>(ch) * S;
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

// The same tick for any slot count max_b, given at run time: the node's
// slots are walked in turn, their tables staged `group` slots at a time in
// dynamic shared memory (all of them once, before the first step, where
// group >= max_b). Tables are (n, max_b, L/8, 256).
template <int L, int VEC>
__global__ void __launch_bounds__(kThreads)
    chain_tick_slots_kernel(const uint32_t* __restrict__ wire_in,
                            uint32_t* __restrict__ wire_out,
                            const uint32_t* __restrict__ src,
                            uint32_t* __restrict__ out,
                            const uint32_t* __restrict__ tables, const TickNodes nodes,
                            int max_b, int group, const Window win, int R, long long Bp,
                            long long S, long long out_node, long long out_obj, int t,
                            int fwd_rows) {
  extern __shared__ uint32_t s_tab[];  // `group` slots' tables
  const int z = static_cast<int>(blockIdx.z);
  const int i = nodes.node[z];
  const int w = static_cast<int>(blockIdx.y);
  int o, ch;
  if (!slot_object(win, t, i, w, o, ch)) return;  // an idle window slot
  const uint32_t* tab = tables + static_cast<size_t>(i) * max_b * kSlotWords<L>;
  const bool once = group >= max_b;
  if (once) {
    for (int e = threadIdx.x; e < max_b * kSlotWords<L>; e += kThreads) s_tab[e] = tab[e];
    __syncthreads();
  }
  const size_t row = static_cast<size_t>(i) * win.W + w;
  const uint32_t* wi = wire_in + row * S;
  uint32_t* wo = i + 1 < fwd_rows ? wire_out + (row + win.W) * S : nullptr;
  uint32_t* dst = out + i * out_node + o * out_obj + static_cast<long long>(ch) * S;
  const uint32_t* blocks = src + static_cast<size_t>(o) * R * Bp + static_cast<size_t>(ch) * S;
  const long long steps = S / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the whole block walks the same steps, so a group's staging may sit
  // inside the loop
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < steps;
       base += stride) {
    const long long j = base + threadIdx.x;
    const bool active = j < steps;
    uint32_t x[VEC] = {};
    if (active) load_lanes<VEC>(wi + j * VEC, x);
    uint32_t e[VEC][32 / L] = {};
    for (int g0 = 0; g0 < max_b; g0 += group) {
      const int g1 = min(g0 + group, max_b);
      if (!once) {
        __syncthreads();  // every thread is done with the previous group's tables
        for (int w = threadIdx.x; w < (g1 - g0) * kSlotWords<L>; w += kThreads)
          s_tab[w] = tab[static_cast<size_t>(g0) * kSlotWords<L> + w];
        __syncthreads();
      }
      for (int s = g0; s < g1; ++s) {
        const int b = nodes.slot[z * max_b + s];
        if (b < 0 || !active) continue;
        uint32_t d[VEC];
        load_lanes<VEC>(blocks + static_cast<size_t>(b) * Bp + j * VEC, d);
#pragma unroll
        for (int r = 0; r < VEC; ++r)
          add_products<L>(s_tab + (s - g0) * kSlotWords<L>, d[r], e[r]);
      }
    }
    if (!active) continue;
    uint32_t c[VEC], xo[VEC];
#pragma unroll
    for (int r = 0; r < VEC; ++r) {
      uint32_t kept, fwd;
      split_products<L>(e[r], kept, fwd);
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

// rows whose products one table entry packs: two 16-bit or four 8-bit words
template <int L>
constexpr int kPackRows = 32 / L;
// words of one row pack's tables: a 256-entry table per byte of a word
template <int L>
constexpr int kPackWords = L / 8 * 256;
// rows a step carries in registers, unrolled: the (16,11) decode's 11
// rows in one group
constexpr int kGroupRows = 12;
template <int L>
constexpr int kGroupPacks = kGroupRows / kPackRows<L>;

// The shard row of each node of the launch (node_lo + z). Passed by value.
struct RepairNodes {
  int shard[kMaxTickNodes];
};

// acc[r][w] ^= the products of lane v[w] with row r of the group, from the
// byte tables of the group's first `packs` row packs (at most G).
template <int L, int VEC, int G = kGroupPacks<L>>
__device__ __forceinline__ void add_row_products(const uint32_t* s_grp, int packs,
                                                 const uint32_t (&v)[VEC],
                                                 uint32_t (&acc)[G * kPackRows<L>][VEC]) {
#pragma unroll
  for (int w = 0; w < VEC; ++w) {
    const uint32_t x = v[w];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q >= packs) break;
      const uint32_t* T = s_grp + q * kPackWords<L>;
      if constexpr (L == 16) {
        // e0 / e1: (row 2q, row 2q + 1) products of word 0 / word 1
        const uint32_t e0 = T[x & 255u] ^ T[256 + ((x >> 8) & 255u)];
        const uint32_t e1 = T[(x >> 16) & 255u] ^ T[256 + (x >> 24)];
        acc[2 * q][w] ^= __byte_perm(e0, e1, 0x5410);
        acc[2 * q + 1][w] ^= __byte_perm(e0, e1, 0x7632);
      } else {
        // e_m: byte r is row 4q + r's product of word m; transpose the bytes
        const uint32_t e0 = T[x & 255u], e1 = T[(x >> 8) & 255u];
        const uint32_t e2 = T[(x >> 16) & 255u], e3 = T[x >> 24];
        const uint32_t a = __byte_perm(e0, e1, 0x5140), b = __byte_perm(e0, e1, 0x7362);
        const uint32_t c = __byte_perm(e2, e3, 0x5140), d = __byte_perm(e2, e3, 0x7362);
        acc[4 * q][w] ^= __byte_perm(a, c, 0x5410);
        acc[4 * q + 1][w] ^= __byte_perm(a, c, 0x7632);
        acc[4 * q + 2][w] ^= __byte_perm(b, d, 0x5410);
        acc[4 * q + 3][w] ^= __byte_perm(b, d, 0x7632);
      }
    }
  }
}

// wire_in / wire_out (n, W, rows, S), shards: object b's shard row r at
// shards + r * shard_row + b * shard_obj, out (B_obj, rows, Bp), tables
// (n, packs, L/8, 256). Node n - 1 writes `out` instead of the wire,
// unless last_forwards (wire_out then has n + 1 rows). The tables are staged
// `stage` packs at a time (a multiple of kGroupPacks, or all of them).
template <int L, int VEC>
__global__ void __launch_bounds__(kThreads)
    repair_tick_kernel(const uint32_t* __restrict__ wire_in,
                       uint32_t* __restrict__ wire_out,
                       const uint32_t* __restrict__ shards,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ tables, const RepairNodes nodes,
                       const Window win, int n, int rows, int stage, long long Bp,
                       long long S, long long shard_row, long long shard_obj, int t,
                       int node_lo, int head_zero, int last_forwards) {
  extern __shared__ uint32_t s_tab[];  // `stage` packs' tables
  constexpr int P = kPackRows<L>;
  const int z = static_cast<int>(blockIdx.z);
  const int i = node_lo + z;
  const int w = static_cast<int>(blockIdx.y);
  int o, ch;
  if (!slot_object(win, t, i, w, o, ch)) return;  // an idle window slot
  const int packs = (rows + P - 1) / P;
  const uint32_t* tab = tables + static_cast<size_t>(i) * packs * kPackWords<L>;
  const uint32_t* loc = shards + nodes.shard[z] * shard_row + o * shard_obj +
                        static_cast<long long>(ch) * S;
  const bool read_in = !(head_zero && i == 0);  // uniform across the block
  const uint32_t* wi = wire_in + (static_cast<size_t>(i) * win.W + w) * rows * S;
  uint32_t* dst;
  long long dst_stride;
  if (i == n - 1 && !last_forwards) {
    dst = out + static_cast<size_t>(o) * rows * Bp + static_cast<size_t>(ch) * S;
    dst_stride = Bp;
  } else {
    dst = wire_out + (static_cast<size_t>(i + 1) * win.W + w) * rows * S;
    dst_stride = S;
  }
  const long long steps = S / VEC;  // VEC divides S (checked by the launcher)
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int p0 = 0; p0 < packs; p0 += stage) {
    const int np = min(stage, packs - p0);
    if (p0) __syncthreads();  // every thread is done with the previous stage
    for (int e = threadIdx.x; e < np * kPackWords<L>; e += kThreads)
      s_tab[e] = tab[static_cast<size_t>(p0) * kPackWords<L> + e];
    __syncthreads();
    for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         j < steps; j += stride) {
      uint32_t v[VEC];
      load_lanes<VEC>(loc + j * VEC, v);
      for (int g = 0; g < np; g += kGroupPacks<L>) {
        const int gp = min(kGroupPacks<L>, np - g);
        const int r0 = (p0 + g) * P;           // the group's first row
        const int nr = min(gp * P, rows - r0);  // and its row count
        // the shard load and every wire load of the group before the lookups
        uint32_t acc[kGroupRows][VEC];
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          if (r < nr && read_in) {
            load_lanes<VEC>(wi + (r0 + r) * S + j * VEC, acc[r]);
          } else {
#pragma unroll
            for (int w = 0; w < VEC; ++w) acc[r][w] = 0;
          }
        }
        add_row_products<L, VEC>(s_tab + g * kPackWords<L>, gp, v, acc);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r)
          if (r < nr) store_lanes<VEC>(dst + (r0 + r) * dst_stride + j * VEC, acc[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// repair_chain
// ---------------------------------------------------------------------------

constexpr int kChainThreads = 512;
constexpr int kMaxChainNodes = 256;   // positions one launch takes

// The shard row of each position of the launch. Passed by value.
struct ChainRows {
  int shard[kMaxChainNodes];
};

// words of one row pack's nibble tables: 16 entries for each nibble of a word
template <int L>
constexpr int kNibbleWords = L / 4 * 16;

// Tables a row group of G packs looks its products up in: 16-entry nibble
// tables where it has several packs, the 256-entry byte tables for one
template <int G>
constexpr bool kNibbles = G > 1;
template <int L, int G>
constexpr int kChainPackWords = kNibbles<G> ? kNibbleWords<L> : kPackWords<L>;
// positions whose shard lanes a thread has in flight ahead of its lookups
template <int G>
constexpr int kAhead = G == 1 ? 2 : 1;

// Stages the tables of positions [p0, p1) and row packs [q0, q0 + np) into
// s, laid out (p - p0, q - q0, kChainPackWords), from the byte tables (h,
// packs, L/8, 256). Nibble tables: nibble m of a word is the low or the
// high half of byte m / 2, so its entry v is that byte's entry v or v << 4.
template <int L, int G>
__device__ __forceinline__ void stage_chain_tables(uint32_t* s, const uint32_t* tables,
                                                   int packs, int p0, int p1, int q0, int np) {
  constexpr int NW = kChainPackWords<L, G>;
  const int per = np * NW;
  for (int e = threadIdx.x; e < (p1 - p0) * per; e += kChainThreads) {
    const int p = p0 + e / per, r = e % per;
    const uint32_t* pack = tables + (static_cast<size_t>(p) * packs + q0 + r / NW) * kPackWords<L>;
    if constexpr (kNibbles<G>) {
      const int m = r % NW / 16, v = r % 16;
      s[e] = pack[(m >> 1) * 256 + (v << (4 * (m & 1)))];
    } else {
      s[e] = pack[r % NW];
    }
  }
}

// acc[r][w] ^= the products of lane v[w] with row r of the group, from the
// nibble tables of the group's first `packs` row packs (at most G).
template <int L, int VEC, int G>
__device__ __forceinline__ void add_row_nibbles(const uint32_t* s_grp, int packs,
                                                const uint32_t (&v)[VEC],
                                                uint32_t (&acc)[G * kPackRows<L>][VEC]) {
  constexpr int NW = kNibbleWords<L>;
#pragma unroll
  for (int w = 0; w < VEC; ++w) {
    // nibble k of the lane indexes table k % (L / 4) of every pack
    int at[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) at[k] = (k % (L / 4)) * 16 + ((v[w] >> (4 * k)) & 15u);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q >= packs) break;
      const uint32_t* T = s_grp + q * NW;
      if constexpr (L == 16) {
        // e0 / e1: (row 2q, row 2q + 1) products of word 0 / word 1
        const uint32_t e0 = T[at[0]] ^ T[at[1]] ^ T[at[2]] ^ T[at[3]];
        const uint32_t e1 = T[at[4]] ^ T[at[5]] ^ T[at[6]] ^ T[at[7]];
        acc[2 * q][w] ^= __byte_perm(e0, e1, 0x5410);
        acc[2 * q + 1][w] ^= __byte_perm(e0, e1, 0x7632);
      } else {
        // e_m: byte r is row 4q + r's product of word m; transpose the bytes
        const uint32_t e0 = T[at[0]] ^ T[at[1]], e1 = T[at[2]] ^ T[at[3]];
        const uint32_t e2 = T[at[4]] ^ T[at[5]], e3 = T[at[6]] ^ T[at[7]];
        const uint32_t a = __byte_perm(e0, e1, 0x5140), b = __byte_perm(e0, e1, 0x7362);
        const uint32_t c = __byte_perm(e2, e3, 0x5140), d = __byte_perm(e2, e3, 0x7362);
        acc[4 * q][w] ^= __byte_perm(a, c, 0x5410);
        acc[4 * q + 1][w] ^= __byte_perm(a, c, 0x7632);
        acc[4 * q + 2][w] ^= __byte_perm(b, d, 0x5410);
        acc[4 * q + 3][w] ^= __byte_perm(b, d, 0x7632);
      }
    }
  }
}

// shards: object b's shard row r at shards + r * shard_row + b * shard_obj,
// out (n_obj, rows, Bp), tables (h, packs, L/8, 256) of the launch's h
// positions, position p reading shard row pos.shard[p]. Each block walks
// (object, lane tile) items; per item and row group of G packs the sums
// start at zero (with from_out: at out's), take every position's products
// in chain order and are stored to out. With `whole` every table is staged
// once; else `group` positions of one row group at a time, for each item.
// A group of several packs looks its products up in nibble tables, a group
// of one (a single lost row) in the byte tables.
template <int L, int VEC, int G>
__global__ void __launch_bounds__(kChainThreads, G == 1 ? 2 : 1)
    repair_chain_kernel(const uint32_t* __restrict__ shards, uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tables, const ChainRows pos, int h,
                        int rows, int n_obj, int whole, int group, long long Bp,
                        long long shard_row, long long shard_obj, int from_out) {
  extern __shared__ uint32_t s_tab[];
  constexpr int P = kPackRows<L>;
  constexpr int NW = kChainPackWords<L, G>;
  constexpr int GR = G * P;
  const int packs = (rows + P - 1) / P;
  const long long steps = Bp / VEC;  // VEC divides Bp (checked by the launcher)
  const long long tiles = (steps + kChainThreads - 1) / kChainThreads;
  if (whole) {
    stage_chain_tables<L, G>(s_tab, tables, packs, 0, h, 0, packs);
    __syncthreads();
  }
  // every thread of a block walks the same items, so a stage may sit inside
  for (long long it = blockIdx.x; it < tiles * n_obj; it += gridDim.x) {
    const int o = static_cast<int>(it / tiles);
    const long long j = (it % tiles) * kChainThreads + threadIdx.x;
    const bool active = j < steps;
    const uint32_t* src = shards + o * shard_obj + j * VEC;
    uint32_t* dst = out + static_cast<size_t>(o) * rows * Bp + j * VEC;
    for (int q0 = 0; q0 < packs; q0 += G) {
      const int gp = min(G, packs - q0);
      const int r0 = q0 * P, nr = min(GR, rows - r0);  // the group's first row, its rows
      uint32_t acc[GR][VEC];
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        if (from_out && active && r < nr) {
          load_lanes<VEC>(dst + (r0 + r) * Bp, acc[r]);
        } else {
#pragma unroll
          for (int w = 0; w < VEC; ++w) acc[r][w] = 0;
        }
      }
      for (int p0 = 0; p0 < h; p0 += group) {
        const int p1 = min(h, p0 + group);
        const uint32_t* s_grp = s_tab + q0 * NW;  // position p's at s_grp + (p - p0) * stride
        int stride = packs * NW;
        if (!whole) {
          __syncthreads();  // every thread is done with the previous stage
          stage_chain_tables<L, G>(s_tab, tables, packs, p0, p1, q0, gp);
          __syncthreads();
          s_grp = s_tab;
          stride = gp * NW;
        }
        // the next kAhead positions' lanes in flight before a position's lookups
        constexpr int A = kAhead<G>;
        uint32_t ahead[A][VEC] = {};
#pragma unroll
        for (int a = 0; a < A; ++a)
          if (active && p0 + a < p1) load_lanes<VEC>(src + pos.shard[p0 + a] * shard_row, ahead[a]);
        for (int p = p0; p < p1; ++p) {
          uint32_t v[VEC];
#pragma unroll
          for (int w = 0; w < VEC; ++w) v[w] = ahead[0][w];
#pragma unroll
          for (int a = 0; a + 1 < A; ++a)
#pragma unroll
            for (int w = 0; w < VEC; ++w) ahead[a][w] = ahead[a + 1][w];
          if (active && p + A < p1)
            load_lanes<VEC>(src + pos.shard[p + A] * shard_row, ahead[A - 1]);
          if constexpr (kNibbles<G>)
            add_row_nibbles<L, VEC, G>(s_grp + (p - p0) * stride, gp, v, acc);
          else
            add_row_products<L, VEC, G>(s_grp + (p - p0) * stride, gp, v, acc);
        }
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < GR; ++r)
          if (r < nr) store_lanes<VEC>(dst + (r0 + r) * Bp, acc[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// encode_chain
// ---------------------------------------------------------------------------

// terms whose block lanes a thread has in flight ahead of its lookups
constexpr int kEncodeAhead = 2;
// A term of the plan: the slot whose tables it applies (its flat index
// into the (n, max_b) tables; -1: none, a node that holds no block), the
// block it reads (-1: none), the lane cache it reads the block from (-1:
// global memory), the one it keeps the block's lanes in for a later term
// (-1: none), and whether it is its node's last term.
enum Plan { kTable, kBlock, kFrom, kTo, kLast, kPlanInts };
constexpr int kMaxEncodeCaches = 8;   // lane caches a block may keep

// Stages terms [t0, t1) of the plan into s: each term's nibble tables, laid
// out (t - t0, kNibbleWords), from the byte tables (n, max_b, L/8, 256)
// (nibble m of a word is the low or the high half of byte m / 2, so its
// entry v is that byte's entry v or v << 4), then the terms' plans.
template <int L>
__device__ __forceinline__ void stage_encode_terms(uint32_t* s, const uint32_t* tables,
                                                   const int* plan, int t0, int t1) {
  constexpr int NW = kNibbleWords<L>;
  const int per = (t1 - t0) * NW;
  for (int e = threadIdx.x; e < per; e += kChainThreads) {
    const int q = plan[(t0 + e / NW) * kPlanInts + kTable], r = e % NW;
    const uint32_t* slot = tables + static_cast<size_t>(q < 0 ? 0 : q) * kSlotWords<L>;
    s[e] = q < 0 ? 0 : slot[(r / 32) * 256 + ((r % 16) << (4 * (r / 16 % 2)))];
  }
  int* staged = reinterpret_cast<int*>(s + per);
  for (int e = threadIdx.x; e < (t1 - t0) * kPlanInts; e += kChainThreads)
    staged[e] = plan[t0 * kPlanInts + e];
}

// e[w] ^= the packed (xi, psi) products of word w of lane v, from one
// term's nibble tables: nibble k of the lane indexes table k % (L / 4). The
// nibbles come out four times over as bytes of two words, each byte a
// table's byte offset, so a lookup costs one byte permute.
template <int L>
__device__ __forceinline__ void add_nibble_products(const uint32_t* T, uint32_t v,
                                                    uint32_t (&e)[32 / L]) {
  const uint32_t lo = (v << 2) & 0x3c3c3c3cu;  // byte m: 4 x nibble 2m
  const uint32_t hi = (v >> 2) & 0x3c3c3c3cu;  // byte m: 4 x nibble 2m + 1
  const char* base = reinterpret_cast<const char*>(T);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    constexpr int P = L / 4;  // nibble tables a word
    const uint32_t a = __byte_perm(lo, 0, 0x4440 + m), b = __byte_perm(hi, 0, 0x4440 + m);
    e[2 * m / P] ^= *reinterpret_cast<const uint32_t*>(base + (2 * m % P) * 64 + a);
    e[(2 * m + 1) / P] ^= *reinterpret_cast<const uint32_t*>(base + ((2 * m + 1) % P) * 64 + b);
  }
}

// src (n_obj, R, Bp) contiguous, object o's block b at src + (o * R + b) *
// Bp; out: node i's row of object o at out + i * out_node + o * out_obj;
// tables (n, max_b, L/8, 256); plan (terms, kPlanInts) on the device, the
// nodes' terms in chain order. Each block walks (object, lane tile) items;
// per item x starts at zero and takes the terms in order, each adding its
// packed (xi, psi) products, and at a node's last term the node stores x ^
// kept as its row and x takes the forwarded half. A term reads its block's
// lanes from global memory or from one of `caches` lane caches in shared
// memory (each thread its own lanes), where an earlier term kept them. With
// `whole` every term is staged once; else `group` terms at a time, for
// each item.
template <int L, int VEC>
__global__ void __launch_bounds__(kChainThreads, 2)
    encode_chain_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tables, const int* __restrict__ plan,
                        int terms, int n_obj, int R, int caches, int whole, int group,
                        long long Bp, long long out_node, long long out_obj) {
  extern __shared__ uint32_t s_mem[];
  constexpr int NW = kNibbleWords<L>;
  constexpr int A = kEncodeAhead;
  constexpr int kCacheWords = kChainThreads * VEC;
  uint32_t* lanes = s_mem + threadIdx.x * VEC;     // this thread's lanes of cache 0
  uint32_t* s_tab = s_mem + caches * kCacheWords;  // the staged tables, then the plans
  const long long steps = Bp / VEC;  // VEC divides Bp (checked by the launcher)
  const long long tiles = (steps + kChainThreads - 1) / kChainThreads;
  if (whole) {
    stage_encode_terms<L>(s_tab, tables, plan, 0, terms);
    __syncthreads();
  }
  // every thread of a block walks the same items, so a stage may sit inside
  for (long long it = blockIdx.x; it < tiles * n_obj; it += gridDim.x) {
    const int o = static_cast<int>(it / tiles);
    const long long j = (it % tiles) * kChainThreads + threadIdx.x;
    const bool active = j < steps;
    const uint32_t* blocks = src + static_cast<size_t>(o) * R * Bp + j * VEC;
    uint32_t* row = out + o * out_obj + j * VEC;  // the current node's row
    uint32_t x[VEC] = {};
    uint32_t e[VEC][32 / L] = {};
    for (int t0 = 0; t0 < terms; t0 += group) {
      const int t1 = min(terms, t0 + group);
      if (!whole) {
        __syncthreads();  // every thread is done with the previous stage
        stage_encode_terms<L>(s_tab, tables, plan, t0, t1);
        __syncthreads();
      }
      // term t's plan at pl + (t - t0) * kPlanInts, uniform across the block
      const int* pl = reinterpret_cast<const int*>(s_tab + (t1 - t0) * NW);
      // the next A terms' global lanes in flight before a term's lookups
      uint32_t ahead[A][VEC] = {};
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int* p = pl + a * kPlanInts;
        if (active && t0 + a < t1 && p[kBlock] >= 0 && p[kFrom] < 0)
          load_lanes<VEC>(blocks + p[kBlock] * Bp, ahead[a]);
      }
      for (int t = t0; t < t1; ++t) {
        const int* p = pl + (t - t0) * kPlanInts;
        uint32_t v[VEC];
        if (p[kFrom] >= 0) {
          load_lanes<VEC>(lanes + p[kFrom] * kCacheWords, v);
        } else {
#pragma unroll
          for (int w = 0; w < VEC; ++w) v[w] = ahead[0][w];
        }
#pragma unroll
        for (int a = 0; a + 1 < A; ++a)
#pragma unroll
          for (int w = 0; w < VEC; ++w) ahead[a][w] = ahead[a + 1][w];
        const int* pa = p + A * kPlanInts;
        if (active && t + A < t1 && pa[kBlock] >= 0 && pa[kFrom] < 0)
          load_lanes<VEC>(blocks + pa[kBlock] * Bp, ahead[A - 1]);
        if (p[kBlock] >= 0) {
          if (p[kTo] >= 0) store_lanes<VEC>(lanes + p[kTo] * kCacheWords, v);
          const uint32_t* T = s_tab + (t - t0) * NW;
#pragma unroll
          for (int r = 0; r < VEC; ++r) add_nibble_products<L>(T, v[r], e[r]);
        }
        if (!p[kLast]) continue;
        // the node's last term: its row, then x moves on
        uint32_t c[VEC];
#pragma unroll
        for (int r = 0; r < VEC; ++r) {
          uint32_t kept, fwd;
          split_products<L>(e[r], kept, fwd);
          c[r] = x[r] ^ kept;
          x[r] ^= fwd;
#pragma unroll
          for (int w = 0; w < 32 / L; ++w) e[r][w] = 0;
        }
        if (active) store_lanes<VEC>(row, c);
        row += out_node;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int L, int MAXB, int VEC>
int launch_chain_tick(const uint32_t* wi, uint32_t* wo, const uint32_t* src,
                      uint32_t* out, const uint32_t* tab, const TickNodes& nodes,
                      int max_b, const Window& win, int R, long long Bp, long long S,
                      long long out_node, long long out_obj, int t, int node_count,
                      int fwd_rows, cudaStream_t st) {
  const dim3 grid = tick_grid(S / VEC, win.W, node_count);
  if constexpr (MAXB > 0) {
    chain_tick_kernel<L, MAXB, VEC><<<grid, kThreads, 0, st>>>(
        wi, wo, src, out, tab, nodes, win, R, Bp, S, out_node, out_obj, t, fwd_rows);
  } else {
    // stage every slot where they fit 48 KB, else the most that do, in turn
    constexpr int slot_bytes = kSlotWords<L> * 4;
    const int group = max_b * slot_bytes <= kStaticSmem ? max_b : kStaticSmem / slot_bytes;
    chain_tick_slots_kernel<L, VEC><<<grid, kThreads, group * slot_bytes, st>>>(
        wi, wo, src, out, tab, nodes, max_b, group, win, R, Bp, S, out_node, out_obj, t,
        fwd_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int L, int MAXB>
int dispatch_chain_tick(bool vec4, const uint32_t* wi, uint32_t* wo,
                        const uint32_t* src, uint32_t* out, const uint32_t* tab,
                        const TickNodes& nodes, int max_b, const Window& win, int R,
                        long long Bp, long long S, long long out_node, long long out_obj,
                        int t, int node_count, int fwd_rows, cudaStream_t st) {
#define GF_CHAIN_ARGS wi, wo, src, out, tab, nodes, max_b, win, R, Bp, S, out_node, out_obj, \
                      t, node_count, fwd_rows, st
  return vec4 ? launch_chain_tick<L, MAXB, 4>(GF_CHAIN_ARGS)
              : launch_chain_tick<L, MAXB, 1>(GF_CHAIN_ARGS);
#undef GF_CHAIN_ARGS
}

template <int L, int VEC>
int launch_repair_tick(const uint32_t* wi, uint32_t* wo, const uint32_t* shards,
                       uint32_t* out, const uint32_t* tab, const RepairNodes& nodes,
                       const Window& win, int n, int rows, long long Bp, long long S,
                       long long shard_row, long long shard_obj, int t, int node_lo,
                       int node_count, int head_zero, int last_forwards, cudaStream_t st) {
  constexpr int pack_bytes = kPackWords<L> * 4;
  const int packs = (rows + kPackRows<L> - 1) / kPackRows<L>;
  // every pack's tables at once where they fit a block, else stages of
  // whole row groups
  int stage = packs;
  if (static_cast<long long>(packs) * pack_bytes > kMaxSmem)
    stage = kMaxSmem / pack_bytes / kGroupPacks<L> * kGroupPacks<L>;
  const int smem = stage * pack_bytes;
  if (smem > kStaticSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        repair_tick_kernel<L, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid = tick_grid(S / VEC, win.W, node_count);
  repair_tick_kernel<L, VEC><<<grid, kThreads, smem, st>>>(
      wi, wo, shards, out, tab, nodes, win, n, rows, stage, Bp, S, shard_row, shard_obj, t,
      node_lo, head_zero, last_forwards);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int VEC, int G>
int launch_repair_chain(const uint32_t* shards, uint32_t* out, const uint32_t* tab,
                        const ChainRows& pos, int h, int rows, int n_obj, long long Bp,
                        long long shard_row, long long shard_obj, int from_out,
                        cudaStream_t st) {
  constexpr int table_bytes = kChainPackWords<L, G> * 4;  // a row pack's, per position
  const int packs = (rows + kPackRows<L> - 1) / kPackRows<L>;
  // every table at once where they fit a block, else `group` positions of
  // one row group at a time
  const long long all = static_cast<long long>(h) * packs * table_bytes;
  const bool whole = all <= kMaxSmem;
  const int group_bytes = min(G, packs) * table_bytes;
  const int group = whole ? h : kMaxSmem / group_bytes;
  const int smem = whole ? static_cast<int>(all) : group * group_bytes;
  auto fn = repair_chain_kernel<L, VEC, G>;
  cudaError_t rc = cudaSuccess;
  if (smem > kStaticSmem)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // persistent blocks: as many as the SMs hold at once, at most one an item
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kChainThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long items = (Bp / VEC + kChainThreads - 1) / kChainThreads * n_obj;
  const long long blocks = static_cast<long long>(max(per_sm, 1)) * sms;
  fn<<<static_cast<unsigned>(min(items, blocks)), kChainThreads, smem, st>>>(
      shards, out, tab, pos, h, rows, n_obj, whole, group, Bp, shard_row, shard_obj, from_out);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int VEC>
int dispatch_repair_chain(const uint32_t* shards, uint32_t* out, const uint32_t* tab,
                          const ChainRows& pos, int h, int rows, int n_obj, long long Bp,
                          long long shard_row, long long shard_obj, int from_out,
                          cudaStream_t st) {
#define GF_RCHAIN_ARGS shards, out, tab, pos, h, rows, n_obj, Bp, shard_row, shard_obj, from_out, st
  // one row pack (a repair of one lost row): one pack of accumulators
  return rows <= kPackRows<L> ? launch_repair_chain<L, VEC, 1>(GF_RCHAIN_ARGS)
                              : launch_repair_chain<L, VEC, kGroupPacks<L>>(GF_RCHAIN_ARGS);
#undef GF_RCHAIN_ARGS
}

template <int L, int VEC>
int launch_encode_chain(const uint32_t* src, uint32_t* out, const uint32_t* tab,
                        const int* plan, int terms, int n_obj, int R, int caches, long long Bp,
                        long long out_node, long long out_obj, cudaStream_t st) {
  constexpr int term_bytes = (kNibbleWords<L> + kPlanInts) * 4;  // a term's tables and plan
  const int cache_bytes = caches * kChainThreads * VEC * 4;
  // every term at once where they fit a block beside the caches, else
  // `group` terms at a time
  const long long all = static_cast<long long>(terms) * term_bytes;
  const bool whole = cache_bytes + all <= kMaxSmem;
  const int group = whole ? terms : (kMaxSmem - cache_bytes) / term_bytes;
  const int smem = cache_bytes + group * term_bytes;
  auto fn = encode_chain_kernel<L, VEC>;
  cudaError_t rc = cudaSuccess;
  if (smem > kStaticSmem)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // persistent blocks: as many as the SMs hold at once, at most one an item
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kChainThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long items = (Bp / VEC + kChainThreads - 1) / kChainThreads * n_obj;
  const long long blocks = static_cast<long long>(max(per_sm, 1)) * sms;
  fn<<<static_cast<unsigned>(min(items, blocks)), kChainThreads, smem, st>>>(
      src, out, tab, plan, terms, n_obj, R, caches, whole, group, Bp, out_node, out_obj);
  return static_cast<int>(cudaGetLastError());
}

bool bad_window(const Window& win) {
  return win.W < 1 || win.n_obj < 1 || win.stagger < 0 || win.C < 1 ||
         (win.stagger == 0 && win.W != win.n_obj);
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// int32 tensors, contiguous except that `out` of gf_chain_tick and
// `shards` of gf_repair_tick are laid out by the strides given (in lanes;
// their rows are contiguous); `slots` and `shard_rows` are host tables.
// The window is (W slots, n_obj objects, stagger, C chunks), stagger 0
// being lockstep (W == n_obj). The caller has checked shapes, strides and
// table values. gf_repair_tick's `out` may be null with last_forwards, which
// writes no output. Each function launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gf_chain_tick(const void* wire_in, void* wire_out,
                             const void* src, void* out, const void* tables,
                             const int* slots, int l, int max_b, int W, int n_obj,
                             int stagger, int C, int R, long long Bp, long long S,
                             long long out_node, long long out_obj, int t, int node_lo,
                             int node_count, int fwd_rows, void* stream) {
  const Window win{W, n_obj, stagger, C};
  if (node_count < 1 || node_count > kMaxTickNodes || max_b < 1 ||
      node_count * max_b > kMaxTickSlots || bad_window(win))
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
  const bool vec4 = S % 4 == 0 && Bp % 4 == 0 && out_node % 4 == 0 && out_obj % 4 == 0 &&
                    aligned16(wire_in) && aligned16(wire_out) && aligned16(src) &&
                    aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const uint32_t*>(wire_in);
  auto wo = static_cast<uint32_t*>(wire_out);
  auto sr = static_cast<const uint32_t*>(src);
  auto ou = static_cast<uint32_t*>(out);
  auto tb = static_cast<const uint32_t*>(tables);
#define GF_CHAIN_ARGS vec4, wi, wo, sr, ou, tb, tn, max_b, win, R, Bp, S, out_node, out_obj, \
                      t, node_count, fwd_rows, st
  if (l == 8 && max_b == 1) return dispatch_chain_tick<8, 1>(GF_CHAIN_ARGS);
  if (l == 8 && max_b == 2) return dispatch_chain_tick<8, 2>(GF_CHAIN_ARGS);
  if (l == 8) return dispatch_chain_tick<8, 0>(GF_CHAIN_ARGS);  // any max_b
  if (l == 16 && max_b == 1) return dispatch_chain_tick<16, 1>(GF_CHAIN_ARGS);
  if (l == 16 && max_b == 2) return dispatch_chain_tick<16, 2>(GF_CHAIN_ARGS);
  if (l == 16) return dispatch_chain_tick<16, 0>(GF_CHAIN_ARGS);
#undef GF_CHAIN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gf_repair_tick(const void* wire_in, void* wire_out,
                              const void* shards, void* out, const void* tables,
                              const int* shard_rows, int l, int n, int W, int n_obj,
                              int stagger, int C, int rows, long long Bp, long long S,
                              long long shard_row, long long shard_obj, int t, int node_lo,
                              int node_count, int head_zero, int last_forwards,
                              void* stream) {
  const Window win{W, n_obj, stagger, C};
  if (node_count < 1 || node_count > kMaxTickNodes || rows < 1 || bad_window(win))
    return static_cast<int>(cudaErrorInvalidValue);
  RepairNodes rn;
  for (int z = 0; z < node_count; ++z) rn.shard[z] = shard_rows[node_lo + z];
  const bool vec4 = S % 4 == 0 && Bp % 4 == 0 && shard_row % 4 == 0 && shard_obj % 4 == 0 &&
                    aligned16(wire_in) && aligned16(wire_out) && aligned16(shards) &&
                    aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const uint32_t*>(wire_in);
  auto wo = static_cast<uint32_t*>(wire_out);
  auto sh = static_cast<const uint32_t*>(shards);
  auto ou = static_cast<uint32_t*>(out);
  auto tb = static_cast<const uint32_t*>(tables);
#define GF_REPAIR_ARGS wi, wo, sh, ou, tb, rn, win, n, rows, Bp, S, shard_row, shard_obj, t, \
                       node_lo, node_count, head_zero, last_forwards, st
  if (l == 8) return vec4 ? launch_repair_tick<8, 4>(GF_REPAIR_ARGS)
                          : launch_repair_tick<8, 1>(GF_REPAIR_ARGS);
  if (l == 16) return vec4 ? launch_repair_tick<16, 4>(GF_REPAIR_ARGS)
                           : launch_repair_tick<16, 1>(GF_REPAIR_ARGS);
#undef GF_REPAIR_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Positions [pos_lo, pos_lo + pos_count) of a whole decode or repair chain:
// `tables` and `shard_rows` hold every position's, (h, packs, l/8, 256) and
// (h,); `shards` (R, n_obj, Bp) is laid out by the strides given, `out`
// (n_obj, rows, Bp) is contiguous. The first launch of a chain (pos_lo 0)
// starts from zero sums; a later one from the sums in `out`.
extern "C" int gf_repair_chain(const void* shards, void* out, const void* tables,
                               const int* shard_rows, int l, int rows, int n_obj,
                               long long Bp, long long shard_row, long long shard_obj,
                               int pos_lo, int pos_count, void* stream) {
  if (pos_lo < 0 || pos_count < 1 || pos_count > kMaxChainNodes || rows < 1 || n_obj < 1 ||
      Bp < 1 || (l != 8 && l != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  ChainRows pos;
  for (int z = 0; z < pos_count; ++z) pos.shard[z] = shard_rows[pos_lo + z];
  const int packs = (rows + 32 / l - 1) / (32 / l);
  auto sh = static_cast<const uint32_t*>(shards);
  auto ou = static_cast<uint32_t*>(out);
  auto tb = static_cast<const uint32_t*>(tables) +
            static_cast<size_t>(pos_lo) * packs * (l / 8) * 256;
  const bool vec4 = Bp % 4 == 0 && shard_row % 4 == 0 && shard_obj % 4 == 0 &&
                    aligned16(shards) && aligned16(out);
  const int from_out = pos_lo > 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GF_RCHAIN_ARGS sh, ou, tb, pos, pos_count, rows, n_obj, Bp, shard_row, shard_obj, \
                      from_out, st
  if (l == 8) return vec4 ? dispatch_repair_chain<8, 4>(GF_RCHAIN_ARGS)
                          : dispatch_repair_chain<8, 1>(GF_RCHAIN_ARGS);
  return vec4 ? dispatch_repair_chain<16, 4>(GF_RCHAIN_ARGS)
              : dispatch_repair_chain<16, 1>(GF_RCHAIN_ARGS);
#undef GF_RCHAIN_ARGS
}

// A whole unplaced encode chain: `src` (n_obj, R, Bp) contiguous, `out` (n,
// n_obj, Bp) laid out by the strides given (in lanes; its rows contiguous),
// `tables` (n, max_b, l/8, 256) and `plan` (terms, 5) on the device: the
// nodes' terms in chain order (Plan), with `caches` lane caches (at most 8).
// The caller has made the plan: tables and blocks in range, each node's
// terms ending in one marked last, and every cache a term reads kept by an
// earlier term of the same block. Writes every row of `out`.
extern "C" int gf_encode_chain(const void* src, void* out, const void* tables,
                               const void* plan, int l, int terms, int n_obj, int R,
                               int caches, long long Bp, long long out_node, long long out_obj,
                               void* stream) {
  if (terms < 1 || n_obj < 1 || R < 1 || Bp < 1 || caches < 0 || caches > kMaxEncodeCaches ||
      (l != 8 && l != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto sr = static_cast<const uint32_t*>(src);
  auto ou = static_cast<uint32_t*>(out);
  auto tb = static_cast<const uint32_t*>(tables);
  auto pl = static_cast<const int*>(plan);
  const bool vec4 = Bp % 4 == 0 && out_node % 4 == 0 && out_obj % 4 == 0 && aligned16(src) &&
                    aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GF_ECHAIN_ARGS sr, ou, tb, pl, terms, n_obj, R, caches, Bp, out_node, out_obj, st
  if (l == 8) return vec4 ? launch_encode_chain<8, 4>(GF_ECHAIN_ARGS)
                          : launch_encode_chain<8, 1>(GF_ECHAIN_ARGS);
  return vec4 ? launch_encode_chain<16, 4>(GF_ECHAIN_ARGS)
              : launch_encode_chain<16, 1>(GF_ECHAIN_ARGS);
#undef GF_ECHAIN_ARGS
}
