// Pipeline-tick kernels of the RapidRAID chain, for Hopper (sm_90a).
//
// Both kernels work on packed GF(2^l) words: one 32-bit lane holds 4 words
// of GF(2^8) or 2 of GF(2^16), and a multiply by a coefficient c is
//     c * x = xor_b ((x >> b) & LSB) * (c * alpha^b),
// where LSB has the lowest bit of every packed word set. The mask lanes are
// 0 or 1 and c * alpha^b < 2^l, so the 32-bit product never carries from one
// packed word into the next; it wraps mod 2^32 as it does on the TPU.
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
//     c     = x_in ^ sum_s sum_b m_sb * bp_xi[s, b]    (kept codeword chunk)
//     x_out = x_in ^ sum_s sum_b m_sb * bp_psi[s, b]   (forwarded wire)
// Bound: memory and integer work are close. Each lane of each replica slot
// costs l masks (shift + and) feeding two multiplies and two xors, about
// 6 * l operations per 4 bytes read; for the (16,11) GF(2^16) main path
// that is 1.4 ms of HBM traffic against 1.0 ms at the card's 33.5 Tops of
// INT32 (2.1 ms at the ALU pipe's 64 instructions/clock/SM), so the kernel
// sits between the two roofs. Design: every mask is built once and
// feeds both accumulators; a block stages its node's planes in shared
// memory and then in registers (fully unrolled over slots and bits), and a
// grid-stride loop over lanes amortizes that staging; slots whose planes
// are all zero (the padded slot of single-block nodes, the last node's psi)
// are skipped with a branch that is uniform across the block.
//
// repair_tick replaces repair_step_kernel / _repair_step_body (same file),
// the decode tick: node i adds sum_b mask_b(local_i) * bp[i, :, b] to the
// rows partial sums it received; the last node writes them to the output
// chunk. Bound: memory. Each lane carries `rows` partial sums in and out
// per node, 8 * rows bytes of wire traffic against 4 bytes of local data.
// Design: one mask per bit, built once per lane and shared by all rows;
// the planes sit in shared memory and are read as broadcasts; consecutive
// threads touch consecutive lanes so every load and store is coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

// wire_in (rows_in, O, S), wire_out (rows_in + 1.., O, S), local
// (n, O, MAXB, Bp), out (n, O, Bp), bp_psi / bp_xi (n, MAXB, L).
template <int L, int MAXB>
__global__ void __launch_bounds__(kThreads)
    chain_tick_kernel(const uint32_t* __restrict__ wire_in,
                      uint32_t* __restrict__ wire_out,
                      const uint32_t* __restrict__ local,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ bp_psi,
                      const uint32_t* __restrict__ bp_xi, int O, long long Bp,
                      long long S, int t, int num_chunks, int node_lo) {
  const int i = node_lo + static_cast<int>(blockIdx.z);
  const int o = static_cast<int>(blockIdx.y);
  const int ch = t - i;
  __shared__ uint32_t s_xi[MAXB * L];
  __shared__ uint32_t s_psi[MAXB * L];
  for (int j = threadIdx.x; j < MAXB * L; j += blockDim.x) {
    s_xi[j] = bp_xi[static_cast<size_t>(i) * MAXB * L + j];
    s_psi[j] = bp_psi[static_cast<size_t>(i) * MAXB * L + j];
  }
  __syncthreads();
  if (ch < 0 || ch >= num_chunks) return;  // whole block: no chunk this tick

  uint32_t cx[MAXB][L];
  uint32_t cp[MAXB][L];
  bool use_xi[MAXB];
  bool use_psi[MAXB];
#pragma unroll
  for (int s = 0; s < MAXB; ++s) {
    uint32_t any_xi = 0, any_psi = 0;
#pragma unroll
    for (int b = 0; b < L; ++b) {
      cx[s][b] = s_xi[s * L + b];
      cp[s][b] = s_psi[s * L + b];
      any_xi |= cx[s][b];
      any_psi |= cp[s][b];
    }
    use_xi[s] = any_xi != 0;
    use_psi[s] = any_psi != 0;
  }

  const uint32_t lsb = Lsb<L>::value;
  const size_t row = static_cast<size_t>(i) * O + o;
  const uint32_t* wi = wire_in + row * S;
  uint32_t* wo = wire_out + (row + O) * S;  // row i + 1, same object
  const uint32_t* loc = local + row * MAXB * Bp + static_cast<size_t>(ch) * S;
  uint32_t* dst = out + row * Bp + static_cast<size_t>(ch) * S;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < S; j += stride) {
    const uint32_t x = wi[j];
    uint32_t c = x;
    uint32_t xo = x;
#pragma unroll
    for (int s = 0; s < MAXB; ++s) {
      if (use_psi[s]) {
        const uint32_t v = loc[static_cast<size_t>(s) * Bp + j];
#pragma unroll
        for (int b = 0; b < L; ++b) {
          const uint32_t m = (v >> b) & lsb;  // shared by both paths
          c ^= m * cx[s][b];
          xo ^= m * cp[s][b];
        }
      } else if (use_xi[s]) {
        const uint32_t v = loc[static_cast<size_t>(s) * Bp + j];
#pragma unroll
        for (int b = 0; b < L; ++b) c ^= ((v >> b) & lsb) * cx[s][b];
      }
    }
    dst[j] = c;
    wo[j] = xo;
  }
}

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

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous int32 tensors; the caller has checked shapes. Each function
// launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gf_chain_tick(const void* wire_in, void* wire_out,
                             const void* local, void* out, const void* bp_psi,
                             const void* bp_xi, int l, int max_b, int O,
                             long long Bp, long long S, int t, int num_chunks,
                             int node_lo, int node_count, void* stream) {
  const dim3 grid = tick_grid(S, O, node_count);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const uint32_t*>(wire_in);
  auto wo = static_cast<uint32_t*>(wire_out);
  auto lo = static_cast<const uint32_t*>(local);
  auto ou = static_cast<uint32_t*>(out);
  auto bpp = static_cast<const uint32_t*>(bp_psi);
  auto bpx = static_cast<const uint32_t*>(bp_xi);
  if (l == 8 && max_b == 1) {
    chain_tick_kernel<8, 1><<<grid, block, 0, st>>>(
        wi, wo, lo, ou, bpp, bpx, O, Bp, S, t, num_chunks, node_lo);
  } else if (l == 8 && max_b == 2) {
    chain_tick_kernel<8, 2><<<grid, block, 0, st>>>(
        wi, wo, lo, ou, bpp, bpx, O, Bp, S, t, num_chunks, node_lo);
  } else if (l == 16 && max_b == 1) {
    chain_tick_kernel<16, 1><<<grid, block, 0, st>>>(
        wi, wo, lo, ou, bpp, bpx, O, Bp, S, t, num_chunks, node_lo);
  } else if (l == 16 && max_b == 2) {
    chain_tick_kernel<16, 2><<<grid, block, 0, st>>>(
        wi, wo, lo, ou, bpp, bpx, O, Bp, S, t, num_chunks, node_lo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
