// Static-coefficient GF(2^l) matrix encode on packed words, for Hopper (sm_90a).
//
// gf_encode replaces gf_encode_kernel / _encode_body
// (src/repro/kernels/gf_encode/kernel.py): out[o, r] = sum_j M[r, j] * x[o, j]
// over GF(2^l), on int32 lanes that pack 4 GF(2^8) or 2 GF(2^16) words, with
// the multiply by a coefficient written as
//     c * x = xor_b ((x >> b) & LSB) * (c * alpha^b)
// (see gf_tick.cu for why the 32-bit product never carries between words).
//
// The TPU kernel bakes M into its unrolled body as constants. Compiling per
// matrix here would cost one nvcc build per code, so the (rows, k, l)
// bit-plane table c * alpha^b is an input: each block stages it in shared
// memory, with one flag per (input row j, bit b) that says whether any row
// has a nonzero plane there. A flagged-off mask is never built, and a zero
// plane term is skipped; both branches read shared memory that is the same
// for every thread, so they never diverge.
//
// Bound: for the (16,11) classical parity (rows = 5) each lane costs k * l
// masks (shift, and) and rows * k * l multiply + xor, 2112 int32 operations
// per 64 bytes moved, so the integer pipes bound it (about 1.06 ms against
// 0.32 ms of HBM traffic for the 704 MiB object). Design: each thread owns
// V lanes (blockDim apart, so every load and store stays coalesced) and RG
// row accumulators per lane: RG * V = 32 registers, 64 for the 16-row
// group (with 8 lanes it spills; with 2 a term's overhead is barely
// shared). Each mask is built once per (j, b) and lane and feeds every
// accumulator of the row group, and each plane constant is read from
// shared memory once per V lanes, so the shared load and the zero test of
// a term are shared by V multiply + xor pairs. The input is read once per
// row group (once in all for rows <= 16). The lane loop is a grid stride
// that masks the ragged end, so no length needs padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr long long kMaxTiles = 2048;  // lane tiles per object; grid stride beyond

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

// data (O, k, Bp), out (O, rows, Bp), planes (rows, k, L).
// Dynamic shared memory: rows * k * L plane words, then k * L flags.
template <int L, int RG, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gf_encode_kernel(const uint32_t* __restrict__ data,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ planes, int rows, int k,
                     long long Bp) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_planes = smem;                 // (rows, k, L)
  uint32_t* s_flag = smem + rows * k * L;    // (k, L): any row nonzero
  const int n_planes = rows * k * L;
  for (int j = threadIdx.x; j < n_planes; j += blockDim.x) s_planes[j] = planes[j];
  __syncthreads();
  for (int jb = threadIdx.x; jb < k * L; jb += blockDim.x) {
    uint32_t any = 0;
    for (int r = 0; r < rows; ++r) any |= s_planes[r * k * L + jb];
    s_flag[jb] = any;
  }
  __syncthreads();

  const uint32_t lsb = Lsb<L>::value;
  const int o = static_cast<int>(blockIdx.y);
  const uint32_t* x = data + static_cast<size_t>(o) * k * Bp;
  uint32_t* y = out + static_cast<size_t>(o) * rows * Bp;
  const long long span = static_cast<long long>(blockDim.x) * V;  // lanes per block step
  for (long long p0 = static_cast<long long>(blockIdx.x) * span + threadIdx.x;
       p0 < Bp; p0 += span * gridDim.x) {
    bool in[V];
#pragma unroll
    for (int q = 0; q < V; ++q) in[q] = p0 + q * blockDim.x < Bp;
    for (int r0 = 0; r0 < rows; r0 += RG) {
      const int nr = rows - r0 < RG ? rows - r0 : RG;
      uint32_t acc[RG][V];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[r][q] = 0;
      for (int j = 0; j < k; ++j) {
        const uint32_t* xj = x + static_cast<size_t>(j) * Bp + p0;
        uint32_t v[V];
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = in[q] ? xj[q * blockDim.x] : 0u;
        const uint32_t* pl = s_planes + (r0 * k + j) * L;
#pragma unroll
        for (int b = 0; b < L; ++b) {
          if (!s_flag[j * L + b]) continue;  // no row uses this plane
          uint32_t m[V];                      // shared by every row
#pragma unroll
          for (int q = 0; q < V; ++q) m[q] = (v[q] >> b) & lsb;
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            if (r < nr) {
              const uint32_t c = pl[r * k * L + b];
              if (c) {
#pragma unroll
                for (int q = 0; q < V; ++q) acc[r][q] ^= m[q] * c;
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (r < nr) {
          uint32_t* yr = y + static_cast<size_t>(r0 + r) * Bp + p0;
#pragma unroll
          for (int q = 0; q < V; ++q)
            if (in[q]) yr[q * blockDim.x] = acc[r][q];
        }
      }
    }
  }
}

template <int L, int RG>
int launch(const uint32_t* data, uint32_t* out, const uint32_t* planes,
           int rows, int k, long long Bp, int O, int threads, size_t smem,
           cudaStream_t st) {
  constexpr int V = RG == 16 ? 4 : 32 / RG;  // lanes per thread: RG * V accumulators
  const long long span = static_cast<long long>(threads) * V;
  long long tiles = (Bp + span - 1) / span;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(O));
  gf_encode_kernel<L, RG, V><<<grid, threads, smem, st>>>(data, out, planes,
                                                          rows, k, Bp);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_rows(const uint32_t* data, uint32_t* out, const uint32_t* planes,
                int rows, int k, long long Bp, int O, int threads, size_t smem,
                cudaStream_t st) {
  if (rows <= 4)
    return launch<L, 4>(data, out, planes, rows, k, Bp, O, threads, smem, st);
  if (rows <= 8)
    return launch<L, 8>(data, out, planes, rows, k, Bp, O, threads, smem, st);
  return launch<L, 16>(data, out, planes, rows, k, Bp, O, threads, smem, st);
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous int32 tensors; the caller has checked shapes, the thread count
// (1..512) and that the planes and flags fit the 48 KB of dynamic shared
// memory a launch gets without opting in. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gf_encode(const void* data, void* out, const void* planes,
                         int l, int rows, int k, long long Bp, int O,
                         int threads, void* stream) {
  const size_t smem = static_cast<size_t>(rows + 1) * k * l * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint32_t*>(data);
  auto y = static_cast<uint32_t*>(out);
  auto p = static_cast<const uint32_t*>(planes);
  if (l == 8) return launch_rows<8>(x, y, p, rows, k, Bp, O, threads, smem, st);
  if (l == 16) return launch_rows<16>(x, y, p, rows, k, Bp, O, threads, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
