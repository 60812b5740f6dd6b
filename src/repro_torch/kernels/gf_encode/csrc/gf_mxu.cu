// Bit-lifted GF(2^l) encode on the int8 tensor cores, for Hopper (sm_90a).
//
// gf_encode_mxu replaces gf_encode_mxu_kernel / _mxu_body
// (src/repro/kernels/gf_encode/kernel.py). Over F2 a GF(2^l) coefficient is
// an l x l bit matrix: bit_i(c * x) = xor_b bit_b(x) * bit_i(c * alpha^b).
// The host lifts the (rows, k) coefficient matrix to the (rows*l, k*l) 0/1
// matrix A (bitlift_matrix), padded with zeros to R_pad x K_pad, multiples
// of the 16 x 32 fragment. Per tile of TB words the kernel
//   1. unpacks the k input rows into 0/1 int8 bit-planes in shared memory,
//      column-major: sB[col][j*l + b] = bit_b(x[j, col]);
//   2. takes the int8 product D = A * sB on the tensor cores
//      (mma.sync m16n8k32 s8 x s8 -> s32); every sum is < k*l, exact;
//   3. keeps D & 1 (the xor of the terms) and repacks l bits per output
//      word, out[r, col] = sum_i (D[r*l + i, col] & 1) << i, with warp
//      shuffles in registers, into a word tile in shared memory that the
//      block then stores coalesced.
//
// Bound: for the (16,11) GF(2^16) generator the product is 256 x 176 int8
// MACs per word, 1.53 ms at the card's 1,979 dense int8 Tops for the 704
// MiB object, against 0.54 ms of HBM traffic for the uint16 words; so the
// tensor-core rate bounds it, and mma.sync reaches only a part of it (the
// full rate needs wgmma, a later change). Design: A never changes, so each
// warp loads the A fragments of its m-tiles into registers once per block
// (up to 2 m-tiles x 8 k-steps) and a grid-stride loop over the word tiles
// reuses them; per tile the only shared-memory loads are the B fragments,
// each used by both of a warp's m-tiles, with a row stride (K_pad + 16
// bytes) that keeps the 32 lanes of a warp on 32 banks. The words are read
// and written in their own type (uint8 or uint16), so no widening pass runs
// before or after. Ragged word counts are masked in the unpack (zero
// columns) and in the store.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 128;       // TB: word columns per tile
constexpr int kMaxBlocks = 1024;      // grid stride beyond
constexpr int kMaxMPerWarp = 2;       // m-tiles per warp: R_pad <= 16 * 16
constexpr int kMaxKTiles = 8;         // k-steps: K_pad <= 8 * 32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// OR of v over the 8 lanes that share lane % 4 (the fragment's groupID axis)
__device__ __forceinline__ uint32_t or_over_groups(uint32_t v) {
  v |= __shfl_xor_sync(kFull, v, 4);
  v |= __shfl_xor_sync(kFull, v, 8);
  v |= __shfl_xor_sync(kFull, v, 16);
  return v;
}

// x (k, B) words, out (rows, B) words, lifted (R_pad, K_pad) int8 row-major.
// Shared memory: sB (TB, K_pad + 16) int8, then sW (rows, TB) words.
template <typename W, int L>
__global__ void __launch_bounds__(kThreads)
    gf_mxu_kernel(const W* __restrict__ x, W* __restrict__ out,
                  const int8_t* __restrict__ lifted, int rows, int k,
                  long long B, int R_pad, int K_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = K_pad + 16;
  int8_t* sB = reinterpret_cast<int8_t*>(smem);
  W* sW = reinterpret_cast<W*>(smem + static_cast<size_t>(kTileWords) * lds);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m_tiles = R_pad / 16, k_tiles = K_pad / 32;

  // this warp's A fragments (m-tiles warp and warp + 8), straight from
  // global memory into registers, once per block
  uint32_t a[kMaxMPerWarp][kMaxKTiles][4];
#pragma unroll
  for (int mi = 0; mi < kMaxMPerWarp; ++mi) {
    const int mt = warp + mi * kWarps;
    const int8_t* a_lo = lifted + static_cast<size_t>(mt * 16 + g) * K_pad + 4 * t;
    const int8_t* a_hi = a_lo + 8 * static_cast<size_t>(K_pad);
#pragma unroll
    for (int kt = 0; kt < kMaxKTiles; ++kt) {
      if (mt < m_tiles && kt < k_tiles) {
        a[mi][kt][0] = *reinterpret_cast<const uint32_t*>(a_lo + kt * 32);
        a[mi][kt][1] = *reinterpret_cast<const uint32_t*>(a_hi + kt * 32);
        a[mi][kt][2] = *reinterpret_cast<const uint32_t*>(a_lo + kt * 32 + 16);
        a[mi][kt][3] = *reinterpret_cast<const uint32_t*>(a_hi + kt * 32 + 16);
      } else {
        a[mi][kt][0] = a[mi][kt][1] = a[mi][kt][2] = a[mi][kt][3] = 0;
      }
    }
  }
  // zero sB once: the padded k*l..K_pad columns stay zero for every tile
  for (int w = threadIdx.x; w < kTileWords * lds / 4; w += kThreads)
    reinterpret_cast<uint32_t*>(sB)[w] = 0;
  __syncthreads();

  const long long n_col_tiles = (B + kTileWords - 1) / kTileWords;
  for (long long tile = blockIdx.x; tile < n_col_tiles; tile += gridDim.x) {
    const long long c0 = tile * kTileWords;
    // 1. unpack: thread (j, col) writes the l bits of x[j, c0 + col],
    //    four bits per 32-bit store
    for (int idx = threadIdx.x; idx < k * kTileWords; idx += kThreads) {
      const int j = idx / kTileWords, col = idx % kTileWords;
      const long long c = c0 + col;
      const uint32_t v = c < B ? static_cast<uint32_t>(x[static_cast<size_t>(j) * B + c]) : 0u;
      uint32_t* dst = reinterpret_cast<uint32_t*>(sB + static_cast<size_t>(col) * lds + j * L);
#pragma unroll
      for (int b = 0; b < L; b += 4) {
        dst[b / 4] = ((v >> b) & 1u) | (((v >> (b + 1)) & 1u) << 8) |
                     (((v >> (b + 2)) & 1u) << 16) | (((v >> (b + 3)) & 1u) << 24);
      }
    }
    __syncthreads();

    // 2.-3. per 8-word n-tile: D = A * sB for this warp's m-tiles, then the
    //    mod-2 bits repacked into words with shuffles and staged in sW
    for (int nt = 0; nt < kTileWords / 8; ++nt) {
      int d[kMaxMPerWarp][4] = {};
      const int8_t* bp = sB + static_cast<size_t>(nt * 8 + g) * lds + 4 * t;
#pragma unroll
      for (int kt = 0; kt < kMaxKTiles; ++kt) {
        if (kt < k_tiles) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp + kt * 32);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + kt * 32 + 16);
#pragma unroll
          for (int mi = 0; mi < kMaxMPerWarp; ++mi)
            if (warp + mi * kWarps < m_tiles) mma_s8(d[mi], a[mi][kt], b0, b1);
        }
      }
      // lane (g, t) holds D rows g (d0, d1) and g + 8 (d2, d3) of the
      // m-tile at columns 2t and 2t + 1
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int mi = 0; mi < kMaxMPerWarp; ++mi) {
        const int mt = warp + mi * kWarps;
        if (mt >= m_tiles) continue;  // uniform across the warp
        const uint32_t dm[4] = {static_cast<uint32_t>(d[mi][0]), static_cast<uint32_t>(d[mi][1]),
                                static_cast<uint32_t>(d[mi][2]), static_cast<uint32_t>(d[mi][3])};
        if constexpr (L == 16) {  // one output row: bits g and g + 8
          const uint32_t w0 = or_over_groups(((dm[0] & 1u) << g) | ((dm[2] & 1u) << (g + 8)));
          const uint32_t w1 = or_over_groups(((dm[1] & 1u) << g) | ((dm[3] & 1u) << (g + 8)));
          if (g == 0) {
            sW[mt * kTileWords + col] = static_cast<W>(w0);
            sW[mt * kTileWords + col + 1] = static_cast<W>(w1);
          }
        } else {  // two output rows, 2mt (rows g) and 2mt + 1 (rows g + 8): bit g
          const uint32_t lo0 = or_over_groups((dm[0] & 1u) << g);
          const uint32_t lo1 = or_over_groups((dm[1] & 1u) << g);
          const uint32_t hi0 = or_over_groups((dm[2] & 1u) << g);
          const uint32_t hi1 = or_over_groups((dm[3] & 1u) << g);
          if (g == 0) {
            sW[2 * mt * kTileWords + col] = static_cast<W>(lo0);
            sW[2 * mt * kTileWords + col + 1] = static_cast<W>(lo1);
            if (2 * mt + 1 < rows) {  // else the m-tile's padded half
              sW[(2 * mt + 1) * kTileWords + col] = static_cast<W>(hi0);
              sW[(2 * mt + 1) * kTileWords + col + 1] = static_cast<W>(hi1);
            }
          }
        }
      }
    }
    __syncthreads();  // sW complete; every read of sB for this tile done

    // 4. store the tile's valid columns, coalesced. The next tile's unpack
    //    may overlap it: it writes sB only, and sW is rewritten only after
    //    the barrier that follows the unpack.
    for (int idx = threadIdx.x; idx < rows * kTileWords; idx += kThreads) {
      const int r = idx / kTileWords, col = idx % kTileWords;
      const long long c = c0 + col;
      if (c < B) out[static_cast<size_t>(r) * B + c] = sW[idx];
    }
  }
}

template <typename W, int L>
int launch(const void* x, void* out, const void* lifted, int rows, int k,
           long long B, int R_pad, int K_pad, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kTileWords) * (K_pad + 16) +
                      static_cast<size_t>(rows) * kTileWords * sizeof(W);
  long long tiles = (B + kTileWords - 1) / kTileWords;
  if (tiles > kMaxBlocks) tiles = kMaxBlocks;
  gf_mxu_kernel<W, L><<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
      static_cast<const W*>(x), static_cast<W*>(out),
      static_cast<const int8_t*>(lifted), rows, k, B, R_pad, K_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. `x` and `out` are device pointers
// of contiguous uint8 (l = 8) or uint16 (l = 16) word tensors, `lifted` of
// the contiguous (R_pad, K_pad) int8 lifted matrix; the caller has checked
// shapes, R_pad % 16 == 0 and R_pad <= 256, K_pad % 32 == 0 and
// K_pad <= 256 (so the shared memory in launch() stays under 48 KB).
// Launches on `stream` and returns cudaGetLastError() (0 on success).

extern "C" int gf_encode_mxu(const void* x, void* out, const void* lifted,
                             int l, int rows, int k, long long B, int R_pad,
                             int K_pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l == 8)
    return launch<uint8_t, 8>(x, out, lifted, rows, k, B, R_pad, K_pad, st);
  if (l == 16)
    return launch<uint16_t, 16>(x, out, lifted, rows, k, B, R_pad, K_pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
