// Bit-lifted GF(2^l) encode on the int8 tensor cores, for Hopper (sm_90a).
//
// gf_encode_mxu replaces gf_encode_mxu_kernel / _mxu_body
// (src/repro/kernels/gf_encode/kernel.py). Over F2 a GF(2^l) coefficient is
// an l x l bit matrix: bit_i(c * x) = xor_b bit_b(x) * bit_i(c * alpha^b).
// The host lifts the (rows, k) coefficient matrix to the (rows*l, k*l) 0/1
// matrix A (bitlift_matrix) and lays it out, zero-padded, as the K-major
// shared-memory operand of wgmma (kernel.mxu_operand). Per tile of 64 words
// the kernel takes D[word, bit] = sum_K bits[word, K] * A[bit, K] on the
// tensor cores (wgmma m64nNk32 s8 x s8 -> s32; every sum is < k*l, exact),
// and the output word is the l bits D & 1 of its row.
//
// Bound: for the (16,11) GF(2^16) generator the product is 256 x 176 int8
// MACs per word, 1.53 ms at the card's 1,979 dense int8 Tops for the 704
// MiB object, against 0.54 ms of HBM traffic for the uint16 words; the
// tensor cores bound it, and only wgmma reaches their full rate.
//
// Design (a persistent, warp-specialised block per SM, 384 threads):
//   * A is copied once per block into shared memory, in the layout built on
//     the host: 8 x 16-byte core matrices, no swizzle (LBO 128 B along K,
//     SBO 256 B along N), so wgmma reads it through a descriptor and no
//     register holds it; any size that fits shared memory runs.
//   * Warpgroup 2 unpacks. Its first thread keeps TMA loads of (k, 256)
//     words (four tiles a load: fewer, wider rows per TMA operation)
//     kStages - 1 loads ahead in a ring with full/empty
//     mbarriers (TMA zero-fills the ragged end of B); the warpgroup turns
//     each tile into 0/1 bytes in a ring of kBits K-major operand buffers (4
//     bits per 32-bit store via one multiply), with full/empty mbarriers of
//     its own. When the row pitch of the words is not a multiple of 16 bytes
//     (TMA's limit) it reads the words with plain loads instead.
//   * Warpgroups 0 and 1 are consumers and take alternate tiles, so one's
//     epilogue overlaps the other's product. A consumer runs wgmma over K
//     for each n-tile of A, frees the operand buffer and writes the words.
//     (Earlier builds, on the card at (16,11): 4.10 ms with the unpack
//     inside the consumers, 3.54 ms with one-tile loads and the consumers
//     taking the tensor cores in turns; scratch builds with the bits as
//     wgmma register fragments, or with more ring slots, were no faster.)
//   * The host orders A's rows (the n axis) so that each thread's
//     accumulators hold all l bits of whole output words, and the unpack
//     orders the words (the m axis) so that each thread holds two adjacent
//     words: the epilogue is (d & 1) << i into registers and one 32-bit
//     store per pair of uint16 words, with no shuffle and no shared memory.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileWords = 64;             // words per tile: wgmma's M
constexpr int kTilesPerLoad = 4;           // tiles per TMA load: 256-word rows
constexpr int kLoadWords = kTileWords * kTilesPerLoad;
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the unpack warpgroup
constexpr int kStages = 4;                 // ring of word tiles
constexpr int kBits = 4;                   // ring of unpacked operand tiles
constexpr int kUnroll = 4;                 // word pairs an unpack thread loads at once
constexpr int kAlign = 1024;

__host__ __device__ constexpr size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

struct Layout {  // byte offsets into the (aligned) dynamic shared memory
  size_t a, bits, stage, stage_bytes, bars, total;
};

__host__ __device__ inline Layout smem_layout(int npad, int K_pad, int stage_rows,
                                              int word_bytes) {
  Layout s;
  s.a = 0;
  s.bits = align_up(static_cast<size_t>(npad) * K_pad, kAlign);
  s.stage = s.bits + align_up(static_cast<size_t>(kTileWords) * K_pad, kAlign) * kBits;
  s.stage_bytes = align_up(static_cast<size_t>(stage_rows) * kLoadWords * word_bytes, 128);
  s.bars = s.stage + s.stage_bytes * kStages;
  s.total = s.bars + (2 * kStages + 2 * kBits) * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, unswizzled operand whose
// 8-row x 16-byte core matrices sit 128 B apart along K and 256 B apart
// along M/N (the layout of kernel.mxu_operand and of the unpacked bits).
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k32(uint32_t (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n256k32(uint32_t (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(uint32_t (&d)[NT / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (NT == 64) wgmma_m64n64k32(d, da, db, acc);
  else if constexpr (NT == 128) wgmma_m64n128k32(d, da, db, acc);
  else wgmma_m64n256k32(d, da, db, acc);
}

// byte offset of (row m, K byte kb) in a K-major operand of `rows_total`
// rows laid out as core matrices (see operand_desc)
__device__ __forceinline__ uint32_t core_offset(int m, int kb, int rows_total) {
  return (kb >> 5) * (rows_total * 32) + (m >> 3) * 256 + ((kb >> 4) & 1) * 128 + (m & 7) * 16 +
         (kb & 15);
}

// the 4 bits of v at `shift` as 4 bytes of 0/1
__device__ __forceinline__ uint32_t spread4(uint32_t v, int shift) {
  return (((v >> shift) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// word v (its low L bits) of input row j as the 0/1 bytes of operand row m
template <int L>
__device__ __forceinline__ void unpack_word(unsigned char* bits, int m, int j, uint32_t v) {
  unsigned char* dst = bits + core_offset(m, j * L, kTileWords);
  if constexpr (L == 16)
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(spread4(v, 0), spread4(v, 4), spread4(v, 8), spread4(v, 12));
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(spread4(v, 0), spread4(v, 4));
}

// x (k, B) words, out (rows, B) words; `image` the (npad, K_pad) operand of
// kernel.mxu_operand in its shared-memory byte order, npad = n_ntiles * NT.
// `box_rows` rows per TMA box, `n_boxes` boxes per tile (n_boxes * box_rows
// >= k); use_tma = 0: the unpack warpgroup reads the words itself.
template <typename W, int L, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    gf_mxu_kernel(__grid_constant__ const CUtensorMap tmap, const W* __restrict__ x,
                  W* __restrict__ out, const int8_t* __restrict__ image, int rows, int k,
                  long long B, int n_ntiles, int K_pad, int box_rows, int n_boxes, int use_tma) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base_u32 = (raw_u32 + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  unsigned char* smem = smem_raw + (base_u32 - raw_u32);
  const int npad = n_ntiles * NT;
  const int stage_rows = box_rows * n_boxes;
  const Layout lay = smem_layout(npad, K_pad, stage_rows, sizeof(W));
  const size_t bits_bytes = align_up(static_cast<size_t>(kTileWords) * K_pad, kAlign);
  // mbarriers: word tile loaded / consumed, operand unpacked / consumed
  const uint32_t full0 = base_u32 + static_cast<uint32_t>(lay.bars);
  const uint32_t empty0 = full0 + kStages * 8;
  const uint32_t bfull0 = empty0 + kStages * 8;
  const uint32_t bempty0 = bfull0 + kBits * 8;
  // The block takes every gridDim.x-th group of kTilesPerLoad adjacent tiles
  // (one TMA load); its i-th tile is tile_of(i).
  const long long n_tiles = (B + kTileWords - 1) / kTileWords;
  const long long n_loads = (B + kLoadWords - 1) / kLoadWords;
  const auto load_of = [&](long long i) { return blockIdx.x + i * gridDim.x; };
  const auto tile_of = [&](long long i) {
    return load_of(i / kTilesPerLoad) * kTilesPerLoad + i % kTilesPerLoad;
  };

  // the lifted operand, once per block
  {
    const int n16 = npad * K_pad / 16;
    const uint4* src = reinterpret_cast<const uint4*>(image);
    uint4* dst = reinterpret_cast<uint4*>(smem + lay.a);
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    for (int b = 0; b < kBits; ++b) {
      mbar_init(bfull0 + 8 * b, 128);
      mbar_init(bempty0 + 8 * b, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // A: generic -> wgmma
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, tid = threadIdx.x % 128;
  if (wg == kConsumers) {
    // ---- unpack warpgroup: words -> 0/1 operand tiles ------------------------
    // Its first thread also drives TMA, kStages - 1 loads ahead of the unpack.
    // Ring slots and phases advance by counting.
    int load_s = 0, s = 0;
    uint32_t load_ph = 0, ph = 0;
    long long loaded = 0;
    const auto load_next = [&]() {
      mbar_wait(empty0 + 8 * load_s, load_ph ^ 1u);
      mbar_expect_tx(full0 + 8 * load_s,
                     static_cast<uint32_t>(stage_rows * kLoadWords * sizeof(W)));
      for (int bx = 0; bx < n_boxes; ++bx)
        tma_load_2d(base_u32 + static_cast<uint32_t>(lay.stage + load_s * lay.stage_bytes +
                                                     bx * box_rows * kLoadWords * sizeof(W)),
                    &tmap, static_cast<int>(load_of(loaded) * kLoadWords), bx * box_rows,
                    full0 + 8 * load_s);
      ++loaded;
      if (++load_s == kStages) load_s = 0, load_ph ^= 1u;
    };
    if (use_tma && tid == 0)
      while (loaded < kStages - 1 && load_of(loaded) < n_loads) load_next();
    for (long long i = 0; tile_of(i) < n_tiles; ++i) {
      const int b = static_cast<int>(i % kBits), q = static_cast<int>(i % kTilesPerLoad);
      if (use_tma && q == 0) {  // the first tile of a load
        if (tid == 0 && load_of(loaded) < n_loads) load_next();
        mbar_wait(full0 + 8 * s, ph);
      }
      mbar_wait(bempty0 + 8 * b, static_cast<uint32_t>(((i / kBits) & 1) ^ 1));
      const long long c0 = tile_of(i) * kTileWords;
      // this tile's columns of the ring slot (kLoadWords words a row)
      const W* st = reinterpret_cast<const W*>(smem + lay.stage + s * lay.stage_bytes) +
                    q * kTileWords;
      // Operand rows m and m + 8 hold words pos and pos + 1 of the tile, so a
      // consumer thread's accumulator rows g and g + 8 are two adjacent
      // words. A thread takes one such pair and every fourth input row, and
      // loads kUnroll pairs before it unpacks any.
      unsigned char* bits = smem + lay.bits + b * bits_bytes;
      const int p = tid % 32, jt = tid / 32;
      const int m = (p & 24) * 2 + (p & 7), pos = (p & 24) * 2 + 2 * (p & 7);
      for (int j0 = jt; j0 < k; j0 += 4 * kUnroll) {
        uint32_t v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + 4 * u;
          v[u] = 0;
          if (j >= k) continue;
          if (use_tma) {
            const W* w = st + j * kLoadWords + pos;
            v[u] = L == 16 ? *reinterpret_cast<const uint32_t*>(w)
                           : *reinterpret_cast<const uint16_t*>(w);
          } else {
            const W* row = x + static_cast<size_t>(j) * B;
            const long long c = c0 + pos;
            v[u] = (c < B ? row[c] : 0u) | ((c + 1 < B ? uint32_t(row[c + 1]) : 0u) << L);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + 4 * u;
          if (j < k) {
            unpack_word<L>(bits, m, j, v[u]);
            unpack_word<L>(bits, m + 8, j, v[u] >> L);
          }
        }
      }
      if (use_tma && (q == kTilesPerLoad - 1 || tile_of(i + 1) >= n_tiles)) {
        mbar_arrive(empty0 + 8 * s);  // the load's words are all unpacked
        if (++s == kStages) s = 0, ph ^= 1u;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // bits -> wgmma
      mbar_arrive(bfull0 + 8 * b);
    }
    return;
  }

  // ---- consumers --------------------------------------------------------------
  const int w = warp % 4, g = lane >> 2, t = lane & 3;
  const uint32_t a_u32 = base_u32 + static_cast<uint32_t>(lay.a);
  constexpr int RT = NT / (4 * L);  // output rows per thread per n-tile
  const bool pairs = (B % 2) == 0;  // two adjacent words per aligned store
  uint32_t d[NT / 2] = {};

  for (long long i = wg; tile_of(i) < n_tiles; i += kConsumers) {
    const int b = static_cast<int>(i % kBits);
    mbar_wait(bfull0 + 8 * b, static_cast<uint32_t>((i / kBits) & 1));
    const uint32_t bits_u32 = base_u32 + static_cast<uint32_t>(lay.bits + b * bits_bytes);
    const long long col = tile_of(i) * kTileWords + 16 * w + 2 * g;  // this thread's word pair
    for (int nt = 0; nt < n_ntiles; ++nt) {
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < K_pad / 32; ++ks) {
        const uint64_t da = operand_desc(bits_u32 + ks * kTileWords * 32);
        const uint64_t db = operand_desc(a_u32 + ks * npad * 32 + nt * NT * 32);
        wgmma_tile<NT>(d, da, db, ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (nt == n_ntiles - 1) mbar_arrive(bempty0 + 8 * b);  // operand tile read

      // epilogue: accumulator column 8c + 2t + p is bit q % L of output row
      // t * RT + q / L of the n-tile, q = 2c + p (kernel.mxu_operand)
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const int r = nt * (NT / L) + t * RT + rr;
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int bit = 0; bit < L; ++bit) {
          const int q = rr * L + bit;
          const int reg = 4 * (q >> 1) + (q & 1);
          word[0] |= (d[reg] & 1u) << bit;
          word[1] |= (d[reg + 2] & 1u) << bit;
        }
        if (r < rows) {
          W* o = out + static_cast<size_t>(r) * B + col;
          if (pairs && col + 1 < B) {
            if constexpr (L == 16)
              *reinterpret_cast<uint32_t*>(o) = word[0] | (word[1] << 16);
            else
              *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(word[0] | (word[1] << 8));
          } else {
            if (col < B) o[0] = static_cast<W>(word[0]);
            if (col + 1 < B) o[1] = static_cast<W>(word[1]);
          }
        }
      }
    }
  }
}

template <typename W, int L, int NT>
int launch(const void* x, void* out, const void* image, int rows, int k, long long B,
           int n_ntiles, int K_pad, cudaStream_t st) {
  constexpr CUtensorMapDataType kType =
      sizeof(W) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const int n_boxes = (k + 255) / 256;                 // TMA boxes are <= 256 rows
  const int box_rows = (k + n_boxes - 1) / n_boxes;
  const Layout lay = smem_layout(n_ntiles * NT, K_pad, box_rows * n_boxes, sizeof(W));
  const size_t smem = lay.total + kAlign;

  CUtensorMap tmap = {};
  const bool use_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (B * sizeof(W)) % 16 == 0;
  if (use_tma) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(k)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(B) * sizeof(W)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kLoadWords), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult rc = cuTensorMapEncodeTiled(
        &tmap, kType, 2, const_cast<void*>(x), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return 10000 + static_cast<int>(rc);  // driver error, offset
  }
  auto kern = gf_mxu_kernel<W, L, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = (B + kLoadWords - 1) / kLoadWords;  // one TMA load each, at least
  if (grid > sms) grid = sms;
  kern<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      tmap, static_cast<const W*>(x), static_cast<W*>(out), static_cast<const int8_t*>(image),
      rows, k, B, n_ntiles, K_pad, box_rows, n_boxes, use_tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int L>
int launch_nt(const void* x, void* out, const void* image, int rows, int k, long long B, int NT,
              int n_ntiles, int K_pad, cudaStream_t st) {
  if (NT == 64) return launch<W, L, 64>(x, out, image, rows, k, B, n_ntiles, K_pad, st);
  if (NT == 128) return launch<W, L, 128>(x, out, image, rows, k, B, n_ntiles, K_pad, st);
  if (NT == 256) return launch<W, L, 256>(x, out, image, rows, k, B, n_ntiles, K_pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. `x` and `out` are device pointers
// of contiguous uint8 (l = 8) or uint16 (l = 16) word tensors, `image` of
// the contiguous int8 operand of kernel.mxu_operand (n_ntiles n-tiles of NT
// lifted rows, K_pad lifted columns); the caller has checked shapes and that
// gf_encode_mxu_smem_bytes() fits the card. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or 10000 + the driver's error code if
// the TMA descriptor could not be built.
extern "C" int gf_encode_mxu(const void* x, void* out, const void* image, int l, int rows, int k,
                             long long B, int NT, int n_ntiles, int K_pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l == 8) return launch_nt<uint8_t, 8>(x, out, image, rows, k, B, NT, n_ntiles, K_pad, st);
  if (l == 16) return launch_nt<uint16_t, 16>(x, out, image, rows, k, B, NT, n_ntiles, K_pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of gf_encode_mxu needs for these sizes.
extern "C" long long gf_encode_mxu_smem_bytes(int l, int k, int NT, int n_ntiles, int K_pad) {
  const int n_boxes = (k + 255) / 256;
  const int box_rows = (k + n_boxes - 1) / n_boxes;
  return static_cast<long long>(
      smem_layout(n_ntiles * NT, K_pad, box_rows * n_boxes, l / 8).total + kAlign);
}
