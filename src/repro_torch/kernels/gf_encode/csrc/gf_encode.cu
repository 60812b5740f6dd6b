// Static-coefficient GF(2^l) matrix encode on packed words, for Hopper (sm_90a).
//
// gf_encode replaces gf_encode_kernel / _encode_body
// (src/repro/kernels/gf_encode/kernel.py): out[o, r] = sum_j M[r, j] * x[o, j]
// over GF(2^l), on int32 lanes that pack 4 GF(2^8) or 2 GF(2^16) words, with
// the multiply by a coefficient written as
//     c * x = xor_b ((x >> b) & LSB) * (c * alpha^b)
// (see gf_tick.cu for why the 32-bit product never carries between words).
//
// This file is a template, not part of the nvcc library. kernel.py fills in
// its two markers (the defines and the body) for one matrix M and one field,
// and NVRTC compiles it at the first use of that matrix, as the TPU kernel
// bakes M into its unrolled body. So every nonzero plane term c * alpha^b is a multiply by an
// immediate, pairs of terms of a row fold into one 3-input xor, a zero term
// or a mask no row uses does not exist, and nothing is read but the data:
// no table, no shared memory, no branch per term.
//
// Bound: for the (16,11) RapidRAID generator (16 rows, 1,936 nonzero terms
// of 2,816) each lane costs a multiply per term, a 3-input xor per two terms
// and a mask per used (input row, bit), against k + rows lanes of HBM
// traffic: the integer pipes bound it (about 1.5 ms against 0.54 ms of HBM
// for the 704 MiB object). Design: one thread per lane, a grid-stride loop
// sized to the card's resident blocks, rows taken 16 at a time so the
// accumulators stay in registers, and each input row loaded one block of
// terms ahead of its use (kernel.encode_source). Scratch builds on the card
// found one lane a thread faster than 4 (16-byte loads) and a rolled loop
// over the input rows slower than the unrolled one; the compiler shares a
// product m * c among the rows that use it, and a product by 1 is free.

typedef unsigned int u32;

@DEFINES@

// The body is written in these macros: plain scalars, so the front end
// has no arrays or templates to take apart and its time stays small beside
// ptxas's. MASK(m, b) is m = (v >> b) & LSB, one 0/1 per packed word; T1
// adds one term a ^= m * c, T2 two folded into one 3-input xor,
// a ^= m * c ^ n * e.
#define LOAD(v, j) v = __ldg(x + (j) * Bp);
#define MASK(m, b) const u32 m = (v >> (b)) & GF_LSB;
#define T1(a, m, c) a ^= m * (c);
#define T2(a, m, c, n, e) a ^= (m * (c)) ^ (n * (e));
#define STORE(r, a) y[(r) * Bp] = a;

// one lane: x its GF_K input rows, y its GF_ROWS output rows, Bp lanes apart
__device__ __forceinline__ void encode_lane(const u32* __restrict__ x, u32* __restrict__ y,
                                            long long Bp) {
@BODY@
}

// data (O, GF_K, Bp) and out (O, GF_ROWS, Bp) int32 lanes, one lane a thread.
extern "C" __global__ void __launch_bounds__(256)
    gf_encode_kernel(const u32* __restrict__ data, u32* __restrict__ out, long long Bp, int O) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int o = 0; o < O; ++o) {
    const u32* x = data + static_cast<long long>(o) * GF_K * Bp;
    u32* y = out + static_cast<long long>(o) * GF_ROWS * Bp;
    for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < Bp;
         p += stride)
      encode_lane(x + p, y + p, Bp);
  }
}
