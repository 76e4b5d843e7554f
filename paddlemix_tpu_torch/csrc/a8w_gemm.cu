// Dynamic a8w8 and a8w4 GEMMs of Llama's projections (LLaVA's decode under
// quant="a8w8", "a8w4" and "wint4"):
//   sx[m]     = max(max_k |x[m, k]|, 1e-6) / 127
//   xq[m, k]  = clip(round_half_even(x[m, k] / sx[m]), -127, 127)
//   out[m, n] = bf16((float(sum_k xq[m, k] * w[n, k]) * sx[m]) * sw[n])
// x (M, K) bf16 row-major; sw (N,) fp32; out (M, N) bf16. N1 (a8w8) takes w
// as wq (N, K) int8; N2 (a8w4) as the packed int4 wq4 (N, K / 2) int8 whose
// byte j of row n holds w[n, j] in its low nibble and w[n, K / 2 + j] in its
// high nibble (the JAX package's halves-split packing, ops/quant.py
// quantize_weights_int4), both nibbles signed.
//
// These replace no Pallas kernel: the JAX package computes them with XLA
// dots (paddlemix_tpu/models/llama/modeling.py MXUDense, :125-171). No
// PyTorch call serves them (torch._int_mm takes no packed int4 and no single
// row), and a dequantize to bf16 followed by a matmul reads the weight 2x or
// 4x over, so they are written here. Every step rounds as the plain versions
// in ops/quant.py do: the division is __fdiv_rn (not a multiply by 1 / sx),
// the int32 sums are exact, the conversion to fp32 rounds to nearest, and
// the two scales apply in that order, so the kernels are bit-exact against
// a8w8_matmul_ref / a8w4_matmul_ref.
//
//  - decode, M = 1: a weight-streaming GEMV (`a8w_gemv_kernel`). The weight
//    bytes bound it (at (1, 4096 -> 11008), 45 MB int8 or 22.5 MB int4 against
//    2 operations a weight). Each block first reduces x's row (at most 22 KB,
//    read through L2) to its amax and quantizes it into shared memory, then
//    each warp streams 4 weight columns, every lane reading 16 bytes of each
//    column per load, 4 loads a column in flight, summed exactly by __dp4a
//    into int32. A packed int4 chunk holds 32 weights: its low nibbles pair
//    with x at k, its high nibbles with x at k + K / 2; both are sign-extended
//    to bytes in registers (an xor, an or, a subtract and an xor a word).
//  - M > 1 (the 608-row prefill): an activation pass (`a8w_quantize_rows_kernel`,
//    a block a row) writes xq and sx to scratch the wrapper allocates, then
//    the wgmma core of csrc/gemm_wg.cuh runs on the int8 operands. The int8
//    operations bound it (at (608, 4096 -> 11008), 54.8 GOP: 0.028 ms at
//    1,979 TOP/s).
//      N1: the SS form (spec DynA8W8): tiles of 128 rows of xq by BN = 256
//      or 128 weight rows, both read by descriptor from 64-byte rows in the
//      64-byte swizzle, wgmma.m64nBNk32.s32.s8.s8; the cluster's two blocks
//      share the rows of xq (TMA multicast). The epilogue converts each sum
//      and applies sx[m] (two rows a thread, in registers) then sw[n] (the
//      tile's columns through shared memory).
//      N2: B6's swapped form, out^T = W4 xq^T (spec A8W4): tiles of 128
//      weight rows by TN = 256 or 128 tokens. A stage holds 64 packed bytes
//      of each weight row (128 k) and the tile's xq at k and at K / 2 + k (64
//      bytes a token each); each consumer thread reads the words holding its
//      s8 A fragments from the packed tile and sign-extends the low nibbles
//      for the stage's first two k32 steps and the high nibbles for the last
//      two, so the weight is never unpacked in memory; xq is wgmma's B operand
//      by descriptor. The epilogue applies sw (two weight rows a thread) and
//      sx (the tile's tokens through shared memory) and stores the
//      transposed tile as B6 does.
//    TMA zero-fills reads past the operands' edges (a zero weight multiplies
//    whatever x lies there) and clips the stores.
//
// Shapes: N % 8 == 0; N1 K % 16 == 0, N2 K % 32 == 0 (16-byte rows of the
// packed weight for TMA and the GEMV's loads); the GEMV keeps x's int8 row in
// shared memory, K <= 48,128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "gemm_wg.cuh"

namespace {

using namespace wg;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// max(m, |8 bf16 values of u|)
__device__ __forceinline__ float amax8(uint4 u, float m) {
  const uint32_t w[4] = {u.x & 0x7fff7fffu, u.y & 0x7fff7fffu, u.z & 0x7fff7fffu,
                         u.w & 0x7fff7fffu};
#pragma unroll
  for (int i = 0; i < 4; ++i) m = fmaxf(m, fmaxf(bf16_lo(w[i]), bf16_hi(w[i])));
  return m;
}

// sx = max(amax, 1e-6) / 127, divided as the plain version divides
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
}

// clip(round_half_even(v / sx), -127, 127) as a byte (clipping first is equal)
__device__ __forceinline__ uint32_t q8(float v, float sx) {
  return uint32_t(__float2int_rn(fminf(fmaxf(__fdiv_rn(v, sx), -127.f), 127.f))) & 0xffu;
}

// 8 bf16 -> 8 int8, the first in the lowest byte
__device__ __forceinline__ uint2 quantize8(uint4 u, float sx) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    r[h] = q8(bf16_lo(w[2 * h]), sx) | q8(bf16_hi(w[2 * h]), sx) << 8 |
           q8(bf16_lo(w[2 * h + 1]), sx) << 16 | q8(bf16_hi(w[2 * h + 1]), sx) << 24;
  return make_uint2(r[0], r[1]);
}

// The max over the block (blockDim.x a multiple of 32, at most 1,024), in every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < int(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Row x (K bf16, K % 8 == 0) -> its sx, and the row quantized into dst (K int8).
__device__ __forceinline__ float quantize_row(const __nv_bfloat16* x, int K, uint2* dst,
                                              float* red) {
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  const int chunks = K >> 3;
  float m = 0.f;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) m = amax8(__ldg(x16 + c), m);
  const float sx = row_scale(block_max(m, red));
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = quantize8(__ldg(x16 + c), sx);
  return sx;
}

// Each byte of w's low (HI false) or high (HI true) nibbles, sign-extended:
// with b the nibble, ((b ^ 8) | 0x80) - 8 never borrows across bytes, and
// the final xor leaves b - 16 * (b >= 8).
template <bool HI>
__device__ __forceinline__ uint32_t nibbles(uint32_t w) {
  const uint32_t b = (HI ? w >> 4 : w) & 0x0f0f0f0fu;
  return (((b ^ 0x08080808u) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

__device__ __forceinline__ int dp4a(uint32_t a, uint32_t b, int c) {
  return __dp4a(int(a), int(b), c);
}

// ----------------------------------------------------- the activation pass
constexpr int AQ_THREADS = 256;

// Block m: row m of x -> xq[m, :] and sx[m].
__global__ void __launch_bounds__(AQ_THREADS)
a8w_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int K) {
  __shared__ float red[AQ_THREADS / 32];
  const size_t row = blockIdx.x;
  const float s = quantize_row(x + row * K, K, reinterpret_cast<uint2*>(xq + row * K), red);
  if (threadIdx.x == 0) sx[row] = s;
}

// ------------------------------------------------------------------ GEMV
constexpr int GV_WARPS = 8, GV_COLS = 4, GV_U = 4;
constexpr int GV_MAX_K = 48128;  // x's int8 row in (non-opted) shared memory, beside `red`

template <bool INT4>
__global__ void __launch_bounds__(GV_WARPS * 32)
a8w_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int N, int K) {
  extern __shared__ __align__(16) uint8_t xs[];  // K bytes
  __shared__ float red[GV_WARPS];
  const float sx = quantize_row(x, K, reinterpret_cast<uint2*>(xs), red);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * GV_WARPS + warp) * GV_COLS;
  if (n0 >= N) return;  // N % 8 == 0: the warp's 4 columns are all inside
  const int row_bytes = INT4 ? K / 2 : K;
  const int kc = row_bytes >> 4;  // 16-byte chunks of a weight column
  const uint4* wcol = reinterpret_cast<const uint4*>(w + (size_t)n0 * row_bytes);
  const uint4* x_lo = reinterpret_cast<const uint4*>(xs);
  const uint4* x_hi = reinterpret_cast<const uint4*>(xs + row_bytes);  // INT4: x at K / 2 + k
  int acc[GV_COLS];
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) acc[j] = 0;

  for (int c0 = lane; c0 < kc; c0 += 32 * GV_U) {
    uint4 wv[GV_U][GV_COLS];
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int c = c0 + 32 * u;
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j)
        wv[u][j] = c < kc ? __ldg(wcol + (size_t)j * kc + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int c = c0 + 32 * u;
      if (c >= kc) break;
      const uint4 xa = x_lo[c];
      const uint32_t xl[4] = {xa.x, xa.y, xa.z, xa.w};
      uint32_t xh[4] = {0, 0, 0, 0};
      if constexpr (INT4) {
        const uint4 xb = x_hi[c];
        xh[0] = xb.x, xh[1] = xb.y, xh[2] = xb.z, xh[3] = xb.w;
      }
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j) {
        const uint32_t ww[4] = {wv[u][j].x, wv[u][j].y, wv[u][j].z, wv[u][j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (INT4) {
            acc[j] = dp4a(nibbles<false>(ww[q]), xl[q], acc[j]);
            acc[j] = dp4a(nibbles<true>(ww[q]), xh[q], acc[j]);
          } else {
            acc[j] = dp4a(ww[q], xl[q], acc[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane < GV_COLS) {
    int v = acc[0];
#pragma unroll
    for (int j = 1; j < GV_COLS; ++j) v = lane == j ? acc[j] : v;
    out[n0 + lane] =
        __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(v), sx), sw[n0 + lane]));
  }
}

// ------------------------------------------------ N1 tiled: the SS form
template <int BN>
struct DynA8W8 {
  static constexpr bool SS = true;                          // both operands by descriptor
  static constexpr int SPS = 2;                             // k32 steps a stage
  static constexpr uint32_t X_BYTES = 128 * 64;             // 128 rows of xq x 64 bytes
  static constexpr uint32_t STAGE_BYTES = X_BYTES + BN * 64;  // + BN weight rows x 64 bytes
  static constexpr uint32_t TILE_BYTES = 64 * BN * 2;       // a warpgroup's 64 rows x BN bf16
  // + the tile's column scales; 1,024-byte aligned
  static constexpr uint32_t OUT_BYTES = (TILE_BYTES + BN * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = int[BN / 2];

  struct Params {
    CUtensorMap x, w, out;
    gemm::Walk walk;  // outer: 128-row blocks of xq, inner: BN-wide column blocks, in pairs
    const float* sx;
    const float* sw;
    int m, n;
  };

  // xq: this block's 64 of the tile's 128 rows, into both blocks of the
  // cluster (their tiles share the rows); the weight: this block's own tile.
  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    tma_load_2d_multicast(st + rank * (X_BYTES / 2), &p.x, bar, kb * gemm::BK,
                          outer * 128 + 64 * rank, 0x3);
    tma_load_2d(st + X_BYTES, &p.w, bar, kb * gemm::BK, inner * BN);
  }

  // k32 step s: the warpgroup's 64 rows of xq by the tile's BN weight rows,
  // both 64-byte rows in the 64-byte swizzle.
  __device__ static void mma(Acc& acc, uint32_t st, int s, int accumulate,
                             const gemm::Thread& th) {
    wgmma_s8_ss<BN>(acc, smem_desc_sw64(st + th.wg * (X_BYTES / 2) + 32 * s),
                    smem_desc_sw64(st + X_BYTES + 32 * s), accumulate);
  }

  // The columns' sw, two a thread (n0 + 2 tid, + 1), and the thread's two
  // rows' sx (16 warp + g and + 8 of the warpgroup's 64).
  struct Pre {
    float2 w;
    float x0, x1;
  };

  __device__ static Pre prefetch(const Params& p, int outer, int inner, const gemm::Thread& th,
                                 const gemm::Staging&) {
    Pre pre{make_float2(0.f, 0.f), 0.f, 0.f};
    const int n = inner * BN + 2 * th.tid;
    if (2 * th.tid < BN && n < p.n)  // N % 8 == 0: n + 1 is inside too
      pre.w = __ldg(reinterpret_cast<const float2*>(p.sw + n));
    const int r = outer * 128 + 64 * th.wg + 16 * th.warp + th.g;
    if (r < p.m) pre.x0 = __ldg(p.sx + r);
    if (r + 8 < p.m) pre.x1 = __ldg(p.sx + r + 8);
    return pre;
  }

  // acc register 4j + 2r + e holds row 16 warp + g + 8r, column n0 + 8j +
  // 2t + e; v = (float(acc) * sx[row]) * sw[column], stored as bf16 into BN /
  // 64 panels of 64 rows x 128 bytes in the 128-byte swizzle (B2's layout),
  // one stmatrix per two 8-column groups.
  __device__ static void stage_out(Acc& acc, const Pre& pre, uint32_t out, const Params&, int,
                                   int, const gemm::Thread& th) {
    const uint32_t cols = out + TILE_BYTES;
    if (2 * th.tid < BN)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 8 * th.tid), "f"(pre.w.x),
                   "f"(pre.w.y) : "memory");
    sync_warpgroup(1 + th.wg);
    const int mi = th.lane >> 3, c = th.lane & 7;  // the matrix and row this lane addresses
    const uint32_t row = out + (16 * th.warp + 8 * (mi & 1) + c) * 128;
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      uint32_t r[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * jj + h;
        const uint2 su = lds64(cols + 32 * j + 8 * th.t);
        const float s[2] = {__uint_as_float(su.x), __uint_as_float(su.y)};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float sx = rr ? pre.x1 : pre.x0;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * rr + e]), sx), s[e]);
          r[2 * h + rr] = pack_bf16(v[0], v[1]);
        }
      }
      const int j = 2 * jj + (mi >> 1);
      stmatrix4<false>(row + (j >> 3) * 8192 + (((j & 7) ^ c) << 4), r);
    }
  }

  __device__ static void store(const Params& p, uint32_t out, int outer, int inner, int wg) {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      tma_store_2d(&p.out, out + q * 8192, inner * BN + 64 * q, outer * 128 + 64 * wg);
  }
};

// ---------------------------------------- N2 tiled: B6's swapped RS form
template <int TN>
struct A8W4 {
  static constexpr bool SS = false;                 // A built in registers
  static constexpr int SPS = 4;                     // k32 steps a stage: 2 low, 2 high nibbles
  static constexpr uint32_t BOX_BYTES = TN * 64;    // TN tokens x 64 bytes of xq
  static constexpr uint32_t X_BYTES = 2 * BOX_BYTES;  // at k and at K / 2 + k
  static constexpr int X_LO = 8 * ((TN + 15) / 16);   // the tokens block 0 of a cluster loads
  static constexpr uint32_t STAGE_BYTES = X_BYTES + 128 * 64;  // + 128 weight rows x 64 bytes
  static constexpr uint32_t TILE_BYTES = TN * 128;  // TN tokens x a warpgroup's 64 columns
  // + the tile's token scales; 1,024-byte aligned
  static constexpr uint32_t OUT_BYTES = (TILE_BYTES + TN * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = int[TN / 2];

  struct Params {
    CUtensorMap x_lo, x_hi, w, out;  // x_lo / x_hi: the first X_LO / the other tokens of a tile
    gemm::Walk walk;  // outer: 128-row blocks of the weight, in pairs; inner: TN-token blocks
    const float* sx;
    const float* sw;
    int m, n, half_k;
  };

  // xq at k = 64 kb (the low nibbles' k) and at K / 2 + 64 kb (the high
  // nibbles'): block 0 of the cluster loads the tile's first X_LO tokens of
  // both, block 1 the rest, each into both blocks; the packed weight: this
  // block's own tile, packed bytes 64 kb .. + 63.
  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    const int k = kb * gemm::BK, t0 = inner * TN + (rank ? X_LO : 0);
    const CUtensorMap* map = rank ? &p.x_hi : &p.x_lo;
    const uint32_t off = rank ? X_LO * 64 : 0;
    tma_load_2d_multicast(st + off, map, bar, k, t0, 0x3);
    tma_load_2d_multicast(st + BOX_BYTES + off, map, bar, p.half_k + k, t0, 0x3);
    tma_load_2d(st + X_BYTES, &p.w, bar, k, outer * 128);
  }

  // The s8 A fragment of k32 step s: weight rows r0 = 64 wg + 16 warp + g and
  // r0 + 8, packed bytes 32 (s % 2) + 4t .. + 3 (registers 0, 1) and + 16
  // (registers 2, 3) of the stage's 64-byte rows (16-byte chunk c of row r
  // at c ^ ((r / 2) % 4)); steps 0, 1 take their low nibbles, 2, 3 their high.
  __device__ static void build(uint32_t (&a)[4], uint32_t st, int s, const Params&,
                               const gemm::Thread& th) {
    const uint32_t row = st + X_BYTES + (64 * th.wg + 16 * th.warp + th.g) * 64 + 4 * th.t;
    const int c0 = 2 * (s & 1), swz = th.g >> 1;
    const uint32_t lo = (c0 ^ swz) << 4, hi = ((c0 + 1) ^ swz) << 4;
    const uint32_t w[4] = {lds32(row + lo), lds32(row + 512 + lo), lds32(row + hi),
                           lds32(row + 512 + hi)};
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s < 2 ? nibbles<false>(w[i]) : nibbles<true>(w[i]);
  }

  __device__ static void mma(Acc& acc, const uint32_t (&a)[4], uint32_t st, int s,
                             int accumulate) {
    wgmma_s8<TN>(acc, a, smem_desc_sw64(st + (s >> 1) * BOX_BYTES + 32 * (s & 1)), accumulate);
  }

  // The scales of this thread's two weight rows (16 warp + g and + 8), and sx
  // of tokens tid and tid + 128 of the tile.
  struct Pre {
    float s0, s1, x0, x1;
  };

  __device__ static Pre prefetch(const Params& p, int outer, int inner, const gemm::Thread& th,
                                 const gemm::Staging&) {
    Pre pre{0.f, 0.f, 0.f, 0.f};
    const int n = outer * 128 + 64 * th.wg + 16 * th.warp + th.g;
    if (n < p.n) pre.s0 = __ldg(p.sw + n);
    if (n + 8 < p.n) pre.s1 = __ldg(p.sw + n + 8);
    const int m = inner * TN + th.tid;
    if (th.tid < TN && m < p.m) pre.x0 = __ldg(p.sx + m);
    if (th.tid + 128 < TN && m + 128 < p.m) pre.x1 = __ldg(p.sx + m + 128);
    return pre;
  }

  // acc register 4j + 2r + e holds weight row 16 warp + g + 8r, token 8j +
  // 2t + e; v = (float(acc) * sx[token]) * sw[row], stored transposed by
  // stmatrix.trans into TN token rows of 128 bytes in the 128-byte swizzle
  // (B6's layout), so out stays (M, N) row-major.
  __device__ static void stage_out(Acc& acc, const Pre& pre, uint32_t out, const Params&, int,
                                   int, const gemm::Thread& th) {
    const uint32_t xs = out + TILE_BYTES;
    if (th.tid < TN)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(xs + 4 * th.tid), "f"(pre.x0) : "memory");
    if (th.tid + 128 < TN)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(xs + 4 * (th.tid + 128)), "f"(pre.x1)
                   : "memory");
    sync_warpgroup(1 + th.wg);
    const int mi = th.lane >> 3, c = th.lane & 7;  // the matrix and row this lane addresses
    const uint32_t chunk = 2 * th.warp + (mi & 1);
    const auto packed = [&](int j, int rr) {
      const uint2 xu = lds64(xs + 4 * (8 * j + 2 * th.t));
      const float s = rr ? pre.s1 : pre.s0;
      return pack_bf16(
          __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * rr]), __uint_as_float(xu.x)), s),
          __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * rr + 1]), __uint_as_float(xu.y)),
                    s));
    };
#pragma unroll
    for (int jj = 0; jj < TN / 16; ++jj) {
      const uint32_t r[4] = {packed(2 * jj, 0), packed(2 * jj, 1), packed(2 * jj + 1, 0),
                             packed(2 * jj + 1, 1)};
      const int m = 8 * (2 * jj + (mi >> 1)) + c;
      stmatrix4<true>(out + m * 128 + ((chunk ^ c) << 4), r);
    }
  }

  __device__ static void store(const Params& p, uint32_t out, int outer, int inner, int wg) {
    tma_store_2d(&p.out, out, outer * 128 + 64 * wg, inner * TN);
  }
};

static_assert(A8W4<128>::X_LO * 64 % 512 == 0 && A8W4<256>::X_LO * 64 % 512 == 0,
              "a multicast half must start on a 64-byte swizzle atom");

template <class S>
__global__ void __cluster_dims__(gemm::CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
a8w_gemm_wgmma_kernel(const __grid_constant__ typename S::Params p) {
  gemm::run<S>(p);
}

// Opts the kernel into its shared memory, once.
template <class S>
cudaError_t prepare() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(a8w_gemm_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(gemm::Layout<S>::BYTES));
  return attr;
}

template <class S>
int max_clusters() {
  return prepare<S>() == cudaSuccess
             ? gemm::max_clusters(a8w_gemm_wgmma_kernel<S>, gemm::Layout<S>::BYTES)
             : 0;
}

constexpr int KIND_A8W8 = 0, KIND_A8W4 = 1;

// The walk of kind's tiled path at (M, N, K) and tile width `tile`:
// {unit_inner, units, k_blocks, pair_inner}.
gemm::Walk walk_of(int kind, int M, int N, int K, int tile) {
  if (kind == KIND_A8W8) {
    const int unit_inner = ((N + tile - 1) / tile + 1) / 2;  // pairs of column blocks
    return {unit_inner, (M + 127) / 128 * unit_inner, (K + gemm::BK - 1) / gemm::BK, 1};
  }
  const int m_tiles = (M + tile - 1) / tile;  // pairs of weight blocks x token blocks
  return {m_tiles, ((N + 127) / 128 + 1) / 2 * m_tiles, (K / 2 + gemm::BK - 1) / gemm::BK, 0};
}

template <int BN>
int launch_a8w8(const void* xq, const void* sx, const void* wq, const void* sw, void* out, int M,
                int N, int K, int grid, cudaStream_t stream) {
  using S = DynA8W8<BN>;
  const cudaError_t attr = prepare<S>();
  if (attr != cudaSuccess) return int(attr);
  typename S::Params p;
  CUresult res = make_map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, uint64_t(K),
                             gemm::BK, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K, uint64_t(K), gemm::BK, BN,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, uint64_t(N) * 2, 64,
                      64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  p.walk = walk_of(KIND_A8W8, M, N, K, BN);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.m = M;
  p.n = N;
  a8w_gemm_wgmma_kernel<S><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}

template <int TN>
int launch_a8w4(const void* xq, const void* sx, const void* wq, const void* sw, void* out, int M,
                int N, int K, int grid, cudaStream_t stream) {
  using S = A8W4<TN>;
  const cudaError_t attr = prepare<S>();
  if (attr != cudaSuccess) return int(attr);
  typename S::Params p;
  CUresult res = make_map_2d(&p.x_lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, uint64_t(K),
                             gemm::BK, S::X_LO, CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.x_hi, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, uint64_t(K), gemm::BK,
                      TN - S::X_LO, CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K / 2, uint64_t(K / 2),
                      gemm::BK, 128, CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, uint64_t(N) * 2, 64,
                      TN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  p.walk = walk_of(KIND_A8W4, M, N, K, TN);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.m = M;
  p.n = N;
  p.half_k = K / 2;
  a8w_gemm_wgmma_kernel<S><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}

int quantize_rows(const void* x, void* xq, void* sx, int M, int K, cudaStream_t s) {
  a8w_quantize_rows_kernel<<<M, AQ_THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<int8_t*>(xq),
                                                static_cast<float*>(sx), K);
  return int(cudaGetLastError());
}

int run_gemm(int kind, const void* x, const void* wq, const void* sw, void* out, void* xq, void* sx,
         int M, int N, int K, int tile, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  if (K % (kind == KIND_A8W4 ? 32 : 16) != 0 || N % 8 != 0) return int(cudaErrorInvalidValue);
  if (M == 1) {
    if (K > GV_MAX_K) return int(cudaErrorInvalidValue);
    const int cols = GV_WARPS * GV_COLS;
    const auto kernel = kind == KIND_A8W4 ? a8w_gemv_kernel<true> : a8w_gemv_kernel<false>;
    kernel<<<(N + cols - 1) / cols, GV_WARPS * 32, K, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(sw), static_cast<__nv_bfloat16*>(out), N, K);
    return int(cudaGetLastError());
  }
  if (grid < 1 || grid % gemm::CLUSTER != 0 || xq == nullptr || sx == nullptr)
    return int(cudaErrorInvalidValue);
  if (tile != 256 && tile != 128) return int(cudaErrorInvalidValue);
  const int err = quantize_rows(x, xq, sx, M, K, s);
  if (err) return err;
  if (kind == KIND_A8W8)
    return tile == 256 ? launch_a8w8<256>(xq, sx, wq, sw, out, M, N, K, grid, s)
                       : launch_a8w8<128>(xq, sx, wq, sw, out, M, N, K, grid, s);
  return tile == 256 ? launch_a8w4<256>(xq, sx, wq, sw, out, M, N, K, grid, s)
                     : launch_a8w4<128>(xq, sx, wq, sw, out, M, N, K, grid, s);
}

template <class S>
void layout_of(int* out) {
  out[4] = S::STAGES;
  out[5] = int(gemm::Layout<S>::BYTES);
}

}  // namespace

// The activation pass alone: x (M, K) bf16 -> xq (M, K) int8 and sx (M,)
// fp32, K % 8 == 0. Returns the cudaError_t of the launch.
extern "C" int a8w_quantize_rows(const void* x, void* xq, void* sx, int M, int K, void* stream) {
  if (M == 0) return 0;
  if (K % 8 != 0) return int(cudaErrorInvalidValue);
  return quantize_rows(x, xq, sx, M, K, static_cast<cudaStream_t>(stream));
}

// N1: x (M, K) bf16, wq (N, K) int8, sw (N,) fp32, out (M, N) bf16, all
// contiguous and 16-byte aligned; K % 16 == 0, N % 8 == 0. M == 1 runs the
// GEMV (K <= 48,128); any other M the activation pass into xq (M, K) int8 and
// sx (M,) fp32, which the caller provides, then the tiled path at an N tile
// of `tile` (256 or 128) with `grid` blocks (ops/gemm_tiles.py picks both).
// Returns the cudaError_t of the launch (0 on success), or 10000 + the
// CUresult of a tensor map that libcuda refused.
extern "C" int a8w8_gemm_bf16(const void* x, const void* wq, const void* sw, void* out, void* xq,
                              void* sx, int M, int N, int K, int tile, int grid, void* stream) {
  return run_gemm(KIND_A8W8, x, wq, sw, out, xq, sx, M, N, K, tile, grid, stream);
}

// N2: as N1 with wq4 (N, K / 2) packed int4 and K % 32 == 0; `tile` is the
// token tile (256 or 128).
extern "C" int a8w4_gemm_bf16(const void* x, const void* wq4, const void* sw, void* out,
                              void* xq, void* sx, int M, int N, int K, int tile, int grid,
                              void* stream) {
  return run_gemm(KIND_A8W4, x, wq4, sw, out, xq, sx, M, N, K, tile, grid, stream);
}

// The 2-block clusters of N1's / N2's tiled path at a tile of `tile` that
// fit on the card at once (0 if not compiled or the query fails).
extern "C" int a8w8_gemm_max_clusters(int tile) {
  return tile == 256 ? max_clusters<DynA8W8<256>>()
         : tile == 128 ? max_clusters<DynA8W8<128>>()
                       : 0;
}

extern "C" int a8w4_gemm_max_clusters(int tile) {
  return tile == 256 ? max_clusters<A8W4<256>>() : tile == 128 ? max_clusters<A8W4<128>>() : 0;
}

// The plan the tiled path of `kind` (0 N1, 1 N2) runs at (M, N, K) and a
// tile of `tile`: out = {unit_inner, units, k_blocks, pair_inner, ring
// stages, dynamic shared memory of a block}. Returns 0, or 1 for a tile that
// is not compiled. ops/gemm_tiles.py mirrors it.
extern "C" int a8w_gemm_plan(int kind, int M, int N, int K, int tile, int* out) {
  if (tile != 256 && tile != 128) return 1;
  const gemm::Walk w = walk_of(kind, M, N, K, tile);
  out[0] = w.unit_inner;
  out[1] = w.units;
  out[2] = w.k_blocks;
  out[3] = w.pair_inner;
  if (kind == KIND_A8W8)
    tile == 256 ? layout_of<DynA8W8<256>>(out) : layout_of<DynA8W8<128>>(out);
  else
    tile == 256 ? layout_of<A8W4<256>>(out) : layout_of<A8W4<128>>(out);
  return 0;
}
