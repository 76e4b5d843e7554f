// Weight-only int8 GEMM (B6):
//   out[m, n] = bf16(scale[n] * sum_k x[m, k] * wq[n, k])
// x (M, K) bf16 row-major, wq (N, K) int8 (K-contiguous per output column),
// scale (N,) fp32, out (M, N) bf16; the sum is taken in fp32 over exact
// products (a bf16 value times an int8 value needs 15 significant bits).
//
// Replaces the Pallas kernel wint8_matmul / _wint8_kernel
// (paddlemix_tpu/ops/quant.py), which widened each int8 weight tile to bf16
// in VMEM and accumulated bf16 x bf16 products in fp32 across a sequential K
// grid axis. Here one source serves the two shapes Llama's projections see:
//
//  - decode, M = 1 (Llama at batch 1): a weight-streaming GEMV. The
//    weight bytes bound it (1 byte a weight, 2 flops a byte at M = 1), so
//    each warp streams 4 output columns, every lane reading 16 int8 weights
//    of each column per 16-byte load, 4 loads a column in flight, and sums in
//    fp32 registers; x (a few KB) is read through the L1 cache. An int8 byte
//    becomes an fp32 value without a conversion instruction: its biased byte
//    is placed in the mantissa of 2^23 (one byte permute) and 2^23 + 128 is
//    subtracted (one add), which is exact. A warp reduce and x scale end the
//    column.
//  - every other M (prefill: M = 608 at the LLaVA bench's prompt): a tiled GEMM on
//    the tensor cores, mma.sync.m16n8k16 bf16 with fp32 accumulators, a
//    128 x 128 output tile per block of 8 warps (each 64 x 32), K 32 at a
//    time through two shared-memory stages fed from registers. The int8 tile
//    is widened to bf16 (exact) as it is stored to shared memory, so weights
//    cross device memory as int8. At M = 608 the product is above the bf16
//    ridge; mma.sync and the register-staged pipeline leave it well below
//    the tensor-core peak (wgmma + TMA is the later step).
//
// Ragged edges: rows past M and columns past N are masked; K must be a
// multiple of 16 (whole 16-byte chunks of both operands) and N of 8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "int8_mma.cuh"

using i8mma::bf16_hi;
using i8mma::bf16_lo;
using i8mma::ldsm_x4;

namespace {

// 4 int8 (little-endian in w) -> 4 exact fp32 values
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // byte b + 128, unsigned
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
}

// two fp32 values that are exact in bf16 -> bf16x2 (a in the low half)
__device__ __forceinline__ uint32_t pack_exact_bf16x2(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// ------------------------------------------------------------------ GEMV
constexpr int GV_WARPS = 8, GV_COLS = 4, GV_U = 4;

__global__ void __launch_bounds__(GV_WARPS * 32)
wint8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int N,
                  int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * GV_WARPS + warp) * GV_COLS;
  if (n0 >= N) return;  // N % 8 == 0: the warp's 4 columns are all inside
  const int kc = K >> 4;  // 16-byte chunks of a weight column
  const uint4* wcol = reinterpret_cast<const uint4*>(wq + (size_t)n0 * K);
  const uint4* x16 = reinterpret_cast<const uint4*>(x);  // 8 bf16 a chunk
  float acc[GV_COLS];
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) acc[j] = 0.f;

  for (int c0 = lane; c0 < kc; c0 += 32 * GV_U) {
    uint4 w[GV_U][GV_COLS];
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int c = c0 + 32 * u;
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j)
        w[u][j] = c < kc ? __ldg(wcol + (size_t)j * kc + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int c = c0 + 32 * u;
      if (c >= kc) break;
      const uint4 xa = __ldg(x16 + 2 * c);
      const uint4 xb = __ldg(x16 + 2 * c + 1);
      const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j) {
        const uint32_t ww[4] = {w[u][j].x, w[u][j].y, w[u][j].z, w[u][j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[4];
          i8x4_to_f32(ww[q], f);
          acc[j] = fmaf(bf16_lo(xw[2 * q]), f[0], acc[j]);
          acc[j] = fmaf(bf16_hi(xw[2 * q]), f[1], acc[j]);
          acc[j] = fmaf(bf16_lo(xw[2 * q + 1]), f[2], acc[j]);
          acc[j] = fmaf(bf16_hi(xw[2 * q + 1]), f[3], acc[j]);
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
    float v = acc[0];
#pragma unroll
    for (int j = 1; j < GV_COLS; ++j) v = lane == j ? acc[j] : v;
    out[n0 + lane] = __float2bfloat16(v * scale[n0 + lane]);
  }
}

// ------------------------------------------------------------ tiled GEMM
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDS = BK * 2 + 16;  // bytes per shared-memory row (32 bf16 + 16 pad)
constexpr int SMEM_BYTES = 2 * (BM + BN) * LDS;  // 40,960

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 2)
wint8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                  int N, int K) {
  __shared__ __align__(16) char smem[SMEM_BYTES];
  char* As = smem;                  // [2][BM][LDS], bf16 x
  char* Bs = smem + 2 * BM * LDS;   // [2][BN][LDS], bf16 widened weights
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // A: two 8-value chunks a thread (row c >> 2, column (c & 3) * 8);
  // B: one 16-byte int8 chunk a thread (column tid >> 1, k (tid & 1) * 16)
  uint4 ra[2], rb;
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS, m = m0 + (c >> 2), k = kt * BK + (c & 3) * 8;
      ra[i] = (m < M && k < K) ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k))
                               : make_uint4(0, 0, 0, 0);
    }
    const int n = n0 + (tid >> 1), k = kt * BK + (tid & 1) * 16;
    rb = (n < N && k < K) ? __ldg(reinterpret_cast<const uint4*>(wq + (size_t)n * K + k))
                          : make_uint4(0, 0, 0, 0);
  };
  auto store = [&](int stage) {
    char* as = As + stage * BM * LDS;
    char* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(as + (c >> 2) * LDS + (c & 3) * 16) = ra[i];
    }
    const uint32_t words[4] = {rb.x, rb.y, rb.z, rb.w};
    uint32_t p[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float f[4];
      i8x4_to_f32(words[w], f);
      p[2 * w] = pack_exact_bf16x2(f[0], f[1]);
      p[2 * w + 1] = pack_exact_bf16x2(f[2], f[3]);
    }
    char* row = bs + (tid >> 1) * LDS + (tid & 1) * 32;
    *reinterpret_cast<uint4*>(row) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(row + 16) = make_uint4(p[4], p[5], p[6], p[7]);
  };

  const int ktiles = (K + BK - 1) / BK;
  fetch(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) fetch(kt + 1);
    const char* as = As + stage * BM * LDS;
    const char* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK * 2; ks += 32) {  // two k16 steps of 32 bytes
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * LDS + ks + (lane >> 4) * 16);
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t r[4];
        ldsm_x4(r, bs + (wn + ni * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks +
                       ((lane >> 3) & 1) * 16);
        bfr[ni][0] = r[0];
        bfr[ni][1] = r[1];
        bfr[ni + 1][0] = r[2];
        bfr[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < ktiles) store(stage ^ 1);
    __syncthreads();
  }

  // acc[mi][ni][r]: row g (r < 2) or g + 8, column 2t + (r & 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn + ni * 8 + 2 * t;
    if (n >= N) continue;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h] * s0, acc[mi][ni][2 * h + 1] * s1);
      }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int wint8_gemm_bf16(const void* x, const void* wq, const void* scale, void* out,
                               int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (M == 0) return 0;
  if (M == 1) {
    const int cols = GV_WARPS * GV_COLS;
    wint8_gemv_kernel<<<(N + cols - 1) / cols, GV_WARPS * 32, 0, s>>>(xb, w, sc, o, N, K);
    return cudaGetLastError();
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wint8_gemm_kernel<<<grid, THREADS, 0, s>>>(xb, w, sc, o, M, N, K);
  return cudaGetLastError();
}
