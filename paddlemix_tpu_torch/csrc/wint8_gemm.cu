// Weight-only int8 GEMM (B6):
//   out[m, n] = bf16(scale[n] * sum_k x[m, k] * wq[n, k])
// x (M, K) bf16 row-major, wq (N, K) int8 (K-contiguous per output column),
// scale (N,) fp32, out (M, N) bf16; the sum is taken in fp32 over exact
// products (a bf16 value times an int8 value needs 15 significant bits).
//
// Replaces the Pallas kernel wint8_matmul / _wint8_kernel
// (paddlemix_tpu/ops/quant.py, pallas_call at :462), which widened each int8
// weight tile to bf16 in VMEM and accumulated bf16 x bf16 products in fp32
// across a sequential K grid axis. Here one source serves the two shapes
// Llama's projections see:
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
//  - every other M (prefill: M = 608 at the LLaVA bench's prompt): the wgmma
//    core of csrc/gemm_wg.cuh with the operands swapped, out^T = Wq x^T, so
//    that the weight, which must be widened, is the A operand that wgmma takes
//    from registers. At M = 608 the bf16 operations bound it (0.055 ms at
//    989 TFLOP/s for 4096 -> 11008; the 45 MB of int8 weights take 0.014 ms).
//    A tile is 128 weight rows (64 a consumer warpgroup) x TN tokens, TN one
//    of 64, 128, 152, 208, 256 (wgmma's N; ops/gemm_tiles.py picks it per
//    shape: 608 = 3 x 208 or 4 x 152 fills 132 SMs in whole waves), and the
//    two blocks of a cluster take neighbouring weight tiles, which read the
//    same tokens; each stage holds x as K-major bf16 (TMA multicast,
//    128-byte swizzle), read by descriptor, and the int8 weight tile (64-byte
//    swizzle). Each consumer thread reads the 4-byte words holding its A
//    fragments' bytes of a stage's four k16 steps and widens them to bf16 by
//    the same byte-permute trick (exact) while the previous stage's
//    wgmma.m64nTNk16 run. The epilogue scales the fp32 sums by scale[n] (one
//    value a row of the transposed tile, loaded when the tile begins), rounds
//    to bf16 and stores them transposed by stmatrix.trans, so out stays
//    (M, N) row-major, then by TMA. Widening the weight tile into shared
//    memory in the producer warpgroup's other three warps, for SS products,
//    measured slower on an H100: those warps could not keep up.
//
// Shapes: K % 16 == 0 (16-byte rows for the GEMV's loads and TMA) and
// N % 8 == 0; TMA zero-fills the ragged edges of the tiled path and clips its
// stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "gemm_wg.cuh"

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 4 int8 (little-endian in w) -> 4 exact fp32 values
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // byte b + 128, unsigned
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
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

// ----------------------------------------------------------- tiled GEMM
using namespace wg;

// Bytes i and i + 1 of w (sel = 0x7650 + i) -> bf16x2, the first in the low
// half: each byte becomes an exact fp32 value (see i8x4_to_f32), whose upper
// half is its bf16.
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <int TN>
struct Wint8 {
  static constexpr bool SS = false;  // A built in registers
  static constexpr int SPS = 4;                              // k16 steps a stage
  static constexpr uint32_t X_BYTES = TN * 128;              // TN tokens x 64 bf16
  static constexpr int X_LO = 8 * ((TN + 15) / 16);          // the tokens block 0 of a cluster loads
  static constexpr uint32_t STAGE_BYTES = X_BYTES + 128 * 64;  // + 128 weight rows x 64 bytes
  static constexpr uint32_t OUT_BYTES = TN * 128;            // TN tokens x a warpgroup's 64 columns
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = float[TN / 2];

  struct Params {
    CUtensorMap x_lo, x_hi, w, out;  // x_lo / x_hi: the first X_LO / the other tokens of a tile
    gemm::Walk walk;  // outer: 128-row blocks of the weight, in pairs; inner: TN-token blocks
    const float* scale;
    int n;
  };

  // x: block 0 of the cluster loads the tile's first X_LO tokens, block 1 the
  // rest, each into both blocks (their tiles share the tokens); the weight:
  // this block's own tile.
  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    if (rank == 0)
      tma_load_2d_multicast(st, &p.x_lo, bar, kb * gemm::BK, inner * TN, 0x3);
    else
      tma_load_2d_multicast(st + X_LO * 128, &p.x_hi, bar, kb * gemm::BK, inner * TN + X_LO, 0x3);
    tma_load_2d(st + X_BYTES, &p.w, bar, kb * gemm::BK, outer * 128);
  }

  // The A fragment of k16 step s: weight rows r0 = 64 wg + 16 warp + g and
  // r0 + 8, bytes 16 s + 2t, + 1 (registers 0, 1) and 16 s + 8 + 2t, + 1
  // (registers 2, 3) of the stage's 64-byte rows (16-byte chunk c of row r at
  // c ^ ((r / 2) % 4)), widened to bf16.
  __device__ static void build(uint32_t (&a)[4], uint32_t st, int s, const Params&,
                               const gemm::Thread& th) {
    const uint32_t row = st + X_BYTES + (64 * th.wg + 16 * th.warp + th.g) * 64 +
                         ((s ^ (th.g >> 1)) << 4) + 4 * (th.t >> 1);
    const uint32_t sel = 0x7650 + 2 * (th.t & 1);
    a[0] = widen2(lds32(row), sel);
    a[1] = widen2(lds32(row + 512), sel);
    a[2] = widen2(lds32(row + 8), sel);
    a[3] = widen2(lds32(row + 512 + 8), sel);
  }

  __device__ static void mma(Acc& acc, const uint32_t (&a)[4], uint32_t st, int s,
                             int accumulate) {
    wgmma_bf16<TN>(acc, a, smem_desc(st + 32 * s, 16, 1024), accumulate);
  }

  // The scales of this thread's two weight rows, 16 warp + g and + 8.
  struct Pre {
    float s0, s1;
  };

  __device__ static Pre prefetch(const Params& p, int outer, int, const gemm::Thread& th,
                                 const gemm::Staging&) {
    const int n = outer * 128 + 64 * th.wg + 16 * th.warp + th.g;
    return {n < p.n ? __ldg(p.scale + n) : 0.f, n + 8 < p.n ? __ldg(p.scale + n + 8) : 0.f};
  }

  __device__ static void stage_out(Acc& acc, const Pre& pre, uint32_t out, const Params&, int,
                                   int, const gemm::Thread& th) {
    const float s0 = pre.s0, s1 = pre.s1;
    const int mi = th.lane >> 3, c = th.lane & 7;  // the matrix and row this lane addresses
    const uint32_t chunk = 2 * th.warp + (mi & 1);
    const auto packed = [&](int j, int rr) {
      const float s = rr ? s1 : s0;
      return pack_bf16(acc[4 * j + 2 * rr] * s, acc[4 * j + 2 * rr + 1] * s);
    };
#pragma unroll
    for (int jj = 0; jj < TN / 16; ++jj) {
      const uint32_t r[4] = {packed(2 * jj, 0), packed(2 * jj, 1), packed(2 * jj + 1, 0),
                             packed(2 * jj + 1, 1)};
      const int m = 8 * (2 * jj + (mi >> 1)) + c;
      stmatrix4<true>(out + m * 128 + ((chunk ^ c) << 4), r);
    }
    if constexpr (TN % 16 != 0) {  // the last 8 tokens: matrices (j, 0), (j, 1) twice
      constexpr int j = TN / 8 - 1;
      const uint32_t r[4] = {packed(j, 0), packed(j, 1), packed(j, 0), packed(j, 1)};
      const int m = 8 * j + c;
      stmatrix4<true>(out + m * 128 + ((chunk ^ c) << 4), r);
    }
  }

  __device__ static void store(const Params& p, uint32_t out, int outer, int inner, int wg) {
    tma_store_2d(&p.out, out, outer * 128 + 64 * wg, inner * TN);
  }
};

template <int TN>
__global__ void __cluster_dims__(gemm::CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
wint8_gemm_wgmma_kernel(const __grid_constant__ typename Wint8<TN>::Params p) {
  gemm::run<Wint8<TN>>(p);
}

// Opts the kernel into its shared memory, once.
template <int TN>
cudaError_t prepare() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(wint8_gemm_wgmma_kernel<TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(gemm::Layout<Wint8<TN>>::BYTES));
  return attr;
}

template <int TN>
int max_clusters() {
  return prepare<TN>() == cudaSuccess
             ? gemm::max_clusters(wint8_gemm_wgmma_kernel<TN>, gemm::Layout<Wint8<TN>>::BYTES)
             : 0;
}

template <int TN>
int launch_wgmma(const void* x, const void* wq, const void* scale, void* out, int M, int N,
                 int K, int grid, cudaStream_t stream) {
  using S = Wint8<TN>;
  const cudaError_t attr = prepare<TN>();
  if (attr != cudaSuccess) return int(attr);
  typename S::Params p;
  CUresult res = make_map_2d(&p.x_lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, uint64_t(K) * 2,
                             gemm::BK, S::X_LO, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.x_hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, uint64_t(K) * 2,
                      gemm::BK, TN - S::X_LO, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K, uint64_t(K), gemm::BK, 128,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, uint64_t(N) * 2, 64,
                      TN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  const int m_tiles = (M + TN - 1) / TN;  // pairs of weight blocks x token blocks
  p.walk = {m_tiles, ((N + 127) / 128 + 1) / 2 * m_tiles, (K + gemm::BK - 1) / gemm::BK, 0};
  p.scale = static_cast<const float*>(scale);
  p.n = N;
  wint8_gemm_wgmma_kernel<TN><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16, wq (N, K) int8, scale (N,) fp32, out (M, N) bf16, all
// contiguous and 16-byte aligned; K % 16 == 0, N % 8 == 0. M == 1 runs the
// GEMV; any other M the tiled path at a token tile of `tile` (64, 128, 152,
// 208 or 256) with `grid` blocks (ops/gemm_tiles.py picks both). Returns the
// cudaError_t of the launch (0 on success), or 10000 + the CUresult of a
// tensor map that libcuda refused.
extern "C" int wint8_gemm_bf16(const void* x, const void* wq, const void* scale, void* out,
                               int M, int N, int K, int tile, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  if (K % 16 != 0 || N % 8 != 0) return int(cudaErrorInvalidValue);
  if (M == 1) {
    const int cols = GV_WARPS * GV_COLS;
    wint8_gemv_kernel<<<(N + cols - 1) / cols, GV_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), N, K);
    return int(cudaGetLastError());
  }
  if (grid < 1 || grid % gemm::CLUSTER != 0) return int(cudaErrorInvalidValue);
  switch (tile) {
    case 64: return launch_wgmma<64>(x, wq, scale, out, M, N, K, grid, s);
    case 128: return launch_wgmma<128>(x, wq, scale, out, M, N, K, grid, s);
    case 152: return launch_wgmma<152>(x, wq, scale, out, M, N, K, grid, s);
    case 208: return launch_wgmma<208>(x, wq, scale, out, M, N, K, grid, s);
    case 256: return launch_wgmma<256>(x, wq, scale, out, M, N, K, grid, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of a tiled block at a token tile of `tile` (0 if not compiled).
extern "C" int wint8_gemm_smem(int tile) {
  switch (tile) {
    case 64: return int(gemm::Layout<Wint8<64>>::BYTES);
    case 128: return int(gemm::Layout<Wint8<128>>::BYTES);
    case 152: return int(gemm::Layout<Wint8<152>>::BYTES);
    case 208: return int(gemm::Layout<Wint8<208>>::BYTES);
    case 256: return int(gemm::Layout<Wint8<256>>::BYTES);
    default: return 0;
  }
}

// The 2-block clusters of the tiled path at a token tile of `tile` that fit
// on the card at once.
extern "C" int wint8_gemm_max_clusters(int tile) {
  switch (tile) {
    case 64: return max_clusters<64>();
    case 128: return max_clusters<128>();
    case 152: return max_clusters<152>();
    case 208: return max_clusters<208>();
    case 256: return max_clusters<256>();
    default: return 0;
  }
}
