// int8 a8w8 GEMM with a static activation scale (B2):
//   out[m, n] = bf16(sx * sw[n] * sum_k q(x[m, k]) * wq[n, k] + bias[n])
// x (M, K) bf16 row-major, wq (N, K) int8, sw and bias (N,) fp32, out (M, N)
// bf16; q(v) = clip(round_half_even(v * (1/sx)), -127, 127).
//
// Replaces the Pallas kernel int8_a8w8_matmul / _a8w8_kernel
// (paddlemix_tpu/ops/conv_int8.py, pallas_call at :210). That kernel read an x
// the caller had already quantized in a separate XLA pass and carried an int32
// accumulator across a sequential K grid axis; here x is quantized in
// registers on its way to the tensor cores, so its int8 copy never goes to
// memory, and a block loops over K itself.
//
// Bound: at (8192, 640 -> 5120), SDXL's GEGLU projection, the bytes bound it
// (0.029 ms at 3.35 TB/s; the bf16 output is 84 of its 98 MB), the int8
// operations (0.027 ms at 1,979 TOP/s) nearly so; at attn2's k/v (M = 154)
// reading the weight does.
//
// Design: the wgmma core of csrc/gemm_wg.cuh. A tile is 128 rows of x (64 a
// consumer warpgroup) x BN = 256 or 128 weight rows, and the two blocks of a
// cluster take neighbouring column tiles, which read the same x; each stage
// holds x as bf16 (TMA multicast, 128-byte swizzle) and the int8 weight tile
// (64-byte swizzle, K-major, as wgmma's 8-bit types require). Each consumer
// thread reads its A fragments of a stage's two k32 steps straight from the
// swizzled x panel (8 bytes at the s8 fragment's positions), quantizes the
// values (multiply, clip, add 1.5 * 2^23 and keep the low byte: no
// conversion instruction) while the previous stage's
// wgmma.m64nBNk32.s32.s8.s8 run, and issues them. The int32 sums stay in
// registers; the epilogue converts them (exact below 2^24) and applies
// acc * (sw[n] * sx) + bias[n] in fp32 with __fmul_rn / __fadd_rn, each step
// rounding as the plain version's separate multiply and add, so the kernel
// is bit-exact with int8_a8w8_matmul_ref; the tile's sw[n] * sx and bias[n]
// are loaded when the tile begins and pass through shared memory. x is
// quantized once per BN-wide tile, which a 256-wide tile halves;
// ops/gemm_tiles.py picks BN per shape (256 unless the narrower tile fills
// the card sooner).
//
// flax adds a Dense bias after the dot's bf16 rounding; this epilogue adds it
// in fp32 before the one rounding, so the two differ by at most one bf16
// rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "gemm_wg.cuh"

namespace {

using namespace wg;

// round_half_even(v * inv_sx) clipped to +-127, as the bits of a float whose
// low byte is the int8: the clip comes first (equal to clipping after the
// round), then adding 1.5 * 2^23 rounds to an integer, half to even, and
// leaves it in the low bits. Each step rounds as the plain version's
// torch.round(x * (1 / sx)).clamp(-127, 127).
__device__ __forceinline__ uint32_t q8_bits(float v, float inv_sx) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv_sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// 4 bf16 (two a word, the lower first) -> 4 int8, the first in the lowest byte
__device__ __forceinline__ uint32_t quantize4(uint2 v, float inv_sx) {
  const uint32_t b0 = q8_bits(__uint_as_float(v.x << 16), inv_sx);
  const uint32_t b1 = q8_bits(__uint_as_float(v.x & 0xffff0000u), inv_sx);
  const uint32_t b2 = q8_bits(__uint_as_float(v.y << 16), inv_sx);
  const uint32_t b3 = q8_bits(__uint_as_float(v.y & 0xffff0000u), inv_sx);
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

template <int BN>
struct A8W8 {
  static constexpr bool SS = false;  // A built in registers
  static constexpr int SPS = 2;                            // k32 steps a stage
  static constexpr uint32_t X_BYTES = 128 * 128;           // 128 rows x 64 bf16
  static constexpr uint32_t STAGE_BYTES = X_BYTES + BN * 64;  // + BN weight rows x 64 bytes
  static constexpr uint32_t TILE_BYTES = 64 * BN * 2;      // a warpgroup's 64 rows x BN bf16
  static constexpr uint32_t OUT_BYTES = TILE_BYTES + BN * 8;  // + its columns' scales and biases
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = int[BN / 2];

  struct Params {
    CUtensorMap x, w, out;
    gemm::Walk walk;  // outer: 128-row blocks of x, inner: BN-wide column blocks, in pairs
    const float* sw;
    const float* bias;  // or null
    int n;
    float sx, inv_sx;
  };

  // x: this block's 64 of the tile's 128 rows, into both blocks of the cluster
  // (their tiles share the rows); the weight: this block's own tile.
  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    tma_load_2d_multicast(st + rank * (X_BYTES / 2), &p.x, bar, kb * gemm::BK,
                          outer * 128 + 64 * rank, 0x3);
    tma_load_2d(st + X_BYTES, &p.w, bar, kb * gemm::BK, inner * BN);
  }

  // The A fragment of k32 step s: rows r0 = 64 wg + 16 warp + g and r0 + 8,
  // columns 32 s + 4 t .. + 3 (registers 0, 1) and 32 s + 16 + 4 t .. + 3
  // (registers 2, 3) of the stage's x panel (16-byte chunk c of row r at
  // c ^ (r % 8)), quantized.
  __device__ static void build(uint32_t (&a)[4], uint32_t st, int s, const Params& p,
                               const gemm::Thread& th) {
    const uint32_t row = st + (64 * th.wg + 16 * th.warp + th.g) * 128 + 8 * (th.t & 1);
    const int c = 4 * s + (th.t >> 1);
    const uint32_t lo = (c ^ th.g) << 4, hi = ((c + 2) ^ th.g) << 4;
    a[0] = quantize4(lds64(row + lo), p.inv_sx);
    a[1] = quantize4(lds64(row + 1024 + lo), p.inv_sx);
    a[2] = quantize4(lds64(row + hi), p.inv_sx);
    a[3] = quantize4(lds64(row + 1024 + hi), p.inv_sx);
  }

  __device__ static void mma(Acc& acc, const uint32_t (&a)[4], uint32_t st, int s,
                             int accumulate) {
    wgmma_s8<BN>(acc, a, smem_desc_sw64(st + X_BYTES + 32 * s), accumulate);
  }

  // The columns' sw[n] * sx and bias[n], two a thread: n0 + 2 tid, + 1.
  struct Pre {
    float2 s, b;
  };

  __device__ static Pre prefetch(const Params& p, int, int inner, const gemm::Thread& th,
                                 const gemm::Staging&) {
    Pre pre{make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    const int n = inner * BN + 2 * th.tid;
    if (2 * th.tid < BN && n < p.n) {  // N % 8 == 0: n + 1 is inside too
      pre.s = __ldg(reinterpret_cast<const float2*>(p.sw + n));
      if (p.bias != nullptr) pre.b = __ldg(reinterpret_cast<const float2*>(p.bias + n));
    }
    pre.s.x = __fmul_rn(pre.s.x, p.sx);
    pre.s.y = __fmul_rn(pre.s.y, p.sx);
    return pre;
  }

  // acc register 4j + 2r + e holds row 16 warp + g + 8r of the warpgroup's 64,
  // column n0 + 8j + 2t + e. The prefetched column values go to shared memory
  // first (after the staging tile: BN scales, then BN biases). Stored as bf16
  // into BN / 64 panels of 64 rows x 128 bytes in the 128-byte swizzle, one
  // stmatrix per two 8-column groups.
  __device__ static void stage_out(Acc& acc, const Pre& pre, uint32_t out, const Params& p, int,
                                   int, const gemm::Thread& th) {
    const uint32_t cols = out + TILE_BYTES;
    if (2 * th.tid < BN) {
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 8 * th.tid), "f"(pre.s.x),
                   "f"(pre.s.y) : "memory");
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 4 * BN + 8 * th.tid),
                   "f"(pre.b.x), "f"(pre.b.y) : "memory");
    }
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
        const uint2 bu = lds64(cols + 4 * BN + 32 * j + 8 * th.t);
        const float s[2] = {__uint_as_float(su.x), __uint_as_float(su.y)};
        const float b[2] = {__uint_as_float(bu.x), __uint_as_float(bu.y)};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * rr + e]), s[e]);
            if (p.bias != nullptr) v[e] = __fadd_rn(v[e], b[e]);
          }
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

template <int BN>
__global__ void __cluster_dims__(gemm::CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ typename A8W8<BN>::Params p) {
  gemm::run<A8W8<BN>>(p);
}

// Opts the kernel into its shared memory, once.
template <int BN>
cudaError_t prepare() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_gemm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(gemm::Layout<A8W8<BN>>::BYTES));
  return attr;
}

template <int BN>
int max_clusters() {
  return prepare<BN>() == cudaSuccess
             ? gemm::max_clusters(int8_gemm_wgmma_kernel<BN>, gemm::Layout<A8W8<BN>>::BYTES)
             : 0;
}

template <int BN>
int launch_wgmma(const void* x, const void* wq, const void* sw, const void* bias, void* out,
                 int M, int N, int K, float sx, float inv_sx, int grid, cudaStream_t stream) {
  using S = A8W8<BN>;
  const cudaError_t attr = prepare<BN>();
  if (attr != cudaSuccess) return int(attr);
  typename S::Params p;
  CUresult res = make_map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, uint64_t(K) * 2,
                             gemm::BK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K, uint64_t(K), gemm::BK, BN,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, uint64_t(N) * 2, 64,
                      64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  const int unit_inner = ((N + BN - 1) / BN + 1) / 2;  // pairs of column blocks
  p.walk = {unit_inner, (M + 127) / 128 * unit_inner, (K + gemm::BK - 1) / gemm::BK, 1};
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.n = N;
  p.sx = sx;
  p.inv_sx = inv_sx;
  int8_gemm_wgmma_kernel<BN><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16, wq (N, K) int8, sw / bias (N,) fp32 (bias may be null), out
// (M, N) bf16, all contiguous and 16-byte aligned; K % 16 == 0, N % 8 == 0.
// tile: the N width of an output tile, 256 or 128; grid: the blocks of the
// persistent walk (ops/gemm_tiles.py picks both). Returns the cudaError_t of
// the launch (0 on success), or 10000 + the CUresult of a tensor map that
// libcuda refused.
extern "C" int int8_gemm_bf16(const void* x, const void* wq, const void* sw, const void* bias,
                              void* out, int M, int N, int K, float sx, float inv_sx, int tile,
                              int grid, void* stream) {
  if (M == 0) return 0;
  if (grid < 1 || grid % gemm::CLUSTER != 0 || K % 16 != 0 || N % 8 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 256: return launch_wgmma<256>(x, wq, sw, bias, out, M, N, K, sx, inv_sx, grid, s);
    case 128: return launch_wgmma<128>(x, wq, sw, bias, out, M, N, K, sx, inv_sx, grid, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of a block at an N tile of `tile` (0 if not compiled).
extern "C" int int8_gemm_smem(int tile) {
  return tile == 256   ? int(gemm::Layout<A8W8<256>>::BYTES)
         : tile == 128 ? int(gemm::Layout<A8W8<128>>::BYTES)
                       : 0;
}

// The 2-block clusters at an N tile of `tile` that fit on the card at once.
extern "C" int int8_gemm_max_clusters(int tile) {
  return tile == 256 ? max_clusters<256>() : tile == 128 ? max_clusters<128>() : 0;
}
