// int8 a8w8 GEMM with a static activation scale (B2):
//   out[m, n] = bf16(sx * sw[n] * sum_k q(x[m, k]) * wq[n, k] + bias[n])
// x (M, K) bf16 row-major, wq (N, K) int8, sw and bias (N,) fp32, out (M, N)
// bf16; q(v) = clip(round_half_even(v * (1/sx)), -127, 127).
//
// Replaces the Pallas kernel int8_a8w8_matmul / _a8w8_kernel
// (paddlemix_tpu/ops/conv_int8.py). That kernel read an x the caller had
// already quantized in a separate XLA pass; here x is quantized while its tile
// is loaded into shared memory, so the int8 copy of x never goes to device
// memory. The TPU kernel carried an int32 accumulator across a sequential K
// grid axis; on Hopper each block owns a 128 x 128 output tile and loops over
// K itself (csrc/int8_mma.cuh).
//
// Bound: at the SDXL shapes (M = 2048 ... 8192, K and N 640 ... 10240) the
// product is well above the card's int8 ridge, so the tensor cores bound it;
// mma.sync (not wgmma) and a two-stage register-staged pipeline leave it below
// the int8 peak. At attn2's k/v (M = 154) the weight read bounds it.
//
// flax adds a Dense bias after the dot's bf16 rounding; this epilogue adds it
// in fp32 before the one rounding, so the two differ by at most one bf16
// rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "int8_mma.cuh"

using namespace i8mma;

namespace {

struct GemmA {
  const __nv_bfloat16* __restrict__ x;
  int M, K, m0;
  float inv_sx;

  using Raw = uint4;  // 8 bf16; zero past M or K, which quantizes to zero

  __device__ __forceinline__ void fetch(int kt, Raw (&ra)[A_CHUNKS]) const {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int m = m0 + a_row(i), k = kt * BK + a_col();
      ra[i] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k)
                               : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ uint2 convert(const Raw& r) const {
    float v[8];
    unpack8(r, v);
    return quantize8(v, inv_sx);
  }
};

struct GemmEpi {
  __nv_bfloat16* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float (&v)[8]) const {
    store_bf16x8(out + (size_t)m * N + n, v);
  }
};

__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K, float sx, float inv_sx) {
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int acc[4][4][4];
  GemmA al{x, M, K, m0, inv_sx};
  mainloop(al, wq, N, K, n0, smem, acc);
  epilogue(acc, M, N, m0, n0, sx, sw, bias, smem, GemmEpi{out, N});
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). bias may be null.
extern "C" int int8_gemm_bf16(const void* x, const void* wq, const void* sw, const void* bias,
                              void* out, int M, int N, int K, float sx, float inv_sx,
                              void* stream) {
  static const cudaError_t attr = allow_smem(int8_gemm_kernel);
  if (attr != cudaSuccess) return attr;
  if (M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, sx, inv_sx);
  return cudaGetLastError();
}
