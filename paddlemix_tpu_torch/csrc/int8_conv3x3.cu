// 3x3 stride-1 SAME int8 conv as an implicit GEMM, channels_last (NHWC) bf16
// in and out: M = B*H*W output pixels, N = O output channels, K = 9*C with
// k = (3*dh + dw)*C + c, wq (O, 3, 3, C) int8 and sw, bias (O,) fp32. Two
// entry points, one template flag (FUSED) that picks the A prologue and the
// epilogue:
//
//   int8_conv3x3_bf16 (B3): out = sx*sw[o]*conv(q(x), wq) + bias[o].
//     Replaces int8_conv3x3_same / _conv3x3_kernel
//     (paddlemix_tpu/ops/conv_int8.py).
//   fused_gn_silu_conv3x3_bf16 (B5): the prologue applies the GroupNorm affine
//     y = x*scale[b, c] + shift[b, c] (aff is (B, 2, C) fp32), then SiLU, then
//     the quantize; the epilogue adds bias[o], temb[b, o] and
//     residual[b, h, w, o] (each optional, bf16) in fp32.
//     Replaces fused_gn_silu_conv3x3 / _kernel
//     (paddlemix_tpu/ops/fused_resnet.py).
//
// q(v) = clip(round_half_even(v * (1/sx)), -127, 127). Each A chunk of 8
// channels is gathered from the input pixel its tap points at; a tap outside
// the image gives int8 zeros after the prologue, because the conv pads the
// activated map (and SiLU(shift) is not zero).
//
// The TPU kernels padded and flattened the image so that every tap was one
// aligned slice, computed on a (W+2)-wide grid with two garbage columns,
// padded C to 128 lanes and sized blocks to VMEM. None of that is needed here:
// the loader computes each chunk's source address and masks it, and only C % 16
// (16-byte loads that never straddle a tap) and O % 8 are required.
//
// Bound: at the SDXL shapes (K = 9*C = 1152 ... 23040) the tensor cores bound
// the product, below the int8 peak for the reasons of csrc/int8_mma.cuh; the
// VAE's 1024x1024 maps with C = 128 have the smallest K, where the gather and
// B5's per-element affine + SiLU + quantize weigh most.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "int8_mma.cuh"

using namespace i8mma;

namespace {

template <bool FUSED>
struct ConvA {
  const __nv_bfloat16* __restrict__ x;
  const float* __restrict__ aff;
  int H, W, C, K;
  float inv_sx;
  int pb[A_CHUNKS], ph[A_CHUNKS], pw[A_CHUNKS];  // the thread's rows; pb = -1 past M
  int c;  // the channel of the thread's chunks in the K tile fetched last

  struct Raw {
    uint4 v;  // 8 bf16 channels of one input pixel
    int b;    // its batch index; -1 for a tap outside the image, or past M or K
  };

  __device__ __forceinline__ ConvA(const __nv_bfloat16* x_, const float* aff_, int H_, int W_,
                                   int C_, int M, int m0, float inv_sx_)
      : x(x_), aff(aff_), H(H_), W(W_), C(C_), K(9 * C_), inv_sx(inv_sx_), c(0) {
    const int hw = H * W;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int m = m0 + a_row(i);
      const int b = m / hw, r = m - b * hw;
      pb[i] = m < M ? b : -1;
      ph[i] = r / W;
      pw[i] = r - ph[i] * W;
    }
  }

  __device__ __forceinline__ void fetch(int kt, Raw (&ra)[A_CHUNKS]) {
    const int k = kt * BK + a_col();
    const int tap = k / C, dh = tap / 3 - 1, dw = tap % 3 - 1;
    c = k - tap * C;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int ih = ph[i] + dh, iw = pw[i] + dw;
      const bool in = pb[i] >= 0 && k < K && ih >= 0 && ih < H && iw >= 0 && iw < W;
      ra[i].b = in ? pb[i] : -1;
      ra[i].v = in ? *reinterpret_cast<const uint4*>(
                         x + (((size_t)pb[i] * H + ih) * W + iw) * C + c)
                   : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ uint2 convert(const Raw& r) const {
    if (r.b < 0) return make_uint2(0, 0);  // int8 zero after the prologue
    float v[8];
    unpack8(r.v, v);
    if (FUSED) {
      const float* a = aff + (size_t)r.b * 2 * C + c;
      const float4 s0 = *reinterpret_cast<const float4*>(a);
      const float4 s1 = *reinterpret_cast<const float4*>(a + 4);
      const float4 t0 = *reinterpret_cast<const float4*>(a + C);
      const float4 t1 = *reinterpret_cast<const float4*>(a + C + 4);
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // separate roundings, as the plain version's x * scale + shift
        const float y = __fadd_rn(__fmul_rn(v[j], s[j]), t[j]);
        v[j] = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
      }
    }
    return quantize8(v, inv_sx);
  }
};

struct ConvEpi {
  __nv_bfloat16* __restrict__ out;
  const __nv_bfloat16* __restrict__ temb;  // (B, O) or null
  const __nv_bfloat16* __restrict__ res;   // (B*H*W, O) or null
  int N, HW;

  __device__ __forceinline__ void add(const __nv_bfloat16* p, float (&v)[8]) const {
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(p), r);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], r[j]);
  }

  __device__ __forceinline__ void operator()(int m, int n, float (&v)[8]) const {
    if (temb != nullptr) add(temb + (size_t)(m / HW) * N + n, v);
    if (res != nullptr) add(res + (size_t)m * N + n, v);
    store_bf16x8(out + (size_t)m * N + n, v);
  }
};

template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ aff,
               const int8_t* __restrict__ wq, const float* __restrict__ sw,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ temb,
               const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int B,
               int H, int W, int C, int O, float sx, float inv_sx) {
  extern __shared__ __align__(16) char smem[];
  const int M = B * H * W, n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int acc[4][4][4];
  ConvA<FUSED> al(x, aff, H, W, C, M, m0, inv_sx);
  mainloop(al, wq, O, 9 * C, n0, smem, acc);
  epilogue(acc, M, O, m0, n0, sx, sw, bias, smem, ConvEpi{out, temb, res, O, H * W});
}

template <bool FUSED>
int launch(const void* x, const void* aff, const void* wq, const void* sw, const void* bias,
           const void* temb, const void* res, void* out, int B, int H, int W, int C, int O,
           float sx, float inv_sx, void* stream) {
  static const cudaError_t attr = allow_smem(conv3x3_kernel<FUSED>);
  if (attr != cudaSuccess) return attr;
  const int M = B * H * W;
  if (M == 0) return 0;
  const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
  conv3x3_kernel<FUSED><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(aff),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(temb),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), B, H, W, C, O,
      sx, inv_sx);
  return cudaGetLastError();
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success). bias, temb and
// residual may be null.
extern "C" int int8_conv3x3_bf16(const void* x, const void* wq, const void* sw, const void* bias,
                                 void* out, int B, int H, int W, int C, int O, float sx,
                                 float inv_sx, void* stream) {
  return launch<false>(x, nullptr, wq, sw, bias, nullptr, nullptr, out, B, H, W, C, O, sx,
                       inv_sx, stream);
}

extern "C" int fused_gn_silu_conv3x3_bf16(const void* x, const void* aff, const void* wq,
                                          const void* sw, const void* bias, const void* temb,
                                          const void* residual, void* out, int B, int H, int W,
                                          int C, int O, float sx, float inv_sx, void* stream) {
  return launch<true>(x, aff, wq, sw, bias, temb, residual, out, B, H, W, C, O, sx, inv_sx,
                      stream);
}
