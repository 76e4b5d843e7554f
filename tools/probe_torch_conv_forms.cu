// The int8 3x3 conv in B2's RS form, for tools/probe_torch_conv_forms.py:
// x stays bf16 in device memory, TMA-loaded at each tap's offset in the
// 128-byte swizzle, and each consumer thread activates (B5: the GroupNorm
// affine from a (B, 2, Cpad) table, then SiLU) and quantizes its A fragments
// of every tap in registers, out-of-image taps masked to int8 zero, on their
// way to wgmma.m64n160k32.s32.s8.s8. 128-pixel tiles by 160 columns, column
// tiles paired; the epilogue adds the bias. The probe builds it against a
// copy of csrc/gemm_wg.cuh whose RS build is told its k block and pixel tile
// (the spec's `build` needs the tap and the pixels), and compares it with the
// port's form (the activation pass and the SS implicit GEMM).
#include "gemm_wg.cuh"

namespace {
using namespace wg;
#include "rs160.inc"

__device__ __forceinline__ uint32_t q8b(float v, float inv_sx) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv_sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f)) & 0xffu;
}

template <bool FUSED>
__device__ __forceinline__ uint32_t act4(uint2 raw, const float4& s, const float4& t, bool in,
                                         float inv_sx) {
  float v[4] = {__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u)};
  if constexpr (FUSED) {
    if (!in) return 0;
    const float sc[4] = {s.x, s.y, s.z, s.w}, sh[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = __fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]);
      v[j] = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
    }
  }
  return q8b(v[0], inv_sx) | (q8b(v[1], inv_sx) << 8) | (q8b(v[2], inv_sx) << 16) |
         (q8b(v[3], inv_sx) << 24);
}

template <bool FUSED>
struct ConvRS {
  static constexpr int BN = 160;
  static constexpr bool SS = false;
  static constexpr int SPS = 2;
  static constexpr uint32_t HALF_BYTES = 64 * 128;  // 64 pixels x 64 bf16
  static constexpr uint32_t A_BYTES = 2 * HALF_BYTES;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + BN * 64;
  static constexpr uint32_t PANEL_BYTES = 64 * 64;
  static constexpr uint32_t TILE_BYTES = 64 * BN * 2;
  static constexpr uint32_t OUT_BYTES = (TILE_BYTES + BN * 8 + 1023) / 1024 * 1024;
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = int[BN / 2];

  struct Params {
    CUtensorMap x, w, out;
    gemm::Walk walk;
    const float* sw;
    const float* bias;
    const float* aff;  // (B, 2, cpad) scale, shift; zeros past C
    int n, batch, H, W, cpad;
    int tw, th, tiles_w, tiles_hw, chunks;
    float sx, inv_sx;
  };

  __device__ static void origin(const Params& p, int outer, int& b, int& y, int& x) {
    b = outer / p.tiles_hw;
    const int r = outer - b * p.tiles_hw, ty = r / p.tiles_w;
    y = ty * p.th;
    x = (r - ty * p.tiles_w) * p.tw;
  }
  __device__ static void half(const Params& p, int h, int& x, int& y) {
    if (p.th == 1)
      x += 64 * h;
    else
      y += h * (p.th / 2);
  }

  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    const int tap = kb / p.chunks, c0 = (kb - tap * p.chunks) * 64;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    int b, y, x;
    origin(p, outer, b, y, x);
    int hx = x, hy = y;
    half(p, rank, hx, hy);
    tma_load_4d_multicast(st + rank * HALF_BYTES, &p.x, bar, c0, hx + dx, hy + dy, b, 0x3);
    tma_load_3d(st + A_BYTES, &p.w, bar, c0, tap, inner * BN);
  }

  __device__ static void build(uint32_t (&a)[4], uint32_t st, int s, const Params& p,
                               const gemm::Thread& th, int kb, int outer) {
    const int tap = kb / p.chunks, c0 = (kb - tap * p.chunks) * 64;
    const int r0 = 64 * th.wg + 16 * th.warp + th.g;
    const uint32_t row = st + r0 * 128 + 8 * (th.t & 1);
    const int c = 4 * s + (th.t >> 1);
    const uint32_t lo = (c ^ th.g) << 4, hi = ((c + 2) ^ th.g) << 4;
    const uint2 v00 = lds64(row + lo), v10 = lds64(row + 1024 + lo);
    const uint2 v01 = lds64(row + hi), v11 = lds64(row + 1024 + hi);
    float4 sA = {}, tA = {}, sB = {}, tB = {};
    bool in0 = true, in1 = true;
    if constexpr (FUSED) {
      int b, y, x;
      origin(p, outer, b, y, x);
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int y0 = y + r0 / p.tw + dy, x0 = x + r0 % p.tw + dx;
      const int y1 = y + (r0 + 8) / p.tw + dy, x1 = x + (r0 + 8) % p.tw + dx;
      in0 = y0 >= 0 && y0 < p.H && x0 >= 0 && x0 < p.W;
      in1 = y1 >= 0 && y1 < p.H && x1 >= 0 && x1 < p.W;
      const float* a_ = p.aff + (size_t)min(b, p.batch - 1) * 2 * p.cpad + c0 + 32 * s + 4 * th.t;
      sA = __ldg(reinterpret_cast<const float4*>(a_));
      sB = __ldg(reinterpret_cast<const float4*>(a_ + 16));
      tA = __ldg(reinterpret_cast<const float4*>(a_ + p.cpad));
      tB = __ldg(reinterpret_cast<const float4*>(a_ + p.cpad + 16));
    }
    a[0] = act4<FUSED>(v00, sA, tA, in0, p.inv_sx);
    a[1] = act4<FUSED>(v10, sA, tA, in1, p.inv_sx);
    a[2] = act4<FUSED>(v01, sB, tB, in0, p.inv_sx);
    a[3] = act4<FUSED>(v11, sB, tB, in1, p.inv_sx);
  }

  __device__ static void mma(Acc& acc, const uint32_t (&a)[4], uint32_t st, int s,
                             int accumulate) {
    wgmma_s8_rs_n160(acc, a, smem_desc_sw64(st + A_BYTES + 32 * s), accumulate);
  }

  struct Pre {
    float2 s, b;
  };
  __device__ static Pre prefetch(const Params& p, int, int inner, const gemm::Thread& th,
                                 const gemm::Staging&) {
    Pre pre{make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    const int n = inner * BN + 2 * th.tid;
    if (2 * th.tid < BN && n < p.n) {
      pre.s = __ldg(reinterpret_cast<const float2*>(p.sw + n));
      if (p.bias != nullptr) pre.b = __ldg(reinterpret_cast<const float2*>(p.bias + n));
    }
    pre.s.x = __fmul_rn(pre.s.x, p.sx);
    pre.s.y = __fmul_rn(pre.s.y, p.sx);
    return pre;
  }

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
    const int mi = th.lane >> 3;
    const int row = 16 * th.warp + 8 * (mi & 1) + (th.lane & 7);
    const uint32_t base = out + row * 64, swz = (row >> 1) & 3;
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      const int jm = 2 * jj + (mi >> 1);
      const uint32_t addr = base + (jm >> 2) * PANEL_BYTES + (((jm & 3) ^ swz) << 4);
      uint32_t r[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * jj + h;
        const uint2 su = lds64(cols + 32 * j + 8 * th.t);
        const uint2 bu = lds64(cols + 4 * BN + 32 * j + 8 * th.t);
        const float s_[2] = {__uint_as_float(su.x), __uint_as_float(su.y)};
        const float b_[2] = {__uint_as_float(bu.x), __uint_as_float(bu.y)};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float v[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            v[k] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * rr + k]), s_[k]);
            if (p.bias != nullptr) v[k] = __fadd_rn(v[k], b_[k]);
          }
          r[2 * h + rr] = pack_bf16(v[0], v[1]);
        }
      }
      stmatrix4<false>(addr, r);
    }
  }

  __device__ static void store(const Params& p, uint32_t out, int outer, int inner, int wg) {
    int b, y, x;
    origin(p, outer, b, y, x);
    half(p, wg, x, y);
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      tma_store_4d(&p.out, out + q * PANEL_BYTES, inner * BN + 32 * q, x, y, b);
  }
};

template <bool FUSED>
__global__ void __cluster_dims__(gemm::CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
conv_rs_kernel(const __grid_constant__ typename ConvRS<FUSED>::Params p) {
  gemm::run<ConvRS<FUSED>>(p);
}

CUresult nhwc(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int B,
              int H, int W, int ch, int box_ch, int pw, int ph, CUtensorMapSwizzle sw) {
  const uint64_t dims[4] = {uint64_t(ch), uint64_t(W), uint64_t(H), uint64_t(B)};
  const uint64_t row = uint64_t(ch) * elem;
  const uint64_t bytes[3] = {row, row * W, row * W * H};
  const uint32_t box[4] = {uint32_t(box_ch), uint32_t(pw), uint32_t(ph), 1};
  return make_map_nd(map, type, ptr, 4, dims, bytes, box, sw);
}

template <bool FUSED>
int launch(const void* x, const void* aff, const void* wq, const void* sw, const void* bias,
           void* out, int B, int H, int W, int C, int O, float sx, float inv_sx, int tw,
           int grid, cudaStream_t stream) {
  using S = ConvRS<FUSED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_rs_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(gemm::Layout<S>::BYTES));
  if (attr != cudaSuccess) return int(attr);
  const int th = 128 / tw, pw = th == 1 ? 64 : tw, ph = th == 1 ? 1 : th / 2;
  typename S::Params p;
  CUresult r = nhwc(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, W, C, 64, pw, ph,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS) {
    const uint64_t dims[3] = {uint64_t(C), 9, uint64_t(O)};
    const uint64_t bytes[2] = {uint64_t(C), uint64_t(C) * 9};
    const uint32_t box[3] = {64, 1, uint32_t(S::BN)};
    r = make_map_nd(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 3, dims, bytes, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (r == CUDA_SUCCESS)
    r = nhwc(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, B, H, W, O, 32, pw, ph,
             CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(r);
  p.tw = tw;
  p.th = th;
  p.tiles_w = (W + tw - 1) / tw;
  p.tiles_hw = p.tiles_w * ((H + th - 1) / th);
  p.chunks = (C + 63) / 64;
  const int outer = B * p.tiles_hw, inner = (O + S::BN - 1) / S::BN, ui = (inner + 1) / 2;
  p.walk = {ui, outer * ui, 9 * p.chunks, 1};
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.aff = static_cast<const float*>(aff);
  p.n = O;
  p.batch = B;
  p.H = H;
  p.W = W;
  p.cpad = p.chunks * 64;
  p.sx = sx;
  p.inv_sx = inv_sx;
  conv_rs_kernel<FUSED><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}
}  // namespace

extern "C" int conv_rs(const void* x, const void* aff, const void* wq, const void* sw,
                       const void* bias, void* out, int B, int H, int W, int C, int O, float sx,
                       float inv_sx, int tw, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aff != nullptr
             ? launch<true>(x, aff, wq, sw, bias, out, B, H, W, C, O, sx, inv_sx, tw, grid, s)
             : launch<false>(x, aff, wq, sw, bias, out, B, H, W, C, O, sx, inv_sx, tw, grid, s);
}
