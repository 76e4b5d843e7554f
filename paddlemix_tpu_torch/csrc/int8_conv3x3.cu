// 3x3 stride-1 SAME int8 conv as an implicit GEMM, channels_last (NHWC) bf16
// in and out: M = B*H*W output pixels, N = O output channels, K = 9*C with
// k = (3*dh + dw)*C + c, wq (O, 3, 3, C) int8 and sw, bias (O,) fp32. Two
// kernels a call, the activation pass (entry point conv3x3_act_quant) and the
// conv (conv3x3_gemm), for both wrappers:
//
//   int8_conv3x3_same (B3, ops/conv_int8.py): out = sx*sw[o]*conv(q(x), wq)
//     + bias[o]. Replaces int8_conv3x3_same / _conv3x3_kernel
//     (paddlemix_tpu/ops/conv_int8.py).
//   fused_gn_silu_conv3x3 (B5, ops/fused_resnet.py): the conv of
//     q(SiLU(GroupNorm(x))), whose epilogue adds bias[o], temb[b, o] and
//     residual[b, h, w, o] (each optional, bf16) in fp32. Replaces
//     fused_gn_silu_conv3x3 / _kernel (paddlemix_tpu/ops/fused_resnet.py).
//
// 1. The activation pass (act_quant_kernel) activates and quantizes every
//    element of x once, into an int8 NHWC map of x's shape: B3 writes q(x),
//    B5 q(SiLU(x * scale[b, c] + shift[b, c])), each thread forming its 8
//    channels' scale = inv[b, g] * gamma[c] and shift = beta[c] - mean[b, g]
//    * scale from the GroupNorm statistics with gn_affine's roundings. Here
//    q(v) = clip(round_half_even(v * (1/sx)), -127, 127), and every fp32 step
//    rounds as the plain PyTorch version's separate operation does
//    (__fmul_rn / __fadd_rn, SiLU as y * (1 / (1 + expf(-y))), the quantize as
//    B2's), so the map is the plain version's quantized map bit for bit.
// 2. The conv (spec Conv of the wgmma core, csrc/gemm_wg.cuh) is then a pure
//    int8 implicit GEMM, SS form: K walks stages of (tap, 64-channel chunk).
//    A stage's A side is the tile's output pixels x 64 channels of the int8
//    map at the tap's (dh, dw) offset, read by TMA as two 4-d boxes (C, W,
//    H, B), each the half of the tile one consumer warpgroup owns. TMA's
//    zero fill of out-of-image taps is exactly the int8 zero the SAME
//    padding of the activated map asks for (SiLU(shift) is not zero, which is
//    why the padding must come after the activation), and it also zero-fills
//    channels past C. The weight side is a 3-d box (C, 9, O) over wq: 64
//    channels of one tap for the tile's BN output channels. Both sit in
//    shared memory as 64-byte rows in the 64-byte swizzle, K-major as s8
//    wgmma requires; the products are wgmma.m64nBNk32.s32.s8.s8 from two
//    descriptors, the sums exact in int32 registers. The epilogue applies
//    acc * (sw[o] * sx) + bias[o] (+ temb[b, o]) (+ residual) in fp32 in the
//    plain version's order and stores bf16 by TMA.
//
// A tile is TW x TH = 128 MW output pixels of one image by BN output
// channels (CONV_VARIANTS; TW a power of two along W, from ops/gemm_tiles.py's
// conv_plan; half of it, one consumer warpgroup's 64 MW pixels, split along W
// when TH = 1, else along H), so any width runs as tiled boxes: the pixels
// past W or H of an edge tile read zeros and are clipped from the store. A
// cluster's two blocks share one operand by TMA multicast: with `pair_inner`
// they take two column tiles of the same pixels and each loads one half of
// the A box for both; otherwise (an O of one column tile) two pixel tiles of
// the same columns, and each loads half of the weight box. The residual tile
// is TMA-loaded into the warpgroup's staging tile while the products run,
// read back by ldmatrix in the accumulators' layout and overwritten with the
// output.
//
// Bound: the int8 operations (2*M*N*9*C at 1,979 TOP/s) bound the conv at
// the SDXL shapes, but with 128-pixel tiles a stage's time followed the bytes
// it brings from L2 (~0.39 / 0.41 / 0.50 us at 128 / 160 / 256 columns on an
// H100, whatever the products), so MW = 2 (each warpgroup's two m64 products
// share one weight descriptor) halves the weight's bytes a product and is
// the default wherever it fills the card. The activation pass moves 3 bytes
// an element (bf16 in, int8 out; 0.009 ms at (2, 128, 128, 320)); B5's
// affine, expf and reciprocal make it instruction-bound at about twice that.
// Only C % 16 == 0 (TMA's 16-byte strides) and O % 8 == 0 are required.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include "gemm_wg.cuh"

namespace {

using namespace wg;

// ------------------------------------------------------- the activation pass
constexpr int ACT_THREADS = 256;

// round_half_even(v * inv_sx) clipped to +-127, as the bits of a float whose
// low byte is the int8 (B2's quantize, csrc/int8_gemm.cu): the clip comes
// first (equal to clipping after the round), then adding 1.5 * 2^23 rounds to
// an integer, half to even, without the quarter-rate conversion instruction.
__device__ __forceinline__ uint32_t q8_bits(float v, float inv_sx) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv_sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// 4 values -> 4 int8, the first in the lowest byte
__device__ __forceinline__ uint32_t quantize4(const float* v, float inv_sx) {
  const uint32_t b0 = q8_bits(v[0], inv_sx), b1 = q8_bits(v[1], inv_sx);
  const uint32_t b2 = q8_bits(v[2], inv_sx), b3 = q8_bits(v[3], inv_sx);
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

__device__ __forceinline__ float affine_at(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// Thread t of block (i, b) quantizes 8-channel chunks k = i * ACT_THREADS + t,
// + stride, ... of image b (hwc8 of them, C / 8 a pixel). The launch makes
// the stride a multiple of C / 8, so a thread's chunks share their channels:
// FUSED, it forms their scale and shift once, in registers.
template <bool FUSED>
__global__ void __launch_bounds__(ACT_THREADS)
act_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ inv, const void* gamma, const void* beta,
                 int affine_bf16, int8_t* __restrict__ xq, int hwc8, int C, int groups,
                 float inv_sx) {
  const int b = blockIdx.y, first = blockIdx.x * ACT_THREADS + threadIdx.x;
  float scale[8], shift[8];
  if constexpr (FUSED) {
    const int c0 = (first % (C / 8)) * 8, cpg = C / groups;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = b * groups + (c0 + j) / cpg;
      scale[j] = __fmul_rn(inv[g], affine_at(gamma, c0 + j, affine_bf16));
      shift[j] = __fsub_rn(affine_at(beta, c0 + j, affine_bf16), __fmul_rn(mean[g], scale[j]));
    }
  }
  const uint4* src = reinterpret_cast<const uint4*>(x) + (size_t)b * hwc8;
  uint2* dst = reinterpret_cast<uint2*>(xq) + (size_t)b * hwc8;
  for (int i = first; i < hwc8; i += gridDim.x * ACT_THREADS) {
    const uint4 u = __ldg(src + i);
    float v[8] = {__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u),
                  __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                  __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u)};
    if constexpr (FUSED) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // separate roundings, as the plain version's x * scale + shift
        const float y = __fadd_rn(__fmul_rn(v[j], scale[j]), shift[j]);
        v[j] = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
      }
    }
    dst[i] = make_uint2(quantize4(v, inv_sx), quantize4(v + 4, inv_sx));
  }
}

// --------------------------------------------------------- the conv's GEMM
// BN output channels by 128 MW pixels: each consumer warpgroup owns MW
// groups of 64 pixels (MW m64 products a k-step, one weight descriptor).
template <int BN, int MW>
struct Conv {
  static constexpr bool SS = true;                            // A read by descriptor
  static constexpr int SPS = 2;                               // k32 steps a stage
  static constexpr int HALF_PIX = 64 * MW;                    // a warpgroup's pixels
  static constexpr uint32_t HALF_BYTES = HALF_PIX * 64;       // x 64 channels
  static constexpr uint32_t A_BYTES = 2 * HALF_BYTES;         // the tile's pixels
  static constexpr uint32_t STAGE_BYTES = A_BYTES + BN * 64;  // + BN weight rows x 64 channels
  static constexpr uint32_t PANEL_BYTES = HALF_PIX * 64;      // HALF_PIX pixels x 32 bf16
  static constexpr uint32_t TILE_BYTES = HALF_PIX * BN * 2;   // a warpgroup's pixels x BN
  // + the columns' scales, biases and time embeddings; 1,024-byte aligned
  static constexpr uint32_t OUT_BYTES = (TILE_BYTES + BN * 12 + 1023) / 1024 * 1024;
  static constexpr int STAGES = gemm::stages_that_fit(STAGE_BYTES, OUT_BYTES);
  using Acc = int[MW][BN / 2];

  struct Params {
    CUtensorMap x, w, out, res;  // res only when has_res
    gemm::Walk walk;  // outer: pixel tiles (image-major), inner: BN-wide column tiles
    const float* sw;
    const float* bias;            // or null
    const __nv_bfloat16* temb;    // (B, O) or null
    int n, batch;                 // O, B
    int tw, th, tiles_w, tiles_hw;  // the pixel tile; tiles an image row, an image
    int chunks;                   // 64-channel chunks of C
    int has_res;
    float sx;
  };

  // The image and the top-left pixel of pixel tile `outer`.
  __device__ static void origin(const Params& p, int outer, int& b, int& y, int& x) {
    b = outer / p.tiles_hw;
    const int r = outer - b * p.tiles_hw, ty = r / p.tiles_w;
    y = ty * p.th;
    x = (r - ty * p.tiles_w) * p.tw;
  }

  // The top-left pixel of half h (HALF_PIX pixels) of the tile at (x, y).
  __device__ static void half(const Params& p, int h, int& x, int& y) {
    if (p.th == 1)
      x += HALF_PIX * h;
    else
      y += h * (p.th / 2);
  }

  __device__ static void load(const Params& p, uint32_t st, uint32_t bar, int outer, int inner,
                              int kb, int rank) {
    const int tap = kb / p.chunks, c0 = (kb - tap * p.chunks) * 64;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    int b, y, x;
    origin(p, outer, b, y, x);
    if (p.walk.pair_inner) {
      // the A box: this block's half of the pixels, into both blocks of the
      // cluster (their column tiles share them); the weight: this block's own
      int hx = x, hy = y;
      half(p, rank, hx, hy);
      tma_load_4d_multicast(st + rank * HALF_BYTES, &p.x, bar, c0, hx + dx, hy + dy, b, 0x3);
      tma_load_3d(st + A_BYTES, &p.w, bar, c0, tap, inner * BN);
    } else {
      // the A box: this block's own pixels; the weight: this block's half of
      // the rows, into both blocks (their pixel tiles share the columns)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int hx = x, hy = y;
        half(p, h, hx, hy);
        tma_load_4d(st + h * HALF_BYTES, &p.x, bar, c0, hx + dx, hy + dy, b);
      }
      tma_load_3d_multicast(st + A_BYTES + rank * (BN / 2) * 64, &p.w, bar, c0, tap,
                            inner * BN + rank * (BN / 2), 0x3);
    }
  }

  // k32 step s of the stage: each 64 pixels of the warpgroup's (half wg of
  // the A box) by the tile's BN weight rows, both 64-byte rows in the 64-byte
  // swizzle.
  __device__ static void mma(Acc& acc, uint32_t st, int s, int accumulate,
                             const gemm::Thread& th) {
    const uint64_t db = smem_desc_sw64(st + A_BYTES + 32 * s);
#pragma unroll
    for (int m = 0; m < MW; ++m)
      wgmma_s8_ss<BN>(acc[m], smem_desc_sw64(st + th.wg * HALF_BYTES + m * 4096 + 32 * s), db,
                      accumulate);
  }

  // The columns' sw[n] * sx, bias[n] and temb[b, n], two a thread: n0 + 2 tid,
  // + 1; and the warpgroup's barrier for its residual tile.
  struct Pre {
    float2 s, b, e;
    uint32_t aux, parity;
  };

  // When the tile has a residual, the warpgroup's first thread also loads it
  // into the staging tile by TMA (once the last tile's store has read it), in
  // the layout the output will take there.
  __device__ static Pre prefetch(const Params& p, int outer, int inner, const gemm::Thread& th,
                                 const gemm::Staging& stg) {
    Pre pre{make_float2(0.f, 0.f), make_float2(0.f, 0.f), make_float2(0.f, 0.f), stg.aux,
            uint32_t(stg.n & 1)};
    int b, y, x;
    origin(p, outer, b, y, x);
    const int n = inner * BN + 2 * th.tid;
    if (2 * th.tid < BN && n < p.n) {  // O % 8 == 0: n + 1 is inside too
      pre.s = __ldg(reinterpret_cast<const float2*>(p.sw + n));
      if (p.bias != nullptr) pre.b = __ldg(reinterpret_cast<const float2*>(p.bias + n));
      if (p.temb != nullptr && b < p.batch)
        pre.e = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.temb + (size_t)b * p.n + n));
    }
    pre.s.x = __fmul_rn(pre.s.x, p.sx);
    pre.s.y = __fmul_rn(pre.s.y, p.sx);
    if (p.has_res && th.tid == 0) {
      bulk_wait_read();
      bar_arrive_expect_tx(stg.aux, TILE_BYTES);
      half(p, th.wg, x, y);
#pragma unroll
      for (int q = 0; q < BN / 32; ++q)
        tma_load_4d(stg.out + q * PANEL_BYTES, &p.res, stg.aux, inner * BN + 32 * q, x, y, b);
    }
    return pre;
  }

  // acc[m] register 4j + 2r + e holds pixel 64 m + 16 warp + g + 8r of the
  // warpgroup's, column n0 + 8j + 2t + e. The staging tile is BN / 32 panels
  // of HALF_PIX pixels x 64 bytes (32 bf16 columns) in the 64-byte swizzle
  // (16-byte chunk c of row r at c ^ ((r >> 1) & 3)); the column values
  // follow it. One stmatrix (and, with a residual, one ldmatrix first) per two
  // 8-column groups.
  __device__ static void stage_out(Acc& acc, const Pre& pre, uint32_t out, const Params& p, int,
                                   int, const gemm::Thread& th) {
    const uint32_t cols = out + TILE_BYTES;  // BN scales, BN biases, BN time embeddings
    if (2 * th.tid < BN) {
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 8 * th.tid), "f"(pre.s.x),
                   "f"(pre.s.y) : "memory");
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 4 * BN + 8 * th.tid),
                   "f"(pre.b.x), "f"(pre.b.y) : "memory");
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cols + 8 * BN + 8 * th.tid),
                   "f"(pre.e.x), "f"(pre.e.y) : "memory");
    }
    sync_warpgroup(1 + th.wg);
    if (p.has_res) bar_wait(pre.aux, pre.parity);
    const int mi = th.lane >> 3;  // the matrix this lane addresses a row of
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int row = 64 * m + 16 * th.warp + 8 * (mi & 1) + (th.lane & 7);
      const uint32_t base = out + row * 64, swz = (row >> 1) & 3;
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj) {
        const int jm = 2 * jj + (mi >> 1);
        const uint32_t addr = base + (jm >> 2) * PANEL_BYTES + (((jm & 3) ^ swz) << 4);
        uint32_t res[4] = {0, 0, 0, 0};
        if (p.has_res) ldmatrix4(res, addr);
        uint32_t r[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * jj + h;
          const uint2 su = lds64(cols + 32 * j + 8 * th.t);
          const uint2 bu = lds64(cols + 4 * BN + 32 * j + 8 * th.t);
          const uint2 eu = lds64(cols + 8 * BN + 32 * j + 8 * th.t);
          const float s[2] = {__uint_as_float(su.x), __uint_as_float(su.y)};
          const float bb[2] = {__uint_as_float(bu.x), __uint_as_float(bu.y)};
          const float e[2] = {__uint_as_float(eu.x), __uint_as_float(eu.y)};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const uint32_t rw = res[2 * h + rr];
            const float rv[2] = {__uint_as_float(rw << 16), __uint_as_float(rw & 0xffff0000u)};
            float v[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              // __fmul_rn / __fadd_rn: each step rounds as the plain version's
              v[k] = __fmul_rn(__int2float_rn(acc[m][4 * j + 2 * rr + k]), s[k]);
              if (p.bias != nullptr) v[k] = __fadd_rn(v[k], bb[k]);
              if (p.temb != nullptr) v[k] = __fadd_rn(v[k], e[k]);
              if (p.has_res) v[k] = __fadd_rn(v[k], rv[k]);
            }
            r[2 * h + rr] = pack_bf16(v[0], v[1]);
          }
        }
        stmatrix4<false>(addr, r);
      }
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

template <int BN, int MW>
__global__ void __cluster_dims__(gemm::CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ typename Conv<BN, MW>::Params p) {
  gemm::run<Conv<BN, MW>>(p);
}

// Opts the kernel into its shared memory, once.
template <int BN, int MW>
cudaError_t prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(gemm::Layout<Conv<BN, MW>>::BYTES));
  return attr;
}

template <int BN, int MW>
int max_clusters() {
  return prepare<BN, MW>() == cudaSuccess
             ? gemm::max_clusters(conv3x3_wgmma_kernel<BN, MW>,
                                  gemm::Layout<Conv<BN, MW>>::BYTES)
             : 0;
}

struct Shape {
  int B, H, W, C, O;
};

// A map over an NHWC tensor (B, H, W, ch) of `type` (`elem` bytes), read as
// (ch, W, H, B) boxes of box_ch channels x the half tile's pixels.
CUresult nhwc_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                  const Shape& s, int ch, int box_ch, int pw, int ph) {
  const uint64_t dims[4] = {uint64_t(ch), uint64_t(s.W), uint64_t(s.H), uint64_t(s.B)};
  const uint64_t row = uint64_t(ch) * elem;
  const uint64_t bytes[3] = {row, row * s.W, row * s.W * s.H};
  const uint32_t box[4] = {uint32_t(box_ch), uint32_t(pw), uint32_t(ph), 1};
  return make_map_nd(map, type, ptr, 4, dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int BN, int MW>
int launch_conv(const void* xq, const void* wq, const void* sw, const void* bias,
                const void* temb, const void* res, void* out, const Shape& s, float sx, int tw,
                int pair_inner, int grid, cudaStream_t stream) {
  using S = Conv<BN, MW>;
  const cudaError_t attr = prepare<BN, MW>();
  if (attr != cudaSuccess) return int(attr);
  const int th = 128 * MW / tw;
  const int pw = th == 1 ? S::HALF_PIX : tw, ph = th == 1 ? 1 : th / 2;
  typename S::Params p;
  CUresult r = nhwc_map(&p.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, s, s.C, 64, pw, ph);
  if (r == CUDA_SUCCESS) {
    const uint64_t dims[3] = {uint64_t(s.C), 9, uint64_t(s.O)};
    const uint64_t bytes[2] = {uint64_t(s.C), uint64_t(s.C) * 9};
    const uint32_t box[3] = {64, 1, uint32_t(pair_inner ? BN : BN / 2)};
    r = make_map_nd(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 3, dims, bytes, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (r == CUDA_SUCCESS)
    r = nhwc_map(&p.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, s, s.O, 32, pw, ph);
  if (r == CUDA_SUCCESS && res != nullptr)
    r = nhwc_map(&p.res, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, res, s, s.O, 32, pw, ph);
  if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(r);
  p.tw = tw;
  p.th = th;
  p.tiles_w = (s.W + tw - 1) / tw;
  p.tiles_hw = p.tiles_w * ((s.H + th - 1) / th);
  p.chunks = (s.C + 63) / 64;
  const int outer = s.B * p.tiles_hw, inner = (s.O + BN - 1) / BN;
  const int unit_inner = pair_inner ? (inner + 1) / 2 : inner;
  p.walk = {unit_inner, pair_inner ? outer * unit_inner : (outer + 1) / 2 * inner, 9 * p.chunks,
            pair_inner};
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.temb = static_cast<const __nv_bfloat16*>(temb);
  p.n = s.O;
  p.batch = s.B;
  p.has_res = res != nullptr;
  p.sx = sx;
  conv3x3_wgmma_kernel<BN, MW><<<grid, THREADS, gemm::Layout<S>::BYTES, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// The activation pass: x (B, H, W, C) bf16 -> xq (B, H, W, C) int8. With
// mean / inv ((B, groups) fp32, the GroupNorm statistics) the fused form,
// q(SiLU(x * scale + shift)) with gamma / beta (C,) fp32, or bf16 if
// affine_bf16; else q(x) (mean, inv, gamma, beta null). C % 8 == 0. Returns
// the cudaError_t of the launch.
extern "C" int conv3x3_act_quant(const void* x, const void* mean, const void* inv,
                                 const void* gamma, const void* beta, int affine_bf16,
                                 int groups, void* xq, int B, int H, int W, int C, float inv_sx,
                                 void* stream) {
  const int c8 = C / 8, hwc8 = H * W * c8;
  if (B == 0 || hwc8 == 0) return 0;
  if (C % 8 != 0 || B > 65535 || (mean != nullptr && C % groups != 0))
    return int(cudaErrorInvalidValue);
  // about 4 chunks a thread, in blocks whose count makes the stride a
  // multiple of C / 8 (a pixel's chunks)
  int step = 1;
  while ((step * ACT_THREADS) % c8 != 0) ++step;
  int blocks = (hwc8 + 4 * ACT_THREADS - 1) / (4 * ACT_THREADS);
  blocks = (blocks + step - 1) / step * step;
  if (blocks > 65535) blocks = 65535 / step * step;
  const dim3 grid(blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  if (mean != nullptr)
    act_quant_kernel<true><<<grid, ACT_THREADS, 0, s>>>(
        xb, static_cast<const float*>(mean), static_cast<const float*>(inv), gamma, beta,
        affine_bf16, q, hwc8, C, groups, inv_sx);
  else
    act_quant_kernel<false><<<grid, ACT_THREADS, 0, s>>>(xb, nullptr, nullptr, nullptr, nullptr,
                                                         0, q, hwc8, C, 1, inv_sx);
  return int(cudaGetLastError());
}

// The widths compiled, as (output channels, pixels) of a tile.
#define CONV_VARIANTS(X) X(160, 256) X(128, 256) X(160, 128)

// The conv of the int8 map xq (B, H, W, C) with wq (O, 3, 3, C) int8: out
// (B, H, W, O) bf16 = acc * (sw * sx) + bias (+ temb (B, O)) (+ residual
// (B, H, W, O)), sw / bias (O,) fp32; bias, temb and residual may be null.
// All contiguous and 16-byte aligned; C % 16 == 0, O % 8 == 0. tile and
// pixels: the output channels and pixels of a tile (CONV_VARIANTS); tw: its
// pixels along W (a power of two from 8 to `pixels`, pixels / tw rows);
// pair_inner: a cluster's blocks take two column tiles of the same pixels
// (else two pixel tiles of the same columns); grid: the blocks of the
// persistent walk (ops/gemm_tiles.py's conv_plan picks all five). Returns
// the cudaError_t of the launch, or 10000 + the CUresult of a tensor map
// that libcuda refused.
extern "C" int conv3x3_gemm(const void* xq, const void* wq, const void* sw, const void* bias,
                            const void* temb, const void* residual, void* out, int B, int H,
                            int W, int C, int O, float sx, int tile, int pixels, int tw,
                            int pair_inner, int grid, void* stream) {
  if (B == 0 || H == 0 || W == 0 || O == 0) return 0;
  if (grid < 1 || grid % gemm::CLUSTER != 0 || C % 16 != 0 || O % 8 != 0 || tw < 8 ||
      tw > pixels || (tw & (tw - 1)) != 0)
    return int(cudaErrorInvalidValue);
  const Shape s{B, H, W, C, O};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONV_LAUNCH(BN, PIX)                                                                \
  if (tile == BN && pixels == PIX)                                                          \
    return launch_conv<BN, PIX / 128>(xq, wq, sw, bias, temb, residual, out, s, sx, tw,      \
                                      pair_inner, grid, st);
  CONV_VARIANTS(CONV_LAUNCH)
#undef CONV_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The dynamic shared memory of a block of a compiled tile (0 if not compiled).
extern "C" int conv3x3_smem(int tile, int pixels) {
#define CONV_SMEM(BN, PIX) \
  if (tile == BN && pixels == PIX) return int(gemm::Layout<Conv<BN, PIX / 128>>::BYTES);
  CONV_VARIANTS(CONV_SMEM)
#undef CONV_SMEM
  return 0;
}

// The 2-block clusters of a compiled tile that fit on the card at once.
extern "C" int conv3x3_max_clusters(int tile, int pixels) {
#define CONV_CLUSTERS(BN, PIX) \
  if (tile == BN && pixels == PIX) return max_clusters<BN, PIX / 128>();
  CONV_VARIANTS(CONV_CLUSTERS)
#undef CONV_CLUSTERS
  return 0;
}
