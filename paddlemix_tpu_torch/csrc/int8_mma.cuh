// Core of the int8 a8w8 3x3 conv kernels (int8_conv3x3.cu: B3, B5):
// a 128 x 128 output tile of out[m, n] = sx * sw[n] * sum_k A[m, k] * Wq[n, k]
// (+ epilogue terms), with A quantized to int8 as it is loaded.
//
// The tile is summed on the tensor cores by mma.sync.m16n8k32.s8.s8.s32,
// exactly in int32. 256 threads = 8 warps as 2 (M) x 4 (N), each warp a 64 x 32
// sub-tile (4 x 4 MMA tiles). K advances 64 at a time through two shared-memory
// stages: the next K tile is read from global memory into registers while the
// current one is multiplied, then stored into the other stage.
//
// Fragments come from shared memory by ldmatrix.x4: four 8-row x 16-byte
// matrices a load, which is the m16n8k32 s8 operand layout (a row of 16 bytes
// is 8 b16 pairs, so lane l receives bytes 4*(l%4) .. +3 of row l/4).
//
// A is read as bf16 (16 bytes = 8 values a load) by a loader the caller gives:
// `ALoader::fetch` only issues the global loads of the next K tile into
// registers (`ALoader::Raw`), so that they are in flight while the current
// tile is multiplied; `ALoader::convert` then quantizes each chunk,
// __float2int_rn(v * (1/sx)) (round half to even) clipped to +-127, into 8
// int8 values packed in a uint2, as it is stored to shared memory. Wq is int8,
// K-contiguous per output column, read 16 bytes a load. Shared-memory rows
// are padded from 64 to 80 bytes, so the 8 rows that one ldmatrix phase reads
// fall in different banks.
//
// The epilogue goes through shared memory: the int32 tile is written there as
// fp32, then each thread reads 8 consecutive columns of a row, applies
// acc * (sw[n] * sx) + bias[n] (+ the caller's extra terms, all in fp32) and
// stores 8 bf16 values in one 16-byte store. Rows past M and column chunks past
// N (N % 8 == 0) are masked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8mma {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int LDS = BK + 16;                         // bytes per shared-memory row
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;      // 4 chunks of 8 values a thread
constexpr int B_CHUNKS = BN * BK / 16 / THREADS;     // 2 chunks of 16 bytes a thread
constexpr int LDC = BN + 4;                          // floats per epilogue row
constexpr int SMEM_PIPE = 2 * (BM + BN) * LDS;       // 40,960 bytes
constexpr int SMEM_EPI = BM * LDC * 4;               // 67,584 bytes
constexpr int SMEM_BYTES = SMEM_PIPE > SMEM_EPI ? SMEM_PIPE : SMEM_EPI;

// The A loader's thread -> chunk map: chunk i of a thread is row
// (tid >> 3) + 32 * i of the tile, K offset (tid & 7) * 8 inside the K tile.
__device__ __forceinline__ int a_row(int i) { return (threadIdx.x >> 3) + 32 * i; }
__device__ __forceinline__ int a_col() { return (threadIdx.x & 7) * 8; }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t q8(float v, float inv_sx) {
  int q = __float2int_rn(v * inv_sx);
  q = max(-127, min(127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// 8 fp32 values -> 8 int8 packed little-endian (value 0 in the lowest byte).
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float inv_sx) {
  uint2 r;
  r.x = q8(v[0], inv_sx) | (q8(v[1], inv_sx) << 8) | (q8(v[2], inv_sx) << 16) |
        (q8(v[3], inv_sx) << 24);
  r.y = q8(v[4], inv_sx) | (q8(v[5], inv_sx) << 8) | (q8(v[6], inv_sx) << 16) |
        (q8(v[7], inv_sx) << 24);
  return r;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z); v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mi][ni][r]: MMA tile (mi, ni) of the warp's 64 x 32 sub-tile; register r
// holds row g (r < 2) or g + 8 (r >= 2), column 2 * t + (r & 1), where g is
// lane / 4 and t is lane % 4 (the m16n8 accumulator layout of the PTX ISA).
template <class ALoader>
__device__ __forceinline__ void mainloop(ALoader& al, const int8_t* __restrict__ wq, int N,
                                         int K, int n0, char* smem, int (&acc)[4][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  char* As = smem;                  // [2][BM][LDS]
  char* Bs = smem + 2 * BM * LDS;   // [2][BN][LDS]

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  typename ALoader::Raw ra[A_CHUNKS];
  uint4 rb[B_CHUNKS];
  auto load_b = [&](int kt) {
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS, n = n0 + (c >> 2), k = kt * BK + (c & 3) * 16;
      rb[i] = (n < N && k < K) ? *reinterpret_cast<const uint4*>(wq + (size_t)n * K + k)
                               : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int stage) {
    char* as = As + stage * BM * LDS;
    char* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      *reinterpret_cast<uint2*>(as + a_row(i) * LDS + a_col()) = al.convert(ra[i]);
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(bs + (c >> 2) * LDS + (c & 3) * 16) = rb[i];
    }
  };

  const int ktiles = (K + BK - 1) / BK;
  al.fetch(0, ra);
  load_b(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      al.fetch(kt + 1, ra);
      load_b(kt + 1);
    }
    const char* as = As + stage * BM * LDS;
    const char* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bfr[4][2];
      // A: lanes 0-15 address rows 0-15 at byte ks, lanes 16-31 the same rows
      // at ks + 16; the four matrices land in a0..a3
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * LDS + ks + (lane >> 4) * 16);
      // B: one load covers the k halves of two 8-column tiles ni, ni + 1
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
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < ktiles) store(stage ^ 1);
    __syncthreads();
  }
}

// Writes the int32 tile to shared memory as fp32 and calls
// epi(m, n, v) for every chunk of 8 columns [n, n + 8) of row m inside
// (M, N), with v[j] = acc[m, n + j] * (sw[n + j] * sx) + bias[n + j].
template <class Epi>
__device__ __forceinline__ void epilogue(int (&acc)[4][4][4], int M, int N, int m0, int n0,
                                         float sx, const float* __restrict__ sw,
                                         const float* __restrict__ bias, char* smem,
                                         const Epi& epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC]; the mainloop ended on a barrier
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * LDC + c) =
          make_float2((float)acc[mi][ni][0], (float)acc[mi][ni][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * LDC + c) =
          make_float2((float)acc[mi][ni][2], (float)acc[mi][ni][3]);
    }
  __syncthreads();
#pragma unroll 2
  for (int i = 0; i < BM * BN / 8 / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c >> 4, cc = (c & 15) * 8;
    const int m = m0 + r, n = n0 + cc;
    if (m >= M || n >= N) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(Cs + r * LDC + cc);
    const float4 a1 = *reinterpret_cast<const float4*>(Cs + r * LDC + cc + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(sw + n);
    const float4 s1 = *reinterpret_cast<const float4*>(sw + n + 4);
    // __fmul_rn / __fadd_rn are never contracted into an FMA, so each step
    // rounds as the plain PyTorch version's separate multiply and add do
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(a[j], __fmul_rn(s[j], sx));
    if (bias != nullptr) {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], b[j]);
    }
    epi(m, n, v);
  }
}

// Stores 8 fp32 values as 8 bf16 at p (16-byte aligned).
__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 o;
  o.x = pack_bf16x2(v[0], v[1]);
  o.y = pack_bf16x2(v[2], v[3]);
  o.z = pack_bf16x2(v[4], v[5]);
  o.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = o;
}

// Opts a kernel into more than 48 KB of dynamic shared memory. Callers keep
// the result in a static of their own, so that it runs once per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace i8mma
