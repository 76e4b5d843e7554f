// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v/o, fp32 online softmax.
//
// Replaces the Pallas kernel paddlemix_tpu/ops/attention.py `_fwd_kernel` (:83),
// called through `_flash_fwd` (:168, pallas_call at :243), in its three forms: the
// inference form (B1, no lse output), which serves the self-attention of the
// SD1.5 and SDXL UNets and the SD3 MM-DiT; the form that also writes the base-2
// log-sum-exp of each row (B15, `want_lse`; `flash_attention_with_lse`, :561),
// which is the residual of the flash backward (csrc/flash_bwd.cu) on the
// training path; and the inference form with int8 QK^T (`int8_qk`,
// PMIX_INT8_ATTN=1), which the SDXL static-a8w8 request runs. Options, as in
// the TPU kernel: causal (top-left aligned, col <= row; key tiles wholly above
// the diagonal are skipped), segment ids (a key is seen only by queries of the
// same id, from two int32 arrays), and GQA (query head h reads kv head
// h / group). Head dims 32, 64, 96, 128, 160 and 256 are compiled; the wrapper
// pads other widths up to the next one with zero columns.
//
// What bounds it: at head_dim 64-256 the two products do 4*S*S*D flops per head
// for 4*S*D*2 bytes of q/k/v/o, so the card is compute-bound: the limit is how
// well the tensor cores are fed, and, at D 64, the exp2 unit (16 a clock an
// SM, one exp2 per 4*D = 256 tensor-core flops, against 1,024 bf16 flops a
// clock). The scores never reach device memory.
//
// Two cores, chosen by a fixed table of the compiled head_dim (`dispatch`),
// never by the outcome of a launch:
//
// The wgmma core (bf16 at D 64 and 128, inference and lse forms, every
// option; namespace `wg`, with the Hopper blocks it shares with the backward
// in csrc/wgmma.cuh). A block owns 128 query rows of one (batch, head):
// two consumer warpgroups of 64 rows and a producer warpgroup, whose first
// warp alone works and which hands its registers to the consumers
// (`setmaxnreg`: 24 / 240). The producer loads Q once by TMA, then walks the
// key tiles (128 keys) into a ring of three K/V stages, each with a full and
// an empty mbarrier; it also copies the tile's key segment ids beside it.
// TMA reads q/k/v through 4-d tensor maps over their (D, H, S, B) strided
// views (built per call on the host; GQA's kv head is a coordinate), writes
// each 64-column panel in the 128-byte swizzle and fills rows past S with
// zeros, so the ragged edges need no padding copies: keys past S get -inf
// scores, rows past S are not stored. Each consumer runs
// S = Q K^T as m64n128k16 `wgmma` with both operands in shared memory
// (K-major descriptors), the online softmax in fp32 and base 2 on the
// accumulator registers (only the tiles at the causal diagonal, at the ragged
// end or with segment ids are masked), rounds P to bf16 in registers, in the
// order the next `wgmma` takes its A operand (the m64nN accumulator's
// registers 8kk..8kk+7 are the A fragment of the k16 step kk), and runs
// O += P V as m64nDk16 `wgmma` with A from registers and V as an MN-major
// (transposed) operand. O, m and l stay in registers for the whole walk; O is
// written once, by plain stores. Within a warpgroup the products of
// neighbouring tiles overlap: tile t's S = Q K^T is issued together with tile
// t - 1's P V, and t's softmax runs while that P V is still on the tensor
// cores; a stage is released when its P V is done. Causal blocks are launched
// longest first. 128 query rows a block at every shape the paths run: the
// smallest grid (SDXL's 1,024-token layers, 320 blocks of one an SM, 2.4
// waves) would take as many waves with 64-row blocks at two an SM.
// The lse form keeps the TPU wrapper's contract: q arrives pre-scaled by
// scale * log2(e) and rounded to bf16, scale_log2 = 1, and the lse is m +
// log2(l) in base 2, from which B14 recomputes p = exp2(s - lse).
//
// The WMMA core (bf16 at D 32, 96, 160 and 256; the int8 QK^T form at every
// width). A block owns 64 query rows of one (batch, head), keeps them in
// shared memory as four 16-row warp tiles, and walks the keys in 64-row
// tiles loaded synchronously into shared memory. Each warp computes
// S = Q K^T with 16x16x16 bf16 WMMA fragments (fp32 accumulate) into shared
// memory, runs the online softmax there in fp32 with exp2 and scale*log2(e)
// folded into the scores, rounds P to bf16 (as the TPU kernel does before its
// PV product) and accumulates O += P V into an fp32 tile in shared memory,
// which it rescales row by row with the softmax correction. q/k/v/o are read
// and written in their (B, S, H, D) layout through strides. O in shared memory
// makes the width cost shared memory and not registers: 133,376 bytes at
// D 160 and 194,816 at D 256 (one block an SM).
//
// int8 QK^T (the TPU kernel's `int8_qk` branch and the XLA prologue of its
// wrapper): each q row and each k row is quantized to int8 with its own
// symmetric scale as its tile is loaded, with the fp32 operations of the
// plain version (ops/attention.py `quantize_rows_int8`): a = max(max|x|,
// 1e-9), x8 = clip(rint(x * (127 / a)), +-127), q's scale (a / 127) *
// scale_log2, k's a / 127. S is summed exactly in int32 on the tensor cores
// by mma.sync m16n8k32 s8.s8.s32 (fragments by ldmatrix.x4, below) and
// dequantized row by row, s = (s32 * sq) * sk,
// so the scores equal the plain version's bit for bit; the softmax and the
// bf16 P V are B1's. Quantizing inside the block needs no pass over q / k in
// device memory; k tiles are quantized again by each query block, which is
// cheap next to the products. The int8 form has no lse output: under autograd
// the forward stays bf16, as in JAX.
//
// Left for later work: the other widths and the int8 form on the wgmma core
// (s8 `wgmma`), a head-40 instantiation, scheduling the two consumer
// warpgroups' softmax against each other, and skipping key tiles that no query
// of the block shares a segment with, as the backward's wgmma core now does
// (csrc/flash_bwd.cu `judge`: segment ids that share no id).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // key rows per tile
constexpr int NUM_WARPS = BLOCK_M / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD_H = 8;  // bf16 row padding: keeps WMMA ldm a multiple of 8, spreads banks
constexpr int PAD_F = 4;  // fp32 row padding

template <int D, bool INT8>
struct Layout {
  static constexpr int LD_QKV = D + PAD_H;
  static constexpr int LD_S = BLOCK_N + PAD_F;
  static constexpr int LD_P = BLOCK_N + PAD_H;
  static constexpr int LD_O = D + PAD_F;
  // int8 rows: D + 16 bytes keeps every row 16-byte aligned for ldmatrix and
  // puts the 8 rows one ldmatrix phase reads in different banks
  static constexpr int LD_8 = D + 16;
  // every section is a multiple of 32 bytes, so every WMMA tile pointer is 32-byte aligned
  static constexpr size_t Q_BYTES = size_t(BLOCK_M) * LD_QKV * sizeof(bf16);
  static constexpr size_t KV_BYTES = size_t(BLOCK_N) * LD_QKV * sizeof(bf16);
  static constexpr size_t S_BYTES = size_t(BLOCK_M) * LD_S * sizeof(float);
  static constexpr size_t P_BYTES = size_t(BLOCK_M) * LD_P * sizeof(bf16);
  static constexpr size_t O_BYTES = size_t(BLOCK_M) * LD_O * sizeof(float);
  static constexpr size_t SEG_BYTES = size_t(BLOCK_N) * sizeof(int);
  static constexpr size_t Q8_BYTES = INT8 ? size_t(BLOCK_M) * LD_8 : 0;
  static constexpr size_t K8_BYTES = INT8 ? size_t(BLOCK_N) * LD_8 : 0;
  static constexpr size_t SCALE_BYTES = INT8 ? size_t(BLOCK_M + BLOCK_N) * sizeof(float) : 0;
  static constexpr size_t Q8_OFF = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES +
                                   SEG_BYTES;
  static constexpr size_t TOTAL = Q8_OFF + Q8_BYTES + K8_BYTES + SCALE_BYTES;
};

// Copy `rows` x D bf16 rows (row stride `stride` elements) into shared memory
// with 16-byte vectors; rows past `valid` are zero-filled so that masked keys
// contribute 0 * 0 and never 0 * garbage.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int valid, int stride) {
  constexpr int VEC = 8;
  constexpr int VPR = D / VEC;
  constexpr int LD = D + PAD_H;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NUM_THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + int64_t(r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Quantize a tile of 64 bf16 rows in shared memory (stride D + PAD_H) to int8
// rows (stride D + 16 bytes) and one fp32 scale a row, two threads a row, with
// the plain version's fp32 operations: a = max(max|x|, 1e-9) (exact), then
// x8 = clip(rint(x * (127 / a)), +-127) and scale = (a / 127) * mul, each
// operation rounded once (the _rn intrinsics are never contracted into an
// FMA). Zero-filled rows quantize to 0.
template <int D>
__device__ __forceinline__ void quantize_tile(const bf16* src, int8_t* dst, float* scale,
                                              float mul) {
  static_assert(2 * BLOCK_M == NUM_THREADS && BLOCK_M == BLOCK_N, "two threads a row");
  constexpr int HALF = D / 2;  // a multiple of 16 for every compiled D
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  const bf16* row = src + r * (D + PAD_H) + part * HALF;
  float amax = 0.f;
#pragma unroll 8
  for (int c = 0; c < HALF; ++c) amax = fmaxf(amax, fabsf(__bfloat162float(row[c])));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));  // the row's other half
  amax = fmaxf(amax, 1e-9f);
  const float inv = __fdiv_rn(127.f, amax);
  uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * (D + 16) + part * HALF);
#pragma unroll 4
  for (int c = 0; c < HALF; c += 4) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int v = __float2int_rn(__fmul_rn(__bfloat162float(row[c + j]), inv));
      v = max(-127, min(127, v));
      word |= (static_cast<uint32_t>(v) & 0xffu) << (8 * j);
    }
    out[c / 4] = word;
  }
  if (part == 0) scale[r] = __fmul_rn(__fdiv_rn(amax, 127.f), mul);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
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

// S = Q8 K8^T for one warp's 16 query rows against the 64 keys of the tile,
// exact in int32, then s = (s32 * sq[row]) * sk[col] into the warp's rows of
// sS. Fragments come by ldmatrix.x4 from the int8 rows (a row of 16 bytes
// is 8 b16 pairs, so lane l receives bytes 4 (l % 4) .. + 3 of row l / 4):
// A rows (lane & 15) at byte ks + 16 (lane >> 4); one B
// load covers the two k halves of two 8-key tiles. Accumulator register r of
// tile ni holds row g (r < 2) or g + 8, key ni * 8 + 2t + (r & 1), with g =
// lane / 4 and t = lane % 4.
template <int D>
__device__ __forceinline__ void scores_int8(const int8_t* sQ8, const int8_t* sK8,
                                            const float* sQs, const float* sKs, float* wS,
                                            int warp, int lane) {
  constexpr int LD8 = D + 16;
  constexpr int LD_S = BLOCK_N + PAD_F;
  int acc[BLOCK_N / 8][4];
#pragma unroll
  for (int ni = 0; ni < BLOCK_N / 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0;
#pragma unroll
  for (int ks = 0; ks < D; ks += 32) {
    uint32_t af[4];
    ldsm_x4(af, sQ8 + (warp * 16 + (lane & 15)) * LD8 + ks + (lane >> 4) * 16);
#pragma unroll
    for (int ni = 0; ni < BLOCK_N / 8; ni += 2) {
      uint32_t r[4];
      ldsm_x4(r, sK8 + (ni * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD8 + ks +
                     ((lane >> 3) & 1) * 16);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_s8(acc[ni], af, b0);
      mma_s8(acc[ni + 1], af, b1);
    }
  }
  const int g = lane >> 2, t = lane & 3;
  const float sq0 = sQs[warp * 16 + g], sq1 = sQs[warp * 16 + g + 8];
#pragma unroll
  for (int ni = 0; ni < BLOCK_N / 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r < 2 ? g : g + 8;
      const int col = ni * 8 + 2 * t + (r & 1);
      wS[row * LD_S + col] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[ni][r]), r < 2 ? sq0 : sq1), sKs[col]);
    }
}

template <int D, bool INT8>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int seq_q, int seq_kv,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                 float scale_log2, int group, int causal, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, int qseg_sb, int kseg_sb,
                 float* __restrict__ lse) {
  using L = Layout<D, INT8>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* sS = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);
  float* sO = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES +
                                       L::P_BYTES);
  int* sKseg = reinterpret_cast<int*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES +
                                      L::P_BYTES + L::O_BYTES);
  // int8 QK^T only: the quantized q and k tiles and their row scales
  int8_t* sQ8 = reinterpret_cast<int8_t*>(smem + L::Q8_OFF);
  int8_t* sK8 = reinterpret_cast<int8_t*>(smem + L::Q8_OFF + L::Q8_BYTES);
  float* sQs = reinterpret_cast<float*>(smem + L::Q8_OFF + L::Q8_BYTES + L::K8_BYTES);
  float* sKs = sQs + BLOCK_M;

  const int m0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<D, BLOCK_M>(sQ, q + int64_t(b) * q_sb + int64_t(h) * q_sh + int64_t(m0) * q_ss,
                        min(BLOCK_M, seq_q - m0), q_ss);
  for (int i = threadIdx.x; i < BLOCK_M * L::LD_O; i += NUM_THREADS) sO[i] = 0.f;
  __syncthreads();

  // bf16: the warp's q rows stay in WMMA fragments; int8: q is quantized once,
  // with scale*log2(e) folded into its row scales, and the scores need no
  // further scaling
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[INT8 ? 1 : D / 16];
  float s_mul = scale_log2;
  if constexpr (INT8) {
    quantize_tile<D>(sQ, sQ8, sQs, scale_log2);
    s_mul = 1.f;
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::LD_QKV + kk * 16, L::LD_QKV);
  }

  // Softmax state: lane pair (2r, 2r+1) owns row r of the warp's 16 rows and
  // splits its columns even/odd (interleaved to spread shared-memory banks).
  const int row = lane >> 1;
  const int half = lane & 1;
  float m_i = -INFINITY;
  float l_i = 0.f;
  float* wS = sS + warp * 16 * L::LD_S;
  bf16* wP = sP + warp * 16 * L::LD_P;
  float* wO = sO + warp * 16 * L::LD_O;
  const int grow = m0 + warp * 16 + row;  // this lane pair's query row
  const int my_seg = (qseg != nullptr && grow < seq_q) ? qseg[int64_t(b) * qseg_sb + grow] : 0;

  const int hk = h / group;  // GQA: the kv head this query head reads
  const bf16* kb = k + int64_t(b) * k_sb + int64_t(hk) * k_sh;
  const bf16* vb = v + int64_t(b) * v_sb + int64_t(hk) * v_sh;
  // causal: the block's last row is m0 + 63, so later key tiles are all masked
  const int n_end = causal ? min(seq_kv, m0 + BLOCK_M) : seq_kv;
  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    const int n_valid = min(BLOCK_N, seq_kv - n0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BLOCK_N>(sK, kb + int64_t(n0) * k_ss, n_valid, k_ss);
    load_tile<D, BLOCK_N>(sV, vb + int64_t(n0) * v_ss, n_valid, v_ss);
    if (kseg != nullptr && int(threadIdx.x) < BLOCK_N)
      sKseg[threadIdx.x] = int(threadIdx.x) < n_valid
                               ? kseg[int64_t(b) * kseg_sb + n0 + threadIdx.x] : 0;
    __syncthreads();

    if constexpr (INT8) {
      quantize_tile<D>(sK, sK8, sKs, 1.f);
      __syncthreads();
      scores_int8<D>(sQ8, sK8, sQs, sKs, wS, warp, lane);
    } else {
      // S = Q K^T for this warp's 16 rows: K is (n, d) row-major, so K^T is col-major.
#pragma unroll
      for (int j = 0; j < BLOCK_N / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, sK + j * 16 * L::LD_QKV + kk * 16, L::LD_QKV);
          wmma::mma_sync(sf, qf[kk], kf, sf);
        }
        wmma::store_matrix_sync(wS + j * 16, sf, L::LD_S, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Online softmax in base 2 (fp32).
    const float* srow = wS + row * L::LD_S;
    float vals[BLOCK_N / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BLOCK_N / 2; ++c) {
      const int col = 2 * c + half;
      bool keep = col < n_valid;
      if (causal) keep = keep && n0 + col <= grow;
      if (kseg != nullptr) keep = keep && sKseg[col] == my_seg;
      const float s = keep ? srow[col] * s_mul : -INFINITY;
      vals[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_i - base);  // 0 on the first tile (m_i = -inf)
    float sum = 0.f;
    bf16* prow = wP + row * L::LD_P;
#pragma unroll
    for (int c = 0; c < BLOCK_N / 2; ++c) {
      const float p = exp2f(vals[c] - base);
      sum += p;
      prow[2 * c + half] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    float* orow = wO + row * L::LD_O;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[2 * c + half] *= alpha;
    __syncwarp();

    // O += P V (V is (n, d) row-major).
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[BLOCK_N / 16];
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], wP + kk * 16, L::LD_P);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, wO + j * 16, L::LD_O, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::LD_QKV + j * 16, L::LD_QKV);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(wO + j * 16, of, L::LD_O, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Normalise and store; l == 0 cannot happen without a fully masked row, but
  // is guarded as the TPU kernel guards it.
  const float inv = l_i == 0.f ? 1.f : 1.f / l_i;
  if (lse != nullptr && half == 0 && grow < seq_q)  // base 2: m + log2(l), as the TPU kernel
    lse[(int64_t(b) * gridDim.y + h) * seq_q + grow] = m_i + log2f(l_i == 0.f ? 1.f : l_i);
  if (grow < seq_q) {
    bf16* og = o + int64_t(b) * o_sb + int64_t(h) * o_sh + int64_t(grow) * o_ss;
    const float* orow = wO + row * L::LD_O;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) og[2 * c + half] = __float2bfloat16(orow[2 * c + half] * inv);
  }
}

template <int D, bool INT8>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int seq_q, int seq_kv, const int* st, float scale_log2, int group, int causal,
           const int* qseg, const int* kseg, int qseg_sb, int kseg_sb, float* lse,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D, INT8>::TOTAL;
  static_assert(smem <= 232448, "shared memory above the 227 KB a block can opt into");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((seq_q + BLOCK_M - 1) / BLOCK_M, heads, batch);
  flash_fwd_kernel<D, INT8><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq_q, seq_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2, group, causal, qseg, kseg, qseg_sb,
      kseg_sb, lse);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------- the wgmma core
namespace wg {

constexpr int BM = 128;          // query rows a block: consumer warpgroups 0 and 1, 64 rows each
constexpr int BN = 128;          // keys a tile

template <int D>
struct Smem {
  static constexpr int STAGES = 3;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t TILE_BYTES = BN * D * 2;  // one K or V tile
  // the Q, K, V and segment sections start on 1,024-byte boundaries (the
  // swizzle's period); the barriers need 8
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t SEG_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t BAR_OFF = SEG_OFF + STAGES * BN * 4;
  static constexpr uint32_t BARS = 1 + 2 * STAGES;  // Q, full[STAGES], empty[STAGES]
  static constexpr uint32_t TOTAL = BAR_OFF + BARS * 8 + 1024;  // + aligning the base
};

// S = Q K^T for a warpgroup's 64 rows against a 128-key tile, issued: D / 16
// steps of k16, each 32 bytes into the 128-byte rows of one 64-column panel.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 2], uint32_t q_rows,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q_rows + (kk / 4) * BM * ROW + off, 16, 1024),
                  smem_desc(k_tile + (kk / 4) * BN * ROW + off, 16, 1024), kk > 0);
  }
}

// O += P V, issued: BN / 16 steps of k16, each 16 keys = 2,048 bytes into
// every V panel; the D / 64 panels lie one panel (LBO) apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o, p[kk], smem_desc(v_tile + kk * 16 * ROW, BN * ROW, 1024));
}

// The online softmax of one tile in base 2 and fp32, on S's accumulator
// registers: register 4j + 2r + e holds row row0 + 8r, key n0 + 8j + c0 + e,
// and a row's 128 keys lie in the 4 threads of a quad. Keys a row does not
// see get -inf, only where `masked` (the causal diagonal, the ragged end,
// segment ids: with `segs`, shared memory at `seg` holds the tile's key
// segments). Updates m and l
// (this thread's part of the row sum), leaves p = exp2(s * scale_log2 - m) in
// s and returns each row's correction exp2(m_old - m) in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2],
                                             float scale_log2, bool masked, int n0, int seq_kv,
                                             bool causal, int row0, int c0, bool segs,
                                             const int* seg, const int (&my_seg)[2]) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + c0 + e;
        const int ks = segs ? seg[8 * j + c0 + e] : 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool keep = col < seq_kv;
          if (causal) keep = keep && col <= row0 + 8 * r;
          if (segs) keep = keep && ks == my_seg[r];
          if (!keep) s[4 * j + 2 * r + e] = -INFINITY;
        }
      }
  }
  float mx[2] = {-INFINITY, -INFINITY}, sub[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);  // scale_log2 > 0
    sub[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m_i[r] - sub[r]);  // 0 on the first tile (m_i = -inf)
    m_i[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -sub[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + sum[r];
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int seq_q,
                       int seq_kv, int o_sb, int o_ss, int o_sh, float scale_log2, int group,
                       int causal, const int* __restrict__ qseg, const int* __restrict__ kseg,
                       int qseg_sb, int kseg_sb, float* __restrict__ lse) {
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* s_seg = reinterpret_cast<int*>(smem_raw + (base - raw) + L::SEG_OFF);
  const uint32_t s_q = base, s_k = base + L::K_OFF, s_v = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  const auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  // causal: the blocks with the longest key walks are launched first
  const int mb = causal ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x);
  const int m0 = mb * BM, h = blockIdx.y, b = blockIdx.z;
  const int n_end = causal ? min(seq_kv, m0 + BM) : seq_kv;  // later tiles are all masked
  const int n_tiles = (n_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 32);           // the producer warp's lanes, one with the TMA bytes
      bar_init(empty(s), CONSUMERS);   // every consumer thread, done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: its first warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < CONSUMERS + 32) {
      const int lane = threadIdx.x & 31;
      const int hk = h / group;  // GQA: the kv head this query head reads
      if (lane == 0) {
        bar_arrive_expect_tx(bar_q, L::Q_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load(s_q + p * BM * ROW, &tq, bar_q, 64 * p, h, m0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int n0 = t * BN;
        bar_wait(empty(s), ((t / STAGES) & 1) ^ 1);  // passes at once on the first round
        if (kseg != nullptr)
          for (int i = lane; i < BN; i += 32)
            s_seg[s * BN + i] = n0 + i < seq_kv ? kseg[int64_t(b) * kseg_sb + n0 + i] : 0;
        if (lane == 0) {
          bar_arrive_expect_tx(full(s), 2 * L::TILE_BYTES);
          const uint32_t kd = s_k + s * L::TILE_BYTES, vd = s_v + s * L::TILE_BYTES;
          for (int p = 0; p < PANELS; ++p) {
            tma_load(kd + p * BN * ROW, &tk, full(s), 64 * p, hk, n0, b);
            tma_load(vd + p * BN * ROW, &tv, full(s), 64 * p, hk, n0, b);
          }
        } else {
          bar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: rows m0 + 64 wg .. m0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    // accumulator register 4j + 2r + e holds row row0 + 8r, column 8j + c0 + e
    const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    int my_seg[2] = {0, 0};
    if (qseg != nullptr)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < seq_q) my_seg[r] = qseg[int64_t(b) * qseg_sb + row0 + 8 * r];

    float acc_s[BN / 2], acc_o[D / 2], alpha[2];
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    const uint32_t q_wg = s_q + wg * 64 * ROW;  // this warpgroup's rows of each Q panel
    bar_wait(bar_q, 0);

    // Tile t's S = Q K^T goes out with tile t - 1's O += P V, and t's softmax
    // runs while that P V is still on the tensor cores.
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, prev = (t + STAGES - 1) % STAGES;
      const int n0 = t * BN;
      bar_wait(full(s), (t / STAGES) & 1);
      pin(acc_s);
      pin(acc_o);
      pin(pa);
      wgmma_fence();
      issue_scores<D>(acc_s, q_wg, s_k + s * L::TILE_BYTES);
      wgmma_commit();
      if (t > 0) {
        issue_pv<D>(acc_o, pa, s_v + prev * L::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; P V may still run
      } else {
        wgmma_wait<0>();
      }
      pin(acc_s);
      // masked only at the causal diagonal, at the ragged end, or with segments
      softmax_tile(acc_s, m_i, l_i, alpha, scale_log2,
                   kseg != nullptr || n0 + BN > seq_kv || (causal && n0 + BN - 1 > m0 + wg * 64),
                   n0, seq_kv, causal, row0, c0, kseg != nullptr, s_seg + s * BN, my_seg);
      wgmma_wait<0>();
      pin(acc_o);
      pin(pa);
      if (t > 0) bar_arrive(empty(prev));  // done with tile t - 1's K and V
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
      pack_a<BN>(pa, acc_s);
    }
    if (n_tiles > 0) {  // the last tile's P V
      const int last = (n_tiles - 1) % STAGES;
      pin(acc_o);
      pin(pa);
      wgmma_fence();
      issue_pv<D>(acc_o, pa, s_v + last * L::TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_o);
      bar_arrive(empty(last));
    }

    // normalise and store; l == 0 only for a row that every key is masked from
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      const int row = row0 + 8 * r;
      if (row >= seq_q) continue;
      const float inv = l_i[r] == 0.f ? 1.f : 1.f / l_i[r];
      if (lse != nullptr && (lane & 3) == 0)  // base 2: m + log2(l), as the TPU kernel
        lse[(int64_t(b) * gridDim.y + h) * seq_q + row] =
            m_i[r] + log2f(l_i[r] == 0.f ? 1.f : l_i[r]);
      bf16* og = o + int64_t(b) * o_sb + int64_t(h) * o_sh + int64_t(row) * o_ss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + 8 * j + c0) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv, acc_o[4 * j + 2 * r + 1] * inv);
    }
  }
}

}  // namespace wg

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                 int seq_q, int seq_kv, const int* st, float scale_log2, int group, int causal,
                 const int* qseg, const int* kseg, int qseg_sb, int kseg_sb, float* lse,
                 cudaStream_t stream) {
  constexpr uint32_t smem = wg::Smem<D>::TOTAL;
  static_assert(smem <= 232448, "shared memory above the 227 KB a block can opt into");
  cudaError_t err = cudaFuncSetAttribute(wg::flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv;
  CUresult res = wg::make_map(&tq, q, batch, seq_q, heads, D, st[0], st[1], st[2], wg::BM);
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tk, k, batch, seq_kv, heads / group, D, st[3], st[4], st[5], wg::BN);
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tv, v, batch, seq_kv, heads / group, D, st[6], st[7], st[8], wg::BN);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  dim3 grid((seq_q + wg::BM - 1) / wg::BM, heads, batch);
  wg::flash_fwd_wgmma_kernel<D><<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), seq_q, seq_kv, st[9], st[10], st[11], scale_log2, group,
      causal, qseg, kseg, qseg_sb, kseg_sb, lse);
  return int(cudaGetLastError());
}

// The fixed table of cores by compiled head_dim: the wgmma core serves bf16 at
// 64 and 128, the WMMA core every other width and the int8 QK^T form.
constexpr bool uses_wgmma(int head_dim, bool int8) {
  return !int8 && (head_dim == 64 || head_dim == 128);
}

template <bool INT8>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
             int seq_q, int seq_kv, int head_dim, const int* st, float scale_log2, int group,
             int causal, const int* qseg, const int* kseg, int qseg_sb, int kseg_sb, float* lse,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || heads % group != 0 || (qseg == nullptr) != (kseg == nullptr) ||
      (causal && seq_q != seq_kv) || (INT8 && lse != nullptr))
    return int(cudaErrorInvalidValue);
#define FLASH_FWD_ARGS \
  q, k, v, o, batch, heads, seq_q, seq_kv, st, scale_log2, group, causal, qseg, kseg, qseg_sb, \
      kseg_sb, lse, s
  switch (head_dim) {  // the table of `uses_wgmma`
    case 32: return launch<32, INT8>(FLASH_FWD_ARGS);
    case 64:
      if constexpr (INT8) return launch<64, true>(FLASH_FWD_ARGS);
      else return launch_wgmma<64>(FLASH_FWD_ARGS);
    case 96: return launch<96, INT8>(FLASH_FWD_ARGS);
    case 128:
      if constexpr (INT8) return launch<128, true>(FLASH_FWD_ARGS);
      else return launch_wgmma<128>(FLASH_FWD_ARGS);
    case 160: return launch<160, INT8>(FLASH_FWD_ARGS);
    case 256: return launch<256, INT8>(FLASH_FWD_ARGS);
    default: return int(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_ARGS
}

}  // namespace

// q, o: (B, Sq, H, D), k, v: (B, Skv, H / group, D), bf16 with unit stride
// over D and the given batch/seq/head strides (elements, each a multiple of
// 8; q/k/v 16-byte aligned). qseg/kseg: (B, Sq) / (B, Skv) int32 with unit
// stride over S and batch strides qseg_sb/kseg_sb, or both null (no
// segments). lse: (B, H, Sq) fp32, contiguous, or null (not written). causal
// needs Sq == Skv. Returns the cudaError_t of the launch (0 on success), or
// 10000 + the CUresult of a tensor map that libcuda refused.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                              int heads, int seq_q, int seq_kv, int head_dim, int q_sb,
                              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                              int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale_log2,
                              int group, int causal, const int* qseg, const int* kseg,
                              int qseg_sb, int kseg_sb, float* lse, void* stream) {
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return dispatch<false>(q, k, v, o, batch, heads, seq_q, seq_kv, head_dim, st, scale_log2,
                         group, causal, qseg, kseg, qseg_sb, kseg_sb, lse, stream);
}

// The inference form with int8 QK^T: the same operands as flash_fwd_bf16, no
// lse; scale_log2 = scale * log2(e) goes into q's row scales.
extern "C" int flash_fwd_int8qk_bf16(const void* q, const void* k, const void* v, void* o,
                                     int batch, int heads, int seq_q, int seq_kv, int head_dim,
                                     int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                                     int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                                     float scale_log2, int group, int causal, const int* qseg,
                                     const int* kseg, int qseg_sb, int kseg_sb, void* stream) {
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return dispatch<true>(q, k, v, o, batch, heads, seq_q, seq_kv, head_dim, st, scale_log2,
                        group, causal, qseg, kseg, qseg_sb, kseg_sb, nullptr, stream);
}

// The core the table sends a compiled head_dim to (1 wgmma, 0 WMMA) and, for
// the wgmma core, its block's dynamic shared memory in *smem_bytes (else 0).
extern "C" int flash_fwd_core(int head_dim, int int8, int* smem_bytes) {
  const bool wgmma = uses_wgmma(head_dim, int8 != 0);
  *smem_bytes = !wgmma ? 0 : head_dim == 64 ? int(wg::Smem<64>::TOTAL)
                                             : int(wg::Smem<128>::TOTAL);
  return wgmma ? 1 : 0;
}
