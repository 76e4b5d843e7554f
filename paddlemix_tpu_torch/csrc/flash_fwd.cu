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
// h / group). A head of any multiple of 8 columns up to 256 is read in place;
// the wrapper pads other heads to the compiled width.
//
// What bounds it: at head_dim 64-256 the two products do 4*S*S*D flops per head
// for 4*S*D*2 bytes of q/k/v/o, so the card is compute-bound: the limit is how
// well the tensor cores are fed, and, at D 64, the exp2 unit (16 a clock an
// SM, one exp2 per 4*D = 256 tensor-core flops, against 1,024 bf16 flops a
// clock). The scores never reach device memory.
//
// One core (namespace `wg`, with the Hopper blocks it shares with the backward
// in csrc/wgmma.cuh), four instantiations, chosen by a fixed table of the head
// width (`compiled_width`, `Tile`), never by the outcome of a launch:
//
//   head      compiled D   key tile BN   ring stages   shared memory a block (bf16 / int8)
//   8-64          64           128            3          117,304 / 86,072 bytes
//   72-128       128           128            3          231,992 / 167,992
//   136-192      192            64            3          198,456 / 158,264
//   200-256      256            64            2          198,184 / 133,160
//
// A block owns 128 query rows of one (batch, head): two consumer warpgroups
// of 64 rows and a producer warpgroup, whose first warp alone works and which
// hands its registers to the consumers (`setmaxnreg`: 24 / 240). The producer
// loads Q once by TMA, then walks the key tiles (BN keys) into a ring of K/V
// stages, each with a full and an empty mbarrier; it also copies the tile's
// key segment ids beside it. TMA reads q/k/v through 4-d tensor maps over
// their (d, H, S, B) strided views (built per call on the host, with the
// caller's head width d; GQA's kv head is a coordinate), writes each
// 64-column panel in the 128-byte swizzle and fills columns past d and rows
// past S with zeros, so neither edge needs a padding copy: zero columns change
// neither q.k nor the first d columns of p.v, keys past S get -inf scores,
// and rows past S and columns past d are not stored. Each consumer runs
// S = Q K^T as m64nBNk16 `wgmma` with both operands in shared memory (K-major
// descriptors), the online softmax in fp32 and base 2 on the accumulator
// registers (only the tiles at the causal diagonal, at the ragged end or with
// segment ids are masked), rounds P to bf16 in registers, in the order the
// next `wgmma` takes its A operand (the m64nN accumulator's registers
// 8kk..8kk+7 are the A fragment of the k16 step kk), and runs O += P V as
// m64nDk16 `wgmma` with A from registers and V as an MN-major (transposed)
// operand. O, m and l stay in registers for the whole walk; O is written
// once, by plain stores. Within a warpgroup the products of neighbouring
// tiles overlap: tile t's S = Q K^T is issued together with tile t - 1's P V,
// and t's softmax runs while that P V is still on the tensor cores; a stage
// is released when its P V is done. Causal blocks are launched longest
// first. 128 query rows a block at every shape the paths run: the smallest
// grid (SDXL's 1,024-token layers, 320 blocks of one an SM, 2.4 waves) would
// take as many waves with 64-row blocks at two an SM.
//
// The table's reasons. A consumer thread holds O in D / 2 registers, S in
// BN / 2 and P in BN / 4 (int8 adds S's int32 copy, BN / 2) within the 240
// that `setmaxnreg` gives it. D 64 and 128 take 128 keys a tile and three
// stages. At D 192 a 128-key stage is 96 KiB, so Q's 48 KiB leave room for one
// stage, and O + S + P would be 192 registers before addresses and the
// softmax state; 64 keys make a stage 48 KiB (three fit) and the three 144.
// At D 256 Q takes 64 KiB and a 64-key stage 64 KiB, so two stages; O + S + P
// are 176 registers (224 at 128 keys, which would spill). SD1.5's head 160
// reads at 192: its third panel is half zeros from TMA's fill, 1.2x the
// work. An exact D 160 is not compiled: P V's N would end inside a 64-column
// swizzle atom of the MN-major V panel, which the 128-byte layout does not
// take, so it would need a second swizzle mode for the last half panel.
//
// The lse form keeps the TPU wrapper's contract: q arrives pre-scaled by
// scale * log2(e) and rounded to bf16, scale_log2 = 1, and the lse is m +
// log2(l) in base 2, from which B14 recomputes p = exp2(s - lse).
//
// int8 QK^T (the TPU kernel's `int8_qk` branch, PMIX_INT8_ATTN=1) quantizes
// each q row and each k row to int8 with its own symmetric scale, with the
// fp32 operations of the plain version (ops/attention.py
// `quantize_rows_int8` / `int8_qk_operands`): a = max(max|x|, 1e-9), x8 =
// clip(rint(x * (127 / a)), +-127) (the multiply by the reciprocal rounded
// once, then round-half-even), q's scale (a / 127) * scale * log2(e), k's
// a / 127, each operation rounded once (the _rn intrinsics are never
// contracted into an FMA). S is summed exactly in int32 on the tensor cores
// and dequantized in registers, s = (s32 * sq) * sk, so the scores equal the
// plain version's bit for bit; the softmax and the bf16 P V are B1's. As in
// the JAX wrapper, q and k are quantized once, by an activation pass
// (`quantize_rows_kernel`: 8 columns a lane, the row's max by shuffles),
// which reads the caller's d columns and writes int8 (B, S, H, D) copies at
// the compiled width (zeros past d) and fp32 (B, H, S) row scales; the
// producer then TMA-loads the Q8 tile once and walks K8 tiles beside the
// bf16 V tiles (int8 rows of 64 bytes in the 64-byte swizzle at D 64; at
// D >= 128 panels of 128 bytes in the 128-byte swizzle, two at 192, whose
// second is half zeros from TMA's fill, and at 256), copying each tile's key
// scales beside it as it copies the segment ids; each consumer runs
// S = Q8 K8^T as m64nBNk32 s8 `wgmma` from two K-major descriptors into int32
// registers, converts them to the fp32 scores in place and goes on as the
// bf16 form does with scale_log2 = 1 (folded into sq). The pass moves 3
// bytes an element of q and k, a few per cent of the core's time at the SDXL
// shapes. What bounds the form at D 64 is not its products but the softmax
// phase that bounds bf16 there, to which the exact dequantization adds per
// score an int32 -> fp32 conversion (on the quarter-rate unit that runs
// exp2) and two multiplies: on an H100 the core takes 1.27x the bf16 form's
// time at (2, 4096, 10, 64), and leaving out its S product entirely saves
// only a twelfth of it. Moving the conversion to the FP32 pipe (adding to
// 1.5 * 2^23), issuing the next tile's S ahead of the softmax, and FA3's
// ping-pong of the two warpgroups each measured slower. The int8 form has no
// lse output: under autograd the forward stays bf16, as in JAX.
//
// Left for later work: a head-40 instantiation, a key tile between 64 and
// 128 at D 192 and 256, and skipping key tiles that no query of the block
// shares a segment with, as the backward's core does (csrc/flash_bwd.cu
// `judge`); for the int8 form, fewer operations a score (a plain version
// that folds sq into the exp2's fused multiply-add would round differently,
// so both would change together) or part of the exp2 on the FMA pipe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wg.cuh"  // wgmma.cuh's blocks, the s8 SS product, the 64-byte swizzle

typedef __nv_bfloat16 bf16;

namespace {

// The compiled width that serves a head of d columns (the fixed table).
constexpr int compiled_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256; }

// ------------------------------------------- the int8 QK^T form's activation pass
constexpr int QUANT_THREADS = 256;

// Quantizes every row of q (the first q_rows rows) and of k (the next k_rows),
// each enumerated as (b, s, h) with h fastest, so that row r of q lands at
// q8 + r * D of a contiguous (B, S, H, D) copy; LPR lanes a row (D / 8
// rounded up to a power of two; lanes past D idle), 8 values a lane, the
// row's max by shuffles among them. The rows' d columns are read; the copy's
// columns past d are zeros. Scales go to sq / sk in (B, H, S) order:
// sq = (a / 127) * scale_log2, sk = a / 127.
template <int D, int LPR>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     int8_t* __restrict__ q8, int8_t* __restrict__ k8, float* __restrict__ sq,
                     float* __restrict__ sk, int heads, int kv_heads, int seq_q, int seq_kv,
                     int q_rows, int k_rows, int d, int q_sb, int q_ss, int q_sh, int k_sb,
                     int k_ss, int k_sh, float scale_log2) {
  static_assert(LPR * 8 >= D && LPR <= 32 && (LPR & (LPR - 1)) == 0, "a power of two >= D / 8");
  const int gid = blockIdx.x * QUANT_THREADS + threadIdx.x;
  const int c = (gid % LPR) * 8;
  int row = gid / LPR;
  const bool is_q = row < q_rows;
  if (!is_q) row -= q_rows;
  const bool valid = (is_q || row < k_rows) && c < D;
  const int H = is_q ? heads : kv_heads, S = is_q ? seq_q : seq_kv;
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (valid && c < d)
    u = __ldg(reinterpret_cast<const uint4*>(
        is_q ? q + int64_t(b) * q_sb + int64_t(s) * q_ss + int64_t(h) * q_sh + c
             : k + int64_t(b) * k_sb + int64_t(s) * k_ss + int64_t(h) * k_sh + c));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float x[8], amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    amax = fmaxf(amax, fmaxf(fabsf(x[2 * i]), fabsf(x[2 * i + 1])));
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!valid) return;
  amax = fmaxf(amax, 1e-9f);
  const float inv = __fdiv_rn(127.f, amax);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = max(-127, min(127, __float2int_rn(__fmul_rn(x[i], inv))));
    packed[i / 4] |= (static_cast<uint32_t>(v) & 0xffu) << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>((is_q ? q8 : k8) + int64_t(row) * D + c) =
      make_uint2(packed[0], packed[1]);
  if (c == 0) {
    const float a = __fdiv_rn(amax, 127.f);
    (is_q ? sq : sk)[(int64_t(b) * H + h) * S + s] = is_q ? __fmul_rn(a, scale_log2) : a;
  }
}

// ---------------------------------------------------------------- the core
namespace wg {

constexpr int BM = 128;  // query rows a block: consumer warpgroups 0 and 1, 64 rows each

// The key tile and the ring's depth of a compiled width (see the header).
template <int D>
struct Tile {
  static constexpr int BN = D <= 128 ? 128 : 64;
  static constexpr int STAGES = D <= 192 ? 3 : 2;
};

// INT8: Q and K are int8 (one D-byte row a query or key), V stays bf16.
template <int D, bool INT8, int BN, int STAGES>
struct Smem {
  static constexpr uint32_t QK = INT8 ? 1 : 2;  // bytes of a q / k element
  // a q / k row is read as panels of QK_ROW bytes (one TMA box, one swizzled
  // row): 64-column panels of bf16, one 64-byte row of int8 at D 64, else
  // 128-byte panels of int8 (the last zero-filled past D)
  static constexpr uint32_t QK_ROW = D * QK < 128 ? D * QK : 128;
  static constexpr uint32_t QK_PANELS = (D * QK + 127) / 128;
  static constexpr uint32_t Q_BYTES = BM * QK_PANELS * QK_ROW;
  static constexpr uint32_t K_BYTES = BN * QK_PANELS * QK_ROW;  // one K tile
  static constexpr uint32_t V_BYTES = BN * D * 2;               // one V tile
  // the Q, K, V and segment sections start on 1,024-byte boundaries (the
  // swizzle's period); the barriers need 8
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr uint32_t SEG_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr uint32_t SK_OFF = SEG_OFF + STAGES * BN * 4;  // int8: the keys' scales
  static constexpr uint32_t BAR_OFF = SK_OFF + (INT8 ? STAGES * BN * 4 : 0);
  static constexpr uint32_t BARS = 1 + 2 * STAGES;  // Q, full[STAGES], empty[STAGES]
  static constexpr uint32_t TOTAL = BAR_OFF + BARS * 8 + 1024;  // + aligning the base
};

// S = Q K^T for a warpgroup's 64 rows against a BN-key tile, issued: D / 16
// steps of k16, each 32 bytes into the 128-byte rows of one 64-column panel.
template <int D, int BN>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 2], uint32_t q_rows,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<BN>(s, smem_desc(q_rows + (kk / 4) * BM * ROW + off, 16, 1024),
                 smem_desc(k_tile + (kk / 4) * BN * ROW + off, 16, 1024), kk > 0);
  }
}

// S32 = Q8 K8^T, issued: D / 32 steps of k32, each 32 bytes into the rows
// (one 64-byte row in the 64-byte swizzle at D 64, else four steps a
// 128-byte panel in the 128-byte swizzle).
template <int D, int BN>
__device__ __forceinline__ void issue_scores_i8(int (&s)[BN / 2], uint32_t q_rows,
                                                uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    if constexpr (D == 64) {
      wgmma_s8_ss<BN>(s, smem_desc_sw64(q_rows + 32 * kk), smem_desc_sw64(k_tile + 32 * kk),
                      kk > 0);
    } else {
      const uint32_t off = (kk % 4) * 32;
      wgmma_s8_ss<BN>(s, smem_desc(q_rows + (kk / 4) * BM * ROW + off, 16, 1024),
                      smem_desc(k_tile + (kk / 4) * BN * ROW + off, 16, 1024), kk > 0);
    }
  }
}

// The int32 scores to fp32, s = (s32 * sq[row]) * sk[key], in the
// accumulator's layout; `sk` points at the tile's key scales + c0.
template <int BN>
__device__ __forceinline__ void dequant_scores(float (&s)[BN / 2], const int (&s32)[BN / 2],
                                               const float (&sq)[2], const float* sk) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[4 * j + 2 * r] = __fmul_rn(__fmul_rn(__int2float_rn(s32[4 * j + 2 * r]), sq[r]), k2.x);
      s[4 * j + 2 * r + 1] =
          __fmul_rn(__fmul_rn(__int2float_rn(s32[4 * j + 2 * r + 1]), sq[r]), k2.y);
    }
  }
}

// O += P V, issued: BN / 16 steps of k16, each 16 keys = 2,048 bytes into
// every V panel; the D / 64 panels lie one panel (LBO) apart.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o, p[kk], smem_desc(v_tile + kk * 16 * ROW, BN * ROW, 1024));
}

// The online softmax of one tile in base 2 and fp32, on S's accumulator
// registers: register 4j + 2r + e holds row row0 + 8r, key n0 + 8j + c0 + e,
// and a row's BN keys lie in the 4 threads of a quad. Keys a row does not
// see get -inf, only where `masked` (the causal diagonal, the ragged end,
// segment ids: with `segs`, shared memory at `seg` holds the tile's key
// segments). Updates m and l (this thread's part of the row sum), leaves
// p = exp2(s * scale_log2 - m) in s and returns each row's correction
// exp2(m_old - m) in alpha.
template <int BN>
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

// d: the caller's head width (o's columns; a multiple of 8, <= D). INT8: tq /
// tk map the int8 copies of the activation pass, sq (B, H, Sq) and sk
// (B, H / group, Skv) are its row scales, and scale_log2 is in sq.
template <int D, bool INT8, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int d,
                       int seq_q, int seq_kv, int o_sb, int o_ss, int o_sh, float scale_log2,
                       int group, int causal, const int* __restrict__ qseg,
                       const int* __restrict__ kseg, int qseg_sb, int kseg_sb,
                       float* __restrict__ lse, const float* __restrict__ sq,
                       const float* __restrict__ sk) {
  using L = Smem<D, INT8, BN, STAGES>;
  constexpr int PANELS = D / 64;  // TMA boxes a bf16 V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* s_seg = reinterpret_cast<int*>(smem_raw + (base - raw) + L::SEG_OFF);
  float* s_sk = reinterpret_cast<float*>(smem_raw + (base - raw) + L::SK_OFF);
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
      const float* skb = INT8 ? sk + (int64_t(b) * (gridDim.y / group) + hk) * seq_kv : nullptr;
      if (lane == 0) {
        bar_arrive_expect_tx(bar_q, L::Q_BYTES);
        for (int p = 0; p < int(L::QK_PANELS); ++p)
          tma_load(s_q + p * BM * L::QK_ROW, &tq, bar_q, int(L::QK_ROW / L::QK) * p, h, m0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int n0 = t * BN;
        bar_wait(empty(s), ((t / STAGES) & 1) ^ 1);  // passes at once on the first round
        if (kseg != nullptr)
          for (int i = lane; i < BN; i += 32)
            s_seg[s * BN + i] = n0 + i < seq_kv ? kseg[int64_t(b) * kseg_sb + n0 + i] : 0;
        if constexpr (INT8)
          for (int i = lane; i < BN; i += 32) s_sk[s * BN + i] = n0 + i < seq_kv ? skb[n0 + i] : 0.f;
        if (lane == 0) {
          bar_arrive_expect_tx(full(s), L::K_BYTES + L::V_BYTES);
          const uint32_t kd = s_k + s * L::K_BYTES, vd = s_v + s * L::V_BYTES;
          for (int p = 0; p < int(L::QK_PANELS); ++p)
            tma_load(kd + p * BN * L::QK_ROW, &tk, full(s), int(L::QK_ROW / L::QK) * p, hk, n0, b);
          for (int p = 0; p < PANELS; ++p)
            tma_load(vd + p * BN * ROW, &tv, full(s), 64 * p, hk, n0, b);
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
    float q_scale[2] = {0.f, 0.f};  // int8: the rows' scales (0 past S, whose q8 rows are 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= seq_q) continue;
      if (qseg != nullptr) my_seg[r] = qseg[int64_t(b) * qseg_sb + row0 + 8 * r];
      if constexpr (INT8) q_scale[r] = sq[(int64_t(b) * gridDim.y + h) * seq_q + row0 + 8 * r];
    }
    const float s_mul = INT8 ? 1.f : scale_log2;

    float acc_s[BN / 2], acc_o[D / 2], alpha[2];
    int acc_i[INT8 ? BN / 2 : 1];  // int8: S = Q8 K8^T in int32
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (INT8 ? BN / 2 : 1); ++i) acc_i[i] = 0;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    const uint32_t q_wg = s_q + wg * 64 * L::QK_ROW;  // this warpgroup's rows of each Q panel
    bar_wait(bar_q, 0);

    // Tile t's S = Q K^T goes out with tile t - 1's O += P V, and t's softmax
    // runs while that P V is still on the tensor cores.
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, prev = (t + STAGES - 1) % STAGES;
      const int n0 = t * BN;
      bar_wait(full(s), (t / STAGES) & 1);
      if constexpr (INT8) pin(acc_i); else pin(acc_s);
      pin(acc_o);
      pin(pa);
      wgmma_fence();
      if constexpr (INT8)
        issue_scores_i8<D, BN>(acc_i, q_wg, s_k + s * L::K_BYTES);
      else
        issue_scores<D, BN>(acc_s, q_wg, s_k + s * L::K_BYTES);
      wgmma_commit();
      if (t > 0) {
        issue_pv<D, BN>(acc_o, pa, s_v + prev * L::V_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; P V may still run
      } else {
        wgmma_wait<0>();
      }
      if constexpr (INT8) {
        pin(acc_i);
        dequant_scores<BN>(acc_s, acc_i, q_scale, s_sk + s * BN + c0);
      } else {
        pin(acc_s);
      }
      // masked only at the causal diagonal, at the ragged end, or with segments
      softmax_tile<BN>(acc_s, m_i, l_i, alpha, s_mul,
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
      issue_pv<D, BN>(acc_o, pa, s_v + last * L::V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_o);
      bar_arrive(empty(last));
    }

    // normalise and store the first d columns; l == 0 only for a row that
    // every key is masked from
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
        if (8 * j < d)  // d is a multiple of 8: columns 8j + c0 and + 1 lie below it
          *reinterpret_cast<__nv_bfloat162*>(og + 8 * j + c0) =
              __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv, acc_o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// A map over the activation pass's contiguous int8 (B, S, H, D) copy, read as
// (D, H, S, B); a box is one panel of a row (D = 64 bytes in the 64-byte
// swizzle, else 128 bytes in the 128-byte one) x `rows` rows of one head,
// zeros past S and past D.
CUresult make_map_i8(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int d,
                     int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(heads), uint64_t(seq), uint64_t(batch)};
  const uint64_t bytes[3] = {uint64_t(d), uint64_t(d) * heads, uint64_t(d) * heads * seq};
  const uint32_t box[4] = {uint32_t(d < 128 ? d : 128), 1, uint32_t(rows), 1};
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 4, dims, bytes, box,
                     d == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace wg

// The activation pass's int8 copies and scales (int8 QK^T).
struct Int8Operands {
  const void *q8, *k8;
  const float *sq, *sk;
};

template <int D, bool INT8>
constexpr uint32_t smem_bytes() {
  return wg::Smem<D, INT8, wg::Tile<D>::BN, wg::Tile<D>::STAGES>::TOTAL;
}

// d: the heads' width (q / k / v / o columns), served at the compiled width D.
template <int D, bool INT8>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                 int seq_q, int seq_kv, int d, const int* st, float scale_log2, int group,
                 int causal, const int* qseg, const int* kseg, int qseg_sb, int kseg_sb,
                 float* lse, const Int8Operands& i8, cudaStream_t stream) {
  constexpr int BN = wg::Tile<D>::BN, STAGES = wg::Tile<D>::STAGES;
  constexpr uint32_t smem = smem_bytes<D, INT8>();
  static_assert(smem <= 232448, "shared memory above the 227 KB a block can opt into");
  const auto kernel = wg::flash_fwd_wgmma_kernel<D, INT8, BN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv;
  CUresult res;
  if constexpr (INT8) {
    res = wg::make_map_i8(&tq, i8.q8, batch, seq_q, heads, D, wg::BM);
    if (res == CUDA_SUCCESS)
      res = wg::make_map_i8(&tk, i8.k8, batch, seq_kv, heads / group, D, BN);
  } else {
    res = wg::make_map(&tq, q, batch, seq_q, heads, d, st[0], st[1], st[2], wg::BM);
    if (res == CUDA_SUCCESS)
      res = wg::make_map(&tk, k, batch, seq_kv, heads / group, d, st[3], st[4], st[5], BN);
  }
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tv, v, batch, seq_kv, heads / group, d, st[6], st[7], st[8], BN);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  dim3 grid((seq_q + wg::BM - 1) / wg::BM, heads, batch);
  kernel<<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), d, seq_q, seq_kv, st[9], st[10], st[11], scale_log2,
      group, causal, qseg, kseg, qseg_sb, kseg_sb, lse, i8.sq, i8.sk);
  return int(cudaGetLastError());
}

template <bool INT8>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
             int seq_q, int seq_kv, int head_dim, const int* st, float scale_log2, int group,
             int causal, const int* qseg, const int* kseg, int qseg_sb, int kseg_sb, float* lse,
             const Int8Operands& i8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || heads % group != 0 || (qseg == nullptr) != (kseg == nullptr) ||
      (causal && seq_q != seq_kv) || (INT8 && lse != nullptr) || head_dim < 8 ||
      head_dim > 256 || head_dim % 8 != 0 ||
      (INT8 && (i8.q8 == nullptr || i8.k8 == nullptr || i8.sq == nullptr || i8.sk == nullptr)))
    return int(cudaErrorInvalidValue);
#define FLASH_FWD_ARGS                                                                        \
  q, k, v, o, batch, heads, seq_q, seq_kv, head_dim, st, scale_log2, group, causal, qseg, kseg, \
      qseg_sb, kseg_sb, lse, i8, s
  switch (compiled_width(head_dim)) {  // the fixed table
    case 64: return launch_wgmma<64, INT8>(FLASH_FWD_ARGS);
    case 128: return launch_wgmma<128, INT8>(FLASH_FWD_ARGS);
    case 192: return launch_wgmma<192, INT8>(FLASH_FWD_ARGS);
    default: return launch_wgmma<256, INT8>(FLASH_FWD_ARGS);
  }
#undef FLASH_FWD_ARGS
}

}  // namespace

// q, o: (B, Sq, H, head_dim), k, v: (B, Skv, H / group, head_dim), bf16 with
// unit stride over head_dim (a multiple of 8, at most 256) and the given
// batch/seq/head strides (elements, each a multiple of 8; q/k/v 16-byte
// aligned). qseg/kseg: (B, Sq) / (B, Skv) int32 with unit stride over S and
// batch strides qseg_sb/kseg_sb, or both null (no segments). lse: (B, H, Sq)
// fp32, contiguous, or null (not written). causal needs Sq == Skv. Returns the
// cudaError_t of the launch (0 on success), or 10000 + the CUresult of a
// tensor map that libcuda refused.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                              int heads, int seq_q, int seq_kv, int head_dim, int q_sb,
                              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                              int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale_log2,
                              int group, int causal, const int* qseg, const int* kseg,
                              int qseg_sb, int kseg_sb, float* lse, void* stream) {
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return dispatch<false>(q, k, v, o, batch, heads, seq_q, seq_kv, head_dim, st, scale_log2,
                         group, causal, qseg, kseg, qseg_sb, kseg_sb, lse, Int8Operands{},
                         stream);
}

// The int8 QK^T form's activation pass: q (B, Sq, H, head_dim) and k (B, Skv,
// KVH, head_dim) bf16 as flash_fwd_bf16 takes them, into q8 / k8, int8
// (B, S, heads, D) contiguous at the compiled width D of head_dim (zeros past
// head_dim), and sq (B, H, Sq) = (a_q / 127) * scale_log2, sk (B, KVH, Skv) =
// a_k / 127, fp32 contiguous.
extern "C" int flash_int8_quantize(const void* q, const void* k, void* q8, void* k8, float* sq,
                                   float* sk, int batch, int heads, int kv_heads, int seq_q,
                                   int seq_kv, int head_dim, int q_sb, int q_ss, int q_sh,
                                   int k_sb, int k_ss, int k_sh, float scale_log2,
                                   void* stream) {
  if (head_dim < 8 || head_dim > 256 || head_dim % 8 != 0) return int(cudaErrorInvalidValue);
  const int q_rows = batch * seq_q * heads, k_rows = batch * seq_kv * kv_heads;
  const int width = compiled_width(head_dim);
  const int lpr = width == 64 ? 8 : width == 128 ? 16 : 32;
  const int64_t threads = int64_t(q_rows + k_rows) * lpr;
  if (threads == 0) return 0;
  const unsigned blocks = unsigned((threads + QUANT_THREADS - 1) / QUANT_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QUANT_ARGS                                                                            \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<int8_t*>(q8),        \
      static_cast<int8_t*>(k8), sq, sk, heads, kv_heads, seq_q, seq_kv, q_rows, k_rows,      \
      head_dim, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, scale_log2
  switch (width) {
    case 64: quantize_rows_kernel<64, 8><<<blocks, QUANT_THREADS, 0, s>>>(QUANT_ARGS); break;
    case 128: quantize_rows_kernel<128, 16><<<blocks, QUANT_THREADS, 0, s>>>(QUANT_ARGS); break;
    case 192: quantize_rows_kernel<192, 32><<<blocks, QUANT_THREADS, 0, s>>>(QUANT_ARGS); break;
    default: quantize_rows_kernel<256, 32><<<blocks, QUANT_THREADS, 0, s>>>(QUANT_ARGS); break;
  }
#undef QUANT_ARGS
  return int(cudaGetLastError());
}

// The inference form with int8 QK^T: the same operands as flash_fwd_bf16, no
// lse; scale_log2 = scale * log2(e) goes into q's row scales. q8 / k8 / sq /
// sk are flash_int8_quantize's outputs for this q and k (q and k are not
// read).
extern "C" int flash_fwd_int8qk_bf16(const void* q, const void* k, const void* v, void* o,
                                     int batch, int heads, int seq_q, int seq_kv, int head_dim,
                                     int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                                     int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                                     float scale_log2, int group, int causal, const int* qseg,
                                     const int* kseg, int qseg_sb, int kseg_sb, const void* q8,
                                     const void* k8, const float* sq, const float* sk,
                                     void* stream) {
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return dispatch<true>(q, k, v, o, batch, heads, seq_q, seq_kv, head_dim, st, scale_log2,
                        group, causal, qseg, kseg, qseg_sb, kseg_sb, nullptr,
                        Int8Operands{q8, k8, sq, sk}, stream);
}

// The instantiation the table serves a head of head_dim columns with, as
// plan[0..3] = {compiled D, key tile BN, ring stages, dynamic shared memory a
// block}; returns 1, or 0 (plan untouched) for a head_dim the kernels do not
// read in place (not a multiple of 8, or above 256).
extern "C" int flash_fwd_core(int head_dim, int int8, int* plan) {
  if (head_dim < 8 || head_dim > 256 || head_dim % 8 != 0) return 0;
  const int width = compiled_width(head_dim);
  plan[0] = width;
  switch (width) {
#define PLAN(D)                                                                   \
  plan[1] = wg::Tile<D>::BN;                                                       \
  plan[2] = wg::Tile<D>::STAGES;                                                   \
  plan[3] = int(int8 ? smem_bytes<D, true>() : smem_bytes<D, false>());            \
  break;
    case 64: PLAN(64)
    case 128: PLAN(128)
    case 192: PLAN(192)
    default: PLAN(256)
#undef PLAN
  }
  return 1;
}
