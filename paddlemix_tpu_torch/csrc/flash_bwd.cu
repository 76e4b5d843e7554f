// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces the Pallas kernels paddlemix_tpu/ops/attention.py `_flash_bwd`
// (B14): `_bwd_dkv_kernel` (pallas_call at `_flash_bwd`'s first call) and
// `_bwd_dq_kernel` (its second). As on the TPU, the two run apart and neither
// uses atomics, so the gradients are deterministic: the dK/dV kernel owns key
// rows and walks the queries, the dQ kernel owns query rows and walks the
// keys. Both recompute the scores from q pre-scaled by scale*log2(e) and
// rounded to bf16 (`qs`, the very operand the lse forward of csrc/flash_fwd.cu
// took) and the base-2 lse that forward wrote, so p = exp2(s - lse) is the
// forward's softmax; di = rowsum(o * do) in fp32 comes from the wrapper, as it
// comes from XLA in the JAX package. Per (query, key):
//   p  = exp2(s - lse)                (fp32; 0 where causal or segments mask)
//   dp = do . v
//   dK/dV kernel: dv += bf16(p)^T do, dk += bf16(p (dp - di) / log2(e))^T qs
//   dQ kernel:    dq += bf16(p (dp - di) * scale) k
// Causal is top-left; segment ids mask from two int32 arrays; GQA: query head
// h reads kv head h / group.
//
// What bounds it: the five products of a (query, key) tile pair do 14 * D
// flops a pair over both kernels against bytes read once per tile, so it is
// compute-bound, and the limit is how the tensor cores are fed. Measured
// (tools/probe_torch_flash_bwd_parts.py), a warpgroup's wait for a tile's
// last products before its next tile costs more than the exp2 unit does.
//
// Two cores, chosen by a fixed table of the compiled head_dim (`dispatch`),
// never by the outcome of a launch. A head of 33-64 runs the wgmma core at 64
// and one of 65-128 at 128, its columns past the head read as zeros (through
// TMA for a multiple of 8; the wrapper pads any other); SD1.5's head 80 runs
// it at 128, faster than the WMMA core at 96 by the measurement in PERF.md.
// The wrapper pads 129-160 to 160 and 161-256 to 256 for the WMMA core.
//
// The wgmma core (D 64 and 128; namespace `wg`, the Hopper blocks of
// csrc/wgmma.cuh, as the forward's). A block owns 128 rows, keys of one
// (batch, kv head) in the dK/dV kernel or queries of one (batch, head) in the
// dQ kernel, split between two consumer warpgroups of 64; a producer
// warpgroup's first warp loads the owned operands once by TMA (K and V, or qs
// and dO) and walks the other side in 64-row tiles (qs and dO with their lse,
// di and segment ids, or K and V with their segment ids) through a ring of
// four stages under full and empty mbarriers (`setmaxnreg` 40 / 232). The
// dK/dV kernel walks every (query tile, query head of the GQA group) pair, so
// the group's sum happens in registers. A warpgroup's tile: S^T = K qs^T and
// dP^T = V dO^T (dK/dV) or S = qs K^T and dP = dO V^T (dQ) as m64n64k16
// `wgmma` with both operands K-major in shared memory; P and dS in fp32 on the
// accumulator registers; then dV += P^T dO and dK += dS^T qs, or dQ += dS K,
// as `wgmma` with A from registers (the accumulator's fragment order, bf16)
// and B MN-major (the transpose bit). dK, dV, dQ stay in fp32 registers for
// the whole walk and are written once, in bf16, in the caller's (B, S, H, D)
// layout. TMA reads the strided (D, H, S, B) views and fills rows past S with
// zeros; the queries past Sq get lse = +inf, so p = 0 there, and the dQ
// kernel masks the keys past Skv of its last tile. Within a warpgroup the
// products of one tile and its elementwise step run in turn; the two
// warpgroups of a block overlap each other (probes that also overlapped a
// warpgroup's own tiles, in the forward's order or by leaving the last
// products in flight, were slower).
//
// Tile skipping. The producer judges each walked tile against each
// warpgroup's 64 rows (`judge`): SKIP when causal hides all of it or when the
// two sides' segment ids share no id, by disjoint [min, max] spans or
// disjoint masks of id mod 32; a tile that both warpgroups skip is never
// loaded. A skipped pair contributes exactly 0: every query that sees at
// least one key (all of them, in causal self-attention with segments) has
// p = exp2(mask - lse) = 0 at a masked key, in JAX as here. Only tiles at the
// causal diagonal, at the ragged end or with mixed segment ids are masked
// element by element. Causal blocks with the longest walks go first: the
// dQ kernel reverses its block order, and the dK/dV kernel's first blocks
// (the first keys) already walk the most queries. The plain versions
// `flash_bwd_{dkv,dq}_tiled_ref` (ops/attention.py) walk the same tiles.
//
// The WMMA core (D 32, 160 and 256). Each warp owns 16 rows (keys in dK/dV,
// queries in dQ) and keeps its accumulator in registers as 16x16 fp32 WMMA
// fragments for the whole walk; the walked tiles (32 rows) and the scores,
// dP, P and dS of the owned rows x 32 sit in shared memory, loaded and
// synchronised by the whole block. Outputs are fp32 (B, H, S_pad, D), one per
// query head, with S padded to the 64-row tile; the wrapper slices, sums over
// GQA groups and casts. D 32: a block of 4 warps, each warp holding its dK
// and its dV. D 160 and 256 (heads of 129-256 padded, as the forward pads
// them): both 16 x D sums in one warp would be 160 / 256 registers a thread
// for the accumulators alone, past the 255 a thread may have, so the dK/dV
// kernel runs 8 warps split by output: warps 0-3 compute S^T = K Q^T for
// their 16 keys and accumulate dV, warps 4-7 compute dP^T = V dO^T for the
// same keys and accumulate dK; the pair (w, w + 4) shares the elementwise P /
// dS step, and every warp holds one 16 x D sum. Shared memory: 93,952 bytes
// at D = 160, 130,816 at D = 256. One template holds both forms (`SPLIT`,
// set above 128). The dQ kernel keeps one 16 x D sum a warp.
//
// Left for later work: the wide heads (160, 256) on the wgmma core, a
// head-40 instantiation, 128-row walked tiles at D = 64 (faster in a probe,
// but the dK/dV kernel then spills), and scheduling the two consumer
// warpgroups' elementwise steps against each other.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int OWN = 64;   // rows a block owns (16 per warp)
constexpr int WALK = 32;  // rows of each walked tile
constexpr int NUM_WARPS = OWN / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int SPLIT_THREADS = 2 * NUM_THREADS;  // the dK/dV kernel above D = 128
constexpr int PAD_H = 8;  // bf16 row padding: keeps WMMA ldm a multiple of 8
constexpr int PAD_F = 4;  // fp32 row padding
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + PAD_H;        // bf16 rows of q/k/v/do
  static constexpr int LD_S = WALK + PAD_F;   // fp32 score rows
  static constexpr int LD_P = WALK + PAD_H;   // bf16 P / dS rows
  static constexpr size_t OWN_BYTES = size_t(OWN) * LD * sizeof(bf16);
  static constexpr size_t WALK_BYTES = size_t(WALK) * LD * sizeof(bf16);
  static constexpr size_t S_BYTES = size_t(OWN) * LD_S * sizeof(float);
  static constexpr size_t P_BYTES = size_t(OWN) * LD_P * sizeof(bf16);
  static constexpr size_t ROW_BYTES = size_t(OWN) * sizeof(float);  // lse / di / seg vectors
  // two owned tiles, two walked tiles, S and dP, P and dS, three row vectors
  static constexpr size_t TOTAL = 2 * OWN_BYTES + 2 * WALK_BYTES + 2 * S_BYTES + 2 * P_BYTES +
                                  3 * ROW_BYTES;
};

// `rows` x D bf16 rows (row stride `stride` elements) into shared memory as
// 16-byte vectors by a block of THREADS; rows past `valid` are zero-filled.
template <int D, int ROWS, int THREADS = NUM_THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int valid, int stride) {
  constexpr int VEC = 8;
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + int64_t(r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LD + c) = val;
  }
}

// `n` values of a per-row fp32 or int32 vector into shared memory, `fill` past `valid`.
template <int THREADS = NUM_THREADS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int n, int valid, T fill) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = i < valid ? src[i] : fill;
}

// C (16 x 32, fp32, row-major at c, ld LD_S) = A (16 x D rows at a) B^T where
// B is 32 x D rows at bt: both operands row-major in shared memory.
template <int D>
__device__ __forceinline__ void rows_by_rows_t(float* c, const bf16* a, const bf16* bt) {
  using L = Layout<D>;
#pragma unroll
  for (int j = 0; j < WALK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::LD);
      wmma::load_matrix_sync(fb, bt + j * 16 * L::LD + kk * 16, L::LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, L::LD_S, wmma::mem_row_major);
  }
}

// acc[j] (16 x 16 column block j of a 16 x D sum) += A (16 x 32 bf16 at a, ld
// LD_P) B (32 x D rows at b).
template <int D>
__device__ __forceinline__ void accumulate(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], const bf16* a,
    const bf16* b) {
  using L = Layout<D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[WALK / 16];
#pragma unroll
  for (int kk = 0; kk < WALK / 16; ++kk) wmma::load_matrix_sync(fa[kk], a + kk * 16, L::LD_P);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * L::LD + j * 16, L::LD);
      wmma::mma_sync(acc[j], fa[kk], fb, acc[j]);
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;  // (B, S, H, D) through strides; q pre-scaled
  const float *lse, *di;         // (B, H, Sq) fp32, contiguous
  const int *qseg, *kseg;        // (B, S) int32 or null
  void *out0, *out1;  // WMMA: fp32 (B, H, S_pad, D) dK, dV or dQ; wgmma: bf16, the caller's
  int seq_q, seq_kv, group, causal, qseg_sb, kseg_sb;
  int dh;  // the operands' head_dim (<= D): the wgmma core reads zeros past it, writes dh
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  float ds_scale;     // 1/log2(e) for dK, the softmax scale for dQ
};

// One block: key tile [n0, n0 + 64) of query head h, batch b; walks the query
// tiles. Head dims to 128: 4 warps, warp w sums dK and dV of keys 16w..
// Above (SPLIT): 8 warps, warp w < 4 sums dV of keys 16w.., warp w + 4 dK of
// the same keys (see the top of the file).
template <int D, bool SPLIT = (D > 128)>
__global__ void __launch_bounds__(SPLIT ? SPLIT_THREADS : NUM_THREADS)
    flash_bwd_dkv_kernel(Args a) {
  using L = Layout<D>;
  constexpr int THREADS = SPLIT ? SPLIT_THREADS : NUM_THREADS;
  constexpr int SUMS = SPLIT ? 1 : 2;     // 16 x D sums a warp: dK and dV, or one of them
  constexpr int PER_KEY = SPLIT ? 4 : 2;  // threads sharing a key's row of 32 queries
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::OWN_BYTES);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * L::OWN_BYTES);
  bf16* sDo = reinterpret_cast<bf16*>(smem + 2 * L::OWN_BYTES + L::WALK_BYTES);
  float* sS = reinterpret_cast<float*>(smem + 2 * L::OWN_BYTES + 2 * L::WALK_BYTES);
  float* sDp = sS + OWN * L::LD_S;
  bf16* sP = reinterpret_cast<bf16*>(sDp + OWN * L::LD_S);
  bf16* sDs = sP + OWN * L::LD_P;
  float* sLse = reinterpret_cast<float*>(sDs + OWN * L::LD_P);
  float* sDi = sLse + OWN;
  int* sSeg = reinterpret_cast<int*>(sDi + OWN);  // query segments of the walked tile
  __shared__ int sKseg[OWN];

  const int n0 = blockIdx.x * OWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int heads = gridDim.y;
  const int warp = threadIdx.x / 32;
  // warp-uniform roles: a split warp computes S^T and sums dV, or dP^T and dK
  const bool dk_warp = SPLIT && warp >= NUM_WARPS;
  const bool does_dv = !SPLIT || !dk_warp;
  const bool does_dk = !SPLIT || dk_warp;
  // the warp's 16 keys, from n0 (`warp % 4` in the 4-warp form costs ptxas
  // 13 registers at D = 96, when it was compiled: 180, two blocks an SM, not three)
  const int rows = (SPLIT ? warp % NUM_WARPS : warp) * 16;
  const int n_valid = min(OWN, a.seq_kv - n0);

  load_tile<D, OWN, THREADS>(
      sK, a.k + int64_t(b) * a.k_sb + int64_t(hk) * a.k_sh + int64_t(n0) * a.k_ss, n_valid,
      a.k_ss);
  load_tile<D, OWN, THREADS>(
      sV, a.v + int64_t(b) * a.v_sb + int64_t(hk) * a.v_sh + int64_t(n0) * a.v_ss, n_valid,
      a.v_ss);
  if (a.kseg != nullptr)
    load_rows<THREADS>(sKseg, a.kseg + int64_t(b) * a.kseg_sb + n0, OWN, n_valid, 0);

  // acc[0] is dK (or a split warp's one sum), acc[SUMS - 1] dV
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[SUMS][D / 16];
#pragma unroll
  for (int s = 0; s < SUMS; ++s)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[s][j], 0.f);
  // the threads of the 16 keys x 32 queries (a warp, or a split pair's 64):
  // thread t owns key t / PER_KEY and the queries (columns) t % PER_KEY +
  // PER_KEY c
  const int t = (dk_warp ? 32 : 0) + threadIdx.x % 32;
  const int r = t / PER_KEY;
  const int part = t % PER_KEY;
  const int key = n0 + rows + r;
  float* wS = sS + rows * L::LD_S;
  float* wDp = sDp + rows * L::LD_S;
  bf16* wP = sP + rows * L::LD_P;
  bf16* wDs = sDs + rows * L::LD_P;
  const int64_t row_base = (int64_t(b) * heads + h) * a.seq_q;
  const bf16* qb = a.q + int64_t(b) * a.q_sb + int64_t(h) * a.q_sh;
  const bf16* db = a.dout + int64_t(b) * a.d_sb + int64_t(h) * a.d_sh;

  // causal: queries before n0 see none of these keys
  for (int m0 = a.causal ? (n0 / WALK) * WALK : 0; m0 < a.seq_q; m0 += WALK) {
    const int m_valid = min(WALK, a.seq_q - m0);
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<D, WALK, THREADS>(sQ, qb + int64_t(m0) * a.q_ss, m_valid, a.q_ss);
    load_tile<D, WALK, THREADS>(sDo, db + int64_t(m0) * a.d_ss, m_valid, a.d_ss);
    load_rows<THREADS>(sLse, a.lse + row_base + m0, WALK, m_valid, 0.f);
    load_rows<THREADS>(sDi, a.di + row_base + m0, WALK, m_valid, 0.f);
    if (a.qseg != nullptr)
      load_rows<THREADS>(sSeg, a.qseg + int64_t(b) * a.qseg_sb + m0, WALK, m_valid, 0);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 32 queries
    if (does_dv) rows_by_rows_t<D>(wS, sK + rows * L::LD, sQ);
    if (does_dk) rows_by_rows_t<D>(wDp, sV + rows * L::LD, sDo);
    if constexpr (SPLIT) __syncthreads(); else __syncwarp();  // S and dP are written
#pragma unroll
    for (int c = 0; c < WALK / PER_KEY; ++c) {
      const int col = PER_KEY * c + part;
      const int qrow = m0 + col;
      bool keep = key < a.seq_kv && col < m_valid;
      if (a.causal) keep = keep && key <= qrow;
      if (a.kseg != nullptr) keep = keep && sKseg[rows + r] == sSeg[col];
      const float p = keep ? exp2f(wS[r * L::LD_S + col] - sLse[col]) : 0.f;
      const float ds = p * (wDp[r * L::LD_S + col] - sDi[col]) * a.ds_scale;
      wP[r * L::LD_P + col] = __float2bfloat16(p);
      wDs[r * L::LD_P + col] = __float2bfloat16(ds);
    }
    if constexpr (SPLIT) __syncthreads(); else __syncwarp();  // P and dS are written
    if (does_dv) accumulate<D>(acc[SUMS - 1], wP, sDo);  // dV += P^T dO
    if (does_dk) accumulate<D>(acc[0], wDs, sQ);         // dK += dS^T Qs
  }

  const int64_t base = ((int64_t(b) * heads + h) * (gridDim.x * OWN) + n0 + rows) * D;
  float* out_dk = static_cast<float*>(a.out0) + base;
  float* out_dv = static_cast<float*>(a.out1) + base;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if (does_dk) wmma::store_matrix_sync(out_dk + j * 16, acc[0][j], D, wmma::mem_row_major);
    if (does_dv)
      wmma::store_matrix_sync(out_dv + j * 16, acc[SUMS - 1][j], D, wmma::mem_row_major);
  }
}

// One block: query tile [m0, m0 + 64) of query head h, batch b; walks the key tiles.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(Args a) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDo = reinterpret_cast<bf16*>(smem + L::OWN_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::OWN_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * L::OWN_BYTES + L::WALK_BYTES);
  float* sS = reinterpret_cast<float*>(smem + 2 * L::OWN_BYTES + 2 * L::WALK_BYTES);
  float* sDp = sS + OWN * L::LD_S;
  bf16* sP = reinterpret_cast<bf16*>(sDp + OWN * L::LD_S);  // unused half of the layout
  bf16* sDs = sP + OWN * L::LD_P;
  float* sLse = reinterpret_cast<float*>(sDs + OWN * L::LD_P);
  float* sDi = sLse + OWN;
  int* sSeg = reinterpret_cast<int*>(sDi + OWN);  // key segments of the walked tile
  __shared__ int sQseg[OWN];

  const int m0 = blockIdx.x * OWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int heads = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m_valid = min(OWN, a.seq_q - m0);
  const int64_t row_base = (int64_t(b) * heads + h) * a.seq_q;

  load_tile<D, OWN>(sQ, a.q + int64_t(b) * a.q_sb + int64_t(h) * a.q_sh + int64_t(m0) * a.q_ss,
                    m_valid, a.q_ss);
  load_tile<D, OWN>(sDo, a.dout + int64_t(b) * a.d_sb + int64_t(h) * a.d_sh +
                             int64_t(m0) * a.d_ss, m_valid, a.d_ss);
  load_rows(sLse, a.lse + row_base + m0, OWN, m_valid, 0.f);
  load_rows(sDi, a.di + row_base + m0, OWN, m_valid, 0.f);
  if (a.qseg != nullptr) load_rows(sQseg, a.qseg + int64_t(b) * a.qseg_sb + m0, OWN, m_valid, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq[j], 0.f);
  const int r = lane >> 1;
  const int half = lane & 1;
  const int lrow = warp * 16 + r;
  const int qrow = m0 + lrow;
  float* wS = sS + warp * 16 * L::LD_S;
  float* wDp = sDp + warp * 16 * L::LD_S;
  bf16* wDs = sDs + warp * 16 * L::LD_P;
  const bf16* kb = a.k + int64_t(b) * a.k_sb + int64_t(hk) * a.k_sh;
  const bf16* vb = a.v + int64_t(b) * a.v_sb + int64_t(hk) * a.v_sh;

  // causal: the block's last query is m0 + 63, so later key tiles are all masked
  const int n_end = a.causal ? min(a.seq_kv, m0 + OWN) : a.seq_kv;
  for (int n0 = 0; n0 < n_end; n0 += WALK) {
    const int n_valid = min(WALK, a.seq_kv - n0);
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<D, WALK>(sK, kb + int64_t(n0) * a.k_ss, n_valid, a.k_ss);
    load_tile<D, WALK>(sV, vb + int64_t(n0) * a.v_ss, n_valid, a.v_ss);
    if (a.kseg != nullptr) load_rows(sSeg, a.kseg + int64_t(b) * a.kseg_sb + n0, WALK, n_valid, 0);
    __syncthreads();

    // S = Qs K^T and dP = dO V^T for the warp's 16 queries x 32 keys
    rows_by_rows_t<D>(wS, sQ + warp * 16 * L::LD, sK);
    rows_by_rows_t<D>(wDp, sDo + warp * 16 * L::LD, sV);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < WALK / 2; ++c) {
      const int col = 2 * c + half;
      const int key = n0 + col;
      bool keep = qrow < a.seq_q && col < n_valid;
      if (a.causal) keep = keep && key <= qrow;
      if (a.kseg != nullptr) keep = keep && sQseg[lrow] == sSeg[col];
      const float p = keep ? exp2f(wS[r * L::LD_S + col] - sLse[lrow]) : 0.f;
      wDs[r * L::LD_P + col] =
          __float2bfloat16(p * (wDp[r * L::LD_S + col] - sDi[lrow]) * a.ds_scale);
    }
    __syncwarp();
    accumulate<D>(dq, wDs, sK);  // dQ += dS K
  }

  float* dqb = static_cast<float*>(a.out0) +
               ((int64_t(b) * heads + h) * (gridDim.x * OWN) + m0 + warp * 16) * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(dqb + j * 16, dq[j], D, wmma::mem_row_major);
}

// ---------------------------------------------------------------- the wgmma core
namespace wg {

constexpr int OWN_ROWS = 128;  // rows a block owns: consumer warpgroups 0 and 1, 64 each
constexpr int W = 64;          // rows of a walked tile
constexpr int CHUNK = 32;      // walked tiles the producer warp judges at once, one a lane
// What a warpgroup does with a walked tile, and the header of the stage after the last.
enum : int { SKIP = 0, FULL = 1, MASKED = 2, END = -1 };

// One layout serves both kernels: two owned operands of 128 rows (K and V, or
// qs and dO), a ring of walked tiles of W rows (qs and dO, or K and V) and
// beside each stage its header {query head or END, first walked row, what
// warpgroup 0 does, what warpgroup 1 does}, then per walked row its segment
// id and, in the dK/dV kernel, its lse and di.
template <int D>
struct BwdSmem {
  static constexpr int STAGES = 4;
  static constexpr uint32_t OWN_BYTES = OWN_ROWS * D * 2;  // one owned operand
  static constexpr uint32_t WALK_BYTES = W * D * 2;        // one walked operand, one stage
  static constexpr uint32_t AUX_BYTES = 16 + 3 * W * 4;
  // the tiles start on 1,024-byte boundaries (the swizzle's period)
  static constexpr uint32_t OWN1_OFF = OWN_BYTES;
  static constexpr uint32_t WALK0_OFF = 2 * OWN_BYTES;
  static constexpr uint32_t WALK1_OFF = WALK0_OFF + STAGES * WALK_BYTES;
  static constexpr uint32_t AUX_OFF = WALK1_OFF + STAGES * WALK_BYTES;
  static constexpr uint32_t BAR_OFF = AUX_OFF + STAGES * AUX_BYTES;
  static constexpr uint32_t BARS = 1 + 2 * STAGES;  // owned, full[STAGES], empty[STAGES]
  static constexpr uint32_t TOTAL = BAR_OFF + BARS * 8 + 1024;  // + aligning the base
};

// The segment ids of some rows: the least, the greatest (lo > hi: no row)
// and a bit for each id mod 32. Two sets of rows share no id when their [lo,
// hi] are disjoint or their bits are.
struct Span {
  int lo, hi;
  uint32_t bits;
  __device__ __forceinline__ void add(int id) {
    lo = min(lo, id);
    hi = max(hi, id);
    bits |= 1u << (id & 31);
  }
};

// The segment ids of rows r0 .. r0 + 63 below `len`, by the whole warp (two a lane).
__device__ __forceinline__ Span warp_span(const int* seg, int r0, int len, int lane) {
  Span s{INT_MAX, INT_MIN, 0u};
  for (int r = r0 + lane; r < min(r0 + 64, len); r += 32) s.add(seg[r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.lo = min(s.lo, __shfl_xor_sync(0xffffffffu, s.lo, o));
    s.hi = max(s.hi, __shfl_xor_sync(0xffffffffu, s.hi, o));
    s.bits |= __shfl_xor_sync(0xffffffffu, s.bits, o);
  }
  return s;
}

// The segment ids of the walked tile's rows r0 .. r0 + W - 1 below `len`, by
// one lane alone: the producer judges 32 walked tiles at once.
__device__ __forceinline__ Span lane_span(const int* seg, int r0, int len) {
  Span s{INT_MAX, INT_MIN, 0u};
  const int end = min(r0 + W, len);
#pragma unroll 8
  for (int r = r0; r < end; ++r) s.add(__ldg(seg + r));
  return s;
}

// What a warpgroup does with a walked tile: its 64 owned rows from o0 (keys
// in the dK/dV kernel, queries in the dQ kernel) against the tile's W rows
// from w0, each cut at its sequence's end. SKIP when no pair of them is
// visible: no owned row, every key after every query (causal, top-left), or
// segment ids that share no id (`Span`: the bits catch MixToken's padding id
// 0 after a row's last segment, whose [lo, hi] spans every id). MASKED
// when some pair may be hidden: the causal diagonal, segment ids other than
// one id on both sides, and the dQ kernel's ragged last key tile (zero rows
// of K past the end would score 0, not be left out). Rows past the end on
// the query side need no mask: their lse reads +inf, so p = 0.
__device__ __forceinline__ int judge(bool own_keys, int o0, int own_len, int w0, int walk_len,
                                     bool causal, bool segs, Span own, Span walk) {
  if (o0 >= own_len) return SKIP;
  const int o1 = min(o0 + 63, own_len - 1), w1 = min(w0 + W - 1, walk_len - 1);
  const int q0 = own_keys ? w0 : o0, q1 = own_keys ? w1 : o1;
  const int k0 = own_keys ? o0 : w0, k1 = own_keys ? o1 : w1;
  if (causal && q1 < k0) return SKIP;
  bool masked = (causal && q0 < k1) || (!own_keys && w0 + W > walk_len);
  if (segs) {
    if (own.hi < walk.lo || walk.hi < own.lo || !(own.bits & walk.bits)) return SKIP;
    masked = masked || !(own.lo == own.hi && walk.lo == walk.hi && own.lo == walk.lo);
  }
  return masked ? MASKED : FULL;
}

// C (64 x W, fp32) = A B^T, issued: A a warpgroup's 64 owned rows (its
// panels OWN_ROWS rows apart), B a walked tile (panels W rows apart), both
// K-major over D.
template <int D>
__device__ __forceinline__ void issue_rows_t(float (&c)[W / 2], uint32_t a_rows,
                                             uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(c, smem_desc(a_rows + (kk / 4) * OWN_ROWS * ROW + off, 16, 1024),
                 smem_desc(b_tile + (kk / 4) * W * ROW + off, 16, 1024), kk > 0);
  }
}

// C (64 x D, fp32) += A B, issued: A (64 x W bf16) from registers, B a walked
// tile as an MN-major operand (16 rows a k16 step, the panels LBO apart).
template <int D>
__device__ __forceinline__ void issue_acc(float (&c)[D / 2], const uint32_t (&a)[W / 16][4],
                                          uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs<D>(c, a[kk], smem_desc(b_tile + kk * 16 * ROW, W * ROW, 1024));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// One stage's header and per-row data.
struct Stage {
  int* hdr;
  int* seg;
  float* lse;
  float* di;
  __device__ __forceinline__ explicit Stage(unsigned char* aux)
      : hdr(reinterpret_cast<int*>(aux)), seg(hdr + 4), lse(reinterpret_cast<float*>(seg + W)),
        di(lse + W) {}
};

// Barriers and tiles of one block, at the 1,024-aligned base of its shared memory.
template <int D>
struct Ring {
  using L = BwdSmem<D>;
  uint32_t base;
  unsigned char* aux;
  __device__ __forceinline__ Ring(unsigned char* smem_raw) {
    const uint32_t raw = smem_addr(smem_raw);
    base = (raw + 1023u) & ~1023u;
    aux = smem_raw + (base - raw) + L::AUX_OFF;
  }
  __device__ __forceinline__ uint32_t own(int i) const { return base + i * L::OWN1_OFF; }
  __device__ __forceinline__ uint32_t walk(int i, int s) const {
    return base + (i ? L::WALK1_OFF : L::WALK0_OFF) + s * L::WALK_BYTES;
  }
  __device__ __forceinline__ uint32_t bar_own() const { return base + L::BAR_OFF; }
  __device__ __forceinline__ uint32_t full(int s) const { return bar_own() + 8u * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar_own() + 8u * (1 + L::STAGES + s);
  }
  __device__ __forceinline__ Stage stage(int s) const { return Stage(aux + s * L::AUX_BYTES); }
  // thread 0: the owned tiles' barrier (one arrival with their bytes); each
  // stage's full (the producer warp's 32 lanes, one with the TMA bytes) and
  // empty (every consumer thread, done with the stage)
  __device__ __forceinline__ void init() const {
    bar_init(bar_own(), 1);
    for (int s = 0; s < L::STAGES; ++s) {
      bar_init(full(s), 32);
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer warp, at its t-th stage: waits until the stage is free
  // (passes at once on the first round) and returns its index
  __device__ __forceinline__ int acquire(int t) const {
    const int s = t % L::STAGES;
    bar_wait(empty(s), ((t / L::STAGES) & 1) ^ 1);
    return s;
  }
  // the producer warp: the stage after the last holds END, and no bytes
  __device__ __forceinline__ void finish(int t, int lane) const {
    const int s = acquire(t);
    if (lane == 0) stage(s).hdr[0] = END;
    bar_arrive(full(s));
  }
};

// The dK/dV kernel. One block: keys n0 .. n0 + 127 of kv head hk, batch b,
// split between the consumer warpgroups; walks (query tile, query head of
// the group) and sums dK and dV over both in registers.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                           const float* __restrict__ di, const int* __restrict__ qseg,
                           const int* __restrict__ kseg, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int heads, int seq_q, int seq_kv, int group,
                           int causal, int qseg_sb, int kseg_sb, float ds_scale, int dh) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const Ring<D> ring(smem_raw);
  const int n0 = blockIdx.x * OWN_ROWS, hk = blockIdx.y, b = blockIdx.z;
  const bool segs = qseg != nullptr;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: its first warp judges the query tiles and keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      bar_arrive_expect_tx(ring.bar_own(), 2 * L::OWN_BYTES);
      for (int p = 0; p < PANELS; ++p) {
        tma_load(ring.own(0) + p * OWN_ROWS * ROW, &tk, ring.bar_own(), 64 * p, hk, n0, b);
        tma_load(ring.own(1) + p * OWN_ROWS * ROW, &tv, ring.bar_own(), 64 * p, hk, n0, b);
      }
    }
    const int* qseg_b = segs ? qseg + int64_t(b) * qseg_sb : nullptr;
    Span own0{0, 0, 1u}, own1{0, 0, 1u};
    if (segs) {
      own0 = warp_span(kseg + int64_t(b) * kseg_sb, n0, seq_kv, lane);
      own1 = warp_span(kseg + int64_t(b) * kseg_sb, n0 + 64, seq_kv, lane);
    }
    const int n_tiles = (seq_q + W - 1) / W;
    int t = 0;  // stages filled
    // causal: queries before n0 see none of the block's keys
    for (int c = causal ? n0 / W : 0; c < n_tiles; c += CHUNK) {
      const int w0 = (c + lane) * W;
      int f0 = SKIP, f1 = SKIP;
      if (w0 < seq_q) {
        const Span walk = segs ? lane_span(qseg_b, w0, seq_q) : Span{0, 0, 1u};
        f0 = judge(true, n0, seq_kv, w0, seq_q, causal, segs, own0, walk);
        f1 = judge(true, n0 + 64, seq_kv, w0, seq_q, causal, segs, own1, walk);
      }
      for (uint32_t todo = __ballot_sync(0xffffffffu, (f0 | f1) != SKIP); todo;
           todo &= todo - 1) {
        const int i = __ffs(todo) - 1;
        const int m0 = (c + i) * W;
        const int g0 = __shfl_sync(0xffffffffu, f0, i), g1 = __shfl_sync(0xffffffffu, f1, i);
        for (int h = hk * group; h < (hk + 1) * group; ++h, ++t) {
          const int s = ring.acquire(t);
          const Stage st = ring.stage(s);
          const int64_t rows = (int64_t(b) * heads + h) * seq_q + m0;
          for (int r = lane; r < W; r += 32) {
            const bool in = m0 + r < seq_q;
            st.lse[r] = in ? lse[rows + r] : INFINITY;  // p = 0 for the zero rows past Sq
            st.di[r] = in ? di[rows + r] : 0.f;
            if (segs) st.seg[r] = in ? qseg_b[m0 + r] : 0;
          }
          if (lane == 0) {
            st.hdr[0] = h;
            st.hdr[1] = m0;
            st.hdr[2] = g0;
            st.hdr[3] = g1;
            bar_arrive_expect_tx(ring.full(s), 2 * L::WALK_BYTES);
            for (int p = 0; p < PANELS; ++p) {
              tma_load(ring.walk(0, s) + p * W * ROW, &tq, ring.full(s), 64 * p, h, m0, b);
              tma_load(ring.walk(1, s) + p * W * ROW, &tdo, ring.full(s), 64 * p, h, m0, b);
            }
          } else {
            bar_arrive(ring.full(s));
          }
        }
      }
    }
    ring.finish(t, lane);
    return;
  }

  // ---- consumer warpgroups 0 and 1: keys n0 + 64 wg .. n0 + 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  // accumulator register 4j + 2r + e holds key key0 + 8r and query column 8j + c0 + e
  const int key0 = n0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  int my_seg[2] = {0, 0};
  if (segs)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key0 + 8 * r < seq_kv) my_seg[r] = kseg[int64_t(b) * kseg_sb + key0 + 8 * r];

  float acc_dk[D / 2], acc_dv[D / 2], acc_s[W / 2], acc_dp[W / 2];
  uint32_t pa[W / 16][4], da[W / 16][4];
  zero(acc_dk);
  zero(acc_dv);
  const uint32_t k_wg = ring.own(0) + wg * 64 * ROW, v_wg = ring.own(1) + wg * 64 * ROW;
  bar_wait(ring.bar_own(), 0);

  for (int t = 0;; ++t) {
    const int s = t % L::STAGES;
    bar_wait(ring.full(s), (t / L::STAGES) & 1);
    const Stage st = ring.stage(s);
    if (st.hdr[0] == END) break;
    const int what = st.hdr[2 + wg];
    if (what == SKIP) {
      bar_arrive(ring.empty(s));
      continue;
    }
    const int m0 = st.hdr[1];
    // S^T = K qs^T and dP^T = V dO^T for the warpgroup's 64 keys x W queries
    // (zeroed first: the products overwrite them, and the last tile's values
    // need no registers meanwhile)
    zero(acc_s);
    zero(acc_dp);
    wgmma_fence();
    issue_rows_t<D>(acc_s, k_wg, ring.walk(0, s));
    issue_rows_t<D>(acc_dp, v_wg, ring.walk(1, s));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_s);
    pin(acc_dp);
    // P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - di) / log2(e), in fp32
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;
        const float l = st.lse[col], d = st.di[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float p = ex2(acc_s[i] - l);
          if (what == MASKED) {
            bool keep = !causal || key0 + 8 * r <= m0 + col;
            if (segs) keep = keep && st.seg[col] == my_seg[r];
            if (!keep) p = 0.f;
          }
          acc_dp[i] = p * (acc_dp[i] - d) * ds_scale;
          acc_s[i] = p;
        }
      }
    pack_a<W>(pa, acc_s);
    pack_a<W>(da, acc_dp);
    // dV += bf16(P^T) dO and dK += bf16(dS^T) qs
    pin(acc_dk);
    pin(acc_dv);
    pin(pa);
    pin(da);
    wgmma_fence();
    issue_acc<D>(acc_dv, pa, ring.walk(1, s));
    issue_acc<D>(acc_dk, da, ring.walk(0, s));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dk);
    pin(acc_dv);
    bar_arrive(ring.empty(s));
  }

  // dK, dV in bf16 into (B, Skv, Hkv, dh), written once
  const int hkv = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_kv) continue;
    const int64_t off = ((int64_t(b) * seq_kv + key) * hkv + hk) * dh + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j + c0 >= dh) break;
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(acc_dk[i], acc_dk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(acc_dv[i], acc_dv[i + 1]);
    }
  }
}

// The dQ kernel. One block: queries m0 .. m0 + 127 of query head h, batch b,
// split between the consumer warpgroups; walks the key tiles of kv head
// h / group and sums dQ over them in registers.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                          const float* __restrict__ di, const int* __restrict__ qseg,
                          const int* __restrict__ kseg, bf16* __restrict__ dq, int seq_q,
                          int seq_kv, int group, int causal, int qseg_sb, int kseg_sb,
                          float ds_scale, int dh) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const Ring<D> ring(smem_raw);
  // causal: the blocks with the longest key walks are launched first
  const int mb = causal ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x);
  const int m0 = mb * OWN_ROWS, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const bool segs = qseg != nullptr;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: its first warp judges the key tiles and keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x & 31;
    const int hk = h / group;  // GQA: the kv head this query head reads
    if (lane == 0) {
      bar_arrive_expect_tx(ring.bar_own(), 2 * L::OWN_BYTES);
      for (int p = 0; p < PANELS; ++p) {
        tma_load(ring.own(0) + p * OWN_ROWS * ROW, &tq, ring.bar_own(), 64 * p, h, m0, b);
        tma_load(ring.own(1) + p * OWN_ROWS * ROW, &tdo, ring.bar_own(), 64 * p, h, m0, b);
      }
    }
    const int* kseg_b = segs ? kseg + int64_t(b) * kseg_sb : nullptr;
    Span own0{0, 0, 1u}, own1{0, 0, 1u};
    if (segs) {
      own0 = warp_span(qseg + int64_t(b) * qseg_sb, m0, seq_q, lane);
      own1 = warp_span(qseg + int64_t(b) * qseg_sb, m0 + 64, seq_q, lane);
    }
    // causal: the block's last query is m0 + 127, so later key tiles are all masked
    const int n_end = causal ? min(seq_kv, m0 + OWN_ROWS) : seq_kv;
    const int n_tiles = (n_end + W - 1) / W;
    int t = 0;
    for (int c = 0; c < n_tiles; c += CHUNK) {
      const int w0 = (c + lane) * W;
      int f0 = SKIP, f1 = SKIP;
      if (c + lane < n_tiles) {
        const Span walk = segs ? lane_span(kseg_b, w0, seq_kv) : Span{0, 0, 1u};
        f0 = judge(false, m0, seq_q, w0, seq_kv, causal, segs, own0, walk);
        f1 = judge(false, m0 + 64, seq_q, w0, seq_kv, causal, segs, own1, walk);
      }
      for (uint32_t todo = __ballot_sync(0xffffffffu, (f0 | f1) != SKIP); todo;
           todo &= todo - 1, ++t) {
        const int i = __ffs(todo) - 1;
        const int n0 = (c + i) * W;
        const int g0 = __shfl_sync(0xffffffffu, f0, i), g1 = __shfl_sync(0xffffffffu, f1, i);
        const int s = ring.acquire(t);
        const Stage st = ring.stage(s);
        if (segs)
          for (int r = lane; r < W; r += 32) st.seg[r] = n0 + r < seq_kv ? kseg_b[n0 + r] : 0;
        if (lane == 0) {
          st.hdr[0] = h;
          st.hdr[1] = n0;
          st.hdr[2] = g0;
          st.hdr[3] = g1;
          bar_arrive_expect_tx(ring.full(s), 2 * L::WALK_BYTES);
          for (int p = 0; p < PANELS; ++p) {
            tma_load(ring.walk(0, s) + p * W * ROW, &tk, ring.full(s), 64 * p, hk, n0, b);
            tma_load(ring.walk(1, s) + p * W * ROW, &tv, ring.full(s), 64 * p, hk, n0, b);
          }
        } else {
          bar_arrive(ring.full(s));
        }
      }
    }
    ring.finish(t, lane);
    return;
  }

  // ---- consumer warpgroups 0 and 1: queries m0 + 64 wg .. m0 + 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  // accumulator register 4j + 2r + e holds query row0 + 8r and key column 8j + c0 + e
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float my_lse[2], my_di[2];
  int my_seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < seq_q;
    const int64_t at = (int64_t(b) * heads + h) * seq_q + row;
    my_lse[r] = in ? lse[at] : INFINITY;  // p = 0 for the zero rows past Sq
    my_di[r] = in ? di[at] : 0.f;
    if (segs && in) my_seg[r] = qseg[int64_t(b) * qseg_sb + row];
  }

  float acc_dq[D / 2], acc_s[W / 2], acc_dp[W / 2];
  uint32_t da[W / 16][4];
  zero(acc_dq);
  const uint32_t q_wg = ring.own(0) + wg * 64 * ROW, do_wg = ring.own(1) + wg * 64 * ROW;
  bar_wait(ring.bar_own(), 0);

  for (int t = 0;; ++t) {
    const int s = t % L::STAGES;
    bar_wait(ring.full(s), (t / L::STAGES) & 1);
    const Stage st = ring.stage(s);
    if (st.hdr[0] == END) break;
    const int what = st.hdr[2 + wg];
    if (what == SKIP) {
      bar_arrive(ring.empty(s));
      continue;
    }
    const int n0 = st.hdr[1];
    // S = qs K^T and dP = dO V^T for the warpgroup's 64 queries x W keys
    zero(acc_s);
    zero(acc_dp);
    wgmma_fence();
    issue_rows_t<D>(acc_s, q_wg, ring.walk(0, s));
    issue_rows_t<D>(acc_dp, do_wg, ring.walk(1, s));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_s);
    pin(acc_dp);
    // dS = exp2(S - lse) (dP - di) scale, in fp32
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n0 + 8 * j + c0 + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float p = ex2(acc_s[i] - my_lse[r]);
          if (what == MASKED) {
            bool keep = key < seq_kv && (!causal || key <= row0 + 8 * r);
            if (segs) keep = keep && st.seg[key - n0] == my_seg[r];
            if (!keep) p = 0.f;
          }
          acc_dp[i] = p * (acc_dp[i] - my_di[r]) * ds_scale;
        }
      }
    pack_a<W>(da, acc_dp);
    // dQ += bf16(dS) K
    pin(acc_dq);
    pin(da);
    wgmma_fence();
    issue_acc<D>(acc_dq, da, ring.walk(0, s));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dq);
    bar_arrive(ring.empty(s));
  }

  // dQ in bf16 into (B, Sq, H, dh), written once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_q) continue;
    bf16* out = dq + ((int64_t(b) * seq_q + row) * heads + h) * dh + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j + c0 >= dh) break;
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * r], acc_dq[4 * j + 2 * r + 1]);
    }
  }
}

}  // namespace wg

template <int D>
int launch(bool dkv, const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::TOTAL;
  void (*kernel)(Args) = dkv ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>;
  const int threads = dkv && D > 128 ? SPLIT_THREADS : NUM_THREADS;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int rows = dkv ? a.seq_kv : a.seq_q;
  dim3 grid((rows + OWN - 1) / OWN, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int D>
int launch_wgmma(bool dkv, const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr uint32_t smem = wg::BwdSmem<D>::TOTAL;
  static_assert(smem <= 232448, "shared memory above the 227 KB a block can opt into");
  const int hkv = heads / a.group;
  // boxes: the owned operands' 128 rows, the walked ones' 64
  const int q_rows = dkv ? wg::W : wg::OWN_ROWS, kv_rows = dkv ? wg::OWN_ROWS : wg::W;
  // over the caller's dh columns: TMA reads the columns up to D past them as zeros
  CUtensorMap tq, tk, tv, tdo;
  CUresult res =
      wg::make_map(&tq, a.q, batch, a.seq_q, heads, a.dh, a.q_sb, a.q_ss, a.q_sh, q_rows);
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tk, a.k, batch, a.seq_kv, hkv, a.dh, a.k_sb, a.k_ss, a.k_sh, kv_rows);
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tv, a.v, batch, a.seq_kv, hkv, a.dh, a.v_sb, a.v_ss, a.v_sh, kv_rows);
  if (res == CUDA_SUCCESS)
    res = wg::make_map(&tdo, a.dout, batch, a.seq_q, heads, a.dh, a.d_sb, a.d_ss, a.d_sh,
                       q_rows);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(res);
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(wg::flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.seq_kv + wg::OWN_ROWS - 1) / wg::OWN_ROWS, hkv, batch);
    wg::flash_bwd_dkv_wgmma_kernel<D><<<grid, wg::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.di, a.qseg, a.kseg, static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), heads, a.seq_q, a.seq_kv, a.group, a.causal, a.qseg_sb,
        a.kseg_sb, a.ds_scale, a.dh);
  } else {
    err = cudaFuncSetAttribute(wg::flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.seq_q + wg::OWN_ROWS - 1) / wg::OWN_ROWS, heads, batch);
    wg::flash_bwd_dq_wgmma_kernel<D><<<grid, wg::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.di, a.qseg, a.kseg, static_cast<bf16*>(a.out0), a.seq_q,
        a.seq_kv, a.group, a.causal, a.qseg_sb, a.kseg_sb, a.ds_scale, a.dh);
  }
  return int(cudaGetLastError());
}

// The fixed table of cores by compiled head_dim: the wgmma core serves 64 and
// 128, the WMMA core every other width.
constexpr bool uses_wgmma(int head_dim) { return head_dim == 64 || head_dim == 128; }

int dispatch(bool dkv, const Args& a, int batch, int heads, int head_dim, cudaStream_t s) {
  if (a.group < 1 || heads % a.group != 0 || (a.qseg == nullptr) != (a.kseg == nullptr) ||
      (a.causal && a.seq_q != a.seq_kv) || a.dh < 1 || a.dh > head_dim || a.dh % 8 != 0 ||
      (!uses_wgmma(head_dim) && a.dh != head_dim))
    return int(cudaErrorInvalidValue);
  switch (head_dim) {  // the table of `uses_wgmma`
    case 32: return launch<32>(dkv, a, batch, heads, s);
    case 64: return launch_wgmma<64>(dkv, a, batch, heads, s);
    case 128: return launch_wgmma<128>(dkv, a, batch, heads, s);
    case 160: return launch<160>(dkv, a, batch, heads, s);
    case 256: return launch<256>(dkv, a, batch, heads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int* qseg, const int* kseg, void* out0, void* out1,
               int seq_q, int seq_kv, int group, int causal, int qseg_sb, int kseg_sb,
               int dh, const int* st, float ds_scale) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di, qseg, kseg,
              out0, out1, seq_q, seq_kv, group, causal, qseg_sb, kseg_sb, dh,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
              st[11], ds_scale};
}

}  // namespace

// qs (pre-scaled by scale*log2(e)), dout: (B, Sq, H, dh); k, v: (B, Skv, H /
// group, dh); bf16 with unit stride over dh and the given batch/seq/head
// strides (elements, each a multiple of 8, rows 16-byte aligned; the four
// tensors' strides in st[12]). head_dim: the compiled width that serves them;
// dh, a multiple of 8, is at most head_dim on the wgmma core (its columns
// past dh read as zeros) and equal to it on the WMMA core. lse, di: (B, H, Sq)
// fp32 contiguous. qseg/kseg: (B, S) int32 with unit stride over S, or both
// null. dk, dv: on the wgmma core (`flash_bwd_core`) bf16 (B, Skv, H / group,
// dh) contiguous, the GQA groups summed; on the WMMA core fp32 (B, H,
// ceil(Skv / 64) * 64, D) contiguous, one per query head. Returns the
// cudaError_t of the launch, or 10000 + the CUresult of a tensor map that
// libcuda refused.
extern "C" int flash_bwd_dkv_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* di, const int* qseg,
                                  const int* kseg, void* dk, void* dv, int batch, int heads,
                                  int seq_q, int seq_kv, int head_dim, int dh, int group,
                                  int causal, int qseg_sb, int kseg_sb, const int* st,
                                  void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dk, dv, seq_q, seq_kv, group,
                           causal, qseg_sb, kseg_sb, dh, st, 1.f / LOG2E);
  return dispatch(true, a, batch, heads, head_dim, static_cast<cudaStream_t>(stream));
}

// The same operands; dq, the gradient of the unscaled q (ds carries `scale`):
// on the wgmma core bf16 (B, Sq, H, dh) contiguous, on the WMMA core fp32 (B,
// H, ceil(Sq / 64) * 64, D) contiguous.
extern "C" int flash_bwd_dq_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* di, const int* qseg,
                                 const int* kseg, void* dq, int batch, int heads, int seq_q,
                                 int seq_kv, int head_dim, int dh, int group, int causal,
                                 int qseg_sb, int kseg_sb, const int* st, float scale,
                                 void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dq, nullptr, seq_q, seq_kv,
                           group, causal, qseg_sb, kseg_sb, dh, st, scale);
  return dispatch(false, a, batch, heads, head_dim, static_cast<cudaStream_t>(stream));
}

// The core the table sends a compiled head_dim to (1 wgmma, 0 WMMA) and, for
// the wgmma core, its blocks' dynamic shared memory in *smem_bytes (else 0),
// the same for both kernels.
extern "C" int flash_bwd_core(int head_dim, int* smem_bytes) {
  const bool wgmma = uses_wgmma(head_dim);
  *smem_bytes = !wgmma ? 0 : head_dim == 64 ? int(wg::BwdSmem<64>::TOTAL)
                                             : int(wg::BwdSmem<128>::TOTAL);
  return wgmma ? 1 : 0;
}
