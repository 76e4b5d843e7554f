// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces the Pallas kernels paddlemix_tpu/ops/attention.py `_flash_bwd`
// (B14): `_bwd_dkv_kernel` (pallas_call at `_flash_bwd`'s first call) and
// `_bwd_dq_kernel` (its second). As on the TPU, the two run apart and neither
// uses atomics, so the gradients are deterministic: the dK/dV kernel owns a key
// tile and walks the query tiles, the dQ kernel owns a query tile and walks the
// key tiles. Both recompute the scores from q pre-scaled by scale*log2(e) and
// rounded to bf16 (`qs`, the very operand the lse forward of csrc/flash_fwd.cu
// took) and the base-2 lse that forward wrote, so p = exp2(s - lse) is the
// forward's softmax; di = rowsum(o * do) in fp32 comes from the wrapper, as it
// comes from XLA in the JAX package. Per (query, key):
//   p  = exp2(s - lse)                (fp32; 0 where causal or segments mask)
//   dp = do . v
//   dK/dV kernel: dv += bf16(p)^T do, dk += bf16(p (dp - di) / log2(e))^T qs
//   dQ kernel:    dq += bf16(p (dp - di) * scale) k
// Causal (top-left): the dK/dV kernel starts at the query tile holding the
// key tile's first row, the dQ kernel stops after the diagonal tile. Segment
// ids mask from two int32 arrays. GQA: query head h reads kv head h / group,
// and the dK/dV kernel writes one fp32 dK/dV per query head, which the wrapper
// sums over each group, as the JAX package sums its per-head outputs.
//
// What bounds it: the five products of a (query, key) tile pair do 10*D flops
// per pair against bytes read once per tile, so like the forward it is
// compute-bound, and the limit is how the tensor cores are fed. Each warp owns
// 16 rows (keys in dK/dV, queries in dQ) and keeps its accumulator in
// registers as 16x16 fp32 WMMA fragments for the whole walk, so the
// accumulators never leave the SM until the end. The walked tiles (32 rows)
// and the scores, dP, P and dS of the owned rows x 32 sit in shared memory.
// Outputs are fp32 (B, H, S_pad, D) with S padded to the 64-row tile, stored
// straight from the fragments; the wrapper slices, sums over GQA groups and
// casts.
//
// Head dims 32-128: a block of 4 warps; in the dK/dV kernel each warp holds
// both its dK and its dV (D fp32 registers a thread for the two sums: 128 at
// D = 128; ~80 KB of shared memory, two blocks an SM). Head dims 160 and 256
// (heads of 129-256 padded, as the forward pads them): both 16 x D sums in one warp
// would be 160 / 256 registers a thread for the accumulators alone, past the
// 255 a thread may have. So the dK/dV kernel runs 8 warps, split by output:
// warps 0-3 compute S^T = K Q^T for their 16 keys and accumulate dV, warps
// 4-7 compute dP^T = V dO^T for the same keys and accumulate dK; the pair
// (w, w + 4) shares the elementwise P / dS step, and every warp holds one
// 16 x D sum (80 / 128 registers, as dQ's). Shared memory is the 4-warp
// layout's: 93,952 bytes at D = 160, 130,816 at D = 256. One template holds
// both forms (`SPLIT`, set above 128, picks the roles, the threads' share of
// the P / dS step and the block-wide syncs), so the masks, the lse and the
// stores are written once. The dQ kernel needs no change there: one 16 x D
// sum a warp.
//
// Left for later work: wgmma + TMA, a ring of walked tiles in flight, skipping
// tiles that share no segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
  float *out0, *out1;            // (B, H, S_pad, D) fp32: dK, dV or dQ
  int seq_q, seq_kv, group, causal, qseg_sb, kseg_sb;
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  float ds_scale;  // 1/log2(e) for dK, the softmax scale for dQ
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
  // 13 registers at D = 96: 180, two blocks an SM instead of three)
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
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if (does_dk)
      wmma::store_matrix_sync(a.out0 + base + j * 16, acc[0][j], D, wmma::mem_row_major);
    if (does_dv)
      wmma::store_matrix_sync(a.out1 + base + j * 16, acc[SUMS - 1][j], D, wmma::mem_row_major);
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

  float* dqb = a.out0 + ((int64_t(b) * heads + h) * (gridDim.x * OWN) + m0 + warp * 16) * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(dqb + j * 16, dq[j], D, wmma::mem_row_major);
}

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

int dispatch(bool dkv, const Args& a, int batch, int heads, int head_dim, cudaStream_t s) {
  if (a.group < 1 || heads % a.group != 0 || (a.qseg == nullptr) != (a.kseg == nullptr) ||
      (a.causal && a.seq_q != a.seq_kv))
    return int(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32: return launch<32>(dkv, a, batch, heads, s);
    case 64: return launch<64>(dkv, a, batch, heads, s);
    case 96: return launch<96>(dkv, a, batch, heads, s);
    case 128: return launch<128>(dkv, a, batch, heads, s);
    case 160: return launch<160>(dkv, a, batch, heads, s);
    case 256: return launch<256>(dkv, a, batch, heads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int* qseg, const int* kseg, float* out0, float* out1,
               int seq_q, int seq_kv, int group, int causal, int qseg_sb, int kseg_sb,
               const int* st, float ds_scale) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di, qseg, kseg,
              out0, out1, seq_q, seq_kv, group, causal, qseg_sb, kseg_sb,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
              st[11], ds_scale};
}

}  // namespace

// qs (pre-scaled by scale*log2(e)), dout: (B, Sq, H, D); k, v: (B, Skv, H /
// group, D); bf16 with unit stride over D and the given batch/seq/head strides
// (elements, each a multiple of 8; the four tensors' strides in st[12]). lse,
// di: (B, H, Sq) fp32 contiguous. qseg/kseg: (B, S) int32 with unit stride
// over S, or both null. dk, dv: (B, H, ceil(Skv / 64) * 64, D) fp32
// contiguous, one per query head. Returns the cudaError_t of the launch.
extern "C" int flash_bwd_dkv_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* di, const int* qseg,
                                  const int* kseg, float* dk, float* dv, int batch, int heads,
                                  int seq_q, int seq_kv, int head_dim, int group, int causal,
                                  int qseg_sb, int kseg_sb, const int* st, void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dk, dv, seq_q, seq_kv, group,
                           causal, qseg_sb, kseg_sb, st, 1.f / LOG2E);
  return dispatch(true, a, batch, heads, head_dim, static_cast<cudaStream_t>(stream));
}

// The same operands; dq: (B, H, ceil(Sq / 64) * 64, D) fp32 contiguous, the
// gradient of the unscaled q (ds carries `scale`).
extern "C" int flash_bwd_dq_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* di, const int* qseg,
                                 const int* kseg, float* dq, int batch, int heads, int seq_q,
                                 int seq_kv, int head_dim, int group, int causal, int qseg_sb,
                                 int kseg_sb, const int* st, float scale, void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dq, nullptr, seq_q, seq_kv,
                           group, causal, qseg_sb, kseg_sb, st, scale);
  return dispatch(false, a, batch, heads, head_dim, static_cast<cudaStream_t>(stream));
}
