// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v/o, fp32 online softmax.
//
// Replaces the Pallas kernel paddlemix_tpu/ops/attention.py `_flash_fwd` /
// `_fwd_kernel`, in both of its forms: the inference form (B1, no lse output),
// which serves the self-attention of the SDXL UNet and the SD3 MM-DiT, and the
// form that also writes the base-2 log-sum-exp of each row (B15, `want_lse`),
// which is the residual of the flash backward (csrc/flash_bwd.cu) on the
// training path and the output of `flash_attention_with_lse`. Options, as in
// the TPU kernel: causal (top-left aligned, col <= row; key tiles wholly above
// the diagonal are skipped), segment ids (a key is seen only by queries of the
// same id, from two int32 arrays), and GQA (query head h reads kv head
// h / group).
//
// What bounds it: at head_dim 64-128 the two products do 4*S*S*D flops per head
// for 4*S*D*2 bytes of q/k/v/o, so the card is compute-bound and the limit is
// how well the tensor cores are fed. The scores never reach device memory: a
// block owns 64 query rows of one (batch, head), keeps them in shared memory as
// four 16-row warp tiles, and walks the keys in 64-row tiles staged in shared
// memory. Each warp computes S = Q K^T with 16x16x16 bf16 WMMA fragments (fp32
// accumulate), runs the online softmax in fp32 with exp2 and scale*log2(e)
// folded into the scores (`scale_log2`; the lse form passes q pre-scaled and
// rounded to bf16, as the TPU wrapper does, and scale_log2 = 1, so that the
// backward recomputes the very scores whose lse this writes), rounds P to bf16
// (as the TPU kernel does before its PV product) and accumulates O += P V into
// an fp32 tile in shared memory, which it rescales row by row with the softmax
// correction. q/k/v/o are read and written in their (B, S, H, D) layout through
// strides, so no transpose copies are made. The ragged query and key edges are
// masked by bounds (rows past S are zero-filled in shared memory; scores past
// Skv are -inf), not by padding.
//
// Left for later work: wgmma + TMA with a producer warp and a ring of K/V
// stages (this version loads K/V synchronously, then computes), keeping O in
// registers, skipping key tiles that no query of the block shares a segment
// with, head_dim above 128, int8 QK^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // key rows per tile
constexpr int NUM_WARPS = BLOCK_M / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD_H = 8;  // bf16 row padding: keeps WMMA ldm a multiple of 8, spreads banks
constexpr int PAD_F = 4;  // fp32 row padding

template <int D>
struct Layout {
  static constexpr int LD_QKV = D + PAD_H;
  static constexpr int LD_S = BLOCK_N + PAD_F;
  static constexpr int LD_P = BLOCK_N + PAD_H;
  static constexpr int LD_O = D + PAD_F;
  // every section is a multiple of 32 bytes, so every WMMA tile pointer is 32-byte aligned
  static constexpr size_t Q_BYTES = size_t(BLOCK_M) * LD_QKV * sizeof(bf16);
  static constexpr size_t KV_BYTES = size_t(BLOCK_N) * LD_QKV * sizeof(bf16);
  static constexpr size_t S_BYTES = size_t(BLOCK_M) * LD_S * sizeof(float);
  static constexpr size_t P_BYTES = size_t(BLOCK_M) * LD_P * sizeof(bf16);
  static constexpr size_t O_BYTES = size_t(BLOCK_M) * LD_O * sizeof(float);
  static constexpr size_t SEG_BYTES = size_t(BLOCK_N) * sizeof(int);
  static constexpr size_t TOTAL = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES +
                                  SEG_BYTES;
};

// Copy `rows` x D bf16 rows (row stride `stride` elements) into shared memory
// with 16-byte vectors; rows past `valid` are zero-filled so that masked keys
// contribute 0 * 0 and never 0 * garbage.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int valid, int stride) {
  constexpr int VEC = 8;
  constexpr int VPR = D / VEC;
  constexpr int LD = Layout<D>::LD_QKV;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NUM_THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + int64_t(r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int seq_q, int seq_kv,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                 float scale_log2, int group, int causal, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, int qseg_sb, int kseg_sb,
                 float* __restrict__ lse) {
  using L = Layout<D>;
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

  const int m0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<D, BLOCK_M>(sQ, q + int64_t(b) * q_sb + int64_t(h) * q_sh + int64_t(m0) * q_ss,
                        min(BLOCK_M, seq_q - m0), q_ss);
  for (int i = threadIdx.x; i < BLOCK_M * L::LD_O; i += NUM_THREADS) sO[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::LD_QKV + kk * 16, L::LD_QKV);

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
      const float s = keep ? srow[col] * scale_log2 : -INFINITY;
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int seq_q, int seq_kv, const int* st, float scale_log2, int group, int causal,
           const int* qseg, const int* kseg, int qseg_sb, int kseg_sb, float* lse,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((seq_q + BLOCK_M - 1) / BLOCK_M, heads, batch);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq_q, seq_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2, group, causal, qseg, kseg, qseg_sb,
      kseg_sb, lse);
  return int(cudaGetLastError());
}

}  // namespace

// q, o: (B, Sq, H, D), k, v: (B, Skv, H / group, D), bf16 with unit stride
// over D and the given batch/seq/head strides (elements, each a multiple of
// 8). qseg/kseg: (B, Sq) / (B, Skv) int32 with unit stride over S and batch
// strides qseg_sb/kseg_sb, or both null (no segments). lse: (B, H, Sq) fp32,
// contiguous, or null (not written). causal needs Sq == Skv. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                              int heads, int seq_q, int seq_kv, int head_dim, int q_sb,
                              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                              int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale_log2,
                              int group, int causal, const int* qseg, const int* kseg,
                              int qseg_sb, int kseg_sb, float* lse, void* stream) {
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || heads % group != 0 || (qseg == nullptr) != (kseg == nullptr) ||
      (causal && seq_q != seq_kv))
    return int(cudaErrorInvalidValue);
#define FLASH_FWD_CASE(DIM)                                                                 \
  case DIM:                                                                                 \
    return launch<DIM>(q, k, v, o, batch, heads, seq_q, seq_kv, st, scale_log2, group, causal, \
                       qseg, kseg, qseg_sb, kseg_sb, lse, s);
  switch (head_dim) {
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(96)
    FLASH_FWD_CASE(128)
    default: return int(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_CASE
}
