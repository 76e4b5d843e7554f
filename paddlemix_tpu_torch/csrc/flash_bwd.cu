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
// One core (namespace `wg`, with the Hopper blocks of csrc/wgmma.cuh that the
// forward shares), four widths, chosen by a fixed table of the head width
// (`compiled_width`, `Form`), never by the outcome of a launch:
//
//   head      D    dK/dV block: rows, stages, split   dQ block           bytes a block (dK/dV / dQ)
//   8-64      64      128, 4, by rows                  128, 4, by rows    102,536 / 102,536
//   72-128   128      128, 4, by rows                  128, 4, by rows    200,840 / 200,840
//   136-192  192       64, 3, by output                128, 2, by rows    216,424 / 199,240
//   200-256  256       64, 2, by output                 64, 2, by output  215,624 / 232,008
//
// A head of a multiple of 8 is read in place (the tensor maps take the
// caller's width and TMA fills the columns up to D with zeros, which change
// no product) and its gradients are written at that width; the wrapper pads
// any other head to D.
//
// A block is a producer warpgroup, whose first warp alone works and which
// hands its registers to the consumers (`setmaxnreg` 40 / 232), and two
// consumer warpgroups. The producer loads the block's owned operands once by
// TMA (K and V of its keys of one (batch, kv head), or qs and dO of its
// queries of one (batch, head)) and walks the other side in 64-row tiles (qs
// and dO with their lse, di and segment ids, or K and V with their segment
// ids) through a ring of stages under full and empty mbarriers. The dK/dV
// kernel walks every (query tile, query head of the GQA group) pair, so the
// group's sum happens in registers. Products are m64nNk16 `wgmma`: S^T = K
// qs^T and dP^T = V dO^T (dK/dV) or S = qs K^T and dP = dO V^T (dQ) with both
// operands K-major in shared memory; P and dS in fp32 on the accumulator
// registers; then dV += P^T dO and dK += dS^T qs, or dQ += dS K, with A from
// registers (the accumulator's fragment order, bf16) and B MN-major (the
// transpose bit). dK, dV, dQ stay in fp32 registers for the whole walk and are
// written once, in bf16, in the caller's (B, S, H, d) layout. TMA reads the
// strided (d, H, S, B) views and fills rows past S with zeros; the queries
// past Sq get lse = +inf, so p = 0 there, and the dQ kernel masks the keys
// past Skv of its last tile. Within a warpgroup the products of one tile and
// its elementwise step run in turn; the two warpgroups overlap each other.
//
// The two ways a block splits its work. By rows (D 64 and 128, and dQ at
// 192): the block owns 128 rows and each consumer warpgroup does all of a
// tile's work for 64 of them, holding dK and dV (or dQ) and the tile's two
// 64 x 64 score tiles. By output (dK/dV at 192 and 256, dQ at 256): dK and dV
// at D 256 would be 256 registers a thread for the sums alone, and 128 owned
// rows of two operands would leave room for one stage, so the block owns 64
// rows and the warpgroups share every tile, one output each, each issuing two
// products a tile. dK/dV: warpgroup 0 computes S^T, then P^T, hands P^T to
// warpgroup 1 through an fp32 64 x 64 exchange tile and sums dV; warpgroup 1
// computes dP^T, forms dS^T from the P^T it takes and sums dK. dQ: warpgroup
// 0 computes S and P, warpgroup 1 dP; they swap them through two exchange
// tiles, both form dS, and each sums half of dQ's columns (N = D / 2 from the
// K tile's panels). A thread's accumulator registers hold the same (row,
// column) pairs in both warpgroups, so a thread exchanges with its twin:
// float4 slots, a warp's access 512 consecutive bytes. Named barriers order
// the exchange (`XCH_FULL`: the tile is written; `XCH_FREE0/1`: the other
// warpgroup has read it, so it may be written again). dQ at 192 keeps 128
// rows: its sums take 96 + 32 + 32 registers, and by output its halves of 96
// columns would end inside a 64-column swizzle atom of the MN-major K panel.
//
// Tile skipping. The producer judges each walked tile against each 64 owned
// rows (`judge`): SKIP when causal hides all of it or when the two sides'
// segment ids share no id, by disjoint [min, max] spans or disjoint masks of
// id mod 32; a tile that no warpgroup works on is never loaded. A skipped pair
// contributes exactly 0: every query that sees at least one key (all of them,
// in causal self-attention with segments) has p = exp2(mask - lse) = 0 at a
// masked key, in JAX as here. Only tiles at the causal diagonal, at the ragged
// end or with mixed segment ids are masked element by element. Every width
// judges 64 x 64 pairs, so `flash_bwd_tile_visits` and the plain versions
// `flash_bwd_{dkv,dq}_tiled_ref` (ops/attention.py) walk the kernels' tiles.
// Causal blocks with the longest walks go first: the dQ kernel reverses its
// block order, and the dK/dV kernel's first blocks (the first keys) already
// walk the most queries.
//
// Left for later work: a head-40 instantiation, 128-row walked tiles at D 64
// (faster in a probe, but the dK/dV kernel then spills), and scheduling the
// two consumer warpgroups' elementwise steps against each other.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The compiled width that serves a head of d columns (the fixed table).
constexpr int compiled_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256; }

namespace wg {

constexpr int W = 64;      // rows of a walked tile, and of a warpgroup's owned rows
constexpr int CHUNK = 32;  // walked tiles the producer warp judges at once, one a lane
// What a warpgroup does with a walked tile, and the header of the stage after the last.
enum : int { SKIP = 0, FULL = 1, MASKED = 2, END = -1 };
// The named barriers of the exchange (0 is __syncthreads').
enum : int { XCH_FULL = 1, XCH_FREE0 = 2, XCH_FREE1 = 3 };

// A kernel's block at a compiled width (see the table at the top).
template <int D, bool DKV>
struct Form {
  // the consumer warpgroups split 64 rows' outputs, else each owns 64 rows
  static constexpr bool SPLIT = DKV ? D > 128 : D > 192;
  static constexpr int OWN = SPLIT ? 64 : 128;  // rows a block owns
  static constexpr int STAGES = D <= 128 ? 4 : D == 192 && DKV ? 3 : 2;
  static constexpr int XCH = SPLIT ? (DKV ? 1 : 2) : 0;  // fp32 64 x 64 exchange tiles
};

// One layout serves both kernels: two owned operands (K and V, or qs and dO),
// a ring of walked tiles of W rows (qs and dO, or K and V), the exchange
// tiles, and beside each stage its header {query head or END, first walked
// row, what warpgroup 0 does, what warpgroup 1 does}, then per walked row its
// segment id and, in the dK/dV kernel, its lse and di.
template <int D, bool DKV>
struct BwdSmem {
  using F = Form<D, DKV>;
  static constexpr int STAGES = F::STAGES;
  static constexpr uint32_t OWN_BYTES = F::OWN * D * 2;  // one owned operand
  static constexpr uint32_t WALK_BYTES = W * D * 2;      // one walked operand, one stage
  static constexpr uint32_t XCH_BYTES = W * W * 4;
  static constexpr uint32_t AUX_BYTES = 16 + 3 * W * 4;
  // the tiles start on 1,024-byte boundaries (the swizzle's period)
  static constexpr uint32_t OWN1_OFF = OWN_BYTES;
  static constexpr uint32_t WALK0_OFF = 2 * OWN_BYTES;
  static constexpr uint32_t WALK1_OFF = WALK0_OFF + STAGES * WALK_BYTES;
  static constexpr uint32_t XCH_OFF = WALK1_OFF + STAGES * WALK_BYTES;
  static constexpr uint32_t AUX_OFF = XCH_OFF + F::XCH * XCH_BYTES;
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

// What a warpgroup does with a walked tile: 64 owned rows from o0 (keys in
// the dK/dV kernel, queries in the dQ kernel) against the tile's W rows from
// w0, each cut at its sequence's end. SKIP when no pair of them is visible:
// no owned row, every key after every query (causal, top-left), or segment
// ids that share no id (`Span`: the bits catch MixToken's padding id 0 after
// a row's last segment, whose [lo, hi] spans every id). MASKED when some pair
// may be hidden: the causal diagonal, segment ids other than one id on both
// sides, and the dQ kernel's ragged last key tile (zero rows of K past the
// end would score 0, not be left out). Rows past the end on the query side
// need no mask: their lse reads +inf, so p = 0.
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
// panels OWN rows apart), B a walked tile (panels W rows apart), both K-major
// over D.
template <int D, int OWN>
__device__ __forceinline__ void issue_rows_t(float (&c)[W / 2], uint32_t a_rows,
                                             uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(c, smem_desc(a_rows + (kk / 4) * OWN * ROW + off, 16, 1024),
                 smem_desc(b_tile + (kk / 4) * W * ROW + off, 16, 1024), kk > 0);
  }
}

// C (64 x N, fp32) += A B, issued: A (64 x W bf16) from registers, B the N
// columns of a walked tile from b_cols as an MN-major operand (16 rows a k16
// step, the 64-column panels LBO apart).
template <int N>
__device__ __forceinline__ void issue_acc(float (&c)[N / 2], const uint32_t (&a)[W / 16][4],
                                          uint32_t b_cols) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs<N>(c, a[kk], smem_desc(b_cols + kk * 16 * ROW, W * ROW, 1024));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The exchange's named barriers, over the two consumer warpgroups.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A thread's m64n64 accumulator into an exchange tile, by its index t in its
// warpgroup; `xch_get(x, j, t)` reads back registers 4j .. 4j + 3.
__device__ __forceinline__ void xch_put(float* x, const float (&v)[W / 2], int t) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
    reinterpret_cast<float4*>(x)[j * 128 + t] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__device__ __forceinline__ float4 xch_get(const float* x, int j, int t) {
  return reinterpret_cast<const float4*>(x)[j * 128 + t];
}

// Register 4j + 2r + e of float4 j.
__device__ __forceinline__ float lane_of(const float4& f, int r, int e) {
  return r ? (e ? f.w : f.z) : (e ? f.y : f.x);
}

// A thread's part of rows row0 and row0 + 8 (those below `rows`) of m64nN
// accumulators: for each pair of columns col0 + 8j + c0 and + 1 below dh (a
// multiple of 8), store(its offset in rows `stride` elements apart, the index
// 4j + 2r of its first register). Called after the walk, so that no address
// of it is live in the loop; a block with two sums stores both in one pass
// (one pass each measured slower).
template <int N, typename Store>
__device__ __forceinline__ void store_rows(int row0, int rows, int64_t stride, int col0, int c0,
                                           int dh, Store store) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + c0;
      if (col >= dh) break;
      store(row * stride + col, 4 * j + 2 * r);
    }
  }
}

// Registers i and i + 1 of an accumulator, in bf16, at p.
template <int N>
__device__ __forceinline__ void put_pair(bf16* p, const float (&acc)[N], int i) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
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

// Barriers, tiles and exchange tiles of one block, at the 1,024-aligned base
// of its shared memory.
template <int D, bool DKV>
struct Ring {
  using L = BwdSmem<D, DKV>;
  uint32_t base;
  unsigned char* aligned;
  __device__ __forceinline__ Ring(unsigned char* smem_raw) {
    const uint32_t raw = smem_addr(smem_raw);
    base = (raw + 1023u) & ~1023u;
    aligned = smem_raw + (base - raw);
  }
  __device__ __forceinline__ uint32_t own(int i) const { return base + i * L::OWN1_OFF; }
  __device__ __forceinline__ uint32_t walk(int i, int s) const {
    return base + (i ? L::WALK1_OFF : L::WALK0_OFF) + s * L::WALK_BYTES;
  }
  __device__ __forceinline__ float* xch(int i) const {
    return reinterpret_cast<float*>(aligned + L::XCH_OFF + i * L::XCH_BYTES);
  }
  __device__ __forceinline__ uint32_t bar_own() const { return base + L::BAR_OFF; }
  __device__ __forceinline__ uint32_t full(int s) const { return bar_own() + 8u * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar_own() + 8u * (1 + L::STAGES + s);
  }
  __device__ __forceinline__ Stage stage(int s) const {
    return Stage(aligned + L::AUX_OFF + s * L::AUX_BYTES);
  }
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
  // a consumer: waits for its t-th stage; returns its index
  __device__ __forceinline__ int await(int t) const {
    const int s = t % L::STAGES;
    bar_wait(full(s), (t / L::STAGES) & 1);
    return s;
  }
};

// P^T = exp2(S^T - lse) in place on S^T's registers (64 keys x W queries from
// m0; register 4j + 2r + e: key key0 + 8r, query column 8j + c0 + e), 0 at
// the pairs a MASKED tile hides; with DS, in the same pass, dS^T = P^T (dP^T -
// di) ds_scale in place on dP^T's registers `dp`.
template <bool DS>
__device__ __forceinline__ void probs_t(float (&s)[W / 2], float (&dp)[W / 2], const Stage& st,
                                        bool masked, bool causal, bool segs, int key0, int m0,
                                        int c0, const int (&my_seg)[2], float ds_scale) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + c0 + e;
      const float l = st.lse[col], d = DS ? st.di[col] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float p = ex2(s[i] - l);
        if (masked) {
          bool keep = !causal || key0 + 8 * r <= m0 + col;
          if (segs) keep = keep && st.seg[col] == my_seg[r];
          if (!keep) p = 0.f;
        }
        if constexpr (DS) dp[i] = p * (dp[i] - d) * ds_scale;
        s[i] = p;
      }
    }
}

// P = exp2(S - lse) in place on S's registers (64 queries x W keys from n0;
// register 4j + 2r + e: query row0 + 8r, key column 8j + c0 + e), 0 at the
// pairs a MASKED tile hides (also the keys past Skv); with DS, in the same
// pass, dS = P (dP - di) ds_scale in place on dP's registers `dp`.
template <bool DS>
__device__ __forceinline__ void probs(float (&s)[W / 2], float (&dp)[W / 2], const Stage& st,
                                      bool masked, bool causal, bool segs, int row0, int n0,
                                      int seq_kv, int c0, const float (&my_lse)[2],
                                      const float (&my_di)[2], const int (&my_seg)[2],
                                      float ds_scale) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = n0 + 8 * j + c0 + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float p = ex2(s[i] - my_lse[r]);
        if (masked) {
          bool keep = key < seq_kv && (!causal || key <= row0 + 8 * r);
          if (segs) keep = keep && st.seg[key - n0] == my_seg[r];
          if (!keep) p = 0.f;
        }
        if constexpr (DS) dp[i] = p * (dp[i] - my_di[r]) * ds_scale;
        s[i] = p;
      }
    }
}

// The dK/dV kernel. One block: keys n0 .. n0 + OWN - 1 of kv head hk, batch
// b; walks (query tile, query head of the group) and sums dK and dV over both
// in registers.
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
  using F = Form<D, true>;
  using L = BwdSmem<D, true>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const Ring<D, true> ring(smem_raw);
  const int n0 = blockIdx.x * F::OWN, hk = blockIdx.y, b = blockIdx.z;
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
        tma_load(ring.own(0) + p * F::OWN * ROW, &tk, ring.bar_own(), 64 * p, hk, n0, b);
        tma_load(ring.own(1) + p * F::OWN * ROW, &tv, ring.bar_own(), 64 * p, hk, n0, b);
      }
    }
    const int* qseg_b = segs ? qseg + int64_t(b) * qseg_sb : nullptr;
    Span own0{0, 0, 1u}, own1{0, 0, 1u};
    if (segs) {
      own0 = warp_span(kseg + int64_t(b) * kseg_sb, n0, seq_kv, lane);
      if (!F::SPLIT) own1 = warp_span(kseg + int64_t(b) * kseg_sb, n0 + 64, seq_kv, lane);
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
        // split: both warpgroups work on the same 64 keys
        f1 = F::SPLIT ? f0 : judge(true, n0 + 64, seq_kv, w0, seq_q, causal, segs, own1, walk);
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

  // ---- consumer warpgroups: keys n0 + 64 wg .. + 63 each, or (split) n0 .. n0 + 63 both
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid / 32, lane = threadIdx.x & 31;
  const int rows0 = F::SPLIT ? 0 : wg * 64;  // the warpgroup's first owned row
  // accumulator register 4j + 2r + e holds key key0 + 8r and column 8j + c0 + e
  const int key0 = n0 + rows0 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  int my_seg[2] = {0, 0};
  if (segs)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key0 + 8 * r < seq_kv) my_seg[r] = kseg[int64_t(b) * kseg_sb + key0 + 8 * r];
  const uint32_t k_wg = ring.own(0) + rows0 * ROW, v_wg = ring.own(1) + rows0 * ROW;
  // dK, dV in bf16 into (B, Skv, Hkv, dh), written once: key k of this block's
  // batch and kv head at out(t) + k * hkv * dh
  const int hkv = gridDim.y;
  const auto out = [&](bf16* t) { return t + (int64_t(b) * seq_kv * hkv + hk) * dh; };
  bar_wait(ring.bar_own(), 0);

  if constexpr (!F::SPLIT) {
    float acc_dk[D / 2], acc_dv[D / 2], acc_s[W / 2], acc_dp[W / 2];
    uint32_t pa[W / 16][4], da[W / 16][4];
    zero(acc_dk);
    zero(acc_dv);
    for (int t = 0;; ++t) {
      const int s = ring.await(t);
      const Stage st = ring.stage(s);
      if (st.hdr[0] == END) break;
      const int what = st.hdr[2 + wg];
      if (what == SKIP) {
        bar_arrive(ring.empty(s));
        continue;
      }
      // S^T = K qs^T and dP^T = V dO^T for the warpgroup's 64 keys x W queries
      // (zeroed first: the products overwrite them, and the last tile's values
      // need no registers meanwhile)
      zero(acc_s);
      zero(acc_dp);
      wgmma_fence();
      issue_rows_t<D, F::OWN>(acc_s, k_wg, ring.walk(0, s));
      issue_rows_t<D, F::OWN>(acc_dp, v_wg, ring.walk(1, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_s);
      pin(acc_dp);
      // P^T and dS^T = P^T (dP^T - di) / log2(e), in fp32
      probs_t<true>(acc_s, acc_dp, st, what == MASKED, causal, segs, key0, st.hdr[1], c0,
                    my_seg, ds_scale);
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
    bf16 *k_out = out(dk), *v_out = out(dv);
    store_rows<D>(key0, seq_kv, int64_t(hkv) * dh, 0, c0, dh, [&](int64_t at, int i) {
      put_pair(k_out + at, acc_dk, i);
      put_pair(v_out + at, acc_dv, i);
    });
  } else if (wg == 0) {
    // ---- split, warpgroup 0: S^T, P^T into the exchange tile, dV += bf16(P^T) dO
    float acc_dv[D / 2], acc_s[W / 2];
    uint32_t pa[W / 16][4];
    zero(acc_dv);
    float* xch = ring.xch(0);
    int sent = 0;
    for (int t = 0;; ++t) {
      const int s = ring.await(t);
      const Stage st = ring.stage(s);
      if (st.hdr[0] == END) break;
      const int what = st.hdr[2];
      if (what == SKIP) {
        bar_arrive(ring.empty(s));
        continue;
      }
      zero(acc_s);
      wgmma_fence();
      issue_rows_t<D, F::OWN>(acc_s, k_wg, ring.walk(0, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_s);
      probs_t<false>(acc_s, acc_s, st, what == MASKED, causal, segs, key0, st.hdr[1], c0,
                     my_seg, ds_scale);
      if (sent++) named_sync(XCH_FREE0);  // warpgroup 1 has read the last tile's P^T
      xch_put(xch, acc_s, tid);
      named_arrive(XCH_FULL);
      pack_a<W>(pa, acc_s);
      pin(acc_dv);
      pin(pa);
      wgmma_fence();
      issue_acc<D>(acc_dv, pa, ring.walk(1, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_dv);
      bar_arrive(ring.empty(s));
    }
    if (sent) named_sync(XCH_FREE0);  // the last tile's
    bf16* v_out = out(dv);
    store_rows<D>(key0, seq_kv, int64_t(hkv) * dh, 0, c0, dh,
                  [&](int64_t at, int i) { put_pair(v_out + at, acc_dv, i); });
  } else {
    // ---- split, warpgroup 1: dP^T, dS^T from warpgroup 0's P^T, dK += bf16(dS^T) qs
    float acc_dk[D / 2], acc_dp[W / 2];
    uint32_t da[W / 16][4];
    zero(acc_dk);
    const float* xch = ring.xch(0);
    for (int t = 0;; ++t) {
      const int s = ring.await(t);
      const Stage st = ring.stage(s);
      if (st.hdr[0] == END) break;
      if (st.hdr[3] == SKIP) {
        bar_arrive(ring.empty(s));
        continue;
      }
      zero(acc_dp);
      wgmma_fence();
      issue_rows_t<D, F::OWN>(acc_dp, v_wg, ring.walk(1, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_dp);
      named_sync(XCH_FULL);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float4 p = xch_get(xch, j, tid);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = st.di[8 * j + c0 + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            acc_dp[i] = lane_of(p, r, e) * (acc_dp[i] - d) * ds_scale;
          }
        }
      }
      named_arrive(XCH_FREE0);
      pack_a<W>(da, acc_dp);
      pin(acc_dk);
      pin(da);
      wgmma_fence();
      issue_acc<D>(acc_dk, da, ring.walk(0, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_dk);
      bar_arrive(ring.empty(s));
    }
    bf16* k_out = out(dk);
    store_rows<D>(key0, seq_kv, int64_t(hkv) * dh, 0, c0, dh,
                  [&](int64_t at, int i) { put_pair(k_out + at, acc_dk, i); });
  }
}

// The dQ kernel. One block: queries m0 .. m0 + OWN - 1 of query head h,
// batch b; walks the key tiles of kv head h / group and sums dQ over them in
// registers.
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
  using F = Form<D, false>;
  using L = BwdSmem<D, false>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const Ring<D, false> ring(smem_raw);
  // causal: the blocks with the longest key walks are launched first
  const int mb = causal ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x);
  const int m0 = mb * F::OWN, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
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
        tma_load(ring.own(0) + p * F::OWN * ROW, &tq, ring.bar_own(), 64 * p, h, m0, b);
        tma_load(ring.own(1) + p * F::OWN * ROW, &tdo, ring.bar_own(), 64 * p, h, m0, b);
      }
    }
    const int* kseg_b = segs ? kseg + int64_t(b) * kseg_sb : nullptr;
    Span own0{0, 0, 1u}, own1{0, 0, 1u};
    if (segs) {
      own0 = warp_span(qseg + int64_t(b) * qseg_sb, m0, seq_q, lane);
      if (!F::SPLIT) own1 = warp_span(qseg + int64_t(b) * qseg_sb, m0 + 64, seq_q, lane);
    }
    // causal: the block's last query is m0 + OWN - 1, so later key tiles are all masked
    const int n_end = causal ? min(seq_kv, m0 + F::OWN) : seq_kv;
    const int n_tiles = (n_end + W - 1) / W;
    int t = 0;
    for (int c = 0; c < n_tiles; c += CHUNK) {
      const int w0 = (c + lane) * W;
      int f0 = SKIP, f1 = SKIP;
      if (c + lane < n_tiles) {
        const Span walk = segs ? lane_span(kseg_b, w0, seq_kv) : Span{0, 0, 1u};
        f0 = judge(false, m0, seq_q, w0, seq_kv, causal, segs, own0, walk);
        f1 = F::SPLIT ? f0 : judge(false, m0 + 64, seq_q, w0, seq_kv, causal, segs, own1, walk);
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

  // ---- consumer warpgroups: queries m0 + 64 wg .. + 63 each, or (split) m0 .. m0 + 63 both
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid / 32, lane = threadIdx.x & 31;
  const int rows0 = F::SPLIT ? 0 : wg * 64;
  // accumulator register 4j + 2r + e holds query row0 + 8r and column 8j + c0 + e
  const int row0 = m0 + rows0 + warp * 16 + (lane >> 2);
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
  const uint32_t q_wg = ring.own(0) + rows0 * ROW, do_wg = ring.own(1) + rows0 * ROW;
  // dQ in bf16 into (B, Sq, H, dh), written once: query q of this block's
  // batch and head at out() + q * heads * dh
  const auto out = [&] { return dq + (int64_t(b) * seq_q * heads + h) * dh; };
  bar_wait(ring.bar_own(), 0);

  if constexpr (!F::SPLIT) {
    float acc_dq[D / 2], acc_s[W / 2], acc_dp[W / 2];
    uint32_t da[W / 16][4];
    zero(acc_dq);
    for (int t = 0;; ++t) {
      const int s = ring.await(t);
      const Stage st = ring.stage(s);
      if (st.hdr[0] == END) break;
      const int what = st.hdr[2 + wg];
      if (what == SKIP) {
        bar_arrive(ring.empty(s));
        continue;
      }
      // S = qs K^T and dP = dO V^T for the warpgroup's 64 queries x W keys
      zero(acc_s);
      zero(acc_dp);
      wgmma_fence();
      issue_rows_t<D, F::OWN>(acc_s, q_wg, ring.walk(0, s));
      issue_rows_t<D, F::OWN>(acc_dp, do_wg, ring.walk(1, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_s);
      pin(acc_dp);
      // dS = P (dP - di) scale, in fp32
      probs<true>(acc_s, acc_dp, st, what == MASKED, causal, segs, row0, st.hdr[1], seq_kv, c0,
                  my_lse, my_di, my_seg, ds_scale);
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
    bf16* q_out = out();
    store_rows<D>(row0, seq_q, int64_t(heads) * dh, 0, c0, dh,
                  [&](int64_t at, int i) { put_pair(q_out + at, acc_dq, i); });
  } else {
    // ---- split: warpgroup 0 computes S and P, warpgroup 1 dP; they swap them,
    // both form dS, and warpgroup wg sums dQ's columns wg D / 2 .. + D / 2 - 1
    float acc_dq[D / 4], acc_x[W / 2];
    uint32_t da[W / 16][4];
    zero(acc_dq);
    float* mine = ring.xch(wg);
    const float* other = ring.xch(wg ^ 1);
    const uint32_t a_wg = wg ? do_wg : q_wg;
    const uint32_t k_cols = wg * (PANELS / 2) * W * ROW;  // the K tile's panels of the half
    int sent = 0;
    for (int t = 0;; ++t) {
      const int s = ring.await(t);
      const Stage st = ring.stage(s);
      if (st.hdr[0] == END) break;
      const int what = st.hdr[2];
      if (what == SKIP) {
        bar_arrive(ring.empty(s));
        continue;
      }
      zero(acc_x);
      wgmma_fence();
      issue_rows_t<D, F::OWN>(acc_x, a_wg, ring.walk(wg, s));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_x);
      if (wg == 0)
        probs<false>(acc_x, acc_x, st, what == MASKED, causal, segs, row0, st.hdr[1], seq_kv, c0,
                     my_lse, my_di, my_seg, ds_scale);
      if (sent++) named_sync(wg ? XCH_FREE1 : XCH_FREE0);  // the other has read my last
      xch_put(mine, acc_x, tid);
      named_sync(XCH_FULL);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float4 y = xch_get(other, j, tid);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            const float p = wg ? lane_of(y, r, e) : acc_x[i];
            const float dp = wg ? acc_x[i] : lane_of(y, r, e);
            acc_x[i] = p * (dp - my_di[r]) * ds_scale;
          }
      }
      named_arrive(wg ? XCH_FREE0 : XCH_FREE1);
      pack_a<W>(da, acc_x);
      pin(acc_dq);
      pin(da);
      wgmma_fence();
      issue_acc<D / 2>(acc_dq, da, ring.walk(0, s) + k_cols);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_dq);
      bar_arrive(ring.empty(s));
    }
    if (sent) named_sync(wg ? XCH_FREE1 : XCH_FREE0);  // the last tile's
    bf16* q_out = out();
    store_rows<D / 2>(row0, seq_q, int64_t(heads) * dh, wg * (D / 2), c0, dh,
                      [&](int64_t at, int i) { put_pair(q_out + at, acc_dq, i); });
  }
}

}  // namespace wg

struct Args {
  const bf16 *q, *k, *v, *dout;  // (B, S, H, dh) through strides; q pre-scaled
  const float *lse, *di;         // (B, H, Sq) fp32, contiguous
  const int *qseg, *kseg;        // (B, S) int32 or null
  bf16 *out0, *out1;             // dK, dV or dQ: bf16, (B, S, H, dh) contiguous
  int seq_q, seq_kv, group, causal, qseg_sb, kseg_sb;
  int dh;  // the operands' head width (<= D): the kernels read zeros past it, write dh
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  float ds_scale;  // 1/log2(e) for dK, the softmax scale for dQ
};

template <int D, bool DKV>
constexpr uint32_t smem_bytes() {
  return wg::BwdSmem<D, DKV>::TOTAL;
}

template <int D>
int launch_wgmma(bool dkv, const Args& a, int batch, int heads, cudaStream_t stream) {
  static_assert(smem_bytes<D, true>() <= 232448 && smem_bytes<D, false>() <= 232448,
                "shared memory above the 227 KB a block can opt into");
  const int hkv = heads / a.group;
  const int own = dkv ? wg::Form<D, true>::OWN : wg::Form<D, false>::OWN;
  // boxes: the owned operands' rows, the walked ones' 64
  const int q_rows = dkv ? wg::W : own, kv_rows = dkv ? own : wg::W;
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
    constexpr uint32_t smem = smem_bytes<D, true>();
    err = cudaFuncSetAttribute(wg::flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.seq_kv + own - 1) / own, hkv, batch);
    wg::flash_bwd_dkv_wgmma_kernel<D><<<grid, wg::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.di, a.qseg, a.kseg, a.out0, a.out1, heads, a.seq_q, a.seq_kv,
        a.group, a.causal, a.qseg_sb, a.kseg_sb, a.ds_scale, a.dh);
  } else {
    constexpr uint32_t smem = smem_bytes<D, false>();
    err = cudaFuncSetAttribute(wg::flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    dim3 grid((a.seq_q + own - 1) / own, heads, batch);
    wg::flash_bwd_dq_wgmma_kernel<D><<<grid, wg::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.di, a.qseg, a.kseg, a.out0, a.seq_q, a.seq_kv, a.group,
        a.causal, a.qseg_sb, a.kseg_sb, a.ds_scale, a.dh);
  }
  return int(cudaGetLastError());
}

bool head_ok(int dh) { return dh >= 8 && dh <= 256 && dh % 8 == 0; }

int dispatch(bool dkv, const Args& a, int batch, int heads, cudaStream_t s) {
  if (a.group < 1 || heads % a.group != 0 || (a.qseg == nullptr) != (a.kseg == nullptr) ||
      (a.causal && a.seq_q != a.seq_kv) || !head_ok(a.dh))
    return int(cudaErrorInvalidValue);
  switch (compiled_width(a.dh)) {  // the fixed table
    case 64: return launch_wgmma<64>(dkv, a, batch, heads, s);
    case 128: return launch_wgmma<128>(dkv, a, batch, heads, s);
    case 192: return launch_wgmma<192>(dkv, a, batch, heads, s);
    default: return launch_wgmma<256>(dkv, a, batch, heads, s);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int* qseg, const int* kseg, void* out0, void* out1,
               int seq_q, int seq_kv, int group, int causal, int qseg_sb, int kseg_sb,
               int dh, const int* st, float ds_scale) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di, qseg, kseg,
              static_cast<bf16*>(out0), static_cast<bf16*>(out1), seq_q, seq_kv, group, causal,
              qseg_sb, kseg_sb, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
              st[8], st[9], st[10], st[11], ds_scale};
}

}  // namespace

// qs (pre-scaled by scale*log2(e)), dout: (B, Sq, H, dh); k, v: (B, Skv, H /
// group, dh); bf16 with unit stride over dh (a multiple of 8, at most 256,
// served at its compiled width, the columns past dh read as zeros) and the
// given batch/seq/head strides (elements, each a multiple of 8, rows 16-byte
// aligned; the four tensors' strides in st[12]). lse, di: (B, H, Sq) fp32
// contiguous. qseg/kseg: (B, S) int32 with unit stride over S, or both null.
// dk, dv: bf16 (B, Skv, H / group, dh) contiguous, the GQA groups summed.
// Returns the cudaError_t of the launch, or 10000 + the CUresult of a tensor
// map that libcuda refused.
extern "C" int flash_bwd_dkv_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* di, const int* qseg,
                                  const int* kseg, void* dk, void* dv, int batch, int heads,
                                  int seq_q, int seq_kv, int dh, int group, int causal,
                                  int qseg_sb, int kseg_sb, const int* st, void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dk, dv, seq_q, seq_kv, group,
                           causal, qseg_sb, kseg_sb, dh, st, 1.f / LOG2E);
  return dispatch(true, a, batch, heads, static_cast<cudaStream_t>(stream));
}

// The same operands; dq, the gradient of the unscaled q (ds carries `scale`):
// bf16 (B, Sq, H, dh) contiguous.
extern "C" int flash_bwd_dq_bf16(const void* qs, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* di, const int* qseg,
                                 const int* kseg, void* dq, int batch, int heads, int seq_q,
                                 int seq_kv, int dh, int group, int causal, int qseg_sb,
                                 int kseg_sb, const int* st, float scale, void* stream) {
  const Args a = make_args(qs, k, v, dout, lse, di, qseg, kseg, dq, nullptr, seq_q, seq_kv,
                           group, causal, qseg_sb, kseg_sb, dh, st, scale);
  return dispatch(false, a, batch, heads, static_cast<cudaStream_t>(stream));
}

// The blocks the table serves a head of dh columns with, as plan[0..9] =
// {compiled D, walked rows, then for the dK/dV kernel and the dQ kernel each
// {rows a block owns, ring stages, 1 if its warpgroups split the outputs,
// dynamic shared memory a block}}; returns 1, or 0 (plan untouched) for a
// width the kernels do not read in place (not a multiple of 8, or above 256).
extern "C" int flash_bwd_core(int dh, int* plan) {
  if (!head_ok(dh)) return 0;
  const int width = compiled_width(dh);
  plan[0] = width;
  plan[1] = wg::W;
  switch (width) {
#define PLAN(D)                                                    \
  plan[2] = wg::Form<D, true>::OWN;                                \
  plan[3] = wg::Form<D, true>::STAGES;                             \
  plan[4] = wg::Form<D, true>::SPLIT;                              \
  plan[5] = int(smem_bytes<D, true>());                            \
  plan[6] = wg::Form<D, false>::OWN;                               \
  plan[7] = wg::Form<D, false>::STAGES;                            \
  plan[8] = wg::Form<D, false>::SPLIT;                             \
  plan[9] = int(smem_bytes<D, false>());                           \
  break;
    case 64: PLAN(64)
    case 128: PLAN(128)
    case 192: PLAN(192)
    default: PLAN(256)
#undef PLAN
  }
  return 1;
}
