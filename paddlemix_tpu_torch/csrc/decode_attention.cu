// Single-query decode attention over a bf16 KV cache (B7) or an int8 KV cache
// with per-(token, head) fp32 scales (B8):
//   out[b, 0, h*G + g, :] = softmax_t(scale * q[b, 0, h*G + g, :] . k[b, t, h, :]) v[b, t, h, :]
// over the keys t < min(lengths[b], L), where an int8 row reads as
// k_q[b, t, h, :] * k_scale[b, t, h] (v likewise); q and out (B, 1, Hq, D)
// bf16 contiguous, k and v (B, L, KVH, D) with unit stride over D and any
// other strides (a slice of the layer-major cache), the scales (B, L, KVH)
// with any strides, lengths (B,) int32 on the device, G = Hq / KVH query heads
// per kv head (GQA: 1, 2, 4 or 8, and for the bf16 cache also 7, Qwen2-7B's 28
// heads on 4), D = 64 or 128, and for the bf16 cache also 80 (OPT-2.7B's
// 2,560 / 32 heads, BLIP-2's language model).
//
// Replaces the Pallas kernels decode_attention / _decode_kernel (B7) and
// decode_attention_int8 / _decode_kernel_int8 (B8), both in
// paddlemix_tpu/ops/decode_attention.py. It computes what they do: an online
// softmax over blocks of keys (fp32 logits from q * scale, keys at or past the
// length masked to NEG = -0.7 * FLT_MAX, blocks wholly past the length
// skipped) and out = acc / l with l == 0 read as 1 (a length of 0 gives
// zeros). B7 rounds P to bf16 before the PV product with fp32 sums; B8
// dequantizes each row in registers (int8 * its scale, in fp32) and keeps P
// and V in fp32, as its TPU kernel does. The TPU kernels carried m, l and acc
// across a sequential grid axis over key blocks; here a block owns one (batch,
// kv head, range of keys) and loops over its keys itself, and the ranges are
// merged by a second kernel.
//
// Bound: the bytes of K and V up to the length, with B8's scales (decode
// reads each cached row once; the arithmetic is ~4 * G flops per bf16 byte).
// At the serving shapes the bytes are few (34.6 MB for B8 at 4,095 keys of
// Llama-2-7B, 10 us at 3.35 TB/s), so what the kernel must do is keep enough
// loads in flight from its first instruction to its last and end every block
// at the same time.
//
// Design. The keys are split into S contiguous ranges, one block of two warps
// each (grid (KVH, B, S); ops/decode_attention.py `key_splits` picks S so
// that the blocks fill whole waves of 4 blocks, 8 warps, an SM, the best
// point of tools/probe_torch_int8_attn_parts.py's sweep on an H100; at 32
// heads that is 33 ranges, 8 blocks on every SM, all resident at once). The two warps take turns over the block's range in steps of STEP
// rows, with no block-wide barrier until the end. A key row is LPR = D / VPL
// consecutive lanes (VPL values each: 8 bf16 or 16 int8, 16 bytes; 8 int8,
// 8 bytes, at G >= 4; D 80 below), so a warp holds RPW = 32 / LPR row slots, and
// each slot walks its own rows with its own online softmax state (m, l and
// acc over its VPL columns, per query head) in registers. Each warp keeps a
// ring of NST steps in shared memory (2 KB of K and V a step, and B8's
// scales), filled by cp.async NST - 1 steps ahead: a lane copies its own
// 16 (or 8) bytes of each of its rows and later reads only those, so the
// ring needs no block barrier, only cp.async.wait_group (and a __syncwarp
// for B8's scales, which a slot's first lane copies); rows past the length
// are zero-filled. A row of D = 80 is ten 16-byte chunks, no power of two:
// it takes 16 lanes (a power of two, so that its lanes reduce by xor shuffles
// and the slots merge as at 64 and 128), of which the first ten read the row
// and the last six hold zeros (their q and their ring slots zero-filled, no
// load issued), two rows a warp step; the cache is read in place at its
// 160-byte rows, not padded. At the end the slots are merged by shuffles and
// the two warps through shared memory, once: each block writes its unnormalised (m,
// l, acc) to a scratch buffer, and a second kernel merges the S partials of
// each query head, acc and l rescaled by exp(m_s - max m), in one pass (each
// thread's share of the splits online, then the shares). It is launched as a
// programmatic dependent of the first (PDL), so its launch overlaps the first
// kernel's run. With S = 1 the first kernel writes the output itself. B8's int8 rows widen to fp32 by a byte permute into a float's
// mantissa (exact, no conversion instruction) and take their scale in fp32
// on the dot product (k) and on p (v): (q . k8) * ks and (p * vs) * v8. Keys
// at or past the length are left out of the walk, which is what NEG's
// weight, exp(NEG - m) = 0, gives them whenever the range has a key; a range
// without one keeps m = -inf, l = 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 2;               // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr float NEG = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 bf16 of a 16-byte word group to fp32 (exact)
__device__ __forceinline__ void unpack_bf16(const uint32_t* w, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 int8 of a word to fp32 (exact): byte + 128 goes into the low mantissa
// bits of 2^23, and 2^23 + 128 comes off
__device__ __forceinline__ void unpack_s8x4(uint32_t w, float* v) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + j)) - 8388736.f;
}

__device__ __forceinline__ void words(const uint4& u, uint32_t (&w)[4]) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}

__device__ __forceinline__ void words(const uint2& u, uint32_t (&w)[2]) {
  w[0] = u.x;
  w[1] = u.y;
}

// A lane's VPL values of a row of T, as one 16- or 8-byte load.
template <typename T, int VPL>
struct Lane {
  static constexpr int BYTES = VPL * int(sizeof(T));
  static constexpr int WORDS = BYTES / 4;
  using Vec = typename std::conditional<BYTES == 16, uint4, uint2>::type;
  static_assert(BYTES == 16 || BYTES == 8, "a lane loads 8 or 16 bytes");
  __device__ __forceinline__ static void unpack(const Vec& u, float (&v)[VPL]) {
    uint32_t w[WORDS];
    words(u, w);
    if constexpr (sizeof(T) == 2) {
      unpack_bf16(w, v);
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) unpack_s8x4(w[i], v + 4 * i);
    }
  }
};

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <int D, int G, typename T>
struct Shape {
  static constexpr bool INT8 = sizeof(T) == 1;
  static constexpr int VPL = INT8 && G <= 2 ? 16 : 8;  // values of a row a lane
  static constexpr int LB = VPL * int(sizeof(T));      // their bytes: one 16- or 8-byte copy
  static constexpr int LIVE = D / VPL;                 // lanes that read a row
  static constexpr int LPR = pow2_ceil(LIVE);          // lanes a row (D 80: 10 of 16 live)
  static_assert(D % VPL == 0 && LPR <= 32, "a row is whole chunks of at most one warp");
  static constexpr int RPW = 32 / LPR;                 // row slots a warp
  static constexpr int U = 1024 / (32 * LB);           // rows a slot a step: 2 KB of K and V
  static constexpr int STEP = RPW * U;                 // rows a warp a step
  static constexpr int NST = G >= 4 ? 3 : 4;           // stages of a warp's ring
  static constexpr int KV_BYTES = 2 * U * 32 * LB;     // a stage: K and V, lane by lane,
  static constexpr int STAGE_BYTES = KV_BYTES + (INT8 ? 2 * U * RPW * 4 : 0);  // + B8's scales
  // resident blocks an SM: 8 leaves 128 registers a thread, which G 4's q,
  // acc, m and l fit (116); G 7 and 8 hold nearly twice as many and take 4
  static constexpr int MIN_BLOCKS = G >= 7 ? 4 : 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from global `src` to shared `dst`, asynchronously; zeros when !ok
// (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies of all but the last N committed groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// partial: per (query head, split) D + 2 floats, [m, l, acc[0..D)]. T is the
// cache element type; ks / vs (the int8 rows' scales) are read for int8 only.
template <int D, int G, typename T>
__global__ void __launch_bounds__(THREADS, Shape<D, G, T>::MIN_BLOCKS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int L,
                        int kvh, int chunk, long long k_sb, long long k_sl, long long k_sh,
                        long long v_sb, long long v_sl, long long v_sh, long long ks_sb,
                        long long ks_sl, long long ks_sh, long long vs_sb, long long vs_sl,
                        long long vs_sh, float scale) {
  using Sh = Shape<D, G, T>;
  constexpr int VPL = Sh::VPL, LB = Sh::LB, LPR = Sh::LPR, RPW = Sh::RPW, U = Sh::U;
  constexpr int LIVE = Sh::LIVE;
  constexpr int STEP = Sh::STEP, NST = Sh::NST;
  constexpr bool INT8 = Sh::INT8;
  using Ln = Lane<T, VPL>;
  using Vec = typename Ln::Vec;
  // each warp's ring of NST steps: in a stage, row u of a slot's K at 16-byte
  // (or 8-byte) chunk 2u * 32 + lane, its V at (2u + 1) * 32 + lane (every
  // lane reads only what it copied itself), and for int8 the rows' two scales
  // after them at 2u * RPW + slot and (2u + 1) * RPW + slot (copied by the
  // slot's first lane, read by all of its lanes after a __syncwarp)
  __shared__ __align__(16) unsigned char ring[WARPS][NST][Sh::STAGE_BYTES];
  __shared__ float red[WARPS][G][D + 2];  // each warp's merged (m, l, acc)

  // the merge may be launched now: it waits for this grid before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPR, slot = lane / LPR;
  const bool live = LIVE == LPR || c < LIVE;  // this lane's chunk lies in the row
  // this block's keys: [t_begin, n), n = min(length, L, the split's end)
  const int t_begin = split * chunk;
  const int n = max(t_begin, min(min(lengths[b], L), t_begin + chunk));
  const int hq = kvh * G;

  const T* kb = k + b * k_sb + h * k_sh + c * VPL;
  const T* vb = v + b * v_sb + h * v_sh + c * VPL;
  const float* ksb = INT8 ? ks + b * ks_sb + h * ks_sh : nullptr;
  const float* vsb = INT8 ? vs + b * vs_sb + h * vs_sh : nullptr;

  // the warp walks steps i = 0, 1, ... at rows t0(i) = t_begin + (warp + WARPS
  // i) STEP; step i's copies are one commit group, in stage i % NST
  const int first = t_begin + warp * STEP;
  const int steps = first < n ? (n - first + WARPS * STEP - 1) / (WARPS * STEP) : 0;
  const uint32_t ring_base = smem_addr(&ring[warp][0][0]);
  const auto issue = [&](int i) {
    if (i < steps) {
      const int t0 = first + i * WARPS * STEP;
      const uint32_t st = ring_base + (i % NST) * Sh::STAGE_BYTES;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + slot + RPW * u;
        const bool ok = t < n, rd = ok && live;  // else zeros, and no read
        cp_async<LB>(st + ((2 * u) * 32 + lane) * LB, rd ? kb + t * k_sl : k, rd);
        cp_async<LB>(st + ((2 * u + 1) * 32 + lane) * LB, rd ? vb + t * v_sl : v, rd);
        if (INT8 && c == 0) {  // the slot's first lane copies the row's scales
          cp_async<4>(st + Sh::KV_BYTES + ((2 * u) * RPW + slot) * 4, ok ? ksb + t * ks_sl : ksb,
                      ok);
          cp_async<4>(st + Sh::KV_BYTES + ((2 * u + 1) * RPW + slot) * 4,
                      ok ? vsb + t * vs_sl : vsb, ok);
        }
      }
    }
    cp_async_commit();  // empty past the last step: the group count stays uniform
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);

  float qf[G][VPL], acc[G][VPL], m_i[G], l_i[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qg = q + ((size_t)b * hq + h * G + g) * D + c * VPL;
#pragma unroll
    for (int j = 0; j < VPL / 8; ++j) {
      const uint4 u = live ? __ldg(reinterpret_cast<const uint4*>(qg + 8 * j))
                           : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      unpack_bf16(w, qf[g] + 8 * j);
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      qf[g][i] *= scale;
      acc[g][i] = 0.f;
    }
    m_i[g] = -INFINITY;
    l_i[g] = 0.f;
  }

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<NST - 2>();  // step i has landed
    if constexpr (INT8) __syncwarp();  // and its scales, copied by each slot's first lane
    issue(i + NST - 1);        // into the stage step i - 1 read
    const int t0 = first + i * WARPS * STEP;
    const unsigned char* st = ring[warp][i % NST];
    const float* sc = reinterpret_cast<const float*>(st + Sh::KV_BYTES);

    // logits of the slot's U rows: each row's LPR lanes reduce their parts
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VPL];
      Ln::unpack(*reinterpret_cast<const Vec*>(st + ((2 * u) * 32 + lane) * LB), kf);
      const bool ok = t0 + slot + RPW * u < n;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) part = fmaf(qf[g][j], kf[j], part);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (INT8) part *= sc[(2 * u) * RPW + slot];  // the row's scale, in fp32
        s[u][g] = ok ? part : -INFINITY;
      }
    }
    // the slot's online softmax; p meets V in bf16 for B7 and in fp32 for B8
    float pv[U][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m_i[g], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i[g] - base);
      m_i[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u][g] - base);  // 0 for rows past n
        sum += p;
        if constexpr (INT8) pv[u][g] = p * sc[(2 * u + 1) * RPW + slot];
        else pv[u][g] = round_bf16(p);
      }
      l_i[g] = l_i[g] * alpha + sum;
#pragma unroll
      for (int j = 0; j < VPL; ++j) acc[g][j] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VPL];
      Ln::unpack(*reinterpret_cast<const Vec*>(st + ((2 * u + 1) * 32 + lane) * LB), vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < VPL; ++j) acc[g][j] = fmaf(pv[u][g], vf[j], acc[g][j]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // merge the warp's slots (lanes LPR, 2 LPR, ... apart), then the warps
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_i[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_i[g], off);
      const float m_new = fmaxf(m_i[g], m_o);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float w_s = expf(m_i[g] - base), w_o = expf(m_o - base);
      l_i[g] = l_i[g] * w_s + l_o * w_o;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        acc[g][j] = acc[g][j] * w_s + __shfl_xor_sync(0xffffffffu, acc[g][j], off) * w_o;
      m_i[g] = m_new;
    }
  }
  if (slot == 0 && live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) red[warp][g][2 + c * VPL + j] = acc[g][j];
      if (c == 0) {
        red[warp][g][0] = m_i[g];
        red[warp][g][1] = l_i[g];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, col = idx % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w][g][0]);
    const float base = m == -INFINITY ? 0.f : m;
    float l = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(red[w][g][0] - base);  // 0 for a warp without keys
      l += wt * red[w][g][1];
      sum += wt * red[w][g][2 + col];
    }
    const size_t head = (size_t)b * hq + h * G + g;
    if (splits == 1) {
      out[head * D + col] = __float2bfloat16(sum / (l == 0.f ? 1.f : l));
    } else {
      float* p = partial + (head * splits + split) * (D + 2);
      p[2 + col] = sum;
      if (col == 0) {
        p[0] = m;
        p[1] = l;
      }
    }
  }
}

// One block of P D threads (P = MERGE_THREADS / D) per (query head, batch): out = sum_s w_s acc_s /
// sum_s w_s l_s with w_s = exp(m_s - max m), 0 where no split saw a key.
// Thread (part, column) merges the splits part, part + P, ... of its column
// online, so that every load of the block goes out at once; the P parts are
// then merged in shared memory. Launched as a programmatic dependent of the
// first kernel: it waits for that grid's completion before reading.
constexpr int MERGE_THREADS = 1024;

template <int D>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_attention_merge(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                       int hq, int splits) {
  constexpr int P = MERGE_THREADS / D;
  __shared__ float red[3][P][D];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t head = (size_t)blockIdx.y * hq + blockIdx.x;
  const float* p = partial + head * splits * (D + 2);
  const int col = threadIdx.x % D, part = threadIdx.x / D;
  float m = -INFINITY, l = 0.f, sum = 0.f;
#pragma unroll 8
  for (int s = part; s < splits; s += P) {
    const float* ps = p + s * (D + 2);
    const float m_s = ps[0], l_s = ps[1], a_s = ps[2 + col];
    const float m_new = fmaxf(m, m_s);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float w_o = expf(m - base), w_s = expf(m_s - base);  // 0 for a split without keys
    l = l * w_o + l_s * w_s;
    sum = sum * w_o + a_s * w_s;
    m = m_new;
  }
  red[0][part][col] = m;
  red[1][part][col] = l;
  red[2][part][col] = sum;
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int q = 1; q < P; ++q) m = fmaxf(m, red[0][q][col]);
  const float base = m == -INFINITY ? 0.f : m;
  l = sum = 0.f;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float w = expf(red[0][q][col] - base);
    l += w * red[1][q][col];
    sum += w * red[2][q][col];
  }
  out[head * D + col] = __float2bfloat16(sum / (l == 0.f ? 1.f : l));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void* out;
  float* partial;
  int B, L, kvh, splits, chunk;
  long long k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, ks_sb, ks_sl, ks_sh, vs_sb, vs_sl, vs_sh;
  float scale;
};

// The largest shared-memory carveout, asked once an instantiation, so that
// Shape::MIN_BLOCKS blocks of it fit an SM; returns how many do, or minus
// the cudaError_t of a call that failed.
template <int D, int G, typename T>
int prepare() {
  static const int resident = [] {
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<D, G, T>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_attention_kernel<D, G, T>,
                                                          THREADS, 0);
    return err == cudaSuccess ? n : -int(err);
  }();
  return resident;
}

template <int D, int G, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int resident = prepare<D, G, T>();
  if (resident < 0) return cudaError_t(-resident);
  decode_attention_kernel<D, G, T><<<dim3(a.kvh, a.B, a.splits), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.partial, a.L, a.kvh, a.chunk, a.k_sb, a.k_sl,
      a.k_sh, a.v_sb, a.v_sl, a.v_sh, a.ks_sb, a.ks_sl, a.ks_sh, a.vs_sb, a.vs_sl, a.vs_sh,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.kvh * G, a.B);
  cfg.blockDim = dim3(MERGE_THREADS / D * D);  // whole parts of D columns (D 80: 960)
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attention_merge<D>, static_cast<const float*>(a.partial),
                            static_cast<__nv_bfloat16*>(a.out), a.kvh * G, a.splits);
}

template <int D, typename T>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<D, 1, T>(a, stream);
    case 2: return launch<D, 2, T>(a, stream);
    case 4: return launch<D, 4, T>(a, stream);
    case 8: return launch<D, 8, T>(a, stream);
    case 7:  // the bf16 cache alone (B7: Qwen2-VL-7B's GQA); B8 stays at 1, 2, 4, 8
      if constexpr (sizeof(T) == 2) return launch<D, 7, T>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int D, int G, const Args& a, cudaStream_t stream) {
  if (a.B == 0 || a.kvh == 0) return cudaSuccess;
  if (a.splits < 1 || (long long)a.splits * a.chunk < a.L || a.splits > 12288 ||
      (a.splits > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  if (D == 64) return dispatch_g<64, T>(G, a, stream);
  if (D == 128) return dispatch_g<128, T>(G, a, stream);
  if constexpr (sizeof(T) == 2)  // the bf16 cache alone (B7); B8 stays at 64 and 128
    if (D == 80) return dispatch_g<80, T>(G, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success); strides in elements.
// `partial` holds B * KVH * G * splits * (D + 2) floats when splits > 1; the
// keys are cut into `splits` ranges of `chunk` (splits * chunk >= L).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* partial, int B,
                                     int L, int kvh, int G, int D, int splits, int chunk,
                                     long long k_sb, long long k_sl, long long k_sh,
                                     long long v_sb, long long v_sl, long long v_sh,
                                     float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, lengths, out, static_cast<float*>(partial), B, L,
               kvh, splits, chunk, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, 0, 0, 0, 0, 0, 0, scale};
  return dispatch<__nv_bfloat16>(D, G, a, static_cast<cudaStream_t>(stream));
}

// The int8 cache (B8): k and v int8, k_scale and v_scale (B, L, KVH) fp32;
// strides in elements, the rest as decode_attention_bf16.
extern "C" int decode_attention_int8(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* lengths, void* out, void* partial, int B,
                                     int L, int kvh, int G, int D, int splits, int chunk,
                                     long long k_sb, long long k_sl, long long k_sh,
                                     long long v_sb, long long v_sl, long long v_sh,
                                     long long ks_sb, long long ks_sl, long long ks_sh,
                                     long long vs_sb, long long vs_sl, long long vs_sh,
                                     float scale, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, lengths, out, static_cast<float*>(partial), B, L,
               kvh, splits, chunk, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, ks_sb, ks_sl, ks_sh,
               vs_sb, vs_sl, vs_sh, scale};
  return dispatch<int8_t>(D, G, a, static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel for (D, G, int8 or bf16 cache) that one SM holds at
// once, as the card reports it; below 0 for a shape without a kernel or a
// failed query.
extern "C" int decode_attention_blocks_per_sm(int D, int G, int int8) {
#define DECODE_OCC(d, g) \
  if (D == d && G == g) return int8 ? prepare<d, g, int8_t>() : prepare<d, g, __nv_bfloat16>();
  DECODE_OCC(64, 1) DECODE_OCC(64, 2) DECODE_OCC(64, 4) DECODE_OCC(64, 8)
  DECODE_OCC(128, 1) DECODE_OCC(128, 2) DECODE_OCC(128, 4) DECODE_OCC(128, 8)
#undef DECODE_OCC
#define DECODE_OCC_BF16(d, g) \
  if (D == d && G == g && !int8) return prepare<d, g, __nv_bfloat16>();
  DECODE_OCC_BF16(80, 1) DECODE_OCC_BF16(80, 2) DECODE_OCC_BF16(80, 4) DECODE_OCC_BF16(80, 8)
  DECODE_OCC_BF16(64, 7) DECODE_OCC_BF16(80, 7) DECODE_OCC_BF16(128, 7)
#undef DECODE_OCC_BF16
  return -1;
}
