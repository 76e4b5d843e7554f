// Single-query decode attention over a paged bf16 KV pool (B9):
//   out[b, h*G + g, :] = softmax_t(scale * (q[b, h*G + g, :] . K_b[t, h, :])) V_b[t, h, :]
// over the keys t < lengths[b], where key t of sequence b lies in pool block
// block_tables[b, t / bs] at row t % bs: K_b[t, h, :] = k_pool[blk, h, t % bs, :].
// q and out (B, H, D) bf16 contiguous; k_pool and v_pool (num_blocks, KVH, bs,
// D) bf16 contiguous (one layer of the pool); block_tables (B, nb_max) int32,
// -1 where unassigned; lengths (B,) int32 on the device; G = H / KVH query
// heads per kv head (GQA), D = 64 or 128, bs a multiple of 16.
//
// Replaces the Pallas kernel paged_decode_attention / _paged_decode_kernel
// (paddlemix_tpu/ops/paged_attention.py). It computes what that kernel does:
// q and k read as fp32, the logits multiplied by `scale` after the dot
// product, keys at or past the length masked to -1e30 with their p forced to
// 0, P and V in fp32, and out = acc / max(l, 1e-30). The TPU kernel walked a
// sequential grid axis over every table entry, and its wrapper forward-filled
// the -1 entries so that the steps past the length re-mapped to a block
// already in VMEM and skipped the copy. Here a block owns one (sequence, kv
// head, range of the sequence's table entries), reads the block ids itself
// and stops at the length, so it never dereferences an entry at or past
// ceil(len / bs), and the -1 entries need no fill; the ranges are merged by a
// second kernel, as in decode_attention.cu.
//
// Bound: the bytes of K and V of each sequence up to its length (the
// arithmetic is ~G flops per byte). One (block, head) tile is a contiguous
// bs x D run, so consecutive keys are consecutive rows: each of the 256
// threads owns one 16-byte chunk (8 values of D) of a key row, D / 8
// consecutive lanes a row, and a warp reads whole rows in one coalesced load;
// a thread loads its KPT rows of K and V at once before using them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// partial: per (query head, split) D + 2 floats, [m, l, acc[0..D)]
template <int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ partial, int kvh, int bs, int nb_max, int chunk_blocks,
                    float scale) {
  constexpr int CH = D / 8;              // lanes per key row
  constexpr int ROWS = THREADS / CH;     // key rows per pass
  constexpr int KPT = G <= 2 ? 8 : 4;    // key rows per thread per block
  constexpr int BK = ROWS * KPT;         // keys per block
  __shared__ float s_p[G][BK];
  __shared__ float s_m[G], s_l[G], s_alpha[G];
  __shared__ float red[ROWS][D];

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % CH, r = tid / CH;
  // this block's keys: [t_begin, n), n = min(length, the table's span, the split's end)
  const int t_begin = split * chunk_blocks * bs;
  const int n = max(0, min(min(lengths[b], nb_max * bs), t_begin + chunk_blocks * bs));
  const int hq = kvh * G;
  const int* table = block_tables + (size_t)b * nb_max;
  const size_t tile = (size_t)bs * D;  // elements of one (block, head) tile

  float qf[G][8], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)b * hq + h * G + g) * D + c * 8),
            qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  for (int t0 = t_begin; t0 < n; t0 += BK) {
    uint4 kr[KPT], vr[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int t = t0 + r + j * ROWS;
      if (t < n) {  // t < length: the table entry t / bs is assigned
        const size_t row = ((size_t)table[t / bs] * kvh + h) * tile + (size_t)(t % bs) * D + c * 8;
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k_pool + row));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v_pool + row));
      } else {
        kr[j] = make_uint4(0, 0, 0, 0);
        vr[j] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();  // the previous block's PV has read s_p
    // logits: each row's CH lanes reduce their partial dot products; the
    // scale multiplies the sum, as in the TPU kernel
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float kf[8];
      unpack8(kr[j], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qf[g][i], kf[i], part);
#pragma unroll
        for (int off = CH / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (c == 0) s_p[g][r + j * ROWS] = t0 + r + j * ROWS < n ? part * scale : MASKED;
      }
    }
    __syncthreads();
    // online softmax: warp g rescales query head g's running max and sum
    if (warp < G) {
      const int g = warp;
      float mloc = -INFINITY;
      for (int i = lane; i < BK; i += 32) mloc = fmaxf(mloc, s_p[g][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_old = s_m[g], m_new = fmaxf(m_old, mloc);
      float lsum = 0.f;
      for (int i = lane; i < BK; i += 32) {
        const float p = t0 + i < n ? expf(s_p[g][i] - m_new) : 0.f;  // masked keys: p = 0
        lsum += p;
        s_p[g][i] = p;  // P stays fp32
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = alpha * s_l[g] + lsum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = s_alpha[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      if (t0 + r + j * ROWS >= n) continue;
      float vf[8];
      unpack8(vr[j], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = s_p[g][r + j * ROWS];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
  }

  // sum the ROWS partial accumulators of each query head; divide by l, or
  // leave (m, l, acc) for the merge
#pragma unroll
  for (int g = 0; g < G; ++g) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) red[r][c * 8 + i] = acc[g][i];
    __syncthreads();
    if (tid < D) {
      float sum = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < ROWS; ++rr) sum += red[rr][tid];
      const size_t head = (size_t)b * hq + h * G + g;
      const float l = s_l[g];
      if (splits == 1) {
        out[head * D + tid] = __float2bfloat16(sum / fmaxf(l, 1e-30f));
      } else {
        float* p = partial + (head * splits + split) * (D + 2);
        p[2 + tid] = sum;
        if (tid == 0) {
          p[0] = s_m[g];
          p[1] = l;
        }
      }
    }
  }
}

// One block of D threads per (query head, sequence): out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30) with w_s = exp(m_s - max m), 0 for a range
// without keys.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out, int hq,
                   int splits) {
  const size_t head = (size_t)blockIdx.y * hq + blockIdx.x;
  const float* p = partial + head * splits * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, p[s * (D + 2)]);
  float l = 0.f, sum = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float w = expf(p[s * (D + 2)] - m);
      l += w * p[s * (D + 2) + 1];
      sum += w * p[s * (D + 2) + 2 + threadIdx.x];
    }
  }
  out[head * D + threadIdx.x] = __float2bfloat16(sum / fmaxf(l, 1e-30f));
}

struct Args {
  const void *q, *k_pool, *v_pool, *block_tables, *lengths;
  void* out;
  float* partial;
  int B, kvh, bs, nb_max, splits, chunk_blocks;
  float scale;
};

template <int D, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  paged_decode_kernel<D, G><<<dim3(a.kvh, a.B, a.splits), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k_pool),
      static_cast<const __nv_bfloat16*>(a.v_pool), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out), a.partial, a.kvh,
      a.bs, a.nb_max, a.chunk_blocks, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_decode_merge<D><<<dim3(a.kvh * G, a.B), D, 0, stream>>>(
      a.partial, static_cast<__nv_bfloat16*>(a.out), a.kvh * G, a.splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<D, 1>(a, stream);
    case 2: return launch<D, 2>(a, stream);
    case 4: return launch<D, 4>(a, stream);
    case 8: return launch<D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). The table entries
// of each sequence are cut into `splits` ranges of `chunk_blocks` entries
// (splits * chunk_blocks >= nb_max); `partial` holds B * KVH * G * splits *
// (D + 2) floats when splits > 1.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* block_tables, const void* lengths,
                                           void* out, void* partial, int B, int kvh, int G,
                                           int D, int bs, int nb_max, int splits,
                                           int chunk_blocks, float scale, void* stream) {
  if (B == 0 || kvh == 0) return 0;
  if (bs < 16 || bs % 16 || splits < 1 || (long long)splits * chunk_blocks < nb_max ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, block_tables, lengths, out, static_cast<float*>(partial), B,
               kvh, bs, nb_max, splits, chunk_blocks, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch_g<64>(G, a, s);
  if (D == 128) return dispatch_g<128>(G, a, s);
  return cudaErrorInvalidValue;
}
