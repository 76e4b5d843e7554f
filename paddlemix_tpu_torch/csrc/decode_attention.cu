// Single-query decode attention over a bf16 KV cache (B7) or an int8 KV cache
// with per-(token, head) fp32 scales (B8):
//   out[b, 0, h*G + g, :] = softmax_t(scale * q[b, 0, h*G + g, :] . k[b, t, h, :]) v[b, t, h, :]
// over the keys t < min(lengths[b], L), where an int8 row reads as
// k_q[b, t, h, :] * k_scale[b, t, h] (v likewise); q and out (B, 1, Hq, D)
// bf16 contiguous, k and v (B, L, KVH, D) with unit stride over D and any
// other strides (a slice of the layer-major cache), the scales (B, L, KVH)
// with any strides, lengths (B,) int32 on the device, G = Hq / KVH query heads
// per kv head (GQA), D = 64 or 128.
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
// Each of the 256 threads owns 8 values of D of a key row (16 bytes of a bf16
// row, 8 of an int8 one), D / 8 consecutive lanes a row, so a row is one
// coalesced read; a thread loads its KPT rows of K and V of a key block (and
// their scales) at once, up to 64 KB in flight per block for bf16 and half of
// that for int8, before using them.
// One block per (batch, kv head) would leave most SMs idle when B * KVH is
// small (Llama-7B at batch 1: 32 blocks on 132 SMs), so the keys are split
// into S contiguous ranges, one block each (the caller picks S): each block
// writes its unnormalised (m, l, acc) to a scratch buffer, and a second
// kernel merges the S partials of each query head, acc and l rescaled by
// exp(m_s - max m). With S = 1 the first kernel writes the output itself.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ctypes binding,
// no PyTorch headers); launched on the caller's stream, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// How a cache element type is read: 8 values of a row as one vector load.
template <typename T>
struct CacheRow;

template <>
struct CacheRow<__nv_bfloat16> {
  using Vec = uint4;
  static constexpr bool kInt8 = false;
  __device__ __forceinline__ static void unpack(const Vec& u, float (&v)[8]) { unpack8(u, v); }
};

template <>
struct CacheRow<int8_t> {
  using Vec = uint2;
  static constexpr bool kInt8 = true;
  __device__ __forceinline__ static void unpack(const Vec& u, float (&v)[8]) {
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
    }
  }
};

// partial: per (query head, split) D + 2 floats, [m, l, acc[0..D)]. T is the
// cache element type; ks / vs (the int8 rows' scales) are read for int8 only.
template <int D, int G, typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int L,
                        int kvh, int chunk, long long k_sb, long long k_sl, long long k_sh,
                        long long v_sb, long long v_sl, long long v_sh, long long ks_sb,
                        long long ks_sl, long long ks_sh, long long vs_sb, long long vs_sl,
                        long long vs_sh, float scale) {
  using Row = CacheRow<T>;
  using Vec = typename Row::Vec;
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
  // this block's keys: [t_begin, n), n = min(length, L, the split's end)
  const int t_begin = split * chunk;
  const int n = max(0, min(min(lengths[b], L), t_begin + chunk));
  const int hq = kvh * G;

  float qf[G][8], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float t[8];
    unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)b * hq + h * G + g) * D + c * 8), t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[g][i] = t[i] * scale;
      acc[g][i] = 0.f;
    }
  }
  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  const T* kb = k + b * k_sb + h * k_sh + c * 8;
  const T* vb = v + b * v_sb + h * v_sh + c * 8;
  const float* ksb = Row::kInt8 ? ks + b * ks_sb + h * ks_sh : nullptr;
  const float* vsb = Row::kInt8 ? vs + b * vs_sb + h * vs_sh : nullptr;

  for (int t0 = t_begin; t0 < n; t0 += BK) {
    Vec kr[KPT], vr[KPT];
    float ksr[KPT], vsr[KPT];  // the rows' scales (int8)
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int t = t0 + r + j * ROWS;
      kr[j] = t < n ? __ldg(reinterpret_cast<const Vec*>(kb + t * k_sl)) : Vec{};
      vr[j] = t < n ? __ldg(reinterpret_cast<const Vec*>(vb + t * v_sl)) : Vec{};
      if constexpr (Row::kInt8) {
        ksr[j] = t < n ? __ldg(ksb + t * ks_sl) : 0.f;
        vsr[j] = t < n ? __ldg(vsb + t * vs_sl) : 0.f;
      }
    }
    __syncthreads();  // the previous block's PV has read s_p
    // logits: each row's CH lanes reduce their partial dot products
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float kf[8];
      Row::unpack(kr[j], kf);
      if constexpr (Row::kInt8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] *= ksr[j];  // dequant in fp32, as the TPU kernel
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qf[g][i], kf[i], part);
#pragma unroll
        for (int off = CH / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (c == 0) s_p[g][r + j * ROWS] = t0 + r + j * ROWS < n ? part : NEG;
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
        const float p = expf(s_p[g][i] - m_new);
        lsum += p;
        // B7: P meets V in bf16, as in its TPU kernel; B8 keeps P in fp32
        s_p[g][i] = Row::kInt8 ? p : round_bf16(p);
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
      Row::unpack(vr[j], vf);
      if constexpr (Row::kInt8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) vf[i] *= vsr[j];
      }
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
        out[head * D + tid] = __float2bfloat16(sum / (l == 0.f ? 1.f : l));
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

// One block of D threads per (query head, batch): out = sum_s w_s acc_s /
// sum_s w_s l_s with w_s = exp(m_s - max m), 0 where no split saw a key.
template <int D>
__global__ void __launch_bounds__(D)
decode_attention_merge(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                       int hq, int splits) {
  const size_t head = (size_t)blockIdx.y * hq + blockIdx.x;
  const float* p = partial + head * splits * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, p[s * (D + 2)]);
  float l = 0.f, sum = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float w = expf(p[s * (D + 2)] - m);  // 0 for a split without keys
      l += w * p[s * (D + 2) + 1];
      sum += w * p[s * (D + 2) + 2 + threadIdx.x];
    }
  }
  out[head * D + threadIdx.x] = __float2bfloat16(sum / (l == 0.f ? 1.f : l));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void* out;
  float* partial;
  int B, L, kvh, splits, chunk;
  long long k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, ks_sb, ks_sl, ks_sh, vs_sb, vs_sl, vs_sh;
  float scale;
};

template <int D, int G, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_attention_kernel<D, G, T><<<dim3(a.kvh, a.B, a.splits), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.partial, a.L, a.kvh, a.chunk, a.k_sb, a.k_sl,
      a.k_sh, a.v_sb, a.v_sl, a.v_sh, a.ks_sb, a.ks_sl, a.ks_sh, a.vs_sb, a.vs_sl, a.vs_sh,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_attention_merge<D><<<dim3(a.kvh * G, a.B), D, 0, stream>>>(
      a.partial, static_cast<__nv_bfloat16*>(a.out), a.kvh * G, a.splits);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<D, 1, T>(a, stream);
    case 2: return launch<D, 2, T>(a, stream);
    case 4: return launch<D, 4, T>(a, stream);
    case 8: return launch<D, 8, T>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int D, int G, const Args& a, cudaStream_t stream) {
  if (a.B == 0 || a.kvh == 0) return cudaSuccess;
  if (a.splits < 1 || (long long)a.splits * a.chunk < a.L ||
      (a.splits > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  if (D == 64) return dispatch_g<64, T>(G, a, stream);
  if (D == 128) return dispatch_g<128, T>(G, a, stream);
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
