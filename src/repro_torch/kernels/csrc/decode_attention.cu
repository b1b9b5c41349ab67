// K5: one new query token per sequence against a KV cache (flash-decode),
// hand-written for Hopper (sm_90a). Built by nvcc into a shared library
// with a plain C interface and loaded through ctypes
// (repro_torch/kernels/attention.py). The entry point launches on the
// stream it is given, allocates nothing, and returns the CUDA error of its
// launch (0 on success).
//
// Replaces repro/kernels/decode_attention.py decode_attention /
// _decode_kernel. The Pallas wrapper transposed the whole cache to
// (B*K, S, hd) before its grid walked the kv blocks in order; here one CTA
// owns one (b, kv head), reads the (B, S, K, hd) cache in place with its
// strides (no copy, so a decode step does not rewrite the cache once per
// layer), and loops over ceil(length / 64) key tiles only. The G = H / K
// query heads of that kv head share every K/V tile it loads; the running
// max, sum and the (G, hd) accumulator stay in fp32 in shared memory.
//
// Bound: bytes. A step reads length*K*hd*2 cache elements per sequence and
// does 4*G flops per element read, far below the ~295 flop/byte the H100
// needs to be compute-bound. This first version runs B*K CTAs (32 at the
// serve path's batch of 4 with 8 kv heads), so it uses a quarter of the
// SMs; splitting the sequence across CTAs with a final combine is the
// known next step.
//
// Keys at or past length[b] are masked (and their tile rows zero-filled,
// so stale cache rows can never turn a zero probability into NaN); length
// is clamped to [0, S]. length[b] = 0 gives a zero output. q is
// (B, H, hd) and o a contiguous (B, H, hd) tensor, both of the caches'
// dtype; query head i attends through kv head i / G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kTK = 64;           // keys per tile: two per lane in the softmax
constexpr float kNegInf = -1e30f; // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

struct Strides {
  long long b, s, h;   // elements; the head_dim stride is 1
};

template <int HD>
int smem_floats(int G) {
  return G * HD              // the G query rows
         + kTK * (HD + 1)    // K tile, padded rows
         + kTK * HD          // V tile
         + G * kTK           // scores, then probabilities
         + 3 * G             // running max, running sum, rescale factor
         + G * HD;           // accumulator
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ length,
              T* __restrict__ o, int S, int KH, int G, long long q_sb,
              long long q_sh, Strides ks, Strides vs, float scale) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + G * HD;
  float* sv = sk + kTK * LD;
  float* sp = sv + kTK * HD;
  float* sm = sp + G * kTK;
  float* sl = sm + G;
  float* sa = sl + G;
  float* acc = sa + G;

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int tid = threadIdx.x;
  const int len = min(max(length[b], 0), S);
  const T* kb = kc + b * ks.b + kh * ks.h;
  const T* vb = vc + b * vs.b + kh * vs.h;

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    sq[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }

  const int n_t = (len + kTK - 1) / kTK;
  for (int t = 0; t < n_t; ++t) {
    const int k0 = t * kTK;
    __syncthreads();   // the previous tile's K, V and P reads are done
    for (int i = tid; i < kTK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k0 + r;
      const bool in = row < len;
      sk[r * LD + d] = in ? to_f32(kb[row * ks.s + d]) : 0.f;
      sv[r * HD + d] = in ? to_f32(vb[row * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores: one (head, key) pair a thread; a warp's 32 keys sit in 32
    // distinct banks thanks to the padded rows
    for (int i = tid; i < G * kTK; i += kThreads) {
      const int g = i / kTK, c = i % kTK;
      const float* qr = sq + g * HD;
      const float* kr = sk + c * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      sp[i] = k0 + c < len ? s * scale : kNegInf;
    }
    __syncthreads();

    {  // online softmax: warp w takes heads w, w+4, ...; two keys a lane
      const int w = tid / 32, lane = tid % 32;
      for (int g = w; g < G; g += kThreads / 32) {
        const float x0 = sp[g * kTK + lane], x1 = sp[g * kTK + lane + 32];
        const float m_prev = sm[g];
        const float m_cur = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
        const float p0 = expf(x0 - m_cur), p1 = expf(x1 - m_cur);
        const float sum = warp_sum(p0 + p1);
        sp[g * kTK + lane] = p0;
        sp[g * kTK + lane + 32] = p1;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_cur);
          sa[g] = alpha;
          sl[g] = sl[g] * alpha + sum;
          sm[g] = m_cur;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V: one (head, column) entry a thread
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      const float* pr = sp + g * kTK;
      float a = acc[i] * sa[g];
#pragma unroll 8
      for (int c = 0; c < kTK; ++c) a = fmaf(pr[c], sv[c * HD + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    o[((long long)b * KH * G + kh * G + g) * HD + d] =
        from_f32<T>(acc[i] / fmaxf(sl[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* length,
           void* o, int B, int S, int KH, int G, long long q_sb,
           long long q_sh, Strides ks, Strides vs, cudaStream_t stream) {
  const int smem = smem_floats<HD>(G) * (int)sizeof(float);
  auto kern = decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * KH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), length, static_cast<T*>(o), S, KH, G, q_sb,
      q_sh, ks, vs, (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kc, const void* vc,
              const int* len, void* o, int B, int S, int KH, int G,
              long long q_sb, long long q_sh, Strides ks, Strides vs,
              cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, kc, vc, len, o, B, S, KH, G, q_sb, q_sh, ks, vs,
                          s);
    case 16:
      return launch<T, 16>(q, kc, vc, len, o, B, S, KH, G, q_sb, q_sh, ks,
                           vs, s);
    case 32:
      return launch<T, 32>(q, kc, vc, len, o, B, S, KH, G, q_sb, q_sh, ks,
                           vs, s);
    case 64:
      return launch<T, 64>(q, kc, vc, len, o, B, S, KH, G, q_sb, q_sh, ks,
                           vs, s);
    case 128:
      return launch<T, 128>(q, kc, vc, len, o, B, S, KH, G, q_sb, q_sh, ks,
                            vs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* da_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
int da_decode_attention(const void* q, const void* k_cache,
                        const void* v_cache, const int* length, void* o,
                        int B, int S, int KH, int G, int hd, long long q_sb,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int dtype, void* stream) {
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_cache, v_cache, length, o, B, S, KH, G,
                            q_sb, q_sh, ks, vs, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, length, o, B, S,
                                    KH, G, q_sb, q_sh, ks, vs, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
