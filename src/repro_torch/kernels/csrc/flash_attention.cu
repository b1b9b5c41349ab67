// K4: causal (or full) softmax attention, hand-written for Hopper (sm_90a).
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (repro_torch/kernels/attention.py). The entry point
// launches on the stream it is given, allocates nothing, and returns the
// CUDA error of its launch (0 on success).
//
// Replaces repro/kernels/flash_attention.py flash_attention / _flash_kernel
// (the Pallas kernel's grid walked the k blocks of one q block in order,
// carrying m, l and acc in VMEM scratch). Here one CTA owns one (b, h,
// q-tile) and loops over the k-tiles itself, keeping the running max, sum
// and accumulator in fp32 (registers for acc, shared memory for m and l).
// Tiles fully above the diagonal are never visited (causal), and a ragged
// last tile (S not a multiple of the tile) is masked, so any S works.
//
// Bound: at the serve path's prefill shape (B=4, S=1024, H=24, hd=128,
// bf16) the 2*B*H*S^2*hd causal FLOPs at the tensor cores' 989 TFLOP/s and
// the 4*B*S*H*hd*2 bytes at 3.35 TB/s are both about 0.03 ms: balanced.
// This first version runs the two products on the CUDA cores in fp32
// (no mma/wgmma, no TMA), so it is far from that bound; its design only
// keeps the work right and conflict-free: Q, K and V tiles are converted
// to fp32 in shared memory once per tile, rows are padded by one float so
// the column reads of the score product hit 32 distinct banks, and each
// thread keeps an 8 x ceil(hd/16) block of the accumulator in registers.
//
// q, k, v are read with their (B, S, H, hd) strides (the last dimension
// contiguous), so the caller makes no transposed copy; o is a contiguous
// (B, S, H, hd) tensor of the input dtype. Output = acc / max(l, 1e-30),
// as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 32;           // key rows per tile
constexpr int kLDP = kBK + 1;     // padded row of the probability tile
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
constexpr int smem_floats() {
  return kBQ * (HD + 1)      // Q tile, padded rows
         + kBK * (HD + 1)    // K tile, padded rows
         + kBK * HD          // V tile
         + kBQ * kLDP        // scores, then probabilities
         + 3 * kBQ;          // running max, running sum, rescale factor
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = (HD + 15) / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * LD;
  float* sv = sk + kBK * LD;
  float* sp = sv + kBK * HD;
  float* sm = sp + kBQ * kLDP;
  float* sl = sm + kBQ;
  float* sa = sl + kBQ;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // the last q-tiles (the most k-tiles under the causal mask) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    sq[r * LD + d] = row < S ? to_f32(qb[row * qs.s + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  // P.V: thread (ty, tx) owns rows ty*8..ty*8+7, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k0 + r;
      const bool in = row < S;     // rows past S: zeros, never NaN garbage
      sk[r * LD + d] = in ? to_f32(kb[row * ks.s + d]) : 0.f;
      sv[r * HD + d] = in ? to_f32(vb[row * vs.s + d]) : 0.f;
    }
    __syncthreads();

    {  // scores: thread (sy, sx) owns rows sy*4..sy*4+3, columns sx + 8*j
      const int sy = tid / 8, sx = tid % 8;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sq[(sy * 4 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sk[(sx + 8 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = sy * 4 + i, c = sx + 8 * j;
          const int qi = q0 + r, ki = k0 + c;
          const bool ok = ki < S && (!causal || ki <= qi);
          sp[r * kLDP + c] = ok ? s[i][j] * scale : kNegInf;
        }
    }
    __syncthreads();

    {  // online softmax: warp w owns rows w*16..w*16+15, one column a lane
      const int w = tid / 32, lane = tid % 32;
      for (int rr = 0; rr < kBQ / 4; ++rr) {
        const int r = w * (kBQ / 4) + rr;
        const float x = sp[r * kLDP + lane];
        const float m_prev = sm[r];
        const float m_cur = fmaxf(m_prev, warp_max(x));
        const float p = expf(x - m_cur);
        const float sum = warp_sum(p);
        sp[r * kLDP + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_cur);
          sa[r] = alpha;
          sl[r] = sl[r] * alpha + sum;
          sm[r] = m_cur;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = sa[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = sp[(ty * 8 + i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < HD ? sv[c * HD + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i, row = q0 + r;
    if (row >= S) continue;
    const float l = fmaxf(sl[r], 1e-30f);
    T* orow = o + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) orow[d] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, Strides qs, Strides ks, Strides vs, int causal,
           cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, qs, ks, vs,
      (float)(1.0 / sqrt((double)HD)), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, Strides qs, Strides ks, Strides vs,
              int causal, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, B, S, H, qs, ks, vs, causal, s);
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, qs, ks, vs, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, qs, ks, vs, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, qs, ks, vs, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, qs, ks, vs, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int hd, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, int dtype, int causal,
                       void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, S, H, qs, ks, vs, causal, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, qs, ks, vs,
                                    causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
