// K4b: the gradient of K4 (causal or full softmax attention with grouped
// kv heads), hand-written for Hopper (sm_90a). Built by nvcc into a shared
// library with a plain C interface and loaded through ctypes
// (repro_torch/kernels/attention.py, which calls it from the backward of
// K4's autograd Function). The entry point launches on the stream it is
// given, allocates nothing, and returns the CUDA error of its launches (0
// on success).
//
// Replaces no Pallas kernel: the reference differentiates its einsum
// attention (repro/models/attention.py, _chunked_attention) with XLA's
// autodiff and has no custom_vjp around its Pallas flash attention. This
// kernel computes what jax.grad gives there, for the port's K4.
//
// Three launches behind one call, each CTA of 256 threads on the CUDA cores
// with its tiles converted to fp32 in shared memory (rows padded by one
// float so the column reads hit distinct banks):
//
// 1. stats: one CTA per (b, h, 64 query rows) recomputes each row's
//    log-sum-exp of the scaled scores (online, over the key tiles up to the
//    diagonal under the causal mask) and delta = rowsum(dO * O), both fp32,
//    into the caller's scratch. K4 keeps its statistics in registers and
//    writes only O, so its two routes stay as they are.
// 2. dK, dV: one CTA per (b, kv head, 64 keys) walks the G query heads of
//    its kv head and, under the causal mask, only the query tiles at or
//    after its key tile. With P = exp(S * scale - lse) it accumulates
//    dV += P^T dO and dK += (P * (dO V^T - delta))^T Q in registers, then
//    writes each row once (times scale for dK): the GQA sum over the G
//    heads happens inside the CTA, so there are no atomics.
// 3. dQ: one CTA per (b, h, 64 query rows) walks the key tiles up to the
//    diagonal and accumulates dQ += (P * (dO V^T - delta)) K, times scale.
//
// Bound: at llama3.2-3b's training shape (B=4, S=1024, H=24, K=8, hd=128,
// bf16, causal) its five products (Q K^T, dO V^T, P^T dO, dS K, dS^T Q;
// 5 x 2 B H S^2 hd, halved by the mask) are 64 GFLOP, 0.065 ms at the
// tensor cores' 989 TFLOP/s, against 0.04 ms for its bytes (q, k, v, o,
// dO read, dq, dk, dv written) at 3.35 TB/s: operations. This kernel runs
// them (and the recomputed Q K^T of launches 1 and 3) on the CUDA cores in
// fp32, far from that bound; wgmma and a forward that writes lse are later
// work.
//
// q, k, v are read with their (B, S, heads, hd) strides (the last dimension
// contiguous); o and dO are contiguous (B, S, H, hd), dq contiguous
// (B, S, H, hd), dk and dv contiguous (B, S, K, hd), all of the input
// dtype. Any S: rows and keys past S are zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head_dim stride is 1
};

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile (== kBQ: the diagonal
                                   // of q-tile i is k-tile i)
constexpr int kLDP = kBK + 1;      // padded row of a probability tile
constexpr float kNegInf = -1e30f;  // K4's mask value

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

// max and sum over the 16 lanes that share a row group (lanes 0-15 or
// 16-31 of a warp: threads tid / 16 == sy)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int HD>
__host__ __device__ constexpr int cols_per_thread() {
  return (HD + 15) / 16;
}

// rows [row0, row0 + 64) of one (b, head) slice (base, row stride) into dst
// (64 rows of HD + 1 floats); rows past S are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long stride_s, int row0,
                                          int S) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = row0 + r;
    dst[r * LD + d] = row < S ? to_f32(base[row * stride_s + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[r_i][d] * B[c_j][d] for the 64 x 64 tile: thread
// (sy, sx) = (tid / 16, tid % 16) owns rows sy*4 + i and columns sx + 16 j
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float (&acc)[4][4]) {
  constexpr int LD = HD + 1;
  const int sy = threadIdx.x / 16, sx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(sy * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(sx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c M(c, r_i) * X[c][d_j] over the 64 rows c of X, where
// M(c, r) is M[c][r] (kTrans: M's columns are the output rows) or M[r][c];
// thread (ty, tx) = (tid / 16, tid % 16) owns output rows ty*4 + i and
// columns tx + 16 j
template <int HD, bool kTrans>
__device__ __forceinline__ void accum_rows(
    const float* M, const float* X, float (&acc)[4][cols_per_thread<HD>()]) {
  constexpr int LD = HD + 1;
  constexpr int CPT = cols_per_thread<HD>();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < kBQ; ++c) {
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m[i] = kTrans ? M[c * kLDP + ty * 4 + i] : M[(ty * 4 + i) * kLDP + c];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      const float x = d < HD ? X[c * LD + d] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(m[i], x, acc[i][j]);
    }
  }
}

// P and dS of one (query tile, key tile) pair into sP (optional) and sdS:
// P = exp(S * scale - lse) where the key is real and visible, else 0;
// dS = P * (dP - delta)
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* sL, const float* sD,
                                      float* sP, float* sdS, int q0, int k0,
                                      int S, float scale, int causal) {
  const int sy = threadIdx.x / 16, sx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = sy * 4 + i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = sx + 16 * j, key = k0 + c;
      const bool ok = row < S && key < S && (!causal || key <= row);
      const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * kLDP + c] = p;
      sdS[r * kLDP + c] = p * (dp[i][j] - sD[r]);
    }
  }
}

// the lse and delta of rows [q0, q0 + 64) of (b, h) into sL, sD (0 past S)
__device__ __forceinline__ void load_stats(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, long long bh,
                                           int q0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int row = q0 + r;
    sL[r] = row < S ? lse[bh * S + row] : 0.f;
    sD[r] = row < S ? delta[bh * S + row] : 0.f;
  }
}

template <int HD>
constexpr int smem_bytes(int tiles, int prob_tiles) {
  return (tiles * kBQ * (HD + 1) + prob_tiles * kBQ * kLDP + 2 * kBQ) *
         (int)sizeof(float);
}

// 1. per-row log-sum-exp of the scaled scores and delta = rowsum(dO * O)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta, int S, int H,
             int G, Strides qs, Strides ks, float scale, int causal) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the most work first
  const int tid = threadIdx.x;
  const long long bh = (long long)b * H + h;

  {  // delta: four threads a row
    const int r = tid / 4, part = tid % 4, row = q0 + r;
    float sum = 0.f;
    if (row < S) {
      const long long at = (((long long)b * S + row) * H + h) * HD;
      for (int d = part; d < HD; d += 4)
        sum = fmaf(to_f32(o[at + d]), to_f32(dout[at + d]), sum);
    }
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    if (part == 0 && row < S) delta[bh * S + row] = sum;
  }

  load_rows<T, HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S);
  const T* kb = k + b * ks.b + kh * ks.h;
  const int sy = tid / 16, sx = tid % 16;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K reads are done
    load_rows<T, HD>(sK, kb, ks.s, k0, S);
    __syncthreads();
    float s[4][4];
    dot_tile<HD>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + sy * 4 + i;
      float x[4], tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + sx + 16 * j;
        const bool ok = key < S && (!causal || key <= row);
        x[j] = ok ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, x[j]);
      }
      // key 0 is in tile 0 and visible to every row, so m is finite from
      // the first tile on
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += x[j] > kNegInf ? expf(x[j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
  if (sx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + sy * 4 + i;
      if (row < S) lse[bh * S + row] = m[i] + logf(l[i]);
    }
  }
}

// 2. dK and dV of 64 keys of one (b, kv head), summed over its G heads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int G,
            Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = cols_per_thread<HD>();
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBQ * kLDP;
  float* sL = sdS + kBQ * kLDP;
  float* sD = sL + kBQ;
  const int KH = H / G;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int k0 = blockIdx.y * kBK;   // the first key tiles see the most rows
  const int tid = threadIdx.x;

  load_rows<T, HD>(sK, k + b * ks.b + kh * ks.h, ks.s, k0, S);
  load_rows<T, HD>(sV, v + b * vs.b + kh * vs.h, vs.s, k0, S);
  float acc_dk[4][CPT], acc_dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + (long long)b * S * H * HD + (long long)h * HD;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the previous tile's reads are done
      load_rows<T, HD>(sQ, qb, qs.s, q0, S);
      load_rows<T, HD>(sdO, gb, (long long)H * HD, q0, S);
      load_stats(sL, sD, lse, delta, bh, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<HD>(sQ, sK, s);
      dot_tile<HD>(sdO, sV, dp);
      probs(s, dp, sL, sD, sP, sdS, q0, k0, S, scale, causal);
      __syncthreads();
      accum_rows<HD, true>(sP, sdO, acc_dv);
      accum_rows<HD, true>(sdS, sQ, acc_dk);
    }
  }

  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const long long at = (((long long)b * S + key) * KH + kh) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) {
        dk[at + d] = from_f32<T>(acc_dk[i][j] * scale);
        dv[at + d] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

// 3. dQ of 64 query rows of one (b, h)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int G, Strides qs, Strides ks,
          Strides vs, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = cols_per_thread<HD>();
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;
  float* sL = sdS + kBQ * kLDP;
  float* sD = sL + kBQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the most work first
  const int tid = threadIdx.x;
  const long long bh = (long long)b * H + h;

  load_rows<T, HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_rows<T, HD>(sdO, dout + (long long)b * S * H * HD + (long long)h * HD,
                   (long long)H * HD, q0, S);
  load_stats(sL, sD, lse, delta, bh, q0, S);
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's reads are done
    load_rows<T, HD>(sK, kb, ks.s, k0, S);
    load_rows<T, HD>(sV, vb, vs.s, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(sQ, sK, s);
    dot_tile<HD>(sdO, sV, dp);
    probs(s, dp, sL, sD, nullptr, sdS, q0, k0, S, scale, causal);
    __syncthreads();
    accum_rows<HD, false>(sdS, sK, acc);
  }

  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const long long at = (((long long)b * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) dq[at + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to what its launches need,
// once (``allowed`` is the kernel's own static).
template <typename K>
cudaError_t allow_smem(K kern, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, int B, int S,
           int H, int G, Strides qs, Strides ks, Strides vs, int causal,
           float* scratch, cudaStream_t stream) {
  static int allowed_stats = 48 * 1024, allowed_dkdv = 48 * 1024,
             allowed_dq = 48 * 1024;
  const int smem_stats = smem_bytes<HD>(2, 0);
  const int smem_dkdv = smem_bytes<HD>(4, 2);
  const int smem_dq = smem_bytes<HD>(4, 1);
  auto k_stats = stats_kernel<T, HD>;
  auto k_dkdv = dkdv_kernel<T, HD>;
  auto k_dq = dq_kernel<T, HD>;
  cudaError_t err = allow_smem(k_stats, smem_stats, allowed_stats);
  if (err == cudaSuccess) err = allow_smem(k_dkdv, smem_dkdv, allowed_dkdv);
  if (err == cudaSuccess) err = allow_smem(k_dq, smem_dq, allowed_dq);
  if (err != cudaSuccess) return (int)err;

  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tg = static_cast<const T*>(dout);
  float* lse = scratch;
  float* delta = scratch + (long long)B * H * S;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const unsigned n_q = (unsigned)((S + kBQ - 1) / kBQ);
  const unsigned n_k = (unsigned)((S + kBK - 1) / kBK);

  k_stats<<<dim3((unsigned)(B * H), n_q), kThreads, smem_stats, stream>>>(
      tq, tk, to, tg, lse, delta, S, H, G, qs, ks, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_dkdv<<<dim3((unsigned)(B * (H / G)), n_k), kThreads, smem_dkdv,
           stream>>>(tq, tk, tv, tg, lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), S, H, G, qs, ks, vs, scale,
                     causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_dq<<<dim3((unsigned)(B * H), n_q), kThreads, smem_dq, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), S, H, G, qs, ks, vs,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, void* dq, void* dk, void* dv,
              int B, int S, int H, int G, Strides qs, Strides ks, Strides vs,
              int causal, float* scratch, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs, ks,
                          vs, causal, scratch, s);
    case 16:
      return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs, ks,
                           vs, causal, scratch, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs, ks,
                           vs, causal, scratch, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs, ks,
                           vs, causal, scratch, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs,
                            ks, vs, causal, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fp32 scratch a call needs: lse and delta of every (b, h, row)
long long fab_scratch_floats(int B, int S, int H) {
  return 2LL * B * H * S;
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. q, o, dO and
// dq have H heads, k, v, dk and dv KH, with H % KH == 0. scratch holds
// fab_scratch_floats(B, S, H) floats.
int fab_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, void* dq,
                            void* dk, void* dv, int B, int S, int H, int KH,
                            int hd, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, int causal, int dtype,
                            void* scratch, void* stream) {
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, dq, dk, dv, B, S, H, G, qs,
                            ks, vs, causal, f, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, dq, dk, dv, B, S,
                                    H, G, qs, ks, vs, causal, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
