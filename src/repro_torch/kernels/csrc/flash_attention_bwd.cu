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
// It reads each query row's log-sum-exp, lse, as K4 wrote it in the
// forward (fp32 (B, H, S)), so P = exp(S * scale - lse) needs no second
// softmax. Three launches behind one call, with no atomics (each output
// element is written once, so the gradients are the same run to run):
//
// 1. delta: delta = rowsum(dO * O) in fp32 into the caller's scratch, 16
//    bytes a load, one to 32 threads a row (both routes).
// 2. dK, dV: one CTA per (b, kv head, key tile) walks the G query heads of
//    its kv head and, under the causal mask, only the query tiles from its
//    diagonal on. With dS = P * (dO V^T - delta) it accumulates
//    dV += P^T dO and dK += dS^T Q in registers, then writes each row once
//    (times scale for dK): the GQA sum over the G heads stays in the CTA.
// 3. dQ: one CTA per (b, h, 64 query rows) walks the key tiles up to the
//    diagonal and accumulates dQ += dS K, times scale.
//
// Two routes for 2 and 3, chosen on the host by dtype, head dim and
// alignment (never by a failure), as K4's are:
//
// * tc (bf16, hd 64 or 128, q/k/v rows on 16 bytes): the tensor cores,
//   with K4's building blocks (hopper.cuh): TMA loads of 64 x 64 boxes with
//   the 128-byte swizzle, an mbarrier ring fed by one producer warp, and
//   wgmma with fp32 accumulators. dK, dV: a consumer warpgroup owns 64
//   keys whose K and V tiles are loaded once; the producer warp brings each
//   (Q, dO) tile pair with its 64 lse and delta values through a two-stage
//   ring. S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both
//   operands K-major in shared memory (the form of K4's Q K^T); P^T and
//   dS^T are computed on the accumulator registers (lse and delta belong
//   to their columns), packed to bf16 in registers and become the A
//   operand of dV += P^T dO and dK += dS^T Q, wgmma m64n{hd}k16 with dO and
//   Q as the MN-major B (the form of K4's P V). dQ: K4's skeleton, one
//   consumer warpgroup and a producer warp streaming K and V through the
//   ring: S = Q K^T, dP = dO V^T, dS on the registers, dQ += dS K with K as
//   the MN-major B. Query rows past S carry lse = +inf into dK/dV's
//   products (P = 0); keys past S are masked in dQ's; TMA zero-fills both.
//   P and dS are rounded to bf16 for their products, as in
//   FlashAttention.
// * simt (fp32, the other head dims, unaligned rows): CTAs of 256 threads
//   on the CUDA cores with tiles converted to fp32 in shared memory (rows
//   padded by one float so the column reads hit distinct banks).
//
// Bound: at llama3.2-3b's training shape (B=4, S=1024, H=24, K=8, hd=128,
// bf16, causal) its five products (Q K^T, dO V^T, P^T dO, dS K, dS^T Q;
// 5 x 2 B H S^2 hd, halved by the mask) are 64 GFLOP, 0.065 ms at the
// tensor cores' 989 TFLOP/s, against 0.04 ms for its bytes (q, k, v, o,
// dO read, dq, dk, dv written) at 3.35 TB/s: operations. The tc route runs
// seven products (Q K^T and dO V^T once for dK, dV and once for dQ), 90
// GFLOP, to keep each output in one CTA without atomics.
//
// q, k, v are read with their (B, S, heads, hd) strides (the last dimension
// contiguous); o and dO are contiguous (B, S, H, hd) on 16 bytes, dq
// contiguous (B, S, H, hd), dk and dv contiguous (B, S, K, hd), all of the
// input dtype. Any S: rows and keys past S are zero-filled and masked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using hopper::aligned16;
using hopper::allow_smem;
using hopper::rows_aligned;
using hopper::Strides;

constexpr float kLog2e = 1.4426950408889634f;

// -- 1. delta = rowsum(dO * O), both routes ----------------------------------

template <typename T> __device__ __forceinline__ float dot16(uint4 a, uint4 g);
template <> __device__ __forceinline__ float dot16<float>(uint4 a, uint4 g) {
  float sum = __uint_as_float(a.x) * __uint_as_float(g.x);
  sum = fmaf(__uint_as_float(a.y), __uint_as_float(g.y), sum);
  sum = fmaf(__uint_as_float(a.z), __uint_as_float(g.z), sum);
  return fmaf(__uint_as_float(a.w), __uint_as_float(g.w), sum);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(uint4 a, uint4 g) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {g.x, g.y, g.z, g.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 w =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    sum = fmaf(u.x, w.x, sum);
    sum = fmaf(u.y, w.y, sum);
  }
  return sum;
}

constexpr int kDeltaThreads = 256;

// thread t reads the t-th 16 bytes of o and dO; a row of HD elements is
// kTPR neighbouring threads of one warp, summed by shuffles
template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int S, int H, long long rows) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kTPR = HD / kVec;
  static_assert(kTPR >= 1 && kTPR <= 32 && HD % kVec == 0, "row split");
  const long long t = (long long)blockIdx.x * kDeltaThreads + threadIdx.x;
  const long long r = t / kTPR;   // the (b, s, h) row
  float sum = 0.f;
  if (r < rows)
    sum = dot16<T>(reinterpret_cast<const uint4*>(o)[t],
                   reinterpret_cast<const uint4*>(dout)[t]);
#pragma unroll
  for (int off = kTPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(~0u, sum, off);
  if (r < rows && t % kTPR == 0) {
    const long long bs = r / H;
    const long long b = bs / S;
    delta[(b * H + r % H) * S + bs % S] = sum;
  }
}

template <typename T, int HD>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  const long long threads = rows * (HD * (long long)sizeof(T) / 16);
  delta_kernel<T, HD>
      <<<(unsigned)((threads + kDeltaThreads - 1) / kDeltaThreads),
         kDeltaThreads, 0, stream>>>(static_cast<const T*>(o),
                                     static_cast<const T*>(dout), delta, S, H,
                                     rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta_hd(int hd, const void* o, const void* dout, float* delta,
                    int B, int S, int H, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_delta<T, 8>(o, dout, delta, B, S, H, s);
    case 16: return launch_delta<T, 16>(o, dout, delta, B, S, H, s);
    case 32: return launch_delta<T, 32>(o, dout, delta, B, S, H, s);
    case 64: return launch_delta<T, 64>(o, dout, delta, B, S, H, s);
    case 128: return launch_delta<T, 128>(o, dout, delta, B, S, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- 2, 3 on the tensor cores (wgmma), bf16, hd 64 / 128 ---------------------

namespace tc {

using namespace hopper;

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kBQ = 64;       // query rows a tile
constexpr int kBK = 64;       // keys a warpgroup's tile (== kBQ: the
                              // diagonal of key tile i is query tile i)
constexpr int kStages = 2;    // ring depth

template <int HD>
__host__ __device__ constexpr int tile_bytes() {   // one Q, K, V or dO tile
  return kBQ * HD * 2;
}
// dK, dV: the K and V tiles, the ring's Q and dO tiles and 64 lse and 64
// delta values a stage, barriers, alignment
template <int HD>
constexpr int dkdv_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<HD>() + kStages * 2 * kBQ * 4 + 64 +
         1024;
}
// dQ: the Q and dO tiles, the K and V rings, barriers, alignment
template <int HD>
constexpr int dq_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<HD>() + 64 + 1024;
}

// a 64 x 64 fp32 accumulator as the A fragments (bf16) of four k16 steps:
// its n8 blocks 2t and 2t + 1 are step t
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(x[8 * t], x[8 * t + 1]);
    a[t][1] = pack_bf16(x[8 * t + 2], x[8 * t + 3]);
    a[t][2] = pack_bf16(x[8 * t + 4], x[8 * t + 5]);
    a[t][3] = pack_bf16(x[8 * t + 6], x[8 * t + 7]);
  }
}

// rows r and r + 8 (i = 0, 1) of a 64 x HD accumulator, times mul, as bf16
// into out's rows (row stride ld elements), where the row is below S
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           long long ld, const float* acc,
                                           int row_a, int S, float mul,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* p = out + row * ld + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

// 2. dK and dV of 64 keys of one (b, kv head), summed over its G query
// heads: one consumer warpgroup, whose warp owns 16 keys and this thread
// rows key_a and key_a + 8 of the accumulators, whose element 4 j + e is
// row key_a + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 (a query of
// S^T, a head dim of dK and dV); and one producer warp. At hd 128 the two
// accumulators beside S^T and dP^T take 192 fp32 registers a thread (252
// in all, no spill): one CTA an SM. A second consumer warpgroup sharing
// the (Q, dO) ring would need setmaxnreg and a producer warpgroup: a CTA
// of 288 threads is held to 168 registers a thread, and spills.
template <int HD>
__global__ void __launch_bounds__(kWG + 32, HD == 64 ? 2 : 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int S, int H, int G, float scale, float scale_log2,
               int causal) {
  constexpr int NS = kBQ / 8;   // n8 column blocks of S^T (queries)
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  // boxes must start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base;                     // one tile
  const uint32_t sv = sk + TB;                  // one tile
  const uint32_t sq = sv + TB;                  // kStages tiles
  const uint32_t sdo = sq + kStages * TB;       // kStages tiles
  const uint32_t sst = sdo + kStages * TB;      // kStages x 128 floats
  const uint32_t bar_kv = sst + kStages * 2 * kBQ * 4;  // K, V landed
  const uint32_t bar_f = bar_kv + 8;            // stage st filled
  const uint32_t bar_e = bar_f + 8 * kStages;   // stage st released
  // a stage's 64 lse (in base 2; +inf past S) and 64 delta values
  float* stats = reinterpret_cast<float*>(smem_raw + (sst - raw));

  const int KH = H / G;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  // the first key tiles see the most query tiles and start first
  const int kt = blockIdx.y, k0 = kt * kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt0 = causal ? kt : 0;
  const int nq = (S + kBQ - 1) / kBQ - qt0;
  const int n_it = G * nq;   // (head, query tile) pairs, heads outer

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_f + 8 * st, 32);   // the producer warp's 32 lanes
      mbar_init(bar_e + 8 * st, kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * TB);
      load_tile<HD>(sk, &map_k, bar_kv, k0, kh, b);
      load_tile<HD>(sv, &map_v, bar_kv, k0, kh, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages, round = it / kStages;
      const int h = kh * G + it / nq, q0 = (qt0 + it % nq) * kBQ;
      if (round > 0) mbar_wait(bar_e + 8 * st, (round - 1) & 1);
      const long long at = ((long long)b * H + h) * S;
      float* stage = stats + st * 2 * kBQ;
      for (int r = lane; r < kBQ; r += 32) {
        const int row = q0 + r;
        stage[r] = row < S ? lse[at + row] * kLog2e : INFINITY;
        stage[kBQ + r] = row < S ? delta[at + row] : 0.f;
      }
      // each lane's arrival releases its own stores
      if (lane == 0) {
        mbar_expect_tx(bar_f + 8 * st, 2 * TB);
        load_tile<HD>(sq + st * TB, &map_q, bar_f + 8 * st, q0, h, b);
        load_tile<HD>(sdo + st * TB, &map_do, bar_f + 8 * st, q0, h, b);
      } else {
        mbar_arrive(bar_f + 8 * st);
      }
    }
    return;
  }

  const int key_a = k0 + warp * 16 + (lane >> 2);
  float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, parity = (it / kStages) & 1;
    const int q0 = (qt0 + it % nq) * kBQ;
    const uint32_t sqs = sq + st * TB, sdos = sdo + st * TB;
    mbar_wait(bar_f + 8 * st, parity);
    float s[NS * 4], dp[NS * 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major(sk, kk), desc_k_major(sqs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k_major(sv, kk), desc_k_major(sdos, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta), the lse
    // and delta of each column's query; the diagonal tile masks the keys
    // after their query
    const float* stage = stats + st * 2 * kBQ;
    const bool diag = causal && q0 == k0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(stage + c);
      const float2 d2 = *reinterpret_cast<const float2*>(stage + kBQ + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * j + e] * scale_log2 - (e & 1 ? l2.y : l2.x));
        if (diag && q0 + c + (e & 1) < key_a + (e >> 1) * 8) p = 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - (e & 1 ? d2.y : d2.x));
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      RS<HD>::run(acc_dv, pa[t], desc_mn_major(sdos, t));
#pragma unroll
    for (int t = 0; t < 4; ++t)
      RS<HD>::run(acc_dk, da[t], desc_mn_major(sqs, t));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(bar_e + 8 * st);   // this thread is done with stage st
  }

  const long long at = ((long long)b * S * KH + kh) * HD;
  store_rows<HD>(dk + at, (long long)KH * HD, acc_dk, key_a, S, scale, lane);
  store_rows<HD>(dv + at, (long long)KH * HD, acc_dv, key_a, S, 1.f, lane);
}

// 3. dQ of 64 query rows of one (b, h): the consumer warpgroup's warp owns
// 16 rows, this thread rows row_a and row_a + 8; K and V tiles stream
// through a two-stage ring as in K4
template <int HD>
__global__ void __launch_bounds__(kWG + 32, 2)
dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int S, int H, int G, float scale,
             float scale_log2, int causal) {
  constexpr int NS = kBK / 8;   // n8 column blocks of S (keys)
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                     // one tile
  const uint32_t sdo = sq + TB;                 // one tile
  const uint32_t sk = sdo + TB;                 // kStages tiles
  const uint32_t sv = sk + kStages * TB;        // kStages tiles
  const uint32_t bar_q = sv + kStages * TB;     // Q and dO landed
  const uint32_t bar_k = bar_q + 8;             // K of stage st landed
  const uint32_t bar_v = bar_k + 8 * kStages;   // V of stage st landed
  const uint32_t bar_e = bar_v + 8 * kStages;   // stage st released

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  // the last query tiles (the most key tiles under the causal mask) first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, qt + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp: one thread issues
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * TB);
      load_tile<HD>(sq, &map_q, bar_q, q0, h, b);
      load_tile<HD>(sdo, &map_do, bar_q, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(bar_e + 8 * st, (round - 1) & 1);
        mbar_expect_tx(bar_k + 8 * st, TB);
        load_tile<HD>(sk + st * TB, &map_k, bar_k + 8 * st, kt * kBK, kh, b);
        mbar_expect_tx(bar_v + 8 * st, TB);
        load_tile<HD>(sv + st * TB, &map_v, bar_v + 8 * st, kt * kBK, kh, b);
      }
    }
    return;
  }

  const int row_a = q0 + warp * 16 + (lane >> 2);
  const long long at = ((long long)b * H + h) * S;
  float l2[2], dl[2];   // this thread's rows' lse (base 2) and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    l2[i] = row < S ? lse[at + row] * kLog2e : 0.f;
    dl[i] = row < S ? delta[at + row] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages, parity = (kt / kStages) & 1;
    const uint32_t sks = sk + st * TB, svs = sv + st * TB;
    float s[NS * 4], dp[NS * 4];
    mbar_wait(bar_k + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major(sq, kk), desc_k_major(sks, kk), kk > 0);
    wgmma_commit();
    mbar_wait(bar_v + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k_major(sdo, kk), desc_k_major(svs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S * scale - lse), dS = P (dP - delta); the diagonal tile and
    // a ragged last tile mask their keys
    const int k0 = kt * kBK;
    const bool masked = (causal && kt == qt) || k0 + kBK > S;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * j + e] * scale_log2 - l2[e >> 1]);
        if (masked) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
      }
    uint32_t da[4][4];
    pack_a(dp, da);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) RS<HD>::run(acc, da[t], desc_mn_major(sks, t));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * st);   // this thread is done with stage st
  }

  store_rows<HD>(dq + ((long long)b * S * H + h) * HD, (long long)H * HD, acc,
                 row_a, S, scale, lane);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int S, int H, int G, Strides qs, Strides ks,
           Strides vs, int causal, cudaStream_t stream) {
  const Strides gs{(long long)S * H * HD, (long long)H * HD, HD};
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, S, H, HD, qs) ||
      !make_map(&mk, k, B, S, H / G, HD, ks) ||
      !make_map(&mv, v, B, S, H / G, HD, vs) ||
      !make_map(&mdo, dout, B, S, H, HD, gs))
    return (int)cudaErrorInvalidValue;
  static int allowed_dkdv = 48 * 1024, allowed_dq = 48 * 1024;
  constexpr int smem_dkdv = dkdv_smem_bytes<HD>();
  constexpr int smem_dq = dq_smem_bytes<HD>();
  auto k_dkdv = dkdv_tc_kernel<HD>;
  auto k_dq = dq_tc_kernel<HD>;
  cudaError_t err = allow_smem(k_dkdv, smem_dkdv, allowed_dkdv);
  if (err == cudaSuccess) err = allow_smem(k_dq, smem_dq, allowed_dq);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const float scale_log2 = scale * kLog2e;
  __nv_bfloat16* tdk = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* tdv = static_cast<__nv_bfloat16*>(dv);
  k_dkdv<<<dim3((unsigned)(B * (H / G)), (unsigned)((S + kBK - 1) / kBK)),
           kWG + 32, smem_dkdv, stream>>>(
      mq, mk, mv, mdo, lse, delta, tdk, tdv, S, H, G, scale, scale_log2,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_dq<<<dim3((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ)), kWG + 32,
         smem_dq, stream>>>(mq, mk, mv, mdo, lse, delta,
                            static_cast<__nv_bfloat16*>(dq), S, H, G, scale,
                            scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// -- 2, 3 on the CUDA cores (simt), fp32 products, any dtype and head dim -----

namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile (== kBQ: the diagonal
                                   // of q-tile i is k-tile i)
constexpr int kLDP = kBK + 1;      // padded row of a probability tile

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
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int S, int H, int G, Strides qs, Strides ks,
           Strides vs, int causal, cudaStream_t stream) {
  static int allowed_dkdv = 48 * 1024, allowed_dq = 48 * 1024;
  const int smem_dkdv = smem_bytes<HD>(4, 2);
  const int smem_dq = smem_bytes<HD>(4, 1);
  auto k_dkdv = dkdv_kernel<T, HD>;
  auto k_dq = dq_kernel<T, HD>;
  cudaError_t err = allow_smem(k_dkdv, smem_dkdv, allowed_dkdv);
  if (err == cudaSuccess) err = allow_smem(k_dq, smem_dq, allowed_dq);
  if (err != cudaSuccess) return (int)err;

  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / sqrt((double)HD));
  const unsigned n_q = (unsigned)((S + kBQ - 1) / kBQ);
  const unsigned n_k = (unsigned)((S + kBK - 1) / kBK);

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
              const void* dout, const float* lse, const float* delta,
              void* dq, void* dk, void* dv, int B, int S, int H, int G,
              Strides qs, Strides ks, Strides vs, int causal,
              cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, G,
                          qs, ks, vs, causal, s);
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                           G, qs, ks, vs, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                           G, qs, ks, vs, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                           G, qs, ks, vs, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                            G, qs, ks, vs, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

}  // namespace

extern "C" {

const char* fab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. q, o, dO and
// dq have H heads, k, v, dk and dv KH, with H % KH == 0. o and dO are
// contiguous and start on 16 bytes. lse is the fp32 (B, H, S) log-sum-exp
// that K4 wrote for the same q, k, v. scratch holds B * H * S floats (each
// row's delta). *route is set to the route taken: 1 = tensor cores (tc),
// 0 = CUDA cores (simt).
int fab_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            int B, int S, int H, int KH, int hd,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            int causal, int dtype, void* scratch, int* route,
                            void* stream) {
  if (KH <= 0 || H % KH != 0 || lse == nullptr || (dtype != 0 && dtype != 1)
      || !aligned16(o) || !aligned16(dout))
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* delta = static_cast<float*>(scratch);
  *route = dtype == 1 && (hd == 64 || hd == 128) && rows_aligned(q, qs) &&
           rows_aligned(k, ks) && rows_aligned(v, vs);
  int err = dtype == 0
                ? launch_delta_hd<float>(hd, o, dout, delta, B, S, H, s)
                : launch_delta_hd<__nv_bfloat16>(hd, o, dout, delta, B, S,
                                                 H, s);
  if (err != 0) return err;
  if (*route) {
    if (hd == 64)
      return tc::launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                            G, qs, ks, vs, causal, s);
    return tc::launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, G,
                           qs, ks, vs, causal, s);
  }
  if (dtype == 0)
    return simt::launch_hd<float>(hd, q, k, v, dout, lse, delta, dq, dk, dv,
                                  B, S, H, G, qs, ks, vs, causal, s);
  return simt::launch_hd<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dq,
                                        dk, dv, B, S, H, G, qs, ks, vs,
                                        causal, s);
}

}  // extern "C"
