// K4: causal (or full) softmax attention, hand-written for Hopper (sm_90a).
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (repro_torch/kernels/attention.py). The entry point
// launches on the stream it is given, allocates nothing, and returns the
// CUDA error of its launch (0 on success).
//
// Replaces repro/kernels/flash_attention.py flash_attention / _flash_kernel
// (the Pallas kernel's grid walked the k blocks of one q block in order,
// carrying m, l and acc in VMEM scratch). Here one CTA owns a q-tile of one
// (b, h) (on the tensor cores, of up to three heads) and loops over the
// k-tiles itself. Tiles fully above the diagonal
// are never loaded (causal), and a ragged last tile (S not a multiple of
// the tile) is zero-filled and masked, so any S works. Key 0 lies in the
// first tile, so no row's running max is still -inf after it.
//
// Queries and keys: q has S_q rows and k, v S_k; query row i sits at
// position q_off + i, so under the causal mask it sees keys 0 .. q_off + i
// (a rank's block of a sequence against the whole sequence's keys, the
// sequence-parallel attention; the default call has S_q = S_k, q_off = 0).
// A q-tile loads the key tiles up to the one holding its last row's
// position, and masks the one or two tiles the diagonal crosses.
//
// GQA: q has H heads, k and v K heads with H % K == 0; query head h reads
// kv head h / (H / K) in place (the reference's jnp.repeat(k, H / K,
// axis=2) order), so the caller expands nothing.
//
// Bound: at the serve path's prefill shape (B=4, S=1024, H=24, K=8,
// hd=128, bf16, causal) the 2*B*H*S^2*hd causal FLOPs take 0.026 ms at the
// tensor cores' 989 TFLOP/s and the (2*B*S*H + 2*B*S*K)*hd*2 bytes 0.020
// ms at 3.35 TB/s: operations, by a little.
//
// Two routes, chosen on the host by dtype, head_dim and alignment (never
// by a failure):
//
// * tc (bf16, hd 64 or 128, 16-byte aligned rows): FlashAttention on
//   Hopper's warpgroup tensor-core instructions (wgmma, bf16 in, fp32
//   accumulate), fed by the Tensor Memory Accelerator. A CTA serves one
//   64-row q-tile of NWG query heads that share a kv head (NWG = 3 when
//   G = H / K is a multiple of 3, else 2 when G is even, else 1), so every
//   K/V tile it loads is read by NWG consumer warpgroups, one a head (16
//   rows a warp), and one producer warp, one of whose threads issues every
//   TMA load: the NWG Q tiles once, then K and V tiles of 64 keys into a
//   two-stage shared-memory ring, each stage with "full" mbarriers (K and V
//   apart, so Q K^T starts before V lands) and an "empty" mbarrier the
//   consumers arrive on when done. TMA reads q, k, v through 4-D tensor
//   maps (head dim, S, heads, B) at their strides, zero-fills rows past S,
//   and writes 64 x 64 boxes with the 128-byte swizzle that wgmma's
//   shared-memory descriptors read.
//   S = Q K^T is wgmma m64n64k16 with Q and K from shared memory
//   (K-major). The online softmax runs on the accumulator registers (row
//   max and sum across the quad of lanes that share a row, exp2f with the
//   scale folded into log2 e). P, packed to bf16 in registers, is the A
//   operand of O += P V, wgmma m64n{hd}k16 with V from shared memory as
//   the transposed (MN-major) B, so P never touches shared memory. Only
//   the diagonal tile and a ragged last tile are masked.
// * simt (fp32, other head dims, or unaligned views): both products in fp32
//   on the CUDA cores from tiles converted into padded shared memory. fp32
//   stays off the tensor cores because TF32 cannot meet the reference's
//   2e-5 fp32 tolerance.
//
// q, k, v are read with their (B, S, heads, hd) strides (the last dimension
// contiguous), so the caller makes no transposed copy; o is a contiguous
// (B, S, H, hd) tensor of the input dtype. Output = acc / max(l, 1e-30),
// as in the reference. Asked for (a non-null pointer: the forward of a
// training step), each route also writes every query row's natural
// log-sum-exp, m + log(l), to an fp32 (B, H, S) tensor that K4b reads in
// place of recomputing it; serving passes null.
//
// The TMA, descriptor and wgmma helpers are in hopper.cuh, shared with
// K4b.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using hopper::allow_smem;
using hopper::rows_aligned;
using hopper::Strides;

// -- tc: tensor cores (wgmma), bf16, hd 64 / 128 -----------------------------

namespace tc {

using namespace hopper;

constexpr int kWG = 128;                     // threads of a warpgroup
constexpr int kBQ = 64;                      // q rows per CTA
constexpr int kBK = 64;                      // keys per tile (== kBQ: the
                                             // diagonal tile of q-tile i is
                                             // k-tile i)
constexpr int kStages = 2;                   // K/V ring depth

template <int HD>
__host__ __device__ constexpr int tile_bytes() {   // one Q, K or V tile
  return kBQ * HD * 2;
}
template <int HD, int NWG>
constexpr int smem_bytes() {   // NWG Q tiles, the K and V rings, barriers,
                               // alignment
  return (NWG + 2 * kStages) * tile_bytes<HD>() + 64 + 1024;
}

// O += P V: wgmma with P as the register A operand
template <int HD>
using PV = RS<HD>;

// kLse: also write each row's log-sum-exp (the training forward). The
// serve path's instantiation (lse null) has no trace of the write: as a
// runtime branch it cost the serve kernel some 7 % of its time on an
// H100, its registers laid out anew.
template <int HD, int NWG, bool kLse>
__global__ void __launch_bounds__(NWG * kWG + 32, NWG == 1 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Sk, int q_off, int H, int G, float scale_log2,
                int causal) {
  constexpr int NS = kBK / 8;    // n8 column blocks of S (keys)
  constexpr int NO = HD / 8;     // n8 column blocks of O (head dims)
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  // boxes must start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                    // NWG tiles
  const uint32_t sk = sq + NWG * TB;           // kStages tiles
  const uint32_t sv = sk + kStages * TB;       // kStages tiles
  const uint32_t bars = sv + kStages * TB;     // 8 bytes each:
  const uint32_t bar_q = bars;                 //   Q landed
  const uint32_t bar_k = bars + 8;             //   K of stage st landed
  const uint32_t bar_v = bar_k + 8 * kStages;  //   V of stage st landed
  const uint32_t bar_e = bar_v + 8 * kStages;  //   stage st released

  // this CTA: batch row b, kv head kh and NWG of the G query heads that
  // read it, from h0 on; warpgroup w takes query head h0 + w
  const int KH = H / G, groups = G / NWG;
  const int b = blockIdx.x / (KH * groups);
  const int kh = blockIdx.x % (KH * groups) / groups;
  const int h0 = kh * G + blockIdx.x % groups * NWG;
  // the last q-tiles (the most k-tiles under the causal mask) start first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // keys up to the tile of this q-tile's last row's position, q_off + q0 +
  // kBQ - 1, under the causal mask
  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q_off + q0 + kBQ - 1) / kBK + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, NWG * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {   // the producer warp: one thread issues
    if (lane == 0) {
      mbar_expect_tx(bar_q, NWG * TB);
      for (int w = 0; w < NWG; ++w)
        load_tile<HD>(sq + w * TB, &map_q, bar_q, q0, h0 + w, b);
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

  // consumers: warpgroup wg computes query head h; its warp w owns q rows
  // 16 w .. 16 w + 15, this thread rows r and r + 8 (the accumulator
  // layout)
  const int wg = warp / 4, h = h0 + wg;
  const uint32_t sqw = sq + wg * TB;
  const int row_a = q0 + (warp % 4) * 16 + (lane >> 2);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages, parity = (kt / kStages) & 1;
    mbar_wait(bar_k + 8 * st, parity);

    // S = Q K^T (64 x 64), accumulator element 4 j + e is row
    // row_a + 8 (e / 2), key 8 j + 2 (lane % 4) + e % 2
    float s[NS * 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major(sqw, kk),
                   desc_k_major(sk + st * TB, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale into the log2 domain; mask the tiles the diagonal crosses (one,
    // or two when q_off is not a multiple of the tile) and a ragged last
    // tile
    const int k0 = kt * kBK;
    const bool masked =
        (causal && k0 + kBK - 1 > q_off + q0) || k0 + kBK > Sk;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (masked) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= Sk || (causal && col > q_off + row)) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }

    // online softmax in registers: a row lives in the four lanes of a quad
    float alpha[2], m_sub[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      m_sub[i] = mx == -INFINITY ? 0.f : mx;
      alpha[i] = exp2f(m_run[i] - m_sub[i]);
      m_run[i] = mx;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m_sub[e >> 1]);
        s[4 * j + e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V: P's accumulator blocks are, pairwise, the A fragments of a
    // k16 step, in registers
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      pf[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
      pf[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pf[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pf[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
    mbar_wait(bar_v + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t)
      PV<HD>::run(acc, pf[t], desc_mn_major(sv + st * TB, t));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * st);   // this thread is done with stage st
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
    // the row's natural log-sum-exp, for K4b: m and l are in base 2
    const int row = row_a + i * 8;
    if (kLse && (lane & 3) == 0 && row < Sq)
      lse[((long long)b * H + h) * Sq + row] =
          (m_run[i] + log2f(l)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow =
        o + (((long long)b * Sq + row) * H + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv[i],
                                acc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// Seq holds the query rows, the keys and the queries' position offset
struct Seq {
  int q, k, off;
};

template <int HD, int NWG, bool kLse>
int launch_nwg(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, void* o, float* lse, int B, Seq sq,
               int H, int G, int causal, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  constexpr int smem = smem_bytes<HD, NWG>();
  auto kern = flash_tc_kernel<HD, NWG, kLse>;
  const cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H / NWG), (unsigned)((sq.q + kBQ - 1) / kBQ));
  kern<<<grid, NWG * kWG + 32, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, sq.q, sq.k, sq.off, H,
      G, (float)(1.4426950408889634 / sqrt((double)HD)), causal);
  return (int)cudaGetLastError();
}

template <int HD, int NWG>
int launch_lse(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, void* o, float* lse, int B, Seq sq,
               int H, int G, int causal, cudaStream_t stream) {
  if (lse != nullptr)
    return launch_nwg<HD, NWG, true>(mq, mk, mv, o, lse, B, sq, H, G, causal,
                                     stream);
  return launch_nwg<HD, NWG, false>(mq, mk, mv, o, lse, B, sq, H, G, causal,
                                    stream);
}

// One CTA serves NWG query heads of one kv head, so each K/V tile it loads
// is read by NWG warpgroups: 3 when G is a multiple of 3, else 2 when it is
// even, else 1 (three warpgroups' registers fill an SM).
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, Seq sq, int H, int G, Strides qs, Strides ks, Strides vs,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, sq.q, H, HD, qs) ||
      !make_map(&mk, k, B, sq.k, H / G, HD, ks) ||
      !make_map(&mv, v, B, sq.k, H / G, HD, vs))
    return (int)cudaErrorInvalidValue;
  if (G % 3 == 0)
    return launch_lse<HD, 3>(mq, mk, mv, o, lse, B, sq, H, G, causal,
                                 stream);
  if (G % 2 == 0)
    return launch_lse<HD, 2>(mq, mk, mv, o, lse, B, sq, H, G, causal,
                                 stream);
  return launch_lse<HD, 1>(mq, mk, mv, o, lse, B, sq, H, G, causal,
                                 stream);
}

}  // namespace tc

// -- simt: CUDA cores, fp32 products, any dtype and head dim -------------------

namespace simt {

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

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1)      // Q tile, padded rows
         + kBK * (HD + 1)    // K tile, padded rows
         + kBK * HD          // V tile
         + kBQ * kLDP        // scores, then probabilities
         + 3 * kBQ;          // running max, running sum, rescale factor
}

// Q, K and V tiles are converted to fp32 in shared memory once per tile,
// rows padded by one float so the column reads of the score product hit
// 32 distinct banks; each thread keeps an 8 x ceil(hd/16) block of the
// accumulator in registers.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int q_off, int H,
             int G, Strides qs, Strides ks, Strides vs, float scale,
             int causal) {
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

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  // the last q-tiles (the most k-tiles under the causal mask) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    sq[r * LD + d] = row < Sq ? to_f32(qb[row * qs.s + d]) : 0.f;
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

  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q_off + q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k0 + r;
      const bool in = row < Sk;    // rows past Sk: zeros, never NaN garbage
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
          const bool ok = ki < Sk && (!causal || ki <= q_off + qi);
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
    if (row >= Sq) continue;
    const float l = fmaxf(sl[r], 1e-30f);
    T* orow = o + (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) orow[d] = from_f32<T>(acc[i][j] / l);
    }
  }
  // each row's log-sum-exp, for K4b
  if (lse != nullptr)
    for (int r = tid; r < kBQ; r += kThreads)
      if (q0 + r < Sq)
        lse[((long long)b * H + h) * Sq + q0 + r] = sm[r] + logf(sl[r]);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, tc::Seq sq, int H, int G, Strides qs, Strides ks,
           Strides vs, int causal, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = flash_kernel<T, HD>;
  const cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((sq.q + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq.q, sq.k, sq.off,
      H, G, qs, ks, vs, (float)(1.0 / sqrt((double)HD)), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              float* lse, int B, tc::Seq sq, int H, int G, Strides qs,
              Strides ks, Strides vs, int causal, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                               s);
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                               s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                               s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                               s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                               s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

}  // namespace

extern "C" {

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. q and o have
// Sq rows and H heads, k and v Sk rows and KH heads, with H % KH == 0 and
// Sk >= 1. Query row i sits at position q_off + i (q_off >= 0), so under
// the causal mask it sees keys 0 .. q_off + i: a rank's block of queries
// against the whole sequence's keys. lse is null or a contiguous fp32
// (B, H, Sq) tensor that gets each query row's natural log-sum-exp of its
// scaled, masked scores (o is the same either way). *route is set to the
// route taken: 1 = tensor cores (tc), 0 = CUDA cores (simt).
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Sk, int H, int KH,
                       int hd, int q_off, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, int dtype, int causal, int* route,
                       void* stream) {
  if (KH <= 0 || H % KH != 0 || Sk < 1 || q_off < 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const tc::Seq sq{Sq, Sk, q_off};
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = dtype == 1 && (hd == 64 || hd == 128) && rows_aligned(q, qs) &&
           rows_aligned(k, ks) && rows_aligned(v, vs);
  if (*route) {
    if (hd == 64)
      return tc::launch<64>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                            s);
    return tc::launch<128>(q, k, v, o, lse, B, sq, H, G, qs, ks, vs, causal,
                           s);
  }
  if (dtype == 0)
    return simt::launch_hd<float>(hd, q, k, v, o, lse, B, sq, H, G, qs, ks,
                                  vs, causal, s);
  if (dtype == 1)
    return simt::launch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, sq, H, G,
                                          qs, ks, vs, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
