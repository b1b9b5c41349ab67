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
// as in the reference.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head_dim stride is 1
};

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

// -- tc: tensor cores (wgmma), bf16, hd 64 / 128 -----------------------------

namespace tc {

constexpr int kWG = 128;                     // threads of a warpgroup
constexpr int kBQ = 64;                      // q rows per CTA
constexpr int kBK = 64;                      // keys per tile (== kBQ: the
                                             // diagonal tile of q-tile i is
                                             // k-tile i)
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kBox = 64 * 64 * 2;            // one TMA box: 64 rows of 64
                                             // bf16, one 128-byte swizzle
                                             // span a row

template <int HD>
__host__ __device__ constexpr int tile_bytes() {   // one Q, K or V tile
  return kBQ * HD * 2;
}
template <int HD, int NWG>
constexpr int smem_bytes() {   // NWG Q tiles, the K and V rings, barriers,
                               // alignment
  return (NWG + 2 * kStages) * tile_bytes<HD>() + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one 64 x 64 box at (head dim c0, row c1, head c2, batch c3) into dst,
// completing on bar; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// rows [s0, s0 + 64) of one (b, head) as HD / 64 boxes, kBox bytes apart
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int s0, int head,
                                          int b) {
#pragma unroll
  for (int half = 0; half < HD / 64; ++half)
    tma_load(dst + half * kBox, map, bar, half * 64, s0, head, b);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}
// K-major (Q, K): 8-row groups 1024 bytes apart; the k16 step kk is 32
// bytes into a row of box kk / 4
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 1, 64);
}
// MN-major (V, the transposed B of P V): keys [16 t, 16 t + 16) of the
// tile, 8-key groups 1024 bytes apart (SBO), boxes of 64 head dims kBox
// apart (LBO)
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int t) {
  return desc(tile + t * 16 * 128, kBox / 16, 64);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64, shared,
// MN-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) B (16 x 128, shared,
// MN-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD> struct PV;
template <> struct PV<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <> struct PV<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int NWG>
__global__ void __launch_bounds__(NWG * kWG + 32, NWG == 1 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, int S, int H, int G,
                float scale_log2, int causal) {
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
  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, qt + 1);

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

    // scale into the log2 domain; mask the diagonal and a ragged last tile
    const int k0 = kt * kBK;
    const bool masked = (causal && kt == qt) || k0 + kBK > S;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (masked) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) x = -INFINITY;
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
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow =
        o + (((long long)b * S + row) * H + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv[i],
                                acc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, HD) bf16 tensor with element strides st, read in boxes of
// 64 rows x 64 head dims with the 128-byte swizzle; rows past S read zeros
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
              int HD, Strides st) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NWG>
int launch_nwg(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, void* o, int B, int S, int H, int G,
               int causal, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  constexpr int smem = smem_bytes<HD, NWG>();
  auto kern = flash_tc_kernel<HD, NWG>;
  const cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H / NWG), (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, NWG * kWG + 32, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, G,
      (float)(1.4426950408889634 / sqrt((double)HD)), causal);
  return (int)cudaGetLastError();
}

// One CTA serves NWG query heads of one kv head, so each K/V tile it loads
// is read by NWG warpgroups: 3 when G is a multiple of 3, else 2 when it is
// even, else 1 (three warpgroups' registers fill an SM).
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int G, Strides qs, Strides ks, Strides vs,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, HD, qs) ||
      !make_map(&mk, k, B, S, H / G, HD, ks) ||
      !make_map(&mv, v, B, S, H / G, HD, vs))
    return (int)cudaErrorInvalidValue;
  if (G % 3 == 0)
    return launch_nwg<HD, 3>(mq, mk, mv, o, B, S, H, G, causal, stream);
  if (G % 2 == 0)
    return launch_nwg<HD, 2>(mq, mk, mv, o, B, S, H, G, causal, stream);
  return launch_nwg<HD, 1>(mq, mk, mv, o, B, S, H, G, causal, stream);
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
             const T* __restrict__ v, T* __restrict__ o, int S, int H, int G,
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

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  // the last q-tiles (the most k-tiles under the causal mask) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

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
           int H, int G, Strides qs, Strides ks, Strides vs, int causal,
           cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = flash_kernel<T, HD>;
  const cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, G, qs, ks, vs,
      (float)(1.0 / sqrt((double)HD)), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, int G, Strides qs, Strides ks, Strides vs,
              int causal, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// TMA needs the base and every stride of q, k and v on 16 bytes
bool rows_aligned(const void* p, Strides st) {
  return aligned16(p) && st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

extern "C" {

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. q and o have
// H heads, k and v KH, with H % KH == 0. *route is set to the route taken:
// 1 = tensor cores (tc), 0 = CUDA cores (simt).
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KH, int hd, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, int dtype, int causal,
                       int* route, void* stream) {
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = dtype == 1 && (hd == 64 || hd == 128) && rows_aligned(q, qs) &&
           rows_aligned(k, ks) && rows_aligned(v, vs);
  if (*route) {
    if (hd == 64)
      return tc::launch<64>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
    return tc::launch<128>(q, k, v, o, B, S, H, G, qs, ks, vs, causal, s);
  }
  if (dtype == 0)
    return simt::launch_hd<float>(hd, q, k, v, o, B, S, H, G, qs, ks, vs,
                                  causal, s);
  if (dtype == 1)
    return simt::launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, G, qs, ks,
                                          vs, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
