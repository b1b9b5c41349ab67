// K5: one new query token per sequence against a KV cache (flash-decode),
// hand-written for Hopper (sm_90a). Built by nvcc into a shared library
// with a plain C interface and loaded through ctypes
// (repro_torch/kernels/attention.py). The entry point launches on the
// stream it is given, allocates nothing (the caller passes the scratch),
// and returns the CUDA error of its launches (0 on success).
//
// Replaces repro/kernels/decode_attention.py decode_attention /
// _decode_kernel. The Pallas wrapper transposed the whole cache to
// (B*K, S, hd) before its grid walked the kv blocks of one sequence in
// order; here the (B, S, K, hd) cache is read in place with its strides (no
// copy, so a decode step does not rewrite the cache once per layer), and
// the sequence is split across CTAs. A call is two launches, through two
// entry points, so the host allocates the output while the split runs:
//
// * split: grid (B*K, n_split), n_split = ceil(S / 64) from the cache's S,
//   so the host never reads `length`. CTA (b, kv head, i) owns keys
//   [64 i, 64 i + 64); if that chunk starts at or past length[b] it returns
//   at once. Otherwise it copies its K and V rows into shared memory with
//   16-byte cp.async (rows past the length zero-filled, so stale cache rows
//   can never turn a zero probability into NaN), keeps them in the cache's
//   dtype, and scores the G = H / K query heads of its kv head against each
//   key in fp32 (a group of lanes splits hd, a shuffle reduces; the passes
//   over the keys are unrolled so their reductions overlap). P V splits the
//   keys among groups of threads that each own two head dims, and the
//   groups' sums meet in shared memory. It writes the chunk's max m_i, sum
//   l_i and unnormalised (G, hd) accumulator to the scratch
//   (B, K, n_split, G, hd + 2) fp32.
// * combine: one CTA per (b, kv head). A warp per head finds the max m over
//   the ceil(length / 64) partials and their weights exp(m_i - m) (kept in
//   shared memory) and the sum l; then every (head, dim) sums its weighted
//   partials, in a fixed order, divides by max(l, 1e-30) and writes q's
//   dtype. The fixed order makes the result deterministic; length 0 gives
//   zeros. Asked for (a non-null lse pointer), it also writes each head's
//   natural log-sum-exp of its scaled scores, m + log(l), to an fp32
//   (B, H) tensor (-inf at length 0): what a caller that split the cache
//   over ranks combines the ranks' outputs by. It is launched as a programmatic dependent of the split (Hopper's
//   griddepcontrol): its CTAs start while the split runs and wait for the
//   split's writes, so its launch latency is hidden.
//
// Bound: bytes. A step reads length*K*hd*2 cache elements per sequence and
// does 4*G flops per element read, far below the ~295 flop/byte the H100
// needs to be compute-bound, so the split spreads the read over the SMs:
// at the serve path's batch of 4, 8 kv heads and S = 1024 it launches 512
// CTAs on 132 SMs.
//
// length is clamped to [0, S]. q is (B, H, hd) and o a contiguous
// (B, H, hd) tensor, both of the caches' dtype; query head i attends
// through kv head i / G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;        // keys per split CTA

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void load2(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& x,
                                      float& y) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x = v.x;
  y = v.y;
}

struct Strides {
  long long b, s, h;   // elements; the head_dim stride is 1
};

template <typename T, int HD>
int split_smem_bytes(int G) {
  return 2 * kChunk * HD * (int)sizeof(T)          // K and V rows
         + (G * HD                                 // q
            + G * kChunk                           // scores
            + 2 * kThreads * G) * (int)sizeof(float);   // P V partials
}

// Raise a kernel's dynamic shared-memory limit once to what a launch needs
// (past the 48 KB default only for many query heads a kv head).
template <typename K>
cudaError_t allow_smem(K kern, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ length,
                    float* __restrict__ part, int S, int KH, int G,
                    int n_split, long long q_sb, long long q_sh, Strides ks,
                    Strides vs, int vec, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);          // elements in 16 bytes
  // scores: TPK lanes a key (enough that a pass covers at most the chunk),
  // EPT head dims a lane, KPP keys a pass
  constexpr int TPK_MIN = kThreads / kChunk > 1 ? kThreads / kChunk : 1;
  constexpr int TPK =
      HD / VEC < TPK_MIN ? TPK_MIN : HD / VEC > 32 ? 32 : HD / VEC;
  constexpr int EPT = HD / TPK;
  constexpr int KPP = kThreads / TPK;
  // P V: CP column pairs, KG groups of threads, KPG keys a group
  constexpr int CP = HD / 2, KG = kThreads / CP, KPG = kChunk / KG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kChunk * HD;
  float* sq = reinterpret_cast<float*>(sv + kChunk * HD);
  float* sp = sq + G * HD;
  float* red = sp + G * kChunk;   // (KG, G, HD) sums of P V

  // let the combine grid launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH, chunk = blockIdx.y;
  const int len = min(max(length[b], 0), S);
  const int k0 = chunk * kChunk;
  if (k0 >= len) return;
  const int n = min(kChunk, len - k0);
  const int tid = threadIdx.x;
  const T* kb = kc + b * ks.b + kh * ks.h + (long long)k0 * ks.s;
  const T* vb = vc + b * vs.b + kh * vs.h + (long long)k0 * vs.s;

  if (vec) {   // every row starts on 16 bytes
    for (int i = tid; i < kChunk * (HD / VEC); i += kThreads) {
      const int r = i / (HD / VEC), c = (i % (HD / VEC)) * VEC;
      const bool in = r < n;
      cp_async16(sk + r * HD + c, kb + (in ? r * ks.s : 0) + c, in ? 16 : 0);
      cp_async16(sv + r * HD + c, vb + (in ? r * vs.s : 0) + c, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = tid; i < kChunk * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = r < n;
      sk[i] = in ? kb[r * ks.s + d] : from_f32<T>(0.f);
      sv[i] = in ? vb[r * vs.s + d] : from_f32<T>(0.f);
    }
  }
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    sq[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
  }
  if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  {  // scores
    const int sub = tid % TPK, d0 = sub * EPT;
    for (int g = 0; g < G; ++g) {
      float qv[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) qv[e] = sq[g * HD + d0 + e];
#pragma unroll
      for (int pass = 0; pass < kChunk / KPP; ++pass) {
        const int c = pass * KPP + tid / TPK;
        const T* kr = sk + c * HD + d0;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; e += 2) {
          float x, y;
          load2(kr + e, x, y);
          s = fmaf(qv[e], x, fmaf(qv[e + 1], y, s));
        }
#pragma unroll
        for (int o = TPK / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(~0u, s, o);
        if (sub == 0) sp[g * kChunk + c] = c < n ? s * scale : -INFINITY;
      }
    }
  }
  __syncthreads();

  float* pb = part + (((long long)b * KH + kh) * n_split + chunk) * G *
                         (HD + 2);
  {  // the chunk's softmax: warp w takes heads w, w+4, ...; KPL keys a lane
    constexpr int KPL = kChunk / 32;
    const int w = tid / 32, lane = tid % 32;
    for (int g = w; g < G; g += kThreads / 32) {
      float x[KPL], m = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        x[j] = sp[g * kChunk + lane + 32 * j];
        m = fmaxf(m, x[j]);
      }
      m = warp_max(m);   // finite: the chunk's first key is in
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float pj = expf(x[j] - m);
        sp[g * kChunk + lane + 32 * j] = pj;
        l += pj;
      }
      l = warp_sum(l);
      if (lane == 0) {
        pb[g * (HD + 2) + HD] = m;
        pb[g * (HD + 2) + HD + 1] = l;
      }
    }
  }
  __syncthreads();

  {  // P V over all 64 rows (p is 0 and V zero-filled past n): thread
     // (kg, cp) sums keys [kg*KPG, (kg+1)*KPG) for head dims 2cp, 2cp+1
    const int cp = tid % CP, kg = tid / CP;
    for (int g = 0; g < G; ++g) {
      const float* pr = sp + g * kChunk + kg * KPG;
      const T* vr = sv + kg * KPG * HD + 2 * cp;
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int c = 0; c < KPG; ++c) {   // two chains, alternate keys
        float x, y;
        load2(vr + c * HD, x, y);
        if (c % 2 == 0) {
          a0 = fmaf(pr[c], x, a0);
          a1 = fmaf(pr[c], y, a1);
        } else {
          b0 = fmaf(pr[c], x, b0);
          b1 = fmaf(pr[c], y, b1);
        }
      }
      red[(kg * G + g) * HD + 2 * cp] = a0 + b0;
      red[(kg * G + g) * HD + 2 * cp + 1] = a1 + b1;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) a += red[kg * G * HD + i];
    pb[(i / HD) * (HD + 2) + i % HD] = a;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ length, T* __restrict__ o,
                      float* __restrict__ lse, int S, int KH, int G,
                      int n_split) {
  extern __shared__ float sw[];   // (n_split, G) weights, G inverse sums
  float* sinv = sw + n_split * G;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  // length was written before the split started, so it may be read before
  // the wait; the partials only after it
  const int len = min(max(length[b], 0), S);
  const int n = (len + kChunk - 1) / kChunk;
  const float* pb = part + ((long long)b * KH + kh) * n_split * G * (HD + 2);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = w; g < G; g += kThreads / 32) {
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32)
      m = fmaxf(m, pb[(c * G + g) * (HD + 2) + HD]);
    m = warp_max(m);
    float den = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float* pc = pb + (c * G + g) * (HD + 2);
      const float wt = expf(pc[HD] - m);
      sw[c * G + g] = wt;
      den = fmaf(wt, pc[HD + 1], den);
    }
    den = warp_sum(den);
    if (lane == 0) sinv[g] = n ? 1.f / fmaxf(den, 1e-30f) : 0.f;
    if (lse != nullptr && lane == 0)
      lse[(long long)b * KH * G + kh * G + g] = n ? m + logf(den) : -INFINITY;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c)
      a = fmaf(sw[c * G + g], pb[(c * G + g) * (HD + 2) + d], a);
    o[((long long)b * KH * G + kh * G + g) * HD + d] = from_f32<T>(a * sinv[g]);
  }
}

struct SplitArgs {
  const void *q, *kc, *vc;
  const int* length;
  void* part;
  int B, S, KH, G, n_split;
  long long q_sb, q_sh;
  Strides ks, vs;
  int vec;
};

template <typename T, int HD>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = split_smem_bytes<T, HD>(a.G);
  auto split = decode_split_kernel<T, HD>;
  const cudaError_t err = allow_smem(split, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3((unsigned)(a.B * a.KH), (unsigned)a.n_split), kThreads, smem,
          stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
                    static_cast<const T*>(a.vc), a.length,
                    static_cast<float*>(a.part), a.S, a.KH, a.G, a.n_split,
                    a.q_sb, a.q_sh, a.ks, a.vs, a.vec,
                    (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_combine(const void* part, const int* length, void* o, float* lse,
                   int B, int S, int KH, int G, int n_split,
                   cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = (n_split + 1) * G * (int)sizeof(float);
  auto combine = decode_combine_kernel<T, HD>;
  const cudaError_t err = allow_smem(combine, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * KH));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, combine,
                                 static_cast<const float*>(part), length,
                                 static_cast<T*>(o), lse, S, KH, G, n_split);
}

// fn<T, HD>() for a runtime dtype code (0 = float32, 1 = bfloat16) and hd
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int hd, Args&&... args) {
#define DA_HD(T)                                        \
  switch (hd) {                                         \
    case 8: return F<T, 8>::run(args...);               \
    case 16: return F<T, 16>::run(args...);             \
    case 32: return F<T, 32>::run(args...);             \
    case 64: return F<T, 64>::run(args...);             \
    case 128: return F<T, 128>::run(args...);           \
    default: return (int)cudaErrorInvalidValue;         \
  }
  if (dtype == 0) DA_HD(float)
  if (dtype == 1) DA_HD(__nv_bfloat16)
#undef DA_HD
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
struct Split {
  static int run(const SplitArgs& a, cudaStream_t s) {
    return launch_split<T, HD>(a, s);
  }
};
template <typename T, int HD>
struct Combine {
  static int run(const void* part, const int* length, void* o, float* lse,
                 int B, int S, int KH, int G, int n_split, cudaStream_t s) {
    return launch_combine<T, HD>(part, length, o, lse, B, S, KH, G, n_split,
                                 s);
  }
};

bool rows_aligned(const void* p, Strides st, int vec_elems) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         st.b % vec_elems == 0 && st.s % vec_elems == 0 &&
         st.h % vec_elems == 0;
}

// The packed arguments of da_split and da_combine, in this order. Pointers
// and the stream are addresses; strides are in elements; dtype 0 = float32,
// 1 = bfloat16; part is the fp32 scratch described above, out the
// (B, KH * G, hd) output of the dtype and lse 0 or the fp32 (B, KH * G)
// log-sum-exp.
enum Arg {
  kQ, kKCache, kVCache, kLength, kPart, kOut, kB, kS, kKH, kG, kHD, kNSplit,
  kQsb, kQsh, kKsb, kKss, kKsh, kVsb, kVss, kVsh, kDtype, kStream, kLse,
  kNumArgs
};

template <typename P>
P* ptr(const long long* a, int i) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(a[i]));
}

}  // namespace

extern "C" {

const char* da_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Keys per split CTA: the wrapper sizes the scratch (B, KH, n_split, G,
// hd + 2) fp32 with n_split = ceil(S / da_chunk()).
int da_chunk() { return kChunk; }

// da_split and da_combine take their arguments packed in one int64 array
// (one ctypes argument instead of twenty-three), in the order of ``enum Arg``
// above.
int da_num_args() { return kNumArgs; }

// The split launch (out is not read).
int da_split(const long long* a) {
  const int S = (int)a[kS], n_split = (int)a[kNSplit], dtype = (int)a[kDtype];
  if (n_split < 1 || (long long)n_split * kChunk < S)
    return (int)cudaErrorInvalidValue;
  const Strides ks{a[kKsb], a[kKss], a[kKsh]}, vs{a[kVsb], a[kVss], a[kVsh]};
  const int ve = dtype == 0 ? 4 : 8;   // elements in 16 bytes
  const void* kc = ptr<const void>(a, kKCache);
  const void* vc = ptr<const void>(a, kVCache);
  const SplitArgs sa{ptr<const void>(a, kQ), kc, vc, ptr<const int>(a, kLength),
                     ptr<void>(a, kPart), (int)a[kB], S, (int)a[kKH],
                     (int)a[kG], n_split, a[kQsb], a[kQsh], ks, vs,
                     rows_aligned(kc, ks, ve) && rows_aligned(vc, vs, ve)};
  return dispatch<Split>(dtype, (int)a[kHD], sa,
                         ptr<CUstream_st>(a, kStream));
}

// The combine launch, on the same stream after da_split with the same
// arguments.
int da_combine(const long long* a) {
  return dispatch<Combine>((int)a[kDtype], (int)a[kHD],
                           ptr<const void>(a, kPart),
                           ptr<const int>(a, kLength), ptr<void>(a, kOut),
                           ptr<float>(a, kLse), (int)a[kB], (int)a[kS],
                           (int)a[kKH], (int)a[kG],
                           (int)a[kNSplit], ptr<CUstream_st>(a, kStream));
}

}  // extern "C"
