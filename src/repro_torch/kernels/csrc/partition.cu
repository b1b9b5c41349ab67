// Partition kernels of the analytics data plane, hand-written for Hopper
// (sm_90a). Built by nvcc into a shared library with a plain C interface
// and loaded through ctypes (repro_torch/kernels/partition.py). Every entry
// point launches on the stream it is given, allocates nothing, and returns
// the CUDA error of its launches (0 on success).
//
// K1  rt_partition_histogram  replaces repro/kernels/partition.py
//     partition_histogram / _hist_kernel (one-hot block histogram).
//     Bound: bytes. It reads N int32 ids once and writes P counters, so
//     at 3.35 TB/s it is a pure streaming pass. Design: one block per row
//     tile keeps the tile's histogram in shared memory with integer
//     atomicAdd (exact, so the result does not depend on the order of the
//     atomics), then either stores it as that tile's row (per-tile mode,
//     K2's input) or adds it to the global totals once per non-empty bin
//     (totals mode, large tiles so the global atomics stay few).
//
// K2  rt_partition_scatter  replaces repro/kernels/partition.py
//     partition_scatter / _scatter_kernel (stable grouping by id).
//     Bound: bytes. It reads ids and rows once and writes rows once; the
//     per-tile histogram and the two scans touch nb*P words. Design: the
//     TPU kernel ran its grid in order and carried nothing; here tiles run
//     in any order, so the bases come first: K1 per 1024-row tile, an
//     exclusive scan down each partition's column of tile counts, and an
//     exclusive scan of the partition totals. The scatter then ranks each
//     row inside its tile stably without atomics: __match_any_sync finds
//     the lanes of the warp that share the row's id, a popcount of the
//     lower lanes is the rank in the warp, and a per-(warp, partition)
//     count table in shared memory, scanned over the 32 warps, places the
//     warp after the earlier warps of the tile.
//
// K3  rt_fused_probe  replaces repro/kernels/partition.py
//     fused_probe / _fused_probe_kernel (one-hot equality probe).
//     Bound: operations. N*M key compares against N*12 + M*12 bytes; at
//     the main path's shapes (M up to 16 Ki) the compares dominate. Design:
//     the whole padded build side (key, cat, valid: 12 bytes a row) is
//     staged once per block in shared memory, and one thread per probe row
//     scans it; every lane of a warp reads the same build row, which
//     shared memory broadcasts without bank conflicts. The build side
//     must fit one block's 227 KB (kFusedSmemBytes): 16 Ki rows at the
//     power-of-two shape classes the dispatcher pads to.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kTotalsTile = kHistThreads * 64;   // rows per block, totals mode
constexpr int kScatterTile = 1024;               // rows per block = threads
constexpr int kScatterWarps = kScatterTile / 32;
constexpr int kScanThreads = 1024;
constexpr int kProbeThreads = 256;
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kFusedSmemBytes = 232448;          // H100: 227 KB per block

// ---- K1 ---------------------------------------------------------------------

__global__ void hist_kernel(const int* __restrict__ ids, long long n, int P,
                            int tile, int* __restrict__ out, int per_tile) {
  extern __shared__ int bins[];
  for (int p = threadIdx.x; p < P; p += blockDim.x) bins[p] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int id = ids[r];
    if ((unsigned)id < (unsigned)P) atomicAdd(&bins[id], 1);
  }
  __syncthreads();
  if (per_tile) {
    int* row = out + (long long)blockIdx.x * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) row[p] = bins[p];
  } else {
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int c = bins[p];
      if (c) atomicAdd(&out[p], c);
    }
  }
}

// ---- scans (K2's bases) -----------------------------------------------------

// Inclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32). warp_sums[nw - 1] holds the block total on return; the
// caller syncs before the next call reuses warp_sums.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += t;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  return v;
}

// Block c replaces column c of the rows x cols matrix m by its exclusive
// prefix sum (in place) and writes the column total to totals[c].
__global__ void column_scan_kernel(int* __restrict__ m, long long rows,
                                   int cols, int* __restrict__ totals) {
  __shared__ int warp_sums[32];
  const int c = blockIdx.x;
  int carry = 0;
  for (long long base = 0; base < rows; base += blockDim.x) {
    const long long r = base + threadIdx.x;
    const int v = r < rows ? m[r * cols + c] : 0;
    const int incl = block_inclusive_scan(v, warp_sums);
    if (r < rows) m[r * cols + c] = carry + incl - v;
    carry += warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0 && totals != nullptr) totals[c] = carry;
}

// ---- K2 scatter ---------------------------------------------------------------

__global__ void scatter_kernel(const char* __restrict__ rows,
                               const int* __restrict__ ids, long long n,
                               int row_bytes, int P,
                               const int* __restrict__ part_base,
                               const int* __restrict__ tile_base,
                               char* __restrict__ out) {
  extern __shared__ int warp_counts[];   // [kScatterWarps][P]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kScatterWarps * P; i += blockDim.x)
    warp_counts[i] = 0;
  __syncthreads();

  const long long r = (long long)blockIdx.x * kScatterTile + threadIdx.x;
  int id = r < n ? ids[r] : -1;
  if ((unsigned)id >= (unsigned)P) id = -1;        // padding / out of range
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (id >= 0 && lane == __ffs(peers) - 1)
    warp_counts[warp * P + id] = __popc(peers);
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kScatterWarps; ++w) {
      const int c = warp_counts[w * P + p];
      warp_counts[w * P + p] = run;
      run += c;
    }
  }
  __syncthreads();
  if (id < 0) return;

  const long long dest = (long long)part_base[id] +
                         tile_base[(long long)blockIdx.x * P + id] +
                         warp_counts[warp * P + id] + rank;
  const bool words = (row_bytes & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(rows) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  if (words) {
    const int nw = row_bytes >> 2;
    const int* src = reinterpret_cast<const int*>(rows) + r * nw;
    int* dst = reinterpret_cast<int*>(out) + dest * nw;
    for (int w = 0; w < nw; ++w) dst[w] = src[w];
  } else {
    const char* src = rows + r * row_bytes;
    char* dst = out + dest * row_bytes;
    for (int b = 0; b < row_bytes; ++b) dst[b] = src[b];
  }
}

// ---- K3 -----------------------------------------------------------------------

__global__ void fused_probe_kernel(const int* __restrict__ pk,
                                   const float* __restrict__ v0,
                                   const float* __restrict__ v1, long long n,
                                   const int* __restrict__ bk,
                                   const int* __restrict__ bc,
                                   const int* __restrict__ bv, int m, int G,
                                   int* __restrict__ grp,
                                   float* __restrict__ wgt) {
  extern __shared__ int build[];         // keys | cats | valid, m each
  int* skey = build;
  int* scat = build + m;
  int* sval = build + 2 * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    skey[j] = bk[j];
    scat[j] = bc[j];
    sval[j] = bv[j];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = pk[i];
  int hits = 0;
  int cat = 0;
  for (int j = 0; j < m; ++j) {
    const int hit = (skey[j] == key) & (sval[j] != 0);
    hits += hit;
    cat += hit * scat[j];
  }
  // cat >= 0 (the wrapper checks build_cat), so C's % is the floor mod
  grp[i] = cat % G;
  wgt[i] = hits > 0 ? v0[i] * v1[i] : 0.0f;
}

}  // namespace

extern "C" {

const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rt_fused_probe_smem_bytes() { return kFusedSmemBytes; }

int rt_partition_histogram(const int* ids, long long n, int P, int per_tile,
                           int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || (long long)P * (long long)sizeof(int) > kDefaultSmemBytes)
    return (int)cudaErrorInvalidValue;
  const int tile = per_tile ? kScatterTile : kTotalsTile;
  const long long nb = (n + tile - 1) / tile;
  if (!per_tile) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)P * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (nb == 0) return (int)cudaGetLastError();
  hist_kernel<<<(unsigned)nb, kHistThreads, (size_t)P * sizeof(int), s>>>(
      ids, n, P, tile, out, per_tile);
  return (int)cudaGetLastError();
}

int rt_partition_scatter(const void* rows, const int* ids, long long n,
                         int row_bytes, int P, void* out, int* part_base,
                         int* tile_hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kScatterWarps * (size_t)P * sizeof(int);
  if (P <= 0 || smem > (size_t)kFusedSmemBytes || row_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) {
    cudaError_t err = cudaMemsetAsync(part_base, 0, (size_t)P * sizeof(int),
                                      s);
    return (int)err;
  }
  const long long nb = (n + kScatterTile - 1) / kScatterTile;
  cudaError_t err;
  hist_kernel<<<(unsigned)nb, kHistThreads, (size_t)P * sizeof(int), s>>>(
      ids, n, P, kScatterTile, tile_hist, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  column_scan_kernel<<<P, kScanThreads, 0, s>>>(tile_hist, nb, P, part_base);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  column_scan_kernel<<<1, kScanThreads, 0, s>>>(part_base, P, 1, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (smem > (size_t)kDefaultSmemBytes) {
    err = cudaFuncSetAttribute(scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scatter_kernel<<<(unsigned)nb, kScatterTile, smem, s>>>(
      static_cast<const char*>(rows), ids, n, row_bytes, P, part_base,
      tile_hist, static_cast<char*>(out));
  return (int)cudaGetLastError();
}

int rt_fused_probe(const int* pk, const float* v0, const float* v1,
                   long long n, const int* bk, const int* bc, const int* bv,
                   int m, int G, int* grp, float* wgt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)3 * (size_t)m * sizeof(int);
  if (m <= 0 || G <= 0 || smem > (size_t)kFusedSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaError_t err;
  if (smem > (size_t)kDefaultSmemBytes) {
    err = cudaFuncSetAttribute(fused_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nb = (n + kProbeThreads - 1) / kProbeThreads;
  fused_probe_kernel<<<(unsigned)nb, kProbeThreads, smem, s>>>(
      pk, v0, v1, n, bk, bc, bv, m, G, grp, wgt);
  return (int)cudaGetLastError();
}

}  // extern "C"
