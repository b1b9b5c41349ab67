// Partition kernels of the analytics data plane, hand-written for Hopper
// (sm_90a). Built by nvcc into a shared library with a plain C interface
// and loaded through ctypes (repro_torch/kernels/partition.py). Every entry
// point launches on the stream it is given, allocates nothing (the caller
// passes outputs and scratch), and returns the CUDA error of its launches
// (0 on success). K1 and K2 take their arguments packed in one int64 array
// and size themselves (copies of the bins, tile, unit, grid) from it and the
// card's SM count.
//
// K1  rt_partition_histogram  replaces repro/kernels/partition.py
//     partition_histogram / _hist_kernel (one-hot block histogram; the
//     reference's dispatcher sums the per-block rows, here the kernel
//     returns the (P,) totals).
//     Bound: bytes. It reads N int32 ids once and writes P counters: at
//     3.35 TB/s a pure streaming pass, so what matters is bytes in flight,
//     contention on the bins, and launches. Design: one launch of two CTAs
//     a SM (512 threads) that walk the ids in a grid-stride loop of 16-byte
//     loads, four in flight a thread (an unaligned head of up to three ids
//     and the ragged tail are read one by one). At small P every thread
//     keeps bins of its own in shared memory ([P][threads], so a warp's 32
//     lanes hit 32 banks whatever their ids) and increments them without
//     atomics; at larger P warp w adds atomically into copy w % copies (16
//     copies at P = 512, two at P = 12,288), which spreads skewed ids over
//     several addresses. The CTA merges its bins and adds each non-zero
//     one into a per-stream accumulator of P counters in global memory;
//     the last CTA to finish (a ticket counter) copies the accumulator to
//     `out` and leaves it, and the ticket, at zero for the next call: no
//     memset. Ids outside [0, P) are skipped (the wrapper refuses them).
//
// K2  rt_partition_scatter  replaces repro/kernels/partition.py
//     partition_scatter / _scatter_kernel (stable grouping by id).
//     Bound: bytes. It reads ids and rows once and writes rows once. The
//     TPU kernel walked its grid in order; here tiles run in any order, so
//     each needs the rows of its ids in all earlier tiles. Design: two
//     launches. The first (tile_hist_kernel) is K1 counting per tile: each
//     CTA takes a chunk of consecutive tiles, each warp counts whole tiles
//     (K1's bins), and the counts become, per partition, exclusive
//     prefixes within the chunk; its last CTA (K1's ticket) scans the
//     totals into the partition bases (the offsets) and the chunk totals
//     into chunk bases, so a tile's base in partition p is two reads. The
//     second, the scatter, is a programmatic dependent of the first
//     (griddepcontrol): one CTA a tile of up to 2048 rows, which ranks its
//     rows while the first launch still runs and waits for it only to read
//     its bases. Ranking is stable: each warp owns a contiguous run of
//     32-row rounds; a ballot a bit of the id (the onesweep sort's
//     warp-level multi-split, Adinets & Merrill 2022) finds the lanes
//     sharing a row's id and a popcount ranks it in its round, a
//     per-(warp, partition) running count in shared memory places the
//     round after the warp's earlier ones, and a scan of those counts over
//     the warps places each warp after the earlier warps. The tile's rows
//     are staged in shared memory in bucket order (rows of one 4-byte
//     unit, the grouping path's index column, travel in registers with
//     their ids; wider ones are read in input order, 16 bytes wide where
//     the alignment allows), and each bucket's run is written out
//     contiguously. Rows too wide to stage are copied from global memory in
//     bucket order instead; rows whose width or address is not a multiple
//     of 4 bytes move a byte at a time.
//     A single-pass scan with decoupled look-back (Merrill & Garland,
//     2016) came first, but with about a thousand tiles resident every
//     tile of the first wave walks back at once, and its waits were a
//     large share of a CTA's life (PERF.md). Counting per tile in the
//     first launch, which reads every id anyway, leaves no wait but the
//     one for that launch.
//
// K3  rt_fused_probe  replaces repro/kernels/partition.py
//     fused_probe / _fused_probe_kernel (one-hot equality probe).
//     Bound: bytes. The one-hot probe of the TPU kernel does N*M key
//     compares, but the function needs none of them: a hash probe reads
//     N*12 + M*12 bytes and writes N*8 (1.4 MB at N = 2^16, M = 8192:
//     0.42 us at 3.35 TB/s), so what is left is the launch, the table's
//     build and the probes' shared-memory latency. Design: one launch of
//     persistent CTAs (at most one a SM, fewer when N is small), each of
//     which builds the table once in shared memory and then walks its share
//     of the probe rows in a grid-stride loop. The table: every build row's
//     (key, cat) staged as 8 bytes, and beside them 2-byte slots that hold
//     row index + 1, 0 for empty, so no key is confused with an empty slot
//     (linear probing from a multiply-shift hash of the key; at least 2M
//     slots, a power of two, and as many more as fit). A valid row is
//     inserted with a 16-bit atomicCAS; a row whose key is already in the
//     table adds its cat into the first row's with atomicAdd, which keeps
//     the one-hot sum of duplicate keys (int32 wraparound included). Rows
//     with build_valid == 0 are never inserted, so they never match. Probe
//     columns are read and outputs written 16 bytes a thread where all five
//     are aligned (a scalar loop takes the rest), and group is cat % G
//     taken as a floor mod, as the reference's jnp % is. At the gate's 16 Ki
//     rows the table takes 16 Ki * 8 + 32 Ki * 2 = 192 KB: still 12 bytes a
//     row, inside one block's 227 KB (kFusedSmemBytes). Keys chosen to
//     collide under the hash make long chains: slower, never wrong, since
//     at least half the slots stay empty. Tried and dropped (PERF.md):
//     inserting in rounds of plain stores instead of CAS, walking a
//     thread's four probe chains side by side, 32-bit slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kFusedSmemBytes = 232448;          // H100: 227 KB per block
// the most dynamic shared memory K1 and K2 ask for: 1 KB of the block's
// 227 KB stays for their static shared variables
constexpr int kDynSmemMax = kFusedSmemBytes - 1024;
// K3: one CTA of 1024 threads a SM; its table holds at most kFusedMaxRows
// build rows (a row's valid bit is kept in a 32-bit mask a thread)
constexpr int kProbeThreads = 1024;
constexpr int kFusedMaxRows = 16384;
constexpr unsigned kProbeHashMult = 0x9E3779B1u;   // Knuth's multiplier

// K1: 16 warps a CTA, two CTAs a SM, so a CTA's bins stay within half the
// SM's 228 KB
constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistCtasPerSm = 2;
constexpr int kHistUnroll = 4;                   // 16-byte loads in flight
constexpr int kHistSmemTarget = 100 * 1024;
// K2: 8 warps a CTA; tiles of 256-2048 rows (at most 8 a thread, so a CTA
// of the grouping path needs 32 registers a thread and eight fit a SM);
// shared memory for four CTAs a SM where the tile allows, else for one
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kMaxTile = 2048;
constexpr int kScatterSmemTarget = 56 * 1024;
// rt_partition_scatter's answer when the caller's scratch is too small (it
// then holds the words needed in the scratch-size argument)
constexpr int kNeedScratch = -1;

int g_sm_count[64];                              // per device ordinal

int sm_count() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (g_sm_count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    g_sm_count[dev] = n > 0 ? n : 132;
  }
  return g_sm_count[dev];
}

// Opt in to more than 48 KB of dynamic shared memory. The attribute is set
// on the current device, so it is set on every such launch (a cheap host
// call) rather than remembered.
template <typename K>
cudaError_t allow_smem(K kern, long long bytes) {
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Whether this CTA is the last of its grid to get here: each CTA takes a
// ticket (a counter at zero between calls) after its global writes. Every
// thread of the CTA calls it.
__device__ bool last_cta(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

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

// out[i] = in[0] + ... + in[i - 1] for i < len (in may be global or shared
// memory); returns the total. Every thread of the block calls it.
__device__ int block_exclusive_scan(const int* in, int* out, int len,
                                    int* warp_sums) {
  int carry = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < len ? in[i] : 0;
    const int incl = block_inclusive_scan(v, warp_sums);
    if (i < len) out[i] = carry + incl - v;
    carry += warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
  }
  return carry;
}

// ---- K1 ---------------------------------------------------------------------

// Count one id. Own: bins is the thread's own column of a [P][threads]
// array (so a warp's 32 lanes hit 32 banks whatever their ids), a plain
// increment; else a per-warp copy, an atomic add.
template <bool Own>
__device__ __forceinline__ void hist_add(int* bins, int id, int P) {
  if ((unsigned)id >= (unsigned)P) return;
  if (Own) ++bins[id * kHistThreads];
  else atomicAdd(&bins[id], 1);
}

template <bool Own>
__device__ __forceinline__ void hist_add4(int* bins, int4 x, int P) {
  hist_add<Own>(bins, x.x, P);
  hist_add<Own>(bins, x.y, P);
  hist_add<Own>(bins, x.z, P);
  hist_add<Own>(bins, x.w, P);
}

// Count ids[0, n) into bins: member `rank` of a team of `team` threads
// reads the 16-byte vectors rank, rank + team, ... (kHistUnroll in flight),
// and members 0-2 one id each of the head before the first 16-byte boundary
// and of the ragged tail.
template <bool Own>
__device__ __forceinline__ void count_ids(const int* __restrict__ ids,
                                          long long n, long long rank,
                                          long long team, int* mine, int P) {
  const long long to_boundary = (long long)(
      ((16u - (unsigned)(reinterpret_cast<uintptr_t>(ids) & 15u)) & 15u) >> 2);
  const long long head = to_boundary < n ? to_boundary : n;
  const long long nv = (n - head) >> 2;
  const int4* body = reinterpret_cast<const int4*>(ids + head);
  long long i = rank;
  for (; i + (kHistUnroll - 1) * team < nv; i += kHistUnroll * team) {
    int4 x[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) x[u] = body[i + u * team];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) hist_add4<Own>(mine, x[u], P);
  }
  for (; i < nv; i += team) hist_add4<Own>(mine, body[i], P);
  const long long tail = head + nv * 4;
  if (rank < head) hist_add<Own>(mine, ids[rank], P);
  if (rank < n - tail) hist_add<Own>(mine, ids[tail + rank], P);
}

// K1's sub-histograms a CTA: bins of every thread's own (kHistThreads
// copies, plain increments) where they fit kHistSmemTarget, else as many
// per-warp copies as fit (a power of two, from kHistWarps down to 1).
int hist_copies(int P) {
  if ((long long)P * kHistThreads * 4 <= kHistSmemTarget) return kHistThreads;
  int copies = kHistWarps;
  while (copies > 1 && (long long)copies * P * 4 > kHistSmemTarget)
    copies /= 2;
  return copies;
}

// acc: P counters at zero between calls; ticket: a counter at zero between
// calls. Leaves both at zero and writes the totals to out. Own: every
// thread keeps its own bins (copies == kHistThreads, small P); else warp w
// adds atomically into copy w % copies.
template <bool Own>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const int* __restrict__ ids, long long n, int P, int copies,
            int* __restrict__ out, int* acc, unsigned* ticket) {
  extern __shared__ int bins[];                  // [copies][P] or [P][threads]
  for (int i = threadIdx.x; i < copies * P; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  int* mine = Own ? bins + threadIdx.x
                  : bins + ((threadIdx.x >> 5) % copies) * P;
  count_ids<Own>(ids, n, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                 (long long)gridDim.x * blockDim.x, mine, P);
  __syncthreads();

  if (Own) {
    // a warp per bin sums the threads' counts
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x >> 5; p < P; p += kHistWarps) {
      int c = 0;
      for (int k = lane; k < kHistThreads; k += 32)
        c += bins[p * kHistThreads + k];
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      if (lane == 0 && c) atomicAdd(&acc[p], c);
    }
  } else {
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      int c = 0;
      for (int k = 0; k < copies; ++k) c += bins[k * P + p];
      if (c) atomicAdd(&acc[p], c);
    }
  }
  if (!last_cta(ticket)) return;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    out[p] = atomicExch(&acc[p], 0);
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

int hist_launch(const int* ids, long long n, int P, int* out, int* acc,
                unsigned* ticket, cudaStream_t s) {
  if (P <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int copies = hist_copies(P);
  const bool own = copies == kHistThreads;
  const long long smem = (long long)copies * P * (long long)sizeof(int);
  if (smem > kDynSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = own ? hist_kernel<true> : hist_kernel<false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const long long vec = (n + 3) / 4;
  long long grid = (vec + kHistThreads - 1) / kHistThreads;
  const long long most = (long long)kHistCtasPerSm * sm_count();
  grid = grid < 1 ? 1 : (grid > most ? most : grid);
  kern<<<(unsigned)grid, kHistThreads, (size_t)smem, s>>>(ids, n, P, copies,
                                                         out, acc, ticket);
  return (int)cudaGetLastError();
}

// ---- K2 ---------------------------------------------------------------------

// K2's first launch: K1 over the same ids, counting per tile of the
// scatter. CTA b owns tiles [b k, (b + 1) k) (k = per_cta) and each of its
// warps counts whole tiles with K1's loop (64 ids a lane at 2048-row tiles),
// into bins of every thread's own (Own, small P: no atomics, and a warp
// reduction per bin) or of every warp's own (shared atomics within the
// warp). Each CTA then turns its tiles' counts into exclusive prefixes
// within its chunk and adds the chunk's totals to the accumulator; the last
// CTA (K1's ticket) copies the totals out, scans them over the partitions
// (offsets, the partition bases) and scans each partition's chunk totals
// over the chunks, so that
//   base(t, p) = chunk[t / k][p] + tile_base[t][p]
// is where tile t's first row of partition p goes. It leaves acc and the
// ticket at zero. It shares K1's counting loop and ticket but is a kernel
// of its own: a warp, not the grid, walks each tile, every tile's counts
// are written out, and the scans follow.
template <bool Own>
__global__ void __launch_bounds__(kHistThreads)
tile_hist_kernel(const int* __restrict__ ids, long long n, int P, int tile,
                 int tiles, int per_cta, int* tile_base, int* chunk,
                 int* __restrict__ offsets, int* acc, unsigned* ticket) {
  // the scatter (a programmatic dependent) may start ranking its tiles
  // now; it waits for this grid's writes before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ int bins[];   // Own: [P][threads], else [warps][P]
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < (Own ? kHistThreads : kHistWarps) * P;
       i += blockDim.x)
    bins[i] = 0;
  __syncthreads();
  const int t0 = blockIdx.x * per_cta;
  const int t1 = min(t0 + per_cta, tiles);
  for (int t = t0 + warp; t < t1; t += kHistWarps) {
    const long long lo = (long long)t * tile;
    int* mine = Own ? bins + threadIdx.x : bins + warp * P;
    count_ids<Own>(ids + lo, n - lo < tile ? n - lo : tile, lane, 32, mine,
                   P);
    __syncwarp();
    if (Own) {
      for (int p = 0; p < P; ++p) {
        int c = mine[p * kHistThreads];
        mine[p * kHistThreads] = 0;
        for (int off = 16; off > 0; off >>= 1)
          c += __shfl_xor_sync(0xffffffffu, c, off);
        if (lane == 0) tile_base[(long long)t * P + p] = c;
      }
    } else {
      for (int p = lane; p < P; p += 32) {
        tile_base[(long long)t * P + p] = mine[p];
        mine[p] = 0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // each partition's tile counts -> exclusive prefixes within the chunk
  // (this CTA's own writes, visible after the barrier), a warp a partition
  for (int p = warp; p < P; p += kHistWarps) {
    int run = 0;
    for (int b = t0; b < t1; b += 32) {
      const int t = b + lane;
      const int v = t < t1 ? tile_base[(long long)t * P + p] : 0;
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      if (t < t1) tile_base[(long long)t * P + p] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      chunk[(long long)blockIdx.x * P + p] = run;
      if (run) atomicAdd(&acc[p], run);
    }
  }
  if (!last_cta(ticket)) return;
  // totals -> partition bases (in bins, which are free now)
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    bins[P + p] = atomicExch(&acc[p], 0);
  __syncthreads();
  block_exclusive_scan(bins + P, bins, P, warp_sums);
  for (int p = threadIdx.x; p < P; p += blockDim.x) offsets[p] = bins[p];
  // each partition's chunk totals -> chunk bases, a warp a partition,
  // kChunkLoads loads a lane in flight (other CTAs' writes: read from L2)
  constexpr int kChunkLoads = 8;
  const int G = (int)gridDim.x;
  for (int p = warp; p < P; p += kHistWarps) {
    int carry = bins[p];
    for (int c0 = 0; c0 < G; c0 += 32 * kChunkLoads) {
      int v[kChunkLoads];
#pragma unroll
      for (int k = 0; k < kChunkLoads; ++k) {
        const int c = c0 + 32 * k + lane;
        v[k] = c < G ? __ldcg(&chunk[(long long)c * P + p]) : 0;
      }
#pragma unroll
      for (int k = 0; k < kChunkLoads; ++k) {
        const int c = c0 + 32 * k + lane;
        int incl = v[k];
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += u;
        }
        if (c < G) chunk[(long long)c * P + p] = carry + incl - v[k];
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

struct ScatterArgs {
  const char* rows;
  const int* ids;
  char* out;
  const int* tile_base;      // (tiles, P), from tile_hist_kernel
  const int* chunk;          // (chunks, P), from tile_hist_kernel
  long long n;
  int P, per_cta, row_units, staged;
};

// Whether a scatter CTA keeps a tile-long row map in shared memory: all do
// but those that stage rows of one unit of at most 4 bytes, which travel in
// registers with their ids.
__host__ __device__ bool scatter_needs_map(long long row_bytes, int unit,
                                           int staged) {
  return !(staged && unit == row_bytes && unit <= 4);
}

__host__ __device__ long long scatter_head_bytes(int tile, int P, bool map) {
  const long long ints = (long long)(kScatterWarps + 2) * P + (map ? tile : 0);
  return (ints * 4 + 15) / 16 * 16;
}

// Dynamic shared memory of one scatter CTA, in bytes: the (warp, partition)
// counts and two P-vectors (tile bases, output deltas), the row map where
// it needs one, the partition of each slot (2 bytes), and, when staged, the
// tile's rows; each part rounded to 16 bytes.
__host__ __device__ long long scatter_smem_bytes(int tile, int P,
                                                 long long row_bytes,
                                                 int unit, int staged) {
  return scatter_head_bytes(tile, P,
                            scatter_needs_map(row_bytes, unit, staged)) +
         (2LL * tile + 15) / 16 * 16 +
         (staged ? ((long long)tile * row_bytes + 15) / 16 * 16 : 0);
}

struct ScatterPlan {
  int unit;        // bytes a row moves in: 16, 4 or 1
  int tile;        // rows a CTA, 0 if no tile fits
  int staged;      // rows staged in shared memory, else copied from global
  long long smem;  // dynamic shared bytes a CTA
};

// K2's scatter for rows of row_bytes at addresses (rows | out) and P
// partitions: rows move in the widest unit that divides the row and both
// addresses; a CTA takes the largest tile whose rows can be staged in
// shared memory with four CTAs a SM (kScatterSmemTarget); else, for rows
// too wide for that, the largest tile that copies them from global memory
// in bucket order; else the same two with one CTA a SM (large P).
ScatterPlan scatter_plan(long long row_bytes, int P, uintptr_t addresses) {
  ScatterPlan plan{1, 0, 0, 0};
  for (int unit : {16, 4})
    if (row_bytes % unit == 0 && addresses % unit == 0) {
      plan.unit = unit;
      break;
    }
  const int tiers[4][2] = {{1, kScatterSmemTarget}, {0, kScatterSmemTarget},
                           {1, kDynSmemMax}, {0, kDynSmemMax}};
  for (const auto& tier : tiers)
    for (int tile = kMaxTile; tile >= kScatterThreads; tile /= 2) {
      const long long smem =
          scatter_smem_bytes(tile, P, row_bytes, plan.unit, tier[0]);
      if (smem <= tier[1]) {
        plan.tile = tile;
        plan.staged = tier[0];
        plan.smem = smem;
        return plan;
      }
    }
  return plan;
}

// The lanes of this warp whose value equals this lane's, for values in
// [0, 2^bits): one ballot a bit (the warp-level multi-split of the onesweep
// sort; on this card it is much cheaper than __match_any_sync).
__device__ __forceinline__ unsigned peers_of(int v, int bits) {
  unsigned peers = 0xffffffffu;
  for (int k = 0; k < bits; ++k) {
    const bool b = (v >> k) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, b);
    peers &= b ? m : ~m;
  }
  return peers;
}

// Tile blockIdx.x of K2's scatter, of R rows a thread. V is the unit a row
// is moved in (int4, int or char) and a row is row_units of them.
template <typename V, int R>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(ScatterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  constexpr int T = R * kScatterThreads;
  constexpr bool kSmallUnit = sizeof(V) <= 4;
  const int P = a.P, U = a.row_units;
  // rows of one unit of at most 4 bytes (the grouping path's index
  // column) travel in registers with their ids; wider ones are staged
  // through the row map below
  const bool in_regs = kSmallUnit && U == 1 && a.staged;
  int* cnt = reinterpret_cast<int*>(smem);       // [warps][P]
  int* texcl = cnt + kScatterWarps * P;          // [P]
  int* delta = texcl + P;                        // [P]
  int* map = delta + P;                          // [T] unless in_regs
  const long long head = scatter_head_bytes(T, P, !in_regs);
  unsigned short* slot_id =                      // [T]
      reinterpret_cast<unsigned short*>(smem + head);
  V* stage = reinterpret_cast<V*>(smem + head + (2LL * T + 15) / 16 * 16);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const long long start = (long long)t * T;
  const int rows_here = (int)(a.n - start < T ? a.n - start : T);
  const V* src = reinterpret_cast<const V*>(a.rows) + start * U;

  for (int i = threadIdx.x; i < kScatterWarps * P; i += blockDim.x) cnt[i] = 0;
  // rank: warp w owns rows [w R 32, (w + 1) R 32) of the tile, 32 a round.
  // Rows whose id is out of range (and the ragged tile's missing rows)
  // take the value P and are ranked among themselves, then dropped.
  int my_key[R];                  // the id, then (id + 1) << 16 | rank
  V my_row[kSmallUnit ? R : 1];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = (warp * R + j) * 32 + lane;
    const int id = r < rows_here ? a.ids[start + r] : P;
    my_key[j] = (unsigned)id < (unsigned)P ? id : P;
    if constexpr (kSmallUnit)
      if (in_regs && r < rows_here) my_row[j] = src[r];
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const int bits = 32 - __clz(P);                // values 0 .. P
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int id = my_key[j];
    const unsigned peers = peers_of(id, bits);
    const bool valid = id < P;
    const int before = valid ? cnt[warp * P + id] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      cnt[warp * P + id] = before + __popc(peers);
    __syncwarp();
    my_key[j] = valid ? (id + 1) << 16 | (before + __popc(peers & below)) : 0;
  }
  __syncthreads();
  // place each warp after the tile's earlier warps, per partition
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kScatterWarps; ++w) {
      const int c = cnt[w * P + p];
      cnt[w * P + p] = run;
      run += c;
    }
    delta[p] = run;
  }
  __syncthreads();
  const int valid = block_exclusive_scan(delta, texcl, P, warp_sums);

  // slots in bucket order
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = (warp * R + j) * 32 + lane;
    const int id = (my_key[j] >> 16) - 1;
    if (id >= 0) {
      const int slot = texcl[id] + cnt[warp * P + id] + (my_key[j] & 0xffff);
      slot_id[slot] = (unsigned short)id;
      if constexpr (kSmallUnit)
        if (in_regs) {
          stage[slot] = my_row[j];
          continue;
        }
      map[a.staged ? r : slot] = a.staged ? slot : r;
    } else if (a.staged && !in_regs && r < rows_here) {
      map[r] = -1;
    }
  }
  __syncthreads();

  // stage the tile's rows in bucket order (input order reads)
  if (a.staged && !in_regs) {
    const int units = rows_here * U;
    auto place = [&](int e, V v) {
      const int r = U == 1 ? e : e / U;
      const int s = map[r];
      if (s >= 0) stage[s * U + (e - r * U)] = v;
    };
    int e0 = 0;
    if constexpr (sizeof(V) == 4) {
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int4* src4 = reinterpret_cast<const int4*>(src);
        const int n4 = units >> 2;
        for (int i = threadIdx.x; i < n4; i += blockDim.x) {
          const int4 x = src4[i];
          place(4 * i, reinterpret_cast<const V&>(x.x));
          place(4 * i + 1, reinterpret_cast<const V&>(x.y));
          place(4 * i + 2, reinterpret_cast<const V&>(x.z));
          place(4 * i + 3, reinterpret_cast<const V&>(x.w));
        }
        e0 = n4 * 4;
      }
    }
    for (int e = e0 + threadIdx.x; e < units; e += blockDim.x) place(e, src[e]);
  }

  // everything below reads the first launch's bases
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int* chunk = a.chunk + (long long)(t / a.per_cta) * P;
  const int* tbase = a.tile_base + (long long)t * P;
  // written by the other grid: read from L2
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    delta[p] = __ldcg(&chunk[p]) + __ldcg(&tbase[p]) - texcl[p];
  __syncthreads();

  // each bucket's run of slots goes out contiguously
  V* dst = reinterpret_cast<V*>(a.out);
  const int units = valid * U;
  if (U == 1) {
    for (int s = threadIdx.x; s < valid; s += blockDim.x) {
      const long long d = (long long)delta[slot_id[s]] + s;
      dst[d] = a.staged ? stage[s] : src[map[s]];
    }
  } else {
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int s = e / U;
      const int u = e - s * U;
      const long long d = ((long long)delta[slot_id[s]] + s) * U + u;
      dst[d] = a.staged ? stage[e] : src[(long long)map[s] * U + u];
    }
  }
}

template <typename V, int R>
int scatter_launch_r(const ScatterArgs& a, int tiles, long long smem,
                     cudaStream_t s) {
  cudaError_t err = allow_smem(scatter_kernel<V, R>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kScatterThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, scatter_kernel<V, R>, a);
}

template <typename V>
int scatter_launch(const ScatterArgs& a, int tile, int tiles, long long smem,
                   cudaStream_t s) {
  switch (tile / kScatterThreads) {
    case 1: return scatter_launch_r<V, 1>(a, tiles, smem, s);
    case 2: return scatter_launch_r<V, 2>(a, tiles, smem, s);
    case 4: return scatter_launch_r<V, 4>(a, tiles, smem, s);
    case 8: return scatter_launch_r<V, 8>(a, tiles, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int tile_hist_launch(const int* ids, long long n, int P, int tile, int tiles,
                     int per_cta, int chunks, int* tile_base, int* chunk,
                     int* offsets, int* acc, unsigned* ticket,
                     cudaStream_t s) {
  const bool own = hist_copies(P) == kHistThreads;
  const long long smem = (long long)(own ? kHistThreads : kHistWarps) * P *
                         (long long)sizeof(int);
  if (smem > kDynSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = own ? tile_hist_kernel<true> : tile_hist_kernel<false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)chunks, kHistThreads, (size_t)smem, s>>>(
      ids, n, P, tile, tiles, per_cta, tile_base, chunk, offsets, acc,
      ticket);
  return (int)cudaGetLastError();
}

// The packed arguments of rt_partition_histogram, in this order. Pointers
// and the stream are addresses. acc is P zeroed int32 counters and ticket
// one zeroed uint32, both held per stream by the caller and left at zero.
enum HistArg {
  kHIds, kHN, kHP, kHOut, kHAcc, kHTicket, kHStream, kHistNumArgs
};

// The packed arguments of rt_partition_scatter, in this order. rows is
// (n, row_bytes) bytes, out the same, offsets (P,) int32; acc and ticket
// as for K1; scratch is scratch_words int32 held per stream by the caller,
// which each call writes in full before it reads it (the tiles' and the
// first launch's chunks' bases).
enum ScatterArg {
  kSRows, kSIds, kSN, kSRowBytes, kSP, kSOut, kSOffsets, kSAcc, kSTicket,
  kSScratch, kSScratchWords, kSStream, kScatterNumArgs
};

template <typename P>
P* ptr(const long long* a, int i) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(a[i]));
}

// ---- K3 -----------------------------------------------------------------------

// log2 of the table's slots: the least power of two >= 2m (at least 2),
// doubled while the table still fits a block's shared memory. A CTA holds
// its SM alone, so the spare memory costs nothing, and the shorter chains
// of a sparser table halved the time at M = 8192 (PERF.md).
int probe_table_bits(int m) {
  int bits = 1;
  while ((1 << bits) < 2 * m) ++bits;
  while (8LL * m + (4LL << bits) <= kFusedSmemBytes) ++bits;
  return bits;
}

__device__ __forceinline__ unsigned probe_hash(int key, int shift) {
  return ((unsigned)key * kProbeHashMult) >> shift;
}

// One probe row: the summed cat of the valid build rows with its key
// (0 if none) as a floor mod of G, and v0 * v1 if there was one, else 0.
__device__ __forceinline__ void probe_row(const int2* rows,
                                          const unsigned short* slots,
                                          unsigned mask, int shift, int G,
                                          int key, float a, float b, int* g,
                                          float* w) {
  int cat = 0;
  bool found = false;
  for (unsigned h = probe_hash(key, shift);; h = (h + 1) & mask) {
    const unsigned s = slots[h];
    if (s == 0) break;
    const int2 r = rows[s - 1];
    if (r.x == key) {
      cat = r.y;
      found = true;
      break;
    }
  }
  const int q = cat % G;
  *g = q + (q < 0 ? G : 0);
  *w = found ? __fmul_rn(a, b) : 0.0f;
}

// Vec: every probe column and output is 16-byte aligned, so rows go four
// at a time (the ragged end of n one at a time).
template <bool Vec>
__global__ void __launch_bounds__(kProbeThreads)
fused_probe_kernel(const int* __restrict__ pk, const float* __restrict__ v0,
                   const float* __restrict__ v1, long long n,
                   const int* __restrict__ bk, const int* __restrict__ bc,
                   const int* __restrict__ bv, int m, int G, int bits,
                   int* __restrict__ grp, float* __restrict__ wgt) {
  extern __shared__ int4 table[];
  int2* rows = reinterpret_cast<int2*>(table);               // m (key, cat)
  unsigned short* slots = reinterpret_cast<unsigned short*>(rows + m);
  const unsigned nslots = 1u << bits, mask = nslots - 1;
  const int shift = 32 - bits;
  // stage every row and clear the slots (nslots is even)
  unsigned valid = 0;                    // bit r: this thread's r-th row
#pragma unroll 4
  for (int j = threadIdx.x, r = 0; j < m; j += blockDim.x, ++r) {
    rows[j] = make_int2(bk[j], bc[j]);
    valid |= (unsigned)(bv[j] != 0) << r;
  }
  unsigned* words = reinterpret_cast<unsigned*>(slots);
  for (unsigned j = threadIdx.x; j < nslots / 2; j += blockDim.x) words[j] = 0;
  __syncthreads();
  // insert the valid rows; a key already present takes this row's cat into
  // the row that holds its slot (only the thread that inserts a row reads
  // that row's cat, and it never gains a slot afterwards)
  for (int j = threadIdx.x, r = 0; j < m; j += blockDim.x, ++r) {
    if (!((valid >> r) & 1u)) continue;
    const int key = rows[j].x;
    for (unsigned h = probe_hash(key, shift);; h = (h + 1) & mask) {
      const unsigned short s = atomicCAS(&slots[h], (unsigned short)0,
                                         (unsigned short)(j + 1));
      if (s == 0) break;
      if (rows[s - 1].x == key) {
        atomicAdd(&rows[s - 1].y, rows[j].y);
        break;
      }
    }
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (Vec) {
    const long long quads = n >> 2;
    for (long long i = first; i < quads; i += step) {
      const int4 k = reinterpret_cast<const int4*>(pk)[i];
      const float4 a = reinterpret_cast<const float4*>(v0)[i];
      const float4 b = reinterpret_cast<const float4*>(v1)[i];
      int4 g;
      float4 w;
      probe_row(rows, slots, mask, shift, G, k.x, a.x, b.x, &g.x, &w.x);
      probe_row(rows, slots, mask, shift, G, k.y, a.y, b.y, &g.y, &w.y);
      probe_row(rows, slots, mask, shift, G, k.z, a.z, b.z, &g.z, &w.z);
      probe_row(rows, slots, mask, shift, G, k.w, a.w, b.w, &g.w, &w.w);
      reinterpret_cast<int4*>(grp)[i] = g;
      reinterpret_cast<float4*>(wgt)[i] = w;
    }
    done = quads << 2;
  }
  for (long long i = done + first; i < n; i += step)
    probe_row(rows, slots, mask, shift, G, pk[i], v0[i], v1[i], &grp[i],
              &wgt[i]);
}

}  // namespace

extern "C" {

const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rt_fused_probe_smem_bytes() { return kFusedSmemBytes; }
unsigned rt_fused_probe_hash_mult() { return kProbeHashMult; }
int rt_hist_num_args() { return kHistNumArgs; }
int rt_scatter_num_args() { return kScatterNumArgs; }
int rt_need_scratch() { return kNeedScratch; }

int rt_partition_histogram(const long long* a) {
  return hist_launch(ptr<const int>(a, kHIds), a[kHN], (int)a[kHP],
                     ptr<int>(a, kHOut), ptr<int>(a, kHAcc),
                     ptr<unsigned>(a, kHTicket),
                     ptr<CUstream_st>(a, kHStream));
}

// Launches nothing and returns kNeedScratch, with the words it needs in
// a[kSScratchWords], when the caller's scratch is smaller than that.
int rt_partition_scatter(long long* a) {
  cudaStream_t s = ptr<CUstream_st>(a, kSStream);
  const long long n = a[kSN], row_bytes = a[kSRowBytes];
  const int P = (int)a[kSP];
  const ScatterPlan plan = scatter_plan(
      row_bytes, P,
      static_cast<uintptr_t>(a[kSRows]) | static_cast<uintptr_t>(a[kSOut]));
  if (P <= 0 || P > 0xffff || row_bytes <= 0 || n < 0 || n > 0x7fffffffLL ||
      plan.tile == 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0)
    return (int)cudaMemsetAsync(ptr<int>(a, kSOffsets), 0,
                                (size_t)P * sizeof(int), s);
  // the first launch: two CTAs a SM, each a chunk of consecutive tiles
  const long long tiles = (n + plan.tile - 1) / plan.tile;
  const long long most = (long long)kHistCtasPerSm * sm_count();
  const int per_cta = (int)((tiles + most - 1) / most);
  const int chunks = (int)((tiles + per_cta - 1) / per_cta);
  const long long words = (tiles + chunks) * P;
  if (a[kSScratchWords] < words) {
    a[kSScratchWords] = words;
    return kNeedScratch;
  }
  int* tile_base = ptr<int>(a, kSScratch);
  int* chunk = tile_base + tiles * P;
  int err = tile_hist_launch(ptr<const int>(a, kSIds), n, P, plan.tile,
                             (int)tiles, per_cta, chunks, tile_base, chunk,
                             ptr<int>(a, kSOffsets), ptr<int>(a, kSAcc),
                             ptr<unsigned>(a, kSTicket), s);
  if (err != 0) return err;
  const ScatterArgs sa{ptr<const char>(a, kSRows), ptr<const int>(a, kSIds),
                       ptr<char>(a, kSOut), tile_base, chunk, n, P, per_cta,
                       (int)(row_bytes / plan.unit), plan.staged};
  if (plan.unit == 16)
    return scatter_launch<int4>(sa, plan.tile, (int)tiles, plan.smem, s);
  if (plan.unit == 4)
    return scatter_launch<int>(sa, plan.tile, (int)tiles, plan.smem, s);
  return scatter_launch<char>(sa, plan.tile, (int)tiles, plan.smem, s);
}

int rt_fused_probe(const int* pk, const float* v0, const float* v1,
                   long long n, const int* bk, const int* bc, const int* bv,
                   int m, int G, int* grp, float* wgt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0 || m > kFusedMaxRows || G <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int bits = probe_table_bits(m);
  const long long smem = (long long)m * (long long)sizeof(int2) +
                         (2LL << bits);
  if (smem > kFusedSmemBytes) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pk) |
                         reinterpret_cast<uintptr_t>(v0) |
                         reinterpret_cast<uintptr_t>(v1) |
                         reinterpret_cast<uintptr_t>(grp) |
                         reinterpret_cast<uintptr_t>(wgt);
  const bool vec = (addr & 15u) == 0;
  auto kern = vec ? fused_probe_kernel<true> : fused_probe_kernel<false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  // each CTA builds the whole table, so take no more CTAs than give every
  // thread a 16-byte vector (or a row) of probes
  const long long per_cta = (long long)kProbeThreads * (vec ? 4 : 1);
  long long grid = (n + per_cta - 1) / per_cta;
  if (grid > sm_count()) grid = sm_count();
  kern<<<(unsigned)grid, kProbeThreads, (size_t)smem, s>>>(
      pk, v0, v1, n, bk, bc, bv, m, G, bits, grp, wgt);
  return (int)cudaGetLastError();
}

}  // extern "C"
