// CSR expansion plus the version-interval predicate of the advisory join,
// with the compaction of its hits fused in.
//
// Replaces: trivy_tpu/ops/join.py `_csr_core` (`csr_pair_join`) and
// `_csr_compact_core` (`csr_pair_join_compact`, which adds the
// `_compact_core` epilogue), both XLA programs. Same contract: per-query
// CSR descriptors (bucket start, count, version row) expand to t_pad pair
// slots; slot idx < total belongs to the last query whose exclusive
// start is <= idx, evaluates advisory row
// clamp(q_start[seg] + idx - start[seg], 0, A-1) against installed
// version clamp(q_ver[seg], 0, U-1) and writes int8 bits (1 = SATISFIED,
// 2 = NEEDS_RECHECK); slots idx >= total write 0. The compacted form also
// writes the nonzero slots in ascending order into an h_cap hit buffer
// (index and bits, zero past the hits), keeps the first h_cap, and
// reports the true hit count.
//
// Bound on the H100: memory. Each slot reads its row's flags and the
// 16-byte prefixes of its bounds, and writes one byte; hot buckets
// repeat, so most of those reads come from L2 and L1.
//
// TILE (JOIN_TILE) and PRE (PREFIX_TOKENS) come from ops/constants.py:
// ops/kernels.py passes them to nvcc.
//
// Design, three launches and no atomics:
//   prep    the exclusive prefix of q_count (the query starts) and, for
//           each tile, the query that owns its first slot. A block scans
//           a chunk of CHUNK counts in shared memory after summing all
//           the counts before its chunk itself: that sum is redundant
//           work, but it is coalesced and spread over the blocks, so no
//           block waits on another. In the compacted form further blocks
//           zero the hit buffer.
//   tiles   a block owns TILE consecutive slots and reads its first and
//           last query from the prep's table. It stages, once per tile,
//           the starts of the queries in between and, for up to
//           SEG_STAGE of them, each query's row base, installed version
//           and that version's 16-byte prefix in shared memory; each
//           slot finds its query there (a short search that resumes
//           where the thread's previous slot stopped). Shared memory
//           stays small so L1 keeps the hot rows: consecutive slots of a
//           warp read consecutive rows of the flags and of the [A, 4]
//           prefix planes (512 contiguous bytes); the full 160-byte
//           vectors are read only when the prefixes tie. A tile of more
//           than SEG_STAGE queries (a run of one- or two-row buckets)
//           reads those per-query values from global memory instead. In
//           the compacted form the block also writes its count of hits.
//   compact (compacted form only) a block takes GROUP tiles: it sums
//           the counts of all tiles before them (redundant and
//           coalesced, as in prep), scans its own, and each warp then
//           moves one tile's hits at a time, 128 bits bytes a round: a
//           lane reads 4, a warp scan of the lanes' counts places each
//           hit in a shared-memory run, and the warp writes the run out
//           coalesced. Hits come out in ascending slot order; past h_cap
//           nothing is written; the last block writes the hit count.
// Each launch only reads what the one before wrote, so no block waits
// on another (a look-back across tiles in one launch measured slower:
// tiles stall on slower predecessors).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#if !defined(JOIN_TILE) || !defined(PREFIX_TOKENS)
#error "build with ops/kernels.py: it defines JOIN_TILE and PREFIX_TOKENS"
#endif

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = JOIN_TILE;           // slots per block
constexpr int SLOTS = TILE / THREADS;     // slots per thread
// query starts a tile stages: one per slot, plus the owner of the next
// tile's first slot, which the tile's table entry may name
constexpr int SEG_CAP = TILE + 1;
// queries whose row base and version a tile stages
constexpr int SEG_STAGE = 256;
constexpr int PRE = PREFIX_TOKENS;        // tokens in the prefix planes
static_assert(PRE == 4, "the prefix planes are read as one int4 a row");
constexpr int PREP_THREADS = 1024;
constexpr int CHUNK = 4 * PREP_THREADS;   // counts a prep block scans
constexpr int HAS_LO = 1, LO_INCL = 2, HAS_HI = 4, HI_INCL = 8, INEXACT = 16;
constexpr int GROUP = 64;                 // tiles a compaction block takes
constexpr int ROUND = 128;                // bits bytes a warp compacts at once
constexpr int ROUNDS = TILE / ROUND;
static_assert(TILE % THREADS == 0 && TILE % ROUND == 0,
              "JOIN_TILE must be a multiple of 256");

// ---- prep -----------------------------------------------------------------

__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  return incl - x + (warp ? s_warp[warp - 1] : 0);
}

__device__ __forceinline__ int block_sum(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if (lane == 0) s_warp[warp] = x;
  __syncthreads();
  int t = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
#pragma unroll
  for (int d = 16; d; d >>= 1) t += __shfl_xor_sync(0xffffffffu, t, d);
  __syncthreads();  // s_warp is free for the next scan
  return t;
}

__device__ __forceinline__ int count_at(const int32_t* __restrict__ q_count,
                                        int i, int n_q) {
  return i < n_q ? __ldg(q_count + i) : 0;
}

// chunks is the number of scan blocks; the blocks after them zero
__global__ void __launch_bounds__(PREP_THREADS)
csr_prep_kernel(const int32_t* __restrict__ q_count, int n_q, int total,
                int chunks, int32_t* __restrict__ starts,
                int32_t* __restrict__ tile_first,
                int32_t* __restrict__ hit_idx,
                int8_t* __restrict__ hit_bits, int h_cap,
                int32_t* __restrict__ n_hits) {
  __shared__ int s_warp[32];
  if ((int)blockIdx.x < chunks) {
    // the counts before this chunk (q_count is 16-byte aligned)
    const int c0 = blockIdx.x * CHUNK;
    int before = 0;
#pragma unroll 4
    for (int i = 4 * threadIdx.x; i < c0; i += 4 * PREP_THREADS) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(q_count + i));
      before += v.x + v.y + v.z + v.w;
    }
    before = block_sum(before, s_warp);
    // this chunk: four consecutive counts a thread
    const int i0 = c0 + 4 * threadIdx.x;
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = count_at(q_count, i0 + j, n_q);
    int run = before +
              block_exclusive_scan(c[0] + c[1] + c[2] + c[3], s_warp);
    // query i owns the slots [starts[i], starts[i + 1]), the last one up
    // to total: it is the last query whose start is <= the slot. Its
    // index goes to tile_first[t] for each tile t whose first slot it
    // owns, and the owner of slot total - 1 to tile_first[n_live].
    const int n_live = (total + TILE - 1) / TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = i0 + j;
      if (q >= n_q) break;
      const int own_end = q == n_q - 1 ? total : min(run + c[j], total);
      starts[q] = run;
      for (int t = (run + TILE - 1) / TILE; t * TILE < own_end; ++t)
        tile_first[t] = q;
      if (run < total && total <= own_end) tile_first[n_live] = q;
      run += c[j];
    }
    if (n_hits && blockIdx.x == 0 && threadIdx.x == 0) *n_hits = 0;
    return;
  }
  const int stride = (gridDim.x - chunks) * PREP_THREADS;
  const int t0 = (blockIdx.x - chunks) * PREP_THREADS + threadIdx.x;
  for (int i = t0; i < h_cap; i += stride) {
    hit_idx[i] = 0;
    hit_bits[i] = 0;
  }
}

// ---- tiles ----------------------------------------------------------------

__device__ __forceinline__ int cmp4(int4 a, int4 b) {
  if (a.x != b.x) return a.x < b.x ? -1 : 1;
  if (a.y != b.y) return a.y < b.y ? -1 : 1;
  if (a.z != b.z) return a.z < b.z ? -1 : 1;
  if (a.w != b.w) return a.w < b.w ? -1 : 1;
  return 0;
}

// sign of (a - b) in lexicographic order over n int32 tokens (n % 4 == 0)
__device__ int lex_cmp(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ b, int n) {
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int4* b4 = reinterpret_cast<const int4*>(b);
  for (int i = 0; i < (n >> 2); ++i) {
    const int c = cmp4(__ldg(a4 + i), __ldg(b4 + i));
    if (c) return c;
  }
  return 0;
}

__global__ void __launch_bounds__(THREADS)
csr_tile_kernel(const int32_t* __restrict__ lo_tok,
                const int32_t* __restrict__ hi_tok,
                const int32_t* __restrict__ flags,
                const int4* __restrict__ lo_pre,
                const int4* __restrict__ hi_pre, int n_rows, int k,
                const int32_t* __restrict__ ver_tok, int n_ver,
                const int32_t* __restrict__ starts,
                const int32_t* __restrict__ tile_first,
                const int32_t* __restrict__ q_start,
                const int32_t* __restrict__ q_ver, int total, int t_pad,
                int8_t* __restrict__ out, int32_t* __restrict__ counts) {
  __shared__ int s_start[SEG_CAP];   // first slot of each staged query
  __shared__ int s_base[SEG_STAGE];  // its q_start minus its first slot
  __shared__ int s_ver[SEG_STAGE];   // its installed version, clamped
  __shared__ int4 s_vp[SEG_STAGE];   // that version's first PRE tokens
  __shared__ int s_warp[WARPS];

  const int tile = blockIdx.x;
  const int s0 = tile * TILE;
  const int live_end = min(s0 + TILE, total);  // slots evaluated here
  // the tile's queries: seg_lo owns its first slot, and none past the
  // next table entry owns one of its slots
  const int seg_lo = s0 < total ? __ldg(tile_first + tile) : 0;
  const int n_seg = s0 < total ? __ldg(tile_first + tile + 1) - seg_lo + 1 : 0;
  // only zero-count queries inside the data could make a tile hold more
  // queries than slots; such a tile searches the starts in global memory
  const bool staged = n_seg <= SEG_CAP;
  const bool payload = n_seg <= SEG_STAGE;
  if (staged)
    for (int i = threadIdx.x; i < n_seg; i += THREADS) {
      const int q = seg_lo + i;
      const int first = __ldg(starts + q);
      s_start[i] = first;
      if (payload) {
        const int v = min(max(__ldg(q_ver + q), 0), n_ver - 1);
        s_base[i] = __ldg(q_start + q) - first;
        s_ver[i] = v;
        s_vp[i] = __ldg(reinterpret_cast<const int4*>(ver_tok + (size_t)v * k));
      }
    }
  __syncthreads();

  int8_t bits[SLOTS];
  int seg = 0;  // resumes from the previous slot: slots only grow
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int slot = s0 + i * THREADS + threadIdx.x;
    int b = 0;
    if (slot < live_end) {
      int hi = n_seg;  // start(seg) <= slot < start(hi)
      while (hi - seg > 1) {
        const int mid = (seg + hi) >> 1;
        const int st = staged ? s_start[mid] : __ldg(starts + seg_lo + mid);
        if (st <= slot) seg = mid; else hi = mid;
      }
      int base, v;
      int4 vp;
      if (payload) {
        base = s_base[seg];
        v = s_ver[seg];
        vp = s_vp[seg];
      } else {
        const int q = seg_lo + seg;
        base = __ldg(q_start + q) -
               (staged ? s_start[seg] : __ldg(starts + q));
        v = min(max(__ldg(q_ver + q), 0), n_ver - 1);
        vp = __ldg(reinterpret_cast<const int4*>(ver_tok + (size_t)v * k));
      }
      const int row = min(max(base + slot, 0), n_rows - 1);
      const int f = __ldg(flags + row);
      const int32_t* inst = ver_tok + (size_t)v * k;
      bool ok = true;
      if (f & HAS_LO) {
        int c = cmp4(__ldg(lo_pre + row), vp);
        if (c == 0)
          c = lex_cmp(lo_tok + (size_t)row * k + PRE, inst + PRE, k - PRE);
        ok = c < 0 || ((f & LO_INCL) && c == 0);
      }
      if (ok && (f & HAS_HI)) {
        int c = cmp4(vp, __ldg(hi_pre + row));
        if (c == 0)
          c = lex_cmp(inst + PRE, hi_tok + (size_t)row * k + PRE, k - PRE);
        ok = c < 0 || ((f & HI_INCL) && c == 0);
      }
      b = (ok ? 1 : 0) | ((f & INEXACT) ? 2 : 0);
    }
    bits[i] = (int8_t)b;
    if (slot < t_pad) out[slot] = (int8_t)b;
  }
  if (counts == nullptr) return;

  int n = 0;  // this tile's hits
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) n += bits[i] != 0;
#pragma unroll
  for (int d = 16; d; d >>= 1) n += __shfl_xor_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s_warp[w];
    counts[tile] = sum;
  }
}

// ---- compaction ------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
csr_compact_kernel(const int8_t* __restrict__ bits, int t_pad,
                   const int32_t* __restrict__ counts, int n_tiles,
                   int32_t* __restrict__ hit_idx,
                   int8_t* __restrict__ hit_bits, int h_cap,
                   int32_t* __restrict__ n_hits) {
  __shared__ int s_warp[32];
  __shared__ int s_off[GROUP];
  __shared__ int32_t s_run_idx[WARPS][ROUND];  // a round's hits, in order
  __shared__ int8_t s_run_bits[WARPS][ROUND];
  const int g0 = blockIdx.x * GROUP;
  const int n_here = min(GROUP, n_tiles - g0);
  // hits of the tiles before this group (counts is 16-byte aligned, g0
  // a multiple of 4)
  int before = 0;
#pragma unroll 4
  for (int i = 4 * threadIdx.x; i < g0; i += 4 * THREADS) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(counts + i));
    before += v.x + v.y + v.z + v.w;
  }
  before = block_sum(before, s_warp);
  const int c = threadIdx.x < n_here ? __ldg(counts + g0 + threadIdx.x) : 0;
  const int excl = block_exclusive_scan(c, s_warp);
  if (threadIdx.x < n_here) s_off[threadIdx.x] = before + excl;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == n_here - 1)
    *n_hits = before + excl + c;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* run_idx = s_run_idx[warp];
  int8_t* run_bits = s_run_bits[warp];
  for (int t = warp; t < n_here; t += WARPS) {
    int base = s_off[t];
    if (base >= h_cap) break;  // this tile's hits and the later ones overflow
    const int s0 = (g0 + t) * TILE + 4 * lane;
    uint32_t w[ROUNDS];  // this lane's 4 bytes of each round, loaded first
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int slot = s0 + r * ROUND;
      if (slot + 4 <= t_pad) {
        w[r] = __ldg(reinterpret_cast<const uint32_t*>(bits + slot));
      } else {  // the last tile may end inside these bytes
        w[r] = 0u;
        for (int b = 0; b < 4 && slot + b < t_pad; ++b)
          w[r] |= (uint32_t)(uint8_t)bits[slot + b] << (8 * b);
      }
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      uint32_t nz = __vcmpne4(w[r], 0u);
      const int n = __popc(nz) >> 3;
      int p = n;  // inclusive scan of the lanes' counts
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, p, d);
        if (lane >= d) p += y;
      }
      const int total = __shfl_sync(0xffffffffu, p, 31);
      if (total == 0) continue;
      for (p -= n; nz; ++p) {
        const int b = (__ffs(nz) - 1) >> 3;
        nz &= ~(0xFFu << (8 * b));
        run_idx[p] = s0 + r * ROUND + b;
        run_bits[p] = (int8_t)(w[r] >> (8 * b));
      }
      __syncwarp();
      for (int e = lane; e < total && base + e < h_cap; e += 32) {
        hit_idx[base + e] = run_idx[e];
        hit_bits[base + e] = run_bits[e];
      }
      __syncwarp();
      base += total;
    }
  }
}

// scratch, int32 and 16-byte aligned: the tiles' hit counts
// [round_up(n_tiles, 4)] (used by the compacted form), the query starts
// [n_q], and each tile's first query [n_tiles + 1]
int launch(const void* lo_tok, const void* hi_tok, const void* flags,
           const void* lo_pre, const void* hi_pre, int n_rows, int k,
           const void* ver_tok, int n_ver, const void* q_start,
           const void* q_count, const void* q_ver, int n_q, int total,
           int t_pad, void* out, void* scratch, bool compact,
           void* hit_idx, void* hit_bits, int h_cap, void* n_hits,
           cudaStream_t st) {
  if (n_rows < 1 || n_ver < 1 || n_q < 1 || k < PRE || (k & 3) != 0 ||
      total < 0 || total > t_pad || h_cap < 0 ||
      ((uintptr_t)q_count & 15) != 0 || ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (t_pad + TILE - 1) / TILE;
  int32_t* counts = compact ? (int32_t*)scratch : nullptr;
  int32_t* starts = (int32_t*)scratch + (n_tiles + 3) / 4 * 4;
  int32_t* tile_first = starts + n_q;
  const int chunks = (n_q + CHUNK - 1) / CHUNK;
  int prep_blocks = chunks;
  if (compact) prep_blocks += min((h_cap + PREP_THREADS - 1) / PREP_THREADS, 264);
  csr_prep_kernel<<<prep_blocks, PREP_THREADS, 0, st>>>(
      (const int32_t*)q_count, n_q, total, chunks, starts, tile_first,
      (int32_t*)hit_idx, (int8_t*)hit_bits, h_cap, (int32_t*)n_hits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  csr_tile_kernel<<<n_tiles, THREADS, 0, st>>>(
      (const int32_t*)lo_tok, (const int32_t*)hi_tok, (const int32_t*)flags,
      (const int4*)lo_pre, (const int4*)hi_pre, n_rows, k,
      (const int32_t*)ver_tok, n_ver, starts, tile_first,
      (const int32_t*)q_start, (const int32_t*)q_ver, total, t_pad,
      (int8_t*)out, counts);
  if ((err = cudaGetLastError()) != cudaSuccess || !compact) return (int)err;
  csr_compact_kernel<<<(n_tiles + GROUP - 1) / GROUP, THREADS, 0, st>>>(
      (const int8_t*)out, t_pad, counts, n_tiles, (int32_t*)hit_idx,
      (int8_t*)hit_bits, h_cap, (int32_t*)n_hits);
  return (int)cudaGetLastError();
}

}  // namespace

// dense bits: out int8[t_pad]; scratch as `launch` lays it out
extern "C" int trivy_csr_join(const void* lo_tok, const void* hi_tok,
                              const void* flags, const void* lo_pre,
                              const void* hi_pre, int n_rows, int k,
                              const void* ver_tok, int n_ver,
                              const void* q_start, const void* q_count,
                              const void* q_ver, int n_q, int total,
                              int t_pad, void* out, void* scratch,
                              void* stream) {
  return launch(lo_tok, hi_tok, flags, lo_pre, hi_pre, n_rows, k, ver_tok,
                n_ver, q_start, q_count, q_ver, n_q, total, t_pad, out,
                scratch, false, nullptr, nullptr, 0, nullptr,
                (cudaStream_t)stream);
}

// dense bits plus the hit buffer: hit_idx int32[h_cap], hit_bits
// int8[h_cap], n_hits int32[1]
extern "C" int trivy_csr_join_compact(
    const void* lo_tok, const void* hi_tok, const void* flags,
    const void* lo_pre, const void* hi_pre, int n_rows, int k,
    const void* ver_tok, int n_ver, const void* q_start, const void* q_count,
    const void* q_ver, int n_q, int total, int t_pad, void* out,
    void* scratch, void* hit_idx, void* hit_bits, int h_cap, void* n_hits,
    void* stream) {
  if (!n_hits) return (int)cudaErrorInvalidValue;
  return launch(lo_tok, hi_tok, flags, lo_pre, hi_pre, n_rows, k, ver_tok,
                n_ver, q_start, q_count, q_ver, n_q, total, t_pad, out,
                scratch, true, hit_idx, hit_bits, h_cap, n_hits,
                (cudaStream_t)stream);
}
