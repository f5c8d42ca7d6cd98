// Exact multi-keyword prefilter for the secret scanner: a two-byte
// filter over a bigram index of the bank, then a shift-or verify of the
// few keyword lanes the filter lets through.
//
// Replaces: trivy_tpu/ops/shiftor_pallas.py `shiftor` (the Pallas TPU
// kernel `_kernel`). Same contract: chunks uint8[B, L] (lowercased) →
// int32[B, n_words], bit k%32 of word k/32 set iff keyword k occurs
// anywhere in the row. w4[p] is bytes p..p+3 of the row, little-endian;
// keyword k occurs at p iff ((w4[p + 4w] ^ kww[w][k]) & kwm[w][k]) == 0
// for every state word w < W. Bytes past the end of a row read as 0,
// never as the next row's bytes, and positions at or past the row end
// start no match.
//
// Bound on the H100: the bytes. Every position of a 4096 x 16384 batch
// (64 MiB, about 20 us at 3.35 TB/s) is looked at once; the brute-force
// version tested every position against every keyword lane instead,
// about 40x more integer work than the bytes take to arrive.
//
// Design:
//   index   built on the host (ops/shiftor.py `bank_index`): for each
//           bigram g = b0 | b1 << 8, the set of lanes whose keyword can
//           start with those two bytes — a 65,536-bit presence bitmap
//           (8 KB, in shared memory) and a [65536] x 128-bit candidate
//           table (1 MB, in global memory, read only at present bigrams:
//           60 lines for the built-in bank). A position whose bigram is
//           absent costs one shared-memory lookup.
//   verify  a thread whose 4-byte word holds a passing position
//           appends (word, pass mask) to its warp's queue in shared
//           memory (a ballot gives the slots); a full queue, and the
//           queue at the end of the span, is drained by the whole warp,
//           one entry a lane. Candidates are sparse in text, so testing
//           them where they are found would run the branch with one or
//           two lanes of 32 active. Each passing position's candidate
//           lanes, less those already found, are tested word by word
//           against the bank (in shared memory) with an early exit.
//   staging a persistent grid walks spans of SPAN positions; each span
//           plus the reach of the last state word is copied into shared
//           memory by the bulk-copy engine (cp.async.bulk, completion on
//           an mbarrier), two buffers deep, so the copy of span i+1
//           overlaps the test of span i. Past a row's end the buffer is
//           zero-filled.
//   hits    each thread keeps the lanes it found; a warp ORs them, maps
//           them to the lanes' bit values and issues at most one
//           atomicOr per output word and span. OR does not depend on
//           order, so the result is deterministic.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WORDS_PER_THREAD = 8;                  // 4-byte words
constexpr int SPAN = THREADS * WORDS_PER_THREAD * 4;  // positions per span
constexpr int LANES = 128;                           // keyword slots
constexpr int MAX_STATE_WORDS = 16;                  // keywords to 64 bytes
// staged bytes past a span: the last state word's reach (4W + 4 bytes
// for W <= 16) rounded up to the bulk copy's 16-byte granule
constexpr int TAIL = 80;
constexpr int BUF = SPAN + TAIL;
constexpr int BITMAP_WORDS = 65536 / 32;
constexpr int WARPS = THREADS / 32;
constexpr int QUEUE = 64;  // queued words per warp, at least 32

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one thread: arm the barrier for `bytes` and start the copy
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t w4_at(const uint32_t* raw, int i) {
  // bytes i..i+3 of the staged span, little-endian
  return __funnelshift_r(raw[i >> 2], raw[(i >> 2) + 1], (i & 3) * 8);
}

// lanes of the bank that occur at position p of the staged span: the
// bigram's candidates less those in `found`, tested word by word
__device__ __forceinline__ void verify(const uint32_t* raw, int p,
                                       const uint4* __restrict__ cand,
                                       const uint32_t* s_kww,
                                       const uint32_t* s_kwm, int n_state,
                                       int n_words, uint32_t (&found)[4]) {
  const uint4 m = __ldg(cand + (w4_at(raw, p) & 0xFFFFu));
  const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= n_words) break;
    uint32_t todo = mw[q] & ~found[q];
    while (todo) {
      const int t = __ffs(todo) - 1;
      todo &= todo - 1;
      const int k = q * 32 + t;
      bool ok = true;
      for (int w = 0; w < n_state && ok; ++w)
        ok = ((w4_at(raw, p + 4 * w) ^ s_kww[w * LANES + k]) &
              s_kwm[w * LANES + k]) == 0u;
      if (ok) found[q] |= 1u << t;
    }
  }
}

struct Span {
  int row, p0, bytes;  // bytes: what the bulk copy brings (a 16 multiple)
};

__device__ __forceinline__ Span span_of(int s, int spans_per_row,
                                        int length) {
  Span sp;
  sp.row = s / spans_per_row;
  sp.p0 = (s - sp.row * spans_per_row) * SPAN;
  sp.bytes = min(BUF, length - sp.p0);
  return sp;
}

__global__ void __launch_bounds__(THREADS)
shiftor_kernel(const uint8_t* __restrict__ chunks, int rows, int length,
               const int32_t* __restrict__ kww,
               const int32_t* __restrict__ kwm,
               const int32_t* __restrict__ kwbit,
               const uint32_t* __restrict__ bitmap,
               const uint4* __restrict__ cand, int n_state,
               int32_t* __restrict__ out, int n_words) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* s_buf = reinterpret_cast<uint32_t*>(smem);         // [2][BUF/4]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + 2 * BUF);  // [2]
  uint32_t* s_bm = reinterpret_cast<uint32_t*>(s_bar + 2);     // [2048]
  uint32_t* s_kww = s_bm + BITMAP_WORDS;                       // [W][128]
  uint32_t* s_kwm = s_kww + n_state * LANES;                   // [W][128]
  uint32_t* s_bit = s_kwm + n_state * LANES;                   // [128]
  // [WARPS][QUEUE] queued words: word index << 4 | pass mask
  uint16_t* s_queue = reinterpret_cast<uint16_t*>(s_bit + LANES);

  const int spans_per_row = (length + SPAN - 1) / SPAN;
  const int n_spans = rows * spans_per_row;
  const int lane = threadIdx.x & 31;
  uint16_t* queue = s_queue + (threadIdx.x >> 5) * QUEUE;

  int s = blockIdx.x;
  if (threadIdx.x == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first span's copy overlaps loading the index and the bank
    const Span sp = span_of(s, spans_per_row, length);
    bulk_load(s_buf, chunks + (size_t)sp.row * length + sp.p0, sp.bytes,
              &s_bar[0]);
  }
  for (int i = threadIdx.x; i < BITMAP_WORDS; i += THREADS)
    s_bm[i] = __ldg(bitmap + i);
  for (int i = threadIdx.x; i < n_state * LANES; i += THREADS) {
    s_kww[i] = (uint32_t)__ldg(kww + i);
    s_kwm[i] = (uint32_t)__ldg(kwm + i);
  }
  for (int i = threadIdx.x; i < LANES; i += THREADS)
    s_bit[i] = (uint32_t)__ldg(kwbit + i);
  __syncthreads();

  for (int it = 0; s < n_spans; ++it, s += gridDim.x) {
    const int b = it & 1;
    uint32_t* raw = s_buf + b * (BUF / 4);
    const Span sp = span_of(s, spans_per_row, length);
    const int next = s + gridDim.x;
    if (threadIdx.x == 0 && next < n_spans) {
      // the other buffer was released by the barrier closing the last
      // iteration
      const Span nx = span_of(next, spans_per_row, length);
      bulk_load(s_buf + (b ^ 1) * (BUF / 4),
                chunks + (size_t)nx.row * length + nx.p0, nx.bytes,
                &s_bar[b ^ 1]);
    }
    mbar_wait(&s_bar[b], (it >> 1) & 1);
    if (sp.bytes < BUF) {  // the row ends inside the staged window
      uint4* z = reinterpret_cast<uint4*>(raw);
      for (int i = sp.bytes / 16 + threadIdx.x; i < BUF / 16; i += THREADS)
        z[i] = make_uint4(0u, 0u, 0u, 0u);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    // positions at or past the row end are never match starts
    const int live = min(length - sp.p0, SPAN);

    uint32_t found[4] = {0u, 0u, 0u, 0u};  // lanes found, by word
    int queued = 0;                          // warp-uniform
    auto drain = [&]() {
      for (int e = lane; e < queued; e += 32) {
        const uint32_t entry = queue[e];
        uint32_t pass = entry & 15u;
        while (pass) {
          const int p = 4 * (int)(entry >> 4) + __ffs(pass) - 1;
          pass &= pass - 1;
          if (p >= live) break;
          verify(raw, p, cand, s_kww, s_kwm, n_state, n_words, found);
        }
      }
      __syncwarp();
      queued = 0;
    };
#pragma unroll 2
    for (int r = 0; r < WORDS_PER_THREAD; ++r) {
      const int j = threadIdx.x + r * THREADS;
      const uint32_t x = raw[j], y = raw[j + 1];
      uint32_t g[4];
      g[0] = x & 0xFFFFu;
      g[1] = (x >> 8) & 0xFFFFu;
      g[2] = x >> 16;
      g[3] = __funnelshift_r(x, y, 24) & 0xFFFFu;
      uint32_t pass = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t bm = s_bm[g[c] >> 5];
        // the funnel shift takes its amount mod 32: bit g & 31
        pass |= (__funnelshift_r(bm, bm, g[c]) & 1u) << c;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, pass != 0u);
      if (ball == 0u) continue;
      if (queued + __popc(ball) > QUEUE) drain();
      if (pass)
        queue[queued + __popc(ball & ((1u << lane) - 1u))] =
            (uint16_t)(j << 4 | pass);
      queued += __popc(ball);
      __syncwarp();
    }
    drain();

    // lanes → bit values, one OR per warp and output word
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= n_words) break;
      const uint32_t f = __reduce_or_sync(0xffffffffu, found[q]);
      if (f == 0u) continue;
      const uint32_t v = __reduce_or_sync(
          0xffffffffu, ((f >> lane) & 1u) ? s_bit[q * 32 + lane] : 0u);
      if (lane == 0 && v)
        atomicOr(reinterpret_cast<unsigned int*>(out) +
                     (size_t)sp.row * n_words + q,
                 v);
    }
    __syncthreads();  // buffer b is free for the copy issued next round
  }
}

size_t smem_bytes(int n_state) {
  return 2 * BUF + 2 * sizeof(uint64_t) +
         sizeof(uint32_t) * (BITMAP_WORDS + 2 * n_state * LANES + LANES) +
         sizeof(uint16_t) * WARPS * QUEUE;
}

// blocks of the persistent grid: as many as fit on the card at once,
// worked out once per device and state-word count
int grid_blocks(int n_state, size_t smem, int* out) {
  static int cache[64][MAX_STATE_WORDS + 1];  // 0: not worked out yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* slot = dev < 64 ? &cache[dev][n_state] : nullptr;
  if (slot && *slot) {
    *out = *slot;
    return 0;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, shiftor_kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  *out = sms * std::max(per_sm, 1);
  if (slot) *slot = *out;
  return 0;
}

}  // namespace

extern "C" int trivy_shiftor(const void* chunks, int rows, int length,
                             const void* kww, const void* kwm,
                             const void* kwbit, const void* bitmap,
                             const void* cand, int n_state, void* out,
                             int n_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || length <= 0) return (int)cudaGetLastError();
  if (n_state < 1 || n_state > MAX_STATE_WORDS || n_words < 1 ||
      n_words > 4 || (length & 15) != 0 ||
      ((uintptr_t)chunks & 15) != 0 || ((uintptr_t)cand & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)rows * n_words, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(n_state);
  int resident = 0;
  if (int rc = grid_blocks(n_state, smem, &resident)) return rc;
  const long long n_spans =
      (long long)rows * ((length + SPAN - 1) / SPAN);
  if (n_spans > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(n_spans, resident);
  shiftor_kernel<<<grid, THREADS, smem, st>>>(
      (const uint8_t*)chunks, rows, length, (const int32_t*)kww,
      (const int32_t*)kwm, (const int32_t*)kwbit, (const uint32_t*)bitmap,
      (const uint4*)cand, n_state, (int32_t*)out, n_words);
  return (int)cudaGetLastError();
}
