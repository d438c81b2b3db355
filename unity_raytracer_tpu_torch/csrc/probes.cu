// Dispatch-cost and FP32-rate probes: the H100 counterparts of the four
// pallas_call sites outside the JAX package.
//
// Replaces
//   scripts/tpu_probe2.py:151  dead_kernel (:134-135) at tiles 1024, 8192
//                              and 65536: o = x + nodes[0,0] + tris[0,0],
//                              the two tables brought in whole each grid
//                              step                         -> dead_tables
//   scripts/tpu_probe2.py:161  dead_kernel_nob (:137-138): o = 2x, same
//                              tiles                        -> dead_nob
//   scripts/tpu_probe2.py:181  dead_kernel at tile 1024 under
//                              dimension_semantics=("arbitrary",), a Mosaic
//                              hint that the grid steps run in order on one
//                              core. CUDA has no such hint: the same body
//                              runs as a persistent grid, one block per SM,
//                              each striding over the tiles in order
//                                                           -> dead_persistent
//   scripts/tpu_r2_session.py:80  fma_kernel (:66-72): per element
//                              acc = v, then 1024 times acc = acc * c + v
//                                                           -> fma_chain
//
// Bounds on the H100. The dead kernels move 8 B per element (x in, o out;
// the two table reads are 8 B per launch) and compute nothing: a bytes
// bound, 2,073,600 elements = 16.6 MB = 5 us at 3.35 TB/s. What they
// measure is the launch: its host enqueue and the device's block
// dispatch, so each block covers `tile` elements, which keeps the TPU
// probe's grid (2025, 254 and 32 blocks). The TPU's re-fetch of a
// replicated block per grid step has no counterpart: a block reads
// nodes[0] and tris[0] once, from L2.
//
// What held them back, and the design of dead_tables and dead_nob: by
// Little's law the card's 3.35 TB/s at ~1 us of loaded latency needs ~3
// MB of loads in flight. 256 threads making scalar 4-byte loads one at a
// time kept ~1 MB in flight at tile 1024 (8 blocks an SM) and 32 KB at
// tile 65536 (32 blocks): 56% and 14% of the bound. Now each thread moves
// 16-byte float4 words (neighbouring threads on neighbouring words) and
// issues a batch of up to kBatch loads before its first store, with the
// streaming cache hints (__ldcs, __stcs: every byte is touched once). A
// block has clamp(tile / 32, 64, 1024) threads, up to 8 words each: 64
// at tile 1024 (4 words each; the 2025 blocks, 16 an SM, fit in one wave
// where 256-thread blocks took two), 256 at 8192 (8 words), 1024 at 65536
// (16 words in two batches, 128 KB in flight on each of the 32 SMs the
// grid reaches). dead_tables reads its two table elements on one lane of
// each warp once the first batch is in flight (dead_words). On an H100
// (PERF.md) these shapes ran level with torch.mul at tiles 1024 and 8192,
// where min(tile / 4, 1024) threads with __ldg ran ~0.0005-0.0008 ms
// slower; at 65536 a ring of 1-D TMA bulk copies (global -> shared ->
// global under mbarriers, up to 7 stages of 32 KB) was no faster (0.0103
// against 0.0100 ms), so it is not used. x and o must be 16-byte aligned
// (the wrappers check); a tile is a multiple of 256 elements, so every
// block starts on a 16-byte word.
// dead_persistent runs the same body (dead_words) on its persistent grid:
// one block per SM (132 on the H100), block b taking tiles b, b + 132,
// ... in order (2025 tiles of 1024: 45 blocks take 16, 87 take 15). A
// block's words are its tiles' words in that order, so a thread's batch
// of kBatch words spans the block's next tiles: with its kPersistThreads
// = 512 threads (utils/probes.PERSISTENT_THREADS) a tile's 256 words take half
// the block, and each thread loads its whole share (at most 8 words)
// before its first store, 64 KB in flight on each SM (8.6 MB on the
// card). The scalar body of the first port (256 threads, one 4-byte load
// at a time each, ~135 KB in flight on the card) ran at 34% of the bound.
//
// fma_chain is operations-bound: 2 FP32 operations per FMA (as the data
// sheet's 67 TFLOP/s counts them), 1024 per element, against 8 B of
// traffic. One dependent chain per thread; with 2048 threads an SM the
// four schedulers each hold 16 warps, which covers the FMA pipeline's
// latency without unrolling chains by hand. The library builds with
// -fmad=false (ops/kernels/_lib.py), under which `acc * c + v` is a
// separately rounded multiply and add at half the rate: the chain is
// written with __fmaf_rn, which that flag leaves fused (one rounding per
// step, as the plain version rounds it).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // fma_chain's blocks; tile granularity
constexpr int kMinThreads = 64;  // dead_tables / dead_nob blocks: tile / 32
constexpr int kMaxThreads = 1024;  // threads, clamped to these
constexpr int kBatch = 8;        // float4 loads a thread holds at once
constexpr int kPersistThreads = 512;  // dead_persistent's blocks
constexpr int kFmaSteps = 1024;            // scripts/tpu_r2_session.py K
constexpr float kFmaScale = 1.000000119f;  // 1 + 2^-23

// threads of a dead_tables / dead_nob block over `tile` elements
int vec_threads(int tile) {
  const int t = tile / 32;
  return t < kMinThreads ? kMinThreads : t > kMaxThreads ? kMaxThreads : t;
}

// o = (x + nodes[0]) + tris[0], or x * 2 with NOB, over the block's
// `count` float4 words. They lie in runs of `words` (a tile each): run r
// starts at word (first + r * stride) * words; without RUNS there is one
// run, the tile `first`. Thread t takes the block's words j = t + k *
// blockDim.x, k = 0, 1, ...; a batch of kBatch of them is loaded before
// any of them is stored, so a persistent block's batch spans its next
// tiles in order. Every warp with a lane below `count` runs the first
// batch on those lanes (dead_tables and dead_nob: a block has at most tile
// / 4 threads, so all of them), and after its loads one lane of each warp
// reads the two table elements and shuffles them to the others: the x
// loads are already in flight while the warp waits for the table
// (measured level with dead_nob; a read by every thread, or before the x
// loads, was 0.0003-0.0005 ms slower at tiles 1024 and 8192).
template <bool NOB, bool RUNS>
__device__ __forceinline__ void dead_words(const float4* __restrict__ x,
                                           const float* __restrict__ nodes,
                                           const float* __restrict__ tris,
                                           float4* __restrict__ o,
                                           int words, long long first,
                                           long long stride, int count) {
  // the lanes of this warp that run the first batch (without RUNS all of
  // them: a block has at most tile / 4 threads)
  const int lanes = count - static_cast<int>(threadIdx.x & ~31u);
  const unsigned warp = !RUNS ? __activemask() : __activemask() &
      (lanes >= 32 ? 0xffffffffu : lanes > 0 ? (1u << lanes) - 1u : 0u);
  const int step = blockDim.x;
  // the global word of the block's word j (recomputed at the store: an
  // array of them cost the float4 kernels registers and spill)
  const long long base = first * words;
  const auto at = [&](int j) -> long long {
    return RUNS ? (first + (j / words) * stride) * words + j % words
                : base + j;
  };
  float n0 = 0.f, t0 = 0.f;
  for (int w0 = threadIdx.x; w0 < count; w0 += kBatch * step) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (w0 + k * step < count) v[k] = __ldcs(x + at(w0 + k * step));
    if (!NOB && w0 == static_cast<int>(threadIdx.x)) {
      if ((threadIdx.x & 31) == 0) {
        n0 = __ldg(nodes);
        t0 = __ldg(tris);
      }
      n0 = __shfl_sync(warp, n0, 0);
      t0 = __shfl_sync(warp, t0, 0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (w0 + k * step < count) {
        float4 r = v[k];
        if (NOB) {
          r.x = r.x * 2.0f; r.y = r.y * 2.0f;
          r.z = r.z * 2.0f; r.w = r.w * 2.0f;
        } else {
          r.x = (r.x + n0) + t0; r.y = (r.y + n0) + t0;
          r.z = (r.z + n0) + t0; r.w = (r.w + n0) + t0;
        }
        __stcs(o + at(w0 + k * step), r);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    dead_tables_kernel(const float4* __restrict__ x,
                       const float* __restrict__ nodes,
                       const float* __restrict__ tris,
                       float4* __restrict__ o, int words) {
  dead_words<false, false>(x, nodes, tris, o, words, blockIdx.x, 0, words);
}

__global__ void __launch_bounds__(kMaxThreads)
    dead_nob_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                    int words) {
  dead_words<true, false>(x, nullptr, nullptr, o, words, blockIdx.x, 0,
                          words);
}

// gridDim.x blocks (one per SM) take tiles blockIdx.x, + gridDim.x, ...,
// below n_tiles, in order: the block's words are those tiles' words
__global__ void __launch_bounds__(kPersistThreads)
    dead_persistent_kernel(const float4* __restrict__ x,
                           const float* __restrict__ nodes,
                           const float* __restrict__ tris,
                           float4* __restrict__ o, int n_tiles, int words) {
  const int b = static_cast<int>(blockIdx.x), g = static_cast<int>(gridDim.x);
  const int mine = n_tiles > b ? (n_tiles - 1 - b) / g + 1 : 0;
  dead_words<false, true>(x, nodes, tris, o, words, blockIdx.x, gridDim.x,
                          mine * words);
}

__global__ void __launch_bounds__(kThreads)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ o,
                     long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float acc = v;
#pragma unroll 16
  for (int k = 0; k < kFmaSteps; ++k) acc = __fmaf_rn(acc, kFmaScale, v);
  o[i] = acc;
}

bool bad_tiling(long long n, int tile) {
  return tile <= 0 || tile % kThreads != 0 || n <= 0 || n % tile != 0 ||
         n / tile > 0x7fffffffLL;
}

bool misaligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 != 0;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for an n that
// is not a positive multiple of `tile` or a tile that is not a multiple of
// 256, and for the dead kernels an x or o that is not 16-byte aligned).
// x and o hold n floats; nodes and tris are read at element 0.

int urt_dead_tables(const float* x, const float* nodes, const float* tris,
                    float* o, long long n, int tile, void* stream) {
  if (bad_tiling(n, tile) || misaligned(x) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  dead_tables_kernel<<<static_cast<unsigned>(n / tile), vec_threads(tile),
                       0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), nodes, tris,
      reinterpret_cast<float4*>(o), tile / 4);
  return launched();
}

int urt_dead_nob(const float* x, float* o, long long n, int tile,
                 void* stream) {
  if (bad_tiling(n, tile) || misaligned(x) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  dead_nob_kernel<<<static_cast<unsigned>(n / tile), vec_threads(tile), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
      tile / 4);
  return launched();
}

// `blocks`: the persistent grid (the card's SM count) of kPersistThreads
// threads; a block's words must fit an int.
int urt_dead_persistent(const float* x, const float* nodes,
                        const float* tris, float* o, long long n, int tile,
                        int blocks, void* stream) {
  if (bad_tiling(n, tile) || misaligned(x) || misaligned(o) ||
      blocks <= 0 ||
      ((n / tile + blocks - 1) / blocks) * (tile / 4) +
              kBatch * kPersistThreads >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dead_persistent_kernel<<<blocks, kPersistThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), nodes, tris,
      reinterpret_cast<float4*>(o), static_cast<int>(n / tile), tile / 4);
  return launched();
}

int urt_fma_chain(const float* x, float* o, long long n, void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  fma_chain_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n);
  return launched();
}

}  // extern "C"
