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
// dispatch, so each block covers `tile` elements with 256 threads striding
// over it, which keeps the TPU probe's grid (2025, 254 and 32 blocks).
// The TPU's re-fetch of a replicated block per grid step has no
// counterpart: a block reads nodes[0] and tris[0] once, from L2.
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

constexpr int kThreads = 256;
constexpr int kFmaSteps = 1024;            // scripts/tpu_r2_session.py K
constexpr float kFmaScale = 1.000000119f;  // 1 + 2^-23

__device__ __forceinline__ void dead_tile(const float* __restrict__ x,
                                          float* __restrict__ o,
                                          long long base, int tile,
                                          float n0, float t0) {
  for (int i = threadIdx.x; i < tile; i += kThreads)
    o[base + i] = (x[base + i] + n0) + t0;
}

__global__ void __launch_bounds__(kThreads)
    dead_tables_kernel(const float* __restrict__ x,
                       const float* __restrict__ nodes,
                       const float* __restrict__ tris, float* __restrict__ o,
                       int tile) {
  dead_tile(x, o, static_cast<long long>(blockIdx.x) * tile, tile, nodes[0],
            tris[0]);
}

__global__ void __launch_bounds__(kThreads)
    dead_nob_kernel(const float* __restrict__ x, float* __restrict__ o,
                    int tile) {
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += kThreads)
    o[base + i] = x[base + i] * 2.0f;
}

// gridDim.x blocks (one per SM) take tiles blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kThreads)
    dead_persistent_kernel(const float* __restrict__ x,
                           const float* __restrict__ nodes,
                           const float* __restrict__ tris,
                           float* __restrict__ o, long long n_tiles,
                           int tile) {
  const float n0 = nodes[0], t0 = tris[0];
  for (long long b = blockIdx.x; b < n_tiles; b += gridDim.x)
    dead_tile(x, o, b * tile, tile, n0, t0);
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

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for an n that
// is not a positive multiple of `tile` or a tile that is not a multiple of
// 256). x and o hold n floats; nodes and tris are read at element 0.

int urt_dead_tables(const float* x, const float* nodes, const float* tris,
                    float* o, long long n, int tile, void* stream) {
  if (bad_tiling(n, tile)) return static_cast<int>(cudaErrorInvalidValue);
  dead_tables_kernel<<<static_cast<unsigned>(n / tile), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, nodes, tris,
                                                            o, tile);
  return launched();
}

int urt_dead_nob(const float* x, float* o, long long n, int tile,
                 void* stream) {
  if (bad_tiling(n, tile)) return static_cast<int>(cudaErrorInvalidValue);
  dead_nob_kernel<<<static_cast<unsigned>(n / tile), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, o, tile);
  return launched();
}

// `blocks`: the persistent grid (the card's SM count).
int urt_dead_persistent(const float* x, const float* nodes,
                        const float* tris, float* o, long long n, int tile,
                        int blocks, void* stream) {
  if (bad_tiling(n, tile) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dead_persistent_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, nodes, tris, o, n / tile, tile);
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
