// Brute-force nearest triangle for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel nearest_triangle_pallas of the JAX package
// (ops/pallas/intersect_mk.py, kernel body :44-105, pallas_call at :145):
// for every ray the smallest Möller–Trumbore t over all T triangles of a
// [T, 9] soup (v0 v1 v2), with the triangle epsilon 1e-5 and a per-
// triangle valid flag; +inf and index -1 where no triangle is hit.
//
// Design: a block of kBlock rays streams the soup through shared memory in
// tiles of kTile triangles (kTile x 9 floats, 18 KB, plus the flags); each
// thread folds its running (t, index) with a strict < in ascending
// triangle order, so of equal t the first triangle wins — the TPU
// kernel's block argmin followed by its strict < across blocks. The work
// is N x T tests of ~60 FP32 operations with no data-dependent skip, so
// the kernel is bound by the FP32 rate; the tile loads are shared by the
// block's 256 rays.
//
// Numerics: the TPU kernel's formula, operation by operation, with IEEE
// division and no FMA contraction (-fmad=false, ops/kernels/_lib.py), so
// it rounds where the plain PyTorch version
// (ops/kernels/intersect_mk.nearest_triangle_plain) rounds.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 512;
constexpr float kEps = 1e-5f;

__global__ void __launch_bounds__(kBlock)
    nearest_tri_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tris,
                       const float* __restrict__ valid, int n, int n_tris,
                       float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ float tile[kTile * 9];
  __shared__ float live[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (lane) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
  }
  float best_t = INFINITY;
  int best_i = -1;
  for (int base = 0; base < n_tris; base += kTile) {
    const int cnt = min(kTile, n_tris - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt * 9; j += blockDim.x)
      tile[j] = tris[(size_t)base * 9 + j];
    for (int j = threadIdx.x; j < cnt; j += blockDim.x)
      live[j] = valid[base + j];
    __syncthreads();
    if (!lane) continue;
    for (int k = 0; k < cnt; ++k) {
      const float* v = tile + 9 * k;
      const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
      const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float a = e1x * hx + e1y * hy + e1z * hz;
      const bool parallel = fabsf(a) < kEps;
      const float f = 1.0f / (parallel ? 1.0f : a);
      const float sx = ox - v[0], sy = oy - v[1], sz = oz - v[2];
      const float u = f * (sx * hx + sy * hy + sz * hz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float w = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      const bool miss = parallel || u < 0.f || u > 1.f || w < 0.f ||
                        u + w > 1.f || t <= kEps || live[k] < 0.5f;
      if (!miss && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
  }
  if (lane) {
    t_out[i] = best_t;
    i_out[i] = best_i;
  }
}

}  // namespace

extern "C" {

// Nearest triangle for n rays (o, d [n,3]) against tris [n_tris, 9] with
// valid [n_tris] (1 = live) on `stream`: t_out [n] (+inf on a miss),
// i_out [n] (-1). Returns cudaGetLastError() after the launch.
int urt_nearest_tri(const float* o, const float* d, const float* tris,
                    const float* valid, int n, int n_tris, float* t_out,
                    int* i_out, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  nearest_tri_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tris, valid, n, n_tris, t_out, i_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
