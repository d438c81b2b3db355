// Brute-force nearest triangle for Hopper (sm_90a), culled per bundle of
// rays.
//
// Replaces the TPU kernel nearest_triangle_pallas of the JAX package
// (ops/pallas/intersect_mk.py, kernel body :44-105, pallas_call at :145):
// for every ray the smallest Möller–Trumbore t over all T triangles of a
// [T, 9] soup (v0 v1 v2), with the triangle epsilon 1e-5 and a per-
// triangle valid flag; +inf and index -1 where no triangle is hit; of
// equal t the first triangle wins.
//
// What bounds it. Without a cull the work is N x T exact tests, ~60 FP32
// operations each; built with -fmad=false (below) none of them fuse, so
// the loop is bound by the instruction issue rate. Most pairs cannot hit:
// a block of 256 consecutive rays of a frame is a 32x8 pixel tile, which
// sees a few dozen of a mesh's triangles or none. So:
//
//   prep_kernel (one thread per triangle, once per launch) writes each
//   triangle's exact record — v0, e1 = v1 - v0, e2 = v2 - v0, its index,
//   three float4 — and its cull record: the centre of its vertices and a
//   radius R holding them, its normal n = e1 x e2, P = |e1| |e2|,
//   Q = |e1| + |e2| and its valid flag.
//
//   nearest_tri_kernel (one block of kBlock rays) reduces its rays to a
//   bundle: the box of their origins (apex: its centre, r_o: a radius
//   holding it) and the cone of their directions (axis c, the least
//   cosine cos_lo and the largest sine sin_hi of any ray's angle to c).
//   It streams the cull records in ascending order, one per thread, and
//   keeps a triangle unless its ball, grown by the margin m below, lies
//   outside the cone grown by r_o; the kept ones are compacted (ballot,
//   popc, warp offsets) into a list of exact records in shared memory, in
//   ascending order. When the list fills or the stream ends, every ray
//   folds the list with the exact test and a strict <, so it keeps the
//   (t, index) that the fold over all T triangles keeps: a dropped
//   triangle is one that no ray of the block can hit. A block with no
//   ray that can hit anything (all past n, non-finite, or d = 0) writes
//   the miss at once; a block whose cone is unusable (a ray 90 degrees
//   or more off the axis, or |d| over- or underflowing) keeps every
//   valid triangle, which is the brute force again.
//
//   A launch with few blocks (a small frame, a slice, the live bounces)
//   would leave most SMs idle while each block folds its survivors one
//   by one, so the host splits each block's triangle stream over
//   gridDim.y blocks, up to kTargetBlocks blocks in all: each folds its
//   share of the chunks, and the shares meet in a 64-bit atomicMin on
//   (t bits << 32 | index), which orders as the strict < fold in
//   ascending order does (t > 0, so its bits order as the floats; of
//   equal t the lower index). finalize_kernel unpacks the keys.
//
// The cone test. For a ray at angle theta <= 90 degrees from the axis
// and a point x at axial distance a and radial distance p from the apex,
// f(x) = p cos(theta) - a sin(theta) is 1-Lipschitz and 0 on the ray; so
// F(x) = p cos_lo - max(a, 0) sin_hi <= f(x) for every ray of the block,
// and F(centre) > R + m + r_o means that no point within m of the
// triangle is on any ray (r_o: the rays start within r_o of the apex).
// cos_lo and sin_hi carry kSlack (32 ulp of 1) for the rounding of the
// normalised directions and the axis; the threshold carries kSlack x the
// distance for the rounding of a, p and the centre.
//
// The margin m: how far outside the triangle the point of an accepted
// hit may be. The exact test accepts on rounded u, w, t; for a ray that
// grazes the plane the rounded u can be far off the exact one (measured:
// accepted rays passing 0.44 units beside a 0.6-unit triangle 40 units
// away). Let a* = e1 . (d x e2) and the exact point of the ray on the
// plane P* = o + t* d, with u = 2^-24 and first-order error bounds from
// the formula as written (cross products 2u, dot products 3u per term):
//   the numerators of u, w, t are off by at most 5u T(s, d, e2),
//   5u T(d, s, e1) and 5u T(e2, s, e1), a by 5u T(e1, d, e2), where
//   T(x, y, z) = sum over the six permutations of |x_i| |y_j| |z_k|
//   <= (2 / sqrt 3) |x| |y| |z| <= 1.25 |x| |y| |z|, s = o - v0;
//   projecting the residual o + t d - (v0 + u e1 + w e2) on the dual
//   basis (d x e2, e1 x d, e1 x e2) bounds its pieces by those errors
//   with no division; dividing back by a* gives the distance from P* (or
//   from o, where t* < 0 < t) to the accepted point v0 + u e1 + w e2,
//   which lies in the triangle:
//     dist <= 1.25 u |d| P (15 |s| + 7 Q) / (|a*| - rho) + u (|s| + Q),
//   rho = |a - a*| + 2u |a| <= 8.75 u |d| P, the last term for the
//   rounding of s and of the edges. |a*| is at least max(1e-5, g) less
//   the error of a, where |a| >= 1e-5 is the test's own parallel cut and
//   g = |d|min (|c . n| cos_lo - P sin_hi) bounds |d . n| over the cone,
//   so a grazing bundle alone pays the 1e-5 floor. Hence, with
//   A = max(1e-5, g) - kSlack |d|max P and |s| <= |apex - centre| + r_o + R,
//     m = kC1 |d|max P (15 |s| + 7 Q) / A + kC2 (|s| + Q),
//   kC1 = 2 x 1.25 u and kC2 = 2u: twice the bound, for the second-order
//   terms and the rounding of m itself; where A <= 0 the triangle is
//   kept. tests/test_torch_nearest.py holds the cull conservative on rays
//   aimed at vertices and edges, grazing and parallel to faces, with zero
//   direction components and origins on the planes, and shows it losing
//   hits with m = 0; on the random grazing rays above the largest
//   distance was 0.07 of the bound before the factor 2.
//
// Numerics of the exact test: the TPU kernel's formula, operation by
// operation, with IEEE division and no FMA contraction (-fmad=false,
// ops/kernels/_lib.py), so it rounds where the plain PyTorch version
// (ops/kernels/intersect_mk.nearest_triangle_plain) rounds; e1 and e2 are
// the same subtractions made once in prep_kernel. The cull's own
// arithmetic is mirrored operation by operation by
// ops/kernels/intersect_mk.nearest_triangle_survivors_plain, so the plain
// model's survivor lists are the kernel's.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBlock = 256;   // rays per bundle (intersect_mk.BLOCK)
constexpr int kWarps = kBlock / 32;
constexpr int kCap = 512;     // exact records in the shared list
constexpr int kTargetBlocks = 2048;  // split a launch up to this many
constexpr float kEps = 1e-5f;
constexpr float kSlack = 0x1p-19f;
constexpr float kC1 = 2.5f * 0x1p-24f;
constexpr float kC2 = 2.0f * 0x1p-24f;
constexpr float kThird = 1.0f / 3.0f;
constexpr float kInf = INFINITY;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ float bigger(float a, float b) {
  return b > a ? b : a;
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__global__ void prep_kernel(const float* __restrict__ tris,
                            const float* __restrict__ valid, int n_tris,
                            float4* __restrict__ exact,
                            float4* __restrict__ cull) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_tris) return;
  const float* v = tris + 9 * (size_t)k;
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float v1x = v[3], v1y = v[4], v1z = v[5];
  const float v2x = v[6], v2y = v[7], v2z = v[8];
  const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float l1 = sqrtf(dot3(e1x, e1y, e1z, e1x, e1y, e1z));
  const float l2 = sqrtf(dot3(e2x, e2y, e2z, e2x, e2y, e2z));
  const float cx = (v0x + v1x + v2x) * kThird;
  const float cy = (v0y + v1y + v2y) * kThird;
  const float cz = (v0z + v1z + v2z) * kThird;
  float ax = v0x - cx, ay = v0y - cy, az = v0z - cz;
  float r2 = dot3(ax, ay, az, ax, ay, az);
  ax = v1x - cx, ay = v1y - cy, az = v1z - cz;
  r2 = bigger(r2, dot3(ax, ay, az, ax, ay, az));
  ax = v2x - cx, ay = v2y - cy, az = v2z - cz;
  r2 = bigger(r2, dot3(ax, ay, az, ax, ay, az));
  exact[3 * k] = make_float4(v0x, v0y, v0z, e1x);
  exact[3 * k + 1] = make_float4(e1y, e1z, e2x, e2y);
  exact[3 * k + 2] = make_float4(e2z, __int_as_float(k), 0.f, 0.f);
  cull[3 * k] = make_float4(cx, cy, cz, sqrtf(r2) * (1.0f + kSlack));
  cull[3 * k + 1] = make_float4(nx, ny, nz, l1 * l2);
  cull[3 * k + 2] =
      make_float4(l1 + l2, valid[k] >= 0.5f ? 1.f : 0.f, 0.f, 0.f);
}

// Block-wide minimum of kN values per thread, the same in every thread
// after the call (warp butterflies, then the warps' results in `red`).
template <int kN>
__device__ __forceinline__ void block_min(float (&x)[kN],
                                          float (*red)[16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      x[j] = fminf(x[j], __shfl_xor_sync(0xffffffffu, x[j], s));
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < kN; ++j) red[warp][j] = x[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    x[j] = red[0][j];
    for (int w = 1; w < kWarps; ++w) x[j] = fminf(x[j], red[w][j]);
  }
  __syncthreads();
}

// The exact test of one ray against the list, folded with a strict <.
__device__ __forceinline__ void fold(const float4* list, int count,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, float& best_t,
                                     int& best_i) {
  for (int j = 0; j < count; ++j) {
    const float4 r0 = list[3 * j], r1 = list[3 * j + 1],
                 r2 = list[3 * j + 2];
    const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
    const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const bool parallel = fabsf(a) < kEps;
    const float f = 1.0f / (parallel ? 1.0f : a);
    const float sx = ox - r0.x, sy = oy - r0.y, sz = oz - r0.z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float w = f * (dx * qx + dy * qy + dz * qz);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    const bool miss = parallel || u < 0.f || u > 1.f || w < 0.f ||
                      u + w > 1.f || t <= kEps;
    if (!miss && t < best_t) {
      best_t = t;
      best_i = __float_as_int(r2.y);
    }
  }
}

// kCount: also add the block's number of kept triangles to
// survivors[blockIdx.x]. kSplit: fold the blockIdx.y-th share of the
// triangle chunks and meet the other shares in keys (see above).
template <bool kCount, bool kSplit>
__global__ void __launch_bounds__(kBlock)
    nearest_tri_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int n, int n_tris,
                       const float4* __restrict__ exact,
                       const float4* __restrict__ cull,
                       float* __restrict__ t_out, int* __restrict__ i_out,
                       int* __restrict__ survivors,
                       unsigned long long* __restrict__ keys) {
  __shared__ float4 list[kCap * 3];
  __shared__ float red[kWarps][16];
  __shared__ int wcount[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (in) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
  }
  // ---- the bundle: rays that can hit anything take part
  const bool part = in && finite3(ox, oy, oz) && finite3(dx, dy, dz) &&
                    (dx != 0.f || dy != 0.f || dz != 0.f);
  const float ln = sqrtf(dot3(dx, dy, dz, dx, dy, dz));
  const bool wild = part && !(ln > 0.f && ln < kInf);
  const bool good = part && !wild;
  const float dnx = dx / ln, dny = dy / ln, dnz = dz / ln;
  float st[16] = {
      part ? ox : kInf,   part ? oy : kInf,   part ? oz : kInf,
      part ? -ox : kInf,  part ? -oy : kInf,  part ? -oz : kInf,
      good ? dnx : kInf,  good ? dny : kInf,  good ? dnz : kInf,
      good ? -dnx : kInf, good ? -dny : kInf, good ? -dnz : kInf,
      good ? ln : kInf,   good ? -ln : kInf,  part ? -1.f : 0.f,
      wild ? -1.f : 0.f};
  block_min(st, red);
  if (st[14] == 0.f) {  // no ray of the block can hit a triangle
    if (!kSplit && in) {
      t_out[i] = kInf;
      i_out[i] = -1;
    }
    return;
  }
  const float olox = st[0], oloy = st[1], oloz = st[2];
  const float ohix = -st[3], ohiy = -st[4], ohiz = -st[5];
  const float mx = (st[6] + -st[9]) * 0.5f;
  const float my = (st[7] + -st[10]) * 0.5f;
  const float mz = (st[8] + -st[11]) * 0.5f;
  const float dmin = st[12], dmax = -st[13];
  const bool any_wild = st[15] != 0.f;
  const float ml = sqrtf(dot3(mx, my, mz, mx, my, mz));
  const float cx = mx / ml, cy = my / ml, cz = mz / ml;
  {
    const float sx = dny * cz - dnz * cy;
    const float sy = dnz * cx - dnx * cz;
    const float sz = dnx * cy - dny * cx;
    st[0] = good ? dot3(dnx, dny, dnz, cx, cy, cz) : kInf;
    st[1] = good ? -sqrtf(dot3(sx, sy, sz, sx, sy, sz)) : kInf;
  }
  {
    float cs[2] = {st[0], st[1]};
    block_min(cs, red);
    st[0] = cs[0];
    st[1] = cs[1];
  }
  const float cos_lo = st[0] - kSlack, sin_hi = -st[1] + kSlack;
  const float acx = (olox + ohix) * 0.5f, acy = (oloy + ohiy) * 0.5f,
              acz = (oloz + ohiz) * 0.5f;
  const float hx = (ohix - olox) * 0.5f, hy = (ohiy - oloy) * 0.5f,
              hz = (ohiz - oloz) * 0.5f;
  const float r_o = sqrtf(dot3(hx, hy, hz, hx, hy, hz)) * (1.0f + kSlack) +
                    (fabsf(acx) + fabsf(acy) + fabsf(acz)) * 0x1p-22f;
  const bool cone = !any_wild && ml > 0.f && cos_lo > 0.f &&
                    isfinite(r_o) && finite3(acx, acy, acz) &&
                    finite3(cx, cy, cz);

  // ---- stream the cull records; fold the kept ones in ascending order
  float best_t = kInf;
  int best_i = -1;
  int count = 0, kept = 0;
  const int chunks = (n_tris + kBlock - 1) / kBlock;
  const int c0 = kSplit ? (int)((long long)blockIdx.y * chunks / gridDim.y)
                        : 0;
  const int c1 = kSplit ? (int)((long long)(blockIdx.y + 1) * chunks /
                                gridDim.y)
                        : chunks;
  for (int c = c0; c < c1; ++c) {
    const int k = c * kBlock + threadIdx.x;
    bool keep = false;
    if (k < n_tris) {
      const float4 c0 = __ldg(cull + 3 * k), c1 = __ldg(cull + 3 * k + 1),
                   c2 = __ldg(cull + 3 * k + 2);
      keep = c2.y > 0.5f;
      if (keep && cone) {
        const float R = c0.w, P = c1.w, Q = c2.x;
        const float vx = c0.x - acx, vy = c0.y - acy, vz = c0.z - acz;
        const float ax = dot3(vx, vy, vz, cx, cy, cz);
        const float px = vy * cz - vz * cy;
        const float py = vz * cx - vx * cz;
        const float pz = vx * cy - vy * cx;
        const float pp = sqrtf(dot3(px, py, pz, px, py, pz));
        const float vl = sqrtf(dot3(vx, vy, vz, vx, vy, vz));
        const float F = pp * cos_lo - (ax > 0.f ? ax : 0.f) * sin_hi;
        const float s = vl + r_o + R;
        const float cn = dot3(cx, cy, cz, c1.x, c1.y, c1.z);
        const float g = dmin * (fabsf(cn) * cos_lo - P * (sin_hi + kSlack));
        const float A = bigger(kEps, g) - kSlack * dmax * P;
        const float m = kC1 * dmax * P * (15.f * s + 7.f * Q) / A +
                        kC2 * (s + Q);
        const float thr = R + m + r_o + kSlack * vl;
        keep = !(A > 0.f) || !(F > thr);
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    int at = count, total = count;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    at += __popc(ball & ((1u << lane) - 1u));
    if (keep) {
      list[3 * at] = __ldg(exact + 3 * k);
      list[3 * at + 1] = __ldg(exact + 3 * k + 1);
      list[3 * at + 2] = __ldg(exact + 3 * k + 2);
    }
    kept += total - count;
    count = total;
    __syncthreads();
    if (count > kCap - kBlock || c + 1 == c1) {
      if (in) fold(list, count, ox, oy, oz, dx, dy, dz, best_t, best_i);
      count = 0;
      __syncthreads();
    }
  }
  if (kSplit && in && best_i >= 0)
    atomicMin(keys + i,
              (unsigned long long)__float_as_uint(best_t) << 32 |
                  (unsigned)best_i);
  if (!kSplit && in) {
    t_out[i] = best_t;
    i_out[i] = best_i;
  }
  if (kCount && threadIdx.x == 0) atomicAdd(survivors + blockIdx.x, kept);
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ keys,
                                int n, float* __restrict__ t_out,
                                int* __restrict__ i_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  t_out[i] = key == ~0ull ? kInf : __uint_as_float((unsigned)(key >> 32));
  i_out[i] = key == ~0ull ? -1 : (int)(unsigned)(key & 0xffffffffu);
}

template <bool kCount>
void launch(const float* o, const float* d, int n, int n_tris,
            const float4* exact, const float4* cull, float* t_out,
            int* i_out, int* survivors, unsigned long long* keys,
            cudaStream_t s) {
  const int blocks = (n + kBlock - 1) / kBlock;
  const int chunks = (n_tris + kBlock - 1) / kBlock;
  const int splits =
      chunks < 2 ? 1 : min(chunks, (kTargetBlocks + blocks - 1) / blocks);
  if (splits == 1) {
    nearest_tri_kernel<kCount, false><<<blocks, kBlock, 0, s>>>(
        o, d, n, n_tris, exact, cull, t_out, i_out, survivors, keys);
    return;
  }
  cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (size_t)n, s);
  nearest_tri_kernel<kCount, true><<<dim3(blocks, splits), kBlock, 0, s>>>(
      o, d, n, n_tris, exact, cull, t_out, i_out, survivors, keys);
  finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(keys, n, t_out, i_out);
}

}  // namespace

extern "C" {

// Nearest triangle for n rays (o, d [n,3]) against tris [n_tris, 9] with
// valid [n_tris] (>= 0.5 = live) on `stream`: t_out [n] (+inf on a miss),
// i_out [n] (-1). scratch: 24 n_tris floats, 16-byte aligned (the exact
// and cull records); keys: n 64-bit words where the launch is split
// (two or more chunks of triangles and fewer than kTargetBlocks blocks
// of rays), else unread and may be null. survivors: null, or
// [ceil(n / 256)] zeroed ints to which the counting instance adds each
// block's kept triangles. Returns cudaGetLastError() after the launches.
int urt_nearest_tri(const float* o, const float* d, const float* tris,
                    const float* valid, int n, int n_tris, float* scratch,
                    unsigned long long* keys, float* t_out, int* i_out,
                    int* survivors, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* exact = reinterpret_cast<float4*>(scratch);
  float4* cull = exact + 3 * (size_t)n_tris;
  if (n_tris > 0)
    prep_kernel<<<(n_tris + 255) / 256, 256, 0, s>>>(tris, valid, n_tris,
                                                      exact, cull);
  if (n > 0) {
    if (survivors)
      launch<true>(o, d, n, n_tris, exact, cull, t_out, i_out, survivors,
                   keys, s);
    else
      launch<false>(o, d, n, n_tris, exact, cull, t_out, i_out, survivors,
                    keys, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
