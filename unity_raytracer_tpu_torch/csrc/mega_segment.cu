// Fused bounce-segment kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel unity_raytracer_tpu/ops/pallas/mega.py:_kernel
// (its pallas_call is at mega.py:1398) in three modes, a template
// parameter each:
//   FORWARD      the hard forward the render runs: wide BVH4/8 walk,
//                Baldwin–Weber leaf records, one any-hit shadow walk per
//                light with the light_cull gate, Blinn-Phong shading on
//                the 0-255 scale and the mirror continuation;
//   RECORD       the same, plus the hit records of mega.py:958-971 for
//                the differentiable replay: t, shading normal, combined
//                material id and the per-light occlusion bits;
//   RECORD_SOFT  RECORD with the min-mode shadow walks of
//                mega.py:1064-1248 (and :105-273): per light the nearest
//                occluder closer than the light, written as st [N, L].
// It reads the host-built arrays unchanged (wide rows, tris_bw rows with a
// 128-float stride, leafmeta, the aux block of ops/kernels/mega.build_aux)
// and writes the five outputs of one segment, plus the records.
//
// Design: one thread per ray with a private stack of STACK (int code,
// float entry distance) entries. Each thread walks near-first with its own
// best_t: it slab-tests the children of a wide node against its own ray,
// sorts the hits by entry distance in registers and pushes them
// far-to-near; on pop it skips an entry whose entry distance exceeds its
// best_t. The TPU kernel's per-tile union walk, scalar SMEM cursor, shared
// stale prune and its tile_r / walk_unroll / occ_mode / near_mode knobs do
// not exist here: they were the TPU's answer to one cursor per tile and
// change no result. Any-hit shadow walks stop at the first occluder closer
// than the light, after testing spheres and loose triangles first. A
// min-mode walk starts from best = the light distance, lowers it with
// spheres and loose triangles (strict <), then walks near-first, pruning
// pops beyond best and lowering best on every closer hit; it never stops
// early. Its occlusion mask (best < best0) is the any-hit walk's, so the
// shading, delta and continuation of RECORD_SOFT equal FORWARD's.
//
// What bounds it on this card: divergent pointer chasing. The 32 rays of a
// warp visit different nodes and leaves, so the loads of the ~10 MB of BVH
// rows (they fit in the 50 MB L2) are scattered and serialised, and the
// per-thread stack lives in local memory beside a register-heavy ray state,
// which limits occupancy. wgmma and TMA do not apply: there is no dense
// tile product and no regular tile to copy. The record modes add 6 (RECORD)
// or 6 + L (RECORD_SOFT) output streams per lane, and RECORD_SOFT's
// min-mode walks visit every box nearer than the nearest occluder instead
// of stopping at the first one. This simple version does nothing about
// either yet beyond 16-byte loads of node and leaf records; the speed work
// is for later.
//
// A counting instance (template flag COUNT, launched only by chip_smoke.py
// to measure the work) adds each lane's slab tests, leaf-slot tests,
// sphere tests and Möller–Trumbore tests to four device counters; the
// kernel's bound in PERF.md is computed from them.
//
// Numerics follow the TPU kernel and the plain PyTorch version
// (ops/kernels/mega.py:trace_segment_plain) formula by formula: IEEE
// division, sqrtf/expf/logf, no fast-math, and no FMA contraction (built
// with -fmad=false, ops/kernels/_lib.py), so every product and sum rounds
// where the plain version rounds it. The two can then differ only by the
// last bits of expf/logf and by which of two hits at equal distance is
// met first.
// A push that would overflow the stack is dropped and counted in
// *overflow; the wrapper raises when the count is not zero.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kStack = 256;      // ops/kernels/traverse_wide.STACK
constexpr int kRow = 128;        // row stride of tris_bw and aux
constexpr int kLeafSlots = 14;   // PALLAS_LEAF: slots per leaf / meta row
constexpr int kBwPerRow = 10;    // BW_PER_ROW: records per tris_bw row
constexpr int kBlock = 128;
constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-5f;
constexpr float kShadowEps = 1e-4f;
constexpr float kTiny = 1e-30f;
// the TPU kernel clamps squared lengths with max(x, 1e-60); 1e-60 rounds
// to 0 in float32, so the clamp is max(x, 0)
constexpr float kMinSq = 0.0f;

enum Mode { kForward = 0, kRecord = 1, kRecordSoft = 2 };

struct Args {
  const float* o;
  const float* d;
  const float* thr;
  const float* tmax;
  const float* wide;
  const float* tris_bw;
  const float* leafmeta;
  const float* aux;
  float* delta;
  float* o2;
  float* d2;
  float* thr2;
  float* tmax2;
  int* overflow;
  int n;
  int depth;
  int leaf_rows;
  int bw_rows;
  int meta_w;
  int n_lights;
  int n_spheres;
  int n_tris;
  int n_mats;
  int max_bounces;
  float light_cull;
  // records (RECORD, RECORD_SOFT): t [n], n [n,3], matid [n], occbits [n],
  // st [n, n_lights] (RECORD_SOFT)
  float* rt;
  float* rn;
  float* rmat;
  float* rocc;
  float* rst;
  // COUNT: slab tests, leaf-slot tests, sphere tests, MT tests
  unsigned long long* counts;
};

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

template <bool COUNT>
struct Stack {
  int code[kStack];
  float key[kStack];
  int sp;
};

// the counting instance's stack also carries the lane's tallies
template <>
struct Stack<true> {
  int code[kStack];
  float key[kStack];
  int sp;
  unsigned long long slab, leaf, sphere, tri;
};

__device__ __forceinline__ float fix_dir(float v) {
  return fabsf(v) < kTiny ? (v < 0.f ? -kTiny : kTiny) : v;
}

__device__ __forceinline__ float rsqrt_clamped(float x) {
  return 1.0f / sqrtf(fmaxf(x, kMinSq));
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz,
             1.0f / fix_dir(dx), 1.0f / fix_dir(dy), 1.0f / fix_dir(dz)};
}

// Slab test of box (lo[0:3], hi[3:6]) over [0, best]; tn = entry distance.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, const Ray& r,
                                     float best, float& tn_out) {
  float t1 = (lx - r.ox) * r.ix;
  float t2 = (hx - r.ox) * r.ix;
  float tn = fminf(t1, t2);
  float tf = fmaxf(t1, t2);
  t1 = (ly - r.oy) * r.iy;
  t2 = (hy - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  t1 = (lz - r.oz) * r.iz;
  t2 = (hz - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  tn = fmaxf(tn, 0.f);
  tn_out = tn;
  return tn <= tf && tn <= best;
}

// Baldwin–Weber test of one 12-float record (16-byte aligned: records sit
// at 48-byte offsets in 512-byte rows).
__device__ __forceinline__ bool bw_hit(const float* rec, const Ray& r,
                                       float& t, float& nx, float& ny,
                                       float& nz) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(rec));
  const float4 b = __ldg(reinterpret_cast<const float4*>(rec) + 1);
  const float4 c = __ldg(reinterpret_cast<const float4*>(rec) + 2);
  nx = a.x;
  ny = a.y;
  nz = a.z;
  const float nd = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const bool par = fabsf(nd) < kTiny;
  t = (a.w - (a.x * r.ox + a.y * r.oy + a.z * r.oz)) / (par ? 1.0f : nd);
  const float hx = r.ox + r.dx * t;
  const float hy = r.oy + r.dy * t;
  const float hz = r.oz + r.dz * t;
  const float u = b.x * hx + b.y * hy + b.z * hz + b.w;
  const float v = c.x * hx + c.y * hy + c.z * hz + c.w;
  return !par && u >= 0.f && v >= 0.f && u + v <= 1.f && t > kEps;
}

// Möller–Trumbore against one loose triangle (9 floats v0 v1 v2).
__device__ __forceinline__ bool mt_hit(const float* v, const Ray& r,
                                       float& t) {
  const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
  const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool par = fabsf(det) < kEps;
  const float f = 1.0f / (par ? 1.0f : det);
  const float sx = r.ox - v[0], sy = r.oy - v[1], sz = r.oz - v[2];
  const float u = f * (sx * px + sy * py + sz * pz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float w = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return !par && u >= 0.f && u <= 1.f && w >= 0.f && u + w <= 1.f &&
         t > kEps;
}

// Sphere row of aux: center(0:3) r2(3) valid(4) matid(5).
__device__ __forceinline__ bool sphere_hit(const float* s, const Ray& r,
                                           float& t) {
  const float ocx = r.ox - s[0], ocy = r.oy - s[1], ocz = r.oz - s[2];
  const float uoc = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
  const float disc = uoc * uoc - (oc2 - s[3]);
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float big = -uoc + sq;
  const float small = -uoc - sq;
  t = small < 0.f ? big : small;
  return disc >= 0.f && big >= 0.f && s[4] > 0.f;
}

// Leaf stack entries: code = -2 - (leaf_row * 256 + count); interior
// entries are the wide row (>= 0).
__device__ __forceinline__ int leaf_code(int leaf_row, int count) {
  return -2 - (leaf_row * 256 + count);
}

template <bool C>
__device__ __forceinline__ void push(Stack<C>& st, int code, float key,
                                     int* overflow) {
  if (st.sp < kStack) {
    st.code[st.sp] = code;
    st.key[st.sp] = key;
    ++st.sp;
  } else {
    atomicAdd(overflow, 1);
  }
}

// Pop the nearest entry that can still beat `best`; false when empty.
template <bool C>
__device__ __forceinline__ bool pop(Stack<C>& st, float best, int& code) {
  while (st.sp > 0) {
    --st.sp;
    if (st.key[st.sp] <= best) {
      code = st.code[st.sp];
      return true;
    }
  }
  return false;
}

// Slab-test the ARITY children of wide row `node`; push the hits
// far-to-near (ORDERED) or in reverse slot order.
template <int ARITY, bool ORDERED, bool C>
__device__ __forceinline__ void expand(const Args& a, int node, const Ray& r,
                                       float best, Stack<C>& st) {
  const float4* row =
      reinterpret_cast<const float4*>(a.wide + (size_t)node * 8 * ARITY);
  float key[ARITY];
  int code[ARITY];
#pragma unroll
  for (int c = 0; c < ARITY; ++c) {
    const float4 lo = __ldg(row + 2 * c);      // lx ly lz hx
    const float4 hi = __ldg(row + 2 * c + 1);  // hy hz meta count
    if constexpr (C) st.slab += hi.w >= 0.f;
    float tn;
    const bool hit = hi.w >= 0.f &&
                     slab(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, best, tn);
    key[c] = hit ? tn : INFINITY;
    const int meta = static_cast<int>(hi.z);
    code[c] = hi.w > 0.f ? leaf_code(meta, static_cast<int>(hi.w)) : meta;
  }
  if (ORDERED) {
#pragma unroll
    for (int i = 1; i < ARITY; ++i) {
#pragma unroll
      for (int j = i; j > 0; --j) {
        if (key[j - 1] > key[j]) {
          const float k = key[j - 1];
          key[j - 1] = key[j];
          key[j] = k;
          const int e = code[j - 1];
          code[j - 1] = code[j];
          code[j] = e;
        }
      }
    }
  }
#pragma unroll
  for (int c = ARITY - 1; c >= 0; --c) {
    if (key[c] < INFINITY) push(st, code[c], key[c], a.overflow);
  }
}

__device__ __forceinline__ const float* bw_record(const Args& a,
                                                  int leaf_row, int j) {
  const int bwbase = (leaf_row / a.leaf_rows) * a.bw_rows;
  return a.tris_bw + (size_t)(bwbase + j / kBwPerRow) * kRow +
         12 * (j % kBwPerRow);
}

// Nearest mesh hit: near-first walk with a per-thread best_t.
template <int ARITY, bool C>
__device__ void nearest_mesh(const Args& a, const Ray& r, Stack<C>& st,
                             float& best_t, float& bnx, float& bny,
                             float& bnz, float& bmat) {
  st.sp = 0;
  int cursor = 0;  // wide row 0 holds the root's children
  do {
    if (cursor >= 0) {
      expand<ARITY, true>(a, cursor, r, best_t, st);
    } else {
      const int x = -2 - cursor;
      const int leaf_row = x >> 8;
      const int count = x & 255;
      if constexpr (C) st.leaf += count;
      for (int j = 0; j < count; ++j) {
        float t, nx, ny, nz;
        if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) &&
            t < best_t) {
          best_t = t;
          // the stored unit plane normal is the shading normal
          bnx = nx;
          bny = ny;
          bnz = nz;
          bmat = __ldg(a.leafmeta + (size_t)(leaf_row + j / kLeafSlots) *
                                        a.meta_w + j % kLeafSlots);
        }
      }
    }
  } while (pop(st, best_t, cursor));
}

// Any-hit mesh occlusion closer than tmax.
template <int ARITY, bool C>
__device__ bool occluded_mesh(const Args& a, const Ray& r, float tmax,
                              Stack<C>& st) {
  st.sp = 0;
  int cursor = 0;
  do {
    if (cursor >= 0) {
      expand<ARITY, false>(a, cursor, r, tmax, st);
    } else {
      const int x = -2 - cursor;
      const int leaf_row = x >> 8;
      const int count = x & 255;
      for (int j = 0; j < count; ++j) {
        if constexpr (C) ++st.leaf;
        float t, nx, ny, nz;
        if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) &&
            t < tmax)
          return true;
      }
    }
  } while (pop(st, tmax, cursor));
  return false;
}

// Shadow query from s toward a light at distance tmax (TPU _occluded):
// scene-box gate, spheres, loose triangles, then the BVH.
template <int ARITY, bool C>
__device__ bool occluded(const Args& a, const Ray& r, float tmax,
                         Stack<C>& st) {
  float tn;
  if constexpr (C) ++st.slab;
  if (!slab(a.aux[0], a.aux[1], a.aux[2], a.aux[3], a.aux[4], a.aux[5], r,
            kBig, tn))
    return false;
  if (!(tmax > 0.f)) return false;
  const float* srow = a.aux + (size_t)(1 + a.n_lights) * kRow;
  for (int s = 0; s < a.n_spheres; ++s, srow += kRow) {
    if constexpr (C) ++st.sphere;
    float t;
    if (sphere_hit(srow, r, t) && t < tmax) return true;
  }
  const float* trow = a.aux + (size_t)(1 + a.n_lights + a.n_spheres) * kRow;
  for (int k = 0; k < a.n_tris; ++k, trow += kRow) {
    if constexpr (C) ++st.tri;
    float t;
    if (mt_hit(trow, r, t) && trow[12] > 0.f && t < tmax) return true;
  }
  return occluded_mesh<ARITY>(a, r, tmax, st);
}

// Min-mode shadow query (TPU _occluded with min_mode): the nearest
// occluder t below best0, where best0 is the light distance, or -1 when
// the ray starts outside the scene box. Returns best0 itself when nothing
// is closer. Never retires early: the walk pops every entry nearer than
// the running best.
template <int ARITY, bool C>
__device__ float nearest_occluder(const Args& a, const Ray& r, float best0,
                                  Stack<C>& st) {
  float best = best0;
  const float* srow = a.aux + (size_t)(1 + a.n_lights) * kRow;
  for (int s = 0; s < a.n_spheres; ++s, srow += kRow) {
    if constexpr (C) ++st.sphere;
    float t;
    if (sphere_hit(srow, r, t) && t < best) best = t;
  }
  const float* trow = a.aux + (size_t)(1 + a.n_lights + a.n_spheres) * kRow;
  for (int k = 0; k < a.n_tris; ++k, trow += kRow) {
    if constexpr (C) ++st.tri;
    float t;
    if (mt_hit(trow, r, t) && trow[12] > 0.f && t < best) best = t;
  }
  if (!(best > 0.f)) return best;
  st.sp = 0;
  int cursor = 0;
  do {
    if (cursor >= 0) {
      expand<ARITY, true>(a, cursor, r, best, st);
    } else {
      const int x = -2 - cursor;
      const int leaf_row = x >> 8;
      const int count = x & 255;
      if constexpr (C) st.leaf += count;
      for (int j = 0; j < count; ++j) {
        float t, nx, ny, nz;
        if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) && t < best)
          best = t;
      }
    }
  } while (pop(st, best, cursor));
  return best;
}

template <int ARITY, int MODE, bool C>
__global__ void __launch_bounds__(kBlock) mega_segment_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  const float tr = a.thr[3 * i], tg = a.thr[3 * i + 1],
              tb = a.thr[3 * i + 2];
  float* delta = a.delta + 3 * i;
  float* o2 = a.o2 + 3 * i;
  float* d2 = a.d2 + 3 * i;
  float* thr2 = a.thr2 + 3 * i;

  if (!(a.tmax[i] >= 0.f)) {  // dead lane: pass-through
    delta[0] = delta[1] = delta[2] = 0.f;
    o2[0] = ox; o2[1] = oy; o2[2] = oz;
    d2[0] = dx; d2[1] = dy; d2[2] = dz;
    thr2[0] = tr; thr2[1] = tg; thr2[2] = tb;
    a.tmax2[i] = -1.f;
    if constexpr (MODE != kForward) {  // record defaults (mega.py:528-536)
      a.rt[i] = -1.f;
      a.rn[3 * i] = a.rn[3 * i + 1] = a.rn[3 * i + 2] = 0.f;
      a.rmat[i] = -1.f;
      a.rocc[i] = 0.f;
      if constexpr (MODE == kRecordSoft)
        for (int l = 0; l < a.n_lights; ++l)
          a.rst[(size_t)i * a.n_lights + l] = kBig;
    }
    return;
  }

  Stack<C> st;
  if constexpr (C) st.slab = st.leaf = st.sphere = st.tri = 0;
  const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
  const int L = a.n_lights, S = a.n_spheres, T = a.n_tris;

  // ---- nearest hit: mesh (strict <), then spheres, then loose tris
  //      (strict >, the reference combine order Scene.cs:94,107) -------
  float best_t = kBig, bnx = 0.f, bny = 0.f, bnz = 0.f, bmat = -1.f;
  nearest_mesh<ARITY>(a, r, st, best_t, bnx, bny, bnz, bmat);

  const float* srow = a.aux + (size_t)(1 + L) * kRow;
  for (int s = 0; s < S; ++s, srow += kRow) {
    if constexpr (C) ++st.sphere;
    float ts;
    if (sphere_hit(srow, r, ts) && best_t > ts) {
      const float rinv = rsqrt_clamped(srow[3]);
      const float px = ox + dx * ts - srow[0];
      const float py = oy + dy * ts - srow[1];
      const float pz = oz + dz * ts - srow[2];
      best_t = ts;
      bnx = px * rinv;
      bny = py * rinv;
      bnz = pz * rinv;
      bmat = srow[5];
    }
  }
  const float* trow = a.aux + (size_t)(1 + L + S) * kRow;
  for (int k = 0; k < T; ++k, trow += kRow) {
    if constexpr (C) ++st.tri;
    float tt;
    if (mt_hit(trow, r, tt) && trow[12] > 0.f && best_t > tt) {
      best_t = tt;
      bnx = trow[9];
      bny = trow[10];
      bnz = trow[11];
      bmat = trow[13];
    }
  }

  float tn_box;
  if constexpr (C) ++st.slab;
  const bool in_box = slab(a.aux[0], a.aux[1], a.aux[2], a.aux[3], a.aux[4],
                           a.aux[5], r, kBig, tn_box);
  const bool hit = in_box && best_t < kBig && best_t >= 0.f;

  // ---- material: diffuse ambient mirror specular phong is_mirror -------
  float m[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) m[j] = 0.f;
  const int mi = static_cast<int>(bmat);
  if (bmat >= 0.f && mi < a.n_mats && static_cast<float>(mi) == bmat) {
    const float* mrow = a.aux + (size_t)(1 + L + S + T + mi) * kRow;
#pragma unroll
    for (int j = 0; j < 14; ++j) m[j] = mrow[j];
  }

  const float t_safe = hit ? best_t : 1.0f;
  const float px = ox + dx * t_safe;
  const float py = oy + dy * t_safe;
  const float pz = oz + dz * t_safe;

  // ---- direct lighting (RayTracingSetup.cs:324-455) --------------------
  float col_r = m[3] * a.aux[6];
  float col_g = m[4] * a.aux[7];
  float col_b = m[5] * a.aux[8];
  const float sx = px + bnx * kShadowEps;
  const float sy = py + bny * kShadowEps;
  const float sz = pz + bnz * kShadowEps;
  const float kdks = fmaxf(fmaxf(m[0], m[1]), m[2]) +
                     fmaxf(fmaxf(m[9], m[10]), m[11]);
  float occbits = 0.f;  // RECORD modes: sum of 2^l over occluded lights
  if constexpr (MODE == kRecordSoft)
    for (int l = 0; l < L; ++l) a.rst[(size_t)i * L + l] = kBig;
  const float* lrow = a.aux + kRow;
  for (int l = 0; l < L; ++l, lrow += kRow) {
    const float lvx = lrow[0] - px, lvy = lrow[1] - py, lvz = lrow[2] - pz;
    const float ld2 = lvx * lvx + lvy * lvy + lvz * lvz;
    const float ldist = sqrtf(ld2);
    const float linv = rsqrt_clamped(ld2);
    const float ldx = lvx * linv, ldy = lvy * linv, ldz = lvz * linv;
    const float ln = ldx * bnx + ldy * bny + ldz * bnz;
    bool need = hit && ln >= 0.f && lrow[6] > 0.f;
    if (a.light_cull > 0.f) {
      const float imax = fmaxf(fmaxf(lrow[3], lrow[4]), lrow[5]);
      need = need && kdks * imax >= a.light_cull * ld2;
    }
    if (!need) continue;  // a culled or unneeded light is not occluded
    bool occ;
    if constexpr (MODE == kRecordSoft) {
      const Ray sr = make_ray(sx, sy, sz, ldx, ldy, ldz);
      float tn;
      if constexpr (C) ++st.slab;
      const float best0 = slab(a.aux[0], a.aux[1], a.aux[2], a.aux[3],
                               a.aux[4], a.aux[5], sr, kBig, tn)
                              ? ldist
                              : -1.f;
      const float best = nearest_occluder<ARITY>(a, sr, best0, st);
      occ = best < best0 && best0 > 0.f;
      if (occ) a.rst[(size_t)i * L + l] = best;
    } else {
      occ = occluded<ARITY>(a, make_ray(sx, sy, sz, ldx, ldy, ldz), ldist,
                            st);
    }
    if constexpr (MODE != kForward) {
      if (occ) occbits += static_cast<float>(1 << l);
    }
    if (occ) continue;
    const float w = 1.0f / fmaxf(ld2, kMinSq);  // Intensity / d^2 (:350)
    const float dterm = fmaxf(0.f, ln) * w;
    col_r += m[0] * dterm * lrow[3];
    col_g += m[1] * dterm * lrow[4];
    col_b += m[2] * dterm * lrow[5];
    // Blinn-Phong specular, halfway (l + v)/|.| with v = -d
    const float hx = ldx - dx, hy = ldy - dy, hz = ldz - dz;
    const float hinv = rsqrt_clamped(hx * hx + hy * hy + hz * hz);
    const float nh =
        fmaxf(0.f, bnx * hx * hinv + bny * hy * hinv + bnz * hz * hinv);
    const float sterm =
        (nh > 0.f ? expf(m[12] * logf(fmaxf(nh, kTiny))) : 0.f) * w;
    col_r += m[9] * sterm * lrow[3];
    col_g += m[10] * sterm * lrow[4];
    col_b += m[11] * sterm * lrow[5];
  }

  delta[0] = tr * (hit ? col_r : a.aux[9]);
  delta[1] = tg * (hit ? col_g : a.aux[10]);
  delta[2] = tb * (hit ? col_b : a.aux[11]);

  // ---- hit records for the replay (mega.py:958-971) --------------------
  if constexpr (MODE != kForward) {
    a.rt[i] = hit ? best_t : -1.f;
    a.rn[3 * i] = bnx;
    a.rn[3 * i + 1] = bny;
    a.rn[3 * i + 2] = bnz;
    a.rmat[i] = hit ? bmat : -1.f;
    a.rocc[i] = occbits;
  }

  // ---- mirror continuation (:358-373) ----------------------------------
  const bool cont = hit && m[13] > 0.f && a.depth < a.max_bounces;
  const float ddn = dx * bnx + dy * bny + dz * bnz;
  o2[0] = px + bnx * kShadowEps;
  o2[1] = py + bny * kShadowEps;
  o2[2] = pz + bnz * kShadowEps;
  d2[0] = cont ? dx - 2.0f * bnx * ddn : dx;
  d2[1] = cont ? dy - 2.0f * bny * ddn : dy;
  d2[2] = cont ? dz - 2.0f * bnz * ddn : dz;
  a.tmax2[i] = cont ? kBig : -1.f;
  thr2[0] = cont ? tr * m[6] : tr;
  thr2[1] = cont ? tg * m[7] : tg;
  thr2[2] = cont ? tb * m[8] : tb;

  if constexpr (C) {
    atomicAdd(a.counts, st.slab);
    atomicAdd(a.counts + 1, st.leaf);
    atomicAdd(a.counts + 2, st.sphere);
    atomicAdd(a.counts + 3, st.tri);
  }
}

template <int ARITY>
cudaError_t launch(const Args& a, int mode, bool count, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  switch (mode * 2 + (count ? 1 : 0)) {
    case 0:
      mega_segment_kernel<ARITY, kForward, false><<<grid, kBlock, 0, s>>>(a);
      break;
    case 1:
      mega_segment_kernel<ARITY, kForward, true><<<grid, kBlock, 0, s>>>(a);
      break;
    case 2:
      mega_segment_kernel<ARITY, kRecord, false><<<grid, kBlock, 0, s>>>(a);
      break;
    case 3:
      mega_segment_kernel<ARITY, kRecord, true><<<grid, kBlock, 0, s>>>(a);
      break;
    case 4:
      mega_segment_kernel<ARITY, kRecordSoft, false><<<grid, kBlock, 0, s>>>(a);
      break;
    case 5:
      mega_segment_kernel<ARITY, kRecordSoft, true><<<grid, kBlock, 0, s>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One segment over n rays on `stream`, in `mode` (0 FORWARD, 1 RECORD,
// 2 RECORD_SOFT). The record pointers (rt, rn, rmat, rocc; rst for
// RECORD_SOFT) may point into larger buffers, e.g. one segment's rows of a
// [B, n] array; they are unused in FORWARD. A non-null `counts` (4 x u64)
// selects the counting instance. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an arity or mode without an instance
// or a missing record pointer).
int urt_mega_segment(const float* o, const float* d, const float* thr,
                     const float* tmax, int n, int depth, const float* wide,
                     int arity, const float* tris_bw, int leaf_rows,
                     int bw_rows, const float* leafmeta, int meta_w,
                     const float* aux, int n_lights, int n_spheres,
                     int n_tris, int n_mats, int max_bounces,
                     float light_cull, float* delta, float* o2, float* d2,
                     float* thr2, float* tmax2, int* overflow, int mode,
                     float* rt, float* rn, float* rmat, float* rocc,
                     float* rst, unsigned long long* counts, void* stream) {
  if (mode != kForward &&
      (!rt || !rn || !rmat || !rocc ||
       (mode == kRecordSoft && n_lights > 0 && !rst)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{o, d, thr, tmax, wide, tris_bw, leafmeta, aux,
               delta, o2, d2, thr2, tmax2, overflow,
               n, depth, leaf_rows, bw_rows, meta_w,
               n_lights, n_spheres, n_tris, n_mats, max_bounces,
               light_cull, rt, rn, rmat, rocc, rst, counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool count = counts != nullptr;
  switch (arity) {
    case 4:
      return static_cast<int>(launch<4>(a, mode, count, s));
    case 8:
      return static_cast<int>(launch<8>(a, mode, count, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
