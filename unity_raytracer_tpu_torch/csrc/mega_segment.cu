// Fused bounce-segment kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel unity_raytracer_tpu/ops/pallas/mega.py:_kernel
// (its pallas_call is at mega.py:1398) in all its modes, a template
// parameter each:
//   FORWARD      the hard forward the render runs: nearest hit, one
//                any-hit shadow walk per light with the light_cull gate,
//                Blinn-Phong shading on the 0-255 scale and the mirror
//                continuation;
//   RECORD       the same, plus the hit records of mega.py:958-971 for
//                the differentiable replay: t, shading normal, combined
//                material id and the per-light occlusion bits;
//   RECORD_SOFT  RECORD with the min-mode shadow walks of
//                mega.py:1064-1248 (and :105-273): per light the nearest
//                occluder closer than the light, written as st [N, L];
//   FORK         the dielectric tree's level (mega.py:976-1045): instead
//                of the mirror continuation, the reflect child (mirrors
//                and dielectrics, Schlick Fresnel) on the base outputs and
//                the refract child (dielectrics without total internal
//                reflection) on four more.
// Two more template parameters pick the mesh walk (the twin's mode e):
//   LAYOUT       kWide4 / kWide8: the wide BVH4/8 rows (ops/kernels/
//                traverse_wide.widen), near-first with a 256-entry stack;
//                kBinary: the binary node rows (bvh_arity = 0), the
//                ordered walk of traverse_mk4 for the nearest hit and the
//                threaded walk of traverse_mk3 for shadows
//                (bvh_walk.cuh); kMeshless: no walk and no table read
//                (has_mesh = False, a scene without mesh triangles);
//   MT           the leaf test: Möller–Trumbore on the vertex rows `tris`
//                (14 triangles of 9 floats per 128-float row, the
//                bake-convention normal -cross(v2-v0, v1-v0)/|.| of
//                mega.py:594-604), or Baldwin–Weber on the `tris_bw`
//                records (wide layouts only) whose stored plane normal is
//                the shading normal.
// It reads the host-built arrays unchanged (wide rows or binary nodes,
// tris or tris_bw rows with a 128-float stride, leafmeta, the aux block of
// ops/kernels/mega.build_aux) and writes the five outputs of one segment,
// plus the records or the refract child.
//
// Design: one thread per ray with a private stack. The wide walk keeps
// STACK (int code, float entry distance) entries: it slab-tests the
// children of a wide node against its own ray, sorts the hits by entry
// distance in registers and pushes them far-to-near; on pop it skips an
// entry whose entry distance exceeds its best_t. The binary walks are the
// traversal kernels' own (bvh_walk.cuh) with this kernel's leaf tests. The
// TPU kernel's per-tile union walk, scalar SMEM cursor, shared stale prune
// and its tile_r / walk_unroll / occ_mode / near_mode knobs do not exist
// here: they were the TPU's answer to one cursor per tile and change no
// result. Any-hit shadow walks stop at the first occluder closer than the
// light, after testing spheres and loose triangles first. A min-mode walk
// starts from best = the light distance, lowers it with spheres and loose
// triangles (strict <), then walks near-first (threaded on the binary
// layout), pruning by best and lowering it on every closer hit; it never
// stops early. Its occlusion mask (best < best0) is the any-hit walk's, so
// the shading, delta and continuation of RECORD_SOFT equal FORWARD's. The
// binary walks test a leaf's slots up to its triangle count; the wide
// walks too (the count rides in the stack code), where the twin tests
// every slot of the leaf's rows: the slots past the count are all-zero
// triangles that no ray hits, so both find the same hits.
//
// What bounds it on this card: divergent pointer chasing. The 32 rays of a
// warp visit different nodes and leaves, so the loads of the ~10 MB of BVH
// rows (they fit in the 50 MB L2) are scattered and serialised, and the
// per-thread stack lives in local memory beside a register-heavy ray state,
// which limits occupancy. wgmma and TMA do not apply: there is no dense
// tile product and no regular tile to copy. The record modes add 6 (RECORD)
// or 6 + L (RECORD_SOFT) output streams per lane and FORK 10; RECORD_SOFT's
// min-mode walks visit every box nearer than the nearest occluder instead
// of stopping at the first one. This simple version does nothing about
// either yet beyond 16-byte loads of node and Baldwin–Weber records; the
// speed work is for later.
//
// A counting instance (template flag C, launched only by chip_smoke.py to
// measure the work, built only where it reads one) adds each lane's slab
// tests, Baldwin–Weber leaf-slot tests, sphere tests and Möller–Trumbore
// tests (loose triangles and MT leaf slots) to four device counters; the
// kernel's bound in PERF.md is computed from them.
//
// Numerics follow the TPU kernel and the plain PyTorch version
// (ops/kernels/mega.py:trace_segment_plain) formula by formula: IEEE
// division, sqrtf/expf/logf, no fast-math, and no FMA contraction (built
// with -fmad=false, ops/kernels/_lib.py), so every product and sum rounds
// where the plain version rounds it; the Fresnel powers are the products
// XLA lowers ** 2 and ** 5 to. The two can then differ only by the last
// bits of expf/logf and by which of two hits at equal distance is met
// first.
// A push that would overflow the stack is dropped and counted in
// *overflow; the wrapper raises when the count is not zero.
//
// Instances: -DURT_MEGA_GROUP picks one library's (ops/kernels/_lib.py):
// 4 the BVH4 rows, 8 the BVH8 rows, 0 the binary rows and the meshless
// fork; without it every instance is built (the ptxas report).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bvh_walk.cuh"

namespace {

using namespace urt;

constexpr int kStack = 256;      // ops/kernels/traverse_wide.STACK
constexpr int kBwPerRow = 10;    // BW_PER_ROW: records per tris_bw row
constexpr int kBlock = 128;
constexpr float kBig = 3.0e38f;
constexpr float kShadowEps = 1e-4f;
// the TPU kernel clamps squared lengths with max(x, 1e-60); 1e-60 rounds
// to 0 in float32, so the clamp is max(x, 0)
constexpr float kMinSq = 0.0f;

enum Mode { kForward = 0, kRecord = 1, kRecordSoft = 2, kFork = 3 };
enum Layout { kMeshless = 0, kBinary = 1, kWide4 = 4, kWide8 = 8 };

struct Args {
  const float* o;
  const float* d;
  const float* thr;
  const float* tmax;
  const float* table;  // wide rows [Nw, 8*arity] or binary nodes [Nn, 16]
  const float* leaf;   // tris_bw (Baldwin–Weber) or tris (MT) rows
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
  // COUNT: slab tests, BW leaf-slot tests, sphere tests, MT tests
  unsigned long long* counts;
  // FORK: the refract child o [n,3], d [n,3], weight [n,3], tmax [n]
  float* o3;
  float* d3;
  float* thr3;
  float* tmax3;
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

__device__ __forceinline__ float rsqrt_clamped(float x) {
  return 1.0f / sqrtf(fmaxf(x, kMinSq));
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

// The bake-convention shading normal of a 9-float triangle (mega.py:
// 594-604): -c / |c| with c = cross(v2 - v0, v1 - v0).
__device__ __forceinline__ void tri_normal(const float* v, float& nx,
                                           float& ny, float& nz) {
  const float v0x = __ldg(v), v0y = __ldg(v + 1), v0z = __ldg(v + 2);
  const float e1x = __ldg(v + 6) - v0x, e1y = __ldg(v + 7) - v0y,
              e1z = __ldg(v + 8) - v0z;
  const float e2x = __ldg(v + 3) - v0x, e2y = __ldg(v + 4) - v0y,
              e2z = __ldg(v + 5) - v0z;
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  const float inv = -rsqrt_clamped(cx * cx + cy * cy + cz * cz);
  nx = cx * inv;
  ny = cy * inv;
  nz = cz * inv;
}

// Möller–Trumbore against a loose triangle's aux row v0 v1 v2 (0:9), read
// with plain loads: through __ldg the forward BVH4 instance needs 8 more
// registers (ptxas, PERF.md).
__device__ __forceinline__ bool mt_aux(const float* v, const Ray& r,
                                       float& t) {
  return mt_test(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], r, t);
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

// ---- leaf slots: slot j of the leaf whose first tris row is leaf_row ----

__device__ __forceinline__ const float* bw_record(const Args& a,
                                                  int leaf_row, int j) {
  const int bwbase = (leaf_row / a.leaf_rows) * a.bw_rows;
  return a.leaf + (size_t)(bwbase + j / kBwPerRow) * kRow +
         12 * (j % kBwPerRow);
}

__device__ __forceinline__ const float* mt_slot(const Args& a, int leaf_row,
                                                int j) {
  return a.leaf + (size_t)(leaf_row + j / kLeafSlots) * kRow +
         9 * (j % kLeafSlots);
}

__device__ __forceinline__ float slot_matid(const Args& a, int leaf_row,
                                            int j) {
  return __ldg(a.leafmeta + (size_t)(leaf_row + j / kLeafSlots) * a.meta_w +
               j % kLeafSlots);
}

// Nearest-hit tests of a leaf's `count` slots (strict <): the winner's t,
// shading normal and material id.
template <bool MT, bool C>
__device__ __forceinline__ void near_leaf(const Args& a, int leaf_row,
                                          int count, const Ray& r,
                                          Stack<C>& st, float& best_t,
                                          float& bnx, float& bny,
                                          float& bnz, float& bmat) {
  if constexpr (MT) {
    if constexpr (C) st.tri += count;
    for (int j = 0; j < count; ++j) {
      const float* v = mt_slot(a, leaf_row, j);
      float t;
      if (mt_hit(v, r, t) && t < best_t) {
        best_t = t;
        tri_normal(v, bnx, bny, bnz);
        bmat = slot_matid(a, leaf_row, j);
      }
    }
  } else {
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
        bmat = slot_matid(a, leaf_row, j);
      }
    }
  }
}

// Any-hit test of a leaf's slots: true at the first one closer than tmax.
template <bool MT, bool C>
__device__ __forceinline__ bool any_leaf(const Args& a, int leaf_row,
                                         int count, const Ray& r,
                                         float tmax, Stack<C>& st) {
  for (int j = 0; j < count; ++j) {
    float t;
    if constexpr (MT) {
      if constexpr (C) ++st.tri;
      if (mt_hit(mt_slot(a, leaf_row, j), r, t) && t < tmax) return true;
    } else {
      if constexpr (C) ++st.leaf;
      float nx, ny, nz;
      if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) && t < tmax)
        return true;
    }
  }
  return false;
}

// Min-mode test of a leaf's slots: best lowered to the nearest hit.
template <bool MT, bool C>
__device__ __forceinline__ void min_leaf(const Args& a, int leaf_row,
                                         int count, const Ray& r,
                                         float& best, Stack<C>& st) {
  if constexpr (C) (MT ? st.tri : st.leaf) += count;
  for (int j = 0; j < count; ++j) {
    float t;
    if constexpr (MT) {
      if (mt_hit(mt_slot(a, leaf_row, j), r, t) && t < best) best = t;
    } else {
      float nx, ny, nz;
      if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) && t < best)
        best = t;
    }
  }
}

// ---- the wide walks ------------------------------------------------------

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
      reinterpret_cast<const float4*>(a.table + (size_t)node * 8 * ARITY);
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

// Nearest mesh hit: near-first walk with a per-thread best_t.
template <int ARITY, bool MT, bool C>
__device__ void nearest_wide(const Args& a, const Ray& r, Stack<C>& st,
                             float& best_t, float& bnx, float& bny,
                             float& bnz, float& bmat) {
  st.sp = 0;
  int cursor = 0;  // wide row 0 holds the root's children
  do {
    if (cursor >= 0) {
      expand<ARITY, true>(a, cursor, r, best_t, st);
    } else {
      const int x = -2 - cursor;
      near_leaf<MT>(a, x >> 8, x & 255, r, st, best_t, bnx, bny, bnz, bmat);
    }
  } while (pop(st, best_t, cursor));
}

// Any-hit mesh occlusion closer than tmax.
template <int ARITY, bool MT, bool C>
__device__ bool occluded_wide(const Args& a, const Ray& r, float tmax,
                              Stack<C>& st) {
  st.sp = 0;
  int cursor = 0;
  do {
    if (cursor >= 0) {
      expand<ARITY, false>(a, cursor, r, tmax, st);
    } else {
      const int x = -2 - cursor;
      if (any_leaf<MT>(a, x >> 8, x & 255, r, tmax, st)) return true;
    }
  } while (pop(st, tmax, cursor));
  return false;
}

// Min-mode mesh walk: best lowered to the nearest occluder below it.
template <int ARITY, bool MT, bool C>
__device__ void min_wide(const Args& a, const Ray& r, float& best,
                         Stack<C>& st) {
  st.sp = 0;
  int cursor = 0;
  do {
    if (cursor >= 0) {
      expand<ARITY, true>(a, cursor, r, best, st);
    } else {
      const int x = -2 - cursor;
      min_leaf<MT>(a, x >> 8, x & 255, r, best, st);
    }
  } while (pop(st, best, cursor));
}

// ---- the binary walks' visitors (bvh_walk.cuh), MT leaves ---------------

template <bool C>
struct BinaryBase {
  const Args& a;
  const Ray& r;
  Stack<C>& st;
  __device__ Node node(int i) const { return load_node(a.table, i); }
  __device__ bool box_below(const Node& nd, float bound, float& tn) const {
    if constexpr (C) ++st.slab;
    return node_slab(nd, r, bound, tn);
  }
  __device__ void overflow() const { atomicAdd(a.overflow, 1); }
};

// nearest: the ordered walk, bounded by the lane's best_t
template <bool C>
struct NearBinary : BinaryBase<C> {
  float& best_t;
  float& bnx;
  float& bny;
  float& bnz;
  float& bmat;
  __device__ bool box(const Node& nd, float& tn) const {
    return this->box_below(nd, best_t, tn);
  }
  __device__ bool leaf(int row, int count) const {
    near_leaf<true>(this->a, row, count, this->r, this->st, best_t, bnx,
                    bny, bnz, bmat);
    return false;
  }
  __device__ float bound() const { return best_t; }
};

// any-hit: the threaded walk, bounded by the light distance
template <bool C>
struct AnyBinary : BinaryBase<C> {
  float tmax;
  bool& found;
  __device__ bool box(const Node& nd, float& tn) const {
    return this->box_below(nd, tmax, tn);
  }
  __device__ bool leaf(int row, int count) const {
    found = any_leaf<true>(this->a, row, count, this->r, tmax, this->st);
    return found;
  }
  __device__ float bound() const { return tmax; }
};

// min mode: the threaded walk, bounded by the running nearest occluder
template <bool C>
struct MinBinary : BinaryBase<C> {
  float& best;
  __device__ bool box(const Node& nd, float& tn) const {
    return this->box_below(nd, best, tn);
  }
  __device__ bool leaf(int row, int count) const {
    min_leaf<true>(this->a, row, count, this->r, best, this->st);
    return false;
  }
  __device__ float bound() const { return best; }
};

// ---- the walks of a layout ----------------------------------------------

template <int LAYOUT, bool MT, bool C>
__device__ __forceinline__ void nearest_mesh(const Args& a, const Ray& r,
                                             Stack<C>& st, float& best_t,
                                             float& bnx, float& bny,
                                             float& bnz, float& bmat) {
  if constexpr (LAYOUT == kBinary) {
    NearBinary<C> v{{a, r, st}, best_t, bnx, bny, bnz, bmat};
    walk_ordered_binary(v);
  } else if constexpr (LAYOUT != kMeshless) {
    nearest_wide<LAYOUT, MT>(a, r, st, best_t, bnx, bny, bnz, bmat);
  }
}

template <int LAYOUT, bool MT, bool C>
__device__ __forceinline__ bool occluded_mesh(const Args& a, const Ray& r,
                                              float tmax, Stack<C>& st) {
  if constexpr (LAYOUT == kBinary) {
    bool found = false;
    AnyBinary<C> v{{a, r, st}, tmax, found};
    walk_threaded_binary(v);
    return found;
  } else if constexpr (LAYOUT != kMeshless) {
    return occluded_wide<LAYOUT, MT>(a, r, tmax, st);
  }
  return false;
}

template <int LAYOUT, bool MT, bool C>
__device__ __forceinline__ void min_mesh(const Args& a, const Ray& r,
                                         float& best, Stack<C>& st) {
  if constexpr (LAYOUT == kBinary) {
    MinBinary<C> v{{a, r, st}, best};
    walk_threaded_binary(v);
  } else if constexpr (LAYOUT != kMeshless) {
    min_wide<LAYOUT, MT>(a, r, best, st);
  }
}

// Shadow query from s toward a light at distance tmax (TPU _occluded):
// scene-box gate, spheres, loose triangles, then the BVH.
template <int LAYOUT, bool MT, bool C>
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
    if (mt_aux(trow, r, t) && trow[12] > 0.f && t < tmax) return true;
  }
  return occluded_mesh<LAYOUT, MT>(a, r, tmax, st);
}

// Min-mode shadow query (TPU _occluded with min_mode): the nearest
// occluder t below best0, where best0 is the light distance, or -1 when
// the ray starts outside the scene box. Returns best0 itself when nothing
// is closer. Never retires early: the walk pops every entry nearer than
// the running best.
template <int LAYOUT, bool MT, bool C>
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
    if (mt_aux(trow, r, t) && trow[12] > 0.f && t < best) best = t;
  }
  if (!(best > 0.f)) return best;
  min_mesh<LAYOUT, MT>(a, r, best, st);
  return best;
}

template <int LAYOUT, bool MT, int MODE, bool C>
__global__ void __launch_bounds__(kBlock) mega_segment_kernel(const Args a) {
  constexpr bool kRec = MODE == kRecord || MODE == kRecordSoft;
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
    a.tmax2[i] = -1.f;
    if constexpr (MODE == kFork) {  // two dead children of weight 0
      thr2[0] = thr2[1] = thr2[2] = 0.f;
      float* o3 = a.o3 + 3 * i;
      float* d3 = a.d3 + 3 * i;
      float* thr3 = a.thr3 + 3 * i;
      o3[0] = ox; o3[1] = oy; o3[2] = oz;
      d3[0] = dx; d3[1] = dy; d3[2] = dz;
      thr3[0] = thr3[1] = thr3[2] = 0.f;
      a.tmax3[i] = -1.f;
    } else {
      thr2[0] = tr; thr2[1] = tg; thr2[2] = tb;
    }
    if constexpr (kRec) {  // record defaults (mega.py:528-536)
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
  nearest_mesh<LAYOUT, MT>(a, r, st, best_t, bnx, bny, bnz, bmat);

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
    if (mt_aux(trow, r, tt) && trow[12] > 0.f && best_t > tt) {
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

  // ---- material: diffuse ambient mirror specular phong is_mirror, and
  //      for the fork transparency ior is_dielectric ---------------------
  constexpr int kFields = MODE == kFork ? 19 : 14;
  float m[kFields];
#pragma unroll
  for (int j = 0; j < kFields; ++j) m[j] = 0.f;
  const int mi = static_cast<int>(bmat);
  if (bmat >= 0.f && mi < a.n_mats && static_cast<float>(mi) == bmat) {
    const float* mrow = a.aux + (size_t)(1 + L + S + T + mi) * kRow;
#pragma unroll
    for (int j = 0; j < kFields; ++j) m[j] = mrow[j];
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
      const float best = nearest_occluder<LAYOUT, MT>(a, sr, best0, st);
      occ = best < best0 && best0 > 0.f;
      if (occ) a.rst[(size_t)i * L + l] = best;
    } else {
      occ = occluded<LAYOUT, MT>(a, make_ray(sx, sy, sz, ldx, ldy, ldz),
                                 ldist, st);
    }
    if constexpr (kRec) {
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
  if constexpr (kRec) {
    a.rt[i] = hit ? best_t : -1.f;
    a.rn[3 * i] = bnx;
    a.rn[3 * i + 1] = bny;
    a.rn[3 * i + 2] = bnz;
    a.rmat[i] = hit ? bmat : -1.f;
    a.rocc[i] = occbits;
  }

  const float ddn = dx * bnx + dy * bny + dz * bnz;
  if constexpr (MODE == kFork) {
    // ---- the dielectric fork (mega.py:976-1045): the reflect child on
    //      the base outputs, the refract child on o3/d3/thr3/tmax3 -----
    const bool entering = ddn < 0.f;
    const float sgn = entering ? 1.f : -1.f;
    const float nex = bnx * sgn, ney = bny * sgn, nez = bnz * sgn;
    const bool is_die = m[18] > 0.f;
    const bool is_mir = m[13] > 0.f;
    const float nrx = is_die ? nex : bnx;
    const float nry = is_die ? ney : bny;
    const float nrz = is_die ? nez : bnz;
    const float rddn = dx * nrx + dy * nry + dz * nrz;
    const float cos_i = fabsf(ddn);
    const float n1 = entering ? 1.f : m[17];
    const float n2v = fmaxf(entering ? m[17] : 1.f, 1e-6f);
    const float eta = n1 / n2v;
    const float kq = 1.f - eta * eta * (1.f - cos_i * cos_i);
    const bool tir = kq < 0.f;
    const float sq = sqrtf(tir ? 1.f : kq);
    const float tfac = eta * cos_i - sq;
    // ((n1 - n2) / (n1 + n2)) ** 2 and (1 - cos_i) ** 5 as XLA lowers
    // them: x * x, and x * ((x * x) * (x * x))
    const float q = (n1 - n2v) / (n1 + n2v);
    const float r0 = q * q;
    const float c = 1.f - cos_i;
    const float c2 = c * c;
    const float fres = tir ? 1.f : r0 + (1.f - r0) * (c * (c2 * c2));
    const float hm = hit ? 1.f : 0.f;
    const bool refr_ok = hit && is_die && !tir;
    const float rof = refr_ok ? 1.f : 0.f;
    const bool can = a.depth < a.max_bounces;  // the lane is live here
    o2[0] = px + nrx * kShadowEps;
    o2[1] = py + nry * kShadowEps;
    o2[2] = pz + nrz * kShadowEps;
    d2[0] = hit ? dx - 2.0f * nrx * rddn : 0.f;
    d2[1] = hit ? dy - 2.0f * nry * rddn : 0.f;
    d2[2] = hit ? dz - 2.0f * nrz * rddn : 1.f;
    thr2[0] = tr * ((m[13] * m[6] + m[18] * fres * m[14]) * hm);
    thr2[1] = tg * ((m[13] * m[7] + m[18] * fres * m[15]) * hm);
    thr2[2] = tb * ((m[13] * m[8] + m[18] * fres * m[16]) * hm);
    a.tmax2[i] = can && hit && (is_mir || is_die) ? kBig : -1.f;
    float* o3 = a.o3 + 3 * i;
    float* d3 = a.d3 + 3 * i;
    float* thr3 = a.thr3 + 3 * i;
    o3[0] = px - nex * kShadowEps;
    o3[1] = py - ney * kShadowEps;
    o3[2] = pz - nez * kShadowEps;
    d3[0] = refr_ok ? eta * dx + tfac * nex : 0.f;
    d3[1] = refr_ok ? eta * dy + tfac * ney : 0.f;
    d3[2] = refr_ok ? eta * dz + tfac * nez : 1.f;
    thr3[0] = tr * (m[18] * (1.f - fres) * m[14] * rof);
    thr3[1] = tg * (m[18] * (1.f - fres) * m[15] * rof);
    thr3[2] = tb * (m[18] * (1.f - fres) * m[16] * rof);
    a.tmax3[i] = can && refr_ok ? kBig : -1.f;
  } else {
    // ---- mirror continuation (:358-373) --------------------------------
    const bool cont = hit && m[13] > 0.f && a.depth < a.max_bounces;
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
  }

  if constexpr (C) {
    atomicAdd(a.counts, st.slab);
    atomicAdd(a.counts + 1, st.leaf);
    atomicAdd(a.counts + 2, st.sphere);
    atomicAdd(a.counts + 3, st.tri);
  }
}

template <int LAYOUT, bool MT, int MODE, bool C>
cudaError_t go(const Args& a, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  mega_segment_kernel<LAYOUT, MT, MODE, C><<<grid, kBlock, 0, s>>>(a);
  return cudaGetLastError();
}

constexpr int key(int layout, bool mt, int mode, bool count) {
  return ((layout * 2 + (mt ? 1 : 0)) * 4 + mode) * 2 + (count ? 1 : 0);
}

#define URT_CASE(L, MT, MODE, C) \
  case key(L, MT, MODE, C):      \
    return go<L, MT, MODE, C>(a, s);
// every mode of a leaf test on a layout, without counting
#define URT_MODES(L, MT)             \
  URT_CASE(L, MT, kForward, false)   \
  URT_CASE(L, MT, kRecord, false)    \
  URT_CASE(L, MT, kRecordSoft, false) \
  URT_CASE(L, MT, kFork, false)

// The instances a route reaches, and the counting instances chip_smoke.py
// reads a bound from.
cudaError_t dispatch(const Args& a, int layout, bool mt, int mode,
                     bool count, cudaStream_t s) {
  switch (key(layout, mt, mode, count)) {
#if !defined(URT_MEGA_GROUP) || URT_MEGA_GROUP == 4
    URT_MODES(kWide4, false)
    URT_CASE(kWide4, false, kForward, true)
    URT_CASE(kWide4, false, kRecordSoft, true)
    URT_CASE(kWide4, false, kFork, true)
    URT_MODES(kWide4, true)
    URT_CASE(kWide4, true, kForward, true)
#endif
#if !defined(URT_MEGA_GROUP) || URT_MEGA_GROUP == 8
    URT_MODES(kWide8, false)
    URT_CASE(kWide8, false, kForward, true)
    URT_CASE(kWide8, false, kRecordSoft, true)
    URT_MODES(kWide8, true)
    URT_CASE(kWide8, true, kForward, true)
#endif
#if !defined(URT_MEGA_GROUP) || URT_MEGA_GROUP == 0
    URT_MODES(kBinary, true)
    URT_CASE(kBinary, true, kForward, true)
    URT_CASE(kMeshless, true, kFork, false)
    URT_CASE(kMeshless, true, kFork, true)
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One segment over n rays on `stream`, in `mode` (0 FORWARD, 1 RECORD,
// 2 RECORD_SOFT, 3 FORK) on `layout` (0 meshless, 1 binary nodes, 4 or 8
// wide rows in `table`) with the Möller–Trumbore (`mt` = 1, `leaf` =
// tris) or Baldwin–Weber (`leaf` = tris_bw) leaf test. The record pointers
// (rt, rn, rmat, rocc; rst for RECORD_SOFT) may point into larger buffers,
// e.g. one segment's rows of a [B, n] array; the refract child's (o3, d3,
// thr3, tmax3) are FORK's. A non-null `counts` (4 x u64) selects the
// counting instance. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a combination this library has no instance
// of, or a missing output pointer).
int urt_mega_segment(const float* o, const float* d, const float* thr,
                     const float* tmax, int n, int depth, const float* table,
                     int layout, int mt, const float* leaf, int leaf_rows,
                     int bw_rows, const float* leafmeta, int meta_w,
                     const float* aux, int n_lights, int n_spheres,
                     int n_tris, int n_mats, int max_bounces,
                     float light_cull, float* delta, float* o2, float* d2,
                     float* thr2, float* tmax2, int* overflow, int mode,
                     float* rt, float* rn, float* rmat, float* rocc,
                     float* rst, float* o3, float* d3, float* thr3,
                     float* tmax3, unsigned long long* counts,
                     void* stream) {
  const bool rec = mode == kRecord || mode == kRecordSoft;
  if ((rec && (!rt || !rn || !rmat || !rocc ||
               (mode == kRecordSoft && n_lights > 0 && !rst))) ||
      (mode == kFork && (!o3 || !d3 || !thr3 || !tmax3)) ||
      mode < kForward || mode > kFork)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{o, d, thr, tmax, table, leaf, leafmeta, aux,
               delta, o2, d2, thr2, tmax2, overflow,
               n, depth, leaf_rows, bw_rows, meta_w,
               n_lights, n_spheres, n_tris, n_mats, max_bounces,
               light_cull, rt, rn, rmat, rocc, rst, counts,
               o3, d3, thr3, tmax3};
  return static_cast<int>(dispatch(a, layout, mt != 0, mode,
                                   counts != nullptr,
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
