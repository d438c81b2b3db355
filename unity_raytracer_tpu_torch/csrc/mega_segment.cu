// Fused bounce-segment kernel for Hopper (sm_90a).
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
//                traverse_wide.widen), near-first with a stack;
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
// It reads the host-built arrays (the walk rows of the wide or binary
// layout, PackedBVH.wide_walk / nodes_walk, whose boxes are widened on the
// host by utils/boxes.pad_box; tris or tris_bw rows with a
// 128-float stride, leafmeta, the aux block of ops/kernels/mega.build_aux,
// whose scene box is widened the same way) plus the port's own leafbox
// rows (one box per 7-slot group of leaf slots), and writes the five
// outputs of one segment, plus the records or the refract child.
//
// Semantics: a lane walks its own ray with pops pruned by its own best t.
// The TPU kernel's per-tile union walk, scalar SMEM cursor, shared stale
// prune and its tile_r / walk_unroll / occ_mode / near_mode knobs do not
// exist here: they were the TPU's answer to one cursor per tile and change
// no result. The wide walk slab-tests the children of a wide node, sorts
// the hits by entry distance in registers and pushes them far-to-near; on
// pop it skips an entry whose entry distance exceeds its best_t. Any-hit
// shadow walks stop at the first occluder closer than the light, after
// testing spheres and loose triangles first. A min-mode walk starts from
// best = the light distance, lowers it with spheres and loose triangles
// (strict <), then walks near-first (threaded on the binary layout),
// pruning by best and lowering it on every closer hit; it never stops
// early. Its occlusion mask (best < best0) is the any-hit walk's, so the
// shading, delta and continuation of RECORD_SOFT equal FORWARD's. A leaf
// test takes its slots (up to the leaf's triangle count, which the wide
// walks carry in the stack code; the twin tests the zero pad slots too,
// which no ray hits) in groups of 7: a group is tested, in slot order,
// only when the ray enters the group's box at or below the walk's bound
// (best_t, the light distance or the min-mode best); a skipped group
// holds no hit there, so strict < keeps the same hits and winners.
//
// What bounds it on this card: divergent pointer chasing. The 32 rays of a
// warp visit different nodes and leaves, so the loads of the ~10 MB of BVH
// rows (they fit in the 50 MB L2) are scattered and serialised, and the
// leaf-slot tests, most of the work on the flagship's 98-slot leaves, ran
// with a third (nearest walk) or a quarter (shadow walks) of the warp
// active (PERF.md); wgmma and TMA do not apply (no dense tile
// product, no regular tile to copy). The design spends the SIMT warp:
//   - leaf groups culled by their box (above): the largest gain;
//   - warp-pooled shadow queries: after the nearest walks, each lane finds
//     the lights it needs a shadow walk for (the light_cull gate and
//     n.l >= 0, as before); the warp compacts those (lane, light) pairs
//     light-major into a list in its shared memory (ballot and popc),
//     with each lane's hit point and normal, and walks the list 32 pairs
//     at a time (ShadowWalk). Each pair's ray is rebuilt from its owner's
//     point by the owner's formulas; the answer (occluded, or the
//     min-mode t) goes back to the owner, which then shades its lights in
//     light order as before, so the colour sums and occbits round exactly
//     as before. A warp without a hit skips the phase. Measured within
//     noise of per-lane walks on the flagship: a round of 32 walks lasts
//     as long as its longest. Refilling a lane from the list as soon as
//     its walk ended, a walk step at a time, was measured slower still
//     (PERF.md).
// The stacks stay in local memory (kStackWide / kStackBinary entries;
// the wrapper holds the tree's worst push depth, PackedBVH.stack_wide /
// stack_binary, to them before the launch): a stack of the tree's depth
// in shared memory, and persistent warps taking 32 lanes at a time from a
// counter, were both measured slower (PERF.md). One thread per
// ray: dead lanes write their pass-through and join the warp's ballots; a
// warp without a live lane stops there.
// The record modes add 6 (RECORD) or 6 + L (RECORD_SOFT) output streams
// per lane and FORK 10; RECORD_SOFT's min-mode walks visit every box
// nearer than the nearest occluder instead of stopping at the first one.
//
// A counting instance (template flag C, launched only by chip_smoke.py to
// measure the work, built only where it reads one) adds each lane's slab
// tests (node and group boxes), Baldwin–Weber leaf-slot tests, sphere
// tests and Möller–Trumbore tests (loose triangles and MT leaf slots) to
// four device counters, from which PERF.md's bound is computed, and their
// split by phase (mega.COUNTS).
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
// *overflow; the wrapper raises when the count is not zero (it checked
// the tree's depth against the capacity, so none is).
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

constexpr int kBwPerRow = 10;    // BW_PER_ROW: records per tris_bw row
constexpr int kBlock = 128;
constexpr int kLightChunk = 8;   // lights pooled at once (LIGHT_CHUNK)
constexpr int kCounts = 16;      // ops/kernels/mega.COUNTS
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
  const float* leafbox;  // [tris rows, 16]: two group boxes per tris row
  const float* leafmeta;
  const float* aux;
  float* delta;
  float* o2;
  float* d2;
  float* thr2;
  float* tmax2;
  int* overflow;  // [1]: dropped stack pushes
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
  // COUNT: kCounts tallies (ops/kernels/mega.COUNTS)
  unsigned long long* counts;
  // FORK: the refract child o [n,3], d [n,3], weight [n,3], tmax [n]
  float* o3;
  float* d3;
  float* thr3;
  float* tmax3;
  int light_chunk;  // lights pooled at once
  int warp_floats;  // a warp's region of shared memory, in 4-byte words
};

// The counting instance's tallies (mega.COUNTS): the totals the bound
// reads, and per phase (0 the nearest walk, 1 the shadow walks) slab
// tests, leaf-slot tests, warp issues of a leaf-slot test, the deepest
// stack and the group box tests. The other instances count nothing.
template <bool C>
struct Tally {
  __device__ void phase(int) {}
  __device__ void slab() {}
  __device__ void group() {}
  template <bool MT>
  __device__ void slot() {}
  __device__ void sphere() {}
  __device__ void tri() {}
  __device__ void pushed(int) {}
  __device__ void live() {}
  __device__ void query() {}
  __device__ void flush(unsigned long long*) const {}
};

template <>
struct Tally<true> {
  unsigned long long v[kCounts];
  int ph;
  __device__ void phase(int p) { ph = p; }
  __device__ void slab() {
    ++v[0];
    ++v[4 + ph];
  }
  __device__ void group() {
    slab();
    ++v[14 + ph];
  }
  // one leaf-slot test; the first active lane of the warp counts the issue
  template <bool MT>
  __device__ void slot() {
    ++v[MT ? 3 : 1];
    ++v[6 + ph];
    if (static_cast<int>(threadIdx.x & 31) == __ffs(__activemask()) - 1)
      ++v[8 + ph];
  }
  __device__ void sphere() { ++v[2]; }
  __device__ void tri() { ++v[3]; }
  __device__ void pushed(int sp) {
    if (static_cast<unsigned long long>(sp) > v[10 + ph]) v[10 + ph] = sp;
  }
  __device__ void live() { ++v[12]; }
  __device__ void query() { ++v[13]; }
  __device__ void flush(unsigned long long* counts) const {
    for (int k = 0; k < kCounts; ++k) {
      if (k == 10 || k == 11)
        atomicMax(counts + k, v[k]);
      else
        atomicAdd(counts + k, v[k]);
    }
  }
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
// with plain loads: through __ldg the forward BVH4 instance needed 8 more
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

// Nearest-hit tests of a leaf's `count` slots (strict <), a group at a
// time: the winner's t, shading normal and material id.
template <bool MT, bool C>
__device__ __forceinline__ void near_leaf(const Args& a, int leaf_row,
                                          int count, const Ray& r,
                                          Tally<C>& tl, float& best_t,
                                          float& bnx, float& bny,
                                          float& bnz, float& bmat) {
  for (int j0 = 0; j0 < count; j0 += kGroup) {
    tl.group();
    if (!group_hit(a.leafbox, leaf_row, j0, r, best_t)) continue;
    const int end = j0 + kGroup < count ? j0 + kGroup : count;
    for (int j = j0; j < end; ++j) {
      tl.template slot<MT>();
      if constexpr (MT) {
        const float* v = mt_slot(a, leaf_row, j);
        float t;
        if (mt_hit(v, r, t) && t < best_t) {
          best_t = t;
          tri_normal(v, bnx, bny, bnz);
          bmat = slot_matid(a, leaf_row, j);
        }
      } else {
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
}

// Any-hit test of a leaf's slots: true at the first one closer than tmax.
template <bool MT, bool C>
__device__ __forceinline__ bool any_leaf(const Args& a, int leaf_row,
                                         int count, const Ray& r,
                                         float tmax, Tally<C>& tl) {
  for (int j0 = 0; j0 < count; j0 += kGroup) {
    tl.group();
    if (!group_hit(a.leafbox, leaf_row, j0, r, tmax)) continue;
    const int end = j0 + kGroup < count ? j0 + kGroup : count;
    for (int j = j0; j < end; ++j) {
      tl.template slot<MT>();
      float t;
      if constexpr (MT) {
        if (mt_hit(mt_slot(a, leaf_row, j), r, t) && t < tmax) return true;
      } else {
        float nx, ny, nz;
        if (bw_hit(bw_record(a, leaf_row, j), r, t, nx, ny, nz) && t < tmax)
          return true;
      }
    }
  }
  return false;
}

// Min-mode test of a leaf's slots: best lowered to the nearest hit.
template <bool MT, bool C>
__device__ __forceinline__ void min_leaf(const Args& a, int leaf_row,
                                         int count, const Ray& r,
                                         float& best, Tally<C>& tl) {
  for (int j0 = 0; j0 < count; j0 += kGroup) {
    tl.group();
    if (!group_hit(a.leafbox, leaf_row, j0, r, best)) continue;
    const int end = j0 + kGroup < count ? j0 + kGroup : count;
    for (int j = j0; j < end; ++j) {
      tl.template slot<MT>();
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
}

// ---- the wide walks ------------------------------------------------------

// Leaf stack entries: code = -2 - (leaf_row * 256 + count); interior
// entries are the wide row (>= 0).
__device__ __forceinline__ int leaf_code(int leaf_row, int count) {
  return -2 - (leaf_row * 256 + count);
}

// Slab-test the ARITY children of wide row `node`; push the hits
// far-to-near (ORDERED) or in reverse slot order.
template <int ARITY, bool ORDERED, bool C>
__device__ __forceinline__ void expand(const Args& a, int node, const Ray& r,
                                       float best, Stack<kStackWide>& st,
                                       Tally<C>& tl) {
  const float4* row =
      reinterpret_cast<const float4*>(a.table + (size_t)node * 8 * ARITY);
  float key[ARITY];
  int code[ARITY];
#pragma unroll
  for (int c = 0; c < ARITY; ++c) {
    const float4 lo = __ldg(row + 2 * c);      // lx ly lz hx
    const float4 hi = __ldg(row + 2 * c + 1);  // hy hz meta count
    if (hi.w >= 0.f) tl.slab();
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
    if (key[c] < INFINITY) {
      if (st.push(code[c], key[c]))
        tl.pushed(st.sp);
      else
        atomicAdd(a.overflow, 1);
    }
  }
}

// Nearest mesh hit: near-first walk with a per-lane best_t.
template <int ARITY, bool MT, bool C>
__device__ void nearest_wide(const Args& a, const Ray& r,
                             Stack<kStackWide>& st, Tally<C>& tl,
                             float& best_t, float& bnx,
                             float& bny, float& bnz, float& bmat) {
  st.sp = 0;
  int cursor = 0;  // wide row 0 holds the root's children
  do {
    if (cursor >= 0) {
      expand<ARITY, true>(a, cursor, r, best_t, st, tl);
    } else {
      const int x = -2 - cursor;
      near_leaf<MT>(a, x >> 8, x & 255, r, tl, best_t, bnx, bny, bnz, bmat);
    }
  } while (st.pop(best_t, cursor));
}

// ---- the binary walks' visitors (bvh_walk.cuh), MT leaves ---------------

template <bool C>
struct BinaryBase {
  const Args& a;
  const Ray& r;
  Tally<C>& tl;
  __device__ Node node(int i) const { return load_node(a.table, i); }
  __device__ bool box_below(const Node& nd, float bound, float& tn) const {
    tl.slab();
    return node_slab(nd, r, bound, tn);
  }
  __device__ void overflow() const { atomicAdd(a.overflow, 1); }
  __device__ void pushed(int sp) const { tl.pushed(sp); }
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
    near_leaf<true>(this->a, row, count, this->r, this->tl, best_t, bnx,
                    bny, bnz, bmat);
    return false;
  }
  __device__ float bound() const { return best_t; }
};

// ---- the walks of a layout ----------------------------------------------

// the walk stack of a layout (kMeshless walks nothing)
template <int LAYOUT>
using LayoutStack = Stack<LAYOUT == kBinary     ? kStackBinary
                          : LAYOUT == kMeshless ? 1
                                                : kStackWide>;

template <int LAYOUT, bool MT, bool C>
__device__ __forceinline__ void nearest_mesh(const Args& a, const Ray& r,
                                             LayoutStack<LAYOUT>& st,
                                             Tally<C>& tl, float& best_t,
                                             float& bnx, float& bny,
                                             float& bnz, float& bmat) {
  if constexpr (LAYOUT == kBinary) {
    NearBinary<C> v{{a, r, tl}, best_t, bnx, bny, bnz, bmat};
    walk_ordered_binary(v, st);
  } else if constexpr (LAYOUT != kMeshless) {
    nearest_wide<LAYOUT, MT>(a, r, st, tl, best_t, bnx, bny, bnz, bmat);
  }
}

// ---- the pooled shadow phase --------------------------------------------

// The geometry of light l seen from hit point p with shading normal n, by
// the formulas of the lane that owns the hit (RayTracingSetup.cs:324-455).
struct LightGeom {
  float ld2, ldist, ldx, ldy, ldz, ln;
};

__device__ __forceinline__ LightGeom light_geom(const float* lrow, float px,
                                                float py, float pz,
                                                float bnx, float bny,
                                                float bnz) {
  const float lvx = lrow[0] - px, lvy = lrow[1] - py, lvz = lrow[2] - pz;
  const float ld2 = lvx * lvx + lvy * lvy + lvz * lvz;
  const float ldist = sqrtf(ld2);
  const float linv = rsqrt_clamped(ld2);
  const float ldx = lvx * linv, ldy = lvy * linv, ldz = lvz * linv;
  return LightGeom{ld2, ldist, ldx, ldy, ldz,
                   ldx * bnx + ldy * bny + ldz * bnz};
}

// One pooled shadow query (TPU _occluded, any-hit or min mode). start()
// rebuilds the pair's shadow ray from its owner's hit
// point and normal (the warp's `pn` columns) exactly as the owner builds
// it, then tests the scene-box gate, the spheres and the loose triangles;
// step() makes one step of the mesh walk (a wide row expanded or a leaf
// tested; one binary node, threaded order). The tests, their order and
// their bounds are the per-lane walks' of before:
//   any-hit  the first occluder closer than the light distance ends it;
//   min mode best starts at best0 = the light distance (-1 outside the
//            scene box), is lowered by every closer sphere, triangle and
//            leaf slot (strict <), and prunes the walk; it never retires
//            early.
template <int LAYOUT, bool MT, int MODE, bool C>
struct ShadowWalk {
  static constexpr bool kMin = MODE == kRecordSoft;
  Ray r;
  float bound;  // any-hit: the light distance; min mode: the running best
  float best0;  // min mode: the light distance, or -1 outside the box
  int cursor;   // the walk's row, leaf code or node
  bool occ;     // any-hit: an occluder was found

  // false when the pair is answered before any mesh walk
  __device__ bool start(const Args& a, const float* pn, int owner, int l,
                        LayoutStack<LAYOUT>& st, Tally<C>& tl) {
    const float px = pn[owner], py = pn[kWarp + owner],
                pz = pn[2 * kWarp + owner];
    const float bnx = pn[3 * kWarp + owner], bny = pn[4 * kWarp + owner],
                bnz = pn[5 * kWarp + owner];
    const LightGeom g = light_geom(a.aux + (size_t)(1 + l) * kRow, px, py,
                                   pz, bnx, bny, bnz);
    r = make_ray(px + bnx * kShadowEps, py + bny * kShadowEps,
                 pz + bnz * kShadowEps, g.ldx, g.ldy, g.ldz);
    tl.query();
    occ = false;
    cursor = 0;
    st.sp = 0;
    float tn;
    tl.slab();
    const bool in_box = slab(a.aux[0], a.aux[1], a.aux[2], a.aux[3],
                             a.aux[4], a.aux[5], r, kBig, tn);
    const float* srow = a.aux + (size_t)(1 + a.n_lights) * kRow;
    const float* trow =
        a.aux + (size_t)(1 + a.n_lights + a.n_spheres) * kRow;
    if constexpr (kMin) {
      best0 = in_box ? g.ldist : -1.f;
      bound = best0;
      for (int s = 0; s < a.n_spheres; ++s, srow += kRow) {
        tl.sphere();
        float t;
        if (sphere_hit(srow, r, t) && t < bound) bound = t;
      }
      for (int k = 0; k < a.n_tris; ++k, trow += kRow) {
        tl.tri();
        float t;
        if (mt_aux(trow, r, t) && trow[12] > 0.f && t < bound) bound = t;
      }
      return LAYOUT != kMeshless && bound > 0.f;
    } else {
      bound = g.ldist;
      if (!in_box || !(bound > 0.f)) return false;
      for (int s = 0; s < a.n_spheres; ++s, srow += kRow) {
        tl.sphere();
        float t;
        if (sphere_hit(srow, r, t) && t < bound) {
          occ = true;
          return false;
        }
      }
      for (int k = 0; k < a.n_tris; ++k, trow += kRow) {
        tl.tri();
        float t;
        if (mt_aux(trow, r, t) && trow[12] > 0.f && t < bound) {
          occ = true;
          return false;
        }
      }
      return LAYOUT != kMeshless;
    }
  }

  // false when the walk has ended
  __device__ bool step(const Args& a, LayoutStack<LAYOUT>& st,
                       Tally<C>& tl) {
    if constexpr (LAYOUT == kBinary) {
      const Node nd = load_node(a.table, cursor);
      float tn;
      tl.slab();
      const bool hit = node_slab(nd, r, bound, tn);
      const int count = static_cast<int>(nd.b.w);
      if (hit && count > 0) {
        const int row = static_cast<int>(nd.b.z);
        if constexpr (kMin) {
          min_leaf<true>(a, row, count, r, bound, tl);
        } else if (any_leaf<true>(a, row, count, r, bound, tl)) {
          occ = true;
          return false;
        }
      }
      cursor = (hit && count <= 0) ? cursor + 1 : static_cast<int>(nd.c.x);
      return cursor >= 0;
    } else if constexpr (LAYOUT != kMeshless) {
      if (cursor >= 0) {
        expand<LAYOUT, kMin>(a, cursor, r, bound, st, tl);
      } else {
        const int x = -2 - cursor;
        if constexpr (kMin) {
          min_leaf<MT>(a, x >> 8, x & 255, r, bound, tl);
        } else if (any_leaf<MT>(a, x >> 8, x & 255, r, bound, tl)) {
          occ = true;
          return false;
        }
      }
      return st.pop(bound, cursor);
    }
    return false;
  }

  // any-hit: 1 when occluded, else 0; min mode: the nearest occluder t
  // when it is closer than the light (occluded), else -1
  __device__ float answer() const {
    if constexpr (kMin)
      return bound < best0 && best0 > 0.f ? bound : -1.f;
    return occ ? 1.f : 0.f;
  }
};

// One segment on lane i of a warp (a lane i >= n does nothing but join
// the warp's ballots). `pn` [6][32], `pairs` and `ans` [light_chunk][32]
// are the warp's shared memory for the pooled shadow queries.
template <int LAYOUT, bool MT, int MODE, bool C>
__device__ __forceinline__ void segment_lanes(const Args& a, int i,
                                              LayoutStack<LAYOUT>& st,
                                              float* pn, int* pairs,
                                              float* ans, Tally<C>& tl) {
  constexpr bool kRec = MODE == kRecord || MODE == kRecordSoft;
  const int lane = static_cast<int>(threadIdx.x & (kWarp - 1));
  const bool valid = i < a.n;
  const bool live = valid && a.tmax[i] >= 0.f;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tr = 0.f, tg = 0.f, tb = 0.f;
  if (valid) {
    ox = a.o[3 * i]; oy = a.o[3 * i + 1]; oz = a.o[3 * i + 2];
    dx = a.d[3 * i]; dy = a.d[3 * i + 1]; dz = a.d[3 * i + 2];
    tr = a.thr[3 * i]; tg = a.thr[3 * i + 1]; tb = a.thr[3 * i + 2];
  }
  if (valid && !live) {  // dead lane: pass-through
    float* delta = a.delta + 3 * i;
    float* o2 = a.o2 + 3 * i;
    float* d2 = a.d2 + 3 * i;
    float* thr2 = a.thr2 + 3 * i;
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
  }
  if (!__any_sync(kFull, live)) return;  // a dead warp is done

  const int L = a.n_lights, S = a.n_spheres, T = a.n_tris;
  // ---- nearest hit: mesh (strict <), then spheres, then loose tris
  //      (strict >, the reference combine order Scene.cs:94,107) -------
  float best_t = kBig, bnx = 0.f, bny = 0.f, bnz = 0.f, bmat = -1.f;
  bool hit = false;
  if (live) {
    tl.phase(0);
    tl.live();
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    nearest_mesh<LAYOUT, MT>(a, r, st, tl, best_t, bnx, bny, bnz, bmat);
    const float* srow = a.aux + (size_t)(1 + L) * kRow;
    for (int s = 0; s < S; ++s, srow += kRow) {
      tl.sphere();
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
      tl.tri();
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
    tl.slab();
    const bool in_box = slab(a.aux[0], a.aux[1], a.aux[2], a.aux[3],
                             a.aux[4], a.aux[5], r, kBig, tn_box);
    hit = in_box && best_t < kBig && best_t >= 0.f;
  }

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

  // ---- direct lighting (RayTracingSetup.cs:324-455), a chunk of lights
  //      at a time: the warp pools the shadow queries, then each lane
  //      shades the chunk's lights in light order ------------------------
  float col_r = m[3] * a.aux[6];
  float col_g = m[4] * a.aux[7];
  float col_b = m[5] * a.aux[8];
  const float kdks = fmaxf(fmaxf(m[0], m[1]), m[2]) +
                     fmaxf(fmaxf(m[9], m[10]), m[11]);
  float occbits = 0.f;  // RECORD modes: sum of 2^l over occluded lights
  pn[lane] = px;
  pn[kWarp + lane] = py;
  pn[2 * kWarp + lane] = pz;
  pn[3 * kWarp + lane] = bnx;
  pn[4 * kWarp + lane] = bny;
  pn[5 * kWarp + lane] = bnz;
  const unsigned below = (1u << lane) - 1u;
  const int lights = __any_sync(kFull, hit) ? L : 0;
  for (int c0 = 0; c0 < lights; c0 += a.light_chunk) {
    const int cn = L - c0 < a.light_chunk ? L - c0 : a.light_chunk;
    // 1. the (lane, light) pairs that need a walk, light-major
    unsigned needs = 0;
    int total = 0;
    for (int k = 0; k < cn; ++k) {
      bool need = false;
      if (hit) {
        const float* lrow = a.aux + (size_t)(1 + c0 + k) * kRow;
        const LightGeom g = light_geom(lrow, px, py, pz, bnx, bny, bnz);
        need = g.ln >= 0.f && lrow[6] > 0.f;
        if (a.light_cull > 0.f) {
          const float imax = fmaxf(fmaxf(lrow[3], lrow[4]), lrow[5]);
          need = need && kdks * imax >= a.light_cull * g.ld2;
        }
      }
      const unsigned ballot = __ballot_sync(kFull, need);
      if (need) {
        pairs[total + __popc(ballot & below)] = k * kWarp + lane;
        needs |= 1u << k;
      }
      total += __popc(ballot);
    }
    __syncwarp();
    // 2. the warp walks the pairs, 32 at a time
    tl.phase(1);
    for (int q0 = 0; q0 < total; q0 += kWarp) {
      if (q0 + lane < total) {
        const int pr = pairs[q0 + lane];
        ShadowWalk<LAYOUT, MT, MODE, C> w;
        if (w.start(a, pn, pr & (kWarp - 1), c0 + pr / kWarp, st, tl))
          while (w.step(a, st, tl)) {
          }
        ans[pr] = w.answer();
      }
    }
    __syncwarp();
    // 3. the owner shades the chunk's lights in light order
    for (int k = 0; k < cn; ++k) {
      const int l = c0 + k;
      const bool need = (needs >> k) & 1u;
      bool occ = false;
      float st_l = kBig;
      if (need) {
        const float v = ans[k * kWarp + lane];
        if constexpr (MODE == kRecordSoft) {
          occ = v >= 0.f;
          if (occ) st_l = v;
        } else {
          occ = v > 0.f;
        }
      }
      if constexpr (MODE == kRecordSoft) {
        if (live) a.rst[(size_t)i * L + l] = st_l;
      }
      if constexpr (kRec) {
        if (occ) occbits += static_cast<float>(1 << l);
      }
      if (!need || occ) continue;  // a culled, unneeded or occluded light
      const float* lrow = a.aux + (size_t)(1 + l) * kRow;
      const LightGeom g = light_geom(lrow, px, py, pz, bnx, bny, bnz);
      const float w = 1.0f / fmaxf(g.ld2, kMinSq);  // Intensity / d^2
      const float dterm = fmaxf(0.f, g.ln) * w;
      col_r += m[0] * dterm * lrow[3];
      col_g += m[1] * dterm * lrow[4];
      col_b += m[2] * dterm * lrow[5];
      // Blinn-Phong specular, halfway (l + v)/|.| with v = -d
      const float hx = g.ldx - dx, hy = g.ldy - dy, hz = g.ldz - dz;
      const float hinv = rsqrt_clamped(hx * hx + hy * hy + hz * hz);
      const float nh =
          fmaxf(0.f, bnx * hx * hinv + bny * hy * hinv + bnz * hz * hinv);
      const float sterm =
          (nh > 0.f ? expf(m[12] * logf(fmaxf(nh, kTiny))) : 0.f) * w;
      col_r += m[9] * sterm * lrow[3];
      col_g += m[10] * sterm * lrow[4];
      col_b += m[11] * sterm * lrow[5];
    }
    __syncwarp();  // the next chunk rewrites pairs and ans
  }
  if (!live) return;
  if constexpr (MODE == kRecordSoft) {  // no hit in the warp: no queries
    if (lights == 0)
      for (int l = 0; l < L; ++l) a.rst[(size_t)i * L + l] = kBig;
  }

  float* delta = a.delta + 3 * i;
  float* o2 = a.o2 + 3 * i;
  float* d2 = a.d2 + 3 * i;
  float* thr2 = a.thr2 + 3 * i;
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
}

// One thread per ray; each warp has its region of dynamic shared memory
// for the pooled shadow queries: pn (6 * 32 words), pairs and ans
// (light_chunk * 32 each).
template <int LAYOUT, bool MT, int MODE, bool C>
__global__ void __launch_bounds__(kBlock) mega_segment_kernel(const Args a) {
  extern __shared__ float smem[];
  LayoutStack<LAYOUT> st;
  float* pn = smem + (threadIdx.x / kWarp) * a.warp_floats;
  int* pairs = reinterpret_cast<int*>(pn + 6 * kWarp);
  float* ans = reinterpret_cast<float*>(pairs + a.light_chunk * kWarp);
  Tally<C> tl{};
  segment_lanes<LAYOUT, MT, MODE>(
      a, static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x), st, pn,
      pairs, ans, tl);
  tl.flush(a.counts);
}

template <int LAYOUT, bool MT, int MODE, bool C>
cudaError_t go(Args a, cudaStream_t s) {
  const auto kernel = mega_segment_kernel<LAYOUT, MT, MODE, C>;
  a.light_chunk = a.n_lights < 1 ? 1
                  : a.n_lights < kLightChunk ? a.n_lights : kLightChunk;
  a.warp_floats = kWarp * (6 + 2 * a.light_chunk);
  kernel<<<(a.n + kBlock - 1) / kBlock, kBlock,
           sizeof(float) * a.warp_floats * (kBlock / kWarp), s>>>(a);
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
// tris) or Baldwin–Weber (`leaf` = tris_bw) leaf test; `leafbox` the group
// boxes of the tris rows; `overflow` the int32 counter of dropped stack
// pushes. The record
// pointers (rt, rn, rmat, rocc; rst for RECORD_SOFT) may point into larger
// buffers, e.g. one segment's rows of a [B, n] array; the refract child's
// (o3, d3, thr3, tmax3) are FORK's. A non-null `counts` (kCounts x u64)
// selects the counting instance. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a combination this library has no
// instance of or a missing output pointer).
int urt_mega_segment(const float* o, const float* d, const float* thr,
                     const float* tmax, int n, int depth, const float* table,
                     int layout, int mt, const float* leaf,
                     const float* leafbox, int leaf_rows, int bw_rows,
                     const float* leafmeta, int meta_w,
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
      mode < kForward || mode > kFork || (layout != kMeshless && !leafbox))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.o = o; a.d = d; a.thr = thr; a.tmax = tmax;
  a.table = table; a.leaf = leaf; a.leafbox = leafbox;
  a.leafmeta = leafmeta; a.aux = aux;
  a.delta = delta; a.o2 = o2; a.d2 = d2; a.thr2 = thr2; a.tmax2 = tmax2;
  a.overflow = overflow;
  a.n = n; a.depth = depth; a.leaf_rows = leaf_rows; a.bw_rows = bw_rows;
  a.meta_w = meta_w; a.n_lights = n_lights; a.n_spheres = n_spheres;
  a.n_tris = n_tris; a.n_mats = n_mats; a.max_bounces = max_bounces;
  a.light_cull = light_cull;
  a.rt = rt; a.rn = rn; a.rmat = rmat; a.rocc = rocc; a.rst = rst;
  a.counts = counts;
  a.o3 = o3; a.d3 = d3; a.thr3 = thr3; a.tmax3 = tmax3;
  return static_cast<int>(dispatch(a, layout, mt != 0, mode,
                                   counts != nullptr,
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
