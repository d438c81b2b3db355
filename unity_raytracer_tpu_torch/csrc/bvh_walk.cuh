// Device code shared by the BVH walks (traverse.cu) and the fused segment
// kernel (mega_segment.cu), for Hopper (sm_90a):
//
//   Ray, fix_dir, make_ray   a ray with its clamped inverse direction;
//   slab                     the TPU kernels' slab test over [0, best]: 1/d
//                            clamped to +-1e-30, entry distance clamped at
//                            0, hit when tn <= tf and tn <= best;
//   mt_test, mt_hit          Möller–Trumbore against one triangle, in the
//                            TPU kernels' operation order (mt_hit reads a
//                            leaf slot's 9 floats through __ldg);
//   group_hit                the slab test of a leaf-slot group's box (the
//                            port's leafbox rows, ops/kernels/traverse_mk3.
//                            group_boxes): a leaf test skips a group whose
//                            box the ray does not enter below its bound
//                            (raised by kGroupMargin);
//   Stack                    a lane's walk stack of (code, entry
//                            distance), in local memory;
//   Node, load_node          the binary node row [16] f32: lo(0:3) hi(3:6)
//                            leaf row(6) count(7) miss(8) right(9);
//   walk_ordered_binary      the binary walk of the TPU's traverse_mk4:
//                            near child first by entry distance, the far
//                            child pushed on the lane's Stack with its
//                            entry distance and dropped on pop when that
//                            exceeds the walk's bound;
//   walk_threaded_binary     the binary walk of the TPU's traverse_mk3:
//                            leftmost-DFS order, descend to node + 1 on a
//                            box hit, else follow the miss link; no stack.
//
// The walks leave what a box test bounds by, what a leaf does and what is
// counted to a visitor V with
//   Node node(int i)                    load node row i
//   bool box(const Node& n, float& tn)  the slab test against the bound
//   bool leaf(int row, int count)       test the leaf's count triangles
//                                       from tris row `row`; true ends the
//                                       walk (an any-hit walk found one)
//   float bound()                       the current bound (best t)
//   void overflow()                     a push the stack had no room for
//   void pushed(int sp)                 a push left sp entries (counting)
//
// Numerics: IEEE division, no fast-math, and the sources are built with
// -fmad=false (ops/kernels/_lib.py), so each product and sum rounds where
// the plain PyTorch versions round it.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace urt {

constexpr int kRow = 128;         // row stride of tris, tris_bw and aux
constexpr int kLeafSlots = 14;    // PALLAS_LEAF: triangles per tris row
constexpr int kNodeRow = 16;      // floats per binary node row
constexpr int kGroup = 7;         // leaf slots per group box (GROUP)
constexpr int kBoxRow = 16;       // floats per leafbox row: 2 group boxes
// GROUP_MARGIN: a triangle's hit is computed a few ulps of t off the
// triangle, so a group is tested up to bound * (1 + this); its box is
// widened by as much of its coordinates (group_boxes)
constexpr float kGroupMargin = 1.0f / 65536.0f;
// stack capacities (entries per lane) of the wide walks and of the ordered
// binary walk: ops/kernels/traverse_wide.STACK and traverse_mk3.
// STACK_BINARY, which the wrappers hold the tree's worst push depth to
// before a launch
constexpr int kStackWide = 256;
constexpr int kStackBinary = 96;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-5f;
constexpr float kTiny = 1e-30f;

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

__device__ __forceinline__ float fix_dir(float v) {
  return fabsf(v) < kTiny ? (v < 0.f ? -kTiny : kTiny) : v;
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz,
             1.0f / fix_dir(dx), 1.0f / fix_dir(dy), 1.0f / fix_dir(dz)};
}

// Slab test of box lo/hi over [0, best]; tn = the entry distance.
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

// Does the ray enter, at or below `bound` raised by kGroupMargin, the box
// of the group of leaf slots j0 .. j0 + kGroup - 1 of the leaf whose first
// tris row is leaf_row? The box holds every vertex of the group's live
// slots, widened outward (group_boxes), so a skipped group holds no hit
// at t <= bound; the margins only test more groups, and a tested group
// changes the walk only by a hit strictly below the bound.
__device__ __forceinline__ bool group_hit(const float* leafbox, int leaf_row,
                                          int j0, const Ray& r,
                                          float bound) {
  const float4* b = reinterpret_cast<const float4*>(
      leafbox + (size_t)(leaf_row + j0 / kLeafSlots) * kBoxRow +
      8 * ((j0 % kLeafSlots) / kGroup));
  const float4 lo = __ldg(b);      // lx ly lz hx
  const float4 hi = __ldg(b + 1);  // hy hz - -
  float tn;
  return slab(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r,
              bound + fabsf(bound) * kGroupMargin, tn);
}

// Möller–Trumbore against one triangle v0 v1 v2.
__device__ __forceinline__ bool mt_test(float v0x, float v0y, float v0z,
                                        float v1x, float v1y, float v1z,
                                        float v2x, float v2y, float v2z,
                                        const Ray& r, float& t) {
  const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool par = fabsf(det) < kEps;
  const float f = 1.0f / (par ? 1.0f : det);
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  const float u = f * (sx * px + sy * py + sz * pz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float w = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return !par && u >= 0.f && u <= 1.f && w >= 0.f && u + w <= 1.f &&
         t > kEps;
}

// ... of a leaf slot's 9 floats, read through the read-only data cache.
__device__ __forceinline__ bool mt_hit(const float* v, const Ray& r,
                                       float& t) {
  return mt_test(__ldg(v), __ldg(v + 1), __ldg(v + 2), __ldg(v + 3),
                 __ldg(v + 4), __ldg(v + 5), __ldg(v + 6), __ldg(v + 7),
                 __ldg(v + 8), r, t);
}

// A lane's stack of (code, entry distance). Its deepest use is the tree's
// worst push depth (PackedBVH.stack_*), which the wrapper checked against
// CAP before the launch. It lives in local memory: cached in L1 as far as
// it is used (10 entries on the flagship), and measured faster than a
// stack of the tree's depth in shared memory, which takes the L1 that
// caches the BVH rows (PERF.md).
template <int CAP>
struct Stack {
  int code[CAP];
  float key[CAP];
  int sp;

  // false (and nothing stored) when the stack is full
  __device__ __forceinline__ bool push(int c, float k) {
    if (sp >= CAP) return false;
    code[sp] = c;
    key[sp] = k;
    ++sp;
    return true;
  }

  // Pop the nearest entry that can still beat `best`; false when empty.
  __device__ __forceinline__ bool pop(float best, int& c) {
    while (sp > 0) {
      --sp;
      if (key[sp] <= best) {
        c = code[sp];
        return true;
      }
    }
    return false;
  }
};

// Binary node row: lo(0:3) hi(3:6) leaf row(6) count(7) miss(8) right(9).
struct Node {
  float4 a;  // lx ly lz hx
  float4 b;  // hy hz leaf_row count
  float4 c;  // miss right - -
};

__device__ __forceinline__ Node load_node(const float* nodes, int i) {
  const float4* p =
      reinterpret_cast<const float4*>(nodes + (size_t)i * kNodeRow);
  return Node{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// The node rows the wrappers pass are the walk rows (PackedBVH.
// nodes_walk): each box widened on the host as the group boxes are
// (utils/boxes.pad_box), so a hit at a box face is not culled
// by rounding, with no extra work per test.
__device__ __forceinline__ bool node_slab(const Node& nd, const Ray& r,
                                          float best, float& tn) {
  return slab(nd.a.x, nd.a.y, nd.a.z, nd.a.w, nd.b.x, nd.b.y, r, best, tn);
}

// traverse_mk4's order: near child first; the far child waits on the
// stack with its entry distance, and is dropped on pop when that exceeds
// the visitor's bound.
template <class V, class S>
__device__ void walk_ordered_binary(V& v, S& st) {
  st.sp = 0;
  int cursor = 0;
  float tn;
  if (!v.box(v.node(0), tn)) return;
  while (true) {
    const Node nd = v.node(cursor);
    const int count = static_cast<int>(nd.b.w);
    if (count > 0) {
      if (v.leaf(static_cast<int>(nd.b.z), count)) return;
    } else {
      const int left = cursor + 1;
      const int right = static_cast<int>(nd.c.y);
      float tl, tr = 0.f;
      const bool hl = v.box(v.node(left), tl);
      const bool hr = right >= 0 && v.box(v.node(right), tr);
      if (hl && hr) {
        const bool l_first = tl <= tr;
        if (st.push(l_first ? right : left, l_first ? tr : tl))
          v.pushed(st.sp);
        else
          v.overflow();
        cursor = l_first ? left : right;
        continue;
      }
      if (hl || hr) {
        cursor = hl ? left : right;
        continue;
      }
    }
    if (!st.pop(v.bound(), cursor)) return;
  }
}

// traverse_mk3's order: threaded by miss links, no stack.
template <class V>
__device__ void walk_threaded_binary(V& v) {
  int cursor = 0;
  while (cursor >= 0) {
    const Node nd = v.node(cursor);
    float tn;
    const bool hit = v.box(nd, tn);
    const int count = static_cast<int>(nd.b.w);
    if (hit && count > 0 && v.leaf(static_cast<int>(nd.b.z), count)) return;
    cursor = (hit && count <= 0) ? cursor + 1 : static_cast<int>(nd.c.x);
  }
}

}  // namespace urt
