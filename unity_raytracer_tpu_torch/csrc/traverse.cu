// Mesh BVH traversal kernels for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package, which share their
// outputs and their epilogue (ops/kernels/traverse_mk3.py):
//   MK3      traverse_packet3 (ops/pallas/traverse_mk3.py, pallas_call at
//            :354): binary walk in threaded order, leftmost-DFS descent to
//            node + 1 on a box hit, else the node's miss link;
//   MK4      traverse_packet4 (ops/pallas/traverse_mk4.py:225): binary
//            walk, near child first by entry distance, the far child
//            pushed with its entry distance;
//   WIDE4/8  traverse_wide (ops/pallas/traverse_wide.py:473): BVH4/8 rows,
//            hit children sorted by entry distance and pushed far to
//            near.
// Each walks in NEAREST mode (the smallest t below tmax) or ANY mode (the
// first occluder below tmax; the lane is parked at t = -1). Per lane it
// writes t (tmax where nothing is closer; -1 on an ANY hit), the winning
// slot in its 14-slot leaf row and that row; slot = row = -1 on a miss.
// A lane with tmax < 0 is culled before the root and keeps its tmax.
//
// The binary walks and the ray, slab, group-box and Möller–Trumbore tests
// are the fused segment kernel's too (bvh_walk.cuh); this file gives them
// its leaf test and its counting.
//
// Design: every lane walks its own ray and prunes pops by its own best t.
// The TPU kernels walk one cursor per tile of 1024 rays with a scalar
// stack in SMEM and prune against the tile's largest best t; those are
// Mosaic constraints (docs/KERNELS.md), not semantics, and are not copied.
// What they leave: mk3 keeps its threaded order (it needs no stack), mk4
// its near-child-first order, wide its far-to-near pushes. A per-lane walk
// meets hits in another order than the tile's, so of two triangles at
// exactly equal t (a shared edge) it may keep the other one; t itself is
// the same.
//
// Leaf tests are Möller–Trumbore on the host-packed `tris` rows (14
// triangles of 9 floats per 128-float row, leaf_rows rows per leaf), in
// groups of 7 slots: a group is tested only when the ray enters its box
// (leafbox, one per group, over its live slots, widened outward) at or
// below the lane's best t (raised by kGroupMargin); a skipped group holds no hit at t <= best, so
// strict < keeps the same winner, in slot order. The binary walks stop at
// the node's triangle count; the wide walk tests every group of the leaf,
// whose unused slots are all-zero triangles that fail the determinant test
// (traverse_wide.py:391). The box test is the kernels' slab test: 1/d
// clamped to +-1e-30, entry distance clamped at 0, hit when tn <= tf and
// tn <= the running best t.
//
// What bounds it on this card: divergent pointer chasing, not bytes or
// FP32 (PERF.md: the walks ran at 5-7% of their bound). The 32 rays of a
// warp visit different nodes and leaves, so their loads of the node and
// leaf rows (they fit in the 50 MB L2) are scattered and serialised, and
// the leaf-slot tests, most of a walk's work on 98-slot leaves, run with
// a third of the warp active (PERF.md). The redesign of kernel #4
// (MK4) culls leaf groups by their box (above), which cuts the slot
// tests; the culled leaf test is every layout's. Its stack stays in local
// memory (kStackBinary entries; the wrapper holds the tree's worst push
// depth, PackedBVH.stack_binary, to it before the launch): a stack of the
// tree's depth in shared memory, and persistent warps taking 32 lanes at a
// time from a counter, were measured slower (PERF.md). WIDE keeps its
// kStackWide-entry stack.
//
// Numerics: IEEE division, no fast-math, no FMA contraction (built with
// -fmad=false, ops/kernels/_lib.py), so each product and sum rounds where
// the plain PyTorch version (traverse_mk3.traverse_plain) rounds it.
//
// A push that would overflow the stack is dropped and counted in
// *overflow; the wrapper raises when the count is not zero (it checked
// the tree's depth against the capacity, so none is). A counting instance (template flag C,
// launched only by chip_smoke.py to measure the work) adds each lane's
// tallies to device counters (traverse_mk3.COUNTS) and sets a byte for
// every table row and every leaf slot it reads, so the bytes the launch
// must move count each row it needs once.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bvh_walk.cuh"

namespace {

using namespace urt;

constexpr int kBlock = 128;
constexpr int kCounts = 6;        // traverse_mk3.COUNTS

enum Layout { kMk3 = 0, kMk4 = 1, kWide4 = 2, kWide8 = 3 };

struct Args {
  const float* o;        // [n, 3]
  const float* d;        // [n, 3]
  const float* tmax;     // [n]
  const float* table;    // nodes [Nn, 16] (MK3, MK4) or wide [Nw, 8*arity]
  const float* tris;     // [rows, 128]
  const float* leafbox;  // [rows, 16]: the two group boxes of a tris row
  float* t_out;          // [n]
  int* slot_out;         // [n]
  int* leaf_out;         // [n]
  int* overflow;         // [1]: dropped stack pushes
  unsigned long long* counts;  // C: kCounts tallies
  unsigned char* seen_rows;    // C: [table rows] set where a row is read
  unsigned char* seen_slots;   // C: [tris rows * 14] set where a slot is
                               //    tested
  int n;
  int leaf_rows;
};

// the lane's result and, in the counting instance, its tallies: slab
// tests (node and group boxes), MT tests, warp issues of an MT test,
// deepest stack, group box tests
struct Lane {
  float best_t;
  int slot;
  int leaf;
  unsigned long long slab;
  unsigned long long mt;
  unsigned long long issue;
  int depth;
  unsigned long long groups;
};

// The triangles of the leaf whose first row is leaf_row, in slot order, a
// group of kGroup slots at a time; count < 0 tests every slot of every
// row. Strict <: of equal t the first one met is kept. Returns true when
// an ANY walk found its occluder.
template <bool ANY, bool C>
__device__ __forceinline__ bool leaf_tests(const Args& a, int leaf_row,
                                           int count, const Ray& r,
                                           Lane& l) {
  const int n = count >= 0 ? count : a.leaf_rows * kLeafSlots;
  for (int j0 = 0; j0 < n; j0 += kGroup) {
    if constexpr (C) {
      ++l.slab;
      ++l.groups;
    }
    if (!group_hit(a.leafbox, leaf_row, j0, r, l.best_t)) continue;
    const int end = j0 + kGroup < n ? j0 + kGroup : n;
    for (int j = j0; j < end; ++j) {
      const int rr = j / kLeafSlots, k = j % kLeafSlots;
      if constexpr (C) {
        ++l.mt;
        a.seen_slots[(size_t)(leaf_row + rr) * kLeafSlots + k] = 1;
        if (static_cast<int>(threadIdx.x & 31) == __ffs(__activemask()) - 1)
          ++l.issue;
      }
      float t;
      if (mt_hit(a.tris + (size_t)(leaf_row + rr) * kRow + 9 * k, r, t) &&
          t < l.best_t) {
        l.slot = k;
        l.leaf = leaf_row + rr;
        if constexpr (ANY) {
          l.best_t = -1.f;  // parked: no later box or leaf test passes
          return true;
        }
        l.best_t = t;
      }
    }
  }
  return false;
}

// The binary walks' visitor (bvh_walk.cuh): box tests against the lane's
// best t, leaf_tests at the node's triangle count.
template <bool ANY, bool C>
struct BinaryLane {
  const Args& a;
  const Ray& r;
  Lane& l;
  __device__ Node node(int i) const {
    if constexpr (C) a.seen_rows[i] = 1;
    return load_node(a.table, i);
  }
  __device__ bool box(const Node& nd, float& tn) const {
    if constexpr (C) ++l.slab;
    return node_slab(nd, r, l.best_t, tn);
  }
  __device__ bool leaf(int row, int count) const {
    return leaf_tests<ANY, C>(a, row, count, r, l);
  }
  __device__ float bound() const { return l.best_t; }
  __device__ void overflow() const { atomicAdd(a.overflow, 1); }
  __device__ void pushed(int sp) const {
    if constexpr (C) l.depth = max(l.depth, sp);
  }
};

// WIDE: slab-test the ARITY children of wide row `cursor`, sort the hits
// by entry distance and push them far to near. Stack codes: a wide row
// (>= 0), or -(leaf row + 2) for a leaf child.
template <int ARITY, bool ANY, bool C>
__device__ void walk_wide(const Args& a, const Ray& r, Lane& l) {
  int code[kStackWide];
  float key[kStackWide];
  int sp = 0;
  int cursor = 0;  // wide row 0 holds the root's children
  while (true) {
    if (cursor >= 0) {
      if constexpr (C) a.seen_rows[cursor] = 1;
      const float4* row = reinterpret_cast<const float4*>(
          a.table + (size_t)cursor * 8 * ARITY);
      float k[ARITY];
      int c[ARITY];
#pragma unroll
      for (int s = 0; s < ARITY; ++s) {
        const float4 lo = __ldg(row + 2 * s);      // lx ly lz hx
        const float4 hi = __ldg(row + 2 * s + 1);  // hy hz meta count
        if constexpr (C) l.slab += hi.w >= 0.f;
        float tn;
        const bool hit = hi.w >= 0.f && slab(lo.x, lo.y, lo.z, lo.w, hi.x,
                                             hi.y, r, l.best_t, tn);
        k[s] = hit ? tn : INFINITY;
        const int meta = static_cast<int>(hi.z);
        c[s] = hi.w > 0.f ? -(meta + 2) : meta;
      }
#pragma unroll
      for (int i = 1; i < ARITY; ++i) {
#pragma unroll
        for (int j = i; j > 0; --j) {
          if (k[j - 1] > k[j]) {
            const float kk = k[j - 1];
            k[j - 1] = k[j];
            k[j] = kk;
            const int cc = c[j - 1];
            c[j - 1] = c[j];
            c[j] = cc;
          }
        }
      }
#pragma unroll
      for (int s = ARITY - 1; s >= 0; --s) {
        if (k[s] < INFINITY) {
          if (sp < kStackWide) {
            code[sp] = c[s];
            key[sp] = k[s];
            ++sp;
            if constexpr (C) l.depth = max(l.depth, sp);
          } else {
            atomicAdd(a.overflow, 1);
          }
        }
      }
    } else if (leaf_tests<ANY, C>(a, -cursor - 2, -1, r, l)) {
      return;
    }
    bool popped = false;
    while (sp > 0) {
      --sp;
      if (key[sp] <= l.best_t) {
        cursor = code[sp];
        popped = true;
        break;
      }
    }
    if (!popped) return;
  }
}

template <bool C>
__device__ __forceinline__ void flush(const Args& a, const Lane& l,
                                      unsigned long long live) {
  if constexpr (C) {
    atomicAdd(a.counts, l.slab);
    atomicAdd(a.counts + 1, l.mt);
    atomicAdd(a.counts + 2, l.issue);
    atomicMax(a.counts + 3, static_cast<unsigned long long>(l.depth));
    atomicAdd(a.counts + 4, live);
    atomicAdd(a.counts + 5, l.groups);
  }
}

// One thread per ray.
template <int LAYOUT, bool ANY, bool C>
__global__ void __launch_bounds__(kBlock) traverse_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  Lane l{a.tmax[i], -1, -1, 0ull, 0ull, 0ull, 0, 0ull};
  if (l.best_t >= 0.f) {  // tmax < 0 culls the lane before the root
    const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    const Ray r{a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2], dx, dy, dz,
                1.0f / fix_dir(dx), 1.0f / fix_dir(dy), 1.0f / fix_dir(dz)};
    if constexpr (LAYOUT == kWide4 || LAYOUT == kWide8) {
      walk_wide<LAYOUT == kWide4 ? 4 : 8, ANY, C>(a, r, l);
    } else {
      BinaryLane<ANY, C> v{a, r, l};
      if constexpr (LAYOUT == kMk3) {
        walk_threaded_binary(v);
      } else {
        Stack<kStackBinary> st;
        walk_ordered_binary(v, st);
      }
    }
  }
  a.t_out[i] = l.best_t;
  a.slot_out[i] = l.slot;
  a.leaf_out[i] = l.leaf;
  flush<C>(a, l, a.tmax[i] >= 0.f);
}

template <int LAYOUT, bool ANY, bool C>
cudaError_t go(const Args& a, cudaStream_t s) {
  traverse_kernel<LAYOUT, ANY, C><<<(a.n + kBlock - 1) / kBlock, kBlock, 0,
                                    s>>>(a);
  return cudaGetLastError();
}

template <int LAYOUT>
cudaError_t launch(const Args& a, bool any_hit, bool count, cudaStream_t s) {
  switch ((any_hit ? 2 : 0) + (count ? 1 : 0)) {
    case 0: return go<LAYOUT, false, false>(a, s);
    case 1: return go<LAYOUT, false, true>(a, s);
    case 2: return go<LAYOUT, true, false>(a, s);
    default: return go<LAYOUT, true, true>(a, s);
  }
}

}  // namespace

extern "C" {

// One walk over n rays on `stream`. layout: 0 MK3, 1 MK4 (table = nodes
// [Nn,16]), 2 WIDE with arity 4, 3 WIDE with arity 8 (table = wide
// [Nw, 8*arity]); leafbox the group boxes of the tris rows; overflow the
// int32 counter of dropped stack pushes. A non-null `counts` (kCounts x u64) selects the counting
// instance, which also needs `seen_rows` (one byte per table row) and
// `seen_slots` (one byte per leaf slot, rows of tris x 14). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown layout).
int urt_traverse(const float* o, const float* d, const float* tmax, int n,
                 int layout, int any_hit, const float* table,
                 const float* tris, const float* leafbox, int leaf_rows,
                 float* t_out, int* slot_out, int* leaf_out,
                 int* overflow, unsigned long long* counts,
                 unsigned char* seen_rows, unsigned char* seen_slots,
                 void* stream) {
  const Args a{o,         d,        tmax,       table,     tris,
               leafbox,   t_out,    slot_out,   leaf_out,  overflow,
               counts,    seen_rows, seen_slots, n,        leaf_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool any = any_hit != 0, count = counts != nullptr;
  switch (layout) {
    case kMk3: return static_cast<int>(launch<kMk3>(a, any, count, s));
    case kMk4: return static_cast<int>(launch<kMk4>(a, any, count, s));
    case kWide4: return static_cast<int>(launch<kWide4>(a, any, count, s));
    case kWide8: return static_cast<int>(launch<kWide8>(a, any, count, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
