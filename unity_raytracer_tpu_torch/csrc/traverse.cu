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
//            hit children sorted by entry distance; the walk descends into
//            the nearest and pushes the others far to near.
// Each walks in NEAREST mode (the smallest t below tmax) or ANY mode (the
// first occluder below tmax; the lane is parked at t = -1). Per lane it
// writes t (tmax where nothing is closer; -1 on an ANY hit), the winning
// slot in its 14-slot leaf row and that row; slot = row = -1 on a miss.
// A lane with tmax < 0 is culled before the root and keeps its tmax.
//
// The binary walks and the ray, slab, group-box and Möller–Trumbore tests
// are the fused segment kernel's too (bvh_walk.cuh); this file gives them
// its leaf tests and its counting.
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
// below the lane's bound (raised by kGroupMargin); a skipped group holds
// no hit at t <= the bound, so strict < keeps the same winner, in slot
// order. Every walk stops at the leaf's triangle count (the wide walk
// carries it in its stack code, WideStack). The box test is the
// kernels' slab test: 1/d clamped to +-1e-30, entry distance clamped at
// 0, hit when tn <= tf and tn <= the running best t. The table is the
// walk rows (PackedBVH.nodes_walk / wide_walk): every node and child box
// widened on the host by the group boxes' rule (utils/boxes.pad_box), so
// a ray aimed at a triangle's corner or edge keeps its hit.
//
// What bounds it on this card: divergent pointer chasing, not bytes or
// FP32 (PERF.md: the walks ran at 4-7% of their bound). The 32 rays of a
// warp visit different nodes and leaves, so their loads of the node and
// leaf rows (they fit in the 50 MB L2) are scattered and serialised, and
// the leaf-slot tests, most of a walk's work on 98-slot leaves, ran with
// a quarter of the warp active when each lane tested its own leaf.
//
// MK4 keeps that per-lane leaf test (leaf_tests, culled by group boxes)
// and its local-memory stack (kStackBinary entries; the wrapper holds the
// tree's worst push depth, PackedBVH.stack_binary, to it before the
// launch): a stack of the tree's depth in shared memory, and persistent
// warps, were measured slower (PERF.md).
//
// MK3 and WIDE test leaves warp-cooperatively (coop_kernel): each lane
// walks until it holds a leaf to test or its walk ends; then the whole
// warp runs a leaf phase over every pending leaf (leaf_phase): the
// (owner, group) pairs are spread one per lane and their group boxes
// slab-tested against the owner's bound at leaf entry, the slots of the
// surviving groups are spread one per lane, 4 groups (28 lanes) a pass,
// and each owner keeps the lexicographic minimum of (t, slot in leaf
// order) over its hits below that bound (the first hitting slot in ANY
// mode). The owners' rays, bounds and results meet in shared memory. A
// lane's walk order and bound are those of the sequential leaf test: its
// bound changes only in a leaf phase, to the value the sequential loop
// ends that leaf with. Culling at the entry bound tests every group the
// sequential loop tests (whose running bound only falls) and maybe more;
// a group the sequential loop skips holds no hit at or below its running
// bound, so the extra groups cannot change the minimum, and ties go to
// the lower slot as the sequential strict < gives them. WIDE descends
// straight into its nearest hit child and pushes only the others, far to
// near: a walk that pushed every hit child would push that one last and
// pop it at once (its key, the child's entry distance, is at most the
// unchanged bound). Its stack keeps kStackWide entries.
//
// Numerics: IEEE division, no fast-math, no FMA contraction (built with
// -fmad=false, ops/kernels/_lib.py), so each product and sum rounds where
// the plain PyTorch version (traverse_mk3.traverse_plain) rounds it.
//
// A push that would overflow the stack is dropped and counted in
// *overflow; the wrapper raises when the count is not zero (it checked
// the tree's depth against the capacity, so none is). A counting
// instance (template flag C, launched only by chip_smoke.py to measure the
// work) adds each lane's tallies to device counters (traverse_mk3.COUNTS)
// and sets a byte for every table row and every leaf slot it reads, so
// the bytes the launch must move count each row it needs once. Its slab,
// group-box and slot tests, and the slots it marks, are the work the walk
// needs: in MK3 and WIDE each owner also runs the sequential leaf test
// (leaf_tests) on a scratch lane from its entry bound, for its tallies
// alone, so the tests the cooperative phase adds (groups culled only at
// the entry bound, an ANY leaf's slots after its first hit) do not count
// as work. An issue is one warp instruction of a slot test: a lane's own
// test in MK4, a cooperative pass in MK3 and WIDE, whose slot tests are
// counted apart (pass_slots).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bvh_walk.cuh"

namespace {

using namespace urt;

constexpr int kBlock = 128;
constexpr int kCounts = 7;        // traverse_mk3.COUNTS
constexpr int kPassGroups = 4;    // leaf groups per cooperative slot pass

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
// deepest stack, group box tests, slot tests of the cooperative passes
struct Lane {
  float best_t;
  int slot;
  int leaf;
  unsigned long long slab;
  unsigned long long mt;
  unsigned long long issue;
  int depth;
  unsigned long long groups;
  unsigned long long pass_slots;
};

// The count triangles of the leaf whose first row is leaf_row, in slot
// order, a group of kGroup slots at a time. Strict <: of equal t the first
// one met is kept. Returns true when an ANY walk found its occluder. MK4's
// leaf test.
template <bool ANY, bool C>
__device__ __forceinline__ bool leaf_tests(const Args& a, int leaf_row,
                                           int n, const Ray& r, Lane& l) {
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

// The ordered binary walk's visitor (bvh_walk.cuh): box tests against the
// lane's best t, leaf_tests at the node's triangle count.
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
    atomicAdd(a.counts + 6, l.pass_slots);
  }
}

// MK4: one thread per ray, each testing its own leaves.
template <int LAYOUT, bool ANY, bool C>
__global__ void __launch_bounds__(kBlock) traverse_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  Lane l{a.tmax[i], -1, -1, 0ull, 0ull, 0ull, 0, 0ull, 0ull};
  if (l.best_t >= 0.f) {  // tmax < 0 culls the lane before the root
    const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    const Ray r{a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2], dx, dy, dz,
                1.0f / fix_dir(dx), 1.0f / fix_dir(dy), 1.0f / fix_dir(dz)};
    BinaryLane<ANY, C> v{a, r, l};
    Stack<kStackBinary> st;
    walk_ordered_binary(v, st);
  }
  a.t_out[i] = l.best_t;
  a.slot_out[i] = l.slot;
  a.leaf_out[i] = l.leaf;
  flush<C>(a, l, a.tmax[i] >= 0.f);
}

// ---------------------------------------------------------------------------
// MK3 and WIDE: walks with a warp-cooperative leaf phase
// ---------------------------------------------------------------------------

constexpr unsigned long long kNoKey = ~0ull;

// A warp's shared memory for its leaf phases: every lane's ray (written
// once), each owner's pending leaf (first tris row, triangle count) and
// bound at leaf entry, each owner's reduction key, and the queue of leaf
// groups whose box test passed, (group << 5) | owner, waiting for a slot
// pass (at most kPassGroups - 1 left over plus one warp's worth).
struct WarpLeaves {
  float ray[9][kWarp];  // ox oy oz dx dy dz ix iy iz
  float bound[kWarp];
  int row[kWarp];
  int count[kWarp];
  unsigned long long key[kWarp];
  unsigned queue[kWarp + kPassGroups];
};

__device__ __forceinline__ Ray owner_ray(const WarpLeaves& s, int o) {
  return Ray{s.ray[0][o], s.ray[1][o], s.ray[2][o], s.ray[3][o], s.ray[4][o],
             s.ray[5][o], s.ray[6][o], s.ray[7][o], s.ray[8][o]};
}

// One slot pass over queue[h .. h + groups): lane l tests slot l % 7 of
// queued group l / 7 for that group's owner, below the owner's entry
// bound and its count, and folds a hit into the owner's key: (t bits,
// slot in leaf order), or the slot alone in ANY mode. t > kEps > 0 on a
// hit, so its bits order as the floats do, and the 64-bit minimum is the
// lexicographic one.
template <bool ANY, bool C>
__device__ __forceinline__ void slot_pass(const Args& a, WarpLeaves& s,
                                          int h, int groups, Lane& l) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  if constexpr (C) {
    if (lane == 0) ++l.issue;
  }
  if (lane >= kGroup * groups) return;
  const unsigned e = s.queue[h + lane / kGroup];
  const int o = static_cast<int>(e & 31u);
  const int j = static_cast<int>(e >> 5) * kGroup + lane % kGroup;
  if (j >= s.count[o]) return;
  const int row = s.row[o] + j / kLeafSlots, k = j % kLeafSlots;
  if constexpr (C) ++l.pass_slots;
  float t;
  if (mt_hit(a.tris + (size_t)row * kRow + 9 * k, owner_ray(s, o), t) &&
      t < s.bound[o]) {
    const unsigned long long key =
        ANY ? static_cast<unsigned long long>(j)
            : (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
                  static_cast<unsigned>(j);
    atomicMin(&s.key[o], key);
  }
}

// The warp's leaf phase over every lane with `pending` set (its leaf in
// s.row / s.count). Called by all 32 lanes. An owner leaves with its
// result in l (and `done` set on an ANY hit).
template <bool ANY, bool C>
__device__ void leaf_phase(const Args& a, WarpLeaves& s, bool pending,
                           Lane& l, bool& done) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  int groups = 0;
  if (pending) {
    s.bound[lane] = l.best_t;
    s.key[lane] = kNoKey;
    groups = (s.count[lane] + kGroup - 1) / kGroup;
    if constexpr (C) {  // the work the walk needs: the sequential test's
      Lane q{l.best_t, -1, -1, 0ull, 0ull, 0ull, 0, 0ull, 0ull};
      leaf_tests<ANY, true>(a, s.row[lane], s.count[lane],
                            owner_ray(s, lane), q);
      l.slab += q.slab;
      l.groups += q.groups;
      l.mt += q.mt;
    }
  }
  int incl = groups;  // inclusive prefix sum of the owners' groups
#pragma unroll
  for (int step = 1; step < kWarp; step <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, step);
    if (lane >= step) incl += v;
  }
  const int excl = incl - groups;
  const int total = __shfl_sync(kFull, incl, kWarp - 1);
  __syncwarp();
  int queued = 0;
  for (int p0 = 0; p0 < total; p0 += kWarp) {
    // pair p: the owner o whose [excl, incl) holds p, its group p - excl
    const int p = p0 + lane;
    int o = 0;
#pragma unroll
    for (int step = kWarp / 2; step > 0; step >>= 1)
      if (__shfl_sync(kFull, incl, o + step - 1) <= p) o += step;
    const int g = p - __shfl_sync(kFull, excl, o & 31);
    bool keep = false;
    if (p < total) {
      keep = group_hit(a.leafbox, s.row[o], g * kGroup, owner_ray(s, o),
                       s.bound[o]);
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep)
      s.queue[queued + __popc(kept & ((1u << lane) - 1u))] =
          (static_cast<unsigned>(g) << 5) | static_cast<unsigned>(o);
    queued += __popc(kept);
    __syncwarp();
    int h = 0;
    for (; h + kPassGroups <= queued; h += kPassGroups)
      slot_pass<ANY, C>(a, s, h, kPassGroups, l);
    // the rest (fewer than kPassGroups) moves to the queue's front
    const int rest = queued - h;
    const unsigned e = lane < rest ? s.queue[h + lane] : 0u;
    __syncwarp();
    if (lane < rest) s.queue[lane] = e;
    __syncwarp();
    queued = rest;
  }
  if (queued) slot_pass<ANY, C>(a, s, 0, queued, l);
  __syncwarp();
  if (pending) {
    const unsigned long long key = s.key[lane];
    if (key != kNoKey) {
      const int j = static_cast<int>(key & 0xffffffffull);
      l.slot = j % kLeafSlots;
      l.leaf = s.row[lane] + j / kLeafSlots;
      if constexpr (ANY) {
        l.best_t = -1.f;  // parked
        done = true;
      } else {
        l.best_t = __uint_as_float(static_cast<unsigned>(key >> 32));
      }
    }
  }
  __syncwarp();
}

// MK3's walk up to its next leaf: leftmost-DFS by miss links, as
// walk_threaded_binary (bvh_walk.cuh) walks it. Returns true with the
// leaf's row and count, the cursor past it; false when the walk ended.
template <bool C>
__device__ __forceinline__ bool threaded_to_leaf(const Args& a, const Ray& r,
                                                 Lane& l, int& cursor,
                                                 int& row, int& count) {
  while (cursor >= 0) {
    if constexpr (C) {
      a.seen_rows[cursor] = 1;
      ++l.slab;
    }
    const Node nd = load_node(a.table, cursor);
    float tn;
    const bool hit = node_slab(nd, r, l.best_t, tn);
    const int c = static_cast<int>(nd.b.w);
    if (hit && c > 0) {
      row = static_cast<int>(nd.b.z);
      count = c;
      cursor = static_cast<int>(nd.c.x);
      return true;
    }
    cursor = hit ? cursor + 1 : static_cast<int>(nd.c.x);
  }
  return false;
}

// A wide walk's stack. Its codes, and the cursor's: a wide row (>= 0); a
// leaf child -(2 + the tris slot index of its last triangle), i.e. -(2 +
// leaf row * 14 + count - 1), so a popped leaf knows its count (leaf rows
// are multiples of leaf_rows, and count <= leaf_rows * 14); -1: pop next.
// A code fits an int32 for any tris table under 2^31 / 14 rows.
template <int CAP>
struct WideStack {
  int code[CAP];
  float key[CAP];
  int sp;
};

// WIDE's walk up to its next leaf: expand row `cursor` (slab-test its
// children, sort the hits by entry distance), descend into the nearest
// and push the others far to near; pop the nearest entry that can still
// beat the bound when the row had no hit or a leaf was tested. Returns
// true with the leaf's row and count; false when the walk ended.
template <int ARITY, bool C>
__device__ __forceinline__ bool wide_to_leaf(const Args& a, const Ray& r,
                                             Lane& l,
                                             WideStack<kStackWide>& st,
                                             int& cursor, int& row,
                                             int& count) {
  while (true) {
    if (cursor >= 0) {
      if constexpr (C) a.seen_rows[cursor] = 1;
      const float4* w = reinterpret_cast<const float4*>(
          a.table + (size_t)cursor * 8 * ARITY);
      float k[ARITY];
      int c[ARITY];
#pragma unroll
      for (int s = 0; s < ARITY; ++s) {
        const float4 lo = __ldg(w + 2 * s);      // lx ly lz hx
        const float4 hi = __ldg(w + 2 * s + 1);  // hy hz meta count
        if constexpr (C) l.slab += hi.w >= 0.f;
        float tn;
        const bool hit = hi.w >= 0.f && slab(lo.x, lo.y, lo.z, lo.w, hi.x,
                                             hi.y, r, l.best_t, tn);
        k[s] = hit ? tn : INFINITY;
        const int meta = static_cast<int>(hi.z);
        c[s] = hi.w > 0.f
                   ? -(meta * kLeafSlots + static_cast<int>(hi.w) + 1)
                   : meta;
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
      for (int s = ARITY - 1; s >= 1; --s) {
        if (k[s] < INFINITY) {
          if (st.sp < kStackWide) {
            st.code[st.sp] = c[s];
            st.key[st.sp] = k[s];
            ++st.sp;
            if constexpr (C) l.depth = max(l.depth, st.sp);
          } else {
            atomicAdd(a.overflow, 1);
          }
        }
      }
      if (k[0] < INFINITY) {
        cursor = c[0];
        continue;
      }
    } else if (cursor <= -2) {
      const int last = -cursor - 2;
      row = last / kLeafSlots / a.leaf_rows * a.leaf_rows;
      count = last - row * kLeafSlots + 1;
      cursor = -1;
      return true;
    }
    cursor = -1;
    while (st.sp > 0) {
      --st.sp;
      if (st.key[st.sp] <= l.best_t) {
        cursor = st.code[st.sp];
        break;
      }
    }
    if (cursor == -1) return false;
  }
}

// MK3 / WIDE: one thread per ray; whole warps stay to the end, since the
// leaf phases need all 32 lanes.
template <int LAYOUT, bool ANY, bool C>
__global__ void __launch_bounds__(kBlock) coop_kernel(const Args a) {
  __shared__ WarpLeaves leaves[kBlock / kWarp];
  WarpLeaves& s = leaves[threadIdx.x / kWarp];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  Lane l{in ? a.tmax[i] : -1.f, -1, -1, 0ull, 0ull, 0ull, 0, 0ull, 0ull};
  const bool live = in && l.best_t >= 0.f;  // tmax < 0: culled
  Ray r{};
  if (live) {
    const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    r = Ray{a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2], dx, dy, dz,
            1.0f / fix_dir(dx), 1.0f / fix_dir(dy), 1.0f / fix_dir(dz)};
  }
  if (__ballot_sync(kFull, live)) {
    s.ray[0][lane] = r.ox;
    s.ray[1][lane] = r.oy;
    s.ray[2][lane] = r.oz;
    s.ray[3][lane] = r.dx;
    s.ray[4][lane] = r.dy;
    s.ray[5][lane] = r.dz;
    s.ray[6][lane] = r.ix;
    s.ray[7][lane] = r.iy;
    s.ray[8][lane] = r.iz;
    bool done = !live;
    int cursor = 0;
    constexpr bool kWide = LAYOUT == kWide4 || LAYOUT == kWide8;
    WideStack<kWide ? kStackWide : 1> st;  // MK3 needs none
    st.sp = 0;
    while (true) {
      bool pending = false;
      int row = 0, count = 0;
      if (!done) {
        if constexpr (kWide)
          pending = wide_to_leaf<LAYOUT == kWide4 ? 4 : 8, C>(
              a, r, l, st, cursor, row, count);
        else
          pending = threaded_to_leaf<C>(a, r, l, cursor, row, count);
        done = !pending;
        if (pending) {
          s.row[lane] = row;
          s.count[lane] = count;
        }
      }
      if (!__any_sync(kFull, pending)) break;
      leaf_phase<ANY, C>(a, s, pending, l, done);
    }
  }
  if (in) {
    a.t_out[i] = l.best_t;
    a.slot_out[i] = l.slot;
    a.leaf_out[i] = l.leaf;
    flush<C>(a, l, live);
  }
}

template <int LAYOUT, bool ANY, bool C>
cudaError_t go(const Args& a, cudaStream_t s) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  if constexpr (LAYOUT == kMk4)
    traverse_kernel<LAYOUT, ANY, C><<<blocks, kBlock, 0, s>>>(a);
  else
    coop_kernel<LAYOUT, ANY, C><<<blocks, kBlock, 0, s>>>(a);
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
// [Nw, 8*arity]); leafbox the group boxes of the tris rows; leaf_rows the
// tris rows per leaf (leaf rows are its multiples); overflow the int32
// counter of dropped stack pushes. A non-null `counts` (kCounts x u64)
// selects the counting instance, which also needs `seen_rows` (one byte
// per table row) and `seen_slots` (one byte per leaf slot, rows of tris x
// 14). Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unknown layout).
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
