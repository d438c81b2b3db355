// The Baldwin–Weber leaf records of a refit tree, on the card.
//
// ops/bvh.refit rewrites every row of a fixed BVH from the scene's current
// mesh verts; the records of PackedBVH.tris_bw are the one part that is
// arithmetic rather than gathers and box unions, so they get a kernel of
// their own: one thread per record position of a leaf, reading its slot's
// triangle from the tris rows the refit has just written.
//
// The record is ops/kernels/traverse_mk3.pack_bw's, in float64 with every
// operation in numpy's order (np.cross: two products, then their
// difference; a 3-term sum over the last axis: (x0 + x1) + x2), each
// correctly rounded (-fmad=false: no contraction), and rounded to float32
// at the end, so the kernel writes the host packer's bits:
//   n0 = e1 x e2, n2 = n0.n0, ok = n2 > 1e-30 (else a zero record),
//   nh = n0 / sqrt(n2), dh = nh.v0, a = (e2 x n0) / n2, a0 = -(a.v0),
//   b = (n0 x e1) / n2, b0 = -(b.v0)
// laid out (nh, dh, a, a0, b, b0). Layout: leaf l's slot j (rows_per_leaf
// * 14 of them) is lanes 9 (j % 14) .. + 9 of tris row l * rpl + j / 14;
// its record is lanes 12 (j % 10) .. + 12 of out row l * bw_rpl + j / 10;
// positions past the slots and lanes 120..127 are 0.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 14;     // triangles of a tris row (PALLAS_LEAF)
constexpr int kPerRow = 10;    // records of a tris_bw row (BW_PER_ROW)

__host__ __device__ inline void cross(const double* a, const double* b,
                                      double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__host__ __device__ inline double dot(const double* a, const double* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__host__ __device__ inline void bw_record(const float* tri, float* rec) {
  double v0[3], e1[3], e2[3];
  for (int i = 0; i < 3; ++i) {
    v0[i] = tri[i];
    e1[i] = static_cast<double>(tri[3 + i]) - v0[i];
    e2[i] = static_cast<double>(tri[6 + i]) - v0[i];
  }
  double n0[3], a[3], b[3];
  cross(e1, e2, n0);
  const double n2 = dot(n0, n0);
  if (!(n2 > 1e-30)) {
    for (int i = 0; i < 12; ++i) rec[i] = 0.0f;
    return;
  }
  const double s = sqrt(n2);
  double nh[3];
  for (int i = 0; i < 3; ++i) nh[i] = n0[i] / s;
  cross(e2, n0, a);
  cross(n0, e1, b);
  for (int i = 0; i < 3; ++i) {
    a[i] = a[i] / n2;
    b[i] = b[i] / n2;
  }
  const double out[12] = {nh[0], nh[1], nh[2], dot(nh, v0),
                          a[0],  a[1],  a[2],  -dot(a, v0),
                          b[0],  b[1],  b[2],  -dot(b, v0)};
  for (int i = 0; i < 12; ++i) rec[i] = static_cast<float>(out[i]);
}

__global__ void bw_records_kernel(const float* __restrict__ tris,
                                  long long positions, int rpl, int bw_rpl,
                                  float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= positions) return;
  const int per = bw_rpl * kPerRow;
  const long long leaf = i / per;
  const int p = static_cast<int>(i % per);
  float* row = out + (leaf * bw_rpl + p / kPerRow) * 128;
  float rec[12];
  if (p < rpl * kSlots) {
    bw_record(tris + (leaf * rpl + p / kSlots) * 128 + 9 * (p % kSlots),
              rec);
  } else {
    for (int j = 0; j < 12; ++j) rec[j] = 0.0f;
  }
  float* o = row + 12 * (p % kPerRow);
  for (int j = 0; j < 12; ++j) o[j] = rec[j];
  if (p % kPerRow == 0)
    for (int j = 12 * kPerRow; j < 128; ++j) row[j] = 0.0f;
}

}  // namespace

extern "C" {

// Writes the records of n_leaves leaves (out: n_leaves * bw_rpl rows of
// 128 floats) from their tris rows (n_leaves * rpl rows) on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// without a launch, for a count that is not positive).
int urt_bw_records(const float* tris, int n_leaves, int rpl, int bw_rpl,
                   float* out, void* stream) {
  if (n_leaves <= 0 || rpl <= 0 || bw_rpl * kPerRow < rpl * kSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long positions =
      static_cast<long long>(n_leaves) * bw_rpl * kPerRow;
  const int threads = 128;
  bw_records_kernel<<<static_cast<unsigned>((positions + threads - 1) /
                                            threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, positions, rpl, bw_rpl, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
