// Pair-expansion traversal for Hopper (sm_90a): the expand and pair-test
// kernels of tputracer_torch/accel/pairs.py.
//
// expand_kernel replaces tputracer/accel/pairs_tpu.py::_expand_kernel.
// Contract (the plain version, pairs.py::expand_plain): for each ray, the
// slab test against every cluster AABB, op for op as traverse.cu's (and
// clustered.cluster_entries): inv = 1/d with a signed clamp at 1e-12,
// t0 = (cmin - o) * inv, t1 = (cmax - o) * inv, tn = max_a min(t0, t1),
// tf = min_a max(t0, t1); cluster c is admitted iff tn <= tf && tf > tmin
// && tn < tmax && tmin < tmax, at te = max(tn, tmin).  The last term keeps a
// dead lane (tmax = 0) whose origin sits inside a box from getting slots.
// Out: the K smallest admitted keys (te, c) in ascending order (the smaller
// c first at equal te), as cid (N,K) and te (N,K), with -1 and 3e38 in
// empty slots; bound (N,), the te of the (K+1)-th admitted key, or 3e38.
//
// pairtest_kernel replaces tputracer/accel/pairs_tpu.py::_pairtest_kernel.
// Contract (pairs.py::pairtest_plain): for each (ray, cluster) pair, if
// te < bt and cid >= 0, a Moeller-Trumbore test of the cluster's leaf
// slots, op for op as tputracer/accel/traverse_tpu.py::mt_cluster_block,
// accepting tmin < t < bt with mask > 0; the first strict minimum over the
// slots j gives (t, cid*leaf + j); otherwise (3e38, -1).  Each pair is
// tested against its ray's own bt, never a running best, so the pairs are
// independent and their order does not change the result.
//
// Design.  The Pallas kernels run 64-ray tiles through a (TILE, C) slab
// matrix and, for the test, through the union of a tile's clusters with
// the other lanes muted.  Here one thread takes one ray (expand) or one
// pair (test), 128 to a block.
//
//   * expand: the block stages all C AABBs into dynamic shared memory once
//     (24 B a cluster, as traverse.cu does); each thread scans them and
//     keeps the kBuf smallest keys in a sorted register buffer (kBuf = K+1
//     rounded up to 5, 9 or 17, a template argument, so the buffer is never
//     indexed at run time and stays in registers).  Bound: ~25 float ops
//     per cluster per ray from shared memory, no global traffic beyond the
//     rays; one scan, where the union-walk kernel may rescan.
//   * pair test: the pairs arrive sorted by cluster, so the lanes of a warp
//     mostly share a cluster and their reads of its leaf slots of v0, e1,
//     e2 and mask (40 B a slot, L2-resident) are broadcasts.  Bound: ~45
//     float ops per slot per wanted pair; pairs that are not wanted exit at
//     once.  Staging a cluster's block in shared memory per run of equal
//     cid, and warp-cooperative tests, are left for later.
//
// Built with -fmad=false and without fast math, each sum in the plain
// version's order and 1/det IEEE, so both kernels agree with their plain
// versions bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // rays (expand) or pairs (test) per block
constexpr int kMaxSlots = 16;   // the largest K the expand kernel takes
constexpr float kBig = 3.0e38f;
constexpr int kNoCluster = 0x7fffffff;

__device__ __forceinline__ bool key_less(float ta, int ca, float tb, int cb) {
  return ta < tb || (ta == tb && ca < cb);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v >= 0.f ? tiny : -tiny) : v);
}

template <int kBuf>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in,
              const float* __restrict__ cmin,   // (C, 3)
              const float* __restrict__ cmax,   // (C, 3)
              int n_clusters, int n_rays, int k_slots,
              int* __restrict__ cid_out,        // (N, K)
              float* __restrict__ te_out,       // (N, K)
              float* __restrict__ bound_out) {  // (N,)
  extern __shared__ float s_box[];   // [c * 6 + k]: min x y z, max x y z
  const int C = n_clusters;
  for (int k = threadIdx.x; k < 3 * C; k += kThreads) {
    s_box[(k / 3) * 6 + k % 3] = cmin[k];
    s_box[(k / 3) * 6 + 3 + k % 3] = cmax[k];
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float tmin = tmin_in[i], tmax = tmax_in[i];

  const float inf = __int_as_float(0x7f800000);   // empty buffer slot
  float bte[kBuf];
  int bc[kBuf];
#pragma unroll
  for (int k = 0; k < kBuf; ++k) {
    bte[k] = inf;
    bc[k] = kNoCluster;
  }
  if (tmin < tmax) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float ix = safe_inv(d[3 * i]), iy = safe_inv(d[3 * i + 1]),
                iz = safe_inv(d[3 * i + 2]);
    for (int c = 0; c < C; ++c) {
      const float* b = s_box + 6 * c;
      float t0 = (b[0] - ox) * ix, t1 = (b[3] - ox) * ix;
      float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
      t0 = (b[1] - oy) * iy;
      t1 = (b[4] - oy) * iy;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
      t0 = (b[2] - oz) * iz;
      t1 = (b[5] - oz) * iz;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
      if (!(tn <= tf && tf > tmin && tn < tmax)) continue;
      const float te = fmaxf(tn, tmin);
      if (!key_less(te, c, bte[kBuf - 1], bc[kBuf - 1])) continue;
      float nt = te;   // insert: carry the larger key down the buffer
      int nc = c;
#pragma unroll
      for (int k = 0; k < kBuf; ++k) {
        if (key_less(nt, nc, bte[k], bc[k])) {
          const float st = bte[k];
          const int sc = bc[k];
          bte[k] = nt;
          bc[k] = nc;
          nt = st;
          nc = sc;
        }
      }
    }
  }
  // the admitted keys are all < tmax <= 3e38; an empty slot still holds inf
  float bound = kBig;
#pragma unroll
  for (int k = 0; k < kBuf; ++k) {
    const bool full = bc[k] != kNoCluster;
    if (k < k_slots) {
      cid_out[static_cast<size_t>(i) * k_slots + k] = full ? bc[k] : -1;
      te_out[static_cast<size_t>(i) * k_slots + k] = full ? bte[k] : kBig;
    } else if (k == k_slots && full) {
      bound = bte[k];
    }
  }
  bound_out[i] = bound;
}

__global__ void __launch_bounds__(kThreads)
pairtest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin_in,
                const int* __restrict__ cid_in,
                const float* __restrict__ te_in,
                const float* __restrict__ bt_in,
                const float* __restrict__ v0,     // (n_tri, 3)
                const float* __restrict__ e1,     // (n_tri, 3)
                const float* __restrict__ e2,     // (n_tri, 3)
                const float* __restrict__ mask,   // (n_tri,)
                int leaf, int n_pairs,
                float* __restrict__ t_out, int* __restrict__ p_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const int c = cid_in[i];
  const float bt = bt_in[i];
  float t_best = kBig;
  int p_best = -1;
  if (te_in[i] < bt && c >= 0) {
    const float tmin = tmin_in[i];
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const int base = c * leaf;
    float th = kBig;   // first strict minimum, argmin's tie rule
    int jb = 0;
    for (int j = 0; j < leaf; ++j) {
      const int s = base + j;
      if (!(__ldg(mask + s) > 0.f)) continue;
      const float v0x = __ldg(v0 + 3 * s), v0y = __ldg(v0 + 3 * s + 1),
                  v0z = __ldg(v0 + 3 * s + 2);
      const float e1x = __ldg(e1 + 3 * s), e1y = __ldg(e1 + 3 * s + 1),
                  e1z = __ldg(e1 + 3 * s + 2);
      const float e2x = __ldg(e2 + 3 * s), e2y = __ldg(e2 + 3 * s + 1),
                  e2z = __ldg(e2 + 3 * s + 2);
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool ok = fabsf(det) > 1e-12f;
      const float f = 1.0f / (ok ? det : 1.0f);
      const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      const float u = f * (sx * px + sy * py + sz * pz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      if (ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > tmin && t < bt &&
          t < th) {
        th = t;
        jb = j;
      }
    }
    if (th < bt) {
      t_best = th;
      p_best = base + jb;
    }
  }
  t_out[i] = t_best;
  p_out[i] = p_best;
}

template <int kBuf>
int launch_expand(const float* o, const float* d, const float* tmin,
                  const float* tmax, const float* cmin, const float* cmax,
                  int n_clusters, int n_rays, int k_slots, int* cid_out,
                  float* te_out, float* bound_out, cudaStream_t stream) {
  const int smem = static_cast<int>(6 * sizeof(float)) * n_clusters;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_kernel<kBuf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_rays + kThreads - 1) / kThreads;
  expand_kernel<kBuf><<<grid, kThreads, smem, stream>>>(
      o, d, tmin, tmax, cmin, cmax, n_clusters, n_rays, k_slots, cid_out,
      te_out, bound_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may ask for on Hopper (227 KB).
int tpt_pairs_max_clusters() {
  return static_cast<int>(232448 / (6 * sizeof(float)));
}

int tpt_pairs_max_slots() { return kMaxSlots; }

// Each launcher starts its kernel on `stream` and returns cudaGetLastError():
// a refused launch never runs, and a later synchronize would not report it.
// Returns cudaErrorInvalidValue for k_slots outside [1, kMaxSlots].
int tpt_pair_expand(const float* o, const float* d, const float* tmin,
                    const float* tmax, const float* cmin, const float* cmax,
                    int n_clusters, int n_rays, int k_slots, int* cid_out,
                    float* te_out, float* bound_out, void* stream) {
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_slots >= 1 && k_slots <= 4)
    return launch_expand<5>(o, d, tmin, tmax, cmin, cmax, n_clusters, n_rays,
                            k_slots, cid_out, te_out, bound_out, s);
  if (k_slots >= 5 && k_slots <= 8)
    return launch_expand<9>(o, d, tmin, tmax, cmin, cmax, n_clusters, n_rays,
                            k_slots, cid_out, te_out, bound_out, s);
  if (k_slots >= 9 && k_slots <= kMaxSlots)
    return launch_expand<kMaxSlots + 1>(o, d, tmin, tmax, cmin, cmax,
                                        n_clusters, n_rays, k_slots, cid_out,
                                        te_out, bound_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int tpt_pair_test(const float* o, const float* d, const float* tmin,
                  const int* cid, const float* te, const float* bt,
                  const float* v0, const float* e1, const float* e2,
                  const float* mask, int leaf, int n_pairs, float* t_out,
                  int* p_out, void* stream) {
  if (n_pairs <= 0) return 0;
  const int grid = (n_pairs + kThreads - 1) / kThreads;
  pairtest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, cid, te, bt, v0, e1, e2, mask, leaf, n_pairs, t_out, p_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
