// Cluster-BVH traversal for Hopper (sm_90a).
//
// Replaces tputracer/accel/traverse_tpu.py::_traverse_kernel (with its
// slab_te, mt_cluster_block and _traverse_tile), the Pallas kernel that
// walks the 2-level cluster BVH of accel/bvh.py.  The contract is that of
// the plain version, tputracer_torch/accel/clustered.py::_traverse:
//
//   * a ray with tmax <= tmin (a dead path) returns (bt0, bp0) untouched;
//   * a slab test against every cluster AABB, op for op as
//     clustered.cluster_entries: inv = 1/d with a signed clamp at 1e-12,
//     t0 = (cmin - o) * inv, t1 = (cmax - o) * inv, tn = max_a min(t0, t1),
//     tf = min_a max(t0, t1); cluster c is admitted iff tn <= tf && tf > tmin
//     && tn < tmax, with entry te = max(tn, tmin);
//   * clusters are visited in order of the key (te, c): the next one is the
//     smallest key strictly greater than the last visited with te < best_t,
//     and the walk ends when there is none;
//   * a visit tests slots j = 0..leaf-1 of cluster c (slot c*leaf + j of the
//     cluster-major tables), skipping mask == 0, by Pluecker edge signs and
//     the plane equation as csrc/intersect.cu does; the first strict minimum
//     with tmin < t < best_t replaces the best, prim = c*leaf + j;
//   * with any_hit a ray stops after the visit that found its first hit.
//
// The Pallas kernel tests triangles by Moeller-Trumbore and walks the union
// of a 64-ray tile's clusters in one shared order.  This kernel computes the
// plane test of the plain version instead, per ray, so it agrees with the
// plain version bit for bit, tie order included.
//
// Design: one thread per ray, 128 per block, the ray in registers.  The
// block stages all C cluster AABBs into dynamic shared memory once (24 B a
// cluster; 28 KB for the 1,160 clusters of the 102k-triangle mesh).  A scan
// over the C boxes fills a sorted buffer of the kBuf smallest keys after the
// last visited one; the ray visits them in order and rescans only when the
// buffer runs dry and the scan had found more than kBuf.  A visit reads the
// cluster's leaf slots from global memory, one contiguous block.  Lanes of a
// warp walk different clusters: that divergence is accepted here.
//
// What bounds it: the rescan costs ~25 float ops per cluster, ~29k per ray
// for C = 1,160, from shared memory; a visit costs ~50 ops and 92 B of
// uncoalesced global reads (L2-resident: the tables are ~21 MB) per slot.
//
// Built with -fmad=false and without fast math, each dot summed in a fixed
// order, so t rounds exactly as the plain float32 version's does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // rays per block
constexpr int kBuf = 8;         // sorted (te, c) candidates per scan
constexpr float kBig = 3.0e38f;
constexpr int kNoCluster = 0x7fffffff;

__device__ __forceinline__ bool key_less(float ta, int ca, float tb, int cb) {
  return ta < tb || (ta == tb && ca < cb);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v >= 0.f ? tiny : -tiny) : v);
}

__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin_in,
                const float* __restrict__ tmax_in,
                const float* __restrict__ bt0, const int* __restrict__ bp0,
                const float* __restrict__ cmin,   // (C, 3)
                const float* __restrict__ cmax,   // (C, 3)
                int n_clusters,
                const float* __restrict__ plu,    // (3, n_tri, 6)
                const float* __restrict__ trin,   // (n_tri, 3)
                const float* __restrict__ v0n,    // (n_tri,)
                const float* __restrict__ mask,   // (n_tri,)
                int leaf, int n_tri, int n_rays, int any_hit,
                float* __restrict__ t_out, int* __restrict__ prim_out) {
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
  float best_t = bt0[i];
  int best_p = bp0[i];

  if (tmax > tmin) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    // ray moment m = o x d; feature [d, m] against each edge's [M, E]
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;

    const float inf = __int_as_float(0x7f800000);   // empty buffer slot
    float tl = -kBig;   // key of the last visited cluster
    int cl = -1;
    for (;;) {
      // scan: the kBuf smallest keys (te, c) > (tl, cl) with te < best_t
      float bte[kBuf];
      int bc[kBuf];
#pragma unroll
      for (int k = 0; k < kBuf; ++k) {
        bte[k] = inf;
        bc[k] = kNoCluster;
      }
      int found = 0;
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
        if (!(te < best_t) || !key_less(tl, cl, te, c)) continue;
        ++found;
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

      // visit the buffer front to back
      bool done = false;
      for (int nb = min(found, kBuf); nb > 0; --nb) {
        const float te = bte[0];
        const int c = bc[0];
#pragma unroll
        for (int k = 0; k < kBuf - 1; ++k) {
          bte[k] = bte[k + 1];
          bc[k] = bc[k + 1];
        }
        bte[kBuf - 1] = inf;
        bc[kBuf - 1] = kNoCluster;
        if (!(te < best_t)) {   // every later key is entered later still
          done = true;
          break;
        }
        tl = te;
        cl = c;

        float cur = best_t;
        int jb = -1;
        const int base = c * leaf;
        for (int j = 0; j < leaf; ++j) {
          const int s = base + j;
          if (!(__ldg(mask + s) > 0.f)) continue;
          float w[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float* q = plu + (static_cast<size_t>(e) * n_tri + s) * 6;
            float acc = __ldg(q) * dx;
            acc = acc + __ldg(q + 1) * dy;
            acc = acc + __ldg(q + 2) * dz;
            acc = acc + __ldg(q + 3) * mx;
            acc = acc + __ldg(q + 4) * my;
            acc = acc + __ldg(q + 5) * mz;
            w[e] = acc;
          }
          const bool pos = w[0] >= 0.f && w[1] >= 0.f && w[2] >= 0.f;
          const bool neg = w[0] <= 0.f && w[1] <= 0.f && w[2] <= 0.f;
          const float nx = __ldg(trin + 3 * s);
          const float ny = __ldg(trin + 3 * s + 1);
          const float nz = __ldg(trin + 3 * s + 2);
          const float d_dot_n = dx * nx + dy * ny + dz * nz;
          const float o_dot_n = ox * nx + oy * ny + oz * nz;
          const bool ok = fabsf(d_dot_n) > 1e-12f;
          const float t = (__ldg(v0n + s) - o_dot_n) / (ok ? d_dot_n : 1.f);
          if (ok && (pos || neg) && t > tmin && t < cur) {
            cur = t;
            jb = j;
          }
        }
        if (jb >= 0) {
          best_t = cur;
          best_p = base + jb;
          if (any_hit) {
            done = true;
            break;
          }
        }
      }
      if (done || found <= kBuf) break;
    }
  }
  t_out[i] = best_t;
  prim_out[i] = best_p;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may ask for on Hopper (227 KB).
int tpt_traverse_max_clusters() {
  return static_cast<int>(232448 / (6 * sizeof(float)));
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
int tpt_traverse(const float* o, const float* d, const float* tmin,
                 const float* tmax, const float* bt0, const int* bp0,
                 const float* cmin, const float* cmax, int n_clusters,
                 const float* plu, const float* trin, const float* v0n,
                 const float* mask, int leaf, int n_tri, int n_rays,
                 int any_hit, float* t_out, int* prim_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int smem = static_cast<int>(6 * sizeof(float)) * n_clusters;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_rays + kThreads - 1) / kThreads;
  traverse_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, bt0, bp0, cmin, cmax, n_clusters, plu, trin, v0n,
      mask, leaf, n_tri, n_rays, any_hit, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_traverse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
