// Cluster-BVH traversal for Hopper (sm_90a): a group of G lanes walks one ray.
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
//   * a visit tests slots j = 0..leaf-1 of cluster c (slot s = c*leaf + j of
//     the cluster-major tables), skipping mask == 0, by Pluecker edge signs
//     and the plane equation as csrc/intersect.cu does; the first strict
//     minimum with tmin < t < best_t replaces the best, prim = c*leaf + j;
//   * with any_hit a ray stops after the visit that found its first hit.
//
// The Pallas kernel tests triangles by Moeller-Trumbore and walks the union
// of a 64-ray tile's clusters in one order, because the TPU has no vector
// gather.  This kernel computes the plane test of the plain version per ray,
// so it agrees with the plain version bit for bit, tie order included.
//
// What bounds it on this card.  A config-3 ray (C = 1,160 clusters of 128
// slots) slab-tests all C boxes, ~26 float ops each, and then visits ~2
// clusters: the scan is most of the work, ~1.5 G ops per 2^16 rays, so the
// bound is the card's float32 rate (~0.06 ms).  One thread per ray (the
// design before this one) left the card under-filled at 2^16 rays (2,048
// warps, under one wave), made each lane scan all C boxes alone, and read
// the visited slots scattered across a warp.
//
// The group design:
//   * G lanes share a ray: G is a template argument, built for kGroup = 32
//     (a warp), the fastest of 8, 16 and 32 on the H100 (PERF.md).  Blocks
//     are persistent (as many as the card holds at once; the count is found
//     once per shared-memory size and kept).  A group's first ray
//     is fixed, so a call with fewer rays than groups (the pair route's
//     fallback, deep walks) gives each ray a group of its own; later rays
//     come from a counter in device memory, so a deep ray holds up only its
//     own group and the rays of a call spread over every SM.
//   * The block stages the C boxes in shared memory once, as six arrays of
//     C floats, so lane l reading box l + G*k hits distinct banks.
//   * Lane l slab-tests boxes c = l, l + G, ... and keeps a sorted register
//     buffer of its kBuf smallest admitted keys after the last visited key
//     with te < best_t.  The next cluster is the group-wide minimum of the
//     lanes' buffer heads (a butterfly of __shfl_xor_sync under key_less,
//     float compares, so te = -0 and +0 tie as in the plain walk).  Its
//     owner, lane c % G, pops it; a lane whose buffer runs dry after its
//     scan found more than kBuf rescans only its own boxes.  A ray costs
//     about one scan of the C boxes in all.
//   * A visit splits the leaf slots: lane j tests slots j, j + G, ... and
//     keeps its first strict minimum; a group reduction picks the smallest
//     t, and on a tie the smallest slot, which is the plain walk's first
//     strict minimum.  The tables are read in the scene's own layout, plu
//     (3, 6, T): each of a warp's loads of one Pluecker coordinate is one
//     contiguous line.  The mask is a predicate, not a branch.
//
// ptxas (CUDA 12.8, -O3 -fmad=false): 48 registers, no spills, no stack
// (the same for G = 8 and 16); 5 blocks of 256 threads (40 warps) per SM
// with the 1,160 boxes of config 3 staged.  What holds it back now: the
// counter's one same-address atomic per ray, which dead rays pay too, and
// the shuffle reductions on the critical path of a visit.

// Built with -fmad=false and without fast math, each dot summed in a fixed
// order, so t rounds exactly as the plain float32 version's does.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kGroup = 32;      // lanes per ray: a warp
constexpr int kThreads = 256;   // lanes per block: 256 / kGroup rays in flight
constexpr int kBuf = 4;         // sorted (te, c) candidates per lane
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;   // no cluster / no slot

__device__ __forceinline__ bool key_less(float ta, int ca, float tb, int cb) {
  return ta < tb || (ta == tb && ca < cb);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v >= 0.f ? tiny : -tiny) : v);
}

// The lanes of this thread's group, as a shuffle mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// The group-wide smallest key (t, c); every lane gets the same one.
template <int G>
__device__ __forceinline__ void group_min(unsigned mask, float& t, int& c) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, t, off, G);
    const int oc = __shfl_xor_sync(mask, c, off, G);
    if (key_less(ot, oc, t, c)) {
      t = ot;
      c = oc;
    }
  }
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
};

// Scan boxes c = lane, lane + G, ... into the sorted buffer: the kBuf
// smallest admitted keys (te, c) > (tl, cl) with te < best_t.  Returns
// whether the scan found more than kBuf.
template <int G>
__device__ __forceinline__ bool scan(const float* __restrict__ s_box, int C,
                                     int lane, const Ray& r, float best_t,
                                     float tl, int cl, float (&bte)[kBuf],
                                     int (&bc)[kBuf]) {
  const float inf = __int_as_float(0x7f800000);   // empty buffer slot
#pragma unroll
  for (int k = 0; k < kBuf; ++k) {
    bte[k] = inf;
    bc[k] = kNone;
  }
  int found = 0;
  for (int c = lane; c < C; c += G) {
    float t0 = (s_box[c] - r.ox) * r.ix, t1 = (s_box[3 * C + c] - r.ox) * r.ix;
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    t0 = (s_box[C + c] - r.oy) * r.iy;
    t1 = (s_box[4 * C + c] - r.oy) * r.iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (s_box[2 * C + c] - r.oz) * r.iz;
    t1 = (s_box[5 * C + c] - r.oz) * r.iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    if (!(tn <= tf && tf > r.tmin && tn < r.tmax)) continue;
    const float te = fmaxf(tn, r.tmin);
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
  return found > kBuf;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin_in,
                const float* __restrict__ tmax_in,
                const float* __restrict__ bt0, const int* __restrict__ bp0,
                const float* __restrict__ cmin,   // (C, 3)
                const float* __restrict__ cmax,   // (C, 3)
                int n_clusters,
                const float* __restrict__ plu,    // (3, 6, n_tri)
                const float* __restrict__ trin,   // (n_tri, 3)
                const float* __restrict__ v0n,    // (n_tri,)
                const float* __restrict__ mask,   // (n_tri,)
                int leaf, int n_tri, int n_rays, int any_hit,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                int* __restrict__ next_ray) {
  // six arrays of C floats: min x, y, z, then max x, y, z
  extern __shared__ float s_box[];
  const int C = n_clusters;
  for (int k = threadIdx.x; k < 3 * C; k += kThreads) {
    const int c = k / 3, a = k - 3 * c;
    s_box[a * C + c] = cmin[k];
    s_box[(3 + a) * C + c] = cmax[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & (G - 1);
  const unsigned gmask = group_mask<G>();
  const size_t T = static_cast<size_t>(n_tri);

  // each group's first ray is fixed, so a call with fewer rays than groups
  // gives every ray a group of its own; the rest come from the counter
  const int n_groups = gridDim.x * (kThreads / G);
  int i = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  while (i < n_rays) {
    // claim the next ray now: the atomic's latency hides behind this one
    const int i_next = lane == 0 ? n_groups + atomicAdd(next_ray, 1) : 0;
    Ray r;
    r.tmin = tmin_in[i];
    r.tmax = tmax_in[i];
    float best_t = bt0[i];
    int best_p = bp0[i];
    if (r.tmax > r.tmin) {
      r.ox = o[3 * i];
      r.oy = o[3 * i + 1];
      r.oz = o[3 * i + 2];
      const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
      r.ix = safe_inv(dx);
      r.iy = safe_inv(dy);
      r.iz = safe_inv(dz);
      // ray moment m = o x d; feature [d, m] against each edge's [M, E]
      const float mx = r.oy * dz - r.oz * dy;
      const float my = r.oz * dx - r.ox * dz;
      const float mz = r.ox * dy - r.oy * dx;

      float bte[kBuf];
      int bc[kBuf];
      bool more = scan<G>(s_box, C, lane, r, best_t, -kBig, -1, bte, bc);
      for (;;) {
        float te = bte[0];
        int c = bc[0];
        group_min<G>(gmask, te, c);
        if (!(te < best_t)) break;   // every later key is entered later still

        // visit cluster c: lane j tests slots j, j + G, ...
        float cur = best_t;
        int jb = kNone;
        const int base = c * leaf;
        for (int j = lane; j < leaf; j += G) {
          const size_t s = static_cast<size_t>(base + j);
          float w[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float* q = plu + 6 * e * T + s;
            float acc = __ldg(q) * dx;
            acc = acc + __ldg(q + T) * dy;
            acc = acc + __ldg(q + 2 * T) * dz;
            acc = acc + __ldg(q + 3 * T) * mx;
            acc = acc + __ldg(q + 4 * T) * my;
            acc = acc + __ldg(q + 5 * T) * mz;
            w[e] = acc;
          }
          const bool pos = w[0] >= 0.f && w[1] >= 0.f && w[2] >= 0.f;
          const bool neg = w[0] <= 0.f && w[1] <= 0.f && w[2] <= 0.f;
          const float nx = __ldg(trin + 3 * s);
          const float ny = __ldg(trin + 3 * s + 1);
          const float nz = __ldg(trin + 3 * s + 2);
          const float d_dot_n = dx * nx + dy * ny + dz * nz;
          const float o_dot_n = r.ox * nx + r.oy * ny + r.oz * nz;
          const bool ok = fabsf(d_dot_n) > 1e-12f;
          const float t = (__ldg(v0n + s) - o_dot_n) / (ok ? d_dot_n : 1.f);
          const bool hit = __ldg(mask + s) > 0.f && ok && (pos || neg) &&
                           t > r.tmin && t < cur;
          cur = hit ? t : cur;
          jb = hit ? j : jb;
        }
        group_min<G>(gmask, cur, jb);   // first strict minimum of the block
        if (jb != kNone) {
          best_t = cur;
          best_p = base + jb;
          if (any_hit) break;
        }
        if ((c & (G - 1)) == lane) {   // the owner pops the visited key
#pragma unroll
          for (int k = 0; k < kBuf - 1; ++k) {
            bte[k] = bte[k + 1];
            bc[k] = bc[k + 1];
          }
          bte[kBuf - 1] = __int_as_float(0x7f800000);
          bc[kBuf - 1] = kNone;
          if (bc[0] == kNone && more)
            more = scan<G>(s_box, C, lane, r, best_t, te, c, bte, bc);
        }
      }
    }
    if (lane == 0) {
      t_out[i] = best_t;
      prim_out[i] = best_p;
    }
    i = __shfl_sync(gmask, i_next, 0, G);
  }
}

// The persistent grid for one dynamic shared-memory size on the current
// device: as many blocks as the card holds at once.  Found once per
// (device, size) and kept, so a call makes no occupancy query.
int max_blocks(int smem, int* blocks) {
  static std::mutex lock;
  static int known_dev = -1, known_smem = -1, known_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(lock);
  if (dev != known_dev || smem != known_smem) {
    auto kernel = traverse_kernel<kGroup>;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess)
      return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return static_cast<int>(err);
    known_dev = dev;
    known_smem = smem;
    known_blocks = sms * per_sm;
  }
  *blocks = known_blocks;
  return 0;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may ask for on Hopper (227 KB).
int tpt_traverse_max_clusters() {
  return static_cast<int>(232448 / (6 * sizeof(float)));
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
// `next_ray` is one int of scratch in device memory, zeroed here on
// `stream` before the launch.
int tpt_traverse(const float* o, const float* d, const float* tmin,
                 const float* tmax, const float* bt0, const int* bp0,
                 const float* cmin, const float* cmax, int n_clusters,
                 const float* plu, const float* trin, const float* v0n,
                 const float* mask, int leaf, int n_tri, int n_rays,
                 int any_hit, float* t_out, int* prim_out, int* next_ray,
                 void* stream) {
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(6 * sizeof(float)) * n_clusters;
  int blocks = 0;
  int err = max_blocks(smem, &blocks);
  if (err != 0) return err;
  // fewer blocks for a call with fewer rays than the card holds groups
  long long grid = (static_cast<long long>(n_rays) * kGroup + kThreads - 1) /
                   kThreads;
  if (grid > blocks) grid = blocks;
  if (grid < 1) grid = 1;
  cudaError_t e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  traverse_kernel<kGroup><<<static_cast<int>(grid), kThreads, smem, s>>>(
      o, d, tmin, tmax, bt0, bp0, cmin, cmax, n_clusters, plu, trin, v0n,
      mask, leaf, n_tri, n_rays, any_hit, t_out, prim_out, next_ray);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_traverse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
