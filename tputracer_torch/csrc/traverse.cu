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
// Past tpt_traverse_max_clusters() clusters the boxes no longer fit in
// shared memory, and tpt_traverse_tree walks a top level of node boxes
// first (the tree walk, below); the wrapper (accel/traverse_cuda.py)
// routes by the cluster count alone.
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
  float dx, dy, dz, mx, my, mz;   // the direction and the moment o x d
};

// Ray i with its slab inverses and its moment for the Pluecker test.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i,
                                        float tmin, float tmax) {
  Ray r;
  r.tmin = tmin;
  r.tmax = tmax;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  // ray moment m = o x d; feature [d, m] against each edge's [M, E]
  r.mx = r.oy * r.dz - r.oz * r.dy;
  r.my = r.oz * r.dx - r.ox * r.dz;
  r.mz = r.ox * r.dy - r.oy * r.dx;
  return r;
}

// Slab entry of box [lo, hi] as clustered.cluster_entries computes it:
// max(tn, tmin), or +inf where the box is not admitted.
__device__ __forceinline__ float entry(float x0, float y0, float z0,
                                       float x1, float y1, float z1,
                                       const Ray& r) {
  float t0 = (x0 - r.ox) * r.ix, t1 = (x1 - r.ox) * r.ix;
  float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
  t0 = (y0 - r.oy) * r.iy;
  t1 = (y1 - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (z0 - r.oz) * r.iz;
  t1 = (z1 - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  if (!(tn <= tf && tf > r.tmin && tn < r.tmax))
    return __int_as_float(0x7f800000);
  return fmaxf(tn, r.tmin);
}

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
    const float te = entry(s_box[c], s_box[C + c], s_box[2 * C + c],
                           s_box[3 * C + c], s_box[4 * C + c],
                           s_box[5 * C + c], r);
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

// Pop the head of a sorted buffer.
__device__ __forceinline__ void pop(float (&bte)[kBuf], int (&bc)[kBuf]) {
#pragma unroll
  for (int k = 0; k < kBuf - 1; ++k) {
    bte[k] = bte[k + 1];
    bc[k] = bc[k + 1];
  }
  bte[kBuf - 1] = __int_as_float(0x7f800000);
  bc[kBuf - 1] = kNone;
}

// Visit the cluster whose slots start at `base`: lane j tests slots j,
// j + G, ... and keeps its first strict minimum with tmin < t < best_t; a
// group reduction picks the smallest t, and on a tie the smallest slot,
// which is the plain walk's first strict minimum.  Returns that slot's j
// with its t in `cur`, or kNone (cur = best_t) where no slot is nearer.
// The tables are read in the scene's own layout, plu (3, 6, T): each of a
// warp's loads of one Pluecker coordinate is one contiguous line.  The
// mask is a predicate, not a branch.
template <int G>
__device__ __forceinline__ int visit(unsigned gmask, int lane, int base,
                                     int leaf, size_t T,
                                     const float* __restrict__ plu,
                                     const float* __restrict__ trin,
                                     const float* __restrict__ v0n,
                                     const float* __restrict__ mask,
                                     const Ray& r, float best_t, float& cur) {
  cur = best_t;
  int jb = kNone;
  for (int j = lane; j < leaf; j += G) {
    const size_t s = static_cast<size_t>(base + j);
    float w[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float* q = plu + 6 * e * T + s;
      float acc = __ldg(q) * r.dx;
      acc = acc + __ldg(q + T) * r.dy;
      acc = acc + __ldg(q + 2 * T) * r.dz;
      acc = acc + __ldg(q + 3 * T) * r.mx;
      acc = acc + __ldg(q + 4 * T) * r.my;
      acc = acc + __ldg(q + 5 * T) * r.mz;
      w[e] = acc;
    }
    const bool pos = w[0] >= 0.f && w[1] >= 0.f && w[2] >= 0.f;
    const bool neg = w[0] <= 0.f && w[1] <= 0.f && w[2] <= 0.f;
    const float nx = __ldg(trin + 3 * s);
    const float ny = __ldg(trin + 3 * s + 1);
    const float nz = __ldg(trin + 3 * s + 2);
    const float d_dot_n = r.dx * nx + r.dy * ny + r.dz * nz;
    const float o_dot_n = r.ox * nx + r.oy * ny + r.oz * nz;
    const bool ok = fabsf(d_dot_n) > 1e-12f;
    const float t = (__ldg(v0n + s) - o_dot_n) / (ok ? d_dot_n : 1.f);
    const bool hit = __ldg(mask + s) > 0.f && ok && (pos || neg) &&
                     t > r.tmin && t < cur;
    cur = hit ? t : cur;
    jb = hit ? j : jb;
  }
  group_min<G>(gmask, cur, jb);   // first strict minimum of the block
  return jb;
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
    const float tmin = tmin_in[i], tmax = tmax_in[i];
    float best_t = bt0[i];
    int best_p = bp0[i];
    if (tmax > tmin) {
      const Ray r = load_ray(o, d, i, tmin, tmax);
      float bte[kBuf];
      int bc[kBuf];
      bool more = scan<G>(s_box, C, lane, r, best_t, -kBig, -1, bte, bc);
      for (;;) {
        float te = bte[0];
        int c = bc[0];
        group_min<G>(gmask, te, c);
        if (!(te < best_t)) break;   // every later key is entered later still

        float cur;
        const int jb = visit<G>(gmask, lane, c * leaf, leaf, T, plu, trin,
                                v0n, mask, r, best_t, cur);
        if (jb != kNone) {
          best_t = cur;
          best_p = c * leaf + jb;
          if (any_hit) break;
        }
        if ((c & (G - 1)) == lane) {   // the owner pops the visited key
          pop(bte, bc);
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

// ---------------------------------------------------------------------------
// The tree walk, for scenes whose cluster boxes outgrow shared memory.
//
// The scene's top level (accel/toptree.py) covers the clusters in runs of
// kFan: node g's box is the exact min and max of clusters g * kFan ..
// g * kFan + kFan - 1.  The block stages the node boxes in place of the
// cluster boxes.  A node's entry is at most each child's (every rounding
// of the slab test is monotone), so a walk that opens each node before it
// visits a cluster whose key is not below the node's entry visits the
// clusters in the flat walk's (te, c) order, with the same any-hit stop:
// the same (t, prim), ties included.
//
// A warp walks a ray.  The nodes: each lane keeps a sorted buffer of its
// kBuf smallest node keys after the last opened one and rescans its own
// nodes when it runs dry, as the flat walk keeps cluster keys.  The
// clusters of the opened nodes: lane l owns child l of every node (the
// clusters c with c % kFan == l) and keeps a sorted buffer of its kBuf
// smallest pending keys; a key pushed out of a full buffer lowers the
// lane's watermark, the least key it has dropped.  Each step takes the
// group's smallest node key (tg, g), cluster key (tc, c) and watermark W:
//   * (tc, c) not below W: a dropped key may come first.  If W's entry is
//     below best_t the lanes refill (below); else no pending cluster is
//     entered before best_t;
//   * tg < best_t and tg <= tc: open node g (a node first on a tie): lane
//     l slab-tests cluster g * kFan + l from device memory and pushes its
//     key if admitted with te < best_t;
//   * else tc < best_t: visit cluster c, which its owner pops;
//   * else the walk ends.
// A refill rebuilds every lane's buffer from the opened nodes (key at or
// below the last opened one, te < best_t: one cooperative rescan of the
// staged node boxes), keeping the keys after the last visited cluster.
// After it the smallest pending key is below every watermark, so a visit
// or the end follows.
//
// Counters, where `counts` is not null: the boxes slab-tested (nodes and
// clusters, rescans and refills included), the clusters visited and the
// live rays walked, summed over a warp's rays and added once a warp.

constexpr int kFan = kGroup;   // clusters under a top node: one a lane

// Cluster k's entry, its box read from device memory.
__device__ __forceinline__ float cluster_entry(const float* __restrict__ cmin,
                                               const float* __restrict__ cmax,
                                               int k, const Ray& r) {
  return entry(__ldg(cmin + 3 * k), __ldg(cmin + 3 * k + 1),
               __ldg(cmin + 3 * k + 2), __ldg(cmax + 3 * k),
               __ldg(cmax + 3 * k + 1), __ldg(cmax + 3 * k + 2), r);
}

// Push key (t, c) into the sorted buffer; the key carried out of its end
// (an empty slot's, or (t, c) itself) lowers the watermark (wt, wc).
__device__ __forceinline__ void push(float (&bte)[kBuf], int (&bc)[kBuf],
                                     float& wt, int& wc, float t, int c) {
#pragma unroll
  for (int k = 0; k < kBuf; ++k) {
    if (key_less(t, c, bte[k], bc[k])) {
      const float st = bte[k];
      const int sc = bc[k];
      bte[k] = t;
      bc[k] = c;
      t = st;
      c = sc;
    }
  }
  if (key_less(t, c, wt, wc)) {
    wt = t;
    wc = c;
  }
}

// How many of n boxes c = lane, lane + G, ... lane l scans.
template <int G>
__device__ __forceinline__ int share(int n, int lane) {
  return lane < n ? (n - lane + G - 1) / G : 0;
}

namespace tree {

template <int G>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin_in,
                const float* __restrict__ tmax_in,
                const float* __restrict__ bt0, const int* __restrict__ bp0,
                const float* __restrict__ cmin,   // (C, 3)
                const float* __restrict__ cmax,   // (C, 3)
                int n_clusters,
                const float* __restrict__ gmin,   // (NG, 3): the top nodes
                const float* __restrict__ gmax,   // (NG, 3)
                int n_nodes,
                const float* __restrict__ plu,    // (3, 6, n_tri)
                const float* __restrict__ trin,   // (n_tri, 3)
                const float* __restrict__ v0n,    // (n_tri,)
                const float* __restrict__ mask,   // (n_tri,)
                int leaf, int n_tri, int n_rays, int any_hit,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                int* __restrict__ next_ray,
                unsigned long long* __restrict__ counts) {
  static_assert(G == kFan, "a node's children go one to a lane of the group");
  // six arrays of NG floats: the node boxes' min x, y, z, then max x, y, z
  extern __shared__ float s_box[];
  const int C = n_clusters, NG = n_nodes;
  for (int k = threadIdx.x; k < 3 * NG; k += kThreads) {
    const int g = k / 3, a = k - 3 * g;
    s_box[a * NG + g] = gmin[k];
    s_box[(3 + a) * NG + g] = gmax[k];
  }
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & (G - 1);
  const unsigned gmask = group_mask<G>();
  const size_t T = static_cast<size_t>(n_tri);
  unsigned long long n_boxes = 0, n_visits = 0, n_walked = 0;

  const int n_groups = gridDim.x * (kThreads / G);
  int i = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  while (i < n_rays) {
    const int i_next = lane == 0 ? n_groups + atomicAdd(next_ray, 1) : 0;
    const float tmin = tmin_in[i], tmax = tmax_in[i];
    float best_t = bt0[i];
    int best_p = bp0[i];
    if (tmax > tmin) {
      const Ray r = load_ray(o, d, i, tmin, tmax);
      ++n_walked;
      float gte[kBuf], cte[kBuf];
      int gc[kBuf], cc[kBuf];
      bool gmore = scan<G>(s_box, NG, lane, r, best_t, -kBig, -1, gte, gc);
      n_boxes += share<G>(NG, lane);
#pragma unroll
      for (int k = 0; k < kBuf; ++k) {
        cte[k] = inf;
        cc[k] = kNone;
      }
      float wt = inf;   // the least cluster key this lane has dropped
      int wc = kNone;
      float tlg = -kBig, tlc = -kBig;   // the last opened node's key and
      int lg = -1, lc = -1;             // the last visited cluster's
      float tg = gte[0];
      int g = gc[0];
      group_min<G>(gmask, tg, g);
      for (;;) {
        float tc = cte[0], tw = wt;
        int c = cc[0], cw = wc;
        group_min<G>(gmask, tc, c);
        group_min<G>(gmask, tw, cw);
        if (!key_less(tc, c, tw, cw)) {   // a dropped key may come first
          if (tw < best_t) {   // refill every lane from the opened nodes
#pragma unroll
            for (int k = 0; k < kBuf; ++k) {
              cte[k] = inf;
              cc[k] = kNone;
            }
            wt = inf;
            wc = kNone;
            for (int j0 = 0; j0 < NG; j0 += G) {
              const int j = j0 + lane;
              bool opened = false;
              if (j < NG) {
                ++n_boxes;
                const float te =
                    entry(s_box[j], s_box[NG + j], s_box[2 * NG + j],
                          s_box[3 * NG + j], s_box[4 * NG + j],
                          s_box[5 * NG + j], r);
                opened = te < best_t && !key_less(tlg, lg, te, j);
              }
              for (unsigned m = __ballot_sync(gmask, opened); m;
                   m &= m - 1) {
                const int k = (j0 + __ffs(m) - 1) * kFan + lane;
                if (k >= C) continue;
                ++n_boxes;
                const float te = cluster_entry(cmin, cmax, k, r);
                if (te < best_t && key_less(tlc, lc, te, k))
                  push(cte, cc, wt, wc, te, k);
              }
            }
            continue;
          }
          tc = inf;   // no pending cluster is entered before best_t
          c = kNone;
        }
        if (tg < best_t && !(tc < tg)) {   // open node g
          if ((g & (G - 1)) == lane) {     // its owner pops its key
            pop(gte, gc);
            if (gc[0] == kNone && gmore) {
              gmore = scan<G>(s_box, NG, lane, r, best_t, tg, g, gte, gc);
              n_boxes += share<G>(NG, lane);
            }
          }
          tlg = tg;
          lg = g;
          const int k = g * kFan + lane;
          if (k < C) {
            ++n_boxes;
            const float te = cluster_entry(cmin, cmax, k, r);
            if (te < best_t && key_less(tlc, lc, te, k))
              push(cte, cc, wt, wc, te, k);
          }
          tg = gte[0];
          g = gc[0];
          group_min<G>(gmask, tg, g);
          continue;
        }
        if (!(tc < best_t)) break;

        ++n_visits;
        float cur;
        const int jb = visit<G>(gmask, lane, c * leaf, leaf, T, plu, trin,
                                v0n, mask, r, best_t, cur);
        if (jb != kNone) {
          best_t = cur;
          best_p = c * leaf + jb;
          if (any_hit) break;
        }
        if ((c & (G - 1)) == lane) pop(cte, cc);   // its owner pops it
        tlc = tc;
        lc = c;
      }
    }
    if (lane == 0) {
      t_out[i] = best_t;
      prim_out[i] = best_p;
    }
    i = __shfl_sync(gmask, i_next, 0, G);
  }
  if (counts != nullptr) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      n_boxes += __shfl_xor_sync(gmask, n_boxes, off, G);
    if (lane == 0) {
      atomicAdd(counts, n_boxes);
      atomicAdd(counts + 1, n_visits);
      atomicAdd(counts + 2, n_walked);
    }
  }
}

}  // namespace tree

// The persistent grid of `kernel` for one dynamic shared-memory size on
// the current device: as many blocks as the card holds at once.  Found
// once per (kernel, device, size) and kept, so a call makes no occupancy
// query.
template <typename Kernel>
int max_blocks(Kernel kernel, int smem, int* blocks) {
  static std::mutex lock;
  static int known_dev = -1, known_smem = -1, known_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(lock);
  if (dev != known_dev || smem != known_smem) {
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

// The grid of a call: the persistent grid, or fewer blocks for a call
// with fewer rays than the card holds groups.
int grid_of(int n_rays, int blocks) {
  long long grid = (static_cast<long long>(n_rays) * kGroup + kThreads - 1) /
                   kThreads;
  if (grid > blocks) grid = blocks;
  if (grid < 1) grid = 1;
  return static_cast<int>(grid);
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may ask for on Hopper (227 KB), in
// boxes: the flat walk's clusters, the tree walk's top nodes.
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
  int err = max_blocks(traverse_kernel<kGroup>, smem, &blocks);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  traverse_kernel<kGroup><<<grid_of(n_rays, blocks), kThreads, smem, s>>>(
      o, d, tmin, tmax, bt0, bp0, cmin, cmax, n_clusters, plu, trin, v0n,
      mask, leaf, n_tri, n_rays, any_hit, t_out, prim_out, next_ray);
  return static_cast<int>(cudaGetLastError());
}

// The tree walk: as tpt_traverse, over the top level's n_nodes boxes
// (gmin, gmax), which must cover the n_clusters in runs of kFan.
// `counts`, three uint64 in device memory or null, gains the launch's
// boxes slab-tested, clusters visited and live rays walked.
int tpt_traverse_tree(const float* o, const float* d, const float* tmin,
                      const float* tmax, const float* bt0, const int* bp0,
                      const float* cmin, const float* cmax, int n_clusters,
                      const float* gmin, const float* gmax, int n_nodes,
                      const float* plu, const float* trin, const float* v0n,
                      const float* mask, int leaf, int n_tri, int n_rays,
                      int any_hit, float* t_out, int* prim_out,
                      int* next_ray, unsigned long long* counts,
                      void* stream) {
  if (n_nodes != (n_clusters + kFan - 1) / kFan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(6 * sizeof(float)) * n_nodes;
  int blocks = 0;
  int err = max_blocks(tree::traverse_kernel<kGroup>, smem, &blocks);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  tree::traverse_kernel<kGroup>
      <<<grid_of(n_rays, blocks), kThreads, smem, s>>>(
          o, d, tmin, tmax, bt0, bp0, cmin, cmax, n_clusters, gmin, gmax,
          n_nodes, plu, trin, v0n, mask, leaf, n_tri, n_rays, any_hit,
          t_out, prim_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_traverse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
