// Pair-expansion traversal for Hopper (sm_90a): the expand and pair-test
// kernels of tputracer_torch/accel/pairs.py.
//
// expand_kernel replaces tputracer/accel/pairs_tpu.py::_expand_kernel
// (pairs_tpu.py:66).  Contract (the plain version, pairs.py::expand_plain):
// for each ray, the slab test against every cluster AABB, op for op as
// traverse.cu's (and clustered.cluster_entries): inv = 1/d with a signed
// clamp at 1e-12, t0 = (cmin - o) * inv, t1 = (cmax - o) * inv,
// tn = max_a min(t0, t1), tf = min_a max(t0, t1); cluster c is admitted iff
// tn <= tf && tf > tmin && tn < tmax && tmin < tmax, at te = max(tn, tmin).
// The last term keeps a dead lane (tmax = 0) whose origin sits inside a box
// from getting slots.  Out: the K smallest admitted keys (te, c) in
// ascending order (the smaller c first at equal te), as cid (N,K) and te
// (N,K), with -1 and 3e38 in empty slots; bound (N,), the te of the
// (K+1)-th admitted key, or 3e38.
//
// pairtest_kernel replaces tputracer/accel/pairs_tpu.py::_pairtest_kernel
// (pairs_tpu.py:139) together with the glue around it (the gathers into
// pair order, the scatters back and the front-to-back fold of the K slots).
// Contract (pairs.py::pairtest_plain): the rays' o, d, tmin, bt0, bp0 in
// their own order; sidx, the permutation that sorts the N*K slots
// s = ray*K + k by cluster; cid and te (N,K) in slot order.  Slot s is
// wanted iff cid >= 0 and te < bt0[ray]; a wanted slot runs a
// Moeller-Trumbore test of its cluster's leaf slots, op for op as
// tputracer/accel/traverse_tpu.py::mt_cluster_block, accepting
// tmin < t < bt0 with mask > 0, first strict minimum over the leaf slots.
// Out: each ray's (best_t, best_p), the K slot results folded front to back
// from (bt0, bp0), the first strict improvement winning.
//
// What bounds them on this card.  Expand: every live ray slab-tests all C
// boxes (26 float ops a box; config 3: C = 1,160), ~1.5 G ops per 2^16
// rays, so the float32 rate.  Pair test: the Moeller-Trumbore stages that
// each (wanted slot, valid leaf slot) reaches (16 ops for the determinant,
// 12 more past |det| > 1e-12, 27 more past the u test), again the float32
// rate; the bytes (the slots, the rays and the touched triangles) are a
// small share.  The design before this one ran one thread per ray or per
// pair: 15 warps an SM at 2^16 rays, dead lanes holding their warps, the
// boxes restaged per 128 rays with a divide per float, ten scalar loads per
// triangle slot, every stage run to the end, and ~67 eager launches of glue
// per call around the two kernels.  Where each stands against its bound,
// and what still holds it back, is in PERF.md.
//
// The expand design:
//   * A group of G lanes per ray (G a template argument, built for
//     kGroup = 8; 16 and 32 were measured slower and are not built).  Lane l
//     scans the quads of boxes
//     l, l + G, ... (boxes 4q .. 4q+3, six LDS.128 a quad, four slabs in
//     flight) and keeps its own sorted register buffer of its kBuf >= K+1
//     smallest keys.  The ray's K+1 smallest keys are among the union of
//     the lanes' K+1 smallest, so K+1 rounds of a shuffle minimum over the
//     lane heads (traverse.cu's butterfly under key_less) give the slots
//     and bound exactly, with no rescan.
//   * Persistent blocks (as many as the card holds at once); the boxes are
//     staged once per block as six arrays of C floats (padded to quads), so
//     a group's lanes read neighbouring quads.
//   * Live rays only: each warp reads chunks of 32 rays in a Weyl order
//     (chunk k*step mod n, as intersect.cu), writes the empty answer of the
//     dead ones at once and queues the live ones (ballot and prefix count);
//     its groups then take the queue a ray each.
//
// The pair-test design (persistent blocks, then a small fold kernel):
//   * Runs are found inside the kernel from the sorted order: warp w takes
//     the chunks of 32 sorted pairs w, w + stride, ..., reads each pair's
//     slot through sidx (no gather in the glue), and queues the wanted
//     ones; a warp that meets an empty slot stops (empty slots sort last,
//     so the non-empty chunks, at the front, fall one or two to a warp).
//   * Each round takes the run at the queue's front (the queued pairs of
//     one cluster, at most 32), stages the cluster's valid leaf slots in
//     shared memory unless the warp already holds them, in slot order, as
//     three float4 rows (v0 with the slot in w, e1, e2), and tests the run
//     with W lanes a pair, W the largest power of two with run * W <= 32:
//     a run of 32 tests a pair a lane with LDS.128 broadcasts, a single
//     pair spreads its rows over the warp, and a shuffle minimum under
//     (t, slot) joins each pair's lanes, so the first minimum still wins.
//     (Testing every distinct cluster of 32 queued pairs in turn, a pair a
//     lane, left one lane busy per cluster where runs were short, and the
//     warps holding short runs set the time.)  Rows go four at a time
//     through the determinant and u stages, which are independent; a row
//     leaves at |det| <= 1e-12 or outside 0 <= u <= 1, which only rejects.
//   * The fold is a 64-bit atomicMin per ray on (ordered bits of t) << 32 |
//     k << 27 | prim: the smallest t, and on a tie the smallest slot k,
//     which is the front-to-back strict fold.  A minimum does not depend on
//     the order, so the bits are the same from run to run.
//   * fold_kernel, launched behind it on the same stream, decodes each
//     ray's key (no improvement keeps (bt0, bp0)) and resets the keys,
//     which the wrapper keeps per device and stream, so a call launches no
//     memset.  A second kernel and not a grid barrier: a barrier needs
//     every block resident at once, which only a cooperative launch
//     promises.
//
// Built with -fmad=false and without fast math, each sum in the plain
// version's order and 1/det IEEE, so both kernels agree with their plain
// versions bit for bit.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <numeric>
#include <tuple>

namespace {

constexpr int kGroup = 8;       // expand's lanes per ray
constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 16;   // the largest K
constexpr int kPrimBits = 27;   // prim < 2^27 in a fold key
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned long long kEmpty = ~0ull;   // a ray with no slot hit

__device__ __forceinline__ bool key_less(float ta, int ca, float tb, int cb) {
  return ta < tb || (ta == tb && ca < cb);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v >= 0.f ? tiny : -tiny) : v);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The lanes of this thread's group of G, as a shuffle mask.
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

// ------------------------------------------------------------------ expand

// One box's slab (tn, tf), op for op as clustered.cluster_entries.
__device__ __forceinline__ void slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float& tn, float& tf) {
  float t0 = (lx - ox) * ix, t1 = (hx - ox) * ix;
  tn = fminf(t0, t1);
  tf = fmaxf(t0, t1);
  t0 = (ly - oy) * iy;
  t1 = (hy - oy) * iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (lz - oz) * iz;
  t1 = (hz - oz) * iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
}

__device__ __forceinline__ float part(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Ray i's slots and bound, by its group of G lanes (glane = 0 .. G-1).
// s_box: six arrays of C4 floats (C rounded up to 4), read as quads.
template <int G, int kBuf>
__device__ __forceinline__ void expand_ray(
    int i, int glane, unsigned gmask, const float4* __restrict__ s_box, int C,
    const float* __restrict__ o, const float* __restrict__ d, float tmin,
    float tmax, int k_slots, int* __restrict__ cid_out,
    float* __restrict__ te_out, float* __restrict__ bound_out) {
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float ix = safe_inv(d[3 * i]), iy = safe_inv(d[3 * i + 1]),
              iz = safe_inv(d[3 * i + 2]);
  const float inf = __int_as_float(0x7f800000);   // empty buffer slot
  float bte[kBuf];
  int bc[kBuf];
#pragma unroll
  for (int k = 0; k < kBuf; ++k) {
    bte[k] = inf;
    bc[k] = kNone;
  }
  const int nq = (C + 3) / 4;   // quads of boxes
  for (int qd = glane; qd < nq; qd += G) {
    const float4 lx = s_box[qd], ly = s_box[nq + qd], lz = s_box[2 * nq + qd];
    const float4 hx = s_box[3 * nq + qd], hy = s_box[4 * nq + qd],
                 hz = s_box[5 * nq + qd];
    float tn[4], tf[4];
    bool in[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      slab(part(lx, q), part(ly, q), part(lz, q), part(hx, q), part(hy, q),
           part(hz, q), ox, oy, oz, ix, iy, iz, tn[q], tf[q]);
      in[q] = 4 * qd + q < C && tn[q] <= tf[q] && tf[q] > tmin &&
              tn[q] < tmax;
    }
    if (!(in[0] || in[1] || in[2] || in[3])) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float te = fmaxf(tn[q], tmin);
      const int c = 4 * qd + q;
      if (!in[q] || !key_less(te, c, bte[kBuf - 1], bc[kBuf - 1])) continue;
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
  // K+1 rounds: the group's smallest head is the next key; its owner pops
  const size_t row = static_cast<size_t>(i) * k_slots;
  for (int r = 0; r <= k_slots; ++r) {
    float t = bte[0];
    int c = bc[0];
    group_min<G>(gmask, t, c);
    const bool full = c != kNone;   // admitted keys are < tmax <= 3e38
    if (full && ((c >> 2) & (G - 1)) == glane) {
#pragma unroll
      for (int k = 0; k < kBuf - 1; ++k) {
        bte[k] = bte[k + 1];
        bc[k] = bc[k + 1];
      }
      bte[kBuf - 1] = inf;
      bc[kBuf - 1] = kNone;
    }
    if (glane == r % G) {
      if (r < k_slots) {
        cid_out[row + r] = full ? c : -1;
        te_out[row + r] = full ? t : kBig;
      } else {
        bound_out[i] = full ? t : kBig;
      }
    }
  }
}

template <int G, int kBuf>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in,
              const float* __restrict__ cmin,   // (C, 3)
              const float* __restrict__ cmax,   // (C, 3)
              int n_clusters, int n_rays, int k_slots, int step,
              int* __restrict__ cid_out,        // (N, K)
              float* __restrict__ te_out,       // (N, K)
              float* __restrict__ bound_out) {  // (N,)
  // six arrays of C4 floats: min x, y, z, then max x, y, z; C4 = C
  // rounded up to 4, the padding never admitted (c < C)
  extern __shared__ float4 s_box4[];
  float* s_box = reinterpret_cast<float*>(s_box4);
  __shared__ int s_queue[kWarps][32];   // each warp's live rays
  const int C = n_clusters, C4 = 4 * ((C + 3) / 4);
  for (int k = threadIdx.x; k < 3 * C4; k += kThreads) {
    const int c = k / 3, a = k - 3 * c;
    s_box[a * C4 + c] = c < C ? cmin[k] : 0.f;
    s_box[(3 + a) * C4 + c] = c < C ? cmax[k] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int glane = lane & (G - 1), group = lane / G;
  constexpr int kGroups = 32 / G;
  const unsigned gmask = group_mask<G>();
  int* queue = s_queue[warp];

  // chunks k, k + stride, ... of the warp, at chunk k * step mod n_chunks
  const int n_chunks = (n_rays + 31) / 32;
  const int stride = gridDim.x * kWarps;
  int k = blockIdx.x * kWarps + warp;
  int chunk = static_cast<int>(static_cast<long long>(k) * step % n_chunks);
  const int advance =
      static_cast<int>(static_cast<long long>(stride) * step % n_chunks);
  for (; k < n_chunks; k += stride) {
    const int i = chunk * 32 + lane;
    bool live = false;
    if (i < n_rays) {
      live = tmin_in[i] < tmax_in[i];
      if (!live) {   // the empty answer at once
        const size_t row = static_cast<size_t>(i) * k_slots;
        for (int s = 0; s < k_slots; ++s) {
          cid_out[row + s] = -1;
          te_out[row + s] = kBig;
        }
        bound_out[i] = kBig;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) queue[__popc(bal & lanes_below())] = i;
    __syncwarp();
    const int n_live = __popc(bal);
    // q is the same in every lane of a group, so a group runs whole
    for (int q = group; q < n_live; q += kGroups) {
      const int r = queue[q];
      expand_ray<G, kBuf>(r, glane, gmask, s_box4, C, o, d, tmin_in[r],
                          tmax_in[r], k_slots, cid_out, te_out, bound_out);
    }
    __syncwarp();   // the queue is read before the next chunk fills it
    chunk += advance;
    if (chunk >= n_chunks) chunk -= n_chunks;
  }
}

// --------------------------------------------------------------- pair test

// (t, k, prim) as one 64-bit key whose unsigned order is (t, k, prim):
// t's bits mapped so that unsigned order is float order.
__device__ __forceinline__ unsigned long long fold_key(float t, int k,
                                                       int prim) {
  unsigned b = __float_as_uint(t);
  b ^= (b & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return (static_cast<unsigned long long>(b) << 32) |
         (static_cast<unsigned>(k) << kPrimBits) | static_cast<unsigned>(prim);
}

__device__ __forceinline__ float key_time(unsigned long long key) {
  unsigned b = static_cast<unsigned>(key >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}

// Cluster c's valid leaf slots, in slot order, into the warp's rows: three
// float4 each (v0 with the slot j in w, e1, e2).  Returns the row count.
// Called by the whole warp.  128 slots at a time, every load issued before
// the first store: two global latencies per 128 slots, not eight.
__device__ __forceinline__ int stage_cluster(
    float4* rows, int c, int leaf, const float* __restrict__ v0,
    const float* __restrict__ e1, const float* __restrict__ e2,
    const float* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(c) * leaf;
  int n = 0;
  __syncwarp();   // every lane is done with the rows staged before
  for (int j0 = 0; j0 < leaf; j0 += 128) {
    float mk[4], x[4][9];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + 32 * b + lane;
      mk[b] = j < leaf ? __ldg(mask + base + j) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const size_t s = 3 * (base + j0 + 32 * b + lane);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        x[b][a] = mk[b] > 0.f ? __ldg(v0 + s + a) : 0.f;
        x[b][3 + a] = mk[b] > 0.f ? __ldg(e1 + s + a) : 0.f;
        x[b][6 + a] = mk[b] > 0.f ? __ldg(e2 + s + a) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool valid = mk[b] > 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        float4* q = rows + 3 * (n + __popc(bal & lanes_below()));
        q[0] = make_float4(x[b][0], x[b][1], x[b][2],
                           __int_as_float(j0 + 32 * b + lane));
        q[1] = make_float4(x[b][3], x[b][4], x[b][5], 0.f);
        q[2] = make_float4(x[b][6], x[b][7], x[b][8], 0.f);
      }
      n += __popc(bal);
    }
  }
  __syncwarp();
  return n;
}

// Moeller-Trumbore of one ray against the staged rows first, first + step,
// ... below n, op for op as traverse_tpu.py::mt_cluster_block: the first
// strict minimum t in (tmin, bt) as (th, jb), jb its leaf slot; th stays
// kBig where none.  Four rows at a time: their determinant and u stages are
// independent.  A row leaves at |det| <= 1e-12 or outside 0 <= u <= 1,
// which only rejects (u > 1 fails u + v <= 1 wherever v >= 0 holds).
__device__ __forceinline__ void test_rows(const float4* rows, int first,
                                          int step, int n, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float tmin, float bt,
                                          float& th, int& jb) {
  for (int r0 = first; r0 < n; r0 += 4 * step) {
    float fq[4], uq[4];
    bool pass[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + q * step;
      const int rr = r < n ? r : first;   // in range; its result is dropped
      const float4 a = rows[3 * rr], b = rows[3 * rr + 1],
                   e = rows[3 * rr + 2];
      const float px = dy * e.z - dz * e.y;
      const float py = dz * e.x - dx * e.z;
      const float pz = dx * e.y - dy * e.x;
      const float det = b.x * px + b.y * py + b.z * pz;
      const float f = 1.0f / det;
      const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
      const float u = f * (sx * px + sy * py + sz * pz);
      fq[q] = f;
      uq[q] = u;
      pass[q] = r < n && fabsf(det) > 1e-12f && u >= 0.f && u <= 1.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // in row order: the first minimum wins
      if (!pass[q]) continue;
      const int r = r0 + q * step;
      const float4 a = rows[3 * r], b = rows[3 * r + 1], e = rows[3 * r + 2];
      const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
      const float qx = sy * b.z - sz * b.y;
      const float qy = sz * b.x - sx * b.z;
      const float qz = sx * b.y - sy * b.x;
      const float v = fq[q] * (dx * qx + dy * qy + dz * qz);
      const float t = fq[q] * (e.x * qx + e.y * qy + e.z * qz);
      if (v >= 0.f && uq[q] + v <= 1.f && t > tmin && t < bt && t < th) {
        th = t;
        jb = __float_as_int(a.w);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pairtest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin_in,
                const float* __restrict__ bt0,
                const long long* __restrict__ sidx,   // (N*K,) sorted order
                const int* __restrict__ cid,          // (N, K) slot order
                const float* __restrict__ te,         // (N, K) slot order
                const float* __restrict__ v0,         // (n_tri, 3)
                const float* __restrict__ e1,         // (n_tri, 3)
                const float* __restrict__ e2,         // (n_tri, 3)
                const float* __restrict__ mask,       // (n_tri,)
                int leaf, int k_slots, int n_rays,
                unsigned long long* __restrict__ keys) {   // (>= N,) kEmpty
  extern __shared__ float4 s_rows[];   // kWarps x leaf x 3
  __shared__ int s_slot[kWarps][64];   // each warp's queue of wanted slots
  __shared__ int s_clus[kWarps][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* rows = s_rows + static_cast<size_t>(warp) * leaf * 3;
  int* qs = s_slot[warp];
  int* qc = s_clus[warp];
  const int n_pairs = n_rays * k_slots;
  const int n_chunks = (n_pairs + 31) / 32;
  const int stride = gridDim.x * kWarps;
  int next = blockIdx.x * kWarps + warp;   // the warp's chunks, strided

  int queued = 0, staged = -1, n_rows = 0;
  bool more = true;
  for (;;) {
    // top the queue up to 32 wanted slots from the warp's next chunks
    while (more && queued < 32) {
      const int ch = next;
      next += stride;
      if (ch >= n_chunks) {
        more = false;
        break;
      }
      const int i = ch * 32 + lane;
      int s = 0, c = -1;
      bool want = false;
      if (i < n_pairs) {
        s = static_cast<int>(sidx[i]);
        c = cid[s];
        want = c >= 0 && te[s] < bt0[s / k_slots];
      }
      // empty slots sort last: every later chunk holds only empty ones
      if (__any_sync(0xffffffffu, i < n_pairs && c < 0)) more = false;
      const unsigned bal = __ballot_sync(0xffffffffu, want);
      if (want) {
        const int at = queued + __popc(bal & lanes_below());
        qs[at] = s;
        qc[at] = c;
      }
      queued += __popc(bal);
    }
    __syncwarp();
    if (queued == 0) break;
    // the run at the queue's front: its pairs share a cluster and, sorted,
    // are a prefix; at most 32 of them
    const int cc = qc[0];
    const int m = __popc(__ballot_sync(0xffffffffu,
                                       lane < queued && qc[lane] == cc));
    // W lanes a pair, W the largest power of two with m * W <= 32: a long
    // run tests a pair a lane, a single pair spreads its rows over the warp
    int w = 32;
    while (w * m > 32) w >>= 1;
    const int pair = lane / w, sub = lane & (w - 1);
    const bool active = pair < m;
    int ray = 0, k = 0;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tmin = 0.f, bt = 0.f;
    if (active) {   // in flight while the cluster is staged
      const int s = qs[pair];
      ray = s / k_slots;
      k = s - ray * k_slots;
      ox = o[3 * ray];
      oy = o[3 * ray + 1];
      oz = o[3 * ray + 2];
      dx = d[3 * ray];
      dy = d[3 * ray + 1];
      dz = d[3 * ray + 2];
      tmin = tmin_in[ray];
      bt = bt0[ray];
    }
    if (cc != staged) {
      n_rows = stage_cluster(rows, cc, leaf, v0, e1, e2, mask);
      staged = cc;
    }
    float th = kBig;   // first strict minimum, argmin's tie rule
    int jb = 0;
    if (active)
      test_rows(rows, sub, w, n_rows, ox, oy, oz, dx, dy, dz, tmin, bt, th,
                jb);
    for (int off = 1; off < w; off <<= 1) {   // the pair's lanes' minimum
      const float ot = __shfl_xor_sync(0xffffffffu, th, off);
      const int oj = __shfl_xor_sync(0xffffffffu, jb, off);
      if (key_less(ot, oj, th, jb)) {
        th = ot;
        jb = oj;
      }
    }
    if (active && sub == 0 && th < bt)
      atomicMin(keys + ray, fold_key(th, k, cc * leaf + jb));
    // drop the run from the queue
    const int rest = queued - m;
    const int a0 = lane + m < queued ? qs[lane + m] : 0;
    const int c0 = lane + m < queued ? qc[lane + m] : 0;
    const int a1 = lane + 32 + m < queued ? qs[lane + 32 + m] : 0;
    const int c1 = lane + 32 + m < queued ? qc[lane + 32 + m] : 0;
    __syncwarp();
    if (lane < rest) {
      qs[lane] = a0;
      qc[lane] = c0;
    }
    if (lane + 32 < rest) {
      qs[lane + 32] = a1;
      qc[lane + 32] = c1;
    }
    queued = rest;
  }
}

// Each ray's folded answer from its key: (bt0, bp0) unless a slot
// improved on it; then the key is reset.  The plain fold starts from bt0:
// where bt0 > 3e38 a slot that reports no hit (3e38) already improves on
// it, so the first slot decides.  If slot 0 is wanted, the test writes its
// no-hit key (3e38, 0, its cluster's first slot), which is that answer; if
// it is empty, so are the rest (empty slots come last), no key is written,
// and the answer is slot 0's (3e38, -1).
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ bt0, const int* __restrict__ bp0,
            int n_rays, unsigned long long* __restrict__ keys,
            float* __restrict__ t_out, int* __restrict__ p_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const unsigned long long key = keys[r];
  float bt = bt0[r];
  int bp = bp0[r];
  if (key != kEmpty) {
    bt = key_time(key);
    bp = static_cast<int>(key & ((1u << kPrimBits) - 1u));
  } else if (bt > kBig) {
    bt = kBig;
    bp = -1;
  }
  t_out[r] = bt;
  p_out[r] = bp;
  keys[r] = kEmpty;
}

// The persistent grid of `kernel` at `smem` bytes of dynamic shared memory
// on the current device: as many blocks as the card holds at once.  Found
// once per (kernel, device, size) and kept, so a call makes no query.  The
// kernel's dynamic shared-memory limit only grows: lowered for a small
// scene, it would refuse the next launch for a larger one.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* blocks) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, int> known;
  static std::map<std::pair<const void*, int>, int> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(lock);
  const void* fn = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(fn, dev, smem);
  auto it = known.find(key);
  if (it == known.end()) {
    int& limit = allowed[std::make_pair(fn, dev)];
    if (smem > limit) {
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
        return static_cast<int>(err);
      limit = smem;
    }
    int sms = 0, per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    it = known.emplace(key, sms * per_sm).first;
  }
  *blocks = it->second;
  return 0;
}

// A step coprime to n near n / golden ratio: k -> k * step mod n visits
// every chunk once, and neighbouring k land far apart (a Weyl sequence).
int chunk_step(int n) {
  int step = static_cast<int>(n * 0.6180339887498949);
  if (step < 1) step = 1;
  while (std::gcd(step, n) != 1) ++step;
  return step;
}

template <int G, int kBuf>
int launch_expand(const float* o, const float* d, const float* tmin,
                  const float* tmax, const float* cmin, const float* cmax,
                  int n_clusters, int n_rays, int k_slots, int* cid_out,
                  float* te_out, float* bound_out, cudaStream_t stream) {
  auto kernel = expand_kernel<G, kBuf>;
  const int smem =
      static_cast<int>(6 * sizeof(float4)) * ((n_clusters + 3) / 4);
  int blocks = 0;
  const int err = resident_blocks(kernel, smem, &blocks);
  if (err != 0) return err;
  const int n_chunks = (n_rays + 31) / 32;
  const int wanted = (n_chunks + kWarps - 1) / kWarps;   // a chunk a warp
  kernel<<<wanted < blocks ? wanted : blocks, kThreads, smem, stream>>>(
      o, d, tmin, tmax, cmin, cmax, n_clusters, n_rays, k_slots,
      chunk_step(n_chunks), cid_out, te_out, bound_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most cluster boxes one block can stage beside its queues (227 KB).
int tpt_pairs_max_clusters() {
  return static_cast<int>((232448 - 1024) / (6 * sizeof(float))) & ~3;
}

// The largest leaf the pair test's per-warp rows hold (227 KB a block).
int tpt_pairs_max_leaf() {
  return static_cast<int>((232448 - 4096) / (kWarps * 3 * sizeof(float4)));
}

int tpt_pairs_max_slots() { return kMaxSlots; }

int tpt_pairs_prim_bits() { return kPrimBits; }

// Each launcher starts its kernel on `stream` and returns cudaGetLastError():
// a refused launch never runs, and a later synchronize would not report it.
// cudaErrorInvalidValue for k_slots outside [1, kMaxSlots].
int tpt_pair_expand(const float* o, const float* d, const float* tmin,
                    const float* tmax, const float* cmin, const float* cmax,
                    int n_clusters, int n_rays, int k_slots, int* cid_out,
                    float* te_out, float* bound_out, void* stream) {
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the buffer holds K+1 keys; a group's lanes write K+1 outputs in turn
  if (k_slots >= 1 && k_slots <= 4)
    return launch_expand<kGroup, 5>(o, d, tmin, tmax, cmin, cmax, n_clusters,
                                    n_rays, k_slots, cid_out, te_out,
                                    bound_out, s);
  if (k_slots >= 5 && k_slots <= 8)
    return launch_expand<kGroup, 9>(o, d, tmin, tmax, cmin, cmax, n_clusters,
                                    n_rays, k_slots, cid_out, te_out,
                                    bound_out, s);
  if (k_slots >= 9 && k_slots <= kMaxSlots)
    return launch_expand<kGroup, kMaxSlots + 1>(
        o, d, tmin, tmax, cmin, cmax, n_clusters, n_rays, k_slots, cid_out,
        te_out, bound_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the pair test and the fold behind it.  `keys` holds at least
// n_rays entries of all ones; the fold leaves them so.  k_slots in
// [1, kMaxSlots] and every prim < 2^kPrimBits (the wrapper checks both).
int tpt_pair_test(const float* o, const float* d, const float* tmin,
                  const float* bt0, const int* bp0, const long long* sidx,
                  const int* cid, const float* te, const float* v0,
                  const float* e1, const float* e2, const float* mask,
                  int leaf, int k_slots, int n_rays,
                  unsigned long long* keys, float* t_out, int* p_out,
                  void* stream) {
  if (n_rays <= 0) return 0;
  if (k_slots < 1 || k_slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = kWarps * leaf * 3 * static_cast<int>(sizeof(float4));
  int blocks = 0;
  const int err = resident_blocks(pairtest_kernel, smem, &blocks);
  if (err != 0) return err;
  const long long n_chunks =
      (static_cast<long long>(n_rays) * k_slots + 31) / 32;
  long long grid = (n_chunks + kWarps - 1) / kWarps;   // a chunk a warp
  if (grid > blocks) grid = blocks;
  pairtest_kernel<<<static_cast<int>(grid), kThreads, smem, s>>>(
      o, d, tmin, bt0, sidx, cid, te, v0, e1, e2, mask, leaf, k_slots,
      n_rays, keys);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      bt0, bp0, n_rays, keys, t_out, p_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
