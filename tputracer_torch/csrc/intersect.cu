// Fused small-scene ray intersection for Hopper (sm_90a).
//
// Replaces tputracer/accel/intersect_tpu.py::_fused_kernel, the Pallas
// kernel that tests every ray against every analytic sphere and every
// padded triangle in VMEM.  Same contract: for each ray, the closest hit
// with tmin < t < tmax as (t, prim); spheres first; triangles by Pluecker
// edge signs and the plane equation, rows with mask == 0 skipped; a
// candidate wins only with a strictly smaller t (so a sphere beats a
// triangle at equal t and a lower triangle index a higher one);
// prim = n_tri + s for sphere s, -1 on a miss; t = tmax on a miss.  With
// any_hit a ray stops at its first hit (shadow rays need only t < tmax).
//
// The scene is read as it is: plu (3, 6, T), tri_n (T, 3), tri_v0 (T, 3),
// tri_mask (T,), sph_c (S, 3), sph_r (S,).  The kernel computes v0.n
// itself while staging, in geometry.dot's order, so the wrapper copies
// nothing and launches nothing else per call.
//
// What bounds it: instruction issue.  A live ray reads and writes ~40
// bytes and then runs the edge test of every valid triangle (three 6-term
// Pluecker dots and six sign compares, 39 ops); only where the three signs
// agree does the plane part follow (two 3-term dots, the |d.n| test, one
// division, 17 ops more), and a random ray's signs agree on a few of a
// Cornell box's 36 triangles.  That is far above the card's bytes-per-op
// line.  Every instruction takes an issue slot the float pipes could have
// used, so what counts is the warp instructions issued per live (ray,
// valid triangle).  A warp runs the plane part whenever any one of its
// lanes' signs agree.  The design before this one (one thread per ray
// over all padded slots) spent issue slots on dead lanes, empty slots,
// scalar or 8-byte shared loads (its 18-float rows allowed no wider), a
// division in every lane, and staging the table again for every 128 rays.  This one's triangle
// loops hold 83-90 instructions, the plane part's included, 6 of them
// 16-byte shared loads (chip_profile.py --sass prints the counts from the
// SASS).
//
// The design:
//   * Persistent blocks (as many as the card holds at once; the count is
//     found once per device and kept).  Each warp reads chunks of 32 rays.
//     A dead ray (tmax <= tmin) gets (tmax, -1) at once; the live rays'
//     indices queue up in the warp's shared list (a ballot and a prefix
//     count), and the warp tests them 32 at a time, so no lane tests a
//     triangle for a ray that cannot hit it.  At the end the warps' last
//     short queues are packed into the block's first warps for one round.
//   * A render's dead paths cluster by pixel, so the chunks are taken in a
//     Weyl order (chunk k * step mod n, step near n / golden ratio): each
//     SM's share of the call, and each warp's, samples the whole image, so
//     they get about the same number of live rays.
//   * Only rows with mask > 0 are staged, in ascending slot order, each
//     with its slot index beside it (an ordered block compaction of
//     kThreads slots at a time), so the tie order and prim are those of
//     the padded loop.  A row is packed as six float4: 18 Pluecker floats,
//     the normal, v0.n and the slot, so a test issues six 16-byte
//     broadcast loads.  Up to kTile rows and kSphTile spheres form a tile.
//   * A scene that fits one tile of each (every scene make_scene leaves
//     unclustered up to 256 triangles) is staged once per block, and its
//     warps then run on their own; a larger one is staged tile by tile for
//     each round in which the block's warps test a queue each.
//   * The division runs only in lanes whose three edge signs agree and
//     whose |d.n| > 1e-12; its value, and so the bits, do not change.
//
// Built with -fmad=false and without fast math, and every dot product is
// summed in a fixed order (the 6-term Pluecker dot k = 0..5, the plane
// dots x, y, z), so edge signs and t round exactly as the plain float32
// version in intersect_cuda.py.

#include <cuda_runtime.h>

#include <mutex>
#include <numeric>

namespace {

constexpr int kThreads = 256;                   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;                      // staged triangles per tile
constexpr int kRow = 6;                         // float4 per staged triangle
constexpr int kSphTile = 128;                   // staged spheres per tile

struct Ray {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin;
};

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Stages the rows with mask > 0 of slots cursor, cursor + 1, ... into
// s_tri in ascending slot order, kThreads slots at a time while their rows
// fit kTile; returns the rows staged and moves cursor past the slots read
// (the same in every thread).  Called by the whole block.
__device__ int stage_tris(float4* s_tri, int* s_wcnt,
                          const float* __restrict__ plu,
                          const float* __restrict__ trin,
                          const float* __restrict__ v0,
                          const float* __restrict__ mask, int n_tri,
                          int& cursor) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t T = static_cast<size_t>(n_tri);
  int n = 0;
  while (cursor < n_tri) {
    const int slot = cursor + tid;
    const bool valid = slot < n_tri && mask[slot] > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, valid);
    if ((tid & 31) == 0) s_wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wcnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    __syncthreads();   // every thread has read s_wcnt
    if (n + total > kTile) break;
    if (valid) {
      float p[18];
#pragma unroll
      for (int k = 0; k < 18; ++k) p[k] = plu[k * T + slot];
      const float nx = trin[3 * slot], ny = trin[3 * slot + 1];
      const float nz = trin[3 * slot + 2];
      float v0n = v0[3 * slot] * nx + v0[3 * slot + 1] * ny;
      v0n = v0n + v0[3 * slot + 2] * nz;
      float4* q = s_tri + kRow * (n + before + __popc(bal & lanes_below()));
      q[0] = make_float4(p[0], p[1], p[2], p[3]);
      q[1] = make_float4(p[4], p[5], p[6], p[7]);
      q[2] = make_float4(p[8], p[9], p[10], p[11]);
      q[3] = make_float4(p[12], p[13], p[14], p[15]);
      q[4] = make_float4(p[16], p[17], nx, ny);
      q[5] = make_float4(nz, v0n, __int_as_float(slot), 0.f);
    }
    n += total;
    cursor += kThreads;
  }
  return n;
}

// Spheres s0 .. s0 + cnt - 1 as float4 (cx, cy, cz, r).  Whole block.
__device__ __forceinline__ void stage_spheres(float4* s_sph,
                                              const float* __restrict__ sph_c,
                                              const float* __restrict__ sph_r,
                                              int s0, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    const int s = s0 + k;
    s_sph[k] = make_float4(sph_c[3 * s], sph_c[3 * s + 1], sph_c[3 * s + 2],
                           sph_r[s]);
  }
}

__device__ __forceinline__ void test_spheres(const float4* s_sph, int cnt,
                                             int prim0, const Ray& r,
                                             int any_hit, float& bt, int& bp,
                                             bool& live) {
  for (int j = 0; live && j < cnt; ++j) {
    const float4 q = s_sph[j];
    const float bx = r.ox - q.x, by = r.oy - q.y, bz = r.oz - q.z;
    const float bq = bx * r.dx + by * r.dy + bz * r.dz;
    const float cq = bx * bx + by * by + bz * bz - q.w * q.w;
    const float disc = bq * bq - cq;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    const float ts = t0 > r.tmin ? t0 : t1;
    if (disc > 0.f && ts > r.tmin && ts < bt) {
      bt = ts;
      bp = prim0 + j;
      if (any_hit) live = false;
    }
  }
}

__device__ __forceinline__ void test_tris(const float4* s_tri, int cnt,
                                          const Ray& r, int any_hit,
                                          float& bt, int& bp, bool& live) {
  for (int j = 0; live && j < cnt; ++j) {
    const float4* q = s_tri + kRow * j;
    const float4 a = q[0], b = q[1], c = q[2], e = q[3], f = q[4];
    // [d, m] against each edge's [M, E], k = 0..5 in order
    const float w0 = a.x * r.dx + a.y * r.dy + a.z * r.dz + a.w * r.mx +
                     b.x * r.my + b.y * r.mz;
    const float w1 = b.z * r.dx + b.w * r.dy + c.x * r.dz + c.y * r.mx +
                     c.z * r.my + c.w * r.mz;
    const float w2 = e.x * r.dx + e.y * r.dy + e.z * r.dz + e.w * r.mx +
                     f.x * r.my + f.y * r.mz;
    const bool pos = w0 >= 0.f && w1 >= 0.f && w2 >= 0.f;
    const bool neg = w0 <= 0.f && w1 <= 0.f && w2 <= 0.f;
    if (!(pos || neg)) continue;
    const float nx = f.z, ny = f.w;
    const float4 g = q[5];   // nz, v0.n, slot
    const float d_dot_n = r.dx * nx + r.dy * ny + r.dz * g.x;
    if (!(fabsf(d_dot_n) > 1e-12f)) continue;
    const float o_dot_n = r.ox * nx + r.oy * ny + r.oz * g.x;
    const float t = (g.y - o_dot_n) / d_dot_n;
    if (t > r.tmin && t < bt) {
      bt = t;
      bp = __float_as_int(g.z);
      if (any_hit) live = false;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_intersect_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmin_in,
                       const float* __restrict__ tmax_in,
                       const float* __restrict__ sph_c,   // (n_sph, 3)
                       const float* __restrict__ sph_r,   // (n_sph,)
                       int n_sph,
                       const float* __restrict__ plu,     // (3, 6, n_tri)
                       const float* __restrict__ trin,    // (n_tri, 3)
                       const float* __restrict__ v0,      // (n_tri, 3)
                       const float* __restrict__ mask,    // (n_tri,)
                       int n_tri, int n_rays, int any_hit, int step,
                       float* __restrict__ t_out, int* __restrict__ prim_out) {
  __shared__ float4 s_tri[kTile * kRow];
  __shared__ float4 s_sph[kSphTile];
  __shared__ int s_queue[kWarps][2 * 32];   // each warp's live rays
  __shared__ int s_wcnt[kWarps];
  __shared__ int s_left[kWarps];            // each warp's last, short queue

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* queue = s_queue[warp];
  int cursor = 0;
  const int n_staged = stage_tris(s_tri, s_wcnt, plu, trin, v0, mask, n_tri,
                                  cursor);
  const bool resident = cursor >= n_tri && n_sph <= kSphTile;
  if (resident) stage_spheres(s_sph, sph_c, sph_r, 0, n_sph);
  __syncthreads();

  // Ray i (none where i < 0) against the whole scene; writes (t, prim).
  // Resident tables: each thread alone.  Otherwise the whole block calls
  // it together and stages the tables tile by tile.
  auto trace = [&](int i) {
    Ray r{};
    float bt = 0.f;
    int bp = -1;
    bool live = i >= 0;
    if (live) {
      r.ox = o[3 * i];
      r.oy = o[3 * i + 1];
      r.oz = o[3 * i + 2];
      r.dx = d[3 * i];
      r.dy = d[3 * i + 1];
      r.dz = d[3 * i + 2];
      // ray moment m = o x d, as geometry.cross
      r.mx = r.oy * r.dz - r.oz * r.dy;
      r.my = r.oz * r.dx - r.ox * r.dz;
      r.mz = r.ox * r.dy - r.oy * r.dx;
      r.tmin = tmin_in[i];
      bt = tmax_in[i];
    }
    if (resident) {
      test_spheres(s_sph, n_sph, n_tri, r, any_hit, bt, bp, live);
      test_tris(s_tri, n_staged, r, any_hit, bt, bp, live);
    } else {
      for (int s0 = 0; s0 < n_sph; s0 += kSphTile) {
        const int cnt = min(kSphTile, n_sph - s0);
        __syncthreads();   // every thread is done with the last tile
        stage_spheres(s_sph, sph_c, sph_r, s0, cnt);
        __syncthreads();
        test_spheres(s_sph, cnt, n_tri + s0, r, any_hit, bt, bp, live);
      }
      int cur = 0;
      while (cur < n_tri) {
        __syncthreads();
        const int cnt = stage_tris(s_tri, s_wcnt, plu, trin, v0, mask,
                                   n_tri, cur);
        __syncthreads();
        test_tris(s_tri, cnt, r, any_hit, bt, bp, live);
      }
    }
    if (i >= 0) {
      t_out[i] = bt;
      prim_out[i] = bp;
    }
  };

  // Each warp reads chunks of 32 rays: for k = its warp index in the grid,
  // then k + stride, ..., chunk k * step mod n_chunks, kept as k grows.
  // Its live rays queue up and are tested 32 at a time.
  const int n_chunks = (n_rays + 31) / 32;
  const int stride = gridDim.x * kWarps;
  int k = blockIdx.x * kWarps + warp;
  int chunk = static_cast<int>(static_cast<long long>(k) * step % n_chunks);
  const int advance =
      static_cast<int>(static_cast<long long>(stride) * step % n_chunks);
  int queued = 0;   // the same in all lanes of the warp; under 32 here
  while (true) {
    // top the queue up to 32, the dead rays out at once
    while (queued < 32 && k < n_chunks) {
      const int i = chunk * 32 + lane;
      bool live = false;
      if (i < n_rays) {
        const float tmax = tmax_in[i];
        live = tmax > tmin_in[i];
        if (!live) {
          t_out[i] = tmax;
          prim_out[i] = -1;
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) queue[queued + __popc(bal & lanes_below())] = i;
      queued += __popc(bal);
      k += stride;
      chunk += advance;
      if (chunk >= n_chunks) chunk -= n_chunks;
    }
    __syncwarp();
    // a resident warp goes on alone; otherwise while any warp has 32
    const bool full = queued >= 32;
    if (resident ? !full : !__syncthreads_or(full)) break;
    trace(full ? queue[lane] : -1);
    if (full) {   // the rest of the queue (under 32) to its front
      const int rest = queued - 32;
      const int next = lane < rest ? queue[32 + lane] : 0;
      __syncwarp();
      if (lane < rest) queue[lane] = next;
      __syncwarp();
      queued = rest;
    }
  }

  // The warps' last queues, under 32 rays each, packed into the block's
  // first threads: at most kThreads - kWarps rays, one round.
  if (lane == 0) s_left[warp] = queued;
  __syncthreads();
  int w = 0, at = tid;
  while (w < kWarps && at >= s_left[w]) at -= s_left[w++];
  trace(w < kWarps ? s_queue[w][at] : -1);
}

// The persistent grid on the current device: as many blocks as the card
// holds at once.  Found once per device and kept, so a call makes no
// occupancy query.
int max_blocks(int* blocks) {
  static std::mutex lock;
  static int known_dev = -1, known_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(lock);
  if (dev != known_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fused_intersect_kernel, kThreads, 0)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return static_cast<int>(err);
    known_dev = dev;
    known_blocks = sms * per_sm;
  }
  *blocks = known_blocks;
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
int tpt_fused_intersect(const float* o, const float* d, const float* tmin,
                        const float* tmax, const float* sph_c,
                        const float* sph_r, int n_sph, const float* plu,
                        const float* trin, const float* v0, const float* mask,
                        int n_tri, int n_rays, int any_hit, float* t_out,
                        int* prim_out, void* stream) {
  if (n_rays <= 0) return 0;
  int blocks = 0;
  const int err = max_blocks(&blocks);
  if (err != 0) return err;
  const int n_chunks = (n_rays + 31) / 32;
  const int wanted = (n_chunks + kWarps - 1) / kWarps;   // a chunk a warp
  const int grid = wanted < blocks ? wanted : blocks;
  fused_intersect_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, sph_c, sph_r, n_sph, plu, trin, v0, mask, n_tri,
      n_rays, any_hit, chunk_step(n_chunks), t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
