// Fused small-scene ray intersection for Hopper (sm_90a).
//
// Replaces tputracer/accel/intersect_tpu.py::_fused_kernel, the Pallas
// kernel that tests every ray against every analytic sphere and every
// padded triangle in VMEM.  Same contract: for each ray, the closest hit
// with tmin < t < tmax as (t, prim); spheres first; triangles by Pluecker
// edge signs and the plane equation, rows with mask == 0 skipped; a
// candidate wins only with a strictly smaller t (so a sphere beats a
// triangle at equal t and a lower triangle index a higher one);
// prim = n_tri + s for sphere s, -1 on a miss; t = tmax on a miss.
//
// What bounds it: arithmetic, not bytes.  A ray reads and writes about 30
// bytes and then runs ~128 triangle tests of ~40 float operations each
// (three 6-term Pluecker dots, two 3-term plane dots, one division), so
// the kernel sits far above the card's bytes-per-flop line; it is bound by
// ALU/FMA issue.
//
// Design: one thread per ray, its ray in registers.  The block stages the
// scene tables into shared memory in chunks of 128 triangles (~23 floats
// each, ~12 KB a chunk, any triangle count) and of 128 spheres, so every
// thread of a block reads one copy of the scene; all lanes of a warp read
// the same triangle at the same time, which shared memory broadcasts.
// Lanes with tmax <= tmin (dead paths get tmax = 0) write (tmax, -1)
// without testing: no candidate could pass t > tmin && t < tmax.  With
// any_hit a lane stops at its first hit (shadow rays need only t < tmax).
//
// Built with -fmad=false and without fast math, and every dot product is
// summed in a fixed order (the 6-term Pluecker dot k = 0..5), so edge signs
// and t round exactly as the plain float32 version in intersect_cuda.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // rays per block
constexpr int kTriBlk = 128;    // triangles staged per chunk
constexpr int kSphBlk = 128;    // spheres staged per chunk

__global__ void __launch_bounds__(kThreads)
fused_intersect_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmin_in,
                       const float* __restrict__ tmax_in,
                       const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ plu,   // (3, n_tri, 6)
                       const float* __restrict__ trin,  // (n_tri, 3)
                       const float* __restrict__ v0n,   // (n_tri,)
                       const float* __restrict__ mask,  // (n_tri,)
                       int n_tri, int n_rays, int any_hit,
                       float* __restrict__ t_out, int* __restrict__ prim_out) {
  __shared__ float s_plu[kTriBlk * 18];   // [tri][edge * 6 + k]
  __shared__ float s_n[kTriBlk * 3];
  __shared__ float s_v0n[kTriBlk];
  __shared__ float s_mask[kTriBlk];
  __shared__ float s_sph[kSphBlk * 4];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool in_range = i < n_rays;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tmin = tmin_in[i];
    tmax = tmax_in[i];
  }
  // every thread stays to the end: all of them help stage the tables
  bool live = in_range && tmax > tmin;
  float bt = tmax;
  int bp = -1;

  for (int s0 = 0; s0 < n_sph; s0 += kSphBlk) {
    const int cnt = min(kSphBlk, n_sph - s0);
    __syncthreads();
    for (int k = tid; k < cnt * 4; k += kThreads) s_sph[k] = sph[s0 * 4 + k];
    __syncthreads();
    for (int s = 0; live && s < cnt; ++s) {
      const float cx = s_sph[4 * s], cy = s_sph[4 * s + 1];
      const float cz = s_sph[4 * s + 2], r = s_sph[4 * s + 3];
      const float bx = ox - cx, by = oy - cy, bz = oz - cz;
      const float bq = bx * dx + by * dy + bz * dz;
      const float cq = bx * bx + by * by + bz * bz - r * r;
      const float disc = bq * bq - cq;
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float t0 = -bq - sq;
      const float t1 = -bq + sq;
      const float ts = t0 > tmin ? t0 : t1;
      if (disc > 0.f && ts > tmin && ts < bt) {
        bt = ts;
        bp = n_tri + s0 + s;
        if (any_hit) live = false;
      }
    }
  }

  // ray moment m = o x d; feature [d, m] against each edge's [M, E]
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;

  for (int t0 = 0; t0 < n_tri; t0 += kTriBlk) {
    const int cnt = min(kTriBlk, n_tri - t0);
    __syncthreads();
    for (int k = tid; k < cnt * 18; k += kThreads) {
      const int tri = k / 18, e = (k % 18) / 6, c = k % 6;
      s_plu[k] = plu[(e * n_tri + t0 + tri) * 6 + c];
    }
    for (int k = tid; k < cnt * 3; k += kThreads) s_n[k] = trin[t0 * 3 + k];
    for (int k = tid; k < cnt; k += kThreads) {
      s_v0n[k] = v0n[t0 + k];
      s_mask[k] = mask[t0 + k];
    }
    __syncthreads();
    for (int j = 0; live && j < cnt; ++j) {
      if (!(s_mask[j] > 0.f)) continue;
      const float* p = s_plu + 18 * j;
      float w[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float* q = p + 6 * e;
        float acc = q[0] * dx;
        acc = acc + q[1] * dy;
        acc = acc + q[2] * dz;
        acc = acc + q[3] * mx;
        acc = acc + q[4] * my;
        acc = acc + q[5] * mz;
        w[e] = acc;
      }
      const bool pos = w[0] >= 0.f && w[1] >= 0.f && w[2] >= 0.f;
      const bool neg = w[0] <= 0.f && w[1] <= 0.f && w[2] <= 0.f;
      const float nx = s_n[3 * j], ny = s_n[3 * j + 1], nz = s_n[3 * j + 2];
      const float d_dot_n = dx * nx + dy * ny + dz * nz;
      const float o_dot_n = ox * nx + oy * ny + oz * nz;
      const bool ok = fabsf(d_dot_n) > 1e-12f;
      const float t = (s_v0n[j] - o_dot_n) / (ok ? d_dot_n : 1.f);
      if (ok && (pos || neg) && t > tmin && t < bt) {
        bt = t;
        bp = t0 + j;
        if (any_hit) live = false;
      }
    }
  }

  if (in_range) {
    t_out[i] = bt;
    prim_out[i] = bp;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
int tpt_fused_intersect(const float* o, const float* d, const float* tmin,
                        const float* tmax, const float* sph, int n_sph,
                        const float* plu, const float* trin, const float* v0n,
                        const float* mask, int n_tri, int n_rays, int any_hit,
                        float* t_out, int* prim_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kThreads - 1) / kThreads;
  fused_intersect_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, sph, n_sph, plu, trin, v0n, mask, n_tri, n_rays,
      any_hit, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
