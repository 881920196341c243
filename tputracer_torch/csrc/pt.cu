// PT's bounce for Hopper (sm_90a): the shading of one wavefront bounce of
// a chunk of paths, in two kernels around the shadow rays.
//
// Replaces no TPU kernel.  The JAX package writes the bounce as array ops
// (tputracer/integrators/pt.py's _bounce_step) and XLA fuses them; the
// port's torch version (integrators/pt.py's _bounce_step_plain) runs them
// as ~300 elementwise kernels, gathers and concatenations a bounce, each
// reading and writing a few (n,) vectors of every lane, alive or not.
// Here each thread takes one lane through the bounce:
//
//   (the caller's closest-hit call: (t, prim), unchanged)
//   pt_prepare_kernel  finalize_hit's point, normal and material; the
//       emission at the hit with its MIS weight, added into L; on every
//       bounce but the last, the light sample (pcg3d in the kernel), the
//       NEE geometry, the BSDF at the light and its MIS weight, and the
//       shadow ray (origin, direction, tmax = 0 where it is not wanted),
//       with the NEE contribution and the lane's flags in a small stash;
//       the bounce's three ray counts, added per block;
//   (the caller's shadow-ray call, unchanged)
//   pt_finish_kernel  the NEE add where the shadow ray is clear; the
//       BSDF sample (diffuse, mirror, glass with its Fresnel pick),
//       the throughput, Russian roulette, and the next ray, pdf, delta
//       flag, alive flag and closest-hit tmax, all in place.
//
// What bounds it: bytes.  A lane's arithmetic is a few hundred float ops;
// the two kernels move at most 260 B a live lane (the carry read and
// written, the hit, the shadow ray and the stash; a lane that misses
// moves 17 B; PT_LANE_BYTES in chip_smoke.py), far below the card's
// ops-per-byte line.  So every
// intermediate stays in registers, the finish kernel recomputes the hit's
// point and normal from (t, prim) and the carry rather than reading them
// back, and a lane that is dead when the bounce begins reads its alive
// flag and leaves: the prepare kernel writes its shadow tmax = 0 and
// nothing else, the finish kernel nothing.  The torch version gives such
// a lane's o, d, thr, prev_delta and prev_pdf values that no later step
// reads (every one is masked by alive); here they keep their old values.
// A lane alive at the bounce's start gets the torch version's bits in
// every carry tensor wherever it is still alive at its end, and L and
// alive everywhere.
//
// Bits: every multiply, add, divide and square root is rounded on its
// own (-fmad=false, IEEE division and sqrt) in the torch version's order,
// with torch's clamp and amax NaN rules; x ** 2 is x * x and 1.0 / x is
// the reciprocal, as torch's CUDA kernels compute them; a tensor times a
// Python scalar is a product with the scalar rounded to float; the
// lookups are plain reads of in-range rows (lookup.fetch's forward);
// cosf and sinf are the libdevice functions torch's cos and sin call.
// finalize_hit and the BSDFs are shade.cuh's, shared with csrc/walk.cu;
// the draws are pcg3d.cuh's, uniform3's bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "pcg3d.cuh"
#include "shade.cuh"

// Everything a launch reads and writes: the scene's tables, the chunk's
// lanes and the bounce.  pt_cuda.Args mirrors it field for field.
struct Args {
  const float* tri_n;       // (T, 3), unnormalized
  const int* tri_mat;       // (T,)
  const float* sph_c;       // (S, 3)
  const float* sph_r;       // (S,)
  const int* sph_mat;       // (S,)
  const int* mat_kind;      // (M,)
  const float* mat_albedo;  // (M, 3)
  const float* mat_emission;  // (M, 3)
  const float* mat_ior;     // (M,)
  const int* emit_prim;     // (E,)
  const float* emit_area;   // (E,)
  const float* emit_v0;     // (E, 3)
  const float* emit_e1;     // (E, 3)
  const float* emit_e2;     // (E, 3)
  const float* emit_n;      // (E, 3)
  const int* emit_mat;      // (E,)
  const long long* uid;     // (n,)
  const float* t;           // (n,) the closest hit's
  const int* prim;          // (n,)
  float* o;                 // (n, 3) the carry, read and written in place
  float* d;                 // (n, 3)
  float* L;                 // (n, 3)
  float* thr;               // (n, 3)
  unsigned char* alive;     // (n,)
  unsigned char* prev_delta;  // (n,)
  float* prev_pdf;          // (n,)
  float* tmax;              // (n,) the next closest-hit call's
  float* so;                // (n, 3) the shadow rays
  float* sd;                // (n, 3)
  float* stmax;             // (n,)
  float* contrib;           // (n, 3) the stash: NEE's contribution
  unsigned char* flags;     // (n,) and kActive | kWant
  const unsigned char* occ;   // (n,) the shadow rays' verdicts
  int* counts;              // (3, max_bounces + 1): issued, active, shadow
  long long n;
  int n_tri_pad;
  int n_emit;
  int bounce;
  int max_bounces;
  int rr_start;
  int mis;
  int transport;
  unsigned int seed;
  float eps;
};
static_assert(sizeof(Args) == 320, "pt_cuda.Args mirrors this layout");

namespace {

using namespace tpt;

constexpr int kThreads = 256;   // threads per block

// rng's salt layout: bounce * kSaltStride + slot
constexpr uint32_t kSaltStride = 8;
constexpr uint32_t kSlotLight = 0;
constexpr uint32_t kSlotBsdf = 1;
constexpr uint32_t kSlotRR = 2;

// the stash's flag bits: the lane hit something while alive (active), and
// its shadow ray is traced (want)
constexpr unsigned char kActive = 1;
constexpr unsigned char kWant = 2;

constexpr float kBig = static_cast<float>(3.0e38);   // pt._BIG
constexpr float kMinDist2 = static_cast<float>(1e-12);
constexpr float kMinCos = static_cast<float>(1e-6);
constexpr float kShadowScale = static_cast<float>(1.0 - 1e-3);
constexpr float kRRLo = static_cast<float>(0.05);
constexpr float kRRHi = static_cast<float>(0.95);

// pt._power2
__device__ __forceinline__ float power2(float a, float b) {
  const float a2 = a * a;
  return a2 / clamp_min(a2 + b * b, kMinSq);
}

__device__ __forceinline__ uint32_t salt(int bounce, uint32_t slot) {
  return static_cast<uint32_t>(bounce) * kSaltStride + slot;
}

// lights.pdf_light_area: the area pdf of the emissive triangle prim, 0 if
// it is none; the sum over the matching rows in table order
__device__ __forceinline__ float pdf_light_area(const Args& a, int prim) {
  float area = 0.0f;
  bool emitter = false;
  for (int e = 0; e < a.n_emit; ++e) {
    if (a.emit_prim[e] == prim) {
      area = area + a.emit_area[e];
      emitter = true;
    }
  }
  return emitter ? 1.0f / (clamp_min(area, kMinSq) *
                           static_cast<float>(a.n_emit))
                 : 0.0f;
}

// One lane of the prepare kernel; returns kActive | kWant as it set them,
// and whether the lane was alive.
__device__ __forceinline__ unsigned char prepare_lane(const Args& a,
                                                      long long i,
                                                      bool terminal,
                                                      bool& was_alive) {
  was_alive = a.alive[i] != 0;
  if (!was_alive) {
    if (!terminal) a.stmax[i] = 0.0f;
    return 0;
  }
  const float t = a.t[i];
  if (!(t < kBig)) {   // a miss: the lane dies in the finish kernel
    if (!terminal) {
      a.stmax[i] = 0.0f;
      a.flags[i] = 0;
    }
    return 0;
  }
  const Vec o = load3(a.o + 3 * i), d = load3(a.d + 3 * i);
  const int prim = a.prim[i];
  const Surface s = surface(a, o, d, t, prim);
  const Vec thr = load3(a.thr + 3 * i);

  // ---- emission at the hit vertex ----
  const Vec le = dot(d, s.n) < 0.0f ? load3(a.mat_emission + 3 * s.mat)
                                    : Vec{0.0f, 0.0f, 0.0f};
  const bool prev_delta = a.prev_delta[i] != 0;
  float w_hit;
  if (a.mis && a.bounce > 0) {
    const float pl_area = pdf_light_area(a, prim);
    const float cos_l = fabsf(dot(s.n, d));
    const float pl_sa = pl_area * (t * t) / clamp_min(cos_l, kMinCos);
    w_hit = prev_delta ? 1.0f : power2(a.prev_pdf[i], pl_sa);
  } else {
    w_hit = prev_delta ? 1.0f : 0.0f;
  }
  Vec L = add(load3(a.L + 3 * i), scale(mul(thr, le), w_hit));
  store3(a.L + 3 * i, L);
  if (terminal) return kActive;

  // ---- next-event estimation: a point on a light, its shadow ray ----
  const Vec wo = neg(d);
  const Vec ns = face_forward(s.n, wo);
  float u0, u1, u2;
  tpt::draw(a.uid[i], salt(a.bounce, kSlotLight), a.seed, u0, u1, u2);
  const int E = a.n_emit;
  long long idx = static_cast<long long>(u0 * static_cast<float>(E));
  idx = idx < E - 1 ? idx : E - 1;
  const float su = sqrtf(u1);
  const float b1 = 1.0f - su;
  const float b2 = u2 * su;
  const Vec y = add(add(load3(a.emit_v0 + 3 * idx),
                        scale(load3(a.emit_e1 + 3 * idx), b1)),
                    scale(load3(a.emit_e2 + 3 * idx), b2));
  const Vec n_l = load3(a.emit_n + 3 * idx);
  const float pdf_a =
      1.0f / (a.emit_area[idx] * static_cast<float>(E));
  const Vec to_l = sub(y, s.p);
  const float dist2 = clamp_min(dot(to_l, to_l), kMinDist2);
  const float dist = sqrtf(dist2);
  const Vec wi = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
  const float cos_p = dot(wi, ns);
  const float cos_l = dot(n_l, neg(wi));
  const int kind = a.mat_kind[s.mat];
  const bool want = cos_p > 0.0f && cos_l > kMinCos && kind == kDiffuse;
  if (!want) {
    a.stmax[i] = 0.0f;
    a.flags[i] = kActive;
    return kActive;
  }
  store3(a.so + 3 * i, add(s.p, scale(ns, a.eps)));
  store3(a.sd + 3 * i, wi);
  a.stmax[i] = dist * kShadowScale;
  const Vec f = eval_bsdf(a, kind, s.mat, ns, wo, wi);
  const float pdf_sa = pdf_a * dist2 / clamp_min(cos_l, kMinCos);
  float w_cos = cos_p;   // w_nee * cos_p
  if (a.mis) w_cos = power2(pdf_sa, pdf_bsdf(kind, ns, wo, wi)) * cos_p;
  const Vec le_l =
      load3(a.mat_emission + 3 * a.emit_mat[idx]);
  store3(a.contrib + 3 * i, scale(mul(mul(thr, f), le_l), w_cos / pdf_sa));
  a.flags[i] = kActive | kWant;
  return kActive | kWant;
}

__global__ void __launch_bounds__(kThreads) pt_prepare_kernel(const Args a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool terminal = a.bounce == a.max_bounces;
  bool was_alive = false;
  unsigned char fl = 0;
  if (i < a.n) fl = prepare_lane(a, i, terminal, was_alive);
  // the bounce's ray counts: a block's, then one atomic each
  const int issued = __syncthreads_count(was_alive);
  const int active = __syncthreads_count(fl & kActive);
  const int shadow = __syncthreads_count(fl & kWant);
  if (threadIdx.x == 0) {
    const int slots = a.max_bounces + 1;
    if (issued) atomicAdd(a.counts + a.bounce, issued);
    if (active) atomicAdd(a.counts + slots + a.bounce, active);
    if (shadow) atomicAdd(a.counts + 2 * slots + a.bounce, shadow);
  }
}

__global__ void __launch_bounds__(kThreads) pt_finish_kernel(const Args a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n || !a.alive[i]) return;
  const unsigned char fl = a.flags[i];
  if (!(fl & kActive)) {   // missed: the path ends
    a.alive[i] = 0;
    a.tmax[i] = 0.0f;
    return;
  }
  if ((fl & kWant) && !a.occ[i])
    store3(a.L + 3 * i, add(load3(a.L + 3 * i), load3(a.contrib + 3 * i)));

  const Vec o = load3(a.o + 3 * i), d = load3(a.d + 3 * i);
  const Surface s = surface(a, o, d, a.t[i], a.prim[i]);
  const Vec wo = neg(d);
  const Vec ns = face_forward(s.n, wo);
  const int kind = a.mat_kind[s.mat];
  const long long uid = a.uid[i];
  float u0, u1, u2;
  tpt::draw(uid, salt(a.bounce, kSlotBsdf), a.seed, u0, u1, u2);
  Vec wi, w;
  float pdf;
  sample_bsdf(a, kind, s.mat, s.n, ns, wo, u0, u1, u2, wi, w, pdf);
  Vec thr = mul(load3(a.thr + 3 * i), w);
  bool active = true;
  if (a.bounce >= a.rr_start) {
    float ur, unused1, unused2;
    tpt::draw(uid, salt(a.bounce, kSlotRR), a.seed, ur, unused1, unused2);
    const float q = clamp(amax(thr), kRRLo, kRRHi);
    active = ur < q;
    thr = {thr.x / q, thr.y / q, thr.z / q};
  }
  const float side = dot(wi, s.n) >= 0.0f ? 1.0f : -1.0f;
  store3(a.o + 3 * i, add(s.p, scale(s.n, side * a.eps)));
  store3(a.d + 3 * i, wi);
  store3(a.thr + 3 * i, thr);
  a.prev_delta[i] = kind != kDiffuse;
  a.prev_pdf[i] = pdf;
  const bool alive = active && amax(thr) > 0.0f;
  a.alive[i] = alive;
  a.tmax[i] = alive ? kBig : 0.0f;
}

unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Runs the prepare kernel on args->n lanes (the bounce args->bounce; on
// the last, emission alone) and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
int tpt_pt_prepare(const Args* args, void* stream) {
  if (args->n <= 0) return 0;
  pt_prepare_kernel<<<grid_of(args->n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Runs the finish kernel on args->n lanes, after the shadow-ray call.
int tpt_pt_finish(const Args* args, void* stream) {
  if (args->n <= 0) return 0;
  pt_finish_kernel<<<grid_of(args->n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
