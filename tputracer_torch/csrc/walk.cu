// BDPT's subpath walks for Hopper (sm_90a): one vertex of the eye or the
// light walk of a chunk of paths, in one kernel after the vertex's
// closest-hit call.
//
// Replaces no TPU kernel.  The JAX package writes the walk as array ops
// (tputracer/integrators/bdpt.py's _walk) and XLA fuses them; the port's
// torch version (integrators/bdpt.py's _walk_plain) runs them as ~150
// elementwise kernels, gathers and concatenations a vertex, each reading
// and writing a few (n,) vectors of every lane, alive or not.  Here each
// thread takes one lane through the vertex:
//
//   (the caller's closest-hit call: (t, prim), unchanged)
//   walk_kernel  finalize_hit's point, normal and material; the vertex's
//       forward pdf (convert_density of the carried solid-angle pdf from
//       the previous point), its material kind and delta flag; the
//       vertex's SoA written straight into the walk's vertex tensors
//       (p, ng, wo, pdf_fwd, pdf_rev = 0, mat, prim, delta, valid), which
//       the connection and splat kernels read in place; and, but on the
//       walk's last vertex, the pcg3d draw, the BSDF sample, the reverse
//       pdf of the previous vertex (its pdf_rev, where this vertex is
//       valid), the next vertex's throughput beta, and the next ray, pdf,
//       alive flag and closest-hit tmax, in place; the lanes alive at the
//       vertex's start, added per block into the vertex's int32 count.
//
// What bounds it: bytes.  A lane's arithmetic is a few hundred float ops;
// a lane valid at a full vertex moves 184 B (WALK_LANE_BYTES in
// chip_smoke.py), far below the card's ops-per-byte line.  So every
// intermediate stays in registers, the hit point is computed from
// (t, prim) and the carried ray rather than stored twice, and a lane that
// is dead when the vertex begins reads its alive flag, writes its vertex's
// fields, and leaves.
//
// Lanes that are not valid at the vertex (dead at its start, or missing
// everything) get the torch version's valid, delta, pdf_fwd, pdf_rev, mat
// and prim: 0, 0, 0, 0, 0 and -1.  Their p, ng and wo, and the next
// vertex's beta, are zeros: the torch version gives them values (which
// every consumer masks by valid) that only its arithmetic on dead lanes
// makes, and zeros keep the fields the same on every call without it.
// A valid lane gets the torch version's bits in every field, and in the
// carry wherever it is still alive after the vertex.
//
// Bits: those of shade.cuh (-fmad=false, IEEE division and sqrt, torch's
// order and clamp and NaN rules, libdevice cosf and sinf) and pcg3d.cuh's
// draws.

#include <cuda_runtime.h>

#include <cstdint>

#include "pcg3d.cuh"
#include "shade.cuh"

// Everything a launch reads and writes: the scene's tables, the vertex's
// hit, the walk's carry, the previous vertex and this one.
// bdpt_cuda.WalkArgs mirrors it field for field.
struct WalkArgs {
  const float* tri_n;       // (T, 3), unnormalized
  const int* tri_mat;       // (T,)
  const float* sph_c;       // (S, 3)
  const float* sph_r;       // (S,)
  const int* sph_mat;       // (S,)
  const int* mat_kind;      // (M,)
  const float* mat_albedo;  // (M, 3)
  const float* mat_ior;     // (M,)
  const long long* uid;     // (n,)
  const float* hit_t;       // (n,) the closest hit's
  const int* hit_prim;      // (n,)
  float* o;                 // (n, 3) the carry, read and written in place
  float* d;                 // (n, 3)
  float* pdf_sa;            // (n,) the solid-angle pdf of d
  unsigned char* alive;     // (n,)
  float* tmax;              // (n,) the next closest-hit call's
  const float* prev_p;      // (n, 3) the point d was sampled from
  const float* prev_ng;     // (n, 3) the previous vertex's normal, or null
  float* prev_pdf_rev;      // (n,) the previous vertex's pdf_rev, or null
  const float* beta;        // (n, 3) this vertex's throughput
  float* beta_next;         // (n, 3) the next vertex's, null on the last
  float* p;                 // (n, 3) this vertex's fields
  float* ng;                // (n, 3)
  float* wo;                // (n, 3)
  float* pdf_fwd;           // (n,)
  float* pdf_rev;           // (n,)
  int* mat;                 // (n,)
  int* prim;                // (n,)
  unsigned char* delta;     // (n,)
  unsigned char* valid;     // (n,)
  int* count;               // (1,) the lanes alive at the vertex's start
  long long n;
  int n_tri_pad;
  int last;
  int transport;
  unsigned int salt;
  unsigned int seed;
  float eps;
};
static_assert(sizeof(WalkArgs) == 280, "bdpt_cuda.WalkArgs mirrors this");

namespace {

using namespace tpt;

constexpr int kThreads = 256;   // threads per block

constexpr float kBig = static_cast<float>(3.0e38);   // bdpt._BIG
constexpr float kMinDist2 = static_cast<float>(1e-12);

// bdpt._convert_density: the solid-angle pdf at p_from as an area pdf at
// p_to, whose normal is n_to
__device__ __forceinline__ float convert_density(float pdf_sa, Vec p_from,
                                                 Vec p_to, Vec n_to) {
  const Vec w = sub(p_to, p_from);
  const float dist2 = clamp_min(dot(w, w), kMinDist2);
  const float inv = 1.0f / dist2;
  const float cos_to = fabsf(dot(n_to, w)) * sqrtf(inv);
  return pdf_sa * cos_to * inv;
}

// One lane of the kernel, alive at the vertex's start or not.
__device__ __forceinline__ void walk_lane(const WalkArgs& a, long long i,
                                          bool alive) {
  const float t = alive ? a.hit_t[i] : kBig;
  if (!(t < kBig)) {   // dead, or a miss: no vertex, and the path ends
    const Vec zero{0.0f, 0.0f, 0.0f};
    store3(a.p + 3 * i, zero);
    store3(a.ng + 3 * i, zero);
    store3(a.wo + 3 * i, zero);
    if (!a.last) store3(a.beta_next + 3 * i, zero);
    a.pdf_fwd[i] = 0.0f;
    a.pdf_rev[i] = 0.0f;
    a.mat[i] = 0;
    a.prim[i] = -1;
    a.delta[i] = 0;
    a.valid[i] = 0;
    if (alive && !a.last) {
      a.alive[i] = 0;
      a.tmax[i] = 0.0f;
    }
    return;
  }
  const Vec o = load3(a.o + 3 * i), d = load3(a.d + 3 * i);
  const int prim = a.hit_prim[i];
  const Surface s = surface(a, o, d, t, prim);
  const Vec prev_p = load3(a.prev_p + 3 * i);
  const int kind = a.mat_kind[s.mat];
  const Vec wo = neg(d);
  store3(a.p + 3 * i, s.p);
  store3(a.ng + 3 * i, s.n);
  store3(a.wo + 3 * i, wo);
  a.pdf_fwd[i] = convert_density(a.pdf_sa[i], prev_p, s.p, s.n);
  a.pdf_rev[i] = 0.0f;
  a.mat[i] = s.mat;
  a.prim[i] = prim;
  a.delta[i] = kind != kDiffuse;
  a.valid[i] = 1;
  if (a.last) return;

  // ---- the next direction, and the previous vertex's reverse pdf ----
  const Vec ns = face_forward(s.n, wo);
  float u0, u1, u2;
  tpt::draw(a.uid[i], a.salt, a.seed, u0, u1, u2);
  Vec wi, w;
  float pdf;
  sample_bsdf(a, kind, s.mat, s.n, ns, wo, u0, u1, u2, wi, w, pdf);
  if (a.prev_pdf_rev) {
    // pdf_bsdf(.., n, wi, wo): the pdf of sampling wo given wi
    const float rev_sa = pdf_bsdf(kind, face_forward(s.n, wi), wi, wo);
    a.prev_pdf_rev[i] =
        convert_density(rev_sa, s.p, prev_p, load3(a.prev_ng + 3 * i));
  }
  const Vec beta = mul(load3(a.beta + 3 * i), w);
  store3(a.beta_next + 3 * i, beta);
  const float side = dot(wi, s.n) >= 0.0f ? 1.0f : -1.0f;
  store3(a.o + 3 * i, add(s.p, scale(s.n, side * a.eps)));
  store3(a.d + 3 * i, wi);
  a.pdf_sa[i] = pdf;
  const bool alive_next = amax(beta) > 0.0f;
  a.alive[i] = alive_next;
  a.tmax[i] = alive_next ? kBig : 0.0f;
}

__global__ void __launch_bounds__(kThreads) walk_kernel(const WalkArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  bool alive = false;
  if (i < a.n) {
    alive = a.alive[i] != 0;
    walk_lane(a, i, alive);
  }
  // the closest-hit rays of the vertex: a block's, then one atomic
  const int issued = __syncthreads_count(alive);
  if (threadIdx.x == 0 && issued) atomicAdd(a.count, issued);
}

unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Runs the kernel on args->n lanes (one vertex; on the walk's last,
// args->last, the vertex alone) and returns cudaGetLastError(): a refused
// launch never runs, and a later synchronize would not report it.
int tpt_walk(const WalkArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  walk_kernel<<<grid_of(args->n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_walk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
