// The counter-based sampler for Hopper (sm_90a): pcg3d of (path uid,
// salt, seed) to three U[0,1) float32 streams (Jarzynski & Olano, JCGT
// 2020).
//
// Replaces no TPU kernel.  The JAX package writes the hash as uint32 ops
// (tputracer/rng.py) and XLA fuses them into the ops around each draw;
// the port's torch version (rng.uniform3_plain) runs them as ~46
// elementwise kernels a draw, and a render draws 3 times a bounce.  This
// kernel is the whole draw in one launch.
//
// What bounds it: bytes.  A lane reads its int64 uid (8 B) and writes
// three floats (12 B); the hash is ~30 integer ops, far below the card's
// ops-per-byte line.  So each thread takes 4 consecutive lanes: two
// 16-byte loads of the uids and one 16-byte store to each output row, a
// warp's accesses contiguous, no shared memory.  The rows lie `stride`
// floats apart, a multiple of 4 the wrapper picks, so every row starts
// 16-byte aligned; a uid pointer that is not (a slice at an odd offset)
// is read one lane at a time.  The last n % 4 lanes are one thread's
// scalar tail.
//
// Bits: pcg3d.cuh's draw, the torch version's bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "pcg3d.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kLanes = 4;       // consecutive lanes per thread

using tpt::draw;

__global__ void __launch_bounds__(kThreads)
    uniform3_kernel(const long long* __restrict__ uid, long long n,
                    uint32_t salt, uint32_t seed, long long stride,
                    float* __restrict__ out) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kLanes;
  if (base >= n) return;
  float* ox = out;
  float* oy = out + stride;
  float* oz = out + 2 * stride;
  if (base + kLanes > n) {   // the tail
    for (long long i = base; i < n; ++i)
      draw(uid[i], salt, seed, ox[i], oy[i], oz[i]);
    return;
  }
  long long u[kLanes];
  if ((reinterpret_cast<uintptr_t>(uid) & 15) == 0) {
    const longlong2 a = *reinterpret_cast<const longlong2*>(uid + base);
    const longlong2 b = *reinterpret_cast<const longlong2*>(uid + base + 2);
    u[0] = a.x;
    u[1] = a.y;
    u[2] = b.x;
    u[3] = b.y;
  } else {
    for (int j = 0; j < kLanes; ++j) u[j] = uid[base + j];
  }
  float4 fx, fy, fz;
  draw(u[0], salt, seed, fx.x, fy.x, fz.x);
  draw(u[1], salt, seed, fx.y, fy.y, fz.y);
  draw(u[2], salt, seed, fx.z, fy.z, fz.z);
  draw(u[3], salt, seed, fx.w, fy.w, fz.w);
  *reinterpret_cast<float4*>(ox + base) = fx;
  *reinterpret_cast<float4*>(oy + base) = fy;
  *reinterpret_cast<float4*>(oz + base) = fz;
}

}  // namespace

extern "C" {

// Draws lanes [0, n) into out[0 .. n), out[stride ..), out[2 * stride ..)
// on `stream` and returns cudaGetLastError(): a refused launch never
// runs, and a later synchronize would not report it.  `out` must be
// 16-byte aligned and `stride` a multiple of 4.
int tpt_uniform3(const long long* uid, long long n, unsigned int salt,
                 unsigned int seed, long long stride, float* out,
                 void* stream) {
  if (n <= 0) return 0;
  const long long per_block = kThreads * kLanes;
  const unsigned grid = static_cast<unsigned>((n + per_block - 1) / per_block);
  uniform3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      uid, n, salt, seed, stride, out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_rng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
