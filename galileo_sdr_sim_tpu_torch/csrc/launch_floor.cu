// The launch floor: an empty kernel, launched with a given grid and block.
//
// The port's smallest kernels (the kp prologue, the gather probe) move so
// few bytes that their byte bound lies below what any launch of their
// grid takes on the card.  ops/measure.floor_ms times this kernel with the
// same grid and block size, the same way as the kernel itself, so that a
// kernel's time can be read against what it could at best reach.  It
// replaces no TPU kernel and no path of the system runs it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launch the empty kernel with grid (gx, gy, gz) and `threads` threads a
// block on `stream`; returns cudaGetLastError() (0 = launched).
int launch_floor_launch(int gx, int gy, int gz, int threads, void* stream) {
  if (gx <= 0 || gy <= 0 || gz <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<dim3(gx, gy, gz), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
