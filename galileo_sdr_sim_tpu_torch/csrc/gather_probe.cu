// In-tile gather for NVIDIA Hopper (sm_90a): out = take_along_axis(tab,
// idx, axis) on (rows, cols) int32 tables, axis 0 or 1.
//
// Replaces the Pallas TPU kernel `main.probe.k` of
// tools/probe_pallas_gather.py:23-27, a capability probe: on the TPU it
// asks whether Mosaic lowers an in-VMEM `jnp.take_along_axis` (a
// `tpu.dynamic_gather`) at shapes (8..128, 128..8192).  On the GPU a
// gather is one indexed load a thread, so the kernel is that: one thread
// per output element, threads along a row on neighbouring columns, so
// the idx read and the out write are coalesced; the tab read is
// coalesced along axis 0 (same column) and scattered within one row's
// span along axis 1 (one row is at most 32 KB, served by L1/L2).
//
// What bounds it on an H100: it does no arithmetic; it moves 8 bytes an
// element (idx read, out written) plus each table element the indices
// reach, read once: at most 1.5 MB at the largest probe shape (16, 8192),
// about 0.5 us at 3.35 TB/s, so at the probe's sizes the launch itself
// is most of the time.
//
// An index outside [0, n) (n the table's length along `axis`) gives 0
// instead of a read outside the table, as the plain version does; the
// probe draws its indices in range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int AXIS>
__global__ void __launch_bounds__(THREADS) gather_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int rows, int cols) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = (int)(i / cols);
  const int c = (int)(i % cols);
  const int j = idx[i];
  const int n = AXIS == 0 ? rows : cols;
  if (j < 0 || j >= n) {
    out[i] = 0;
    return;
  }
  out[i] = AXIS == 0 ? tab[(long long)j * cols + c] : tab[(long long)r * cols + j];
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an axis other than 0 or 1 or an empty shape.
int gather_probe_launch(const void* tab, const void* idx, void* out, int rows, int cols,
                        int axis, void* stream) {
  if ((axis != 0 && axis != 1) || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tab);
  const int32_t* x = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  if (axis == 0)
    gather_kernel<0><<<grid, THREADS, 0, st>>>(t, x, o, rows, cols);
  else
    gather_kernel<1><<<grid, THREADS, 0, st>>>(t, x, o, rows, cols);
  return (int)cudaGetLastError();
}

const char* gather_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
