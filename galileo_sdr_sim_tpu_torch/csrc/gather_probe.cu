// In-tile gather for NVIDIA Hopper (sm_90a): out = take_along_axis(tab,
// idx, axis) on (rows, cols) int32 tables, axis 0 or 1.
//
// Replaces the Pallas TPU kernel `main.probe.k` of
// tools/probe_pallas_gather.py:23-27, a capability probe: on the TPU it
// asks whether Mosaic lowers an in-VMEM `jnp.take_along_axis` (a
// `tpu.dynamic_gather`) at shapes (8..128, 128..8192): a gather inside a
// tile that is resident in fast memory.
//
// Design, the same question put to this card: a block brings the slice
// of the table its outputs can reach into shared memory with 16-byte
// asynchronous copies (cp.async), reads its indices as one int4 a thread
// while those copies are in flight, and gathers from shared memory; it
// writes its outputs as one int4 a thread.  Along axis 1 the slice is
// the whole row (at most 32 KB at the probe's shapes), shared by the
// blocks that each gather 1024 outputs of the row; along axis 0 it is
// all rows of a 32-column tile, shared by the blocks that each gather 32
// rows of the tile.  The table read and the index read are independent,
// so a block waits for one trip to memory, not for two in a row.
//
// Of the two designs this one was kept.  The other, one indexed load from
// global memory a thread, took 0.01961 ms for the seven probes where this
// one takes 0.01832 (NVIDIA H100 80GB HBM3, 700.00 W, both in turns in one
// process, ops/kp_ab.py; empty launches of the same grids 0.0119): equal
// on the five small shapes, which sit at the launch floor either way,
// 4% behind where the indices reach few columns of a long row or run
// along axis 0, and 19% ahead on (16, 8192) with indices over the whole
// row, the one probe whose time is not the launch's.
//
// What bounds it on an H100: it does no arithmetic; it moves 8 bytes an
// element (idx read, out written) plus each table element the indices
// reach, read once: at most 1.5 MB at the largest probe shape (16, 8192),
// about 0.5 us at 3.35 TB/s, so at the probe's sizes the launch itself
// is most of the time (ops/measure.floor_ms).
//
// An index outside [0, n) (n the table's length along `axis`) gives 0
// instead of a read outside the table, as the plain version does; the
// probe draws its indices in range.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                    // int32 values of an int4
constexpr int OUT_TILE = THREADS * VEC;   // outputs a block gathers
constexpr int AX0_COLS = 32;              // columns of an axis-0 tile
constexpr int AX0_VECS = AX0_COLS / VEC;  // int4 of one tile row
constexpr int AX0_ROWS = OUT_TILE / AX0_COLS;  // output rows of an axis-0 block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// Axis 1: block (x, r) stages row r and gathers its outputs
// [x*OUT_TILE, (x+1)*OUT_TILE) of that row.  cols % 4 == 0.
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int rows, int cols) {
  extern __shared__ int4 tile4[];  // the row
  const int r = blockIdx.y;
  const size_t row0 = (size_t)r * cols;
  const int4* row4 = reinterpret_cast<const int4*>(tab + row0);
  for (int i = threadIdx.x; i < cols / VEC; i += THREADS) cp_async16(&tile4[i], &row4[i]);
  const int v = blockIdx.x * THREADS + threadIdx.x;  // this thread's int4 of the row
  const bool live = v < cols / VEC;
  int4 j = make_int4(0, 0, 0, 0);
  if (live) j = reinterpret_cast<const int4*>(idx + row0)[v];
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  const int32_t* tile = reinterpret_cast<const int32_t*>(tile4);
  int4 o;
  o.x = (unsigned)j.x < (unsigned)cols ? tile[j.x] : 0;
  o.y = (unsigned)j.y < (unsigned)cols ? tile[j.y] : 0;
  o.z = (unsigned)j.z < (unsigned)cols ? tile[j.z] : 0;
  o.w = (unsigned)j.w < (unsigned)cols ? tile[j.w] : 0;
  reinterpret_cast<int4*>(out + row0)[v] = o;
}

// Axis 0: block (x, y) stages all rows of columns [x*32, x*32 + 32) and
// gathers output rows [y*32, y*32 + 32) of those columns.  cols % 4 == 0.
__global__ void __launch_bounds__(THREADS) gather_cols_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int rows, int cols) {
  extern __shared__ int4 tile4[];  // [rows][AX0_VECS]
  const int c0 = blockIdx.x * AX0_COLS;
  for (int i = threadIdx.x; i < rows * AX0_VECS; i += THREADS) {
    const int rr = i / AX0_VECS, q = i % AX0_VECS;
    if (c0 + q * VEC < cols)
      cp_async16(&tile4[i], tab + (size_t)rr * cols + c0 + q * VEC);
  }
  const int r = blockIdx.y * AX0_ROWS + threadIdx.x / AX0_VECS;
  const int c = c0 + (threadIdx.x % AX0_VECS) * VEC;  // first of this thread's four columns
  const bool live = r < rows && c < cols;
  const size_t at = (size_t)r * cols + c;
  int4 j = make_int4(0, 0, 0, 0);
  if (live) j = *reinterpret_cast<const int4*>(idx + at);
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  const int32_t* tile = reinterpret_cast<const int32_t*>(tile4) + (c - c0);
  int4 o;
  o.x = (unsigned)j.x < (unsigned)rows ? tile[j.x * AX0_COLS] : 0;
  o.y = (unsigned)j.y < (unsigned)rows ? tile[j.y * AX0_COLS + 1] : 0;
  o.z = (unsigned)j.z < (unsigned)rows ? tile[j.z * AX0_COLS + 2] : 0;
  o.w = (unsigned)j.w < (unsigned)rows ? tile[j.w * AX0_COLS + 3] : 0;
  *reinterpret_cast<int4*>(out + at) = o;
}

__host__ __device__ inline size_t tile_bytes(int rows, int cols, int axis) {
  return (size_t)(axis == 0 ? (size_t)rows * AX0_COLS : (size_t)cols) * sizeof(int32_t);
}

// Raise the dynamic shared memory `kernel` may use on the current device
// to `smem` bytes, once per size and device (slot 0 or 1 names the kernel).
cudaError_t grant_smem(const void* kernel, int slot, size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> granted[2][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev >= 0 && dev < MAX_DEVICES;
  if (kept && granted[slot][dev].load(std::memory_order_relaxed) >= (int)smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && kept) granted[slot][dev].store((int)smem, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block stages, and the launch geometry: out4 =
// grid x, y, z and the block size.
size_t gather_probe_tile_bytes(int rows, int cols, int axis) { return tile_bytes(rows, cols, axis); }

void gather_probe_geometry(int rows, int cols, int axis, int* out4) {
  out4[0] = axis == 0 ? (cols + AX0_COLS - 1) / AX0_COLS : (cols + OUT_TILE - 1) / OUT_TILE;
  out4[1] = axis == 0 ? (rows + AX0_ROWS - 1) / AX0_ROWS : rows;
  out4[2] = 1;
  out4[3] = THREADS;
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an axis other than 0 or 1, an empty shape, or
// a column count that is not a multiple of 4 (rows are moved 16 bytes at
// a time; the table, the indices and the output must be 16-byte aligned).
int gather_probe_launch(const void* tab, const void* idx, void* out, int rows, int cols,
                        int axis, void* stream) {
  if ((axis != 0 && axis != 1) || rows <= 0 || cols <= 0 || cols % VEC != 0)
    return (int)cudaErrorInvalidValue;
  int g[4];
  gather_probe_geometry(rows, cols, axis, g);
  const size_t smem = tile_bytes(rows, cols, axis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tab);
  const int32_t* x = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  const void* kernel = axis == 0 ? reinterpret_cast<const void*>(gather_cols_kernel)
                                 : reinterpret_cast<const void*>(gather_rows_kernel);
  if (smem > 48 * 1024) {
    const cudaError_t err = grant_smem(kernel, axis, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (axis == 0)
    gather_cols_kernel<<<dim3(g[0], g[1]), THREADS, smem, st>>>(t, x, o, rows, cols);
  else
    gather_rows_kernel<<<dim3(g[0], g[1]), THREADS, smem, st>>>(t, x, o, rows, cols);
  return (int)cudaGetLastError();
}

const char* gather_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
