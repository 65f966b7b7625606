// Factorized (K, p) Galileo E1 synthesis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel_v5` of
// galileo_sdr_sim_tpu/ops/synth_kp_pallas.py, branch sine-BOC,
// emit="i32pack", no per-channel gain.  Same math and op order: the
// per-(channel, p) prologue of _kernel_v5 (chip geometry, 5-tap select
// from the pre-resampled window table, code-period carry planes, carrier
// p-factor), then for every row K the sum over channels, in ascending
// order, of (chip_b*d - chip_c*s) * cis(fc_k*K) * cis(p), in float32,
// times 250, truncated toward zero, and I/Q packed into one int32 word
// (I low 16 bits, Q high).
//
// What bounds it on an H100: per B=8 block it writes 8 x 200 x 1300 int32
// = 8.3 MB and does about 0.5 GFLOP of float32 work at C = 8 channels
// (~25 flops per channel-sample), i.e. ~2.5 us of HBM traffic against
// ~8 us of FP32 arithmetic at the card's 67 TFLOP/s.  It is compute-bound, and
// at B=8 it launches only 8 x 11 x 5 = 440 blocks of 128 threads.
//
// Design:
// * one block per (p tile of 128 columns, epoch b, chunk of K rows),
//   one thread per column p; each block computes its own per-(c, p)
//   planes into shared memory (this replaces the TPU's scalar prefetch
//   and the prologue-at-program-0 schedule; blocks run in no order);
// * the chip planes are 4 bytes per (c, row, p): a0b, a1b, a0c, a1c; the
//   carry planes b0/b1 are bits of one word; psi, w8, cos p, sin p are
//   one float4 per (c, p);
// * the K-factor cis(fc_k*K) of the block's K rows is a shared table;
// * the main loop reads shared memory only and stores coalesced along p.
// The TPU layout machinery (1408-lane padding, 128-aligned window DMA
// plus lane rotate, SMEM budget guard, kap_tile) has no counterpart.
//
// Precision: precise sinf/cosf, no fast-math.  Whether `a*b + c` is
// contracted into FMA is chosen by the build (-fmad); see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P_GRID = 1300;
constexpr int ROWS = 8;
constexpr int COLS = 1023;
constexpr int W_PACK = 32;
constexpr int J_RS = 5;
constexpr int W_RS = J_RS * W_PACK;
constexpr int P_TILE = 128;
constexpr float AMP = 250.0f;
constexpr float NPER = 8184.0f;

struct Smem {
  float4* plf;      // [C][P_TILE]      psi, w8, cos p, sin p
  char4* chip;      // [C][ROWS][P_TILE] a0b, a1b, a0c, a1c of row rho
  uint32_t* bits;   // [C][P_TILE]      b0 bits 0..7, b1 bits 8..15
  float2* cisk;     // [C][k_chunk]     cos, sin of the K factor
  float* mu;        // [C]
  int* sym;         // [C]
  int* pil;         // [C]
};

__host__ __device__ inline size_t smem_bytes(int C, int k_chunk) {
  return (size_t)C * P_TILE * (sizeof(float4) + ROWS * sizeof(char4) + sizeof(uint32_t)) +
         (size_t)C * k_chunk * sizeof(float2) + (size_t)C * 3 * sizeof(float);
}

__device__ inline Smem carve(unsigned char* base, int C, int k_chunk) {
  Smem s;
  s.plf = reinterpret_cast<float4*>(base);
  base += (size_t)C * P_TILE * sizeof(float4);
  s.chip = reinterpret_cast<char4*>(base);
  base += (size_t)C * ROWS * P_TILE * sizeof(char4);
  s.bits = reinterpret_cast<uint32_t*>(base);
  base += (size_t)C * P_TILE * sizeof(uint32_t);
  s.cisk = reinterpret_cast<float2*>(base);
  base += (size_t)C * k_chunk * sizeof(float2);
  s.mu = reinterpret_cast<float*>(base);
  s.sym = reinterpret_cast<int*>(s.mu + C);
  s.pil = s.sym + C;
  return s;
}

__device__ inline float pm1(int word, int bit) {
  return 1.0f - 2.0f * (float)((word >> bit) & 1);
}

__global__ void __launch_bounds__(P_TILE) synth_kp_v5_kernel(
    const float* __restrict__ cp0, const float* __restrict__ two_a,
    const float* __restrict__ mu, const float* __restrict__ g0,
    const int* __restrict__ o, const float* __restrict__ r,
    const float* __restrict__ carr0, const float* __restrict__ fc,
    const float* __restrict__ fc_k, const int* __restrict__ sym_bits,
    const int* __restrict__ pil_bits, const int8_t* __restrict__ vpack_rs,
    int32_t* __restrict__ out, int C, int n_k, int t_rs, int k_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, C, k_chunk);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.x * P_TILE + tid;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(n_k, k_begin + k_chunk);
  const float two_pi = (float)6.283185307179586;  // float32(2*pi)
  const float inv_nper = 1.0f / NPER;
  const float s_ratio = (float)(1023.0 / 1300.0);

  for (int c = tid; c < C; c += P_TILE) {
    s.mu[c] = mu[b * C + c];
    s.sym[c] = sym_bits[b * C + c];
    s.pil[c] = pil_bits[b * C + c];
  }
  // K-factor table: cis(2*pi*frac(fc_k * K)) for this block's rows
  for (int i = tid; i < C * k_chunk; i += P_TILE) {
    const int c = i / k_chunk;
    const int K = k_begin + i % k_chunk;
    float ph = fc_k[b * C + c] * (float)K;
    ph = ph - floorf(ph);
    const float ang = two_pi * ph;
    s.cisk[i] = make_float2(cosf(ang), sinf(ang));
  }

  // prologue: per-(c, p) planes (_kernel_v5 lines 124-170)
  if (p < P_GRID) {
    const float pp = (float)p;
    for (int c = 0; c < C; ++c) {
      const int bc = b * C + c;
      const float mu_c = mu[bc];
      const float phi = 2.0f * cp0[bc] + two_a[bc] * pp;
      const float gb = floorf(phi) + (mu_c < 0.0f ? -1.0f : 0.0f);
      const float psi = phi - gb;
      const float gbm = gb - NPER * floorf(gb * inv_nper);
      const float w8 = gb >= NPER ? 1.0f : 0.0f;
      const float s_p = floorf(pp * s_ratio);
      const float m_p = (float)COLS * pp - (float)P_GRID * s_p;
      const float kap_p = m_p + r[bc] >= (float)P_GRID ? 1.0f : 0.0f;
      const float e2 = (gb - g0[bc]) - s_p - kap_p;
      float ph_p = carr0[bc] + fc[bc] * pp;
      ph_p = ph_p - floorf(ph_p);
      const float ang_p = two_pi * ph_p;
      s.plf[c * P_TILE + tid] = make_float4(psi, w8, cosf(ang_p), sinf(ang_p));

      // 5-tap select: rows j*32 .. j*32+31 of column o + p, j = e2 + 2
      int8_t v[W_PACK];
      const int j = (int)e2 + 2;
      if (j >= 0 && j < J_RS) {
        const int8_t* src =
            vpack_rs + ((size_t)c * W_RS + (size_t)j * W_PACK) * t_rs + o[bc] + p;
#pragma unroll
        for (int k = 0; k < W_PACK; ++k) v[k] = src[(size_t)k * t_rs];
      } else {
#pragma unroll
        for (int k = 0; k < W_PACK; ++k) v[k] = 0;
      }
      uint32_t bw = 0;
#pragma unroll
      for (int rho = 0; rho < ROWS; ++rho) {
        s.chip[(c * ROWS + rho) * P_TILE + tid] =
            make_char4(v[rho], v[8 + rho], v[16 + rho], v[24 + rho]);
        const float thr = (float)COLS * ((float)ROWS - (float)rho);
        bw |= (gbm >= thr ? 1u : 0u) << rho;
        bw |= (gbm + 1.0f >= thr ? 1u : 0u) << (8 + rho);
      }
      s.bits[c * P_TILE + tid] = bw;
    }
  }
  __syncthreads();
  if (p >= P_GRID) return;

  // main loop (_kernel_v5 lines 260-336)
  for (int K = k_begin; K < k_end; ++K) {
    const int kap = K >> 3;
    const int rho = K & 7;
    const float k8 = (float)K;
    float acc_i = 0.0f;
    float acc_q = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float4 f = s.plf[c * P_TILE + tid];
      const char4 ch = s.chip[(c * ROWS + rho) * P_TILE + tid];
      const uint32_t bw = s.bits[c * P_TILE + tid];
      const float t_kp = f.x + s.mu[c] * k8;
      const float delta = floorf(t_kp);
      const float a0b = ch.x, a1b = ch.y, a0c = ch.z, a1c = ch.w;
      const float chip_b = a0b + delta * (a1b - a0b);
      const float chip_c = a0c + delta * (a1c - a0c);
      const float b0 = (float)((bw >> rho) & 1u);
      const float b1 = (float)((bw >> (8 + rho)) & 1u);
      const float bsel = b0 + delta * (b1 - b0);
      const int wd = s.sym[c];
      const int wp = s.pil[c];
      const float d0 = pm1(wd, kap), d1 = pm1(wd, kap + 1), d2 = pm1(wd, kap + 2);
      const float s0 = pm1(wp, kap), s1 = pm1(wp, kap + 1), s2 = pm1(wp, kap + 2);
      const float w8 = f.y;
      const float d_lo = d0 + w8 * (d1 - d0);
      const float d_df = (d1 + w8 * (d2 - d1)) - d_lo;
      const float s_lo = s0 + w8 * (s1 - s0);
      const float s_df = (s1 + w8 * (s2 - s1)) - s_lo;
      const float d_val = d_lo + bsel * d_df;
      const float s_val = s_lo + bsel * s_df;
      const float m = chip_b * d_val - chip_c * s_val;
      const float2 ck = s.cisk[c * k_chunk + (K - k_begin)];
      const float cis_r = ck.x * f.z - ck.y * f.w;
      const float cis_i = ck.x * f.w + ck.y * f.z;
      acc_i = acc_i + m * cis_r;
      acc_q = acc_q + m * cis_i;
    }
    const int ii = (int)truncf(AMP * acc_i);
    const int qq = (int)truncf(AMP * acc_q);
    out[((size_t)b * n_k + K) * P_GRID + p] =
        (int32_t)(((uint32_t)ii & 0xFFFFu) | ((uint32_t)qq << 16));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch with C channels and k_chunk rows needs.
size_t synth_kp_v5_smem_bytes(int C, int k_chunk) { return smem_bytes(C, k_chunk); }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int synth_kp_v5_launch(const void* cp0, const void* two_a, const void* mu,
                       const void* g0, const void* o, const void* r,
                       const void* carr0, const void* fc, const void* fc_k,
                       const void* sym_bits, const void* pil_bits,
                       const void* vpack_rs, void* out, int B, int C, int n_k,
                       int t_rs, int k_chunk, void* stream) {
  const size_t smem = smem_bytes(C, k_chunk);
  cudaError_t err = cudaFuncSetAttribute(
      synth_kp_v5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P_GRID + P_TILE - 1) / P_TILE, B, (n_k + k_chunk - 1) / k_chunk);
  synth_kp_v5_kernel<<<grid, P_TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cp0), static_cast<const float*>(two_a),
      static_cast<const float*>(mu), static_cast<const float*>(g0),
      static_cast<const int*>(o), static_cast<const float*>(r),
      static_cast<const float*>(carr0), static_cast<const float*>(fc),
      static_cast<const float*>(fc_k), static_cast<const int*>(sym_bits),
      static_cast<const int*>(pil_bits), static_cast<const int8_t*>(vpack_rs),
      static_cast<int32_t*>(out), C, n_k, t_rs, k_chunk);
  return (int)cudaGetLastError();
}

const char* synth_kp_v5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
