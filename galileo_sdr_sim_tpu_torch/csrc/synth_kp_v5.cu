// Factorized (K, p) Galileo E1 synthesis for NVIDIA Hopper (sm_90a), in
// two kernels launched one after the other on the caller's stream.
//
// Replaces the Pallas TPU kernel `_kernel_v5` of
// galileo_sdr_sim_tpu/ops/synth_kp_pallas.py in six instantiations of
// `synth_kp_v5_kernel<CBOC, GAIN, F32>`: sine-BOC or CBOC(6,1,1/11)
// (`cboc=True`, :171-175 and :294-304), without or with per-channel gain
// (`use_gain=True`, :307-311), and, without gain, the f32 emit
// (`emit="f32"`, :342-344).  Its main loop is the TPU kernel's
// K-vectorised one (`vec_kt=True`, :180-259), which gives the values of
// the default per-row loop bit for bit.  Same math and op order as
// _kernel_v5: the per-(channel, p) prologue (chip geometry, 5-tap select
// from the pre-resampled window table, code-period carry planes, carrier
// p-factor), then for every row K the sum over channels, in ascending
// order, of m * cis(fc_k*K) * cis(p), in float32, times 250, truncated
// toward zero, and I/Q packed into one int32 word (I low 16 bits, Q
// high).  m = chip_b*d - chip_c*s, or under CBOC
// (chip_b*wb)*d - (chip_c*wc)*s with wb, wc = alpha +- beta*tau; times
// gain[c] under GAIN.
//
// One store serves emit="i32pack" and emit="int16" (:337-341): on the
// GPU the I/Q int16 pair written as one little-endian 32-bit word IS the
// interleaved int16 layout.  Under F32 the store writes 250*acc_i,
// 250*acc_q untruncated as one float2 per sample, (B, n_k*1300, 2)
// float32: the accumulator the sat-sharded mesh path all-reduces before
// truncation (galileo_sdr_sim_tpu/parallel/mesh.py:154-156).  Every op
// before the store is shared, so its truncation is bit-equal to the
// packed store.
//
// What bounds it on an H100: per B=8 block it writes 8.3 MB (int32) and
// does ~0.54 GFLOP of float32 work at C = 8 channels (~32 flops per
// channel-sample), ~2.5 us of HBM traffic against ~8 us at the FP32
// peak; in practice the instructions issued bind (~35 a channel-row, of
// which 20 FP32), four warp instructions a clock per SM.
//
// Design:
// * kp_planes_kernel, the prologue (_kernel_v5 lines 124-170), runs once
//   per (epoch b, channel c, column p) and writes the planes to a scratch
//   the wrapper allocates: psi, w8, cos p, sin p (one float4), the chip
//   words of the 8 rows (two uint4) and the bits word; and once per
//   (b, c, K) the K factor cis(2*pi*frac(fc_k*K)) (a float2).  At B = 8,
//   C = 8 that is 4.8 MB, which stays in L2 for the main kernel.
// * synth_kp_v5_kernel, one block per (p tile of 128 columns, epoch b,
//   chunk of k_chunk K rows), one thread per column p, copies its tile of
//   planes and its K factors into shared memory with coalesced loads and
//   runs the main loop from shared memory only, storing coalesced along
//   p.  It computes no sin/cos and reads no strided byte, so the wrapper
//   cuts K as finely as it needs to fill the SMs: k_chunk follows B
//   (8 at B = 1: 11 x 25 = 275 blocks; 40 at B = 8: 440).
// * The main loop (the TPU's v6 schedule): the block's rows in groups of
//   eight, one kap (K = 8*kap + rho), eight I and eight Q accumulators in
//   registers; the channels ascending in the outer loop; each channel's
//   planes and scalars read once per kap; the symbol selects d_lo, d_df,
//   s_lo, s_df (which depend on kap and w8 only) once per kap.
// * No type conversion in the main loop: every value a conversion gave
//   is a small exact integer in float32 (taps in {-1, 0, 1}, bits,
//   symbols, K < 2^24, delta and j6), built instead by a byte permute
//   under the exponent of 2^23, a select, a float row counter, or the
//   lowest mantissa bit of x + 1.5*2^23.  The inexact operations keep
//   _kernel_v5's expressions and order (t_kp, the carrier product, the
//   accumulation, the CBOC weights, the gain), so the output is the same
//   bits as with the conversions (tests/data/torch_kp_digests.json).
//   Only the floorf of each chip edge (FRND) stays.
// * Chip words hold a0, a1 - a0 of the data and the pilot code as biased
//   bytes; the bits word holds b0 (bits 0..7), b1 - b0 (bits 8..15) and
//   parity(gb) (bit 16).  CBOC: tau = (-1)^(parity(gb) + parity(K) +
//   delta + j6), and (alpha, beta) are kernel arguments.
// * No tensor cores: the channel sum has a per-(c, K, p) factor m, so it
//   is no matrix product, and TF32 would not keep the bits.  No TMA: a
//   block's plane tile is a few KB to tens of KB, which plain coalesced
//   loads move.
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
constexpr int P_TILES = (P_GRID + P_TILE - 1) / P_TILE;
constexpr int P_PAD = P_TILES * P_TILE;  // columns of a plane in the scratch
constexpr float AMP = 250.0f;
constexpr float NPER = 8184.0f;

// the planes in the scratch, each (b, c) in turn over P_PAD columns
// (columns 1300.. hold zeros), then the K factors over n_k rows
struct Planes {
  float4* plf;     // [B][C][P_PAD]     psi, w8, cos p, sin p
  uint4* chip;     // [B][C][2][P_PAD]  chip words of rows 4h .. 4h+3
  uint32_t* bits;  // [B][C][P_PAD]     b0 bits 0..7, b1 - b0 bits 8..15,
                   //                   parity(gb) bit 16
  float2* cisk;    // [B][C][n_k]       cos, sin of the K factor
};

__host__ __device__ inline size_t planes_bytes(int B, int C, int n_k) {
  return (size_t)B * C * ((size_t)P_PAD * (sizeof(float4) + 2 * sizeof(uint4) + sizeof(uint32_t)) +
                          (size_t)n_k * sizeof(float2));
}

__host__ __device__ inline Planes carve_planes(unsigned char* base, int B, int C) {
  Planes q;
  const size_t bc = (size_t)B * C * P_PAD;
  q.plf = reinterpret_cast<float4*>(base);
  q.chip = reinterpret_cast<uint4*>(q.plf + bc);
  q.bits = reinterpret_cast<uint32_t*>(q.chip + 2 * bc);
  q.cisk = reinterpret_cast<float2*>(q.bits + bc);
  return q;
}

// a block's shared memory: its tile of the planes and K factors
struct Smem {
  float4* plf;     // [C][P_TILE]
  uint4* chip;     // [C][2][P_TILE]
  uint32_t* bits;  // [C][P_TILE]
  float2* cisk;    // [C][k_chunk]
  float4* scal;    // [C] mu, symbol word, pilot word (as bits), gain
};

__host__ __device__ inline size_t smem_bytes(int C, int k_chunk) {
  return (size_t)C * P_TILE * (sizeof(float4) + 2 * sizeof(uint4) + sizeof(uint32_t)) +
         (size_t)C * k_chunk * sizeof(float2) + (size_t)C * sizeof(float4);
}

__device__ inline Smem carve(unsigned char* base, int C, int k_chunk) {
  Smem s;
  s.plf = reinterpret_cast<float4*>(base);
  s.chip = reinterpret_cast<uint4*>(s.plf + C * P_TILE);
  s.bits = reinterpret_cast<uint32_t*>(s.chip + 2 * C * P_TILE);
  s.cisk = reinterpret_cast<float2*>(s.bits + C * P_TILE);  // 16-byte aligned
  s.scal = reinterpret_cast<float4*>(s.cisk + C * k_chunk);  // k_chunk % 8 == 0
  return s;
}

// +-1 symbol of bit `bit` of `word`: 1 - 2*bit exactly, by a select
__device__ __forceinline__ float pm1(uint32_t word, int bit) {
  return ((word >> bit) & 1u) ? -1.0f : 1.0f;
}

// 0.0f or 1.0f, bit `bit` of `word`, by a select
__device__ __forceinline__ float bit01(uint32_t word, int bit) {
  return ((word >> bit) & 1u) ? 1.0f : 0.0f;
}

// chip words hold four values v in [-2, 2] as bytes v + CHIP_BIAS
constexpr int CHIP_BIAS = 2;
constexpr float MAGIC23 = 8388608.0f;  // 2^23

__host__ __device__ constexpr uint32_t chip_byte(int v) { return (uint32_t)(v + CHIP_BIAS); }

// byte BYTE of chip word w as the float v: PRMT puts the byte under the
// exponent of 2^23 (0x4B000000), where the float spacing is 1, giving
// 2^23 + v + CHIP_BIAS exactly; the subtraction is exact
template <int BYTE>
__device__ __forceinline__ float chip_val(uint32_t w) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | BYTE)) -
         (MAGIC23 + (float)CHIP_BIAS);
}

// parity of an integer-valued float x with |x| < 2^22: x + 1.5*2^23
// lies in [2^23, 2^24), where the floats are the integers, so the sum is
// exact and its lowest mantissa bit is x's parity (1.5*2^23 is even)
__device__ __forceinline__ uint32_t parity(float x) {
  return (uint32_t)__float_as_int(x + 1.5f * MAGIC23) & 1u;
}

// the store of one sample: 250*acc truncated toward zero and packed
// (I low 16 bits, Q high), or under F32 the untruncated float2
template <bool F32>
__device__ inline void store_sample(void* out, size_t at, float acc_i, float acc_q) {
  if (F32) {
    static_cast<float2*>(out)[at] = make_float2(AMP * acc_i, AMP * acc_q);
  } else {
    const int ii = (int)truncf(AMP * acc_i);
    const int qq = (int)truncf(AMP * acc_q);
    static_cast<int32_t*>(out)[at] =
        (int32_t)(((uint32_t)ii & 0xFFFFu) | ((uint32_t)qq << 16));
  }
}

// The prologue (_kernel_v5 lines 124-170): one block per (p tile, epoch
// b, channel c), one thread per column p, which also computes the K
// factor of row K = p.
__global__ void __launch_bounds__(P_TILE) kp_planes_kernel(
    const float* __restrict__ cp0, const float* __restrict__ two_a,
    const float* __restrict__ mu, const float* __restrict__ g0,
    const int* __restrict__ o, const float* __restrict__ r,
    const float* __restrict__ carr0, const float* __restrict__ fc,
    const float* __restrict__ fc_k, const int8_t* __restrict__ vpack_rs,
    unsigned char* __restrict__ planes, int B, int C, int n_k, int t_rs) {
  const Planes q = carve_planes(planes, B, C);
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int bc = b * C + c;
  const int p = blockIdx.x * P_TILE + threadIdx.x;
  const size_t at = (size_t)bc * P_PAD + p;
  const float two_pi = (float)6.283185307179586;  // float32(2*pi)
  const float inv_nper = 1.0f / NPER;
  const float s_ratio = (float)(1023.0 / 1300.0);

  // K-factor table: cis(2*pi*frac(fc_k * K))
  for (int K = p; K < n_k; K += P_PAD) {
    float ph = fc_k[bc] * (float)K;
    ph = ph - floorf(ph);
    const float ang = two_pi * ph;
    q.cisk[(size_t)bc * n_k + K] = make_float2(cosf(ang), sinf(ang));
  }
  if (p >= P_GRID) {
    q.plf[at] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    q.chip[((size_t)bc * 2) * P_PAD + p] = make_uint4(0u, 0u, 0u, 0u);
    q.chip[((size_t)bc * 2 + 1) * P_PAD + p] = make_uint4(0u, 0u, 0u, 0u);
    q.bits[at] = 0u;
    return;
  }
  const float pp = (float)p;
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
  q.plf[at] = make_float4(psi, w8, cosf(ang_p), sinf(ang_p));

  // 5-tap select: rows j*32 .. j*32+31 of column o + p, j = e2 + 2
  int8_t v[W_PACK];
  const int j = (int)e2 + 2;
  if (j >= 0 && j < J_RS) {
    const int8_t* src = vpack_rs + ((size_t)c * W_RS + (size_t)j * W_PACK) * t_rs + o[bc] + p;
#pragma unroll
    for (int k = 0; k < W_PACK; ++k) v[k] = src[(size_t)k * t_rs];
  } else {
#pragma unroll
    for (int k = 0; k < W_PACK; ++k) v[k] = 0;
  }
  uint32_t words[ROWS];
  uint32_t bw = 0;
#pragma unroll
  for (int rho = 0; rho < ROWS; ++rho) {
    const int a0b = v[rho], a0c = v[16 + rho];
    words[rho] = chip_byte(a0b) | chip_byte(v[8 + rho] - a0b) << 8 | chip_byte(a0c) << 16 |
                 chip_byte(v[24 + rho] - a0c) << 24;
    // b1 >= b0 for every gbm (gbm + 1 >= gbm in float32), so b1 - b0 is
    // 0 or 1: one bit
    const float thr = (float)COLS * ((float)ROWS - (float)rho);
    const uint32_t b0 = gbm >= thr ? 1u : 0u;
    const uint32_t b1 = gbm + 1.0f >= thr ? 1u : 0u;
    bw |= b0 << rho;
    bw |= (b1 - b0) << (8 + rho);
  }
  const float pgb = gb - 2.0f * floorf(gb * 0.5f);  // exact: gb is an integer
  bw |= (pgb != 0.0f ? 1u : 0u) << 16;
  q.chip[((size_t)bc * 2) * P_PAD + p] = make_uint4(words[0], words[1], words[2], words[3]);
  q.chip[((size_t)bc * 2 + 1) * P_PAD + p] = make_uint4(words[4], words[5], words[6], words[7]);
  q.bits[at] = bw;
}

template <bool CBOC, bool GAIN, bool F32>
__device__ __forceinline__ void main_loop(const Smem& s, void* __restrict__ out, int tid,
                                          int b, int p, int C, int n_k, int k_chunk,
                                          int k_begin, int k_end, float w_plus,
                                          float w_minus) {
  // main loop (_kernel_v5 lines 180-259, the per-element ops of lines
  // 260-336): k_begin and k_end are multiples of 8 (k_chunk and n_k are).
  // K0 in float: K < 2^24, so k0f + rho is (float)(K0 + rho) exactly
  float k0f = (float)k_begin;
  for (int K0 = k_begin; K0 < k_end; K0 += ROWS, k0f += (float)ROWS) {
    const int kap = K0 >> 3;
    float acc_i[ROWS], acc_q[ROWS];
#pragma unroll
    for (int rho = 0; rho < ROWS; ++rho) acc_i[rho] = acc_q[rho] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float4 f = s.plf[c * P_TILE + tid];
      const uint32_t bw = s.bits[c * P_TILE + tid];
      const uint4 ch0 = s.chip[(c * 2) * P_TILE + tid];
      const uint4 ch1 = s.chip[(c * 2 + 1) * P_TILE + tid];
      const uint32_t words[ROWS] = {ch0.x, ch0.y, ch0.z, ch0.w, ch1.x, ch1.y, ch1.z, ch1.w};
      const float4 sc = s.scal[c];
      const float mu_c = sc.x;
      const uint32_t wd = __float_as_uint(sc.y) >> kap;
      const uint32_t wp = __float_as_uint(sc.z) >> kap;
      const float gain_c = sc.w;
      const uint32_t pgb = (bw >> 16) & 1u;
      const float d0 = pm1(wd, 0), d1 = pm1(wd, 1), d2 = pm1(wd, 2);
      const float s0 = pm1(wp, 0), s1 = pm1(wp, 1), s2 = pm1(wp, 2);
      const float w8 = f.y;
      const float d_lo = d0 + w8 * (d1 - d0);
      const float d_df = (d1 + w8 * (d2 - d1)) - d_lo;
      const float s_lo = s0 + w8 * (s1 - s0);
      const float s_df = (s1 + w8 * (s2 - s1)) - s_lo;
      // the K factors of the eight rows, two to a float4
      const float4* cisk4 = reinterpret_cast<const float4*>(s.cisk + c * k_chunk + (K0 - k_begin));
      float4 ck4[ROWS / 2];
#pragma unroll
      for (int h = 0; h < ROWS / 2; ++h) ck4[h] = cisk4[h];
#pragma unroll
      for (int rho = 0; rho < ROWS; ++rho) {
        const float k8 = k0f + (float)rho;
        const uint32_t ch = words[rho];
        const float t_kp = f.x + mu_c * k8;
        const float delta = floorf(t_kp);
        // a1 - a0 is stored: the same exact value _kernel_v5 computes
        const float chip_b = chip_val<0>(ch) + delta * chip_val<1>(ch);
        const float chip_c = chip_val<2>(ch) + delta * chip_val<3>(ch);
        // b1 - b0 is stored (0 or 1: see the prologue)
        const float bsel = bit01(bw, rho) + delta * bit01(bw, 8 + rho);
        const float d_val = d_lo + bsel * d_df;
        const float s_val = s_lo + bsel * s_df;
        float m;
        if (CBOC) {
          const float frac = t_kp - delta;
          const float j6 = floorf(6.0f * frac);
          // parity(gb) + parity(K) + delta + j6: delta + j6 is exact
          const bool tau_pos = (parity(delta + j6) ^ pgb ^ (uint32_t)(rho & 1)) == 0u;
          const float wb = tau_pos ? w_plus : w_minus;
          const float wc = tau_pos ? w_minus : w_plus;
          m = (chip_b * wb) * d_val - (chip_c * wc) * s_val;
        } else {
          m = chip_b * d_val - chip_c * s_val;
        }
        if (GAIN) m = m * gain_c;
        const float4 q4 = ck4[rho / 2];
        const float2 ck = (rho & 1) ? make_float2(q4.z, q4.w) : make_float2(q4.x, q4.y);
        const float cis_r = ck.x * f.z - ck.y * f.w;
        const float cis_i = ck.x * f.w + ck.y * f.z;
        acc_i[rho] = acc_i[rho] + m * cis_r;
        acc_q[rho] = acc_q[rho] + m * cis_i;
      }
    }
#pragma unroll
    for (int rho = 0; rho < ROWS; ++rho)
      store_sample<F32>(out, ((size_t)b * n_k + K0 + rho) * P_GRID + p, acc_i[rho], acc_q[rho]);
  }
}

template <bool CBOC, bool GAIN, bool F32>
__global__ void __launch_bounds__(P_TILE) synth_kp_v5_kernel(
    const float* __restrict__ mu, const int* __restrict__ sym_bits,
    const int* __restrict__ pil_bits, const float* __restrict__ chan_gain,
    const unsigned char* __restrict__ planes, void* __restrict__ out, float alpha,
    float beta, int B, int C, int n_k, int k_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, C, k_chunk);
  const Planes q = carve_planes(const_cast<unsigned char*>(planes), B, C);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P_TILE;
  const int p = p0 + tid;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(n_k, k_begin + k_chunk);

  // the block's tile of the planes, coalesced along p
  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    s.plf[c * P_TILE + tid] = q.plf[bc * P_PAD + p];
    s.chip[(c * 2) * P_TILE + tid] = q.chip[(bc * 2) * P_PAD + p];
    s.chip[(c * 2 + 1) * P_TILE + tid] = q.chip[(bc * 2 + 1) * P_PAD + p];
    s.bits[c * P_TILE + tid] = q.bits[bc * P_PAD + p];
  }
  for (int i = tid; i < C * k_chunk; i += P_TILE) {
    const int c = i / k_chunk;
    const int K = k_begin + i % k_chunk;
    s.cisk[i] = K < n_k ? q.cisk[((size_t)b * C + c) * n_k + K] : make_float2(0.0f, 0.0f);
  }
  for (int c = tid; c < C; c += P_TILE) {
    const int bc = b * C + c;
    s.scal[c] = make_float4(mu[bc], __int_as_float(sym_bits[bc]), __int_as_float(pil_bits[bc]),
                            GAIN ? chan_gain[bc] : 1.0f);
  }
  __syncthreads();
  if (p >= P_GRID) return;

  // CBOC weights: alpha + beta*tau at tau = +1 and at tau = -1
  const float w_plus = alpha + beta;
  const float w_minus = alpha - beta;

  main_loop<CBOC, GAIN, F32>(s, out, tid, b, p, C, n_k, k_chunk, k_begin, k_end, w_plus,
                             w_minus);
}

template <bool CBOC, bool GAIN, bool F32>
int launch(const void* const* ops, const void* planes, void* out, float alpha, float beta,
           int B, int C, int n_k, int k_chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k_chunk);
  cudaError_t err = cudaFuncSetAttribute(synth_kp_v5_kernel<CBOC, GAIN, F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P_TILES, B, (n_k + k_chunk - 1) / k_chunk);
  synth_kp_v5_kernel<CBOC, GAIN, F32><<<grid, P_TILE, smem, stream>>>(
      static_cast<const float*>(ops[0]), static_cast<const int*>(ops[1]),
      static_cast<const int*>(ops[2]), static_cast<const float*>(ops[3]),
      static_cast<const unsigned char*>(planes), out, alpha, beta, B, C, n_k, k_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a main-kernel launch with C channels and k_chunk
// rows needs, and the bytes of the planes scratch of B epochs.
size_t synth_kp_v5_smem_bytes(int C, int k_chunk) { return smem_bytes(C, k_chunk); }
size_t synth_kp_v5_planes_bytes(int B, int C, int n_k) { return planes_bytes(B, C, n_k); }

// Launch the prologue on `stream`: fill `planes` (synth_kp_v5_planes_bytes
// bytes, 16-byte aligned) from the (B, C) operands and the (C, 160, t_rs)
// window table.  Returns cudaGetLastError() (0 = launched).
int synth_kp_v5_planes_launch(const void* cp0, const void* two_a, const void* mu,
                              const void* g0, const void* o, const void* r, const void* carr0,
                              const void* fc, const void* fc_k, const void* vpack_rs,
                              void* planes, int B, int C, int n_k, int t_rs, void* stream) {
  const dim3 grid(P_TILES, B, C);
  kp_planes_kernel<<<grid, P_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cp0), static_cast<const float*>(two_a),
      static_cast<const float*>(mu), static_cast<const float*>(g0), static_cast<const int*>(o),
      static_cast<const float*>(r), static_cast<const float*>(carr0),
      static_cast<const float*>(fc), static_cast<const float*>(fc_k),
      static_cast<const int8_t*>(vpack_rs), static_cast<unsigned char*>(planes), B, C, n_k, t_rs);
  return (int)cudaGetLastError();
}

// Launch the main kernel on `stream`, after the prologue filled `planes`
// on the same stream; returns cudaGetLastError() (0 = launched).  The
// CBOC instantiation runs when `cboc` is non-zero (alpha, beta are then
// its weights), the GAIN one when `chan_gain` is not null; `f32` selects
// the float32 store (out is then (B, n_k*1300) float2), which has no
// GAIN instantiation.  k_chunk must be a multiple of 8 (the main loop
// takes rows in groups of eight); else, or for f32 with gain,
// cudaErrorInvalidValue.
int synth_kp_v5_launch(const void* mu, const void* sym_bits, const void* pil_bits,
                       const void* chan_gain, const void* planes, void* out, float alpha,
                       float beta, int cboc, int f32, int B, int C, int n_k, int k_chunk,
                       void* stream) {
  const void* ops[4] = {mu, sym_bits, pil_bits, chan_gain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gain = chan_gain != nullptr;
  if (k_chunk <= 0 || k_chunk % ROWS != 0 || (f32 && gain)) return (int)cudaErrorInvalidValue;
  if (f32 && cboc) return launch<true, false, true>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
  if (f32) return launch<false, false, true>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
  if (cboc && gain) return launch<true, true, false>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
  if (cboc) return launch<true, false, false>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
  if (gain) return launch<false, true, false>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
  return launch<false, false, false>(ops, planes, out, alpha, beta, B, C, n_k, k_chunk, st);
}

const char* synth_kp_v5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
