// Blocked online-softmax attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_kernel`): the same function -- q (B, Sq, Hq, D)
// against k/v (B, Sk, Hkv, D), GQA mapping q head hi to kv head hi // g,
// causal `qpos >= kpos` and window `qpos - kpos < window` masks with both
// positions counted from 0, masked logits at -1e30 (not -inf, so a fully
// masked tile never turns the running max into NaN), optional
// `softcap * tanh(s / softcap)`, the running max m, sum l and accumulator
// kept in fp32, l clamped at 1e-30, the output written once in q's dtype.
//
// Design.  One CTA of 256 threads per (64-query tile, q head, batch).  It
// reads q, k and v straight from their (B, S, H, D) layout (row stride
// H*D, head offset h*D): the TPU wrapper's transposes to (B, H, S, D) are
// not needed.  The query tile is staged once in shared memory as fp32,
// transposed (Qt[d][row]); the CTA then walks 64-key tiles from the first
// tile the window admits to the last one causality admits, staging K
// transposed (Kt[d][key]) and V as is (Vs[key][d]).  Each thread owns a 4x4
// block of the 64x64 score tile (rows ty + 16i, keys tx + 16j) and 4 rows x
// DP/16 columns of the output accumulator, all in registers; a row's 16
// threads share one half-warp, so the row max and row sum are shuffles.
// The probabilities go through shared memory (Ps) into the P.V product.
// A ragged Sq or Sk is masked, not tiled around: keys past Sk score -inf
// (they are not part of the function, so they add exactly 0 even to a
// row whose running max is still -1e30), rows past Sq are never stored.
// Offsets into global memory are 64-bit.
//
// What bounds it on this card.  Both products run on the fp32 CUDA cores
// (67 TFLOP/s peak on an H100 SXM) for f32 and bf16 inputs alike, and each
// FMA in the score loop costs a shared-memory read per 4x4 block row, so
// shared-memory bandwidth limits it well below that peak.  At hymba's
// shapes (D = 64) the work is compute bound: about 64 FLOPs per byte of
// q, k, v and o.  The tensor-core path (wgmma on bf16 tiles, at 989
// TFLOP/s), TMA staging and a pipelined K/V ring are later work.  So is a
// backward kernel: the autograd Function recomputes through the plain
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty picks rows, tx picks keys
constexpr int MAX_SMEM = 232448;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// DP: head dim rounded up to a multiple of 16 (the thread grid's width);
// columns d >= D are staged as zeros and never stored.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t Sq,
                 int64_t Sk, int Hq, int Hkv, int D, float scale,
                 float softcap, int causal, int64_t window) {
  extern __shared__ float smem[];
  float* Qt = smem;                        // [DP][BQ + 1]
  float* Kt = Qt + DP * (BQ + 1);          // [DP][BK + 1]
  float* Vs = Kt + DP * (BK + 1);          // [BK][DP]
  float* Ps = Vs + BK * DP;                // [BQ][BK + 1]
  constexpr int NJ = DP / 16;              // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t b = blockIdx.z;
  const int hq = blockIdx.y;
  const int hk = hq / (Hq / Hkv);
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t q_stride = (int64_t)Hq * D;   // one sequence step of q / o
  const int64_t k_stride = (int64_t)Hkv * D;  // one sequence step of k / v
  const T* qb = q + b * Sq * q_stride + (int64_t)hq * D;
  const T* kb = k + b * Sk * k_stride + (int64_t)hk * D;
  const T* vb = v + b * Sk * k_stride + (int64_t)hk * D;
  T* ob = o + b * Sq * q_stride + (int64_t)hq * D;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const int64_t qp = q0 + r;
    Qt[d * (BQ + 1) + r] =
        (qp < Sq && d < D) ? to_f32(qb[qp * q_stride + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // key tiles: from the first one the window admits for the tile's first
  // row to the last one causality admits for its last row
  const int64_t q_last = (q0 + BQ - 1 < Sq - 1) ? q0 + BQ - 1 : Sq - 1;
  int64_t k_lo = 0, k_hi = Sk - 1;
  if (causal && q_last < k_hi) k_hi = q_last;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int64_t t_lo = k_lo / BK;
  const int64_t t_hi = k_hi < k_lo ? t_lo - 1 : k_hi / BK;

  for (int64_t t = t_lo; t <= t_hi; ++t) {
    const int64_t k0 = t * BK;
    __syncthreads();    // the previous tile's Kt, Vs and Ps reads are done
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int c = e / DP, d = e % DP;
      const int64_t kp = k0 + c;
      const bool in = kp < Sk && d < D;
      Kt[d * (BK + 1) + c] = in ? to_f32(kb[kp * k_stride + d]) : 0.f;
      Vs[c * DP + d] = in ? to_f32(vb[kp * k_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (kp >= Sk) {
          x = -INFINITY;
        } else {
          bool keep = true;
          if (causal) keep = keep && qp >= kp;
          if (window > 0) keep = keep && (qp - kp) < window;
          if (!keep) x = NEG_BIG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[qp * q_stride + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      int64_t b, int64_t sq, int64_t sk, int64_t hq,
                      int64_t hkv, int64_t d, float scale, float softcap,
                      int causal, int64_t window, cudaStream_t stream) {
  const int64_t smem =
      (int64_t)(DP * (BQ + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1)) *
      (int64_t)sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t tiles_q = (sq + BQ - 1) / BQ;
  if (tiles_q > 0x7fffffffLL || hq > 65535 || b > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles_q, (unsigned)hq, (unsigned)b);
  flash_fwd_kernel<T, DP><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, (int)hq,
      (int)hkv, (int)d, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
                   int64_t d, float scale, float softcap, int causal,
                   int64_t window, cudaStream_t stream) {
  if (d <= 16)
    return launch_dp<T, 16>(q, k, v, o, b, sq, sk, hq, hkv, d, scale,
                            softcap, causal, window, stream);
  if (d <= 32)
    return launch_dp<T, 32>(q, k, v, o, b, sq, sk, hq, hkv, d, scale,
                            softcap, causal, window, stream);
  if (d <= 64)
    return launch_dp<T, 64>(q, k, v, o, b, sq, sk, hq, hkv, d, scale,
                            softcap, causal, window, stream);
  return launch_dp<T, 128>(q, k, v, o, b, sq, sk, hq, hkv, d, scale, softcap,
                           causal, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (b, sq, hq, d), k and v (b, sk, hkv,
// d) and o (b, sq, hq, d) are contiguous device buffers of that type.
// softcap <= 0 means none; window <= 0 means none.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int64_t b, int64_t sq, int64_t sk,
                                     int64_t hq, int64_t hkv, int64_t d,
                                     float scale, float softcap, int causal,
                                     int64_t window, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 ||
      d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, b, sq, sk, hq, hkv, d, scale,
                              softcap, causal, window, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, hq, hkv, d,
                                      scale, softcap, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
