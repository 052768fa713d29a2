// SSD (Mamba-2) intra-chunk pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_chunk (body
// `_kernel`): for every chunk of cl steps and every head,
//
//   y[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * xdt_j     (intra)
//   S     = sum_j xdt_j (x) B_j * exp(cum_end - cum_j)              (summary)
//
// with cum the prefix sum of the log-decay la over the chunk, all the math
// in fp32, y written in xdt's dtype and S (the chunk's state from zero
// inflow) in fp32.  The inter-chunk recurrence stays in PyTorch
// (models/lm/modules._ssd_chunked), as it stays in JAX in the reference.
//
// Design.  One CTA of 256 threads per (batch x chunk, block of BH heads).
// B and C have no head dim, so the CTA builds G = C . B^T (cl x cl) once in
// shared memory and reuses it for its BH heads: B is staged whole, C in
// tiles of NT state columns (what lets mamba2's cl = 128, n = 128 fit the
// 227 KB a block may use).  Per head it stages xdt's (cl, p) slice and la,
// takes cum as a warp-level prefix sum in shared memory, and then
//   * y: each thread owns one row i and p / (256 / CLM) columns in
//     registers and sums j = 0..i of G[i][j] * exp(cum_i - cum_j) * xdt_j.
//     Stopping at j = i is the reference's upper triangle masked in the
//     exponent at -1e30: exp(-1e30 - .) is exactly 0 in fp32, so those
//     terms add nothing;
//   * S: each thread owns (p, n) entries and sums over the chunk's j.
// A chunk shorter than the template's CLM (the chunk shrink of
// `_ssd_chunked` picks any divisor of l) is masked: rows past cl stage as
// zeros and are never stored.  Offsets into global memory are 64-bit.
//
// What bounds it on this card.  Per chunk and head the work is about
// cl^2 * p FLOPs against (cl * p) inputs, 32 to 64 FLOPs per input
// element: compute bound on the fp32 CUDA cores, and limited below their
// 67 TFLOP/s by shared-memory reads and one expf per (i, j) pair.  The
// tensor-core path (the G and y products are matmul-shaped) is later work,
// as is a backward kernel: the autograd Function recomputes through the
// plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BH = 4;           // heads per CTA (sharing one G)
constexpr int NT = 32;          // state columns of C staged at a time
constexpr int PMAX = 64;        // largest head dim p
constexpr int NMAX = 128;       // largest state size n
constexpr int MAX_SMEM = 232448;

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

// CLM: the largest chunk this instance takes (64 or 128); cl <= CLM.
template <typename T, int CLM>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ xdt, const float* __restrict__ la,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 T* __restrict__ y, float* __restrict__ S, int cl, int H,
                 int P, int N) {
  constexpr int GQ = CLM * CLM / THREADS;   // G entries per thread
  constexpr int TPR = THREADS / CLM;        // threads per row of y
  constexpr int YQ = PMAX / TPR;            // y columns per thread
  extern __shared__ float smem[];
  float* Bs = smem;                          // [CLM][N + 1]
  float* Cs = Bs + CLM * (N + 1);            // [CLM][NT + 1]
  float* Gs = Cs + CLM * (NT + 1);           // [CLM][CLM + 1]
  float* Xs = Gs + CLM * (CLM + 1);          // [CLM][P]
  float* cum = Xs + CLM * P;                 // [CLM]
  float* W = cum + CLM;                      // [CLM] exp(cum_end - cum_j)

  const int tid = threadIdx.x;
  const int64_t bc = blockIdx.x;             // batch * n_chunks + chunk
  const int h0 = blockIdx.y * BH;
  const int64_t row0 = bc * cl;              // first row of the chunk in l
  const T* Bc = Bm + row0 * N;
  const T* Cc = Cm + row0 * N;

  for (int e = tid; e < CLM * N; e += THREADS) {
    const int j = e / N, n = e % N;
    Bs[j * (N + 1) + n] = j < cl ? to_f32(Bc[(int64_t)j * N + n]) : 0.f;
  }

  // G = C . B^T: this thread's entries are rows i0 + TPR*q of column gj
  const int gj = tid % CLM;
  const int i0 = tid / CLM;
  float g[GQ];
#pragma unroll
  for (int q = 0; q < GQ; ++q) g[q] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nt = N - n0 < NT ? N - n0 : NT;
    __syncthreads();    // Bs is staged / the previous C tile is consumed
    for (int e = tid; e < CLM * NT; e += THREADS) {
      const int i = e / NT, nn = e % NT;
      Cs[i * (NT + 1) + nn] =
          (i < cl && nn < nt) ? to_f32(Cc[(int64_t)i * N + n0 + nn]) : 0.f;
    }
    __syncthreads();
    for (int nn = 0; nn < nt; ++nn) {
      const float bv = Bs[gj * (N + 1) + n0 + nn];
#pragma unroll
      for (int q = 0; q < GQ; ++q)
        g[q] = fmaf(Cs[(i0 + TPR * q) * (NT + 1) + nn], bv, g[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < GQ; ++q) Gs[(i0 + TPR * q) * (CLM + 1) + gj] = g[q];

  const int yi = tid / TPR;                  // this thread's row of y
  const int yc = tid % TPR;                  // and first column
  for (int hh = 0; hh < BH; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
    __syncthreads();    // G is written / the previous head is consumed
    for (int e = tid; e < CLM * P; e += THREADS) {
      const int j = e / P, pp = e % P;
      Xs[e] = j < cl ? to_f32(xdt[((row0 + j) * H + h) * P + pp]) : 0.f;
    }
    for (int j = tid; j < CLM; j += THREADS)
      cum[j] = j < cl ? la[(row0 + j) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) {     // inclusive prefix sum of la over the chunk
      const int per = (cl + 31) / 32;
      const int start = tid * per;
      float run = 0.f;
      for (int u = 0; u < per; ++u) {
        const int j = start + u;
        if (j < cl) {
          run += cum[j];
          cum[j] = run;
        }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += t;
      }
      const float before = tot - run;
      for (int u = 0; u < per; ++u) {
        const int j = start + u;
        if (j < cl) cum[j] += before;
      }
    }
    __syncthreads();
    for (int j = tid; j < cl; j += THREADS) W[j] = expf(cum[cl - 1] - cum[j]);
    __syncthreads();

    if (yi < cl) {
      float acc[YQ];
#pragma unroll
      for (int q = 0; q < YQ; ++q) acc[q] = 0.f;
      const float ci = cum[yi];
      for (int j = 0; j <= yi; ++j) {
        const float w = Gs[yi * (CLM + 1) + j] * expf(ci - cum[j]);
#pragma unroll
        for (int q = 0; q < YQ; ++q) {
          const int pp = yc + TPR * q;
          if (pp < P) acc[q] = fmaf(w, Xs[j * P + pp], acc[q]);
        }
      }
      T* yr = y + ((row0 + yi) * H + h) * P;
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        const int pp = yc + TPR * q;
        if (pp < P) yr[pp] = from_f32<T>(acc[q]);
      }
    }

    float* Sh = S + (bc * H + h) * (int64_t)P * N;
    for (int e = tid; e < P * N; e += THREADS) {
      const int pp = e / N, n = e % N;
      float s = 0.f;
      for (int j = 0; j < cl; ++j)
        s = fmaf(Xs[j * P + pp] * W[j], Bs[j * (N + 1) + n], s);
      Sh[e] = s;
    }
  }
}

template <typename T, int CLM>
cudaError_t launch_cl(const void* xdt, const float* la, const void* B,
                      const void* C, void* y, float* S, int64_t bnc,
                      int64_t cl, int64_t h, int64_t p, int64_t n,
                      cudaStream_t stream) {
  const int64_t smem =
      (int64_t)(CLM * (n + 1) + CLM * (NT + 1) + CLM * (CLM + 1) + CLM * p +
                2 * CLM) *
      (int64_t)sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, CLM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t hblocks = (h + BH - 1) / BH;
  if (bnc > 0x7fffffffLL || hblocks > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bnc, (unsigned)hblocks);
  ssd_chunk_kernel<T, CLM><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(xdt), la, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), S, (int)cl, (int)h,
      (int)p, (int)n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xdt, const float* la, const void* B,
                   const void* C, void* y, float* S, int64_t bnc, int64_t cl,
                   int64_t h, int64_t p, int64_t n, cudaStream_t stream) {
  if (cl <= 64)
    return launch_cl<T, 64>(xdt, la, B, C, y, S, bnc, cl, h, p, n, stream);
  return launch_cl<T, 128>(xdt, la, B, C, y, S, bnc, cl, h, p, n, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of xdt, B, C and y); la and S are
// float32.  xdt (b, l, h, p), la (b, l, h), B and C (b, l, n), y (b, l, h,
// p) and S (b, l / cl, h, p, n) are contiguous device buffers; bnc =
// b * l / cl.  Takes cl <= 128, p <= 64, n <= 128.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_chunk(const void* xdt, const void* la, const void* B,
                               const void* C, void* y, void* S, int dtype,
                               int64_t bnc, int64_t cl, int64_t h, int64_t p,
                               int64_t n, void* stream) {
  if (bnc < 1 || cl < 1 || cl > 128 || h < 1 || p < 1 || p > PMAX ||
      n < 1 || n > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* laf = static_cast<const float*>(la);
  float* Sf = static_cast<float*>(S);
  if (dtype == 0)
    return (int)launch<float>(xdt, laf, B, C, y, Sf, bnc, cl, h, p, n, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(xdt, laf, B, C, y, Sf, bnc, cl, h, p,
                                      n, st);
  return (int)cudaErrorInvalidValue;
}
