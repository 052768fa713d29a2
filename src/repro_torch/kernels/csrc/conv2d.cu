// Implicit-GEMM VALID convolution for Hopper (sm_90a), NHWC x HWIO -> NHWC.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d.py::conv2d
// (body `_kernel`): the same function -- a VALID conv with one stride for
// both spatial dims, products summed in fp32 over the KH*KW taps and the
// C input channels, the result written once in x's dtype.  Padding and the
// halo rows are the caller's job.
//
// Design.  One CTA of 256 threads computes a TH x TW tile of output pixels
// of one sample for BF filters (grid: spatial tiles x filter tiles x N).
// It walks C in chunks of `cc` channels; for each chunk it stages, in
// shared memory and converted to fp32, the (TH-1)*S+KH by (TW-1)*S+KW input
// patch that feeds the tile and the (KH, KW, cc, BF) weight slice.  Each
// thread owns PX=8 neighbouring output pixels of one row times FX=4
// filters in registers and runs the KH*KW*cc multiply-adds on CUDA cores
// from shared memory, four channels per float4 read.  Partial tiles are
// masked: out-of-range input pixels, channels past C and filters past F
// stage as zeros, and stores past H_out, W_out or F are skipped, so C=18,
// F=1 and prime output extents need no special tiling.  Offsets into
// global memory are 64-bit.
//
// What bounds it on this card.  At the meshnet shapes the work is compute
// bound (hundreds of FLOPs per byte); this first version uses the fp32
// CUDA-core FMA path (67 TFLOP/s peak on an H100 SXM) for both f32 and
// bf16 inputs and is limited by shared-memory reads (about one 16-byte
// read per 4 FMAs per thread).  The tensor-core path (wgmma, at 989
// TFLOP/s in bf16), TMA staging and a multi-stage pipeline are left for a
// later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // output rows per tile
constexpr int TW = 16;       // output columns per tile
constexpr int BF = 64;       // filters per tile
constexpr int PX = 8;        // output pixels per thread (one row)
constexpr int FX = 4;        // filters per thread
constexpr int THREADS = (TH * TW / PX) * (BF / FX);   // 256
constexpr int MAX_SMEM = 232448;                     // 227 KB per block

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, int64_t H, int64_t W, int64_t C, int KH,
              int KW, int64_t F, int S, int64_t H_out, int64_t W_out,
              int tiles_w, int cc) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [KH*KW][cc][BF]
  float* xs = ws + KH * KW * cc * BF;            // [in_rows][in_cols][cc]
  const int in_rows = (TH - 1) * S + KH;
  const int in_cols = (TW - 1) * S + KW;

  const int tid = threadIdx.x;
  const int64_t n = blockIdx.z;
  const int64_t f0 = (int64_t)blockIdx.y * BF;
  const int64_t oh0 = (int64_t)(blockIdx.x / tiles_w) * TH;
  const int64_t ow0 = (int64_t)(blockIdx.x % tiles_w) * TW;
  const int64_t ih0 = oh0 * S;
  const int64_t iw0 = ow0 * S;

  const int fg = tid % (BF / FX);          // filter group
  const int pg = tid / (BF / FX);          // pixel group
  const int pr = pg / (TW / PX);           // output row in the tile
  const int pc = (pg % (TW / PX)) * PX;    // first output column

  float acc[PX][FX];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < FX; ++q) acc[p][q] = 0.f;

  const T* xn = x + n * H * W * C;
  const int taps = KH * KW;
  const int w_count = taps * cc * BF;
  const int x_count = in_rows * in_cols * cc;

  for (int64_t c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();   // the previous chunk's reads are done
    for (int e = tid; e < w_count; e += THREADS) {
      const int fi = e % BF;
      const int r = e / BF;
      const int ci = r % cc;
      const int tap = r / cc;
      const int64_t c = c0 + ci;
      const int64_t f = f0 + fi;
      ws[e] = (c < C && f < F) ? to_f32(w[((int64_t)tap * C + c) * F + f])
                               : 0.f;
    }
    for (int e = tid; e < x_count; e += THREADS) {
      const int ci = e % cc;
      const int r = e / cc;
      const int col = r % in_cols;
      const int row = r / in_cols;
      const int64_t ih = ih0 + row;
      const int64_t iw = iw0 + col;
      const int64_t c = c0 + ci;
      xs[e] = (ih < H && iw < W && c < C) ? to_f32(xn[(ih * W + iw) * C + c])
                                          : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < KH; ++i) {
      for (int j = 0; j < KW; ++j) {
        const float* wt = ws + (i * KW + j) * cc * BF + fg * FX;
        const float* xt = xs + ((pr * S + i) * in_cols + pc * S + j) * cc;
        for (int ci = 0; ci < cc; ci += 4) {
          const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * BF);
          const float4 w1 =
              *reinterpret_cast<const float4*>(wt + (ci + 1) * BF);
          const float4 w2 =
              *reinterpret_cast<const float4*>(wt + (ci + 2) * BF);
          const float4 w3 =
              *reinterpret_cast<const float4*>(wt + (ci + 3) * BF);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xt + p * S * cc + ci);
            acc[p][0] = fmaf(xv.x, w0.x, acc[p][0]);
            acc[p][1] = fmaf(xv.x, w0.y, acc[p][1]);
            acc[p][2] = fmaf(xv.x, w0.z, acc[p][2]);
            acc[p][3] = fmaf(xv.x, w0.w, acc[p][3]);
            acc[p][0] = fmaf(xv.y, w1.x, acc[p][0]);
            acc[p][1] = fmaf(xv.y, w1.y, acc[p][1]);
            acc[p][2] = fmaf(xv.y, w1.z, acc[p][2]);
            acc[p][3] = fmaf(xv.y, w1.w, acc[p][3]);
            acc[p][0] = fmaf(xv.z, w2.x, acc[p][0]);
            acc[p][1] = fmaf(xv.z, w2.y, acc[p][1]);
            acc[p][2] = fmaf(xv.z, w2.z, acc[p][2]);
            acc[p][3] = fmaf(xv.z, w2.w, acc[p][3]);
            acc[p][0] = fmaf(xv.w, w3.x, acc[p][0]);
            acc[p][1] = fmaf(xv.w, w3.y, acc[p][1]);
            acc[p][2] = fmaf(xv.w, w3.z, acc[p][2]);
            acc[p][3] = fmaf(xv.w, w3.w, acc[p][3]);
          }
        }
      }
    }
  }

  const int64_t oh = oh0 + pr;
  if (oh >= H_out) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int64_t ow = ow0 + pc + p;
    if (ow >= W_out) break;
    T* yp = y + ((n * H_out + oh) * W_out + ow) * F;
#pragma unroll
    for (int q = 0; q < FX; ++q) {
      const int64_t f = f0 + fg * FX + q;
      if (f < F) yp[f] = from_f32<T>(acc[p][q]);
    }
  }
}

int64_t smem_bytes(int kh, int kw, int s, int cc) {
  const int64_t in_rows = (TH - 1) * s + kh;
  const int64_t in_cols = (TW - 1) * s + kw;
  return ((int64_t)kh * kw * cc * BF + in_rows * in_cols * cc) *
         (int64_t)sizeof(float);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t n,
                   int64_t h, int64_t wd, int64_t c, int64_t kh, int64_t kw,
                   int64_t f, int64_t s, cudaStream_t stream) {
  const int64_t h_out = (h - kh) / s + 1;
  const int64_t w_out = (wd - kw) / s + 1;
  const int64_t tiles_h = (h_out + TH - 1) / TH;
  const int64_t tiles_w = (w_out + TW - 1) / TW;
  const int64_t tiles_f = (f + BF - 1) / BF;
  if (tiles_h * tiles_w > 0x7fffffffLL || tiles_f > 65535 || n > 65535)
    return cudaErrorInvalidConfiguration;
  // channel chunk: a multiple of 4 (float4 reads); 8 unless the staged
  // weight slice and patch do not fit, e.g. for very large kernels
  int cc = 8;
  int64_t smem = smem_bytes((int)kh, (int)kw, (int)s, cc);
  if (smem > MAX_SMEM) {
    cc = 4;
    smem = smem_bytes((int)kh, (int)kw, (int)s, cc);
  }
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(tiles_h * tiles_w), (unsigned)tiles_f,
                  (unsigned)n);
  conv2d_kernel<T><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      h, wd, c, (int)kh, (int)kw, f, (int)s, h_out, w_out, (int)tiles_w, cc);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (n, h, wd, c), w (kh, kw, c, f) and
// y (n, h_out, w_out, f) are contiguous device buffers of that type.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_conv2d(const void* x, const void* w, void* y, int dtype,
                            int64_t n, int64_t h, int64_t wd, int64_t c,
                            int64_t kh, int64_t kw, int64_t f, int64_t s,
                            void* stream) {
  if (n < 1 || c < 1 || f < 1 || s < 1 || kh < 1 || kw < 1 || h < kh ||
      wd < kw || kh > 64 || kw > 64 || s > 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, y, n, h, wd, c, kh, kw, f, s, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, y, n, h, wd, c, kh, kw, f, s,
                                      st);
  return (int)cudaErrorInvalidValue;
}
