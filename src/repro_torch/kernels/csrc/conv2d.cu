// Implicit-GEMM VALID convolution for Hopper (sm_90a), NHWC x HWIO -> NHWC.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d.py::conv2d
// (body `_kernel`): the same function -- a VALID conv with one stride for
// both spatial dims, products summed in fp32 over the KH*KW taps and the
// C input channels, the result written once in x's dtype.  Padding and the
// halo rows are the caller's job.
//
// GEMM view.  M = N*H_out*W_out output pixels, flattened in y's own row
// order; N = F filters; K = KH*KW*C, walked tap by tap, each tap in slices
// of BK channels.  A CTA computes 128 (or, bf16, 256) consecutive pixels
// (any samples, any rows) x a 64- or 128-filter tile.  Each thread
// resolves its pixels' input offsets once, before the K loop; inside it,
// a K step only adds a tap's offset, with no division.  The wrapper's plan
// (kernels/conv2d.py::plan) zero-pads C to a multiple of 8 (bf16) or 4
// (f32) and the weight's F likewise, so every copy is 16 aligned bytes;
// zero channels and filters add exact zeros.  Out-of-range pixels and
// channels past C are zero-filled by the copy, and stores stop at the real
// F and at M.
//
// What bounds it.  At mesh1k's shapes (batch 2, 414 GFLOP per forward over
// about 1 GB of activations) both paths are bound by operations: 6.18 ms
// per forward at the 67 TFLOP/s of the fp32 CUDA cores, 0.46 ms at the 989
// TFLOP/s of the bf16 tensor cores.  What the design does about it:
//
// - bf16: tensor cores through `wgmma` (m64nNk16, fp32 accumulators in
//   registers), 256 threads = 2 warpgroups.  K steps are one tap x 64
//   channels (128 bytes); a 4-stage ring in shared memory is filled by
//   16-byte `cp.async` copies into the 128-byte-swizzled layouts the wgmma
//   descriptors name: A K-major (a pixel's channels contiguous, as NHWC
//   has them), B MN-major (a channel's filters contiguous, as HWIO has
//   them; wgmma transposes it).  The ring runs two K steps ahead, and one
//   wgmma group stays in flight while the next step's copies are issued.
//   Every K step's tiles come from L2, whose bandwidth, not the tensor
//   cores, bounds this path at these shapes; so where 256-pixel tiles
//   still fill the card (with a 128-filter tile), each warpgroup runs two
//   m64 blocks and every B tile serves twice the pixels.
// - f32: full FP32 FMAs on CUDA cores (no TF32).  Each thread holds an
//   8-pixel x 8-filter register tile (256 threads for a 128-filter tile,
//   128 for a 64-filter one); K steps are one tap x 16 channels (8 where C
//   is not a multiple of 16) through a 3-stage cp.async ring.  A is staged
//   [pixel][channel] and each thread reads 4 channels of one pixel per
//   float4 (broadcast across its 8-thread phase), B [channel][filter] with
//   the 8 threads of a phase on 8 consecutive float4s, so both are
//   conflict-free: 16 FMAs per shared-memory read.
// - Split-K: where the tiles fill less than one wave of the 132 SMs
//   (conv5_x, conv6_x at batch 2) the plan splits the K steps over
//   blockIdx.y; each split writes fp32 partials to a workspace and
//   `repro_conv2d_splitk_reduce` sums them in split order into x's dtype.
//   No atomics: the result is deterministic.
//
// Tile order.  The Pallas kernel's `interior_first` visits its interior
// row blocks before the two that read the halo rows (the §IV-A schedule
// inside the kernel).  Here a CTA's pixels may span rows and samples, so
// the wrapper passes the pixel tiles as a permutation (`tile_order`):
// every tile holding an output row that reads the first or last SAME-pad
// rows of its sample comes after all the others.  The same tiles compute
// the same sums, so the output is bit-identical to the plain order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels per CTA (bf16: 128 or 256)
constexpr int F32_STAGES = 3;
constexpr int THREADS = 256;   // bf16 path
constexpr int BF_BK = 64;      // channels per K step, bf16 (128 bytes)
constexpr int BF_STAGES = 4;

// Shapes and the K walk, as the host computes them once per launch.
struct Geom {
  int64_t H, W, C, F, Fp;      // C and Fp as padded; F the real filters
  int64_t Wo, HoWo, M;         // M = N * H_out * W_out
  int KH, KW, S;
  int f_tiles;                 // ceil(F / BN)
  int csteps, ksteps;          // K steps per tap, in all
  int per_split;               // K steps per split
  const int32_t* order;        // pixel tile of each grid position, or null
};

// the pixel tile a CTA computes: blockIdx.x walks the pixel tiles in the
// wrapper's `tile_order` (interior first: the tiles reading the halo rows
// last), or in order where none is given; the filter tile is the fastest
__device__ __forceinline__ int64_t pixel_tile(const Geom& g) {
  const int pos = blockIdx.x / g.f_tiles;
  return g.order ? g.order[pos] : pos;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// offset in x of the first tap's first channel of output pixel m
__device__ __forceinline__ int64_t pixel_offset(const Geom& g, int64_t m) {
  const int64_t n = m / g.HoWo;
  const int64_t r = m - n * g.HoWo;
  const int64_t oh = r / g.Wo;
  const int64_t ow = r - oh * g.Wo;
  return ((n * g.H + oh * g.S) * g.W + ow * g.S) * g.C;
}

// The K walk: tap by tap, BK channels at a time.  x_off is the current
// step's offset from a pixel's first tap, w_off its offset in w.
template <int BK>
struct KWalk {
  int64_t x_off, w_off;
  int c0, kj;

  __device__ __forceinline__ void start(const Geom& g, int ks) {
    const int tap = ks / g.csteps;
    const int ki = tap / g.KW;
    c0 = (ks - tap * g.csteps) * BK;
    kj = tap - ki * g.KW;
    x_off = ((int64_t)ki * g.W + kj) * g.C + c0;
    w_off = ((int64_t)tap * g.C + c0) * g.Fp;
  }

  __device__ __forceinline__ void next(const Geom& g) {
    if (c0 + BK < g.C) {
      c0 += BK;
      x_off += BK;
      w_off += (int64_t)BK * g.Fp;
      return;
    }
    // channel 0 of the next tap: along the row, or the next row's first
    x_off += g.C - c0;
    w_off += (g.C - c0) * g.Fp;
    c0 = 0;
    if (++kj == g.KW) {
      kj = 0;
      x_off += (g.W - g.KW) * g.C;
    }
  }
};

// ------------------------------------------------------------ f32 path --

// 8 x 8 outputs per thread
__host__ __device__ constexpr int f32_threads(int bn) { return 2 * bn; }
__host__ __device__ constexpr int f32_smem_bytes(int bn, int bk) {
  return F32_STAGES * (BM * bk + bk * bn) * 4;
}

template <int BN, int BK>
__global__ void __launch_bounds__(f32_threads(BN))
repro_conv2d_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        const Geom g) {
  constexpr int ST = F32_STAGES, NT = f32_threads(BN);
  constexpr int A_PER = BM * BK / 4 / NT;     // 16-byte A copies per thread
  constexpr int B_PER = BK / 8;               // ... and B copies
  constexpr int A_ROWS = NT / (BK / 4);       // A rows apart per copy
  constexpr int WN = BN / 64;                 // warps across the filters
  constexpr uint32_t A_STAGE = BM * BK * 4, B_STAGE = BK * BN * 4;
  extern __shared__ float4 smem_f4[];
  float* As = reinterpret_cast<float*>(smem_f4);   // [ST][BM][BK]
  float* Bs = As + ST * BM * BK;                    // [ST][BK][BN]

  const int tid = threadIdx.x;
  const int64_t m0 = pixel_tile(g) * BM;
  const int64_t f0 = (int64_t)(blockIdx.x % g.f_tiles) * BN;

  // per K step this thread copies 4 channels of A_PER pixels (rows
  // tid/(BK/4) + r*A_ROWS) and 4 filters of B_PER channel rows (tid/(BN/4)
  // + 8r); a pixel's input offset is resolved here, once
  const int ac = (tid % (BK / 4)) * 4;
  int64_t a_base[A_PER];
  bool a_pix[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const int64_t m = m0 + tid / (BK / 4) + r * A_ROWS;
    a_pix[r] = m < g.M;
    a_base[r] = a_pix[r] ? pixel_offset(g, m) + ac : 0;
  }
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  const bool b_col = f0 + bc < g.Fp;
  const int64_t b_base = (int64_t)br * g.Fp + f0 + bc;
  const uint32_t a_dst = smem_u32(As + (tid / (BK / 4)) * BK + ac);
  const uint32_t b_dst = smem_u32(Bs + br * BN + bc);

  const int ks0 = blockIdx.y * g.per_split;
  const int nk = max(0, min(g.ksteps, ks0 + g.per_split) - ks0);
  KWalk<BK> kw;
  kw.start(g, ks0);

  auto load = [&](int stage) {
    const bool a_c = kw.c0 + ac < g.C;
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const bool ok = a_pix[r] && a_c;
      cp_async16(a_dst + stage * A_STAGE + r * A_ROWS * BK * 4,
                 x + (ok ? a_base[r] + kw.x_off : 0), ok);
    }
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const bool ok = b_col && kw.c0 + br + 8 * r < g.C;
      cp_async16(b_dst + stage * B_STAGE + r * 8 * BN * 4,
                 w + (ok ? b_base + 8 * r * g.Fp + kw.w_off : 0), ok);
    }
    kw.next(g);
  };

  // thread tile: pixels tm*8 .. tm*8+7 x filters tn*4 .. tn*4+3 and
  // BN/2 + tn*4 .. +3.  The 8 threads of a quarter warp share tm (one
  // broadcast A address) and read 8 consecutive float4s of B.
  const int warp = tid >> 5, lane = tid & 31;
  const int tm = (warp / WN) * 4 + (lane >> 3);
  const int tn = (warp % WN) * 8 + (lane & 7);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<ST - 2>();   // this thread's copies of step `it` landed
    __syncthreads();           // everyone's; and step it-1's reads are done
    if (it + ST - 1 < nk) load((it + ST - 1) % ST);
    cp_async_commit();
    const float* at = As + (it % ST) * BM * BK + tm * 8 * BK;
    const float* bt = Bs + (it % ST) * BK * BN + tn * 4;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      // 4 channels of each of the thread's 8 pixels
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(at + i * BK + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bt + (kq + kk) * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bt + (kq + kk) * BN + BN / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* o = out + (int64_t)blockIdx.y * g.M * g.F;
  const bool vec = (g.F & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + tm * 8 + i;
    if (m >= g.M) break;
    float* row = o + m * g.F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t f = f0 + h * (BN / 2) + tn * 4;
      if (vec && f + 3 < g.F) {
        *reinterpret_cast<float4*>(row + f) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (f + j < g.F) row[f + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// ----------------------------------------------------------- bf16 path --

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D (64 x N, fp32) += A (64 x 16, K-major) . B (16 x N, MN-major)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n64(d, da, db);
}

// two neighbouring outputs of one pixel row, masked at the real F
__device__ __forceinline__ void store2(float* p, int64_t f, int64_t F,
                                       float a, float b) {
  if (f + 1 < F && (F & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (f < F) p[0] = a;
    if (f + 1 < F) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, int64_t f,
                                       int64_t F, float a, float b) {
  if (f + 1 < F && (F & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(a, b);   // .x = a (lower address)
  } else {
    if (f < F) p[0] = __float2bfloat16(a);
    if (f + 1 < F) p[1] = __float2bfloat16(b);
  }
}

__host__ __device__ constexpr int bf16_smem_bytes(int tm, int bn) {
  return BF_STAGES * (tm + bn) * BF_BK * 2 + 1024;   // + alignment
}

// TM = 128 or 256 pixels: each warpgroup runs TM/128 m64 blocks
template <int TM, int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
repro_conv2d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         OutT* __restrict__ out, const Geom g) {
  constexpr int BK = BF_BK, ST = BF_STAGES, MB = TM / 128;
  constexpr int A_BYTES = TM * BK * 2, B_BYTES = BK * BN * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int AR = 4 * MB;                   // A copies per thread
  constexpr int CPR = BN / 8;                  // 16-byte chunks per B row
  constexpr int B_ROWS = THREADS / CPR;        // B rows per pass: 16 or 32
  constexpr int B_PASSES = BK / B_ROWS;        // 4 or 2
  constexpr int NR = BN / 2;                   // accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms (8 rows x 128 bytes) must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int64_t m0 = pixel_tile(g) * TM;
  const int64_t f0 = (int64_t)(blockIdx.x % g.f_tiles) * BN;

  // A: pixel rows tid/8 + 32r (r < AR), chunk tid%8 = channels
  // 8*(tid%8)..; stored K-major, row r at r*128 bytes, chunk c at
  // (c ^ (r % 8)) * 16
  const int arow = tid >> 3, ach = tid & 7;
  int64_t a_base[AR];
  bool a_pix[AR];
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    const int64_t m = m0 + arow + 32 * r;
    a_pix[r] = m < g.M;
    a_base[r] = a_pix[r] ? pixel_offset(g, m) + ach * 8 : 0;
  }
  const uint32_t a_dst = arow * 128 + ((ach ^ (arow & 7)) << 4);
  // B: channel rows tid/CPR + B_ROWS*p, chunk tid%CPR = filters
  // 8*(tid%CPR)..; stored MN-major in 64-filter atoms of 64 rows x 128
  // bytes (8 KB apart), row k at k*128, chunk c at (c ^ (k % 8)) * 16
  const int brow = tid / CPR, bch = tid % CPR;
  const bool b_col = f0 + bch * 8 < g.Fp;
  const int64_t b_base = (int64_t)brow * g.Fp + f0 + bch * 8;
  const uint32_t b_dst = A_BYTES + (bch >> 3) * (BK * 128) + brow * 128 +
                         (((bch & 7) ^ (brow & 7)) << 4);

  const int ks0 = blockIdx.y * g.per_split;
  const int nk = max(0, min(g.ksteps, ks0 + g.per_split) - ks0);
  KWalk<BK> kw;
  kw.start(g, ks0);

  auto load = [&](int stage) {
    const uint32_t s = base + stage * STAGE;
    const bool c_ok = kw.c0 + ach * 8 < g.C;
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      const bool ok = a_pix[r] && c_ok;
      cp_async16(s + a_dst + r * 32 * 128,
                 x + (ok ? a_base[r] + kw.x_off : 0), ok);
    }
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const bool ok = b_col && kw.c0 + brow + p * B_ROWS < g.C;
      cp_async16(s + b_dst + p * B_ROWS * 128,
                 w + (ok ? b_base + (int64_t)p * B_ROWS * g.Fp + kw.w_off
                         : 0),
                 ok);
    }
    kw.next(g);
  };

  float acc[MB][NR];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[b][i] = 0.f;

  const int wg = tid >> 7;   // warpgroup: pixels wg*64*MB .. +64*MB-1
#pragma unroll
  for (int s = 0; s < ST - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<ST - 3>();   // this thread's copies of step `it` landed
    fence_proxy_async();       // ... and are visible to wgmma
    // everyone's copies landed, and every warpgroup has retired the wgmma
    // group of step it-2, whose stage the next load overwrites
    __syncthreads();
    if (it + ST - 2 < nk) load((it + ST - 2) % ST);
    cp_async_commit();
    const uint32_t s = base + (it % ST) * STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: a block of 64 rows, 16 channels (32 bytes) further per kk;
      //    8-row groups 1024 bytes apart
      // B: 16 channel rows (2048 bytes) further per kk; 8-row groups 1024
      //    bytes apart, 64-filter atoms BK*128 bytes apart
      const uint64_t db = sw128_desc(s + A_BYTES + kk * 2048, BK * 128, 1024);
#pragma unroll
      for (int b = 0; b < MB; ++b)
        wgmma_tile<BN>(
            acc[b], sw128_desc(s + (wg * MB + b) * 64 * 128 + kk * 32, 16,
                               1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(acc[b][i])::"memory");

  // accumulator layout of m64nN: register i of lane l in warp q of the
  // warpgroup is row q*16 + l/4 + 8*((i/2)%2), column (i/4)*8 + (l%4)*2 +
  // i%2
  const int lane = tid & 31, q = (tid >> 5) & 3;
  OutT* o = out + (int64_t)blockIdx.y * g.M * g.F;
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    const int64_t row0 = m0 + (wg * MB + b) * 64 + q * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NR; i += 2) {
      const int64_t m = row0 + ((i >> 1) & 1) * 8;
      const int64_t f = f0 + (i >> 2) * 8 + (lane & 3) * 2;
      if (m < g.M && f < g.F)
        store2(o + m * g.F + f, f, g.F, acc[b][i], acc[b][i + 1]);
    }
  }
}

// ------------------------------------------------------------- split-K --

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// y[i] = sum over the splits of ws[z][i], in split order
template <typename T>
__global__ void repro_conv2d_splitk_reduce(const float* __restrict__ ws,
                                           T* __restrict__ y, int64_t mf,
                                           int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mf;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mf + i];
    put(y + i, s);
  }
}

// ---------------------------------------------------------------- host --

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BN, int BK>
cudaError_t launch_f32(const void* x, const void* w, void* out,
                       const Geom& g, dim3 grid, cudaStream_t st) {
  constexpr int smem = f32_smem_bytes(BN, BK);
  auto k = repro_conv2d_f32_kernel<BN, BK>;
  cudaError_t e;
  if (smem > 48 * 1024 && (e = allow_smem(k, smem)) != cudaSuccess) return e;
  k<<<grid, f32_threads(BN), smem, st>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w),
                                         static_cast<float*>(out), g);
  return cudaGetLastError();
}

template <int TM, int BN>
cudaError_t launch_bf16(const void* x, const void* w, void* y, void* ws,
                        const Geom& g, dim3 grid, cudaStream_t st) {
  constexpr int smem = bf16_smem_bytes(TM, BN);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  cudaError_t e;
  if (grid.y > 1) {
    auto k = repro_conv2d_bf16_kernel<TM, BN, float>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
    k<<<grid, THREADS, smem, st>>>(xb, wb, static_cast<float*>(ws), g);
  } else {
    auto k = repro_conv2d_bf16_kernel<TM, BN, __nv_bfloat16>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
    k<<<grid, THREADS, smem, st>>>(xb, wb, static_cast<__nv_bfloat16*>(y),
                                   g);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (n, h, wd, c), w (kh, kw, c, fp)
// and y (n, h_out, w_out, f) are contiguous device buffers of that type,
// with c and fp zero-padded to a multiple of 4 (f32) or 8 (bf16) and
// fp >= f.  tile_m x tile_n is the output tile: 128 x 64 or 128 x 128,
// or 256 x 128 for bf16; tile_k the channels per K step (f32: 8 or 16;
// bf16: 64);
// with splits > 1, ws is an fp32 workspace of splits * n * h_out * w_out *
// f elements.  order is null, or a device array of the ceil(n * h_out *
// w_out / tile_m) pixel tiles in the order their CTAs are numbered (a
// permutation: every tile once).  Every launch goes on `stream`.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int repro_conv2d(const void* x, const void* w, void* y, void* ws,
                            int dtype, int64_t n, int64_t h, int64_t wd,
                            int64_t c, int64_t kh, int64_t kw, int64_t f,
                            int64_t fp, int64_t s, int64_t tile_m,
                            int64_t tile_n, int64_t tile_k, int64_t splits,
                            const void* order, void* stream) {
  const int64_t align = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n < 1 || c < 1 || f < 1 || fp < f ||
      s < 1 || kh < 1 || kw < 1 || h < kh || wd < kw || kh > 64 || kw > 64 ||
      s > 64 || c % align || fp % align || (tile_n != 64 && tile_n != 128) ||
      (dtype == 0 ? tile_k != 8 && tile_k != 16 : tile_k != BF_BK) ||
      (tile_m != BM && (dtype == 0 || tile_m != 2 * BM || tile_n != 128)) ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.H = h; g.W = wd; g.C = c; g.F = f; g.Fp = fp;
  g.KH = (int)kh; g.KW = (int)kw; g.S = (int)s;
  const int64_t h_out = (h - kh) / s + 1;
  g.Wo = (wd - kw) / s + 1;
  g.HoWo = h_out * g.Wo;
  g.M = n * g.HoWo;
  const int64_t csteps = (c + tile_k - 1) / tile_k;
  const int64_t ksteps = kh * kw * csteps;
  const int64_t f_tiles = (f + tile_n - 1) / tile_n;
  const int64_t tiles = (g.M + tile_m - 1) / tile_m * f_tiles;
  if (ksteps > 0x7fffffffLL || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  g.f_tiles = (int)f_tiles;
  g.csteps = (int)csteps;
  g.ksteps = (int)ksteps;
  g.per_split = (int)((ksteps + splits - 1) / splits);
  g.order = static_cast<const int32_t*>(order);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* out = splits > 1 ? ws : y;

  cudaError_t e;
  if (dtype == 0) {
    if (tile_n == 128)
      e = tile_k == 16 ? launch_f32<128, 16>(x, w, out, g, grid, st)
                       : launch_f32<128, 8>(x, w, out, g, grid, st);
    else
      e = tile_k == 16 ? launch_f32<64, 16>(x, w, out, g, grid, st)
                       : launch_f32<64, 8>(x, w, out, g, grid, st);
  } else {
    if (tile_m == 256)
      e = launch_bf16<256, 128>(x, w, y, ws, g, grid, st);
    else
      e = tile_n == 128 ? launch_bf16<128, 128>(x, w, y, ws, g, grid, st)
                        : launch_bf16<128, 64>(x, w, y, ws, g, grid, st);
  }
  if (e != cudaSuccess || splits == 1) return (int)e;

  const int64_t mf = g.M * f;
  const unsigned blocks = (unsigned)((mf + 255) / 256 < 132 * 16
                                         ? (mf + 255) / 256 : 132 * 16);
  if (dtype == 0)
    repro_conv2d_splitk_reduce<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(y), mf,
        (int)splits);
  else
    repro_conv2d_splitk_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), mf,
        (int)splits);
  return (int)cudaGetLastError();
}
