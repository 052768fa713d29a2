// SSD (Mamba-2) intra-chunk pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_chunk (body
// `_kernel`): for every chunk of cl steps and every head,
//
//   y[i] = sum_{j<=i} M[i][j] xdt_j,  M[i][j] = (C_i . B_j) exp(cum_i - cum_j)
//   S    = sum_j xdt_j (x) B_j * w_j,  w_j = exp(cum_end - cum_j)
//
// with cum the prefix sum of the log-decay la over the chunk, all the math
// in fp32, y written once in xdt's dtype and S (the chunk's state from zero
// inflow) in fp32.  The recurrence over chunks stays in PyTorch
// (models/lm/modules.inter_chunk_states), as it stays in jnp in the
// reference.
//
// What bounds it.  At hymba-1.5b's shape (h 50, p 64, n 16, cl 64) a
// call reads xdt and writes y and S: 60 MB in f32, 33 MB in bf16, against
// 0.64 GFLOP, so bytes bound it (18 / 10 us at 3.35 TB/s).  At mamba2's
// (h 48, n 128, cl 128) the work is 2.5 GFLOP: operations bound it in f32
// on the CUDA cores (37 us at 67 TFLOP/s), bytes in bf16.
//
// Design of the first path (cl <= 128, p <= 64, n <= 128).  One CTA of
// 4 x CLM threads (CLM = 64 or 128, the chunk rounded up: 8 or 16 warps)
// per (batch x chunk, block of heads).
//   * B and C have no head dim: the CTA builds G = C . B^T once, only its
//     16 x 16 tiles on or below the diagonal, packed, and reuses it for its
//     heads (2 where G is cheap, n <= 32, else 4).
//   * Per head a 2-stage cp.async ring stages the next head's xdt slice
//     and la while this head computes; warp 0 takes cum and w.
//   * M = G o exp(cum_i - cum_j) is built by all threads with one exp per
//     (i, j, head), only on the tiles on or below the diagonal (those above
//     are zero), into shared memory: fp32 on the f32 path, a bf16 high and
//     low part on the bf16 path.
//   * y: each warp owns two 16-row tiles from both ends of the chunk (t and
//     CLM / 16 - 1 - t), so the triangle is shared out evenly, and one
//     quarter (16 columns) of p.  S: warps take blocks of (p, n).  y and S
//     follow each other without a barrier.
//   * f32 ("fma"): register-tiled FMAs, 2 rows x 4 columns of y a thread
//     (a float2 of M and a float4 of xdt per 8 FMAs) and 4 x 4 of S (a
//     float4 of xdt, w and a float4 of B per 16 FMAs; the chunk's steps
//     split over up to 4 lanes, summed by shuffles, where the blocks are
//     fewer than the threads).
//   * bf16 ("mma"): warp-level mma.sync.m16n8k16 with bf16 operands and
//     fp32 accumulators, operands by ldmatrix.  G's inputs are exact in
//     bf16.  y = M . xdt and S = (xdt o w)^T . B each have one fp32
//     operand; each is split into a bf16 high part and the bf16 rounding
//     of the rest, and both parts are multiplied by the exact bf16 xdt or
//     B.  That keeps the TPU kernel's fp32 arithmetic to about 2^-16 per
//     term, where rounding M to bf16 alone (as attention rounds P) would
//     lose 2^-8 of sum_j |M_ij xdt_j|.  xdt o w is scaled and split in
//     registers, on its way from ldmatrix to the product.  mma.sync, not
//     wgmma: the pass is bytes bound, and at a third of the tensor cores'
//     peak the 1.1 GFLOP of the split products take about 4 us; wgmma's
//     shared-memory descriptors, swizzle and proxy fences buy nothing.
//   * y leaves in 16-byte stores (bf16 through a per-warp staging tile).
// A chunk shorter than CLM, or one that is not a multiple of 16, is
// masked: rows past cl stage as zeros and are never stored.  That CTA
// holds the whole chunk's packed G, M and a head's xdt slice in shared
// memory, so it is built for cl <= 128, p <= 64, n <= 128.
//
// The wide path takes every other shape (a longer chunk, a wider head or
// a larger state; mamba_ssm's default chunk of 256), as the Pallas kernel
// does.  Its M would not fit: at cl 256 it alone is 256 KB in fp32, over
// the 227 KB a CTA may have.  So it tiles everything and keeps nothing of
// the chunk whole, fp32 on the CUDA cores for both dtypes (bf16 inputs
// widened as they are staged, y rounded once to bf16):
//   * 256 threads, each a 4 x 4 block of a 64 x 64 tile.  A y CTA takes
//     one row block of 64 rows and one 64-column slice of p, and walks the
//     column blocks j <= i of the lower triangle: G_ij = C_i . B_j^T
//     contracted over n in 32-column slices staged through shared memory,
//     M_ij = G_ij o exp(cum_i - cum_j) masked above the diagonal and past
//     the chunk, y_i += M_ij . xdt_j.  M does not depend on p, so a
//     second p slice repeats the G work (p <= 64 at every registered
//     arch: one slice).
//   * An S CTA takes one 64 x 64 tile of (p, n) and walks the chunk's row
//     blocks: S += (xdt_j o w_j)^T . B_j.
//   * Each CTA recomputes the chunk's cumulative log-decay from la in
//     fp32, a 64-row block at a time, each block's scan carried from the
//     last row of the one before, so every CTA of a (chunk, head) holds
//     the same bits (exp(cum_i - cum_i) = 1 on the diagonal).
//   * The grid puts the longest y row blocks first (slowest dimension),
//     then the S tiles.
// Offsets into global memory are 64-bit.  There is no backward kernel:
// the autograd Function recomputes through the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 16;        // rows and columns of one tile of M
constexpr int GP = 20;          // floats a row of a packed G / f32 M tile
constexpr int TILE_F = TILE * GP;
constexpr int MB = 24;          // bf16 a row of a bf16 M tile (48 bytes)
constexpr int TILE_B = TILE * MB;
constexpr int YB = 24;          // bf16 a row of a warp's y staging tile
constexpr int PMAX = 64;        // the first path's largest head dim p
constexpr int NMAX = 128;       // the first path's largest state size n
constexpr int STAGES = 2;       // the xdt / la ring (ring0, ring1)
constexpr int MAX_SMEM = 232448;

__host__ __device__ constexpr int threads_of(int clm) { return 4 * clm; }
__host__ __device__ constexpr int align16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int tri(int it, int kt) {
  return it * (it + 1) / 2 + kt;
}
// tile t of the packed lower triangle -> its row tile
__device__ __forceinline__ int row_of(int t) {
  int it = 0;
  while (tri(it + 1, 0) <= t) ++it;
  return it;
}

// Byte offsets of the shared-memory regions.  G stays for the whole CTA.
// Ring stage 0 comes first, so that head 0's copy can land while G is
// built; C overlays what follows it, (f32) M and ring stage 1.
struct Layout {
  int g, b, cum, w, ys, mq, ring0, cs, ring1, stage, la, x_pitch, b_pitch,
      total;
};

__host__ __device__ inline Layout layout(bool bf16, int clm, int n) {
  Layout L;
  const int esz = bf16 ? 2 : 4;
  const int ntile = tri(clm / TILE, 0);
  const int gbytes = ntile * TILE_F * 4;
  // rows of B and C: bf16 padded to 16 columns (the k of one mma) plus 8,
  // f32 to 4 (a float4) plus 4; 16-byte rows, no bank conflicts
  L.b_pitch = bf16 ? (n + 15) / 16 * 16 + 8 : (n + 3) / 4 * 4 + 4;
  L.x_pitch = bf16 ? PMAX + 8 : PMAX + 4;
  const int bc_bytes = align16(clm * L.b_pitch * esz);
  L.la = align16(clm * L.x_pitch * esz);
  L.stage = L.la + align16(clm * 4);
  int o = gbytes;
  L.g = 0;
  L.b = o;
  o += bc_bytes;
  L.cum = o;
  o += align16(clm * 4);
  L.w = o;
  o += align16(clm * 4);
  L.ys = o;                               // bf16: each warp's y tile
  o += bf16 ? threads_of(clm) / 32 * TILE * YB * 2 : 0;
  L.mq = o;                               // bf16: M's high, then low tiles
  o += bf16 ? 2 * ntile * TILE_B * 2 : 0;
  L.ring0 = o;
  L.cs = o + L.stage;                     // C, then M (f32), then stage 1
  L.ring1 = L.cs + (bf16 ? 0 : gbytes);
  const int end = L.ring1 + L.stage;
  L.total = end > L.cs + bc_bytes ? end : L.cs + bc_bytes;
  return L;
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
// d += a . b, one m16n8k16 product, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}
// (x0, x1) in fp32 as a bf16 pair of high parts and one of low parts
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = pack(x0 - __low2float(h), x1 - __high2float(h));
}
// a bf16 pair of xdt times (w0, w1), split
__device__ __forceinline__ void split_scaled(uint32_t v, float w0, float w1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  split(__low2float(x) * w0, __high2float(x) * w1, hi, lo);
}

struct Args {
  const void* xdt;
  const float* la;
  const void* B;
  const void* C;
  void* y;
  float* S;
  int cl, H, P, N, heads;
};

// M[i][j] of one tile element: zero above the diagonal and past the chunk
__device__ __forceinline__ float m_elem(const float* cum, float g, int i,
                                        int j, int cl) {
  return (i < cl && j <= i) ? g * expf(cum[i] - cum[j]) : 0.f;
}

// G = C . B^T on the tiles on or below the diagonal, f32: a 4 x 4 block a
// thread at a time, float4 reads along n (eight per 64 FMAs)
template <int CLM>
__device__ void build_g_fma(float* Gp, const float* Bs, const float* Cs,
                            int rt, int np, int bp) {
  for (int u = threadIdx.x; u < tri(rt, 0) * 16; u += threads_of(CLM)) {
    const int t = u >> 4, q = u & 15;
    const int it = row_of(t), kt = t - tri(it, 0);
    const float* cr = Cs + (it * TILE + (q >> 2) * 4) * bp;
    const float* br = Bs + (kt * TILE + (q & 3) * 4) * bp;
    float g[4][4] = {};
    for (int k = 0; k < np; k += 4) {
      float4 c[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        c[r] = *reinterpret_cast<const float4*>(cr + r * bp + k);
        b[r] = *reinterpret_cast<const float4*>(br + r * bp + k);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          g[r][s] = fmaf(c[r].x, b[s].x, g[r][s]);
          g[r][s] = fmaf(c[r].y, b[s].y, g[r][s]);
          g[r][s] = fmaf(c[r].z, b[s].z, g[r][s]);
          g[r][s] = fmaf(c[r].w, b[s].w, g[r][s]);
        }
    }
    float* gt = Gp + t * TILE_F + (q & 3) * 4 * GP + (q >> 2) * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<float4*>(gt + s * GP) =
          make_float4(g[0][s], g[1][s], g[2][s], g[3][s]);
  }
}

// the same on the tensor cores: one 16 x 16 tile a warp at a time
template <int CLM>
__device__ void build_g_mma(float* Gp, const __nv_bfloat16* Bs,
                            const __nv_bfloat16* Cs, int rt, int np,
                            int bp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  for (int t = warp; t < tri(rt, 0); t += threads_of(CLM) / 32) {
    const int it = row_of(t), kt = t - tri(it, 0);
    float acc[2][4] = {};
    for (int k = 0; k < np; k += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, Cs + (it * TILE + (lane & 7) + ((lane >> 3) & 1) * 8) * bp +
                     k + (lane >> 4) * 8);
      ldsm_x4(b, Bs + (kt * TILE + (lane & 7) + (lane >> 4) * 8) * bp + k +
                     ((lane >> 3) & 1) * 8);
      mma(acc[0], a, b[0], b[1]);
      mma(acc[1], a, b[2], b[3]);
    }
    float* gt = Gp + t * TILE_F;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int jj = s * 8 + 2 * tig;
      gt[jj * GP + gid] = acc[s][0];
      gt[(jj + 1) * GP + gid] = acc[s][1];
      gt[jj * GP + gid + 8] = acc[s][2];
      gt[(jj + 1) * GP + gid + 8] = acc[s][3];
    }
  }
}

// f32, one head: M into shared memory, then y and S by register-tiled FMAs
template <int CLM>
__device__ void head_fma(const Args& a, float* Mp, const float* Gp,
                         const float* X, const float* Bs, const float* cum,
                         const float* wv, int bp, int xp, int64_t row0,
                         int64_t bc, int h) {
  constexpr int THREADS = threads_of(CLM), PAIRS = CLM / TILE / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = a.cl, P = a.P, N = a.N, H = a.H;
  const int rt = (cl + TILE - 1) / TILE;
  // M = G o exp(cum_i - cum_j): one exp per (i, j); a thread keeps its
  // place in a tile and walks the tiles
  {
    constexpr int STEP = THREADS / (TILE * TILE);   // tiles an iteration
    const int ii = tid & 15, jj = (tid >> 4) & 15;
    int t = tid / (TILE * TILE), it = row_of(t), kt = t - tri(it, 0);
    for (; t < tri(rt, 0); t += STEP) {
      const int o = t * TILE_F + jj * GP + ii;
      Mp[o] = m_elem(cum, Gp[o], it * TILE + ii, kt * TILE + jj, cl);
      for (kt += STEP; kt > it; ++it) kt -= it + 1;
    }
  }
  __syncthreads();

  // y: rows 2r, 2r + 1 of tiles pair and CLM / 16 - 1 - pair, columns
  // 16 quarter + 4c.. (a float4: 16-byte stores)
  float* y = static_cast<float*>(a.y);
  const bool vec_y = P % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const int pair = warp % PAIRS, col = (warp / PAIRS) * 16 + 4 * (lane & 3);
  const int r2 = 2 * (lane >> 2);
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    const int it = side == 0 ? pair : CLM / TILE - 1 - pair;
    if (it >= rt || col - 4 * (lane & 3) >= P) continue;
    float acc[2][4] = {};
#pragma unroll 1
    for (int kt = 0; kt <= it; ++kt) {
      const float* mt = Mp + tri(it, kt) * TILE_F + r2;
      const float* xk = X + kt * TILE * xp + col;
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        const float2 m = *reinterpret_cast<const float2*>(mt + jj * GP);
        const float4 x = *reinterpret_cast<const float4*>(xk + jj * xp);
        const float xc[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[0][c] = fmaf(m.x, xc[c], acc[0][c]);
          acc[1][c] = fmaf(m.y, xc[c], acc[1][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = it * TILE + r2 + r;
      if (i >= cl) continue;
      float* yr = y + ((row0 + i) * H + h) * (int64_t)P + col;
      if (vec_y) {
        if (col < P)
          *reinterpret_cast<float4*>(yr) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < P) yr[c] = acc[r][c];
      }
    }
  }

  // S: a 4 (p) x 4 (n) block a group of js lanes at a time, each lane
  // every js-th step j, summed by shuffles; per step a float4 of xdt, w_j
  // and a float4 of B for 16 FMAs
  float* Sh = a.S + (bc * H + h) * (int64_t)P * N;
  const int p4 = (P + 3) / 4, n4 = (N + 3) / 4, units = p4 * n4;
  const int js = units * 4 <= THREADS ? 4 : units * 2 <= THREADS ? 2 : 1;
  const int part = tid % js;
  for (int u = tid / js; u < units; u += THREADS / js) {
    const int nb = u % n4, pq = u / n4;
    const float* xb = X + 4 * pq;
    const float* bb = Bs + 4 * nb;
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = part; j < cl; j += js) {
      const float4 x = *reinterpret_cast<const float4*>(xb + j * xp);
      const float4 b = *reinterpret_cast<const float4*>(bb + j * bp);
      const float w = wv[j];
      const float xw[4] = {x.x * w, x.y * w, x.z * w, x.w * w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xw[r], bv[c], acc[r][c]);
    }
    if (js > 1) {             // the js lanes of a block are all active
      const unsigned mask = __activemask();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          for (int off = 1; off < js; off <<= 1)
            acc[r][c] += __shfl_xor_sync(mask, acc[r][c], off);
    }
    if (part != 0) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = 4 * pq + r;
      if (pp >= P) continue;
      float* sr = Sh + (int64_t)pp * N + 4 * nb;
      if (N % 4 == 0) {
        *reinterpret_cast<float4*>(sr) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * nb + c < N) sr[c] = acc[r][c];
      }
    }
  }
}

// bf16, one head: M split into bf16 high and low tiles in shared memory;
// y = M . xdt and S = (xdt o w)^T . B on mma.sync, two products each
template <int CLM>
__device__ void head_mma(const Args& a, __nv_bfloat16* Mq, const float* Gp,
                         const __nv_bfloat16* X, const __nv_bfloat16* Bs,
                         const float* cum, const float* wv,
                         __nv_bfloat16* Ys, int bp, int xp, int64_t row0,
                         int64_t bc, int h) {
  constexpr int THREADS = threads_of(CLM), WARPS = THREADS / 32;
  constexpr int PAIRS = CLM / TILE / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cl = a.cl, P = a.P, N = a.N, H = a.H;
  const int rt = (cl + TILE - 1) / TILE;
  const int nlow = tri(CLM / TILE, 0) * TILE_B;     // the low part's offset

  // M = G o exp(cum_i - cum_j), two neighbouring columns a thread: one
  // exp per (i, j); its high and low parts as bf16 pairs.  A thread keeps
  // its place in a tile and walks the tiles.
  {
    constexpr int STEP = THREADS / (TILE * TILE / 2);  // tiles an iteration
    const int ii = (tid >> 3) & 15, jj = (tid & 7) * 2;
    int t = tid / (TILE * TILE / 2), it = row_of(t), kt = t - tri(it, 0);
    for (; t < tri(rt, 0); t += STEP) {
      const float* g = Gp + t * TILE_F + jj * GP + ii;
      const int i = it * TILE + ii, j = kt * TILE + jj;
      uint32_t hi, lo;
      split(m_elem(cum, g[0], i, j, cl), m_elem(cum, g[GP], i, j + 1, cl),
            hi, lo);
      const int o = t * TILE_B + ii * MB + jj;
      *reinterpret_cast<uint32_t*>(Mq + o) = hi;
      *reinterpret_cast<uint32_t*>(Mq + nlow + o) = lo;
      for (kt += STEP; kt > it; ++it) kt -= it + 1;
    }
  }
  __syncthreads();

  // y: tiles pair and CLM / 16 - 1 - pair, columns 16 quarter..
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  const bool vec_y = P % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  __nv_bfloat16* yw = Ys + warp * TILE * YB;
  const int pair = warp % PAIRS, col0 = (warp / PAIRS) * 16;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    const int it = side == 0 ? pair : CLM / TILE - 1 - pair;
    if (it >= rt || col0 >= P) continue;
    float acc[2][4] = {};
#pragma unroll 1
    for (int kt = 0; kt <= it; ++kt) {
      uint32_t ah[4], al[4], b[4];
      const __nv_bfloat16* mt = Mq + tri(it, kt) * TILE_B +
                                ((lane & 7) + ((lane >> 3) & 1) * 8) * MB +
                                (lane >> 4) * 8;
      ldsm_x4(ah, mt);
      ldsm_x4(al, mt + nlow);
      ldsm_x4_t(b, X + (kt * TILE + (lane & 7) + ((lane >> 3) & 1) * 8) * xp +
                       col0 + (lane >> 4) * 8);
      mma(acc[0], ah, b[0], b[1]);
      mma(acc[1], ah, b[2], b[3]);
      mma(acc[0], al, b[0], b[1]);
      mma(acc[1], al, b[2], b[3]);
    }
    // y rounded once to bf16, staged per warp, stored 16 bytes at a time
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      *reinterpret_cast<uint32_t*>(yw + gid * YB + nt * 8 + 2 * tig) =
          pack(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(yw + (gid + 8) * YB + nt * 8 + 2 * tig) =
          pack(acc[nt][2], acc[nt][3]);
    }
    __syncwarp();
    if (vec_y) {
      const int r = lane >> 1, c = col0 + (lane & 1) * 8, i = it * TILE + r;
      if (i < cl && c < P)
        *reinterpret_cast<uint4*>(y + ((row0 + i) * H + h) * (int64_t)P + c) =
            *reinterpret_cast<const uint4*>(yw + r * YB + (lane & 1) * 8);
    } else {
      for (int e = lane; e < TILE * 16; e += 32) {
        const int r = e >> 4, c = col0 + (e & 15), i = it * TILE + r;
        if (i < cl && c < P)
          y[((row0 + i) * H + h) * (int64_t)P + c] = yw[r * YB + (e & 15)];
      }
    }
    __syncwarp();
  }

  // S: warps take (16 rows of p) x (a group of 8-column tiles of n); A =
  // (xdt o w)^T by a transposing ldmatrix, scaled and split in registers
  float* Sh = a.S + (bc * H + h) * (int64_t)P * N;
  const int pm = (P + 15) / 16, nt8 = (N + 7) / 8;
  int gsz = (pm * nt8 + WARPS - 1) / WARPS;
  gsz = gsz < 1 ? 1 : gsz > 8 ? 8 : gsz;
  const int units = pm * ((nt8 + gsz - 1) / gsz);
  for (int u = warp; u < units; u += WARPS) {
    const int mt = u % pm, n0 = (u / pm) * gsz;
    float acc[8][4] = {};
#pragma unroll 1
    for (int kt = 0; kt < rt; ++kt) {
      uint32_t xa[4], ahi[4], alo[4];
      ldsm_x4_t(xa, X + (kt * TILE + (lane & 7) + (lane >> 4) * 8) * xp +
                        mt * 16 + ((lane >> 3) & 1) * 8);
      const int j0 = kt * TILE + 2 * tig;
      const float w0 = wv[j0], w1 = wv[j0 + 1], w8 = wv[j0 + 8],
                  w9 = wv[j0 + 9];
      split_scaled(xa[0], w0, w1, ahi[0], alo[0]);
      split_scaled(xa[1], w0, w1, ahi[1], alo[1]);
      split_scaled(xa[2], w8, w9, ahi[2], alo[2]);
      split_scaled(xa[3], w8, w9, ahi[3], alo[3]);
      const __nv_bfloat16* bk =
          Bs + (kt * TILE + (lane & 7) + ((lane >> 3) & 1) * 8) * bp;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q >= gsz || n0 + q >= nt8) continue;
        uint32_t b[2];
        ldsm_x2_t(b, bk + (n0 + q) * 8);
        mma(acc[q], ahi, b[0], b[1]);
        mma(acc[q], alo, b[0], b[1]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= gsz) continue;
      const int n = (n0 + q) * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pp = mt * 16 + gid + 8 * half;
        if (pp >= P || n >= N) continue;
        float* sr = Sh + (int64_t)pp * N + n;
        if (N % 2 == 0) {
          *reinterpret_cast<float2*>(sr) =
              make_float2(acc[q][2 * half], acc[q][2 * half + 1]);
        } else {
          sr[0] = acc[q][2 * half];
          if (n + 1 < N) sr[1] = acc[q][2 * half + 1];
        }
      }
    }
  }
}

// three 64-row CTAs an SM (at most 85 registers a thread), one 128-row CTA
template <typename T, int CLM>
__global__ void __launch_bounds__(threads_of(CLM), CLM == 64 ? 3 : 1)
ssd_chunk_kernel(const Args a) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  constexpr int THREADS = threads_of(CLM);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(MMA, CLM, a.N);
  float* Gp = reinterpret_cast<float*>(smem + L.g);
  T* Bs = reinterpret_cast<T*>(smem + L.b);
  T* Cs = reinterpret_cast<T*>(smem + L.cs);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* wv = reinterpret_cast<float*>(smem + L.w);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = a.cl, H = a.H, P = a.P, N = a.N;
  const int rt = (cl + TILE - 1) / TILE;
  const int bp = L.b_pitch, xp = L.x_pitch;
  const int64_t bc = blockIdx.x;                 // batch * n_chunks + chunk
  const int hbase = blockIdx.y * a.heads;
  const int nh = min(a.heads, H - hbase);
  const int64_t row0 = bc * cl;                  // first row of the chunk
  const T* xdt = static_cast<const T*>(a.xdt);

  const bool vec_x = (P * (int)sizeof(T)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(xdt) & 15) == 0;
  auto ring = [&](int hh) { return smem + (hh % STAGES ? L.ring1 : L.ring0); };
  auto stage_head = [&](int hh) {
    const int h = hbase + hh;
    T* X = reinterpret_cast<T*>(ring(hh));
    float* ls = reinterpret_cast<float*>(ring(hh) + L.la);
    if (vec_x) {
      constexpr int per = 16 / sizeof(T);
      const int cpr = P / per;
      for (int e = tid; e < cl * cpr; e += THREADS) {
        const int j = e / cpr, c = e % cpr;
        cp16(X + j * xp + c * per, xdt + ((row0 + j) * H + h) * P + c * per);
      }
    } else {
      for (int e = tid; e < cl * P; e += THREADS) {
        const int j = e / P, pp = e % P;
        X[j * xp + pp] = xdt[((row0 + j) * H + h) * P + pp];
      }
    }
    for (int j = tid; j < cl; j += THREADS)
      cp4(ls + j, a.la + (row0 + j) * H + h);
    cp_commit();
  };

  // B and C of the chunk by cp.async where their rows are 16-byte
  // multiples, zero past cl rows and n columns; head 0's slice is in flight
  // while G is built
  {
    const T* Bc = static_cast<const T*>(a.B) + row0 * N;
    const T* Cc = static_cast<const T*>(a.C) + row0 * N;
    const int np = MMA ? (N + 15) / 16 * 16 : (N + 3) / 4 * 4;
    const bool vec_bc = (N * (int)sizeof(T)) % 16 == 0 &&
                        ((reinterpret_cast<uintptr_t>(a.B) |
                          reinterpret_cast<uintptr_t>(a.C)) & 15) == 0;
    if (vec_bc) {
      constexpr int per = 16 / sizeof(T);
      const int cpr = N / per;
      for (int e = tid; e < cl * cpr; e += THREADS) {
        const int j = e / cpr, c = e % cpr;
        cp16(Bs + j * bp + c * per, Bc + (int64_t)j * N + c * per);
        cp16(Cs + j * bp + c * per, Cc + (int64_t)j * N + c * per);
      }
    }
    for (int e = tid; e < CLM * np; e += THREADS) {
      const int j = e / np, k = e % np;
      const bool in = j < cl && k < N;
      if (vec_bc && in) continue;
      Bs[j * bp + k] = in ? Bc[(int64_t)j * N + k] : zero<T>();
      Cs[j * bp + k] = in ? Cc[(int64_t)j * N + k] : zero<T>();
    }
    cp_commit();
    stage_head(0);
    cp_wait<1>();
    __syncthreads();
    if constexpr (MMA)
      build_g_mma<CLM>(Gp, Bs, Cs, rt, np, bp);
    else
      build_g_fma<CLM>(Gp, Bs, Cs, rt, np, bp);
    __syncthreads();                             // C is dead from here
  }
  // where the copies do not reach (columns past p, rows past cl) the ring
  // stays zero; the first barrier of the head loop publishes it
  if (P < PMAX || cl < CLM) {
    for (int e = tid; e < STAGES * CLM * PMAX; e += THREADS) {
      const int pp = e % PMAX, j = (e / PMAX) % CLM;
      if (j < cl && pp < P) continue;
      reinterpret_cast<T*>(ring(e / (CLM * PMAX)))[j * xp + pp] = zero<T>();
    }
  }

#pragma unroll 1
  for (int hh = 0; hh < nh; ++hh) {
    if (hh + 1 < nh) {
      stage_head(hh + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* X = reinterpret_cast<const T*>(ring(hh));
    const float* ls = reinterpret_cast<const float*>(ring(hh) + L.la);
    if (warp == 0) {          // inclusive prefix sum of la, then w
      const int per = (cl + 31) / 32, start = lane * per;
      float run = 0.f;
      for (int u = 0; u < per; ++u) {
        const int j = start + u;
        if (j < cl) {
          run += ls[j];
          cum[j] = run;
        }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += t;
      }
      float before = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) before = 0.f;
      for (int u = 0; u < per; ++u) {
        const int j = start + u;
        if (j < cl) cum[j] += before;
      }
      __syncwarp();
      const float end = cum[cl - 1];
      for (int j = lane; j < CLM; j += 32) {
        if (j < cl) {
          wv[j] = expf(end - cum[j]);
        } else {
          wv[j] = 0.f;
          cum[j] = 0.f;
        }
      }
    }
    __syncthreads();
    if constexpr (MMA)
      head_mma<CLM>(a, reinterpret_cast<__nv_bfloat16*>(smem + L.mq), Gp, X,
                    Bs, cum, wv,
                    reinterpret_cast<__nv_bfloat16*>(smem + L.ys), bp, xp,
                    row0, bc, hbase + hh);
    else
      head_fma<CLM>(a, reinterpret_cast<float*>(Cs), Gp, X, Bs, cum, wv, bp,
                    xp, row0, bc, hbase + hh);
    __syncthreads();          // this stage is read; the next copy may land
  }
}

// the kernel's dynamic shared memory, allowed past the default 48 KB
template <typename T, int CLM>
cudaError_t configure(int n, int* smem) {
  const Layout L = layout(std::is_same<T, __nv_bfloat16>::value, CLM, n);
  *smem = L.total;
  if (L.total > MAX_SMEM) return cudaErrorInvalidConfiguration;
  if (L.total <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(ssd_chunk_kernel<T, CLM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L.total);
}

template <typename T, int CLM>
int ctas_per_sm(int n) {
  int smem = 0, blocks = 0;
  if (configure<T, CLM>(n, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ssd_chunk_kernel<T, CLM>, threads_of(CLM), smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <typename T, int CLM>
cudaError_t launch_cl(const Args& a, int64_t bnc, cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = configure<T, CLM>(a.N, &smem);
  if (e != cudaSuccess) return e;
  const int64_t hblocks = (a.H + a.heads - 1) / a.heads;
  if (bnc > 0x7fffffffLL || hblocks > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bnc, (unsigned)hblocks);
  ssd_chunk_kernel<T, CLM><<<grid, threads_of(CLM), (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int64_t bnc, cudaStream_t stream) {
  if (a.cl <= 64) return launch_cl<T, 64>(a, bnc, stream);
  return launch_cl<T, 128>(a, bnc, stream);
}

// ------------------------------------------------------ the wide path --

constexpr int WB = 64;           // rows of a row block, columns of a column block
constexpr int WP = 64;           // p columns a y CTA, p rows of an S tile
constexpr int WN = 32;           // n columns a slice of G's contraction
constexpr int WS = 64;           // n columns of an S tile
constexpr int W_THREADS = 256;   // 16 x 16, each a 4 x 4 block of a tile
constexpr int WNP = WN + 1;      // pitch of the staged C and B slices
constexpr int WMP = WB + 1;      // pitch of M
// float offsets of the shared regions: C and B slices, M (an S CTA's B
// tile instead), xdt (o w), the row block's and the column block's cum
constexpr int W_CS = 0, W_BS = WB * WNP, W_MS = 2 * WB * WNP,
              W_XS = W_MS + WB * WMP, W_CR = W_XS + WB * WP,
              W_CC = W_CR + WB, W_FLOATS = W_CC + WB;
static_assert(WB * WS <= WB * WMP, "an S tile's B fits M's place");
constexpr int W_SMEM = W_FLOATS * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The cumulative log-decay of row block k of the chunk (rows past cl add
// 0) into out[WB], from `carry`, the cum at the last row of block k - 1;
// returns the cum at the block's last row.  Warp 0 scans; every thread
// takes part in its two barriers.
__device__ float wide_cum(const float* la, int64_t row0, int H, int h,
                          int cl, int k, float carry, float* out) {
  __syncthreads();                       // out's last readers are done
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, j = k * WB + 2 * lane;
    const float a0 = j < cl ? la[(row0 + j) * H + h] : 0.f;
    const float a1 = j + 1 < cl ? la[(row0 + j + 1) * H + h] : 0.f;
    float tot = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += t;
    }
    float before = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) before = 0.f;
    out[2 * lane] = carry + (before + a0);
    out[2 * lane + 1] = carry + (before + a0 + a1);
  }
  __syncthreads();
  return out[WB - 1];
}

// y over row block i, p columns ps * WP.., of one (chunk, head)
template <typename T>
__device__ void wide_y(const Args& a, float* sm, int64_t bc, int h, int i,
                       int ps) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cl = a.cl, H = a.H, P = a.P, N = a.N;
  float *Cs = sm + W_CS, *Bs = sm + W_BS, *Ms = sm + W_MS, *Xs = sm + W_XS,
        *cr = sm + W_CR, *cc = sm + W_CC;
  const int64_t row0 = bc * cl;
  const T* xdt = static_cast<const T*>(a.xdt);
  const T* Bg = static_cast<const T*>(a.B) + row0 * N;
  const T* Cg = static_cast<const T*>(a.C) + row0 * N;
  float carry = 0.f;
  for (int k = 0; k < i; ++k)
    carry = wide_cum(a.la, row0, H, h, cl, k, carry, cc);
  wide_cum(a.la, row0, H, h, cl, i, carry, cr);

  float acc[4][4] = {};
  carry = 0.f;
#pragma unroll 1
  for (int j = 0; j <= i; ++j) {
    carry = wide_cum(a.la, row0, H, h, cl, j, carry, cc);
    // G_ij = C_i . B_j^T, over n a slice at a time
    float g[4][4] = {};
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += WN) {
      for (int e = tid; e < WB * WN; e += W_THREADS) {
        const int r = e / WN, c = e % WN, n = n0 + c;
        const int ri = i * WB + r, rj = j * WB + r;
        Cs[r * WNP + c] =
            ri < cl && n < N ? to_f32(Cg[(int64_t)ri * N + n]) : 0.f;
        Bs[r * WNP + c] =
            rj < cl && n < N ? to_f32(Bg[(int64_t)rj * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < WN; ++c) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = Cs[(ty + 16 * u) * WNP + c];
          bv[u] = Bs[(tx + 16 * u) * WNP + c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) g[r][s] = fmaf(cv[r], bv[s], g[r][s]);
      }
      __syncthreads();
    }
    // M_ij, zero above the diagonal and past the chunk
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int ii = ty + 16 * r, jj = tx + 16 * s;
        const int gi = i * WB + ii, gj = j * WB + jj;
        Ms[ii * WMP + jj] =
            gi < cl && gj <= gi ? g[r][s] * expf(cr[ii] - cc[jj]) : 0.f;
      }
    for (int e = tid; e < WB * WP; e += W_THREADS) {
      const int r = e / WP, c = e % WP, rj = j * WB + r, pc = ps * WP + c;
      Xs[r * WP + c] =
          rj < cl && pc < P
              ? to_f32(xdt[((row0 + rj) * H + h) * (int64_t)P + pc])
              : 0.f;
    }
    __syncthreads();
    // y_i += M_ij . xdt_j
#pragma unroll 8
    for (int c = 0; c < WB; ++c) {
      float mv[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mv[u] = Ms[(ty + 16 * u) * WMP + c];
        xv[u] = Xs[c * WP + tx + 16 * u];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(mv[r], xv[s], acc[r][s]);
    }
  }
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i * WB + ty + 16 * r;
    if (gi >= cl) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int pc = ps * WP + tx + 16 * s;
      if (pc < P) put(y + ((row0 + gi) * H + h) * (int64_t)P + pc, acc[r][s]);
    }
  }
}

// S over the (p, n) tile (ps * WP.., ns * WS..) of one (chunk, head)
template <typename T>
__device__ void wide_s(const Args& a, float* sm, int64_t bc, int h, int ps,
                       int ns) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cl = a.cl, H = a.H, P = a.P, N = a.N;
  float *Bt = sm + W_MS, *Xs = sm + W_XS, *cc = sm + W_CC;
  const int64_t row0 = bc * cl;
  const int nrb = (cl + WB - 1) / WB;
  const T* xdt = static_cast<const T*>(a.xdt);
  const T* Bg = static_cast<const T*>(a.B) + row0 * N;
  float carry = 0.f;
  for (int k = 0; k < nrb; ++k)
    carry = wide_cum(a.la, row0, H, h, cl, k, carry, cc);
  const float end = carry;               // the cum at the chunk's last row

  float acc[4][4] = {};
  carry = 0.f;
#pragma unroll 1
  for (int k = 0; k < nrb; ++k) {
    carry = wide_cum(a.la, row0, H, h, cl, k, carry, cc);
    for (int e = tid; e < WB * WP; e += W_THREADS) {
      const int r = e / WP, c = e % WP, rj = k * WB + r, pc = ps * WP + c;
      Xs[r * WP + c] =
          rj < cl && pc < P
              ? to_f32(xdt[((row0 + rj) * H + h) * (int64_t)P + pc]) *
                    expf(end - cc[r])
              : 0.f;
    }
    for (int e = tid; e < WB * WS; e += W_THREADS) {
      const int r = e / WS, c = e % WS, rj = k * WB + r, n = ns * WS + c;
      Bt[r * WS + c] = rj < cl && n < N ? to_f32(Bg[(int64_t)rj * N + n])
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WB; ++r) {
      float xv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = Xs[r * WP + ty + 16 * u];
        bv[u] = Bt[r * WS + tx + 16 * u];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[q][s] = fmaf(xv[q], bv[s], acc[q][s]);
    }
  }
  float* Sh = a.S + (bc * H + h) * (int64_t)P * N;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int pp = ps * WP + ty + 16 * q;
    if (pp >= P) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = ns * WS + tx + 16 * s;
      if (n < N) Sh[(int64_t)pp * N + n] = acc[q][s];
    }
  }
}

__host__ __device__ inline int wide_y_units(int cl, int p) {
  return (cl + WB - 1) / WB * ((p + WP - 1) / WP);
}

// grid (b * n_chunks, heads, units): units are the y CTAs, the longest row
// blocks first, then the S tiles
template <typename T>
__global__ void __launch_bounds__(W_THREADS, 2)
ssd_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int nps = (a.P + WP - 1) / WP, nrb = (a.cl + WB - 1) / WB;
  const int u = blockIdx.z, ny = wide_y_units(a.cl, a.P);
  if (u < ny) {
    wide_y<T>(a, sm, blockIdx.x, blockIdx.y, nrb - 1 - u / nps, u % nps);
  } else {
    const int v = u - ny, nns = (a.N + WS - 1) / WS;
    wide_s<T>(a, sm, blockIdx.x, blockIdx.y, v / nns, v % nns);
  }
}

template <typename T>
cudaError_t configure_wide() {
  return cudaFuncSetAttribute(ssd_wide_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              W_SMEM);
}

template <typename T>
cudaError_t launch_wide(const Args& a, int64_t bnc, cudaStream_t stream) {
  const cudaError_t e = configure_wide<T>();
  if (e != cudaSuccess) return e;
  const int64_t units = (int64_t)wide_y_units(a.cl, a.P) +
                        (int64_t)((a.P + WP - 1) / WP) * ((a.N + WS - 1) / WS);
  if (bnc > 0x7fffffffLL || a.H > 65535 || units > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bnc, (unsigned)a.H, (unsigned)units);
  ssd_wide_kernel<T><<<grid, W_THREADS, (size_t)W_SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int wide_ctas_per_sm() {
  int blocks = 0;
  if (configure_wide<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ssd_wide_kernel<T>, W_THREADS, W_SMEM) != cudaSuccess)
    return -1;
  return blocks;
}

// whether the CTA of the first path is built for this shape
bool narrow(int64_t cl, int64_t p, int64_t n) {
  return cl <= 128 && p <= PMAX && n <= NMAX;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of xdt, B, C and y); la and S are
// float32.  xdt (b, l, h, p), la (b, l, h), B and C (b, l, n), y (b, l, h,
// p) and S (b, l / cl, h, p, n) are contiguous device buffers; bnc =
// b * l / cl.  Takes any cl, p and n >= 1: cl <= 128, p <= 64 and
// n <= 128 run on the first path, whose tiles, threads, heads per CTA and
// stages follow from the dtype, cl and n; anything else on the wide path
// (kernels/ssd.py::plan mirrors both).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_ssd_chunk(const void* xdt, const void* la, const void* B,
                               const void* C, void* y, void* S, int dtype,
                               int64_t bnc, int64_t cl, int64_t h, int64_t p,
                               int64_t n, void* stream) {
  constexpr int64_t I32 = 0x7fffffffLL;
  if (bnc < 1 || cl < 1 || cl > I32 || h < 1 || h > I32 || p < 1 ||
      p > I32 || n < 1 || n > I32)
    return (int)cudaErrorInvalidValue;
  const Args a{xdt, static_cast<const float*>(la), B, C, y,
               static_cast<float*>(S), (int)cl, (int)h, (int)p, (int)n,
               n <= 32 ? 2 : 4};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool first = narrow(cl, p, n);
  if (dtype == 0)
    return (int)(first ? launch<float>(a, bnc, st)
                       : launch_wide<float>(a, bnc, st));
  if (dtype == 1)
    return (int)(first ? launch<__nv_bfloat16>(a, bnc, st)
                       : launch_wide<__nv_bfloat16>(a, bnc, st));
  return (int)cudaErrorInvalidValue;
}

// CTAs of the kernel that fit one SM at this dtype, chunk, head dim and
// state size (-1 if the query fails): what `kernels/ssd.py::occupancy`
// reports.
extern "C" int repro_ssd_ctas_per_sm(int dtype, int64_t cl, int64_t p,
                                     int64_t n) {
  if (cl < 1 || p < 1 || n < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (!narrow(cl, p, n))
    return dtype == 0 ? wide_ctas_per_sm<float>()
                      : wide_ctas_per_sm<__nv_bfloat16>();
  if (dtype == 0)
    return cl <= 64 ? ctas_per_sm<float, 64>((int)n)
                    : ctas_per_sm<float, 128>((int)n);
  return cl <= 64 ? ctas_per_sm<__nv_bfloat16, 64>((int)n)
                  : ctas_per_sm<__nv_bfloat16, 128>((int)n);
}
