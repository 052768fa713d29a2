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
// Like the Pallas kernel, the bf16 path rounds P to bf16 before P.V.
//
// A block call (ring attention's tile of one query block against one key
// block, `lse` not null) shifts the query positions by `delta` (query row
// i sits at i + delta, key j at j: the blocks' global offsets), writes the
// output in fp32 whatever the inputs' dtype, and writes each row's
// log-sum-exp lse = (m + log2 l) ln 2 (B, Hq, Sq), fp32, from the m and l
// the epilogue holds.  Such a call may have rows that no key of the block
// is admitted to: their tiles are all masked, or their CTA walks no tile
// (m stays -1e30 in log2 units, l 0, the output 0), and their lse is
// about -1e30, so a merge by log-sum-exp gives them weight 0.
//
// Both paths read q, k and v in place from their (B, S, H, D) layout (row
// stride H*D, head offset h*D) and run one CTA per (query tile, q head,
// batch).  The grid puts the query tile in its slow dimension and, under
// causality, launches the longest tiles (the last queries, which see the
// most keys) first, so the causal tail does not straggle.  A CTA walks key
// tiles from the first one the window admits to the last one causality
// admits; the mask arithmetic runs only on tiles that a diagonal, a window
// edge or the end of Sk crosses.  The softmax runs in log2 units on the
// special-function unit (ex2); on unmasked tiles the max is taken on the
// raw products and scale * log2(e) folds into the exponent's FMA; the
// softcap, where there is one, is applied before the fold, in natural
// units.  Keys past Sk score -inf (they are not part of the function, so
// they add exactly 0 even to a row whose running max is still -1e30);
// rows past Sq are never stored.  Offsets are 64-bit.
//
// What bounds it on this card.  At hymba's shapes (D = 64, 25/5 heads,
// 2048 tokens) attention does about 64 FLOPs per byte of q, k, v and o per
// key tile, so both paths are bound by operations: 0.20 ms per causal call
// at the 67 TFLOP/s of the fp32 CUDA cores, 0.014 ms at the 989 TFLOP/s of
// the bf16 tensor cores.  At gemma2's (D = 256, 16/8 heads, softcap 50,
// 8192 tokens) the causal call's bound is 8.21 ms f32 and 0.556 ms bf16;
// the kernel took 19.15 and 3.29 ms on an H100 80GB HBM3 at 700 W
// (PERF.md).  What the design does about it:
//
// - bf16 (`wgmma`): 128 queries x 64 keys per step, two consumer
//   warpgroups of 64 query rows.  Q is staged once; K and V go through a
//   2-stage ring of 16-byte cp.async copies into 128-byte-swizzled shared
//   memory (D padded with zeros to 64, 128 or 256 = one, two or four
//   swizzle atoms), loaded one tile ahead of the compute.  S = Q.K^T is `wgmma m64n64k16`
//   with Q and K both K-major (D contiguous, as they lie).  The online
//   softmax runs on the S accumulator fragments (row max over a quad of
//   lanes, per-thread partial row sums); P, rounded to bf16 pairs, lies
//   exactly in the register-A fragment of the next product, so O += P.V is
//   `wgmma` with A from registers and V read MN-major through the
//   transpose bit: P never touches shared memory.  The two warpgroups run
//   the two products and the softmax in step, so at D = 64 two CTAs share
//   an SM (128 registers a thread) and one's softmax (the exponentials on
//   the special-function unit cost about as much as the products on the
//   tensor cores) runs beside the other's wgmma.  At D = 256 (gemma2) the
//   shared memory still fits two stages (64 KB of Q, 64 KB of K and V a
//   stage: 193 KB) and registers are the tight part: a warpgroup's 64 x
//   256 fp32 O tile is 128 registers a thread beside the 32 of S, so one
//   CTA holds the SM and P.V runs as two m64n128 halves of the O tile,
//   each over two 64-column atoms of V.
// - f32: full FP32 FMAs on the CUDA cores (no TF32), register-tiled as
//   the f32 conv is.  A thread holds 8 query rows x 4 keys of the 128 x
//   64 score tile and 8 rows x D/16 columns of the output (at D = 256 the
//   CTA takes 64 query rows, 4 a thread: 128 would need 260 KB of shared
//   memory with one stage, 64 take 211 KB).  Q, K and V
//   stay row-major as they lie (rows padded by 4 floats, so the float4
//   reads are conflict-free) and are filled by 16-byte cp.async copies, K
//   and V through a 2-stage ring (one stage at D > 64, where two do not
//   fit in shared memory).  Both products read float4s: 32 FMAs per 3
//   reads.  P goes through shared memory once per tile, within the
//   half-warp that owns its rows, so it needs no block barrier.  One CTA
//   of 8 warps fills the SM's registers, so a stall is not hidden: the
//   path runs at less than half the CUDA cores' peak (PERF.md); 8 x 8 a
//   thread with Q and K staged transposed did no better.  bf16 inputs
//   whose D is
//   not a multiple of 8 also take this path, converted to fp32 as they
//   are staged (synchronous copies, as for f32 rows that are not 16
//   bytes).
//
// - D > 256 (`split`; the Pallas kernel takes any D, and the two paths
//   above keep a whole row of Q, K and V, padded to 256 at most, in shared
//   memory): the output's head dim is split over CTAs, 256 columns of V
//   and O each, so the grid is (q heads, query tiles, batch x ceil(D /
//   256)).  Each CTA walks the key tiles of 64 keys as the `fma` path does
//   (64 query rows, 4 a thread; the same masks, edge test, softcap and
//   online softmax in log2 units, fp32 on the CUDA cores, bf16 widened as
//   it is staged, P in fp32), but accumulates S = Q.K^T over D in 64-column
//   slices of Q and K staged through shared memory, then O += P.V over its
//   256 columns.  Every CTA of a row computes the same S, m and l bit for
//   bit, so the slices agree; the first writes the row's lse.  The score
//   work is ceil(D / 256) times the function's: at D = 512 the CTAs do 1.5
//   times the FLOPs the bound counts.  Shared memory: 115 KB, one CTA an
//   SM.
//
// The backward pass is not here: the autograd Function recomputes through
// the plain version (the TPU kernel is forward-only too).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG_BQ = 128;       // query rows per CTA, bf16 path
constexpr int WG_BK = 64;        // keys per tile, bf16 path
// query rows per CTA, f32 path: 128, or 64 at D padded to 256
__host__ __device__ constexpr int fma_bq(int dp) {
  return dp == 256 ? 64 : 128;
}
constexpr int FMA_BK = 64;       // keys per tile, f32 path
constexpr int THREADS = 256;     // both paths
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIG2 = NEG_BIG * LOG2E;   // a masked logit, log2 units
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                    // null: a one-device call (o in q's dtype)
  int64_t Sq, Sk, window;        // window <= 0: none
  int64_t delta;                 // query row i sits at position i + delta
  int Hq, Hkv, D, causal, tiles_q;
  float scale, softcap;          // softcap <= 0: none
};

// ------------------------------------------------------------ helpers --

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// The CTA's query tile (longest first under causality) and its key tiles
// t_lo .. t_hi of `bk` keys: from the first one the window admits for the
// tile's first row to the last one causality admits for its last row, the
// rows at their positions (shifted by delta); none where nothing is
// admitted (t_hi = t_lo - 1).
struct Tiles {
  int64_t q0, q_last, t_lo, t_hi;

  __device__ __forceinline__ Tiles(const Args& a, int bq, int bk) {
    const int qt = a.causal ? a.tiles_q - 1 - (int)blockIdx.y
                            : (int)blockIdx.y;
    q0 = (int64_t)qt * bq;
    q_last = q0 + bq - 1 < a.Sq - 1 ? q0 + bq - 1 : a.Sq - 1;
    int64_t k_lo = 0, k_hi = a.Sk - 1;
    if (a.causal && q_last + a.delta < k_hi) k_hi = q_last + a.delta;
    if (a.window > 0 && q0 + a.delta - a.window + 1 > 0)
      k_lo = q0 + a.delta - a.window + 1;
    t_lo = k_lo / bk;
    t_hi = k_hi < k_lo ? t_lo - 1 : k_hi / bk;
  }

  // whether a mask or the end of Sk crosses the key tile at k0 for some
  // stored row (rows past Sq are computed but never stored)
  __device__ __forceinline__ bool edge(const Args& a, int64_t k0,
                                       int bk) const {
    return k0 + bk > a.Sk || (a.causal && k0 + bk - 1 > q0 + a.delta) ||
           (a.window > 0 && q_last + a.delta - k0 >= a.window);
  }
};

// 2^x on the special-function unit (ex2.approx(-inf) = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the logit of (query row qr, key kp) in log2 units, masked: s is the raw
// q.k product; the row sits at position qr + delta
__device__ __forceinline__ float masked_logit(const Args& a, float s,
                                              int64_t qr, int64_t kp) {
  float x = s * a.scale;
  if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
  if (kp >= a.Sk) return -INFINITY;
  const int64_t qp = qr + a.delta;
  if ((a.causal && qp < kp) || (a.window > 0 && qp - kp >= a.window))
    return NEG_BIG2;
  return x * LOG2E;
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching wgmma accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, fp32) (+)= A (64 x 16, K-major, shared) . B (16 x 64,
// K-major, shared); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x N,
// MN-major, shared: wgmma transposes it)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x DP, fp32) += P (64 x 16, registers) . V (16 x DP at v_addr,
// MN-major, 64-column atoms ROWS * 128 bytes apart): one wgmma at DP 64 or
// 128, two m64n128 halves at DP 256 (registers 0-63 hold columns 0-127,
// 64-127 columns 128-255: the accumulator layout of one m64n256)
template <int DP, int ROWS>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t v_addr) {
  constexpr uint32_t ATOM = ROWS * 128;
  if constexpr (DP == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a,
                  sw128_desc(v_addr, ATOM, 1024));
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                  sw128_desc(v_addr + 2 * ATOM, ATOM, 1024));
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, sw128_desc(v_addr, ATOM, 1024));
  } else {
    wgmma_rs_n64(d, a, sw128_desc(v_addr, ATOM, 1024));
  }
}

// Copy rows r0 .. r0+ROWS-1 (of n_rows; stride rs elements) of a (rows, D)
// bf16 matrix into ROWS x DP of 128-byte-swizzled shared memory at dst: a
// 64-column atom after another (ROWS * 128 bytes apart), row r at r * 128,
// 16-byte chunk c at (c ^ (r % 8)) * 16.  Rows past n_rows and columns
// past D are zero-filled.
template <int ROWS, int DP>
__device__ __forceinline__ void load_swizzled(uint32_t dst, const bf16* src,
                                              int64_t r0, int64_t n_rows,
                                              int64_t rs, int D, int tid) {
  constexpr int CPR = DP / 8;   // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < ROWS * CPR / THREADS; ++pass) {
    const int e = tid + pass * THREADS, r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < n_rows && c * 8 < D;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               ok ? src + (r0 + r) * rs + c * 8 : src, ok);
  }
}

__host__ __device__ constexpr int wgmma_smem_bytes(int dp, int bk) {
  return WG_BQ * dp * 2 + 2 * (2 * bk * dp * 2) + 1024;   // + alignment
}

// DP: D padded to 64, 128 or 256.  At DP = 64 two CTAs share an SM (at
// most 128 registers a thread), so that one CTA's softmax runs beside the
// other's wgmma.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
flash_fwd_wgmma_kernel(const Args a) {
  constexpr int BQ = WG_BQ, BK = WG_BK;
  constexpr uint32_t Q_BYTES = BQ * DP * 2;
  constexpr uint32_t KV_BYTES = BK * DP * 2;          // one of K and V
  constexpr uint32_t STAGE = 2 * KV_BYTES;
  constexpr int NS = BK / 2, NO = DP / 2;             // accumulators
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms (8 rows x 128 bytes) start on 1024-byte boundaries
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Q_BYTES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int hq = blockIdx.x, hk = hq / (a.Hq / a.Hkv);
  const int64_t b = blockIdx.z;
  const int64_t qs = (int64_t)a.Hq * a.D, ks = (int64_t)a.Hkv * a.D;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.Sq * qs +
                   (int64_t)hq * a.D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.Sk * ks +
                   (int64_t)hk * a.D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.Sk * ks +
                   (int64_t)hk * a.D;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.Sq * qs + (int64_t)hq * a.D;
  const Tiles tl(a, BQ, BK);
  const int nt = (int)(tl.t_hi - tl.t_lo + 1);

  auto load_kv = [&](int64_t t, int stage) {
    const uint32_t s = kv_s + stage * STAGE;
    load_swizzled<BK, DP>(s, kb, t * BK, a.Sk, ks, a.D, tid);
    load_swizzled<BK, DP>(s + KV_BYTES, vb, t * BK, a.Sk, ks, a.D, tid);
  };
  load_swizzled<BQ, DP>(q_s, qb, tl.q0, a.Sq, qs, a.D, tid);
  if (nt > 0) load_kv(tl.t_lo, 0);
  cp_async_commit();

  // accumulator layout of m64nN: register i of lane l in warp w of the
  // warpgroup is row w*16 + l/4 + 8*((i/2)%2), column (i/4)*8 + (l%4)*2 +
  // i%2.  This thread's rows are row0 and row0 + 8.
  const int64_t row0 = tl.q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const float sl2 = a.scale * LOG2E;
  const bool plain = !(a.softcap > 0.f);
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG2, NEG_BIG2}, l[2] = {0.f, 0.f};   // l: this
                                                           // thread's part

  for (int it = 0; it < nt; ++it) {
    const int64_t k0 = (tl.t_lo + it) * BK;
    cp_async_wait_all();   // this thread's copies of tile `it` landed
    fence_proxy_async();   // ... and are visible to wgmma
    // everyone's copies landed, and both warpgroups retired the wgmmas of
    // tile it-1, whose stage the next load overwrites
    __syncthreads();
    if (it + 1 < nt) load_kv(tl.t_lo + it + 1, (it + 1) & 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + (it & 1) * STAGE, v_s = k_s + KV_BYTES;

    // S = Q . K^T: both K-major; per k16 slice +32 bytes within an atom,
    // the next atom ROWS * 128 bytes on; 8-row groups 1024 bytes apart
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(s,
                   sw128_desc(q_s + (kk >> 2) * (BQ * 128) + wg * 64 * 128 +
                                  off, 16, 1024),
                   sw128_desc(k_s + (kk >> 2) * (BK * 128) + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragments, in log2 units.  Tiles no mask
    // crosses keep the raw products: the max is taken on them and the
    // scale folds into the exponent's FMA.
    const bool fast = plain && sl2 > 0.f && !tl.edge(a, k0, BK);
    const float mul = fast ? sl2 : 1.f;
    if (!fast) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = masked_logit(a, s[i], row0 + 8 * ((i >> 1) & 1),
                            k0 + (i >> 2) * 8 + col0 + (i & 1));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * mul);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= corr[h];
    }
    // P in bf16 pairs: the register-A fragment of k16 slice kk is
    // {s[8kk], s[8kk+1]}, {s[8kk+2], s[8kk+3]}, {s[8kk+4], s[8kk+5]},
    // {s[8kk+6], s[8kk+7]} (rows r, r+8, r, r+8; columns 0-7, 8-15)
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, h = j & 1;
        const float p0 = ex2(fmaf(s[i], mul, neg_m[h]));
        const float p1 = ex2(fmaf(s[i + 1], mul, neg_m[h]));
        l[h] += p0 + p1;
        p[kk][j] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P . V: V MN-major (keys x D, D contiguous); per k16 slice 16
    // key rows (2048 bytes) on, 64-column atoms BK * 128 bytes apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DP, BK>(o, p[kk], v_s + kk * 2048);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    // a block call: the row's lse, once a quad (its 4 lanes agree)
    if (a.lse != nullptr && (lane & 3) == 0 && row0 + 8 * h < a.Sq)
      a.lse[(b * a.Hq + hq) * a.Sq + row0 + 8 * h] =
          (m[h] + log2f(lc)) * LN2;
    l[h] = 1.f / lc;
  }
  // D is a multiple of 8 here: a column pair is both in or both out.  A
  // block call writes fp32 pairs.
  float* of = static_cast<float*>(a.o) + b * a.Sq * qs + (int64_t)hq * a.D;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int h = (i >> 1) & 1;
    const int64_t row = row0 + 8 * h;
    const int col = (i >> 2) * 8 + col0;
    if (row < a.Sq && col < a.D) {
      if (a.lse != nullptr)
        *reinterpret_cast<float2*>(of + row * qs + col) =
            make_float2(o[i] * l[h], o[i + 1] * l[h]);
      else
        *reinterpret_cast<__nv_bfloat162*>(ob + row * qs + col) =
            __floats2bfloat162_rn(o[i] * l[h], o[i + 1] * l[h]);
    }
  }
}

// ------------------------------------------------------------ f32 path --

// Rows r0 .. r0+ROWS-1 (of n_rows; stride rs elements) of a (rows, D)
// matrix into ROWS x DP fp32 of shared memory at dst (row stride ds
// floats, a multiple of 4); rows past n_rows and columns past D are
// zero-filled.  VEC: the source is fp32 with D a multiple of 4, copied 16
// bytes at a time by cp.async, or (the split path) bf16 with D a multiple
// of 8, read 16 bytes at a time and widened; else element by element,
// converted to fp32.
template <int ROWS, int DP, bool VEC, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ds, const T* src,
                                          int64_t r0, int64_t n_rows,
                                          int64_t rs, int D, int tid) {
  if constexpr (VEC && sizeof(T) == 2) {
    constexpr int CPR = DP / 8;
    for (int e = tid; e < ROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (r0 + r < n_rows && c * 8 < D) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c * 8);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(h[0]),
                     f1 = __bfloat1622float2(h[1]),
                     f2 = __bfloat1622float2(h[2]),
                     f3 = __bfloat1622float2(h[3]);
        lo = make_float4(f0.x, f0.y, f1.x, f1.y);
        hi = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
      *reinterpret_cast<float4*>(dst + r * ds + c * 8) = lo;
      *reinterpret_cast<float4*>(dst + r * ds + c * 8 + 4) = hi;
    }
  } else if constexpr (VEC) {
    constexpr int CPR = DP / 4;
    static_assert(ROWS * CPR % THREADS == 0, "whole passes");
#pragma unroll
    for (int pass = 0; pass < ROWS * CPR / THREADS; ++pass) {
      const int e = tid + pass * THREADS, r = e / CPR, c = e % CPR;
      const bool ok = r0 + r < n_rows && c * 4 < D;
      cp_async16(smem_u32(dst + r * ds + c * 4),
                 ok ? src + (r0 + r) * rs + c * 4 : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      dst[r * ds + c] = (r0 + r < n_rows && c < D)
                            ? to_f32(src[(r0 + r) * rs + c]) : 0.f;
    }
  }
}

__host__ __device__ constexpr int fma_smem_bytes(int dp, int st) {
  return (fma_bq(dp) * (dp + 4) + st * FMA_BK * (dp + 4) +
          st * FMA_BK * dp + fma_bq(dp) * (FMA_BK + 4)) * 4;
}

// DP: D padded to 64, 128 or 256; ST: K/V stages (2, or 1 at DP >= 128,
// where two do not fit in shared memory)
template <typename T, int DP, int ST, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_fma_kernel(const Args a) {
  constexpr int BQ = fma_bq(DP), BK = FMA_BK;
  constexpr int RI = BQ / 16;               // query rows per thread
  constexpr int QP = DP + 4, PP = BK + 4;   // padded row strides (floats)
  constexpr int NC = DP / 16;               // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);   // [BQ][QP]
  float* Ks = Qs + BQ * QP;                         // [ST][BK][QP]
  float* Vs = Ks + ST * BK * QP;                    // [ST][BK][DP]
  float* Ps = Vs + ST * BK * DP;                    // [BQ][PP]

  // thread (ty, tx): rows ty + 16i (i < RI), keys tx + 16j (j < 4), output
  // columns 64h + 4tx .. +3 (h < DP/64); a row's 16 threads are one
  // half-warp
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hq = blockIdx.x, hk = hq / (a.Hq / a.Hkv);
  const int64_t b = blockIdx.z;
  const int64_t qs = (int64_t)a.Hq * a.D, ks = (int64_t)a.Hkv * a.D;
  const T* qb = static_cast<const T*>(a.q) + b * a.Sq * qs +
                (int64_t)hq * a.D;
  const T* kb = static_cast<const T*>(a.k) + b * a.Sk * ks +
                (int64_t)hk * a.D;
  const T* vb = static_cast<const T*>(a.v) + b * a.Sk * ks +
                (int64_t)hk * a.D;
  T* ob = static_cast<T*>(a.o) + b * a.Sq * qs + (int64_t)hq * a.D;
  const Tiles tl(a, BQ, BK);
  const int nt = (int)(tl.t_hi - tl.t_lo + 1);

  auto load_kv = [&](int64_t t, int stage) {
    load_rows<BK, DP, VEC>(Ks + stage * BK * QP, QP, kb, t * BK, a.Sk, ks,
                           a.D, tid);
    load_rows<BK, DP, VEC>(Vs + stage * BK * DP, DP, vb, t * BK, a.Sk, ks,
                           a.D, tid);
  };
  load_rows<BQ, DP, VEC>(Qs, QP, qb, tl.q0, a.Sq, qs, a.D, tid);
  if (nt > 0) load_kv(tl.t_lo, 0);
  cp_async_commit();

  const float sl2 = a.scale * LOG2E;
  const bool plain = !(a.softcap > 0.f);
  float acc[RI][NC], m[RI], l[RI];   // l: this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_BIG2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    const int64_t k0 = (tl.t_lo + it) * BK;
    if constexpr (ST == 1) {
      if (it > 0) {
        __syncthreads();   // tile it-1's K and V reads are done
        load_kv(tl.t_lo + it, 0);
        cp_async_commit();
      }
      cp_async_wait_all();
      __syncthreads();
    } else {
      cp_async_wait_all();   // this thread's copies of tile `it` landed
      __syncthreads();       // everyone's; tile it-1's reads are done
      if (it + 1 < nt) load_kv(tl.t_lo + it + 1, (it + 1) % ST);
      cp_async_commit();
    }
    const float* Kt = Ks + (it % ST) * BK * QP;
    const float* Vt = Vs + (it % ST) * BK * DP;

    // S = Q.K^T: per 4 dims, a float4 of each of the RI rows (the same
    // address across a quarter-warp) and of each of the 4 keys
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // log2 units; tiles no mask crosses keep the raw products and fold
    // the scale into the exponent's FMA
    const bool fast = plain && sl2 > 0.f && !tl.edge(a, k0, BK);
    const float mul = fast ? sl2 : 1.f;
    float corr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fast)
          s[i][j] = masked_logit(a, s[i][j], tl.q0 + ty + 16 * i,
                                 k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx * mul);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(fmaf(s[i][j], mul, -m_new));
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr[i] + sum;
    }
    __syncwarp();   // P's rows are this half-warp's own

    // O += P.V: per 4 keys, a float4 of P of each of the RI rows and a
    // float4 of V of each key
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int h = 0; h < DP / 64; ++h) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              Vt + (kk + u) * DP + 64 * h + 4 * tx);
          vv[4 * h] = v4.x;
          vv[4 * h + 1] = v4.y;
          vv[4 * h + 2] = v4.z;
          vv[4 * h + 3] = v4.w;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                         : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off, 16);
    const int64_t row = tl.q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
    // a block call: the row's lse, once a half-warp (its lanes agree)
    if (a.lse != nullptr && tx == 0)
      a.lse[(b * a.Hq + hq) * a.Sq + row] = (m[i] + log2f(lc)) * LN2;
    T* orow = ob + row * qs;
    // a block call on bf16 inputs writes fp32 (on fp32 inputs T is float)
    float* orow32 = static_cast<float*>(a.o) +
                    (b * a.Sq + row) * qs + (int64_t)hq * a.D;
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      const int col = 64 * h + 4 * tx;
      if (sizeof(T) != 4 && a.lse != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < a.D) orow32[col + c] = acc[i][4 * h + c] * inv;
      } else if constexpr (VEC) {   // fp32, D a multiple of 4: float4s
        if (col < a.D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                          acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < a.D) put(orow + col + c, acc[i][4 * h + c] * inv);
      }
    }
  }
}

// ---------------------------------------------------------- split path --

constexpr int SP_BQ = 64;        // query rows per CTA
constexpr int SP_BK = 64;        // keys per tile
constexpr int SP_DS = 64;        // D columns a slice of the score product
constexpr int SP_DV = 256;       // output (V and O) columns per CTA
constexpr int SP_QP = SP_DS + 4, SP_PP = SP_BK + 4;   // padded strides

__host__ __device__ constexpr int split_smem_bytes() {
  return (SP_BQ * SP_QP + SP_BK * SP_QP + SP_BK * SP_DV + SP_BQ * SP_PP) * 4;
}
__host__ __device__ constexpr int split_slices(int d) {
  return (d + SP_DV - 1) / SP_DV;
}

// D > 256: columns dv0 .. dv0 + 255 of the output, blockIdx.z = batch x
// slices + slice.  VEC: fp32 with D a multiple of 4 (16-byte copies), or
// bf16 with D a multiple of 8 (16-byte reads).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_split_kernel(const Args a) {
  constexpr int BQ = SP_BQ, BK = SP_BK;
  constexpr int RI = BQ / 16;               // query rows per thread
  constexpr int NC = SP_DV / 16;            // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);   // [BQ][SP_QP]
  float* Ks = Qs + BQ * SP_QP;                      // [BK][SP_QP]
  float* Vs = Ks + BK * SP_QP;                      // [BK][SP_DV]
  float* Ps = Vs + BK * SP_DV;                      // [BQ][SP_PP]

  // thread (ty, tx): rows ty + 16i, keys tx + 16j, output columns
  // dv0 + 64h + 4tx .. +3 (h < 4); a row's 16 threads are one half-warp
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ns = split_slices(a.D);
  const int hq = blockIdx.x, hk = hq / (a.Hq / a.Hkv);
  const int64_t b = blockIdx.z / ns;
  const int dv0 = (int)(blockIdx.z % ns) * SP_DV;
  const int64_t qs = (int64_t)a.Hq * a.D, ks = (int64_t)a.Hkv * a.D;
  const T* qb = static_cast<const T*>(a.q) + b * a.Sq * qs +
                (int64_t)hq * a.D;
  const T* kb = static_cast<const T*>(a.k) + b * a.Sk * ks +
                (int64_t)hk * a.D;
  const T* vb = static_cast<const T*>(a.v) + b * a.Sk * ks +
                (int64_t)hk * a.D;
  const Tiles tl(a, BQ, BK);
  const int nt = (int)(tl.t_hi - tl.t_lo + 1);

  const float sl2 = a.scale * LOG2E;
  const bool plain = !(a.softcap > 0.f);
  float acc[RI][NC], m[RI], l[RI];   // l: this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_BIG2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    const int64_t k0 = (tl.t_lo + it) * BK;
    __syncthreads();   // tile it-1's reads of V are done
    load_rows<BK, SP_DV, VEC>(Vs, SP_DV, vb + dv0, k0, a.Sk, ks, a.D - dv0,
                              tid);
    // S = Q.K^T, a 64-column slice of D at a time
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < a.D; d0 += SP_DS) {
      load_rows<BQ, SP_DS, VEC>(Qs, SP_QP, qb + d0, tl.q0, a.Sq, qs,
                                a.D - d0, tid);
      load_rows<BK, SP_DS, VEC>(Ks, SP_QP, kb + d0, k0, a.Sk, ks, a.D - d0,
                                tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < SP_DS; d += 4) {
        float4 qv[RI], kv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * SP_QP +
                                                   d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * SP_QP +
                                                   d);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      __syncthreads();   // before the next slice lands on Q and K
    }

    // the online softmax, as on the fma path
    const bool fast = plain && sl2 > 0.f && !tl.edge(a, k0, BK);
    const float mul = fast ? sl2 : 1.f;
    float corr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fast)
          s[i][j] = masked_logit(a, s[i][j], tl.q0 + ty + 16 * i,
                                 k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx * mul);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(fmaf(s[i][j], mul, -m_new));
        sum += p;
        Ps[(ty + 16 * i) * SP_PP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr[i] + sum;
    }
    __syncwarp();   // P's rows are this half-warp's own

    // O += P.V over this CTA's 256 columns
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * SP_PP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int h = 0; h < SP_DV / 64; ++h) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              Vs + (kk + u) * SP_DV + 64 * h + 4 * tx);
          vv[4 * h] = v4.x;
          vv[4 * h + 1] = v4.y;
          vv[4 * h + 2] = v4.z;
          vv[4 * h + 3] = v4.w;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                         : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off, 16);
    const int64_t row = tl.q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
    // a block call: the row's lse, once a row (the first slice's CTA)
    if (a.lse != nullptr && tx == 0 && dv0 == 0)
      a.lse[(b * a.Hq + hq) * a.Sq + row] = (m[i] + log2f(lc)) * LN2;
    T* orow = static_cast<T*>(a.o) + (b * a.Sq + row) * qs +
              (int64_t)hq * a.D + dv0;
    // a block call on bf16 inputs writes fp32 (on fp32 inputs T is float)
    float* orow32 = static_cast<float*>(a.o) + (b * a.Sq + row) * qs +
                    (int64_t)hq * a.D + dv0;
#pragma unroll
    for (int h = 0; h < SP_DV / 64; ++h) {
      const int col = 64 * h + 4 * tx;
      if (sizeof(T) != 4 && a.lse != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (dv0 + col + c < a.D) orow32[col + c] = acc[i][4 * h + c] * inv;
      } else if constexpr (VEC && sizeof(T) == 4) {   // float4s
        if (dv0 + col < a.D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                          acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (dv0 + col + c < a.D) put(orow + col + c, acc[i][4 * h + c] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------- host --

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, const Args& a,
                   dim3 grid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wgmma(const Args& a, dim3 grid, cudaStream_t st) {
  return launch(flash_fwd_wgmma_kernel<DP>, THREADS,
                wgmma_smem_bytes(DP, WG_BK), a, grid, st);
}

template <typename T, int DP, int ST>
cudaError_t launch_fma(const Args& a, bool vec, dim3 grid, cudaStream_t st) {
  constexpr int smem = fma_smem_bytes(DP, ST);
  if constexpr (sizeof(T) == 4) {
    if (vec)
      return launch(flash_fwd_fma_kernel<T, DP, ST, true>, THREADS, smem, a,
                    grid, st);
  }
  return launch(flash_fwd_fma_kernel<T, DP, ST, false>, THREADS, smem, a,
                grid, st);
}

template <typename T>
cudaError_t launch_split(const Args& a, bool vec, dim3 grid, cudaStream_t st) {
  constexpr int smem = split_smem_bytes();
  if (vec)
    return launch(flash_fwd_split_kernel<T, true>, THREADS, smem, a, grid,
                  st);
  return launch(flash_fwd_split_kernel<T, false>, THREADS, smem, a, grid, st);
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (b, sq, hq, d), k and v (b, sk, hkv,
// d) and o (b, sq, hq, d) are contiguous device buffers of that type.
// softcap <= 0 means none; window <= 0 means none.  path: 1 = wgmma (bf16
// with d <= 256 a multiple of 8), 0 = fma (any other d <= 256), 2 = split
// (d > 256), as kernels/flash_attention.py::plan picks it; each path's
// tiles and stages follow from d here.  Where a path copies 16 bytes at a
// time (wgmma; fma and split on fp32 with d a multiple of 4; split on bf16
// with d a multiple of 8) the buffers must be 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success).  delta: query row i sits at position i + delta (0 for a
// one-device call).  lse: null for a one-device call; else a block call,
// o is fp32 whatever `dtype` and lse (b, hq, sq) fp32 receives each row's
// log-sum-exp.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int64_t b, int64_t sq, int64_t sk,
                                     int64_t hq, int64_t hkv, int64_t d,
                                     float scale, float softcap, int causal,
                                     int64_t window, int path, int64_t delta,
                                     float* lse, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 ||
      d < 1 || d > 0x7fffffffLL || (dtype != 0 && dtype != 1) || path < 0 ||
      path > 2 || (path == 2) != (d > 256) ||
      (path == 1 && (dtype != 1 || d % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const bool vec = path == 1 || (dtype == 0 && d % 4 == 0) ||
                   (path == 2 && d % 8 == 0);
  if (vec && (misaligned(q) || misaligned(k) || misaligned(v) ||
              misaligned(o)))
    return (int)cudaErrorMisalignedAddress;
  const int tile_q = path == 1 ? WG_BQ : path == 2 ? SP_BQ : fma_bq(dp);
  const int64_t tiles_q = (sq + tile_q - 1) / tile_q;
  const int64_t bz = path == 2 ? b * split_slices((int)d) : b;
  if (tiles_q > 65535 || bz > 65535 || hq > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.Sq = sq; a.Sk = sk; a.window = window; a.delta = delta;
  a.Hq = (int)hq; a.Hkv = (int)hkv; a.D = (int)d; a.causal = causal != 0;
  a.tiles_q = (int)tiles_q;
  a.scale = scale; a.softcap = softcap;
  // the query tile is the grid's slow dimension: with causality the
  // longest tiles of every head go first
  const dim3 grid((unsigned)hq, (unsigned)tiles_q, (unsigned)bz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2)
    return (int)(dtype == 0 ? launch_split<float>(a, vec, grid, st)
                            : launch_split<bf16>(a, vec, grid, st));
  if (path == 1)
    return (int)(dp == 64    ? launch_wgmma<64>(a, grid, st)
                 : dp == 128 ? launch_wgmma<128>(a, grid, st)
                             : launch_wgmma<256>(a, grid, st));
  if (dtype == 0)
    return (int)(dp == 64    ? launch_fma<float, 64, 2>(a, vec, grid, st)
                 : dp == 128 ? launch_fma<float, 128, 1>(a, vec, grid, st)
                             : launch_fma<float, 256, 1>(a, vec, grid, st));
  return (int)(dp == 64    ? launch_fma<bf16, 64, 2>(a, false, grid, st)
               : dp == 128 ? launch_fma<bf16, 128, 1>(a, false, grid, st)
                           : launch_fma<bf16, 256, 1>(a, false, grid, st));
}
