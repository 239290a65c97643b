// The backward of the Mamba-2 SSD scan for Hopper (sm_90a), CUDA C++ with
// a plain C interface loaded through ctypes (see
// repro_torch/kernels/common.py).
//
// Replaces: no TPU kernel.  It is the gradient of
// src/repro/kernels/mamba2_ssd/kernel.py::ssd_bhtp (the Pallas kernel,
// pl.pallas_call at kernel.py:83), which JAX takes of its jnp
// ``ssd_chunked`` (src/repro/models/mamba2.py:68).  The port launches the
// forward kernel (mamba2_ssd.cu) on every CUDA forward, so training needs
// this backward behind ops.SsdFn.
//
// What it computes (ref.ssd_bwd_plain, in the same factoring), per batch
// row b and head h, given dy_t and dh_T (dhT): the forward is h_t =
// exp(l_t) h_{t-1} + dt_t x_t B_t^T, l_t = dt_t A, y_t = h_t C_t.  The
// adjoint G_t = dy_t C_t^T + exp(l_{t+1}) G_{t+1} runs backward from dhT.
// With L the inclusive cumulative sum of l over a chunk of kChunk steps,
// M[t,s] = exp(L_t - L_s) (s <= t), X[t,s] = dy_t . x_s, CB[t,s] = C_t .
// B_s, h0 the chunk's start state and Gc the adjoint arriving at its end:
//   dC_t (head h) = exp(L_t) h0^T dy_t + sum_{s<=t} M X[t,s] dt_s B_s
//   gx_s = exp(L_c - L_s) Gc B_s + sum_{t>=s} M CB[t,s] dy_t,  dx = dt gx
//   dB_s (head h) = dt_s (exp(L_c - L_s) Gc^T x_s + sum_{t>=s} M X[t,s] C_t)
//   dl_t = exp(l_t) G_t . h_{t-1}
//        = exp(L_c) (h0 . Gc) + sum_{tau>=t} exp(L_tau) C_tau . (h0^T dy_tau)
//          + sum_{s<t} exp(L_c - L_s) dt_s x_s . (Gc B_s)
//          + sum_{s<t<=tau} M[tau,s] dt_s X[tau,s] CB[tau,s]
//   ddt = A dl + x . gx,  dA = sum over B and T of dt dl.
// dl is taken term by term, not as the reverse sum of C . dC - x . dx that
// the same identity also gives: under strong decay (zamba2's dt A reaches
// -16 a step) that sum's terms are far larger than dl, and even anchored
// at every chunk's end its rounding missed dA by up to 3.6e-3 of dA's
// largest entry at A = -exp(normal + 3) over 512 steps, against 1.8e-5
// term by term (scripts/recurrent_bwd_precision.py, float64 reference).
// Every exponent is <= 0 (a scan's rounding is clamped).  Steps t >= T are
// dt = 0, dy = 0 and get no gradient written.
//
// What bounds it on an H100, at zamba2-2.7b's training shape (B=4, T=2048,
// H=80, P=N=64): about 39 G operations, of which the products (the two
// boundary scans, X, Gc B, h0^T dy, Gc^T x, dC, gx and dB) are 32 G; on
// TF32 tensor cores with the three-term split they take about 0.2 ms.
// The bytes: x and dy read twice, the two (B, H, nc+1, P, N) boundary
// tensors (341 MB each) written once and read once, dx written, about 2.2
// GB or 0.66 ms at 3.35 TB/s: they, not the products, bound this design
// (chip_smoke.py prints both bounds beside its time).  The first version (one block per (b, h)
// walking the 64 chunks in series, every product a CUDA-core FMA loop,
// serial sections on one thread, dB and dC one row per head) took 9.16 ms.
// This design takes the sequential chain off the critical path:
//  * ssd_bwd_scan_kernel runs the two chunk-boundary recurrences, one
//    block per (32 state rows, h, b, direction): the forward state h' =
//    exp(L_c) h + ((x dt) o exp(L_c - L))^T B, written at every chunk's
//    start (states), and the adjoint Gc <- exp(L_c) Gc + (dy o exp(L))^T C
//    from dhT, written at every chunk's start (adj; entry j + 1 is chunk
//    j's Gc, entry 0 dh0).  Both are 32 x c . c x N products a chunk, on
//    tensor cores as the forward's state product is, the state held in
//    the accumulators across the sequence; L is a warp-shuffle scan.  Its
//    k loop is not unrolled: at 117 registers four blocks of 128 threads
//    share an SM (scripts/k5_bwd_variants.py, scan_unroll_2).
//  * ssd_bwd_chunk_kernel: one block of 8 warps per (chunk, group of
//    kGroup heads, b), 2560 blocks at the training shape, every chunk in
//    parallel, each warp a 16 x 16 tile of every 32 x 64 product.  It reads
//    its chunk's h0 and Gc from the scan's tensors, computes CB once for
//    the group, and walks the group's heads: X, Gc B, h0^T dy, Gc^T x, dC,
//    gx and dB on tensor cores (TF32 x 3); M, the rectangle of dl and the
//    scans of E and F on CUDA cores, spread over the block (the rectangle
//    in O(c^2): each warp owns 4 columns s, takes their suffix sums over
//    tau >= t by a warp scan and adds those at s < t).  A head's x and dy
//    are staged by cp.async while the previous head computes, its h0 while
//    the previous head's later phases run and its Gc once the previous
//    head's products are done, so that two blocks share an SM (113 KB of
//    shared memory each; no value but the group's sums is carried across
//    a barrier in registers).  dB and dC are
//    summed over the group's heads in registers in a fixed order and leave
//    one row per group (B, T, ceil(H / kGroup), N); dA leaves one value per
//    (b, chunk, h).  The wrapper sums both in a fixed order.  No atomics:
//    two calls give the same bits.
// Any P, N <= 64 (the tiles are padded to 64 with zeros in shared memory);
// 16-byte cp.async where every row start is 16-byte aligned and P and N are
// multiples of 4, else 4-byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_mma.cuh"

namespace {

using namespace ssd;

constexpr int kDim = 64;          // P and N are padded to this
constexpr int kScanRows = 32;     // state rows per scan block
constexpr int kScanThreads = 128;
constexpr int kThreads = 256;     // chunk kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;         // heads a chunk-kernel block (ops.HEAD_GROUP)

struct Strides {
  long long b, t, h;
};

// R rows of C floats into shared memory (leading dimension ld): row r
// from src + r * stride, its columns c < ncols, rows r < nrows; the rest
// zero.  vec: 16-byte copies (16-byte aligned rows, ncols % 4 == 0), else
// 4-byte ones.  UNROLL4: the 16-byte loop unrolled by four (the scans),
// or not at all (the chunk kernel, where the unrolled loops' addresses
// pushed it past 128 registers a thread into spills).
template <int R, int C, int NT, bool UNROLL4>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src, long long stride,
                                           int nrows, int ncols, bool vec,
                                           int tid) {
  constexpr int Q = C / 4;
  auto copy16 = [&](int i) {
    const int r = i / Q, c = (i % Q) * 4;
    const bool in = r < nrows && c < ncols;
    cp_async16(dst + r * ld + c, src + (in ? r * stride + c : 0), in);
  };
  if (vec) {
    if constexpr (UNROLL4) {
#pragma unroll 4
      for (int i = tid; i < R * Q; i += NT) copy16(i);
    } else {
#pragma unroll 1
      for (int i = tid; i < R * Q; i += NT) copy16(i);
    }
  } else {
    for (int i = tid; i < R * C; i += NT) {
      const int r = i / C, c = i % C;
      const bool in = r < nrows && c < ncols;
      cp_async4(dst + r * ld + c, src + (in ? r * stride + c : 0), in);
    }
  }
}

// One warp's (16 x 8 NT) tile of D += A B on TF32 x 3 over k steps ks0 <=
// ks < ks1 of 8.  fa(ks, a) gives this lane's A values of step ks in
// fragment order: (row g, k), (g + 8, k), (g, k'), (g + 8, k'); fb(ks, j,
// b) its B values (k, column g of n-tile j), (k', g).  The loaders choose
// which k and k' a lane's tig stands for (tig and tig + 4, or 2 tig and 2
// tig + 1, whichever reads shared memory without bank conflicts); A and B
// of one product agree, so the sum is the same.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma_step(float (&d)[NT][4],
                                              float (&dx)[NT][4], int ks,
                                              FA& fa, FB& fb) {
  float a[4];
  fa(ks, a);
  uint32_t ah[4], al[4];
  split_a(a[0], a[1], a[2], a[3], ah, al);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float bv[2];
    fb(ks, j, bv);
    uint32_t bh[2], bl[2];
    split(bv[0], bh[0], bl[0]);
    split(bv[1], bh[1], bl[1]);
    mma3(d[j], dx[j], ah, al, bh, bl);
  }
}

// The k loop two steps at a time (the chunk kernel's products)...
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&d)[NT][4],
                                         float (&dx)[NT][4], int ks0,
                                         int ks1, FA fa, FB fb) {
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) warp_mma_step<NT>(d, dx, ks, fa, fb);
}

// ... or one at a time (the scans: fewer registers, more resident blocks)
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma_rolled(float (&d)[NT][4],
                                                float (&dx)[NT][4], int ks0,
                                                int ks1, FA fa, FB fb) {
#pragma unroll 1
  for (int ks = ks0; ks < ks1; ++ks) warp_mma_step<NT>(d, dx, ks, fa, fb);
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
}

// Lane t's inclusive cumulative sum of v over lanes 0..t.
__device__ __forceinline__ float warp_cumsum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kAll, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// Lane t's sum of v over lanes t..31.
__device__ __forceinline__ float warp_suffix_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kAll, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// An (rows, cols) element pair (c, c + 1) of row-major storage with row
// length ld: float2 where both fit and ld is even, else element by element.
__device__ __forceinline__ void store_pair(float* row, int c, int cols,
                                           bool even, float v0, float v1) {
  if (even && c + 1 < cols) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < cols) row[c] = v0;
    if (c + 1 < cols) row[c + 1] = v1;
  }
}

// --- the chunk-boundary scans -----------------------------------------------

constexpr int kLdU = 36;          // [t][p] rows of 32 + 4: A read down columns
constexpr int kLdV = 68;          // [t][n] rows of 64 + 4: B read down columns

struct ScanStage {
  float u[kChunk * kLdU];         // x (forward) or dy (adjoint): 32 rows of P
  float v[kChunk * kLdV];         // B (forward) or C (adjoint)
  float dt[kChunk];
};

// blockIdx: (x) 32 state rows, (y) head, (z) 2 b + direction (0: the
// forward states, 1: the adjoint).  out[b, h] is (nc + 1, P, N).
__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ h0, const float* __restrict__ dhT,
                    float* __restrict__ states, float* __restrict__ adj, int T,
                    int H, int P, int N, Strides xs, Strides ys, Strides ds,
                    long long bm_sb, long long bm_st, long long cm_sb,
                    long long cm_st, int vec) {
  __shared__ __align__(16) ScanStage stg[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int p0 = blockIdx.x * kScanRows, h = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool fwd = (blockIdx.z & 1) == 0;
  const int nc = (T + kChunk - 1) / kChunk;
  const int prow = min(kScanRows, P - p0);
  const float a = A[h];
  const float* u = fwd ? x + b * xs.b + h * xs.h + p0
                       : dy + b * ys.b + h * ys.h + p0;
  const long long ust = fwd ? xs.t : ys.t;
  const float* v = fwd ? Bm + b * bm_sb : Cm + b * cm_sb;
  const long long vst = fwd ? bm_st : cm_st;
  const float* dtp = dt + b * ds.b + h * ds.h;
  const long long PN = (long long)P * N;
  float* out = (fwd ? states : adj) + ((long long)b * H + h) * (nc + 1) * PN;
  const float* init = fwd ? h0 : dhT;   // dhT may be null: zero

  // this warp's 16 x 32 tile of the block's 32 x 64 state: rows wr + g
  // (+8), n-tile jn columns wc + 8 jn + 2 tig (+1)
  const int wr = 16 * (warp & 1), wc = 32 * (warp >> 1);
  const bool evenN = (N & 1) == 0;
  float hs[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wr + g + 8 * (i >> 1), c = wc + 8 * jn + 2 * tig + (i & 1);
      hs[jn][i] = init != nullptr && r < prow && c < N
                      ? init[((long long)b * H + h) * PN +
                             (long long)(p0 + r) * N + c]
                      : 0.f;
    }
  auto store = [&](int slot) {
    float* o = out + (long long)slot * PN;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = wr + g + 8 * r2;
        if (r < prow)
          store_pair(o + (long long)(p0 + r) * N, wc + 8 * jn + 2 * tig, N,
                     evenN, hs[jn][2 * r2], hs[jn][2 * r2 + 1]);
      }
  };
  auto stage = [&](ScanStage& s, int j) {
    const int t0 = j * kChunk, nt = min(kChunk, T - t0);
    stage_tile<kChunk, kScanRows, kScanThreads, true>(
        s.u, kLdU, u + t0 * ust, ust, nt, prow, vec, tid);
    stage_tile<kChunk, kDim, kScanThreads, true>(
        s.v, kLdV, v + t0 * vst, vst, nt, N, vec, tid);
    if (tid < kChunk)
      cp_async4(&s.dt[tid], dtp + (tid < nt ? (t0 + tid) * ds.t : 0),
                tid < nt);
  };

  stage(stg[0], fwd ? 0 : nc - 1);
  cp_async_commit();
  for (int it = 0; it < nc; ++it) {
    const int j = fwd ? it : nc - 1 - it;
    if (it + 1 < nc) {
      stage(stg[(it + 1) & 1], fwd ? j + 1 : j - 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    store(fwd ? j : j + 1);             // the state at the chunk's start
    const ScanStage& s = stg[it & 1];
    const float L = warp_cumsum(s.dt[lane] * a, lane);   // lane t: L_t
    const float Lc = __shfl_sync(kAll, L, kChunk - 1);
    // the scale of step t's outer product: dt exp(L_c - L) for the state,
    // exp(L) for the adjoint (both <= 1 where dt <= 1)
    const float f = fwd ? s.dt[lane] * __expf(fminf(Lc - L, 0.f))
                        : __expf(fminf(L, 0.f));
    // the carried state's decay over the chunk, in both directions
    const float carry = __expf(fminf(Lc, 0.f));
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[jn][i] *= carry;
    float hx[4][4];
    zero(hx);
    // A[p][k = t] = u[t][p] f_t, B[k = t][n] = v[t][n]; k = 2 tig, 2 tig + 1
    warp_mma_rolled<4>(
        hs, hx, 0, kChunk / 8,
        [&](int ks, float (&av)[4]) {
          const int t = 8 * ks + 2 * tig;
          const float fa = __shfl_sync(kAll, f, t);
          const float fb = __shfl_sync(kAll, f, t + 1);
          const float* r0 = &s.u[t * kLdU + wr + g];
          av[0] = r0[0] * fa;
          av[1] = r0[8] * fa;
          av[2] = r0[kLdU] * fb;
          av[3] = r0[kLdU + 8] * fb;
        },
        [&](int ks, int jn, float (&bv)[2]) {
          const int t = 8 * ks + 2 * tig;
          bv[0] = s.v[t * kLdV + wc + 8 * jn + g];
          bv[1] = s.v[(t + 1) * kLdV + wc + 8 * jn + g];
        });
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[jn][i] += hx[jn][i];
    __syncthreads();                    // the stage is refilled next
  }
  store(fwd ? nc : 0);
}

// --- the chunk-parallel adjoint kernel ---------------------------------------

// Padded rows, chosen so that every fragment load is free of bank
// conflicts: 68 (x, dy) and 36 (M X dt and its transpose) where a product
// reads rows g with columns tig, tig + 4, or columns 2 tig, 2 tig + 1 down
// rows; 72 (B, C, h0, Gc) and 40 (M CB, transposed) where rows g are read
// as pairs 2 tig, 2 tig + 1 or rows tig, tig + 4 down a column; 33 for X,
// read down its columns.
constexpr int kLdX = 68;
constexpr int kLdS = 72;
constexpr int kLdM = 36;
constexpr int kLdT = 40;
constexpr int kLdQ = 33;
constexpr bool kStageUnroll4 = false;   // the chunk kernel's staging loops

struct ChunkSmem {
  float bm[kChunk * kLdS];        // B [s][n], shared by the group
  float cm[kChunk * kLdS];        // C [t][n]
  float x[2][kChunk * kLdX];      // a head's x [s][p], double-buffered
  float dy[2][kChunk * kLdX];     // its dy [t][p]
  float dt[2][kChunk];
  float h0[kDim * kLdS];          // the chunk's start state [p][n]
  float gc[kDim * kLdS];          // the adjoint at its end [p][n]
  float X[kChunk * kLdQ];         // dy_t . x_s
  float mxdt[kChunk * kLdM];      // M X dt [t][s]
  float mxdtT[kChunk * kLdM];     // the same, [s][t]
  float mcbT[kChunk * kLdT];      // M CB [s][t]
  float cbT[kChunk * kChunk];     // CB [s][t], computed once for the group
  float epart[4][kChunk];         // C . (h0^T dy) over each 16 columns n
  float fpart[4][kChunk];         // x . (Gc B) over each 16 columns p
  float xgpart[4][kChunk];        // x . gx over each 16 columns p
  float rect[kWarps][kChunk];     // the rectangle over each warp's 4 s
  float base[kWarps];             // h0 . Gc by warp
};

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ adj, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dA_part,
                     float* __restrict__ dB_part, float* __restrict__ dC_part,
                     int T, int H, int P, int N, Strides xs, Strides ds,
                     long long bm_sb, long long bm_st, long long cm_sb,
                     long long cm_st, Strides ys, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int j = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, ngroups = gridDim.y;
  const int t0 = j * kChunk, nt = min(kChunk, T - t0);
  const int h_first = hg * kGroup, nh = min(kGroup, H - h_first);
  const long long PN = (long long)P * N;
  const bool evenP = (P & 1) == 0, evenN = (N & 1) == 0;

  // this warp's tiles: of a 32 x 64 output rows r0 + g (+8), n-tiles j2 at
  // columns c0 + 8 j2 + 2 tig (+1); of a 32 x 32 one rows r0 + g (+8),
  // columns q0 + 2 tig (+1)
  const int r0 = 16 * (warp & 1), c0 = 16 * (warp >> 1), q0 = 8 * (warp >> 1);
  const int ra = r0 + g, rb = ra + 8;

  auto stage_head = [&](int hi, int buf) {
    const int h = h_first + hi;
    stage_tile<kChunk, kDim, kThreads, kStageUnroll4>(
        sm.x[buf], kLdX, x + b * xs.b + h * xs.h + t0 * xs.t, xs.t, nt, P,
        vec, tid);
    stage_tile<kChunk, kDim, kThreads, kStageUnroll4>(
        sm.dy[buf], kLdX, dy + b * ys.b + h * ys.h + t0 * ys.t, ys.t, nt, P,
        vec, tid);
    if (tid < kChunk)
      cp_async4(&sm.dt[buf][tid],
                dt + b * ds.b + h * ds.h + (tid < nt ? (t0 + tid) * ds.t : 0),
                tid < nt);
  };
  auto stage_h0 = [&](int hi) {       // the chunk's start state
    const long long bh = (long long)b * H + h_first + hi;
    stage_tile<kDim, kDim, kThreads, kStageUnroll4>(
        sm.h0, kLdS, states + (bh * (nc + 1) + j) * PN, N, P, N, vec, tid);
  };
  auto stage_gc = [&](int hi) {       // the adjoint at the chunk's end
    const long long bh = (long long)b * H + h_first + hi;
    stage_tile<kDim, kDim, kThreads, kStageUnroll4>(
        sm.gc, kLdS, adj + (bh * (nc + 1) + j + 1) * PN, N, P, N, vec, tid);
  };

  stage_tile<kChunk, kDim, kThreads, kStageUnroll4>(
      sm.bm, kLdS, Bm + b * bm_sb + t0 * bm_st, bm_st, nt, N, vec, tid);
  stage_tile<kChunk, kDim, kThreads, kStageUnroll4>(
      sm.cm, kLdS, Cm + b * cm_sb + t0 * cm_st, cm_st, nt, N, vec, tid);
  stage_head(0, 0);
  stage_h0(0);
  stage_gc(0);
  cp_async_commit();

  // dB and dC summed over the group's heads: rows ra, rb of this warp's
  // two n-tiles (columns n)
  float dB_acc[2][4], dC_acc[2][4];
  zero(dB_acc);
  zero(dC_acc);

  for (int hi = 0; hi < nh; ++hi) {
    const int h = h_first + hi, buf = hi & 1;
    if (hi + 1 < nh) stage_head(hi + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // this head's x, dy, dt, h0 and Gc
    __syncthreads();
    const float* xs_ = sm.x[buf];
    const float* dys = sm.dy[buf];
    const float a = A[h];
    // --- phase 1: L, X, h0^T dy (E's part, into dC), h0 . Gc ------------
    const float dtr = sm.dt[buf][lane];                  // lane t: dt_t
    const float L = warp_cumsum(dtr * a, lane);          // lane t: L_t
    const float Lc = __shfl_sync(kAll, L, kChunk - 1);
    if (hi == 0) {
      // CB = C B^T for the group (k = n; 2 tig, 2 tig + 1), into cbT
      float d[1][4], e[1][4];
      zero(d);
      zero(e);
      warp_mma<1>(
          d, e, 0, kDim / 8,
          [&](int ks, float (&av)[4]) {
            const float2 u0 = ld2(&sm.cm[ra * kLdS + 8 * ks + 2 * tig]);
            const float2 u1 = ld2(&sm.cm[rb * kLdS + 8 * ks + 2 * tig]);
            av[0] = u0.x; av[1] = u1.x; av[2] = u0.y; av[3] = u1.y;
          },
          [&](int ks, int, float (&bv)[2]) {
            const float2 w = ld2(&sm.bm[(q0 + g) * kLdS + 8 * ks + 2 * tig]);
            bv[0] = w.x; bv[1] = w.y;
          });
      float* o = sm.cbT;
      o[(q0 + 2 * tig) * kChunk + ra] = d[0][0] + e[0][0];
      o[(q0 + 2 * tig + 1) * kChunk + ra] = d[0][1] + e[0][1];
      o[(q0 + 2 * tig) * kChunk + rb] = d[0][2] + e[0][2];
      o[(q0 + 2 * tig + 1) * kChunk + rb] = d[0][3] + e[0][3];
    }
    {
      // X = dy x^T (k = p; tig, tig + 4)
      float d[1][4], e[1][4];
      zero(d);
      zero(e);
      warp_mma<1>(
          d, e, 0, kDim / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + tig;
            av[0] = dys[ra * kLdX + k];
            av[1] = dys[rb * kLdX + k];
            av[2] = dys[ra * kLdX + k + 4];
            av[3] = dys[rb * kLdX + k + 4];
          },
          [&](int ks, int, float (&bv)[2]) {
            const int k = 8 * ks + tig;
            bv[0] = xs_[(q0 + g) * kLdX + k];
            bv[1] = xs_[(q0 + g) * kLdX + k + 4];
          });
      float* o = sm.X;
      o[ra * kLdQ + q0 + 2 * tig] = d[0][0] + e[0][0];
      o[ra * kLdQ + q0 + 2 * tig + 1] = d[0][1] + e[0][1];
      o[rb * kLdQ + q0 + 2 * tig] = d[0][2] + e[0][2];
      o[rb * kLdQ + q0 + 2 * tig + 1] = d[0][3] + e[0][3];
    }
    {
      // h0^T dy (k = p; tig, tig + 4): E's part, then into dC
      float d[2][4], e[2][4];
      zero(d);
      zero(e);
      warp_mma<2>(
          d, e, 0, kDim / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + tig;
            av[0] = dys[ra * kLdX + k];
            av[1] = dys[rb * kLdX + k];
            av[2] = dys[ra * kLdX + k + 4];
            av[3] = dys[rb * kLdX + k + 4];
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const int k = 8 * ks + tig;
            bv[0] = sm.h0[k * kLdS + c0 + 8 * j2 + g];
            bv[1] = sm.h0[(k + 4) * kLdS + c0 + 8 * j2 + g];
          });
      const float ea = __expf(fminf(__shfl_sync(kAll, L, ra), 0.f));
      const float eb = __expf(fminf(__shfl_sync(kAll, L, rb), 0.f));
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int c = c0 + 8 * j2 + 2 * tig;
        const float2 ca = ld2(&sm.cm[ra * kLdS + c]);
        const float2 cb = ld2(&sm.cm[rb * kLdS + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[j2][i] += e[j2][i];
        pa += ca.x * d[j2][0] + ca.y * d[j2][1];
        pb += cb.x * d[j2][2] + cb.y * d[j2][3];
        dC_acc[j2][0] += ea * d[j2][0];
        dC_acc[j2][1] += ea * d[j2][1];
        dC_acc[j2][2] += eb * d[j2][2];
        dC_acc[j2][3] += eb * d[j2][3];
      }
      pa += __shfl_xor_sync(kAll, pa, 1);
      pa += __shfl_xor_sync(kAll, pa, 2);
      pb += __shfl_xor_sync(kAll, pb, 1);
      pb += __shfl_xor_sync(kAll, pb, 2);
      if (tig == 0) {
        sm.epart[warp >> 1][ra] = pa;
        sm.epart[warp >> 1][rb] = pb;
      }
    }
    {
      // h0 . Gc
      float q = 0.f;
#pragma unroll 1
      for (int i = tid; i < kDim * kDim; i += kThreads) {
        const int p = i >> 6, n = i & 63;
        q += sm.h0[p * kLdS + n] * sm.gc[p * kLdS + n];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        q += __shfl_xor_sync(kAll, q, off);
      if (lane == 0) sm.base[warp] = q;
    }
    __syncthreads();
    // h0 is free: the next head's goes in flight
    if (hi + 1 < nh) stage_h0(hi + 1);
    cp_async_commit();
    // --- phase 2: warp w owns columns s = 4 w .. 4 w + 3, lane t --------
    {
      float rect = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 4 * warp + q, t = lane;
        const float Ls = __shfl_sync(kAll, L, s);
        const float dts = sm.dt[buf][s];
        const float m = s <= t ? __expf(fminf(L - Ls, 0.f)) : 0.f;
        const float mxdt = m * sm.X[t * kLdQ + s] * dts;
        const float cb = sm.cbT[s * kChunk + t];
        sm.mxdt[t * kLdM + s] = mxdt;
        sm.mxdtT[s * kLdM + t] = mxdt;
        sm.mcbT[s * kLdT + t] = m * cb;
        // sum_{tau >= t} of M dt X CB at column s (s < tau), taken at s < t
        const float col = warp_suffix_sum(s < t ? mxdt * cb : 0.f, lane);
        rect += s < t ? col : 0.f;
      }
      sm.rect[warp][lane] = rect;
    }
    __syncthreads();
    // --- phase 3: dC, dB and gx ------------------------------------------
    const float back_a = __expf(fminf(Lc - __shfl_sync(kAll, L, ra), 0.f));
    const float back_b = __expf(fminf(Lc - __shfl_sync(kAll, L, rb), 0.f));
    const float dt_a = sm.dt[buf][ra], dt_b = sm.dt[buf][rb];
    {
      // dC += (M X dt) B, k = s <= t (tig, tig + 4)
      float d[2][4], e[2][4];
      zero(d);
      zero(e);
      warp_mma<2>(
          d, e, 0, (r0 + 16) / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + tig;
            av[0] = sm.mxdt[ra * kLdM + k];
            av[1] = sm.mxdt[rb * kLdM + k];
            av[2] = sm.mxdt[ra * kLdM + k + 4];
            av[3] = sm.mxdt[rb * kLdM + k + 4];
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const int k = 8 * ks + tig;
            bv[0] = sm.bm[k * kLdS + c0 + 8 * j2 + g];
            bv[1] = sm.bm[(k + 4) * kLdS + c0 + 8 * j2 + g];
          });
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
        for (int i = 0; i < 4; ++i) dC_acc[j2][i] += d[j2][i] + e[j2][i];
    }
    {
      // this head's dB: dt_s exp(L_c - L_s) Gc^T x_s (k = p; tig, tig +
      // 4), then (M X dt)^T C (k = t >= s; tig, tig + 4)
      float dB_h[2][4], dB_e[2][4];
      zero(dB_h);
      zero(dB_e);
      const float sa = dt_a * back_a, sb = dt_b * back_b;
      warp_mma<2>(
          dB_h, dB_e, 0, kDim / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + tig;
            av[0] = xs_[ra * kLdX + k] * sa;
            av[1] = xs_[rb * kLdX + k] * sb;
            av[2] = xs_[ra * kLdX + k + 4] * sa;
            av[3] = xs_[rb * kLdX + k + 4] * sb;
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const int k = 8 * ks + tig;
            bv[0] = sm.gc[k * kLdS + c0 + 8 * j2 + g];
            bv[1] = sm.gc[(k + 4) * kLdS + c0 + 8 * j2 + g];
          });
      warp_mma<2>(
          dB_h, dB_e, r0 / 8, kChunk / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + tig;
            av[0] = sm.mxdtT[ra * kLdM + k];
            av[1] = sm.mxdtT[rb * kLdM + k];
            av[2] = sm.mxdtT[ra * kLdM + k + 4];
            av[3] = sm.mxdtT[rb * kLdM + k + 4];
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const int k = 8 * ks + tig;
            bv[0] = sm.cm[k * kLdS + c0 + 8 * j2 + g];
            bv[1] = sm.cm[(k + 4) * kLdS + c0 + 8 * j2 + g];
          });
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
        for (int i = 0; i < 4; ++i) dB_acc[j2][i] += dB_h[j2][i] + dB_e[j2][i];
    }
    {
      // gx = exp(L_c - L_s) Gc B_s (k = n; 2 tig, 2 tig + 1), whose rows
      // against x give F's part, + (M CB)^T dy (k = t >= s; 2 tig, 2 tig +
      // 1); dx = dt gx
      float gx[2][4], e[2][4];
      zero(gx);
      zero(e);
      warp_mma<2>(
          gx, e, 0, kDim / 8,
          [&](int ks, float (&av)[4]) {
            const float2 u0 = ld2(&sm.bm[ra * kLdS + 8 * ks + 2 * tig]);
            const float2 u1 = ld2(&sm.bm[rb * kLdS + 8 * ks + 2 * tig]);
            av[0] = u0.x; av[1] = u1.x; av[2] = u0.y; av[3] = u1.y;
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const float2 w =
                ld2(&sm.gc[(c0 + 8 * j2 + g) * kLdS + 8 * ks + 2 * tig]);
            bv[0] = w.x; bv[1] = w.y;
          });
      float fa = 0.f, fb = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int c = c0 + 8 * j2 + 2 * tig;
        const float2 xa = ld2(&xs_[ra * kLdX + c]);
        const float2 xb = ld2(&xs_[rb * kLdX + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gx[j2][i] += e[j2][i];
          e[j2][i] = 0.f;
        }
        fa += xa.x * gx[j2][0] + xa.y * gx[j2][1];
        fb += xb.x * gx[j2][2] + xb.y * gx[j2][3];
        gx[j2][0] *= back_a;
        gx[j2][1] *= back_a;
        gx[j2][2] *= back_b;
        gx[j2][3] *= back_b;
      }
      fa += __shfl_xor_sync(kAll, fa, 1);
      fa += __shfl_xor_sync(kAll, fa, 2);
      fb += __shfl_xor_sync(kAll, fb, 1);
      fb += __shfl_xor_sync(kAll, fb, 2);
      if (tig == 0) {
        sm.fpart[warp >> 1][ra] = fa;
        sm.fpart[warp >> 1][rb] = fb;
      }
      warp_mma<2>(
          gx, e, r0 / 8, kChunk / 8,
          [&](int ks, float (&av)[4]) {
            const int k = 8 * ks + 2 * tig;
            const float2 u0 = ld2(&sm.mcbT[ra * kLdT + k]);
            const float2 u1 = ld2(&sm.mcbT[rb * kLdT + k]);
            av[0] = u0.x; av[1] = u1.x; av[2] = u0.y; av[3] = u1.y;
          },
          [&](int ks, int j2, float (&bv)[2]) {
            const int k = 8 * ks + 2 * tig;
            bv[0] = dys[k * kLdX + c0 + 8 * j2 + g];
            bv[1] = dys[(k + 1) * kLdX + c0 + 8 * j2 + g];
          });
      float xa_ = 0.f, xb_ = 0.f;
      const long long HP = (long long)H * P;
      float* dxa = dx + ((long long)b * T + t0 + ra) * HP + (long long)h * P;
      float* dxb = dx + ((long long)b * T + t0 + rb) * HP + (long long)h * P;
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int c = c0 + 8 * j2 + 2 * tig;
#pragma unroll
        for (int i = 0; i < 4; ++i) gx[j2][i] += e[j2][i];
        const float2 xa = ld2(&xs_[ra * kLdX + c]);
        const float2 xb = ld2(&xs_[rb * kLdX + c]);
        xa_ += xa.x * gx[j2][0] + xa.y * gx[j2][1];
        xb_ += xb.x * gx[j2][2] + xb.y * gx[j2][3];
        if (ra < nt)
          store_pair(dxa, c, P, evenP, dt_a * gx[j2][0], dt_a * gx[j2][1]);
        if (rb < nt)
          store_pair(dxb, c, P, evenP, dt_b * gx[j2][2], dt_b * gx[j2][3]);
      }
      xa_ += __shfl_xor_sync(kAll, xa_, 1);
      xa_ += __shfl_xor_sync(kAll, xa_, 2);
      xb_ += __shfl_xor_sync(kAll, xb_, 1);
      xb_ += __shfl_xor_sync(kAll, xb_, 2);
      if (tig == 0) {
        sm.xgpart[warp >> 1][ra] = xa_;
        sm.xgpart[warp >> 1][rb] = xb_;
      }
    }
    __syncthreads();
    // Gc is free: the next head's goes in flight
    if (hi + 1 < nh) stage_gc(hi + 1);
    cp_async_commit();
    // --- phase 4: dl, ddt and dA (warp 0, lane t) -------------------------
    if (warp == 0) {
      const int t = lane;
      const float E = __expf(fminf(L, 0.f)) *
                      (sm.epart[0][t] + sm.epart[1][t] + sm.epart[2][t] +
                       sm.epart[3][t]);
      const float Fv = __expf(fminf(Lc - L, 0.f)) * dtr *
                       (sm.fpart[0][t] + sm.fpart[1][t] + sm.fpart[2][t] +
                        sm.fpart[3][t]);
      float rect = 0.f, q = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        rect += sm.rect[w][t];
        q += sm.base[w];
      }
      const float base = __expf(fminf(Lc, 0.f)) * q;
      const float esuf = warp_suffix_sum(E, lane);        // tau >= t
      const float fin = warp_cumsum(Fv, lane);
      float fpre = __shfl_up_sync(kAll, fin, 1);          // s < t
      if (lane == 0) fpre = 0.f;
      const float dl = base + esuf + fpre + rect;
      const float xg = sm.xgpart[0][t] + sm.xgpart[1][t] + sm.xgpart[2][t] +
                       sm.xgpart[3][t];
      if (t < nt) ddt[((long long)b * T + t0 + t) * H + h] = a * dl + xg;
      float da = dtr * dl;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da += __shfl_xor_sync(kAll, da, off);
      if (lane == 0) dA_part[((long long)b * nc + j) * H + h] = da;
    }
  }
  // the group's dB and dC rows (B, T, ngroups, N)
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int t = r2 == 0 ? ra : rb;
    if (t >= nt) continue;
    const long long row = (((long long)b * T + t0 + t) * ngroups + hg) * N;
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const int c = c0 + 8 * j2 + 2 * tig;
      store_pair(dB_part + row, c, N, evenN, dB_acc[j2][2 * r2],
                 dB_acc[j2][2 * r2 + 1]);
      store_pair(dC_part + row, c, N, evenN, dC_acc[j2][2 * r2],
                 dC_acc[j2][2 * r2 + 1]);
    }
  }
}

}  // namespace

// x, dy (B,T,H,P) and dt (B,T,H) through (batch, step, head) strides, Bm/Cm
// (B,T,N) through (batch, step) strides, last dimensions contiguous; A
// (H,), h0 and dhT (B,H,P,N; dhT null for zero) contiguous; states and adj
// (B,H,nc+1,P,N) scratch (adj[:, :, 0] is dh0 on return); dx (B,T,H,P),
// ddt (B,T,H), dA_part (B,nc,H), dB_part and dC_part (B,T,ceil(H/8),N)
// contiguous.  vec: every row of x, dy, Bm and Cm starts 16-byte aligned
// and P, N are multiples of 4.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       const void* dy, const void* dhT, void* states,
                       void* adj, void* dx, void* ddt, void* dA_part,
                       void* dB_part, void* dC_part, int B, int T, int H,
                       int P, int N, long long x_sb, long long x_st,
                       long long x_sh, long long d_sb, long long d_st,
                       long long d_sh, long long bm_sb, long long bm_st,
                       long long cm_sb, long long cm_st, long long y_sb,
                       long long y_st, long long y_sh, int vec,
                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kDim || N > kDim ||
      B > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(ChunkSmem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{x_sb, x_st, x_sh}, ds{d_sb, d_st, d_sh},
      ys{y_sb, y_st, y_sh};
  const int nc = (T + kChunk - 1) / kChunk;
  ssd_bwd_scan_kernel<<<dim3((P + kScanRows - 1) / kScanRows, H, 2 * B),
                        kScanThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(h0), static_cast<const float*>(dhT),
      static_cast<float*>(states), static_cast<float*>(adj), T, H, P, N, xs,
      ys, ds, bm_sb, bm_st, cm_sb, cm_st, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chunk_kernel<<<dim3(nc, (H + kGroup - 1) / kGroup, B), kThreads,
                         sizeof(ChunkSmem), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(adj),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), T, H, P, N, xs, ds, bm_sb, bm_st, cm_sb,
      cm_st, ys, vec);
  return static_cast<int>(cudaGetLastError());
}
