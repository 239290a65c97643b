// RWKV-6 WKV recurrence for Hopper (sm_90a), CUDA C++ with a plain C
// interface loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: src/repro/kernels/rwkv6_wkv/kernel.py::wkv6_bhtn (the Pallas
// TPU kernel; pl.pallas_call at kernel.py:85).
//
// What it computes (the same function as the TPU kernel), per batch row b
// and head h, with a carried (N, N) float32 state S:
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),     log w_t = logw_t <= 0
// in chunks of kChunk steps.  Inside a chunk, with L the inclusive and
// Lprev the exclusive cumulative sum of logw over the chunk's steps:
//     A[t,s] = sum_n r[t,n] k[s,n] exp(Lprev[t,n] - L[s,n])   (s < t)
//     A[t,t] = sum_n r[t,n] u[n] k[t,n]                        (the bonus)
//     y[t,m] = sum_{s<=t} A[t,s] v[s,m] + sum_n r[t,n] exp(Lprev[t,n]) S[n,m]
//     S'[n,m] = exp(L[c-1,n]) S[n,m] + sum_s k[s,n] exp(L[c-1,n] - L[s,n]) v[s,m]
// Every exponent is <= 0 (a sum of log decays between ordered steps, summed
// step by step so that L never rises), so nothing overflows however strong
// the decay.  Lprev[t] is L[t-1] itself, never L[t] - logw[t].  The (c, c,
// N) decay tensor the TPU kernel materialises is never formed.
//
// Layout: r, k, v, logw and y are (B,T,H,N) float32 in the model layout,
// read through (batch, step, head) element strides with the last dimension
// contiguous; u is (H,N), s0 and s_T (B,H,N,N), contiguous.  Steps t >= T
// are treated as k = v = 0, logw = 0 (decay 1: the state passes unchanged)
// here, not in a padded copy, and their y is not written.
//
// Two kernels serve the two sides of ops.tensor_core_path:
//
// wkv6_tc_fwd (N = 64, every row start 16-byte aligned: the model's
// shapes).  What bounds it on an H100: at the rwkv6-1.6b prefill bucket
// (B=8, T=512, H=32, N=64) the call reads r, k, v, logw (134 MB) and s0 (4
// MB) and writes y (34 MB) and s_T (4 MB): about 176 MB, 0.053 ms at 3.35
// TB/s; that is the bound.  The first version ran 0.97 ms there: each
// A[t,s] took N exponentials on the fly (c(c-1)/2 N a chunk and head, half
// the lanes idle on the triangle), two 32-column blocks each recomputed A,
// the products were CUDA-core FMAs reading shared memory and loads were
// synchronous.  This design:
//  * One block per (b, h) forms A once for all 64 value columns; eight
//    warps spread the state and the y tile over their registers.
//  * Sub-chunks of kSub = 8 steps cut the exponentials.  For s in sub-chunk
//    i (last step e) and t in a later one,
//        exp(Lprev_t - L_s) = exp(Lprev_t - L_e) * exp(L_e - L_s),
//    both exponents <= 0 (L never rises and t - 1 >= e >= s): neither
//    factor can overflow, and a factor that underflows bounds a true value
//    smaller still.  This is not the division form exp(Lprev_t) *
//    exp(-L_s) that tests/test_kernels.py::test_wkv6_extreme_decay_stability
//    rejects: no factor's exponent is positive.  The off-diagonal blocks of
//    A are then true products, (r o decay) (k o decay)^T, on tensor cores;
//    only the four 8 x 8 diagonal blocks keep the exact on-the-fly form.
//    About 12 K exponentials a chunk and head instead of 32 K.
//  * Every product runs on tensor cores: mma.sync m16n8k8 in TF32, each
//    operand split as a = hi + lo (hi = cvt.rna.tf32(a), lo = a - hi,
//    which the tensor cores read truncated to TF32) and the product taken
//    as hi*lo + lo*hi + hi*hi with fp32 accumulation, the cross terms in
//    an accumulator of their own (plain TF32's 11 significant bits miss the
//    1e-4 tolerance; the dropped terms are about 2^-21 of each product):
//      A_off = (r o exp(Lprev - L_e)) (k o exp(L_e - L))^T   per sub-chunk
//      y     = [A | r o exp(Lprev)] (32 x 96)  .  [v ; S] (96 x 64)
//      S'    = exp(L_c) o S + (k o exp(L_c - L))^T (64 x 32)  .  v (32 x 64)
//    The decayed r and k are split once a chunk (hi in place, lo beside),
//    not once a use.  The state stays in the accumulator registers of its
//    product across the whole sequence and is written to shared memory
//    once a chunk as y's operand.  The split, the mma.sync wrappers and
//    the cp.async copies live in wkv_mma.cuh, shared with the backward.
//  * Each chunk's r, k, v and logw (256-byte rows) are staged with 16-byte
//    cp.async copies into a double buffer, so chunk j+1 is in flight while
//    chunk j computes; the 95 KB a block takes let two blocks share an SM.
//  * Loads are wide: the diagonal blocks and the decay pass read 16 bytes
//    a lane, and the fragments' k and n indices are permuted (the sums do
//    not change) so that A pairs are 8-byte loads, B values of one step 8-
//    or 16-byte loads and outputs 16-byte stores, over rows padded to 68,
//    72 or 40 floats.  Exponentials are __expf (ex2.approx; relative error
//    a few 1e-6 at the arguments that matter, against the 1e-4 tolerance).
//  What still bounds it (chip_smoke.py prints both bounds beside the time):
//  neither the bytes nor the tensor-core products.  A chunk is five phases
//  split by barriers (the step-by-step cumulative sum, A, the decays, the
//  products, the state's store) whose latency 16 warps on an SM cannot
//  hide; the diagonal blocks' exponentials are the largest phase.
//
// wkv6_fwd (the rest: N < 64 or unaligned rows): the first version's
// CUDA-core kernel.  A block owns (b, h, a tile of kTile value columns)
// with its S tile in shared memory, recomputes the chunk's A per tile with
// the exponentials on the fly, and loads synchronously.  The model never
// takes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv_mma.cuh"

namespace {

using namespace wkv;

constexpr int kChunk = 32;      // steps per chunk (ref.CHUNK)
constexpr int kMaxN = 64;       // head size the shared tiles are sized for
constexpr int kTile = 32;       // value columns per block
constexpr int kThreads = 256;

struct Strides {
  long long b, t, h;
};

// --- the CUDA-core kernel (N <= 64, any alignment) --------------------------

__host__ __device__ constexpr int smem_floats(int n) {
  // r (c x N), k, L, Lprev (c x (N+1) each), v (c x kTile),
  // A (c x (c+1)), S (N x kTile), u (N)
  return kChunk * n + 3 * kChunk * (n + 1) + kChunk * kTile +
         kChunk * (kChunk + 1) + n * kTile + n;
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H,
            int N, Strides rs, Strides ks, Strides vs, Strides ws,
            Strides ys) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int MT = min(kTile, N - m0);
  const int tid = threadIdx.x;
  const int LD = N + 1;                // padded rows: lanes on distinct banks

  extern __shared__ float smem[];
  float* r_s = smem;                   // [c][N]  r, then r * exp(Lprev)
  float* k_s = r_s + kChunk * N;       // [c][LD] k, then k * exp(Lc - L)
  float* L_s = k_s + kChunk * LD;      // [c][LD] inclusive cumsum of logw
  float* P_s = L_s + kChunk * LD;      // [c][LD] exclusive cumsum (Lprev)
  float* v_s = P_s + kChunk * LD;      // [c][kTile] this block's columns
  float* A_s = v_s + kChunk * kTile;   // [c][c+1]
  float* S_s = A_s + kChunk * (kChunk + 1);   // [N][kTile] the state tile
  float* u_s = S_s + N * kTile;        // [N]

  const float* s0_bh = s0 + ((long long)b * H + h) * N * N;
  for (int idx = tid; idx < N * kTile; idx += kThreads) {
    const int n = idx / kTile, m = idx % kTile;
    S_s[idx] = m < MT ? s0_bh[(long long)n * N + m0 + m] : 0.f;
  }
  for (int n = tid; n < N; n += kThreads) u_s[n] = u[(long long)h * N + n];

  const long long rb = b * rs.b + h * rs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h, wb = b * ws.b + h * ws.h;
  const long long yb = b * ys.b + h * ys.h;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    // --- stage the chunk; steps past T are k = v = 0, logw = 0 ---------
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      r_s[t * N + n] = in ? r[rb + tt * rs.t + n] : 0.f;
      k_s[t * LD + n] = in ? k[kb + tt * ks.t + n] : 0.f;
      L_s[t * LD + n] = in ? logw[wb + tt * ws.t + n] : 0.f;
    }
    for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
      const int t = idx / kTile, m = idx % kTile;
      const bool in = t0 + t < T && m < MT;
      v_s[idx] = in ? v[vb + (long long)(t0 + t) * vs.t + m0 + m] : 0.f;
    }
    __syncthreads();
    // --- cumulative log decays, one column n per thread -----------------
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float lw = L_s[t * LD + n];
        P_s[t * LD + n] = acc;          // exclusive: exactly L[t-1]
        acc += lw;
        L_s[t * LD + n] = acc;
      }
    }
    __syncthreads();
    // --- A[t,s]: a warp holds one row t, its lanes the columns s ---------
    for (int idx = tid; idx < kChunk * kChunk; idx += kThreads) {
      const int t = idx / kChunk, s = idx % kChunk;
      float a = 0.f;
      if (s < t) {
        for (int n = 0; n < N; ++n)
          a += r_s[t * N + n] * k_s[s * LD + n] *
               expf(P_s[t * LD + n] - L_s[s * LD + n]);
      } else if (s == t) {
        for (int n = 0; n < N; ++n)
          a += r_s[t * N + n] * u_s[n] * k_s[t * LD + n];
      }
      A_s[t * (kChunk + 1) + s] = a;
    }
    __syncthreads();
    // --- decay r and k for the state terms, in place --------------------
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      r_s[t * N + n] *= expf(P_s[t * LD + n]);
      k_s[t * LD + n] *= expf(L_s[(kChunk - 1) * LD + n] - L_s[t * LD + n]);
    }
    __syncthreads();
    // --- y over this block's columns: lanes on consecutive m ------------
    for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
      const int t = idx / kTile, m = idx % kTile;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s)
        acc += A_s[t * (kChunk + 1) + s] * v_s[s * kTile + m];
      for (int n = 0; n < N; ++n) acc += r_s[t * N + n] * S_s[n * kTile + m];
      if (m < MT && t0 + t < T)
        y[yb + (long long)(t0 + t) * ys.t + m0 + m] = acc;
    }
    __syncthreads();
    // --- state update: each thread owns its (n, m) entries --------------
    for (int idx = tid; idx < N * kTile; idx += kThreads) {
      const int n = idx / kTile, m = idx % kTile;
      float acc = expf(L_s[(kChunk - 1) * LD + n]) * S_s[idx];
      for (int s = 0; s < kChunk; ++s)
        acc += k_s[s * LD + n] * v_s[s * kTile + m];
      S_s[idx] = acc;
    }
    __syncthreads();
  }

  float* sT_bh = sT + ((long long)b * H + h) * N * N;
  for (int idx = tid; idx < N * kTile; idx += kThreads) {
    const int n = idx / kTile, m = idx % kTile;
    if (m < MT) sT_bh[(long long)n * N + m0 + m] = S_s[idx];
  }
}

// --- the tensor-core kernel (N = 64, 16-byte aligned rows) ------------------

constexpr int kDim = 64;        // N of the tensor-core kernel
constexpr int kSub = 8;         // steps per sub-chunk
// Padded rows, chosen so that the fragment loads below are free of bank
// conflicts (k's A_off reads excepted, 2-way): 68 floats where a row pair
// 2 tig, 2 tig + 1 is read down its columns (k, v, the state), 72 and 40
// where rows g are read in pairs of columns 2 tig, 2 tig + 1 (r and L; A).
constexpr int kLdR = 72;
constexpr int kLdK = 68;
constexpr int kLdA = 40;

// a diagonal sub-block's entries (t << 3 | s): the 28 with s < t, then the
// 8 with s = t
constexpr int kDiagEntries = kSub * (kSub - 1) / 2 + kSub;
__constant__ unsigned char kDiagPairs[kDiagEntries] = {
    8, 16, 17, 24, 25, 26, 32, 33, 34, 35, 40, 41, 42, 43, 44, 48, 49, 50, 51,
    52, 53, 56, 57, 58, 59, 60, 61, 62, 0, 9, 18, 27, 36, 45, 54, 63};

struct TcStage {                // one chunk in flight
  float r[kChunk * kLdR];       // r, then TF32 hi of r o exp(Lprev)
  float k[kChunk * kLdK];       // k, then TF32 hi of k o exp(L_c - L)
  float v[kChunk * kLdK];
  float L[kChunk * kLdR];       // logw, then its inclusive cumsum
};

struct TcSmem {
  TcStage stage[2];
  float rlo[kChunk * kLdR];     // lo of r o exp(Lprev)
  float klo[kChunk * kLdK];     // lo of k o exp(L_c - L)
  float S[kDim * kLdK];         // the state as y's operand, [n][m]
  float A[kChunk * kLdA];       // the chunk's A (zero above the diagonal)
  float u[kDim];
};

// An A fragment of values that are TF32 already
__device__ __forceinline__ void as_a(float v0, float v1, float v2, float v3,
                                     uint32_t (&r)[4]) {
  r[0] = __float_as_uint(v0);
  r[1] = __float_as_uint(v1);
  r[2] = __float_as_uint(v2);
  r[3] = __float_as_uint(v3);
}

// Four values split once (see split), hi and lo stored as floats
__device__ __forceinline__ void split4(float4 v, float* hi, float* lo) {
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

__global__ void __launch_bounds__(kThreads, 2)
wkv6_tc_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ sT, int T, int H,
               Strides rs, Strides ks, Strides vs, Strides ws, Strides ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem_raw);
  const int b = blockIdx.y, h = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int nc = (T + kChunk - 1) / kChunk;

  const long long rb = b * rs.b + h * rs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h, wb = b * ws.b + h * ws.h;
  const long long yb = b * ys.b + h * ys.h;

  auto stage_chunk = [&](TcStage& st, int j) {
    const int t0 = j * kChunk;
    #pragma unroll
    for (int it = 0; it < (kChunk * 16) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int t = idx >> 4, q = (idx & 15) * 4;
      const bool in = t0 + t < T;
      const long long tt = in ? t0 + t : 0;   // a valid row when zero-filled
      cp_async16(&st.r[t * kLdR + q], r + rb + tt * rs.t + q, in);
      cp_async16(&st.k[t * kLdK + q], k + kb + tt * ks.t + q, in);
      cp_async16(&st.v[t * kLdK + q], v + vb + tt * vs.t + q, in);
      cp_async16(&st.L[t * kLdR + q], logw + wb + tt * ws.t + q, in);
    }
  };

  for (int idx = tid; idx < kChunk * kLdA; idx += kThreads) sm.A[idx] = 0.f;
  for (int n = tid; n < kDim; n += kThreads) sm.u[n] = u[(long long)h * kDim + n];

  // The fragments' k index is permuted inside each 8-step: fragment
  // columns tig and tig + 4 take steps 2 tig and 2 tig + 1 (A and B alike,
  // so the sums are unchanged), which makes each A pair one 8-byte load.
  // The n index is permuted too: column g of n-tile jn is column
  // J g + jn of the warp's J n-tiles, so a thread's B values of one step
  // are J consecutive floats, and its outputs 2 J consecutive ones.
  //
  // The state: this warp's 16 x 32 tile of the (N, N) accumulator, rows
  // n = sr (+8), its n-tile jn holding columns sc + 8 tig + jn (+4).
  const int sr = 16 * (warp & 3) + g, sc = 32 * (warp >> 2);
  float Sr[4][4];
  auto store_state = [&](float* dst, int ld) {   // 4 float4 a thread
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (sr + 8 * (i >> 1)) * ld + sc +
                                 8 * tig + 4 * (i & 1)) =
          make_float4(Sr[0][i], Sr[1][i], Sr[2][i], Sr[3][i]);
  };
  const float* s0_bh = s0 + ((long long)b * H + h) * kDim * kDim;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Sr[jn][i] = s0_bh[(sr + 8 * (i >> 1)) * kDim + sc + 8 * tig +
                        4 * (i & 1) + jn];
  store_state(sm.S, kLdK);

  // y's tile of this warp: rows t = ym + g (+8), columns m = yc + 4 tig + 0..3
  const int ym = 16 * (warp & 1), yc = 16 * (warp >> 1);

  stage_chunk(sm.stage[0], 0);
  cp_async_commit();
  for (int j = 0; j < nc; ++j) {
    TcStage& st = sm.stage[j & 1];
    if (j + 1 < nc) {
      stage_chunk(sm.stage[(j + 1) & 1], j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // --- L: one column n per thread, summed step by step -------------------
    if (tid < kDim) {
      float lw[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) lw[t] = st.L[t * kLdR + tid];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        acc += lw[t];
        st.L[t * kLdR + tid] = acc;
      }
    }
    __syncthreads();
    if (warp < 4) {
      // --- A below the diagonal sub-blocks: rows t > e of sub-chunk i's
      // columns, A = (r o exp(L[t-1] - L_e)) (k o exp(L_e - L_s))^T ------
      const int i = warp == 0 ? 0 : warp - 1;
      const int e = kSub * i + kSub - 1;
      const int t0r = 16 * (warp == 0 ? 0 : 1) + g, t1r = t0r + 8;
      const bool v0 = t0r > e, v1 = t1r > e;
      const int s = kSub * i + g;
      float acc[4] = {}, accx[4] = {};
      uint32_t ah[4], al[4], bh[2], bl[2];
      // r o exp(L[t-1] - L_e) for rows t > e, else 0 (never a positive
      // exponent)
      auto rd = [&](bool ok, int t, int n, float2 le) {
        if (!ok) return make_float2(0.f, 0.f);
        const float2 rv = ld2(&st.r[t * kLdR + n]);
        const float2 lp = ld2(&st.L[(t - 1) * kLdR + n]);
        return make_float2(rv.x * __expf(lp.x - le.x),
                           rv.y * __expf(lp.y - le.y));
      };
#pragma unroll 2
      for (int kk = 0; kk < kDim / 8; ++kk) {
        const int n = 8 * kk + 2 * tig;
        const float2 le = ld2(&st.L[e * kLdR + n]);
        const float2 a0 = rd(v0, t0r, n, le), a1 = rd(v1, t1r, n, le);
        split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
        const float2 kv = ld2(&st.k[s * kLdK + n]);
        const float2 ls = ld2(&st.L[s * kLdR + n]);
        split(kv.x * __expf(le.x - ls.x), bh[0], bl[0]);
        split(kv.y * __expf(le.y - ls.y), bh[1], bl[1]);
        mma3(acc, accx, ah, al, bh, bl);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += accx[q];
      const int c = kSub * i + 2 * tig;
      if (v0) {
        sm.A[t0r * kLdA + c] = acc[0];
        sm.A[t0r * kLdA + c + 1] = acc[1];
      }
      if (v1) {
        sm.A[t1r * kLdA + c] = acc[2];
        sm.A[t1r * kLdA + c + 1] = acc[3];
      }
    } else {
      // --- the diagonal sub-block d, exact: 8 lanes per entry over n, over
      // the block's 28 entries below its diagonal, then its 8 bonus entries
      // (those above stay 0 from the start) --------------------------------
      const int d = warp - 4, lg = lane >> 3, li = lane & 7;
      for (int it = 0; it < kDiagEntries / 4; ++it) {
        const int ent = kDiagPairs[4 * it + lg];
        const int t = kSub * d + (ent >> 3), s = kSub * d + (ent & 7);
        float acc = 0.f;
        if (4 * it < kDiagEntries - kSub) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {       // n = 4 li + 32 q + (0..3)
            const int n = 4 * li + 32 * q;
            const float4 rv = ld4(&st.r[t * kLdR + n]);
            const float4 kv = ld4(&st.k[s * kLdK + n]);
            const float4 pv = ld4(&st.L[(t - 1) * kLdR + n]);
            const float4 lv = ld4(&st.L[s * kLdR + n]);
            acc += rv.x * kv.x * __expf(pv.x - lv.x) +
                   rv.y * kv.y * __expf(pv.y - lv.y) +
                   rv.z * kv.z * __expf(pv.z - lv.z) +
                   rv.w * kv.w * __expf(pv.w - lv.w);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = 4 * li + 32 * q;
            const float4 rv = ld4(&st.r[t * kLdR + n]);
            const float4 kv = ld4(&st.k[t * kLdK + n]);
            const float4 uv = ld4(&sm.u[n]);
            acc += rv.x * uv.x * kv.x + rv.y * uv.y * kv.y +
                   rv.z * uv.z * kv.z + rv.w * uv.w * kv.w;
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (li == 0) sm.A[t * kLdA + s] = acc;
      }
    }
    __syncthreads();
    // --- r o exp(Lprev) and k o exp(L_c - L), 4 at a time, split once
    // into hi (in place) and lo (beside), for the products -------------
#pragma unroll
    for (int it = 0; it < (kChunk * kDim) / (4 * kThreads); ++it) {
      const int idx = tid + it * kThreads;
      const int t = idx >> 4, n = 4 * (idx & 15);
      const float4 lc = ld4(&st.L[(kChunk - 1) * kLdR + n]);
      const float4 lt = ld4(&st.L[t * kLdR + n]);
      const float4 lp = t > 0 ? ld4(&st.L[(t - 1) * kLdR + n])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 rv = ld4(&st.r[t * kLdR + n]);
      split4(make_float4(rv.x * __expf(lp.x), rv.y * __expf(lp.y),
                         rv.z * __expf(lp.z), rv.w * __expf(lp.w)),
             &st.r[t * kLdR + n], &sm.rlo[t * kLdR + n]);
      const float4 kv = ld4(&st.k[t * kLdK + n]);
      split4(make_float4(kv.x * __expf(lc.x - lt.x), kv.y * __expf(lc.y - lt.y),
                         kv.z * __expf(lc.z - lt.z), kv.w * __expf(lc.w - lt.w)),
             &st.k[t * kLdK + n], &sm.klo[t * kLdK + n]);
    }
    __syncthreads();
    // --- y = A v + (r o exp(Lprev)) S --------------------------------------
    {
      float acc[2][4] = {}, accx[2][4] = {};   // hi*hi; the cross terms
      uint32_t ah[4], al[4], bh[2], bl[2];
      const int t0r = ym + g, t1r = t0r + 8;
      for (int kk = 0; kk < (ym + 16) / 8; ++kk) {   // s <= t only
        const int c = 8 * kk + 2 * tig;
        const float2 a0 = ld2(&sm.A[t0r * kLdA + c]);
        const float2 a1 = ld2(&sm.A[t1r * kLdA + c]);
        split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
        const float2 v0 = ld2(&st.v[c * kLdK + yc + 2 * g]);
        const float2 v1 = ld2(&st.v[(c + 1) * kLdK + yc + 2 * g]);
        split(v0.x, bh[0], bl[0]);
        split(v1.x, bh[1], bl[1]);
        mma3(acc[0], accx[0], ah, al, bh, bl);
        split(v0.y, bh[0], bl[0]);
        split(v1.y, bh[1], bl[1]);
        mma3(acc[1], accx[1], ah, al, bh, bl);
      }
#pragma unroll 2
      for (int kk = 0; kk < kDim / 8; ++kk) {
        const int n = 8 * kk + 2 * tig;
        const float2 r0 = ld2(&st.r[t0r * kLdR + n]);       // TF32 hi
        const float2 r1 = ld2(&st.r[t1r * kLdR + n]);
        const float2 q0 = ld2(&sm.rlo[t0r * kLdR + n]);     // lo
        const float2 q1 = ld2(&sm.rlo[t1r * kLdR + n]);
        as_a(r0.x, r1.x, r0.y, r1.y, ah);
        as_a(q0.x, q1.x, q0.y, q1.y, al);
        const float2 s0v = ld2(&sm.S[n * kLdK + yc + 2 * g]);
        const float2 s1v = ld2(&sm.S[(n + 1) * kLdK + yc + 2 * g]);
        split(s0v.x, bh[0], bl[0]);
        split(s1v.x, bh[1], bl[1]);
        mma3(acc[0], accx[0], ah, al, bh, bl);
        split(s0v.y, bh[0], bl[0]);
        split(s1v.y, bh[1], bl[1]);
        mma3(acc[1], accx[1], ah, al, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[0][i] += accx[0][i];
        acc[1][i] += accx[1][i];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = j * kChunk + ym + g + 8 * half;
        if (t < T)
          *reinterpret_cast<float4*>(y + yb + (long long)t * ys.t + yc +
                                     4 * tig) =
              make_float4(acc[0][2 * half], acc[1][2 * half],
                          acc[0][2 * half + 1], acc[1][2 * half + 1]);
      }
    }
    // --- S = exp(L_c) o S + (k o exp(L_c - L))^T v, in registers -----------
    {
      const float d0 = __expf(st.L[(kChunk - 1) * kLdR + sr]);
      const float d1 = __expf(st.L[(kChunk - 1) * kLdR + sr + 8]);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        Sr[jn][0] *= d0;
        Sr[jn][1] *= d0;
        Sr[jn][2] *= d1;
        Sr[jn][3] *= d1;
      }
      float Sx[4][4] = {};                     // this chunk's cross terms
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const int c = 8 * kk + 2 * tig;
        const float* kv = &st.k[c * kLdK + sr];             // TF32 hi
        const float* kl = &sm.klo[c * kLdK + sr];           // lo
        as_a(kv[0], kv[8], kv[kLdK], kv[kLdK + 8], ah);
        as_a(kl[0], kl[8], kl[kLdK], kl[kLdK + 8], al);
        const float4 v0 = ld4(&st.v[c * kLdK + sc + 4 * g]);
        const float4 v1 = ld4(&st.v[(c + 1) * kLdK + sc + 4 * g]);
        const float vv0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float vv1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          split(vv0[jn], bh[0], bl[0]);
          split(vv1[jn], bh[1], bl[1]);
          mma3(Sr[jn], Sx[jn], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) Sr[jn][q] += Sx[jn][q];
    }
    __syncthreads();              // every read of sm.S and of this stage
    store_state(sm.S, kLdK);
  }

  store_state(sT + ((long long)b * H + h) * kDim * kDim, kDim);
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        void* y, void* sT, int B, int T, int H, int N,
                        long long r_sb, long long r_st, long long r_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long w_sb, long long w_st, long long w_sh,
                        long long y_sb, long long y_st, long long y_sh,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  const size_t smem_max = smem_floats(kMaxN) * sizeof(float);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_max));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const size_t smem = smem_floats(N) * sizeof(float);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  wkv6_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), T, H, N,
      Strides{r_sb, r_st, r_sh}, Strides{k_sb, k_st, k_sh},
      Strides{v_sb, v_st, v_sh}, Strides{w_sb, w_st, w_sh},
      Strides{y_sb, y_st, y_sh});
  return static_cast<int>(cudaGetLastError());
}

// N = 64.
extern "C" int wkv6_tc_fwd(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* y, void* sT, int B, int T, int H,
                           long long r_sb, long long r_st, long long r_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long w_sb, long long w_st, long long w_sh,
                           long long y_sb, long long y_st, long long y_sh,
                           void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(TcSmem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  wkv6_tc_kernel<<<dim3(H, B), kThreads, sizeof(TcSmem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), T, H,
      Strides{r_sb, r_st, r_sh}, Strides{k_sb, k_st, k_sh},
      Strides{v_sb, v_st, v_sh}, Strides{w_sb, w_st, w_sh},
      Strides{y_sb, y_st, y_sh});
  return static_cast<int>(cudaGetLastError());
}
