// Mamba-2 SSD scan for Hopper (sm_90a), CUDA C++ with a plain C interface
// loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py::ssd_bhtp (the Pallas
// TPU kernel; pl.pallas_call at kernel.py:83).
//
// What it computes (the same function as the TPU kernel), per batch row b
// and head h, with a carried (P, N) float32 state:
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,      y_t = h_t C_t
// (the D-skip is added outside) in chunks of kChunk steps.  Inside a chunk,
// with L the inclusive cumulative sum of dA = dt * A:
//     W[t,s] = exp(L_t - L_s) * G[t,s],   G = C B^T             (s <= t)
//     y[t,p] = sum_{s<=t} W[t,s] dt_s x[s,p] + exp(L_t) sum_n C[t,n] h[p,n]
//     h'[p,n] = exp(L_c) h[p,n] + sum_s dt_s x[s,p] exp(L_c - L_s) B[s,n]
// Every exponent is <= 0 (a scan's rounding is clamped).  dA is formed here
// from dt and A[h] (the TPU wrapper built a (B,H,T,1) dA tensor).
//
// Layout: x and y are (B,T,H,P), dt (B,T,H), Bm and Cm (B,T,N), all float32
// in the model layout, read through element strides with the last dimension
// of x, y, Bm and Cm contiguous (x may be a view of the conv output); A is
// (H,), h0 and h_T (B,H,P,N), contiguous.  Steps t >= T are treated as
// dt = 0 (decay 1, no input) here, not in a padded copy, and their y is not
// written.  The chunk is 32 steps (ref.CHUNK); it only moves where the sums
// are cut, so the result is the same up to rounding.
//
// Two kernels serve the two sides of ops.tensor_core_path:
//
// ssd_tc_fwd (P = N = 64, every row start 16-byte aligned: the model's
// shapes).  What bounds it on an H100: at the zamba2-2.7b prefill bucket
// (B=8, T=512, H=80, P=N=64) the call reads x (84 MB), dt, B and C (about
// 3 MB) and h0 (10.5 MB) and writes y (84 MB) and h_T (10.5 MB): about 193
// MB, 0.058 ms at 3.35 TB/s.  Its products, about 4.3 GFLOP at chunk 32,
// would take 0.064 ms at the fp32 CUDA-core peak; on tensor cores in TF32
// with a three-term split (three products at 495 TFLOP/s) they take 0.026
// ms, so the bound is the bytes.  The first version ran 2.1 ms there:
// every product was a CUDA-core FMA reading both operands from shared
// memory, G = C B^T was recomputed by each of the 80 heads, loads were
// synchronous and the cumulative sum ran on one thread.  This design:
//  * G = C B^T does not depend on the head.  A first small kernel
//    (ssd_gram_kernel, one block per (b, chunk)) writes it for every (b,
//    chunk) into a scratch tensor, (B, nc, 32, 32) float32 (0.5 MB at the
//    bucket, 2 MB at B=1, T=16384), that every head's block reads from L2.
//    This keeps one block per (b, h), 640 at the bucket; sharing G in the
//    shared memory of a block that serves a group of heads would cut that
//    parallelism by the group size and hold the group's states at once.
//  * The three products run on tensor cores: mma.sync m16n8k8 in TF32
//    with a three-term split of every operand (ssd_mma.cuh, shared with
//    the backward kernels): plain TF32 would miss these 96-term sums by
//    about 1e-3 against a tolerance of 1e-4.
//      y   = [W | exp(L) o C] (32 x 96)  .  [x dt ; h^T] (96 x 64)
//      h'  = exp(L_c) h + ((x dt) o wd)^T (64 x 32)  .  B (32 x 64)
//    The (P, N) state stays in the accumulator registers of the state
//    product across the whole sequence (8 warps, a 16 x 32 tile each) and
//    is written to shared memory once a chunk as y's operand.  The split
//    costs two instructions an operand value and dominates the products'
//    instruction stream, so its second rounding is left to the hardware.
//  * W = exp(L_t - L_s) o G takes one exponential per (t, s <= t), formed
//    once per head and chunk in place over the staged G.  L is a warp scan
//    that every warp runs itself, so only two barriers split a chunk.
//  * Each chunk's x, dt, B, C and G are staged with 16-byte cp.async copies
//    (4-byte ones for dt, whose steps are H floats apart) into a double
//    buffer, so chunk j+1 is in flight while chunk j computes.  The 80 KB a
//    block takes let two blocks share an SM.
//  * Fragment loads are few and conflict-free: the k index of each 8-step
//    and the n index of a warp's n-tiles are permuted (the sums do not
//    change), so A pairs are 8-byte loads, B values of one step 8- or
//    16-byte loads and outputs 16-byte stores, over rows padded to 68, 72
//    or 40 floats.  Exponentials are __expf (ex2.approx; relative error a
//    few 1e-6 at the arguments that matter, against the 1e-4 tolerance).
//  What still bounds it (chip_smoke.py prints both bounds beside the time):
//  neither the bytes nor the tensor-core products.  Each chunk is a chain
//  of dependent steps (the scan, W, chains of 12 to 24 dependent mma.sync
//  a y fragment, two barriers) whose latency 16 warps on an SM cannot
//  hide; the next step is to overlap chunks across warps (warp
//  specialisation).
//
// ssd_fwd (the rest: any P, N <= 64, unaligned rows): the first version's
// CUDA-core kernel, one block per (b, h) with the state in shared memory,
// synchronous loads and fp32 FMAs.  The model never takes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_mma.cuh"

namespace {

using namespace ssd;

constexpr int kMaxP = 64;       // head dim the shared tiles are sized for
constexpr int kMaxN = 64;       // state size the shared tiles are sized for
constexpr int kThreads = 256;

struct Strides {
  long long b, t, h;
};

// --- the CUDA-core kernel (any P, N <= 64) ----------------------------------

__host__ __device__ constexpr int smem_floats(int p, int n) {
  // x*dt (c x P), B, C (c x (N+1) each), W (c x (c+1)), state (P x (N+1)),
  // dt, L, exp(Lc - L) (c each)
  return kChunk * p + 2 * kChunk * (n + 1) + kChunk * (kChunk + 1) +
         p * (n + 1) + 3 * kChunk;
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hT, int T, int H,
           int P, int N, Strides xs, Strides ds, long long bm_sb,
           long long bm_st, long long cm_sb, long long cm_st, Strides ys) {
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int LD = N + 1;                // padded rows: lanes on distinct banks

  extern __shared__ float smem[];
  float* x_s = smem;                   // [c][P]  x * dt
  float* B_s = x_s + kChunk * P;       // [c][LD]
  float* C_s = B_s + kChunk * LD;      // [c][LD]
  float* W_s = C_s + kChunk * LD;      // [c][c+1]
  float* h_s = W_s + kChunk * (kChunk + 1);   // [P][LD] the state
  float* dt_s = h_s + P * LD;          // [c]
  float* L_s = dt_s + kChunk;          // [c] inclusive cumsum of dt * A
  float* wd_s = L_s + kChunk;          // [c] exp(L_c - L_s)

  const float a = A[h];
  const float* h0_bh = h0 + ((long long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads)
    h_s[(idx / N) * LD + idx % N] = h0_bh[idx];

  const long long xb = b * xs.b + h * xs.h, db = b * ds.b + h * ds.h;
  const long long yb = b * ys.b + h * ys.h;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    // --- stage the chunk; steps past T have dt = 0 and no input ---------
    for (int t = tid; t < kChunk; t += kThreads)
      dt_s[t] = t0 + t < T ? dt[db + (long long)(t0 + t) * ds.t] : 0.f;
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      B_s[t * LD + n] = in ? Bm[b * bm_sb + tt * bm_st + n] : 0.f;
      C_s[t * LD + n] = in ? Cm[b * cm_sb + tt * cm_st + n] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < kChunk * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      x_s[idx] = t0 + t < T ? x[xb + (long long)(t0 + t) * xs.t + p] * dt_s[t]
                            : 0.f;
    }
    if (tid == 0) {                    // kChunk dependent adds: one thread
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += dt_s[t] * a;
        L_s[t] = acc;
      }
    }
    __syncthreads();
    for (int t = tid; t < kChunk; t += kThreads)
      wd_s[t] = expf(L_s[kChunk - 1] - L_s[t]);
    // --- W[t,s]: a warp holds one row t, its lanes the columns s ---------
    for (int idx = tid; idx < kChunk * kChunk; idx += kThreads) {
      const int t = idx / kChunk, s = idx % kChunk;
      float g = 0.f;
      if (s <= t) {
        for (int n = 0; n < N; ++n) g += C_s[t * LD + n] * B_s[s * LD + n];
        g *= expf(L_s[t] - L_s[s]);
      }
      W_s[t * (kChunk + 1) + s] = g;
    }
    __syncthreads();
    // --- y: lanes on consecutive p --------------------------------------
    for (int idx = tid; idx < kChunk * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      float intra = 0.f, carried = 0.f;
      for (int s = 0; s <= t; ++s)
        intra += W_s[t * (kChunk + 1) + s] * x_s[s * P + p];
      for (int n = 0; n < N; ++n) carried += C_s[t * LD + n] * h_s[p * LD + n];
      if (t0 + t < T)
        y[yb + (long long)(t0 + t) * ys.t + p] = intra + expf(L_s[t]) * carried;
    }
    __syncthreads();
    // --- state update: each thread owns its (p, n) entries --------------
    const float decay = expf(L_s[kChunk - 1]);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float acc = 0.f;
      for (int s = 0; s < kChunk; ++s)
        acc += x_s[s * P + p] * wd_s[s] * B_s[s * LD + n];
      h_s[p * LD + n] = decay * h_s[p * LD + n] + acc;
    }
    __syncthreads();
  }

  float* hT_bh = hT + ((long long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads)
    hT_bh[idx] = h_s[(idx / N) * LD + idx % N];
}

// --- the tensor-core kernel (P = N = 64, 16-byte aligned rows) --------------

constexpr int kDim = 64;        // P and N of the tensor-core kernel
// Padded rows, chosen so that every fragment load below is free of bank
// conflicts: 68 floats where a row pair 2 tig, 2 tig + 1 is read down its
// columns (x, B, the state), 72 and 40 where rows g are read in pairs of
// columns 2 tig, 2 tig + 1 (C; G, then W).
constexpr int kLdX = 68;
constexpr int kLdC = 72;
constexpr int kLdW = 40;
constexpr int kLdH = 68;

struct TcStage {                // one chunk in flight
  float x[kChunk * kLdX];       // x, then x * dt
  float b[kChunk * kLdX];
  float c[kChunk * kLdC];
  float w[kChunk * kLdW];       // G, then W
  float dt[kChunk];
};

struct TcSmem {
  TcStage stage[2];
  float h[kDim * kLdH];         // the state as y's operand, [p][n]
  float L[kChunk];              // inclusive cumsum of dt * A
};
static_assert(kChunk * kChunk == 4 * kThreads, "one float4 of W a thread");

// G[b, j] = C_j B_j^T for chunk j of row b (zeros past T), in fp32 FMAs
__global__ void __launch_bounds__(kThreads)
ssd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ G, int T, long long bm_sb,
                long long bm_st, long long cm_sb, long long cm_st) {
  __shared__ float B_s[kChunk][kDim + 1], C_s[kChunk][kDim + 1];
  const int j = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int t0 = j * kChunk;
  for (int idx = tid; idx < kChunk * kDim; idx += kThreads) {
    const int t = idx / kDim, n = idx % kDim;
    const bool in = t0 + t < T;
    const long long tt = t0 + t;
    B_s[t][n] = in ? Bm[b * bm_sb + tt * bm_st + n] : 0.f;
    C_s[t][n] = in ? Cm[b * cm_sb + tt * cm_st + n] : 0.f;
  }
  __syncthreads();
  const int t = tid >> 3, s0 = tid & 7;      // row t, columns s0 + 8 i
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n = 0; n < kDim; ++n) {
    const float cv = C_s[t][n];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += cv * B_s[s0 + 8 * i][n];
  }
  float* Gt = G + ((long long)b * gridDim.x + j) * kChunk * kChunk +
              t * kChunk;
#pragma unroll
  for (int i = 0; i < 4; ++i) Gt[s0 + 8 * i] = acc[i];
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_tc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ G,
              const float* __restrict__ h0, float* __restrict__ y,
              float* __restrict__ hT, int T, int H, Strides xs, Strides ds,
              long long bm_sb, long long bm_st, long long cm_sb,
              long long cm_st, Strides ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem_raw);
  const int b = blockIdx.y, h = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int nc = (T + kChunk - 1) / kChunk;
  const float a = A[h];

  const long long xb = b * xs.b + h * xs.h, db = b * ds.b + h * ds.h;
  const long long bb = b * bm_sb, cb = b * cm_sb;
  const long long yb = b * ys.b + h * ys.h;
  const float* Gb = G + (long long)b * nc * kChunk * kChunk;

  auto stage_chunk = [&](TcStage& st, int j) {
    const int t0 = j * kChunk;
    #pragma unroll
    for (int it = 0; it < (kChunk * 16) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int t = idx >> 4, q = (idx & 15) * 4;
      const bool in = t0 + t < T;
      const long long tt = in ? t0 + t : 0;   // a valid row when zero-filled
      cp_async16(&st.x[t * kLdX + q], x + xb + tt * xs.t + q, in);
      cp_async16(&st.b[t * kLdX + q], Bm + bb + tt * bm_st + q, in);
      cp_async16(&st.c[t * kLdC + q], Cm + cb + tt * cm_st + q, in);
    }
    const float* Gj = Gb + (long long)j * kChunk * kChunk;
    #pragma unroll
    for (int it = 0; it < (kChunk * 8) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int t = idx >> 3, q = (idx & 7) * 4;
      cp_async16(&st.w[t * kLdW + q], Gj + t * kChunk + q, true);
    }
    if (tid < kChunk) {
      const bool in = t0 + tid < T;
      cp_async4(&st.dt[tid], dt + db + (in ? t0 + tid : 0) * ds.t, in);
    }
  };

  // The fragments' k index is permuted inside each 8-step: fragment
  // columns tig and tig + 4 take steps 2 tig and 2 tig + 1 (A and B alike,
  // so the sums are unchanged), which makes each A pair one 8-byte load.
  // The n index is permuted too: column g of n-tile jn is column
  // J g + jn of the warp's J n-tiles, so a thread's B values of one step
  // are J consecutive floats, and its outputs 2 J consecutive ones.
  //
  // The state: this warp's 16 x 32 tile of the (P, N) accumulator, rows
  // p = sp (+8), its n-tile jn holding columns sn + 8 tig + jn (+4).
  const int sp = 16 * (warp & 3) + g, sn = 32 * (warp >> 2);
  float hs[4][4];
  auto store_state = [&](float* dst, int ld) {   // 4 float4 a thread
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (sp + 8 * (i >> 1)) * ld + sn +
                                 8 * tig + 4 * (i & 1)) =
          make_float4(hs[0][i], hs[1][i], hs[2][i], hs[3][i]);
  };
  const float* h0_bh = h0 + ((long long)b * H + h) * kDim * kDim;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hs[jn][i] = h0_bh[(sp + 8 * (i >> 1)) * kDim + sn + 8 * tig +
                        4 * (i & 1) + jn];
  store_state(sm.h, kLdH);

  // y's tile of this warp: rows t = ym + g (+8), columns p = yp + 4 tig + 0..3
  const int ym = 16 * (warp & 1), yp = 16 * (warp >> 1);

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
    // --- L: every warp scans dt * A itself (lane t holds L_t) and writes
    // the same values to shared memory, so no barrier is needed before its
    // own reads; then W = exp(L_t - L_s) o G in place, once per head ------
    float L = st.dt[lane] * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kAll, L, off);
      if (lane >= off) L += o;
    }
    const float Lc = __shfl_sync(kAll, L, kChunk - 1);
    sm.L[lane] = L;
    __syncwarp();
    {                                // 4 consecutive s of one row t
      const int t = tid >> 3, s0 = 4 * (tid & 7);
      float4* wp = reinterpret_cast<float4*>(&st.w[t * kLdW + s0]);
      const float4 ls = ld4(&sm.L[s0]);
      const float lt = sm.L[t];
      float4 w = *wp;
      w.x = s0 <= t ? w.x * __expf(fminf(lt - ls.x, 0.f)) : 0.f;
      w.y = s0 + 1 <= t ? w.y * __expf(fminf(lt - ls.y, 0.f)) : 0.f;
      w.z = s0 + 2 <= t ? w.z * __expf(fminf(lt - ls.z, 0.f)) : 0.f;
      w.w = s0 + 3 <= t ? w.w * __expf(fminf(lt - ls.w, 0.f)) : 0.f;
      *wp = w;
    }
    __syncthreads();
    // --- y = W (x dt) + (exp(L) o C) h^T ----------------------------------
    {
      float acc[2][4] = {}, accx[2][4] = {};   // hi*hi; the cross terms
      uint32_t ah[4], al[4], bh[2], bl[2];
      const int t0r = ym + g, t1r = t0r + 8;
      for (int ks = 0; ks < (ym + 16) / 8; ++ks) {   // s <= t only
        const int s = 8 * ks + 2 * tig;
        const float2 w0 = ld2(&st.w[t0r * kLdW + s]);
        const float2 w1 = ld2(&st.w[t1r * kLdW + s]);
        split_a(w0.x, w1.x, w0.y, w1.y, ah, al);
        const float2 d = ld2(&st.dt[s]);
        const float2 x0 = ld2(&st.x[s * kLdX + yp + 2 * g]);
        const float2 x1 = ld2(&st.x[(s + 1) * kLdX + yp + 2 * g]);
        split(x0.x * d.x, bh[0], bl[0]);
        split(x1.x * d.y, bh[1], bl[1]);
        mma3(acc[0], accx[0], ah, al, bh, bl);
        split(x0.y * d.x, bh[0], bl[0]);
        split(x1.y * d.y, bh[1], bl[1]);
        mma3(acc[1], accx[1], ah, al, bh, bl);
      }
      const float e0 = __expf(__shfl_sync(kAll, L, t0r));
      const float e1 = __expf(__shfl_sync(kAll, L, t1r));
#pragma unroll 2
      for (int ks = 0; ks < kDim / 8; ++ks) {
        const int n = 8 * ks + 2 * tig;
        const float2 c0 = ld2(&st.c[t0r * kLdC + n]);
        const float2 c1 = ld2(&st.c[t1r * kLdC + n]);
        split_a(c0.x * e0, c1.x * e1, c0.y * e0, c1.y * e1, ah, al);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const float2 hv = ld2(&sm.h[(yp + 2 * g + jn) * kLdH + n]);
          split(hv.x, bh[0], bl[0]);
          split(hv.y, bh[1], bl[1]);
          mma3(acc[jn], accx[jn], ah, al, bh, bl);
        }
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
          *reinterpret_cast<float4*>(y + yb + (long long)t * ys.t + yp +
                                     4 * tig) =
              make_float4(acc[0][2 * half], acc[1][2 * half],
                          acc[0][2 * half + 1], acc[1][2 * half + 1]);
      }
    }
    // --- h = exp(L_c) h + (x dt exp(L_c - L))^T B, in registers ----------
    {
      const float decay = __expf(Lc);
      float hx[4][4] = {};                     // this chunk's cross terms
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) hs[jn][i] *= decay;
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const int s = 8 * ks + 2 * tig;
        const float2 d = ld2(&st.dt[s]);
        const float fa =
            d.x * __expf(fminf(Lc - __shfl_sync(kAll, L, s), 0.f));
        const float fb =
            d.y * __expf(fminf(Lc - __shfl_sync(kAll, L, s + 1), 0.f));
        const float* xa = &st.x[s * kLdX + sp];
        split_a(xa[0] * fa, xa[8] * fa, xa[kLdX] * fb, xa[kLdX + 8] * fb, ah,
                al);
        const float4 b0 = ld4(&st.b[s * kLdX + sn + 4 * g]);
        const float4 b1 = ld4(&st.b[(s + 1) * kLdX + sn + 4 * g]);
        const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
        const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          split(bv0[jn], bh[0], bl[0]);
          split(bv1[jn], bh[1], bl[1]);
          mma3(hs[jn], hx[jn], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) hs[jn][i] += hx[jn][i];
    }
    __syncthreads();              // every read of sm.h and of this stage
    store_state(sm.h, kLdH);
  }

  store_state(hT + ((long long)b * H + h) * kDim * kDim, kDim);
}

}  // namespace

extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       void* y, void* hT, int B, int T, int H, int P, int N,
                       long long x_sb, long long x_st, long long x_sh,
                       long long d_sb, long long d_st, long long d_sh,
                       long long bm_sb, long long bm_st, long long cm_sb,
                       long long cm_st, long long y_sb, long long y_st,
                       long long y_sh, void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxP, kMaxN) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const size_t smem = smem_floats(P, N) * sizeof(float);
  dim3 grid(H, B);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), T, H, P, N,
      Strides{x_sb, x_st, x_sh}, Strides{d_sb, d_st, d_sh}, bm_sb, bm_st,
      cm_sb, cm_st, Strides{y_sb, y_st, y_sh});
  return static_cast<int>(cudaGetLastError());
}

// P = N = 64; G is (B, ceil(T / 32), 32, 32) float32 scratch.
extern "C" int ssd_tc_fwd(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* h0,
                          void* G, void* y, void* hT, int B, int T, int H,
                          long long x_sb, long long x_st, long long x_sh,
                          long long d_sb, long long d_st, long long d_sh,
                          long long bm_sb, long long bm_st, long long cm_sb,
                          long long cm_st, long long y_sb, long long y_st,
                          long long y_sh, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(TcSmem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (T + kChunk - 1) / kChunk;
  ssd_gram_kernel<<<dim3(nc, B), kThreads, 0, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(G), T, bm_sb, bm_st, cm_sb, cm_st);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tc_kernel<<<dim3(H, B), kThreads, sizeof(TcSmem), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(G),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), T, H, Strides{x_sb, x_st, x_sh},
      Strides{d_sb, d_st, d_sh}, bm_sb, bm_st, cm_sb, cm_st,
      Strides{y_sb, y_st, y_sh});
  return static_cast<int>(cudaGetLastError());
}
