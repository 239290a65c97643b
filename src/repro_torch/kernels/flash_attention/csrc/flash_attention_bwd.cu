// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: no TPU kernel.  The JAX package differentiates its plain jnp
// attention (its Pallas flash kernel, repro/kernels/flash_attention/
// kernel.py::flash_attention_bhsd, is opt-in and has no custom_vjp), while
// the port always runs K1's forward (flash_attention.cu) on the card, so
// training needs this gradient of K1 to get any gradient through attention.
//
// What it computes: the gradient of K1's function.  With the forward's
// per-row log-sum-exp lse (written by flash_attention_fwd) and
//   P = exp(scale * Q K^T - lse)   on the visible (query, key) pairs, else 0,
//   Delta = rowsum(dO * O),
//   dS = P * (dO V^T - Delta),
// it writes dV = P^T dO, dK = scale * dS^T Q and dQ = scale * dS K, the G
// query heads of a KV head summed into its dK/dV.  Visibility is the
// forward's exactly: key kp is visible to query qp iff kp < min(lengths[b],
// Skv), kp <= qp under `causal` and qp - window < kp under a window; query
// and key positions both count from 0 (Skv != S is cross-attention).  A row
// that sees no key (lse = -inf) gets zero gradients.  Layouts are K1's:
// q, o, dO and dq (B,S,H,hd), k, v, dk and dv (B,Skv,K,hd), read and
// written through (batch, seq, head) element strides with the last
// dimension contiguous; lse and Delta (B,H,S) fp32.  Gradients come out in
// the inputs' dtype, accumulated in fp32.
//
// Design: three launches, no atomics, so two runs give the same bits.
//  * delta_kernel: Delta, one warp per (b, s, h) row.
//  * dK/dV: over keys.  An item's K and V stay in place while the G query
//    heads of its KV head and their query tiles that can see it stream
//    past, so the GQA sum happens inside the block; P is recomputed from
//    lse on the way.
//  * dQ: over query rows of one head, over the key tiles they see, the
//    same recomputation (the price of having no atomics).
// Three routes, chosen per call as K1's forward chooses (the caller's
// ops.tensor_core_path, the entry's tc argument):
//  * bf16 on tensor cores (head_dim 64, 80, 96 or 128, 16-byte aligned
//    rows: dkdv_wgmma_kernel, dq_wgmma_kernel; the last section below);
//  * fp32 on tensor cores, the same head dims and alignment
//    (dkdv_tf32_kernel, dq_tf32_kernel; the section before it): every
//    product as TF32 x 3 on mma.sync (kernels/csrc/tf32x3.cuh), P and dS
//    split like the inputs, the fp32 precision of the gradient JAX takes
//    of its float32 attention.  It serves whisper's encoder in training (6
//    launches a step).  At its B=2 step shape (S = Skv = 1500, 8/8 heads of
//    64) the ideal work is 23.0 GFLOP of products against 98 MB, 0.140 ms
//    at a third of the TF32 peak; the design does seven products a pair
//    (S and dP again in the dQ kernel) where five are ideal, the price of
//    having no atomics;
//  * CUDA cores (other head dims up to 256, rows off a 16-byte boundary,
//    fp32 or bf16): the forward's CUDA-core layout, HD_PAD/32 lanes owning
//    one row's head dims in registers, dot products reduced by warp
//    shuffles, 32-row tiles of the other side staged in shared memory as
//    fp32.
// What bounds the bf16 route on an H100: at danube's training shape (B=4,
// S=2048, 32/8 heads of 80, causal) the gradient's ideal work is five
// products a visible pair, 215 GFLOP (2.5x the forward's 86), against
// about 0.3 GB of q, k, v, o, dO and the three gradients: some 700
// operations a byte, far above the card's ~295, so the tensor cores bound
// it (0.217 ms at the bf16 peak).  What the tensor-core design does about it:
//  * every product on wgmma, the only way to the tensor cores' full rate:
//    S^T = K Q^T and dP^T = V dO^T from shared memory, then dV += P^T dO
//    and dK += dS^T Q with P^T and dS^T as register A operands (the dQ
//    kernel: S = Q K^T, dP = dO V^T, dQ += dS K);
//  * P and dS enter their products as bf16 hi + lo parts (pack_bf16_split,
//    as K1's forward takes P), so the only bf16 rounding left is the
//    inputs' own and the gradients' final one;
//  * one shared-memory layout serves both readings of a tile: 16-dim
//    chunks of 32-byte rows, 32B-swizzled, read K-major (chunk c is k-step
//    c) for S^T and dP^T and MN-major (16 rows of every chunk are a k-step
//    of N = hd) for the accumulating products, so nothing is transposed in
//    shared memory, and hd 80 and 96 run exact k-steps and N (on the hd-128
//    instantiation with TMA zero-filling dims 80-127, as the forward runs
//    them, danube's backward took 1.62 ms against 1.33 exact on "NVIDIA
//    H100 80GB HBM3, 700.00 W": scripts/k1_bwd_variants.py);
//  * a producer warp issues TMA loads of the streamed tiles into a ring of
//    stages on mbarriers (lse and Delta rows by cp.async beside them) and
//    reloads an item's resident pair only after its first stages; its
//    warpgroup gives registers to the two consumer warpgroups
//    (setmaxnreg), which at hd 128 hold dK's and dV's 128 accumulators a
//    thread besides S^T's and dP^T's 64;
//  * persistent blocks, one per SM, walk items longest first (causal:
//    the first keys, or the last query rows), the dK/dV walk snaking;
//  * masks only on tiles that straddle the length, S, the diagonal or the
//    window edge; tiles that no key (row) of an item sees are neither
//    loaded nor multiplied.  A query row that sees no key (lse = -inf)
//    only ever meets such a tile, where P is selected to 0, never exp(inf).
// What it still lacks: ten products a pair where five are ideal (S and
// dP recomputed by the dQ kernel, P and dS as hi + lo); inside a
// warpgroup a tile's products wait for each other (the two warpgroups
// overlap one another; a one-tile software pipeline ran slower, its
// registers spilling); the gradients are stored from registers, not TMA.

#include <math.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The valid keys of batch row b: min(lengths[b], Skv), or Skv.
__device__ __forceinline__ int valid_keys(const int* lengths, int b,
                                          int Skv) {
  const int L = lengths != nullptr ? lengths[b] : Skv;
  return min(max(L, 0), Skv);
}

// Whether key kp is visible to query qp: K1's mask.
__device__ __forceinline__ bool visible(int kp, int qp, int L, int causal,
                                        int window) {
  return kp < L && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// dS of one pair from P, dP = dO . v and Delta.
__device__ __forceinline__ float dsoft(float p, float dp, float delta) {
  return p * (dp - delta);
}

// The query rows that can see some key of [k0, k1): [lo, hi).
__device__ __forceinline__ void query_range(int k0, int k1, int S, int causal,
                                            int window, int& lo, int& hi) {
  lo = causal ? k0 : 0;
  hi = window > 0 ? min(S, k1 - 1 + window) : S;
}

// The keys that some query row of [q0, q1) can see, below L: [lo, hi).
__device__ __forceinline__ void key_range(int q0, int q1, int L, int causal,
                                          int window, int& lo, int& hi) {
  lo = window > 0 ? max(0, q0 - window + 1) : 0;
  hi = causal ? min(L, q1) : L;
}

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * O), one warp per (b, s, h) row, written (B,H,S).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H, int hd,
             Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * S * H) return;
  const int h = (int)(row % H);
  const int s = (int)((row / H) % S);
  const int b = (int)(row / ((long long)H * S));
  const T* orow = o + b * os.b + (long long)s * os.s + h * os.h;
  const T* drow = dout + b * dos.b + (long long)s * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc += to_float(orow[d]) * to_float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
}

// ---------------------------------------------------------------------------
// CUDA-core path.  A row of the block's own side (keys for dK/dV, queries
// for dQ) is owned by TPR = HD_PAD/32 consecutive lanes holding 32 of its
// head dims (dims 4*(c*TPR + sub) + e, c < 8, e < 4, as K1's forward).
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kDims = 32;      // head dims a lane owns
constexpr int kTile = 32;      // rows of the other side per shared tile

template <typename T, int TPR>
__device__ __forceinline__ void load_row(const T* row, int hd, int sub,
                                         bool valid, float (&r)[kDims]) {
#pragma unroll
  for (int c = 0; c < kDims / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * TPR + sub) + e;
      r[4 * c + e] = valid && d < hd ? to_float(row[d]) : 0.f;
    }
}

template <typename T, int TPR>
__device__ __forceinline__ void store_row(T* row, int hd, int sub,
                                          const float (&r)[kDims],
                                          float mul) {
#pragma unroll
  for (int c = 0; c < kDims / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * TPR + sub) + e;
      if (d < hd) row[d] = from_float<T>(r[4 * c + e] * mul);
    }
}

// The dot product of a lane's 32 dims with a staged row, summed over the
// TPR lanes of the row.
template <int TPR>
__device__ __forceinline__ float row_dot(const float (&r)[kDims],
                                         const float* srow, int sub) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kDims / 4; ++c) {
    const float4 x = s4[c * TPR + sub];
    dot += r[4 * c] * x.x + r[4 * c + 1] * x.y + r[4 * c + 2] * x.z +
           r[4 * c + 3] * x.w;
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

template <int TPR>
__device__ __forceinline__ void row_axpy(float (&acc)[kDims], float a,
                                         const float* srow, int sub) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int c = 0; c < kDims / 4; ++c) {
    const float4 x = s4[c * TPR + sub];
    acc[4 * c] += a * x.x;
    acc[4 * c + 1] += a * x.y;
    acc[4 * c + 2] += a * x.z;
    acc[4 * c + 3] += a * x.w;
  }
}

// One block per (key tile of BK keys, KV head, batch row).
template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv,
            const int* __restrict__ lengths, int S, int Skv, int H, int G,
            int hd, Strides qs, Strides ks, Strides vs, Strides dos,
            Strides dks, Strides dvs, int causal, int window, float scale) {
  constexpr int TPR = HD_PAD / kDims;
  constexpr int BK = kThreads / TPR;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kTile][HD_PAD]
  float* do_s = q_s + kTile * HD_PAD;             // [kTile][HD_PAD]
  float* lse_s = do_s + kTile * HD_PAD;           // [kTile]
  float* dl_s = lse_s + kTile;                    // [kTile]

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int kp = k0 + tid / TPR;
  const int L = valid_keys(lengths, b, Skv);

  float kr[kDims], vr[kDims], dka[kDims], dva[kDims];
  load_row<T, TPR>(k + b * ks.b + (long long)min(kp, Skv - 1) * ks.s +
                       kh * ks.h, hd, sub, kp < Skv, kr);
  load_row<T, TPR>(v + b * vs.b + (long long)min(kp, Skv - 1) * vs.s +
                       kh * vs.h, hd, sub, kp < Skv, vr);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dka[i] = dva[i] = 0.f;

  if (k0 < L) {
    int qlo, qhi;
    query_range(k0, min(k0 + BK, L), S, causal, window, qlo, qhi);
    for (int hh = 0; hh < G; ++hh) {
      const int h = kh * G + hh;
      for (int t0 = qlo; t0 < qhi; t0 += kTile) {
        __syncthreads();    // the previous tile is no longer read
        for (int idx = tid; idx < kTile * HD_PAD; idx += kThreads) {
          const int j = idx / HD_PAD;
          const int d = idx % HD_PAD;
          const int qp = t0 + j;
          float qx = 0.f, dx = 0.f;
          if (qp < qhi && d < hd) {
            qx = to_float(q[b * qs.b + (long long)qp * qs.s + h * qs.h + d]);
            dx = to_float(
                dout[b * dos.b + (long long)qp * dos.s + h * dos.h + d]);
          }
          q_s[idx] = qx;
          do_s[idx] = dx;
        }
        for (int j = tid; j < kTile; j += kThreads) {
          const int qp = t0 + j;
          const long long r = ((long long)b * H + h) * S + qp;
          lse_s[j] = qp < qhi ? lse[r] : 0.f;
          dl_s[j] = qp < qhi ? delta[r] : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          const int qp = t0 + j;
          const float* qrow = q_s + j * HD_PAD;
          const float* drow = do_s + j * HD_PAD;
          const float s = row_dot<TPR>(kr, qrow, sub);
          const float dp = row_dot<TPR>(vr, drow, sub);
          const float p = qp < qhi && visible(kp, qp, L, causal, window)
                              ? expf(s * scale - lse_s[j])
                              : 0.f;
          const float ds = dsoft(p, dp, dl_s[j]);
          row_axpy<TPR>(dva, p, drow, sub);
          row_axpy<TPR>(dka, ds, qrow, sub);
        }
      }
    }
  }
  if (kp < Skv) {
    store_row<T, TPR>(dk + b * dks.b + (long long)kp * dks.s + kh * dks.h,
                      hd, sub, dka, scale);
    store_row<T, TPR>(dv + b * dvs.b + (long long)kp * dvs.s + kh * dvs.h,
                      hd, sub, dva, 1.f);
  }
}

// One block per (query tile of BQ rows, query head, batch row).
template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, const int* __restrict__ lengths, int S,
          int Skv, int H, int G, int hd, Strides qs, Strides ks, Strides vs,
          Strides dos, Strides dqs, int causal, int window, float scale) {
  constexpr int TPR = HD_PAD / kDims;
  constexpr int BQ = kThreads / TPR;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kTile][HD_PAD]
  float* v_s = k_s + kTile * HD_PAD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int qp = q0 + tid / TPR;
  const int L = valid_keys(lengths, b, Skv);
  const int qc = min(qp, S - 1);

  float qr[kDims], dor[kDims], dqa[kDims];
  load_row<T, TPR>(q + b * qs.b + (long long)qc * qs.s + h * qs.h, hd, sub,
                   qp < S, qr);
  load_row<T, TPR>(dout + b * dos.b + (long long)qc * dos.s + h * dos.h, hd,
                   sub, qp < S, dor);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dqa[i] = 0.f;
  const long long r = ((long long)b * H + h) * S + qc;
  const float lse_r = lse[r];
  const float dl_r = delta[r];

  int lo, hi;
  key_range(q0, q0 + BQ, L, causal, window, lo, hi);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * HD_PAD; idx += kThreads) {
      const int j = idx / HD_PAD;
      const int d = idx % HD_PAD;
      const int kp = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < hi && d < hd) {
        kx = to_float(k[b * ks.b + (long long)kp * ks.s + kh * ks.h + d]);
        vx = to_float(v[b * vs.b + (long long)kp * vs.s + kh * vs.h + d]);
      }
      k_s[idx] = kx;
      v_s[idx] = vx;
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const int kp = t0 + j;
      const float* krow = k_s + j * HD_PAD;
      const float s = row_dot<TPR>(qr, krow, sub);
      const float dp = row_dot<TPR>(dor, v_s + j * HD_PAD, sub);
      const float p = qp < S && kp < hi && visible(kp, qp, L, causal, window)
                          ? expf(s * scale - lse_r)
                          : 0.f;
      row_axpy<TPR>(dqa, dsoft(p, dp, dl_r), krow, sub);
    }
  }
  if (qp < S)
    store_row<T, TPR>(dq + b * dqs.b + (long long)qp * dqs.s + h * dqs.h,
                      hd, sub, dqa, scale);
}

// ---------------------------------------------------------------------------
// Tensor-core float32 path: fp32, head_dim HD in {64, 80, 96, 128}, every
// row start 16-byte aligned.  The CUDA-core kernels' structure (a block of
// 64 resident rows of its own side streaming 32-row tiles of the other
// side through a two-stage cp.async ring, no atomics), with every product
// of a visible pair on mma.sync m16n8k8 in TF32 x 3 (tf32x3.cuh: operands
// split into hi + lo parts, fp32 accumulators), so the gradient keeps
// fp32 precision.  A block is four warps; a warp owns 16 resident rows (a
// lane holds rows g and g + 8 of them).
//  * dkdv_tf32_kernel, per (64 keys, KV head, b): S^T = K Q^T and
//    dP^T = V dO^T with the warp's K and V rows as A, then P^T from lse and
//    dS^T = P^T (dP^T - Delta) in the accumulator layout, which is the A
//    layout of dV += P^T dO and dK += dS^T Q once a k-step's queries are
//    ordered 2 t4, 2 t4 + 1 (no shuffle); the G query heads of the KV head
//    stream past in turn.  Each tile's dK and dV are summed from zero in
//    registers (64 head dims a pass) and added into the block's dK and dV,
//    which each thread keeps for its own fragments in shared memory.
//  * dq_tf32_kernel, per (64 query rows, head, b): S = Q K^T and
//    dP = dO V^T, P and dS as in the forward, dQ += dS K, each tile's sum
//    from zero added into dQ in registers.
// No tensor-core sum runs longer than one tile.  The k index of a k-step
// is permuted alike in both operands of S^T, dP^T, S and dP (dims 2 t4,
// 2 t4 + 1 at columns t4, t4 + 4), so a row's two values are one float2;
// every tile's row stride is 8 mod 32 (24 for hd 80), which keeps those
// reads on distinct banks.  The accumulating products read their B
// operand down a column (rows 2 t4 and 2 t4 + 1), two lanes to a bank.
// ---------------------------------------------------------------------------

constexpr int kTfWarps = 4;
constexpr int kTfThreads = 32 * kTfWarps;
// blocks an SM should hold at head dim hd, as many as shared memory
// allows: caps ptxas at 168 registers a thread (hd <= 80) or 255, which
// these kernels fit without a spill (left to its own choice it took 128
// for some and spilled; at hd 128, 168 spilled too)
constexpr int tf_min_blocks(int hd) { return hd <= 80 ? 3 : 2; }
constexpr int kTfRes = 16 * kTfWarps;        // resident rows of a block
constexpr int kTfTile = 32;                  // rows of a streamed tile
constexpr int kTfChunk = 8;                  // n-tiles (64 dims) a pass

// Shared-memory plan (floats): the resident pair (K and V; Q and dO), then
// two stages of the streamed pair (Q and dO with their rows' lse and
// Delta; K and V), then (dK/dV) each thread's dK and dV fragments.
template <int HD>
struct TfBwd {
  static constexpr int RS = HD + 8;          // every tile's row stride
  static constexpr int NT = HD / 8;          // n-tiles of HD
  static constexpr int RES = 2 * kTfRes * RS;
  static constexpr int TILE = kTfTile * RS;
  static constexpr int STAGE_KV = 2 * TILE + 2 * kTfTile;
  static constexpr int STAGE_Q = 2 * TILE;
  static constexpr int ACC = 2 * kTfRes * HD;
  static constexpr int SMEM_KV = 4 * (RES + 2 * STAGE_KV + ACC);
  static constexpr int SMEM_Q = 4 * (RES + 2 * STAGE_Q);
};

// The A fragment (rows g, g + 8; k-step columns 2 t4, 2 t4 + 1) of a k-step
// of 8 dims at `p` (row g, dim 2 t4) of a tile with row stride rs, split.
__device__ __forceinline__ void tf_a(const float* p, int rs, uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  const float2 x0 = tf32x3::ld2(p);
  const float2 x1 = tf32x3::ld2(p + 8 * rs);
  tf32x3::split_a_bits(x0.x, x1.x, x0.y, x1.y, hi, lo);
}

// acc[n] += A (B rows 8 j + 2 t4 and + 1, columns 8 n + g) for n < NT: the
// A fragments a (hi, lo) of NJ k-steps against a tile b0 (row 2 t4, column
// g) with row stride rs, summed from zero 64 columns at a time and handed
// to add(n, t) for each n-tile.
template <int NJ, int NT, typename Add>
__device__ __forceinline__ void tf_accumulate(const uint32_t (&ah)[NJ][4],
                                              const uint32_t (&al)[NJ][4],
                                              const float* b0, int rs,
                                              Add add) {
#pragma unroll
  for (int c = 0; c < NT; c += kTfChunk) {
    float t[kTfChunk][4];
#pragma unroll
    for (int n = 0; n < kTfChunk; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < kTfChunk; ++n) {
        if (c + n < NT) {
          const float* br = b0 + 8 * j * rs + 8 * (c + n);
          uint32_t bh[2], bl[2];
          tf32x3::split_bits(br[0], bh[0], bl[0]);
          tf32x3::split_bits(br[rs], bh[1], bl[1]);
          tf32x3::mma3_acc(t[n], ah[j], al[j], bh, bl);
        }
      }
#pragma unroll
    for (int n = 0; n < kTfChunk; ++n)
      if (c + n < NT) add(c + n, t[n]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTfThreads, tf_min_blocks(HD))
dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, const int* __restrict__ lengths,
                 int S, int Skv, int H, int G, Strides qs, Strides ks,
                 Strides vs, Strides dos, Strides dks, Strides dvs,
                 int causal, int window, float scale, float scale_log2) {
  using T = TfBwd<HD>;
  constexpr int NT = T::NT;
  constexpr int NJ = kTfTile / 8;            // n-tiles of S^T, k-steps after
  extern __shared__ float4 tfb_smem4[];
  float* k_s = reinterpret_cast<float*>(tfb_smem4);
  float* v_s = k_s + kTfRes * T::RS;
  float* stages = v_s + kTfRes * T::RS;

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * kTfRes;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int kw0 = k0 + 16 * warp;            // the warp's first key
  const int L = valid_keys(lengths, b, Skv);
  // this thread's dK and dV fragments: n-tile n at [n * 32]
  float4* dka = reinterpret_cast<float4*>(stages + 2 * T::STAGE_KV) +
                warp * NT * 32 + lane;
  float4* dva = dka + kTfWarps * NT * 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    dka[n * 32] = dva[n * 32] = make_float4(0.f, 0.f, 0.f, 0.f);

  int qlo = 0, qhi = 0;
  if (k0 < L) query_range(k0, min(k0 + kTfRes, L), S, causal, window, qlo,
                          qhi);
  const int ntq = qhi > qlo ? (qhi - qlo + kTfTile - 1) / kTfTile : 0;
  const int n_items = G * ntq;               // (head, query tile), heads outer

  auto load = [&](int i) {
    const int h = kh * G + i / ntq;
    const int t0 = qlo + (i % ntq) * kTfTile;
    float* st = stages + (i & 1) * T::STAGE_KV;
    cp_rows<HD, kTfTile, kTfThreads>(st, T::RS, q + b * qs.b + h * qs.h,
                                     qs.s, t0, qhi, tid);
    cp_rows<HD, kTfTile, kTfThreads>(st + T::TILE, T::RS,
                                     dout + b * dos.b + h * dos.h, dos.s, t0,
                                     qhi, tid);
    if (tid < 2 * kTfTile) {                 // lse, then Delta, of the rows
      const int j = tid % kTfTile;
      const bool ok = t0 + j < qhi;
      const long long r = ((long long)b * H + h) * S + (ok ? t0 + j : 0);
      tf32x3::cp_async4(st + 2 * T::TILE + tid,
                        (tid < kTfTile ? lse : delta) + r, ok);
    }
  };
  if (n_items > 0) {
    cp_rows<HD, kTfRes, kTfThreads>(k_s, T::RS, k + b * ks.b + kh * ks.h,
                                    ks.s, k0, Skv, tid);
    cp_rows<HD, kTfRes, kTfThreads>(v_s, T::RS, v + b * vs.b + kh * vs.h,
                                    vs.s, k0, Skv, tid);
    load(0);
  }
  tf32x3::cp_async_commit();

  const float* kr = k_s + (16 * warp + g) * T::RS + 2 * t4;
  const float* vr = v_s + (16 * warp + g) * T::RS + 2 * t4;
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      load(i + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = qlo + (i % ntq) * kTfTile;
    // some query of the tile sees some key of the warp
    if (kw0 < L && (!causal || t0 + kTfTile - 1 >= kw0) &&
        (window <= 0 || t0 - window < kw0 + 15)) {
      const float* q_t = stages + (i & 1) * T::STAGE_KV;
      const float* do_t = q_t + T::TILE;
      const float* lse_t = do_t + T::TILE;
      const float* dl_t = lse_t + kTfTile;
      // S^T and dP^T: a lane's n-tile j holds queries 8 j + 2 t4 (+1) of
      // keys g ([0..1]) and g + 8 ([2..3])
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t kh4[4], kl4[4], vh4[4], vl4[4];
        tf_a(kr + 8 * kk, T::RS, kh4, kl4);
        tf_a(vr + 8 * kk, T::RS, vh4, vl4);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int off = (8 * j + g) * T::RS + 8 * kk + 2 * t4;
          const float2 y = tf32x3::ld2(q_t + off);
          const float2 z = tf32x3::ld2(do_t + off);
          uint32_t bh[2], bl[2];
          tf32x3::split_bits(y.x, bh[0], bl[0]);
          tf32x3::split_bits(y.y, bh[1], bl[1]);
          tf32x3::mma3_acc(st[j], kh4, kl4, bh, bl);
          tf32x3::split_bits(z.x, bh[0], bl[0]);
          tf32x3::split_bits(z.y, bh[1], bl[1]);
          tf32x3::mma3_acc(dpt[j], vh4, vl4, bh, bl);
        }
      }
      // P^T from lse, dS^T = P^T (dP^T - Delta); masks only on a tile that
      // straddles the length, the query edge, the diagonal or the window
      // edge of some key of the warp
      const bool mask = kw0 + 16 > L || t0 + kTfTile > qhi ||
                        (causal && t0 < kw0 + 15) ||
                        (window > 0 && t0 + kTfTile - 1 - window >= kw0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 ls = tf32x3::ld2(lse_t + 8 * j + 2 * t4);
        const float2 dl = tf32x3::ld2(dl_t + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = t0 + 8 * j + 2 * t4 + (e & 1);
          const int kp = kw0 + g + 8 * (e >> 1);
          const float p =
              !mask || (qp < qhi && visible(kp, qp, L, causal, window))
                  ? ex2(fmaf(st[j][e], scale_log2,
                             -((e & 1) ? ls.y : ls.x) * kLog2e))
                  : 0.f;
          st[j][e] = p;
          dpt[j][e] = dsoft(p, dpt[j][e], (e & 1) ? dl.y : dl.x);
        }
      }
      // dV += P^T dO, then dK += dS^T Q (scaled at the store)
      uint32_t ah[NJ][4], al[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tf32x3::split_a_bits(st[j][0], st[j][2], st[j][1], st[j][3], ah[j],
                             al[j]);
      tf_accumulate<NJ, NT>(ah, al, do_t + 2 * t4 * T::RS + g, T::RS,
                            [&](int n, const float (&t)[4]) {
                              float4 a = dva[n * 32];
                              a.x += t[0];
                              a.y += t[1];
                              a.z += t[2];
                              a.w += t[3];
                              dva[n * 32] = a;
                            });
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tf32x3::split_a_bits(dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3],
                             ah[j], al[j]);
      tf_accumulate<NJ, NT>(ah, al, q_t + 2 * t4 * T::RS + g, T::RS,
                            [&](int n, const float (&t)[4]) {
                              float4 a = dka[n * 32];
                              a.x += t[0];
                              a.y += t[1];
                              a.z += t[2];
                              a.w += t[3];
                              dka[n * 32] = a;
                            });
    }
    __syncthreads();                         // stage i & 1 is free again
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int kp = kw0 + g + 8 * x;
    if (kp >= Skv) continue;
    float* dkr = dk + b * dks.b + (long long)kp * dks.s + kh * dks.h;
    float* dvr = dv + b * dvs.b + (long long)kp * dvs.s + kh * dvs.h;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 a = dka[n * 32];
      const float4 c = dva[n * 32];
      *reinterpret_cast<float2*>(dkr + 8 * n + 2 * t4) =
          x ? make_float2(a.z * scale, a.w * scale)
            : make_float2(a.x * scale, a.y * scale);
      *reinterpret_cast<float2*>(dvr + 8 * n + 2 * t4) =
          x ? make_float2(c.z, c.w) : make_float2(c.x, c.y);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTfThreads, tf_min_blocks(HD))
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               const int* __restrict__ lengths, int S, int Skv, int H, int G,
               Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
               int causal, int window, float scale, float scale_log2) {
  using T = TfBwd<HD>;
  constexpr int NT = T::NT;
  constexpr int NJ = kTfTile / 8;            // n-tiles of S, k-steps of dQ
  extern __shared__ float4 tfb_smem4[];
  float* q_s = reinterpret_cast<float*>(tfb_smem4);
  float* do_s = q_s + kTfRes * T::RS;
  float* stages = do_s + kTfRes * T::RS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  // causal: the row blocks that see the most keys start first
  const int mb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = mb * kTfRes;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int r0 = q0 + 16 * warp;             // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};
  const int L = valid_keys(lengths, b, Skv);
  int lo, hi, wlo, whi;
  key_range(q0, q0 + kTfRes, L, causal, window, lo, hi);
  key_range(r0, r0 + 16, L, causal, window, wlo, whi);
  const int ntiles = hi > lo ? (hi - lo + kTfTile - 1) / kTfTile : 0;
  float lq[2], dlq[2];                       // lse (log2 units) and Delta
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const long long r = ((long long)b * H + h) * S + min(rows[x], S - 1);
    lq[x] = lse[r] * kLog2e;
    dlq[x] = delta[r];
  }

  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  auto load = [&](int i) {
    float* st = stages + (i & 1) * T::STAGE_Q;
    const int t0 = lo + i * kTfTile;
    cp_rows<HD, kTfTile, kTfThreads>(st, T::RS, kb, ks.s, t0, hi, tid);
    cp_rows<HD, kTfTile, kTfThreads>(st + T::TILE, T::RS, vb, vs.s, t0, hi,
                                     tid);
  };
  if (ntiles > 0) {
    cp_rows<HD, kTfRes, kTfThreads>(q_s, T::RS, q + b * qs.b + h * qs.h,
                                    qs.s, q0, S, tid);
    cp_rows<HD, kTfRes, kTfThreads>(do_s, T::RS,
                                    dout + b * dos.b + h * dos.h, dos.s, q0,
                                    S, tid);
    load(0);
  }
  tf32x3::cp_async_commit();

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const float* qr = q_s + (16 * warp + g) * T::RS + 2 * t4;
  const float* dr = do_s + (16 * warp + g) * T::RS + 2 * t4;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load(i + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = lo + i * kTfTile;
    if (t0 < whi && t0 + kTfTile > wlo) {
      const float* k_t = stages + (i & 1) * T::STAGE_Q;
      const float* v_t = k_t + T::TILE;
      // S and dP: a lane's n-tile j holds keys 8 j + 2 t4 (+1) of rows g
      // ([0..1]) and g + 8 ([2..3])
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t qh4[4], ql4[4], dh4[4], dl4[4];
        tf_a(qr + 8 * kk, T::RS, qh4, ql4);
        tf_a(dr + 8 * kk, T::RS, dh4, dl4);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int off = (8 * j + g) * T::RS + 8 * kk + 2 * t4;
          const float2 y = tf32x3::ld2(k_t + off);
          const float2 z = tf32x3::ld2(v_t + off);
          uint32_t bh[2], bl[2];
          tf32x3::split_bits(y.x, bh[0], bl[0]);
          tf32x3::split_bits(y.y, bh[1], bl[1]);
          tf32x3::mma3_acc(s[j], qh4, ql4, bh, bl);
          tf32x3::split_bits(z.x, bh[0], bl[0]);
          tf32x3::split_bits(z.y, bh[1], bl[1]);
          tf32x3::mma3_acc(dp[j], dh4, dl4, bh, bl);
        }
      }
      // P from lse, dS = P (dP - Delta) into s; masks only on a tile that
      // straddles the length, S, the diagonal or the window edge
      const bool mask = t0 + kTfTile > L || r0 + 16 > S ||
                        (causal && t0 + kTfTile - 1 > r0) ||
                        (window > 0 && t0 <= r0 + 15 - window);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + 8 * j + 2 * t4 + (e & 1);
          const int x = e >> 1;
          const float p =
              !mask || (rows[x] < S &&
                        visible(kp, rows[x], L, causal, window))
                  ? ex2(fmaf(s[j][e], scale_log2, -lq[x]))
                  : 0.f;
          s[j][e] = dsoft(p, dp[j][e], dlq[x]);
        }
      // dQ += dS K (scaled at the store)
      uint32_t ah[NJ][4], al[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tf32x3::split_a_bits(s[j][0], s[j][2], s[j][1], s[j][3], ah[j],
                             al[j]);
      tf_accumulate<NJ, NT>(ah, al, k_t + 2 * t4 * T::RS + g, T::RS,
                            [&](int n, const float (&t)[4]) {
#pragma unroll
                              for (int e = 0; e < 4; ++e) dqa[n][e] += t[e];
                            });
    }
    __syncthreads();                         // stage i & 1 is free again
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = rows[x];
    if (r >= S) continue;
    float* dqr = dq + b * dqs.b + (long long)r * dqs.s + h * dqs.h;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dqr + 8 * n + 2 * t4) =
          make_float2(dqa[n][2 * x] * scale, dqa[n][2 * x + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, head_dim HD in {64, 80, 96, 128}, 16-byte aligned
// rows.  A block is kBwWG consumer warpgroups of 64 resident rows each and
// one producer warpgroup (its first warp issues every load; the warpgroup
// gives its registers to the consumers with setmaxnreg).  Every
// tile is 16-dim chunks of 32 bytes a row, 32B-swizzled, chunk c of a tile
// of R rows at c * R * 32 bytes: a K-major wgmma operand reads chunk c as
// k-step c, and an MN-major one reads 16 rows of every chunk as a k-step of
// N = HD, so every k-step and N slice is exact at hd 80 and 96 and one
// layout serves both readings of a tile.  The wgmma accumulator layout: a
// thread (warp w of its warpgroup, lane g * 4 + t4) holds d[j] at row
// 16 w + g + 8 ((j >> 1) & 1), column 8 (j / 4) + 2 t4 + (j & 1).
// ---------------------------------------------------------------------------

constexpr int kBwWG = 2;                       // consumer warpgroups
constexpr int kBwRows = 64 * kBwWG;            // resident rows of an item
constexpr int kBwTile = 64;                    // rows of a streamed tile
constexpr int kBwThreads = 128 * (kBwWG + 1);  // + the producer warpgroup
constexpr int kRowBytes = 32;                  // a chunk row: 16 bf16 dims
constexpr int kChunk = 16;                     // head dims a chunk
constexpr int kSmemCap = 232448 - 1024 - 256;  // less alignment, barriers
constexpr int kMaxStages = 6;
// registers a thread after setmaxnreg (the launch gives 168 to each of the
// 384): dK/dV at hd 128 holds 128 accumulators besides S^T's and dP^T's
template <int HD, bool KV>
constexpr int kProducerRegs = KV && HD == 128 ? 24 : 40;
template <int HD, bool KV>
constexpr int kConsumerRegs = KV && HD == 128 ? 240 : 232;

// Shared-memory plan: the resident pair (K and V for dK/dV, Q and dO for
// dQ), then a ring of stages of the streamed pair (Q and dO, with their
// rows' lse and Delta, for dK/dV; K and V for dQ), then the barriers.
template <int HD, bool KV>
struct BwTiles {
  static constexpr int NCH = HD / kChunk;
  static constexpr int RES_T = NCH * kBwRows * kRowBytes;
  static constexpr int TILE_T = NCH * kBwTile * kRowBytes;
  static constexpr int RES = 2 * RES_T;
  static constexpr int STAGE = 2 * TILE_T + (KV ? 1024 : 0);
  static constexpr int TX = 2 * TILE_T;     // the TMA bytes of a stage
  static constexpr int FIT = (kSmemCap - RES) / STAGE;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int BARS = RES + STAGES * STAGE;
  static constexpr int SMEM = BARS + 8 * (2 + 2 * STAGES) + 1024;
};

// One 4-byte cp.async; cp_async_arrive makes `bar` take one arrival when
// this thread's earlier cp.asyncs have landed (its count includes it).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t kmajor(const unsigned char* p) {
  return gmma_desc(p, 16, 8 * kRowBytes, kSwizzle32);
}

// 16 rows from `p` of a tile of `rows` rows as an MN-major B of N = HD:
// chunks `rows * 32` bytes apart (LBO), 8-row groups 256 bytes (SBO).
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* p,
                                            int rows) {
  return gmma_desc(p, rows * kRowBytes, 8 * kRowBytes, kSwizzle32);
}

// The r-th item of this block's walk, or -1 past the last: rounds of
// gridDim.x items, with `snake` every other round in reverse block order.
// dK/dV snakes: its items, longest first, are few (3.9 a block at danube's
// shape), and round-robin gives the first blocks 21% more than the mean
// (scripts/k1_bwd_variants.py times both).  dQ's many items come out
// within 3% of the mean either way; it walks round-robin.
__device__ __forceinline__ int walk(int r, int items, bool snake) {
  const int t = r * (int)gridDim.x + (snake && (r & 1)
                                          ? (int)gridDim.x - 1 - blockIdx.x
                                          : blockIdx.x);
  return t < items ? t : -1;
}

// A dK/dV work item: keys [k0, k0 + kBwRows) of KV head kh of batch row b.
// Its tiles are, for each query head kh * G + hh in turn, the query tiles
// [tfirst, tfirst + ntq * kBwTile) that some key of the item sees.
struct KvItem {
  int b, kh, k0, L, tfirst, ntq;
};

__device__ __forceinline__ KvItem kv_item(int t, int K, int B, int S,
                                          int Skv, const int* lengths,
                                          int causal, int window) {
  KvItem it;
  const int per = K * B;
  // the first keys see the most queries under causality: they come first;
  // KV heads run fastest
  const int rest = t % per;
  it.kh = rest % K;
  it.b = rest / K;
  it.k0 = (t / per) * kBwRows;
  it.L = valid_keys(lengths, it.b, Skv);
  it.tfirst = 0;
  it.ntq = 0;
  if (it.k0 < it.L) {
    int lo, hi;
    query_range(it.k0, min(it.k0 + kBwRows, it.L), S, causal, window, lo,
                hi);
    it.tfirst = (lo / kBwTile) * kBwTile;
    it.ntq = hi > it.tfirst ? (hi - it.tfirst + kBwTile - 1) / kBwTile : 0;
  }
  return it;
}

// A dQ work item: queries [q0, q0 + kBwRows) of query head h of batch row
// b, and the key tiles [tfirst, tfirst + ntiles * kBwTile) some row sees.
struct QItem {
  int b, h, q0, L, tfirst, ntiles;
};

__device__ __forceinline__ QItem q_item(int t, int nqb, int B, int H,
                                        int Skv, const int* lengths,
                                        int causal, int window) {
  QItem it;
  const int per = H * B;
  // causal: the rows that see the most key tiles come first
  const int qb = causal ? nqb - 1 - t / per : t / per;
  const int rest = t % per;
  it.h = rest % H;
  it.b = rest / H;
  it.q0 = qb * kBwRows;
  it.L = valid_keys(lengths, it.b, Skv);
  int lo, hi;
  key_range(it.q0, it.q0 + kBwRows, it.L, causal, window, lo, hi);
  it.tfirst = (lo / kBwTile) * kBwTile;
  it.ntiles = hi > it.tfirst ? (hi - it.tfirst + kBwTile - 1) / kBwTile : 0;
  return it;
}

// Write rows `rows` of a warpgroup's 64 x HD fp32 accumulators (times mul)
// as bf16 to head hh of batch row b; rows at or past n are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, Strides st,
                                           int b, int hh, const int (&rows)[2],
                                           int n, const float (&acc)[HD / 2],
                                           float mul, int t4) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (rows[x] >= n) continue;
    __nv_bfloat16* row =
        dst + b * st.b + (long long)rows[x] * st.s + hh * st.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * x] * mul, acc[4 * j + 2 * x + 1] * mul);
  }
}

// X (64 x 64 fp32 accumulators) as the A fragments of four k-steps, bf16
// hi parts in x[0..3] and lo parts in x[4..7]: the accumulators of n-tiles
// 2kk and 2kk+1 are the A layout of k-step kk.
__device__ __forceinline__ void split_frags(const float (&acc)[32],
                                            uint32_t (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pack_bf16_split(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1], x[kk][e],
                      x[4 + kk][e]);
}

// acc (64 x HD) += X (64 x 64, as hi + lo fragments) times the 64 x HD
// tile at `tile` read MN-major.
template <int HD>
__device__ __forceinline__ void issue_acc(float (&acc)[HD / 2],
                                          const uint32_t (&x)[8][4],
                                          const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor(tile + kk * 16 * kRowBytes, kBwTile);
    wgmma_rs<HD>(acc, x[kk], db);
    wgmma_rs<HD>(acc, x[4 + kk], db);
  }
  wgmma_commit();
}

// d (64 x 64) = A B^T over HD: A rows at `a` of a tile of `arows` rows, B
// the 64 rows of the tile at `b`, both K-major (issued, not committed).
template <int HD>
__device__ __forceinline__ void issue_rows(float (&d)[32],
                                           const unsigned char* a, int arows,
                                           const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < HD / kChunk; ++c)
    wgmma_ss_n64(d, kmajor(a + c * arows * kRowBytes),
                 kmajor(b + c * kBwTile * kRowBytes), c > 0);
}

// dK and dV.  Persistent: one block per SM walks the items t = blockIdx.x,
// blockIdx.x + gridDim.x, ...  The producer loads an item's K and V once
// (the resident pair, reused after the consumers release it) and then, in
// the ring, every (query head, query tile) of the item with the tile's lse
// and Delta rows; it loads the first stages of an item before waiting to
// reload the resident pair, so those overlap the previous item's end.
template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv,
                  const int* __restrict__ lengths, int B, int S, int Skv,
                  int H, int G, Strides dks, Strides dvs, int causal,
                  int window, float scale, float scale_log2) {
  using T = BwTiles<HD, true>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* smem =
      bw_smem_raw + ((1024u - (smem_u32(bw_smem_raw) & 1023u)) & 1023u);
  uint64_t* resfull = reinterpret_cast<uint64_t*>(smem + T::BARS);
  uint64_t* resempty = resfull + 1;
  uint64_t* full = resempty + 1;
  uint64_t* empty = full + ST;
  const int K = H / G;
  const int items = ((Skv + kBwRows - 1) / kBwRows) * K * B;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(resfull, 1);
    mbar_init(resempty, 4 * kBwWG);          // one arrival per consumer warp
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);           // the TMAs, the lanes' cp.asyncs
      mbar_init(&empty[s], 4 * kBwWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kBwWG) {                   // the producer warpgroup
    regs_dealloc<kProducerRegs<HD, true>>();
    // one warp: lane 0 issues the TMAs; every lane copies two of a tile's
    // 64 lse and Delta values by cp.async (a 1-d TMA box would need each
    // row's start 16-byte aligned, and S need not be a multiple of 4)
    if (warp == 4 * kBwWG) {
      const long long last = (long long)B * H * S - 1;
      int seq = 0;                           // ring tiles issued so far
      int n = 0;                             // items of this block so far
      for (int t; (t = walk(n, items, true)) >= 0; ++n) {
        const KvItem it =
            kv_item(t, K, B, S, Skv, lengths, causal, window);
        const int ntile = G * it.ntq;
        auto load_res = [&]() {
          if (n >= 1) mbar_wait(resempty, (n - 1) & 1);
          mbar_expect_tx(resfull, T::RES);
#pragma unroll
          for (int c = 0; c < T::NCH; ++c) {
            tma_load(smem + c * kBwRows * kRowBytes, &tm_k, resfull,
                     kChunk * c, it.kh, it.k0, it.b);
            tma_load(smem + T::RES_T + c * kBwRows * kRowBytes, &tm_v,
                     resfull, kChunk * c, it.kh, it.k0, it.b);
          }
        };
        // the first item's pair loads at once, a later one's after the
        // item's first ST tiles (or all, if fewer)
        const int at = n == 0 ? 0 : min(ntile, ST);
        for (int i = 0; i < ntile; ++i, ++seq) {
          if (i == at && lane == 0) load_res();
          const int s = seq % ST;
          if (seq >= ST) mbar_wait(&empty[s], (seq / ST - 1) & 1);
          unsigned char* st = smem + T::RES + s * T::STAGE;
          const int h = it.kh * G + i / it.ntq;
          const int t0 = it.tfirst + (i % it.ntq) * kBwTile;
          if (lane == 0) {
            mbar_expect_tx(&full[s], T::TX);
#pragma unroll
            for (int c = 0; c < T::NCH; ++c) {
              tma_load(st + c * kBwTile * kRowBytes, &tm_q, &full[s],
                       kChunk * c, h, t0, it.b);
              tma_load(st + T::TILE_T + c * kBwTile * kRowBytes, &tm_do,
                       &full[s], kChunk * c, h, t0, it.b);
            }
          }
          // rows past S (masked) read the last value rather than past it
          float* lse_s = reinterpret_cast<float*>(st + 2 * T::TILE_T);
          const long long row = ((long long)it.b * H + h) * S + t0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = lane + 32 * e;
            const long long x = min(row + j, last);
            cp_async4(lse_s + j, lse + x);
            cp_async4(lse_s + kBwTile + j, delta + x);
          }
          cp_async_arrive(&full[s]);
        }
        if (at == ntile && lane == 0) load_res();
      }
    }
  } else {
    regs_alloc<kConsumerRegs<HD, true>>();
    // consumer warpgroup wg owns keys k0 + 64 wg .. + 63 of an item
    const int wg = warp / 4;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const unsigned char* ks = smem + wg * 64 * kRowBytes;
    const unsigned char* vs = ks + T::RES_T;
    float dka[HD / 2], dva[HD / 2];
    float sacc[32], pacc[32];
    int seq = 0;
    int n = 0;
    for (int t; (t = walk(n, items, true)) >= 0; ++n) {
      const KvItem it = kv_item(t, K, B, S, Skv, lengths, causal, window);
      const int L = it.L;
      const int kw0 = it.k0 + 64 * wg;
      const int rows[2] = {kw0 + (warp % 4) * 16 + g,
                           kw0 + (warp % 4) * 16 + g + 8};
      int wlo = 0, whi = 0;                  // queries the warpgroup's keys see
      if (kw0 < L)
        query_range(kw0, min(kw0 + 64, L), S, causal, window, wlo, whi);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dka[j] = dva[j] = 0.f;
      const int ntile = G * it.ntq;
      mbar_wait(resfull, n & 1);
      for (int i = 0; i < ntile; ++i) {
        const int s = (seq + i) % ST;
        mbar_wait(&full[s], ((seq + i) / ST) & 1);
        const int t0 = it.tfirst + (i % it.ntq) * kBwTile;
        if (t0 < whi && t0 + kBwTile > wlo) {
          const unsigned char* qt = smem + T::RES + s * T::STAGE;
          const unsigned char* dot = qt + T::TILE_T;
          const float* lse_s =
              reinterpret_cast<const float*>(qt + 2 * T::TILE_T);
          const float* dl_s = lse_s + kBwTile;
          // S^T = K Q^T and dP^T = V dO^T, keys by queries
          fence_regs(sacc);
          fence_regs(pacc);
          wgmma_fence();
          issue_rows<HD>(sacc, ks, kBwRows, qt);
          issue_rows<HD>(pacc, vs, kBwRows, dot);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          fence_regs(pacc);
          // P^T and dS^T, lse and Delta by column (query); masks only on
          // tiles that straddle the length, S, the diagonal or the window
          const bool edge = kw0 + 64 > L || t0 + kBwTile > S ||
                            (causal && kw0 + 63 > t0) ||
                            (window > 0 && kw0 <= t0 + kBwTile - 1 - window);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = 8 * (j / 4) + 2 * t4 + (j & 1);
            float p = ex2(fmaf(sacc[j], scale_log2, -lse_s[col] * kLog2e));
            if (edge && !(t0 + col < S && visible(rows[(j >> 1) & 1],
                                                  t0 + col, L, causal,
                                                  window)))
              p = 0.f;
            sacc[j] = p;
            pacc[j] = dsoft(p, pacc[j], dl_s[col]);
          }
          // both split before either product is issued: P^T's fragments
          // stay live while dV's wgmma runs, and at hd 128 dS^T's fp32
          // values beside them would not fit in the registers
          uint32_t pf[8][4], df[8][4];
          split_frags(sacc, pf);
          split_frags(pacc, df);
          wgmma_fence();
          issue_acc<HD>(dva, pf, dot);       // dV += P^T dO
          issue_acc<HD>(dka, df, qt);        // dK += dS^T Q
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      __syncwarp();                          // K and V of this item are done
      if (lane == 0) mbar_arrive(resempty);
      seq += ntile;
      store_rows<HD>(dk, dks, it.b, it.kh, rows, Skv, dka, scale, t4);
      store_rows<HD>(dv, dvs, it.b, it.kh, rows, Skv, dva, 1.f, t4);
    }
  }
}

// dQ: the forward's skeleton.  Persistent blocks walk items of kBwRows
// query rows of one head; the producer loads an item's Q and dO once and
// its K and V tiles into the ring.
template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq,
                const int* __restrict__ lengths, int B, int S, int Skv,
                int H, int G, Strides dqs, int causal, int window,
                float scale, float scale_log2) {
  using T = BwTiles<HD, false>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* smem =
      bw_smem_raw + ((1024u - (smem_u32(bw_smem_raw) & 1023u)) & 1023u);
  uint64_t* resfull = reinterpret_cast<uint64_t*>(smem + T::BARS);
  uint64_t* resempty = resfull + 1;
  uint64_t* full = resempty + 1;
  uint64_t* empty = full + ST;
  const int nqb = (S + kBwRows - 1) / kBwRows;
  const int items = nqb * H * B;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(resfull, 1);
    mbar_init(resempty, 4 * kBwWG);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kBwWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kBwWG) {                   // the producer warpgroup
    regs_dealloc<kProducerRegs<HD, false>>();
    if (warp == 4 * kBwWG && lane == 0) {
      int seq = 0;
      int n = 0;
      for (int t; (t = walk(n, items, false)) >= 0; ++n) {
        const QItem it = q_item(t, nqb, B, H, Skv, lengths, causal, window);
        const int kh = it.h / G;
        auto load_res = [&]() {
          if (n >= 1) mbar_wait(resempty, (n - 1) & 1);
          mbar_expect_tx(resfull, T::RES);
#pragma unroll
          for (int c = 0; c < T::NCH; ++c) {
            tma_load(smem + c * kBwRows * kRowBytes, &tm_q, resfull,
                     kChunk * c, it.h, it.q0, it.b);
            tma_load(smem + T::RES_T + c * kBwRows * kRowBytes, &tm_do,
                     resfull, kChunk * c, it.h, it.q0, it.b);
          }
        };
        const int at = n == 0 ? 0 : min(it.ntiles, ST);
        for (int i = 0; i < it.ntiles; ++i, ++seq) {
          if (i == at) load_res();
          const int s = seq % ST;
          if (seq >= ST) mbar_wait(&empty[s], (seq / ST - 1) & 1);
          unsigned char* st = smem + T::RES + s * T::STAGE;
          const int t0 = it.tfirst + i * kBwTile;
          mbar_expect_tx(&full[s], T::TX);
#pragma unroll
          for (int c = 0; c < T::NCH; ++c) {
            tma_load(st + c * kBwTile * kRowBytes, &tm_k, &full[s],
                     kChunk * c, kh, t0, it.b);
            tma_load(st + T::TILE_T + c * kBwTile * kRowBytes, &tm_v,
                     &full[s], kChunk * c, kh, t0, it.b);
          }
        }
        if (at == it.ntiles) load_res();
      }
    }
  } else {
    regs_alloc<kConsumerRegs<HD, false>>();
    // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63 of an item
    const int wg = warp / 4;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const unsigned char* qs = smem + wg * 64 * kRowBytes;
    const unsigned char* dos = qs + T::RES_T;
    float dqa[HD / 2];
    float sacc[32], pacc[32];
    int seq = 0;
    int n = 0;
    for (int t; (t = walk(n, items, false)) >= 0; ++n) {
      const QItem it = q_item(t, nqb, B, H, Skv, lengths, causal, window);
      const int L = it.L;
      const int r0 = it.q0 + 64 * wg;
      const int rows[2] = {r0 + (warp % 4) * 16 + g,
                           r0 + (warp % 4) * 16 + g + 8};
      float lse2[2], dl[2];                  // rows past S read row S - 1
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const long long r =
            ((long long)it.b * H + it.h) * S + min(rows[x], S - 1);
        lse2[x] = lse[r] * kLog2e;
        dl[x] = delta[r];
      }
      // the key tiles some row of this warpgroup sees are one run
      const int wlo = window > 0 ? max(0, r0 - window + 1) : 0;
      const int whi = causal ? min(L, r0 + 64) : L;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dqa[j] = 0.f;
      mbar_wait(resfull, n & 1);
      for (int i = 0; i < it.ntiles; ++i) {
        const int s = (seq + i) % ST;
        mbar_wait(&full[s], ((seq + i) / ST) & 1);
        const int t0 = it.tfirst + i * kBwTile;
        if (t0 < whi && t0 + kBwTile > wlo) {
          const unsigned char* kt = smem + T::RES + s * T::STAGE;
          const unsigned char* vt = kt + T::TILE_T;
          // S = Q K^T and dP = dO V^T, queries by keys
          fence_regs(sacc);
          fence_regs(pacc);
          wgmma_fence();
          issue_rows<HD>(sacc, qs, kBwRows, kt);
          issue_rows<HD>(pacc, dos, kBwRows, vt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          fence_regs(pacc);
          const bool edge = t0 + kBwTile > L ||
                            (causal && t0 + kBwTile - 1 > r0) ||
                            (window > 0 && t0 <= r0 + 63 - window);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int x = (j >> 1) & 1;
            const int kp = t0 + 8 * (j / 4) + 2 * t4 + (j & 1);
            float p = ex2(fmaf(sacc[j], scale_log2, -lse2[x]));
            if (edge && !visible(kp, rows[x], L, causal, window)) p = 0.f;
            pacc[j] = dsoft(p, pacc[j], dl[x]);
          }
          uint32_t df[8][4];
          split_frags(pacc, df);
          wgmma_fence();
          issue_acc<HD>(dqa, df, kt);        // dQ += dS K
          wgmma_wait<0>();
          fence_regs(dqa);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      __syncwarp();                          // Q and dO of this item are done
      if (lane == 0) mbar_arrive(resempty);
      seq += it.ntiles;
      store_rows<HD>(dq, dqs, it.b, it.h, rows, S, dqa, scale, t4);
    }
  }
}

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int* lengths;
  int B, S, Skv, H, K, hd;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const long long rows = (long long)a.B * a.S * a.H;
  const long long blocks = (rows + 3) / 4;
  if (blocks > (1ll << 31) - 1) return cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, 128, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.B, a.S, a.H, a.hd, a.os, a.dos);
  return cudaGetLastError();
}

template <typename T, int HD_PAD>
cudaError_t launch_cuda_core(const Args& a) {
  constexpr int TPR = HD_PAD / kDims;
  constexpr int BR = kThreads / TPR;      // rows of the block's own side
  const int G = a.H / a.K;
  auto kv = dkdv_kernel<T, HD_PAD>;
  const size_t kv_smem = (2 * kTile * HD_PAD + 2 * kTile) * sizeof(float);
  cudaError_t e = smem_attr(kv, kv_smem);
  if (e != cudaSuccess) return e;
  kv<<<dim3((a.Skv + BR - 1) / BR, a.K, a.B), kThreads, kv_smem,
       a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lengths, a.S,
      a.Skv, a.H, G, a.hd, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.causal,
      a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kq = dq_kernel<T, HD_PAD>;
  const size_t q_smem = 2 * kTile * HD_PAD * sizeof(float);
  e = smem_attr(kq, q_smem);
  if (e != cudaSuccess) return e;
  kq<<<dim3((a.S + BR - 1) / BR, a.H, a.B), kThreads, q_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.lengths, a.S, a.Skv, a.H, G, a.hd,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cuda_core(const Args& a) {
  if (a.hd <= 32) return launch_cuda_core<T, 32>(a);
  if (a.hd <= 64) return launch_cuda_core<T, 64>(a);
  if (a.hd <= 128) return launch_cuda_core<T, 128>(a);
  return launch_cuda_core<T, 256>(a);
}

template <int HD>
cudaError_t launch_tf32(const Args& a) {
  using T = TfBwd<HD>;
  const int G = a.H / a.K;
  const float scale_log2 = a.scale * kLog2e;
  auto kv = dkdv_tf32_kernel<HD>;
  cudaError_t e = smem_attr(kv, T::SMEM_KV);
  if (e != cudaSuccess) return e;
  kv<<<dim3((a.Skv + kTfRes - 1) / kTfRes, a.K, a.B), kTfThreads, T::SMEM_KV,
       a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.lengths, a.S, a.Skv, a.H, G, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.causal, a.window, a.scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kq = dq_tf32_kernel<HD>;
  e = smem_attr(kq, T::SMEM_Q);
  if (e != cudaSuccess) return e;
  kq<<<dim3((a.S + kTfRes - 1) / kTfRes, a.H, a.B), kTfThreads, T::SMEM_Q,
       a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.lengths, a.S, a.Skv, a.H,
      G, a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale,
      scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const Args& a) {
  using bf = __nv_bfloat16;
  const int G = a.H / a.K;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  // boxes of 16 head dims (32 bytes, 32B-swizzled) by 64 or kBwRows rows;
  // TMA zero-fills rows past S or Skv, and the kernels mask them
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap q_t, do_t, k_r, v_r, q_r, do_r, k_t, v_t;
  if (!make_map(&q_t, a.q, a.B, a.S, a.H, HD, a.qs, kBwTile, kChunk, sw) ||
      !make_map(&do_t, a.dout, a.B, a.S, a.H, HD, a.dos, kBwTile, kChunk,
                sw) ||
      !make_map(&k_r, a.k, a.B, a.Skv, a.K, HD, a.ks, kBwRows, kChunk, sw) ||
      !make_map(&v_r, a.v, a.B, a.Skv, a.K, HD, a.vs, kBwRows, kChunk, sw) ||
      !make_map(&q_r, a.q, a.B, a.S, a.H, HD, a.qs, kBwRows, kChunk, sw) ||
      !make_map(&do_r, a.dout, a.B, a.S, a.H, HD, a.dos, kBwRows, kChunk,
                sw) ||
      !make_map(&k_t, a.k, a.B, a.Skv, a.K, HD, a.ks, kBwTile, kChunk, sw) ||
      !make_map(&v_t, a.v, a.B, a.Skv, a.K, HD, a.vs, kBwTile, kChunk, sw))
    return cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  auto kv = dkdv_wgmma_kernel<HD>;
  constexpr int kv_smem = BwTiles<HD, true>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (e != cudaSuccess) return e;
  const long long kv_items =
      (long long)((a.Skv + kBwRows - 1) / kBwRows) * a.K * a.B;
  kv<<<(unsigned)(kv_items < sms ? kv_items : sms), kBwThreads, kv_smem,
       a.stream>>>(q_t, do_t, k_r, v_r, a.lse, a.delta, static_cast<bf*>(a.dk),
                   static_cast<bf*>(a.dv), a.lengths, a.B, a.S, a.Skv, a.H,
                   G, a.dks, a.dvs, a.causal, a.window, a.scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kq = dq_wgmma_kernel<HD>;
  constexpr int q_smem = BwTiles<HD, false>::SMEM;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           q_smem);
  if (e != cudaSuccess) return e;
  const long long q_items =
      (long long)((a.S + kBwRows - 1) / kBwRows) * a.H * a.B;
  kq<<<(unsigned)(q_items < sms ? q_items : sms), kBwThreads, q_smem,
       a.stream>>>(q_r, do_r, k_t, v_t, a.lse, a.delta,
                   static_cast<bf*>(a.dq), a.lengths, a.B, a.S, a.Skv, a.H,
                   G, a.dqs, a.causal, a.window, a.scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The gradients of flash_attention_fwd.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, o, dout, dq, dk, dv all of it).  lse (B,H,S) fp32 is the
// forward's; delta (B,H,S) fp32 is scratch the call fills.  Strides are in
// elements; lengths may be null; window <= 0 means no window.  tc (the
// caller's ops.tensor_core_path) picks the tensor-core kernels of the
// dtype (TF32 x 3 for fp32, wgmma for bf16), which take head_dim 64, 80,
// 96 or 128 and 16-byte aligned rows and refuse other inputs; tc = 0 the
// CUDA-core kernels.  Returns cudaGetLastError() after the last launch
// (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int* lengths, int dtype, int B, int S, int Skv, int H,
    int K, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int causal, int window, float scale, void* stream,
    int tc) {
  if (B < 1 || S < 1 || Skv < 1 || K < 1 || H % K != 0 || hd < 1 ||
      hd > 256 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, lengths, B, S, Skv, H, K,
         hd, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
         Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
         Strides{do_sb, do_ss, do_sh}, Strides{dq_sb, dq_ss, dq_sh},
         Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh}, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  if (tc) {
    bool (*aligned)(const void*, const Strides&) =
        dtype == 0 ? f32_aligned : mma_aligned;
    if ((hd != 64 && hd != 80 && hd != 96 && hd != 128) ||
        !(aligned(q, a.qs) && aligned(k, a.ks) && aligned(v, a.vs) &&
          aligned(dout, a.dos) && aligned(dq, a.dqs) && aligned(dk, a.dks) &&
          aligned(dv, a.dvs)))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = dtype == 0 ? launch_delta<float>(a)
                             : launch_delta<__nv_bfloat16>(a);
  if (e != cudaSuccess) return (int)e;
  if (!tc)
    e = dtype == 0 ? dispatch_cuda_core<float>(a)
                   : dispatch_cuda_core<__nv_bfloat16>(a);
  else if (dtype == 0)
    e = hd == 64   ? launch_tf32<64>(a)
        : hd == 80 ? launch_tf32<80>(a)
        : hd == 96 ? launch_tf32<96>(a)
                   : launch_tf32<128>(a);
  else
    e = hd == 64   ? launch_wgmma<64>(a)
        : hd == 80 ? launch_wgmma<80>(a)
        : hd == 96 ? launch_wgmma<96>(a)
                   : launch_wgmma<128>(a);
  return (int)e;
}
