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
//  * dK/dV: one block per (key tile, KV head, batch row).  It keeps its
//    tile's K and V and the dK/dV accumulators for the whole loop over the
//    G query heads of the KV head and their query tiles that can see the
//    tile, recomputing P from lse on the way: the GQA sum happens inside
//    the block.
//  * dQ: one block per (query tile, query head, batch row) over the key
//    tiles its rows can see, the same recomputation.
// Two paths, chosen per call as K1's forward chooses:
//  * tensor cores (bf16, head_dim 64, 80, 96 or 128, 16-byte aligned rows):
//    64-row tiles, four warps of 16 rows, every product on mma.sync
//    m16n8k16 with fp32 accumulators.  P and dS enter their products as
//    bf16 hi + lo parts (as K1's forward takes P), so the only bf16
//    rounding left is the inputs' own and the gradients' final one.  The
//    operands sit in shared memory in the two layouts the products read
//    (Q, dO or K row-major and transposed), and fragments are loaded by
//    plain 32-bit reads.
//  * CUDA cores (fp32, other head dims up to 256, unaligned bf16): the
//    forward's CUDA-core layout, HD_PAD/32 lanes owning one row's head dims
//    in registers, dot products reduced by warp shuffles, 32-row tiles of
//    the other side staged in shared memory as fp32.
// What bounds it: at danube's training shape (B=4, S=2048, 32/8 heads of
// 80, causal) the work is about 2.5x the forward's operations against
// the bytes of q, k, v, o, dO and the three gradients, far above the
// card's ~295 operations a byte: the tensor cores bound the ideal.  This
// first kernel is simple rather than fast (no wgmma, TMA or warp
// specialisation, scalar fragment loads, P recomputed in both kernels);
// chip_smoke.py prints its time beside that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;
};

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
// Tensor-core path: bf16, head_dim HD in {64, 80, 96, 128}.  Tiles of 64
// rows on both sides; warp w owns rows 16w..16w+15 of the block's own side.
// A lane's fragments follow mma.m16n8k16: g = lane / 4, t = lane % 4; A
// holds (row g | g+8, k 2t..2t+1 | 2t+8..2t+9), B (k 2t.. | 2t+8.., n g),
// C (row g | g+8, n 2t..2t+1).
// ---------------------------------------------------------------------------

constexpr int kMT = 64;               // rows of a tile, either side

template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + 8;       // row-major tile row (bf16)
  static constexpr int LDT = kMT + 8;     // transposed tile row (bf16)
  static constexpr int ROW = kMT * LD;    // elements of a row-major tile
  static constexpr int TR = HD * LDT;     // elements of a transposed tile
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two values as the bf16 pair hi = bf16(x) and the pair of remainders
// lo = bf16(x - hi), low element first.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// A fragment of rows r0.. (16) and head dims kk*16.. of a row-major tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * LD + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// c[n] (16 x 64) = A rows r0.. of `a_tile` times B^T, B the 64 rows of
// `b_tile` (both row-major over HD head dims): S = Q K^T and its kind.
template <int HD>
__device__ __forceinline__ void rows_by_rows(float (&c)[8][4],
                                             const __nv_bfloat16* a_tile,
                                             const __nv_bfloat16* b_tile,
                                             int r0, int g, int t) {
  constexpr int LD = MmaSmem<HD>::LD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    frag_a<LD>(a, a_tile, r0, kk, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* p = b_tile + (n * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(c[n], a, ld32(p), ld32(p + 8));
    }
  }
}

// acc (16 x HD) += X (16 x 64, fp32 C fragments, as bf16 hi + lo) times the
// 64 x HD matrix held transposed in `bt` (HD rows of 64): dV += P^T dO etc.
template <int HD>
__device__ __forceinline__ void acc_product(float (&acc)[HD / 8][4],
                                            const float (&x)[8][4],
                                            const __nv_bfloat16* bt, int g,
                                            int t) {
  constexpr int LDT = MmaSmem<HD>::LDT;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0]);
    split_bf16(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1]);
    split_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const __nv_bfloat16* p = bt + (nd * 8 + g) * LDT + kc * 16 + 2 * t;
      const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
      mma_bf16(acc[nd], hi, b0, b1);
      mma_bf16(acc[nd], lo, b0, b1);
    }
  }
}

// Stage rows [r0, r0 + 64) of a (B, N, heads, HD) bf16 tensor (head `hh`
// of batch row b) in shared memory, row-major into `rm` and, where `tr` is
// not null, transposed into `tr`; rows at or past `n` are zeros.
template <int HD>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src,
                                           Strides st, int b, int hh, int r0,
                                           int n, __nv_bfloat16* rm,
                                           __nv_bfloat16* tr) {
  constexpr int LD = MmaSmem<HD>::LD;
  constexpr int LDT = MmaSmem<HD>::LDT;
  constexpr int CH = HD / 8;              // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kMT * CH; idx += blockDim.x) {
    const int j = idx / CH;
    const int c = idx % CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + j < n)
      x = *reinterpret_cast<const uint4*>(
          src + b * st.b + (long long)(r0 + j) * st.s + hh * st.h + 8 * c);
    *reinterpret_cast<uint4*>(rm + j * LD + 8 * c) = x;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(8 * c + i) * LDT + j] = e[i];
    }
  }
}

// Write a warp's 16 x HD fp32 accumulators (times mul) as bf16 rows r0 + g
// and r0 + g + 8 of head hh, rows at or past n skipped.
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, Strides st,
                                          int b, int hh, int r0, int n,
                                          const float (&acc)[HD / 8][4],
                                          float mul, int g, int t) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r0 + g + 8 * x;
    if (r >= n) continue;
    __nv_bfloat16* row = dst + b * st.b + (long long)r * st.s + hh * st.h;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const __nv_bfloat162 w = __floats2bfloat162_rn(
          acc[nd][2 * x] * mul, acc[nd][2 * x + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + 2 * t) = w;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv,
                const int* __restrict__ lengths, int S, int Skv, int H,
                int G, Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, int causal, int window,
                float scale) {
  using M = MmaSmem<HD>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* v_s = k_s + M::ROW;
  __nv_bfloat16* q_s = v_s + M::ROW;
  __nv_bfloat16* do_s = q_s + M::ROW;
  __nv_bfloat16* qt_s = do_s + M::ROW;    // Q transposed: HD rows of 64
  __nv_bfloat16* dot_s = qt_s + M::TR;    // dO transposed
  float* lse_s = reinterpret_cast<float*>(dot_s + M::TR);
  float* dl_s = lse_s + kMT;

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * kMT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;               // the warp's keys in the tile
  const int L = valid_keys(lengths, b, Skv);

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  if (k0 < L) {
    stage_tile<HD>(k, ks, b, kh, k0, Skv, k_s, nullptr);
    stage_tile<HD>(v, vs, b, kh, k0, Skv, v_s, nullptr);
    int qlo, qhi;
    query_range(k0, min(k0 + kMT, L), S, causal, window, qlo, qhi);
    for (int hh = 0; hh < G; ++hh) {
      const int h = kh * G + hh;
      for (int t0 = (qlo / kMT) * kMT; t0 < qhi; t0 += kMT) {
        __syncthreads();    // the previous tile is no longer read
        stage_tile<HD>(q, qs, b, h, t0, qhi, q_s, qt_s);
        stage_tile<HD>(dout, dos, b, h, t0, qhi, do_s, dot_s);
        for (int j = threadIdx.x; j < kMT; j += blockDim.x) {
          const int qp = t0 + j;
          const long long r = ((long long)b * H + h) * S + qp;
          lse_s[j] = qp < qhi ? lse[r] : 0.f;
          dl_s[j] = qp < qhi ? delta[r] : 0.f;
        }
        __syncthreads();
        // S^T = K Q^T, then P^T, for the warp's 16 keys x 64 queries
        float p[8][4];
        rows_by_rows<HD>(p, k_s, q_s, r0, g, t);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + r0 + g + 8 * (e >> 1);
            const int j = n * 8 + 2 * t + (e & 1);
            const int qp = t0 + j;
            p[n][e] = qp >= qlo && qp < qhi &&
                              visible(kp, qp, L, causal, window)
                          ? expf(p[n][e] * scale - lse_s[j])
                          : 0.f;
          }
        acc_product<HD>(dva, p, dot_s, g, t);          // dV += P^T dO
        float ds[8][4];
        rows_by_rows<HD>(ds, v_s, do_s, r0, g, t);     // dP^T = V dO^T
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[n][e] = dsoft(p[n][e], ds[n][e], dl_s[n * 8 + 2 * t + (e & 1)]);
        acc_product<HD>(dka, ds, qt_s, g, t);          // dK += dS^T Q
      }
    }
  }
  store_acc<HD>(dk, dks, b, kh, k0 + r0, Skv, dka, scale, g, t);
  store_acc<HD>(dv, dvs, b, kh, k0 + r0, Skv, dva, 1.f, g, t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq,
              const int* __restrict__ lengths, int S, int Skv, int H, int G,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              int causal, int window, float scale) {
  using M = MmaSmem<HD>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* do_s = q_s + M::ROW;
  __nv_bfloat16* k_s = do_s + M::ROW;
  __nv_bfloat16* v_s = k_s + M::ROW;
  __nv_bfloat16* kt_s = v_s + M::ROW;     // K transposed: HD rows of 64

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  const int q0 = blockIdx.x * kMT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;               // the warp's queries in the tile
  const int L = valid_keys(lengths, b, Skv);

  stage_tile<HD>(q, qs, b, h, q0, S, q_s, nullptr);
  stage_tile<HD>(dout, dos, b, h, q0, S, do_s, nullptr);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qp = min(q0 + r0 + g + 8 * x, S - 1);
    const long long r = ((long long)b * H + h) * S + qp;
    lse_r[x] = lse[r];
    dl_r[x] = delta[r];
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;

  int lo, hi;
  key_range(q0, q0 + kMT, L, causal, window, lo, hi);
  for (int t0 = (lo / kMT) * kMT; t0 < hi; t0 += kMT) {
    __syncthreads();
    stage_tile<HD>(k, ks, b, kh, t0, hi, k_s, kt_s);
    stage_tile<HD>(v, vs, b, kh, t0, hi, v_s, nullptr);
    __syncthreads();
    float p[8][4], ds[8][4];
    rows_by_rows<HD>(p, q_s, k_s, r0, g, t);           // S = Q K^T
    rows_by_rows<HD>(ds, do_s, v_s, r0, g, t);         // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int qp = q0 + r0 + g + 8 * x;
        const int kp = t0 + n * 8 + 2 * t + (e & 1);
        const float pv = qp < S && kp >= lo && kp < hi &&
                                 visible(kp, qp, L, causal, window)
                             ? expf(p[n][e] * scale - lse_r[x])
                             : 0.f;
        ds[n][e] = dsoft(pv, ds[n][e], dl_r[x]);
      }
    acc_product<HD>(dqa, ds, kt_s, g, t);              // dQ += dS K
  }
  store_acc<HD>(dq, dqs, b, h, q0 + r0, S, dqa, scale, g, t);
}

bool mma_aligned(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
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
cudaError_t launch_mma(const Args& a) {
  using M = MmaSmem<HD>;
  using bf = __nv_bfloat16;
  const int G = a.H / a.K;
  auto kv = dkdv_mma_kernel<HD>;
  const size_t kv_smem =
      (4 * M::ROW + 2 * M::TR) * sizeof(bf) + 2 * kMT * sizeof(float);
  cudaError_t e = smem_attr(kv, kv_smem);
  if (e != cudaSuccess) return e;
  kv<<<dim3((a.Skv + kMT - 1) / kMT, a.K, a.B), kThreads, kv_smem,
       a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.lengths,
      a.S, a.Skv, a.H, G, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.causal,
      a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kq = dq_mma_kernel<HD>;
  const size_t q_smem = (4 * M::ROW + M::TR) * sizeof(bf);
  e = smem_attr(kq, q_smem);
  if (e != cudaSuccess) return e;
  kq<<<dim3((a.S + kMT - 1) / kMT, a.H, a.B), kThreads, q_smem,
       a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dq), a.lengths, a.S, a.Skv, a.H, G, a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace

// The gradients of flash_attention_fwd.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, o, dout, dq, dk, dv all of it).  lse (B,H,S) fp32 is the
// forward's; delta (B,H,S) fp32 is scratch the call fills.  Strides are in
// elements; lengths may be null; window <= 0 means no window.  Returns
// cudaGetLastError() after the last launch (0 on success).  Whether the
// tensor-core path was taken is written to *tensor_cores when not null.
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
    int* tensor_cores) {
  if (B < 1 || S < 1 || Skv < 1 || K < 1 || H % K != 0 || hd < 1 ||
      hd > 256 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, lengths, B, S, Skv, H, K,
         hd, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
         Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
         Strides{do_sb, do_ss, do_sh}, Strides{dq_sb, dq_ss, dq_sh},
         Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh}, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  const bool tc = dtype == 1 && (hd == 64 || hd == 80 || hd == 96 ||
                                 hd == 128) &&
                  mma_aligned(q, a.qs) && mma_aligned(k, a.ks) &&
                  mma_aligned(v, a.vs) && mma_aligned(dout, a.dos) &&
                  mma_aligned(dq, a.dqs) && mma_aligned(dk, a.dks) &&
                  mma_aligned(dv, a.dvs);
  if (tensor_cores != nullptr) *tensor_cores = tc ? 1 : 0;
  cudaError_t e;
  if (dtype == 0)
    e = launch_delta<float>(a);
  else if (dtype == 1)
    e = launch_delta<__nv_bfloat16>(a);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    e = dispatch_cuda_core<float>(a);
  else if (!tc)
    e = dispatch_cuda_core<__nv_bfloat16>(a);
  else if (hd == 64)
    e = launch_mma<64>(a);
  else if (hd == 80)
    e = launch_mma<80>(a);
  else if (hd == 96)
    e = launch_mma<96>(a);
  else
    e = launch_mma<128>(a);
  return (int)e;
}
