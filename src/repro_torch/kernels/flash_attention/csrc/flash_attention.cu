// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (the Pallas TPU kernel; pl.pallas_call at kernel.py:97).
//
// What it computes (the same function as the TPU kernel): softmax attention
// of S queries over Skv keys (Skv != S is cross-attention), with causal
// masking, an optional sliding window (key kp is visible to query qp iff
// qp - window < kp), per-row ragged valid key counts, and GQA (query head h
// reads KV head h / G).  Query and key positions both count from 0, as in
// the TPU kernel's mask, so causal with Skv != S keeps kp <= qp.  Scores are
// scaled by 1/sqrt(head_dim); the softmax is the fp32 online softmax
// (running max m, running sum l, fp32 accumulator).  A row with no visible
// key produces zeros.
//
// Layout: q (B,S,H,hd), k/v (B,Skv,K,hd) and o (B,S,H,hd), read and written
// in model layout through (batch, seq, head) element strides; the last
// dimension must be contiguous.  Nothing is transposed or padded in device
// memory: the ragged sequence edge and head dims beyond hd are masked here.
// fp32 and bf16 inputs; o has q's dtype.
//
// What bounds it on an H100: at the serving shapes (yi-9b, B=8, S=256,
// H=32, K=4, hd=128, bf16, causal) the call reads q+k+v and writes o, about
// 38 MB, against about 4.3 GFLOP of causal work: some 110 FLOP per byte,
// below the ~295 FLOP per byte at which the card's bf16 tensor cores rather
// than its memory become the limit, so the ideal kernel is bound by device
// memory (chip_smoke.py prints the bound it computes for each run beside
// the measured time).  The ideal is some 11 us; at these small shapes
// (2-16 key tiles per 128 query rows) what keeps a kernel from it is
// latency, and at S = 1024 the rate at which the tensor cores are fed.
// What the design does about it:
//  * tensor cores through wgmma (the only way to their full rate on this
//    card) for both products, fp32 accumulators in registers; P enters
//    P V as two bf16 operands, bf16(p) and its remainder (a second wgmma
//    on the same V tile), so P V keeps the TPU kernel's fp32 precision (a
//    single bf16 P would round each p to 8 bits and move many outputs by
//    an ulp); the online softmax keeps m on the raw scores and folds
//    log2(e)/sqrt(hd) into the FFMA before each ex2;
//  * TMA loads into a 4-stage K/V ring on mbarriers, issued by a producer
//    warp that runs ahead of the two consumer warpgroups;
//  * persistent blocks, one per SM, each walking a static list of work
//    items (128 query rows of one head; the rows nearest the end of a
//    causal sequence, which see the most keys, first): the K/V ring runs
//    on from one item into the next and Q is double-buffered, so an item's
//    Q and first tiles load while the previous item finishes;
//  * inside a warpgroup, Q K^T of tile j is issued ahead of P V of tile
//    j-1 and the softmax of tile j runs while P V does;
//  * the producer loads only tiles some row of the item can see under
//    causality, the window and lengths[b], a warpgroup skips the ones none
//    of its rows sees, and masks are applied only on tiles that straddle
//    the diagonal, the window edge or the length;
//  * the tensor maps describe the model layout through its strides, so
//    nothing is transposed, padded or copied in device memory.
// Rows are 128 positions of one query head (two warpgroups of 64), not
// (position, head-in-group) pairs: 128 is not a multiple of G = 12
// (command-r-plus, mistral-large), and the G heads that share a K/V tile
// run as neighbouring items that find it in L2.
// Head dims 80 and 96: their rows do not fit one 128-byte swizzle row, so
// a row is two boxes of 64 dims and TMA zero-fills the dims past hd (the
// map's inner extent is hd); they run the hd-128 instantiation, whose
// products then include zero columns (the hd-80 instantiation of its own
// had its wgmma serialized by ptxas for want of registers).
// What it does not reach: on this card SDPA's library kernel is about 1.2x
// faster at the main shapes (PERF.md).  A variant without the softmax ran
// little faster, so the products' pipeline, not the exponentials, bounds
// it; not yet done (later work): Q K^T with Q in registers and 128-key
// tiles (fewer shared-memory reads per product), 256-row items for G = 1
// (fewer K/V re-reads), and a TMA store of O.
//
// Three routes, chosen per call by the caller (ops.tensor_core_path, passed
// as the entry's tc argument) from what the inputs are:
//  * bf16 on tensor cores (flash_attention_wgmma_kernel): head_dim 64, 80,
//    96 or 128, every row start 16-byte aligned (the model's q/k/v always
//    are).  One persistent block per SM of 2 consumer warpgroups and a
//    producer warp; see its section below.
//  * fp32 on tensor cores (flash_attention_tf32_kernel): the same head dims
//    and alignment.  It serves whisper's encoder, whose float32 frames keep
//    the residual stream in float32 (6 launches a forward or prefill, and
//    their backward in training), and float32 calls elsewhere.  Both
//    products run as TF32 x 3 on mma.sync (each operand split into hi + lo
//    TF32 parts, three products, fp32 sums: kernels/csrc/tf32x3.cuh), the
//    precision of the TPU kernel's float32 dot_generals; one TF32 product
//    (11 bits) misses the float32 tolerance 31-fold at whisper's shape
//    (tests/test_torch_flash_attention_fp32.py).  What bounds it on an H100:
//    at whisper's encoder (B=8, S = Skv = 1500, 8/8 heads of 64) 36.9 GFLOP
//    of products against 98 MB, so the tensor cores: three TF32 products
//    each, 0.223 ms at a third of the TF32 peak (0.550 ms at the CUDA
//    cores' fp32 peak).  The design: four warps per 64 query rows, 32-key
//    K/V tiles through a two-stage cp.async ring, the split by two integer
//    operations on the bit pattern (cvt.rna.tf32 cost 15-21% more), the
//    fragment layouts chosen so that P goes from the softmax into P V and a
//    row's operands load as float2 with no shuffle and no bank conflict,
//    and each tile's P V summed from zero before it is added into O (see
//    its section below).  What it does not reach: about 3x its bound.  Each
//    warp splits every K and V value it reads (four warps a tile), and the
//    split's instructions weigh (the cheaper rounding alone gained 15-21%);
//    a 64-key tile ran no faster and 4 blocks an SM slower
//    (scripts/k1_fp32_variants.py).  Not yet tried: 32 rows a warp, so
//    that each split B fragment feeds two products.
//  * CUDA cores (flash_attention_kernel): what the others do not take: other
//    head dims (up to 256), rows off a 16-byte boundary, in fp32 or bf16.
//    One block of 128 threads per (query tile, query head, batch row); each
//    query row is owned by HD_PAD/32 consecutive lanes holding 32 of its
//    head dims of q and of the accumulator in registers, a q.k dot product
//    is reduced across those lanes with warp shuffles, and 32-key K/V tiles
//    are converted to fp32 in shared memory, read as float4 in an order
//    that keeps the lanes of a warp on distinct banks.
// All three run the key loop inside the block and keep m, l and the output
// accumulator in registers for the whole loop.  Where the caller passes an
// `lse` buffer (B, H, S) fp32 (training: the backward kernel in
// flash_attention_bwd.cu recomputes P from it), both write each row's
// log-sum-exp m + log(l) in natural-log units of the scaled scores, and
// -inf for a row that sees no key; with lse null nothing else changes.
//
// The tensor maps are encoded per call on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links no -lcuda.  The Hopper helpers (mbarriers, TMA, wgmma and
// the tensor maps) and the float32 route's row copies are in sm90.cuh,
// shared with flash_attention_bwd.cu.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockKV = 32;          // keys per shared-memory tile
constexpr int kDimsPerThread = 32;    // head dims each lane owns
constexpr float kNegInf = -1e30f;     // NEG_INF of the TPU kernel

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

template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse,
                       const int* __restrict__ lengths, int S, int Skv,
                       int G, int hd, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale) {
  constexpr int TPR = HD_PAD / kDimsPerThread;  // lanes per query row
  constexpr int BQ = kThreads / TPR;            // query rows per block
  constexpr int VEC = kDimsPerThread / 4;       // float4 chunks per lane
  static_assert(kThreads % TPR == 0 && 32 % TPR == 0, "row lanes in a warp");

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBlockKV][HD_PAD]
  float* v_s = k_s + kBlockKV * HD_PAD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qpos = q0 + row;

  int L = lengths != nullptr ? lengths[b] : Skv;
  L = min(max(L, 0), Skv);
  // keys that at least one row of this tile can see: [lo, hi)
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(L, q0 + BQ) : L;

  // lane `sub` owns dims 4*(c*TPR + sub) + e, c < VEC, e < 4
  float qv[kDimsPerThread];
  float acc[kDimsPerThread];
  const T* qrow = q + b * qs.b + (long long)min(qpos, S - 1) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * TPR + sub) + e;
      qv[4 * c + e] = d < hd ? to_float(qrow[d]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kBlockKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockKV * HD_PAD; idx += kThreads) {
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

    float s[kBlockKV];
    unsigned visible = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * HD_PAD);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float4 kk = kr[c * TPR + sub];
        dot += qv[4 * c] * kk.x + qv[4 * c + 1] * kk.y +
               qv[4 * c + 2] * kk.z + qv[4 * c + 3] * kk.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = t0 + j;
      const bool ok = kp < hi && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      s[j] = ok ? dot * scale : kNegInf;
      visible |= (ok ? 1u : 0u) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      s[j] = ((visible >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * HD_PAD);
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float4 vv = vr[c * TPR + sub];
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qpos < S && lse != nullptr && sub == 0)
    lse[((long long)b * gridDim.y + h) * S + qpos] =
        l > 0.f ? m + logf(l) : -INFINITY;
  if (qpos < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + (long long)qpos * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (c * TPR + sub) + e;
        if (d < hd) orow[d] = from_float<T>(acc[4 * c + e] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core float32 path (flash_attention_tf32_kernel): fp32, head_dim
// HD in {64, 80, 96, 128}, every row start 16-byte aligned.  A block is
// four warps over 64 query rows of one head (a warp owns 16: a lane holds
// rows g and g + 8 of them), streaming 32-key tiles of K and V through a
// two-stage cp.async ring.  Both products run on mma.sync m16n8k8 in TF32
// with every operand split into hi + lo parts (tf32x3.cuh), so each keeps
// fp32 precision as the TPU kernel's float32 dot_generals do:
//  * S = Q K^T: Q's fragments are read from shared memory and split per
//    k-step, K's per n-tile;
//  * O += P V: P leaves the online softmax in the accumulator layout,
//    which is the A layout once the keys of a k-step are ordered 2 t4,
//    2 t4 + 1 (a thread's columns t4 and t4 + 4), so P is split in
//    registers with no shuffle; V's fragments are read in the same key
//    order.  Each tile's P V is summed from zero in registers (64 head
//    dims at a time) and then added into O with the rescale, so no
//    tensor-core sum runs longer than one tile.
// The k index of a k-step is permuted the same way in both operands of
// Q K^T (dims 2 t4, 2 t4 + 1 at columns t4, t4 + 4), so a thread reads its
// two values of a row as one float2.  Row strides keep a warp's reads on
// distinct banks (TfTiles).  Tiles no row of a warp sees are skipped by
// that warp, masks apply only on tiles that straddle an edge, and the
// online softmax is the tensor-core bf16 path's (m on the raw scores, the
// scale folded into each exponent's FFMA).
// ---------------------------------------------------------------------------

constexpr int kTfWarps = 4;
constexpr int kTfRows = 16 * kTfWarps;       // query rows of a block
constexpr int kTfKV = 32;                    // keys of a streamed tile
constexpr int kTfThreads = 32 * kTfWarps;
// blocks an SM should hold at head dim hd, as many as shared memory
// allows: caps ptxas at 168 registers a thread (hd <= 80) or 255, which
// these kernels fit without a spill (left to its own choice it took 128
// for some and spilled; at hd 128, 168 spilled too)
constexpr int tf_min_blocks(int hd) { return hd <= 80 ? 3 : 2; }
constexpr int kTfChunk = 8;                  // n-tiles (64 dims) a P V pass

// Shared-memory plan (floats): Q, then two stages of K and V.  Q and K are
// read as float2 at (row g, dims 2 t4 and 2 t4 + 1): a row stride of 8 mod
// 32 (24 for hd 80) puts the 16 lanes of a half-warp on distinct banks.  V
// is read as floats at (rows 2 t4 and 2 t4 + 1, dim g): a stride of 4 mod
// 16 does the same for all 32 lanes.
template <int HD>
struct TfTiles {
  static constexpr int QS = HD + 8;          // Q and K row stride
  static constexpr int VS = HD + 4;          // V row stride
  static constexpr int Q = kTfRows * QS;
  static constexpr int K = kTfKV * QS;
  static constexpr int STAGE = K + kTfKV * VS;
  static constexpr int SMEM = 4 * (Q + 2 * STAGE);
};

template <int HD>
__global__ void __launch_bounds__(kTfThreads, tf_min_blocks(HD))
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            const int* __restrict__ lengths, int S, int Skv,
                            int G, Strides qs, Strides ks, Strides vs,
                            Strides os, int causal, int window,
                            float scale_log2) {
  using T = TfTiles<HD>;
  using namespace tf32x3;
  constexpr int NT = HD / 8;                 // k-steps of Q K^T, n-tiles of O
  constexpr int NJ = kTfKV / 8;              // n-tiles of S, k-steps of P V
  extern __shared__ float4 tf_smem4[];
  float* q_s = reinterpret_cast<float*>(tf_smem4);
  float* kv_s = q_s + T::Q;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  // causal: the row blocks that see the most keys start first
  const int mb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = mb * kTfRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int r0 = q0 + 16 * warp;             // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};

  int L = lengths != nullptr ? lengths[b] : Skv;
  L = min(max(L, 0), Skv);
  // keys some row of the block sees: [lo, hi); of the warp: [wlo, whi)
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(L, q0 + kTfRows) : L;
  const int wlo = window > 0 ? max(0, r0 - window + 1) : 0;
  const int whi = causal ? min(L, r0 + 16) : L;
  const int ntiles = hi > lo ? (hi - lo + kTfKV - 1) / kTfKV : 0;

  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  auto load_kv = [&](int i) {
    float* st = kv_s + (i & 1) * T::STAGE;
    const int t0 = lo + i * kTfKV;
    cp_rows<HD, kTfKV, kTfThreads>(st, T::QS, kb, ks.s, t0, hi, tid);
    cp_rows<HD, kTfKV, kTfThreads>(st + T::K, T::VS, vb, vs.s, t0, hi, tid);
  };
  if (ntiles > 0) {
    cp_rows<HD, kTfRows, kTfThreads>(q_s, T::QS, q + b * qs.b + h * qs.h,
                                     qs.s, q0, S, tid);
    load_kv(0);
  }
  cp_async_commit();

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // row maxima of the raw scores
  float l[2] = {0.f, 0.f};               // this lane's partial row sums

  const float* qr = q_s + (16 * warp + g) * T::QS + 2 * t4;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_kv(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = lo + i * kTfKV;
    if (t0 < whi && t0 + kTfKV > wlo) {
      const float* k_t = kv_s + (i & 1) * T::STAGE;
      const float* v_t = k_t + T::K;
      // S = Q K^T; a lane's n-tile j holds keys 8 j + 2 t4 (+1) of rows
      // g (s[j][0..1]) and g + 8 (s[j][2..3])
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float2 x0 = ld2(qr + 8 * kk);
        const float2 x1 = ld2(qr + 8 * T::QS + 8 * kk);
        uint32_t ah[4], al[4];
        split_a_bits(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 y = ld2(k_t + (8 * j + g) * T::QS + 8 * kk + 2 * t4);
          uint32_t bh[2], bl[2];
          split_bits(y.x, bh[0], bl[0]);
          split_bits(y.y, bh[1], bl[1]);
          mma3_acc(s[j], ah, al, bh, bl);
        }
      }
      // masks only on a tile that straddles the length, the diagonal or
      // the window edge of some row of the warp
      if (t0 + kTfKV > L || (causal && t0 + kTfKV - 1 > r0) ||
          (window > 0 && t0 <= r0 + 15 - window)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = t0 + 8 * j + 2 * t4 + (e & 1);
            const int r = rows[e >> 1];
            const bool seen = kp < L && (!causal || kp <= r) &&
                              (window <= 0 || kp > r - window);
            if (!seen) s[j][e] = -INFINITY;
          }
      }
      float alpha[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {          // row g (x = 0) and g + 8
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          tmax = fmaxf(tmax, fmaxf(s[j][2 * x], s[j][2 * x + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[x], tmax);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[x] = ex2((m[x] - m_use) * scale_log2);
        const float ms = m_use * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 2 * x; e < 2 * x + 2; ++e) {
            s[j][e] = ex2(fmaf(s[j][e], scale_log2, -ms));
            sum += s[j][e];
          }
        l[x] = l[x] * alpha[x] + sum;
        m[x] = m_new;
      }
      // O = alpha O + P V, 64 head dims a pass
      uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        split_a_bits(s[j][0], s[j][2], s[j][1], s[j][3], ph[j], pl[j]);
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
              const float* vr = v_t + (8 * j + 2 * t4) * T::VS +
                                8 * (c + n) + g;
              uint32_t bh[2], bl[2];
              split_bits(vr[0], bh[0], bl[0]);
              split_bits(vr[T::VS], bh[1], bl[1]);
              mma3_acc(t[n], ph[j], pl[j], bh, bl);
            }
          }
#pragma unroll
        for (int n = 0; n < kTfChunk; ++n)
          if (c + n < NT)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              oacc[c + n][e] = fmaf(oacc[c + n][e], alpha[e >> 1], t[n][e]);
      }
    }
    __syncthreads();                         // stage i & 1 is free again
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = rows[x];
    if (r >= S) continue;
    // m is on the raw scores and l sums powers of 2: back to natural log
    // units of the scaled scores
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * gridDim.y + h) * S + r] =
          l[x] > 0.f ? (m[x] * scale_log2 + log2f(l[x])) * kLn2 : -INFINITY;
    const float inv = 1.f / fmaxf(l[x], 1e-30f);
    float* orow = o + b * os.b + (long long)r * os.s + h * os.h;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(oacc[n][2 * x] * inv, oacc[n][2 * x + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, head_dim 64, 80, 96 or 128, 16-byte aligned rows.
// A block is kFaWG consumer warpgroups of 64 query rows each (an item: 128
// positions of one query head) and one producer warp.  For each item the
// producer's elected thread loads Q into one of two buffers (qfull/qempty)
// and then every K/V tile the item can see by TMA into a ring of kFaStages
// stages, completing on mbarriers (full[s]); the consumers release a stage
// by arriving on empty[s].  Tiles are 64 keys by 64 head
// dims of 128 bytes, 128B-swizzled, so a head dim of 80, 96 or 128 is two
// such boxes and TMA zero-fills the columns past hd.  S = Q K^T is
// wgmma.m64n64k16 with both operands K-major in shared memory; O += P V is
// two wgmma.m64nNk16, P split into bf16 hi and lo parts in registers as
// the A operands (pack_bf16_split), and
// V read MN-major (transposed) from the same swizzled tile, N = 64 for
// hd 64 and 128 otherwise (the columns past hd are zeros and are dropped).
// ---------------------------------------------------------------------------

constexpr int kFaWG = 2;                     // consumer warpgroups per block
constexpr int kFaM = 64 * kFaWG;             // query rows per block
constexpr int kFaBKV = 64;                   // keys per tile
constexpr int kFaStages = 4;                 // K/V ring depth
constexpr int kFaThreads = 128 * kFaWG + 32; // + the producer warp
constexpr int kBoxBytes = 128;  // 64 bf16 head dims: one swizzle row

// Shared-memory plan of the tensor-core kernel for NC 64-dim boxes per row.
template <int NC>
struct FaTiles {
  static constexpr int NPV = 64 * NC;         // N of O += P V
  static constexpr int QBYTES = NC * kFaM * kBoxBytes;    // one Q buffer
  static constexpr int TBYTES = NC * kFaBKV * kBoxBytes;  // a K or V tile
  static constexpr int STAGE = 2 * TBYTES;
  static constexpr int RING = 2 * QBYTES;     // two Q buffers, then the ring
  static constexpr int BARS = RING + kFaStages * STAGE;
  // + the barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = BARS + 8 * (4 + 2 * kFaStages) + 1024;
};

// One work item: 128 query rows (block mb) of query head h of batch row b,
// and the key tiles [tfirst, tfirst + ntiles * kFaBKV) some row can see:
// L = min(lengths[b], Skv) keys at most, fewer under causality or a window.
struct FaItem {
  int b, h, q0, L, tfirst, ntiles;
};

__device__ __forceinline__ FaItem fa_item(int t, int nmb, int B, int H,
                                          int Skv, const int* lengths,
                                          int causal, int window) {
  FaItem it;
  const int per_mb = H * B;
  // causal: the row blocks with the most key tiles come first; heads run
  // fastest, so the G heads of a KV head are in flight together
  const int mb = causal ? nmb - 1 - t / per_mb : t / per_mb;
  const int rest = t % per_mb;
  it.h = rest % H;
  it.b = rest / H;
  it.q0 = mb * kFaM;
  int L = lengths != nullptr ? lengths[it.b] : Skv;
  it.L = min(max(L, 0), Skv);
  const int lo = window > 0 ? max(0, it.q0 - window + 1) : 0;
  const int hi = causal ? min(it.L, it.q0 + kFaM) : it.L;
  it.tfirst = (lo / kFaBKV) * kFaBKV;
  it.ntiles = hi > it.tfirst ? (hi - it.tfirst + kFaBKV - 1) / kFaBKV : 0;
  return it;
}

// Persistent: one block per SM walks the work items t = blockIdx.x,
// blockIdx.x + gridDim.x, ...  The producer runs ahead across items: the
// K/V ring continues from one item into the next, and Q is double-buffered,
// so an item's Q and first tiles load while the previous item finishes.
template <int NC>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse,
                             const int* __restrict__ lengths, int B, int S,
                             int Skv, int H, int G, int hd, Strides os,
                             int causal, int window, float scale_log2) {
  using T = FaTiles<NC>;
  constexpr int KSTEPS = 4 * NC;             // 16 head dims a step
  extern __shared__ unsigned char fa_smem_raw[];
  unsigned char* smem =
      fa_smem_raw + ((1024u - (smem_u32(fa_smem_raw) & 1023u)) & 1023u);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + T::BARS);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + kFaStages;
  const int nmb = (S + kFaM - 1) / kFaM;
  const int items = nmb * H * B;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mbar_init(&qfull[x], 1);
      mbar_init(&qempty[x], 4 * kFaWG);      // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kFaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kFaWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kFaWG) {                   // the producer warp
    if (lane == 0) {
      int seq = 0;                           // ring tiles issued so far
      int n = 0;                             // items of this block so far
      for (int t = blockIdx.x; t < items; t += gridDim.x, ++n) {
        const FaItem it = fa_item(t, nmb, B, H, Skv, lengths, causal, window);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&qempty[qb], ((n >> 1) - 1) & 1);
        mbar_expect_tx(&qfull[qb], T::QBYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(smem + qb * T::QBYTES + c * kFaM * kBoxBytes, &tm_q,
                   &qfull[qb], c * 64, it.h, it.q0, it.b);
        const int kh = it.h / G;
        for (int i = 0; i < it.ntiles; ++i, ++seq) {
          const int s = seq % kFaStages;
          if (seq >= kFaStages)
            mbar_wait(&empty[s], (seq / kFaStages - 1) & 1);
          unsigned char* st = smem + T::RING + s * T::STAGE;
          const int t0 = it.tfirst + i * kFaBKV;
          mbar_expect_tx(&full[s], T::STAGE);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load(st + c * kFaBKV * kBoxBytes, &tm_k, &full[s], c * 64,
                     kh, t0, it.b);
            tma_load(st + T::TBYTES + c * kFaBKV * kBoxBytes, &tm_v,
                     &full[s], c * 64, kh, t0, it.b);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows r0 .. r0+63 of an item; a lane holds
  // rows g, g+8 of its warp's 16
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t4 = lane % 4;
  float oacc[T::NPV / 2];
  float m[2], l[2];      // row maxima of the raw scores, partial row sums
  float sacc[32];
  uint32_t pf[2][8][4];  // P of two tiles as A fragments: hi [0,4), lo [4,8)
  float alpha[2];
  int seq = 0;                               // ring tiles consumed so far
  int n = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x, ++n) {
    const FaItem it = fa_item(t, nmb, B, H, Skv, lengths, causal, window);
    const int L = it.L;
    const int r0 = it.q0 + wg * 64;
    const int rows[2] = {r0 + (warp % 4) * 16 + g,
                         r0 + (warp % 4) * 16 + g + 8};
    const int wlo = window > 0 ? max(0, r0 - window + 1) : 0;
    const int whi = causal ? min(L, r0 + 64) : L;
    const unsigned char* qs = smem + (n & 1) * T::QBYTES;
#pragma unroll
    for (int j = 0; j < T::NPV / 2; ++j) oacc[j] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    auto stage_of = [&](int i) {
      return smem + T::RING + ((seq + i) % kFaStages) * T::STAGE;
    };
    auto full_wait = [&](int i) {
      mbar_wait(&full[(seq + i) % kFaStages], ((seq + i) / kFaStages) & 1);
    };
    auto release = [&](int i) {              // this warp is done with tile i
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(seq + i) % kFaStages]);
    };
    // the tiles some row of this warpgroup sees are one run of the item's
    // tiles; the others are only released
    auto active = [&](int i) {
      const int t0 = it.tfirst + i * kFaBKV;
      return t0 < whi && t0 + kFaBKV > wlo;
    };
    // S = Q K^T of tile i, issued (not waited for)
    auto issue_qk = [&](int i) {
      const unsigned char* kt = stage_of(i);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int c = kk / 4;
        const int off = (kk % 4) * 32;
        const uint64_t da = gmma_desc(
            qs + (c * kFaM + wg * 64) * kBoxBytes + off, 16, 1024);
        const uint64_t db = gmma_desc(kt + c * kFaBKV * kBoxBytes + off, 16,
                                      1024);
        wgmma_ss_n64(sacc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile i with P fragments p, issued
    auto issue_pv = [&](int i, const uint32_t (&p)[8][4]) {
      const unsigned char* vt = stage_of(i) + T::TBYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // V rows 16kk.. as B, MN-major: the 64-dim boxes are kFaBKV rows
        // apart (LBO), 8-row groups 1024 bytes apart (SBO)
        const uint64_t dv = gmma_desc(vt + kk * 16 * kBoxBytes,
                                      kFaBKV * kBoxBytes, 1024);
        if constexpr (NC == 1) {
          wgmma_rs_n64(oacc, p[kk], dv);
          wgmma_rs_n64(oacc, p[4 + kk], dv);
        } else {
          wgmma_rs_n128(oacc, p[kk], dv);
          wgmma_rs_n128(oacc, p[4 + kk], dv);
        }
      }
      wgmma_commit();
    };
    // The online softmax of tile i's scores: updates m and l, writes P into
    // p and the factor the output accumulator must be scaled by into alpha.
    // m is kept on the raw scores; the scale goes into the exponent's FFMA.
    auto softmax = [&](int i, uint32_t (&p)[8][4]) {
      const int t0 = it.tfirst + i * kFaBKV;
      // masks only on tiles that straddle the length, the diagonal or the
      // window edge of some row of the warpgroup
      if (t0 + kFaBKV > L || (causal && t0 + kFaBKV - 1 > r0) ||
          (window > 0 && t0 <= r0 + 63 - window)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kp = t0 + 8 * (j / 4) + 2 * t4 + (j & 1);
          const int r = rows[(j >> 1) & 1];
          if (!(kp < L && (!causal || kp <= r) &&
                (window <= 0 || kp > r - window)))
            sacc[j] = -INFINITY;
        }
      }
      float ms[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {          // row g (x = 0) and g + 8
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          a[j] = fmaxf(sacc[4 * j + 2 * x], sacc[4 * j + 2 * x + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
        float tmax = fmaxf(a[0], __shfl_xor_sync(0xffffffffu, a[0], 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[x], tmax);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[x] = ex2((m[x] - m_use) * scale_log2);
        ms[x] = m_use * scale_log2;
        m[x] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        sacc[j] = ex2(fmaf(sacc[j], scale_log2, -ms[(j >> 1) & 1]));
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          a[j] = sacc[4 * j + 2 * x] + sacc[4 * j + 2 * x + 1];
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) a[j] += a[j + w];
        l[x] = l[x] * alpha[x] + a[0];
      }
      // the S accumulators of n-tiles 2kk and 2kk+1 are the A layout of
      // rows g, g+8 for keys 16kk..16kk+15
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pack_bf16_split(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1],
                          p[kk][x], p[4 + kk][x]);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < T::NPV / 8; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
    };
    // one step of the software pipeline: Q K^T of tile i is issued, then
    // P V of tile prev (P in pin) behind it on the tensor cores; the
    // softmax of tile i (into pout) runs while P V does, and O is rescaled
    // once P V is done.  pin/pout alternate between pf[0] and pf[1] at
    // fixed indices.
    auto step = [&](int i, int prev, const uint32_t (&pin)[8][4],
                    uint32_t (&pout)[8][4]) {
      full_wait(i);
      fence_regs(oacc);
      wgmma_fence();
      issue_qk(i);
      issue_pv(prev, pin);
      wgmma_wait<1>();                       // Q K^T of tile i is done
      fence_regs(sacc);
      softmax(i, pout);
      wgmma_wait<0>();                       // P V of tile prev is done
      fence_regs(oacc);
      release(prev);
      rescale();
    };
    auto finish = [&](int prev, const uint32_t (&pin)[8][4]) {
      fence_regs(oacc);
      wgmma_fence();
      issue_pv(prev, pin);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(prev);
    };

    mbar_wait(&qfull[n & 1], (n >> 1) & 1);
    int i = 0;
    for (; i < it.ntiles && !active(i); ++i) {
      full_wait(i);
      release(i);
    }
    if (i < it.ntiles) {
      full_wait(i);
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
      fence_regs(sacc);
      wgmma_fence();
      issue_qk(i);
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(i, pf[0]);
      int prev = i++;
      for (;;) {
        if (i == it.ntiles || !active(i)) {
          finish(prev, pf[0]);
          break;
        }
        step(i, prev, pf[0], pf[1]);
        prev = i++;
        if (i == it.ntiles || !active(i)) {
          finish(prev, pf[1]);
          break;
        }
        step(i, prev, pf[1], pf[0]);
        prev = i++;
      }
    }
    for (; i < it.ntiles; ++i) {
      full_wait(i);
      release(i);
    }
    __syncwarp();                            // Q of this item is done with
    if (lane == 0) mbar_arrive(&qempty[n & 1]);
    seq += it.ntiles;

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = rows[x];
      if (r >= S) continue;
      // m is on the raw scores and l sums powers of 2: back to natural
      // log units of the scaled scores
      if (lse != nullptr && t4 == 0)
        lse[((long long)it.b * H + it.h) * S + r] =
            l[x] > 0.f ? (m[x] * scale_log2 + log2f(l[x])) * kLn2 : -INFINITY;
      const float inv = 1.f / fmaxf(l[x], 1e-30f);
      __nv_bfloat16* orow =
          o + it.b * os.b + (long long)r * os.s + it.h * os.h;
#pragma unroll
      for (int j = 0; j < T::NPV / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
              oacc[4 * j + 2 * x] * inv, oacc[4 * j + 2 * x + 1] * inv);
      }
    }
  }
}

template <int NC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* lengths, int B, int S,
                         int Skv, int H, int K, int hd, Strides qs,
                         Strides ks, Strides vs,
                         Strides os, int causal, int window, float scale,
                         cudaStream_t stream) {
  // Q over S query positions, K and V over Skv keys: TMA zero-fills a box
  // past either edge, and the kernel masks keys at or past min(len, Skv)
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, hd, qs, kFaM) ||
      !make_map(&tk, k, B, Skv, K, hd, ks, kFaBKV) ||
      !make_map(&tv, v, B, Skv, K, hd, vs, kFaBKV))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_wgmma_kernel<NC>;
  constexpr int smem = FaTiles<NC>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long items = (long long)((S + kFaM - 1) / kFaM) * H * B;
  const int sms = sm_count();
  if (sms < 1 || items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kern<<<grid, kFaThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, lengths, B, S, Skv, H,
      H / K, hd, os, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* lengths, int B, int S, int Skv,
                        int H, int G, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, int window, float scale,
                        cudaStream_t stream) {
  auto kern = flash_attention_tf32_kernel<HD>;
  constexpr int smem = TfTiles<HD>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTfRows - 1) / kTfRows, H, B);
  kern<<<grid, kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, lengths, S,
      Skv, G, qs, ks, vs, os, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* lengths, int B, int S, int Skv,
                   int H, int G, int hd, Strides qs, Strides ks,
                   Strides vs, Strides os,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = kThreads / (HD_PAD / kDimsPerThread);
  const size_t smem = 2 * kBlockKV * HD_PAD * sizeof(float);
  auto kern = flash_attention_kernel<T, HD_PAD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lengths, S, Skv, G,
      hd, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* lengths, int B, int S,
                        int Skv, int H, int G, int hd, Strides qs,
                        Strides ks, Strides vs,
                        Strides os,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lse, lengths, B, S, Skv, H, G, hd, qs, ks,
                         vs, os, causal, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, lengths, B, S, Skv, H, G, hd, qs, ks,
                         vs, os, causal, window, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, lengths, B, S, Skv, H, G, hd, qs, ks,
                          vs, os, causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, lengths, B, S, Skv, H, G, hd, qs, ks,
                        vs, os, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  S queries, Skv keys.  Strides are in
// elements.  lse may be null; else (B, H, S) contiguous fp32, written with
// each row's log-sum-exp.  lengths may be null (every row has Skv valid
// keys); a length is read as min(lengths[b], Skv).  window <= 0 means no
// window.  tc (the caller's ops.tensor_core_path) picks the tensor-core
// kernel of the dtype (TF32 x 3 for fp32, wgmma for bf16), which takes
// head_dim 64, 80, 96 or 128 and 16-byte aligned rows and refuses other
// inputs; tc = 0 the CUDA-core kernel.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* lengths, int dtype, int B, int S, int Skv, int H, int K,
    int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float scale, void* stream, int tc) {
  if (B < 1 || S < 1 || Skv < 1 || K < 1 || H % K != 0 || hd < 1 ||
      hd > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tc)
    return (int)(dtype == 0
                     ? dispatch_hd<float>(q, k, v, o, lse, lengths, B, S, Skv,
                                          H, G, hd, qs, ks, vs, os, causal,
                                          window, scale, st)
                     : dispatch_hd<__nv_bfloat16>(
                           q, k, v, o, lse, lengths, B, S, Skv, H, G, hd, qs,
                           ks, vs, os, causal, window, scale, st));
  if (hd != 64 && hd != 80 && hd != 96 && hd != 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (!(f32_aligned(q, qs) && f32_aligned(k, ks) && f32_aligned(v, vs) &&
          f32_aligned(o, os)))
      return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (hd == 64)
      e = launch_tf32<64>(q, k, v, o, lse, lengths, B, S, Skv, H, G, qs, ks,
                          vs, os, causal, window, scale, st);
    else if (hd == 80)
      e = launch_tf32<80>(q, k, v, o, lse, lengths, B, S, Skv, H, G, qs, ks,
                          vs, os, causal, window, scale, st);
    else if (hd == 96)
      e = launch_tf32<96>(q, k, v, o, lse, lengths, B, S, Skv, H, G, qs, ks,
                          vs, os, causal, window, scale, st);
    else
      e = launch_tf32<128>(q, k, v, o, lse, lengths, B, S, Skv, H, G, qs, ks,
                           vs, os, causal, window, scale, st);
    return (int)e;
  }
  if (!(mma_aligned(q, qs) && mma_aligned(k, ks) && mma_aligned(v, vs) &&
        mma_aligned(o, os)))
    return (int)cudaErrorInvalidValue;
  // one 64-dim box (hd 64) or two, TMA zero-filling the dims past hd
  return (int)(hd == 64 ? launch_wgmma<1>(q, k, v, o, lse, lengths, B, S,
                                          Skv, H, K, hd, qs, ks, vs, os,
                                          causal, window, scale, st)
                        : launch_wgmma<2>(q, k, v, o, lse, lengths, B, S,
                                          Skv, H, K, hd, qs, ks, vs, os,
                                          causal, window, scale, st));
}
