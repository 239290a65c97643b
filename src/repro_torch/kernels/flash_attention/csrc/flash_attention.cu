// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (the Pallas TPU kernel; pl.pallas_call at kernel.py:97).
//
// What it computes (the same function as the TPU kernel): softmax attention
// over a full sequence with causal masking, an optional sliding window
// (key kp is visible to query qp iff qp - window < kp), per-row ragged
// valid lengths, and GQA (query head h reads KV head h / G).  Scores are
// scaled by 1/sqrt(head_dim); the softmax is the fp32 online softmax
// (running max m, running sum l, fp32 accumulator).  A row with no visible
// key produces zeros.
//
// Layout: q (B,S,H,hd), k/v (B,S,K,hd) and o (B,S,H,hd), read and written
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
// the measured time).  What the design does about it: every q/o byte is
// touched once, K/V tiles are staged once per block in shared memory and
// reused by all of the block's query rows, scores and probabilities never
// reach device memory, and key tiles that no row of a block (or warp) can
// see under the causal mask or the window are skipped.  It does not reach
// the bound yet: the loads are synchronous (no cp.async/TMA pipeline), GQA
// groups re-read their shared K/V tile per query head, and at 220
// registers only two blocks fit an SM.  wgmma and TMA come later.
//
// Two paths, chosen per call from what the inputs are:
//  * tensor cores (flash_attention_mma_kernel): bf16, head_dim 64, 80, 96
//    or 128, every row start 16-byte aligned (the model's q/k/v always
//    are).  One block of 4 warps per (64 query rows, query head, batch
//    row); mma.sync m16n8k16 with fp32 accumulators; 64-key K/V tiles.
//  * CUDA cores (flash_attention_kernel): fp32, other head dims (up to
//    256), unaligned bf16.  One block of 128 threads per (query tile,
//    query head, batch row); each query row is owned by HD_PAD/32
//    consecutive lanes holding 32 of its head dims of q and of the
//    accumulator in registers, a q.k dot product is reduced across those
//    lanes with warp shuffles, and 32-key K/V tiles are converted to fp32
//    in shared memory, read as float4 in an order that keeps the lanes of
//    a warp on distinct banks.
// Both run the key loop inside the block and keep m, l and the output
// accumulator in registers for the whole loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockKV = 32;          // keys per shared-memory tile
constexpr int kDimsPerThread = 32;    // head dims each lane owns
constexpr float kNegInf = -1e30f;     // NEG_INF of the TPU kernel

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

template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ lengths, int S, int G, int hd,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale) {
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

  int L = lengths != nullptr ? lengths[b] : S;
  L = min(max(L, 0), S);
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
// Tensor-core path: bf16 inputs, head_dim a multiple of 16 up to 128, 16-byte
// aligned rows.  FA2 layout: a block of 4 warps owns 64 query rows (16 per
// warp); per 64-key tile, S = Q K^T and O += P V run on mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  Q stays in registers as A fragments, K/V
// tiles sit in shared memory with rows padded by 16 bytes so that ldmatrix
// is free of bank conflicts, and P goes from the S accumulators straight
// into A fragments without touching memory.  Each lane holds two query
// rows (g and g+8 of its warp); row statistics are reduced across the four
// lanes of a quad.
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;
constexpr int kMmaBKV = 64;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           const int* __restrict__ lengths, int S, int G,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int causal, int window, float scale) {
  static_assert(HD % 16 == 0 && HD <= 128, "head_dim");
  constexpr int LDS = HD + 8;          // padded smem row, in elements
  constexpr int KSTEPS = HD / 16;      // k-steps of Q K^T
  constexpr int NT_S = kMmaBKV / 8;    // n-tiles of S (keys)
  constexpr int NT_O = HD / 8;         // n-tiles of O (head dims)
  constexpr int CHUNKS = HD / 8;       // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaBKV * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMmaBKV * LDS];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / G;
  const int q0 = blockIdx.x * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;              // row within the 8-row group
  const int t4 = lane % 4;             // lane within the quad
  const int wq0 = q0 + warp * 16;      // the warp's first query row
  const int rows[2] = {wq0 + g, wq0 + g + 8};

  int L = lengths != nullptr ? lengths[b] : S;
  L = min(max(L, 0), S);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(L, q0 + kMmaBQ) : L;

  // Q as A fragments: reg0 (row g, cols 2*t4..), reg1 (row g+8), reg2/3 the
  // same rows at cols + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[i & 1];
      const int col = kk * 16 + (i >> 1) * 8 + 2 * t4;
      qf[kk][i] = r < S ? *reinterpret_cast<const uint32_t*>(
                              q + b * qs.b + (long long)r * qs.s +
                              h * qs.h + col)
                        : 0u;
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int d = 0; d < NT_O; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};             // this lane's partial row sums

  for (int t0 = lo; t0 < hi; t0 += kMmaBKV) {
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < kMmaBKV * CHUNKS; idx += kThreads) {
      const int j = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 8;
      const int kp = t0 + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kp < hi) {
        kx = *reinterpret_cast<const uint4*>(
            k + b * ks.b + (long long)kp * ks.s + kh * ks.h + c);
        vx = *reinterpret_cast<const uint4*>(
            v + b * vs.b + (long long)kp * vs.s + kh * vs.h + c);
      }
      *reinterpret_cast<uint4*>(k_s + j * LDS + c) = kx;
      *reinterpret_cast<uint4*>(v_s + j * LDS + c) = vx;
    }
    __syncthreads();

    // tiles no row of this warp can see
    if (causal && wq0 + 15 < t0) continue;
    if (window > 0 && t0 + kMmaBKV - 1 <= wq0 - window) continue;

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        // matrices: (keys j, dims kk*16), (keys j, +8), (keys j+1, ...)
        const int mi = lane >> 3;
        uint32_t bf[4];
        ldsm_x4(bf, k_s + ((j + (mi >> 1)) * 8 + (lane & 7)) * LDS +
                        kk * 16 + (mi & 1) * 8);
        mma_bf16(s[j], qf[kk], bf[0], bf[1]);
        mma_bf16(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask, scale, online softmax (rows g and g+8 of the warp)
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i >> 1];
        const int kp = t0 + j * 8 + 2 * t4 + (i & 1);
        const bool ok = kp < hi && (!causal || kp <= r) &&
                        (window <= 0 || kp > r - window);
        s[j][i] = ok ? s[j][i] * scale : kNegInf;
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[j][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tile_max[x] = fmaxf(tile_max[x],
                          __shfl_xor_sync(0xffffffffu, tile_max[x], 1));
      tile_max[x] = fmaxf(tile_max[x],
                          __shfl_xor_sync(0xffffffffu, tile_max[x], 2));
      const float m_new = fmaxf(m[x], tile_max[x]);
      alpha[x] = expf(m[x] - m_new);
      m[x] = m_new;
      l[x] *= alpha[x];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = i >> 1;
        const float p = s[j][i] > 0.5f * kNegInf ? expf(s[j][i] - m[x]) : 0.f;
        s[j][i] = p;
        l[x] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: P from the S accumulators as A fragments, 16 keys a step
#pragma unroll
    for (int t = 0; t < kMmaBKV / 16; ++t) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pf[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pf[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pf[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int d = 0; d < NT_O; d += 2) {
        // matrices: (keys 16t, dims 8d), (keys 16t+8, dims 8d), (.., 8d+8)
        const int mi = lane >> 3;
        uint32_t bf[4];
        ldsm_x4_trans(bf, v_s + (t * 16 + (mi & 1) * 8 + (lane & 7)) * LDS +
                              (d + (mi >> 1)) * 8);
        mma_bf16(acc[d], pf, bf[0], bf[1]);
        mma_bf16(acc[d + 1], pf, bf[2], bf[3]);
      }
    }
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
    const float denom = fmaxf(l[x], 1e-30f);
    __nv_bfloat16* orow = o + b * os.b + (long long)r * os.s + h * os.h;
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * t4) =
          pack_bf16(acc[d][2 * x] / denom, acc[d][2 * x + 1] / denom);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const int* lengths, int B, int S, int H, int G,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, H, B);
  flash_attention_mma_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lengths, S, G, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

// The tensor-core path takes bf16 rows whose every start is 16-byte aligned.
bool mma_aligned(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

template <typename T, int HD_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int S, int H, int G, int hd,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lengths, S, G, hd, qs, ks,
      vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        const int* lengths, int B, int S, int H, int G, int hd,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lengths, B, S, H, G, hd, qs, ks, vs, os,
                         causal, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lengths, B, S, H, G, hd, qs, ks, vs, os,
                         causal, window, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lengths, B, S, H, G, hd, qs, ks, vs, os,
                          causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, lengths, B, S, H, G, hd, qs, ks, vs, os,
                        causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lengths may
// be null (every row has S valid keys).  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    int dtype, int B, int S, int H, int K, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float scale, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || hd < 1 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(q, k, v, o, lengths, B, S, H, G, hd, qs, ks, vs,
                           os, causal, window, scale, st);
  else if (dtype == 1 && mma_aligned(q, qs) && mma_aligned(k, ks) &&
           mma_aligned(v, vs) && mma_aligned(o, os) &&
           (hd == 64 || hd == 80 || hd == 96 || hd == 128)) {
    switch (hd) {
      case 64:
        e = launch_mma<64>(q, k, v, o, lengths, B, S, H, G, qs, ks, vs, os,
                           causal, window, scale, st);
        break;
      case 80:
        e = launch_mma<80>(q, k, v, o, lengths, B, S, H, G, qs, ks, vs, os,
                           causal, window, scale, st);
        break;
      case 96:
        e = launch_mma<96>(q, k, v, o, lengths, B, S, H, G, qs, ks, vs, os,
                           causal, window, scale, st);
        break;
      default:
        e = launch_mma<128>(q, k, v, o, lengths, B, S, H, G, qs, ks, vs, os,
                            causal, window, scale, st);
    }
  } else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(q, k, v, o, lengths, B, S, H, G, hd, qs,
                                   ks, vs, os, causal, window, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
