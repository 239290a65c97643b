// Flash-decode for Hopper (sm_90a), CUDA C++ with a plain C interface
// loaded through ctypes (see repro_torch/kernels/common.py).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_bkgd
// (the Pallas TPU kernel; pl.pallas_call at kernel.py:87).
//
// What it computes (the same function as the TPU kernel): one query token
// per row against that row's KV cache, GQA (query head h reads KV head
// h / G), online softmax over the row's lengths[b] valid keys (clamped to
// Smax), optionally only keys with kpos > lengths[b] - 1 - window.  Scores
// are scaled by 1/sqrt(head_dim); m, l and the accumulator are fp32, and P
// stays fp32 for P.V (as in the TPU kernel; the plain version rounds P to
// the cache dtype first).  A row with no valid key produces zeros.
//
// Layout: q (B,H,hd) and o (B,H,hd) through (batch, head) element strides;
// the cache layer k/v (B,Smax,K,hd) through (batch, position, head)
// strides, so a layer view of the stacked (L,B,Smax,K,hd) cache is read
// where it lies, with no transpose and no padding copy (the TPU wrapper
// moved the head axis and padded Smax on every call).  The last dimension
// must be contiguous.  fp32 and bf16; q, k and v share one dtype and o has
// q's dtype.
//
// What bounds it on an H100: one decode tick reads every valid K/V byte of
// the layer once and does 4*hd FLOP per (query head, key), i.e. 2*G FLOP
// per K/V byte read at bf16: 16 for yi-9b's G=8, far below the ~295 FLOP
// per byte where the tensor cores rather than device memory would bind.
// So the bound is the K/V bytes over 3.35 TB/s.  What the design does
// about it:
//  * Each K/V row is loaded from device memory exactly once, by one warp,
//    into registers, and used there for all the G query heads of its KV
//    head (no shared-memory staging is needed for reuse across heads).
//  * The KV axis is split over blocks: at serving shapes a (B,K) grid is
//    32 blocks on 132 SMs (yi-9b, B=8), so the wrapper picks `nsplit`
//    splits per (row, KV head) to put a few blocks on every SM, and a
//    second small kernel combines the splits' (m, l, acc) partials.
//  * Inside a block, 4 warps take interleaved steps of 4 keys each, so
//    every warp keeps 8 row loads in flight.  A lane owns HD_PAD/32
//    consecutive head dims of q, of each K/V row and of the accumulators;
//    a q.k dot product is reduced across the warp with shuffles.  The
//    warps' partial states are merged in shared memory at the end.
// Not yet done (later work): tensor cores (G query heads form too few
// rows for an m16 mma without padding), cp.async/TMA pipelining, the fp8
// e4m3 cache.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// Resident blocks per SM the split kernel is compiled for (the register
// cap is 65536 / (3 * 128) = 170 a thread); the wrapper's split plan
// (ops.py BLOCKS_PER_SM) sizes one wave by it.
constexpr int kBlocksPerSM = 3;
constexpr int kKeysPerStep = 4;       // keys one warp loads per step
constexpr int kCombineThreads = 128;
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

template <int BYTES>
struct Chunk;
template <>
struct Chunk<2> { using type = unsigned short; };
template <>
struct Chunk<4> { using type = unsigned int; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<16> { using type = uint4; };

// VEC consecutive elements at p + d0 (a lane's head dims of one row) as
// floats, read with 16-byte (or narrower) loads; zeros past hd.  The wrapper
// guarantees that every row start is aligned to the lane's span and that hd
// is a multiple of VEC, so a lane's span is wholly inside or outside hd.
template <typename T, int VEC>
__device__ __forceinline__ void load_dims(const T* p, int d0, int hd,
                                          float (&out)[VEC]) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  constexpr int CH = BYTES < 16 ? BYTES : 16;
  constexpr int PER = CH / (int)sizeof(T);
  using C = typename Chunk<CH>::type;
  if (d0 < hd) {
#pragma unroll
    for (int c = 0; c < VEC / PER; ++c) {
      const C raw = reinterpret_cast<const C*>(p + d0)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = 0.f;
  }
}

// One block per (KV split, KV head x head group, batch row).  The block's
// GB query heads are g0 .. g0+GB-1 of KV head kh (those >= G are padding).
// Writes the split's unnormalised accumulator to part_acc (B,H,nsplit,hd)
// and its (max, sum) to part_ml (B,H,nsplit,2).
template <typename T, int HD_PAD, int GB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Smax, int H, int G, int hd, int ngroups, int chunk,
                    int nsplit, int window, float scale, long long q_sb,
                    long long q_sh, Strides ks, Strides vs) {
  constexpr int VEC = HD_PAD / 32;
  constexpr int U = kKeysPerStep;
  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ __align__(16) float sm_acc[kWarps][GB][HD_PAD];

  const int b = blockIdx.z;
  const int kh = blockIdx.y / ngroups;
  const int g0 = (blockIdx.y % ngroups) * GB;
  const int split = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * VEC;

  const int L = min(max(lengths[b], 0), Smax);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int begin = max(lo, split * chunk);
  const int end = min(L, split * chunk + chunk);

  float qv[GB][VEC];
  float acc[GB][VEC];
  float m[GB];
  float l[GB];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    const int g = g0 + gi;
    if (g < G) {
      load_dims<T, VEC>(q + b * q_sb + (long long)(kh * G + g) * q_sh, d0,
                        hd, qv[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[gi][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const T* kbase = k + b * ks.b + kh * ks.h;
  const T* vbase = v + b * vs.b + kh * vs.h;
  for (int j0 = begin + warp * U; j0 < end; j0 += kWarps * U) {
    float kr[U][VEC];
    float vr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(j0 + u, end - 1);   // past the end: a valid row, unused
      load_dims<T, VEC>(kbase + (long long)j * ks.s, d0, hd, kr[u]);
      load_dims<T, VEC>(vbase + (long long)j * vs.s, d0, hd, vr[u]);
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qv[gi][e] * kr[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][gi] = dot * scale;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float step_max = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j0 + u < end) step_max = fmaxf(step_max, s[u][gi]);
      const float m_new = fmaxf(m[gi], step_max);
      const float alpha = expf(m[gi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = j0 + u < end ? expf(s[u][gi] - m_new) : 0.f;
        s[u][gi] = p;
        psum += p;
      }
      l[gi] = l[gi] * alpha + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[gi][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a += s[u][gi] * vr[u][e];
        acc[gi][e] = a;
      }
      m[gi] = m_new;
    }
  }

  // merge the four warps' states; an empty warp has m = kNegInf, l = 0
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[warp][gi][d0 + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * HD_PAD; idx += kThreads) {
    const int gi = idx / HD_PAD;
    const int d = idx % HD_PAD;
    const int g = g0 + gi;
    if (g >= G || d >= hd) continue;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][gi]);
    float a_sum = 0.f, l_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][gi] - M);
      a_sum += a * sm_acc[w][gi][d];
      l_sum += a * sm_l[w][gi];
    }
    const long long row = ((long long)b * H + kh * G + g) * nsplit + split;
    part_acc[row * hd + d] = a_sum;
    if (d == 0) {
      part_ml[2 * row] = M;
      part_ml[2 * row + 1] = l_sum;
    }
  }
}

// One block per (query head, batch row): o = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max_s m_s).  A row whose splits are all empty has
// l = 0 everywhere and gets zeros.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      int H, int hd, int nsplit, long long o_sb,
                      long long o_sh) {
  extern __shared__ float w_s[];        // [nsplit]
  __shared__ float denom_s;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long row0 = ((long long)b * H + h) * nsplit;
  const float* ml = part_ml + 2 * row0;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  for (int s = threadIdx.x; s < nsplit; s += kCombineThreads)
    w_s[s] = expf(ml[2 * s] - M);
  __syncthreads();
  if (threadIdx.x == 0) {
    float denom = 0.f;
    for (int s = 0; s < nsplit; ++s) denom += w_s[s] * ml[2 * s + 1];
    denom_s = fmaxf(denom, 1e-30f);
  }
  __syncthreads();
  const float inv = 1.f / denom_s;
  for (int d = threadIdx.x; d < hd; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += w_s[s] * part_acc[(row0 + s) * hd + d];
    o[b * o_sb + h * o_sh + d] = from_float<T>(a * inv);
  }
}

template <typename T, int HD_PAD, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, float* part_acc, float* part_ml, int B,
                   int Smax, int H, int K, int hd, long long q_sb,
                   long long q_sh, Strides ks, Strides vs, long long o_sb,
                   long long o_sh, int nsplit, int chunk, int window,
                   float scale, cudaStream_t stream) {
  const int G = H / K;
  const int ngroups = (G + GB - 1) / GB;
  const dim3 grid(nsplit, K * ngroups, B);
  decode_split_kernel<T, HD_PAD, GB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, Smax, H, G, hd,
      ngroups, chunk, nsplit, window, scale, q_sb, q_sh, ks, vs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<dim3(H, B), kCombineThreads,
                             nsplit * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(o), H, hd, nsplit, o_sb, o_sh);
  return cudaGetLastError();
}

template <typename T, int HD_PAD>
cudaError_t dispatch_gb(int gb, const void* q, const void* k, const void* v,
                        void* o, const int* lengths, float* part_acc,
                        float* part_ml, int B, int Smax, int H, int K, int hd,
                        long long q_sb, long long q_sh, Strides ks, Strides vs,
                        long long o_sb, long long o_sh, int nsplit, int chunk,
                        int window, float scale, cudaStream_t stream) {
#define DA_LAUNCH(GBV)                                                       \
  return launch<T, HD_PAD, GBV>(q, k, v, o, lengths, part_acc, part_ml, B,   \
                                Smax, H, K, hd, q_sb, q_sh, ks, vs, o_sb,    \
                                o_sh, nsplit, chunk, window, scale, stream)
  switch (gb) {
    case 1: DA_LAUNCH(1);
    case 2: DA_LAUNCH(2);
    case 4: DA_LAUNCH(4);
    default:
      if constexpr (HD_PAD <= 128) {
        DA_LAUNCH(8);
      }
  }
  return cudaErrorInvalidValue;   // 8 heads per block only up to hd 128
#undef DA_LAUNCH
}

template <typename T>
cudaError_t dispatch_hd(int gb, const void* q, const void* k, const void* v,
                        void* o, const int* lengths, float* part_acc,
                        float* part_ml, int B, int Smax, int H, int K, int hd,
                        long long q_sb, long long q_sh, Strides ks, Strides vs,
                        long long o_sb, long long o_sh, int nsplit, int chunk,
                        int window, float scale, cudaStream_t stream) {
#define DA_HD(HDV)                                                           \
  return dispatch_gb<T, HDV>(gb, q, k, v, o, lengths, part_acc, part_ml, B,  \
                             Smax, H, K, hd, q_sb, q_sh, ks, vs, o_sb, o_sh, \
                             nsplit, chunk, window, scale, stream)
  if (hd <= 32) DA_HD(32);
  if (hd <= 64) DA_HD(64);
  if (hd <= 128) DA_HD(128);
  DA_HD(256);
#undef DA_HD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lengths is
// int32 (B,).  part_acc (B,H,nsplit,hd) and part_ml (B,H,nsplit,2) are fp32
// scratch the caller allocates; `chunk` keys per split (nsplit * chunk >=
// Smax).  gb: query heads per block (1, 2, 4, or 8 for head_dim <= 128).
// Every row start of q/k/v must be aligned to a lane's span of head dims
// (HD_PAD/32 elements) and hd a multiple of it.  window <= 0: no window.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    float* part_acc, float* part_ml, int dtype, int B, int Smax, int H, int K,
    int hd, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int nsplit, int chunk, int gb, int window,
    float scale, void* stream) {
  if (B < 1 || Smax < 1 || K < 1 || H % K != 0 || hd < 1 || hd > 256 ||
      nsplit < 1 || chunk < 1 || (long long)nsplit * chunk < Smax)
    return (int)cudaErrorInvalidValue;
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(gb, q, k, v, o, lengths, part_acc, part_ml, B, Smax,
                           H, K, hd, q_sb, q_sh, ks, vs, o_sb, o_sh, nsplit,
                           chunk, window, scale, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(gb, q, k, v, o, lengths, part_acc, part_ml,
                                   B, Smax, H, K, hd, q_sb, q_sh, ks, vs, o_sb,
                                   o_sh, nsplit, chunk, window, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
