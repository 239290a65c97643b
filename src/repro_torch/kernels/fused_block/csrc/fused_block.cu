// The dense transformer block's elementwise passes, fused, for Hopper
// (sm_90a): CUDA C++ with a plain C interface loaded through ctypes (see
// repro_torch/kernels/common.py).
//
// Replaces no TPU kernel: on the TPU, XLA fuses these chains into the
// neighbouring ops by itself.  In eager PyTorch each step of a chain is a
// kernel of its own that reads and writes a whole float32 copy of the
// activations: RMSNorm is about seven passes (upcast, square, mean, rsqrt,
// two products, downcast), RoPE about nine on q and nine on k (with the
// angles, cos and sin made twice a layer), SwiGLU's silu and product two,
// the residual add one more.  At a yi-9b forward (B=16, S=512, 48 layers)
// those passes move about 560 GB and took 36% of the card's time.
//
// What bounds each kernel on an H100: bytes.  Each reads every input once
// and writes every output once (3.35 TB/s), with the float32 intermediates
// in registers; none does enough arithmetic to matter.  Every activation
// is bfloat16 (the norm's scale float32), contiguous, 16-byte aligned and
// moved in 16-byte vectors of 8 elements: the served models' widths all
// are whole vectors.  Other dtypes and widths keep the eager chain
// (models/layers.py decides); an entry refuses a shape it cannot take
// with cudaErrorInvalidValue and launches nothing.
//
//   rms_norm_kernel   y = bf16((x * rsqrt(mean(x^2) + eps)) * scale), and in
//                     the residual form first x = bf16(x + residual),
//                     written back as the new residual stream.  One block a
//                     row; each thread keeps up to kNormVecs 16-byte
//                     vectors of the row in registers between the row's
//                     sum of squares (a warp-shuffle and shared-memory
//                     reduction) and the scaled write, so the row is read
//                     once.  D a multiple of 8, at most kNormVecs x
//                     kNormThreads vectors (16384).
//   rope_qk_kernel    q and k rotated in place in one launch, half-split
//                     convention: (x1, x2) -> (x1 cos - x2 sin, x1 sin +
//                     x2 cos).  One block a token (b, s): it makes the
//                     token's hd/2 angles, cos and sin once, into shared
//                     memory, for all of q's and k's heads.  hd/2 a
//                     multiple of 8 (head dims 64, 80, 128).
//   silu_mul_kernel   h = bf16(bf16(silu(gate)) * up).
//
// The roundings are the eager chain's, so that the served numbers do not
// move: every float32 product, sum and difference is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc may not contract them into an
// FMA, which the eager chain's separate kernels never do), bf16 results
// are rounded once to nearest even, positions become float32 as
// ``positions.float()`` does, and cosf / sinf / expf / rsqrtf are the
// precise library functions (no fast-math).  RoPE and silu * up equal the
// eager chain bit for bit; the norm's sum of squares is taken in another
// order than torch's reduction, so its output may differ in the last bf16
// place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;             // bf16 elements in a 16-byte vector
constexpr int kNormVecs = 4;        // 16-byte vectors a norm thread holds
constexpr int kNormThreads = 512;   // the most a row's block takes
constexpr int kRopeThreads = 128;
constexpr int kSiluThreads = 256;

// ---------------------------------------------------------------------------
// 16-byte vectors as floats, and rounding to bf16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

// v as bf16 stores it: what the eager chain holds between two of its
// kernels
__device__ __forceinline__ float stored(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// RMSNorm, with the residual add before it
// ---------------------------------------------------------------------------

template <bool kResidual>
__global__ void __launch_bounds__(kNormThreads)
rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                bf16* __restrict__ x_out, bf16* __restrict__ y,
                const float* __restrict__ scale, int D, float inv_d,
                float eps) {
  __shared__ float part[32];
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const int nvec = D / kVec;
  float v[kNormVecs][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kNormVecs; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      load8(x + base + c * kVec, v[i]);
      if constexpr (kResidual) {
        float r[kVec];
        load8(res + base + c * kVec, r);
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[i][j] = stored(__fadd_rn(v[i][j], r[j]));
        store8(x_out + base + c * kVec, v[i]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) ss = __fadd_rn(ss, __fmul_rn(v[i][j], v[i][j]));
    }
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_d), eps));
#pragma unroll
  for (int i = 0; i < kNormVecs; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float s[kVec];
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(scale + c * kVec + j);
        s[j] = t.x; s[j + 1] = t.y; s[j + 2] = t.z; s[j + 3] = t.w;
      }
      float o[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], r), s[j]);
      store8(y + base + c * kVec, o);
    }
  }
}

// ---------------------------------------------------------------------------
// RoPE on q and k, in place
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRopeThreads)
rope_qk_kernel(bf16* __restrict__ q, bf16* __restrict__ k, const void* pos,
               int pos_i32, const float* __restrict__ freqs, int S, int H,
               int K, int half, long long p_sb, long long p_ss) {
  extern __shared__ float cs[];           // cos [half], then sin [half]
  const int s = blockIdx.x, b = blockIdx.y;
  const long long pi = b * p_sb + s * p_ss;
  const float p = pos_i32
      ? static_cast<float>(static_cast<const int*>(pos)[pi])
      : static_cast<float>(static_cast<const long long*>(pos)[pi]);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float a = __fmul_rn(p, freqs[i]);
    cs[i] = cosf(a);
    cs[half + i] = sinf(a);
  }
  __syncthreads();
  const int hd = 2 * half, nv = half / kVec;
  bf16* qt = q + (static_cast<long long>(b) * S + s) * H * hd;
  bf16* kt = k + (static_cast<long long>(b) * S + s) * K * hd;
  for (int w = threadIdx.x; w < (H + K) * nv; w += blockDim.x) {
    const int head = w / nv, j = (w - head * nv) * kVec;
    bf16* row = head < H ? qt + head * hd : kt + (head - H) * hd;
    float x1[kVec], x2[kVec], o1[kVec], o2[kVec];
    load8(row + j, x1);
    load8(row + half + j, x2);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float c = cs[j + e], sn = cs[half + j + e];
      o1[e] = __fsub_rn(__fmul_rn(x1[e], c), __fmul_rn(x2[e], sn));
      o2[e] = __fadd_rn(__fmul_rn(x1[e], sn), __fmul_rn(x2[e], c));
    }
    store8(row + j, o1);
    store8(row + half + j, o2);
  }
}

// ---------------------------------------------------------------------------
// SwiGLU's silu(gate) * up
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSiluThreads)
silu_mul_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                bf16* __restrict__ h, long long nvec) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= nvec) return;
  float a[kVec], b[kVec], o[kVec];
  load8(g + i * kVec, a);
  load8(u + i * kVec, b);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    // F.silu's own expression, then its result stored
    const float sl = stored(a[e] / (1.0f + expf(-a[e])));
    o[e] = __fmul_rn(sl, b[e]);
  }
  store8(h + i * kVec, o);
}

}  // namespace

// Every entry returns the launch's cudaError_t (0: launched; an empty call
// launches nothing; cudaErrorInvalidValue: a shape the kernel does not
// take, nothing launched).  Every tensor is contiguous and 16-byte
// aligned, the activations bf16.

// x, res, x_out, y: (rows, D); scale (D,) float32; res and x_out null for
// the plain form.
extern "C" int rms_norm_fwd(const void* x, const void* res, void* x_out,
                            void* y, const void* scale, long long rows,
                            int D, float eps, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || D < 1 || D % kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = (D / kVec + kNormVecs - 1) / kNormVecs;
  const int threads = ((per_thread + 31) / 32) * 32;
  if (threads > kNormThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const float inv_d = 1.0f / static_cast<float>(D);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const bf16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  auto* yy = static_cast<bf16*>(y);
  if (res)
    rms_norm_kernel<true><<<grid, threads, 0, st>>>(
        xx, static_cast<const bf16*>(res), static_cast<bf16*>(x_out), yy, sc,
        D, inv_d, eps);
  else
    rms_norm_kernel<false><<<grid, threads, 0, st>>>(
        xx, nullptr, nullptr, yy, sc, D, inv_d, eps);
  return static_cast<int>(cudaGetLastError());
}

// q (B,S,H,hd) and k (B,S,K,hd), rotated in place; pos int32 (pos_i32) or
// int64, element (b, s) at b * p_sb + s * p_ss; freqs (hd/2,) float32.
extern "C" int rope_qk_fwd(void* q, void* k, const void* pos, int pos_i32,
                           const void* freqs, int B, int S, int H, int K,
                           int hd, long long p_sb, long long p_ss,
                           void* stream) {
  if (B < 0 || S < 0 || B > 65535 || H < 1 || K < 1 || hd < 2 ||
      hd % (2 * kVec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = hd / 2;
  const size_t smem = 2 * half * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  rope_qk_kernel<<<dim3(S, B), kRopeThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(q), static_cast<bf16*>(k), pos, pos_i32,
      static_cast<const float*>(freqs), S, H, K, half, p_sb, p_ss);
  return static_cast<int>(cudaGetLastError());
}

// g, u, h: n elements each, n a multiple of 8.
extern "C" int silu_mul_fwd(const void* g, const void* u, void* h,
                            long long n, void* stream) {
  if (n < 0 || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = n / kVec;
  const long long blocks = (nvec + kSiluThreads - 1) / kSiluThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (nvec == 0) return 0;
  silu_mul_kernel<<<static_cast<unsigned>(blocks), kSiluThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<bf16*>(h), nvec);
  return static_cast<int>(cudaGetLastError());
}
