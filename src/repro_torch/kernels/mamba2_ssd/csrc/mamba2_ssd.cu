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
//     W[t,s] = exp(L_t - L_s) * (C_t . B_s)                  (s <= t)
//     y[t,p] = sum_{s<=t} W[t,s] dt_s x[s,p] + exp(L_t) sum_n C[t,n] h[p,n]
//     h'[p,n] = exp(L_c) h[p,n] + sum_s dt_s x[s,p] exp(L_c - L_s) B[s,n]
// Every exponent is <= 0.  dA is formed here from dt and A[h] (the TPU
// wrapper built a (B,H,T,1) dA tensor).
//
// Layout: x and y are (B,T,H,P), dt (B,T,H), Bm and Cm (B,T,N), all float32
// in the model layout, read through element strides with the last dimension
// of x, y, Bm and Cm contiguous (x may be a view of the conv output); A is
// (H,), h0 and h_T (B,H,P,N), contiguous.  Steps t >= T are treated as
// dt = 0 (decay 1, no input) here, not in a padded copy, and their y is not
// written.
//
// Work split: the sequential chunk axis of the TPU grid becomes a loop
// inside the block, one block per (b, h) holding its (P, N) state in shared
// memory for the whole sequence: 640 blocks at the zamba2-2.7b prefill
// bucket (B=8, H=80), 80 at B=1.  The chunk is 64 steps, not the TPU's 128:
// the tiles (x dt 16 KB, B and C 16.6 KB each, W 16.6 KB, the state 16.6 KB)
// then take 84 KB of dynamic shared memory, so two blocks fit an SM; at 128
// the c x c W alone is 66 KB and one block would fill it.  The chunk only
// moves where the sum is cut; the result is the same up to rounding.
//
// What bounds it on an H100: at B=8, T=512, H=80, P=N=64 the call reads x
// (84 MB), dt, B and C (about 3 MB) and h0 (10.5 MB) and writes y (84 MB)
// and h_T (10.5 MB): about 193 MB, 0.058 ms at 3.35 TB/s.  The products,
// about 2 (c^2/2 (N + P) + 2 c P N) per chunk and head (8.3 GFLOP at that
// shape), take 0.12 ms at the fp32 CUDA-core peak of 67 TFLOP/s, so without
// tensor cores the kernel is bound by operations; chip_smoke.py prints the
// bound it computes for each run beside the measured time.  This first
// version is simple and right rather than fast: synchronous loads, fp32
// CUDA-core products, and G = C B^T recomputed by every head of a
// (b, chunk) although it does not depend on the head (80-fold redundancy at
// zamba2's 80 heads; the first thing a redesign removes, along with
// tensor-core (TF32 or bf16 split) products and cp.async staging).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // steps per chunk (ref.CHUNK)
constexpr int kMaxP = 64;       // head dim the shared tiles are sized for
constexpr int kMaxN = 64;       // state size the shared tiles are sized for
constexpr int kThreads = 256;

struct Strides {
  long long b, t, h;
};

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
    if (tid == 0) {                    // 64 dependent adds: one thread
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += dt_s[t] * a;
        L_s[t] = acc;
      }
    }
    __syncthreads();
    for (int t = tid; t < kChunk; t += kThreads)
      wd_s[t] = expf(L_s[kChunk - 1] - L_s[t]);
    // --- W[t,s]: a warp holds half a row t, its lanes the columns s -----
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
