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
// What it computes, per batch row b and head h, given dy_t and dh_T (dhT):
// the forward is h_t = exp(l_t) h_{t-1} + dt_t x_t B_t^T, l_t = dt_t A,
// y_t = h_t C_t.  The adjoint G_t = dy_t C_t^T + exp(l_{t+1}) G_{t+1} runs
// backward from dhT, a chunk of kChunk steps at a time.  With L the
// inclusive cumulative sum of l over the chunk, M[t,s] = exp(L_t - L_s)
// (s <= t), X[t,s] = dy_t . x_s, CB[t,s] = C_t . B_s, h0 the chunk's start
// state and Gc the adjoint arriving from the later chunks:
//   dC_t (head h) = exp(L_t) h0^T dy_t + sum_{s<=t} M X[t,s] dt_s B_s
//   gx_s = exp(L_c - L_s) Gc B_s + sum_{t>=s} M CB[t,s] dy_t,  dx = dt gx
//   dB_s (head h) = dt_s (exp(L_c - L_s) Gc^T x_s + sum_{t>=s} M X[t,s] C_t)
//   dl_t = exp(l_t) G_t . h_{t-1}
//        = exp(L_c) (h0 . Gc) + sum_{tau>=t} exp(L_tau) C_tau . (h0^T dy_tau)
//          + sum_{s<t} exp(L_c - L_s) dt_s x_s . (Gc B_s)
//          + sum_{s<t<=tau} M[tau,s] dt_s X[tau,s] CB[tau,s]
//   ddt = A dl + x . gx,  dA = sum over T of dt dl,  Gc <- exp(L_c) Gc +
//   sum_t exp(L_t) dy_t C_t^T;  dh0 is the last Gc.
// dl is taken term by term, each term a sum of products of the chunk's
// values (c^3/6 scalars a chunk and head, no P x N product a step), not as
// the reverse sum of C . dC - x . dx that the same identity also gives:
// under strong decay (zamba2's dt A reaches -16 a step) that sum's terms
// are far larger than dl, and even anchored at every chunk's end its
// rounding missed dA by up to 3.6e-3 of dA's largest entry at A =
// -exp(normal + 3) over 512 steps, against 1.8e-5 term by term
// (scripts/recurrent_bwd_precision.py, float64 reference).  Every exponent
// is <= 0.
// Steps t >= T are dt = 0, dy = 0 and get no gradient written.
//
// Two kernels, launched in turn by ssd_bwd:
//  * ssd_states_kernel rebuilds the state at the start of every chunk and
//    at the end ((B, H, nc + 1, P, N) float32 scratch): one block per (b,
//    h, kTile state rows), the forward's state update alone.  The backward
//    rebuilds them rather than have the forward write them, so the serving
//    forward stays as it is and nothing of size nc P N is kept between a
//    forward and its backward (under remat only one layer's states are
//    alive, and only during its backward).
//  * ssd_bwd_kernel: one block per (b, h) walks the chunks from last to
//    first, its adjoint, the chunk's start state and inputs in shared
//    memory (rows padded to 65 floats, so lanes reading down a column hit
//    distinct banks), each output element summed by one thread in a fixed
//    order.  No atomics: dB and dC leave one row per head (B, T, H, N) and
//    dA one value per (b, h), which the wrapper sums over the heads and
//    over B; two calls give the same bits.
//  What bounds it: CUDA-core fp32 work, about 0.8 M FMAs a chunk and head
//  (five 32 x 64 x 64 products and the state update), and the bytes of
//  the per-head dB and dC rows (2 x 168 MB at zamba2's training shape, B=4,
//  T=2048, H=80).  A first version: tensor cores and a head-group block
//  that sums dB and dC in shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;      // steps per chunk (ref.CHUNK)
constexpr int kMaxDim = 64;     // the largest P and N taken
constexpr int kTile = 16;       // state rows per block of the states pass
constexpr int kStThreads = 256;
constexpr int kThreads = 512;

struct Strides {
  long long b, t, h;
};

__host__ __device__ constexpr int states_smem_floats(int n) {
  // x (c x kTile), B (c x N), L, wd (c each), h (kTile x N)
  return kChunk * kTile + kChunk * n + 2 * kChunk + kTile * n;
}

__global__ void __launch_bounds__(kStThreads)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ h0, float* __restrict__ states,
                  int T, int H, int P, int N, Strides xs, Strides ds,
                  long long bm_sb, long long bm_st) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int PT = min(kTile, P - p0);
  const int tid = threadIdx.x;
  const int nc = (T + kChunk - 1) / kChunk;

  extern __shared__ float smem[];
  float* x_s = smem;                    // [c][kTile] this block's rows
  float* B_s = x_s + kChunk * kTile;    // [c][N]
  float* L_s = B_s + kChunk * N;        // [c]
  float* wd_s = L_s + kChunk;           // [c] dt * exp(Lc - L)
  float* h_s = wd_s + kChunk;           // [kTile][N] the state tile

  const long long bh = (long long)b * H + h;
  const long long PN = (long long)P * N;
  float* st = states + bh * (nc + 1) * PN;
  for (int idx = tid; idx < kTile * N; idx += kStThreads) {
    const int p = idx / N, n = idx % N;
    h_s[idx] = p < PT ? h0[bh * PN + (long long)(p0 + p) * N + n] : 0.f;
  }
  const float a = A[h];
  const long long xb = b * xs.b + h * xs.h, db = b * ds.b + h * ds.h;
  const long long bb = b * bm_sb;
  __syncthreads();

  for (int j = 0; j < nc; ++j) {
    const int t0 = j * kChunk;
    for (int idx = tid; idx < kTile * N; idx += kStThreads) {
      const int p = idx / N, n = idx % N;
      if (p < PT) st[j * PN + (long long)(p0 + p) * N + n] = h_s[idx];
    }
    for (int idx = tid; idx < kChunk * kTile; idx += kStThreads) {
      const int t = idx / kTile, p = idx % kTile;
      const bool in = t0 + t < T && p < PT;
      x_s[idx] = in ? x[xb + (long long)(t0 + t) * xs.t + p0 + p] : 0.f;
    }
    for (int idx = tid; idx < kChunk * N; idx += kStThreads) {
      const int t = idx / N, n = idx % N;
      B_s[idx] = t0 + t < T ? Bm[bb + (long long)(t0 + t) * bm_st + n] : 0.f;
    }
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float d = t0 + t < T ? dt[db + (long long)(t0 + t) * ds.t] : 0.f;
        wd_s[t] = d;
        acc += d * a;
        L_s[t] = acc;
      }
      for (int t = 0; t < kChunk; ++t)
        wd_s[t] *= expf(acc - L_s[t]);
    }
    __syncthreads();
    const float decay = expf(L_s[kChunk - 1]);
    for (int idx = tid; idx < kTile * N; idx += kStThreads) {
      const int p = idx / N, n = idx % N;
      float acc = decay * h_s[idx];
      for (int s = 0; s < kChunk; ++s)
        acc += wd_s[s] * x_s[s * kTile + p] * B_s[s * N + n];
      h_s[idx] = acc;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kTile * N; idx += kStThreads) {
    const int p = idx / N, n = idx % N;
    if (p < PT) st[nc * PN + (long long)(p0 + p) * N + n] = h_s[idx];
  }
}

__host__ __device__ constexpr int bwd_smem_floats(int p, int n) {
  // x, dy, Gb, gx (c x (P+1) each); B, C, hdy (c x (N+1) each);
  // X, CB, MX, MCB (c x (c+1) each); Gc, h0 (P x (N+1) each); dt, L, eL,
  // back, E, F, rect, xg (c each); 16 warp partials
  return 4 * kChunk * (p + 1) + 3 * kChunk * (n + 1) +
         4 * kChunk * (kChunk + 1) + 2 * p * (n + 1) + 8 * kChunk + 16;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dy,
               const float* __restrict__ dhT,
               const float* __restrict__ states, float* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dA_part,
               float* __restrict__ dB_part, float* __restrict__ dC_part,
               float* __restrict__ dh0, int T, int H, int P, int N,
               Strides xs, Strides ds, long long bm_sb, long long bm_st,
               long long cm_sb, long long cm_st, Strides dys) {
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int CL = kChunk + 1;
  const int LP = P + 1, LN = N + 1;
  const int nc = (T + kChunk - 1) / kChunk;

  extern __shared__ float smem[];
  float* x_s = smem;                    // [c][LP]
  float* dy_s = x_s + kChunk * LP;      // [c][LP]
  float* Gb_s = dy_s + kChunk * LP;     // [c][LP] Gc B_s
  float* gx_s = Gb_s + kChunk * LP;     // [c][LP]
  float* B_s = gx_s + kChunk * LP;      // [c][LN]
  float* C_s = B_s + kChunk * LN;       // [c][LN]
  float* hdy_s = C_s + kChunk * LN;     // [c][LN] h0^T dy_t
  float* X_s = hdy_s + kChunk * LN;     // [c][c+1] dy_t . x_s
  float* CB_s = X_s + kChunk * CL;      // [c][c+1] C_t . B_s
  float* MX_s = CB_s + kChunk * CL;     // [c][c+1] M X
  float* MCB_s = MX_s + kChunk * CL;    // [c][c+1] M CB
  float* G_s = MCB_s + kChunk * CL;     // [P][LN] the adjoint Gc
  float* h0_s = G_s + P * LN;           // [P][LN] the chunk's start state
  float* dt_s = h0_s + P * LN;          // [c]
  float* L_s = dt_s + kChunk;           // [c] inclusive cumsum of dt A
  float* eL_s = L_s + kChunk;           // [c] exp(L)
  float* back_s = eL_s + kChunk;        // [c] exp(Lc - L)
  float* E_s = back_s + kChunk;         // [c]
  float* F_s = E_s + kChunk;            // [c]
  float* rect_s = F_s + kChunk;         // [c]
  float* xg_s = rect_s + kChunk;        // [c]
  float* part_s = xg_s + kChunk;        // [kWarps]

  const long long bh = (long long)b * H + h;
  const long long PN = (long long)P * N;
  const float* st = states + bh * (nc + 1) * PN;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    G_s[p * LN + n] = dhT != nullptr ? dhT[bh * PN + idx] : 0.f;
  }
  const float a = A[h];
  const long long xb = b * xs.b + h * xs.h, db = b * ds.b + h * ds.h;
  const long long yb = b * dys.b + h * dys.h;
  const long long bb = b * bm_sb, cb = b * cm_sb;
  // the outputs are contiguous: dx (B,T,H,P), ddt (B,T,H), dB/dC parts
  // (B,T,H,N)
  const long long HP = (long long)H * P, HN = (long long)H * N;
  float dA_acc = 0.f;                   // thread 0

  for (int j = nc - 1; j >= 0; --j) {
    const int t0 = j * kChunk;
    __syncthreads();                    // the previous chunk is done
    for (int idx = tid; idx < kChunk * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      x_s[t * LP + p] = in ? x[xb + tt * xs.t + p] : 0.f;
      dy_s[t * LP + p] = in ? dy[yb + tt * dys.t + p] : 0.f;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      B_s[t * LN + n] = in ? Bm[bb + tt * bm_st + n] : 0.f;
      C_s[t * LN + n] = in ? Cm[cb + tt * cm_st + n] : 0.f;
    }
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      h0_s[p * LN + n] = st[j * PN + idx];
    }
    if (tid < kChunk)
      dt_s[tid] = t0 + tid < T ? dt[db + (long long)(t0 + tid) * ds.t] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += dt_s[t] * a;
        L_s[t] = acc;
      }
    }
    // Gc B_s (lanes on p), h0^T dy_t (lanes on n), X and CB (a warp a row
    // t, its lanes the columns s <= t), h0 . Gc (warp partials)
    for (int idx = tid; idx < kChunk * P; idx += kThreads) {
      const int s = idx / P, p = idx % P;
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc += G_s[p * LN + n] * B_s[s * LN + n];
      Gb_s[s * LP + p] = acc;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc += dy_s[t * LP + p] * h0_s[p * LN + n];
      hdy_s[t * LN + n] = acc;
    }
    for (int idx = tid; idx < kChunk * kChunk; idx += kThreads) {
      const int t = idx / kChunk, s = idx % kChunk;
      float xv = 0.f, cbv = 0.f;
      if (s <= t) {
        for (int p = 0; p < P; ++p) xv += dy_s[t * LP + p] * x_s[s * LP + p];
        for (int n = 0; n < N; ++n) cbv += C_s[t * LN + n] * B_s[s * LN + n];
      }
      X_s[t * CL + s] = xv;
      CB_s[t * CL + s] = cbv;
    }
    {
      float acc = 0.f;
      for (int idx = tid; idx < P * N; idx += kThreads) {
        const int p = idx / N, n = idx % N;
        acc += h0_s[p * LN + n] * G_s[p * LN + n];
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) part_s[warp] = acc;
    }
    __syncthreads();
    const float Lc = L_s[kChunk - 1];
    if (tid < kChunk) {
      eL_s[tid] = expf(L_s[tid]);
      back_s[tid] = expf(Lc - L_s[tid]);
    }
    for (int idx = tid; idx < kChunk * kChunk; idx += kThreads) {
      const int t = idx / kChunk, s = idx % kChunk;
      const float m = s <= t ? expf(L_s[t] - L_s[s]) : 0.f;
      MX_s[t * CL + s] = m * X_s[t * CL + s];
      MCB_s[t * CL + s] = m * CB_s[t * CL + s];
    }
    __syncthreads();
    // dC (lanes on n), gx and dx (lanes on p), dB (lanes on n); E, F and
    // the rectangle sums of dl by the lanes of the first warps
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s)
        acc += MX_s[t * CL + s] * dt_s[s] * B_s[s * LN + n];
      acc += eL_s[t] * hdy_s[t * LN + n];
      if (t0 + t < T)
        dC_part[((long long)b * T + t0 + t) * HN + (long long)h * N + n] = acc;
    }
    for (int idx = tid; idx < kChunk * P; idx += kThreads) {
      const int s = idx / P, p = idx % P;
      float acc = 0.f;
      for (int t = s; t < kChunk; ++t)
        acc += MCB_s[t * CL + s] * dy_s[t * LP + p];
      acc += back_s[s] * Gb_s[s * LP + p];
      gx_s[s * LP + p] = acc;
      if (t0 + s < T)
        dx[((long long)b * T + t0 + s) * HP + (long long)h * P + p] =
            dt_s[s] * acc;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int s = idx / N, n = idx % N;
      float acc = 0.f;
      for (int t = s; t < kChunk; ++t)
        acc += MX_s[t * CL + s] * C_s[t * LN + n];
      float gtx = 0.f;
      for (int p = 0; p < P; ++p) gtx += G_s[p * LN + n] * x_s[s * LP + p];
      acc += back_s[s] * gtx;
      if (t0 + s < T)
        dB_part[((long long)b * T + t0 + s) * HN + (long long)h * N + n] =
            dt_s[s] * acc;
    }
    if (tid < kChunk) {
      const int t = tid;
      // the rectangle s < t <= tau of M dt X CB
      float acc = 0.f;
      for (int tau = t; tau < kChunk; ++tau)
        for (int s = 0; s < t; ++s)
          acc += MX_s[tau * CL + s] * CB_s[tau * CL + s] * dt_s[s];
      rect_s[t] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      const int t = lane;
      float e = 0.f, f = 0.f, xg = 0.f;
      for (int n = 0; n < N; ++n) e += C_s[t * LN + n] * hdy_s[t * LN + n];
      for (int p = 0; p < P; ++p) {
        f += x_s[t * LP + p] * Gb_s[t * LP + p];
        xg += x_s[t * LP + p] * gx_s[t * LP + p];
      }
      E_s[t] = eL_s[t] * e;
      F_s[t] = back_s[t] * dt_s[t] * f;
      xg_s[t] = xg;
      __syncwarp();
      if (lane == 0) {
        float q = 0.f;
        for (int w = 0; w < kWarps; ++w) q += part_s[w];
        const float base = expf(Lc) * q;
        float pre = 0.f;                // sum_{s<t} F
        float suf = 0.f;                // sum_{tau>=t} E
        for (int s = 0; s < kChunk; ++s) suf += E_s[s];
        for (int tt = 0; tt < kChunk; ++tt) {
          const float dl = base + suf + pre + rect_s[tt];
          suf -= E_s[tt];
          pre += F_s[tt];
          if (t0 + tt < T)
            ddt[((long long)b * T + t0 + tt) * H + h] = a * dl + xg_s[tt];
          dA_acc += dt_s[tt] * dl;
        }
      }
    }
    // the adjoint's update (reads nothing the first warp writes)
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float acc = expf(Lc) * G_s[p * LN + n];
      for (int t = 0; t < kChunk; ++t)
        acc += eL_s[t] * dy_s[t * LP + p] * C_s[t * LN + n];
      G_s[p * LN + n] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    dh0[bh * PN + idx] = G_s[p * LN + n];
  }
  if (tid == 0) dA_part[bh] = dA_acc;
}

}  // namespace

// x, dy (B,T,H,P) and dt (B,T,H) through (batch, step, head) strides, Bm/Cm
// (B,T,N) through (batch, step) strides, last dimensions contiguous; A
// (H,), h0 and dhT (B,H,P,N; dhT null for zero) contiguous; states
// (B,H,nc+1,P,N) scratch; dx (B,T,H,P), ddt (B,T,H), dA_part (B,H),
// dB_part and dC_part (B,T,H,N), dh0 (B,H,P,N) contiguous.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       const void* dy, const void* dhT, void* states,
                       void* dx, void* ddt, void* dA_part, void* dB_part,
                       void* dC_part, void* dh0, int B, int T, int H, int P,
                       int N, long long x_sb, long long x_st, long long x_sh,
                       long long d_sb, long long d_st, long long d_sh,
                       long long bm_sb, long long bm_st, long long cm_sb,
                       long long cm_st, long long y_sb, long long y_st,
                       long long y_sh, void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kMaxDim ||
      N > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_floats(kMaxDim, kMaxDim) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{x_sb, x_st, x_sh}, ds{d_sb, d_st, d_sh};
  dim3 sgrid((P + kTile - 1) / kTile, H, B);
  ssd_states_kernel<<<sgrid, kStThreads, states_smem_floats(N) * sizeof(float),
                      s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(h0), static_cast<float*>(states), T, H, P, N,
      xs, ds, bm_sb, bm_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_kernel<<<dim3(H, B), kThreads, bwd_smem_floats(P, N) * sizeof(float),
                   s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dhT), static_cast<const float*>(states),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dh0), T, H, P, N, xs,
      ds, bm_sb, bm_st, cm_sb, cm_st, Strides{y_sb, y_st, y_sh});
  return static_cast<int>(cudaGetLastError());
}
