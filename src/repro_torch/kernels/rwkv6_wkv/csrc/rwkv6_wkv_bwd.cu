// The backward of the RWKV-6 WKV recurrence for Hopper (sm_90a), CUDA C++
// with a plain C interface loaded through ctypes (see
// repro_torch/kernels/common.py).
//
// Replaces: no TPU kernel.  It is the gradient of
// src/repro/kernels/rwkv6_wkv/kernel.py::wkv6_bhtn (the Pallas kernel,
// pl.pallas_call at kernel.py:85), which JAX takes of its jnp
// ``wkv_chunked`` (src/repro/models/rwkv6.py:108).  The port launches the
// forward kernel (rwkv6_wkv.cu) on every CUDA forward, so training needs
// this backward behind ops.Wkv6Fn.
//
// What it computes, per batch row b and head h, given dy_t and dS_T (dsT):
// the forward is S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// y_t = r_t (S_{t-1} + diag(u) k_t v_t^T).  The adjoint of the state runs
// backward, G_{t-1} = diag(w_t) G_t + r_t dy_t^T from G_T = dsT, a chunk of
// kChunk steps at a time.  With L (Lprev) the inclusive (exclusive)
// cumulative sum of logw over the chunk, D[t,s] = exp(Lprev_t - L_s) for
// s < t, A the forward's matrix (its diagonal the u bonus), Bd[t,s] =
// dy_t . v_s and G the adjoint arriving from the later chunks:
//   dv_s  = sum_{t>=s} A[t,s] dy_t + (k_s o exp(L_c - L_s))^T G
//   dr'_t = sum_{s<t} Bd[t,s] D[t,s] o k_s + exp(Lprev_t) o S_start dy_t
//   dk'_s = sum_{t>s} Bd[t,s] D[t,s] o r_t + exp(L_c - L_s) o G v_s
//   dr = dr' + u o k (v.dy),  dk = dk' + r o u (v.dy),  du = sum r o k (v.dy)
//   dlogw_t = Q_end + sum_{tau>t} r_tau o dr'_tau - sum_{tau>=t} k_tau o dk'_tau
//   G <- exp(L_c) o G + sum_t (r_t o exp(Lprev_t)) dy_t^T
// Q_end[n] = sum_m S_end[n,m] G[n,m], the chunk's end state against the
// adjoint from later chunks (dlogw_t = G_t . (S_t - k_t v_t^T) row by row,
// stepped back through the chunk); it is taken anew at every chunk's end,
// so the reverse sums never run past 32 steps.  Their terms outgrow dlogw
// only under strong decay: against float64, dlogw's largest error is
// 2.5e-7 of its largest entry at rwkv6's own decays and up to 1.1e-4 at
// logw = -exp(normal + 4) (scripts/recurrent_bwd_precision.py).  Every
// exponent is <= 0.  Steps t >= T are k = v = 0, logw = 0, dy = 0 and get
// no gradient written.
//
// Two kernels, launched in turn by wkv6_bwd:
//  * wkv6_states_kernel rebuilds the state at the start of every chunk and
//    at the end ((B, H, nc + 1, N, N) float32 scratch): one block per (b,
//    h, kTile state columns), the forward's state update alone.  The
//    backward rebuilds them rather than have the forward write them, so
//    the forward that serving runs stays as it is and nothing of size
//    nc N^2 is kept between a forward and its backward (under remat only
//    one layer's states are alive, and only during its backward).
//  * wkv6_bwd_kernel: one block per (b, h) walks the chunks from last to
//    first, its adjoint G, the chunk's start state and its inputs in
//    shared memory (rows padded to N + 1 floats, so lanes reading down a
//    column hit distinct banks), each output element summed by one thread
//    in a fixed order.  No atomics: du leaves one row per (b, h) that the
//    wrapper sums over B; two calls give the same bits.
//  What bounds it: CUDA-core fp32 work, about 0.8 M FMAs and 0.1 M
//  exponentials a chunk and head (A, dr' and dk' each take one
//  exponential per (t, s < t, n)), against the 3.35 TB/s of the bytes
//  (r, k, v, logw, dy read once, dr, dk, dv, dlogw written once), and 128
//  blocks at rwkv6's training shape (B=4, H=32) on 132 SMs.  A first
//  version: the tensor cores and the sub-chunk factoring of the forward
//  kernel are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;      // steps per chunk (ref.CHUNK)
constexpr int kMaxN = 64;       // the largest head size taken
constexpr int kTile = 16;       // state columns per block of the states pass
constexpr int kStThreads = 256;
constexpr int kThreads = 512;

struct Strides {
  long long b, t, h;
};

__host__ __device__ constexpr int states_smem_floats(int n) {
  // k (c x (N+1)), L (c x (N+1)), v (c x kTile), S (N x kTile)
  return 2 * kChunk * (n + 1) + kChunk * kTile + n * kTile;
}

__global__ void __launch_bounds__(kStThreads)
wkv6_states_kernel(const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ logw,
                   const float* __restrict__ s0, float* __restrict__ states,
                   int T, int H, int N, Strides ks, Strides vs, Strides ws) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int MT = min(kTile, N - m0);
  const int tid = threadIdx.x;
  const int LD = N + 1;
  const int nc = (T + kChunk - 1) / kChunk;

  extern __shared__ float smem[];
  float* k_s = smem;                    // [c][LD] k, then k * exp(Lc - L)
  float* L_s = k_s + kChunk * LD;       // [c][LD] inclusive cumsum of logw
  float* v_s = L_s + kChunk * LD;       // [c][kTile] this block's columns
  float* S_s = v_s + kChunk * kTile;    // [N][kTile] the state tile

  const long long bh = (long long)b * H + h;
  const long long NN = (long long)N * N;
  float* st = states + bh * (nc + 1) * NN;
  for (int idx = tid; idx < N * kTile; idx += kStThreads) {
    const int n = idx / kTile, m = idx % kTile;
    S_s[idx] = m < MT ? s0[bh * NN + (long long)n * N + m0 + m] : 0.f;
  }
  const long long kb = b * ks.b + h * ks.h, vb = b * vs.b + h * vs.h;
  const long long wb = b * ws.b + h * ws.h;
  __syncthreads();

  for (int j = 0; j < nc; ++j) {
    const int t0 = j * kChunk;
    for (int idx = tid; idx < N * kTile; idx += kStThreads) {
      const int n = idx / kTile, m = idx % kTile;
      if (m < MT) st[j * NN + (long long)n * N + m0 + m] = S_s[idx];
    }
    for (int idx = tid; idx < kChunk * N; idx += kStThreads) {
      const int t = idx / N, n = idx % N;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      k_s[t * LD + n] = in ? k[kb + tt * ks.t + n] : 0.f;
      L_s[t * LD + n] = in ? logw[wb + tt * ws.t + n] : 0.f;
    }
    for (int idx = tid; idx < kChunk * kTile; idx += kStThreads) {
      const int t = idx / kTile, m = idx % kTile;
      const bool in = t0 + t < T && m < MT;
      v_s[idx] = in ? v[vb + (long long)(t0 + t) * vs.t + m0 + m] : 0.f;
    }
    __syncthreads();
    for (int n = tid; n < N; n += kStThreads) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += L_s[t * LD + n];
        L_s[t * LD + n] = acc;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kChunk * N; idx += kStThreads) {
      const int t = idx / N, n = idx % N;
      k_s[t * LD + n] *= expf(L_s[(kChunk - 1) * LD + n] - L_s[t * LD + n]);
    }
    __syncthreads();
    for (int idx = tid; idx < N * kTile; idx += kStThreads) {
      const int n = idx / kTile, m = idx % kTile;
      float acc = expf(L_s[(kChunk - 1) * LD + n]) * S_s[idx];
      for (int s = 0; s < kChunk; ++s)
        acc += k_s[s * LD + n] * v_s[s * kTile + m];
      S_s[idx] = acc;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < N * kTile; idx += kStThreads) {
    const int n = idx / kTile, m = idx % kTile;
    if (m < MT) st[nc * NN + (long long)n * N + m0 + m] = S_s[idx];
  }
}

__host__ __device__ constexpr int bwd_smem_floats(int n) {
  // r, k, v, dy, L, Lprev, kd, rp, dr', dk' (c x (N+1) each); A, Bd
  // (c x (c+1) each); G, S_start (N x (N+1) each); u, Q_end (N each)
  return 10 * kChunk * (n + 1) + 2 * kChunk * (kChunk + 1) +
         2 * n * (n + 1) + 2 * n;
}

__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ dsT,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dlogw, float* __restrict__ du_part,
                float* __restrict__ ds0, int T, int H, int N, Strides rs,
                Strides ks, Strides vs, Strides ws, Strides dys) {
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int CL = kChunk + 1;
  const int LD = N + 1;
  const int nc = (T + kChunk - 1) / kChunk;

  extern __shared__ float smem[];
  float* r_s = smem;                    // [c][LD]
  float* k_s = r_s + kChunk * LD;
  float* v_s = k_s + kChunk * LD;
  float* dy_s = v_s + kChunk * LD;
  float* L_s = dy_s + kChunk * LD;      // inclusive cumsum of logw
  float* P_s = L_s + kChunk * LD;       // exclusive: exactly L[t-1]
  float* kd_s = P_s + kChunk * LD;      // k * exp(Lc - L)
  float* rp_s = kd_s + kChunk * LD;     // r * exp(Lprev)
  float* drp_s = rp_s + kChunk * LD;    // dr' (no bonus)
  float* dkp_s = drp_s + kChunk * LD;   // dk' (no bonus)
  float* A_s = dkp_s + kChunk * LD;     // [c][c+1] A[t][s], s <= t
  float* Bd_s = A_s + kChunk * CL;      // [c][c+1] dy_t . v_s, s <= t
  float* G_s = Bd_s + kChunk * CL;      // [N][LD] the adjoint
  float* S0_s = G_s + N * LD;           // [N][LD] the chunk's start state
  float* u_s = S0_s + N * LD;           // [N]
  float* q_s = u_s + N;                 // [N] Q_end

  const long long bh = (long long)b * H + h;
  const long long NN = (long long)N * N;
  const float* st = states + bh * (nc + 1) * NN;
  for (int idx = tid; idx < N * N; idx += kThreads) {
    const int n = idx / N, m = idx % N;
    G_s[n * LD + m] = dsT != nullptr ? dsT[bh * NN + idx] : 0.f;
  }
  for (int n = tid; n < N; n += kThreads) u_s[n] = u[(long long)h * N + n];
  const long long rb = b * rs.b + h * rs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h, wb = b * ws.b + h * ws.h;
  const long long db = b * dys.b + h * dys.h;
  // the outputs are contiguous (B, T, H, N)
  const long long ob = ((long long)b * T * H + h) * N, ot = (long long)H * N;
  float du_acc = 0.f;                   // thread n < N: du[n] of this (b, h)

  for (int j = nc - 1; j >= 0; --j) {
    const int t0 = j * kChunk;
    __syncthreads();                    // the previous chunk is done
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const bool in = t0 + t < T;
      const long long tt = t0 + t;
      r_s[t * LD + n] = in ? r[rb + tt * rs.t + n] : 0.f;
      k_s[t * LD + n] = in ? k[kb + tt * ks.t + n] : 0.f;
      v_s[t * LD + n] = in ? v[vb + tt * vs.t + n] : 0.f;
      dy_s[t * LD + n] = in ? dy[db + tt * dys.t + n] : 0.f;
      L_s[t * LD + n] = in ? logw[wb + tt * ws.t + n] : 0.f;
    }
    for (int idx = tid; idx < N * N; idx += kThreads) {
      const int n = idx / N, m = idx % N;
      S0_s[n * LD + m] = st[j * NN + idx];
    }
    // Q_end[n]: the chunk's end state against G, one warp a row
    for (int n = warp; n < N; n += kWarps) {
      float acc = 0.f;
      for (int m = lane; m < N; m += 32)
        acc += st[(j + 1) * NN + (long long)n * N + m] * G_s[n * LD + m];
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) q_s[n] = acc;
    }
    __syncthreads();
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float lw = L_s[t * LD + n];
        P_s[t * LD + n] = acc;
        acc += lw;
        L_s[t * LD + n] = acc;
      }
    }
    __syncthreads();
    // A and Bd (a warp a row t, its lanes the columns s), the decayed k, r
    for (int idx = tid; idx < kChunk * kChunk; idx += kThreads) {
      const int t = idx / kChunk, s = idx % kChunk;
      float a = 0.f, bd = 0.f;
      if (s < t) {
        for (int n = 0; n < N; ++n) {
          a += r_s[t * LD + n] * k_s[s * LD + n] *
               expf(P_s[t * LD + n] - L_s[s * LD + n]);
          bd += dy_s[t * LD + n] * v_s[s * LD + n];
        }
      } else if (s == t) {
        for (int n = 0; n < N; ++n) {
          a += r_s[t * LD + n] * u_s[n] * k_s[t * LD + n];
          bd += dy_s[t * LD + n] * v_s[t * LD + n];
        }
      }
      A_s[t * CL + s] = a;
      Bd_s[t * CL + s] = bd;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      kd_s[t * LD + n] = k_s[t * LD + n] *
                         expf(L_s[(kChunk - 1) * LD + n] - L_s[t * LD + n]);
      rp_s[t * LD + n] = r_s[t * LD + n] * expf(P_s[t * LD + n]);
    }
    __syncthreads();
    // dv (lanes on m), dr' and dk' (lanes on n)
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int s = idx / N, m = idx % N;
      float acc = 0.f;
      for (int t = s; t < kChunk; ++t)
        acc += A_s[t * CL + s] * dy_s[t * LD + m];
      for (int n = 0; n < N; ++n) acc += kd_s[s * LD + n] * G_s[n * LD + m];
      if (t0 + s < T) dv[ob + (long long)(t0 + s) * ot + m] = acc;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const float pt = P_s[t * LD + n];
      float acc = 0.f;
      for (int s = 0; s < t; ++s)
        acc += Bd_s[t * CL + s] * k_s[s * LD + n] *
               expf(pt - L_s[s * LD + n]);
      float sdy = 0.f;
      for (int m = 0; m < N; ++m) sdy += S0_s[n * LD + m] * dy_s[t * LD + m];
      drp_s[t * LD + n] = acc + expf(pt) * sdy;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int s = idx / N, n = idx % N;
      const float ls = L_s[s * LD + n];
      float acc = 0.f;
      for (int t = s + 1; t < kChunk; ++t)
        acc += Bd_s[t * CL + s] * r_s[t * LD + n] *
               expf(P_s[t * LD + n] - ls);
      float gv = 0.f;
      for (int m = 0; m < N; ++m) gv += G_s[n * LD + m] * v_s[s * LD + m];
      dkp_s[s * LD + n] = acc + expf(L_s[(kChunk - 1) * LD + n] - ls) * gv;
    }
    __syncthreads();
    // the bonus parts, du and dlogw (thread n walks the chunk backward),
    // beside the adjoint's update (which reads none of what they write)
    for (int n = tid; n < N; n += kThreads) {
      float acc = q_s[n];
      for (int t = kChunk - 1; t >= 0; --t) {
        const float vdy = Bd_s[t * CL + t];
        const float rt = r_s[t * LD + n], kt = k_s[t * LD + n];
        const float dkp = dkp_s[t * LD + n], drp = drp_s[t * LD + n];
        acc -= kt * dkp;
        if (t0 + t < T) {
          const long long o = ob + (long long)(t0 + t) * ot + n;
          dlogw[o] = acc;
          dr[o] = drp + u_s[n] * kt * vdy;
          dk[o] = dkp + rt * u_s[n] * vdy;
        }
        du_acc += rt * kt * vdy;
        acc += rt * drp;
      }
    }
    for (int idx = tid; idx < N * N; idx += kThreads) {
      const int n = idx / N, m = idx % N;
      float acc = expf(L_s[(kChunk - 1) * LD + n]) * G_s[n * LD + m];
      for (int t = 0; t < kChunk; ++t)
        acc += rp_s[t * LD + n] * dy_s[t * LD + m];
      G_s[n * LD + m] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * N; idx += kThreads) {
    const int n = idx / N, m = idx % N;
    ds0[bh * NN + idx] = G_s[n * LD + m];
  }
  if (tid < N) du_part[bh * N + tid] = du_acc;
}

}  // namespace

// r, k, v, logw, dy (B,T,H,N) through (batch, step, head) strides; u (H,N),
// dsT (B,H,N,N) or null (zero), contiguous; states (B,H,nc+1,N,N) scratch;
// dr, dk, dv, dlogw (B,T,H,N), du_part (B,H,N), ds0 (B,H,N,N) contiguous.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* states,
                        void* dr, void* dk, void* dv, void* dlogw,
                        void* du_part, void* ds0, int B, int T, int H, int N,
                        long long r_sb, long long r_st, long long r_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long w_sb, long long w_st, long long w_sh,
                        long long d_sb, long long d_st, long long d_sh,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory cap
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_floats(kMaxN) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      ws{w_sb, w_st, w_sh};
  dim3 sgrid((N + kTile - 1) / kTile, H, B);
  wkv6_states_kernel<<<sgrid, kStThreads, states_smem_floats(N) * sizeof(float),
                       s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(s0),
      static_cast<float*>(states), T, H, N, ks, vs, ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_kernel<<<dim3(H, B), kThreads, bwd_smem_floats(N) * sizeof(float),
                    s>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(dsT), static_cast<const float*>(states),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dlogw),
      static_cast<float*>(du_part), static_cast<float*>(ds0), T, H, N,
      Strides{r_sb, r_st, r_sh}, ks, vs, ws, Strides{d_sb, d_st, d_sh});
  return static_cast<int>(cudaGetLastError());
}
