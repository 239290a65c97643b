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
// What it computes (ref.wkv6_bwd_plain, in the same factoring), per batch
// row b and head h, given dy_t and dS_T (dsT): the forward is S_t =
// diag(w_t) S_{t-1} + k_t v_t^T and y_t = r_t (S_{t-1} + diag(u) k_t
// v_t^T).  The adjoint of the state runs backward, G_{t-1} = diag(w_t) G_t
// + r_t dy_t^T from G_T = dsT, a chunk of kChunk steps at a time.  With L
// (Lprev) the inclusive (exclusive) cumulative sum of logw over the chunk,
// D[t,s] = exp(Lprev_t - L_s) for s < t, A the forward's matrix (its
// diagonal the u bonus), Bd[t,s] = dy_t . v_s, S the chunk's start state,
// S' its end state and G the adjoint arriving from the later chunks:
//   dv_s  = sum_{t>=s} A[t,s] dy_t + (k_s o exp(L_c - L_s))^T G
//   dr'_t = sum_{s<t} Bd[t,s] D[t,s] o k_s + exp(Lprev_t) o S dy_t
//   dk'_s = sum_{t>s} Bd[t,s] D[t,s] o r_t + exp(L_c - L_s) o G v_s
//   dr = dr' + u o k (v.dy),  dk = dk' + r o u (v.dy),  du = sum r o k (v.dy)
//   dlogw_t = Q_end + sum_{tau>t} r_tau o dr'_tau - sum_{tau>=t} k_tau o dk'_tau
//   G <- exp(L_c) o G + sum_t (r_t o exp(Lprev_t)) dy_t^T
// Q_end[n] = sum_m S'[n,m] G[n,m], the chunk's end state against the
// adjoint from later chunks (dlogw_t = G_t . (S_t - k_t v_t^T) row by row,
// stepped back through the chunk); it is taken anew at every chunk's end,
// so the reverse sums never run past 32 steps.  (The tensor-core route
// forms it from what a chunk's block holds, never reading S': S' = exp(L_c)
// o S + (k o exp(L_c - L))^T v gives Q_end = exp(L_c) o (S . G) + sum_s
// k_s o exp(L_c - L_s) (G v_s), the last factor dk''s state term.)  Their
// terms outgrow dlogw
// only under strong decay.  Against float64 (scripts/recurrent_bwd_
// precision.py, CPU), dlogw's largest error over its largest entry is
// 2.5e-7 at rwkv6's own decays, 2.3e-5 at logw = -exp(normal + 2) and
// 1.1e-4 at -exp(normal + 4) in exact fp32, and the same to two digits
// with every product rounded as the TF32 x 3 products below round it
// (2.7e-7, 2.3e-5, 1.1e-4): the products add nothing that shows, the
// sums' own rounding is the whole error.  So dlogw keeps the reverse sums,
// not K5's term-by-term form (whose rectangle of s < t < tau pairs costs
// an exponential per pair and n here).  Every exponent is <= 0.  Steps t
// >= T are k = v = 0, logw = 0, dy = 0 and get no gradient written.
//
// Two routes, chosen by shape in ops.wkv6_bwd as the forward chooses
// (ops.tensor_core_path, and dy's rows 16-byte aligned too):
//
// N = 64 with aligned rows (the model's shapes), two tensor-core kernels.
// What bounds them on an H100, at rwkv6-1.6b's training shape (B=4,
// T=2048, H=32, N=64), in this design: the bytes.  r, k, v, logw and dy
// are read twice (the scans and the chunk kernel), the two (B, H, nc+1,
// N, N) boundary tensors (136 MB each) are written once and read back,
// and dr, dk, dv, dlogw written: about 1.7 GB, 0.50 ms at 3.35 TB/s,
// against about 16 G operations of products (0.10 ms on TF32 x 3).  It
// takes 0.88 ms of device time, the scans 0.28 (about their bytes) and
// the chunk kernel 0.60, where the products' fragments, read from shared
// memory about 550 times a warp with two blocks an SM, bound it.  The
// first version (a states pass, then one block per (b, h) walking the 64
// chunks in series on CUDA cores, an exponential per (t, s < t, n) in
// each of A, dr' and dk', 128 blocks on 132 SMs) took 3.54 ms.  This
// design takes the serial chain off the critical path:
//  * wkv6_bwd_scan_kernel runs the two chunk-boundary recurrences, one
//    block per (kScanRows state rows, h, b, direction): the forward state
//    S' = exp(L_c) o S + (k o exp(L_c - L))^T v, written at every chunk's
//    start and at the end (states), and the adjoint G <- exp(L_c) o G + (r
//    o exp(Lprev))^T dy from dsT, written at every chunk's end (adj; entry
//    j + 1 is chunk j's G, entry 0 ds0).  The decay acts on the rows n
//    alone, so the rows split over blocks with no exchange, and the
//    adjoint needs no forward state, so both directions run at once.
//    Each is a kScanRows x c . c x N product a chunk on tensor cores, the
//    state held in the accumulators across the sequence; L is summed step
//    by step, one column a thread (never rising, so every exponent is <=
//    0 without a clamp, and the forward kernel's L bit for bit).
//  * wkv6_bwd_chunk_kernel: one block of 8 warps per (chunk, h, b), 8192
//    blocks at the training shape, every chunk in parallel.  It stages
//    its chunk's r, k, v, dy and logw, S = states[j] and G = adj[j + 1]
//    with cp.async, and runs every product on TF32 x 3 mma.sync
//    (wkv_mma.cuh): Bd = dy v^T, A
//    between sub-chunks, dv, S dy and G v, and dr' and dk' between
//    sub-chunks.  Sub-chunks of kSub = 8 steps, as in the forward: for
//    steps s <= b < t, b = 8q - 1 the last step of sub-chunk q - 1,
//        exp(Lprev_t - L_s) = exp(Lprev_t - L_b) exp(L_b - L_s),
//    both exponents <= 0.  With R_q = r o exp(Lprev - L_b) (rows t > b)
//    and K_q = k o exp(L_b - L) (rows s <= b), A[t, s] = R_q[t] . K_q[s]
//    for s in sub-chunk q - 1; dr'_t += exp(Lprev_t - L_b) o (Bd[t, s<=b]
//    K_q) for t in sub-chunk q (one scale a row, the product over every
//    earlier s at once); dk'_s += exp(L_b - L_s) o (Bd[t>b, s]^T R_q) for
//    s in sub-chunk q - 1.  So A, dr' and dk' share one pair of decayed
//    operands per sub-chunk boundary, taken on the fly in the fragment
//    loads.  The four 8 x 8 diagonal blocks keep the exact form on CUDA
//    cores: A's entries 8 lanes an entry over n (as the forward), dr' and
//    dk' one thread per (sub-chunk, n), an exponential per (t, s < t, n)
//    used by both.  dlogw's reverse sums run a thread per (quarter of
//    the steps, n): its 8 steps' sums, the later quarters' totals added
//    in a fixed order, then its steps backward.  du leaves one row per
//    (b, chunk, h) that the wrapper sums in a fixed order.
//    At 110 KB of shared memory (rows padded to 72 floats, A and Bd to
//    40) two blocks share an SM; no fragment crosses a barrier.  No
//    atomics anywhere: two calls give the same bits.
//
// The rest (N < 64 or unaligned rows; the model never takes it), the first
// version's two CUDA-core kernels, launched in turn:
//  * wkv6_states_kernel rebuilds the state at the start of every chunk and
//    at the end ((B, H, nc + 1, N, N) float32 scratch): one block per (b,
//    h, kTile state columns), the forward's state update alone.
//  * wkv6_bwd_kernel: one block per (b, h) walks the chunks from last to
//    first, its adjoint G, the chunk's start state and its inputs in
//    shared memory (rows padded to N + 1 floats, so lanes reading down a
//    column hit distinct banks), each output element summed by one thread
//    in a fixed order.  No atomics: du leaves one row per (b, h) that the
//    wrapper sums over B; two calls give the same bits.
// Both routes rebuild the chunk states rather than have the forward write
// them, so the forward that serving runs stays as it is and nothing of
// size nc N^2 is kept between a forward and its backward (under remat
// only one layer's states are alive, and only during its backward).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv_mma.cuh"

namespace {

using namespace wkv;

constexpr int kChunk = 32;      // steps per chunk (ref.CHUNK)
constexpr int kMaxN = 64;       // the largest head size taken
constexpr int kTile = 16;       // state columns per block of the states pass
constexpr int kStThreads = 256;
constexpr int kThreads = 512;

struct Strides {
  long long b, t, h;
};

// --- the CUDA-core kernels (N <= 64, any alignment) -------------------------

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


// --- the tensor-core kernels (N = 64, 16-byte aligned rows) -----------------

constexpr int kDim = 64;          // N of the tensor-core kernels
constexpr int kSub = 8;           // steps per sub-chunk (ref.SUB)
constexpr int kNSub = kChunk / kSub;
static_assert(kSub % 8 == 0 && kChunk % kSub == 0, "kSub: 8, 16 or 32");
constexpr unsigned kAll = 0xffffffffu;

// One warp's (16 x 8 NT) tile of D += A B on TF32 x 3 over k steps ks0 <=
// ks < ks1 of 8.  fa(ks, a) gives this lane's A values of step ks in
// fragment order: (row g, k), (g + 8, k), (g, k + 1), (g + 8, k + 1) with
// k = 8 ks + 2 tig; fb(ks, j, b) its B values (k, column g of n-tile j),
// (k + 1, g).  Fragment columns tig and tig + 4 stand for steps 2 tig and
// 2 tig + 1, in A and B alike, so the sum is the same.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma_step(float (&d)[NT][4],
                                              float (&dx)[NT][4], int ks,
                                              FA& fa, FB& fb) {
  float a[4];
  fa(ks, a);
  uint32_t ah[4], al[4];
  split_a(a[0], a[1], a[2], a[3], ah, al);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float bv[2];
    fb(ks, j, bv);
    uint32_t bh[2], bl[2];
    split(bv[0], bh[0], bl[0]);
    split(bv[1], bh[1], bl[1]);
    mma3(d[j], dx[j], ah, al, bh, bl);
  }
}

// The k loop two steps at a time (the chunk kernel's products)...
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&d)[NT][4],
                                         float (&dx)[NT][4], int ks0,
                                         int ks1, FA fa, FB fb) {
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) warp_mma_step<NT>(d, dx, ks, fa, fb);
}

// ... or one at a time (the scans: fewer registers)
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma_rolled(float (&d)[NT][4],
                                                float (&dx)[NT][4], int ks0,
                                                int ks1, FA fa, FB fb) {
#pragma unroll 1
  for (int ks = ks0; ks < ks1; ++ks) warp_mma_step<NT>(d, dx, ks, fa, fb);
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
}

// --- the chunk-boundary scans -----------------------------------------------

constexpr int kScanRows = 32;     // state rows per scan block
constexpr int kScanThreads = 32 * 2 * (kScanRows / 16);
constexpr int kLdU = kScanRows + 4;   // [t][n] rows: A read down columns
constexpr int kLdV = kDim + 4;        // [t][m] rows: B read down columns

struct ScanStage {
  float u[kChunk * kLdU];         // k (forward) or r (adjoint): the rows n
  float w[kChunk * kLdU];         // logw of the rows n, then its cumsum
  float v[kChunk * kLdV];         // v (forward) or dy (adjoint)
};

// blockIdx: (x) kScanRows state rows, (y) head, (z) 2 b + direction (0:
// the forward states, 1: the adjoint).  out[b, h] is (nc + 1, N, N).
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ logw,
                     const float* __restrict__ dy,
                     const float* __restrict__ s0,
                     const float* __restrict__ dsT, float* __restrict__ states,
                     float* __restrict__ adj, int T, int H, Strides sr,
                     Strides sk, Strides sv, Strides sw, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanStage* stg = reinterpret_cast<ScanStage*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kScanRows, h = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool fwd = (blockIdx.z & 1) == 0;
  const int nc = (T + kChunk - 1) / kChunk;
  const float* up = fwd ? k + b * sk.b + h * sk.h + n0
                        : r + b * sr.b + h * sr.h + n0;
  const long long ust = fwd ? sk.t : sr.t;
  const float* wp = logw + b * sw.b + h * sw.h + n0;
  const float* vp = fwd ? v + b * sv.b + h * sv.h : dy + b * sd.b + h * sd.h;
  const long long vst = fwd ? sv.t : sd.t;
  const long long NN = kDim * kDim;
  const long long bh = (long long)b * H + h;
  float* out = (fwd ? states : adj) + bh * (nc + 1) * NN;
  const float* init = fwd ? s0 : dsT;   // dsT may be null: zero

  // this warp's 16 x 32 tile of the block's kScanRows x 64 state: rows wr +
  // g (+8), n-tile jn columns wc + 8 jn + 2 tig (+1)
  const int wr = 16 * (warp % (kScanRows / 16));
  const int wc = 32 * (warp / (kScanRows / 16));
  float hs[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + wr + g + 8 * (i >> 1);
      const int col = wc + 8 * jn + 2 * tig + (i & 1);
      hs[jn][i] = init != nullptr ? init[bh * NN + row * kDim + col] : 0.f;
    }
  auto store = [&](int slot) {
    float* o = out + (long long)slot * NN;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        *reinterpret_cast<float2*>(
            o + (n0 + wr + g + 8 * r2) * kDim + wc + 8 * jn + 2 * tig) =
            make_float2(hs[jn][2 * r2], hs[jn][2 * r2 + 1]);
  };
  auto stage = [&](ScanStage& s, int j) {
    const int t0 = j * kChunk;
    constexpr int QU = kScanRows / 4, QV = kDim / 4;
    for (int i = tid; i < kChunk * QU; i += kScanThreads) {
      const int t = i / QU, c = (i % QU) * 4;
      const bool in = t0 + t < T;
      const long long tt = in ? t0 + t : 0;   // a valid row when zero-filled
      cp_async16(&s.u[t * kLdU + c], up + tt * ust + c, in);
      cp_async16(&s.w[t * kLdU + c], wp + tt * sw.t + c, in);
    }
    for (int i = tid; i < kChunk * QV; i += kScanThreads) {
      const int t = i / QV, c = (i % QV) * 4;
      const bool in = t0 + t < T;
      const long long tt = in ? t0 + t : 0;
      cp_async16(&s.v[t * kLdV + c], vp + tt * vst + c, in);
    }
  };

  stage(stg[0], fwd ? 0 : nc - 1);
  cp_async_commit();
  for (int it = 0; it < nc; ++it) {
    const int j = fwd ? it : nc - 1 - it;
    if (it + 1 < nc) {
      stage(stg[(it + 1) & 1], fwd ? j + 1 : j - 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    store(fwd ? j : j + 1);     // the state at the chunk's start, the
                                // adjoint at its end
    ScanStage& s = stg[it & 1];
    if (tid < kScanRows) {      // L: one row n a thread, step by step
      float lw[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) lw[t] = s.w[t * kLdU + tid];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        acc += lw[t];
        s.w[t * kLdU + tid] = acc;
      }
    }
    __syncthreads();
    const float* L = s.w;
    const float* Lc = &s.w[(kChunk - 1) * kLdU];
    // the carried state's decay over the chunk, in both directions
    const float d0 = __expf(Lc[wr + g]), d1 = __expf(Lc[wr + g + 8]);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      hs[jn][0] *= d0;
      hs[jn][1] *= d0;
      hs[jn][2] *= d1;
      hs[jn][3] *= d1;
    }
    // step t's scale of row n: exp(L_c - L_t) for the state, exp(Lprev_t)
    // for the adjoint (both <= 1)
    auto scale = [&](int t, int n) {
      return fwd ? __expf(Lc[n] - L[t * kLdU + n])
                 : (t > 0 ? __expf(L[(t - 1) * kLdU + n]) : 1.f);
    };
    float hx[4][4];
    zero(hx);
    // A[n][k = t] = u[t][n] scale(t, n), B[k = t][m] = v[t][m]
    warp_mma_rolled<4>(
        hs, hx, 0, kChunk / 8,
        [&](int ks, float (&av)[4]) {
          const int t = 8 * ks + 2 * tig, n = wr + g;
          const float* u0 = &s.u[t * kLdU + n];
          av[0] = u0[0] * scale(t, n);
          av[1] = u0[8] * scale(t, n + 8);
          av[2] = u0[kLdU] * scale(t + 1, n);
          av[3] = u0[kLdU + 8] * scale(t + 1, n + 8);
        },
        [&](int ks, int jn, float (&bv)[2]) {
          const int t = 8 * ks + 2 * tig;
          bv[0] = s.v[t * kLdV + wc + 8 * jn + g];
          bv[1] = s.v[(t + 1) * kLdV + wc + 8 * jn + g];
        });
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[jn][i] += hx[jn][i];
    __syncthreads();            // the stage is refilled next
  }
  store(fwd ? nc : 0);
}

// --- the chunk-parallel kernel ----------------------------------------------

constexpr int kChunkThreads = 256;  // 8 warps
constexpr int kChunkBlocks = 2;     // blocks an SM
constexpr int kLd = 72;             // [t][n] and [n][m] rows: 64 + 8
constexpr int kLdA = 40;            // [32][32] rows: 32 + 8

// a diagonal sub-block's entries (t << 3 | s): the 28 with s < t, then the
// 8 with s = t (the forward's table)
constexpr int kDiagEntries = kSub * (kSub - 1) / 2 + kSub;
__constant__ unsigned char kDiagPairs[kDiagEntries] = {
    8, 16, 17, 24, 25, 26, 32, 33, 34, 35, 40, 41, 42, 43, 44, 48, 49, 50, 51,
    52, 53, 56, 57, 58, 59, 60, 61, 62, 0, 9, 18, 27, 36, 45, 54, 63};

struct ChunkSmem {
  float r[kChunk * kLd];
  float k[kChunk * kLd];
  float v[kChunk * kLd];
  float dy[kChunk * kLd];
  float L[kChunk * kLd];          // logw, then its inclusive cumsum
  float S[kDim * kLd];            // the chunk's start state [n][m]
  float G[kDim * kLd];            // the adjoint arriving at its end [n][m]
  float Bd[kChunk * kLdA];        // dy_t . v_s [t][s], s <= t
  float At[kChunk * kLdA];        // A transposed [s][t], zero where s > t
  float dr[kChunk * kLd];         // dr' [t][n]
  float dk[kChunk * kLd];         // dk' [s][n]
  float u[kDim];
  float qpart[2][kDim];           // sum_s k_s o exp(L_c - L_s) (G v_s), by
                                  // halves of the chunk's steps
};

// Phase 4's partial sums, over the (dead) At: by quarter of the chunk's
// steps, sum (r o dr' - k o dk') and sum r o k (v.dy); S . G row by row,
// by quarter of the columns
struct TailSmem {
  float part[4][kDim];
  float du[4][kDim];
  float sg[4][kDim];
};
static_assert(sizeof(TailSmem) <= sizeof(float) * kChunk * kLdA, "At");

__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
wkv6_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ logw,
                      const float* __restrict__ u,
                      const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ adj, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dlogw, float* __restrict__ du_part,
                      int T, int H, Strides sr, Strides sk, Strides sv,
                      Strides sw, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = j * kChunk, nt = min(kChunk, T - t0);
  const long long NN = kDim * kDim;
  const long long bh = (long long)b * H + h;
  const float* Sg = states + (bh * (nc + 1) + j) * NN;
  const float* Gg = adj + (bh * (nc + 1) + j + 1) * NN;
  // the outputs are contiguous (B, T, H, N): row t of this chunk and head
  const long long HN = (long long)H * kDim;
  const long long ob = ((long long)b * T + t0) * HN + (long long)h * kDim;

  // --- phase 0: stage the chunk (steps past T zero), S and G -------------
  auto stage = [&](float* dst, const float* src, Strides st) {
    src += b * st.b + h * st.h + t0 * st.t;
#pragma unroll 1
    for (int i = tid; i < kChunk * 16; i += kChunkThreads) {
      const int t = i >> 4, c = (i & 15) * 4;
      const bool in = t < nt;
      cp_async16(dst + t * kLd + c, src + (in ? t * st.t : 0) + c, in);
    }
  };
  stage(sm.r, r, sr);
  stage(sm.k, k, sk);
  stage(sm.v, v, sv);
  stage(sm.dy, dy, sd);
  stage(sm.L, logw, sw);
#pragma unroll 1
  for (int i = tid; i < kDim * 16; i += kChunkThreads) {
    const int n = i >> 4, c = (i & 15) * 4;
    cp_async16(sm.S + n * kLd + c, Sg + n * kDim + c, true);
    cp_async16(sm.G + n * kLd + c, Gg + n * kDim + c, true);
  }
  cp_async_commit();
  for (int i = tid; i < kChunk * kLdA; i += kChunkThreads) sm.At[i] = 0.f;
  if (tid < kDim) sm.u[tid] = u[(long long)h * kDim + tid];
  cp_async_wait<0>();
  __syncthreads();

  float* L = sm.L;
  // --- phase 1: L; Bd -------------------------------------------------------
  if (warp < 2) {
    // L: one column n a thread, summed step by step (never rising)
    float lw[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) lw[t] = L[t * kLd + tid];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      acc += lw[t];
      L[t * kLd + tid] = acc;
    }
  } else {
    // Bd = dy v^T (k = m), the six 16 x 8 tiles on or below the diagonal
    const int w = warp - 2;
    const int mt = w < 2 ? 0 : 1, ns = w < 2 ? w : w - 2;
    const int ra = 16 * mt + g, rb = ra + 8, s = 8 * ns + g;
    float d[1][4], x[1][4];
    zero(d);
    zero(x);
    warp_mma<1>(
        d, x, 0, kDim / 8,
        [&](int kk, float (&av)[4]) {
          const int m = 8 * kk + 2 * tig;
          const float2 a0 = ld2(&sm.dy[ra * kLd + m]);
          const float2 a1 = ld2(&sm.dy[rb * kLd + m]);
          av[0] = a0.x; av[1] = a1.x; av[2] = a0.y; av[3] = a1.y;
        },
        [&](int kk, int, float (&bv)[2]) {
          const float2 w2 = ld2(&sm.v[s * kLd + 8 * kk + 2 * tig]);
          bv[0] = w2.x; bv[1] = w2.y;
        });
    const int c = 8 * ns + 2 * tig;
    *reinterpret_cast<float2*>(&sm.Bd[ra * kLdA + c]) =
        make_float2(d[0][0] + x[0][0], d[0][1] + x[0][1]);
    *reinterpret_cast<float2*>(&sm.Bd[rb * kLdA + c]) =
        make_float2(d[0][2] + x[0][2], d[0][3] + x[0][3]);
  }
  __syncthreads();

  // --- phase 2: A; dr' and dk' within the sub-chunks ---------------------
  if (warp < 4) {
    // A between sub-chunks: its 16 x 8 tiles of columns s in sub-chunk i
    // and rows t > e = kSub i + kSub - 1, one a warp (at most four),
    // A[t, s] = (r_t o exp(L_{t-1} - L_e)) . (k_s o exp(L_e - L_s)) (k = n)
    int w = 0, i = 0, mt = 0, nt = 0;
#pragma unroll
    for (int ii = 0; ii < kNSub - 1; ++ii)
#pragma unroll
      for (int mm = (ii + 1) * kSub / 16; mm < 2; ++mm)
#pragma unroll
        for (int jj = 0; jj < kSub / 8; ++jj, ++w)
          if (w == warp) {
            i = ii;
            mt = mm;
            nt = jj;
          }
    if (warp < w) {
      const int e = kSub * i + kSub - 1;
      const int ra = 16 * mt + g, rb = ra + 8;
      const bool va = ra > e, vb = rb > e;
      const int s = kSub * i + 8 * nt + g;
      auto decayed_r = [&](bool ok, int t, int n, float2 le) {
        if (!ok) return make_float2(0.f, 0.f);
        const float2 rv = ld2(&sm.r[t * kLd + n]);
        const float2 lp = ld2(&L[(t - 1) * kLd + n]);
        return make_float2(rv.x * __expf(lp.x - le.x),
                           rv.y * __expf(lp.y - le.y));
      };
      float d[1][4], x[1][4];
      zero(d);
      zero(x);
      warp_mma<1>(
          d, x, 0, kDim / 8,
          [&](int kk, float (&av)[4]) {
            const int n = 8 * kk + 2 * tig;
            const float2 le = ld2(&L[e * kLd + n]);
            const float2 a0 = decayed_r(va, ra, n, le);
            const float2 a1 = decayed_r(vb, rb, n, le);
            av[0] = a0.x; av[1] = a1.x; av[2] = a0.y; av[3] = a1.y;
          },
          [&](int kk, int, float (&bv)[2]) {
            const int n = 8 * kk + 2 * tig;
            const float2 le = ld2(&L[e * kLd + n]);
            const float2 kv = ld2(&sm.k[s * kLd + n]);
            const float2 ls = ld2(&L[s * kLd + n]);
            bv[0] = kv.x * __expf(le.x - ls.x);
            bv[1] = kv.y * __expf(le.y - ls.y);
          });
      const int c = kSub * i + 8 * nt + 2 * tig;
      if (va) {
        sm.At[c * kLdA + ra] = d[0][0] + x[0][0];
        sm.At[(c + 1) * kLdA + ra] = d[0][1] + x[0][1];
      }
      if (vb) {
        sm.At[c * kLdA + rb] = d[0][2] + x[0][2];
        sm.At[(c + 1) * kLdA + rb] = d[0][3] + x[0][3];
      }
    }
  } else {
    // A within the sub-chunks, exact: 8 lanes an entry over n, 4 entries a
    // warp at a time, every sub-chunk's entries s < t and its bonus
    // entries s = t (kSub = 8: the table; otherwise every (t, s), those
    // with s > t skipped)
    const int lg = lane >> 3, li = lane & 7;
    constexpr int kEntries = kSub == 8 ? kDiagEntries : kSub * kSub;
    for (int base = 4 * (warp - 4); base < kNSub * kEntries; base += 16) {
      const int e = base + lg, blk = e / kEntries, ent = e % kEntries;
      int t, s;
      if constexpr (kSub == 8) {
        t = kDiagPairs[ent] >> 3;
        s = kDiagPairs[ent] & 7;
      } else {
        t = ent / kSub;
        s = ent % kSub;
      }
      const bool ok = e < kNSub * kEntries && s <= t;
      t += kSub * blk;
      s += kSub * blk;
      float acc = 0.f;
      if (ok && s < t) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {       // n = 4 li + 32 q + (0..3)
          const int n = 4 * li + 32 * q;
          const float4 rv = ld4(&sm.r[t * kLd + n]);
          const float4 kv = ld4(&sm.k[s * kLd + n]);
          const float4 pv = ld4(&L[(t - 1) * kLd + n]);
          const float4 lv = ld4(&L[s * kLd + n]);
          acc += rv.x * kv.x * __expf(pv.x - lv.x) +
                 rv.y * kv.y * __expf(pv.y - lv.y) +
                 rv.z * kv.z * __expf(pv.z - lv.z) +
                 rv.w * kv.w * __expf(pv.w - lv.w);
        }
      } else if (ok) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = 4 * li + 32 * q;
          const float4 rv = ld4(&sm.r[t * kLd + n]);
          const float4 kv = ld4(&sm.k[t * kLd + n]);
          const float4 uv = ld4(&sm.u[n]);
          acc += rv.x * uv.x * kv.x + rv.y * uv.y * kv.y +
                 rv.z * uv.z * kv.z + rv.w * uv.w * kv.w;
        }
      }
      acc += __shfl_xor_sync(kAll, acc, 4);
      acc += __shfl_xor_sync(kAll, acc, 2);
      acc += __shfl_xor_sync(kAll, acc, 1);
      if (ok && li == 0) sm.At[s * kLdA + t] = acc;
    }
  }
  if (tid < kNSub * kDim) {
    // dr' and dk' within sub-chunk i, exact, thread (i, n): D[t, s] =
    // exp(L_{t-1} - L_s) once a pair, for both
    const int i = tid / kDim, n = tid % kDim, tb = kSub * i;
    float dkv[kSub];
#pragma unroll
    for (int c = 0; c < kSub; ++c) dkv[c] = 0.f;
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const float rt = sm.r[(tb + a) * kLd + n];
      const float lp = a > 0 ? L[(tb + a - 1) * kLd + n] : 0.f;
      float dra = 0.f;
#pragma unroll
      for (int c = 0; c < a; ++c) {
        const float w = sm.Bd[(tb + a) * kLdA + tb + c] *
                        __expf(lp - L[(tb + c) * kLd + n]);
        dra = fmaf(w, sm.k[(tb + c) * kLd + n], dra);
        dkv[c] = fmaf(w, rt, dkv[c]);
      }
      sm.dr[(tb + a) * kLd + n] = dra;
    }
#pragma unroll
    for (int c = 0; c < kSub; ++c) sm.dk[(tb + c) * kLd + n] = dkv[c];
  }
  __syncthreads();

  // --- phase 3: dv, dr', dk' (warp: rows 16 mt .. +15, columns c0 .. +15) --
  {
    const int mt = warp & 1, c0 = 16 * (warp >> 1);
    const int ra = 16 * mt + g, rb = ra + 8;
    const float* Lc = &L[(kChunk - 1) * kLd];
    float d[2][4], x[2][4], res[2][4];
    auto row = [&](int i) { return i < 2 ? ra : rb; };
    auto col = [&](int j2, int i) { return c0 + 8 * j2 + 2 * tig + (i & 1); };
    // the own sub-chunk's part (phase 2) plus res, written back in place
    auto add_into = [&](float* dst) {
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          float2* p = reinterpret_cast<float2*>(
              &dst[(r2 == 0 ? ra : rb) * kLd + c0 + 8 * j2 + 2 * tig]);
          const float2 o = *p;
          *p = make_float2(o.x + res[j2][2 * r2], o.y + res[j2][2 * r2 + 1]);
        }
    };
    // this warp's rows of A, dy, v as the A operand (k pairs 2 tig, 2 tig + 1)
    auto rows_of = [&](const float* m, int ld) {
      return [=](int kk, float (&av)[4]) {
        const int c = 8 * kk + 2 * tig;
        const float2 a0 = ld2(&m[ra * ld + c]);
        const float2 a1 = ld2(&m[rb * ld + c]);
        av[0] = a0.x; av[1] = a1.x; av[2] = a0.y; av[3] = a1.y;
      };
    };

    // dv = A^T dy (k = t >= s) + (k o exp(L_c - L)) G (k = n)
    zero(d);
    zero(x);
    warp_mma<2>(d, x, 2 * mt, kChunk / 8, rows_of(sm.At, kLdA),
                [&](int kk, int j2, float (&bv)[2]) {
                  const int t = 8 * kk + 2 * tig, m = c0 + 8 * j2 + g;
                  bv[0] = sm.dy[t * kLd + m];
                  bv[1] = sm.dy[(t + 1) * kLd + m];
                });
    warp_mma<2>(
        d, x, 0, kDim / 8,
        [&](int kk, float (&av)[4]) {
          const int n = 8 * kk + 2 * tig;
          const float2 lc = ld2(&Lc[n]);
          const float2 k0 = ld2(&sm.k[ra * kLd + n]);
          const float2 k1 = ld2(&sm.k[rb * kLd + n]);
          const float2 l0 = ld2(&L[ra * kLd + n]);
          const float2 l1 = ld2(&L[rb * kLd + n]);
          av[0] = k0.x * __expf(lc.x - l0.x);
          av[1] = k1.x * __expf(lc.x - l1.x);
          av[2] = k0.y * __expf(lc.y - l0.y);
          av[3] = k1.y * __expf(lc.y - l1.y);
        },
        [&](int kk, int j2, float (&bv)[2]) {
          const int n = 8 * kk + 2 * tig, m = c0 + 8 * j2 + g;
          bv[0] = sm.G[n * kLd + m];
          bv[1] = sm.G[(n + 1) * kLd + m];
        });
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int t = r2 == 0 ? ra : rb;
        if (t < nt)
          *reinterpret_cast<float2*>(dv + ob + t * HN + c0 + 8 * j2 +
                                     2 * tig) =
              make_float2(d[j2][2 * r2] + x[j2][2 * r2],
                          d[j2][2 * r2 + 1] + x[j2][2 * r2 + 1]);
      }

    // dr' = exp(Lprev) o (S dy_t) (k = m) ...
    zero(d);
    zero(x);
    warp_mma<2>(d, x, 0, kDim / 8, rows_of(sm.dy, kLd),
                [&](int kk, int j2, float (&bv)[2]) {
                  const float2 w2 = ld2(&sm.S[(c0 + 8 * j2 + g) * kLd +
                                              8 * kk + 2 * tig]);
                  bv[0] = w2.x; bv[1] = w2.y;
                });
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = row(i), n = col(j2, i);
        const float lp = t > 0 ? L[(t - 1) * kLd + n] : 0.f;
        res[j2][i] = (d[j2][i] + x[j2][i]) * __expf(lp);
      }
    // ... + for t in sub-chunk q >= 1, b = kSub q - 1: exp(L_{t-1} - L_b)
    // o sum_{s <= b} Bd[t, s] (k_s o exp(L_b - L_s)) (k = s); where this
    // warp's rows ra and rb lie in two sub-chunks they take turns, the
    // other's A rows zero
    zero(d);
    zero(x);
    const int qa = ra / kSub, qb = rb / kSub;
#pragma unroll 1
    for (int p = max(qa, 1); p <= qb; ++p) {
      const int bq = kSub * p - 1;
      const bool ua = p == qa, ub = p == qb;
      warp_mma<2>(
          d, x, 0, kSub * p / 8,
          [&](int kk, float (&av)[4]) {
            const int s = 8 * kk + 2 * tig;
            const float2 z = make_float2(0.f, 0.f);
            const float2 a0 = ua ? ld2(&sm.Bd[ra * kLdA + s]) : z;
            const float2 a1 = ub ? ld2(&sm.Bd[rb * kLdA + s]) : z;
            av[0] = a0.x; av[1] = a1.x; av[2] = a0.y; av[3] = a1.y;
          },
          [&](int kk, int j2, float (&bv)[2]) {
            const int s = 8 * kk + 2 * tig, n = c0 + 8 * j2 + g;
            const float lb = L[bq * kLd + n];
            bv[0] = sm.k[s * kLd + n] * __expf(lb - L[s * kLd + n]);
            bv[1] = sm.k[(s + 1) * kLd + n] *
                    __expf(lb - L[(s + 1) * kLd + n]);
          });
    }
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = row(i), n = col(j2, i), q = t / kSub;
        if (q > 0)
          res[j2][i] += (d[j2][i] + x[j2][i]) *
                        __expf(L[(t - 1) * kLd + n] -
                               L[(kSub * q - 1) * kLd + n]);
      }
    add_into(sm.dr);

    // dk' = exp(L_c - L_s) o (G v_s) (k = m) ...
    zero(d);
    zero(x);
    warp_mma<2>(d, x, 0, kDim / 8, rows_of(sm.v, kLd),
                [&](int kk, int j2, float (&bv)[2]) {
                  const float2 w2 = ld2(&sm.G[(c0 + 8 * j2 + g) * kLd +
                                              8 * kk + 2 * tig]);
                  bv[0] = w2.x; bv[1] = w2.y;
                });
    // ... and Q_end's part sum_s k_s o (that state term), by half of the
    // steps (mt): this warp's rows, then its lanes g, summed in turn
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      float q[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = row(i), n = col(j2, i);
        res[j2][i] = (d[j2][i] + x[j2][i]) * __expf(Lc[n] - L[s * kLd + n]);
        q[i & 1] = fmaf(sm.k[s * kLd + n], res[j2][i], q[i & 1]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        q[0] += __shfl_xor_sync(kAll, q[0], off);
        q[1] += __shfl_xor_sync(kAll, q[1], off);
      }
      if (g == 0) {
        sm.qpart[mt][col(j2, 0)] = q[0];
        sm.qpart[mt][col(j2, 1)] = q[1];
      }
    }
    // ... + for s in sub-chunk i < kNSub - 1, e = kSub i + kSub - 1:
    // exp(L_e - L_s) o sum_{t > e} Bd[t, s] (r_t o exp(L_{t-1} - L_e))
    // (k = t), the rows' sub-chunks in turns as above
    zero(d);
    zero(x);
    const int ia = ra / kSub, ib = rb / kSub;
#pragma unroll 1
    for (int p = ia; p <= min(ib, kNSub - 2); ++p) {
      const int e = kSub * p + kSub - 1;
      const bool ua = p == ia, ub = p == ib;
      warp_mma<2>(
          d, x, kSub * (p + 1) / 8, kChunk / 8,
          [&](int kk, float (&av)[4]) {
            const int t = 8 * kk + 2 * tig;
            av[0] = ua ? sm.Bd[t * kLdA + ra] : 0.f;
            av[1] = ub ? sm.Bd[t * kLdA + rb] : 0.f;
            av[2] = ua ? sm.Bd[(t + 1) * kLdA + ra] : 0.f;
            av[3] = ub ? sm.Bd[(t + 1) * kLdA + rb] : 0.f;
          },
          [&](int kk, int j2, float (&bv)[2]) {
            const int t = 8 * kk + 2 * tig, n = c0 + 8 * j2 + g;
            const float le = L[e * kLd + n];
            bv[0] = sm.r[t * kLd + n] * __expf(L[(t - 1) * kLd + n] - le);
            bv[1] = sm.r[(t + 1) * kLd + n] * __expf(L[t * kLd + n] - le);
          });
    }
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = row(i), n = col(j2, i), si = s / kSub;
        if (si < kNSub - 1)
          res[j2][i] += (d[j2][i] + x[j2][i]) *
                        __expf(L[(kSub * si + kSub - 1) * kLd + n] -
                               L[s * kLd + n]);
      }
    add_into(sm.dk);
  }
  __syncthreads();

  // --- phase 4: dlogw and du, dr and dk ------------------------------------
  // dlogw_t = Q_end + sum_{tau > t} r o dr' - sum_{tau >= t} k o dk', with
  // Q_end = S' . G = exp(L_c) o (S . G) + sum_s k_s o exp(L_c - L_s) (G v_s)
  // (S' = exp(L_c) o S + (k o exp(L_c - L))^T v, so S' is never read).
  // Thread (quarter qt of the steps, n): its 8 steps' sums, then the later
  // quarters' sums in a fixed order, then its steps backward.
  {
    TailSmem& tl = *reinterpret_cast<TailSmem*>(sm.At);
    const int qt = tid >> 6, n = tid & 63, tb = 8 * qt;
    float rd[8], kd[8], part = 0.f, du = 0.f, sg = 0.f;
#pragma unroll
    for (int m = 0; m < 16; ++m) {      // S[n] . G[n] over 16 columns
      const int c = 16 * qt + ((m + n) & 15);
      sg = fmaf(sm.S[n * kLd + c], sm.G[n * kLd + c], sg);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int t = tb + a;
      const float rt = sm.r[t * kLd + n], kt = sm.k[t * kLd + n];
      rd[a] = rt * sm.dr[t * kLd + n];
      kd[a] = kt * sm.dk[t * kLd + n];
      part += rd[a] - kd[a];
      du = fmaf(rt * kt, sm.Bd[t * kLdA + t], du);
    }
    tl.part[qt][n] = part;
    tl.du[qt][n] = du;
    tl.sg[qt][n] = sg;
    __syncthreads();
    float acc = __expf(L[(kChunk - 1) * kLd + n]) *
                    (tl.sg[0][n] + tl.sg[1][n] + tl.sg[2][n] + tl.sg[3][n]) +
                sm.qpart[0][n] + sm.qpart[1][n];
    for (int q = 3; q > qt; --q) acc += tl.part[q][n];
#pragma unroll
    for (int a = 7; a >= 0; --a) {
      acc -= kd[a];
      if (tb + a < nt) dlogw[ob + (tb + a) * HN + n] = acc;
      acc += rd[a];
    }
    if (qt == 0)
      du_part[(((long long)b * nc + j) * H + h) * kDim + n] =
          tl.du[0][n] + tl.du[1][n] + tl.du[2][n] + tl.du[3][n];
  }
  for (int i = tid; i < kChunk * 16; i += kChunkThreads) {
    const int t = i >> 4, n = 4 * (i & 15);
    if (t >= nt) continue;
    const float vdy = sm.Bd[t * kLdA + t];
    const float4 rv = ld4(&sm.r[t * kLd + n]), kv = ld4(&sm.k[t * kLd + n]);
    const float4 uv = ld4(&sm.u[n]);
    const float4 a = ld4(&sm.dr[t * kLd + n]), c = ld4(&sm.dk[t * kLd + n]);
    *reinterpret_cast<float4*>(dr + ob + t * HN + n) = make_float4(
        a.x + uv.x * kv.x * vdy, a.y + uv.y * kv.y * vdy,
        a.z + uv.z * kv.z * vdy, a.w + uv.w * kv.w * vdy);
    *reinterpret_cast<float4*>(dk + ob + t * HN + n) = make_float4(
        c.x + rv.x * uv.x * vdy, c.y + rv.y * uv.y * vdy,
        c.z + rv.z * uv.z * vdy, c.w + rv.w * uv.w * vdy);
  }
}

}  // namespace

// r, k, v, logw, dy (B,T,H,N) through (batch, step, head) strides; u (H,N),
// s0 and dsT (B,H,N,N; dsT null for zero), contiguous; states (B,H,nc+1,N,N)
// scratch; dr, dk, dv, dlogw (B,T,H,N) contiguous.  tc: the tensor-core
// route (N = 64, every row of r, k, v, logw and dy 16-byte aligned): adj
// (B,H,nc+1,N,N) scratch (adj[:, :, 0] is ds0 on return), du_part
// (B,nc,H,N), ds0 unused.  Otherwise the CUDA-core route: adj unused,
// du_part (B,1,H,N), ds0 (B,H,N,N).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* states,
                        void* adj, void* dr, void* dk, void* dv, void* dlogw,
                        void* du_part, void* ds0, int B, int T, int H, int N,
                        long long r_sb, long long r_st, long long r_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long w_sb, long long w_st, long long w_sh,
                        long long d_sb, long long d_st, long long d_sh, int tc,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN || (tc && N != kDim) ||
      B > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // raise the dynamic shared-memory caps
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_floats(kMaxN) * sizeof(float)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(2 * sizeof(ScanStage)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(ChunkSmem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides rs{r_sb, r_st, r_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, ws{w_sb, w_st, w_sh}, ds{d_sb, d_st, d_sh};
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(logw),
              *up = static_cast<const float*>(u),
              *s0p = static_cast<const float*>(s0),
              *dyp = static_cast<const float*>(dy),
              *dsTp = static_cast<const float*>(dsT);
  float *stp = static_cast<float*>(states), *drp = static_cast<float*>(dr),
        *dkp = static_cast<float*>(dk), *dvp = static_cast<float*>(dv),
        *dwp = static_cast<float*>(dlogw),
        *dup = static_cast<float*>(du_part);
  if (tc) {
    const int nc = (T + kChunk - 1) / kChunk;
    float* adjp = static_cast<float*>(adj);
    wkv6_bwd_scan_kernel<<<dim3(kDim / kScanRows, H, 2 * B), kScanThreads,
                           2 * sizeof(ScanStage), s>>>(
        rp, kp, vp, wp, dyp, s0p, dsTp, stp, adjp, T, H, rs, ks, vs, ws, ds);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv6_bwd_chunk_kernel<<<dim3(nc, H, B), kChunkThreads, sizeof(ChunkSmem),
                            s>>>(rp, kp, vp, wp, up, dyp, stp, adjp, drp, dkp,
                                 dvp, dwp, dup, T, H, rs, ks, vs, ws, ds);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 sgrid((N + kTile - 1) / kTile, H, B);
  wkv6_states_kernel<<<sgrid, kStThreads, states_smem_floats(N) * sizeof(float),
                       s>>>(kp, vp, wp, s0p, stp, T, H, N, ks, vs, ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_kernel<<<dim3(H, B), kThreads, bwd_smem_floats(N) * sizeof(float),
                    s>>>(rp, kp, vp, wp, up, dyp, dsTp, stp, drp, dkp, dvp,
                         dwp, dup, static_cast<float*>(ds0), T, H, N, rs, ks,
                         vs, ws, ds);
  return static_cast<int>(cudaGetLastError());
}
