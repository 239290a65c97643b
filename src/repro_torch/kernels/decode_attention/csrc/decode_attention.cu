// Flash-decode for Hopper (sm_90a), CUDA C++ with a plain C interface
// loaded through ctypes (see repro_torch/kernels/common.py).  Two entries
// share one split kernel and one combine kernel:
//
//  * decode_attention_fwd (K2) replaces
//    src/repro/kernels/decode_attention/kernel.py::decode_attention_bkgd
//    (the Pallas TPU kernel; pl.pallas_call at kernel.py:87): the cache is
//    one contiguous layer per row.
//  * paged_decode_attention_fwd (K3) replaces
//    src/repro/kernels/decode_attention/kernel.py::decode_attention_paged_bkgd
//    (pl.pallas_call at kernel.py:202): key t of row b lives in physical
//    page page_table[b, t / ps] of a shared page pool, at offset t % ps.
//
// What it computes (the same function as the TPU kernels): one query token
// per row against that row's KV cache, GQA (query head h reads KV head
// h / G), online softmax over the row's lengths[b] valid keys (clamped to
// Smax, which is MP * ps for the paged pool), optionally only keys with
// kpos > lengths[b] - 1 - window.  Scores are scaled by 1/sqrt(head_dim); m,
// l and the accumulator are fp32, and P stays fp32 for P.V (as in the TPU
// kernels; the plain versions round P to the cache dtype first).  A row with
// no valid key produces zeros.
//
// Layout: q (B,H,hd) and o (B,H,hd) through (batch, head) element strides.
// K2's cache layer k/v (B,Smax,K,hd) is read through (batch, position,
// head) strides, so a layer view of the stacked (L,B,Smax,K,hd) cache is
// read where it lies, with no transpose and no padding copy (the TPU wrapper
// moved the head axis and padded Smax on every call).  K3's pool layer
// k/v_pages (P,ps,K,hd) is read through (page, position, head) strides in
// the same way (the TPU wrapper transposed the whole pool to (P,K,ps,hd) on
// every call); page_table (B,MP) is int32 and contiguous, and page 0 is the
// dump page that vacant rows point at.  Page offsets are 64-bit.  The last
// dimension must be contiguous.  fp32 and bf16; q, k and v share one dtype
// and o has q's dtype.
//
// What bounds it on an H100: one decode tick reads every valid K/V byte of
// the layer once and does 4*hd FLOP per (query head, key), i.e. 2*G FLOP
// per K/V byte read at bf16: 16 for yi-9b's G=8, far below the ~295 FLOP
// per byte where the tensor cores rather than device memory would bind.
// So the bound is the K/V bytes (plus K3's table) over 3.35 TB/s.  What the
// design does about it:
//  * Each K/V row is loaded from device memory exactly once, by one warp,
//    into registers, and used there for all the G query heads of its KV
//    head (no shared-memory staging is needed for reuse across heads).
//  * The KV axis is split over blocks: at serving shapes a (B,K) grid is
//    32 blocks on 132 SMs (yi-9b, B=8), so the wrapper picks `nsplit`
//    splits per (row, KV head) to put a few blocks on every SM, and a
//    second small kernel combines the splits' (m, l, acc) partials.
//  * Inside a block, 4 warps take interleaved steps of 4 keys each, so
//    every warp keeps 8 row loads in flight (loaded as raw words with no
//    branch and converted after the last one, see Span).  A lane owns
//    HD_PAD/32 consecutive head dims of q, of each K/V row and of the
//    accumulators; a q.k dot product is reduced across the warp with shuffles.  The
//    warps' partial states are merged in shared memory at the end.
//  * K3 differs from K2 only in how a key row is addressed (the KV
//    template parameter of the split kernel).  A block first copies its
//    split's page-table entries into shared memory (chunk / ps ints), so
//    a key's page is one shared load.  The wrapper starts every split on
//    a page boundary and, at ps = 16, uses K2's split plan unchanged, so
//    K3 walks the same keys in the same order as K2 and its output on a
//    pool equals K2's on the gathered cache bit for bit.
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
// K3 stages a split's table entries in dynamic shared memory: at most this
// many (32 KB; with the split kernel's 16.6 KB of static shared memory the
// block stays under the 48 KB a launch gets without opting in).
constexpr int kMaxSplitPages = 8192;

// Element strides of a cache layer: (batch row, position, head) for K2's
// (B,Smax,K,hd) layer; (page, position in page, head) for K3's (P,ps,K,hd)
// pool layer.
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

// VEC consecutive elements at p + d0 (a lane's head dims of q) as
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

// How the split kernel finds key/value row t of (batch row b, KV head kh).
// at(b, kh, first, last, smem) is called by every thread of the block
// before q is loaded (a __syncthreads follows) and returns a cursor whose
// rows(t, kr, vr) gives key t's two row pointers, first <= t <= last.

// K2: a contiguous cache layer, row t at base + b*sb + t*ss + kh*sh.
template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  Strides ks, vs;
  struct Cursor {
    const T* kb;
    const T* vb;
    long long kss, vss;
    __device__ __forceinline__ void rows(int t, const T*& kr, const T*& vr) {
      kr = kb + (long long)t * kss;
      vr = vb + (long long)t * vss;
    }
  };
  __device__ __forceinline__ Cursor at(int b, int kh, int, int, int*) const {
    return {k + b * ks.b + kh * ks.h, v + b * vs.b + kh * vs.h, ks.s, vs.s};
  }
};

// K3: a page pool layer, row t at pool + table[b, t/ps]*sp + (t%ps)*ss +
// kh*sh.  at() stages the split's table entries in shared memory, so a
// key's page is one shared load; t / ps is a multiply-high by a magic
// number (exact for t < 2^31).
__device__ __forceinline__ int div_magic(int t, unsigned magic,
                                         unsigned shift) {
  return (int)((__umulhi((unsigned)t, magic) + (unsigned)t) >> shift);
}

template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  Strides ks, vs;
  const int* table;       // (B, MP) int32, contiguous
  int MP, ps;
  unsigned magic, shift;  // t / ps == div_magic(t, magic, shift)
  struct Cursor {
    const T* kb;
    const T* vb;
    const int* pages;     // shared: table[b, p_lo ..]
    long long ksp, kss, vsp, vss;
    int ps, p_lo;
    unsigned magic, shift;
    __device__ __forceinline__ void rows(int t, const T*& kr, const T*& vr) {
      const int p = div_magic(t, magic, shift);
      const long long pg = pages[p - p_lo];
      const long long o = t - p * ps;
      kr = kb + pg * ksp + o * kss;
      vr = vb + pg * vsp + o * vss;
    }
  };
  __device__ __forceinline__ Cursor at(int b, int kh, int first, int last,
                                       int* smem) const {
    const int p_lo = div_magic(first, magic, shift);
    const int n = last >= first ?                            // empty split
        div_magic(last, magic, shift) - p_lo + 1 : 0;
    const int* trow = table + (long long)b * MP;
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = trow[p_lo + i];
    return {k + kh * ks.h, v + kh * vs.h, smem, ks.b, ks.s, vs.b, vs.s, ps,
            p_lo, magic, shift};
  }
};

// A lane's span of one K/V row as raw words, loaded without a branch (a
// lane past hd reads the row's first span and is zeroed when converted),
// so that the compiler keeps all of a step's row loads in flight before
// any conversion waits on one.  (With load_dims' branch, K3's address
// arithmetic made the compiler put each load and its conversion in a
// block of its own: eight memory latencies a step in a row.)
template <typename T, int VEC>
struct Span {
  static constexpr int BYTES = VEC * (int)sizeof(T);
  static constexpr int CH = BYTES < 16 ? BYTES : 16;
  static constexpr int N = BYTES / CH;
  static constexpr int PER = CH / (int)sizeof(T);
  using C = typename Chunk<CH>::type;
  C c[N];
  __device__ __forceinline__ void load(const T* p, int d0, int hd) {
    const C* src = reinterpret_cast<const C*>(p + (d0 < hd ? d0 : 0));
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = src[i];
  }
  __device__ __forceinline__ void to_floats(bool valid,
                                            float (&out)[VEC]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T* e = reinterpret_cast<const T*>(&c[i]);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        out[i * PER + j] = valid ? to_float(e[j]) : 0.f;
    }
  }
};

// One block per (KV split, KV head x head group, batch row).  The block's
// GB query heads are g0 .. g0+GB-1 of KV head kh (those >= G are padding).
// Writes the split's unnormalised accumulator to part_acc (B,H,nsplit,hd)
// and its (max, sum) to part_ml (B,H,nsplit,2).
template <typename T, int HD_PAD, int GB, typename KV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_split_kernel(const T* __restrict__ q, KV kv,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Smax, int H, int G, int hd, int ngroups, int chunk,
                    int nsplit, int window, float scale, long long q_sb,
                    long long q_sh) {
  constexpr int VEC = HD_PAD / 32;
  constexpr int U = kKeysPerStep;
  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ __align__(16) float sm_acc[kWarps][GB][HD_PAD];
  extern __shared__ int sm_pages[];     // K3: the split's table entries

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

  typename KV::Cursor cur = kv.at(b, kh, begin, end - 1, sm_pages);
  __syncthreads();

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

  for (int j0 = begin + warp * U; j0 < end; j0 += kWarps * U) {
    Span<T, VEC> kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(j0 + u, end - 1);   // past the end: a valid row, unused
      const T* krow;
      const T* vrow;
      cur.rows(j, krow, vrow);
      kraw[u].load(krow, d0, hd);
      vraw[u].load(vrow, d0, hd);
    }
    float kr[U][VEC];
    float vr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kraw[u].to_floats(d0 < hd, kr[u]);
      vraw[u].to_floats(d0 < hd, vr[u]);
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

// The arguments both entries share.
struct Common {
  int smem_pages;     // K3: table entries a split stages (chunk / ps)
  const void* q;
  void* o;
  const int* lengths;
  float* part_acc;
  float* part_ml;
  int B, Smax, H, K, hd;
  long long q_sb, q_sh, o_sb, o_sh;
  int nsplit, chunk, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD_PAD, int GB, typename KV>
cudaError_t launch(const Common& a, KV kv) {
  const int G = a.H / a.K;
  const int ngroups = (G + GB - 1) / GB;
  const dim3 grid(a.nsplit, a.K * ngroups, a.B);
  decode_split_kernel<T, HD_PAD, GB, KV>
      <<<grid, kThreads, a.smem_pages * sizeof(int), a.stream>>>(
      static_cast<const T*>(a.q), kv, a.lengths, a.part_acc, a.part_ml,
      a.Smax, a.H, G, a.hd, ngroups, a.chunk, a.nsplit, a.window, a.scale,
      a.q_sb, a.q_sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<dim3(a.H, a.B), kCombineThreads,
                             a.nsplit * sizeof(float), a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.o), a.H, a.hd, a.nsplit,
      a.o_sb, a.o_sh);
  return cudaGetLastError();
}

template <typename T, int HD_PAD, typename KV>
cudaError_t dispatch_gb(int gb, const Common& a, KV kv) {
  switch (gb) {
    case 1: return launch<T, HD_PAD, 1>(a, kv);
    case 2: return launch<T, HD_PAD, 2>(a, kv);
    case 4: return launch<T, HD_PAD, 4>(a, kv);
    default:
      if constexpr (HD_PAD <= 128) {
        return launch<T, HD_PAD, 8>(a, kv);
      }
  }
  return cudaErrorInvalidValue;   // 8 heads per block only up to hd 128
}

template <typename T, typename KV>
cudaError_t dispatch_hd(int gb, const Common& a, KV kv) {
  if (a.hd <= 32) return dispatch_gb<T, 32>(gb, a, kv);
  if (a.hd <= 64) return dispatch_gb<T, 64>(gb, a, kv);
  if (a.hd <= 128) return dispatch_gb<T, 128>(gb, a, kv);
  return dispatch_gb<T, 256>(gb, a, kv);
}

bool bad_common(const Common& a) {
  return a.B < 1 || a.Smax < 1 || a.K < 1 || a.H % a.K != 0 || a.hd < 1 ||
         a.hd > 256 || a.nsplit < 1 || a.chunk < 1 ||
         (long long)a.nsplit * a.chunk < a.Smax;
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
  const Common a{0, q, o, lengths, part_acc, part_ml, B, Smax, H, K, hd,
                 q_sb, q_sh, o_sb, o_sh, nsplit, chunk, window, scale,
                 static_cast<cudaStream_t>(stream)};
  if (bad_common(a)) return (int)cudaErrorInvalidValue;
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(gb, a, ContigKV<float>{
        static_cast<const float*>(k), static_cast<const float*>(v), ks, vs});
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(gb, a, ContigKV<__nv_bfloat16>{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ks, vs});
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// K3.  As decode_attention_fwd, with k/v the pool layer (P,ps,K,hd) through
// (page, position, head) strides, page_table (B,MP) int32 contiguous, and
// Smax = MP * ps.  `chunk` must be a multiple of ps (every split starts on a
// page boundary) and chunk / ps at most kMaxSplitPages.  Every table entry
// must be a page of the pool.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* page_table, const int* lengths, float* part_acc,
    float* part_ml, int dtype, int B, int MP, int ps, int H, int K, int hd,
    long long q_sb, long long q_sh, long long k_sp, long long k_ss,
    long long k_sh, long long v_sp, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int nsplit, int chunk, int gb, int window,
    float scale, void* stream) {
  const Common a{ps > 0 ? chunk / ps : 0, q, o, lengths, part_acc, part_ml,
                 B, MP * ps, H, K, hd, q_sb, q_sh, o_sb, o_sh, nsplit, chunk,
                 window, scale, static_cast<cudaStream_t>(stream)};
  if (MP < 1 || ps < 1 || bad_common(a) || chunk % ps != 0 ||
      a.smem_pages > kMaxSplitPages)
    return (int)cudaErrorInvalidValue;
  unsigned shift = 0;                   // ceil(log2(ps))
  while ((1u << shift) < (unsigned)ps) ++shift;
  const unsigned magic = (unsigned)(
      ((1ull << 32) * ((1ull << shift) - ps)) / ps + 1);
  const Strides ks{k_sp, k_ss, k_sh}, vs{v_sp, v_ss, v_sh};
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(gb, a, PagedKV<float>{
        static_cast<const float*>(k), static_cast<const float*>(v), ks, vs,
        page_table, MP, ps, magic, shift});
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(gb, a, PagedKV<__nv_bfloat16>{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ks, vs, page_table, MP, ps,
        magic, shift});
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
