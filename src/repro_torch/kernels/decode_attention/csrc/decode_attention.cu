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
// l and the accumulator are fp32.  Both kernels keep P at fp32 precision,
// as the TPU kernels do (kernel.py:59-63 and :150-154, an f32 dot_general):
// the CUDA-core kernel multiplies fp32 P by V; the tensor-core kernel takes
// the unnormalised P as a bf16 hi part and a bf16 lo part (P - hi), two
// products a tile (pack_bf16_split, as K1's P V), which comes within about
// 2^-16 of fp32 P where hi alone would round every p to 8 bits.  (The plain
// versions round the normalised P to the cache dtype.)  A row with no valid
// key produces zeros.
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
// dimension must be contiguous.  q and o share one dtype; the cache (k and
// v) takes q's dtype (fp32 or bf16) or, with a bf16 q, float8 e4m3fn (the
// fp8 KV cache; the TPU kernels take it through k_ref[...].astype(float32),
// kernel.py:42-44 and :135-137).  An e4m3fn value converts to bf16 exactly
// (subnormals and NaN included), so K2 on an e4m3 cache computes what it
// computes on the bf16 copy of that cache, bit for bit.
//
// What bounds it on an H100: one decode tick reads every valid K/V byte of
// the layer once and does 4*hd FLOP per (query head, key), i.e. 2*G FLOP
// per K/V byte read at bf16: 16 for yi-9b's G=8, far below the ~295 FLOP
// per byte where the tensor cores rather than device memory would bind.
// So the bound is the K/V bytes (plus K3's table) over 3.35 TB/s: 0.16 ms
// at 32k keys for yi-9b's B=8.  Reaching it takes some 40-60 KB of loads
// in flight on every SM and little issue work per byte.  What the design
// does about it (the tensor-core kernel, decode_split_mma_kernel, for bf16
// at head_dim 32-128, which the model always runs):
//  * The G query heads of a KV head are the rows of one mma.sync m16n8k16
//    A tile (padded to 16), so one block serves the whole group, each K/V
//    row is read from device memory once, and both products run on tensor
//    cores: no per-key warp reductions (the CUDA-core kernel spends five
//    shuffles per key and head on its q.k sums, about 40 per key at G=8,
//    which alone exceeds the bound at 32k keys).
//  * Each warp streams its own 16-key tiles through a 3-stage ring of
//    16-byte cp.async copies in shared memory (padded rows, so ldmatrix is
//    conflict-free), keeping two tiles (17 KB at hd 128) in flight while it
//    computes one; two blocks of four warps per SM hold some 140 KB in
//    flight.
//  * The KV axis is split over blocks: at serving shapes a (B,K) grid is
//    32 blocks on 132 SMs (yi-9b, B=8), so the wrapper picks `nsplit`
//    splits per (row, KV head) to fill one wave of two blocks per SM, and
//    a second small kernel combines the splits' (m, l, acc) partials.
//  * K3 differs from K2 only in how a key row is addressed (the KV
//    template parameter of the split kernels).  A block first copies its
//    split's page-table entries into shared memory (chunk / ps ints), so
//    a key's page is one shared load.  The wrapper starts every split on
//    a page boundary and, at ps = 16, uses K2's split plan unchanged, so
//    K3 walks the same keys in the same order as K2 and its output on a
//    pool equals K2's on the gathered cache bit for bit.
// The CUDA-core kernel (decode_split_kernel) serves fp32 caches, hd 256,
// G > 16 and rows not 16-byte aligned: 4 warps take interleaved steps of 4
// keys, a lane owns HD_PAD/32 head dims, and a q.k dot product is reduced
// across the warp with shuffles.  TMA is not used: a paged row is found
// through the page table, one 16-key tile at a time.
// The e4m3 cache halves the bytes, and so the bound (0.080 ms at 32k keys
// for yi-9b's B=8).  Both kernels take it: the CUDA-core kernel converts a
// lane's span of each row to floats as it loads it; the tensor-core kernel
// keeps its cp.async ring, now of e4m3 rows (a 16-byte copy holds 16 of a
// key's dims), and each warp converts a tile it has received into a bf16
// staging tile in shared memory (cvt.rn.f16x2.e4m3x2, then to bf16: both
// exact), from which the bf16 fragments are loaded by ldmatrix as before
// (ldmatrix on sm_90 moves 16-bit elements only).  The products stay bf16
// mma.sync: an fp16 product would round q.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
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
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
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
struct Chunk<1> { using type = unsigned char; };
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
// and its (max, sum) to part_ml (B,H,nsplit,2).  TQ is q's type, TC the
// cache's (KV's element type).
template <typename TQ, typename TC, int HD_PAD, int GB, typename KV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_split_kernel(const TQ* __restrict__ q, KV kv,
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
      load_dims<TQ, VEC>(q + b * q_sb + (long long)(kh * G + g) * q_sh, d0,
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
    Span<TC, VEC> kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(j0 + u, end - 1);   // past the end: a valid row, unused
      const TC* krow;
      const TC* vrow;
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

// ---------------------------------------------------------------------------
// Tensor-core split kernel: bf16 q, a bf16 or e4m3 cache, head_dim
// 32/64/80/96/128, 16-byte aligned rows, G <= 16.  One block of 4 warps per (KV split, KV head, batch row);
// the G query heads of the KV head are the rows of one mma.sync m16n8k16 A
// tile (padded to 16 rows with zeros), held in registers for the whole
// split.  Each warp walks its own 16-key tiles (warp w takes tiles w, w+4,
// ...) through a private ring of kTcStages shared-memory stages filled by
// 16-byte cp.async, so every warp keeps kTcStages - 1 tiles in flight while
// it computes one.  Per tile: S = Q K^T (K by ldmatrix), the online softmax
// in the exp2 domain across the four lanes of a quad, P split into bf16 hi
// and lo parts as the A operands of O += P_hi V + P_lo V (V by
// ldmatrix.trans).  The warps' (m, l, acc)
// are merged through shared memory at the end.  Keys of a tile outside the
// split's [begin, end) load the nearest row inside it (so K3 stays on its
// staged pages) and are masked.  With an e4m3 cache the ring holds e4m3
// rows, unpadded, and a tile is converted into the warp's bf16 staging tile
// (padded as the bf16 ring's) before the products read it.
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
// Resident blocks per SM the tensor-core kernel is sized for (registers
// and a 3-stage ring of 16-key K/V tiles per warp: 104 KB at head_dim 128);
// the wrapper's split plan (ops.py TC_BLOCKS_PER_SM) sizes one wave by it.
constexpr int kTcBlocksPerSM = 2;
constexpr int kTcKeys = 16;           // keys per warp tile
constexpr int kTcStages = 3;          // ring stages per warp
constexpr float kLog2e = 1.4426950408889634f;

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

// (a, b) as bf16 hi parts and the rest (a - hi, b - hi) as bf16 lo parts:
// P V taken as hi V + lo V keeps P to about 2^-16 of its fp32 value
__device__ __forceinline__ void pack_bf16_split(float a, float b,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Two e4m3 values (low byte first) as a bf16x2 word (low half first):
// e4m3 -> f16 in hardware, then f16 -> f32 -> bf16, every step exact.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared memory of the tensor-core kernel at head_dim HD with cache
// element TC: K3's page entries first, at offset 0; from `ring_off`
// (128-aligned) each warp's ring of kTcStages (K, V) tile pairs; with an
// e4m3 cache then each warp's bf16 staging pair.
template <int HD, typename TC>
struct TcSmem {
  static constexpr bool kF8 = sizeof(TC) == 1;
  static constexpr int LDS = HD + 8;      // bf16 tile row: ldmatrix conflict-free
  static constexpr int TILE = kTcKeys * LDS;  // elements of a bf16 K (or V) tile
  static constexpr int ROW = kF8 ? HD : LDS;  // ring row, in TC elements
  static constexpr int RTILE = kTcKeys * ROW; // ring elements of one tile
  static constexpr int RING_WARP = kTcStages * 2 * RTILE * (int)sizeof(TC);
  static constexpr int STAGE_WARP = kF8 ? 2 * TILE * 2 : 0;
  static constexpr int BYTES = kTcWarps * (RING_WARP + STAGE_WARP);
  // a warp's ring holds its (m, l, acc) for the final merge
  static_assert(RING_WARP >= (32 + 16 * HD) * 4, "merge scratch");
};

// An e4m3 (K, V) tile pair of the ring (rows of HD bytes, K's 16 then V's
// 16) into the warp's bf16 staging pair (rows of HD + 8 elements).
template <int HD>
__device__ __forceinline__ void stage_e4m3_tiles(
    const __nv_fp8_e4m3* src, __nv_bfloat16* dst, int lane) {
  constexpr int CH = HD / 16;           // 16-byte chunks of an e4m3 row
  constexpr int LDS = HD + 8;
#pragma unroll
  for (int c = lane; c < 2 * kTcKeys * CH; c += 32) {
    const int j = c / CH;
    const int col = (c % CH) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(src + j * HD + col);
    uint4 lo, hi;
    lo.x = e4m3x2_to_bf16x2(w.x);
    lo.y = e4m3x2_to_bf16x2(w.x >> 16);
    lo.z = e4m3x2_to_bf16x2(w.y);
    lo.w = e4m3x2_to_bf16x2(w.y >> 16);
    hi.x = e4m3x2_to_bf16x2(w.z);
    hi.y = e4m3x2_to_bf16x2(w.z >> 16);
    hi.z = e4m3x2_to_bf16x2(w.w);
    hi.w = e4m3x2_to_bf16x2(w.w >> 16);
    __nv_bfloat16* d = dst + j * LDS + col;
    *reinterpret_cast<uint4*>(d) = lo;
    *reinterpret_cast<uint4*>(d + 8) = hi;
  }
}

template <int HD, typename TC, typename KV>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q, KV kv,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int Smax, int H, int G,
                        int chunk, int nsplit, int window, float scale_log2,
                        long long q_sb, long long q_sh, int ring_off) {
  static_assert(HD % 16 == 0 && HD <= 128, "head_dim");
  using SM = TcSmem<HD, TC>;
  constexpr int LDS = SM::LDS;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;
  constexpr int PER = 16 / (int)sizeof(TC);   // elements of a 16-byte copy
  constexpr int CH = HD / PER;                // 16-byte copies per row
  constexpr int ROW = SM::ROW;
  constexpr int RTILE = SM::RTILE;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  int* sm_pages = reinterpret_cast<int*>(tc_smem);

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int split = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int mi = lane >> 3;            // ldmatrix: which 8x8 matrix
  unsigned char* wring_b = tc_smem + ring_off + warp * SM::RING_WARP;
  TC* wring = reinterpret_cast<TC*>(wring_b);
  __nv_bfloat16* wstage = reinterpret_cast<__nv_bfloat16*>(
      tc_smem + ring_off + kTcWarps * SM::RING_WARP + warp * SM::STAGE_WARP);

  const int L = min(max(lengths[b], 0), Smax);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int begin = max(lo, split * chunk);
  const int end = min(L, split * chunk + chunk);

  typename KV::Cursor cur = kv.at(b, kh, begin, end - 1, sm_pages);
  __syncthreads();

  // Q as A fragments: rows g and g+8 are query heads g0 = kh*G + row
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + 2 * t4;
      qf[kk][i] = r < G ? *reinterpret_cast<const uint32_t*>(
                              q + b * q_sb + (long long)(kh * G + r) * q_sh +
                              col)
                        : 0u;
    }
  }
  float acc[NT_O][4];
#pragma unroll
  for (int d = 0; d < NT_O; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // log2 domain
  float l[2] = {0.f, 0.f};               // this lane's partial row sums

  const int tbase = (begin / kTcKeys) * kTcKeys;
  const int ntiles = end > begin ? (end - tbase + kTcKeys - 1) / kTcKeys : 0;
  const int nmine =
      ntiles > warp ? (ntiles - warp + kTcWarps - 1) / kTcWarps : 0;

  auto issue = [&](int i) {            // this warp's i-th tile -> stage i % S
    const int t0 = tbase + (warp + i * kTcWarps) * kTcKeys;
    TC* ks = wring + (i % kTcStages) * 2 * RTILE;
    TC* vs = ks + RTILE;
#pragma unroll
    for (int c = lane; c < kTcKeys * CH; c += 32) {
      const int j = c / CH;
      const int col = (c % CH) * PER;
      const int t = min(max(t0 + j, begin), end - 1);
      const TC* kr;
      const TC* vr;
      cur.rows(t, kr, vr);
      cp_async16(ks + j * ROW + col, kr + col);
      cp_async16(vs + j * ROW + col, vr + col);
    }
  };

#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < nmine) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nmine; ++i) {
    if (i + kTcStages - 1 < nmine) issue(i + kTcStages - 1);
    cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncwarp();
    const TC* kring = wring + (i % kTcStages) * 2 * RTILE;
    const __nv_bfloat16* ks;
    if constexpr (SM::kF8) {
      stage_e4m3_tiles<HD>(kring, wstage, lane);
      __syncwarp();
      ks = wstage;
    } else {
      ks = kring;
    }
    const __nv_bfloat16* vs = ks + SM::TILE;
    const int t0 = tbase + (warp + i * kTcWarps) * kTcKeys;

    // S = Q K^T: 16 heads x 16 keys, two n-tiles of 8 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // matrices: (keys 0-7, dims kk*16), (+8 dims), (keys 8-15, ..), (..)
      uint32_t bf[4];
      ldsm_x4(bf, ks + ((mi >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                      (mi & 1) * 8);
      mma_bf16(s[0], qf[kk], bf[0], bf[1]);
      mma_bf16(s[1], qf[kk], bf[2], bf[3]);
    }

    // scale into the log2 domain, mask keys outside [begin, end)
    const bool edge = t0 < begin || t0 + kTcKeys > end;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kp = t0 + j * 8 + 2 * t4 + (e & 1);
          if (kp < begin || kp >= end) x = -INFINITY;
        }
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 1));
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 2));
      const float m_new = fmaxf(m[x], tmax[x]);
      m_use[x] = m_new == -INFINITY ? 0.f : m_new;
      alpha[x] = exp2f(m[x] - m_use[x]);
      m[x] = m_new;
      l[x] *= alpha[x];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: P (16 heads x 16 keys) as two A fragments, its bf16 hi
    // and lo parts (the lo product first: the smaller terms join first)
    uint32_t ph[4], pl[4];
    pack_bf16_split(s[0][0], s[0][1], ph[0], pl[0]);
    pack_bf16_split(s[0][2], s[0][3], ph[1], pl[1]);
    pack_bf16_split(s[1][0], s[1][1], ph[2], pl[2]);
    pack_bf16_split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int d = 0; d < NT_O; d += 2) {
      // matrices: (keys 0-7, dims 8d), (keys 8-15, dims 8d), (.., 8d+8)
      uint32_t bf[4];
      ldsm_x4_trans(bf, vs + ((mi & 1) * 8 + (lane & 7)) * LDS +
                            (d + (mi >> 1)) * 8);
      mma_bf16(acc[d], pl, bf[0], bf[1]);
      mma_bf16(acc[d + 1], pl, bf[2], bf[3]);
      mma_bf16(acc[d], ph, bf[0], bf[1]);
      mma_bf16(acc[d + 1], ph, bf[2], bf[3]);
    }
    __syncwarp();                      // stage and staging refill next
  }
  cp_async_wait<0>();
  __syncwarp();

  // merge the four warps' states through each warp's own ring region:
  // [16] m, [16] l, [16][HD] acc (fp32); an empty warp has m = -inf, l = 0
  float* wm = reinterpret_cast<float*>(wring_b);
  float* wl = wm + 16;
  float* wacc = wl + 16;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    if (t4 == 0) {
      wm[g + 8 * x] = m[x];
      wl[g + 8 * x] = l[x];
    }
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      wacc[(g + 8 * x) * HD + d * 8 + 2 * t4] = acc[d][2 * x];
      wacc[(g + 8 * x) * HD + d * 8 + 2 * t4 + 1] = acc[d][2 * x + 1];
    }
  }
  __syncthreads();
  const float* base = reinterpret_cast<const float*>(
      tc_smem + ring_off);
  constexpr int WSTRIDE = SM::RING_WARP / 4;   // floats per warp ring
  for (int idx = threadIdx.x; idx < G * HD; idx += kTcThreads) {
    const int gi = idx / HD;
    const int d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, base[w * WSTRIDE + gi]);
    const float M_use = M == -INFINITY ? 0.f : M;
    float a_sum = 0.f, l_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float* wb = base + w * WSTRIDE;
      const float a = exp2f(wb[gi] - M_use);
      a_sum += a * wb[32 + gi * HD + d];
      l_sum += a * wb[16 + gi];
    }
    const long long row = ((long long)b * H + kh * G + gi) * nsplit + split;
    part_acc[row * HD + d] = a_sum;
    if (d == 0) {                      // the combine kernel's natural-log m
      part_ml[2 * row] = M == -INFINITY ? kNegInf : M / kLog2e;
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

template <typename T>
cudaError_t launch_combine(const Common& a) {
  decode_combine_kernel<T><<<dim3(a.H, a.B), kCombineThreads,
                             a.nsplit * sizeof(float), a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.o), a.H, a.hd, a.nsplit,
      a.o_sb, a.o_sh);
  return cudaGetLastError();
}

template <typename TQ, typename TC, int HD_PAD, int GB, typename KV>
cudaError_t launch(const Common& a, KV kv) {
  const int G = a.H / a.K;
  const int ngroups = (G + GB - 1) / GB;
  const dim3 grid(a.nsplit, a.K * ngroups, a.B);
  decode_split_kernel<TQ, TC, HD_PAD, GB, KV>
      <<<grid, kThreads, a.smem_pages * sizeof(int), a.stream>>>(
      static_cast<const TQ*>(a.q), kv, a.lengths, a.part_acc, a.part_ml,
      a.Smax, a.H, G, a.hd, ngroups, a.chunk, a.nsplit, a.window, a.scale,
      a.q_sb, a.q_sh);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_combine<TQ>(a);
}

// The tensor-core kernel: K3's table entries, then the warps' rings (and,
// for an e4m3 cache, their staging tiles).
template <int HD, typename TC, typename KV>
cudaError_t launch_tc(const Common& a, KV kv) {
  const int ring_off = (a.smem_pages * (int)sizeof(int) + 127) / 128 * 128;
  const int smem = ring_off + TcSmem<HD, TC>::BYTES;
  auto kern = decode_split_mma_kernel<HD, TC, KV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nsplit, a.K, a.B);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), kv, a.lengths, a.part_acc,
      a.part_ml, a.Smax, a.H, a.H / a.K, a.chunk, a.nsplit, a.window,
      a.scale * kLog2e, a.q_sb, a.q_sh, ring_off);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_combine<__nv_bfloat16>(a);
}

// gb == kTcHeads selects the tensor-core kernel (the whole GQA group in one
// block); the wrapper picks it for a bf16 q, a bf16 or e4m3 cache, these
// head dims, G <= 16 and 16-byte aligned rows, and the entries check the
// same.
constexpr int kTcHeads = 16;

template <typename TC, typename KV>
cudaError_t dispatch_tc(const Common& a, KV kv) {
  switch (a.hd) {
    case 32: return launch_tc<32, TC>(a, kv);
    case 64: return launch_tc<64, TC>(a, kv);
    case 80: return launch_tc<80, TC>(a, kv);
    case 96: return launch_tc<96, TC>(a, kv);
    case 128: return launch_tc<128, TC>(a, kv);
  }
  return cudaErrorInvalidValue;
}

// A row start and its strides (in elements of `esize` bytes) on 16 bytes.
bool aligned16(const void* p, int esize, long long s0, long long s1,
               long long s2) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && s0 * esize % 16 == 0
         && s1 * esize % 16 == 0 && s2 * esize % 16 == 0;
}

template <typename TQ, typename TC, int HD_PAD, typename KV>
cudaError_t dispatch_gb(int gb, const Common& a, KV kv) {
  switch (gb) {
    case 1: return launch<TQ, TC, HD_PAD, 1>(a, kv);
    case 2: return launch<TQ, TC, HD_PAD, 2>(a, kv);
    case 4: return launch<TQ, TC, HD_PAD, 4>(a, kv);
    default:
      if constexpr (HD_PAD <= 128) {
        return launch<TQ, TC, HD_PAD, 8>(a, kv);
      }
  }
  return cudaErrorInvalidValue;   // 8 heads per block only up to hd 128
}

template <typename TQ, typename TC, typename KV>
cudaError_t dispatch_hd(int gb, const Common& a, KV kv) {
  if (a.hd <= 32) return dispatch_gb<TQ, TC, 32>(gb, a, kv);
  if (a.hd <= 64) return dispatch_gb<TQ, TC, 64>(gb, a, kv);
  if (a.hd <= 128) return dispatch_gb<TQ, TC, 128>(gb, a, kv);
  return dispatch_gb<TQ, TC, 256>(gb, a, kv);
}

bool bad_common(const Common& a) {
  return a.B < 1 || a.Smax < 1 || a.K < 1 || a.H % a.K != 0 || a.hd < 1 ||
         a.hd > 256 || a.nsplit < 1 || a.chunk < 1 ||
         (long long)a.nsplit * a.chunk < a.Smax;
}

// The cache codes: 0 = float32, 1 = bfloat16, 2 = float8 e4m3fn.  Valid
// (q, cache) pairs: (0, 0), (1, 1), (1, 2).
constexpr int kF32 = 0, kBF16 = 1, kE4M3 = 2;

// How K2 and K3 build their KV addressing from the cache pointers, once
// the cache's element type T is known.
struct MakeContig {
  Strides ks, vs;
  template <typename T>
  ContigKV<T> make(const void* k, const void* v) const {
    return {static_cast<const T*>(k), static_cast<const T*>(v), ks, vs};
  }
};

struct MakePaged {
  Strides ks, vs;
  const int* table;
  int MP, ps;
  unsigned magic, shift;
  template <typename T>
  PagedKV<T> make(const void* k, const void* v) const {
    return {static_cast<const T*>(k), static_cast<const T*>(v), ks, vs,
            table, MP, ps, magic, shift};
  }
};

// Runs the tensor-core (gb == kTcHeads) or the CUDA-core kernel on the
// (q, cache) element types that the codes name.
template <typename Make>
cudaError_t dispatch(int dtype, int cache_dtype, int gb, const Common& a,
                     const void* k, const void* v, const Make& m) {
  if (gb == kTcHeads) {
    const int esize = cache_dtype == kE4M3 ? 1 : 2;
    if (dtype != kBF16 || (cache_dtype != kBF16 && cache_dtype != kE4M3) ||
        a.H / a.K > kTcHeads || !aligned16(a.q, 2, a.q_sb, a.q_sh, 0) ||
        !aligned16(k, esize, m.ks.b, m.ks.s, m.ks.h) ||
        !aligned16(v, esize, m.vs.b, m.vs.s, m.vs.h))
      return cudaErrorInvalidValue;
    if (cache_dtype == kE4M3)
      return dispatch_tc<__nv_fp8_e4m3>(
          a, m.template make<__nv_fp8_e4m3>(k, v));
    return dispatch_tc<__nv_bfloat16>(a, m.template make<__nv_bfloat16>(k, v));
  }
  if (dtype == kF32 && cache_dtype == kF32)
    return dispatch_hd<float, float>(gb, a, m.template make<float>(k, v));
  if (dtype == kBF16 && cache_dtype == kBF16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        gb, a, m.template make<__nv_bfloat16>(k, v));
  if (dtype == kBF16 && cache_dtype == kE4M3)
    return dispatch_hd<__nv_bfloat16, __nv_fp8_e4m3>(
        gb, a, m.template make<__nv_fp8_e4m3>(k, v));
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: q's (and o's) code, cache_dtype: k's and v's (0 = float32, 1 =
// bfloat16, 2 = float8 e4m3fn; an e4m3 cache takes a bf16 q).  Strides
// are in elements.  lengths is int32 (B,).  part_acc (B,H,nsplit,hd) and
// part_ml (B,H,nsplit,2) are fp32 scratch the caller allocates; `chunk`
// keys per split (nsplit * chunk >= Smax).  gb: query heads per block (1,
// 2, 4, or 8 for head_dim <= 128; kTcHeads for the tensor-core kernel).
// Every row start of q/k/v must be aligned to a lane's span of head dims
// (HD_PAD/32 elements) and hd a multiple of it.  window <= 0: no window.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    float* part_acc, float* part_ml, int dtype, int cache_dtype, int B,
    int Smax, int H, int K, int hd, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    int nsplit, int chunk, int gb, int window, float scale, void* stream) {
  const Common a{0, q, o, lengths, part_acc, part_ml, B, Smax, H, K, hd,
                 q_sb, q_sh, o_sb, o_sh, nsplit, chunk, window, scale,
                 static_cast<cudaStream_t>(stream)};
  if (bad_common(a)) return (int)cudaErrorInvalidValue;
  const MakeContig m{{k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  return (int)dispatch(dtype, cache_dtype, gb, a, k, v, m);
}

// K3.  As decode_attention_fwd, with k/v the pool layer (P,ps,K,hd) through
// (page, position, head) strides, page_table (B,MP) int32 contiguous, and
// Smax = MP * ps.  `chunk` must be a multiple of ps (every split starts on a
// page boundary) and chunk / ps at most kMaxSplitPages.  Every table entry
// must be a page of the pool.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* page_table, const int* lengths, float* part_acc,
    float* part_ml, int dtype, int cache_dtype, int B, int MP, int ps, int H,
    int K, int hd, long long q_sb, long long q_sh, long long k_sp,
    long long k_ss, long long k_sh, long long v_sp, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, int nsplit, int chunk,
    int gb, int window, float scale, void* stream) {
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
  const MakePaged m{{k_sp, k_ss, k_sh}, {v_sp, v_ss, v_sh}, page_table, MP,
                    ps, magic, shift};
  return (int)dispatch(dtype, cache_dtype, gb, a, k, v, m);
}
