// Hand-written Hopper (sm_90a) kernels for the sparse emit path and the
// dense wire.
//
// They replace the Pallas TPU kernels of src/repro/kernels/sparsify/
// kernel.py (the RICE parts of compact_emit_2d become a kernel of their own
// here):
//
//   stats_l1max   <- stats_l1max_2d   (kernel.py:275)  (sum|g|, max|g|) per row
//   tail_stats    <- tail_stats_2d    (kernel.py:195)  (count, sum|g|) of |g| < t
//   select_stats  <- select_stats_2d  (kernel.py:384)  pass 1 of the compaction
//   compact_emit  <- compact_emit_2d  (kernel.py:559)  pass 2: compact write
//   rice_pack     <- compact_emit_2d  (kernel.py:497-556, the rice_r >= 0
//                    parts)  Golomb-Rice packing of the compact idx stream;
//                    its fitted variant packs each row at its own r
//                    (wire-format v4: XLA's _rice_pack_gaps at the chosen
//                    r, src/repro/comm/compaction.py:265)
//   rice_fit      <- the candidate sweep and argmin of XLA's
//                    rice_encode_fitted (src/repro/comm/compaction.py:300)
//                    the data-fitted Golomb-Rice parameter per row
//   stats         <- stats_2d         (kernel.py:239)  (sum|g|, sum g^2, max)
//   sparsify      <- sparsify_2d      (kernel.py:96)   dense Q(g), wire dtype
//   sparsify_ef   <- sparsify_ef_2d   (kernel.py:123)  Q(g) and g - Q(g)
//   sparsify_prng <- sparsify_prng_2d (kernel.py:157)  Q(g), Philox uniforms
//   topk_threshold <- the lax.top_k of topk_emit (ops.py:268, outside
//                    Pallas)  topk's threshold and tie budget per row
//   compact_bins, compact_select <- the lax.top_k of compaction.compact
//                    (src/repro/comm/compaction.py:64)  the magnitude
//                    compaction of a bf16 group: row scalars from the
//                    magnitude bins, then one select-and-compact pass
//   closed_lambda <- the jnp.sort of closed_form_lambda
//                    (src/repro/core/sparsify.py:40)  Algorithm 2's lambda
//                    of a bf16 row from its magnitude bins
//
// The first six run the sparse gather wire (rice_fit and the fitted
// rice_pack under wire-format v4), the next four the dense wire
// (stats, tail_stats and sparsify or sparsify_ef) and ops.gspar_sparsify_prng;
// topk_threshold gives the topk selector its per-row scalars; the last
// three serve the pod stage's and the reference backend's compaction and
// Algorithm 2 (algo="closed").
//
// Passes 1 and 2 take every selector kind of the TPU kernels (gspar's lam,
// unisp's rho, bernoulli's bern, topk) as a template parameter, and pass 2
// every value codec: f32 and bf16, and the integer codecs qsgd<N> and
// ternary with the codec uniforms gathered at compact rank.
//
// Layout. Every kernel takes one shape group as a row-major [rows, d] batch
// (rice_pack: the group's compact [rows, k_cap] idx), one launch per group,
// as the vmap over the group is on the TPU: the grid is (tiles, rows),
// blockIdx.y is the row, and each block owns kTile consecutive coordinates
// of its row (rice_pack: kRiceTile codes, in the order of a ticket; pass 1
// for topk: kTopkTiles tiles; topk_threshold's histogram: an equal run of
// the group's chunks, one persistent block an SM).
// Per-row scalars (lambda, rho, max|g|, the topk threshold and tie
// budget, the codec scale, the saturation gate) are read from device
// memory, so no host round trip sits between the passes. The ragged end of
// a row is masked here; nothing is padded into a tile layout.
//
// What bounds them. The first four stream the gradient (bf16 on the main
// path) and, for the sampling selectors' two compaction passes, f32
// uniforms: they are bound by device memory bandwidth (2 B/coord for the
// reductions and topk's pass 1, 6 B/coord for a sampling pass 1, 8 B/coord
// plus the compact output, the codec uniforms and the EF residual for pass
// 2). Each thread therefore loads kItems consecutive elements per sweep (one
// 16-byte vector load of bf16, two of f32) and keeps its partial sums in
// registers; pass 2 issues each sweep's loads a sweep ahead and writes its
// residual, like the dense wire's kernels their Q, as 16-byte vectors. Pass
// 2 with a selector that reads little (topk: 2 B/coord) and rice_pack are
// bound by instruction issue and latency rather than bytes (see the
// sections of kernels 4 and 4b).
//
// Order without a sequential grid. The TPU carries the compact rank (and
// topk's tie rank) from tile to tile in SMEM across a grid that runs in
// order. Hopper blocks run in no order, so pass 1 writes per-(row, tile)
// survivor (and tie) counts, a one-block-per-row finish kernel scans them
// into per-tile base ranks, and pass 2 gives every survivor its slot as base
// + in-block rank (a warp shuffle scan and one barrier a sweep). Slots are
// written without atomics, so idx ascends by coordinate; pass 2 also zeroes
// the slots past each row's live prefix (at a capacity of a whole row, a
// memset before it does). rice_pack, which needs the
// quotient sum of everything before a block, takes it from a chained scan
// with decoupled look-back instead: one launch, blocks ordered by a ticket.
//
// Sums accumulate in f64 and round to f32 once, so they differ from the TPU's
// tile-order f32 sums only by rounding; counts are integers (the TPU counts
// tail_stats in f32, and reads topk's tie budget from an f32 scalar, which
// stop being exact past 2^24).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                // threads per block
constexpr int kItems = 8;                    // consecutive elements per thread
constexpr int kSweep = kThreads * kItems;    // elements per block sweep
constexpr int kWarps = kThreads / 32;        // warps per block
constexpr int64_t kTile = 8 * kSweep;        // coordinates per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t row_end(int64_t d, int64_t start) {
  return d < start + kTile ? d : start + kTile;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kItems consecutive elements of one row starting at i, as f32; entries at or
// past `end` read as 0 (callers mask them by index). `vec` promises a 16-byte
// aligned row base and d % 8 == 0, which makes every full chunk aligned.
__device__ __forceinline__ void load_items(const __nv_bfloat16* __restrict__ row,
                                           int64_t i, int64_t end, bool vec,
                                           float out[kItems]) {
  if (vec && i + kItems <= end) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < kItems; ++k) out[k] = __bfloat162float(h[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      out[k] = (i + k < end) ? __bfloat162float(row[i + k]) : 0.f;
  }
}

__device__ __forceinline__ void load_items(const float* __restrict__ row,
                                           int64_t i, int64_t end, bool vec,
                                           float out[kItems]) {
  if (vec && i + kItems <= end) {
    float4 a = *reinterpret_cast<const float4*>(row + i);
    float4 b = *reinterpret_cast<const float4*>(row + i + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) out[k] = (i + k < end) ? row[i + k] : 0.f;
  }
}

// The same kItems elements as raw registers, so that a loop can issue a
// sweep's loads one sweep ahead and widen them to f32 only when it uses them
// (load_chunk, then unpack; bf16 widens exactly by a 16-bit shift).
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { uint4 v; };
template <> struct Chunk<float> { float4 a, b; };

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ row,
                                           int64_t i, int64_t end, bool vec,
                                           Chunk<__nv_bfloat16>& c) {
  if (vec && i + kItems <= end) {
    c.v = *reinterpret_cast<const uint4*>(row + i);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
    unsigned w[kItems / 2];
#pragma unroll
    for (int k = 0; k < kItems / 2; ++k) {
      const unsigned lo = i + 2 * k < end ? h[i + 2 * k] : 0u;
      const unsigned hi = i + 2 * k + 1 < end ? h[i + 2 * k + 1] : 0u;
      w[k] = lo | (hi << 16);
    }
    c.v = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           int64_t i, int64_t end, bool vec,
                                           Chunk<float>& c) {
  if (vec && i + kItems <= end) {
    c.a = *reinterpret_cast<const float4*>(row + i);
    c.b = *reinterpret_cast<const float4*>(row + i + 4);
  } else {
    float f[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) f[k] = (i + k < end) ? row[i + k] : 0.f;
    c.a = make_float4(f[0], f[1], f[2], f[3]);
    c.b = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float out[kItems]) {
  const unsigned w[kItems / 2] = {c.v.x, c.v.y, c.v.z, c.v.w};
#pragma unroll
  for (int k = 0; k < kItems / 2; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Chunk<float>& c,
                                       float out[kItems]) {
  out[0] = c.a.x; out[1] = c.a.y; out[2] = c.a.z; out[3] = c.a.w;
  out[4] = c.b.x; out[5] = c.b.y; out[6] = c.b.z; out[7] = c.b.w;
}

// kItems consecutive values of one row from i, rounded to the row's type;
// entries at or past `end` are not stored. `vec` as in load_items.
__device__ __forceinline__ void store_items(__nv_bfloat16* __restrict__ row,
                                            int64_t i, int64_t end, bool vec,
                                            const float v[kItems]) {
  if (vec && i + kItems <= end) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < kItems; ++k) h[k] = __float2bfloat16_rn(v[k]);
    *reinterpret_cast<uint4*>(row + i) = raw;
  } else {
    for (int k = 0; k < kItems && i + k < end; ++k)
      row[i + k] = __float2bfloat16_rn(v[k]);
  }
}

__device__ __forceinline__ void store_items(float* __restrict__ row,
                                            int64_t i, int64_t end, bool vec,
                                            const float v[kItems]) {
  if (vec && i + kItems <= end) {
    *reinterpret_cast<float4*>(row + i) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + i + 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int k = 0; k < kItems && i + k < end; ++k) row[i + k] = v[k];
  }
}

// The block zeroes bytes [a, b) of p: single bytes up to a 16-byte boundary
// and after the last one, 16-byte stores between.
__device__ void zero_bytes(unsigned char* __restrict__ p, int64_t a,
                           int64_t b) {
  if (a >= b) return;
  const int64_t head = (16 - (int64_t)((uintptr_t)(p + a) & 15)) & 15;
  const int64_t body = head < b - a ? (b - a - head) >> 4 : 0;
  const int64_t tail = a + head + 16 * body;
  for (int64_t j = threadIdx.x; j < head && a + j < b; j += blockDim.x)
    p[a + j] = 0;
  uint4* v = reinterpret_cast<uint4*>(p + a + head);
  for (int64_t j = threadIdx.x; j < body; j += blockDim.x)
    v[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t j = tail + threadIdx.x; j < b; j += blockDim.x) p[j] = 0;
}

template <typename V> __device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// Block-wide sum; the result is valid in thread 0. `sh` holds 32 entries.
template <typename V> __device__ V block_sum(V v, V* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  V t = 0;
  if (w == 0) {
    t = lane < nw ? sh[lane] : V(0);
    t = warp_sum(t);
  }
  return t;
}

__device__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  float t = 0.f;
  if (w == 0) {
    t = lane < nw ? sh[lane] : 0.f;
    t = warp_max(t);
  }
  return t;
}

// Exclusive scan of one int per thread over the block; every thread gets its
// exclusive prefix and the block total. `sh` holds 33 entries.
__device__ int block_excl_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();                      // earlier readers of sh are done
  if (lane == 31) sh[w] = inc;
  __syncthreads();
  if (w == 0) {
    int x = lane < nw ? sh[lane] : 0;
    int xi = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int n = __shfl_up_sync(kFull, xi, o);
      if (lane >= o) xi += n;
    }
    if (lane < nw) sh[lane] = xi - x;
    if (lane == 31) sh[32] = xi;
  }
  __syncthreads();
  *total = sh[32];
  return sh[w] + inc - v;
}

// ---------------------------------------------------------------------------
// Kernels 1 and 7: (sum|g|, max|g|) per row, and with kL2 also sum g^2. One
// body serves both, so stats' sum|g| and max|g| are stats_l1max's bit for
// bit on the same row (the same partials in the same order): the dense wire
// takes lambda_0 from stats, the gather wire from stats_l1max, and the two
// wires draw the same kept set only if the lambdas are the same bits.
// ---------------------------------------------------------------------------

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
stats_tiles(const T* __restrict__ g, int64_t d, int64_t ntiles, int vec,
            double* __restrict__ psum, double* __restrict__ psq,
            float* __restrict__ pmax) {
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const T* grow = g + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  double s = 0.0, q = 0.0;
  float m = 0.f;
  for (int64_t i = start + threadIdx.x * kItems; i < end; i += kSweep) {
    float x[kItems];
    load_items(grow, i, end, vec, x);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float a = fabsf(x[k]);     // masked entries read as 0
      s += a;
      if constexpr (kL2) q += __fmul_rn(a, a);
      m = fmaxf(m, a);
    }
  }
  __shared__ double sh_s[32];
  __shared__ float sh_m[32];
  s = block_sum(s, sh_s);
  if constexpr (kL2) q = block_sum(q, sh_s);
  m = block_max(m, sh_m);
  if (threadIdx.x == 0) {
    psum[row * ntiles + tile] = s;
    if constexpr (kL2) psq[row * ntiles + tile] = q;
    pmax[row * ntiles + tile] = m;
  }
}

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
stats_finish(const double* __restrict__ psum, const double* __restrict__ psq,
             const float* __restrict__ pmax, int64_t ntiles,
             float* __restrict__ l1, float* __restrict__ l2,
             float* __restrict__ mx) {
  const int64_t row = blockIdx.x;
  double s = 0.0, q = 0.0;
  float m = 0.f;
  for (int64_t t = threadIdx.x; t < ntiles; t += blockDim.x) {
    s += psum[row * ntiles + t];
    if constexpr (kL2) q += psq[row * ntiles + t];
    m = fmaxf(m, pmax[row * ntiles + t]);
  }
  __shared__ double sh_s[32];
  __shared__ float sh_m[32];
  s = block_sum(s, sh_s);
  if constexpr (kL2) q = block_sum(q, sh_s);
  m = block_max(m, sh_m);
  if (threadIdx.x == 0) {
    l1[row] = (float)s;
    if constexpr (kL2) l2[row] = (float)q;
    mx[row] = m;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: (count, sum|g|) over |g| < thresh[row]; no work where gate[row]
// is 0 (lambda_0 * max|g| <= 1: nothing saturates, lambda_0 is final).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_tiles(const T* __restrict__ g, int64_t d, int64_t ntiles, int vec,
           const float* __restrict__ thresh, const uint8_t* __restrict__ gate,
           int* __restrict__ pcnt, double* __restrict__ psum) {
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  if (!gate[row]) return;              // uniform over the block
  const float t = thresh[row];
  const T* grow = g + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  int c = 0;
  double s = 0.0;
  for (int64_t i = start + threadIdx.x * kItems; i < end; i += kSweep) {
    float x[kItems];
    load_items(grow, i, end, vec, x);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float a = fabsf(x[k]);
      if (i + k < end && a < t) {
        ++c;
        s += a;
      }
    }
  }
  __shared__ int sh_c[32];
  __shared__ double sh_s[32];
  c = block_sum(c, sh_c);
  s = block_sum(s, sh_s);
  if (threadIdx.x == 0) {
    pcnt[row * ntiles + tile] = c;
    psum[row * ntiles + tile] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
tail_finish(const int* __restrict__ pcnt, const double* __restrict__ psum,
            int64_t ntiles, const uint8_t* __restrict__ gate,
            long long* __restrict__ cnt, float* __restrict__ l1) {
  const int64_t row = blockIdx.x;
  if (!gate[row]) {
    if (threadIdx.x == 0) {
      cnt[row] = 0;
      l1[row] = 0.f;
    }
    return;
  }
  long long c = 0;
  double s = 0.0;
  for (int64_t t = threadIdx.x; t < ntiles; t += blockDim.x) {
    c += pcnt[row * ntiles + t];
    s += psum[row * ntiles + t];
  }
  __shared__ long long sh_c[32];
  __shared__ double sh_s[32];
  c = block_sum(c, sh_c);
  s = block_sum(s, sh_s);
  if (threadIdx.x == 0) {
    cnt[row] = c;
    l1[row] = (float)s;
  }
}

// ---------------------------------------------------------------------------
// Kernels 3 and 4: the two-pass compaction, one instantiation per selector
// kind PK (a template parameter: no per-element branch on the kind). The
// selectors, as _tile_select (kernel.py:302) defines them from the per-row
// scalars s1, s2 and the topk tie budget:
//
//   kLam  (gspar)     p = min(s1 |g|, 1)
//   kRho  (unisp)     p = s1 on the support, 0 off it
//   kBern (bernoulli) p = |g| / s2, s2 = max|g|
//       z = u < p, v = z ? g / p : 0
//   kTopk             z = |g| > t, or |g| == t > 0 among the first `budget`
//                     such coordinates of the row (XLA top_k's lowest-index
//                     tie break); v = z ? g : 0. Reads no uniforms.
//
// The TPU carries the topk tie rank from tile to tile in SMEM. Here every
// tie has |g| = t, so pass 1 needs no rank: it counts per tile the strict
// survivors (gt) and the ties, and reduces the statistics of the strict
// survivors only. select_finish scans the tie counts into a tie base per
// tile, keeps kept = clamp(budget - tie_base, 0, ties) of each tile's ties,
// and scans gt + kept into the base ranks; the kept ties add kept * t^2 to
// sum v^2 and t to max|v|. Pass 2 re-derives the mask from the tie base with
// one more block scan per sweep. The budget stays an integer throughout.
// ---------------------------------------------------------------------------

enum : int { kLam = 0, kRho = 1, kBern = 2, kTopk = 3 };

struct Sample {
  bool z;
  float p, v;
};

template <int PK>
__device__ __forceinline__ float keep_prob(float a, float s1, float s2) {
  if constexpr (PK == kLam) return fminf(s1 * a, 1.f);
  if constexpr (PK == kRho) return a > 0.f ? s1 : 0.f;
  return s2 > 0.f ? __fdiv_rn(a, s2) : 0.f;        // kBern
}

// The sampling selectors (every kind but kTopk) on one element.
template <int PK>
__device__ __forceinline__ Sample sample(float x, float r, float s1, float s2,
                                         bool valid) {
  Sample o;
  o.p = keep_prob<PK>(fabsf(x), s1, s2);
  o.z = valid && r < o.p;
  o.v = o.z ? __fdiv_rn(x, o.p) : 0.f;
  return o;
}

// Survivor (and topk tie) counts per warp of one sweep, double-buffered by
// sweep parity: sweep s writes half s & 1, meets the block at one barrier
// and reads it back; a warp can rewrite that half two sweeps later only
// after every warp has passed the barrier in between, so after every read.
struct SweepCounts {
  int kept[2][kWarps];   // survivors (topk: strict survivors |g| > t)
  int ties[2][kWarps];   // topk: threshold ties |g| == t > 0
};

// The mask of a thread's items from coordinate i that lie before end.
__device__ __forceinline__ unsigned valid_items(int64_t i, int64_t end) {
  const int64_t n = end - i;
  return n >= kItems ? (1u << kItems) - 1u : (n <= 0 ? 0u : (1u << n) - 1u);
}

// The value a kept coordinate x sends: g / p for the sampling selectors
// (the bits sample() gives), g itself for topk.
template <int PK>
__device__ __forceinline__ float kept_value(float x, float s1, float s2) {
  if constexpr (PK == kTopk) return x;
  return __fdiv_rn(x, keep_prob<PK>(fabsf(x), s1, s2));
}

// The selector and the ranks of one sweep. Each thread holds kItems
// consecutive elements, of which those in the mask `valid` lie before the
// tile's end (valid_items). Its survivors and topk ties are counted with
// popc of its masks, packed into one int (ties in the high half) and
// scanned across the warp with five shuffles (which measured faster than
// a ballot and popc per item, most for topk); the warps' totals are read
// from `sh` after one barrier, so
// every thread of the block calls this in every sweep. Returns the kept
// mask (bit k: item k), the thread's first survivor rank within the sweep
// in *first and the sweep's survivor count in *total. Masks rather than
// bool and value arrays keep the pass-2 kernels' registers down
// (kept_value gives a survivor's value when it is stored).
//
// topk: a tie is kept iff its rank among the row's ties is below the
// budget. The warp's ties start at *tie_rank plus the ties of the warps
// below, so every thread derives from the same shared counts how many of
// each warp's ties are kept (its first `kept`, in coordinate order) without
// a second scan. *tie_rank advances by the sweep's ties.
template <int PK>
__device__ __forceinline__ unsigned sweep_ranks(const float x[kItems],
                                                const float r[kItems],
                                                unsigned valid, float s1,
                                                float s2, long long budget,
                                                long long* tie_rank,
                                                SweepCounts& sh, int par,
                                                int* first, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned zm = 0u, tm = 0u;           // kept (topk: strict) and tie masks
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const float a = fabsf(x[k]);
    if constexpr (PK == kTopk) {
      zm |= (unsigned)(a > s1) << k;
      tm |= (unsigned)(a == s1 && s1 > 0.f) << k;
    } else {
      zm |= (unsigned)(r[k] < keep_prob<PK>(a, s1, s2)) << k;
    }
  }
  zm &= valid;
  tm &= valid;
  const int mine = __popc(zm) | (__popc(tm) << 16);
  int inc = mine;                      // (ties << 16) | survivors, inclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) {
    sh.kept[par][w] = inc & 0xffff;
    if constexpr (PK == kTopk) sh.ties[par][w] = inc >> 16;
  }
  __syncthreads();
  const int below = inc - mine;        // my warp's lanes before me
  int base = 0, sum = 0;
  if constexpr (PK == kTopk) {
    // ties the budget still admits at the sweep's start (saturated)
    const long long left0 = budget - *tie_rank;
    int left = left0 <= 0 ? 0 : (left0 < (1 << 30) ? (int)left0 : 1 << 30);
    int kept_w = 0, ties = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int t = sh.ties[par][j];
      const int kept = left < t ? left : t;
      left -= kept;
      const int c = sh.kept[par][j] + kept;
      if (j == w) kept_w = kept;
      if (j < w) base += c;
      sum += c;
      ties += t;
    }
    const int tp = below >> 16;        // ties before mine in the warp
    if (tm) {
      int tr = tp;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if ((tm >> k) & 1u) {
          zm |= (unsigned)(tr < kept_w) << k;
          ++tr;
        }
      }
    }
    *tie_rank += ties;
    base += (below & 0xffff) + (tp < kept_w ? tp : kept_w);
  } else {
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int c = sh.kept[par][j];
      if (j < w) base += c;
      sum += c;
    }
    base += below & 0xffff;
  }
  *first = base;
  *total = sum;
  return zm;
}

// Pass 1 per (row, tile) for the sampling selectors: survivors, support
// |{g != 0}|, sum p, sum g^2, sum v^2 and max|v| (topk: select_tiles_topk).
// With round_v the codec-scale statistics see v rounded to g's type T: the
// dense wire's scale, over the v that apply_mask casts to the leaf dtype
// (the gather wire encodes float32 v).
template <int PK, typename T>
__global__ void __launch_bounds__(kThreads)
select_tiles(const T* __restrict__ g, const float* __restrict__ u, int64_t d,
             int64_t ntiles, int vec_g, int vec_u,
             const float* __restrict__ s1p, const float* __restrict__ s2p,
             int* __restrict__ pcnt, int* __restrict__ pnzc,
             double* __restrict__ ppsum, double* __restrict__ pden,
             double* __restrict__ pvsq, float* __restrict__ pvmx,
             int round_v) {
  static_assert(PK != kTopk, "topk's pass 1 is select_tiles_topk");
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const float s1 = s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const T* grow = g + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  int cnt = 0, nzc = 0;
  double ps = 0.0, dn = 0.0, vs = 0.0;
  float vm = 0.f;
  for (int64_t i = start + threadIdx.x * kItems; i < end; i += kSweep) {
    float x[kItems], r[kItems];
    load_items(grow, i, end, vec_g, x);
    load_items(u + row * d, i, end, vec_u, r);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i + k >= end) continue;
      const float a = fabsf(x[k]);
      const float a2 = a * a;
      nzc += a > 0.f;
      dn += a2;
      const Sample o = sample<PK>(x[k], r[k], s1, s2, true);
      const float v = round_v ? to_f32(from_f32<T>(o.v)) : o.v;
      const float v2 = v * v;
      ps += o.p;
      cnt += o.z;
      vs += v2;
      vm = fmaxf(vm, fabsf(v));
    }
  }
  __shared__ int sh_i[32];
  __shared__ double sh_d[32];
  __shared__ float sh_f[32];
  cnt = block_sum(cnt, sh_i);
  nzc = block_sum(nzc, sh_i);
  ps = block_sum(ps, sh_d);
  dn = block_sum(dn, sh_d);
  vs = block_sum(vs, sh_d);
  vm = block_max(vm, sh_f);
  if (threadIdx.x == 0) {
    const int64_t o = row * ntiles + tile;
    pcnt[o] = cnt;
    pnzc[o] = nzc;
    ppsum[o] = ps;
    pden[o] = dn;
    pvsq[o] = vs;
    pvmx[o] = vm;
  }
}

// Pass 1 for topk, redesigned for this card. topk reads 2 B a coordinate
// (bf16 g, no uniforms), so a block of one tile (32 KB) would spend as long
// on its fixed cost, seven block reductions of which three in f64 with
// their barriers, as on its loads (42 % of the bound on an H100). Here a
// block covers kTopkTiles consecutive tiles of its row and:
//   - still writes one entry per tile, as select_finish and pass 2 read
//     them: the strict and tie counts of a tile go through one packed int
//     (ties in the high half: a tile has at most kTile = 2^14 of each), and
//     sum v^2 and max|v| over the strict survivors stay per tile (the finish
//     sums them only over the tiles before the one that straddles k_cap);
//   - reduces each tile per warp only, into shared memory, and the block
//     once at its end (one barrier pair for all its tiles);
//   - reduces the support and sum g^2 once per block, into its first
//     tile's slot (zeros in the others: the finish only totals them);
//   - writes no sum p (for topk it equals the strict count);
//   - sums a thread's squares of one sweep (8 items) in f32 and converts
//     to f64 once a sweep (Hopper issues 64-bit conversions at 16 a clock
//     an SM): non-negative terms, so within 8u (about 4.8e-7) relative;
//   - loads a full tile's 8 sweeps before using them (8 x 16 B in flight a
//     thread), masking only a row's ragged last tile.
constexpr int kTopkTiles = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_tiles_topk(const T* __restrict__ g, int64_t d, int64_t ntiles,
                  int vec_g, const float* __restrict__ s1p,
                  int* __restrict__ pcnt, int* __restrict__ pnzc,
                  int* __restrict__ pties, double* __restrict__ pden,
                  double* __restrict__ pvsq, float* __restrict__ pvmx) {
  const int64_t row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * kTopkTiles;
  const int nt = (int)(ntiles - t0 < kTopkTiles ? ntiles - t0 : kTopkTiles);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float s1 = s1p[row];
  const bool ties_on = s1 > 0.f;
  const T* grow = g + row * d;
  __shared__ int sh_c[kTopkTiles][kWarps];
  __shared__ double sh_v[kTopkTiles][kWarps];
  __shared__ float sh_m[kTopkTiles][kWarps];
  int nzc = 0;
  double dn = 0.0;
  for (int j = 0; j < nt; ++j) {                  // uniform over the block
    const int64_t start = (t0 + j) * kTile;
    const int64_t end = row_end(d, start);
    int c = 0;                                     // (ties << 16) | strict
    double vs = 0.0;
    float vm = 0.f;
    // one sweep's items: the thread's strict and tie counts, support, and
    // f32 partial sums of g^2 and of the strict survivors' v^2
    auto items = [&](const float x[kItems], unsigned valid) {
      float dn_s = 0.f, vs_s = 0.f;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (!((valid >> k) & 1u)) continue;
        const float a = fabsf(x[k]);
        nzc += a > 0.f;
        dn_s += __fmul_rn(a, a);      // rounded as the plain version
        if (a > s1) {
          ++c;
          vs_s += __fmul_rn(x[k], x[k]);
          vm = fmaxf(vm, a);
        } else if (a == s1 && ties_on) {
          c += 1 << 16;
        }
      }
      dn += dn_s;
      vs += vs_s;
    };
    const int64_t i0 = start + threadIdx.x * kItems;
    if (end - start == kTile) {                    // a full tile
      Chunk<T> ch[kTile / kSweep];
#pragma unroll
      for (int s = 0; s < kTile / kSweep; ++s)
        load_chunk(grow, i0 + s * kSweep, end, vec_g, ch[s]);
#pragma unroll
      for (int s = 0; s < kTile / kSweep; ++s) {
        float x[kItems];
        unpack(ch[s], x);
        items(x, (1u << kItems) - 1u);
      }
    } else {
      for (int64_t i = i0; i < end; i += kSweep) {
        float x[kItems];
        load_items(grow, i, end, vec_g, x);
        items(x, valid_items(i, end));
      }
    }
    c = warp_sum(c);
    vs = warp_sum(vs);
    vm = warp_max(vm);
    if (lane == 0) {
      sh_c[j][w] = c;
      sh_v[j][w] = vs;
      sh_m[j][w] = vm;
    }
  }
  __shared__ int sh_i[32];
  __shared__ double sh_d[32];
  nzc = block_sum(nzc, sh_i);       // its barriers also publish sh_c/v/m
  dn = block_sum(dn, sh_d);
  if (threadIdx.x < nt) {
    const int j = threadIdx.x;
    int c = 0;
    double vs = 0.0;
    float vm = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      c += sh_c[j][k];
      vs += sh_v[j][k];
      vm = fmaxf(vm, sh_m[j][k]);
    }
    const int64_t o = row * ntiles + t0 + j;
    pcnt[o] = c & 0xffff;
    pties[o] = c >> 16;
    pvsq[o] = vs;
    pvmx[o] = vm;
    pnzc[o] = j == 0 ? nzc : 0;     // block totals, valid in thread 0
    pden[o] = j == 0 ? dn : 0.0;
  }
}

// One block per row: scan the tile counts into base ranks (topk: first the
// tie counts into tie bases, which decide each tile's kept ties), reduce the
// tile partials, and re-run the single tile that straddles rank k_cap so that
// the codec-scale statistics see exactly the first k_cap survivors.
template <int PK, typename T>
__global__ void __launch_bounds__(kThreads)
select_finish(const T* __restrict__ g, const float* __restrict__ u, int64_t d,
              int64_t ntiles, int vec_g, int vec_u,
              const float* __restrict__ s1p, const float* __restrict__ s2p,
              const long long* __restrict__ budgetp, int64_t k_cap,
              const int* __restrict__ pcnt, const int* __restrict__ pnzc,
              const int* __restrict__ pties, const double* __restrict__ ppsum,
              const double* __restrict__ pden, const double* __restrict__ pvsq,
              const float* __restrict__ pvmx, int* __restrict__ base,
              int* __restrict__ tie_base, int* __restrict__ cnt_out,
              int* __restrict__ nzc_out, float* __restrict__ psum_out,
              float* __restrict__ den_out, float* __restrict__ vsq_out,
              float* __restrict__ vmx_out, int round_v) {
  const int64_t row = blockIdx.x;
  const float s1 = s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const long long budget = PK == kTopk ? budgetp[row] : 0;
  const float t2 = s1 * s1;                 // topk: v^2 of a kept tie
  __shared__ int sh_scan[33];
  __shared__ long long sh_straddle[3];   // tile index, its base rank, tie base
  if (threadIdx.x == 0) sh_straddle[0] = -1;
  long long running = 0, tie_run = 0, nz = 0;
  double ps = 0.0, dn = 0.0, vs = 0.0;
  float vm = 0.f;
  for (int64_t c0 = 0; c0 < ntiles; c0 += blockDim.x) {
    const int64_t t = c0 + threadIdx.x;
    const int64_t o = row * ntiles + t;
    int c = t < ntiles ? pcnt[o] : 0;
    long long tb = 0;
    int kept = 0;                          // topk: this tile's kept ties
    if constexpr (PK == kTopk) {
      const int ties = t < ntiles ? pties[o] : 0;
      int ttotal;
      tb = tie_run + block_excl_scan(ties, &ttotal, sh_scan);
      const long long left = budget - tb;
      kept = left <= 0 ? 0 : (left < ties ? (int)left : ties);
      c += kept;
      tie_run += ttotal;
      if (t < ntiles) tie_base[o] = (int)tb;
    }
    int total;
    const int ex = block_excl_scan(c, &total, sh_scan);
    if (t < ntiles) {
      const long long b = running + ex;
      base[o] = (int)b;
      nz += pnzc[o];
      ps += (PK == kTopk ? (double)pcnt[o] : ppsum[o]) + kept;
      dn += pden[o];
      if (b + c <= k_cap) {
        vs += pvsq[o] + (double)kept * (double)t2;
        vm = fmaxf(vm, pvmx[o]);
        if (kept > 0) vm = fmaxf(vm, s1);
      } else if (b < k_cap) {          // at most one tile straddles k_cap
        sh_straddle[0] = t;
        sh_straddle[1] = b;
        sh_straddle[2] = tb;
      }
    }
    running += total;
  }
  __syncthreads();
  const long long st = sh_straddle[0];
  if (st >= 0) {
    const T* grow = g + row * d;
    const int64_t start = st * kTile;
    const int64_t end = row_end(d, start);
    long long rank0 = sh_straddle[1], tie_rank = sh_straddle[2];
    __shared__ SweepCounts sh_sweep;
    int par = 0;
    for (int64_t s = start; s < end; s += kSweep, par ^= 1) {  // uniform
      const int64_t i = s + threadIdx.x * kItems;
      float x[kItems], r[kItems];
      load_items(grow, i, end, vec_g, x);
      if constexpr (PK != kTopk) load_items(u + row * d, i, end, vec_u, r);
      int first, total;
      const unsigned zm = sweep_ranks<PK>(x, r, valid_items(i, end), s1,
                                          s2, budget, &tie_rank, sh_sweep,
                                          par, &first, &total);
      long long rk = rank0 + first;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if ((zm >> k) & 1u) {
          if (rk < k_cap) {
            float v = kept_value<PK>(x[k], s1, s2);
            if (round_v) v = to_f32(from_f32<T>(v));
            const float v2 = v * v;
            vs += v2;
            vm = fmaxf(vm, fabsf(v));
          }
          ++rk;
        }
      }
      rank0 += total;
    }
  }
  __shared__ long long sh_l[32];
  __shared__ double sh_d[32];
  __shared__ float sh_f[32];
  nz = block_sum(nz, sh_l);
  ps = block_sum(ps, sh_d);
  dn = block_sum(dn, sh_d);
  vs = block_sum(vs, sh_d);
  vm = block_max(vm, sh_f);
  if (threadIdx.x == 0) {
    cnt_out[row] = (int)running;
    nzc_out[row] = (int)nz;
    psum_out[row] = (float)ps;
    den_out[row] = (float)dn;
    vsq_out[row] = (float)vs;
    vmx_out[row] = vm;
  }
}

// The integer codecs' level of one kept value, in codecs.py's order of
// operations, each step rounded on its own (no contraction into an FMA), so
// that the level is the JAX package's bit for bit:
//   qsgd:    scaled = (|v| / scale) * s, lo = floor(scaled),
//            level = lo + (u < scaled - lo)
//   ternary: level = u < |v| / scale
// (|v| / scale is 0 where scale <= 0), signed like v.
__device__ __forceinline__ float int_level(float v, float scale, float uc,
                                           float levels, int ternary) {
  const float q = scale > 0.f ? __fdiv_rn(fabsf(v), scale) : 0.f;
  float level;
  if (ternary) {
    level = uc < q ? 1.f : 0.f;
  } else {
    const float scaled = __fmul_rn(q, levels);
    const float lo = floorf(scaled);
    level = __fadd_rn(lo, uc < __fsub_rn(scaled, lo) ? 1.f : 0.f);
  }
  return v < 0.f ? -level : level;
}

template <typename W> struct IntWire : std::false_type {};
template <> struct IntWire<int8_t> : std::true_type {};
template <> struct IntWire<int16_t> : std::true_type {};

// ---------------------------------------------------------------------------
// Kernel 4: pass 2. Re-derive the kept mask and write survivor j of the row
// (j = base + in-block rank < k_cap) to slot j: idx the row coordinate and
// the value in the wire dtype W. A float W takes v rounded; an integer W
// (qsgd, ternary) the codec level of v from the row's scale and u_cod[row,
// j], the codec uniform at the survivor's compact rank; with no u_cod
// (`ucod` null) the deterministic rounding of the pod stage's compaction:
// every uniform is kDetU, the float32 just below 0.5, so that `u < frac`
// holds exactly where frac >= 0.5 (qsgd rounds up, ternary keeps p >=
// 0.5, as the JAX codecs do without a key). With `res` (float
// codecs) the EF residual g - encoded value is written for every coordinate,
// overflow-dropped survivors included; the encoded value is the codec's
// output in float32, so it is W-rounded only for a rounding codec
// (`round_res`: bf16), as on the TPU. The integer codecs' EF subtracts the
// decoded level, a product formed after the exchange's scale is known: the
// backend scatters it from the compact buffers instead. Slots past the
// row's live prefix, [min(nnz, k_cap), k_cap), get idx 0 and value 0.
//
// Bound: one read of g (and u), one write of the residual with EF, the
// compact slots (and an integer codec's uniform per live slot): 10 B/coord
// for bf16 g with f32 uniforms and the residual, 8 without, 2-4 for topk.
// A straightforward port runs at 20-50 % of that: 8 scalar 2-byte
// residual stores a thread, 16 bytes apart across a warp (10.5 of 17.8 ms
// a step at gemma-2b), two block scans a sweep (topk three) and a memset
// of both compact buffers. The design, for the card:
// - the residual leaves as 16-byte vectors (store_items, one per 8 bf16)
//   wherever its row base is aligned and d % 8 == 0 (`vec_r`), scalar only
//   at a ragged end or an unaligned row;
// - a survivor's rank: each thread's survivors (and topk's ties) counted
//   by popc of its item masks, one int (ties in the high half) scanned
//   across the warp with five shuffles, the warps' totals in shared
//   memory double-buffered by sweep parity (sweep_ranks): one barrier a
//   sweep, and topk's tie ranks follow from the same shared counts, so
//   ties cost no scan where there are ties and nothing where there are
//   none;
// - the next sweep's g (16 B) and u (2 x 16 B) loads are issued into
//   registers (Chunk) before this sweep's ranks, barrier and stores, so
//   they are in flight across the barrier (register double-buffering,
//   kept over a cp.async ring: the loads need no shared memory, and the
//   ring's waits would add barriers);
// - what remains is issue-bound, not memory-bound, for the selectors that
//   read little (topk reads 2 B/coord): the sweep counts in 32 bits, and
//   only a thread's kept items are visited (a loop over the set bits of
//   its mask, the item picked from registers by a select tree), so a warp
//   runs its store path as often as its fullest lane keeps, about twice a
//   sweep at 5 % density, not 8 times behind per-item branches;
// - the dead slots are zeroed by the row's blocks, each its share, before
//   their sweeps, so the buffers come from torch.empty; at a capacity of a
//   whole row (k_cap >= d: bern's, nearly every slot dead) the launcher
//   memsets both buffers instead, which measured faster there;
// - without EF a block whose base rank is at least k_cap returns after
//   its share of the dead slots.
// ptxas (-Xptxas -v, sm_90a, 4 blocks an SM): 50-64 registers, no spills
// in any instantiation (chip_smoke prints the lines).
// ---------------------------------------------------------------------------

constexpr int kCodStage = 2048;     // codec uniforms a block stages
// nextafterf(0.5f, 0.f): the deterministic rounding's uniform
#define kDetU __int_as_float(0x3effffff)

// A 4-byte asynchronous copy from device to shared memory (cp.async: no
// register holds it in flight), and the wait for this thread's copies.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Item k of a thread's kItems registers, k known only at run time: a tree
// of selects, so the array stays in registers.
__device__ __forceinline__ float pick(const float x[kItems], int k) {
  const bool b0 = k & 1, b1 = k & 2;
  const float p0 = b0 ? x[1] : x[0], p1 = b0 ? x[3] : x[2];
  const float p2 = b0 ? x[5] : x[4], p3 = b0 ? x[7] : x[6];
  const float q0 = b1 ? p1 : p0, q1 = b1 ? p3 : p2;
  return (k & 4) ? q1 : q0;
}

template <int PK, typename T, typename W>
__global__ void __launch_bounds__(kThreads, 4)
compact_emit(const T* __restrict__ g, const float* __restrict__ u, int64_t d,
             int64_t ntiles, int vec_g, int vec_u, int vec_r,
             const float* __restrict__ s1p, const float* __restrict__ s2p,
             const long long* __restrict__ budgetp,
             const int* __restrict__ base, const int* __restrict__ tie_base,
             const int* __restrict__ nnz, int64_t k_cap, W* __restrict__ vals,
             int* __restrict__ idx, T* __restrict__ res, int round_res,
             const float* __restrict__ scale, const float* __restrict__ ucod,
             float levels, int ternary, int zero_dead) {
  constexpr bool kInt = IntWire<W>::value;
  // coordinates, ranks and k_cap are below 2^31 (the wrapper checks), so
  // the sweeps count in 32 bits; only row bases are 64-bit
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t o = row * ntiles + tile;
  W* vrow = vals + row * k_cap;
  int* irow = idx + row * k_cap;
  const int kc = (int)k_cap;
  const int n_row = nnz[row];
  const int tile_rank = base[o];
  if (zero_dead) {   // this block's share of [min(nnz, k_cap), k_cap)
    const int live = n_row < kc ? n_row : kc;
    const int share = (int)((kc - live + ntiles - 1) / ntiles);
    const int64_t a = live + tile * share;
    const int64_t b = a + share < kc ? a + share : kc;
    if (a < b) {
      zero_bytes(reinterpret_cast<unsigned char*>(vrow), a * sizeof(W),
                 b * sizeof(W));
      zero_bytes(reinterpret_cast<unsigned char*>(irow), a * 4, b * 4);
    }
  }
  if (res == nullptr && tile_rank >= kc) return;   // uniform over the block
  const float s1 = s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const long long budget = PK == kTopk ? budgetp[row] : 0;
  long long tie_rank = PK == kTopk ? tie_base[o] : 0;
  const float sc = kInt ? scale[row] : 1.f;
  const float* ucrow = kInt && ucod != nullptr ? ucod + row * k_cap
                                                : nullptr;
  const T* grow = g + row * d;
  const float* urow = PK == kTopk ? nullptr : u + row * d;
  T* rrow = res == nullptr ? nullptr : res + row * d;
  const int start = (int)(tile * kTile);
  const int end = (int)row_end(d, start);
  __shared__ SweepCounts sh;
  // the integer codecs read u_cod at compact rank: the block's ranks are
  // [base, next base), so their first kCodStage uniforms are copied to
  // shared memory as the block starts, off the sweeps' critical path
  __shared__ float sh_cod[kInt ? kCodStage : 1];
  int staged = 0;
  if constexpr (kInt) {
    if (ucrow != nullptr) {     // none to stage in the deterministic mode
      const int next = tile + 1 < ntiles ? base[o + 1] : n_row;
      const int hi = next < kc ? next : kc;
      staged = hi - tile_rank < kCodStage ? hi - tile_rank : kCodStage;
      for (int j = threadIdx.x; j < staged; j += kThreads)
        cp_async4(sh_cod + j, ucrow + tile_rank + j);
    }
  }
  Chunk<T> gc;
  Chunk<float> uc;
  load_chunk(grow, start + threadIdx.x * kItems, end, vec_g, gc);
  if constexpr (PK != kTopk)
    load_chunk(urow, start + threadIdx.x * kItems, end, vec_u, uc);
  if constexpr (kInt) cp_async_wait_all();   // seen by all after a barrier
  int rank0 = tile_rank;
  int par = 0;
  for (int s = start; s < end; s += kSweep, par ^= 1) {   // uniform
    const int i = s + threadIdx.x * kItems;
    float x[kItems], r[kItems];
    unpack(gc, x);
    if constexpr (PK != kTopk) unpack(uc, r);
    // the next sweep's loads (none past the tile) fly across the barrier
    load_chunk(grow, i + kSweep, end, vec_g, gc);
    if constexpr (PK != kTopk) load_chunk(urow, i + kSweep, end, vec_u, uc);
    int first, total;
    const unsigned zm = sweep_ranks<PK>(x, r, valid_items(i, end), s1, s2,
                                        budget, &tie_rank, sh, par, &first,
                                        &total);
    // only the kept items: a warp loops as often as its fullest lane keeps
    int rk = rank0 + first;
    for (unsigned m = zm; m != 0u; m &= m - 1u, ++rk) {
      const int k = __ffs(m) - 1;
      const float xk = pick(x, k);
      const float v = kept_value<PK>(xk, s1, s2);
      if (rk < kc) {
        if constexpr (kInt) {
          const int j = rk - tile_rank;
          const float uk = ucrow == nullptr ? kDetU
                           : j < staged ? sh_cod[j] : ucrow[rk];
          vrow[rk] = (W)(int)int_level(v, sc, uk, levels, ternary);
        } else {
          vrow[rk] = from_f32<W>(v);
        }
        irow[rk] = i + k;
      }
      if constexpr (!kInt) {               // the residual, in place of x
        const float rk_res = xk - (round_res ? to_f32(from_f32<W>(v)) : v);
#pragma unroll
        for (int kk = 0; kk < kItems; ++kk) x[kk] = kk == k ? rk_res : x[kk];
      }
    }
    if constexpr (!kInt)
      if (rrow != nullptr) store_items(rrow, i, end, vec_r, x);
    rank0 += total;
  }
}

// ---------------------------------------------------------------------------
// Kernel 4b: Golomb-Rice packing of the compact index stream (the RICE wire
// layout), from pass 2's ascending idx[rows, k_cap] and pass 1's nnz. Per
// row, with n_live = min(nnz, k_cap), live code i has x_i = idx_i - idx_{i-1}
// - 1 (idx_{-1} = -1) and q_i = x_i >> r; dead codes have x = 0. The stream
// is [k_cap*r remainder bits | unary field] in cap_words int32 words,
// zeroed before the launch: the low r bits of x_i at bit i*r; in the unary
// field code i's q_i one-bits and then its terminator (a zero) at unary
// position sum_{j<=i} q_j + i, so every bit below live_end = sum q + n_live
// is a one except at terminators, and the dead codes' terminators and
// everything after are zeros. used = ceil((k_cap*r + sum q + k_cap) / 32).
//
// The TPU packs inside pass 2 and carries the previous coordinate and the
// running quotient sum across its sequential grid in SMEM. Here the packing
// reads the compact buffer after pass 2. A straightforward port takes
// four launches, reads idx twice, sets each terminator with a global
// atomicOr (about 1e8 a step at gemma-2b, up to 8 lanes of a warp on one
// word) and flips the unary words in a second pass: 2.2 ms a step against
// a 0.185 ms bound. Here, one launch after one memset (the words and the
// status words):
// - each thread owns kRiceItems consecutive codes (16-byte idx loads and
//   the code before them), so each live idx is read once; dead codes are
//   never read. The kernel is bound by latency, not bytes: a block's loads
//   are in flight only between its ticket and its look-back, so the block
//   takes 16 codes a thread (4096) at 6 blocks an SM, which measured
//   faster than 8, 12, 20 or 32 codes at the occupancy each allows;
// - the unary base of a block (the quotient sum of the row's codes before
//   it) comes from a single-pass chained scan with decoupled look-back over
//   per-block quotient sums (a status word per block: aggregate or
//   inclusive prefix). Blocks take their (row, block) from a ticket
//   (atomicAdd), so a block only ever waits on blocks that have started;
//   the row's last block writes `used`; warp 0 looks back while the other
//   warps' remainder words are stored. (Persistent blocks that prefetch
//   their next tile measured slower: every block held a ticket whose
//   aggregate it published a whole tile later, and look-backs walked back
//   over all the tiles in flight.);
// - a warp's codes own a contiguous span of the unary field. Once the base
//   is known, the warp stages it in shared memory a window of kRiceWin
//   words at a time (the span's bits set, each terminator cleared with a
//   shared atomicAnd) and stores the words plainly; only the span's first
//   and last word, shared with the neighbouring warp or block, take one
//   global atomicOr each. A window without terminators (a long quotient: a
//   single code at d - 1, r = 0) is stored as whole words of ones without
//   staging. (Staging the span from a word boundary before the base, while
//   warp 0 looks back, and storing it shifted after, measured slower.);
// - the warp's remainders fill exactly kRiceItems * r whole words: each
//   lane ORs its codes into them in shared memory and the words are stored
//   plainly; only the word where the remainder field meets the unary field
//   takes a global atomicOr.
// Bound: one read of each row's live idx prefix (4 B per live code) and one
// write of the words; the memset (which keeps the words past `used` zero)
// adds one more write of them.
// ptxas (-Xptxas -v, sm_90a, 6 blocks an SM): 40 registers, a 16-byte
// stack frame (12 bytes of spill stores), 15 KB of shared memory.
//
// The fitted variant (kFitted, wire-format v4) reads each row's r from
// r_rows (rice_fit's output) instead of one r for the group, packs into
// the fitted capacity (the window's largest) and writes the header
// (r << kHdrShift) | used in place of used. The static instantiation is
// the kernel above, unchanged.
// ---------------------------------------------------------------------------

constexpr int kRiceItems = 16;                     // codes per thread
constexpr int kRiceMinBlocks = 6;                  // blocks an SM holds
constexpr int64_t kRiceTile = kRiceItems * kThreads;   // codes per block
constexpr int kRiceCodes = kRiceItems * 32;            // codes per warp
constexpr int kRiceWin = 256;                      // staged words per warp
// a warp's staging buffer: its remainder words (r <= 30) or a unary window
constexpr int kRiceBuf = 30 * kRiceItems > kRiceWin ? 30 * kRiceItems
                                                     : kRiceWin;
constexpr int kHdrShift = 26;                      // fitted counts header
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// A status word carries its value in its own 64 bits, so the look-back
// needs no ordering beyond single-copy atomicity: relaxed loads and stores
// at device scope (no L1 copy).
__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename V> __device__ __forceinline__ V warp_allsum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Run by one warp of block b > 0, after b published its aggregate: look
// back over its predecessors 32 at a time until one holds an inclusive
// prefix, and return b's exclusive prefix (the quotients before it).
// (A window of 256, 8 words a lane, measured slower: the nearest prefix
// lies within 32 tiles, and the wide window waits on more of them.)
__device__ long long rice_lookback(const unsigned long long* __restrict__ st,
                                   int64_t b) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int64_t top = b - 1;; top -= 32) {
    const int64_t j = top - lane;
    unsigned long long f = j >= 0 ? ld_status(st + j) : kPrefix;
    while (__any_sync(kFull, (f >> 32) == 0))
      if ((f >> 32) == 0) f = ld_status(st + j);
    const unsigned pre = __ballot_sync(kFull, (f >> 32) == 2);
    const int last = pre ? __ffs(pre) - 1 : 31;   // the nearest prefix
    excl += warp_allsum(lane <= last ? (long long)(f & 0xffffffffu) : 0ll);
    if (pre) return excl;
  }
}

// The bits of word wi that lie in [lo, hi] (bit positions from a word
// boundary).
__device__ __forceinline__ unsigned span_bits(unsigned wi, unsigned lo,
                                              unsigned hi) {
  const unsigned wb = wi * 32u;
  const unsigned a = (lo > wb ? lo : wb) - wb;
  const unsigned e = (hi < wb + 31u ? hi : wb + 31u) - wb;
  const unsigned upto = e >= 31u ? ~0u : (1u << (e + 1u)) - 1u;
  return upto & ~((1u << a) - 1u);
}

template <bool kFitted>
__global__ void __launch_bounds__(kThreads, kRiceMinBlocks)
rice_pack(const int* __restrict__ idx, const int* __restrict__ nnz,
          int64_t k_cap, int r_group, const int* __restrict__ r_rows,
          int64_t nb, int64_t cap_words, int vec,
          unsigned long long* __restrict__ status,
          unsigned* __restrict__ words, int* __restrict__ used) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t row = blockIdx.y;
  const int r = kFitted ? r_rows[row] : r_group;
  unsigned long long* st = status + row * nb;   // the row's status words
  __shared__ unsigned long long sh_ticket;
  __shared__ int sh_warp[kWarps];
  __shared__ long long sh_base;
  __shared__ unsigned sh_buf[kWarps][kRiceBuf];
  const int64_t nl = nnz[row];           // in flight with the ticket
  if (threadIdx.x == 0)                  // the row's tickets follow all rows'
    sh_ticket = atomicAdd(status + gridDim.y * nb + row, 1ull);  // status
  __syncthreads();
  const int64_t b = (int64_t)sh_ticket;  // blocks of the row, in start order
  const int* irow = idx + row * k_cap;
  const int64_t n_live = nl < k_cap ? nl : k_cap;
  const int64_t c0 = b * kRiceTile + threadIdx.x * kRiceItems;  // my first
  // my live codes: a prefix of mine, as live codes are a prefix of the row
  const int nk = c0 >= n_live ? 0 : (n_live - c0 < kRiceItems
                                     ? (int)(n_live - c0) : kRiceItems);
  int x[kRiceItems];                     // idx, then gap - 1 (0 when dead)
  if (vec && nk == kRiceItems) {
#pragma unroll
    for (int v = 0; v < kRiceItems / 4; ++v) {
      const int4 q = *reinterpret_cast<const int4*>(irow + c0 + 4 * v);
      x[4 * v] = q.x; x[4 * v + 1] = q.y; x[4 * v + 2] = q.z;
      x[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRiceItems; ++k) x[k] = k < nk ? irow[c0 + k] : 0;
  }
  int prev = c0 > 0 && nk > 0 ? irow[c0 - 1] : -1;
  int qs = 0;
#pragma unroll
  for (int k = 0; k < kRiceItems; ++k) {
    const int cur = x[k];
    x[k] = k < nk ? cur - prev - 1 : 0;
    prev = cur;
    qs += x[k] >> r;
  }
  // quotient sums: in the warp by shuffles, across warps in shared memory
  int inc = qs;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) sh_warp[w] = inc;
  __syncthreads();
  int wpre = 0, agg = 0;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const int c = sh_warp[j];
    if (j < w) wpre += c;
    agg += c;
  }
  if (threadIdx.x == 0)                  // publish at once: the row's first
    st_status(st + b, (b == 0 ? kPrefix : kAggregate) | (unsigned)agg);
  // a block past the live codes has an aggregate of 0 and nothing to
  // write; only the row's last block looks back over such blocks (for
  // `used`), so the others leave at once instead of waiting on the row
  if (b * kRiceTile >= n_live && b > 0 && b < nb - 1) return;

  const int64_t cw = b * kRiceTile + (int64_t)w * kRiceCodes;  // warp's first
  const bool live = cw < n_live;         // a live code in this warp
  unsigned* wrow = words + row * cap_words;
  unsigned* buf = sh_buf[w];
  const int64_t rem_bits = k_cap * r;    // the remainder field, then unary

  // This warp's kRiceItems * r remainder words need no base: they are
  // written while warp 0 looks back.
  if (live && r > 0) {
    const int nw = kRiceItems * r;
    const unsigned rmask = (1u << r) - 1u;
    for (int j = lane; j < nw; j += 32) buf[j] = 0u;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRiceItems; ++k) {
      const unsigned rem = (unsigned)x[k] & rmask;
      if (rem) {
        const int bit = (lane * kRiceItems + k) * r;
        const int off = bit & 31;
        atomicOr(buf + (bit >> 5), rem << off);
        if (off + r > 32) atomicOr(buf + (bit >> 5) + 1, rem >> (32 - off));
      }
    }
    __syncwarp();
    const int64_t w0 = cw / 32 * r;      // cw is a multiple of 32
    unsigned* rw = wrow + w0;
    // words [0, full) lie wholly in the remainder field; word `full` meets
    // the unary field when the field does not end on a word
    const int64_t full64 = rem_bits / 32 - w0;
    const int full = full64 < nw ? (int)full64 : nw;
    for (int j = lane; j < nw; j += 32) {
      const unsigned v = buf[j];
      if (!v) continue;                  // the memset's zero stays
      if (j < full) rw[j] = v;
      else if (j == full) atomicOr(rw + j, v);
    }
    __syncwarp();
  }
  if (w == 0) {
    const long long excl = b == 0 ? 0 : rice_lookback(st, b);
    if (lane == 0) {
      sh_base = excl;
      if (b > 0) st_status(st + b, kPrefix | (unsigned)(excl + agg));
    }
  }
  __syncthreads();
  const long long qbase = sh_base;     // quotients of the row's earlier blocks
  if (b == nb - 1 && threadIdx.x == 0) {
    const int u = (int)((k_cap * r + qbase + agg + k_cap + 31) / 32);
    used[row] = kFitted ? (r << kHdrShift) | u : u;
  }
  if (!live) return;

  // The unary span of this warp's live codes, in bits from the word `ws`
  // that holds its first bit: [lo, hi], from the first code's first
  // one-bit (or terminator) to the last live code's terminator. My codes'
  // terminators follow from my quotient prefix in the warp.
  const int64_t p = rem_bits + qbase + wpre + cw;
  const int64_t ws = p >> 5;
  unsigned* wspan = wrow + ws;
  const int64_t wleft = cap_words - ws;  // (every span fits: capacity bound)
  const int last = n_live - cw < kRiceCodes ? (int)(n_live - cw) - 1
                                            : kRiceCodes - 1;
  const unsigned lo = (unsigned)(p & 31);
  const unsigned hi = lo + (unsigned)sh_warp[w] + (unsigned)last;
  const unsigned tme = lo + (unsigned)(inc - qs) +
                       (unsigned)(lane * kRiceItems);
  const unsigned mine_lo = tme + (unsigned)(x[0] >> r);     // when nk > 0
  const unsigned mine_hi = tme + (unsigned)qs + (unsigned)(nk - 1);
  const unsigned nwords = (hi >> 5) + 1u;
  for (unsigned wa = 0; wa < nwords; wa += kRiceWin) {
    const unsigned wz = wa + kRiceWin < nwords ? wa + kRiceWin : nwords;
    const bool mine = nk > 0 && (mine_lo >> 5) < wz && (mine_hi >> 5) >= wa;
    const bool staged = __any_sync(kFull, mine);  // terminators lie here
    if (staged) {
      for (unsigned j = lane; j < wz - wa; j += 32)
        buf[j] = span_bits(wa + j, lo, hi);
      __syncwarp();
      if (mine) {
        unsigned t = tme;
#pragma unroll
        for (int k = 0; k < kRiceItems; ++k) {
          t += (unsigned)(x[k] >> r);
          const unsigned tw = (t + k) >> 5;   // code c0 + k's terminator
          if (k < nk && tw >= wa && tw < wz)
            atomicAnd(buf + (tw - wa), ~(1u << ((t + k) & 31)));
        }
      }
      __syncwarp();
    }
    for (unsigned j = lane; j < wz - wa; j += 32) {
      const unsigned wi = wa + j;
      if ((int64_t)wi >= wleft) break;
      const unsigned v = staged ? buf[j] : span_bits(wi, lo, hi);
      if ((wi == 0 && lo) || (wi == nwords - 1 && (hi & 31) != 31)) {
        if (v) atomicOr(wspan + wi, v);  // shared with a neighbour
      } else {
        wspan[wi] = v;
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// rice_fit: the data-fitted Golomb-Rice parameter of each row (wire-format
// v4), from pass 2's ascending idx[rows, k_cap] and pass 1's nnz. It
// replaces the candidate sweep and argmin of XLA's rice_encode_fitted
// (src/repro/comm/compaction.py:300-324), which packs the row at every r of
// the window and keeps the shortest stream. Only the used word counts
// decide, and candidate r's count is ceil((k_cap r + S_r + k_cap) / 32) with
// S_r = sum over live codes of (gap - 1) >> r (dead codes code 0): one
// number per candidate. So each block reads kRiceTile codes of a row's
// live prefix once (kRiceItems consecutive codes a thread and the code
// before them, as rice_pack reads them), reduces S_r for every candidate
// (at most kFitMax) in int64, and adds it to the row's accumulator with one
// atomicAdd per candidate (integer adds, so the order of the blocks does
// not matter); blocks past the live prefix read nothing. A one-thread-a-row
// finish forms the counts, takes the first minimum over the ascending
// window and writes r and the header (r << kHdrShift) | used, which the
// fitted rice_pack then packs at. Bound: one read of each row's live idx
// prefix (4 B per live code); the accumulators and outputs are 40 B a row.
// ---------------------------------------------------------------------------

constexpr int kFitMax = 4;                         // candidates of a window

__global__ void __launch_bounds__(kThreads)
rice_fit_tiles(const int* __restrict__ idx, const int* __restrict__ nnz,
               int64_t k_cap, int4 window, int vec,
               unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t row = blockIdx.y, b = blockIdx.x;
  const int64_t nl = nnz[row];
  const int64_t n_live = nl < k_cap ? nl : k_cap;
  if (b * kRiceTile >= n_live) return;    // the whole block is dead codes
  const int* irow = idx + row * k_cap;
  const int64_t c0 = b * kRiceTile + threadIdx.x * kRiceItems;
  const int nk = c0 >= n_live ? 0 : (n_live - c0 < kRiceItems
                                     ? (int)(n_live - c0) : kRiceItems);
  int x[kRiceItems];
  if (vec && nk == kRiceItems) {
#pragma unroll
    for (int v = 0; v < kRiceItems / 4; ++v) {
      const int4 q = *reinterpret_cast<const int4*>(irow + c0 + 4 * v);
      x[4 * v] = q.x; x[4 * v + 1] = q.y; x[4 * v + 2] = q.z;
      x[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRiceItems; ++k) x[k] = k < nk ? irow[c0 + k] : 0;
  }
  const int rs[kFitMax] = {window.x, window.y, window.z, window.w};
  long long sum[kFitMax] = {0, 0, 0, 0};
  int prev = c0 > 0 && nk > 0 ? irow[c0 - 1] : -1;
#pragma unroll
  for (int k = 0; k < kRiceItems; ++k) {
    if (k < nk) {
      const int gap1 = x[k] - prev - 1;
      prev = x[k];
#pragma unroll
      for (int c = 0; c < kFitMax; ++c) sum[c] += gap1 >> rs[c];
    }
  }
  __shared__ long long sh[kWarps][kFitMax];
#pragma unroll
  for (int c = 0; c < kFitMax; ++c) {
    const long long v = warp_allsum(sum[c]);
    if (lane == 0) sh[w][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kFitMax) {
    long long t = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) t += sh[j][threadIdx.x];
    if (t) atomicAdd(acc + row * kFitMax + threadIdx.x,
                     (unsigned long long)t);
  }
}

__global__ void rice_fit_finish(const unsigned long long* __restrict__ acc,
                                int64_t rows, int64_t k_cap, int nw,
                                int4 window, int* __restrict__ r_out,
                                int* __restrict__ header) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int rs[kFitMax] = {window.x, window.y, window.z, window.w};
  long long best = -1;
  int best_r = rs[0];
  for (int c = 0; c < nw; ++c) {    // the first minimum: strict <
    const long long u = (k_cap * rs[c] + (long long)acc[row * kFitMax + c]
                         + k_cap + 31) / 32;
    if (best < 0 || u < best) {
      best = u;
      best_r = rs[c];
    }
  }
  r_out[row] = best_r;
  header[row] = (best_r << kHdrShift) | (int)best;
}

// ---------------------------------------------------------------------------
// Kernels 5, 6 and 8: the dense Q(g) of the dense wire, for every selector
// kind and value codec of Scheme.apply_dense (src/repro/core/schemes.py:272).
// Per coordinate, in float32:
//   kLam, kRho, kBern  p = keep_prob<PK>, z = u < p, v = z ? g / p : 0
//   kTopk              z = |g| > t, or a tie among the first `budget` of the
//                      row (the tie base of the tile from pass 1), v = z ? g : 0
//   kOne (identity)    p = 1, v = g
// then v is rounded to the leaf type T (apply_mask's cast), and the codec
// gives q: a float codec rounds v to the wire type W (f32: T, bf16); an
// integer codec (kInt: qsgd, ternary) takes the level of v from the row's
// scale and the codec uniform of the coordinate and writes the decoded
// level in T: level * (scale / levels) for qsgd, level * scale for ternary,
// each product and quotient rounded on its own (no FMA: nvcc contracts by
// default), as codecs.py parenthesises the decode. With kEF the residual
// g - float(q) after that rounding is written in T (kernel 6, as
// _sparsify_ef_body subtracts the stored Q); with kPrng (kLam, float codec
// only) the uniforms come from Philox4x32-10 in the kernel instead of an
// input buffer (kernel 8). A kept value is g / p exactly (an unkept one +0;
// apply_mask's Z * g / p gives -0 for a negative g there: the values are
// equal). The same pass reduces per (row, tile) what the dense wire's
// accounting reads of q as the wire carries it: the nonzeros, those with
// p = 1 and sum q^2 (a thread's sweep in f32, then f64 partials), so no
// torch reduction walks the 2.5e9 coordinates again; and, where `pden` is
// given (unisp, Algorithm 2, identity with a float codec: no earlier pass
// of theirs reduces it; never kernel 8), sum g^2 the same way. A finish
// kernel per row sums the partials.
// topk ranks its ties with one block scan a sweep (sweep_ranks), so the
// sweep loop runs uniformly over the block.
//
// Bound: one read of g (and of the f32 uniforms, and of an integer codec's
// f32 uniforms), one write of Q (and of the residual): 8 B/coord for bf16
// g and Q with the sampling selectors (12 with an integer codec), 10 and 14
// with the residual, 4 (6) for topk and identity, 4 B with the uniforms
// from Philox. Loads and stores are 16-byte vectors where every row base is
// aligned and d % 8 == 0 (one for 8 bf16, two for 8 f32), scalar at a
// ragged end.
//
// Philox. The TPU seeds its on-core generator per tile (kernel.py:84-85), so
// its stream depends on the tiling. Here the key is (seed, 0) and the
// counter (i / 4, row, 0, 0): one call gives the four uniforms of
// coordinates i..i+3, u = (bits >> 8) * 2^-24, whatever the tile size.
// ---------------------------------------------------------------------------

enum : int { kOne = 4 };   // the identity selector (the dense wire only)

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float philox_uniform(unsigned b) {
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

template <int PK, typename T, typename W, bool kInt, bool kEF, bool kPrng>
__global__ void __launch_bounds__(kThreads)
sparsify_tiles(const T* __restrict__ g, const float* __restrict__ u,
               int64_t d, int64_t ntiles, int vec,
               const float* __restrict__ s1p, const float* __restrict__ s2p,
               const long long* __restrict__ budgetp,
               const int* __restrict__ tie_base, unsigned seed,
               const float* __restrict__ scalep,
               const float* __restrict__ ucod, float levels, int ternary,
               W* __restrict__ q, T* __restrict__ res,
               int* __restrict__ pcnt, int* __restrict__ psure,
               double* __restrict__ psq, double* __restrict__ pden) {
  constexpr bool kSample = PK != kTopk && PK != kOne;
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const float s1 = PK == kOne ? 0.f : s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const long long budget = PK == kTopk ? budgetp[row] : 0;
  long long tie_rank = PK == kTopk ? tie_base[row * ntiles + tile] : 0;
  const float sc = kInt ? scalep[row] : 0.f;
  // the decode's factor: scale / levels (qsgd) or the scale (ternary)
  const float step = kInt && !ternary ? __fdiv_rn(sc, levels) : sc;
  const T* grow = g + row * d;
  W* qrow = q + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  __shared__ SweepCounts sh;
  int cnt = 0, sure = 0, par = 0;
  double sq = 0.0, dn = 0.0;
  for (int64_t s = start; s < end; s += kSweep, par ^= 1) {   // uniform
    const int64_t i = s + threadIdx.x * kItems;
    float x[kItems], r[kItems], c[kItems], w[kItems];
    load_items(grow, i, end, vec, x);
    if constexpr (kPrng) {
      // i % 8 == 0: two counters give the thread's eight uniforms
      const uint2 key = make_uint2(seed, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 b = philox4x32_10(
            make_uint4((unsigned)((i >> 2) + h), (unsigned)row, 0u, 0u), key);
        r[4 * h] = philox_uniform(b.x);
        r[4 * h + 1] = philox_uniform(b.y);
        r[4 * h + 2] = philox_uniform(b.z);
        r[4 * h + 3] = philox_uniform(b.w);
      }
    } else if constexpr (kSample) {
      load_items(u + row * d, i, end, vec, r);
    }
    if constexpr (kInt) load_items(ucod + row * d, i, end, vec, c);
    unsigned zm = 0u;
    if constexpr (PK == kTopk) {
      int first, total;
      zm = sweep_ranks<kTopk>(x, r, valid_items(i, end), s1, s2, budget,
                              &tie_rank, sh, par, &first, &total);
    }
    // a sweep's squares summed in f32, converted to f64 once a sweep (64-bit
    // conversions issue at 16 a clock an SM): 8 non-negative terms, so
    // within 8 ulps (about 4.8e-7) relative
    if constexpr (!kPrng) {
      if (pden != nullptr) {              // uniform over the grid
        float dn8 = 0.f;
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          if (i + k < end) dn8 = __fadd_rn(dn8, __fmul_rn(x[k], x[k]));
        dn += dn8;
      }
    }
    float sq8 = 0.f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool valid = i + k < end;
      float v;
      bool one;                          // p = 1 at this coordinate
      if constexpr (PK == kOne) {
        v = x[k];
        one = true;
      } else if constexpr (PK == kTopk) {
        one = (zm >> k) & 1u;
        v = one ? x[k] : 0.f;
      } else {
        const Sample o = sample<PK>(x[k], r[k], s1, s2, valid);
        v = o.v;
        one = o.p >= 1.f;
      }
      float e;
      if constexpr (kInt) {
        v = to_f32(from_f32<T>(v));
        const float level = (float)(int)int_level(v, sc, c[k], levels,
                                                  ternary);
        e = to_f32(from_f32<W>(__fmul_rn(level, step)));
      } else {
        // rounding to T first changes nothing here: T is f32, or W = T
        e = to_f32(from_f32<W>(v));
      }
      w[k] = e;
      if (valid && e != 0.f) {
        ++cnt;
        sure += one;
        sq8 = __fadd_rn(sq8, __fmul_rn(e, e));
      }
    }
    sq += sq8;
    store_items(qrow, i, end, vec, w);
    if constexpr (kEF) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) x[k] = x[k] - w[k];
      store_items(res + row * d, i, end, vec, x);
    }
  }
  __shared__ int sh_i[32];
  __shared__ double sh_d[32];
  cnt = block_sum(cnt, sh_i);
  sure = block_sum(sure, sh_i);
  sq = block_sum(sq, sh_d);
  if (pden != nullptr) dn = block_sum(dn, sh_d);
  if (threadIdx.x == 0) {
    const int64_t o = row * ntiles + tile;
    pcnt[o] = cnt;
    psure[o] = sure;
    psq[o] = sq;
    if (pden != nullptr) pden[o] = dn;
  }
}

__global__ void __launch_bounds__(kThreads)
sparsify_finish(const int* __restrict__ pcnt, const int* __restrict__ psure,
                const double* __restrict__ psq,
                const double* __restrict__ pden, int64_t ntiles,
                long long* __restrict__ cnt, long long* __restrict__ sure,
                float* __restrict__ sq, float* __restrict__ den) {
  const int64_t row = blockIdx.x;
  long long c = 0, s = 0;
  double q = 0.0, dn = 0.0;
  for (int64_t t = threadIdx.x; t < ntiles; t += blockDim.x) {
    c += pcnt[row * ntiles + t];
    s += psure[row * ntiles + t];
    q += psq[row * ntiles + t];
    if (pden != nullptr) dn += pden[row * ntiles + t];
  }
  __shared__ long long sh_l[32];
  __shared__ double sh_d[32];
  c = block_sum(c, sh_l);
  s = block_sum(s, sh_l);
  q = block_sum(q, sh_d);
  if (pden != nullptr) dn = block_sum(dn, sh_d);
  if (threadIdx.x == 0) {
    cnt[row] = c;
    sure[row] = s;
    sq[row] = (float)q;
    if (pden != nullptr) den[row] = (float)dn;
  }
}

// Philox4x32-10 of n (counter, key) pairs, ck = n x [c0 c1 c2 c3 k0 k1]: the
// generator of kernel 8, exposed for its known-answer test.
__global__ void philox_kat(const unsigned* __restrict__ ck,
                           unsigned* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const unsigned* c = ck + 6 * j;
  const uint4 b = philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]),
                                make_uint2(c[4], c[5]));
  out[4 * j] = b.x;
  out[4 * j + 1] = b.y;
  out[4 * j + 2] = b.z;
  out[4 * j + 3] = b.w;
}

// ---------------------------------------------------------------------------
// topk's threshold: per row of a [rows, d] group, t = the k_target-th
// largest |g| (f32) and budget = k_target - #{|g| > t} (int64). Replaces
// the XLA lax.top_k of topk_emit (src/repro/kernels/sparsify/ops.py:268),
// which the JAX package runs outside Pallas, and torch.topk, which computes
// the same two numbers from a sort of the row's f32 magnitudes (62 ms a
// step at gemma-2b, 1 GB of scratch).
//
// A radix select on the magnitude's bit pattern, with no sort: the key is
// bits & 0x7fff (bf16) or bits & 0x7fffffff (f32), monotone in |g| for
// finite values. Each round histograms `bits` bits of the key, from the
// top, over the coordinates whose higher key bits equal the row's prefix so
// far (every coordinate in the first round), and a one-block-per-row
// finish scans the bins from the top until the count reaches what is left
// of k_target: that bin extends the prefix, and the bins above it are
// counted out of k_target. After the last round the prefix is t's key and
// what is left of k_target is the budget. A row with fewer than k_target
// nonzeros ends in key 0: t = 0 and budget = k_target - nnz, as torch.topk
// gives. The rounds (bits per round, summing to the key's 15 or 31) come
// from the caller: bf16 in one round of 2^15 bins (128 KB of shared
// memory, one block an SM) or two of 2^8 and 2^7; f32 in three of 2^11,
// 2^10, 2^10.
//
// Bound: one read of g per round (2 B/coord for bf16 in one round). The
// histogram kernel is persistent: its blocks split the group's chunks of
// kRadixChunk coordinates (row-major) into equal runs, so every block gets
// the same work whatever the row lengths, and flush their shared-memory
// histogram into the row's global one (atomics on the non-zero bins only)
// when their run leaves a row. Shared atomics on hot bins are the risk:
// bin 0 (a zero gradient, most of an embedding row) is counted in a
// register and added once a warp; small histograms keep one copy per warp
// (up to 64 KB) so that warps do not contend with each other.
// ---------------------------------------------------------------------------

constexpr int kRadixThreads = 1024;
constexpr int64_t kRadixChunk = 8 * kRadixThreads * kItems;  // 65,536
constexpr int kRadixCopyBytes = 64 << 10;  // per-warp copies up to this

// The magnitude keys of a thread's kItems raw elements, in order.
__device__ __forceinline__ void chunk_keys(const Chunk<__nv_bfloat16>& c,
                                           unsigned key[kItems]) {
  const unsigned w[kItems / 2] = {c.v.x, c.v.y, c.v.z, c.v.w};
#pragma unroll
  for (int k = 0; k < kItems / 2; ++k) {
    key[2 * k] = w[k] & 0x7fffu;
    key[2 * k + 1] = (w[k] >> 16) & 0x7fffu;
  }
}

__device__ __forceinline__ void chunk_keys(const Chunk<float>& c,
                                           unsigned key[kItems]) {
  const float f[kItems] = {c.a.x, c.a.y, c.a.z, c.a.w,
                           c.b.x, c.b.y, c.b.z, c.b.w};
#pragma unroll
  for (int k = 0; k < kItems; ++k) key[k] = __float_as_uint(f[k]) & 0x7fffffffu;
}

// One round's histogram. Block b covers chunks [b C / G, (b + 1) C / G) of
// the group's C = rows x chunks_per_row chunks; `ncopy` histograms of 2^bits
// bins in dynamic shared memory (warp w counts into copy w % ncopy).
template <typename T>
__global__ void __launch_bounds__(kRadixThreads)
radix_hist(const T* __restrict__ g, int64_t d, int64_t cpr, int64_t nchunks,
           int vec, int shift, int bits, int ncopy,
           const long long* __restrict__ state, unsigned* __restrict__ hist) {
  extern __shared__ unsigned sh_bins[];
  const int nbins = 1 << bits, hi = shift + bits;
  const int64_t c0 = nchunks * blockIdx.x / gridDim.x;
  const int64_t c1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  unsigned* mine = sh_bins + ((threadIdx.x >> 5) % ncopy) * nbins;
  for (int j = threadIdx.x; j < ncopy * nbins; j += blockDim.x)
    sh_bins[j] = 0u;
  int64_t row = c0 / (cpr > 0 ? cpr : 1);
  unsigned prefix = state != nullptr ? (unsigned)state[3 * row] : 0u;
  unsigned zeros = 0u;                   // bin 0, counted in a register
  __syncthreads();
  auto count = [&](unsigned key) {
    if ((key >> hi) != prefix) return;
    const unsigned bin = (key >> shift) & (unsigned)(nbins - 1);
    if (bin == 0u) ++zeros;
    else atomicAdd(&mine[bin], 1u);
  };
  // adds the block's histogram of `row` to the row's global one
  auto flush = [&]() {
    const unsigned z = warp_sum(zeros);
    if ((threadIdx.x & 31) == 0 && z) atomicAdd(&sh_bins[0], z);
    zeros = 0u;
    __syncthreads();
    unsigned* hrow = hist + row * nbins;
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
      unsigned n = 0u;
      for (int c = 0; c < ncopy; ++c) {
        n += sh_bins[c * nbins + b];
        sh_bins[c * nbins + b] = 0u;
      }
      if (n) atomicAdd(&hrow[b], n);
    }
    __syncthreads();
  };
  constexpr int kUnroll = 4;
  constexpr int64_t kStep = (int64_t)kRadixThreads * kItems;
  for (int64_t c = c0; c < c1; ++c) {             // uniform over the block
    const int64_t r = c / cpr;
    if (r != row) {
      flush();
      row = r;
      prefix = state != nullptr ? (unsigned)state[3 * row] : 0u;
    }
    const T* grow = g + row * d;
    const int64_t start = (c - row * cpr) * kRadixChunk;
    const int64_t end = d < start + kRadixChunk ? d : start + kRadixChunk;
    int64_t i = start + threadIdx.x * kItems;
    for (; i + (kUnroll - 1) * kStep + kItems <= end; i += kUnroll * kStep) {
      Chunk<T> ch[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_chunk(grow, i + u * kStep, end, vec, ch[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned key[kItems];
        chunk_keys(ch[u], key);
#pragma unroll
        for (int k = 0; k < kItems; ++k) count(key[k]);
      }
    }
    for (; i < end; i += kStep) {
      Chunk<T> ch;
      load_chunk(grow, i, end, vec, ch);
      unsigned key[kItems];
      chunk_keys(ch, key);
      const unsigned valid = valid_items(i, end);
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if ((valid >> k) & 1u) count(key[k]);
    }
  }
  if (c0 < c1) flush();
}

// One block per row: the bin of this round that holds the row's remaining
// rank. state[row] = (prefix, what is left of k_target, -); the first round
// starts from (0, k_target), the last writes t and the budget instead.
__global__ void __launch_bounds__(kRadixThreads)
radix_finish(const unsigned* __restrict__ hist, int bits, int first,
             int last, int f32_keys, long long k_target,
             long long* __restrict__ state, float* __restrict__ t_out,
             long long* __restrict__ budget_out) {
  const int64_t row = blockIdx.x;
  const int nbins = 1 << bits;
  const long long prefix = first ? 0 : state[3 * row];
  const long long left = first ? k_target : state[3 * row + 1];
  const unsigned* h = hist + row * nbins;
  // thread j sums bins [lo, top), the j-th run from the top
  const int per = (nbins + blockDim.x - 1) / blockDim.x;
  const int top = nbins - (int)threadIdx.x * per;
  const int lo = top - per > 0 ? top - per : 0;
  int mine = 0;
  for (int b = lo; b < top; ++b) mine += (int)h[b];
  __shared__ int sh_scan[33];
  int total;
  const int above = block_excl_scan(mine, &total, sh_scan);
  if (above < left && left <= (long long)above + mine) {   // one thread
    long long acc = above;
    for (int b = top - 1; b >= lo; --b) {
      if (acc + h[b] >= left) {
        const long long key = (prefix << bits) | b;
        if (last) {
          t_out[row] = __uint_as_float(f32_keys ? (unsigned)key
                                                : (unsigned)key << 16);
          budget_out[row] = left - acc;
        } else {
          state[3 * row] = key;
          state[3 * row + 1] = left - acc;
        }
        break;
      }
      acc += h[b];
    }
  }
}

// ---------------------------------------------------------------------------
// The bins of a bfloat16 row. Its 15-bit magnitude key (bits & 0x7fff)
// takes 2^15 values, one bin each, and a bin holds one value: so the one
// histogram pass of topk_threshold (radix_hist at 15 bits) gives every
// order statistic and every sum over |g| that depends on a magnitude
// threshold. Two finish kernels read a row's 2^15 counts, one block a row
// (kRadixThreads threads, kBinsPerThread consecutive bins each, loaded as
// 16-byte vectors):
//
//   compact_finish  the magnitude compaction's row scalars at k_cap: the
//                   threshold t, the tie budget, the nonzeros (d less bin
//                   0), the kept count min(k_cap, nonzeros) and an integer
//                   codec's scale inputs over the kept values, sum v^2 and
//                   max|v|. It replaces pass 1 of topk (select_tiles_topk
//                   and select_finish) on the compaction's path;
//   closed_finish   Algorithm 2's lambda (the XLA jnp.sort of
//                   closed_form_lambda, src/repro/core/sparsify.py:40)
//                   with no float64 [rows, 2^15] scratch: the counts are
//                   read once and scanned in the block.
//
// Sums of bins are float64 over exact terms: c v has at most 39
// significant bits and c v^2 (or c times v's float32 square) at most 47, so
// only the additions round. Empty bins are skipped (the keys of inf and NaN
// make 0 x inf).
// ---------------------------------------------------------------------------

constexpr int kKeyBins = 1 << 15;
constexpr int kBinsPerThread = kKeyBins / kRadixThreads;   // 32

// A thread's kBinsPerThread counts from bin lo (16-byte aligned).
__device__ __forceinline__ void load_bins(const unsigned* __restrict__ h,
                                          int lo,
                                          unsigned c[kBinsPerThread]) {
  const uint4* p = reinterpret_cast<const uint4*>(h + lo);
#pragma unroll
  for (int v = 0; v < kBinsPerThread / 4; ++v) {
    const uint4 q = p[v];
    c[4 * v] = q.x; c[4 * v + 1] = q.y; c[4 * v + 2] = q.z; c[4 * v + 3] = q.w;
  }
}

// The value of a bf16 magnitude key.
__device__ __forceinline__ float key_value(int key) {
  return __uint_as_float((unsigned)key << 16);
}

// Block-wide max of a non-negative int, valid in every thread; `sh` one int.
__device__ int block_max_int(int v, int* sh) {
  if (threadIdx.x == 0) *sh = 0;
  __syncthreads();
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) atomicMax(sh, v);
  __syncthreads();
  return *sh;
}

// One block a row. Thread j holds the bins [lo, lo + 32), lo counted from
// the top (thread 0 the highest bins), so one exclusive block scan of the
// threads' counts gives each run's rank from the top, and the thread whose
// run holds rank k_cap walks it down to the bin: that is t's key, and
// k_cap less the coordinates above it is the tie budget (radix_finish's
// rule; a row with fewer than k_cap nonzeros ends in bin 0: t = 0). The
// kept values are the bins above t and `budget` values t: sum v^2 over
// them (each v^2 rounded to float32, as pass 1 squares) and max|v|, the
// highest non-empty bin.
__global__ void __launch_bounds__(kRadixThreads)
compact_finish(const unsigned* __restrict__ hist, int64_t d, int64_t k_cap,
               float* __restrict__ t_out, long long* __restrict__ budget_out,
               int* __restrict__ nonzeros_out, int* __restrict__ kept_out,
               float* __restrict__ sum_sq_out, float* __restrict__ max_out) {
  const int64_t row = blockIdx.x;
  const unsigned* h = hist + row * kKeyBins;
  const int lo = kKeyBins - ((int)threadIdx.x + 1) * kBinsPerThread;
  unsigned c[kBinsPerThread];
  load_bins(h, lo, c);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) mine += (int)c[j];
  __shared__ int sh_scan[33];
  __shared__ int sh_key, sh_max;
  __shared__ long long sh_budget;
  __shared__ double sh_d[32];
  int total;
  const int above = block_excl_scan(mine, &total, sh_scan);
  if (above < k_cap && k_cap <= (long long)above + mine) {   // one thread
    long long acc = above;
    for (int j = kBinsPerThread - 1; j >= 0; --j) {
      if (acc + c[j] >= k_cap) {
        sh_key = lo + j;
        sh_budget = k_cap - acc;
        break;
      }
      acc += c[j];
    }
  }
  __syncthreads();
  const int tkey = sh_key;
  const long long budget = sh_budget;
  double sq = 0.0;
  int top = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int b = lo + j;
    if (c[j] == 0u || b < tkey) continue;
    top = b > top ? b : top;
    const float v = key_value(b);
    const double s = (double)__fmul_rn(v, v);
    sq = __dadd_rn(sq, __dmul_rn(b > tkey ? (double)c[j] : (double)budget,
                                 s));
  }
  sq = block_sum(sq, sh_d);
  top = block_max_int(top, &sh_max);
  if (threadIdx.x == 0) {
    const int nz = (int)(d - (int64_t)h[0]);
    t_out[row] = key_value(tkey);
    budget_out[row] = budget;
    nonzeros_out[row] = nz;
    kept_out[row] = nz < k_cap ? nz : (int)k_cap;
    sum_sq_out[row] = (float)sq;
    max_out[row] = key_value(top);
  }
}

// Block-wide exclusive scan of a pair of doubles, one pair a thread: each
// thread gets its exclusive prefixes, and the block totals. `sh` holds 66.
// Exclusive prefixes are shifted inclusive ones (no subtraction).
__device__ void block_excl_scan2(double a, double b, double* ea, double* eb,
                                 double* ta, double* tb, double* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double na = __shfl_up_sync(kFull, ia, o);
    const double nb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia = __dadd_rn(na, ia);
      ib = __dadd_rn(nb, ib);
    }
  }
  double xa = __shfl_up_sync(kFull, ia, 1);   // the lanes before me
  double xb = __shfl_up_sync(kFull, ib, 1);
  if (lane == 0) xa = xb = 0.0;
  __syncthreads();
  if (lane == 31) {
    sh[w] = ia;
    sh[32 + w] = ib;
  }
  __syncthreads();
  if (w == 0) {
    double sa = lane < nw ? sh[lane] : 0.0;
    double sb = lane < nw ? sh[32 + lane] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double na = __shfl_up_sync(kFull, sa, o);
      const double nb = __shfl_up_sync(kFull, sb, o);
      if (lane >= o) {
        sa = __dadd_rn(na, sa);
        sb = __dadd_rn(nb, sb);
      }
    }
    double pa = __shfl_up_sync(kFull, sa, 1);
    double pb = __shfl_up_sync(kFull, sb, 1);
    if (lane == 0) pa = pb = 0.0;
    __syncwarp();
    if (lane < nw) {
      sh[lane] = pa;
      sh[32 + lane] = pb;
    }
    if (lane == 31) {
      sh[64] = sa;
      sh[65] = sb;
    }
  }
  __syncthreads();
  *ea = __dadd_rn(sh[w], xa);    // the warps before mine, then my lanes'
  *eb = __dadd_rn(sh[32 + w], xb);
  *ta = sh[64];
  *tb = sh[65];
}

// One block a row. Thread j holds the bins [32 j, 32 j + 32), ascending.
// With v a bin's value (0 where the bin is empty), s1 = c v and s2 = c v^2,
// T and L the sums of s1 and s2 over the bins below and S the row's sum of
// s2: the highest non-empty bin b with v T <= eps S + L gives lambda =
// (s1 + T) / (eps S + s2 + L) at b, rounded to float32 once; no such bin
// (eps < 0) gives 0 and bin -1. Each product and sum is rounded on its own
// (no FMA), in the order of the plain version's expression
// (ref.closed_lambda_bins_ref); the scan's order is the block's, so T, L and
// S agree with torch.cumsum's to rounding (rtol 1e-6 on lambda).
__global__ void __launch_bounds__(kRadixThreads)
closed_finish(const unsigned* __restrict__ hist, double eps,
              float* __restrict__ lam_out, int* __restrict__ bin_out) {
  const int64_t row = blockIdx.x;
  const int lo = (int)threadIdx.x * kBinsPerThread;
  unsigned c[kBinsPerThread];
  load_bins(hist + row * kKeyBins, lo, c);
  double a1 = 0.0, a2 = 0.0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    if (c[j] == 0u) continue;
    const double v = (double)key_value(lo + j);
    const double s1 = __dmul_rn((double)c[j], v);
    a1 = __dadd_rn(a1, s1);
    a2 = __dadd_rn(a2, __dmul_rn(s1, v));
  }
  __shared__ double sh[66];
  __shared__ int sh_best;
  double t_low, l_low, t_all, total;
  block_excl_scan2(a1, a2, &t_low, &l_low, &t_all, &total, sh);
  const double budget = __dmul_rn(eps, total);
  int best = -1;
  double num = 0.0, den = 0.0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    if (c[j] == 0u) continue;
    const double v = (double)key_value(lo + j);
    const double s1 = __dmul_rn((double)c[j], v);
    const double s2 = __dmul_rn(s1, v);
    if (__dmul_rn(v, t_low) <= __dadd_rn(budget, l_low)) {
      best = lo + j;
      num = __dadd_rn(s1, t_low);
      den = __dadd_rn(__dadd_rn(budget, s2), l_low);
    }
    t_low = __dadd_rn(t_low, s1);
    l_low = __dadd_rn(l_low, s2);
  }
  const int b = block_max_int(best + 1, &sh_best) - 1;
  if (b >= 0 && best == b) {             // the thread that holds bin b
    lam_out[row] = den > 0.0 ? (float)__ddiv_rn(num, den) : 0.f;
    bin_out[row] = b;
  } else if (b < 0 && threadIdx.x == 0) {
    lam_out[row] = 0.f;
    bin_out[row] = -1;
  }
}

// ---------------------------------------------------------------------------
// compact_select: the magnitude compaction's one pass over g after
// compact_finish. Per row, keep |g| > t and the first `budget` coordinates
// with |g| == t > 0 (lax.top_k's lowest-index tie break), and write them in
// coordinate order into the compact buffers: idx the coordinate, the value
// the bf16 itself (the f32 and bf16 codecs on a bf16 row) or an integer
// codec's level of it from the row's scale at the deterministic uniform
// kDetU (the pod stage's _encode_det). Slots [kept, k_cap) get idx 0 and
// value 0. It replaces pass 2 of topk (compact_emit) on the compaction's
// path, and with compact_finish its pass 1.
//
// Order without a second read. Pass 2 took each tile's base rank from pass
// 1's per-tile counts. Here a tile of kSelTile coordinates is read once,
// into shared memory, its strict survivors and ties are counted, and the
// counts of the row's tiles before it come from a single-pass chained scan
// with decoupled look-back. A status word carries both counts, each below
// 2^31 (the wrapper refuses d >= 2^31), beside a 2-bit flag: [flag | ties
// (31 bits) | strict (31 bits)]; packed words add field by field, as no
// field sum reaches 2^31. A kept item's slot is strict-before +
// min(ties-before, budget), and a tie is kept while its tie rank is below
// the budget.
//
// The design, for the card. A block a tile, taken from a per-row ticket
// (rice_pack's scheme: a block only waits on tiles that have started):
// - the tile goes to shared memory by cp.async (16 B a copy, a sweep of the
//   block coalesced), so the registers stay few and 4 blocks fit an SM;
// - a thread counts 64 consecutive coordinates (its 8 chunks, read from a
//   swizzled slot so that neither the copies nor the reads conflict on
//   banks): the tile's ranks take one warp scan and an exclusive sum of
//   the warps' totals;
// - a chunk's 8 keys are compared two to a 32-bit word: with the keys in
//   15-bit halves, k + (0x7fff - t) sets bit 15 of a half exactly where
//   k > t and k + (0x8000 - t) where k >= t, with no carry between halves;
// - a ninth warp does the look-back from the block's start, while the tile
//   loads and is counted (the tile's warps publish its aggregate as soon as
//   they have counted it, so no tile waits on another's look-back), and
//   waits only on the tiles between b and the nearest inclusive prefix;
// - the writes go a sweep at a time: a warp's kept items of a sweep take
//   consecutive slots, so each lane stages its own in shared memory and
//   the warp stores them coalesced.
// Measured slower on the H100: the tile in registers (3 blocks an SM),
// persistent blocks that copy their next tile while finishing the current
// one (a tile's aggregate then waits a whole tile, and the chain of
// look-backs serialises), each lane storing its own kept items, and the
// block staging all the tile's candidates with their counts (no faster,
// and it spilled).
// Bound: one read of g (2 B/coord) and the compact write (k_cap x (2 + 4)
// B a row with bf16 values).
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 256;                   // threads a block
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelChunks = 8;                      // a thread's 16-B chunks
constexpr int kSelTileChunks = kSelChunks * kSelThreads;
constexpr int64_t kSelTile = (int64_t)kSelTileChunks * kItems;   // 16,384
constexpr int kSelMinBlocks = 4;                   // blocks an SM holds
// shared memory a block: the tile, each chunk's count prefix within its
// thread (two bytes: strict, ties), each thread's prefix in its warp, and
// each warp's staging of one sweep's kept items (idx and bf16 bits)
constexpr int kSelSmem = kSelTileChunks * 16 + kSelTileChunks * 2 +
                         kSelThreads * 4 + kSelThreads * kItems * 6;
constexpr unsigned long long kSelCount = (1ull << 31) - 1;
constexpr unsigned long long kSelValue = (1ull << 62) - 1;
constexpr unsigned long long kSelAggregate = 1ull << 62;
constexpr unsigned long long kSelPrefix = 2ull << 62;

// Run by one warp after its block published tile b's aggregate (b > 0):
// the packed counts of the row's tiles before b. Lane l reads tile b - 1 -
// l (a window of 32, nearest first) and re-reads only while a tile nearer
// than the nearest inclusive prefix has published nothing.
__device__ unsigned long long select_lookback(
    const unsigned long long* __restrict__ st, int64_t b) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0ull;
  for (int64_t top = b - 1;; top -= 32) {
    const int64_t j = top - lane;
    unsigned long long f = j >= 0 ? ld_status(st + j) : kSelPrefix;
    unsigned pre;
    int last;                           // the lanes to sum: 0..last
    while (true) {
      pre = __ballot_sync(kFull, (f >> 62) == 2);
      last = pre ? __ffs(pre) - 1 : 31;
      const unsigned need = last == 31 ? kFull : (2u << last) - 1u;
      if (!(__ballot_sync(kFull, (f >> 62) == 0) & need)) break;
      __nanosleep(64);
      if ((f >> 62) == 0) f = ld_status(st + j);
    }
    excl += warp_allsum(lane <= last ? (f & kSelValue) : 0ull);
    if (pre) return excl;
  }
}

// A 16-byte asynchronous copy from device to shared memory, cached in L2
// only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// The stage slot of a tile's chunk c (coordinates 8c .. 8c + 7): the
// copies of a sweep (c = s * 256 + thread) and a thread's reads of its own
// chunks (c = thread * 8 + j) both hit 8 distinct 16-byte bank groups in
// each quarter warp.
__device__ __forceinline__ int sel_slot(int c) { return c ^ ((c >> 3) & 7); }

// A chunk's strict (k > t) and tie (k == t) flags: item 2i at bit 15 - i,
// item 2i + 1 at bit 31 - i (i: the chunk's word).
__device__ __forceinline__ void chunk_flags(const uint4& v, unsigned cgt,
                                            unsigned cge, unsigned* gt,
                                            unsigned* ge) {
  const unsigned x[4] = {v.x, v.y, v.z, v.w};
  unsigned a = 0u, e = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned m = x[i] & 0x7fff7fffu;
    a |= ((m + cgt) & 0x80008000u) >> i;
    e |= ((m + cge) & 0x80008000u) >> i;
  }
  *gt = a;
  *ge = e;
}

// chunk_flags' bits as a mask in item order (bit k: item k): reversed,
// items 2i + 1 sit at bit i and items 2i at bit 16 + i, then interleaved.
__device__ __forceinline__ unsigned item_mask(unsigned f) {
  const unsigned r = __brev(f);
  unsigned ev = (r >> 16) & 0xfu, od = r & 0xfu;
  ev = (ev | (ev << 2)) & 0x33u;
  ev = (ev | (ev << 1)) & 0x55u;
  od = (od | (od << 2)) & 0x33u;
  od = (od | (od << 1)) & 0x55u;
  return ev | (od << 1);
}

// The tile's warps alone (barrier 1), and the whole block at the look-back's
// end (barrier 2, the look-back warp arriving from its own branch).
__device__ __forceinline__ void sel_sync_tile() {
  asm volatile("bar.sync 1, %0;" :: "n"(kSelThreads) : "memory");
}
__device__ __forceinline__ void sel_sync_all() {
  asm volatile("bar.sync 2, %0;" :: "n"(kSelThreads + 32) : "memory");
}

template <typename W>
__global__ void __launch_bounds__(kSelThreads + 32, kSelMinBlocks)
compact_select(const __nv_bfloat16* __restrict__ g, int64_t d,
               int64_t ntiles, int vec, const float* __restrict__ t_in,
               const long long* __restrict__ budget_in,
               const int* __restrict__ kept_in, int64_t k_cap,
               unsigned long long* __restrict__ status, W* __restrict__ vals,
               int* __restrict__ idx, const float* __restrict__ scale,
               float levels, int ternary) {
  constexpr bool kInt = IntWire<W>::value;
  extern __shared__ uint4 sh_tile[];     // kSelTileChunks, then:
  unsigned short* sh_pre = reinterpret_cast<unsigned short*>(
      sh_tile + kSelTileChunks);         // kSelTileChunks
  int* sh_thr = reinterpret_cast<int*>(sh_pre + kSelTileChunks);
  unsigned* sh_sidx = reinterpret_cast<unsigned*>(sh_thr + kSelThreads);
  unsigned short* sh_sval = reinterpret_cast<unsigned short*>(
      sh_sidx + kSelThreads * kItems);   // the warps' staging
  __shared__ unsigned long long sh_ticket, sh_base;
  __shared__ int sh_warp[kSelWarps];
  __shared__ int sh_agg;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t row = blockIdx.y;
  unsigned long long* st = status + row * ntiles;   // the row's status words
  const int kept = kept_in[row];                    // in flight with the ticket
  const unsigned tkey = __float_as_uint(t_in[row]) >> 16;
  const long long budget = budget_in[row];
  if (threadIdx.x == 0)                  // the rows' tickets follow all rows'
    sh_ticket = atomicAdd(status + gridDim.y * ntiles + row, 1ull); // status
  __syncthreads();
  const int64_t b = (int64_t)sh_ticket;  // the row's tiles, in start order
  W* vrow = vals + row * k_cap;
  int* irow = idx + row * k_cap;
  {   // this tile's share of the row's dead slots [kept, k_cap)
    const int64_t share = (k_cap - kept + ntiles - 1) / ntiles;
    const int64_t a = kept + b * share;
    const int64_t e = a + share < k_cap ? a + share : k_cap;
    if (a < e) {
      zero_bytes(reinterpret_cast<unsigned char*>(vrow), a * sizeof(W),
                 e * sizeof(W));
      zero_bytes(reinterpret_cast<unsigned char*>(irow), a * 4, e * 4);
    }
  }
  if (w == kSelWarps) {
    // The look-back warp: from the block's start, while the tile loads and
    // is counted, it sums the row's tiles before b (their aggregates are
    // published as they are counted, whatever their look-back), then
    // publishes b's inclusive prefix.
    const unsigned long long excl = b == 0 ? 0ull : select_lookback(st, b);
    if (lane == 0) sh_base = excl;
    sel_sync_all();                      // b's counts, and its base
    const int agg = sh_agg;
    if (lane == 0 && b > 0)
      st_status(st + b, kSelPrefix | (excl + ((unsigned long long)(agg &
                                               0xffff) |
                                              ((unsigned long long)(agg >>
                                                                    16)
                                               << 31))));
    return;
  }
  const int64_t start = b * kSelTile;
  const int64_t end = d < start + kSelTile ? d : start + kSelTile;
  const __nv_bfloat16* grow = g + row * d;
  // the tile into shared memory, a sweep of the block's chunks a round
  // (coalesced); zeros past the row's end (never kept)
#pragma unroll
  for (int s = 0; s < kSelChunks; ++s) {
    const int c = s * kSelThreads + (int)threadIdx.x;
    const int64_t i = start + (int64_t)c * kItems;
    if (vec && i + kItems <= end) {
      cp_async16(sh_tile + sel_slot(c), grow + i);
    } else {
      Chunk<__nv_bfloat16> ch;
      load_chunk(grow, i, end, false, ch);
      sh_tile[sel_slot(c)] = ch.v;
    }
  }
  cp_async_wait_all();
  sel_sync_tile();                       // the tile is in shared memory
  // my 64 consecutive coordinates (chunks 8 t .. 8 t + 7): their strict
  // and tie counts, and each chunk's prefix among them (a byte each)
  const unsigned cgt = (0x7fffu - tkey) * 0x10001u;
  const unsigned cge = (0x8000u - tkey) * 0x10001u;
  const bool ties_on = tkey != 0u;
  int ns = 0, nt = 0;
  unsigned pre[kSelChunks / 2];
#pragma unroll
  for (int j = 0; j < kSelChunks; ++j) {
    unsigned a, e;
    chunk_flags(sh_tile[sel_slot((int)threadIdx.x * kSelChunks + j)], cgt,
                cge, &a, &e);
    const unsigned p = (unsigned)(ns | (nt << 8));
    if (j & 1) pre[j / 2] |= p << 16;
    else pre[j / 2] = p;
    ns += __popc(a);
    nt += ties_on ? __popc(e & ~a) : 0;
  }
  reinterpret_cast<uint4*>(sh_pre)[threadIdx.x] =
      make_uint4(pre[0], pre[1], pre[2], pre[3]);
  const int mine = ns | (nt << 16);      // at most 64 of each
  int inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) sh_warp[w] = inc;
  sh_thr[threadIdx.x] = inc - mine;      // my lanes' before me, in my warp
  sel_sync_tile();                       // counts, prefixes, warp totals
  int wp[kSelWarps], agg = 0;            // packed: at most 2^14 of each
#pragma unroll
  for (int j = 0; j < kSelWarps; ++j) {
    wp[j] = agg;
    agg += sh_warp[j];
  }
  if (threadIdx.x == 0) {               // publish at once: a row's first
    st_status(st + b, (b == 0 ? kSelPrefix : kSelAggregate) |
                          (unsigned long long)(agg & 0xffff) |
                          ((unsigned long long)(agg >> 16) << 31));
    sh_agg = agg;
  }
  sel_sync_all();                        // the tile's base
  const unsigned long long base = sh_base;
  const int s0 = (int)(base & kSelCount), t0 = (int)((base >> 31) & kSelCount);
  const int bud = budget < (long long)k_cap ? (int)budget : (int)k_cap;
  const int kc = (int)k_cap;
  const float sc = kInt ? scale[row] : 1.f;
  unsigned* wsi = sh_sidx + w * 32 * kItems;         // this warp's staging
  unsigned short* wsv = sh_sval + w * 32 * kItems;
  // The writes go chunk by chunk in a sweep of the block (chunk c = s 256 +
  // t): sweep s's chunks are 256 consecutive coordinates, owned by warp s's
  // threads (c / 8), so a chunk's ranks are the warps' before s, its owner's
  // lanes' before it in warp s, and the owner's chunks' before it. A warp's
  // kept items of a sweep take consecutive slots [r, r + n): each lane
  // stages its own in shared memory, and the warp stores them coalesced.
  static_assert(kSelThreads == kSelChunks * 32, "sweep s: warp s's chunks");
#pragma unroll
  for (int s = 0; s < kSelChunks; ++s) {
    const int c = s * kSelThreads + (int)threadIdx.x;
    const uint4 v = sh_tile[sel_slot(c)];
    const unsigned cp = sh_pre[c];
    const int lp = wp[s] + sh_thr[c / kSelChunks] +
                   (int)((cp & 0xffu) | ((cp >> 8) << 16));
    const int rs = s0 + (lp & 0xffff), rt = t0 + (lp >> 16);
    const int r0 = rs + (rt < bud ? rt : bud);   // my first kept item's slot
    unsigned a, e;
    chunk_flags(v, cgt, cge, &a, &e);
    e = ties_on ? e & ~a : 0u;
    unsigned km = 0u;                    // kept items, in item order
    if ((a | e) != 0u) {
      km = item_mask(a);
      for (unsigned t = item_mask(e), n = 0; t != 0u && (int)n < bud - rt;
           t &= t - 1u, ++n)
        km |= t & (0u - t);              // the budget's first ties
    }
    const int wr = __shfl_sync(kFull, r0, 0);
    const int wn = __shfl_sync(kFull, r0 + __popc(km), 31) - wr;
    if (km != 0u) {
      int j = r0 - wr;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if ((km >> k) & 1u) {
          const unsigned wd = (k & 4) ? ((k & 2) ? v.w : v.z)
                                      : ((k & 2) ? v.y : v.x);
          wsv[j] = (unsigned short)((k & 1) ? wd >> 16 : wd & 0xffffu);
          wsi[j] = (unsigned)(start + (int64_t)c * kItems + k);
          ++j;
        }
      }
    }
    __syncwarp();
    for (int j = lane; j < wn && wr + j < kc; j += 32) {
      const unsigned bits = wsv[j];
      if constexpr (kInt) {
        vrow[wr + j] = (W)(int)int_level(__uint_as_float(bits << 16), sc,
                                         kDetU, levels, ternary);
      } else {
        reinterpret_cast<unsigned short*>(vrow)[wr + j] =
            (unsigned short)bits;
      }
      irow[wr + j] = (int)wsi[j];
    }
    __syncwarp();
  }
}

// One round of radix_hist over the group at (shift, bits), after a memset of
// `hist` (rows x 2^bits); `state` the prefixes of earlier rounds (null in
// the first).
template <typename T>
void launch_radix_hist(const void* g, long long rows, long long d, int vec,
                       int shift, int bits, const long long* state,
                       void* hist, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cpr = (d + kRadixChunk - 1) / kRadixChunk;
  const int64_t nchunks = rows * cpr;
  const int nbins = 1 << bits;
  int ncopy = kRadixCopyBytes / (nbins * 4);
  ncopy = ncopy < 1 ? 1 : (ncopy > kRadixThreads / 32 ? kRadixThreads / 32
                                                      : ncopy);
  const int smem = ncopy * nbins * 4;
  cudaFuncSetAttribute(radix_hist<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_hist<T>,
                                                kRadixThreads, smem);
  const int64_t want = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = nchunks < want ? nchunks : want;
  cudaMemsetAsync(hist, 0, rows * nbins * 4, st);
  if (grid > 0)
    radix_hist<T><<<(unsigned)grid, kRadixThreads, smem, st>>>(
        (const T*)g, d, cpr, nchunks, vec, shift, bits, ncopy, state,
        (unsigned*)hist);
}

template <typename T>
int launch_topk_threshold(const void* g, long long rows, long long d,
                          int vec, long long k_target, const int bits[3],
                          void* hist, void* state, void* t, void* budget,
                          cudaStream_t st) {
  const int key_bits = std::is_same<T, float>::value ? 31 : 15;
  int nrounds = 0, sum = 0;
  while (nrounds < 3 && bits[nrounds] > 0) sum += bits[nrounds++];
  if (sum != key_bits || k_target < 1 || k_target > d)
    return (int)cudaErrorInvalidValue;
  int shift = key_bits;
  for (int r = 0; r < nrounds; ++r) {
    shift -= bits[r];
    launch_radix_hist<T>(g, rows, d, vec, shift, bits[r],
                         r ? (const long long*)state : nullptr, hist, st);
    radix_finish<<<(unsigned)rows, kRadixThreads, 0, st>>>(
        (const unsigned*)hist, bits[r], r == 0, r == nrounds - 1,
        std::is_same<T, float>::value, k_target, (long long*)state,
        (float*)t, (long long*)budget);
  }
  return (int)cudaGetLastError();
}

inline unsigned grid_x(int64_t ntiles) { return (unsigned)ntiles; }

// Calls f(std::integral_constant<int, PK>) for the selector kind `pk`.
template <typename F> int with_kind(int pk, F&& f) {
  switch (pk) {
    case kLam: f(std::integral_constant<int, kLam>{}); break;
    case kRho: f(std::integral_constant<int, kRho>{}); break;
    case kBern: f(std::integral_constant<int, kBern>{}); break;
    case kTopk: f(std::integral_constant<int, kTopk>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int PK, typename T>
void launch_select(const void* g, const void* u, long long rows,
                   long long d, int vec_g, int vec_u, const void* s1,
                   const void* s2, const void* budget, long long k_cap,
                   void* pcnt, void* pnzc, void* pties, void* ppsum,
                   void* pden, void* pvsq, void* pvmx, void* base,
                   void* tie_base, void* cnt, void* nzc, void* psum,
                   void* den, void* vsq, void* vmx, int round_v,
                   cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  if constexpr (PK == kTopk) {
    dim3 grid(grid_x((nt + kTopkTiles - 1) / kTopkTiles), (unsigned)rows);
    select_tiles_topk<T><<<grid, kThreads, 0, st>>>(
        (const T*)g, d, nt, vec_g, (const float*)s1, (int*)pcnt, (int*)pnzc,
        (int*)pties, (double*)pden, (double*)pvsq, (float*)pvmx);
  } else {
    dim3 grid(grid_x(nt), (unsigned)rows);
    select_tiles<PK, T><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const float*)u, d, nt, vec_g, vec_u, (const float*)s1,
        (const float*)s2, (int*)pcnt, (int*)pnzc, (double*)ppsum,
        (double*)pden, (double*)pvsq, (float*)pvmx, round_v);
  }
  select_finish<PK, T><<<(unsigned)rows, kThreads, 0, st>>>(
      (const T*)g, (const float*)u, d, nt, vec_g, vec_u, (const float*)s1,
      (const float*)s2, (const long long*)budget, k_cap, (const int*)pcnt,
      (const int*)pnzc, (const int*)pties, (const double*)ppsum,
      (const double*)pden, (const double*)pvsq, (const float*)pvmx,
      (int*)base, (int*)tie_base, (int*)cnt, (int*)nzc, (float*)psum,
      (float*)den, (float*)vsq, (float*)vmx, round_v);
}

template <int PK, typename T, typename W>
void launch_emit(const void* g, const void* u, long long rows, long long d,
                 int vec_g, int vec_u, int vec_r, const void* s1,
                 const void* s2, const void* budget, const void* base,
                 const void* tie_base, const void* nnz, long long k_cap,
                 void* vals, void* idx, void* res, int round_res,
                 const void* scale, const void* ucod, float levels,
                 int ternary, cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  // the dead slots: the kernel zeroes them, except at a capacity of a whole
  // row (bern's k_cap = d, nearly every slot dead), where a memset of both
  // buffers measured faster than stores mixed into the pass
  const int zero_dead = k_cap < d;
  if (!zero_dead) {
    cudaMemsetAsync(vals, 0, rows * k_cap * sizeof(W), st);
    cudaMemsetAsync(idx, 0, rows * k_cap * 4, st);
  }
  compact_emit<PK, T, W><<<grid, kThreads, 0, st>>>(
      (const T*)g, (const float*)u, d, nt, vec_g, vec_u, vec_r,
      (const float*)s1, (const float*)s2, (const long long*)budget,
      (const int*)base, (const int*)tie_base, (const int*)nnz, k_cap,
      (W*)vals, (int*)idx, (T*)res, round_res, (const float*)scale,
      (const float*)ucod, levels, ternary, zero_dead);
}

template <bool kL2>
int launch_stats(const void* g, int dt, long long rows, long long d, int vec,
                 void* psum, void* psq, void* pmax, void* l1, void* l2,
                 void* mx, cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  if (dt == 1)
    stats_tiles<__nv_bfloat16, kL2><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)g, d, nt, vec, (double*)psum, (double*)psq,
        (float*)pmax);
  else
    stats_tiles<float, kL2><<<grid, kThreads, 0, st>>>(
        (const float*)g, d, nt, vec, (double*)psum, (double*)psq,
        (float*)pmax);
  stats_finish<kL2><<<(unsigned)rows, kThreads, 0, st>>>(
      (const double*)psum, (const double*)psq, (const float*)pmax, nt,
      (float*)l1, (float*)l2, (float*)mx);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, PK>) for the dense emit's kind `pk`
// (every pass-1/2 kind and kOne).
template <typename F> int with_dense_kind(int pk, F&& f) {
  if (pk == kOne) {
    f(std::integral_constant<int, kOne>{});
    return 0;
  }
  return with_kind(pk, f);
}

template <int PK, typename T, typename W, bool kInt>
void launch_sparsify(const void* g, const void* u, long long rows,
                     long long d, int vec, const void* s1, const void* s2,
                     const void* budget, const void* tie_base, int prng,
                     unsigned seed, const void* scale, const void* ucod,
                     float levels, int ternary, void* q, void* res,
                     void* pcnt, void* psure, void* psq, void* pden,
                     cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
#define GSPAR_DENSE(EF, PRNG)                                               \
  sparsify_tiles<PK, T, W, kInt, EF, PRNG><<<grid, kThreads, 0, st>>>(     \
      (const T*)g, (const float*)u, d, nt, vec, (const float*)s1,           \
      (const float*)s2, (const long long*)budget, (const int*)tie_base,     \
      seed, (const float*)scale, (const float*)ucod, levels, ternary,       \
      (W*)q, (T*)res, (int*)pcnt, (int*)psure, (double*)psq, (double*)pden)
  if constexpr (PK == kLam && !kInt) {
    if (prng) {
      GSPAR_DENSE(false, true);
      return;
    }
  }
  if (res != nullptr)
    GSPAR_DENSE(true, false);
  else
    GSPAR_DENSE(false, false);
#undef GSPAR_DENSE
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). dtype codes: 0 = float32, 1 = bfloat16.
// Each function enqueues its kernels on `stream`, allocates nothing, and
// returns cudaGetLastError() of its launches.
// ---------------------------------------------------------------------------

extern "C" {

long long gspar_tile(void) { return kTile; }
long long gspar_rice_tile(void) { return kRiceTile; }
long long gspar_select_tile(void) { return kSelTile; }

const char* gspar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int gspar_stats_l1max(const void* g, int dt, long long rows, long long d,
                      int vec, void* psum, void* pmax, void* l1, void* mx,
                      void* stream) {
  return launch_stats<false>(g, dt, rows, d, vec, psum, nullptr, pmax, l1,
                             nullptr, mx, (cudaStream_t)stream);
}

int gspar_stats(const void* g, int dt, long long rows, long long d, int vec,
                void* psum, void* psq, void* pmax, void* l1, void* l2,
                void* mx, void* stream) {
  return launch_stats<true>(g, dt, rows, d, vec, psum, psq, pmax, l1, l2, mx,
                            (cudaStream_t)stream);
}

int gspar_tail_stats(const void* g, int dt, long long rows, long long d,
                     int vec, const void* thresh, const void* gate,
                     void* pcnt, void* psum, void* cnt, void* l1,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  if (dt == 1)
    tail_tiles<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)g, d, nt, vec, (const float*)thresh,
        (const uint8_t*)gate, (int*)pcnt, (double*)psum);
  else
    tail_tiles<float><<<grid, kThreads, 0, st>>>(
        (const float*)g, d, nt, vec, (const float*)thresh,
        (const uint8_t*)gate, (int*)pcnt, (double*)psum);
  tail_finish<<<(unsigned)rows, kThreads, 0, st>>>(
      (const int*)pcnt, (const double*)psum, nt, (const uint8_t*)gate,
      (long long*)cnt, (float*)l1);
  return (int)cudaGetLastError();
}

int gspar_select_stats(const void* g, int dt, const void* u, long long rows,
                       long long d, int vec_g, int vec_u, int pk,
                       const void* s1, const void* s2, const void* budget,
                       long long k_cap, void* pcnt, void* pnzc, void* pties,
                       void* ppsum, void* pden, void* pvsq, void* pvmx,
                       void* base, void* tie_base, void* cnt, void* nzc,
                       void* psum, void* den, void* vsq, void* vmx,
                       int round_v, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_kind(pk, [&](auto kind) {
    constexpr int PK = decltype(kind)::value;
    if (dt == 1)
      launch_select<PK, __nv_bfloat16>(
          g, u, rows, d, vec_g, vec_u, s1, s2, budget, k_cap, pcnt, pnzc,
          pties, ppsum, pden, pvsq, pvmx, base, tie_base, cnt, nzc, psum, den,
          vsq, vmx, round_v, st);
    else
      launch_select<PK, float>(
          g, u, rows, d, vec_g, vec_u, s1, s2, budget, k_cap, pcnt, pnzc,
          pties, ppsum, pden, pvsq, pvmx, base, tie_base, cnt, nzc, psum, den,
          vsq, vmx, round_v, st);
  });
  return err ? err : (int)cudaGetLastError();
}

// wdt: the wire dtype code (0 float32, 1 bfloat16, 2 int8, 3 int16); an
// integer wire takes `scale` and `ucod`, and `ternary` or the qsgd `levels`.
// nnz: pass 1's survivors per row (the live prefix of the compact buffers);
// vec_r: 16-byte residual stores (aligned row base, d % 8 == 0).
int gspar_compact_emit(const void* g, int dt, const void* u, long long rows,
                       long long d, int vec_g, int vec_u, int vec_r, int pk,
                       const void* s1, const void* s2, const void* budget,
                       const void* base, const void* tie_base,
                       const void* nnz, long long k_cap, void* vals, int wdt,
                       void* idx,
                       void* res, int round_res, const void* scale,
                       const void* ucod, float levels, int ternary,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = true;
  const int err = with_kind(pk, [&](auto kind) {
    constexpr int PK = decltype(kind)::value;
#define GSPAR_EMIT(T, W)                                                     \
  launch_emit<PK, T, W>(g, u, rows, d, vec_g, vec_u, vec_r, s1, s2, budget, \
                        base, tie_base, nnz, k_cap, vals, idx, res,        \
                        round_res, scale, ucod, levels, ternary, st)
    using bf16 = __nv_bfloat16;
    if (dt == 0 && wdt == 0) GSPAR_EMIT(float, float);
    else if (dt == 0 && wdt == 1) GSPAR_EMIT(float, bf16);
    else if (dt == 1 && wdt == 1) GSPAR_EMIT(bf16, bf16);
    else if (dt == 0 && wdt == 2) GSPAR_EMIT(float, int8_t);
    else if (dt == 0 && wdt == 3) GSPAR_EMIT(float, int16_t);
    else if (dt == 1 && wdt == 2) GSPAR_EMIT(bf16, int8_t);
    else if (dt == 1 && wdt == 3) GSPAR_EMIT(bf16, int16_t);
    else ok = false;
#undef GSPAR_EMIT
  });
  if (err) return err;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
// status: rows * (ceil(k_cap / kRiceTile) + 1) 64-bit words (the blocks'
// look-back status words, then a ticket counter per row) and words: both
// zeroed here before the launch; vec: 16-byte idx loads (aligned base,
// k_cap % 4 == 0).
// r_rows null: every row at r (the static format); else row i at r_rows[i],
// and `used` takes the fitted header (r_rows[i] << 26) | used.
int gspar_rice_pack(const void* idx, const void* nnz, long long rows,
                    long long k_cap, int r, const void* r_rows,
                    long long cap_words, int vec, void* status, void* words,
                    void* used, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = (k_cap + kRiceTile - 1) / kRiceTile;
  const int64_t sbytes = rows * (nb + 1) * 8, wbytes = rows * cap_words * 4;
  if ((char*)words == (char*)status + sbytes) {   // one memset for both
    cudaMemsetAsync(status, 0, sbytes + wbytes, st);
  } else {
    cudaMemsetAsync(status, 0, sbytes, st);
    cudaMemsetAsync(words, 0, wbytes, st);
  }
  dim3 grid(grid_x(nb), (unsigned)rows);
  if (rows * nb > 0 && r_rows == nullptr)
    rice_pack<false><<<grid, kThreads, 0, st>>>(
        (const int*)idx, (const int*)nnz, k_cap, r, nullptr, nb, cap_words,
        vec, (unsigned long long*)status, (unsigned*)words, (int*)used);
  else if (rows * nb > 0)
    rice_pack<true><<<grid, kThreads, 0, st>>>(
        (const int*)idx, (const int*)nnz, k_cap, 0, (const int*)r_rows, nb,
        cap_words, vec, (unsigned long long*)status, (unsigned*)words,
        (int*)used);
  return (int)cudaGetLastError();
}

// The fitted parameter of each row: window r0..r{nw-1} ascending (nw <= 4);
// acc: rows x 4 uint64 scratch (zeroed here); r_out, header: int32 [rows].
int gspar_rice_fit(const void* idx, const void* nnz, long long rows,
                   long long k_cap, int nw, int r0, int r1, int r2, int r3,
                   int vec, void* acc, void* r_out, void* header,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nw < 1 || nw > kFitMax) return (int)cudaErrorInvalidValue;
  const int4 window = make_int4(r0, r1, r2, r3);
  const int64_t nb = (k_cap + kRiceTile - 1) / kRiceTile;
  cudaMemsetAsync(acc, 0, rows * kFitMax * 8, st);
  dim3 grid(grid_x(nb), (unsigned)rows);
  if (rows * nb > 0)
    rice_fit_tiles<<<grid, kThreads, 0, st>>>(
        (const int*)idx, (const int*)nnz, k_cap, window, vec,
        (unsigned long long*)acc);
  if (rows > 0)
    rice_fit_finish<<<(unsigned)((rows + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(
        (const unsigned long long*)acc, rows, k_cap, nw, window,
        (int*)r_out, (int*)header);
  return (int)cudaGetLastError();
}

// Kernels 5, 6 and 8. pk: the selector kind (kLam, kRho, kBern, kTopk,
// kOne) with its per-row s1 (lambda, rho, t), s2 (bern: max|g|) and topk's
// budget and per-tile tie bases (pass 1's); wdt: the wire dtype code of q
// (0 float32, 1 bfloat16); int_codec: q is the decoded level of an integer
// codec in g's dtype (wdt = dt), from the per-row `scale` and the codec
// uniforms `ucod` shaped like g, `ternary` or the qsgd `levels`; `res`
// non-null: kernel 6; `prng` non-zero (kLam, float codec): kernel 8 (no
// u, no res, no sum g^2), Philox keyed (seed, 0); `pden` and `den` null:
// no sum g^2.
int gspar_sparsify(const void* g, int dt, const void* u, long long rows,
                   long long d, int vec, int pk, const void* s1,
                   const void* s2, const void* budget, const void* tie_base,
                   int prng, unsigned seed, int int_codec, const void* scale,
                   const void* ucod, float levels, int ternary, void* q,
                   int wdt, void* res, void* pcnt, void* psure, void* psq,
                   void* pden, void* cnt, void* sure, void* sq, void* den,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = true;
  const int err = with_dense_kind(pk, [&](auto kind) {
    constexpr int PK = decltype(kind)::value;
#define GSPAR_SPARSIFY(T, W, INT)                                             \
  launch_sparsify<PK, T, W, INT>(g, u, rows, d, vec, s1, s2, budget,         \
                                 tie_base, prng, seed, scale, ucod, levels,  \
                                 ternary, q, res, pcnt, psure, psq, pden, st)
    using bf16 = __nv_bfloat16;
    if (int_codec && dt == 0 && wdt == 0) GSPAR_SPARSIFY(float, float, true);
    else if (int_codec && dt == 1 && wdt == 1) GSPAR_SPARSIFY(bf16, bf16, true);
    else if (int_codec) ok = false;
    else if (dt == 0 && wdt == 0) GSPAR_SPARSIFY(float, float, false);
    else if (dt == 0 && wdt == 1) GSPAR_SPARSIFY(float, bf16, false);
    else if (dt == 1 && wdt == 1) GSPAR_SPARSIFY(bf16, bf16, false);
    else ok = false;
#undef GSPAR_SPARSIFY
  });
  if (err) return err;
  if (!ok) return (int)cudaErrorInvalidValue;
  sparsify_finish<<<(unsigned)rows, kThreads, 0, st>>>(
      (const int*)pcnt, (const int*)psure, (const double*)psq,
      (const double*)pden, (d + kTile - 1) / kTile, (long long*)cnt,
      (long long*)sure, (float*)sq, (float*)den);
  return (int)cudaGetLastError();
}

// topk's threshold and tie budget per row. bits: the key bits of each
// round, from the top (0 ends the list; they sum to 15 for bf16, 31 for
// f32); hist: rows x 2^max(bits) uint32 (zeroed here before each round);
// state: rows x 3 int64; t: f32 [rows]; budget: int64 [rows].
int gspar_topk_threshold(const void* g, int dt, long long rows, long long d,
                         int vec, long long k_target, int bits0, int bits1,
                         int bits2, void* hist, void* state, void* t,
                         void* budget, void* stream) {
  const int bits[3] = {bits0, bits1, bits2};
  cudaStream_t st = (cudaStream_t)stream;
  if (dt == 1)
    return launch_topk_threshold<__nv_bfloat16>(g, rows, d, vec, k_target,
                                                bits, hist, state, t, budget,
                                                st);
  return launch_topk_threshold<float>(g, rows, d, vec, k_target, bits, hist,
                                      state, t, budget, st);
}

// The bf16 magnitude histogram alone (topk_threshold's one bf16 round):
// hist rows x 2^15 uint32, zeroed here.
int gspar_magnitude_hist(const void* g, long long rows, long long d, int vec,
                         void* hist, void* stream) {
  launch_radix_hist<__nv_bfloat16>(g, rows, d, vec, 0, 15, nullptr, hist,
                                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Algorithm 2's lambda per row from the magnitude histogram `hist` (rows x
// 2^15): lam float32 [rows], bin int32 [rows] (-1: no bin qualifies).
int gspar_closed_lambda(const void* hist, long long rows, double eps,
                        void* lam, void* bin, void* stream) {
  if (rows > 0)
    closed_finish<<<(unsigned)rows, kRadixThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)hist, eps, (float*)lam, (int*)bin);
  return (int)cudaGetLastError();
}

// The magnitude compaction's row scalars at k_cap for bf16 g: hist rows x
// 2^15 uint32 (zeroed here); t float32, budget int64, nonzeros, kept int32,
// sum_sq, max_abs float32, each [rows].
int gspar_compact_bins(const void* g, long long rows, long long d, int vec,
                       long long k_cap, void* hist, void* t, void* budget,
                       void* nonzeros, void* kept, void* sum_sq,
                       void* max_abs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k_cap < 1 || k_cap > d) return (int)cudaErrorInvalidValue;
  launch_radix_hist<__nv_bfloat16>(g, rows, d, vec, 0, 15, nullptr, hist,
                                   st);
  if (rows > 0)
    compact_finish<<<(unsigned)rows, kRadixThreads, 0, st>>>(
        (const unsigned*)hist, d, k_cap, (float*)t, (long long*)budget,
        (int*)nonzeros, (int*)kept, (float*)sum_sq, (float*)max_abs);
  return (int)cudaGetLastError();
}

// The compaction's select-and-compact pass for bf16 g, from compact_bins'
// t, budget and kept. status: rows x (ceil(d / kSelTile) + 1) uint64 (the
// tiles' look-back words, then a ticket counter per row), zeroed here.
// wdt: the wire dtype code (1 bfloat16: the f32 and bf16 codecs; 2 int8, 3
// int16: an integer codec, with `scale` and `ternary` or the qsgd
// `levels`, rounded deterministically).
int gspar_compact_select(const void* g, long long rows, long long d, int vec,
                         long long k_cap, const void* t, const void* budget,
                         const void* kept, void* status, void* vals, int wdt,
                         void* idx, const void* scale, float levels,
                         int ternary, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nt = (d + kSelTile - 1) / kSelTile;
  cudaMemsetAsync(status, 0, rows * (nt + 1) * 8, st);
  dim3 grid(grid_x(nt), (unsigned)rows);
  if (rows * nt == 0) return (int)cudaGetLastError();
#define GSPAR_SELECT(W)                                                      \
  do {                                                                       \
    cudaFuncSetAttribute(compact_select<W>,                                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         kSelSmem);                                          \
    compact_select<W><<<grid, kSelThreads + 32, kSelSmem, st>>>(             \
        (const __nv_bfloat16*)g, d, nt, vec, (const float*)t,                \
        (const long long*)budget, (const int*)kept, k_cap,                   \
        (unsigned long long*)status, (W*)vals, (int*)idx,                    \
        (const float*)scale, levels, ternary);                               \
  } while (0)
  if (wdt == 1) GSPAR_SELECT(__nv_bfloat16);
  else if (wdt == 2) GSPAR_SELECT(int8_t);
  else if (wdt == 3) GSPAR_SELECT(int16_t);
  else return (int)cudaErrorInvalidValue;
#undef GSPAR_SELECT
  return (int)cudaGetLastError();
}

int gspar_philox(const void* ck, void* out, long long n, void* stream) {
  philox_kat<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
               (cudaStream_t)stream>>>((const unsigned*)ck, (unsigned*)out,
                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"
