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
//                    parts)  Golomb-Rice packing of the compact idx stream
//   stats         <- stats_2d         (kernel.py:239)  (sum|g|, sum g^2, max)
//   sparsify      <- sparsify_2d      (kernel.py:96)   dense Q(g), wire dtype
//   sparsify_ef   <- sparsify_ef_2d   (kernel.py:123)  Q(g) and g - Q(g)
//   sparsify_prng <- sparsify_prng_2d (kernel.py:157)  Q(g), Philox uniforms
//
// The first five run the sparse gather wire, the last four the dense wire
// (stats, tail_stats and sparsify or sparsify_ef) and ops.gspar_sparsify_prng.
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
// of its row. Per-row scalars (lambda, rho, max|g|, the topk threshold and
// tie budget, the codec scale, the saturation gate) are read from device
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
// registers. rice_pack reads the compact idx and writes the code words, and
// the dense wire's kernels write Q (and the residual) with 16-byte vector
// stores (see their sections).
//
// Order without a sequential grid. The TPU carries the compact rank (and
// topk's tie rank) from tile to tile in SMEM across a grid that runs in
// order. Hopper blocks run in no order, so pass 1 writes per-(row, tile)
// survivor (and tie) counts, a one-block-per-row finish kernel scans them
// into per-tile base ranks, and pass 2 gives every survivor its slot as base
// + in-block rank (thread counts, warp shuffles and one block scan). Slots
// are written without atomics, so idx ascends by coordinate and the padding
// slots keep the zeros the wrapper allocated.
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

// The selector over one thread's kItems consecutive elements of a sweep
// (i = its first coordinate, end = the tile's end). topk ranks its ties with
// a block-wide scan, so every thread of the block calls this in every sweep;
// `tie_rank` carries the row's ties before the sweep.
template <int PK>
__device__ __forceinline__ void select_sweep(const float x[kItems],
                                             const float r[kItems], int64_t i,
                                             int64_t end, float s1, float s2,
                                             long long budget,
                                             long long* tie_rank,
                                             int* sh_scan, bool z[kItems],
                                             float v[kItems]) {
  if constexpr (PK == kTopk) {
    bool tie[kItems];
    int lt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool valid = i + k < end;
      const float a = fabsf(x[k]);
      z[k] = valid && a > s1;
      tie[k] = valid && a == s1 && s1 > 0.f;
      lt += tie[k];
    }
    int total;
    long long tr = *tie_rank + block_excl_scan(lt, &total, sh_scan);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (tie[k]) {
        z[k] = tr < budget;
        ++tr;
      }
      v[k] = z[k] ? x[k] : 0.f;
    }
    *tie_rank += total;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const Sample o = sample<PK>(x[k], r[k], s1, s2, i + k < end);
      z[k] = o.z;
      v[k] = o.v;
    }
  }
}

// Pass 1 per (row, tile): survivors, support |{g != 0}|, sum p, sum g^2, sum
// v^2 and max|v| (for topk: of the strict survivors, plus the tile's ties).
template <int PK, typename T>
__global__ void __launch_bounds__(kThreads)
select_tiles(const T* __restrict__ g, const float* __restrict__ u, int64_t d,
             int64_t ntiles, int vec_g, int vec_u,
             const float* __restrict__ s1p, const float* __restrict__ s2p,
             int* __restrict__ pcnt, int* __restrict__ pnzc,
             int* __restrict__ pties, double* __restrict__ ppsum,
             double* __restrict__ pden, double* __restrict__ pvsq,
             float* __restrict__ pvmx) {
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const float s1 = s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const T* grow = g + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  int cnt = 0, nzc = 0, ties = 0;
  double ps = 0.0, dn = 0.0, vs = 0.0;
  float vm = 0.f;
  for (int64_t i = start + threadIdx.x * kItems; i < end; i += kSweep) {
    float x[kItems], r[kItems];
    load_items(grow, i, end, vec_g, x);
    if constexpr (PK != kTopk) load_items(u + row * d, i, end, vec_u, r);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i + k >= end) continue;
      const float a = fabsf(x[k]);
      const float a2 = a * a;
      nzc += a > 0.f;
      dn += a2;
      if constexpr (PK == kTopk) {
        if (a > s1) {
          const float v2 = x[k] * x[k];
          ++cnt;
          ps += 1.0;
          vs += v2;
          vm = fmaxf(vm, a);
        } else if (a == s1 && s1 > 0.f) {
          ++ties;
        }
      } else {
        const Sample o = sample<PK>(x[k], r[k], s1, s2, true);
        const float v2 = o.v * o.v;
        ps += o.p;
        cnt += o.z;
        vs += v2;
        vm = fmaxf(vm, fabsf(o.v));
      }
    }
  }
  __shared__ int sh_i[32];
  __shared__ double sh_d[32];
  __shared__ float sh_f[32];
  cnt = block_sum(cnt, sh_i);
  nzc = block_sum(nzc, sh_i);
  if constexpr (PK == kTopk) ties = block_sum(ties, sh_i);
  ps = block_sum(ps, sh_d);
  dn = block_sum(dn, sh_d);
  vs = block_sum(vs, sh_d);
  vm = block_max(vm, sh_f);
  if (threadIdx.x == 0) {
    const int64_t o = row * ntiles + tile;
    pcnt[o] = cnt;
    pnzc[o] = nzc;
    if constexpr (PK == kTopk) pties[o] = ties;
    ppsum[o] = ps;
    pden[o] = dn;
    pvsq[o] = vs;
    pvmx[o] = vm;
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
              float* __restrict__ vmx_out) {
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
      ps += ppsum[o] + kept;
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
    for (int64_t s = start; s < end; s += kSweep) {   // uniform over the block
      const int64_t i = s + threadIdx.x * kItems;
      float x[kItems], r[kItems];
      load_items(grow, i, end, vec_g, x);
      if constexpr (PK != kTopk) load_items(u + row * d, i, end, vec_u, r);
      bool z[kItems];
      float v[kItems];
      select_sweep<PK>(x, r, i, end, s1, s2, budget, &tie_rank, sh_scan, z,
                       v);
      int lc = 0;
#pragma unroll
      for (int k = 0; k < kItems; ++k) lc += z[k];
      int total;
      long long rk = rank0 + block_excl_scan(lc, &total, sh_scan);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (z[k]) {
          if (rk < k_cap) {
            const float v2 = v[k] * v[k];
            vs += v2;
            vm = fmaxf(vm, fabsf(v[k]));
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
// j], the codec uniform at the survivor's compact rank. With `res` (float
// codecs) the EF residual g - encoded value is written for every coordinate,
// overflow-dropped survivors included; the encoded value is the codec's
// output in float32, so it is W-rounded only for a rounding codec
// (`round_res`: bf16), as on the TPU. The integer codecs' EF subtracts the
// decoded level, a product formed after the exchange's scale is known: the
// backend scatters it from the compact buffers instead.
// ---------------------------------------------------------------------------

template <int PK, typename T, typename W>
__global__ void __launch_bounds__(kThreads)
compact_emit(const T* __restrict__ g, const float* __restrict__ u, int64_t d,
             int64_t ntiles, int vec_g, int vec_u,
             const float* __restrict__ s1p, const float* __restrict__ s2p,
             const long long* __restrict__ budgetp,
             const int* __restrict__ base, const int* __restrict__ tie_base,
             int64_t k_cap, W* __restrict__ vals, int* __restrict__ idx,
             T* __restrict__ res, int round_res,
             const float* __restrict__ scale, const float* __restrict__ ucod,
             float levels, int ternary) {
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t o = row * ntiles + tile;
  long long rank0 = base[o];
  if (res == nullptr && rank0 >= k_cap) return;   // uniform over the block
  const float s1 = s1p[row];
  const float s2 = PK == kBern ? s2p[row] : 0.f;
  const long long budget = PK == kTopk ? budgetp[row] : 0;
  long long tie_rank = PK == kTopk ? tie_base[o] : 0;
  const float sc = IntWire<W>::value ? scale[row] : 1.f;
  const float* ucrow = IntWire<W>::value ? ucod + row * k_cap : nullptr;
  const T* grow = g + row * d;
  W* vrow = vals + row * k_cap;
  int* irow = idx + row * k_cap;
  T* rrow = res == nullptr ? nullptr : res + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  __shared__ int sh_scan[33];
  for (int64_t s = start; s < end; s += kSweep) {     // uniform over the block
    const int64_t i = s + threadIdx.x * kItems;
    float x[kItems], r[kItems];
    load_items(grow, i, end, vec_g, x);
    if constexpr (PK != kTopk) load_items(u + row * d, i, end, vec_u, r);
    bool z[kItems];
    float v[kItems];
    select_sweep<PK>(x, r, i, end, s1, s2, budget, &tie_rank, sh_scan, z, v);
    int lc = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) lc += z[k];
    int total;
    long long rk = rank0 + block_excl_scan(lc, &total, sh_scan);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (z[k]) {
        if (rk < k_cap) {
          if constexpr (IntWire<W>::value)
            vrow[rk] = (W)(int)int_level(v[k], sc, ucrow[rk], levels, ternary);
          else
            vrow[rk] = from_f32<W>(v[k]);
          irow[rk] = (int)(i + k);
        }
        ++rk;
      }
      if constexpr (!IntWire<W>::value) {
        if (rrow != nullptr && i + k < end) {
          const float enc = round_res ? to_f32(from_f32<W>(v[k])) : v[k];
          rrow[i + k] = from_f32<T>(x[k] - (z[k] ? enc : 0.f));
        }
      }
    }
    rank0 += total;
  }
}

// ---------------------------------------------------------------------------
// Kernel 5: Golomb-Rice packing of the compact index stream (the RICE wire
// layout), from pass 2's ascending idx[rows, k_cap] and pass 1's nnz. Per row,
// with n_live = min(nnz, k_cap), live code i has x_i = idx_i - idx_{i-1} - 1
// (idx_{-1} = -1) and q_i = x_i >> r; dead codes have x = 0. The stream is
// [k_cap*r remainder bits | unary field] in cap_words zeroed int32 words: the
// low r bits of x_i at bit i*r, the terminator of code i at unary position
// sum_{j<=i} q_j + i, and one-bits below live_end = sum q + n_live except at
// terminators. used = ceil((k_cap*r + sum q + k_cap) / 32).
//
// The TPU packs inside pass 2 and carries the previous coordinate and the
// running quotient sum across its sequential grid in SMEM. Here the packing
// reads the compact buffer instead, so those carries become a scan over the
// k_cap codes: rice_tiles sums q per block of kRiceTile codes (the previous
// code's index is one load across the block edge), rice_scan turns the sums
// into per-block unary bases, rice_write writes the remainders (a warp's 32
// codes own r whole words: an OR-reduction over the warp and plain stores)
// and sets the terminators with atomicOr (disjoint bits: the same words in
// any order), and rice_finalize flips each unary word below live_end. Bound:
// one read of each row's live idx prefix (4 B per live code; dead codes are
// never loaded) and one write of the words.
// ---------------------------------------------------------------------------

constexpr int64_t kRiceTile = 8 * kThreads;    // codes per block

struct RiceCode {
  int64_t x;      // gap - 1 (0 for dead codes and codes past k_cap)
  bool live;
};

__device__ __forceinline__ RiceCode rice_code(const int* __restrict__ irow,
                                              int64_t i, int64_t n_live) {
  RiceCode c;
  c.live = i < n_live;
  const int64_t prev = i > 0 && c.live ? irow[i - 1] : -1;
  c.x = c.live ? (int64_t)irow[i] - prev - 1 : 0;
  return c;
}

__device__ __forceinline__ int64_t live_count(const int* __restrict__ nnz,
                                              int64_t row, int64_t k_cap) {
  const int64_t n = nnz[row];
  return n < k_cap ? n : k_cap;
}

__global__ void __launch_bounds__(kThreads)
rice_tiles(const int* __restrict__ idx, const int* __restrict__ nnz,
           int64_t k_cap, int r, int64_t nb, int* __restrict__ qsum) {
  const int64_t row = blockIdx.y, b = blockIdx.x;
  const int* irow = idx + row * k_cap;
  const int64_t n_live = live_count(nnz, row, k_cap);
  const int64_t start = b * kRiceTile;
  const int64_t end = k_cap < start + kRiceTile ? k_cap : start + kRiceTile;
  int s = 0;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads)
    s += (int)(rice_code(irow, i, n_live).x >> r);
  __shared__ int sh[32];
  s = block_sum(s, sh);
  if (threadIdx.x == 0) qsum[row * nb + b] = s;
}

// One block per row: exclusive scan of the block quotient sums into unary
// bases; the row's used word count and the end of its live unary bits.
__global__ void __launch_bounds__(kThreads)
rice_scan(const int* __restrict__ qsum, const int* __restrict__ nnz,
          int64_t k_cap, int r, int64_t nb, int* __restrict__ qbase,
          int* __restrict__ used, long long* __restrict__ live_end) {
  const int64_t row = blockIdx.x;
  __shared__ int sh_scan[33];
  long long running = 0;
  for (int64_t c0 = 0; c0 < nb; c0 += blockDim.x) {
    const int64_t b = c0 + threadIdx.x;
    const int q = b < nb ? qsum[row * nb + b] : 0;
    int total;
    const int ex = block_excl_scan(q, &total, sh_scan);
    if (b < nb) qbase[row * nb + b] = (int)(running + ex);
    running += total;
  }
  if (threadIdx.x == 0) {
    used[row] = (int)((k_cap * r + running + k_cap + 31) / 32);
    live_end[row] = running + live_count(nnz, row, k_cap);
  }
}

__global__ void __launch_bounds__(kThreads)
rice_write(const int* __restrict__ idx, const int* __restrict__ nnz,
           int64_t k_cap, int r, int64_t nb, int64_t cap_words,
           const int* __restrict__ qbase, unsigned* __restrict__ words) {
  const int64_t row = blockIdx.y, b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int* irow = idx + row * k_cap;
  unsigned* wrow = words + row * cap_words;
  const int64_t n_live = live_count(nnz, row, k_cap);
  const int64_t rem_bits = k_cap * r;            // the remainder field
  const unsigned rmask = (1u << r) - 1u;
  __shared__ int sh_scan[33];
  long long carry = qbase[row * nb + b];
  // every thread runs every sweep: the warp and block collectives below
  for (int64_t s = b * kRiceTile; s < (b + 1) * kRiceTile; s += kThreads) {
    const int64_t i = s + threadIdx.x;
    const RiceCode c = i < k_cap ? rice_code(irow, i, n_live)
                                 : RiceCode{0, false};
    const int q = (int)(c.x >> r);
    int total;
    const int ex = block_excl_scan(q, &total, sh_scan);
    if (c.live) {
      const int64_t bit = rem_bits + carry + ex + q + i;   // terminator
      atomicOr(wrow + (bit >> 5), 1u << (bit & 31));
    }
    carry += total;
    // this warp's 32 codes start at a multiple of 32, so their remainders
    // fill exactly r words: word j gathers every lane's bits that land there
    const int64_t w0 = (i - lane) * r / 32;
    const unsigned rem = (unsigned)c.x & rmask;
    for (int j = 0; j < r; ++j) {
      const int off = lane * r - 32 * j;
      unsigned part = 0u;
      if (off >= 0 && off < 32) part = rem << off;
      else if (off < 0 && -off < r) part = rem >> (-off);
      const unsigned w = __reduce_or_sync(kFull, part);
      const int64_t wi = w0 + j;
      if (lane == j) {
        if ((wi + 1) * 32 <= rem_bits) wrow[wi] = w;
        else if (wi * 32 < rem_bits && w) atomicOr(wrow + wi, w);  // shares
      }                                            // its word with the unary
    }
  }
}

// Unary field: one-bits below live_end except at the terminators, so each
// word's unary bits below live_end flip. Remainder bits are left alone.
__global__ void __launch_bounds__(kThreads)
rice_finalize(int64_t k_cap, int r, int64_t cap_words,
              const long long* __restrict__ live_end,
              unsigned* __restrict__ words) {
  const int64_t row = blockIdx.y;
  const int64_t wi = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (wi >= cap_words) return;
  const int64_t lo = k_cap * r, hi = lo + live_end[row];
  const int64_t wb = wi * 32;
  const int64_t a = (lo > wb ? lo : wb) - wb;
  const int64_t e = (hi < wb + 32 ? hi : wb + 32) - wb;
  if (a >= e) return;
  const unsigned below_e = e >= 32 ? ~0u : (1u << e) - 1u;
  words[row * cap_words + wi] ^= below_e & ~((1u << a) - 1u);
}

// ---------------------------------------------------------------------------
// Kernels 5, 6 and 8: the dense Q(g) of the dense wire. Per coordinate
//   p = min(lam |g|, 1), z = u < p, q = z ? g / p : 0
// rounded to the wire type W on the way out; with kEF also the residual
// g - float(q) after that rounding, in g's type T (kernel 6, as
// _sparsify_ef_body subtracts the stored Q); with kPrng the uniforms come
// from Philox4x32-10 in the kernel instead of an input buffer (kernel 8).
// The same pass reduces per (row, tile) what the dense wire's accounting
// reads of q as the wire carries it: the nonzeros, those with p = 1, and
// sum q^2 (f64 partials), so no torch reduction walks the 2.5e9 coordinates
// again. A finish kernel per row sums the partials.
//
// Bound: one read of g (and of the f32 uniforms), one write of Q (and of the
// residual): 8 B/coord for bf16 g and Q (kernel 5), 10 B with the residual,
// 4 B with the uniforms from Philox. Loads and stores are 16-byte vectors
// where every row base is aligned and d % 8 == 0 (one for 8 bf16, two for 8
// f32), scalar at a ragged end.
//
// Philox. The TPU seeds its on-core generator per tile (kernel.py:84-85), so
// its stream depends on the tiling. Here the key is (seed, 0) and the
// counter (i / 4, row, 0, 0): one call gives the four uniforms of
// coordinates i..i+3, u = (bits >> 8) * 2^-24, whatever the tile size.
// ---------------------------------------------------------------------------

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

template <typename T, typename W, bool kEF, bool kPrng>
__global__ void __launch_bounds__(kThreads)
sparsify_tiles(const T* __restrict__ g, const float* __restrict__ u,
               int64_t d, int64_t ntiles, int vec,
               const float* __restrict__ lamp, unsigned seed,
               W* __restrict__ q, T* __restrict__ res,
               int* __restrict__ pcnt, int* __restrict__ psure,
               double* __restrict__ psq) {
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const float lam = lamp[row];
  const T* grow = g + row * d;
  W* qrow = q + row * d;
  const int64_t start = tile * kTile;
  const int64_t end = row_end(d, start);
  int cnt = 0, sure = 0;
  double sq = 0.0;
  for (int64_t i = start + threadIdx.x * kItems; i < end; i += kSweep) {
    float x[kItems], r[kItems], w[kItems];
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
    } else {
      load_items(u + row * d, i, end, vec, r);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float p = fminf(lam * fabsf(x[k]), 1.f);
      const bool z = i + k < end && r[k] < p;
      w[k] = to_f32(from_f32<W>(z ? __fdiv_rn(x[k], p) : 0.f));
      if (w[k] != 0.f) {
        ++cnt;
        sure += p >= 1.f;
        sq += __fmul_rn(w[k], w[k]);
      }
    }
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
  if (threadIdx.x == 0) {
    const int64_t o = row * ntiles + tile;
    pcnt[o] = cnt;
    psure[o] = sure;
    psq[o] = sq;
  }
}

__global__ void __launch_bounds__(kThreads)
sparsify_finish(const int* __restrict__ pcnt, const int* __restrict__ psure,
                const double* __restrict__ psq, int64_t ntiles,
                long long* __restrict__ cnt, long long* __restrict__ sure,
                float* __restrict__ sq) {
  const int64_t row = blockIdx.x;
  long long c = 0, s = 0;
  double q = 0.0;
  for (int64_t t = threadIdx.x; t < ntiles; t += blockDim.x) {
    c += pcnt[row * ntiles + t];
    s += psure[row * ntiles + t];
    q += psq[row * ntiles + t];
  }
  __shared__ long long sh_l[32];
  __shared__ double sh_d[32];
  c = block_sum(c, sh_l);
  s = block_sum(s, sh_l);
  q = block_sum(q, sh_d);
  if (threadIdx.x == 0) {
    cnt[row] = c;
    sure[row] = s;
    sq[row] = (float)q;
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
                   void* den, void* vsq, void* vmx, cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  select_tiles<PK, T><<<grid, kThreads, 0, st>>>(
      (const T*)g, (const float*)u, d, nt, vec_g, vec_u, (const float*)s1,
      (const float*)s2, (int*)pcnt, (int*)pnzc, (int*)pties, (double*)ppsum,
      (double*)pden, (double*)pvsq, (float*)pvmx);
  select_finish<PK, T><<<(unsigned)rows, kThreads, 0, st>>>(
      (const T*)g, (const float*)u, d, nt, vec_g, vec_u, (const float*)s1,
      (const float*)s2, (const long long*)budget, k_cap, (const int*)pcnt,
      (const int*)pnzc, (const int*)pties, (const double*)ppsum,
      (const double*)pden, (const double*)pvsq, (const float*)pvmx,
      (int*)base, (int*)tie_base, (int*)cnt, (int*)nzc, (float*)psum,
      (float*)den, (float*)vsq, (float*)vmx);
}

template <int PK, typename T, typename W>
void launch_emit(const void* g, const void* u, long long rows, long long d,
                 int vec_g, int vec_u, const void* s1, const void* s2,
                 const void* budget, const void* base, const void* tie_base,
                 long long k_cap, void* vals, void* idx, void* res,
                 int round_res, const void* scale, const void* ucod,
                 float levels, int ternary, cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  compact_emit<PK, T, W><<<grid, kThreads, 0, st>>>(
      (const T*)g, (const float*)u, d, nt, vec_g, vec_u, (const float*)s1,
      (const float*)s2, (const long long*)budget, (const int*)base,
      (const int*)tie_base, k_cap, (W*)vals, (int*)idx, (T*)res, round_res,
      (const float*)scale, (const float*)ucod, levels, ternary);
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

template <typename T, typename W>
void launch_sparsify(const void* g, const void* u, long long rows,
                     long long d, int vec, const void* lam, int prng,
                     unsigned seed, void* q, void* res, void* pcnt,
                     void* psure, void* psq, cudaStream_t st) {
  const int64_t nt = (d + kTile - 1) / kTile;
  dim3 grid(grid_x(nt), (unsigned)rows);
  const T* gt = (const T*)g;
  const float* uf = (const float*)u;
  const float* lf = (const float*)lam;
  if (prng)
    sparsify_tiles<T, W, false, true><<<grid, kThreads, 0, st>>>(
        gt, nullptr, d, nt, vec, lf, seed, (W*)q, nullptr, (int*)pcnt,
        (int*)psure, (double*)psq);
  else if (res != nullptr)
    sparsify_tiles<T, W, true, false><<<grid, kThreads, 0, st>>>(
        gt, uf, d, nt, vec, lf, seed, (W*)q, (T*)res, (int*)pcnt,
        (int*)psure, (double*)psq);
  else
    sparsify_tiles<T, W, false, false><<<grid, kThreads, 0, st>>>(
        gt, uf, d, nt, vec, lf, seed, (W*)q, nullptr, (int*)pcnt,
        (int*)psure, (double*)psq);
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
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_kind(pk, [&](auto kind) {
    constexpr int PK = decltype(kind)::value;
    if (dt == 1)
      launch_select<PK, __nv_bfloat16>(
          g, u, rows, d, vec_g, vec_u, s1, s2, budget, k_cap, pcnt, pnzc,
          pties, ppsum, pden, pvsq, pvmx, base, tie_base, cnt, nzc, psum, den,
          vsq, vmx, st);
    else
      launch_select<PK, float>(
          g, u, rows, d, vec_g, vec_u, s1, s2, budget, k_cap, pcnt, pnzc,
          pties, ppsum, pden, pvsq, pvmx, base, tie_base, cnt, nzc, psum, den,
          vsq, vmx, st);
  });
  return err ? err : (int)cudaGetLastError();
}

// wdt: the wire dtype code (0 float32, 1 bfloat16, 2 int8, 3 int16); an
// integer wire takes `scale` and `ucod`, and `ternary` or the qsgd `levels`.
int gspar_compact_emit(const void* g, int dt, const void* u, long long rows,
                       long long d, int vec_g, int vec_u, int pk,
                       const void* s1, const void* s2, const void* budget,
                       const void* base, const void* tie_base,
                       long long k_cap, void* vals, int wdt, void* idx,
                       void* res, int round_res, const void* scale,
                       const void* ucod, float levels, int ternary,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = true;
  const int err = with_kind(pk, [&](auto kind) {
    constexpr int PK = decltype(kind)::value;
#define GSPAR_EMIT(T, W)                                                     \
  launch_emit<PK, T, W>(g, u, rows, d, vec_g, vec_u, s1, s2, budget, base,  \
                        tie_base, k_cap, vals, idx, res, round_res, scale,  \
                        ucod, levels, ternary, st)
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
int gspar_rice_pack(const void* idx, const void* nnz, long long rows,
                    long long k_cap, int r, long long cap_words, void* qsum,
                    void* qbase, void* live_end, void* words, void* used,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = (k_cap + kRiceTile - 1) / kRiceTile;
  dim3 grid(grid_x(nb), (unsigned)rows);
  rice_tiles<<<grid, kThreads, 0, st>>>((const int*)idx, (const int*)nnz,
                                        k_cap, r, nb, (int*)qsum);
  rice_scan<<<(unsigned)rows, kThreads, 0, st>>>(
      (const int*)qsum, (const int*)nnz, k_cap, r, nb, (int*)qbase,
      (int*)used, (long long*)live_end);
  rice_write<<<grid, kThreads, 0, st>>>(
      (const int*)idx, (const int*)nnz, k_cap, r, nb, cap_words,
      (const int*)qbase, (unsigned*)words);
  dim3 fgrid((unsigned)((cap_words + kThreads - 1) / kThreads),
             (unsigned)rows);
  rice_finalize<<<fgrid, kThreads, 0, st>>>(
      k_cap, r, cap_words, (const long long*)live_end, (unsigned*)words);
  return (int)cudaGetLastError();
}


// Kernels 5, 6 and 8. wdt: the wire dtype code of q (0 float32, 1
// bfloat16); `res` non-null: kernel 6; `prng` non-zero: kernel 8 (no u, no
// res), Philox keyed (seed, 0).
int gspar_sparsify(const void* g, int dt, const void* u, long long rows,
                   long long d, int vec, const void* lam, int prng,
                   unsigned seed, void* q, int wdt, void* res, void* pcnt,
                   void* psure, void* psq, void* cnt, void* sure, void* sq,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
#define GSPAR_SPARSIFY(T, W)                                                \
  launch_sparsify<T, W>(g, u, rows, d, vec, lam, prng, seed, q, res, pcnt, \
                        psure, psq, st)
  if (dt == 0 && wdt == 0) GSPAR_SPARSIFY(float, float);
  else if (dt == 0 && wdt == 1) GSPAR_SPARSIFY(float, bf16);
  else if (dt == 1 && wdt == 1) GSPAR_SPARSIFY(bf16, bf16);
  else return (int)cudaErrorInvalidValue;
#undef GSPAR_SPARSIFY
  sparsify_finish<<<(unsigned)rows, kThreads, 0, st>>>(
      (const int*)pcnt, (const int*)psure, (const double*)psq,
      (d + kTile - 1) / kTile, (long long*)cnt, (long long*)sure, (float*)sq);
  return (int)cudaGetLastError();
}

int gspar_philox(const void* ck, void* out, long long n, void* stream) {
  philox_kat<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
               (cudaStream_t)stream>>>((const unsigned*)ck, (unsigned*)out,
                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"
