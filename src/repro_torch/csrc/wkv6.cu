// wkv6 (RWKV-6 linear attention, forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6/wkv6.py (`wkv6`, body
// `_kernel`).  Same function: per (batch, head), with a [K, K] state S
// that starts at zero,
//     S_t = diag(exp w_t) S_{t-1} + k_t^T v_t
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
// worked chunk by chunk: with cw the inclusive cumulative sum of w over
// the chunk, e = cw - w, and total its last row,
//     y   = A v + (r u k) v + (r exp(e)) S_in,
//           A[t, j] = sum_k r[t,k] k[j,k] exp(e[t,k] - cw[j,k]), j < t
//     S'  = exp(total) S_in + (k exp(total - cw))^T v.
// y comes back in r's type, the final state in fp32.
//
// Stability: every exponent taken is <= 0, as in the TPU kernel, which
// builds exp(e_t - cw_j) as an [L, L, K] tensor in VMEM (16 MiB per
// (b, h) at L = 256, K = 64); neither kernel here materialises it.  Rows
// are cut into tiles.  For j in a tile that ends at row a and t past
// that tile,
//     exp(e_t - cw_j) = exp(e_t - cw_a) * exp(cw_a - cw_j),
// and both factors have exponents <= 0 (e_t = cw_{t-1} <= cw_a <= cw_j,
// since w <= 0), so A over those pairs is a product of two [*, K]
// operands.  Pairs inside a diagonal tile take exp(e_t - cw_j) directly.
// The unbounded factoring by exp(-cw_j) of the reference's jnp form is
// never used.
//
// What bounds it on an H100 SXM: at the serve shape (B 4, S 256, H 32,
// K 64, bf16) the call moves 27.3 MB (r, k, v, y in bf16; w in fp32; the
// final state in fp32), 8.1 us at 3.35 TB/s; the recurrence's 0.54 GFLOP
// take 8.0 us at the 67 TFLOP/s fp32 rate.  Two kernels; the wrapper
// (kernels/wkv6/ops.py) picks one before the launch:
//
//   * `wkv6_tc_kernel` (bf16, rows 16-byte aligned): the chunks run in
//     parallel, on the tensor cores.  Notes at the kernel.
//   * `wkv6_kernel` (fp32, and bf16 operands off the 16-byte grid): one
//     block of 256 threads per (batch, head) loops over the chunks in
//     order with the state in shared memory, fp32 FMAs, 8-row anchor
//     tiles, chunk L the wrapper's plan halved until smem_floats(L, K)
//     fits (64 at K = 64; core/gpu_mapping.py::wkv_smem_plan mirrors the
//     sum).  Latency bounds it: 128 blocks on 132 SMs, one block per SM,
//     each chunk's steps serialised behind __syncthreads.
//
// Rows past the end of the sequence are read as zero, which leaves y and
// the state as they are, so a ragged last chunk is masked by both.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after its launch.

#include "wkv6_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// ================================== fp32: one block per (b, h), in order

constexpr int kThreads = 256;
constexpr int kTile = 8;            // rows per anchor tile
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// fp32 words of shared memory one block uses at chunk length L.
__host__ __device__ constexpr long long smem_floats(int L, int K) {
  return 1LL * K * K + 4LL * L * (K + 1) + 1LL * L * K + 1LL * L * (L + 1) +
         L + 2LL * K;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ R, const T* __restrict__ Kin,
                const T* __restrict__ V, const float* __restrict__ W,
                const float* __restrict__ U, T* __restrict__ Y,
                float* __restrict__ Sout, int S, int H, int L) {
  static_assert(K % 4 == 0 && kThreads % K == 0, "K must divide 256");
  constexpr int KP = K + 1;  // padded rows: no bank conflicts down a column
  constexpr int KQ = K / 4;
  extern __shared__ __align__(16) float smem[];
  float* st = smem;             // [K][K] state
  float* rs = st + K * K;       // [L][KP] r, later r * exp(e)
  float* ks = rs + L * KP;      // [L][KP] k, later k * exp(total - cw)
  float* ka = ks + L * KP;      // [L][KP] k * exp(cw_anchor - cw)
  float* cw = ka + L * KP;      // [L][KP] w, then its inclusive cumsum
  float* vs = cw + L * KP;      // [L][K]  (16-byte aligned: float4 rows)
  float* as = vs + L * K;       // [L][L + 1] intra-chunk A
  float* dg = as + L * (L + 1); // [L] u-bonus r u k per row
  float* us = dg + L;           // [K]
  float* tot = us + K;          // [K] the chunk's total log-decay
  const int LA = L + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long row = 1LL * H * K;
  const long long base = (1LL * b * S * H + h) * K;  // (b, s = 0, h, 0)

  for (int i = tid; i < K; i += kThreads) us[i] = U[h * K + i];
  for (int i = tid; i < K * K; i += kThreads) st[i] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  const int n_tiles = (L + kTile - 1) / kTile;
  // off-diagonal work items: (tile jb, row t) with t past tile jb
  int n_off = 0;
  for (int jb = 0; jb < n_tiles; ++jb) n_off += max(0, L - (jb + 1) * kTile);
  constexpr int kDiagPairs = kTile * (kTile - 1) / 2;
  const int n_items = n_off + n_tiles * kDiagPairs;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int n = min(L, S - t0);

    // 1. the chunk into shared memory as fp32; rows past S read as zero
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < n) {
        const long long g = base + (t0 + t) * row + k;
        rv = to_f32(R[g]);
        kv = to_f32(Kin[g]);
        vv = to_f32(V[g]);
        wv = W[g];
      }
      rs[t * KP + k] = rv;
      ks[t * KP + k] = kv;
      vs[t * K + k] = vv;
      cw[t * KP + k] = wv;
    }
    __syncthreads();

    // 2. inclusive cumsum of w down each channel, in kSeg row segments
    {
      constexpr int kSeg = kThreads / K;
      const int seg = tid / K, ch = tid % K;
      const int len = (L + kSeg - 1) / kSeg;
      const int lo = min(L, seg * len), hi = min(L, lo + len);
      float acc = 0.f;
      for (int t = lo; t < hi; ++t) {
        acc += cw[t * KP + ch];
        cw[t * KP + ch] = acc;
      }
      __syncthreads();
      float off = 0.f;
      for (int s2 = 0; s2 < seg; ++s2) {
        const int last = min(L, (s2 + 1) * len) - 1;
        if (last >= s2 * len) off += cw[last * KP + ch];
      }
      __syncthreads();
      for (int t = lo; t < hi; ++t) cw[t * KP + ch] += off;
      __syncthreads();
    }

    // 3. total decay, anchored keys and the u-bonus
    for (int i = tid; i < K; i += kThreads) tot[i] = cw[(L - 1) * KP + i];
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K, k = i % K;
      const int anchor = min(L - 1, (j / kTile) * kTile + kTile - 1);
      ka[j * KP + k] =
          ks[j * KP + k] * expf(cw[anchor * KP + k] - cw[j * KP + k]);
    }
    for (int t = tid; t < L; t += kThreads) {
      float a = 0.f;
      for (int k = 0; k < K; ++k) a += rs[t * KP + k] * us[k] * ks[t * KP + k];
      dg[t] = a;
    }
    __syncthreads();

    // 4. A[t, j] for j < t
    for (int it = tid; it < n_items; it += kThreads) {
      if (it < n_off) {
        // rows t past tile jb: one exp per (t, k), kTile products
        int jb = 0, rem = it;
        while (rem >= L - (jb + 1) * kTile) {
          rem -= L - (jb + 1) * kTile;
          ++jb;
        }
        const int j0 = jb * kTile;
        const int anchor = j0 + kTile - 1;
        const int t = j0 + kTile + rem;
        float acc[kTile];
#pragma unroll
        for (int q = 0; q < kTile; ++q) acc[q] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float rq = rs[t * KP + k] *
                           expf(cw[(t - 1) * KP + k] - cw[anchor * KP + k]);
#pragma unroll
          for (int q = 0; q < kTile; ++q) acc[q] += rq * ka[(j0 + q) * KP + k];
        }
#pragma unroll
        for (int q = 0; q < kTile; ++q) as[t * LA + j0 + q] = acc[q];
      } else {
        // a pair (t, j), j < t, inside one tile: the exponent taken directly
        const int p = it - n_off;
        const int tile = p / kDiagPairs;
        int tl = 1, jl = p % kDiagPairs;
        while (jl >= tl) {
          jl -= tl;
          ++tl;
        }
        const int t = tile * kTile + tl, j = tile * kTile + jl;
        if (t < L) {
          float a = 0.f;
          for (int k = 0; k < K; ++k)
            a += rs[t * KP + k] * ks[j * KP + k] *
                 expf(cw[(t - 1) * KP + k] - cw[j * KP + k]);
          as[t * LA + j] = a;
        }
      }
    }
    __syncthreads();

    // 5. r * exp(e) and k * exp(total - cw), in place
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      const float e = t > 0 ? cw[(t - 1) * KP + k] : 0.f;
      rs[t * KP + k] *= expf(e);
      ks[t * KP + k] *= expf(tot[k] - cw[t * KP + k]);
    }
    __syncthreads();

    // 6. y = A v + (r u k) v + (r exp(e)) S_in, 4 rows x 4 columns a thread
    for (int it = tid; it < ((L + 3) / 4) * KQ; it += kThreads) {
      const int ta = (it / KQ) * 4, v0 = (it % KQ) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ta + i;
        const float d = t < L ? dg[t] : 0.f;
        const float4 vt = t < L ? *reinterpret_cast<const float4*>(
                                      &vs[t * K + v0])
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[i][0] = d * vt.x;
        acc[i][1] = d * vt.y;
        acc[i][2] = d * vt.z;
        acc[i][3] = d * vt.w;
      }
      const int jn = min(ta + 3, L);
      for (int j = 0; j < jn; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j * K + v0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ta + i;
          const float a = (j < t && t < L) ? as[t * LA + j] : 0.f;
          acc[i][0] += a * vv.x;
          acc[i][1] += a * vv.y;
          acc[i][2] += a * vv.z;
          acc[i][3] += a * vv.w;
        }
      }
      for (int k = 0; k < K; ++k) {
        const float4 sv = *reinterpret_cast<const float4*>(&st[k * K + v0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ta + i;
          const float q = t < L ? rs[t * KP + k] : 0.f;
          acc[i][0] += q * sv.x;
          acc[i][1] += q * sv.y;
          acc[i][2] += q * sv.z;
          acc[i][3] += q * sv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ta + i;
        if (t < n) {
          T* out = Y + base + (t0 + t) * row + v0;
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = from_f32<T>(acc[i][q]);
        }
      }
    }
    __syncthreads();

    // 7. S' = exp(total) S_in + kdec^T v, 4 x 4 a thread
    for (int it = tid; it < KQ * KQ; it += kThreads) {
      const int k0 = (it / KQ) * 4, v0 = (it % KQ) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dec = expf(tot[k0 + i]);
        const float4 sv =
            *reinterpret_cast<const float4*>(&st[(k0 + i) * K + v0]);
        acc[i][0] = dec * sv.x;
        acc[i][1] = dec * sv.y;
        acc[i][2] = dec * sv.z;
        acc[i][3] = dec * sv.w;
      }
      for (int j = 0; j < n; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j * K + v0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kd = ks[j * KP + k0 + i];
          acc[i][0] += kd * vv.x;
          acc[i][1] += kd * vv.y;
          acc[i][2] += kd * vv.z;
          acc[i][3] += kd * vv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&st[(k0 + i) * K + v0]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
  }

  float* so = Sout + 1LL * bh * K * K;
  for (int i = tid; i < K * K; i += kThreads) so[i] = st[i];
}

template <typename T, int K>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* state,
                     int B, int S, int H, int L, cudaStream_t s) {
  const long long bytes = smem_floats(L, K) * 4;
  if (L < 1 || bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, K><<<B * H, kThreads, bytes, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(state), S, H, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* y, void* state,
                         int B, int S, int H, int K, int L, cudaStream_t s) {
  switch (K) {
    case 32:
      return launch_k<T, 32>(r, k, v, w, u, y, state, B, S, H, L, s);
    case 64:
      return launch_k<T, 64>(r, k, v, w, u, y, state, B, S, H, L, s);
    case 128:
      return launch_k<T, 128>(r, k, v, w, u, y, state, B, S, H, L, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ======================== bf16: the chunks in parallel across a cluster
//
// One block of 256 threads per (batch, head, `rows`-row chunk of the
// sequence); the chunks of one (b, h) are the ranks of a thread-block
// cluster (cluster dims (csize, 1, 1), csize = min(8, chunks)).  Where a
// sequence has more than 8 chunks, the cluster walks groups of csize
// chunks and carries the state from one group to the next.  Per group:
//
//   1. loads: w (fp32) and r, k, v (bf16) by cp.async, 16 bytes a thread,
//      w in its own commit group so the scan starts before r, k, v land;
//   2. the cumulative log2-decay cw: w scaled by log2(e) as it is read,
//      summed down each channel in kTcThreads / K row segments; every
//      exponential of the kernel is then one ex2.approx of a difference
//      of these sums;
//   3. the decay over the chunk, exp2(total), per channel; the anchored
//      keys k' = k exp2(cw_a - cw) (a the last row of the key's 16-row
//      sub-tile); A inside each 8-row half of the diagonal sub-tiles, in
//      fp32 FMAs with the exponents taken directly, the u bonus r u k on
//      its diagonal;
//   4. A off the diagonal: for sub-tiles j < i, q' = r exp2(e_t - cw_a)
//      built in registers as mma.sync A fragments against k' (both
//      exponents <= 0); and in each diagonal sub-tile its second half's
//      rows against its first half's keys the same way, through the
//      anchor row between the halves (the last warp takes half of these
//      blocks during step 3).  That leaves 2 x 28 of a diagonal
//      sub-tile's 120 pairs to take an exp2 per channel each.  Every
//      bf16 operand made here (q', k', A, and in
//      steps 5 and 7 r exp2(e), kd and S_in) is kept as a hi part and
//      the bf16 rounding of what it misses, and a product takes
//      hi.hi + lo.hi + hi.lo: one bf16 rounding costs 2^-9 of terms that
//      cancel, which the card's check of y (and 1e-4 of the state) does
//      not allow.  r, k and v are exact in bf16;
//   5. r exp2(e) and kd = k exp2(total - cw), each as hi + lo;
//   6. the chunk's state contribution dS = hi^T v + lo^T v (mma.sync,
//      fp32 accumulators) into shared memory, where the cluster reads it;
//   7. cluster barrier; the blocks fold the ranks' (dS, exp2(total))
//      in rank order through distributed shared memory,
//      S = exp2(total_c) S + dS_c from zero (or the group's carry), each
//      block over a 1/csize share of the state's elements, all ranks'
//      loads in flight at once, and store the state entering each rank's
//      chunk, S_in (as bf16 hi + lo parts), into that rank's shared
//      memory.  One fixed order for every element gives the same bits
//      from the same inputs; no atomics.  Each block keeps its share of
//      the carry to the next group, and in the last group writes its
//      share of the final state.  A second cluster barrier: every S_in
//      is in place and no block reads another's dS any more, so a block
//      may reload or leave as soon as it is done;
//   8. y = A v + (r exp2(e)) S_in on the tensor cores, the second product
//      from the hi and lo parts of both factors, stored for the chunk's
//      rows in S.
//
// Neither bytes nor operations bound it: a block's steps run one after
// another behind barriers, and two blocks an SM hide little of the wait
// for a block's loads.  The step clocks put most of a block's time in
// the load of w, the pairs inside the diagonal halves and the barriers.
//
// At the serve shape (S 256, rows 64) that is 4 chunks a (b, h), 512
// blocks in clusters of 4, two blocks an SM (83,456 bytes of shared
// memory a block).  Building with -DWKV6_STEP_CLOCKS adds per-step clock
// counters (below); PERF.md has what they read on the card.

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 64;      // most rows of a block at K = 32 and 64
constexpr int kTcRowsWide = 16;  // most rows of a block at K = 128
constexpr int kTcPad = 8;        // row padding, in elements
constexpr int kSub = 16;         // rows of an mma sub-tile
constexpr int kHalf = kSub / 2;  // rows of a sub-tile's halves
constexpr int kMaxCluster = 8;   // blocks of a portable cluster
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of shared memory one block uses.  fp32: cw (later dS),
// exp2(total), u.  bf16: r (later the hi part of r exp2(e)), k (later the
// hi part of kd, then the lo part of S_in), v, the hi part of k' (later
// the lo part of kd, then the hi part of S_in), the lo part of k' (later
// of r exp2(e)), A's hi and lo parts.  The carry (fp32) only when the
// cluster walks more than one group.
__host__ __device__ constexpr long long tc_smem_bytes(int K, int rows,
                                                       bool carry) {
  return 4LL * ((rows > K ? rows : K) * (K + kTcPad) + 2LL * K) +
         2LL * ((3LL * rows + 2LL * (rows > K ? rows : K)) * (K + kTcPad) +
                2LL * rows * (rows + kTcPad)) +
         (carry ? 4LL * K * K : 0LL);
}

// (a, b) as bf16 hi parts at `hi` and the bf16 rounding of what they
// miss at `lo`: hi + lo carries about 16 bits of each value.
__device__ __forceinline__ void split_bf2(bf16* hi, bf16* lo, float a,
                                          float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  store_bf2(lo, a - f.x, b - f.y);
}

// The same split into two packed registers (mma operands).
__device__ __forceinline__ void split_u32(uint32_t& hi, uint32_t& lo, float a,
                                          float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f32_bf16(a - f.x, b - f.y);
}

// Four values the same way, each part in one 8-byte store (to another
// block's shared memory in the cluster's fold).
__device__ __forceinline__ void split_bf4(bf16* hi, bf16* lo, float4 v) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  *reinterpret_cast<uint2*>(hi) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                 *reinterpret_cast<const uint32_t*>(&h1));
  *reinterpret_cast<uint2*>(lo) =
      make_uint2(pack_f32_bf16(v.x - f0.x, v.y - f0.y),
                 pack_f32_bf16(v.z - f1.x, v.w - f1.y));
}

#ifdef WKV6_STEP_CLOCKS
// Where a block's time goes, for a profiling build only (the wrappers'
// library has none of it): thread 0 reads clock64() as each step ends
// and adds the step's cycles to a counter summed over every block (the
// last slot counts the blocks); wkv6_step_clocks reads and clears them.
constexpr int kClockSteps = 10;
__device__ unsigned long long g_step_clocks[kClockSteps + 1];
#define WKV6_CLOCK(i)                                            \
  if (tid == 0) {                                                \
    const long long now = clock64();                             \
    atomicAdd(&g_step_clocks[i],                                 \
              static_cast<unsigned long long>(now - clk));       \
    clk = now;                                                   \
  }
#else
#define WKV6_CLOCK(i)
#endif

template <int K, int ROWS>
__global__ void __launch_bounds__(kTcThreads, 2)
    wkv6_tc_kernel(const bf16* __restrict__ R, const bf16* __restrict__ Kin,
                   const bf16* __restrict__ V, const float* __restrict__ W,
                   const float* __restrict__ U, bf16* __restrict__ Y,
                   float* __restrict__ Sout, int S, int H, int rows,
                   int groups) {
  static_assert(K % 32 == 0 && ROWS % kSub == 0, "tile shapes");
  constexpr int LD = K + kTcPad;        // bf16 and fp32 rows of K channels
  constexpr int LA = ROWS + kTcPad;     // rows of A
  constexpr int KR = ROWS > K ? ROWS : K;
  constexpr int NCH = 32;               // output columns of a work item
  constexpr int NJ = NCH / 8;
  constexpr int KH = K / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cw = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]; dS [K][LD]
  float* dec = cw + KR * LD;                       // [K] exp2(total)
  float* us = dec + K;                             // [K]
  bf16* rs = reinterpret_cast<bf16*>(us + K);  // [ROWS][LD] r, hi of r 2^e
  bf16* ks = rs + ROWS * LD;                   // [KR][LD] k, hi of kd, lo S_in
  bf16* vs = ks + KR * LD;                     // [ROWS][LD] v
  bf16* kp = vs + ROWS * LD;                   // [KR][LD] hi k', lo kd, hi S_in
  bf16* rl = kp + KR * LD;                     // [ROWS][LD] lo k', lo r 2^e
  bf16* as = rl + ROWS * LD;                   // [ROWS][LA] hi of A
  bf16* al = as + ROWS * LA;                   // [ROWS][LA] lo of A
  float* carry = reinterpret_cast<float*>(al + ROWS * LA);  // [K][K]
  float* ds = cw;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int rank = blockIdx.x, csize = gridDim.x;  // the cluster: x extent
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long row = 1LL * H * K;
  const long long base = (1LL * b * S * H + h) * K;  // (b, s = 0, h, 0)
  const int nt = rows / kSub;
  cg::cluster_group cluster = cg::this_cluster();
#ifdef WKV6_STEP_CLOCKS
  long long clk = clock64();
#endif

  for (int i = tid; i < K; i += kTcThreads) us[i] = U[h * K + i];

  for (int grp = 0; grp < groups; ++grp) {
    const int t0 = (grp * csize + rank) * rows;
    const int n = max(0, min(rows, S - t0));

    // 1. loads; rows past S are zero-filled
    for (int i = tid; i < rows * (K / 4); i += kTcThreads) {
      const int t = i / (K / 4), q = (i % (K / 4)) * 4;
      const bool ok = t < n;
      cp_async16_zfill(cw + t * LD + q,
                       ok ? W + base + (t0 + t) * row + q : W, ok);
    }
    cp_async_commit();
    for (int i = tid; i < rows * (K / 8); i += kTcThreads) {
      const int t = i / (K / 8), q = (i % (K / 8)) * 8;
      const bool ok = t < n;
      const long long off = ok ? base + (t0 + t) * row + q : 0;
      cp_async16_zfill(rs + t * LD + q, R + off, ok);
      cp_async16_zfill(ks + t * LD + q, Kin + off, ok);
      cp_async16_zfill(vs + t * LD + q, V + off, ok);
    }
    cp_async_commit();
    cp_async_wait<1>();  // w has landed
    __syncthreads();
    WKV6_CLOCK(0)

    // 2. cw: inclusive sum of w log2(e) down each channel, in segments
    {
      constexpr int kSeg = kTcThreads / K;
      const int ch = tid % K, seg = tid / K;
      const int len = rows / kSeg;
      float acc = 0.f;
      for (int t = seg * len; t < (seg + 1) * len; ++t) {
        acc += cw[t * LD + ch] * kLog2e;
        cw[t * LD + ch] = acc;
      }
      __syncthreads();
      float off = 0.f;
      for (int s2 = 0; s2 < seg; ++s2)
        off += cw[((s2 + 1) * len - 1) * LD + ch];
      __syncthreads();
      if (seg > 0)
        for (int t = seg * len; t < (seg + 1) * len; ++t)
          cw[t * LD + ch] += off;
    }
    cp_async_wait<0>();  // r, k, v have landed
    __syncthreads();
    WKV6_CLOCK(1)

    // 3. exp2(total); anchored keys as hi + lo (the last sub-tile's
    //    anchor nothing); A inside each 8-row half of the diagonal
    //    sub-tiles, exponents taken directly, zeros above
    for (int i = tid; i < K; i += kTcThreads)
      dec[i] = ex2f(cw[(rows - 1) * LD + i]);
    for (int i = tid; i < (rows - kSub) * KH; i += kTcThreads) {
      const int s = i / KH, k = (i % KH) * 2;
      const int a = (s / kSub) * kSub + kSub - 1;
      const float2 ca = ld_f2(cw + a * LD + k), cs = ld_f2(cw + s * LD + k);
      const float2 kv = bf2_to_f2(ks + s * LD + k);
      split_bf2(kp + s * LD + k, rl + s * LD + k, kv.x * ex2f(ca.x - cs.x),
                kv.y * ex2f(ca.y - cs.y));
    }
    // A diagonal sub-tile's second half's rows against its first half's
    // keys through the anchor row between the halves (both operands built
    // in registers; the mma's first 8 rows are zero and unused), and the
    // zeros above them.
    auto cross_half = [&](int i0) {
      const int a = i0 + kHalf - 1;
      const int t = i0 + kHalf + g, sk = i0 + g;
      float acc[4] = {};
#pragma unroll
      for (int kc = 0; kc < K / 16; ++kc) {
        uint32_t qa[4] = {0u, 0u, 0u, 0u}, ql[4] = {0u, 0u, 0u, 0u};
        uint32_t kh[2], kl[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = kc * 16 + half * 8 + 2 * tq;
          const float2 ca = ld_f2(cw + a * LD + k);
          const float2 r2 = bf2_to_f2(rs + t * LD + k);
          const float2 ce = ld_f2(cw + (t - 1) * LD + k);
          split_u32(qa[2 * half + 1], ql[2 * half + 1],
                    r2.x * ex2f(ce.x - ca.x), r2.y * ex2f(ce.y - ca.y));
          const float2 k2 = bf2_to_f2(ks + sk * LD + k);
          const float2 cs = ld_f2(cw + sk * LD + k);
          split_u32(kh[half], kl[half], k2.x * ex2f(ca.x - cs.x),
                    k2.y * ex2f(ca.y - cs.y));
        }
        mma_bf16(acc, qa, kh[0], kh[1]);
        mma_bf16(acc, ql, kh[0], kh[1]);
        mma_bf16(acc, qa, kl[0], kl[1]);
      }
      const int col = i0 + 2 * tq;
      split_bf2(as + t * LA + col, al + t * LA + col, acc[2], acc[3]);
      // and the zeros above: rows of the first half, columns of the second
      const int zr = (i0 + g) * LA + i0 + kHalf + 2 * tq;
      store_bf2(as + zr, 0.f, 0.f);
      store_bf2(al + zr, 0.f, 0.f);
    };

    // The last warp takes the first half of the sub-tiles' cross-half
    // blocks (the rest go with step 4, which then fills the warps once);
    // the others the pairs inside the 8-row halves, one a thread, then
    // the cheaper u-bonus rows, so no thread takes two pairs while
    // another has none (a pair sums K exp2 terms in two running sums).
    if (warp == kTcWarps - 1) {
      for (int i = 0; i < nt / 2; ++i) cross_half(i * kSub);
    } else {
      constexpr int kPairs = kHalf * (kHalf - 1) / 2;  // in an 8-row half
      const int n_pairs = 2 * nt * kPairs;
      for (int it = tid; it < n_pairs + rows; it += kTcThreads - 32) {
        float a0 = 0.f, a1 = 0.f;
        int t, s;
        if (it >= n_pairs) {  // the u bonus r u k on the diagonal
          t = s = it - n_pairs;
          for (int k = 0; k < K; k += 2) {
            const float2 r2 = bf2_to_f2(rs + t * LD + k);
            const float2 k2 = bf2_to_f2(ks + t * LD + k);
            a0 = fmaf(r2.x * us[k], k2.x, a0);
            a1 = fmaf(r2.y * us[k + 1], k2.y, a1);
          }
        } else {  // a pair inside one 8-row half
          const int h0 = (it / kPairs) * kHalf;
          int tl = 1, sl = it % kPairs;
          while (sl >= tl) {
            sl -= tl;
            ++tl;
          }
          t = h0 + tl;
          s = h0 + sl;
#pragma unroll 8
          for (int k = 0; k < K; k += 2) {
            const float2 r2 = bf2_to_f2(rs + t * LD + k);
            const float2 k2 = bf2_to_f2(ks + s * LD + k);
            const float2 ce = ld_f2(cw + (t - 1) * LD + k);
            const float2 cs = ld_f2(cw + s * LD + k);
            a0 = fmaf(r2.x * k2.x, ex2f(ce.x - cs.x), a0);
            a1 = fmaf(r2.y * k2.y, ex2f(ce.y - cs.y), a1);
          }
          as[s * LA + t] = al[s * LA + t] = __float2bfloat16(0.f);
        }
        const float a = a0 + a1;
        const bf16 ah = __float2bfloat16(a);
        as[t * LA + s] = ah;
        al[t * LA + s] = __float2bfloat16(a - __bfloat162float(ah));
      }
    }
    __syncthreads();
    WKV6_CLOCK(2)

    // 4. A off the diagonal: sub-tile pairs (i, j < i), anchor a the last
    //    row of sub-tile j; q' k'^T as hi.hi + lo.hi + hi.lo (q' or k'
    //    rounded to bf16 alone costs 2^-9 of terms that cancel); and the
    //    cross-half blocks step 3 left
    const int n_pairs = nt * (nt - 1) / 2;
    for (int p = warp; p < n_pairs + nt - nt / 2; p += kTcWarps) {
      if (p >= n_pairs) {
        cross_half((nt / 2 + p - n_pairs) * kSub);
        continue;
      }
      int i = 1, j = p;
      while (j >= i) {
        j -= i;
        ++i;
      }
      const int a = j * kSub + kSub - 1;
      const int t_lo = i * kSub + g, t_hi = t_lo + 8;
      float acc[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < K / 16; ++kc) {
        uint32_t qa[4], ql[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = kc * 16 + half * 8 + 2 * tq;
          const float2 ca = ld_f2(cw + a * LD + k);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int t = hi ? t_hi : t_lo;
            const float2 r2 = bf2_to_f2(rs + t * LD + k);
            const float2 ce = ld_f2(cw + (t - 1) * LD + k);
            split_u32(qa[2 * half + hi], ql[2 * half + hi],
                      r2.x * ex2f(ce.x - ca.x), r2.y * ex2f(ce.y - ca.y));
          }
        }
        uint32_t kf[4], kl[4];
        const int off = (j * kSub + (mi >> 1) * 8 + (lane & 7)) * LD +
                        kc * 16 + (mi & 1) * 8;
        ldmatrix_x4(kf, kp + off);
        ldmatrix_x4(kl, rl + off);
        mma_bf16(acc[0], qa, kf[0], kf[1]);
        mma_bf16(acc[1], qa, kf[2], kf[3]);
        mma_bf16(acc[0], ql, kf[0], kf[1]);
        mma_bf16(acc[1], ql, kf[2], kf[3]);
        mma_bf16(acc[0], qa, kl[0], kl[1]);
        mma_bf16(acc[1], qa, kl[2], kl[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int col = j * kSub + nb * 8 + 2 * tq;
        split_bf2(as + t_lo * LA + col, al + t_lo * LA + col, acc[nb][0],
                  acc[nb][1]);
        split_bf2(as + t_hi * LA + col, al + t_hi * LA + col, acc[nb][2],
                  acc[nb][3]);
      }
    }
    __syncthreads();
    WKV6_CLOCK(3)

    // 5. r exp2(e) as hi (in place of r) + lo; kd = k exp2(total - cw) as
    //    hi (in place of k) + lo (in place of k')
    for (int i = tid; i < rows * KH; i += kTcThreads) {
      const int t = i / KH, k = (i % KH) * 2;
      const float2 e =
          t > 0 ? ld_f2(cw + (t - 1) * LD + k) : make_float2(0.f, 0.f);
      const float2 c = ld_f2(cw + t * LD + k);
      const float2 tot = ld_f2(cw + (rows - 1) * LD + k);
      const float2 r2 = bf2_to_f2(rs + t * LD + k);
      const float2 k2 = bf2_to_f2(ks + t * LD + k);
      split_bf2(rs + t * LD + k, rl + t * LD + k, r2.x * ex2f(e.x),
                r2.y * ex2f(e.y));
      split_bf2(ks + t * LD + k, kp + t * LD + k, k2.x * ex2f(tot.x - c.x),
                k2.y * ex2f(tot.y - c.y));
    }
    __syncthreads();
    WKV6_CLOCK(4)

    // 6. dS = hi^T v + lo^T v over the chunk's rows, into ds (over cw)
    for (int item = warp; item < (K / 16) * (K / NCH); item += kTcWarps) {
      const int m0 = (item % (K / 16)) * 16, n0 = (item / (K / 16)) * NCH;
      float acc[NJ][4] = {};
      for (int tc = 0; tc < nt; ++tc) {
        uint32_t ah[4], al[4];
        const int off =
            (tc * kSub + (mi >> 1) * 8 + (lane & 7)) * LD + m0 + (mi & 1) * 8;
        ldmatrix_x4_trans(ah, ks + off);
        ldmatrix_x4_trans(al, kp + off);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (tc * kSub + (mi & 1) * 8 + (lane & 7)) *
                                         LD + n0 + (j + (mi >> 1)) * 8);
          mma_bf16(acc[j], ah, vf[0], vf[1]);
          mma_bf16(acc[j + 1], ah, vf[2], vf[3]);
          mma_bf16(acc[j], al, vf[0], vf[1]);
          mma_bf16(acc[j + 1], al, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(ds + (m0 + g) * LD + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(ds + (m0 + g + 8) * LD + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }

    // 7. every dS and exp2(total) of the cluster is written: fold them in
    //    rank order, this block over its share of the state's float4s,
    //    and hand each rank the state entering its chunk (hi + lo parts,
    //    stored into that rank's shared memory)
    WKV6_CLOCK(5)
    cluster_arrive();
    cluster_wait();
    WKV6_CLOCK(6)
    {
      constexpr int N4 = K * K / 4;
      const int per = (N4 + csize - 1) / csize;
      const int end4 = min(N4, (rank + 1) * per);
      const bool last = grp == groups - 1;
      for (int e4 = rank * per + tid; e4 < end4; e4 += kTcThreads) {
        const int kr = e4 / (K / 4), off = kr * LD + (e4 % (K / 4)) * 4;
        float4 d4[kMaxCluster];
        float dk[kMaxCluster];
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < csize) {  // every load in flight before the fold
            dk[c] = cluster.map_shared_rank(dec, c)[kr];
            d4[c] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(ds, c) + off);
          }
        }
        float4 st = grp > 0
                        ? *reinterpret_cast<const float4*>(carry + e4 * 4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < csize) {
            bf16* hi = cluster.map_shared_rank(kp, c) + off;
            bf16* lo = cluster.map_shared_rank(ks, c) + off;
            split_bf4(hi, lo, st);
            st.x = fmaf(dk[c], st.x, d4[c].x);
            st.y = fmaf(dk[c], st.y, d4[c].y);
            st.z = fmaf(dk[c], st.z, d4[c].z);
            st.w = fmaf(dk[c], st.w, d4[c].w);
          }
        }
        if (!last)  // this block's share of the carry to the next group
          *reinterpret_cast<float4*>(carry + e4 * 4) = st;
        else        // its share of the final state
          *reinterpret_cast<float4*>(Sout + 1LL * bh * K * K + e4 * 4) = st;
      }
    }
    WKV6_CLOCK(7)
    cluster_arrive();  // S_in is in place in every block; dS is read
    cluster_wait();
    WKV6_CLOCK(8)

    // 8. y = A v + (r exp2(e)) S_in, 16 rows by NCH columns a work item;
    //    A as hi + lo against v (exact in bf16), the second product as
    //    hi.hi + hi.lo + lo.hi
    for (int item = warp; item < nt * (K / NCH); item += kTcWarps) {
      const int i = item % nt, n0 = (item / nt) * NCH;
      float acc[NJ][4] = {};
      for (int sc = 0; sc <= i; ++sc) {
        uint32_t ah[4], al4[4];
        const int aoff = (i * kSub + (lane & 15)) * LA + sc * kSub +
                         (lane >> 4) * 8;
        ldmatrix_x4(ah, as + aoff);
        ldmatrix_x4(al4, al + aoff);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (sc * kSub + (mi & 1) * 8 + (lane & 7)) *
                                         LD + n0 + (j + (mi >> 1)) * 8);
          mma_bf16(acc[j], ah, vf[0], vf[1]);
          mma_bf16(acc[j + 1], ah, vf[2], vf[3]);
          mma_bf16(acc[j], al4, vf[0], vf[1]);
          mma_bf16(acc[j + 1], al4, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int kc = 0; kc < K / 16; ++kc) {
        uint32_t ah[4], al[4];
        const int aoff = (i * kSub + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ah, rs + aoff);
        ldmatrix_x4(al, rl + aoff);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t sh[4], sl[4];
          const int soff = (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD + n0 +
                           (j + (mi >> 1)) * 8;
          ldmatrix_x4_trans(sh, kp + soff);
          ldmatrix_x4_trans(sl, ks + soff);
          mma_bf16(acc[j], ah, sh[0], sh[1]);
          mma_bf16(acc[j + 1], ah, sh[2], sh[3]);
          mma_bf16(acc[j], ah, sl[0], sl[1]);
          mma_bf16(acc[j + 1], ah, sl[2], sl[3]);
          mma_bf16(acc[j], al, sh[0], sh[1]);
          mma_bf16(acc[j + 1], al, sh[2], sh[3]);
        }
      }
      const int t_lo = i * kSub + g, t_hi = t_lo + 8;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + j * 8 + 2 * tq;
        if (t_lo < n)
          store_bf2(Y + base + (t0 + t_lo) * row + col, acc[j][0], acc[j][1]);
        if (t_hi < n)
          store_bf2(Y + base + (t0 + t_hi) * row + col, acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // every warp is done with this group's tiles
    WKV6_CLOCK(9)
  }
#ifdef WKV6_STEP_CLOCKS
  if (tid == 0) atomicAdd(&g_step_clocks[kClockSteps], 1ull);
#endif
}

template <int K, int ROWS>
cudaError_t launch_tc_k(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, void* state,
                        int B, int S, int H, int rows, cudaStream_t s) {
  if (rows < kSub || rows > ROWS || rows % kSub || S < 1 || B < 1 ||
      H < 1 || B * H > 65535)
    return cudaErrorInvalidValue;
  const int chunks = (S + rows - 1) / rows;
  const int csize = min(kMaxCluster, chunks);
  const int groups = (chunks + csize - 1) / csize;
  const size_t bytes = tc_smem_bytes(K, ROWS, groups > 1);
  static size_t opted_in = 48 * 1024;  // once per instantiation and size
  if (bytes > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_tc_kernel<K, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, B * H, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, wkv6_tc_kernel<K, ROWS>, static_cast<const bf16*>(r),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, rows, groups);
}

cudaError_t launch_tc(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* y, void* state,
                      int B, int S, int H, int K, int rows, cudaStream_t s) {
  switch (K) {
    case 32:
      return launch_tc_k<32, kTcRows>(r, k, v, w, u, y, state, B, S, H, rows,
                                      s);
    case 64:
      return launch_tc_k<64, kTcRows>(r, k, v, w, u, y, state, B, S, H, rows,
                                      s);
    case 128:
      return launch_tc_k<128, kTcRowsWide>(r, k, v, w, u, y, state, B, S, H,
                                           rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: contiguous [B, S, H, K] in bf16 (bf16 = 1) or fp32; w: the
// same shape in fp32; u: [H, K] fp32.  y: [B, S, H, K] in r's type;
// state: [B, H, K, K] fp32.  L: the chunk length.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y,
                           void* state, int B, int S, int H, int K, int L,
                           int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(r, k, v, w, u, y, state, B, S, H, K,
                                         L, s)
           : launch_typed<float>(r, k, v, w, u, y, state, B, S, H, K, L, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// r, k, v: contiguous [B, S, H, K] bf16, rows 16-byte aligned; w: the
// same shape in fp32; u: [H, K] fp32.  y: [B, S, H, K] bf16; state:
// [B, H, K, K] fp32.  rows: the rows of one block's chunk (a multiple of
// 16, at most 64 at K = 32 and 64, 16 at K = 128).
extern "C" int wkv6_tc_launch(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* y,
                              void* state, int B, int S, int H, int K,
                              int rows, void* stream) {
  cudaError_t err = launch_tc(r, k, v, w, u, y, state, B, S, H, K, rows,
                              static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef WKV6_STEP_CLOCKS
// out: kClockSteps + 1 counters (each step's cycles summed over blocks,
// then the blocks), read and cleared.
extern "C" int wkv6_step_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_step_clocks, sizeof(g_step_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kClockSteps + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_step_clocks, zero, sizeof(zero)));
}
#endif
