// wkv6 backward (RWKV-6 linear attention, gradients) for Hopper (sm_90a).
//
// The reference has no backward kernel: jax.grad differentiates its jnp
// chunked form (src/repro/models/rwkv.py, `wkv6_chunked`), the
// function the TPU kernel src/repro/kernels/wkv6/wkv6.py (`wkv6`)
// computes.  These kernels differentiate the exact recurrence of
// csrc/wkv6.cu: per (batch, head), with a [K, K] state that starts at
// zero,
//     S_t = diag(exp w_t) S_{t-1} + k_t^T v_t
//     y_t = r_t S_{t-1} + (r_t u k_t^T) v_t.
// Given dy and the final state's gradient dS_T (absent counts as zero),
// with dS_t the adjoint of S_t (dS_{t-1} = diag(exp w_t) dS_t +
// r_t^T dy_t) and g_t = dy_t . v_t:
//     dr_t = S_{t-1} dy_t + u k_t g_t
//     dk_t = dS_t v_t     + u r_t g_t
//     dv_t = k_t dS_t     + (r_t u k_t) dy_t
//     du   = sum over b, t of r_t k_t g_t
//     dw_t = exp(w_t) <S_{t-1}, dS_t>   (per channel, over v).
// dw is never taken from S_{t-1} rebuilt by dividing S_t by exp(w_t):
// with Q_t = <S_t, dS_t> per channel, a_t = r_t (S_{t-1} dy_t) and
// b_t = k_t (dS_t v_t), Q_{t-1} = Q_t - b_t + a_t and dw_t = Q_t - b_t,
// so inside a chunk that ends at row E,
//     dw_i = Q_E + sum_{i <= t <= E} (a_t - b_t) - a_i,
// a reverse cumulative sum per channel from the boundary term Q_E.
// Within a chunk, with cw the inclusive cumulative log-decay, e = cw - w
// and total its last row,
//     S_{t-1} = diag(exp e_t) S_in + sum_{j<t} diag(exp(e_t - cw_j)) k_j^T v_j
//     dS_j    = diag(exp(total - cw_j)) dS_out
//               + sum_{t>j} diag(exp(e_t - cw_j)) r_t^T dy_t
//     dS_in   = diag(exp total) dS_out + (r exp e)^T dy,
// and the gradients of a chunk need S_in, which depends on every earlier
// chunk, and dS_out, which depends on every later one.  Every exponent
// taken is <= 0 (w <= 0, so cw falls down a chunk).
//
// What bounds it on an H100 SXM: at rwkv6-1.6b's training shape (B 4,
// S 4096, H 32, K 64, bf16) the call moves 0.74 GB (r, k, v, dy, dr,
// dk, dv in bf16; w and dw in fp32), 0.220 ms at 3.35 TB/s, and the five
// [K, K] products a row (the state update; S dy, dS v, k dS and r^T dy)
// are 21.5 GFLOP.  On `fma` they run at the 67 TFLOP/s fp32 rate, 0.3205
// ms: the operations bound it.  On `tensor_core` they run on mma.sync in
// tf32, four of them in three passes (the split below) and k dS in one,
// 55.8 GFLOP at 495 TFLOP/s, 0.113 ms: the bytes bound it.  Two paths;
// the wrapper (kernels/wkv6/ops.py, `bwd_dispatch`) picks one before the
// launch:
//
//   * `tensor_core` (bf16 r, k, v and dy, every operand on a 16-byte
//     boundary): two launches, the chunks of one (b, h) in parallel as
//     the ranks of a thread-block cluster and every product on the
//     tensor cores.  Notes below, at the kernels.
//   * `fma` (fp32, and bf16 operands off the 16-byte grid):
//     `wkv6_bwd_kernel`, one block of 256 threads per (b, h), fp32
//     throughout (r, k, v and dy read in their type, bf16 or fp32; dr,
//     dk, dv written in it; dw and du's per-(b, h) sums in fp32):
//       1. forward over the chunks (L rows: 64 at K = 32, 32 at K = 64,
//          16 at K = 128, core/gpu_mapping.py::WKV_BWD_ROWS), writing the
//          state at each chunk boundary into a scratch buffer
//          [B*H, chunks+1, K, K] (the forward kernel returns only the
//          final state);
//       2. backward over the chunks, carrying dS in shared memory, every
//          pair's decay taken directly as exp(e_t - cw_j); no [L, L, K]
//          tensor is stored.
//     du is summed per channel by one thread in row order, and over b by
//     the wrapper.  Latency bounds it: B*H = 128 blocks on 132 SMs, each
//     walking its chunks twice in order, every product a scalar fp32 FMA
//     loop from shared memory behind __syncthreads (9 a chunk on the way
//     back).  Its step clocks (below) put a block's time in the loops
//     over pairs and rows (PERF.md has the shares).
//
// No atomics in either path: the same inputs give the same bits.  Rows
// past the end of the sequence are read as zero (w too), which leaves the
// state and every gradient as they are: a ragged last chunk is masked.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after its launches.  Building with
// -DWKV6_BWD_STEP_CLOCKS adds per-step clock counters to both paths
// (`wkv6_bwd_step_clocks` reads them).

#include "wkv6_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

#ifdef WKV6_BWD_STEP_CLOCKS
// Where a block's time goes, for a profiling build only (the wrappers'
// library has none of it): thread 0 reads clock64() as each step ends
// and adds the step's cycles to a counter summed over every block; the
// last slots count the blocks.  Slots: the tensor-core gradient kernel's
// steps, the fma kernel's, the states launch's whole block, then the
// three block counts.
constexpr int kTcClockSteps = 12;
constexpr int kFmaClock = kTcClockSteps;
constexpr int kFmaClockSteps = 12;
constexpr int kStatesClock = kFmaClock + kFmaClockSteps;
constexpr int kTcBlocks = kStatesClock + 1;
constexpr int kFmaBlocks = kTcBlocks + 1;
constexpr int kStatesBlocks = kFmaBlocks + 1;
constexpr int kClockSlots = kStatesBlocks + 1;
__device__ unsigned long long g_bwd_clocks[kClockSlots];
#define BWD_CLOCK_START long long clk = clock64();
#define BWD_CLOCK(i)                                              \
  if (threadIdx.x == 0) {                                         \
    const long long now = clock64();                              \
    atomicAdd(&g_bwd_clocks[i],                                   \
              static_cast<unsigned long long>(now - clk));        \
    clk = now;                                                    \
  }
#define BWD_CLOCK_BLOCK(i) \
  if (threadIdx.x == 0) atomicAdd(&g_bwd_clocks[i], 1ull);
#else
#define BWD_CLOCK_START
#define BWD_CLOCK(i)
#define BWD_CLOCK_BLOCK(i)
#endif


constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// rows per chunk at each head dim (core/gpu_mapping.py::WKV_BWD_ROWS)
template <int K>
struct ChunkRows;
template <>
struct ChunkRows<32> {
  static constexpr int value = 64;
};
template <>
struct ChunkRows<64> {
  static constexpr int value = 32;
};
template <>
struct ChunkRows<128> {
  static constexpr int value = 16;
};

// fp32 words of shared memory one block uses (core/gpu_mapping.py::
// wkv_bwd_smem_plan mirrors the sum): r, k, v, dy, cw, a and a - b
// [L][K+1]; S_in and dS [K][K+1]; A and dy.v [L][L+1]; g and r u k per
// row; the total decay, u, Q and du per channel.
__host__ __device__ constexpr long long bwd_smem_floats(int L, int K) {
  return 7LL * L * (K + 1) + 2LL * K * (K + 1) + 2LL * L * (L + 1) + 2LL * L +
         4LL * K;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_kernel(const T* __restrict__ R, const T* __restrict__ Kin,
                    const T* __restrict__ V, const float* __restrict__ W,
                    const float* __restrict__ U, const T* __restrict__ DY,
                    const float* __restrict__ DST, T* __restrict__ DR,
                    T* __restrict__ DK, T* __restrict__ DV,
                    float* __restrict__ DW, float* __restrict__ DUP,
                    float* __restrict__ SB, int S, int H) {
  constexpr int L = ChunkRows<K>::value;
  constexpr int KP = K + 1;  // padded rows: no bank conflicts down a column
  constexpr int LA = L + 1;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;            // [L][KP] r, later r * exp(e)
  float* ks = rs + L * KP;     // [L][KP] k, later k * exp(total - cw)
  float* vs = ks + L * KP;     // [L][KP] v
  float* ys = vs + L * KP;     // [L][KP] dy
  float* cw = ys + L * KP;     // [L][KP] w, then its inclusive cumsum
  float* as = cw + L * KP;     // [L][KP] a = r (S_{t-1} dy)
  float* zs = as + L * KP;     // [L][KP] a - b, b = k (dS_t v)
  float* si = zs + L * KP;     // [K][KP] the chunk's incoming state
  float* ds = si + K * KP;     // [K][KP] the adjoint of its final state
  float* am = ds + K * KP;     // [L][LA] A[t, j] = r_t . (k_j exp(e_t - cw_j))
  float* bm = am + L * LA;     // [L][LA] dy_t . v_j
  float* gs = bm + L * LA;     // [L] dy_t . v_t
  float* dg = gs + L;          // [L] r_t u k_t
  float* tot = dg + L;         // [K] the chunk's total log-decay
  float* us = tot + K;         // [K]
  float* qs = us + K;          // [K] <S_out, dS_out> per channel
  float* du = qs + K;          // [K] this (b, h)'s du

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  BWD_CLOCK_START
  const int b = bh / H, h = bh % H;
  const long long row = 1LL * H * K;
  const long long base = (1LL * b * S * H + h) * K;  // (b, s = 0, h, 0)
  const int n_chunks = (S + L - 1) / L;
  float* sb = SB + 1LL * bh * (n_chunks + 1) * K * K;

  for (int i = tid; i < K; i += kThreads) {
    us[i] = U[h * K + i];
    du[i] = 0.f;
  }
  for (int i = tid; i < K * K; i += kThreads) si[(i / K) * KP + i % K] = 0.f;
  __syncthreads();

  // 1. forward: the state at each chunk boundary into sb
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int n = min(L, S - t0);
    for (int i = tid; i < K * K; i += kThreads)
      sb[1LL * c * K * K + i] = si[(i / K) * KP + i % K];
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      float kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < n) {
        const long long g = base + (t0 + t) * row + k;
        kv = to_f32(Kin[g]);
        vv = to_f32(V[g]);
        wv = W[g];
      }
      ks[t * KP + k] = kv;
      vs[t * KP + k] = vv;
      cw[t * KP + k] = wv;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 0)
    for (int k = tid; k < K; k += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += cw[t * KP + k];
        cw[t * KP + k] = acc;
      }
      tot[k] = acc;
    }
    __syncthreads();
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      ks[t * KP + k] *= expf(tot[k] - cw[t * KP + k]);
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 1)
    // S' = diag(exp total) S + kdec^T v; each element read and written by
    // its own thread
    for (int i = tid; i < K * K; i += kThreads) {
      const int k = i / K, v = i % K;
      float acc = expf(tot[k]) * si[k * KP + v];
      for (int j = 0; j < L; ++j) acc += ks[j * KP + k] * vs[j * KP + v];
      si[k * KP + v] = acc;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 2)
  }
  for (int i = tid; i < K * K; i += kThreads)
    sb[1LL * n_chunks * K * K + i] = si[(i / K) * KP + i % K];

  // 2. backward over the chunks, dS carried from dS_T
  for (int i = tid; i < K * K; i += kThreads)
    ds[(i / K) * KP + i % K] = DST ? DST[1LL * bh * K * K + i] : 0.f;
  __syncthreads();

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * L;
    const int n = min(L, S - t0);
    const float* s_in = sb + 1LL * c * K * K;
    const float* s_out = s_in + K * K;
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, yv = 0.f, wv = 0.f;
      if (t < n) {
        const long long g = base + (t0 + t) * row + k;
        rv = to_f32(R[g]);
        kv = to_f32(Kin[g]);
        vv = to_f32(V[g]);
        yv = to_f32(DY[g]);
        wv = W[g];
      }
      rs[t * KP + k] = rv;
      ks[t * KP + k] = kv;
      vs[t * KP + k] = vv;
      ys[t * KP + k] = yv;
      cw[t * KP + k] = wv;
    }
    for (int i = tid; i < K * K; i += kThreads)
      si[(i / K) * KP + i % K] = s_in[i];
    __syncthreads();
    BWD_CLOCK(kFmaClock + 3)

    // cumulative log-decay, the boundary term Q, and per row g and r u k
    for (int k = tid; k < K; k += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += cw[t * KP + k];
        cw[t * KP + k] = acc;
      }
      tot[k] = acc;
      float q = 0.f;
      for (int v = 0; v < K; ++v) q += s_out[k * K + v] * ds[k * KP + v];
      qs[k] = q;
    }
    for (int t = tid; t < L; t += kThreads) {
      float g = 0.f, d = 0.f;
      for (int k = 0; k < K; ++k) {
        g += ys[t * KP + k] * vs[t * KP + k];
        d += rs[t * KP + k] * us[k] * ks[t * KP + k];
      }
      gs[t] = g;
      dg[t] = d;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 4)

    // A[t, j] and dy_t . v_j for j < t
    for (int p = tid; p < L * L; p += kThreads) {
      const int t = p / L, j = p % L;
      float a = 0.f, bb = 0.f;
      if (j < t) {
        for (int k = 0; k < K; ++k) {
          a += rs[t * KP + k] * ks[j * KP + k] *
               expf(cw[(t - 1) * KP + k] - cw[j * KP + k]);
          bb += ys[t * KP + k] * vs[j * KP + k];
        }
      }
      am[t * LA + j] = a;
      bm[t * LA + j] = bb;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 5)

    // dr_t = exp(e_t) (S_in dy_t) + sum_{j<t} (dy_t.v_j) k_j exp(e_t - cw_j)
    //        + u k_t g_t
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      const float e = t > 0 ? cw[(t - 1) * KP + k] : 0.f;
      float st = 0.f;
      for (int v = 0; v < K; ++v) st += si[k * KP + v] * ys[t * KP + v];
      float acc = expf(e) * st;
      for (int j = 0; j < t; ++j)
        acc += bm[t * LA + j] * ks[j * KP + k] * expf(e - cw[j * KP + k]);
      as[t * KP + k] = rs[t * KP + k] * acc;
      if (t < n)
        DR[base + (t0 + t) * row + k] =
            from_f32<T>(acc + us[k] * ks[t * KP + k] * gs[t]);
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 6)

    // dk_j = exp(total - cw_j) (dS v_j) + sum_{t>j} (dy_t.v_j) r_t
    //        exp(e_t - cw_j) + u r_j g_j
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K, k = i % K;
      const float cj = cw[j * KP + k];
      float st = 0.f;
      for (int v = 0; v < K; ++v) st += ds[k * KP + v] * vs[j * KP + v];
      float acc = expf(tot[k] - cj) * st;
      for (int t = j + 1; t < L; ++t)
        acc += bm[t * LA + j] * rs[t * KP + k] *
               expf(cw[(t - 1) * KP + k] - cj);
      zs[j * KP + k] = as[j * KP + k] - ks[j * KP + k] * acc;
      if (j < n)
        DK[base + (t0 + j) * row + k] =
            from_f32<T>(acc + us[k] * rs[j * KP + k] * gs[j]);
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 7)

    // dw by the reverse cumulative sum from Q; du in row order
    for (int k = tid; k < K; k += kThreads) {
      float acc = qs[k], d = du[k];
      for (int t = L - 1; t >= 0; --t) {
        acc += zs[t * KP + k];
        if (t < n) DW[base + (t0 + t) * row + k] = acc - as[t * KP + k];
        d += rs[t * KP + k] * ks[t * KP + k] * gs[t];
      }
      du[k] = d;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 8)

    // r * exp(e) and k * exp(total - cw), in place
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      const float e = t > 0 ? cw[(t - 1) * KP + k] : 0.f;
      rs[t * KP + k] *= expf(e);
      ks[t * KP + k] *= expf(tot[k] - cw[t * KP + k]);
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 9)

    // dv_j = kdec_j dS + sum_{t>j} A[t, j] dy_t + (r_j u k_j) dy_j
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K, v = i % K;
      float acc = dg[j] * ys[j * KP + v];
      for (int k = 0; k < K; ++k) acc += ks[j * KP + k] * ds[k * KP + v];
      for (int t = j + 1; t < L; ++t) acc += am[t * LA + j] * ys[t * KP + v];
      if (j < n) DV[base + (t0 + j) * row + v] = from_f32<T>(acc);
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 10)

    // dS_in = diag(exp total) dS + (r exp e)^T dy; each element read and
    // written by its own thread
    for (int i = tid; i < K * K; i += kThreads) {
      const int k = i / K, v = i % K;
      float acc = expf(tot[k]) * ds[k * KP + v];
      for (int t = 0; t < L; ++t) acc += rs[t * KP + k] * ys[t * KP + v];
      ds[k * KP + v] = acc;
    }
    __syncthreads();
    BWD_CLOCK(kFmaClock + 11)
  }

  for (int k = tid; k < K; k += kThreads) DUP[1LL * bh * K + k] = du[k];
  BWD_CLOCK_BLOCK(kFmaBlocks)
}

template <typename T, int K>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* dy,
                     const void* dstate, void* dr, void* dk, void* dv,
                     void* dw, void* du, void* scratch, int B, int S, int H,
                     int rows, cudaStream_t s) {
  constexpr int L = ChunkRows<K>::value;
  const long long bytes = bwd_smem_floats(L, K) * 4;
  if (rows != L || bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<T, K><<<B * H, kThreads, bytes, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dy),
      static_cast<const float*>(dstate), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du), static_cast<float*>(scratch), S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* dy,
                         const void* dstate, void* dr, void* dk, void* dv,
                         void* dw, void* du, void* scratch, int B, int S,
                         int H, int K, int rows, cudaStream_t s) {
  switch (K) {
    case 32:
      return launch_k<T, 32>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du,
                             scratch, B, S, H, rows, s);
    case 64:
      return launch_k<T, 64>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du,
                             scratch, B, S, H, rows, s);
    case 128:
      return launch_k<T, 128>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du,
                              scratch, B, S, H, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ==================== bf16: the chunks in parallel across a cluster
//
// The state and the adjoint are linear recurrences over the chunks,
//     S_in(c + 1)    = exp2(total_c) S_in(c)    + kd_c^T v_c
//     dS_out(c - 1)  = exp2(total_c) dS_out(c)  + (r exp2(e))_c^T dy_c,
// (kd = k exp2(total - cw)), so each chunk's contributions are products
// of its own rows, and only their fold runs in order.  Two launches:
//
//   `wkv6_bwd_states_kernel`: a block of 256 threads per (b, h, segment
//   of groups of chunks), no cluster.  It walks its segment's chunks,
//   keeps X = exp2(total) X +
//   kd^T v in its mma accumulators and the decay product D of each row,
//   and writes (X, D) at each group's start and at the segment's end
//   (the wrapper's scratch: [B*H, groups + segments, K, K + 1] fp32).
//
//   `wkv6_bwd_tc_kernel`: a block of 256 threads per (b, h, `rows`-row
//   chunk); the chunks of one (b, h) are the ranks of a thread-block
//   cluster of csize (1 to 8, the wrapper's choice: the fewest waves of
//   blocks times groups) that walks the groups of csize chunks from last
//   to first.  Each block first chains the segments over its share of
//   the state's rows, E_{s+1} = D_s E_s + X_s (the state entering a
//   group is then D E + X).  Per group:
//     1. loads: w (fp32) and r, k, v, dy (bf16) by cp.async, 16 bytes a
//        thread, w in its own commit group;
//     2. cw, the cumulative log2-decay (w scaled by log2(e) as it is
//        summed, kTcThreads / K row segments); every exponential is one
//        ex2.approx of a difference of these sums, never positive;
//     3. exp2(total); kd and r exp2(e); per row g = dy . v and r u k;
//     4. on the tensor cores: kd^T v and (r exp2(e))^T dy into shared
//        memory, dy v^T for every sub-tile pair (I, J <= I);
//     5. cluster barrier; the blocks fold both in place, each over its
//        share of the rows, all ranks' loads in flight at once: the state
//        forward in rank order from the group's entry (S_in of each
//        rank), the adjoint backward in reverse rank order from the carry
//        of the group after (dS_out of each rank; dS_T or zero for the
//        last group), and Q = <S_out, dS_out> per channel, a fixed
//        shuffle tree over the row's lanes.  One fixed order for every
//        element, no atomics: the same inputs give the same bits.  The
//        adjoint entering the group is kept, over the group's consumed X
//        in the scratch, for the group before;
//     6. second cluster barrier; the anchored operands: k' = k exp2(cw_a -
//        cw) (a the last row of the key's 16-row sub-tile) and
//        r~ = r exp2(e - cw_b) (b the row before the query's sub-tile);
//     7. inside each diagonal sub-tile, a thread per sub-tile and
//        channel, dr and dk in fp32 FMAs, each pair's decay
//        exp2(e_t - cw_j) a running product of the step decays
//        exp2(cw_q - cw_{q-1}) (15 exp2 a thread, not 120); A^T there
//        inside each 8-row half a thread per pair, across the halves on
//        the tensor cores through the anchor row between them (as the
//        forward does), u's bonus r u k on the diagonal; off the diagonal
//        A^T = k' q'^T, q' = r exp2(e - cw_a) built in registers;
//     8. dr = exp2(e) dy S_in^T + sum_J exp2(e - cw_a) (dy v^T)[I, J] k'_J
//        and dk = exp2(total - cw) v dS_out^T + sum_I exp2(cw_b - cw)
//        (dy v^T)[I, J]^T r~_I, plus the diagonal terms of step 7: the
//        u terms added, stored; a = r dr and a - k dk kept;
//     9. kd again; the dw scan's segment sums;
//    10. dv = kd dS_out + A^T dy; dw = Q + the reverse sum of a - k dk
//        down the chunk minus a; du's partial per (b, h, chunk), which
//        the wrapper sums over chunks and b in a fixed order.
//
// Precision: dw's terms cancel (it sums a chunk's rows of a - k dk, each
// about <S, dS>), and it is held to 1e-4 of fp32.  One bf16 rounding of
// an operand the kernel builds (2^-9), or a bf16 hi + lo pair as the
// forward's tensor-core kernel keeps (about 2^-17), reads 0.53 of that
// allowance already on the CPU model of this arithmetic
// (kernels/tolerance.py::wkv_bwd_cluster_model).  So every product that
// feeds dr, dk and the folds, with an operand the kernel builds (scaled
// by a decay, S_in, dS_out, dy v^T), runs on mma.sync m16n8k8 in tf32,
// the operand split into its tf32 part and the rest (both read by the
// tensor cores as tf32, cut toward zero), the product taken as big.big +
// small.big + big.small into fp32 accumulators (about 2^-20).  dv, and
// A, which only dv reads, are held to bf16's allowance: their products
// take one tf32 pass.  r, k, v and dy are exact in tf32 and in bf16; dy
// v^T from them is exact products summed in fp32 on mma.sync m16n8k16.
//
// What the step clocks read on the card (WKV6_BWD_STEP_CLOCKS; PERF.md,
// PR 24): at the training shape, 32 rows a chunk, cluster 2, 64 groups,
// 256 blocks (two an SM, 112,640 bytes of shared memory a block) each
// walking 64 chunks, about 34k cycles a chunk, spread over the steps
// (none above 17 %): the steps are latency-bound, each behind a
// barrier with 16 warps an SM.  Making them overlap (a chunk's loads and
// fold under another's products) is the next step toward the bound.

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;   // threads of a block, both launches
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcPad = 8;         // row padding, in elements
constexpr int kSub = 16;          // rows of a sub-tile
constexpr int kMaxCluster = 8;    // blocks of a portable cluster
constexpr float kLog2e = 1.4426950408889634f;

// rows per block at each head dim (core/gpu_mapping.py::WKV_BWD_TC_ROWS)
template <int K>
struct TcRows;
template <>
struct TcRows<32> {
  static constexpr int value = 32;
};
template <>
struct TcRows<64> {
  static constexpr int value = 32;
};
template <>
struct TcRows<128> {
  static constexpr int value = 16;
};

// The gradient kernel's shared memory, in floats: fp32 [L][F] arrays
// (F = K + pad) cw; two for the diagonal sub-tiles' dr and dk (later
// a = r dr and a - k dk); two derived operands (kd and r exp2(e), then
// k' and r~, then kd); the state and adjoint [K][F] (the contributions,
// then S_in and dS_out); [L][FL] dy v^T and A^T (FL = L + pad); per
// channel exp2(total), u and Q; per row g and r u k.  Then bf16 r, k, v
// and dy [L][F].  (core/gpu_mapping.py::wkv_bwd_smem_plan sums the same.)
template <int K, int L>
struct TcLayout {
  static constexpr int F = K + kTcPad;
  static constexpr int FL = L + kTcPad;
  static constexpr int kCw = 0;
  static constexpr int kC0 = kCw + L * F;
  static constexpr int kC1 = kC0 + L * F;
  static constexpr int kX1 = kC1 + L * F;
  static constexpr int kX2 = kX1 + L * F;
  static constexpr int kSs = kX2 + L * F;
  static constexpr int kSd = kSs + K * F;
  static constexpr int kBm = kSd + K * F;
  static constexpr int kAt = kBm + L * FL;
  static constexpr int kDec = kAt + L * FL;
  static constexpr int kU = kDec + K;
  static constexpr int kQ = kU + K;
  static constexpr int kG = kQ + K;
  static constexpr int kRk = kG + L;
  static constexpr int kF32 = kRk + L;
  static constexpr long long kBytes = 4LL * kF32 + 2LL * 4 * L * F;
  // blocks an SM by shared memory (228 KB, 1 KB kept per block)
  static constexpr int kBlocksPerSm = kBytes + 1024 <= 233472 / 2 ? 2 : 1;
};

// The states kernel's: fp32 cw and kd [L][F] and exp2(total) [K]; bf16
// k and v [L][F].
template <int K, int L>
struct StLayout {
  static constexpr int F = K + kTcPad;
  static constexpr int kCw = 0;
  static constexpr int kKd = L * F;
  static constexpr int kDec = kKd + L * F;
  static constexpr int kF32 = kDec + K;
  static constexpr long long kBytes = 4LL * kF32 + 2LL * 2 * L * F;
};

// The states launch's scratch, in floats from its start: the state
// entering each group relative to its segment's start, xl [B*H][groups]
// [K][K] (later the adjoint carries); each segment's own, xs [B*H][nseg]
// [K][K] (later the state entering the segment); the decay products to
// match, dl [B*H][groups][K] and ds [B*H][nseg][K].
struct StScratch {
  float *xl, *xs, *dl, *ds;
  __host__ __device__ StScratch(float* p, int bh, int groups, int nseg,
                                int K)
      : xl(p),
        xs(p + 1LL * bh * groups * K * K),
        dl(p + 1LL * bh * (groups + nseg) * K * K),
        ds(p + 1LL * bh * (groups + nseg) * K * K + 1LL * bh * groups * K) {}
};

__device__ __forceinline__ float4 fma4(float d, float4 a, float4 b) {
  return make_float4(fmaf(d, a.x, b.x), fmaf(d, a.y, b.y), fmaf(d, a.z, b.z),
                     fmaf(d, a.w, b.w));
}

__device__ __forceinline__ float bf_at(const bf16* p) {
  return __bfloat162float(*p);
}

// x rounded to tf32 (to nearest, ties away), its low 13 bits clear
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x as its tf32 part (big: its low 13 bits cleared, cut toward zero) and
// the rest (small), which the tensor cores read as tf32 by its top 19
// bits: two instructions, and big + small carries about 20 bits of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A (16 x 8 ks) B (8 ks x 8 NJ) over the k steps [ks0, ks1), a
// warp's product on the tensor cores in tf32.  fa(r, c) gives
// {A[r][c], A[r][c + 1]}, fb(n, c) gives {B[c][n], B[c + 1][n]} (c even:
// thread tq takes a step's columns 2 tq and 2 tq + 1 as the mma's k and
// k + 4, for A and B alike, which leaves the sum as it is).  An operand
// not exact in tf32 (AX, BX false) enters as big + small, the product as
// big.big + small.big + big.small; with ONE, as its tf32 rounding alone,
// one product (where a result is held to bf16's allowance).
template <int NJ, bool AX, bool BX, bool ONE = false, typename FA,
          typename FB>
__device__ __forceinline__ void mma3(float (&acc)[NJ][4], int ks0, int ks1,
                                     FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) {
    const int c = ks * 8 + 2 * tq;
    const float2 a0 = fa(g, c), a1 = fa(g + 8, c);
    uint32_t ab[4], as[4], bb[NJ][2], bs[NJ][2];
    if constexpr (AX) {
      ab[0] = __float_as_uint(a0.x);
      ab[1] = __float_as_uint(a1.x);
      ab[2] = __float_as_uint(a0.y);
      ab[3] = __float_as_uint(a1.y);
    } else if constexpr (ONE) {
      ab[0] = tf32_bits(a0.x);
      ab[1] = tf32_bits(a1.x);
      ab[2] = tf32_bits(a0.y);
      ab[3] = tf32_bits(a1.y);
    } else {
      split_tf32(a0.x, ab[0], as[0]);
      split_tf32(a1.x, ab[1], as[1]);
      split_tf32(a0.y, ab[2], as[2]);
      split_tf32(a1.y, ab[3], as[3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 bv = fb(j * 8 + g, c);
      if constexpr (BX) {
        bb[j][0] = __float_as_uint(bv.x);
        bb[j][1] = __float_as_uint(bv.y);
      } else if constexpr (ONE) {
        bb[j][0] = tf32_bits(bv.x);
        bb[j][1] = tf32_bits(bv.y);
      } else {
        split_tf32(bv.x, bb[j][0], bs[j][0]);
        split_tf32(bv.y, bb[j][1], bs[j][1]);
      }
    }
    // consecutive products into different accumulators
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ab, bb[j][0], bb[j][1]);
    if constexpr (!BX && !ONE) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ab, bs[j][0], bs[j][1]);
    }
    if constexpr (!AX && !ONE) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], as, bb[j][0], bb[j][1]);
    }
  }
}

// Store a warp's [16][8 NJ] accumulators at out[(r0 + row) * pitch +
// n0 + col] (fp32, row pairs).
template <int NJ>
__device__ __forceinline__ void store_acc(float* out, int pitch, int r0,
                                          int n0, const float (&acc)[NJ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + j * 8 + 2 * tq;
    *reinterpret_cast<float2*>(out + (r0 + g) * pitch + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (r0 + g + 8) * pitch + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Load one chunk: w (fp32) into cw [L][F] in its own commit group, then
// the bf16 operands of `srcs` into `dsts` [L][F]; rows past n zero-filled.
template <int K, int L, int N>
__device__ __forceinline__ void load_chunk(float* cw, const float* W,
                                           bf16* const (&dsts)[N],
                                           const bf16* const (&srcs)[N],
                                           long long base, long long row,
                                           int t0, int n) {
  constexpr int F = K + kTcPad;
  for (int i = threadIdx.x; i < L * (K / 4); i += kTcThreads) {
    const int t = i / (K / 4), q = (i % (K / 4)) * 4;
    const bool ok = t < n;
    cp_async16_zfill(cw + t * F + q, ok ? W + base + (t0 + t) * row + q : W,
                     ok);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < L * (K / 8); i += kTcThreads) {
    const int t = i / (K / 8), q = (i % (K / 8)) * 8;
    const bool ok = t < n;
    const long long off = ok ? base + (t0 + t) * row + q : 0;
#pragma unroll
    for (int s = 0; s < N; ++s)
      cp_async16_zfill(dsts[s] + t * F + q, srcs[s] + off, ok);
  }
  cp_async_commit();
}

// cw: inclusive sum of w log2(e) down each channel, in kTcThreads / K
// row segments, each offset by the sums of the ones before it.
template <int K, int L>
__device__ __forceinline__ void scan_log2(float* cw) {
  constexpr int F = K + kTcPad;
  constexpr int kSeg = kTcThreads / K;
  constexpr int len = L / kSeg;
  static_assert(L % kSeg == 0, "rows must split into the scan's segments");
  const int ch = threadIdx.x % K, seg = threadIdx.x / K;
  float acc = 0.f;
  for (int t = seg * len; t < (seg + 1) * len; ++t) {
    acc += cw[t * F + ch] * kLog2e;
    cw[t * F + ch] = acc;
  }
  __syncthreads();
  float off = 0.f;
  for (int s2 = 0; s2 < seg; ++s2) off += cw[((s2 + 1) * len - 1) * F + ch];
  __syncthreads();
  if (seg > 0)
    for (int t = seg * len; t < (seg + 1) * len; ++t) cw[t * F + ch] += off;
}

// kd = k exp2(total - cw) into kd [L][F] (fp32), and exp2(total) into
// dec (when given).
template <int K, int L>
__device__ __forceinline__ void build_kd(float* kd, float* dec,
                                         const float* cw, const bf16* ks) {
  constexpr int F = K + kTcPad;
  if (dec)
    for (int i = threadIdx.x; i < K; i += kTcThreads)
      dec[i] = ex2f(cw[(L - 1) * F + i]);
  for (int i = threadIdx.x; i < L * (K / 2); i += kTcThreads) {
    const int t = i / (K / 2), k = (i % (K / 2)) * 2;
    const float2 c = ld_f2(cw + t * F + k), tot = ld_f2(cw + (L - 1) * F + k);
    const float2 k2 = bf2_to_f2(ks + t * F + k);
    *reinterpret_cast<float2*>(kd + t * F + k) = make_float2(
        k2.x * ex2f(tot.x - c.x), k2.y * ex2f(tot.y - c.y));
  }
}

// One warp's item of out[k][v] = sum over the chunk's rows of
// x[t][k] y[t][v] (x fp32 [L][F], built; y bf16 [L][F], exact): a
// 16 x 8 NJ output tile.
template <int K, int L, int NJ>
__device__ __forceinline__ void contrib_item(float* out, const float* x,
                                             const bf16* y, int item) {
  constexpr int F = K + kTcPad;
  const int m0 = (item % (K / 16)) * 16, n0 = (item / (K / 16)) * (8 * NJ);
  float acc[NJ][4] = {};
  mma3<NJ, false, true>(
      acc, 0, L / 8,
      [&](int r, int c) {
        return make_float2(x[c * F + m0 + r], x[(c + 1) * F + m0 + r]);
      },
      [&](int n, int c) {
        return make_float2(bf_at(y + c * F + n0 + n),
                           bf_at(y + (c + 1) * F + n0 + n));
      });
  store_acc<NJ>(out, F, m0, n0, acc);
}

template <int K, int NJ>
__host__ __device__ constexpr int contrib_items() {
  return (K / 16) * (K / (8 * NJ));
}

// One warp's dy v^T for the sub-tile pair p = I (I + 1) / 2 + J (J <= I),
// exact bf16 operands on mma.sync m16n8k16, into bm [L][FL] fp32.
template <int K, int L>
__device__ __forceinline__ void bm_item(float* bm, const bf16* ys,
                                        const bf16* vs, int p) {
  constexpr int F = K + kTcPad, FL = L + kTcPad;
  int I = 0, J = p;
  while (J > I) {
    J -= I + 1;
    ++I;
  }
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  float acc[2][4] = {};
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, ys + (I * kSub + (lane & 15)) * F + kc * 16 +
                        (lane >> 4) * 8);
    ldmatrix_x4(bf, vs + (J * kSub + (mi >> 1) * 8 + (lane & 7)) * F +
                        kc * 16 + (mi & 1) * 8);
    mma_bf16(acc[0], af, bf[0], bf[1]);
    mma_bf16(acc[1], af, bf[2], bf[3]);
  }
  store_acc<2>(bm, FL, I * kSub, J * kSub, acc);
}

// The fold's share of a block: rows [r0, r1) of the [K, K] state, as
// float4 items (K / 4 a row).
struct FoldShare {
  int r0, items;
  __device__ FoldShare(int rank, int csize, int K) {
    const int rpb = (K + csize - 1) / csize;
    r0 = rank * rpb;
    items = max(0, min(K, r0 + rpb) - r0) * (K / 4);
  }
};

// The fold's inputs for item `it` of this block's share: the state
// entering group grp, D_l E + X_l from the states launch (X_l and D_l
// relative to its segment's start, E the state entering the segment),
// and the adjoint leaving the group (the carry of the group after, kept
// over that group's X_l; dS_T or zero for the last group).  Zeros past
// the share.
template <int K>
__device__ __forceinline__ void fold_inputs(float4& st, float4& ad, int it,
                                            const FoldShare& share,
                                            const float* xl, const float* xs,
                                            const float* dl, int gps,
                                            const float* DST, int bh,
                                            int grp, int groups) {
  if (it >= share.items) return;
  const int kr = share.r0 + it / (K / 4), q4 = (it % (K / 4)) * 4;
  const float4 e = *reinterpret_cast<const float4*>(
      xs + (1LL * (grp / gps) * K + kr) * K + q4);
  st = fma4(dl[grp * K + kr], e,
            *reinterpret_cast<const float4*>(xl + (1LL * grp * K + kr) * K +
                                             q4));
  if (grp + 1 < groups)
    ad = *reinterpret_cast<const float4*>(
        xl + (1LL * (grp + 1) * K + kr) * K + q4);
  else if (DST)
    ad = *reinterpret_cast<const float4*>(DST + (1LL * bh * K + kr) * K +
                                          q4);
}

template <int K, int L>
__global__ void __launch_bounds__(kTcThreads, K >= 128 ? 2 : 4)
    wkv6_bwd_states_kernel(const bf16* __restrict__ Kin,
                           const bf16* __restrict__ V,
                           const float* __restrict__ W,
                           float* __restrict__ scratch, int S, int H,
                           int csize, int groups, int gps, int nseg) {
  using Lay = StLayout<K, L>;
  constexpr int F = Lay::F;
  constexpr int NJ = 2;                            // 16 columns an item
  constexpr int kItems = (K / 16) * (K / 16);      // 16 x 16 output tiles
  constexpr int IT = (kItems + kTcWarps - 1) / kTcWarps;  // a warp's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* cw = sm + Lay::kCw;
  float* kd = sm + Lay::kKd;
  float* dec = sm + Lay::kDec;
  bf16* ks = reinterpret_cast<bf16*>(sm + Lay::kF32);
  bf16* vs = ks + L * F;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int seg = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long row = 1LL * H * K;
  const long long base = (1LL * b * S * H + h) * K;  // (b, s = 0, h, 0)
  const StScratch sc(scratch, gridDim.y, groups, nseg, K);
  const int g0 = seg * gps, g1 = min(groups, g0 + gps);
  BWD_CLOCK_START

  // this warp's output tiles of X = the fold of kd^T v from the segment's
  // start, in its accumulators, and the decay product D of its rows
  float acc[IT][NJ][4] = {};
  float dp[IT][2];
#pragma unroll
  for (int i = 0; i < IT; ++i) dp[i][0] = dp[i][1] = 1.f;
  auto store = [&](float* x, float* d) {
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int item = warp + i * kTcWarps;
      if (item >= kItems) break;
      const int m0 = (item % (K / 16)) * 16, n0 = (item / (K / 16)) * 16;
      store_acc<NJ>(x, K, m0, n0, acc[i]);
      if (n0 == 0 && tq == 0) {
        d[m0 + g] = dp[i][0];
        d[m0 + g + 8] = dp[i][1];
      }
    }
  };
  for (int grp = g0; grp < g1; ++grp) {
    store(sc.xl + (1LL * bh * groups + grp) * K * K,
          sc.dl + (1LL * bh * groups + grp) * K);
    for (int c = grp * csize; c < (grp + 1) * csize; ++c) {
      const int t0 = c * L;
      const int n = max(0, min(L, S - t0));
      bf16* const dsts[2] = {ks, vs};
      const bf16* const srcs[2] = {Kin, V};
      load_chunk<K, L, 2>(cw, W, dsts, srcs, base, row, t0, n);
      cp_async_wait<1>();
      __syncthreads();
      scan_log2<K, L>(cw);
      cp_async_wait<0>();
      __syncthreads();
      build_kd<K, L>(kd, dec, cw, ks);
      __syncthreads();
      // X = exp2(total) X + kd^T v: the decay on the accumulators, then
      // the chunk's product into them
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int item = warp + i * kTcWarps;
        if (item >= kItems) break;
        const int m0 = (item % (K / 16)) * 16, n0 = (item / (K / 16)) * 16;
        const float d0 = dec[m0 + g], d1 = dec[m0 + g + 8];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j][0] *= d0;
          acc[i][j][1] *= d0;
          acc[i][j][2] *= d1;
          acc[i][j][3] *= d1;
        }
        dp[i][0] *= d0;
        dp[i][1] *= d1;
        mma3<NJ, false, true>(
            acc[i], 0, L / 8,
            [&](int r, int cc) {
              return make_float2(kd[cc * F + m0 + r],
                                 kd[(cc + 1) * F + m0 + r]);
            },
            [&](int nn, int cc) {
              return make_float2(bf_at(vs + cc * F + n0 + nn),
                                 bf_at(vs + (cc + 1) * F + n0 + nn));
            });
      }
      __syncthreads();  // every warp is done with this chunk's tiles
    }
  }
  store(sc.xs + (1LL * bh * nseg + seg) * K * K,
        sc.ds + (1LL * bh * nseg + seg) * K);
  BWD_CLOCK(kStatesClock)
  BWD_CLOCK_BLOCK(kStatesBlocks)
}

template <int K, int L, int CMAX>
__global__ void __launch_bounds__(kTcThreads,
                                  TcLayout<K, L>::kBlocksPerSm)
    wkv6_bwd_tc_kernel(const bf16* __restrict__ R, const bf16* __restrict__ Kin,
                       const bf16* __restrict__ V, const float* __restrict__ W,
                       const float* __restrict__ U, const bf16* __restrict__ DY,
                       const float* __restrict__ DST, bf16* __restrict__ DR,
                       bf16* __restrict__ DK, bf16* __restrict__ DV,
                       float* __restrict__ DW, float* __restrict__ DUP,
                       float* __restrict__ scratch, int S, int H, int groups,
                       int gps, int nseg) {
  using Lay = TcLayout<K, L>;
  constexpr int F = Lay::F, FL = Lay::FL;
  constexpr int NT = L / kSub;                  // sub-tiles of a chunk
  // 8-column tiles of a warp's item in steps 8 and 10: 8 items
  constexpr int NJ = NT * K >= 256 ? 4 : 2;
  constexpr int NCH = 8 * NJ;
  constexpr int CJ = 2;                         // of a contribution item
  constexpr int kSeg = kTcThreads / K;         // the dw scan's segments
  constexpr int kLen = L / kSeg;
  constexpr int kHalf = kSub / 2;                   // rows of a half
  constexpr int kHalfPairs = kHalf * (kHalf - 1) / 2;  // pairs inside it
  static_assert(K % 32 == 0 && L % kSub == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* cw = sm + Lay::kCw;
  float* c0 = sm + Lay::kC0;  // diagonal dr, then a = r dr
  float* c1 = sm + Lay::kC1;  // diagonal dk, then a - k dk
  float* x1 = sm + Lay::kX1;  // kd; k'; kd
  float* x2 = sm + Lay::kX2;  // r exp2(e); r~; the scan's sums
  float* ss = sm + Lay::kSs;  // kd^T v, then S_in
  float* sd = sm + Lay::kSd;  // (r exp2(e))^T dy, then dS_out
  float* bm = sm + Lay::kBm;  // dy v^T [t][j]
  float* at = sm + Lay::kAt;  // A^T [j][t]
  float* dec = sm + Lay::kDec;
  float* us = sm + Lay::kU;
  float* qs = sm + Lay::kQ;
  float* gs = sm + Lay::kG;
  float* rk = sm + Lay::kRk;
  bf16* rs = reinterpret_cast<bf16*>(sm + Lay::kF32);
  bf16* ks = rs + L * F;
  bf16* vs = ks + L * F;
  bf16* ys = vs + L * F;
  float* zsum = x2;               // [kSeg][K]
  float* dsum = x2 + kTcThreads;  // [kSeg][K]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rank = blockIdx.x, csize = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long row = 1LL * H * K;
  const long long base = (1LL * b * S * H + h) * K;  // (b, s = 0, h, 0)
  const StScratch sc(scratch, gridDim.y, groups, nseg, K);
  float* xl = sc.xl + 1LL * bh * groups * K * K;
  float* xs = sc.xs + 1LL * bh * nseg * K * K;
  const float* dl = sc.dl + 1LL * bh * groups * K;
  const float* dsg = sc.ds + 1LL * bh * nseg * K;
  const FoldShare share(rank, csize, K);
  cg::cluster_group cluster = cg::this_cluster();
  BWD_CLOCK_START

  for (int i = tid; i < K; i += kTcThreads) us[i] = U[h * K + i];
  // the state entering each segment, E_0 = 0, E_{s+1} = D_s E_s + X_s,
  // in place of the segment's own X_s, over this block's share
  for (int it = tid; it < share.items; it += kTcThreads) {
    const int kr = share.r0 + it / (K / 4), q4 = (it % (K / 4)) * 4;
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sg = 0; sg < nseg; ++sg) {
      float4* x = reinterpret_cast<float4*>(xs + (1LL * sg * K + kr) * K + q4);
      const float4 own = *x;
      *x = e;
      e = fma4(dsg[sg * K + kr], e, own);
    }
  }

  for (int grp = groups - 1; grp >= 0; --grp) {
    const int chunk = grp * csize + rank;
    const int t0 = chunk * L;
    const int n = max(0, min(L, S - t0));

    // 1. loads; rows past S are zero-filled
    {
      bf16* const dsts[4] = {rs, ks, vs, ys};
      const bf16* const srcs[4] = {R, Kin, V, DY};
      load_chunk<K, L, 4>(cw, W, dsts, srcs, base, row, t0,
                                        n);
    }
    cp_async_wait<1>();  // w has landed
    __syncthreads();
    BWD_CLOCK(0)

    // 2. cw
    scan_log2<K, L>(cw);
    cp_async_wait<0>();  // r, k, v, dy have landed
    __syncthreads();
    BWD_CLOCK(1)

    // 3. exp2(total), kd and r exp2(e); per row g = dy . v and r u k,
    //    kTcThreads / L threads a row, a fixed shuffle tree
    build_kd<K, L>(x1, dec, cw, ks);
    for (int i = tid; i < L * (K / 2); i += kTcThreads) {
      const int t = i / (K / 2), k = (i % (K / 2)) * 2;
      const float2 e =
          t > 0 ? ld_f2(cw + (t - 1) * F + k) : make_float2(0.f, 0.f);
      const float2 r2 = bf2_to_f2(rs + t * F + k);
      *reinterpret_cast<float2*>(x2 + t * F + k) =
          make_float2(r2.x * ex2f(e.x), r2.y * ex2f(e.y));
    }
    {
      constexpr int TPR = kTcThreads / L;
      static_assert(TPR <= 32 && 2 * TPR <= K, "a row's threads");
      const int t = tid / TPR, sub = tid % TPR;
      float gsum = 0.f, rsum = 0.f;
      for (int c = 2 * sub; c < K; c += 2 * TPR) {
        const float2 y2 = bf2_to_f2(ys + t * F + c);
        const float2 v2 = bf2_to_f2(vs + t * F + c);
        const float2 r2 = bf2_to_f2(rs + t * F + c);
        const float2 k2 = bf2_to_f2(ks + t * F + c);
        gsum = fmaf(y2.x, v2.x, gsum);
        gsum = fmaf(y2.y, v2.y, gsum);
        rsum = fmaf(r2.x * us[c], k2.x, rsum);
        rsum = fmaf(r2.y * us[c + 1], k2.y, rsum);
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
        gsum += __shfl_xor_sync(0xffffffffu, gsum, o);
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      }
      if (sub == 0) {
        gs[t] = gsum;
        rk[t] = rsum;
      }
    }
    __syncthreads();
    BWD_CLOCK(2)

    // the fold's first round of the group's entry state and adjoint
    // carry (global memory), in flight across step 4 and the barrier
    float4 st0 = make_float4(0.f, 0.f, 0.f, 0.f), ad0 = st0;
    fold_inputs<K>(st0, ad0, tid, share, xl, xs, dl, gps, DST, bh, grp,
                   groups);

    // 4. kd^T v into ss, (r exp2(e))^T dy into sd, dy v^T into bm
    {
      constexpr int nc = contrib_items<K, CJ>();
      for (int item = warp; item < 2 * nc + NT * (NT + 1) / 2;
           item += kTcWarps) {
        if (item < nc)
          contrib_item<K, L, CJ>(ss, x1, vs, item);
        else if (item < 2 * nc)
          contrib_item<K, L, CJ>(sd, x2, ys, item - nc);
        else
          bm_item<K, L>(bm, ys, vs, item - 2 * nc);
      }
    }
    BWD_CLOCK(3)
    cluster_arrive();
    cluster_wait();
    BWD_CLOCK(4)

    // 5. both folds in place, this block over its share of the rows
    for (int base0 = 0; base0 < share.items; base0 += kTcThreads) {
      const int it = base0 + tid;
      const bool act = it < share.items;
      const int kr = share.r0 + (act ? it : 0) / (K / 4);
      const int q4 = (it % (K / 4)) * 4;
      const int off = kr * F + q4;
      float4 sv[CMAX], dv[CMAX];
      float dk[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        sv[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dk[c] = 1.f;
        if (act && c < csize) {  // every load in flight before the fold
          dk[c] = cluster.map_shared_rank(dec, c)[kr];
          sv[c] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(ss, c) + off);
          dv[c] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(sd, c) + off);
        }
      }
      float4 st = st0, ad = ad0;
      if (base0 > 0)
        fold_inputs<K>(st, ad, it, share, xl, xs, dl, gps, DST, bh, grp,
                       groups);
      // the adjoint from the last rank down: dS_out of each rank
#pragma unroll
      for (int c = CMAX - 1; c >= 0; --c) {
        if (c < csize) {
          const float4 add = dv[c];
          dv[c] = ad;
          ad = fma4(dk[c], ad, add);
        }
      }
      // the state from the first rank up: S_in of each, and Q
      float qp[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        qp[c] = 0.f;
        if (c < csize) {
          const float4 add = sv[c];
          sv[c] = st;
          st = fma4(dk[c], st, add);
          qp[c] = st.x * dv[c].x + st.y * dv[c].y + st.z * dv[c].z +
                  st.w * dv[c].w;
        }
      }
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (act && c < csize) {
          *reinterpret_cast<float4*>(cluster.map_shared_rank(ss, c) + off) =
              sv[c];
          *reinterpret_cast<float4*>(cluster.map_shared_rank(sd, c) + off) =
              dv[c];
        }
#pragma unroll
        for (int o = 1; o < K / 4; o <<= 1)
          qp[c] += __shfl_xor_sync(0xffffffffu, qp[c], o);
        if (act && c < csize && q4 == 0)
          cluster.map_shared_rank(qs, c)[kr] = qp[c];
      }
      // the adjoint entering this group, over its consumed entry state,
      // for the group before
      if (act && grp > 0)
        *reinterpret_cast<float4*>(xl + (1LL * grp * K + kr) * K + q4) =
            ad;
    }
    BWD_CLOCK(5)
    cluster_arrive();  // S_in, dS_out and Q are in place in every block
    cluster_wait();
    BWD_CLOCK(6)

    // 6. k' (the rows of every sub-tile but the last) into x1, r~ (of
    //    every sub-tile but the first) into x2
    for (int i = tid; i < L * (K / 2); i += kTcThreads) {
      const int t = i / (K / 2), k = (i % (K / 2)) * 2, sub = t / kSub;
      const float2 c = ld_f2(cw + t * F + k);
      if (sub < NT - 1) {
        const float2 ca = ld_f2(cw + (sub * kSub + kSub - 1) * F + k);
        const float2 k2 = bf2_to_f2(ks + t * F + k);
        *reinterpret_cast<float2*>(x1 + t * F + k) = make_float2(
            k2.x * ex2f(ca.x - c.x), k2.y * ex2f(ca.y - c.y));
      }
      if (sub > 0) {
        const float2 cb = ld_f2(cw + (sub * kSub - 1) * F + k);
        const float2 e = ld_f2(cw + (t - 1) * F + k);
        const float2 r2 = bf2_to_f2(rs + t * F + k);
        *reinterpret_cast<float2*>(x2 + t * F + k) = make_float2(
            r2.x * ex2f(e.x - cb.x), r2.y * ex2f(e.y - cb.y));
      }
    }
    __syncthreads();
    BWD_CLOCK(7)

    // 7. inside the diagonal sub-tiles: dr and dk, a thread per sub-tile
    //    and channel, each pair's exp2 used for both
    for (int it = tid; it < NT * K; it += kTcThreads) {
      const int d0 = (it / K) * kSub, ch = it % K;
      // the step decays st[q] = exp2(cw_q - cw_{q-1}) <= 1; a pair's
      // decay exp2(e_t - cw_j) is the product of those of rows j+1..t-1,
      // taken from j = t - 1 (1) down
      float dka[kSub], st[kSub], kj[kSub];
      float prev = cw[d0 * F + ch];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        dka[q] = 0.f;
        kj[q] = bf_at(ks + (d0 + q) * F + ch);
        if (q > 0) {
          const float c = cw[(d0 + q) * F + ch];
          st[q] = ex2f(c - prev);
          prev = c;
        }
      }
      c0[d0 * F + ch] = 0.f;
#pragma unroll
      for (int tl = 1; tl < kSub; ++tl) {
        const int t = d0 + tl;
        const float rv = bf_at(rs + t * F + ch);
        float dra = 0.f, p = 1.f;
#pragma unroll
        for (int jl = tl - 1; jl >= 0; --jl) {
          const float bp = bm[t * FL + d0 + jl] * p;
          dra = fmaf(bp, kj[jl], dra);
          dka[jl] = fmaf(bp, rv, dka[jl]);
          p *= st[jl];
        }
        c0[t * F + ch] = dra;
      }
#pragma unroll
      for (int jl = 0; jl < kSub; ++jl) c1[(d0 + jl) * F + ch] = dka[jl];
    }
    //    A^T there: inside each 8-row half a thread per pair (after the
    //    items above, thread by thread); u's bonus on the diagonal and
    //    zeros below it in A^T; the block across the halves below
    for (int it = (tid + kTcThreads - (NT * K) % kTcThreads) %
                  kTcThreads;
         it < NT * 2 * kHalfPairs; it += kTcThreads) {
      const int h0 = (it / kHalfPairs) * kHalf;
      int tl = 1, jl = it % kHalfPairs;
      while (jl >= tl) {
        jl -= tl;
        ++tl;
      }
      const int t = h0 + tl, j = h0 + jl;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; k += 2) {
        const float2 r2 = bf2_to_f2(rs + t * F + k);
        const float2 k2 = bf2_to_f2(ks + j * F + k);
        const float2 e = ld_f2(cw + (t - 1) * F + k);
        const float2 cj = ld_f2(cw + j * F + k);
        a0 = fmaf(r2.x * k2.x, ex2f(e.x - cj.x), a0);
        a1 = fmaf(r2.y * k2.y, ex2f(e.y - cj.y), a1);
      }
      at[j * FL + t] = a0 + a1;
    }
    for (int it = tid; it < NT * kSub * kSub; it += kTcThreads) {
      const int d0 = (it / (kSub * kSub)) * kSub;
      const int rl = (it / kSub) % kSub, cl = it % kSub;
      if (cl <= rl) at[(d0 + rl) * FL + d0 + cl] = cl == rl ? rk[d0 + rl] : 0.f;
    }
    //    A^T off the diagonal: k'_J q'^T, q' = r exp2(e - cw_a) built as
    //    the B operand, a warp per sub-tile pair (I, J < I); and in each
    //    diagonal sub-tile the block across its halves the same way,
    //    through the anchor row a between them (k' and q' both built, the
    //    mma's rows 8-15 zero and unused)
    for (int p = warp; p < NT * (NT - 1) / 2 + NT; p += kTcWarps) {
      if (p >= NT * (NT - 1) / 2) {
        const int d0 = (p - NT * (NT - 1) / 2) * kSub, a = d0 + kHalf - 1;
        float acc[1][4] = {};
        mma3<1, false, false, true>(
            acc, 0, K / 8,
            [&](int r, int c) {
              if (r >= kHalf) return make_float2(0.f, 0.f);
              const float2 k2 = bf2_to_f2(ks + (d0 + r) * F + c);
              const float2 ca = ld_f2(cw + a * F + c);
              const float2 cj = ld_f2(cw + (d0 + r) * F + c);
              return make_float2(k2.x * ex2f(ca.x - cj.x),
                                 k2.y * ex2f(ca.y - cj.y));
            },
            [&](int nn, int c) {
              const int t = d0 + kHalf + nn;
              const float2 r2 = bf2_to_f2(rs + t * F + c);
              const float2 e = ld_f2(cw + (t - 1) * F + c);
              const float2 ca = ld_f2(cw + a * F + c);
              return make_float2(r2.x * ex2f(e.x - ca.x),
                                 r2.y * ex2f(e.y - ca.y));
            });
        *reinterpret_cast<float2*>(at + (d0 + g) * FL + d0 + kHalf +
                                   2 * tq) = make_float2(acc[0][0],
                                                         acc[0][1]);
        continue;
      }
      int I = 1, J = p;
      while (J >= I) {
        J -= I;
        ++I;
      }
      const int a = J * kSub + kSub - 1;
      float acc[2][4] = {};
      mma3<2, false, false, true>(
          acc, 0, K / 8,
          [&](int r, int c) { return ld_f2(x1 + (J * kSub + r) * F + c); },
          [&](int nn, int c) {
            const int t = I * kSub + nn;
            const float2 r2 = bf2_to_f2(rs + t * F + c);
            const float2 e = ld_f2(cw + (t - 1) * F + c);
            const float2 ca = ld_f2(cw + a * F + c);
            return make_float2(r2.x * ex2f(e.x - ca.x),
                               r2.y * ex2f(e.y - ca.y));
          });
      store_acc<2>(at, FL, J * kSub, I * kSub, acc);
    }
    __syncthreads();
    BWD_CLOCK(8)

    // 8. dr and dk, a warp per (sub-tile I, NCH channels)
    for (int item = warp; item < NT * (K / NCH); item += kTcWarps) {
      const int I = item % NT, n0 = (item / NT) * NCH, tr = I * kSub;
      float ar[NJ][4] = {}, ak[NJ][4] = {};
      mma3<NJ, true, false>(
          ar, 0, K / 8,
          [&](int r, int c) { return bf2_to_f2(ys + (tr + r) * F + c); },
          [&](int nn, int c) { return ld_f2(ss + (n0 + nn) * F + c); });
      mma3<NJ, true, false>(
          ak, 0, K / 8,
          [&](int r, int c) { return bf2_to_f2(vs + (tr + r) * F + c); },
          [&](int nn, int c) { return ld_f2(sd + (n0 + nn) * F + c); });
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ch = n0 + j * 8 + 2 * tq;
        const float2 tot = ld_f2(cw + (L - 1) * F + ch);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = tr + g + 8 * hf;
          const float2 e =
              t > 0 ? ld_f2(cw + (t - 1) * F + ch) : make_float2(0.f, 0.f);
          const float2 c = ld_f2(cw + t * F + ch);
          ar[j][2 * hf] *= ex2f(e.x);
          ar[j][2 * hf + 1] *= ex2f(e.y);
          ak[j][2 * hf] *= ex2f(tot.x - c.x);
          ak[j][2 * hf + 1] *= ex2f(tot.y - c.y);
        }
      }
      for (int J = 0; J < I; ++J) {  // dr through J's anchor row a
        const int a = J * kSub + kSub - 1;
        float tmp[NJ][4] = {};
        mma3<NJ, false, false>(
            tmp, 0, 2,
            [&](int r, int c) {
              return ld_f2(bm + (tr + r) * FL + J * kSub + c);
            },
            [&](int nn, int c) {
              return make_float2(x1[(J * kSub + c) * F + n0 + nn],
                                 x1[(J * kSub + c + 1) * F + n0 + nn]);
            });
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int ch = n0 + j * 8 + 2 * tq;
          const float2 ca = ld_f2(cw + a * F + ch);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 e = ld_f2(cw + (tr + g + 8 * hf - 1) * F + ch);
            ar[j][2 * hf] = fmaf(ex2f(e.x - ca.x), tmp[j][2 * hf],
                                 ar[j][2 * hf]);
            ar[j][2 * hf + 1] = fmaf(ex2f(e.y - ca.y), tmp[j][2 * hf + 1],
                                     ar[j][2 * hf + 1]);
          }
        }
      }
      for (int I2 = I + 1; I2 < NT; ++I2) {  // dk through I2's anchor b
        const int bb = I2 * kSub - 1;
        float tmp[NJ][4] = {};
        mma3<NJ, false, false>(
            tmp, 0, 2,
            [&](int r, int c) {
              return make_float2(bm[(I2 * kSub + c) * FL + tr + r],
                                 bm[(I2 * kSub + c + 1) * FL + tr + r]);
            },
            [&](int nn, int c) {
              return make_float2(x2[(I2 * kSub + c) * F + n0 + nn],
                                 x2[(I2 * kSub + c + 1) * F + n0 + nn]);
            });
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int ch = n0 + j * 8 + 2 * tq;
          const float2 cb = ld_f2(cw + bb * F + ch);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 c = ld_f2(cw + (tr + g + 8 * hf) * F + ch);
            ak[j][2 * hf] = fmaf(ex2f(cb.x - c.x), tmp[j][2 * hf],
                                 ak[j][2 * hf]);
            ak[j][2 * hf + 1] = fmaf(ex2f(cb.y - c.y), tmp[j][2 * hf + 1],
                                     ak[j][2 * hf + 1]);
          }
        }
      }
      // the diagonal sub-tile's terms and the u terms; a = r dr and
      // a - k dk kept for dw
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ch = n0 + j * 8 + 2 * tq;
        const float2 u2 = ld_f2(us + ch);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = tr + g + 8 * hf;
          const float2 dd = ld_f2(c0 + t * F + ch), dq = ld_f2(c1 + t * F + ch);
          const float drx = ar[j][2 * hf] + dd.x;
          const float dry = ar[j][2 * hf + 1] + dd.y;
          const float dkx = ak[j][2 * hf] + dq.x;
          const float dky = ak[j][2 * hf + 1] + dq.y;
          const float2 r2 = bf2_to_f2(rs + t * F + ch);
          const float2 k2 = bf2_to_f2(ks + t * F + ch);
          const float ax = r2.x * drx, ay = r2.y * dry;
          *reinterpret_cast<float2*>(c0 + t * F + ch) = make_float2(ax, ay);
          *reinterpret_cast<float2*>(c1 + t * F + ch) =
              make_float2(ax - k2.x * dkx, ay - k2.y * dky);
          if (t < n) {
            const float gt = gs[t];
            const long long o = base + (t0 + t) * row + ch;
            store_bf2(DR + o, drx + u2.x * k2.x * gt, dry + u2.y * k2.y * gt);
            store_bf2(DK + o, dkx + u2.x * r2.x * gt, dky + u2.y * r2.y * gt);
          }
        }
      }
    }
    __syncthreads();
    BWD_CLOCK(9)

    // 9. kd again (into x1); the dw scan's and du's segment sums (over x2)
    build_kd<K, L>(x1, nullptr, cw, ks);
    {
      const int ch = tid % K, seg = tid / K;
      float zsm = 0.f, dsm = 0.f;
      for (int t = seg * kLen; t < (seg + 1) * kLen; ++t) {
        zsm += c1[t * F + ch];
        dsm = fmaf(bf_at(rs + t * F + ch) * bf_at(ks + t * F + ch), gs[t],
                   dsm);
      }
      zsum[seg * K + ch] = zsm;
      dsum[seg * K + ch] = dsm;
    }
    __syncthreads();
    BWD_CLOCK(10)

    // 10. dv = kd dS_out + A^T dy, a warp per (sub-tile J, NCH channels);
    //     dw by the reverse sum from Q; du's partial for this chunk
    for (int item = warp; item < NT * (K / NCH); item += kTcWarps) {
      const int J = item % NT, n0 = (item / NT) * NCH, tr = J * kSub;
      float av[NJ][4] = {};
      mma3<NJ, false, false, true>(
          av, 0, K / 8,
          [&](int r, int c) { return ld_f2(x1 + (tr + r) * F + c); },
          [&](int nn, int c) {
            return make_float2(sd[c * F + n0 + nn], sd[(c + 1) * F + n0 + nn]);
          });
      for (int I = J; I < NT; ++I)
        mma3<NJ, false, true, true>(
            av, 2 * I, 2 * I + 2,
            [&](int r, int c) { return ld_f2(at + (tr + r) * FL + c); },
            [&](int nn, int c) {
              return make_float2(bf_at(ys + c * F + n0 + nn),
                                 bf_at(ys + (c + 1) * F + n0 + nn));
            });
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ch = n0 + j * 8 + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = tr + g + 8 * hf;
          if (t < n)
            store_bf2(DV + base + (t0 + t) * row + ch, av[j][2 * hf],
                      av[j][2 * hf + 1]);
        }
      }
    }
    {
      const int ch = tid % K, seg = tid / K;
      float acc = qs[ch];
      for (int s2 = kSeg - 1; s2 > seg; --s2) acc += zsum[s2 * K + ch];
      for (int t = (seg + 1) * kLen - 1; t >= seg * kLen; --t) {
        acc += c1[t * F + ch];
        if (t < n) DW[base + (t0 + t) * row + ch] = acc - c0[t * F + ch];
      }
      if (seg == 0) {
        float d = 0.f;
        for (int s2 = 0; s2 < kSeg; ++s2) d += dsum[s2 * K + ch];
        DUP[(1LL * bh * groups * csize + chunk) * K + ch] = d;
      }
    }
    __syncthreads();  // every warp is done with this group's tiles
    BWD_CLOCK(11)
  }
  BWD_CLOCK_BLOCK(kTcBlocks)
}

template <int K, int L, int CMAX>
cudaError_t launch_tc_cmax(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* dy,
                           const void* dstate, void* dr, void* dk, void* dv,
                           void* dw, void* du, void* scratch, int B, int S,
                           int H, int csize, int nseg, cudaStream_t s) {
  const int chunks = (S + L - 1) / L;
  if (csize < 1 || csize > CMAX || csize > chunks)
    return cudaErrorInvalidValue;
  const int groups = (chunks + csize - 1) / csize;
  if (nseg < 1 || nseg > groups) return cudaErrorInvalidValue;
  const int gps = (groups + nseg - 1) / nseg;  // groups a segment
  nseg = (groups + gps - 1) / gps;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_states_kernel<K, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(StLayout<K, L>::kBytes));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wkv6_bwd_tc_kernel<K, L, CMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TcLayout<K, L>::kBytes));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const size_t st_bytes = StLayout<K, L>::kBytes;
  const dim3 st_grid(nseg, B * H, 1);
  wkv6_bwd_states_kernel<K, L><<<st_grid, kTcThreads, st_bytes, s>>>(
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(w), static_cast<float*>(scratch), S, H,
          csize, groups, gps, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, B * H, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = TcLayout<K, L>::kBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, wkv6_bwd_tc_kernel<K, L, CMAX>, static_cast<const bf16*>(r),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const bf16*>(dy), static_cast<const float*>(dstate),
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du),
      static_cast<float*>(scratch), S, H, groups, gps, nseg);
}

// The kernels compiled for clusters of at most 2 (their fold's register
// arrays a quarter as long) where the cluster is that small, else for 8.
// -DWKV6_BWD_CMAX8 compiles the one for 8 alone: chip_smoke.py's phase 3
// times that build against this one at the training shape.
template <int K, int L>
cudaError_t launch_tc_k(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dy,
                        const void* dstate, void* dr, void* dk, void* dv,
                        void* dw, void* du, void* states, int B, int S, int H,
                        int csize, int nseg, cudaStream_t s) {
#ifndef WKV6_BWD_CMAX8
  if (csize <= 2)
    return launch_tc_cmax<K, L, 2>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw,
                                   du, states, B, S, H, csize, nseg, s);
#endif
  return launch_tc_cmax<K, L, kMaxCluster>(r, k, v, w, u, dy, dstate, dr, dk,
                                           dv, dw, du, states, B, S, H, csize,
                                           nseg, s);
}

cudaError_t launch_tc(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* dy,
                      const void* dstate, void* dr, void* dk, void* dv,
                      void* dw, void* du, void* states, int B, int S, int H,
                      int K, int rows, int cluster, int nseg,
                      cudaStream_t s) {
  if (S < 1 || B < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  switch (K) {  // each head dim's rows (TcRows)
    case 32:
      if (rows != TcRows<32>::value) break;
      return launch_tc_k<32, TcRows<32>::value>(r, k, v, w, u, dy, dstate,
                                               dr, dk, dv, dw, du, states, B,
                                               S, H, cluster, nseg, s);
    case 64:
      if (rows != TcRows<64>::value) break;
      return launch_tc_k<64, TcRows<64>::value>(r, k, v, w, u, dy, dstate,
                                               dr, dk, dv, dw, du, states, B,
                                               S, H, cluster, nseg, s);
    case 128:
      if (rows != TcRows<128>::value) break;
      return launch_tc_k<128, TcRows<128>::value>(r, k, v, w, u, dy, dstate,
                                                 dr, dk, dv, dw, du, states,
                                                 B, S, H, cluster, nseg, s);
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, dy: contiguous [B, S, H, K] in one type (bf16 when bf16 != 0,
// else fp32); w: the same shape in fp32; u: [H, K] fp32; dstate: the
// final state's gradient [B, H, K, K] fp32, or null for zero.  dr, dk,
// dv: [B, S, H, K] in r's type; dw: [B, S, H, K] fp32; du: [B, H, K]
// fp32, each (b, h)'s sum over its rows (the wrapper sums over b);
// scratch: [B * H, chunks + 1, K, K] fp32, chunks = ceil(S / rows).
// rows: the chunk the wrapper reckoned (WKV_BWD_ROWS[K]); another value
// is refused.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               const void* dstate, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* scratch,
                               int B, int S, int H, int K, int rows,
                               int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(r, k, v, w, u, dy, dstate, dr, dk,
                                         dv, dw, du, scratch, B, S, H, K,
                                         rows, s)
           : launch_typed<float>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw,
                                 du, scratch, B, S, H, K, rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// r, k, v, dy: contiguous [B, S, H, K] bf16, rows 16-byte aligned; w: the
// same shape in fp32; u: [H, K] fp32; dstate: the final state's gradient
// [B, H, K, K] fp32, or null for zero.  dr, dk, dv: [B, S, H, K] bf16;
// dw: [B, S, H, K] fp32; du: [B * H, groups * cluster, K] fp32, each
// chunk's sum over its rows (the wrapper sums over chunks and b); states:
// [B * H, groups, K, K] fp32 scratch.  rows: the rows of a chunk
// (TcRows<K>); cluster: the chunks a group (1 to 8, at most the chunks;
// the wrapper's choice), groups = ceil(chunks / cluster), chunks =
// ceil(S / rows).  Two launches on the stream: the group states, then
// the gradients.
extern "C" int wkv6_bwd_tc_launch(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* dy,
                                  const void* dstate, void* dr, void* dk,
                                  void* dv, void* dw, void* du, void* states,
                                  int B, int S, int H, int K, int rows,
                                  int cluster, int segments, void* stream) {
  cudaError_t err =
      launch_tc(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du, states, B, S,
                H, K, rows, cluster, segments,
                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef WKV6_BWD_STEP_CLOCKS
// out: kClockSlots counters (each step's cycles summed over blocks: the
// tensor-core kernel's 12 steps, the fma kernel's 12, the states launch;
// then the three kernels' block counts), read and cleared.
extern "C" int wkv6_bwd_step_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_bwd_clocks, sizeof(g_bwd_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kClockSlots] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_bwd_clocks, zero, sizeof(zero)));
}
#endif
