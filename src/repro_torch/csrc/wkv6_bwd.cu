// wkv6 backward (RWKV-6 linear attention, gradients) for Hopper (sm_90a).
//
// The reference has no backward kernel: jax.grad differentiates its jnp
// chunked form (src/repro/models/rwkv.py, `wkv6_chunked`), the
// function the TPU kernel src/repro/kernels/wkv6/wkv6.py (`wkv6`)
// computes.  This kernel differentiates the exact recurrence of
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
// a reverse cumulative sum per channel from the boundary term Q_E, which
// the block reads from the state saved at that boundary and the adjoint
// it carries.
//
// One block of 256 threads per (b, h), fp32 throughout (r, k, v and dy
// read in their type, bf16 or fp32; dr, dk, dv written in it; dw and
// du's per-(b, h) sums in fp32):
//   1. forward over the chunks (L rows: 64 at K = 32, 32 at K = 64, 16
//      at K = 128, core/gpu_mapping.py::WKV_BWD_ROWS), writing the state
//      at each chunk boundary into a scratch buffer [B*H, chunks+1, K, K]
//      (the forward kernel returns only the final state);
//   2. backward over the chunks, carrying dS in shared memory: within a
//      chunk, with cw the inclusive cumulative log-decay and e = cw - w,
//          S_{t-1} = diag(exp e_t) S_in + sum_{j<t} diag(exp(e_t - cw_j)) k_j^T v_j
//          dS_j    = diag(exp(tot - cw_j)) dS_out
//                    + sum_{t>j} diag(exp(e_t - cw_j)) r_t^T dy_t
//          dS_in   = diag(exp tot) dS_out + (r exp e)^T dy,
//      every pair's decay taken directly as exp(e_t - cw_j), an exponent
//      <= 0 (w <= 0, so cw falls down the chunk): no exponent taken is
//      positive and no [L, L, K] tensor is stored.
// du is summed per channel by one thread in row order, and over b by the
// wrapper: no atomics, the same bits on every run.
//
// What bounds it on an H100 SXM: at rwkv6-1.6b's training shape (B 4,
// S 4096, H 32, K 64, bf16) the call moves 0.74 GB (r, k, v, dy, dr,
// dk, dv in bf16; w and dw in fp32), 0.22 ms at 3.35 TB/s, and the five
// [K, K] products a row (the forward's state update; S dy, dS v, k dS
// and r^T dy) are 21.5 GFLOP, 0.32 ms at the 67 TFLOP/s fp32 rate.
// This first kernel is latency-bound instead: B*H = 128 blocks on 132
// SMs, each walking its chunks in order, every product on fp32 FMAs
// from shared memory, behind __syncthreads at each step.  Tensor-core
// products and chunks in parallel across a cluster, as the forward's
// tensor_core path has, are later work.
//
// Rows past the end of the sequence are read as zero (w too), which
// leaves the state and every gradient as they are: a ragged last chunk
// is masked.
//
// Plain C interface, loaded with ctypes; the entry returns
// cudaGetLastError() right after its launch.

#include "common.cuh"

namespace {

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
    // S' = diag(exp total) S + kdec^T v; each element read and written by
    // its own thread
    for (int i = tid; i < K * K; i += kThreads) {
      const int k = i / K, v = i % K;
      float acc = expf(tot[k]) * si[k * KP + v];
      for (int j = 0; j < L; ++j) acc += ks[j * KP + k] * vs[j * KP + v];
      si[k * KP + v] = acc;
    }
    __syncthreads();
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

    // r * exp(e) and k * exp(total - cw), in place
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, k = i % K;
      const float e = t > 0 ? cw[(t - 1) * KP + k] : 0.f;
      rs[t * KP + k] *= expf(e);
      ks[t * KP + k] *= expf(tot[k] - cw[t * KP + k]);
    }
    __syncthreads();

    // dv_j = kdec_j dS + sum_{t>j} A[t, j] dy_t + (r_j u k_j) dy_j
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K, v = i % K;
      float acc = dg[j] * ys[j * KP + v];
      for (int k = 0; k < K; ++k) acc += ks[j * KP + k] * ds[k * KP + v];
      for (int t = j + 1; t < L; ++t) acc += am[t * LA + j] * ys[t * KP + v];
      if (j < n) DV[base + (t0 + j) * row + v] = from_f32<T>(acc);
    }
    __syncthreads();

    // dS_in = diag(exp total) dS + (r exp e)^T dy; each element read and
    // written by its own thread
    for (int i = tid; i < K * K; i += kThreads) {
      const int k = i / K, v = i % K;
      float acc = expf(tot[k]) * ds[k * KP + v];
      for (int t = 0; t < L; ++t) acc += rs[t * KP + k] * ys[t * KP + v];
      ds[k * KP + v] = acc;
    }
    __syncthreads();
  }

  for (int k = tid; k < K; k += kThreads) DUP[1LL * bh * K + k] = du[k];
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
