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
// Stability: every exponent taken is <= 0, as in the TPU kernel.  The
// TPU kernel builds exp(e_t - cw_j) as an [L, L, K] tensor in VMEM (16 MiB
// per (b, h) at L = 256, K = 64); this kernel never materialises it.
// Rows are cut into tiles of kTile.  For j in a tile that ends at row a
// and t past that tile,
//     exp(e_t - cw_j) = exp(e_t - cw_a) * exp(cw_a - cw_j),
// and both factors have exponents <= 0 (e_t = cw_{t-1} <= cw_a <= cw_j,
// since w <= 0).  The second factor is folded into k once per row ("ka"),
// the first once per (t, tile), so A over those pairs is a product of
// two [*, K] operands with one exp per kTile products.  Pairs inside the
// diagonal tile take exp(e_t - cw_j) directly.  The unbounded factoring
// by exp(-cw_j) of the reference's jnp form is not used.
//
// Design on this card:
//   * One block of 256 threads per (batch, head) loops over the chunks in
//     order with the state in shared memory: the TPU's sequential chunk
//     grid axis becomes that loop.  B * H = 128 blocks at the serve shape
//     (B 4, H 32, K 64), on 132 SMs.
//   * A chunk's r, k, v and w are read once into shared memory as fp32;
//     the per-channel cumulative sum runs in kThreads / K segments.
//   * y and the state update are register-tiled 4 x 4 per thread, v and
//     the state read as float4.
//   * The chunk length L is the wrapper's plan, halved until
//     smem_floats(L, K) fits the 227 KB a block may use
//     (core/gpu_mapping.py::wkv_smem_plan mirrors the sum): 64 at K = 64.
//     Rows past the end of the sequence are read as zero, which leaves y
//     and the state as they are, so a ragged last chunk is masked here.
//
// What bounds it on an H100 SXM: at the serve shape the call moves
// 27.3 MB (r, k, v, y in bf16; w in fp32; the final state in fp32), 8.1 us
// at 3.35 TB/s, and the recurrence's 0.54 GFLOP take 8.0 us at the 67
// TFLOP/s fp32 rate, so both bounds sit near 8 us.  This design is bound
// by neither: one block per SM with 8 warps serialises each chunk's
// load, scan, intra-chunk product and state update behind __syncthreads,
// so latency sets its time.  Tensor-core products, TMA and parallel
// chunks are later work.
//
// Plain C interface, loaded with ctypes; the entry returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;            // rows per anchor tile
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
