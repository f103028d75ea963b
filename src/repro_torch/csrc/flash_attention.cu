// flash_attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_kernel`).  Same function:
// causal and/or sliding-window attention with GQA, an online softmax that
// carries (m, l, acc) in fp32, scale 1/sqrt(D) unless one is given,
// masked scores set to the finite -1e30, p rounded to v's type before the
// PV product, and the output acc / max(l, 1e-30).
//
// Design on this card:
//   * One block covers one (batch, head) pair and a tile of 64 queries;
//     it loops over 64-row K/V tiles itself.  The TPU's sequential kv
//     grid axis, whose VMEM scratch carried (m, l, acc), becomes that
//     loop with the statistics in registers.
//   * Two threads share a query row: each scores half of the tile's
//     keys, the pair reduces the row max and sum with one shuffle, and
//     each keeps half of the row's output dims in registers.
//   * GQA: head h reads KV head h / (H / KV) through strides, so q, k
//     and v are read in their [B, S, heads, D] layout without copies.
//   * Ragged q and kv edges are masked here (the TPU kernel asserted
//     that the tiles divide S).  Tiles that the causal or window mask
//     hides for every row of the block are skipped.  A row whose first
//     visited tile is fully masked keeps m = -1e30 and collects exp(0)
//     terms, which alpha = exp(-1e30 - m) = 0 clears at its first real
//     tile, as in the reference; -inf would give NaN there.
//   * Scores and the PV product use fp32 FMAs from shared memory.
//
// What bounds it on an H100 SXM: at the serve prefill shape (B 4, S 256,
// H 14, KV 2, D 64, causal) the causal pairs need ~0.47 GFLOP (0.48 us at
// the bf16 tensor-core rate) and the inputs and output ~4.2 MB (1.25 us
// at 3.35 TB/s), so bytes bound it.  This design reads each K/V tile once
// per 64-query tile and keeps scores, p and the output accumulator out of
// device memory; its fp32 FMA inner loops, not bytes, set its time.
// Tensor-core (mma/wgmma) tiles are later work.
//
// Plain C interface, loaded with ctypes; the entry returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // queries per block (two threads per query)
constexpr int kBK = 64;  // keys per kv tile
constexpr float kNegInf = -1e30f;

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

// p as the PV product sees it: rounded to v's type.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                     const T* __restrict__ V, T* __restrict__ O, int Sq,
                     int Sk, int H, int KV, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long o_sb, long long o_ss,
                     long long o_sh, int causal, int window, float scale) {
  constexpr int DP = D + 1;  // padded rows: no bank conflicts across rows
  constexpr int PP = kBK + 1;
  constexpr int HALF_D = D / 2;
  constexpr int HALF_K = kBK / 2;

  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;    // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][DP]
  float* Ps = Vs + kBK * DP;    // [kBQ][PP]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x >> 1;      // query row within the tile
  const int half = threadIdx.x & 1;    // which half of keys / dims
  const int qpos = q0 + r;

  const T* qb = Q + b * q_sb + h * q_sh;
  const T* kb = K + b * k_sb + kvh * k_sh;
  const T* vb = V + b * v_sb + kvh * v_sh;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int p = q0 + rr;
    Qs[rr * DP + d] = p < Sq ? to_f32(qb[p * q_ss + d]) : 0.f;
  }

  // kv tiles that some row of this block can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / kBK) * kBK;

  float m = kNegInf;
  float l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
      const int rr = idx / D;
      const int d = idx - rr * D;
      const int p = k0 + rr;
      const bool in = p < Sk;
      Ks[rr * DP + d] = in ? to_f32(kb[p * k_ss + d]) : 0.f;
      Vs[rr * DP + d] = in ? to_f32(vb[p * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[HALF_K];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < HALF_K; ++j) {
      const int c = half * HALF_K + j;
      const int kpos = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * DP + d], Ks[c * DP + d], dot);
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s[j] = ok ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < HALF_K; ++j) {
      const float p = expf(s[j] - m_new);
      lsum += p;
      Ps[r * PP + half * HALF_K + j] = round_to<T>(p);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l = l * alpha + lsum;
    m = m_new;
    __syncwarp();  // the row's two threads are neighbouring lanes
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = Ps[r * PP + c];
      const float* vrow = Vs + c * DP + half * HALF_D;
#pragma unroll
      for (int i = 0; i < HALF_D; ++i) acc[i] = fmaf(p, vrow[i], acc[i]);
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = O + b * o_sb + qpos * o_ss + h * o_sh + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) orow[i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV,
                     const long long* st, int causal, int window, float scale,
                     cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1)) *
      sizeof(float);
  static bool opted_in = false;  // once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, int B, int Sq, int Sk, int H, int KV, int D,
                         const long long* st, int causal, int window,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, st, causal, window,
                             scale, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, st, causal, window,
                             scale, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o in
// that order; the head dim must be contiguous.  bf16: 1 = bf16, 0 = fp32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int window, float scale, int bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D,
                                         strides, causal, window, scale, s)
           : launch_typed<float>(q, k, v, o, B, Sq, Sk, H, KV, D, strides,
                                 causal, window, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
