// flash_attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_kernel`).  Same function:
// causal and/or sliding-window attention with GQA, an online softmax that
// carries (m, l, acc) in fp32, scale 1/sqrt(D) unless one is given,
// masked scores set to the finite -1e30, p rounded to v's type before the
// PV product with l summed from the fp32 p, and the output
// acc / max(l, 1e-30).
//
// Two kernels, chosen by the wrapper from the dtype before the launch:
//
// bf16: `flash_fwd_tc_kernel`, on the tensor cores.
//   * One block of 4 warps covers one (batch, head) pair and a tile of
//     64 queries; each warp owns 16 query rows.  The block loops over
//     64-key K/V tiles itself: the TPU's sequential kv grid axis, whose
//     VMEM scratch carried (m, l, acc), becomes that loop with the
//     statistics in registers.
//   * Q.K^T and P.V are mma.sync m16n8k16 bf16 products with fp32
//     accumulators.  Q's fragments are loaded once (ldmatrix) up to
//     D = 128; at D = 256 the output accumulator alone takes 128
//     registers a thread, so each k16 fragment of Q is reloaded from
//     shared memory (where Q stays for the whole block) as the Q.K^T
//     product reaches it, which keeps the kernel under the 255-register
//     cap of 128 threads.  K and V tiles stay bf16 in shared memory, rows padded by 16 bytes so the
//     ldmatrix reads of eight rows hit eight distinct bank groups, and
//     the next tile is loaded by cp.async into a second buffer while the
//     current one is multiplied.
//   * The score fragment becomes the A operand of the PV product in
//     registers (the m16n8 accumulator layout is the m16k16 A layout),
//     rounded to bf16; l is summed from the fp32 p.
//   * log2(e) * scale is folded into the scores and exp2f replaces exp;
//     masked scores are set to -1e30 after that scaling, so they stay
//     finite.
//   * The causal grid runs its heaviest query tiles (the last ones, which
//     see the most keys) first.
//
// fp32: `flash_fwd_kernel`, fp32 FMAs from shared memory (tensor cores
// cannot meet the 1e-5 fp32 policy).  Two threads share a query row: each
// scores half of the tile's keys, the pair reduces the row max and sum
// with one shuffle, and each keeps half of the row's output dims.
//
// Head dims 32, 64, 112, 128 and 256 are compiled, one instantiation
// each.  D = 112 (zamba2-7b's shared attention blocks, 3584 / 32) is
// 7 k16 steps of Q.K^T and 14 n8 output chunks, which the PV loop takes
// in pairs; its padded row of 120 bf16 (240 bytes) is an odd number of
// 16-byte pieces, as at every other D, so the ldmatrix reads of eight
// rows still hit eight distinct bank groups.
//
// Both kernels:
//   * Given an `lse` pointer ([B, H, Sq] fp32), they also write each
//     row's log-sum-exp of its masked, scaled scores, m + log(l), for
//     the backward (csrc/flash_attention_bwd.cu); with a null pointer
//     they write nothing more, and o's bits are the same either way.
//   * The tensor-core kernel, given an `o_lo` pointer too (bf16, o's
//     layout; head dims up to kLoMaxD), runs its PV product on each p as
//     hi + lo (a second product into acc_lo; chip_smoke.py 9(a) times
//     the forward both ways) and writes o_lo = (acc + acc_lo) / l - o, so
//     that o + o_lo carries sum_k P V with fp32 P: the backward takes its
//     D_i = rowsum(dO (o + o_lo)) instead of a walk over the keys.  That
//     is `flash_fwd_tc_lo_kernel`; `flash_fwd_tc_kernel`, which serving
//     runs, is the kernel as it was.
//   * GQA: head h reads KV head h / (H / KV) through strides, so q, k
//     and v are read in their [B, S, heads, D] layout without copies.
//   * Ragged q and kv edges are masked here (the TPU kernel asserted
//     that the tiles divide S).  Tiles that the causal or window mask
//     hides for every row of the block are skipped.  A row whose first
//     visited tile is fully masked keeps m = -1e30 and collects exp(0)
//     terms, which alpha = exp(-1e30 - m) = 0 clears at its first real
//     tile, as in the reference; -inf would give NaN there.
//
// What bounds it on an H100 SXM: at the serve prefill shape (B 4, S 256,
// H 14, KV 2, D 64, causal) the causal pairs need ~0.47 GFLOP (0.48 us at
// the bf16 tensor-core rate) and the inputs and output ~4.2 MB (1.25 us
// at 3.35 TB/s), so bytes bound it.  At gemma3-12b's (B 4, S 2048,
// H 16, KV 8, D 256) the operations bound it: 137 GFLOP for a causal
// layer (0.139 ms) and 103 GFLOP for a local layer of window 1024
// (0.104 ms), against 0.060 ms for its 201 MB.  A block's 168,960 bytes
// of shared memory (Q and two K and V buffers of 64 rows of 264) leave
// one block of 4 warps an SM at D = 256.  Both designs read each K/V tile once
// per 64-query tile and keep scores, p and the output accumulator out of
// device memory.  The 224 blocks of that shape do 1 to 4 tiles each, so
// the time is a few tile latencies, which the double buffer overlaps.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after its launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // queries per block
constexpr int kBK = 64;  // keys per kv tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kLoMaxD = 128;  // tensor_core: the largest head dim with o_lo

// p as the PV product sees it: rounded to v's type.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                     const T* __restrict__ V, T* __restrict__ O,
                     float* __restrict__ lse, int Sq,
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
    if (lse != nullptr && half == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int KV,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Sq, int Sk, int H,
                         int KV, int D,
                         const long long* st, int causal, int window,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                             window, scale, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                             window, scale, s);
    case 112:
      return launch_d<T, 112>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    case 256:
      return launch_d<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

// LO: the PV product also takes the part of each p that its bf16
// rounding drops (a second product into acc_lo), and o_lo gets the fp32
// output (acc + acc_lo) / l less o; acc, and so o and lse, are the same
// bits either way.
template <int D, bool LO>
__device__ __forceinline__ void flash_fwd_tc_body(
    const bf16* __restrict__ Q, const bf16* __restrict__ K,
    const bf16* __restrict__ V, bf16* __restrict__ O, float* __restrict__ lse,
    bf16* __restrict__ o_lo, int Sq, int Sk, int H, int KV, int nqt,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale_log2) {
  constexpr int LD = D + 8;    // padded row: ldmatrix reads conflict-free
  constexpr int DK = D / 16;   // k16 steps of Q.K^T over the head dim
  constexpr int DN = D / 8;    // n8 chunks of the output
  constexpr int NK = kBK / 8;  // n8 chunks of a score tile
  constexpr bool kQInRegs = D <= 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                      // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  // heaviest query tiles first under the causal mask
  const int qt = causal ? nqt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16* qb = Q + b * q_sb + h * q_sh;
  const bf16* kb = K + b * k_sb + kvh * k_sh;
  const bf16* vb = V + b * v_sb + kvh * v_sh;

  // kv tiles that some row of this block can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / kBK) * kBK;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK
                                       : 0;

  cp_async_tile<kBK, D, LD, kThreads>(Qs, qb, q_ss, q0, Sq);
  cp_async_commit();
  if (ntiles > 0) {
    cp_async_tile<kBK, D, LD, kThreads>(Ks, kb, k_ss, kv_begin, Sk);
    cp_async_tile<kBK, D, LD, kThreads>(Vs, vb, v_ss, kv_begin, Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // Q's A fragments: kept in registers for the whole key loop up to
  // D = 128; at D = 256 they would take 64 registers beside the 128 of
  // the output accumulator, so each k16 fragment is reloaded from Qs
  // (resident for the whole block) as the Q.K^T product reaches it.
  const bf16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qa[kQInRegs ? DK : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kc = 0; kc < DK; ++kc) ldmatrix_x4(qa[kc], qrow + kc * 16);
  }

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sums
  float acc[DN][4];
  float acc_lo[LO ? DN : 1][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (LO) {
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_lo[j][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kv_begin + it * kBK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next tile loads while this one runs
      cp_async_tile<kBK, D, LD, kThreads>(Ks + (buf ^ 1) * kBK * LD, kb,
                                          k_ss, k0 + kBK, Sk);
      cp_async_tile<kBK, D, LD, kThreads>(Vs + (buf ^ 1) * kBK * LD, vb,
                                          v_ss, k0 + kBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * kBK * LD;
    const bf16* Vt = Vs + buf * kBK * LD;
    const int mi = lane >> 3;  // which of ldmatrix's four matrices

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK; ++kc) {
      uint32_t qk[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qa[kc][e];
      } else {
        ldmatrix_x4(qk, qrow + kc * 16);
      }
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + (mi >> 1) * 8 + (lane & 7)) * LD +
                            kc * 16 + (mi & 1) * 8);
        mma_bf16(s[j], qk, kf[0], kf[1]);
        mma_bf16(s[j + 1], qk, kf[2], kf[3]);
      }
    }

    // scale (log2 domain), mask, and the tile's row maxima
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? row_lo : row_hi;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the quad shares its rows
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = exp2f(m_lo - mn_lo);
    const float alpha_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_lo);
      s[j][1] = exp2f(s[j][1] - mn_lo);
      s[j][2] = exp2f(s[j][2] - mn_hi);
      s[j][3] = exp2f(s[j][3] - mn_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc[j][0] *= alpha_lo;
      acc[j][1] *= alpha_lo;
      acc[j][2] *= alpha_hi;
      acc[j][3] *= alpha_hi;
      if constexpr (LO) {
        acc_lo[j][0] *= alpha_lo;
        acc_lo[j][1] *= alpha_lo;
        acc_lo[j][2] *= alpha_hi;
        acc_lo[j][3] *= alpha_hi;
      }
    }

    // P (rounded to bf16) . V, P straight from the score registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_f32_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_f32_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_f32_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_f32_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      uint32_t pl[4];  // LO: what the rounding of pa dropped
      if constexpr (LO) {
        const float* a = s[2 * kc];
        const float* c = s[2 * kc + 1];
        pl[0] = pack_f32_bf16(bf16_rest(a[0]), bf16_rest(a[1]));
        pl[1] = pack_f32_bf16(bf16_rest(a[2]), bf16_rest(a[3]));
        pl[2] = pack_f32_bf16(bf16_rest(c[0]), bf16_rest(c[1]));
        pl[3] = pack_f32_bf16(bf16_rest(c[2]), bf16_rest(c[3]));
      }
#pragma unroll
      for (int j = 0; j < DN; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                                  (j + (mi >> 1)) * 8);
        mma_bf16(acc[j], pa, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pa, vf[2], vf[3]);
        if constexpr (LO) {
          mma_bf16(acc_lo[j], pl, vf[0], vf[1]);
          mma_bf16(acc_lo[j + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  bf16* ob = O + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    if (row_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * o_ss + j * 8) =
          __floats2bfloat162_rn(acc[j][0] / d_lo, acc[j][1] / d_lo);
    if (row_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * o_ss + j * 8) =
          __floats2bfloat162_rn(acc[j][2] / d_hi, acc[j][3] / d_hi);
  }
  if constexpr (LO) {  // o_lo in o's layout
    bf16* lb = o_lo + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_hi : row_lo;
        if (row >= Sq) continue;
        const float dn = half ? d_hi : d_lo;
        const float x0 = acc[j][2 * half] / dn;
        const float x1 = acc[j][2 * half + 1] / dn;
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<__nv_bfloat162*>(lb + row * o_ss + j * 8) =
            __floats2bfloat162_rn(
                (x0 - __low2float(o2)) + acc_lo[j][2 * half] / dn,
                (x1 - __high2float(o2)) + acc_lo[j][2 * half + 1] / dn);
      }
    }
  }
  if (lse != nullptr && t == 0) {  // m is in the log2 domain
    float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row_lo < Sq) lrow[row_lo] = (m_lo + log2f(d_lo)) * kLn2;
    if (row_hi < Sq) lrow[row_hi] = (m_hi + log2f(d_hi)) * kLn2;
  }
}

#define FLASH_FWD_TC_PARAMS                                                 \
  const bf16 *__restrict__ Q, const bf16 *__restrict__ K,                   \
      const bf16 *__restrict__ V, bf16 *__restrict__ O,                     \
      float *__restrict__ lse, bf16 *__restrict__ o_lo, int Sq, int Sk,     \
      int H, int KV, int nqt, long long q_sb, long long q_ss,               \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,       \
      long long v_sb, long long v_ss, long long v_sh, long long o_sb,       \
      long long o_ss, long long o_sh, int causal, int window,               \
      float scale_log2
#define FLASH_FWD_TC_ARGS                                                   \
  Q, K, V, O, lse, o_lo, Sq, Sk, H, KV, nqt, q_sb, q_ss, q_sh, k_sb, k_ss,  \
      k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, scale_log2

// The kernel serving runs, and (LO) its o_lo form, compiled for three
// blocks an SM at head dim 64, where its second accumulator would leave
// two.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(FLASH_FWD_TC_PARAMS) {
  flash_fwd_tc_body<D, false>(FLASH_FWD_TC_ARGS);
}
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
    flash_fwd_tc_lo_kernel(FLASH_FWD_TC_PARAMS) {
  flash_fwd_tc_body<D, true>(FLASH_FWD_TC_ARGS);
}

template <int D, bool LO>
cudaError_t launch_tc_lo(const void* q, const void* k, const void* v, void* o,
                         float* lse, void* o_lo, int B, int Sq, int Sk, int H,
                         int KV,
                      const long long* st, int causal, int window,
                      float scale, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
  auto kernel = flash_fwd_tc_kernel<D>;
  if constexpr (LO) kernel = flash_fwd_tc_lo_kernel<D>;
  static bool opted_in = false;  // once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const dim3 grid(B * H, nqt);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      static_cast<bf16*>(o_lo), Sq, Sk, H, KV, nqt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// o_lo only up to head dim kLoMaxD (at 256 the second accumulator would
// not fit beside the first); null launches the kernel serving runs.
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, void* o_lo, int B, int Sq, int Sk, int H,
                      int KV, const long long* st, int causal, int window,
                      float scale, cudaStream_t stream) {
  if (o_lo == nullptr)
    return launch_tc_lo<D, false>(q, k, v, o, lse, nullptr, B, Sq, Sk, H, KV,
                                  st, causal, window, scale, stream);
  if constexpr (D <= kLoMaxD)
    return launch_tc_lo<D, true>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV, st,
                                 causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o in
// that order; the head dim must be contiguous.  lse: null, or [B, H, Sq]
// fp32 for the rows' log-sum-exp.  bf16: 1 = bf16, 0 = fp32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq,
                                      int Sk, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int window, float scale, int bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                         D, strides, causal, window, scale,
                                         s)
           : launch_typed<float>(q, k, v, o, lse, B, Sq, Sk, H, KV, D,
                                 strides, causal, window, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tensor-core kernel: same arguments, minus the dtype flag, plus
// o_lo: null, or (head dims up to 128) bf16 in o's layout for the part of
// the fp32 output, its PV product taking each p as hi + lo, that o's
// rounding drops.  Every row of q, k and v must start on a 16-byte
// boundary (the wrapper checks the pointers and strides).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int B,
                                         int Sq, int Sk, int H, int KV, int D,
                                         const long long* strides, int causal,
                                         int window, float scale, void* o_lo,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_tc<32>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
                          strides, causal, window, scale, s);
      break;
    case 64:
      err = launch_tc<64>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
                          strides, causal, window, scale, s);
      break;
    case 112:
      err = launch_tc<112>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
                           strides, causal, window, scale, s);
      break;
    case 128:
      err = launch_tc<128>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
                           strides, causal, window, scale, s);
      break;
    case 256:
      err = launch_tc<256>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
                           strides, causal, window, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
