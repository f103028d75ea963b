// flash_attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel for
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`),
// and `jax.grad` differentiates its jnp `sdpa`.  The port's training path
// runs every prefill-form attention through the forward kernel
// (csrc/flash_attention.cu), and this is its gradient, so that no step
// on the card differentiates attention as torch ops.  Same function as
// the plain version (ops.attention_grad): dq, dk and dv of causal and/or
// sliding-window GQA attention with scale `scale`, masked scores out of
// the softmax.
//
// The recipe (FlashAttention-2's): the forward saves each row's
// log-sum-exp `lse` of its masked, scaled scores; here, tile by tile,
//   S = scale q k^T,  P = exp(S - lse) (0 where masked),  dP = dO v^T,
//   D_i = sum_k P dP,  dS = P (dP - D_i),
//   dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k,
// with S, P, dP and dS kept out of device memory.  Along a query's row dS
// sums to zero, and a row that sees few keys keeps whatever breaks that
// whole, so two choices hold it: D_i is the sum of the kernel's own fp32
// P dP, not rowsum(dO * O), which with O rounded to bf16 misses it by the
// rounding; and dS enters the dQ product as two bf16 parts, hi and the
// rounded rest.  On the CPU the recipe's dQ read 2.46 of the bf16
// allowance with rowsum(dO * O) and one bf16 dS, 0.19 this way
// (kernels/tolerance.py; tests/test_torch_flash_grad.py).
//
// Deterministic, with no atomics: two launches, in this order.
//   * dQ: one block per (batch, head, 64-query tile).  It walks the key
//     tiles its rows can see twice: first S, dP and D_i, which it writes
//     to `delta`; then S, dP, dS and dQ += dS k.
//   * dK/dV: one block per (batch, kv head, 64-key tile).  It walks the
//     G query heads of its GQA group and, for each, the query tiles that
//     can see its keys (reading lse and the dQ launch's D_i): S^T, P^T,
//     dP^T, dS^T, dV += P^T dO, dK += dS^T q.  The group's sum stays in
//     registers.
//   Recomputing S and dP in the dQ launch (twice) and the split dQ
//   product cost five products beyond the five; they buy the same bits
//   on every run, a D_i that matches P and a dQ held to its bf16
//   rounding.  Tiles the causal or window mask hides for every pair are
//   skipped; the causal grid runs its heaviest tiles first (dQ: the last
//   query tiles; dK/dV: the first key tiles).
//
// Elementwise work sits beside the products in every tile (an exp2 a
// pair in each of the three walks), so the tensor-core kernels test the
// mask per pair only on tiles it cuts (`tile_visible`): at qwen2's
// training shape that took a launch from 3.53 to 2.57 ms (chip_smoke.py
// 9a, the two versions in turns on one H100).
//
// bf16: `flash_bwd_dq_tc_kernel` and `flash_bwd_dkdv_tc_kernel`, on the
// tensor cores, the forward's design: mma.sync m16n8k16 bf16 with fp32
// accumulators, fragments by ldmatrix from rows padded by 16 bytes, the
// streamed tiles double-buffered by cp.async.  Each warp owns 16 rows of
// the block's 64; score-shaped fragments (P, dS) become the A operand of
// the next product in registers, rounded to bf16.  dK/dV at D = 256 runs
// 8 warps, two a row group, each with half of the head dim's dK and dV
// accumulators (both compute the group's S and dP): 4 warps would need
// 256 accumulator registers a thread.
//
// fp32 (and bf16 off the 16-byte grid): `flash_bwd_dq_kernel` and
// `flash_bwd_dkdv_kernel`, fp32 FMAs from shared memory (the tensor cores
// cannot meet the 1e-5 fp32 policy).  Threads share a row (2, or 4 in
// dK/dV at D = 256): each scores a share of the streamed tile's columns
// into shared memory, then keeps a share of the row's head dims.  At
// D = 256 the streamed tile is 32 rows, so that both blocks fit.
//
// Head dims 32, 64, 112, 128 and 256 are compiled, as in the forward.
// Rows past Sq or Sk are zero-filled and masked.
//
// What bounds it on an H100 SXM: at qwen2-0.5b's training shape (B 4,
// S 4096, H 14, KV 2, D 64, causal) the five products over the 8.39 M
// visible pairs a head take 300.7 GFLOP (0.304 ms at the bf16 tensor-core
// rate) against ~106 MB of inputs and outputs (q, k, v, dO and lse read,
// dq, dk and dv written: 0.032 ms): operations bound it.  This design runs ten products (S and dP three times, dQ
// twice) on mma.sync, which reaches a share of wgmma's rate.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after each of its two launches.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps, 16 own rows each
constexpr int kTile = 64;        // own rows of a block; tensor_core's
                                 // streamed tile
constexpr int kTcPad = 8;        // tensor_core row padding, in elements
constexpr int kTcSplitD = 128;   // tensor_core dK/dV: 8 warps above it
constexpr int kFmaWideD = 128;   // fma: narrow tiles above this head dim
constexpr int kFmaNarrow = 32;   // fma: the streamed tile there
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Operands of both launches.  Strides are in elements, (batch, seq,
// head) for q, k, v, do, dq, dk, dv in that order; head dims are
// contiguous.  lse and delta are [B, H, Sq] fp32.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV;
  long long st[21];
  int causal, window;
  float scale;
};

enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kDQ = 12, kDK = 15, kDV = 18 };

template <typename T>
__device__ __forceinline__ const T* head_base(const void* p,
                                              const long long* st, int b,
                                              int h) {
  return static_cast<const T*>(p) + b * st[0] + h * st[2];
}

template <typename T>
__device__ __forceinline__ T* head_base_out(void* p, const long long* st,
                                            int b, int h) {
  return static_cast<T*>(p) + b * st[0] + h * st[2];
}

__device__ __forceinline__ bool visible(const Params& p, int qpos,
                                        int kpos) {
  bool ok = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
  return ok;
}

// Whether every pair of the 64-query tile at q0 and the 64-key tile at
// k0 is visible (block-uniform): then no pair needs its mask.
__device__ __forceinline__ bool tile_visible(const Params& p, int q0,
                                             int k0) {
  return q0 + kTile <= p.Sq && k0 + kTile <= p.Sk &&
         (!p.causal || k0 + kTile - 1 <= q0) &&
         (p.window <= 0 || q0 + kTile - 1 - k0 < p.window);
}

// Key tiles (of `tile` rows) that a row of the query tile at q0 may see:
// [*begin, *end).
__device__ __forceinline__ void key_range(const Params& p, int q0, int tile,
                                          int* begin, int* end) {
  const int q_last = min(q0 + kTile, p.Sq) - 1;
  *end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int kb = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *begin = (kb / tile) * tile;
}

// Query rows that may see a key of the tile at k0: [*begin, *end).
__device__ __forceinline__ void query_range(const Params& p, int k0,
                                            int* begin, int* end) {
  const int k_last = min(k0 + kTile, p.Sk) - 1;
  *begin = p.causal ? k0 : 0;
  *end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
}

// The shared memory of each block, which flash_bwd_smem_plan in
// core/gpu_mapping.py sums the same way.
template <int D>
__host__ __device__ constexpr size_t tc_dq_smem() {
  return 6 * kTile * (D + kTcPad) * sizeof(bf16) + kTile * sizeof(float);
}
template <int D>
__host__ __device__ constexpr size_t tc_dkdv_smem() {
  return 6 * kTile * (D + kTcPad) * sizeof(bf16) + 4 * kTile * sizeof(float);
}
template <int D>
__host__ __device__ constexpr int fma_tile() {
  return D > kFmaWideD ? kFmaNarrow : kTile;
}
template <int D>
__host__ __device__ constexpr size_t fma_dq_smem() {
  return (2 * (kTile + fma_tile<D>()) * (D + 1) +
          kTile * (fma_tile<D>() + 1)) *
         sizeof(float);
}
template <int D>
__host__ __device__ constexpr size_t fma_dkdv_smem() {
  return (2 * (kTile + fma_tile<D>()) * (D + 1) +
          2 * kTile * (fma_tile<D>() + 1) + 2 * fma_tile<D>()) *
         sizeof(float);
}
template <int D>
__host__ __device__ constexpr int tc_dkdv_threads() {
  return D > kTcSplitD ? 2 * kThreads : kThreads;
}
template <int D>
__host__ __device__ constexpr int fma_dkdv_threads() {
  return (D > kFmaWideD ? 4 : 2) * kTile;
}

// ------------------------------------------------ bf16, tensor cores

// The row group's A fragment (16 rows from `rows`, k16 step kc).
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* rows,
                                       int kc) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, rows + (lane & 15) * LD + (lane >> 4) * 8 + kc * 16);
}

// B fragments of n8 chunks j and j + 1 of X^T for a product against the
// rows of X (row-major [n][k], the k16 step kc).
template <int LD>
__device__ __forceinline__ void bt_frag(uint32_t (&f)[4], const bf16* X,
                                        int j, int kc) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  ldmatrix_x4(f, X + (j * 8 + (mi >> 1) * 8 + (lane & 7)) * LD + kc * 16 +
                     (mi & 1) * 8);
}

// B fragments of n8 chunks at columns col and col + 8 of X (row-major
// [k][n], the k16 step kc).
template <int LD>
__device__ __forceinline__ void b_frag(uint32_t (&f)[4], const bf16* X,
                                       int col, int kc) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  ldmatrix_x4_trans(f, X + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                           col + (mi >> 1) * 8);
}

// The m16n8 accumulators of chunks 2kc and 2kc + 1 as one m16k16 A
// operand, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (*s)[4], int kc) {
  a[0] = pack_f32_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_f32_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_f32_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_f32_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// x - bf16(x), the part of x that one bf16 rounding drops
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

// The same operand in two bf16 parts, hi + lo, which together keep
// ~16 bits of each value.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (*s)[4], int kc) {
  acc_to_a(hi, s, kc);
  const float* a = s[2 * kc];
  const float* b = s[2 * kc + 1];
  lo[0] = pack_f32_bf16(bf16_rest(a[0]), bf16_rest(a[1]));
  lo[1] = pack_f32_bf16(bf16_rest(a[2]), bf16_rest(a[3]));
  lo[2] = pack_f32_bf16(bf16_rest(b[0]), bf16_rest(b[1]));
  lo[3] = pack_f32_bf16(bf16_rest(b[2]), bf16_rest(b[3]));
}

// S = q k^T and dP = dO v^T of the warp's 16 rows against a key tile.
template <int D, int LD>
__device__ __forceinline__ void scores_tc(float (&s)[kTile / 8][4],
                                          float (&dp)[kTile / 8][4],
                                          const bf16* qrow,
                                          const bf16* dorow, const bf16* Kt,
                                          const bf16* Vt) {
  constexpr int NK = kTile / 8;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t qa[4], da[4];
    a_frag<LD>(qa, qrow, kc);
    a_frag<LD>(da, dorow, kc);
#pragma unroll
    for (int j = 0; j < NK; j += 2) {
      uint32_t f[4];
      bt_frag<LD>(f, Kt, j, kc);
      mma_bf16(s[j], qa, f[0], f[1]);
      mma_bf16(s[j + 1], qa, f[2], f[3]);
      bt_frag<LD>(f, Vt, j, kc);
      mma_bf16(dp[j], da, f[0], f[1]);
      mma_bf16(dp[j + 1], da, f[2], f[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const __grid_constant__ Params p, int nqt,
                           float scale_log2) {
  constexpr int LD = D + kTcPad;
  constexpr int DN = D / 8;      // n8 chunks of dQ
  constexpr int NK = kTile / 8;  // n8 chunks of a score tile
  constexpr int R = kTile * LD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* dOs = Qs + R;                            // [kTile][LD]
  bf16* Ks = dOs + R;                            // [2][kTile][LD]
  bf16* Vs = Ks + 2 * R;                         // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * R);  // [kTile], log2

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int qt = p.causal ? nqt - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16* qb = head_base<bf16>(p.q, p.st + kQ, b, h);
  const bf16* dob = head_base<bf16>(p.dout, p.st + kDO, b, h);
  const bf16* kb = head_base<bf16>(p.k, p.st + kK, b, kvh);
  const bf16* vb = head_base<bf16>(p.v, p.st + kV, b, kvh);

  int kv_begin, kv_end;
  key_range(p, q0, kTile, &kv_begin, &kv_end);
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTile - 1) / kTile : 0;

  auto issue = [&](int tile, int buf) {
    const int k0 = kv_begin + tile * kTile;
    cp_async_tile<kTile, D, LD, kThreads>(Ks + buf * R, kb, p.st[kK + 1],
                                          k0, p.Sk);
    cp_async_tile<kTile, D, LD, kThreads>(Vs + buf * R, vb, p.st[kV + 1],
                                          k0, p.Sk);
  };
  // one pass over the key tiles, double-buffered: body(k0, Kt, Vt)
  auto walk = [&](auto body) {
    if (ntiles > 0) issue(0, 0);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < ntiles) {  // the next tile loads while this one runs
        issue(it + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(kv_begin + it * kTile, Ks + buf * R, Vs + buf * R);
      __syncthreads();  // this buffer is refilled two tiles on
    }
  };

  cp_async_tile<kTile, D, LD, kThreads>(Qs, qb, p.st[kQ + 1], q0, p.Sq);
  cp_async_tile<kTile, D, LD, kThreads>(dOs, dob, p.st[kDO + 1], q0, p.Sq);
  cp_async_commit();
  if (threadIdx.x < kTile) {
    const int qpos = q0 + threadIdx.x;
    lse_s[threadIdx.x] =
        qpos < p.Sq
            ? p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qpos] *
                  kLog2e
            : 0.f;
  }
  cp_async_wait<0>();  // q and dO have landed
  __syncthreads();

  const bf16* qrow = Qs + warp * 16 * LD;
  const bf16* dorow = dOs + warp * 16 * LD;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float lse_lo = lse_s[warp * 16 + g];
  const float lse_hi = lse_s[warp * 16 + g + 8];

  // P from lse, 0 where masked, in place of S
  auto probs = [&](float (&s)[NK][4], int k0) {
    if (tile_visible(p, q0, k0)) {  // no pair of the tile is masked
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2f(s[j][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi));
      return;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        s[j][e] = visible(p, lo ? row_lo : row_hi, kpos)
                      ? exp2f(s[j][e] * scale_log2 - (lo ? lse_lo : lse_hi))
                      : 0.f;
      }
    }
  };

  // pass 1: D_i = sum_k P dP, from this kernel's own P and dP (fp32),
  // written out for the dK/dV launch
  float d_lo = 0.f, d_hi = 0.f;
  walk([&](int k0, const bf16* Kt, const bf16* Vt) {
    float s[NK][4], dp[NK][4];
    scores_tc<D, LD>(s, dp, qrow, dorow, Kt, Vt);
    probs(s, k0);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      d_lo += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
      d_hi += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
    }
  });
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // the quad shares its rows
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
  }
  if (t == 0) {
    float* drow = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
    if (row_lo < p.Sq) drow[row_lo] = d_lo;
    if (row_hi < p.Sq) drow[row_hi] = d_hi;
  }

  // pass 2: dS = P (dP - D_i), dQ += dS k
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  walk([&](int k0, const bf16* Kt, const bf16* Vt) {
    float s[NK][4], dp[NK][4];
    scores_tc<D, LD>(s, dp, qrow, dorow, Kt, Vt);
    probs(s, k0);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] *= dp[j][0] - d_lo;
      s[j][1] *= dp[j][1] - d_lo;
      s[j][2] *= dp[j][2] - d_hi;
      s[j][3] *= dp[j][3] - d_hi;
    }
    // dS in two bf16 parts: along a row it sums to zero, which one
    // rounding of each term would break for rows that see few keys
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, s, kc);
#pragma unroll
      for (int j = 0; j < DN; j += 2) {
        uint32_t f[4];
        b_frag<LD>(f, Kt, j * 8, kc);
        mma_bf16(acc[j], hi, f[0], f[1]);
        mma_bf16(acc[j + 1], hi, f[2], f[3]);
        mma_bf16(acc[j], lo, f[0], f[1]);
        mma_bf16(acc[j + 1], lo, f[2], f[3]);
      }
    }
  });

  bf16* dqb = head_base_out<bf16>(p.dq, p.st + kDQ, b, h) + 2 * t;
  const float sc = p.scale;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    if (row_lo < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row_lo * p.st[kDQ + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(acc[j][0] * sc, acc[j][1] * sc);
    if (row_hi < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row_hi * p.st[kDQ + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(acc[j][2] * sc, acc[j][3] * sc);
  }
}

template <int D>
__global__ void __launch_bounds__(tc_dkdv_threads<D>())
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ Params p, int nkt,
                             float scale_log2) {
  constexpr int LD = D + kTcPad;
  constexpr int DK = D / 16;                  // k16 steps over the head dim
  constexpr int SPLIT = tc_dkdv_threads<D>() / kThreads;
  constexpr int DW = D / SPLIT;               // head dims a warp keeps
  constexpr int DN = DW / 8;                  // its n8 chunks of dK, dV
  constexpr int NQ = kTile / 8;               // n8 chunks of a score tile
  constexpr int NT = tc_dkdv_threads<D>();
  constexpr int R = kTile * LD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* Vs = Ks + R;                             // [kTile][LD]
  bf16* Qs = Vs + R;                             // [2][kTile][LD]
  bf16* dOs = Qs + 2 * R;                        // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * R);  // [2][kTile]
  float* dlt_s = lse_s + 2 * kTile;                      // [2][kTile]

  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int G = p.H / p.KV;
  // under the causal mask the first key tiles see the most queries
  const int k0 = static_cast<int>(blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3;          // the warp's group of 16 key rows
  const int dpart = warp >> 2;      // its part of the head dim
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  (void)nkt;

  const bf16* kb = head_base<bf16>(p.k, p.st + kK, b, kvh);
  const bf16* vb = head_base<bf16>(p.v, p.st + kV, b, kvh);

  int q_begin, q_end;
  query_range(p, k0, &q_begin, &q_end);
  const int nq = q_end > q_begin ? (q_end - q_begin + kTile - 1) / kTile : 0;
  const int iters = G * nq;

  // iteration i: head kvh * G + i / nq, queries from q_begin + (i % nq) * 64
  auto stage = [&](int i, int buf) {
    const int hh = kvh * G + i / nq;
    const int q0 = q_begin + (i % nq) * kTile;
    cp_async_tile<kTile, D, LD, NT>(Qs + buf * R,
                                 head_base<bf16>(p.q, p.st + kQ, b, hh),
                                 p.st[kQ + 1], q0, p.Sq);
    cp_async_tile<kTile, D, LD, NT>(dOs + buf * R,
                                 head_base<bf16>(p.dout, p.st + kDO, b, hh),
                                 p.st[kDO + 1], q0, p.Sq);
    for (int r = threadIdx.x; r < kTile; r += NT) {
      const int qpos = q0 + r;
      const long long at =
          (static_cast<long long>(b) * p.H + hh) * p.Sq + qpos;
      lse_s[buf * kTile + r] = qpos < p.Sq ? p.lse[at] * kLog2e : 0.f;
      dlt_s[buf * kTile + r] = qpos < p.Sq ? p.delta[at] : 0.f;
    }
  };

  cp_async_tile<kTile, D, LD, NT>(Ks, kb, p.st[kK + 1], k0, p.Sk);
  cp_async_tile<kTile, D, LD, NT>(Vs, vb, p.st[kV + 1], k0, p.Sk);
  if (iters > 0) stage(0, 0);
  cp_async_commit();

  const bf16* krow = Ks + rg * 16 * LD;
  const bf16* vrow = Vs + rg * 16 * LD;
  const int key_lo = k0 + rg * 16 + g;
  const int key_hi = key_lo + 8;

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    const int q0 = q_begin + (it % nq) * kTile;
    if (it + 1 < iters) {  // the next (head, query tile) loads meanwhile
      stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * R;
    const bf16* dOt = dOs + buf * R;
    const float* lt = lse_s + buf * kTile;
    const float* dt = dlt_s + buf * kTile;

    // S^T = k q^T and dP^T = v dO^T over the warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK; ++kc) {
      uint32_t ka[4], va[4];
      a_frag<LD>(ka, krow, kc);
      a_frag<LD>(va, vrow, kc);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t f[4];
        bt_frag<LD>(f, Qt, j, kc);
        mma_bf16(s[j], ka, f[0], f[1]);
        mma_bf16(s[j + 1], ka, f[2], f[3]);
        bt_frag<LD>(f, dOt, j, kc);
        mma_bf16(dp[j], va, f[0], f[1]);
        mma_bf16(dp[j + 1], va, f[2], f[3]);
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T
    if (tile_visible(p, q0, k0)) {  // no pair of the tile is masked
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + j * 8 + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          s[j][e] = exp2f(s[j][e] * scale_log2 - (odd ? l2.y : l2.x));
          dp[j][e] = s[j][e] * (dp[j][e] - (odd ? d2.y : d2.x));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          const float pr = visible(p, q0 + qi, e < 2 ? key_lo : key_hi)
                               ? exp2f(s[j][e] * scale_log2 - lt[qi])
                               : 0.f;
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - dt[qi]);
        }
      }
    }
    // dV += P^T dO and dK += dS^T q over the warp's head dims
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s, kc);
      acc_to_a(da, dp, kc);
#pragma unroll
      for (int j = 0; j < DN; j += 2) {
        const int col = dpart * DW + j * 8;
        uint32_t f[4];
        b_frag<LD>(f, dOt, col, kc);
        mma_bf16(dv[j], pa, f[0], f[1]);
        mma_bf16(dv[j + 1], pa, f[2], f[3]);
        b_frag<LD>(f, Qt, col, kc);
        mma_bf16(dk[j], da, f[0], f[1]);
        mma_bf16(dk[j + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  const int col0 = dpart * DW + 2 * t;
  bf16* dkb = head_base_out<bf16>(p.dk, p.st + kDK, b, kvh) + col0;
  bf16* dvb = head_base_out<bf16>(p.dv, p.st + kDV, b, kvh) + col0;
  const float sc = p.scale;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    if (key_lo < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key_lo * p.st[kDK + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(dk[j][0] * sc, dk[j][1] * sc);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key_lo * p.st[kDV + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(dv[j][0], dv[j][1]);
    }
    if (key_hi < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key_hi * p.st[kDK + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(dk[j][2] * sc, dk[j][3] * sc);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key_hi * p.st[kDV + 1] +
                                         j * 8) =
          __floats2bfloat162_rn(dv[j][2], dv[j][3]);
    }
  }
}

template <int D>
cudaError_t launch_bwd_tc(const Params& p, cudaStream_t stream) {
  constexpr size_t dq_smem = tc_dq_smem<D>();
  constexpr size_t dkdv_smem = tc_dkdv_smem<D>();
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float scale_log2 = p.scale * kLog2e;
  const int nqt = (p.Sq + kTile - 1) / kTile;
  const int nkt = (p.Sk + kTile - 1) / kTile;
  flash_bwd_dq_tc_kernel<D><<<dim3(p.B * p.H, nqt), kThreads, dq_smem,
                              stream>>>(p, nqt, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<D><<<dim3(p.B * p.KV, nkt),
                                tc_dkdv_threads<D>(), dkdv_smem, stream>>>(
      p, nkt, scale_log2);
  return cudaGetLastError();
}

// ------------------------------------------------------------ fp32 FMAs

// rows r0..r0+ROWS-1 of G (row stride ld, D contiguous) as fp32 into S
// [ROWS][D + 1]; rows past R are zeros
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows_f32(float* S, const T* G,
                                              long long ld, int r0, int R) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int gr = r0 + rr;
    S[rr * (D + 1) + d] = gr < R ? to_f32(G[gr * ld + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __grid_constant__ Params p, int nqt) {
  constexpr int BT = fma_tile<D>();  // keys per streamed tile
  constexpr int DP = D + 1;          // padded rows: no bank conflicts
  constexpr int PP = BT + 1;
  constexpr int HALF_D = D / 2;
  constexpr int HALF_T = BT / 2;

  extern __shared__ float smem[];
  float* Qs = smem;              // [kTile][DP]
  float* dOs = Qs + kTile * DP;  // [kTile][DP]
  float* Ks = dOs + kTile * DP;  // [BT][DP]
  float* Vs = Ks + BT * DP;      // [BT][DP]
  float* dSs = Vs + BT * DP;     // [kTile][PP]

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int qt = p.causal ? nqt - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qt * kTile;
  const int r = threadIdx.x >> 1;     // query row within the tile
  const int half = threadIdx.x & 1;   // which half of keys / dims
  const int qpos = q0 + r;
  const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + qpos;
  const float lse_r = qpos < p.Sq ? p.lse[at] : 0.f;

  const T* kb = head_base<T>(p.k, p.st + kK, b, kvh);
  const T* vb = head_base<T>(p.v, p.st + kV, b, kvh);
  load_rows_f32<T, D, kTile, kThreads>(
      Qs, head_base<T>(p.q, p.st + kQ, b, h), p.st[kQ + 1], q0, p.Sq);
  load_rows_f32<T, D, kTile, kThreads>(
      dOs, head_base<T>(p.dout, p.st + kDO, b, h), p.st[kDO + 1], q0, p.Sq);

  int kv_begin, kv_end;
  key_range(p, q0, BT, &kv_begin, &kv_end);

  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  // pass 0: D_i = sum_k P dP (written out for the dK/dV launch);
  // pass 1: dS = P (dP - D_i), dQ += dS k
  float dl_r = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    float dsum = 0.f;
    for (int k0 = kv_begin; k0 < kv_end; k0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_rows_f32<T, D, BT, kThreads>(Ks, kb, p.st[kK + 1], k0, p.Sk);
      load_rows_f32<T, D, BT, kThreads>(Vs, vb, p.st[kV + 1], k0, p.Sk);
      __syncthreads();
      for (int j = 0; j < HALF_T; ++j) {
        const int c = half * HALF_T + j;
        float sd = 0.f, pd = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          sd = fmaf(Qs[r * DP + d], Ks[c * DP + d], sd);
          pd = fmaf(dOs[r * DP + d], Vs[c * DP + d], pd);
        }
        const float pr = visible(p, qpos, k0 + c)
                             ? expf(sd * p.scale - lse_r) : 0.f;
        if (pass == 0)
          dsum = fmaf(pr, pd, dsum);
        else
          dSs[r * PP + c] = pr * (pd - dl_r);
      }
      if (pass == 0) continue;
      __syncwarp();  // the row's two threads are neighbouring lanes
      for (int c = 0; c < BT; ++c) {
        const float ds = dSs[r * PP + c];
        const float* krow = Ks + c * DP + half * HALF_D;
#pragma unroll
        for (int i = 0; i < HALF_D; ++i) acc[i] = fmaf(ds, krow[i], acc[i]);
      }
    }
    if (pass == 0) {
      dl_r = dsum + __shfl_xor_sync(0xffffffffu, dsum, 1);
      if (half == 0 && qpos < p.Sq) p.delta[at] = dl_r;
    }
  }

  if (qpos < p.Sq) {
    T* dqrow = head_base_out<T>(p.dq, p.st + kDQ, b, h) +
               qpos * p.st[kDQ + 1] + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) dqrow[i] = from_f32<T>(acc[i] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(fma_dkdv_threads<D>())
    flash_bwd_dkdv_kernel(const __grid_constant__ Params p, int nkt) {
  constexpr int NT = fma_dkdv_threads<D>();
  constexpr int TPR = NT / kTile;    // threads a key row
  constexpr int BT = fma_tile<D>();  // queries per streamed tile
  constexpr int DP = D + 1;
  constexpr int PP = BT + 1;
  constexpr int DW = D / TPR;        // head dims of a thread's dK, dV
  constexpr int QW = BT / TPR;       // queries a thread scores

  extern __shared__ float smem[];
  float* Ks = smem;               // [kTile][DP]
  float* Vs = Ks + kTile * DP;    // [kTile][DP]
  float* Qs = Vs + kTile * DP;    // [BT][DP]
  float* dOs = Qs + BT * DP;      // [BT][DP]
  float* Ps = dOs + BT * DP;      // [kTile][PP]
  float* dSs = Ps + kTile * PP;   // [kTile][PP]
  float* lse_s = dSs + kTile * PP;  // [BT]
  float* dlt_s = lse_s + BT;        // [BT]

  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int G = p.H / p.KV;
  const int k0 = static_cast<int>(blockIdx.y) * kTile;
  const int r = threadIdx.x / TPR;    // key row within the tile
  const int part = threadIdx.x % TPR;
  const int kpos = k0 + r;
  (void)nkt;

  load_rows_f32<T, D, kTile, NT>(Ks, head_base<T>(p.k, p.st + kK, b, kvh),
                                 p.st[kK + 1], k0, p.Sk);
  load_rows_f32<T, D, kTile, NT>(Vs, head_base<T>(p.v, p.st + kV, b, kvh),
                                 p.st[kV + 1], k0, p.Sk);

  int q_begin, q_end;
  query_range(p, k0, &q_begin, &q_end);

  float dk[DW], dv[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) dk[i] = dv[i] = 0.f;

  for (int hh = kvh * G; hh < (kvh + 1) * G; ++hh) {
    const T* qb = head_base<T>(p.q, p.st + kQ, b, hh);
    const T* dob = head_base<T>(p.dout, p.st + kDO, b, hh);
    const long long row0 = (static_cast<long long>(b) * p.H + hh) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_rows_f32<T, D, BT, NT>(Qs, qb, p.st[kQ + 1], q0, p.Sq);
      load_rows_f32<T, D, BT, NT>(dOs, dob, p.st[kDO + 1], q0, p.Sq);
      for (int c = threadIdx.x; c < BT; c += NT) {
        const bool in = q0 + c < p.Sq;
        lse_s[c] = in ? p.lse[row0 + q0 + c] : 0.f;
        dlt_s[c] = in ? p.delta[row0 + q0 + c] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < QW; ++j) {
        const int c = part * QW + j;
        float sd = 0.f, pd = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          sd = fmaf(Ks[r * DP + d], Qs[c * DP + d], sd);
          pd = fmaf(Vs[r * DP + d], dOs[c * DP + d], pd);
        }
        const float pr = visible(p, q0 + c, kpos)
                             ? expf(sd * p.scale - lse_s[c]) : 0.f;
        Ps[r * PP + c] = pr;
        dSs[r * PP + c] = pr * (pd - dlt_s[c]);
      }
      __syncwarp();  // the row's threads are neighbouring lanes
      for (int c = 0; c < BT; ++c) {
        const float pv = Ps[r * PP + c];
        const float ds = dSs[r * PP + c];
        const float* orow = dOs + c * DP + part * DW;
        const float* qrow = Qs + c * DP + part * DW;
#pragma unroll
        for (int i = 0; i < DW; ++i) {
          dv[i] = fmaf(pv, orow[i], dv[i]);
          dk[i] = fmaf(ds, qrow[i], dk[i]);
        }
      }
    }
  }

  if (kpos < p.Sk) {
    T* dkrow = head_base_out<T>(p.dk, p.st + kDK, b, kvh) +
               kpos * p.st[kDK + 1] + part * DW;
    T* dvrow = head_base_out<T>(p.dv, p.st + kDV, b, kvh) +
               kpos * p.st[kDV + 1] + part * DW;
#pragma unroll
    for (int i = 0; i < DW; ++i) {
      dkrow[i] = from_f32<T>(dk[i] * p.scale);
      dvrow[i] = from_f32<T>(dv[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t dq_smem = fma_dq_smem<D>();
  constexpr size_t dkdv_smem = fma_dkdv_smem<D>();
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int nqt = (p.Sq + kTile - 1) / kTile;
  const int nkt = (p.Sk + kTile - 1) / kTile;
  flash_bwd_dq_kernel<T, D><<<dim3(p.B * p.H, nqt), kThreads, dq_smem,
                              stream>>>(p, nqt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(p.B * p.KV, nkt),
                                fma_dkdv_threads<D>(), dkdv_smem, stream>>>(
      p, nkt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_typed(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_bwd_fma<T, 32>(p, s);
    case 64:
      return launch_bwd_fma<T, 64>(p, s);
    case 112:
      return launch_bwd_fma<T, 112>(p, s);
    case 128:
      return launch_bwd_fma<T, 128>(p, s);
    case 256:
      return launch_bwd_fma<T, 256>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, const long long* strides,
                   int causal, int window, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

// The tensor-core backward (bf16): q, k, v, do, lse [B, H, Sq] fp32 from
// the forward, delta (scratch, [B, H, Sq] fp32), dq, dk, dv; the shape;
// strides: 21 element strides, (batch, seq, head) for q, k, v, do, dq,
// dk and dv in that order (head dims contiguous); the mask and scale;
// the stream.  Every row of q, k, v, do and the gradients must start on
// a 16-byte boundary (the wrapper checks the pointers and strides).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, B,
                               Sq, Sk, H, KV, strides, causal, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_bwd_tc<32>(p, s);
      break;
    case 64:
      err = launch_bwd_tc<64>(p, s);
      break;
    case 112:
      err = launch_bwd_tc<112>(p, s);
      break;
    case 128:
      err = launch_bwd_tc<128>(p, s);
      break;
    case 256:
      err = launch_bwd_tc<256>(p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The fp32-FMA backward: the same arguments and the dtype flag (1 =
// bf16, 0 = fp32) before the stream.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D,
    const long long* strides, int causal, int window, float scale, int bf16,
    void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, B,
                               Sq, Sk, H, KV, strides, causal, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_fma_typed<__nv_bfloat16>(p, D, s)
                               : launch_fma_typed<float>(p, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
