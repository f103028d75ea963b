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
//   dS = P (dP - D_i),
//   dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k,
// with S, P, dP and dS kept out of device memory.  Along a query's row dS
// sums to zero, and a row that sees few keys keeps whatever breaks that
// whole, so two choices hold dq to its bf16 check.  D_i must be sum_k P
// dP with fp32 P: rowsum(dO * O) with O rounded to bf16 misses it by
// that rounding, and so, at long rows, does O's fp32 value before the
// rounding, since the forward's PV product takes p rounded to bf16.  Up
// to head dim 128 the forward therefore writes o_lo from a PV product on
// p as hi + lo (csrc/flash_attention.cu), and D_i = rowsum(dO (o +
// o_lo)); at 256 (no room for a second accumulator there) the dQ launch
// sums D_i over a first walk of the keys, as the fp32 path does.  And dS
// enters the dQ product as two bf16 parts, hi and the rounded rest.  On
// the CPU (kernels/tolerance.py's printer) dq reads 0.16-0.21 of the
// bf16 allowance either way; D_i from o rounded up to 2.39, from o + o_lo
// of a PV product on p rounded once 1.04 at S 4096 (1.92 on the card at
// qwen2's training shape).
//
// What bounds it on an H100 SXM: at qwen2-0.5b's training shape (B 4,
// S 4096, H 14, KV 2, D 64, causal) the five products over the 8.39 M
// visible pairs a head take 300.7 GFLOP (0.304 ms at the bf16
// tensor-core rate) against ~106 MB of inputs and outputs (q, k, v, dO
// and lse read, dq, dk and dv written: 0.032 ms): the tensor cores
// bound it, and only wgmma reaches their full rate.
//
// bf16 (`tensor_core`, rows on the 16-byte grid): wgmma fed by TMA,
// deterministic, with no atomics, three launches in this order:
//   * dQ (`flash_bwd_dq_tc_kernel`): one block per (batch, head, 128
//     query rows), heaviest first under the causal mask.  A producer
//     warp brings the block's q and dO once and keeps a ring of K and V
//     tiles (64 keys) in flight by TMA, each stage guarded by a `full`
//     and an `empty` mbarrier; two warpgroups of 64 rows each take D_i
//     of their rows from dO, o and o_lo (written out for dK/dV), then
//     walk the key tiles their rows can see once: S and dP by wgmma from
//     shared memory, P and dS in registers (the per-pair mask only on
//     tiles it cuts), dQ += dS_hi k + dS_lo k by wgmma with A from
//     registers (the accumulator layout is the A layout).  Four products
//     a pair (six at head dim 256, with its D_i walk).
//   * dK/dV (`flash_bwd_dkdv_tc_kernel`): one block per (batch, query
//     head, 128 keys), heaviest first: the blocks are the GQA group
//     times more and lighter than one per kv head, so no wave waits on
//     a block that walks the whole group.  A producer warp brings k and
//     v once and rings q and dO tiles with their lse and D_i; each of two
//     warpgroups owns 64 keys: S^T, dP^T, dV += P^T dO, dK += dS^T q,
//     P^T and dS^T from registers.  Four products a pair.  With G = 1
//     each block writes dk and dv; else each head's fp32 partials
//     [B, Sk, H, D] go to scratch and
//   * the group sum (`flash_bwd_group_sum_kernel`) adds each group's G
//     partials in head order into dk (times scale) and dv.
//   Eight products a visible pair against the bound's five.  A block's
//   9 warps (two warpgroups and the producer) leave 168 registers a
//   thread, and 128 head dims of dK and dV take 128 of them: above head
//   dim 64 the dK/dV block's two warpgroups share 64 keys, each with
//   half the head dim's dK and dV, both computing S and dP (ten
//   products a pair; holding all the head dims spilled ~1 KB a thread,
//   and ran slower).  At head dim 256 the dQ block has one warpgroup
//   (its dQ accumulators take 128 registers a thread) and walks for
//   D_i: twelve products a pair.  Tiles sit in shared memory as TMA
//   writes them for wgmma: boxes of 64 rows by 64 head
//   dims (128-byte rows, 128-byte swizzle) through a 4-D map (head dim,
//   head, sequence, batch) whose edges fill zeros, so rows past Sq or Sk
//   and head dims past D (112 -> 128, 32 -> 64) read as zeros.
//
// fp32 (and bf16 off the 16-byte grid): `flash_bwd_dq_kernel` and
// `flash_bwd_dkdv_kernel`, fp32 FMAs from shared memory (the tensor cores
// cannot meet the 1e-5 fp32 policy), two launches.  The dQ launch walks
// its keys twice (D_i = sum P dP first, written to `delta`, then dS and
// dQ); the dK/dV block owns 64 keys of a kv head and walks its GQA
// group's heads, so the group's sum stays in registers.  Threads share a
// row (2, or 4 in dK/dV at D = 256): each scores a share of the streamed
// tile's columns into shared memory, then keeps a share of the row's
// head dims.  At D = 256 the streamed tile is 32 rows, so that both
// blocks fit.
//
// Head dims 32, 64, 112, 128 and 256 are compiled, as in the forward.
// Rows past Sq or Sk are zero-filled and masked; tiles the causal or
// window mask hides for every pair are skipped.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after each of its launches.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;    // fma: 4 warps; tensor_core: a warpgroup
constexpr int kTile = 64;        // rows of a tile (a warpgroup's wgmma M)
constexpr int kChunk = 64;       // tensor_core: head dims of a TMA box
constexpr int kBox = kTile * kChunk * 2;  // bytes of a box, 128-byte rows
constexpr int kTcSplitD = 64;    // tensor_core dK/dV: split above it
constexpr int kTcWideD = 128;    // tensor_core: narrow blocks above it
constexpr int kProducer = 32;    // tensor_core: the producer warp
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
  const void* o;     // tensor_core up to kTcWideD: the forward's o and
  const void* o_lo;  // o_lo, contiguous [B, Sq, H, D] bf16
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dk_part;    // tensor_core, G > 1: [B, Sk, H, D] fp32 partials;
  float* dv_part;    // null: each block writes dk and dv
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

// Keys that a row in [q_first, q_last] may see, from a multiple of
// `tile`: [*begin, *end).
__device__ __forceinline__ void key_span(const Params& p, int q_first,
                                         int q_last, int tile, int* begin,
                                         int* end) {
  *end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int kb = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *begin = (kb / tile) * tile;
}

// Key tiles (of `tile` rows) that a row of the query tile at q0 may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int tile,
                                          int* begin, int* end) {
  key_span(p, q0, min(q0 + kTile, p.Sq) - 1, tile, begin, end);
}

// Query rows that may see a key in [k_first, k_last]: [*begin, *end).
__device__ __forceinline__ void query_span(const Params& p, int k_first,
                                           int k_last, int* begin,
                                           int* end) {
  *begin = p.causal ? k_first : 0;
  *end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
}

// Query rows that may see a key of the tile at k0.
__device__ __forceinline__ void query_range(const Params& p, int k0,
                                            int* begin, int* end) {
  query_span(p, k0, min(k0 + kTile, p.Sk) - 1, begin, end);
}

// The shared memory of each block, which flash_bwd_smem_plan in
// core/gpu_mapping.py sums the same way.  tensor_core: 1 KB of alignment
// slack (a box starts on 1024 bytes), the boxes, fp32 rows, barriers.
template <int D>
__host__ __device__ constexpr int tc_chunks() {
  return (D + kChunk - 1) / kChunk;
}
// dQ: consumer warpgroups of 64 query rows each; at D 256 one, whose dQ
// accumulators alone take 128 registers a thread
template <int D>
__host__ __device__ constexpr int tc_dq_wgs() {
  return D > kTcWideD ? 1 : 2;
}
template <int D>
__host__ __device__ constexpr int tc_dq_stages() {
  return D > kTcWideD ? 2 : 3;
}
// dK/dV: keys a block owns, 64 a consumer warpgroup; above 64 head dims
// both warpgroups take the same 64, each half the head dim's dK and dV
template <int D>
__host__ __device__ constexpr int tc_dkdv_keys() {
  return D > kTcSplitD ? kTile : 2 * kTile;
}
template <int D>
__host__ __device__ constexpr int tc_dkdv_stages() {
  return D > kTcWideD ? 2 : 3;
}
template <int D>
__host__ __device__ constexpr size_t tc_dq_smem() {
  return 1024 + (2 * tc_dq_wgs<D>() + 2 * tc_dq_stages<D>()) *
                    tc_chunks<D>() * kBox +
         (2 * tc_dq_stages<D>() + 1) * sizeof(uint64_t);
}
template <int D>
__host__ __device__ constexpr size_t tc_dkdv_smem() {
  return 1024 + (2 * tc_dkdv_keys<D>() / kTile + 2 * tc_dkdv_stages<D>()) *
                    tc_chunks<D>() * kBox +
         tc_dkdv_stages<D>() * 2 * kTile * sizeof(float) +
         (2 * tc_dkdv_stages<D>() + 1) * sizeof(uint64_t);
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
__host__ __device__ constexpr int fma_dkdv_threads() {
  return (D > kFmaWideD ? 4 : 2) * kTile;
}

// ------------------------------------------------ bf16, tensor cores
//
// Tiles live in shared memory as TMA writes them for wgmma: a tile of
// 64 rows is DP / 64 boxes of [64 rows][64 head dims] (8 KB, 128-byte
// rows in the 128-byte swizzle), loaded through a 4-D map (head dim,
// head, sequence, batch) whose edges fill zeros: rows past Sq or Sk, and
// head dims past D (112 -> 128, 32 -> 64).  A product over the head dim
// (S, dP) reads both operands K-major; a product over a tile's rows
// (dQ, dV, dK) reads the tile MN-major (the transpose bit), its head
// dims as N.

// Descriptors of a tile at shared address `base`: K-major (over the head
// dim) and MN-major (over the rows).  A step within the tile adds its
// byte offset / 16 to the start-address field (addresses stay under
// 2^18, the field's 14 bits).
__device__ __forceinline__ uint64_t desc_k(uint32_t base) {
  return wgmma_desc_sw128(base, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t base) {
  return wgmma_desc_sw128(base, kBox, 1024);
}
// K-major: the k16 step kk (32 bytes along a 128-byte row, then the next
// box).  MN-major: rows 16 kk .. 16 kk + 15 (2 KB on), N across the
// boxes from head dim 64 c0.
__device__ __forceinline__ uint64_t step_k(uint64_t d, int kk) {
  return d + (((kk >> 2) * kBox + (kk & 3) * 32) >> 4);
}
__device__ __forceinline__ uint64_t step_mn(uint64_t d, int kk, int c0) {
  return d + ((c0 * kBox + kk * 2048) >> 4);
}

// A = X (64 rows of a tile at xa) against B = Y^T (64 rows of a tile at
// yb), over the DP head dims: s = X Y^T, m64n64, fp32.
template <int DP>
__device__ __forceinline__ void scores_wg(float (&s)[32], uint32_t xa,
                                          uint32_t yb) {
  const uint64_t da = desc_k(xa), db = desc_k(yb);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64<0>(s, step_k(da, kk), step_k(db, kk), kk > 0);
}

// d (64 x NN, fp32) += A (64 x 64, four m64k16 fragments) * the 64 rows
// of the tile at `base`, head dims 64 c0 .. 64 c0 + NN - 1.
template <int NN>
__device__ __forceinline__ void rows_product(float (&d)[NN / 2],
                                             const uint32_t (&a)[4][4],
                                             uint32_t base, int c0) {
  const uint64_t db = desc_mn(base);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if constexpr (NN == 128)
      wgmma_rs_n128<1>(d, a[kc], step_mn(db, kc, c0));
    else
      wgmma_rs_n64<1>(d, a[kc], step_mn(db, kc, c0));
  }
}

template <int D>
__global__ void __launch_bounds__(tc_dq_wgs<D>() * kThreads + kProducer, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ Params p, int nqb,
                           float scale_log2) {
  constexpr int NC = tc_chunks<D>();
  constexpr int DP = NC * kChunk;
  constexpr int NWG = tc_dq_wgs<D>();
  constexpr int ST = tc_dq_stages<D>();
  constexpr int NN = DP > 128 ? 128 : DP;  // N of one dQ wgmma
  constexpr int NP = DP / NN;              // dQ wgmmas a k16 step
  // D_i by a first walk over the keys where the forward writes no o_lo
  constexpr bool WALK = D > kTcWideD;
  constexpr int NW = WALK ? 2 : 1;  // walks over the key tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;                   // [NWG][NC] boxes
  unsigned char* dOs = Qs + NWG * NC * kBox;  // [NWG][NC]
  unsigned char* KVs = dOs + NWG * NC * kBox;  // [ST][K, V][NC]
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + ST * 2 * NC * kBox);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  // under the causal mask the last query tiles see the most keys
  const int qb = p.causal ? nqb - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qb * NWG * kTile;
  const int wg = threadIdx.x / kThreads;  // NWG: the producer warp

  int kv_begin, kv_end;
  key_span(p, q0, min(q0 + NWG * kTile, p.Sq) - 1, kTile, &kv_begin,
           &kv_end);
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);  // one arrival per consumer warpgroup
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer: q and dO once, then the K/V ring
    if (threadIdx.x == NWG * kThreads) {
      mbar_arrive_expect_tx(qbar, 2 * NWG * NC * kBox);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(Qs + (w * NC + c) * kBox, &tm_q, c * kChunk, h,
                      q0 + w * kTile, b, qbar);
          tma_load_4d(dOs + (w * NC + c) * kBox, &tm_do, c * kChunk, h,
                      q0 + w * kTile, b, qbar);
        }
      for (int it = 0; it < NW * ntiles; ++it) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(&empty[st], ((it / ST) - 1) & 1);
        unsigned char* kt = KVs + st * 2 * NC * kBox;
        const int k0 = kv_begin + (it % ntiles) * kTile;
        mbar_arrive_expect_tx(&full[st], 2 * NC * kBox);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(kt + c * kBox, &tm_k, c * kChunk, kvh, k0, b,
                      &full[st]);
          tma_load_4d(kt + (NC + c) * kBox, &tm_v, c * kChunk, kvh, k0, b,
                      &full[st]);
        }
      }
    }
    return;
  }

  const int cw = wg;  // this consumer warpgroup: rows qw0 .. qw0 + 63
  const int tid = threadIdx.x - wg * kThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + cw * kTile;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  const int row_lo = qw0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float lse_lo = row_lo < p.Sq ? p.lse[row0 + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < p.Sq ? p.lse[row0 + row_hi] * kLog2e : 0.f;

  // the key tiles this warpgroup's rows can see
  int kb_w = 0, ke_w = 0;
  if (qw0 < p.Sq)
    key_span(p, qw0, min(qw0 + kTile, p.Sq) - 1, kTile, &kb_w, &ke_w);

  float acc[NP][NN / 2];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < NN / 2; ++i) acc[pp][i] = 0.f;

  const uint32_t q_base = smem_addr(Qs + cw * NC * kBox);
  const uint32_t do_base = smem_addr(dOs + cw * NC * kBox);
  mbar_wait(qbar, 0);

  float d_lo = 0.f, d_hi = 0.f;
  if constexpr (!WALK) {
    // D_i = sum_d dO (o + o_lo) in fp32 for the warp's 16 rows, two lanes
    // a row (lane 2r + half), each every other 16-byte piece; written out
    // for dK/dV
    const int row = qw0 + warp * 16 + (lane >> 1);
    float sum = 0.f;
    if (row < p.Sq) {
      const bf16* dor = head_base<bf16>(p.dout, p.st + kDO, b, h) +
                        row * p.st[kDO + 1];
      const long long at =
          ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
      const bf16* orow = static_cast<const bf16*>(p.o) + at;
      const bf16* lrow = static_cast<const bf16*>(p.o_lo) + at;
      for (int pc = lane & 1; pc < D / 8; pc += 2) {
        const uint4 a = *reinterpret_cast<const uint4*>(dor + pc * 8);
        const uint4 o = *reinterpret_cast<const uint4*>(orow + pc * 8);
        const uint4 l = *reinterpret_cast<const uint4*>(lrow + pc * 8);
        const bf16* av = reinterpret_cast<const bf16*>(&a);
        const bf16* ov = reinterpret_cast<const bf16*>(&o);
        const bf16* lv = reinterpret_cast<const bf16*>(&l);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum = fmaf(__bfloat162float(av[e]),
                     __bfloat162float(ov[e]) + __bfloat162float(lv[e]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0 && row < p.Sq) p.delta[row0 + row] = sum;
    d_lo = __shfl_sync(0xffffffffu, sum, 2 * g);       // row g
    d_hi = __shfl_sync(0xffffffffu, sum, 2 * g + 16);  // row g + 8
  }

  // WALK: walk 1 sums D_i = sum_k P dP from this kernel's own fp32 P and
  // dP (each thread over its columns, then the quad); then (or at once)
  // the walk that forms dS and dQ
  for (int it = 0; it < NW * ntiles; ++it) {
    const int st = it % ST;
    const bool second = !WALK || it >= ntiles;
    const int k0 = kv_begin + (it % ntiles) * kTile;
    if (WALK && it == ntiles) {  // D_i of the rows: the quad shares them
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
      }
      if (t == 0) {  // for the dK/dV launch
        if (row_lo < p.Sq) p.delta[row0 + row_lo] = d_lo;
        if (row_hi < p.Sq) p.delta[row0 + row_hi] = d_hi;
      }
    }
    mbar_wait(&full[st], (it / ST) & 1);
    if (k0 < ke_w && k0 + kTile > kb_w) {
      const uint32_t k_base = smem_addr(KVs + st * 2 * NC * kBox);
      const uint32_t v_base = k_base + NC * kBox;
      float s[32], dp[32];
      wgmma_fence();
      scores_wg<DP>(s, q_base, k_base);   // S = q k^T
      scores_wg<DP>(dp, do_base, v_base);  // dP = dO v^T
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      wgmma_fence_regs(dp);
      // P from lse, 0 where masked, in place of S
      if (tile_visible(p, qw0, k0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2f(s[i] * scale_log2 - ((i & 2) ? lse_hi : lse_lo));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const bool hi = i & 2;
          s[i] = visible(p, hi ? row_hi : row_lo, kpos)
                     ? exp2f(s[i] * scale_log2 - (hi ? lse_hi : lse_lo))
                     : 0.f;
        }
      }
      if (!second) {
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          d_lo += s[i] * dp[i] + s[i + 1] * dp[i + 1];
          d_hi += s[i + 2] * dp[i + 2] + s[i + 3] * dp[i + 3];
        }
      } else {
        // dS = P (dP - D_i); dQ += dS k with dS in two bf16 parts: along
        // a row it sums to zero, which one rounding of each term would
        // break for rows that see few keys
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] *= dp[i] - ((i & 2) ? d_hi : d_lo);
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a_split(hi[kc], lo[kc], s, kc);
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          rows_product<NN>(acc[pp], hi, k_base, pp * (NN / kChunk));
          rows_product<NN>(acc[pp], lo, k_base, pp * (NN / kChunk));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) wgmma_fence_regs(acc[pp]);
      }
    }
    if (tid == 0) mbar_arrive(&empty[st]);  // the stage back to the producer
  }
  if (WALK && ntiles == 0 && t == 0) {  // rows that see no key: D_i = 0
    if (row_lo < p.Sq) p.delta[row0 + row_lo] = 0.f;
    if (row_hi < p.Sq) p.delta[row0 + row_hi] = 0.f;
  }

  bf16* dqb = head_base_out<bf16>(p.dq, p.st + kDQ, b, h) + 2 * t;
  const float sc = p.scale;
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int col = pp * NN + j * 8;
      if (col >= D) continue;
      const float* a = acc[pp] + 4 * j;
      if (row_lo < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + row_lo * p.st[kDQ + 1] +
                                           col) =
            __floats2bfloat162_rn(a[0] * sc, a[1] * sc);
      if (row_hi < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + row_hi * p.st[kDQ + 1] +
                                           col) =
            __floats2bfloat162_rn(a[2] * sc, a[3] * sc);
    }
}

template <int D>
__global__ void __launch_bounds__(2 * kThreads + kProducer, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ Params p,
                             float scale_log2) {
  constexpr int NC = tc_chunks<D>();
  constexpr int DP = NC * kChunk;
  constexpr bool SPLIT = D > kTcSplitD;  // both warpgroups on 64 keys
  constexpr int KW = tc_dkdv_keys<D>() / kTile;  // key boxes a block owns
  constexpr int ST = tc_dkdv_stages<D>();
  constexpr int NO = SPLIT ? DP / 2 : DP;  // head dims of a warpgroup's dK, dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;                  // [KW][NC] boxes
  unsigned char* Vs = Ks + KW * NC * kBox;   // [KW][NC]
  unsigned char* QDs = Vs + KW * NC * kBox;  // [ST][q, dO][NC]
  float* lsd = reinterpret_cast<float*>(QDs + ST * 2 * NC * kBox);
  // lsd: [ST][lse * log2(e), D_i][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(lsd + ST * 2 * kTile);
  uint64_t* empty = full + ST;
  uint64_t* kbar = empty + ST;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  // under the causal mask the first key tiles see the most queries
  const int k0 = static_cast<int>(blockIdx.y) * KW * kTile;
  const int wg = threadIdx.x / kThreads;  // 2: the producer warp

  int q_begin, q_end;
  query_span(p, k0, min(k0 + KW * kTile, p.Sk) - 1, &q_begin, &q_end);
  const int nq = q_end > q_begin ? (q_end - q_begin + kTile - 1) / kTile : 0;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);  // the TMA's bytes and 32 lanes' lse, D_i
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(kbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: k and v once, then the q/dO ring
    const int lane = threadIdx.x - 2 * kThreads;
    if (lane == 0) {
      mbar_arrive_expect_tx(kbar, 2 * KW * NC * kBox);
      for (int w = 0; w < KW; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(Ks + (w * NC + c) * kBox, &tm_k, c * kChunk, kvh,
                      k0 + w * kTile, b, kbar);
          tma_load_4d(Vs + (w * NC + c) * kBox, &tm_v, c * kChunk, kvh,
                      k0 + w * kTile, b, kbar);
        }
    }
    for (int it = 0; it < nq; ++it) {
      const int st = it % ST;
      const int q0 = q_begin + it * kTile;
      if (it >= ST) mbar_wait(&empty[st], ((it / ST) - 1) & 1);
      if (lane == 0) {
        unsigned char* qt = QDs + st * 2 * NC * kBox;
        mbar_arrive_expect_tx(&full[st], 2 * NC * kBox);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(qt + c * kBox, &tm_q, c * kChunk, h, q0, b, &full[st]);
          tma_load_4d(qt + (NC + c) * kBox, &tm_do, c * kChunk, h, q0, b,
                      &full[st]);
        }
      }
      float* l = lsd + st * 2 * kTile;
      for (int r = lane; r < kTile; r += 32) {
        const int qpos = q0 + r;
        const bool in = qpos < p.Sq;
        l[r] = in ? p.lse[row0 + qpos] * kLog2e : 0.f;
        l[kTile + r] = in ? p.delta[row0 + qpos] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
    return;
  }

  const int cw = wg;
  const int tid = threadIdx.x - wg * kThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kbox = SPLIT ? 0 : cw;         // this warpgroup's keys
  const int kw0 = k0 + kbox * kTile;
  const int c0 = SPLIT ? cw * (NO / kChunk) : 0;  // its first head-dim box
  const int key_lo = kw0 + warp * 16 + g;
  const int key_hi = key_lo + 8;

  // the query tiles that can see this warpgroup's keys
  int qb_w = 0, qe_w = 0;
  if (kw0 < p.Sk) query_span(p, kw0, min(kw0 + kTile, p.Sk) - 1, &qb_w,
                             &qe_w);

  float dk[NO / 2], dv[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_base = smem_addr(Ks + kbox * NC * kBox);
  const uint32_t v_base = smem_addr(Vs + kbox * NC * kBox);
  mbar_wait(kbar, 0);

  for (int it = 0; it < nq; ++it) {
    const int st = it % ST;
    const int q0 = q_begin + it * kTile;
    mbar_wait(&full[st], (it / ST) & 1);
    if (q0 < qe_w && q0 + kTile > qb_w) {
      const uint32_t q_st = smem_addr(QDs + st * 2 * NC * kBox);
      const uint32_t do_st = q_st + NC * kBox;
      const float* lt = lsd + st * 2 * kTile;
      const float* dt = lt + kTile;
      float s[32], dp[32];
      wgmma_fence();
      scores_wg<DP>(s, k_base, q_st);    // S^T = k q^T
      scores_wg<DP>(dp, v_base, do_st);  // dP^T = v dO^T
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      wgmma_fence_regs(dp);
      // P^T in place of S^T, dS^T in place of dP^T; column e of the
      // thread's n8 chunk j is query 8j + 2t + (e & 1)
      if (tile_visible(p, q0, kw0)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + j * 8 + 2 * t);
          const float2 d2 =
              *reinterpret_cast<const float2*>(dt + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const bool odd = e & 1;
            s[i] = exp2f(s[i] * scale_log2 - (odd ? l2.y : l2.x));
            dp[i] = s[i] * (dp[i] - (odd ? d2.y : d2.x));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = (i >> 2) * 8 + 2 * t + (i & 1);
          const float pr = visible(p, q0 + qi, (i & 2) ? key_hi : key_lo)
                               ? exp2f(s[i] * scale_log2 - lt[qi])
                               : 0.f;
          s[i] = pr;
          dp[i] = pr * (dp[i] - dt[qi]);
        }
      }
      // dV += P^T dO and dK += dS^T q over this warpgroup's head dims
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        acc_to_a(pa[kc], s, kc);
        acc_to_a(da[kc], dp, kc);
      }
      wgmma_fence();
      rows_product<NO>(dv, pa, do_st, c0);
      rows_product<NO>(dk, da, q_st, c0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(dv);
      wgmma_fence_regs(dk);
    }
    if (tid == 0) mbar_arrive(&empty[st]);
  }

  // G = 1: dk (scaled) and dv in bf16; else this head's fp32 partials,
  // which flash_bwd_group_sum_kernel sums over the group
  const float sc = p.scale;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j) {
    const int col = (c0 * kChunk) + j * 8 + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key_hi : key_lo;
      if (key >= p.Sk) continue;
      const float* k2 = dk + 4 * j + 2 * half;
      const float* v2 = dv + 4 * j + 2 * half;
      if (p.dk_part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(
            head_base_out<bf16>(p.dk, p.st + kDK, b, kvh) +
            key * p.st[kDK + 1] + col) =
            __floats2bfloat162_rn(k2[0] * sc, k2[1] * sc);
        *reinterpret_cast<__nv_bfloat162*>(
            head_base_out<bf16>(p.dv, p.st + kDV, b, kvh) +
            key * p.st[kDV + 1] + col) = __floats2bfloat162_rn(v2[0], v2[1]);
      } else {
        const long long at =
            ((static_cast<long long>(b) * p.Sk + key) * p.H + h) * D + col;
        *reinterpret_cast<float2*>(p.dk_part + at) = make_float2(k2[0], k2[1]);
        *reinterpret_cast<float2*>(p.dv_part + at) = make_float2(v2[0], v2[1]);
      }
    }
  }
}

// dk = scale * sum over the group's heads of dk_part, dv = the same sum of
// dv_part (no scale), in head order; four head dims a thread
// (blockIdx.y: 0 dk, 1 dv).  The partials are [B, Sk, H, D] fp32.
__global__ void flash_bwd_group_sum_kernel(const __grid_constant__ Params p,
                                           int D) {
  const int dk = blockIdx.y == 0;
  const float* part = dk ? p.dk_part : p.dv_part;
  const long long* st = p.st + (dk ? kDK : kDV);
  bf16* out = static_cast<bf16*>(dk ? p.dk : p.dv);
  const float sc = dk ? p.scale : 1.f;
  const int G = p.H / p.KV;
  const int n4 = D / 4;
  const long long total = static_cast<long long>(p.B) * p.Sk * p.KV * n4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(e % n4) * 4;
    long long rest = e / n4;
    const int kvh = static_cast<int>(rest % p.KV);
    rest /= p.KV;
    const int s = static_cast<int>(rest % p.Sk);
    const int b = static_cast<int>(rest / p.Sk);
    const float* src =
        part + ((static_cast<long long>(b) * p.Sk + s) * p.H + kvh * G) * D +
        d;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(src + g * D);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    bf16* o = out + b * st[0] + s * st[1] + kvh * st[2] + d;
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(sum.x * sc, sum.y * sc);
    *reinterpret_cast<__nv_bfloat162*>(o + 2) =
        __floats2bfloat162_rn(sum.z * sc, sum.w * sc);
  }
}

template <int D>
cudaError_t launch_bwd_tc(const Params& p, cudaStream_t stream) {
  constexpr size_t dq_smem = tc_dq_smem<D>();
  constexpr size_t dkdv_smem = tc_dkdv_smem<D>();
  constexpr int NWG = tc_dq_wgs<D>();
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
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map_4d(&tq, p.q, D, p.H, p.Sq, p.B, p.st + kQ, kTile) ||
      !tensor_map_4d(&tk, p.k, D, p.KV, p.Sk, p.B, p.st + kK, kTile) ||
      !tensor_map_4d(&tv, p.v, D, p.KV, p.Sk, p.B, p.st + kV, kTile) ||
      !tensor_map_4d(&tdo, p.dout, D, p.H, p.Sq, p.B, p.st + kDO, kTile))
    return cudaErrorInvalidValue;
  const float scale_log2 = p.scale * kLog2e;
  const int nqb = (p.Sq + NWG * kTile - 1) / (NWG * kTile);
  const int nkb = (p.Sk + tc_dkdv_keys<D>() - 1) / tc_dkdv_keys<D>();
  flash_bwd_dq_tc_kernel<D><<<dim3(p.B * p.H, nqb),
                              NWG * kThreads + kProducer, dq_smem,
                              stream>>>(tq, tk, tv, tdo, p, nqb, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<D><<<dim3(p.B * p.H, nkb),
                                2 * kThreads + kProducer, dkdv_smem,
                                stream>>>(tq, tk, tv, tdo, p, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.dk_part == nullptr) return err;
  const long long quads = static_cast<long long>(p.B) * p.Sk * p.KV * D / 4;
  const long long want = (quads + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_group_sum_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(p, D);
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
  Params p = {};
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
// then the forward's o and o_lo (contiguous [B, Sq, H, D] bf16; null at
// head dim 256, where the dQ launch walks its keys for D_i), the group's
// fp32 partials of dk and dv ([B, Sk, H, D] scratch; null when H == KV),
// the stream.  Every row of q, k, v, do and the gradients
// must start on a 16-byte boundary (the wrapper checks the pointers and
// strides).  Returns cudaErrorInvalidValue when a tensor map cannot be
// made.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D,
    const long long* strides, int causal, int window, float scale,
    const void* o, const void* o_lo, float* dk_part, float* dv_part,
    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                         H, KV, strides, causal, window, scale);
  p.o = o;
  p.o_lo = o_lo;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  if ((D <= kTcWideD && (o == nullptr || o_lo == nullptr)) ||
      (H != KV && (dk_part == nullptr || dv_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == KV) p.dk_part = p.dv_part = nullptr;
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
