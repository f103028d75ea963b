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
// Two paths, chosen by the wrapper from the dtype before the launch:
//
// bf16 (`tensor_core`, rows on the 16-byte grid): wgmma fed by TMA,
// warp-specialised.  `flash_fwd_tc_kernel` (serving's) and
// `flash_fwd_tc_lo_kernel` (training's, which also writes o_lo):
//   * One block per (batch, head, 128 queries), heaviest query tiles
//     first under the causal mask; 384 threads: a producer warpgroup,
//     one thread of which issues every TMA load (setmaxnreg gives it 24
//     registers a thread), and two consumer warpgroups of 64 query rows
//     each, the M of a wgmma (240 registers a thread).
//   * Q arrives once by TMA; K and V tiles of 64 keys come through a
//     ring of three stages, each guarded by a `full` and an `empty`
//     mbarrier.  Tiles sit in shared memory as TMA writes them for
//     wgmma: boxes of 64 rows by 64 head dims in the 128-byte swizzle,
//     through a 4-D map (head dim, head, sequence, batch) built in the C
//     entry: GQA (head h reads KV head h / (H / KV)) and q, k and v's
//     strides go into the map, which reads them in place; its zero fill
//     pads head dims 32 -> 64, 112 -> 128 and 224 -> 256 and the rows past Sq or
//     Sk.  A zero-filled key scores 0, not -1e30, so keys >= Sk are
//     masked like any other.
//   * S = Q K^T is an SS wgmma with fp32 accumulators, and the online
//     softmax stays in registers: scores scaled by scale * log2(e)
//     (ex2.approx), masked to -1e30 only on the key tiles the mask cuts
//     for some row of the warpgroup; tiles it hides from every row are
//     not computed.  P.V is an RS wgmma, n64 a head-dim chunk: p packed
//     to bf16 in registers (the accumulator layout is the A layout), V
//     read MN-major.  The LO kernel runs a second RS product on p -
//     bf16(p) into O_lo and writes o_lo = (O + O_lo) / l - o, so that o
//     + o_lo carries sum_k P V with fp32 P: the backward
//     (csrc/flash_attention_bwd.cu) takes D_i = rowsum(dO (o + o_lo))
//     from it.
//   * Registers decide the schedule (kernel constants below;
//     core/gpu_mapping.py's flash_tc_registers is the same rule).  A
//     consumer thread holds O in dp / 2 fp32 registers (dp the padded
//     head dims its warpgroup holds), a 64-key tile's scores in 32 and,
//     overlapped, p as bf16 in 16; O_lo and p's rest as much again.  120
//     of its 240 go to these; the rest is addresses, descriptors, m, l
//     and the softmax's temporaries, and past the 120 ptxas spills (128
//     spilled, 112 did not).  Serving's kernel up to head dim 128
//     overlaps: each tile's S is issued beside the last tile's P V and
//     its softmax runs under that product (80 and 112 registers).  At
//     224 and 256 its warpgroups split the head dim, each holding 128 of
//     O for the block's 64 query rows and each computing S (112,
//     overlapped; one warpgroup holding all of O needs 160 even in
//     series, 144 at 224 unpadded).  The o_lo
//     kernel runs S, the softmax and P V in series (96 registers), its
//     warpgroups split from head dim 112 up (160 unsplit).  ptxas
//     serialises every wgmma of a kernel whose in-flight operands do not
//     fit, and one under a branch it cannot prove uniform or after a
//     wait whose count depends on the data: the warpgroup index is
//     broadcast from lane 0, and the overlapped loop runs its first S
//     and its last P V outside the loop.  Serving's kernel and the o_lo
//     kernel run the same products and the same arithmetic in the same
//     order, whatever their schedules, so their o is the same bits.  128
//     keys fit nowhere (at head dim 64, 128 registers overlapped, and as
//     many in series with o_lo).
//   * No atomics: two runs give the same bits.
//
// fp32 (and bf16 off the 16-byte grid): `flash_fwd_kernel`, fp32 FMAs
// from shared memory (tensor cores cannot meet the 1e-5 fp32 policy).
// One block of 4 warps covers 64 queries of one (batch, head) and loops
// over 64-key tiles; two threads share a query row: each scores half of
// the tile's keys, the pair reduces the row max and sum with one
// shuffle, and each keeps half of the row's output dims.
//
// Head dims 32, 64, 112, 128, 224 (zamba2-7b-instruct's tied blocks)
// and 256 are compiled, one instantiation each; the backward
// (csrc/flash_attention_bwd.cu) is not compiled at 224.  Both paths:
//   * Given an `lse` pointer ([B, H, Sq] fp32), write each row's
//     log-sum-exp of its masked, scaled scores, m + log(l), for the
//     backward; with a null pointer they write nothing more, and o's
//     bits are the same either way.
//   * Mask ragged q and kv edges (the TPU kernel asserted that the tiles
//     divide S), store no row >= Sq, and skip tiles that the causal or
//     window mask hides for every row of the block.  A row whose first
//     visited tile is fully masked keeps m = -1e30 and collects exp(0)
//     terms, which alpha = exp(-1e30 - m) = 0 clears at its first real
//     tile, as in the reference; -inf would give NaN there.
//
// What bounds it on an H100 SXM: the two products, 4 D operations a
// visible (query, key) pair, at the 989 TFLOP/s bf16 tensor-core rate,
// against q, k, v and o at 3.35 TB/s.  At gemma3-12b's prefill (B 4,
// S 2048, H 16, KV 8, D 256) a causal layer takes 137 GFLOP (0.139 ms)
// and a local layer of window 1024 103 GFLOP (0.104 ms), against
// 0.060 ms for its 201 MB; at qwen2-0.5b's training shape (B 4, S 4096,
// H 14, KV 2, D 64, causal) 120 GFLOP (0.122 ms) against 0.033 ms: the
// tensor cores bound it, and only wgmma reaches their full rate.  At
// the serve prefill (B 4, S 256, H 14, KV 2, D 64) the bytes do (1.3 us
// against 0.5 us), and its 112 blocks fill 112 of the 132 SMs.  Each
// block reads Q once and each K/V tile once, and keeps scores, p and O
// out of device memory.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() right after its launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // fma: a block; tensor_core: a warpgroup
constexpr int kBQ = 64;        // fma: queries of a block
constexpr int kBK = 64;        // fma: keys of a kv tile
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
    case 224:
      return launch_d<T, 224>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    case 256:
      return launch_d<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                              window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ bf16, tensor cores
//
// Tiles sit in shared memory as TMA writes them for wgmma: boxes of 64
// rows by 64 head dims (8 KB: 128-byte rows in the 128-byte swizzle),
// loaded through a 4-D map (head dim, head, sequence, batch) whose edges
// fill zeros; a tile of 64 rows is its DP / 64 boxes one after another.
// Q.K^T reads Q and K K-major (over the head dim); P.V reads V MN-major
// (its head dims as N).

using bf16 = __nv_bfloat16;

constexpr int kWgRows = 64;       // query rows of a consumer warpgroup
constexpr int kTcKeys = 64;       // keys of a K/V tile
constexpr int kChunk = 64;        // head dims of a TMA box (128 bytes)
constexpr int kStages = 3;        // K/V ring stages
constexpr int kProducerRegs = 24;   // setmaxnreg: the producer warpgroup
constexpr int kConsumerRegs = 240;  // setmaxnreg: each consumer warpgroup
constexpr int kRegBudget = 120;   // of kConsumerRegs for the live tiles
constexpr int kSmemBytes = 232448;  // shared memory a block may use
constexpr int kTcThreads = 3 * kThreads;  // two consumers, a producer
constexpr int kBox = kWgRows * kChunk * 2;  // bytes of a box

template <int D>
__host__ __device__ constexpr int tc_chunks() {
  return (D + kChunk - 1) / kChunk;
}
// fp32 registers a consumer thread keeps live across a key tile whose
// warpgroup holds dp head dims of O: O (dp / 2), the tile's scores
// (kTcKeys / 2) and, overlapped (the next tile's S beside the last P V),
// p as the PV product's bf16 A operand (kTcKeys / 4); with o_lo a
// second O and a second p.
__host__ __device__ constexpr int tc_live_regs(int dp, bool lo,
                                               bool overlap) {
  return (dp / 2) * (lo ? 2 : 1) + kTcKeys / 2 +
         (overlap ? (kTcKeys / 4) * (lo ? 2 : 1) : 0);
}
// The schedule, from registers: the two warpgroups split the head dim
// (both on the block's 64 query rows, S computed by each) where a
// warpgroup holding all of it does not fit kRegBudget even in series;
// a warpgroup overlaps a tile's softmax with the last P V where its
// tiles fit that way.  ptxas serialises every wgmma of a kernel whose
// in-flight operands do not fit, and spills past the budget.
template <int D, bool LO>
__host__ __device__ constexpr bool tc_split() {
  return tc_live_regs(tc_chunks<D>() * kChunk, LO, false) > kRegBudget;
}
template <int D, bool LO>
__host__ __device__ constexpr bool tc_overlap() {
  return tc_live_regs(tc_chunks<D>() * kChunk / (tc_split<D, LO>() ? 2 : 1),
                      LO, true) <= kRegBudget;
}
// queries of a block: 64 a warpgroup, or 64 for the split pair
template <int D, bool LO>
__host__ __device__ constexpr int tc_rows() {
  return tc_split<D, LO>() ? kWgRows : 2 * kWgRows;
}
template <int D>
__host__ __device__ constexpr int tc_tile_bytes() {  // a K or a V tile
  return tc_chunks<D>() * kBox;
}
// 1 KB of alignment slack (a box starts on 1024 bytes), Q, the ring, a
// full and an empty barrier a stage and Q's
template <int D, bool LO>
__host__ __device__ constexpr size_t tc_smem() {
  return 1024 + static_cast<size_t>(tc_rows<D, LO>() / kWgRows) *
                    tc_tile_bytes<D>() +
         static_cast<size_t>(kStages) * 2 * tc_tile_bytes<D>() +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// Descriptors of a tile at shared address `base`: K-major (over the head
// dim) and MN-major (over the rows).  A step within the tile adds its
// byte offset / 16 to the start-address field.
__device__ __forceinline__ uint64_t desc_k(uint32_t base) {
  return wgmma_desc_sw128(base, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t base) {
  return wgmma_desc_sw128(base, kBox, 1024);
}
// K-major: the k16 step kk (32 bytes along a 128-byte row, then the next
// box).  MN-major: rows 16 kk .. 16 kk + 15 (2 KB on) of head-dim chunk
// c (the box c).
__device__ __forceinline__ uint64_t step_k(uint64_t d, int kk) {
  return d + (((kk >> 2) * kBox + (kk & 3) * 32) >> 4);
}
__device__ __forceinline__ uint64_t step_mn(uint64_t d, int kk, int c) {
  return d + ((c * kBox + kk * 2048) >> 4);
}

// 2^x by the SFU's approximation (relative error ~2^-22; 0 for x below
// -126, so exp2(-1e30 - m) is 0 and exp2(0) is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A key tile the warpgroup's rows do not see: its stage straight back
// to the producer.
__device__ __forceinline__ void skip_tile(int tid, int it, int ST,
                                          uint64_t* full, uint64_t* empty) {
  mbar_wait(&full[it % ST], (it / ST) & 1);
  if (tid == 0) mbar_arrive(&empty[it % ST]);
}

// After the wait for a P V product: its accumulators are read from here
// on, and its A operands were live until here (an in-flight wgmma reads
// them).
template <bool LO, int NP, int NL, int KCL>
__device__ __forceinline__ void fence_pv(float (&o)[NP][32],
                                         float (&olo)[NP][NL],
                                         uint32_t (&pa)[kTcKeys / 16][4],
                                         uint32_t (&pl)[KCL][4]) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    wgmma_fence_regs(o[pp]);
    if constexpr (LO) wgmma_fence_regs(olo[pp]);
  }
#pragma unroll
  for (int kc = 0; kc < kTcKeys / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      asm volatile("" : "+r"(pa[kc][e])::"memory");
      if constexpr (LO) asm volatile("" : "+r"(pl[kc][e])::"memory");
    }
}

// S (64 x 64, fp32) = the warpgroup's Q (descriptor qdesc) times the K
// tile at shared address k_base, over the DP head dims.
template <int DP>
__device__ __forceinline__ void scores(float (&s)[32], uint64_t qdesc,
                                       uint32_t k_base) {
  const uint64_t kdesc = desc_k(k_base);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64<0>(s, step_k(qdesc, kk), step_k(kdesc, kk), kk > 0);
}

// O += P V over the V tile at shared address v_base, head-dim chunks c0
// .. c0 + NP - 1, one n64 product a chunk and k16 step (LO: O_lo += (P -
// bf16(P)) V), P in registers.
template <bool LO, int NP, int NL, int KCL>
__device__ __forceinline__ void pv_product(float (&o)[NP][32],
                                           float (&olo)[NP][NL],
                                           uint32_t (&pa)[kTcKeys / 16][4],
                                           uint32_t (&pl)[KCL][4],
                                           uint32_t v_base, int c0) {
  const uint64_t vdesc = desc_mn(v_base);
#pragma unroll
  for (int kc = 0; kc < kTcKeys / 16; ++kc)
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const uint64_t db = step_mn(vdesc, kc, c0 + pp);
      wgmma_rs_n64<1>(o[pp], pa[kc], db);
      if constexpr (LO) wgmma_rs_n64<1>(olo[pp], pl[kc], db);
    }
}

struct FwdParams {
  bf16* o;
  float* lse;   // null: not written
  bf16* o_lo;   // the o_lo kernel's: o's layout
  int Sq, Sk, H, KV, nqb;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale_log2;
};

// The keys a thread's two rows see, as columns of a key tile less 2 t
// past the tile's first key: [first, last] (the tile's k0 subtracted
// at use), and the warpgroup's first row, for the tiles the mask cuts.
struct Mask {
  int last_lo, last_hi, first_lo, first_hi, qw0;
};

__device__ __forceinline__ Mask make_mask(const FwdParams& p, int qw0,
                                          int row_lo, int row_hi, int t) {
  Mask m;
  m.last_lo = min(p.Sk - 1, p.causal ? row_lo : p.Sk) - 2 * t;
  m.last_hi = min(p.Sk - 1, p.causal ? row_hi : p.Sk) - 2 * t;
  m.first_lo = p.window > 0 ? row_lo - p.window + 1 - 2 * t : -(1 << 30);
  m.first_hi = p.window > 0 ? row_hi - p.window + 1 - 2 * t : -(1 << 30);
  m.qw0 = qw0;
  return m;
}

// One key tile's scores (at key k0) through the online softmax: scaled
// to the log2 domain and, on a tile the mask cuts for some row of the
// warpgroup, masked to -1e30; the rows' maxima m, the factors alpha by
// which O must be rescaled, p = exp2(s - m) in place of s and the rows'
// sums l (this thread's share).  Element i of s is row g (+ 8 if i & 2),
// key k0 + 8 (i / 4) + 2 t + (i & 1).
__device__ __forceinline__ void online_softmax(
    float (&s)[32], const FwdParams& p, const Mask& mk, int k0, float& m_lo,
    float& m_hi, float& l_lo, float& l_hi, float& alpha_lo,
    float& alpha_hi) {
  const bool uncut =
      k0 + kTcKeys <= p.Sk && (!p.causal || k0 + kTcKeys - 1 <= mk.qw0) &&
      (p.window <= 0 || mk.qw0 + kWgRows - 1 - k0 < p.window);
  if (uncut) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], p.scale_log2);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + (i >> 2) * 8 + (i & 1);
      const bool ok = (i & 2) ? col <= mk.last_hi && col >= mk.first_hi
                              : col <= mk.last_lo && col >= mk.first_lo;
      s[i] = ok ? __fmul_rn(s[i], p.scale_log2) : kNegInf;
    }
  }
  float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the quad shares its rows
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo);
  const float mn_hi = fmaxf(m_hi, mx_hi);
  alpha_lo = ex2(m_lo - mn_lo);
  alpha_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    s[i] = ex2(s[i] - mn_lo);
    s[i + 1] = ex2(s[i + 1] - mn_lo);
    s[i + 2] = ex2(s[i + 2] - mn_hi);
    s[i + 3] = ex2(s[i + 3] - mn_hi);
    sum_lo += s[i] + s[i + 1];
    sum_hi += s[i + 2] + s[i + 3];
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
}

template <bool LO, int NP, int NL>
__device__ __forceinline__ void rescale(float (&o)[NP][32],
                                        float (&olo)[NP][NL], float alpha_lo,
                                        float alpha_hi) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = (i & 2) ? alpha_hi : alpha_lo;
      o[pp][i] *= a;
      if constexpr (LO) olo[pp][i] *= a;
    }
}

// p rounded to bf16 as the P V product's A operand (LO: and the
// rounding's rest)
template <bool LO, int KCL>
__device__ __forceinline__ void to_a_operand(uint32_t (&pa)[kTcKeys / 16][4],
                                             uint32_t (&pl)[KCL][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < kTcKeys / 16; ++kc) {
    if constexpr (LO)
      acc_to_a_split(pa[kc], pl[kc], s, kc);
    else
      acc_to_a(pa[kc], s, kc);
  }
}

// LO: the PV product also takes the part of each p that its bf16
// rounding drops (a second product into O_lo), and o_lo gets the fp32
// output (O + O_lo) / l less o; O, and so o and lse, are the same bits
// either way: the o_lo kernel and serving's run the same products, n64
// a chunk, and the same arithmetic in the same order, whatever their
// schedules.
template <int D, bool LO>
__device__ __forceinline__ void flash_fwd_tc_body(const CUtensorMap* tm_q,
                                                  const CUtensorMap* tm_k,
                                                  const CUtensorMap* tm_v,
                                                  const FwdParams& p) {
  constexpr int NC = tc_chunks<D>();
  constexpr int DP = NC * kChunk;            // head dims, padded
  constexpr bool SPLIT = tc_split<D, LO>();
  constexpr bool OVERLAP = tc_overlap<D, LO>();
  constexpr int ROWS = tc_rows<D, LO>();     // queries of the block
  constexpr int NP = SPLIT ? NC / 2 : NC;    // a warpgroup's O chunks
  constexpr int ST = kStages;
  constexpr int TILE = tc_tile_bytes<D>();
  static_assert(!SPLIT || NC % 2 == 0, "a split takes whole chunks");
  static_assert(tc_live_regs(NP * kChunk, LO, OVERLAP) <= kRegBudget,
                "registers");
  static_assert(tc_smem<D, LO>() <= kSmemBytes, "shared memory");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;                         // [ROWS / 64][NC]
  unsigned char* KVs = Qs + (ROWS / kWgRows) * TILE;  // [ST][K, V][NC]
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + ST * 2 * TILE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  // under the causal mask the last query tiles see the most keys
  const int qb = p.causal ? p.nqb - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qb * ROWS;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform: a wgmma under a branch it cannot prove uniform is
  // serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0);

  // key tiles that some row of the block can see
  const int q_last = min(q0 + ROWS, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin = (kv_begin / kTcKeys) * kTcKeys;
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTcKeys - 1) / kTcKeys : 0;
  // 64-row boxes of Q with a row below Sq
  const int nq = min(ROWS / kWgRows, (p.Sq - q0 + kWgRows - 1) / kWgRows);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: Q once, then the K/V ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kThreads) {
      mbar_arrive_expect_tx(qbar, nq * TILE);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load_4d(Qs + w * TILE + c * kBox, tm_q, c * kChunk, h,
                      q0 + w * kWgRows, b, qbar);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(&empty[st], ((it / ST) - 1) & 1);
        unsigned char* kt = KVs + st * 2 * TILE;
        const int k0 = kv_begin + it * kTcKeys;
        mbar_arrive_expect_tx(&full[st], 2 * TILE);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(kt + c * kBox, tm_k, c * kChunk, kvh, k0, b,
                      &full[st]);
          tma_load_4d(kt + TILE + c * kBox, tm_v, c * kChunk, kvh, k0, b,
                      &full[st]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int cw = wg;  // this consumer warpgroup
  const int tid = threadIdx.x - cw * kThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // its rows qw0 .. qw0 + 63, and its head-dim chunks c0 .. c0 + NP - 1
  const int qw0 = q0 + (SPLIT ? 0 : cw * kWgRows);
  const int c0 = SPLIT ? cw * NP : 0;
  const int row_lo = qw0 + warp * 16 + g;
  const int row_hi = row_lo + 8;

  // the keys this warpgroup's rows can see: [kb_w, ke_w)
  int kb_w = 0, ke_w = 0;
  if (qw0 < p.Sq) {
    ke_w = p.causal ? min(p.Sk, min(qw0 + kWgRows, p.Sq)) : p.Sk;
    kb_w = p.window > 0 ? max(0, qw0 - p.window + 1) : 0;
  }

  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sums
  float o[NP][32];
  float olo[NP][LO ? 32 : 1];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pp][i] = 0.f;
  if constexpr (LO) {
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) olo[pp][i] = 0.f;
  }

  const uint64_t qdesc =
      desc_k(smem_addr(Qs + (SPLIT ? 0 : cw * TILE)));
  const uint32_t kv0 = smem_addr(KVs);
  const Mask mask = make_mask(p, qw0, row_lo, row_hi, t);
  mbar_wait(qbar, 0);

  // The key tiles of the block are [0, ntiles); this warpgroup's rows see
  // [it0, it1).  A stage goes back to the producer once its P V is done,
  // a tile the warpgroup skips at once.
  //   OVERLAP: each tile issues S = Q K^T beside the previous tile's O +=
  // P V, so that the softmax of S runs while the tensor cores finish P V;
  // then O is rescaled and P rounded for the next round.  The first tile
  // runs S alone and the last P V runs alone, so that the loop's products
  // and waits are the same every round (the compiler serialises wgmma
  // around a wait it cannot place).
  //   In series: S, the softmax, P V, each tile.
  const int it0 =
      min(ntiles, kb_w > kv_begin ? (kb_w - kv_begin) / kTcKeys : 0);
  const int it1 =
      max(it0, min(ntiles, (ke_w - kv_begin + kTcKeys - 1) / kTcKeys));
  float s[32];
  uint32_t pa[kTcKeys / 16][4];
  uint32_t pl[LO ? kTcKeys / 16 : 1][4];
  float alpha_lo, alpha_hi;
  int it = 0;
  for (; it < it0; ++it) skip_tile(tid, it, ST, full, empty);
  if constexpr (OVERLAP) {
    if (it0 < it1) {
      int st = it % ST;
      mbar_wait(&full[st], (it / ST) & 1);
      wgmma_fence();
      scores<DP>(s, qdesc, kv0 + st * 2 * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      online_softmax(s, p, mask, kv_begin + it * kTcKeys, m_lo, m_hi, l_lo,
                     l_hi, alpha_lo, alpha_hi);
      to_a_operand<LO>(pa, pl, s);  // O is 0: nothing to rescale
      int pst = st;
      for (++it; it < it1; ++it) {
        st = it % ST;
        mbar_wait(&full[st], (it / ST) & 1);
        wgmma_fence();
        scores<DP>(s, qdesc, kv0 + st * 2 * TILE);
        wgmma_commit();
        pv_product<LO>(o, olo, pa, pl, kv0 + pst * 2 * TILE + TILE, c0);
        wgmma_commit();
        wgmma_wait<1>();  // S is done; P V may still run
        wgmma_fence_regs(s);
        online_softmax(s, p, mask, kv_begin + it * kTcKeys, m_lo, m_hi,
                       l_lo, l_hi, alpha_lo, alpha_hi);
        wgmma_wait<0>();
        fence_pv<LO>(o, olo, pa, pl);
        if (tid == 0) mbar_arrive(&empty[pst]);  // the stage back
        rescale<LO>(o, olo, alpha_lo, alpha_hi);
        to_a_operand<LO>(pa, pl, s);
        pst = st;
      }
      wgmma_fence();
      pv_product<LO>(o, olo, pa, pl, kv0 + pst * 2 * TILE + TILE, c0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_pv<LO>(o, olo, pa, pl);
      if (tid == 0) mbar_arrive(&empty[pst]);
    }
  } else {
    for (; it < it1; ++it) {
      const int st = it % ST;
      mbar_wait(&full[st], (it / ST) & 1);
      wgmma_fence();
      scores<DP>(s, qdesc, kv0 + st * 2 * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      online_softmax(s, p, mask, kv_begin + it * kTcKeys, m_lo, m_hi, l_lo,
                     l_hi, alpha_lo, alpha_hi);
      rescale<LO>(o, olo, alpha_lo, alpha_hi);
      to_a_operand<LO>(pa, pl, s);
      wgmma_fence();
      pv_product<LO>(o, olo, pa, pl, kv0 + st * 2 * TILE + TILE, c0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_pv<LO>(o, olo, pa, pl);
      if (tid == 0) mbar_arrive(&empty[st]);
    }
  }
  for (; it < ntiles; ++it) skip_tile(tid, it, ST, full, empty);

  if (qw0 >= p.Sq) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  const long long head = b * p.o_sb + h * p.o_sh + 2 * t;
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (c0 + pp) * kChunk + j * 8;
      if (col >= D) continue;  // head dims padded past D
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_hi : row_lo;
        if (row >= p.Sq) continue;
        const float dn = half ? d_hi : d_lo;
        const float x0 = o[pp][4 * j + 2 * half] / dn;
        const float x1 = o[pp][4 * j + 2 * half + 1] / dn;
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(x0, x1);
        const long long at = head + row * p.o_ss + col;
        *reinterpret_cast<__nv_bfloat162*>(p.o + at) = o2;
        if constexpr (LO)  // o_lo in o's layout
          *reinterpret_cast<__nv_bfloat162*>(p.o_lo + at) =
              __floats2bfloat162_rn(
                  (x0 - __low2float(o2)) + olo[pp][4 * j + 2 * half] / dn,
                  (x1 - __high2float(o2)) +
                      olo[pp][4 * j + 2 * half + 1] / dn);
      }
    }
  // m is in the log2 domain; a split pair's rows are written once
  if (p.lse != nullptr && t == 0 && (!SPLIT || cw == 0)) {
    float* lrow = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    if (row_lo < p.Sq) lrow[row_lo] = (m_lo + log2f(d_lo)) * kLn2;
    if (row_hi < p.Sq) lrow[row_hi] = (m_hi + log2f(d_hi)) * kLn2;
  }
}

// The kernel serving runs, and (LO) its o_lo form for training: one
// block of two consumer warpgroups and a producer warpgroup an SM.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ FwdParams p) {
  flash_fwd_tc_body<D, false>(&tm_q, &tm_k, &tm_v, p);
}
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_lo_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ FwdParams p) {
  flash_fwd_tc_body<D, true>(&tm_q, &tm_k, &tm_v, p);
}

template <int D, bool LO>
cudaError_t launch_tc_lo(const void* q, const void* k, const void* v, void* o,
                         float* lse, void* o_lo, int B, int Sq, int Sk, int H,
                         int KV, const long long* st, int causal, int window,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<D, LO>();
  constexpr int rows = tc_rows<D, LO>();
  auto kernel = flash_fwd_tc_kernel<D>;
  if constexpr (LO) kernel = flash_fwd_tc_lo_kernel<D>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // the maps are built here, at each launch (a captured graph keeps them
  // as the launch's parameters)
  CUtensorMap tq, tk, tv;
  if (!tensor_map_4d(&tq, q, D, H, Sq, B, st, kWgRows) ||
      !tensor_map_4d(&tk, k, D, KV, Sk, B, st + 3, kTcKeys) ||
      !tensor_map_4d(&tv, v, D, KV, Sk, B, st + 6, kTcKeys))
    return cudaErrorInvalidValue;
  FwdParams p;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.o_lo = static_cast<bf16*>(o_lo);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.nqb = (Sq + rows - 1) / rows;
  p.o_sb = st[9];
  p.o_ss = st[10];
  p.o_sh = st[11];
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  kernel<<<dim3(B * H, p.nqb), kTcThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// o_lo only up to head dim kLoMaxD (at 256 a second O would not fit
// beside the first); null launches the kernel serving runs.
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
    case 224:
      err = launch_tc<224>(q, k, v, o, lse, o_lo, B, Sq, Sk, H, KV,
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
