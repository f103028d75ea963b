// spm_matmul for Hopper (sm_90a): C = A @ B with fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spm_matmul/spm_matmul.py
// (`spm_matmul`, bodies `_kernel_2d` and `_kernel_3d`).  It computes
// what that kernel computes, not its grid block by block: the TPU's
// sequential K grid axis and its fp32 VMEM accumulator become a loop
// over K inside a block (and, for narrow problems, a K split across the
// blocks of a thread-block cluster), with the accumulator in registers.
//
// Three kernels; the wrapper (kernels/spm_matmul/ops.py) picks one from
// dtype, alignment, M and the B layout before the launch:
//
//   * `splitk_decode_kernel` (bf16, M <= 16, B as [K, N], rows 16-byte
//     aligned): decode.  Bytes bound it (each weight read once per step;
//     qwen2-0.5b's 0.99 GB take >= 0.29 ms at 3.35 TB/s).  The weights,
//     streamed by a TMA-fed mbarrier ring, are wgmma's 64-row operand and
//     the tokens its N (8 or 16); a cluster of up to 8 blocks splits K so
//     that the grid fills the SMs, and reduces the fp32 partials through
//     distributed shared memory in rank order.  Notes at the kernel.
//   * `wgmma_gemm_kernel` (bf16, M >= 64, rows 16-byte aligned): prefill.
//     Tensor-core operations bound the wide products; a TMA-fed 4-stage
//     mbarrier ring feeds two consumer warpgroups running wgmma on a
//     128 x 128 tile.  Narrow problems split K over a cluster the same
//     way.  Notes at the kernel.
//   * `spm_matmul_kernel` (everything else: fp32, bf16 rows that are not
//     16-byte aligned, 16 < M < 64, and the transposed-B decode logits):
//     one block owns one [BM, BN] tile and loops over K chunks of `bkc`
//     columns (the plan's `bk`; bk == 0 stages the whole K when it fits)
//     brought in by cp.async, double buffered with `stages` = 2.  bf16
//     goes through mma.sync m16n8k16; fp32 through fp32 FMAs with the
//     same fragment ownership.  M tiles are innermost (blockIdx.x), so
//     neighbouring blocks read the same B column block (the reference's
//     B-stationary order, as L2 reuse).  Every edge is masked; decode's
//     rows past M are zero-filled and never stored.  At the decode
//     logits (M = 4, B the [V, d] table read in place through trans_b)
//     it reaches ~71 % of the byte bound.
//
// B is read either as [K, N] (weights) or, with trans_b, as [N, K] (the
// tied embedding table read in place for the logits: no transposed copy).
// No path uses atomics: the same inputs give the same bits.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() right after its launch.

#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda.h>

#include <unordered_map>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // shared-memory row padding, in elements

// Copy a [rows, bkc] slab of a row-major matrix G (rows r0.., columns
// k0..) into S (row stride lds), zero-filling past R rows and K columns.
// Whole 16-byte pieces go by cp.async; edge pieces by plain stores.
template <typename T>
__device__ __forceinline__ void load_rows(T* S, int lds, const T* G,
                                          long long ldg, int r0, int R,
                                          int k0, int K, int rows, int bkc,
                                          int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = bkc / VEC;
  const int total = rows * cpr;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * VEC;
    const int gr = r0 + r;
    const int gk = k0 + c;
    T* dst = S + r * lds + c;
    if (vec && gr < R && gk + VEC <= K) {
      cp_async16(dst, G + gr * ldg + gk);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dst[j] = (gr < R && gk + j < K) ? G[gr * ldg + gk + j]
                                        : from_f32<T>(0.f);
      }
    }
  }
}

// Copy a [bkc, cols] slab of row-major B [K, N] (rows k0.., columns n0..)
// into S in the same [k][n] layout (row stride lds), zero-filled.
template <typename T>
__device__ __forceinline__ void load_kn(T* S, int lds, const T* G,
                                        long long ldg, int n0, int N, int k0,
                                        int K, int cols, int bkc, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = cols / VEC;
  const int total = bkc * cpr;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int k = idx / cpr;
    const int n = (idx - k * cpr) * VEC;
    const int gk = k0 + k;
    const int gn = n0 + n;
    T* dst = S + k * lds + n;
    if (vec && gk < K && gn + VEC <= N) {
      cp_async16(dst, G + gk * ldg + gn);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dst[j] = (gk < K && gn + j < N) ? G[gk * ldg + gn + j]
                                        : from_f32<T>(0.f);
      }
    }
  }
}

// One k16 step of a warp's [MT*16, NT*8] tile.  Fragment ownership is
// mma.sync's: lane (g = lane/4, t = lane%4) owns rows g and g+8 and
// columns 2t, 2t+1 of every 16x8 output tile.
template <int MT, int NT>
__device__ __forceinline__ void warp_step(float (&acc)[MT][NT][4],
                                          const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Bs, int ldb,
                                          int trans_b, int kk, int wm0,
                                          int wn0, int g, int t) {
  uint32_t a[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const __nv_bfloat16* p = As + (wm0 + i * 16 + g) * lda + kk + 2 * t;
    a[i][0] = *reinterpret_cast<const uint32_t*>(p);
    a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
    a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = wn0 + j * 8 + g;
    uint32_t b0, b1;
    if (trans_b) {  // Bs is [n][k]
      const __nv_bfloat16* q = Bs + n * ldb + kk + 2 * t;
      b0 = *reinterpret_cast<const uint32_t*>(q);
      b1 = *reinterpret_cast<const uint32_t*>(q + 8);
    } else {  // Bs is [k][n]
      const __nv_bfloat16* q = Bs + (kk + 2 * t) * ldb + n;
      b0 = pack_bf16(q[0], q[ldb]);
      b1 = pack_bf16(q[8 * ldb], q[9 * ldb]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void warp_step(float (&acc)[MT][NT][4],
                                          const float* As, int lda,
                                          const float* Bs, int ldb,
                                          int trans_b, int kk, int wm0,
                                          int wn0, int g, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* a_lo = As + (wm0 + i * 16 + g) * lda + kk;
    const float* a_hi = a_lo + 8 * lda;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn0 + j * 8 + 2 * t;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float b0, b1;
        if (trans_b) {
          b0 = Bs[n * ldb + kk + k];
          b1 = Bs[(n + 1) * ldb + kk + k];
        } else {
          b0 = Bs[(kk + k) * ldb + n];
          b1 = Bs[(kk + k) * ldb + n + 1];
        }
        acc[i][j][0] = fmaf(a_lo[k], b0, acc[i][j][0]);
        acc[i][j][1] = fmaf(a_lo[k], b1, acc[i][j][1]);
        acc[i][j][2] = fmaf(a_hi[k], b0, acc[i][j][2]);
        acc[i][j][3] = fmaf(a_hi[k], b1, acc[i][j][3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_out(void* C, int out_f32, int M, int N,
                                          int row, int col, float v) {
  if (row >= M || col >= N) return;
  const long long idx = static_cast<long long>(row) * N + col;
  if (out_f32) {
    static_cast<float*>(C)[idx] = v;
  } else {
    static_cast<T*>(C)[idx] = from_f32<T>(v);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    spm_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      void* __restrict__ C, int M, int N, int K,
                      long long lda, long long ldb, int trans_b, int out_f32,
                      int bkc, int stages, int vec) {
  constexpr int WARPS_M = (BM == 16) ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "tile does not split");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda_s = bkc + kPad;
  const int ldb_s = trans_b ? bkc + kPad : BN + kPad;
  // per stage: A slab [BM][bkc + kPad], then B slab [BN][bkc + kPad]
  // (trans_b) or [bkc][BN + kPad]
  const int stage_elems = BM * lda_s + (trans_b ? BN : bkc) * ldb_s;
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto load_chunk = [&](int c, int buf) {
    T* As = smem + buf * stage_elems;
    T* Bs = As + BM * lda_s;
    const int k0 = c * bkc;
    load_rows<T>(As, lda_s, A, lda, m0, M, k0, K, BM, bkc, vec);
    if (trans_b) {
      load_rows<T>(Bs, ldb_s, B, ldb, n0, N, k0, K, BN, bkc, vec);
    } else {
      load_kn<T>(Bs, ldb_s, B, ldb, n0, N, k0, K, BN, bkc, vec);
    }
    cp_async_commit();
  };

  const int nchunks = (K + bkc - 1) / bkc;
  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = (stages == 2) ? (c & 1) : 0;
    if (stages == 2 && c + 1 < nchunks) {
      load_chunk(c + 1, buf ^ 1);  // overlaps this chunk's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* As = smem + buf * stage_elems;
    const T* Bs = As + BM * lda_s;
    // the zero-filled tail past K adds nothing: stop at the last k16 step
    const int kend = min(bkc, ((K - c * bkc + 15) / 16) * 16);
    for (int kk = 0; kk < kend; kk += 16) {
      warp_step<MT, NT>(acc, As, lda_s, Bs, ldb_s, trans_b, kk, wm0, wn0, g,
                        t);
    }
    __syncthreads();
    if (stages == 1 && c + 1 < nchunks) load_chunk(c + 1, 0);
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm0 + i * 16 + g;
      const int col = n0 + wn0 + j * 8 + 2 * t;
      store_out<T>(C, out_f32, M, N, row, col, acc[i][j][0]);
      store_out<T>(C, out_f32, M, N, row, col + 1, acc[i][j][1]);
      store_out<T>(C, out_f32, M, N, row + 8, col, acc[i][j][2]);
      store_out<T>(C, out_f32, M, N, row + 8, col + 1, acc[i][j][3]);
    }
  }
}

template <typename T, int BM, int BN>
cudaError_t launch_tile(const void* a, const void* b, void* c, int m, int n,
                        int k, long long lda, long long ldb, int trans_b,
                        int out_f32, int bkc, int stages, int vec,
                        cudaStream_t stream) {
  const int lda_s = bkc + kPad;
  const int b_elems = trans_b ? BN * (bkc + kPad) : bkc * (BN + kPad);
  const size_t smem =
      stages * (static_cast<size_t>(BM) * lda_s + b_elems) * sizeof(T);
  // opt in above 48 KB once per instantiation and size (a host call the
  // decode loop would otherwise pay on every launch)
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        spm_matmul_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  spm_matmul_kernel<T, BM, BN><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, m, n, k, lda,
      ldb, trans_b, out_f32, bkc, stages, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, void* c, int m, int n,
                         int k, long long lda, long long ldb, int trans_b,
                         int out_f32, int bm, int bn, int bkc, int stages,
                         int vec, cudaStream_t s) {
#define SPM_CASE(BM_, BN_)                                                  \
  if (bm == BM_ && bn == BN_)                                               \
    return launch_tile<T, BM_, BN_>(a, b, c, m, n, k, lda, ldb, trans_b,    \
                                    out_f32, bkc, stages, vec, s);
  // the tiles the wrapper's plans can select (ops.py TILES): decode
  // 16x64; small or narrow problems 32x64, 32x128, 64x64; prefill
  // 64x128; the reference's conformance plans 64x128 and 128x128
  SPM_CASE(16, 64)
  SPM_CASE(32, 64)
  SPM_CASE(32, 128)
  SPM_CASE(64, 64)
  SPM_CASE(64, 128)
  SPM_CASE(128, 128)
#undef SPM_CASE
  return cudaErrorInvalidValue;
}


// ============================================== decode: cluster split-K
//
// M <= 16, bf16, B as [K, N].  Bytes bound it: each weight is read once
// per step (pixtral-12b's 22 GB of weights take >= 6.5 ms a step at 3.35
// TB/s), and at this M the products are a sliver of the tensor cores'
// rate.  The operands are swapped so that the weights fill wgmma's
// 64-row operand: a block computes C^T[64 columns, NT] = B^T[64, K
// slice] * A^T[K slice, NT] as wgmma m64nNTk16, NT = 8 for M <= 8 and 16
// for M <= 16, A's rows past M zeros in shared memory and never stored.
// B's tile is read MN-major, as the [K, N] weight lies (64 columns x 64 K
// rows a stage, no transposed copy); A's [NT, 64] box K-major.  Both come
// by TMA in the 128-byte swizzle the descriptors name, zero-filled past
// K, N and M.  One producer warp keeps a ring of kSkStages stages in
// flight, each guarded by a `full` mbarrier (the bytes landed) and an
// `empty` one (the consumer is done with it), while one consumer
// warpgroup runs wgmma on the stages that have landed: the loads never
// wait on the arithmetic.  Blocks are small (160 threads, ~62 KB), so
// several share an SM.
//
// A cluster of `splits` blocks (cluster dims (splits, 1, 1)) owns one
// 64-column tile; block `rank` sums K steps [rank * kb_per, ...), whole
// 64-deep steps (the wrapper picks the fewest splits, at most 8, that
// give each of the 132 SMs a block).  Each block parks its fp32 partial
// in its drained ring; after a cluster barrier each block sums a share of
// the tile over the cluster's partials in rank order through distributed
// shared memory and stores it once: one launch, no atomics, the same bits
// from the same inputs.  One split is launched without a cluster and
// stores its own partial.

using bf16 = __nv_bfloat16;

constexpr int kSkBN = 64;        // a cluster's columns: wgmma's 64 rows
constexpr int kSkBK = 64;        // K rows of a stage: 128 bytes of bf16
constexpr int kSkStages = 6;     // TMA ring depth
constexpr int kSkThreads = 160;  // a consumer warpgroup, a producer warp
constexpr int kSkWBytes = kSkBN * kSkBK * 2;  // B's tile of a stage, 8 KB

// a stage: B's tile, then A's [NT][kSkBK] box (1024-byte aligned both)
template <int NT>
constexpr int kSkStageBytes = kSkWBytes + NT * kSkBK * 2;
// 1 KB of alignment slack, the stages, a full and an empty barrier each
template <int NT>
constexpr size_t kSkSmem =
    1024 + static_cast<size_t>(kSkStages) * kSkStageBytes<NT> +
    16 * kSkStages;
static_assert(16 * kSkBN * 4 <= kSkStages * kSkWBytes,
              "the block's fp32 partial reuses the stages");

template <typename T>
__device__ __forceinline__ void store_one(void* C, int out_f32, long long idx,
                                          float v) {
  if (out_f32) {
    static_cast<float*>(C)[idx] = v;
  } else {
    static_cast<T*>(C)[idx] = from_f32<T>(v);
  }
}

// d (64 x NT, fp32) += A (64 x 16, MN-major: B's tile as it lies) * B
// (16 x NT, K-major: A's rows), both from shared memory.  Each thread of
// the warpgroup holds NT / 2 of d's values.
__device__ __forceinline__ void wgmma_sk(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_sk(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <int NT>
__global__ void __launch_bounds__(kSkThreads)
    splitk_decode_kernel(const __grid_constant__ CUtensorMap tmB,
                         const __grid_constant__ CUtensorMap tmA,
                         void* __restrict__ C, int M, int N, int K,
                         int out_f32, int kb_per) {
  constexpr int kStage = kSkStageBytes<NT>;
  extern __shared__ __align__(16) unsigned char sk_smem_raw[];
  unsigned char* smem =
      sk_smem_raw + ((1024 - (smem_addr(sk_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSkStages * kStage);
  uint64_t* empty = full + kSkStages;

  // the cluster is (splits, 1, 1) and the grid's x extent is `splits`
  const int rank = blockIdx.x;
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * kSkBN;
  const int kb0 = rank * kb_per;
  const int nkb = max(0, min((K + kSkBK - 1) / kSkBK, kb0 + kb_per) - kb0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSkStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {  // the producer
      for (int i = 0; i < nkb; ++i) {
        const int st = i % kSkStages;
        if (i >= kSkStages) mbar_wait(&empty[st], ((i / kSkStages) - 1) & 1);
        unsigned char* sb = smem + st * kStage;
        const int kc = (kb0 + i) * kSkBK;
        mbar_arrive_expect_tx(&full[st], kStage);
        tma_load_2d(sb, &tmB, n0, kc, &full[st]);
        tma_load_2d(sb + kSkWBytes, &tmA, kc, 0, &full[st]);
      }
    }
  } else {
    for (int i = 0; i < nkb; ++i) {
      const int st = i % kSkStages;
      mbar_wait(&full[st], (i / kSkStages) & 1);
      const uint32_t sb = smem_addr(smem + st * kStage);
      const uint32_t sa = sb + kSkWBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSkBK / 16; ++kk) {
        // B's tile, MN-major: the k16 step is 16 rows of 128 bytes, 8-row
        // groups 1024 bytes apart.  A's box, K-major: the k16 step is 32
        // bytes along the swizzled row, 8-row groups 1024 bytes apart.
        wgmma_sk(acc, wgmma_desc_sw128(sb + kk * 2048, kSkWBytes, 1024),
                 wgmma_desc_sw128(sa + kk * 32, 16, 1024));
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's are
      // done, so its stage goes back to the producer
      wgmma_wait<1>();
      if (i > 0 && threadIdx.x == 0)
        mbar_arrive(&empty[(i - 1) % kSkStages]);
    }
    wgmma_wait<0>();
  }

  // The partial goes to the drained stages as [NT][kSkBN] (token-major),
  // so the stores below run along N.
  __syncthreads();  // every stage's products are done
  float* part = reinterpret_cast<float*>(smem);
  if (threadIdx.x < 128) {
    // accumulator fragment: warp w holds rows (columns of C) 16w..16w+15;
    // acc[4j + e] is row lane/4 (+8 for e >= 2), column (row of C)
    // 8j + 2(lane%4) (+1 for odd e)
    const int lane = threadIdx.x & 31;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int t = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float* p = part + (8 * j + t) * kSkBN + r;
      p[0] = acc[4 * j];
      p[kSkBN] = acc[4 * j + 1];
      p[8] = acc[4 * j + 2];
      p[kSkBN + 8] = acc[4 * j + 3];
    }
  }
  const int E = M * kSkBN;  // rows past M are never stored
  if (splits == 1) {  // no cluster: the block's partial is the output
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kSkThreads) {
      const int row = e / kSkBN;
      const int col = n0 + (e - row * kSkBN);
      if (col < N)
        store_one<bf16>(C, out_f32, static_cast<long long>(row) * N + col,
                        part[e]);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the cluster is written
  const int per = (E + splits - 1) / splits;
  const int e_end = min(E, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kSkThreads) {
    float v = 0.f;
    for (int q = 0; q < splits; ++q) v += cluster.map_shared_rank(part, q)[e];
    const int row = e / kSkBN;
    const int col = n0 + (e - row * kSkBN);
    if (col < N)
      store_one<bf16>(C, out_f32, static_cast<long long>(row) * N + col, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int NT>
cudaError_t launch_splitk_nt(const CUtensorMap& mb, const CUtensorMap& ma,
                             void* c, int m, int n, int k, int out_f32,
                             int splits, int kb_per, cudaStream_t stream) {
  constexpr size_t smem = kSkSmem<NT>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        splitk_decode_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + kSkBN - 1) / kSkBN, 1);
  cfg.blockDim = dim3(kSkThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, splitk_decode_kernel<NT>, mb, ma, c, m, n,
                            k, out_f32, kb_per);
}

// =================================================== prefill: TMA + wgmma
//
// M >= 64, bf16.  Tensor-core operations bound the wide products.  A
// block of three warpgroups owns a 128 x 128 output tile: warpgroup 2's
// first thread is the producer, keeping a ring of four 64-deep stages
// (A box 128 x 64 and B box 64 x 128, 32 KB a stage) filled by TMA, each
// stage guarded by a `full` mbarrier (the bytes landed) and an `empty`
// one (both consumers are done with it); warpgroups 0 and 1 each run
// wgmma m64n128k16 on 64 of the tile's rows, fp32 accumulators in
// registers.  TMA writes the 128-byte swizzle that the wgmma descriptors
// name; A is K-major; B is K-major when given as [N, K] (trans_b) and
// MN-major ([K, N], the transpose bit) otherwise.  Ragged M, N and K
// edges are TMA's zero fill and masked stores.
//
// Narrow problems give too few tiles for the 132 SMs: the grid's z axis
// then splits K over a cluster of `splits` blocks in whole 64-deep
// steps, each block parks its fp32 partial in the (drained) stages, and
// the cluster sums them in rank order through distributed shared memory,
// as the decode path does.

constexpr int kWgBM = 128;
constexpr int kWgBN = 128;
constexpr int kWgBK = 64;  // 128 bytes of bf16: one swizzle row
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;
constexpr int kWgABytes = kWgBM * kWgBK * 2;
constexpr int kWgBBytes = kWgBN * kWgBK * 2;
constexpr int kWgStageBytes = kWgABytes + kWgBBytes;
constexpr int kWgPartLd = kWgBN + 8;  // fp32 tile row stride (epilogue)
// 1 KB of alignment slack (the swizzle atoms are 1024-byte aligned), the
// stages, then a full and an empty barrier per stage
constexpr size_t kWgSmem =
    1024 + static_cast<size_t>(kWgStages) * kWgStageBytes + 16 * kWgStages;
static_assert(kWgBM * kWgPartLd * 4 <= kWgStages * kWgStageBytes,
              "the epilogue's fp32 tile reuses the stages");

// d (64 x 128, fp32) += A (64 x 16, K-major) * B (16 x 128) from shared
// memory; TB = 1 reads B MN-major (N contiguous: the transpose bit),
// TB = 0 K-major.  Each thread of the warpgroup holds 64 of d's values.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// Four consecutive outputs of row `row` from column `col`: one 16-byte
// (fp32) or 8-byte (bf16) store when they are inside N and aligned.
__device__ __forceinline__ void store_quad(void* C, int out_f32, int M, int N,
                                           int row, int col, float4 v) {
  if (row >= M || col >= N) return;
  const long long idx = static_cast<long long>(row) * N + col;
  if (col + 3 < N && (idx & 3) == 0) {
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(C) + idx) = v;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(C) + idx) = u;
    }
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && col + i < N; ++i)
    store_one<bf16>(C, out_f32, idx + i, f[i]);
}

template <int TRANS_B>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB,
                      void* __restrict__ C, int M, int N, int K, int out_f32,
                      int kb_per) {
  extern __shared__ __align__(16) unsigned char wg_smem_raw[];
  unsigned char* smem =
      wg_smem_raw + ((1024 - (smem_addr(wg_smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * kWgBM;
  const int n0 = blockIdx.y * kWgBN;
  const int nkb_all = (K + kWgBK - 1) / kWgBK;
  const int kb0 = blockIdx.z * kb_per;
  const int nkb = max(0, min(nkb_all, kb0 + kb_per) - kb0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (wg == 2) {
    if (threadIdx.x == 256) {  // the producer
      for (int i = 0; i < nkb; ++i) {
        const int st = i % kWgStages;
        if (i >= kWgStages) mbar_wait(&empty[st], ((i / kWgStages) - 1) & 1);
        unsigned char* sa = smem + st * kWgStageBytes;
        unsigned char* sb = sa + kWgABytes;
        const int kc = (kb0 + i) * kWgBK;
        mbar_arrive_expect_tx(&full[st], kWgStageBytes);
        tma_load_2d(sa, &tmA, kc, m0, &full[st]);
        if (TRANS_B) {
          tma_load_2d(sb, &tmB, kc, n0, &full[st]);
        } else {  // two 64-column boxes, 8 KB each
          tma_load_2d(sb, &tmB, n0, kc, &full[st]);
          tma_load_2d(sb + kWgBBytes / 2, &tmB, n0 + 64, kc, &full[st]);
        }
      }
    }
  } else {
    for (int i = 0; i < nkb; ++i) {
      const int st = i % kWgStages;
      mbar_wait(&full[st], (i / kWgStages) & 1);
      // this warpgroup's 64 rows of A: 64 swizzled 128-byte rows further
      const uint32_t sa =
          smem_addr(smem + st * kWgStageBytes) + wg * 64 * 128;
      const uint32_t sb = smem_addr(smem + st * kWgStageBytes + kWgABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // K-major: the k16 step is 32 bytes along the swizzled row, 8-row
        // groups 1024 bytes apart.  MN-major B: the k16 step is 16 rows
        // of 128 bytes, 8-row groups 1024 bytes apart, the second
        // 64-column box 8 KB on.
        const uint64_t da = wgmma_desc_sw128(sa + kk * 32, 16, 1024);
        const uint64_t db =
            TRANS_B ? wgmma_desc_sw128(sb + kk * 32, 16, 1024)
                    : wgmma_desc_sw128(sb + kk * 2048, kWgBBytes / 2, 1024);
        wgmma_m64n128k16<TRANS_B ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's are
      // done, so its stage goes back to the producer
      wgmma_wait<1>();
      if (i > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(i - 1) % kWgStages]);
    }
    wgmma_wait<0>();
  }

  // The epilogue goes through shared memory: both consumers park their
  // fp32 tile in the drained stages, then every thread stores 4 columns
  // at a time along the rows (coalesced), summing the cluster's
  // partials in rank order when K is split.
  __syncthreads();  // both consumers are done with the stages
  float* part = reinterpret_cast<float*>(smem);  // [kWgBM][kWgPartLd]
  if (wg < 2) {
    // accumulator fragment: warp w of the warpgroup holds rows
    // 16w..16w+15; acc[4j + e] is row lane/4 (+8 for e >= 2), column
    // 8j + 2(lane%4) (+1 for odd e)
    const int lane = threadIdx.x & 31;
    const int r = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float* p = part + r * kWgPartLd + 8 * j + c;
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * kWgPartLd) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  const int splits = gridDim.z;  // the cluster is (1, 1, splits)
  int row0 = 0, rows = kWgBM;
  if (splits == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // every partial of the cluster is written
    const int per = (kWgBM + splits - 1) / splits;
    row0 = blockIdx.z * per;
    rows = max(0, min(kWgBM, row0 + per) - row0);
  }
  for (int e = threadIdx.x; e < rows * (kWgBN / 4); e += kWgThreads) {
    const int r = row0 + e / (kWgBN / 4);
    const int c = 4 * (e % (kWgBN / 4));
    float4 v = *reinterpret_cast<const float4*>(part + r * kWgPartLd + c);
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < splits; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + r * kWgPartLd + c);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    store_quad(C, out_f32, M, N, m0 + r, n0 + c, v);
  }
  if (splits > 1)
    cg::this_cluster().sync();  // no block leaves while another reads
}

// Tensor maps cached by pointer, shape, stride and box: the eager
// prefill asks for the same weights (384 of them in rwkv6-1.6b) and
// activation buffers every call.  Cleared when it passes kMapCap.
struct MapKey {
  const void* ptr;
  uint64_t d0, d1, stride;
  uint32_t b0, b1;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && stride == o.stride &&
           b0 == o.b0 && b1 == o.b1;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = reinterpret_cast<uint64_t>(k.ptr);
    for (uint64_t v : {k.d0, k.d1, k.stride, uint64_t(k.b0) << 32 | k.b1})
      h = (h ^ v) * 0x100000001b3ull;
    return static_cast<size_t>(h);
  }
};
constexpr size_t kMapCap = 4096;

// A 2-D bf16 map of a row-major matrix with `d1` rows of `d0` elements
// (row stride `stride` bytes), box b0 x b1, 128-byte swizzle.
bool tensor_map(CUtensorMap* out, const void* ptr, uint64_t d0, uint64_t d1,
                uint64_t stride, uint32_t b0, uint32_t b1) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, d0, d1, stride, b0, b1};
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res =
      fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return false;
  if (cache.size() >= kMapCap) cache.clear();
  cache.emplace(key, *out);
  return true;
}

template <int TB>
cudaError_t launch_wgmma_tb(const CUtensorMap& ma, const CUtensorMap& mb,
                            void* c, int m, int n, int k, int out_f32,
                            int splits, int kb_per, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        wgmma_gemm_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kWgSmem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + kWgBM - 1) / kWgBM, (n + kWgBN - 1) / kWgBN, splits);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, wgmma_gemm_kernel<TB>, ma, mb, c, m, n, k,
                            out_f32, kb_per);
}

}  // namespace

// in_bf16: 1 = bf16 A and B, 0 = fp32.  out_f32: 1 = fp32 C, 0 = C in the
// input type.  bkc: staged K chunk, a multiple of 16.  stages: 1 or 2
// shared-memory buffers.  vec: 1 when every row of A and B starts on a
// 16-byte boundary.
extern "C" int spm_matmul_launch(const void* a, const void* b, void* c, int m,
                                 int n, int k, long long lda, long long ldb,
                                 int trans_b, int in_bf16, int out_f32,
                                 int bm, int bn, int bkc, int stages, int vec,
                                 void* stream) {
  if (bkc <= 0 || bkc % 16 != 0 || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      in_bf16 ? launch_typed<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb,
                                            trans_b, out_f32, bm, bn, bkc,
                                            stages, vec, s)
              : launch_typed<float>(a, b, c, m, n, k, lda, ldb, trans_b,
                                    out_f32, bm, bn, bkc, stages, vec, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Decode path: M <= 16, bf16 A and B, B as [K, N] with N a multiple of 8,
// every row 16-byte aligned.  `splits` blocks (1..8, one cluster) per
// 64-column tile, each over `ks` rows of K (a multiple of 64; the last
// may be shorter).  out_f32: 1 = fp32 C, 0 = bf16 C.  Returns
// cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int spm_matmul_splitk_launch(const void* a, const void* b, void* c,
                                        int m, int n, int k, long long lda,
                                        long long ldb, int out_f32, int splits,
                                        int ks, void* stream) {
  if (m < 1 || m > 16 || splits < 1 || splits > 8 || ks <= 0 || ks % kSkBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = m <= 8 ? 8 : 16;  // A's rows as wgmma's N
  // one row of A has no stride to speak of (a view's may read 0)
  const long long ra = m > 1 ? lda : (k + 7) / 8 * 8;
  CUtensorMap mb, ma;
  const uint64_t es = sizeof(bf16);
  if (!tensor_map(&mb, b, n, k, ldb * es, kSkBN, kSkBK) ||
      !tensor_map(&ma, a, k, m, ra * es, kSkBK, nt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      nt == 8 ? launch_splitk_nt<8>(mb, ma, c, m, n, k, out_f32, splits,
                                    ks / kSkBK, s)
              : launch_splitk_nt<16>(mb, ma, c, m, n, k, out_f32, splits,
                                     ks / kSkBK, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Prefill path: bf16 A [M, K] and B ([K, N], or [N, K] with trans_b),
// every row 16-byte aligned.  `splits` blocks (1..8, one cluster) per
// 128 x 128 tile, each over `kb_per` 64-deep steps of K.  Returns
// cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int spm_matmul_wgmma_launch(const void* a, const void* b, void* c,
                                       int m, int n, int k, long long lda,
                                       long long ldb, int trans_b, int out_f32,
                                       int splits, int kb_per, void* stream) {
  if (splits < 1 || splits > 8 || kb_per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  const uint64_t es = sizeof(bf16);
  bool ok = tensor_map(&ma, a, k, m, lda * es, kWgBK, kWgBM);
  ok = ok && (trans_b ? tensor_map(&mb, b, k, n, ldb * es, kWgBK, kWgBN)
                      : tensor_map(&mb, b, n, k, ldb * es, 64, kWgBK));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      trans_b ? launch_wgmma_tb<1>(ma, mb, c, m, n, k, out_f32, splits,
                                   kb_per, s)
              : launch_wgmma_tb<0>(ma, mb, c, m, n, k, out_f32, splits,
                                   kb_per, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
