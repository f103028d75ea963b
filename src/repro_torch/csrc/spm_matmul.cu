// spm_matmul for Hopper (sm_90a): C = A @ B with fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spm_matmul/spm_matmul.py
// (`spm_matmul`, bodies `_kernel_2d` and `_kernel_3d`).  It computes
// what that kernel computes, not its grid block by block:
//
//   * One block owns one [BM, BN] output tile.  The TPU's sequential
//     K grid axis (and its fp32 VMEM accumulator) becomes a loop inside
//     the block over K chunks of `bkc` columns, with the accumulator in
//     registers.  `bkc` is the plan's `bk` (bk == 0 stages the whole K,
//     the reference's resident-B regime, when it fits in shared memory).
//   * Chunks arrive by cp.async, 16 bytes a copy with every copy of a
//     chunk in flight at once; with `stages` = 2 the next chunk loads
//     into a second buffer while the current one is multiplied (the
//     TPU pipeline's double buffering).
//   * Blocks are laid out with the M tiles innermost (blockIdx.x), so
//     neighbouring blocks read the same B column block: the reference's
//     B-stationary order, here as L2 reuse instead of VMEM residency.
//   * bf16 inputs go through the tensor cores with mma.sync m16n8k16
//     (fp32 accumulate); fp32 inputs use plain fp32 FMAs with the same
//     fragment ownership, so both types share loads and epilogue.
//   * B is read either as [K, N] (weights) or, with trans_b, as [N, K]
//     (the tied embedding table read in place for the logits: no
//     transposed copy of the [V, d] table is made).
//   * Every edge is masked: M, N and K need not divide any tile.
//     Decode feeds M = batch (1..4), far below a 16-row MMA tile; the
//     rows past M are zero-filled and never stored.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   * decode (M = 4): bytes.  Each weight is read once per step; the
//     0.99 GB of qwen2-0.5b weights take >= 0.29 ms per step.  The design
//     answer is the small-M tile (BM = 16, BN = 64) that puts more blocks
//     on the card for narrow N, whole-K (or 512-deep) slabs when there
//     are fewer blocks than SMs, and many 16-byte copies in flight.
//   * prefill (M = B*P = 1024): tensor-core operations for the wide
//     products.  mma.sync reaches only part of the wgmma peak; wgmma and
//     TMA pipelines are later work.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // shared-memory row padding, in elements

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
