// Grouped (per-expert) GEMM for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_gemm.py::_kernel (driven
// there by _grouped_gemm, forward and backward of the expert_gemm custom VJP).
// Computes what it computes: C[e] = A[e] @ B[e] for A (E, M, K), B (E, K, N), fp32
// accumulation, C (E, M, N) written in the input dtype, masked per expert by the
// group sizes gs (E,) int32, read from device memory (a null pointer means "all"):
//  - rows mode (the forward and dx): rows m >= gs[e] of C are zero. A row tile whose
//    first row is >= gs[e] loads nothing, computes nothing and writes zeros (the
//    output comes from torch.empty); the straddling tile reads A's rows >= gs[e] as
//    zero and writes them as zero.
//  - contract mode (dw): contraction indices k >= gs[e] are read as zero from both
//    operands, and the contraction loop stops at ceil(gs[e] / BK) tiles, so tiles
//    made of padding only are never read.
//
// Design. The TPU kernel walks the contraction as the minor grid dimension and carries
// the fp32 accumulator in VMEM between grid steps. Here one block owns one
// (row tile, column tile, expert) -- grid (M/64, N/64, E), row tiles fastest, so the
// blocks that share an expert's weight column strip run together and find it in L2 --
// and loops over the contraction tiles itself, accumulating in registers. A and B are
// read through (expert, row, column) strides, so the backward's transposed operands
// (w^T for dx, x^T for dw) are views and never copied, and ragged M, N and K are masked
// at load (where the reference pads every dim to its block).
//
// Two bodies:
//  - gg_bf16<A_KMAJ, B_KMAJ>: bf16 inputs. 64 x 64 output tile, 4 warps of 32 x 32,
//    32-deep contraction tiles; mma.sync m16n8k16 (bf16 in, fp32 accumulate). Each
//    operand tile sits in shared memory in its global layout: k-contiguous ([row][k],
//    fragments read as 32-bit words, as flash_fwd.cu reads Q and K) or row-contiguous
//    ([k][row], fragments through ldmatrix.trans, as flash_fwd.cu reads V). The forward
//    reads x k-contiguous and w n-contiguous; dx reads g and w^T k-contiguous; dw reads
//    x^T m-contiguous and g n-contiguous. Tiles arrive by 16-byte cp.async copies in a
//    3-stage pipeline; a copy's source size masks the ragged and padding elements
//    (zero-filled), so nothing past a limit is read. Operands whose strides break the
//    16-byte rule take a scalar load path into the same layouts.
//  - gg_f32: fp32 inputs, fp32 FMAs on the CUDA cores (TF32 stays off, as the port
//    sets it), 64 x 64 tile, 256 threads of 4 x 4 outputs, each output one FMA chain in
//    k order. It serves the card-against-CPU checks; the paths run bf16.
//
// Bound. The forward at the serving prefill (E 64, C 468, d 2048, f 1408, about 24,000
// real rows) is 1.4e11 FLOP and about 0.55 GB of weights and activations, ~0.17 ms at
// 3.35 TB/s, so by bytes; decode (C = 1, at most 24 experts with a token) reads ~138 MB
// of weights. mma.sync without wgmma/TMA and 64 x 64 tiles keep this kernel well above
// that; wgmma, TMA and a deeper pipeline are later work.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point grouped_gemm at the end of this file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Params {
  const void* a;                    // A (E, M, K) through strides
  const void* b;                    // B (E, K, N) through strides
  void* c;                          // C (E, M, N), contiguous
  const int* gs;                    // (E,) on the device, or null
  long long a_se, a_sm, a_sk;       // strides in elements
  long long b_se, b_sk, b_sn;
  int e, m, n, k;
  int contract;                     // 0: rows mode, 1: contract mode
};

// Per block: the rows of A that carry data and the contraction length to walk.
struct Limits {
  int row_lim;                      // A rows (and C rows) below this are live
  int k_lim;                        // contraction indices below this are read
};

__device__ __forceinline__ Limits limits(const Params& p, int e) {
  const int full = p.contract ? p.k : p.m;
  int g = p.gs ? p.gs[e] : full;
  g = min(max(g, 0), full);
  Limits l;
  l.row_lim = p.contract ? p.m : g;
  l.k_lim = p.contract ? g : p.k;
  return l;
}

// ---------------------------------------------------------------------------
// bf16 body

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kPitchK = kBK + 8;        // [row][k] tiles: 80-byte rows
constexpr int kPitchR = kBM + 8;        // [k][row] tiles: 144-byte rows
constexpr int kTileElems = kBM * kPitchK > kBK * kPitchR ? kBM * kPitchK : kBK * kPitchR;
static_assert(kBM == kBN, "one loader serves both operands");

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem_ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Copies src_bytes (0..16) and zero-fills the rest of the 16 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One operand's 64-row x 32-deep tile into shared memory. "Rows" are m for A and n
// for B. KMAJ: the tile is [row][k] (k contiguous), else [k][row]. The global element
// (row, k) sits at base + row * s_row + k * s_col; it is live where row < row_lim and
// k < k_lim, and reads as zero elsewhere. vec: 16-byte copies along the contiguous
// direction (the caller checked unit stride there, the other strides multiples of 8
// elements and a 16-byte aligned base); else element by element.
template <bool KMAJ>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long s_row, long long s_col, int row0,
                                          int row_lim, int k0, int k_lim, bool vec) {
  if (vec) {
    constexpr int kChunks = kBM * kBK / 8;
    for (int j = threadIdx.x; j < kChunks; j += kThreads) {
      // neighbouring threads take neighbouring chunks of the contiguous direction
      const int r = KMAJ ? j / (kBK / 8) : (j % (kBM / 8)) * 8;
      const int c = KMAJ ? (j % (kBK / 8)) * 8 : j / (kBM / 8);
      const int row = row0 + r;
      const int col = k0 + c;
      int live = KMAJ ? (row < row_lim ? k_lim - col : 0) : (col < k_lim ? row_lim - row : 0);
      live = min(max(live, 0), 8);
      __nv_bfloat16* s = KMAJ ? dst + r * kPitchK + c : dst + c * kPitchR + r;
      const __nv_bfloat16* g = live > 0 ? base + row * s_row + col * s_col : base;
      cp_async16(s, g, live * 2);
    }
  } else {
    for (int j = threadIdx.x; j < kBM * kBK; j += kThreads) {
      const int r = KMAJ ? j / kBK : j % kBM;
      const int c = KMAJ ? j % kBK : j / kBM;
      const int row = row0 + r;
      const int col = k0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (row < row_lim && col < k_lim) v = base[row * s_row + col * s_col];
      dst[KMAJ ? r * kPitchK + c : c * kPitchR + r] = v;
    }
  }
}

template <bool A_KMAJ, bool B_KMAJ>
__global__ void __launch_bounds__(kThreads) gg_bf16(Params p, int a_vec, int b_vec) {
  __shared__ __align__(16) __nv_bfloat16 sA[kStages][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 sB[kStages][kTileElems];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const Limits lim = limits(p, e);
  // a row tile past the expert's load, or no contraction left: nothing to read
  const int nk = m0 >= lim.row_lim ? 0 : (lim.k_lim + kBK - 1) / kBK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int tig = lane % 4;                // thread in group
  const int wm = (warp / 2) * 32;          // the warp's 32 x 32 quarter of the tile
  const int wn = (warp % 2) * 32;

  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a) + e * p.a_se;
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b) + e * p.b_se;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_tile<A_KMAJ>(sA[s], A, p.a_sm, p.a_sk, m0, lim.row_lim, s * kBK, lim.k_lim, a_vec);
      load_tile<B_KMAJ>(sB[s], B, p.b_sn, p.b_sk, n0, p.n, s * kBK, lim.k_lim, b_vec);
    }
    cp_async_commit();
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // tile kt landed; every warp is done with kt-1
    const int nxt = kt + kStages - 1;       // into the buffer tile kt-1 used
    if (nxt < nk) {
      load_tile<A_KMAJ>(sA[nxt % kStages], A, p.a_sm, p.a_sk, m0, lim.row_lim, nxt * kBK,
                        lim.k_lim, a_vec);
      load_tile<B_KMAJ>(sB[nxt % kStages], B, p.b_sn, p.b_sk, n0, p.n, nxt * kBK, lim.k_lim,
                        b_vec);
    }
    cp_async_commit();
    const __nv_bfloat16* tA = sA[kt % kStages];
    const __nv_bfloat16* tB = sB[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16;
        if (A_KMAJ) {
          const __nv_bfloat16* p0 = tA + (r + g) * kPitchK + kk + tig * 2;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kPitchK);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kPitchK + 8);
        } else {
          // 8x8 matrices (rows, k): (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          const __nv_bfloat16* p0 = tA + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * kPitchR +
                                    r + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(a[mi][0], a[mi][1], a[mi][2], a[mi][3], p0);
        }
      }
      uint32_t b[4][2];
      if (B_KMAJ) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p0 = tB + (wn + ni * 8 + g) * kPitchK + kk + tig * 2;
          b[ni][0] = *reinterpret_cast<const uint32_t*>(p0);
          b[ni][1] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        }
      } else {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const __nv_bfloat16* p0 =
              tB + (kk + (lane & 15)) * kPitchR + wn + np * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1], p0);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();                      // nothing left in flight at exit

  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(p.c) + (long long)e * p.m * p.n;
  const bool pairs = (p.n & 1) == 0;       // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= p.m || col >= p.n) continue;
        const bool live = row < lim.row_lim;
        const float v0 = live ? acc[mi][ni][2 * half] : 0.f;
        const float v1 = live ? acc[mi][ni][2 * half + 1] : 0.f;
        __nv_bfloat16* dst = C + (long long)row * p.n + col;
        if (pairs && col + 1 < p.n) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < p.n) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 body: FMAs on the CUDA cores

constexpr int kF = 64;                   // output tile edge
constexpr int kFK = 16;                  // contraction tile
constexpr int kFThreads = 256;           // 16 x 16 threads of 4 x 4 outputs

__global__ void __launch_bounds__(kFThreads) gg_f32(Params p, int a_kfast, int b_kfast) {
  __shared__ __align__(16) float sA[kFK][kF + 4];   // [k][m]
  __shared__ __align__(16) float sB[kFK][kF + 4];   // [k][n]
  const int m0 = blockIdx.x * kF;
  const int n0 = blockIdx.y * kF;
  const int e = blockIdx.z;
  const Limits lim = limits(p, e);
  const int nk = m0 >= lim.row_lim ? 0 : (lim.k_lim + kFK - 1) / kFK;
  const float* A = static_cast<const float*>(p.a) + e * p.a_se;
  const float* B = static_cast<const float*>(p.b) + e * p.b_se;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kFK;
    // neighbouring threads read along the operand's contiguous direction
    for (int j = threadIdx.x; j < kF * kFK; j += kFThreads) {
      int r = a_kfast ? j / kFK : j % kF;
      int c = a_kfast ? j % kFK : j / kF;
      int row = m0 + r, col = k0 + c;
      sA[c][r] = (row < lim.row_lim && col < lim.k_lim) ? A[row * p.a_sm + col * p.a_sk] : 0.f;
      r = b_kfast ? j / kFK : j % kF;
      c = b_kfast ? j % kFK : j / kF;
      row = n0 + r;
      col = k0 + c;
      sB[c][r] = (row < p.n && col < lim.k_lim) ? B[row * p.b_sn + col * p.b_sk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  float* C = static_cast<float*>(p.c) + (long long)e * p.m * p.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.m) continue;
    const bool live = row < lim.row_lim;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tx * 4 + jj;
      if (col < p.n) C[(long long)row * p.n + col] = live ? acc[i][jj] : 0.f;
    }
  }
}

template <bool AK, bool BK>
cudaError_t launch_bf16(const Params& p, int a_vec, int b_vec, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.n + kBN - 1) / kBN, p.e);
  gg_bf16<AK, BK><<<grid, kThreads, 0, stream>>>(p, a_vec, b_vec);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32, 1 = bf16.
// a_kmaj / b_kmaj: 1 if the operand's k direction is its contiguous one (else its
// row direction is, or neither); a_vec / b_vec: 1 if 16-byte copies along that
// direction are allowed (bf16 only). contract: 0 rows mode, 1 contract mode.
extern "C" int grouped_gemm(const void* a, const void* b, void* c, const void* gs,
                            long long a_se, long long a_sm, long long a_sk,
                            long long b_se, long long b_sk, long long b_sn,
                            int e, int m, int n, int k, int contract,
                            int a_kmaj, int a_vec, int b_kmaj, int b_vec, int dtype,
                            void* stream) {
  Params p;
  p.a = a; p.b = b; p.c = c; p.gs = static_cast<const int*>(gs);
  p.a_se = a_se; p.a_sm = a_sm; p.a_sk = a_sk;
  p.b_se = b_se; p.b_sk = b_sk; p.b_sn = b_sn;
  p.e = e; p.m = m; p.n = n; p.k = k;
  p.contract = contract;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == 1) {
    if (a_kmaj && b_kmaj) return launch_bf16<true, true>(p, a_vec, b_vec, st);
    if (a_kmaj) return launch_bf16<true, false>(p, a_vec, b_vec, st);
    if (b_kmaj) return launch_bf16<false, true>(p, a_vec, b_vec, st);
    return launch_bf16<false, false>(p, a_vec, b_vec, st);
  }
  if (dtype == 0) {
    const dim3 grid((m + kF - 1) / kF, (n + kF - 1) / kF, e);
    gg_f32<<<grid, kFThreads, 0, st>>>(p, a_kmaj, b_kmaj);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
