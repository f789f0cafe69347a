// Grouped (per-expert) GEMM for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_gemm.py::_kernel (driven
// there by _grouped_gemm, forward and backward of the expert_gemm custom VJP).
// Computes what it computes: C[e] = A[e] @ B[e] for A (E, M, K), B (E, K, N), fp32
// accumulation, C (E, M, N) written in the input dtype, masked per expert by the
// group sizes gs (E,) int32, read from device memory (a null pointer means "all"):
//  - rows mode (the forward and dx): rows m >= gs[e] of C are zero. A row tile whose
//    first row is >= gs[e] loads nothing, computes nothing and writes zeros (the
//    output comes from torch.empty); a straddling tile writes its rows >= gs[e] as
//    zero, whatever A holds there (each output row reads only its own A row).
//  - contract mode (dw): contraction indices k >= gs[e] count as zero in both
//    operands, and the contraction loop stops at ceil(gs[e] / BK) tiles, so tiles
//    made of padding only are never read.
//
// Design. The TPU kernel walks the contraction as the minor grid dimension and carries
// the fp32 accumulator in VMEM between grid steps. Here one block owns one
// (row tile, column tile, expert) -- row tiles fastest, so the blocks that share an
// expert's weight column strip run together and find it in L2 -- and loops over the
// contraction tiles itself, accumulating in registers. A and B are read through
// (expert, row, column) strides, so the backward's transposed operands (w^T for dx,
// x^T for dw) are views and never copied. No split-K and no atomics: two launches
// give bit-identical results.
//
// Bodies (the wrapper, grouped_gemm.py, chooses by a static rule):
//  - gg_sm90<A_KMAJ, B_KMAJ>: bf16 with N a multiple of 8 and operands that
//    meet TMA's 16-byte rule (every MoE path's shape: prefill, decode and
//    training), the Hopper body. 128 x 256 output tiles,
//    64-deep contraction tiles, 384 threads: a
//    producer warpgroup (setmaxnreg 24; one thread streams A and B tiles by TMA
//    through a 4-stage full/empty mbarrier ring from 3-D tensor maps
//    (contiguous dim, other dim, expert) built per call from the strides,
//    128-byte swizzle, zero fill past each tensor's end) and two consumer
//    warpgroups that each own 64 rows and run m64n256k16 wgmmas with both
//    operands in shared memory, keeping one tile's wgmmas in flight while the
//    next tile's are issued. Each operand keeps its global layout in shared
//    memory: K-major (k contiguous: one box of rows x 64 k) or MN-major (rows
//    contiguous: 64-row boxes of 64 k-rows), read through the matching
//    descriptor (wgmma's transpose bit for MN-major). The forward reads x
//    K-major and w MN-major; dx reads g and w^T K-major; dw reads x^T MN-major
//    (the transposed A descriptor) and g MN-major. In contract mode the last,
//    straddling contraction tile has its indices >= gs[e] zeroed in shared
//    memory in both operands after TMA lands it and before the wgmmas read it:
//    TMA's zero fill covers only a tensor's own end, and padding rows may hold
//    anything (NaN * 0 is NaN). The output leaves through shared memory (128
//    columns at a time, swizzled) by TMA stores, which skip rows past M and
//    columns past N. Rows mode launches a block per output tile; contract mode
//    (dw, contractions of a few hundred rows) one block per SM that walks the
//    tiles, so one tile's store overlaps the next tile's loads (launch_sm90
//    has the measured reason).
//  - gg_bf16<A_KMAJ, B_KMAJ>: bf16 off the 16-byte rule (or N not a multiple of
//    8), on no path; the first version. 64 x 64 output tile, 4
//    warps of 32 x 32, 32-deep contraction tiles; mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate). Each operand tile sits in shared memory in its global
//    layout: k-contiguous ([row][k], fragments read as 32-bit words) or
//    row-contiguous ([k][row], fragments through ldmatrix.trans). Tiles arrive by
//    16-byte cp.async copies in a 3-stage pipeline; a copy's source size masks the
//    ragged and padding elements (zero-filled), so nothing past a limit is read.
//    Operands whose strides break the 16-byte rule take a scalar load path into
//    the same layouts.
//  - gg_f32: fp32 inputs, fp32 FMAs on the CUDA cores (TF32 stays off, as the port
//    sets it), 64 x 64 tile, 256 threads of 4 x 4 outputs, each output one FMA chain in
//    k order. It serves the card-against-CPU checks; the paths run bf16.
//
// Bound. The forward at the serving prefill (E 64, C 468, d 2048, f 1408, about
// 22,000-24,000 real rows) is ~1.3e11 FLOP (0.13 ms at 989 TFLOP/s) and about 0.55
// GB of weights and activations (~0.16 ms at 3.35 TB/s), so by bytes, with the
// tensor cores close behind; decode (C = 1, at most 24 experts with a token)
// reads ~116 MB of weights. Measured (chip_smoke.py on the MoE paths' own inputs,
// H100 80GB HBM3, 700 W): prefill gate/up 0.2622 ms and down 0.2487 (torch.bmm
// 0.2367 / 0.2441; the mma.sync body 0.9393 / 0.9621), training dx 0.1629 and dw
// 0.1881 (bmm 0.2779 / 0.2789). At gate/up N = 1408 is 5.5 tiles of 256, so 9%
// of the tensor work is padding columns. Decode (one row per expert) 0.0498 ms
// (bmm 0.1217), where the mma.sync body takes 0.0662: the Hopper body is the
// faster of the two at every path shape, one row per expert included, so the
// rule routes by layout alone. -Xptxas -v (CUDA 12.8): the Hopper kernels 168
// registers at launch, no spills.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -I csrc
// and bound with ctypes through the C entry point grouped_gemm at the end of this file.

#include "sm90.cuh"          // mbarrier/TMA/wgmma helpers, the tensor maps

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
// Hopper body (bf16)

constexpr int kHBM = 128;                 // output rows: two consumer warpgroups x 64
constexpr int kHBN = 256;                 // output columns
constexpr int kHBK = 64;                  // contraction: one 128-byte swizzled row
constexpr int kHBox = 64 * 128;           // one 64-row box of 128-byte rows (8 KB)
constexpr int kHATile = kHBM * kHBK * 2;  // bytes of an A tile (16 KB)

// Shared memory of the Hopper body: a ring of kStages (A tile, B tile) stages,
// 128 columns of the output tile on their way to TMA's store (64 rows a
// warpgroup, in two boxes of 128-byte rows), then the full/empty barriers:
// 225 KB of the 227 a block may use.
struct GgSh {
  static constexpr int kStages = 4;
  static constexpr int kBTile = kHBK * kHBN * 2;
  static constexpr int kStage = kHATile + kBTile;
  static constexpr int kOutOff = kStages * kStage;
  static constexpr int kOutBytes = 64 * 128 * 2;     // one warpgroup's rows, 128 columns
  static constexpr int kBarOff = kOutOff + 2 * kOutBytes;
  static constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
};

// Zero, in one operand's tile of a stage, the contraction indices at or past lim
// (0 < lim < 64). The tile is `rows` rows of 128 bytes: in a K-major tile a row
// is one m (or n) and the indices are its columns lim..63, which the 128-byte
// swizzle stores as logical 16-byte chunk j of row r at chunk j ^ (r & 7); in an
// MN-major tile (64-row boxes) a row is one index, k = r % 64. t: the consumer
// thread, 0..255, each taking every 256th chunk.
template <bool KMAJ>
__device__ __forceinline__ void zero_tail(unsigned char* tile, int rows, int lim, int t) {
  for (int idx = t; idx < rows * 8; idx += 2 * kWg) {
    const int r = idx / 8;
    const int pc = idx % 8;
    uint4* chunk = reinterpret_cast<uint4*>(tile + r * 128 + pc * 16);
    if (KMAJ) {
      const int k0 = 8 * (pc ^ (r & 7));
      if (k0 + 8 <= lim) continue;
      if (k0 >= lim) {
        *chunk = make_uint4(0u, 0u, 0u, 0u);
      } else {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(chunk);
        for (int j = lim - k0; j < 8; ++j) e[j] = __float2bfloat16(0.f);
      }
    } else if (r % 64 >= lim) {
      *chunk = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Persistent: one block per SM walks the output tiles (128 rows x 256 columns of
// one expert; row tiles fastest, so the blocks that share an expert's weight
// column strip run together and find it in L2) from blockIdx.x in steps of
// gridDim.x. The producer streams every tile's 64-deep contraction tiles of A
// and B through one ring without pausing between output tiles; consumer
// warpgroup c owns rows 64c .. 64c+63 of each and stores them through shared
// memory with TMA while the producer already fills the ring for the next tile.
template <bool A_KMAJ, bool B_KMAJ>
__global__ void __launch_bounds__(kSm90Threads, 1)
gg_sm90(const Params p, const __grid_constant__ CUtensorMap tm_a,
        const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_c) {
  using Sh = GgSh;
  constexpr int kNAcc = kHBN / 2;                       // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_u32);    // generic pointer to base
  auto tile_a = [&](int s) { return base + s * Sh::kStage; };
  auto tile_b = [&](int s) { return base + s * Sh::kStage + kHATile; };
  auto full = [&](int s) { return base + Sh::kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + Sh::kBarOff + 8 * (Sh::kStages + s); };

  const int tiles_m = (p.m + kHBM - 1) / kHBM;
  const int tiles_n = (p.n + kHBN - 1) / kHBN;
  const int n_tiles = tiles_m * tiles_n * p.e;
  // one output tile's coordinates and contraction length
  struct Tile {
    int m0, n0, e, nk, tail;
    Limits lim;
  };
  auto tile_at = [&](int i) {
    Tile u;
    u.m0 = (i % tiles_m) * kHBM;
    u.n0 = (i / tiles_m % tiles_n) * kHBN;
    u.e = i / (tiles_m * tiles_n);
    u.lim = limits(p, u.e);
    // a row tile past the expert's load, or no contraction left: nothing to read
    u.nk = u.m0 >= u.lim.row_lim ? 0 : (u.lim.k_lim + kHBK - 1) / kHBK;
    // contract mode: indices >= gs[e] inside the last tile are zeroed after it lands
    u.tail = p.contract && u.lim.k_lim < p.k ? u.lim.k_lim % kHBK : 0;
    return u;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {                              // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;                                       // contraction tiles so far
      for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
        const Tile u = tile_at(i);
        for (int kt = 0; kt < u.nk; ++kt, ++it) {
          const int s = it % Sh::kStages;
          const int k0 = kt * kHBK;
          mbar_wait(empty(s), ((it / Sh::kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), Sh::kStage);
          if (A_KMAJ) {
            tma_load_3d(tile_a(s), &tm_a, full(s), k0, u.m0, u.e);
          } else {
            tma_load_3d(tile_a(s), &tm_a, full(s), u.m0, k0, u.e);
            tma_load_3d(tile_a(s) + kHBox, &tm_a, full(s), u.m0 + 64, k0, u.e);
          }
          if (B_KMAJ) {
            tma_load_3d(tile_b(s), &tm_b, full(s), k0, u.n0, u.e);
          } else {
            for (int bx = 0; bx < kHBN / 64; ++bx)
              tma_load_3d(tile_b(s) + bx * kHBox, &tm_b, full(s), u.n0 + 64 * bx, k0, u.e);
          }
        }
      }
    }
  } else {                                              // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int t = threadIdx.x - kWg;                    // 0..255
    const int c = t / kWg;
    const int warp = (t % kWg) / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const bool lead = t % kWg == 0;                     // issues the warpgroup's stores
    unsigned char* out = gbase + Sh::kOutOff + c * Sh::kOutBytes;
    const uint32_t out_u32 = base + Sh::kOutOff + c * Sh::kOutBytes;
    float acc[kNAcc];
    int it = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      const Tile u = tile_at(i);
#pragma unroll
      for (int j = 0; j < kNAcc; ++j) acc[j] = 0.f;
      for (int kt = 0; kt < u.nk; ++kt, ++it) {
        const int s = it % Sh::kStages;
        mbar_wait(full(s), (it / Sh::kStages) & 1);
        if (u.tail && kt == u.nk - 1) {
          zero_tail<A_KMAJ>(gbase + s * Sh::kStage, kHBM, u.tail, t);
          zero_tail<B_KMAJ>(gbase + s * Sh::kStage + kHATile, kHBN, u.tail, t);
          fence_async_smem();                           // for wgmma's reads
          named_sync(1, 2 * kWg);                       // both consumers
        }
        const uint32_t a = tile_a(s) + c * kHBox;       // this warpgroup's 64 rows
        const uint32_t b = tile_b(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kHBK / 16; ++kk) {
          const uint64_t da = A_KMAJ ? sw128_desc(a + kk * 32, 16)
                                     : sw128_desc(a + kk * 2048, kHBox);
          const uint64_t db = B_KMAJ ? sw128_desc(b + kk * 32, 16)
                                     : sw128_desc(b + kk * 2048, kHBox);
          wgmma_ss_n256<A_KMAJ ? 0 : 1, B_KMAJ ? 0 : 1>(acc, da, db, 1);
        }
        wg_commit();
        wg_wait<1>();                                   // tile it - 1's wgmmas are done
        if (kt > 0) mbar_arrive(empty((it - 1) % Sh::kStages));
      }
      wg_wait<0>();
      fence_regs(acc);
      if (u.nk > 0) mbar_arrive(empty((it - 1) % Sh::kStages));

      // the warpgroup's 64 x 256 rows as bf16 (rows at or past the expert's load
      // as zero), 128 columns at a time in two swizzled boxes, out by TMA, which
      // leaves rows past M and columns past N unwritten; first the previous
      // store must have read the buffer
#pragma unroll
      for (int cols = 0; cols < kHBN; cols += 128) {
        if (lead) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_sync(2 + c, kWg);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;       // row within the warpgroup's 64
          const bool live = u.m0 + 64 * c + r < u.lim.row_lim;
#pragma unroll
          for (int j = 0; j < 16; ++j) {                // 8-column groups
            const int nt = cols / 8 + j;
            const float v0 = live ? acc[4 * nt + 2 * half] : 0.f;
            const float v1 = live ? acc[4 * nt + 2 * half + 1] : 0.f;
            const int off = (j / 8) * kHBox + r * 128 + (((j % 8) ^ (r % 8)) * 16) + tig * 4;
            *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_async_smem();
        named_sync(2 + c, kWg);
        if (lead) {
          for (int bx = 0; bx < 2; ++bx)
            tma_store_3d(&tm_c, out_u32 + bx * kHBox, u.n0 + cols + 64 * bx, u.m0 + 64 * c,
                         u.e);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (lead) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The 3-D map (contiguous dim, other dim, expert) of one bf16 operand, in boxes of
// 64 contiguous elements x box_rows: inner/outer are its extents, s_outer/s_e its
// strides in elements.
int encode_operand(CUtensorMap* map, const void* ptr, int inner, int outer, int e,
                   long long s_outer, long long s_e, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)e};
  const cuuint64_t strides[2] = {(cuuint64_t)s_outer * 2, (cuuint64_t)s_e * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16(map, ptr, 3, dims, strides, box);
}

// The Hopper body: the tensor maps (K-major: rows x 64 k; MN-major: 64 k-rows x
// 64 rows, loaded rows / 64 times per tile; C in 64 x 64 boxes), then the launch.
template <bool AK, bool BK>
int launch_sm90(const Params& p, cudaStream_t st) {
  CUtensorMap ta, tb, tc;
  int err = AK ? encode_operand(&ta, p.a, p.k, p.m, p.e, p.a_sm, p.a_se, kHBM)
               : encode_operand(&ta, p.a, p.m, p.k, p.e, p.a_sk, p.a_se, 64);
  if (!err) err = BK ? encode_operand(&tb, p.b, p.k, p.n, p.e, p.b_sn, p.b_se, kHBN)
                     : encode_operand(&tb, p.b, p.n, p.k, p.e, p.b_sk, p.b_se, 64);
  if (!err) err = encode_operand(&tc, p.c, p.n, p.m, p.e, p.n, (long long)p.m * p.n, 64);
  if (err) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      gg_sm90<AK, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, GgSh::kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  // rows mode: a block per output tile, which the hardware hands out in order as
  // SMs free up, so the blocks reading one expert's weight strip stay together
  // (a fixed walk of the tiles, one block per SM, measured 16-40% slower at the
  // MoE shapes); contract mode (short contractions): one block per SM walking
  // the tiles, so a tile's store overlaps the next tile's loads (20% faster)
  int dev = 0, sms = 0;
  cudaError_t aerr = cudaGetDevice(&dev);
  if (aerr == cudaSuccess) aerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (aerr != cudaSuccess) return (int)aerr;
  const long long n_tiles = (long long)((p.m + kHBM - 1) / kHBM) * ((p.n + kHBN - 1) / kHBN) * p.e;
  const int grid = (int)(p.contract && n_tiles > sms ? sms : n_tiles);
  gg_sm90<AK, BK><<<grid, kSm90Threads, GgSh::kSmemBytes, st>>>(p, ta, tb, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the body the caller names: 0 = fp32 (gg_f32), 1 = bf16 mma.sync
// (gg_bf16), 2 = bf16 Hopper (gg_sm90; the caller checked TMA's 16-byte rule).
// a_kmaj / b_kmaj: 1 if the operand's k direction is its contiguous one (else its
// row direction is, or neither); a_vec / b_vec: 1 if 16-byte copies along that
// direction are allowed (gg_bf16 only). contract: 0 rows mode, 1 contract mode.
// Returns the cudaError_t of the launch (0 on success), 20000 when the driver
// offers no tensor-map encoder and 20001 + the CUresult of a failed encode.
extern "C" int grouped_gemm(const void* a, const void* b, void* c, const void* gs,
                            long long a_se, long long a_sm, long long a_sk,
                            long long b_se, long long b_sk, long long b_sn,
                            int e, int m, int n, int k, int contract,
                            int a_kmaj, int a_vec, int b_kmaj, int b_vec, int body,
                            void* stream) {
  Params p;
  p.a = a; p.b = b; p.c = c; p.gs = static_cast<const int*>(gs);
  p.a_se = a_se; p.a_sm = a_sm; p.a_sk = a_sk;
  p.b_se = b_se; p.b_sk = b_sk; p.b_sn = b_sn;
  p.e = e; p.m = m; p.n = n; p.k = k;
  p.contract = contract;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (body == 2) {
    if (a_kmaj && b_kmaj) return launch_sm90<true, true>(p, st);
    if (a_kmaj) return launch_sm90<true, false>(p, st);
    if (b_kmaj) return launch_sm90<false, true>(p, st);
    return launch_sm90<false, false>(p, st);
  }
  if (body == 1) {
    if (a_kmaj && b_kmaj) return launch_bf16<true, true>(p, a_vec, b_vec, st);
    if (a_kmaj) return launch_bf16<true, false>(p, a_vec, b_vec, st);
    if (b_kmaj) return launch_bf16<false, true>(p, a_vec, b_vec, st);
    return launch_bf16<false, false>(p, a_vec, b_vec, st);
  }
  if (body == 0) {
    const dim3 grid((m + kF - 1) / kF, (n + kF - 1) / kF, e);
    gg_f32<<<grid, kFThreads, 0, st>>>(p, a_kmaj, b_kmaj);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
