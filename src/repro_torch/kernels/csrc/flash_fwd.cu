// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_fwd_kernel
// (driven there by _flash_forward). Computes exactly what it computes: online-softmax
// tiled attention returning o (B, Hq, S, hd) in the input dtype and the per-row
// logsumexp lse (B, Hq, S) in fp32, with GQA (kv head = h / group), causal and
// sliding-window masks, logit softcap (tanh before the mask), a query position
// offset, and whole-tile skipping of key tiles the mask rules out.
//
// Design. The TPU kernel walks the KV tiles as the minor grid dimension and carries
// (m, l, acc) in VMEM scratch between grid steps. Hopper blocks run in parallel and
// carry nothing, so here one block owns one (batch, q-head, q-tile) and loops over
// the relevant KV tiles itself. Ragged S and T edges are masked in the kernel; no
// padded copies are made. Masked scores are the finite -1e30 of the reference and l
// is clamped to 1e-30, so a fully masked row gives o = 0 and lse ~ -1e30, never NaN.
// q, k, v and o are addressed through batch/head/sequence strides (head dim
// contiguous), so batch-major callers pass transposed views without copies.
//
// Bodies (the wrapper, flash_attention.py, chooses by dtype and head dim):
//  - flash_fwd_sm90<HD>: bf16 at hd 64 and 128 (every path's head dim: qwen and
//    deepseek 128, zamba2's shared attention 64), the Hopper body, the forward
//    counterpart of flash_bwd.cu's. 384 threads: a producer warpgroup
//    (setmaxnreg down to 24; one thread loads the block's 128-query Q tile once
//    by TMA, then streams the 64-key K and V tiles through a ring of 5 (hd 128)
//    or 6 (hd 64) stages with full/empty mbarriers) and two consumer warpgroups
//    (240 registers) that each own 64 of the tile's queries. S = Q K^T is a
//    wgmma with both operands in shared memory (K-major); O += P V takes P
//    straight from the S accumulator as wgmma's register A fragments and reads
//    V MN-major through the transposed descriptor, so P never touches shared
//    memory and V is never transposed. Within a warpgroup S_j = Q K_j^T and
//    O += P_{j-1} V_{j-1} are issued together and the softmax of S_j runs while
//    the second is on the tensor cores; O takes S_j's rescale when it retires
//    (so a warpgroup holds two stages, hence the deeper ring), and the two
//    warpgroups fill each other's gaps. TMA's 4-D maps (head dim, sequence,
//    head, batch) zero-fill rows past S and T; a zero key scores 0, not -inf,
//    so tiles with such keys take the mask path. The online softmax keeps the
//    rows' max in natural units and the sums per thread (quad reductions over
//    the accumulator layout); O and l are rescaled only when a row's max
//    rises. Tiles that no mask edge touches (tile_straddles: the causal
//    diagonal, the window edge, a ragged S or T) skip the per-element test, and
//    there p = 2^(q.k * scale log2 e - m log2 e) is one FFMA and one MUFU.EX2;
//    softcap keeps the per-element path (tanh, mask, expf). The grid puts the
//    tile index on y, heaviest causal tiles first across all heads.
//  - flash_fwd_bf16<HD>: bf16 at every other head dim the reference's kernel takes
//    (a multiple of 8 up to 256: gemma2's 256 on the grid prefill), the first version.
//    4 warps x 16 query rows = 64-row q tile, 64-key KV tiles. Q.K^T and P.V run
//    on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). Tiles
//    sit in padded shared memory (conflict-free fragment loads; V fragments via
//    ldmatrix.trans), filled by cp.async in a two-step pipeline (V of a tile loads
//    while its scores are computed, K of the next tile while P.V runs). Tiles wholly
//    inside the mask skip the per-element mask test.
//  - flash_fwd_f32<HD>: fp32 inputs, plain fp32 FMA on the CUDA cores (the reference
//    computes in fp32, and TF32 would miss its 3e-5 tolerance). 4 warps x 8 rows,
//    32-key tiles; lane j owns key j for the scores and head-dim columns j, j+32, ...
//    for the output. Bound by the 67 TFLOP/s fp32 rate at best; not on the paths.
//  Both bodies are built at HD 32, 64, 128 and 256 and take a head dim hd that is a
//  multiple of 8 up to 256 at the least HD that holds it (body_hd): columns past hd
//  load as zeros and are never stored, so no padded copy is made (hd 40 pays for 64).
//
// Rounding. The reference keeps P in fp32; both bf16 bodies pass P to P.V as two
// bf16 terms (head + remainder, ~16 bits), which doubles that product's tensor-core
// work but keeps the kernel's rounding at the reference's (one rounding of O to
// bf16). Measured on every bf16 row of chip_smoke.py's FLASH_CASES and the
// training shape (H100 80GB HBM3, 700 W): two terms within 1.00 bf16 ulp
// everywhere; a variant of this body with P rounded to bf16 once (one term) was
// 61-401 ulps off (401 at the serving shape, 210 at the training shape), far
// outside the 2-ulp limit, for 12-17% less time (serving 0.1723 against 0.1973
// ms, training 0.2230 against 0.2698 ms). So two terms stay.
//
// Bound. At the training shape (B 1, Hq = Hkv = 20, S = T = 4096, hd 128, causal)
// the two products are 4 hd FLOP per attended pair, 8.6e10 FLOP = 87 us at 989
// TFLOP/s; at the serving shape (B 4, Hq 40, Hkv 8, S = T = 1000) 4.1e10 FLOP =
// 41.5 us; the bytes (~98 MB at serving, 29 us at 3.35 TB/s) weigh less. With
// two bf16 terms the kernel issues 1.5x that tensor-core work, which SDPA (one
// bf16 P) does not. Measured (chip_smoke.py, H100 80GB HBM3, 700 W): training
// 0.2688 ms (SDPA 0.1707; the mma.sync body 0.9783), serving 0.1976 (SDPA
// 0.1006; 0.5170), zamba2's serving shape (4 x 32 x 8000, hd 64) 4.845 (SDPA
// 2.259; 11.89). The first Hopper version, which waited out each product before
// the softmax, took 0.302 / 0.213 ms. -Xptxas -v (CUDA 12.8): 168 registers at
// launch, no spills.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -I csrc
// and bound with ctypes through the C entry point flash_fwd at the end of this file.

#include "sm90.cuh"          // the masks, mbarrier/TMA/wgmma helpers, the tensor maps

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                       // contiguous (B, Hq, S)
  long long q_sb, q_sh, q_ss;       // strides in elements: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int b, hq, hkv, s, t;
  int hd;                           // the true head dim; the body's HD may be larger
  int causal, window, q_offset;
  float softcap, scale;
};

__device__ __forceinline__ float score_mod(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16 on the tensor cores.

constexpr int kBq = 64;    // 4 warps x 16 rows
constexpr int kBk = 64;
constexpr int kThreads = 128;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;     // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [row0, row0 + rows) of one (batch, head) slice into a padded
// shared tile with 16-byte cp.async copies, zero-filling rows at or past n_rows and
// the columns at or past hd (a multiple of 8, so a chunk is wholly in or out).
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int rows,
                                                int n_rows, int hd) {
  constexpr int kChunks = HD / 8;        // 16-byte chunks per row
  constexpr int kPitch = HD + 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < n_rows && c * 8 < hd;
    const __nv_bfloat16* g = in ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * kPitch + c * 8, g, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int kPitch = HD + 8;           // padding keeps fragment loads conflict-free
  constexpr int kDt = HD / 8;              // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBq * kPitch;
  __nv_bfloat16* sV = sK + kBk * kPitch;

  // heaviest causal q tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = qt * kBq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int tig = lane % 4;                // thread in group

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  // The relevant KV tiles form one contiguous range: causality bounds it above,
  // the window below.
  const int nk = (p.t + kBk - 1) / kBk;
  int k_lo = 0;
  while (k_lo < nk && !tile_relevant(p, q_start, kBq, k_lo * kBk, kBk)) ++k_lo;
  int k_hi = k_lo;
  while (k_hi < nk && tile_relevant(p, q_start, kBq, k_hi * kBk, kBk)) ++k_hi;

  // Pipeline: V_kt is in flight while S_kt is computed, K_kt+1 while P.V_kt is.
  load_tile_async<HD>(sQ, Q, p.q_ss, q_start, kBq, p.s, p.hd);
  if (k_lo < k_hi) load_tile_async<HD>(sK, K, p.k_ss, k_lo * kBk, kBk, p.t, p.hd);
  cp_async_commit();

  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                 // this thread's partial row sums

  const int row_a = q_start + warp * 16 + g;   // rows of fragment elements 0,1 / 2,3
  const __nv_bfloat16* qrow0 = sQ + (warp * 16 + g) * kPitch + tig * 2;
  const __nv_bfloat16* qrow1 = qrow0 + 8 * kPitch;

  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int k_start = kt * kBk;
    cp_async_wait_all();
    __syncthreads();                       // K_kt landed; every warp is done with V_kt-1
    load_tile_async<HD>(sV, V, p.v_ss, k_start, kBk, p.t, p.hd);
    cp_async_commit();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qrow0 + kk);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qrow1 + kk);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qrow0 + kk + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qrow1 + kk + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * kPitch + kk + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16(sc[nt], a0, a1, a2, a3, b0, b1);
      }
    }

    // scale, softcap, mask, online softmax (rows row_a and row_a + 8); a tile wholly
    // inside the mask skips the per-element test
    const bool inside = q_start + kBq <= p.s && k_start + kBk <= p.t &&
                        (!p.causal || k_start + kBk - 1 <= p.q_offset + q_start) &&
                        (p.window <= 0 || p.q_offset + q_start + kBq - 1 - k_start < p.window);
    uint32_t ok_bits = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = score_mod(p, sc[nt][e]);
        if (!inside && !attend(p, row_a + (e >> 1) * 8, k_start + nt * 8 + tig * 2 + (e & 1))) {
          s = kNegInf;
          ok_bits &= ~(1u << (nt * 4 + e));
        }
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ((ok_bits >> (nt * 4 + e)) & 1u) ? expf(sc[nt][e] - m[e >> 1]) : 0.f;
        sc[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    cp_async_wait_all();
    __syncthreads();                       // V_kt landed; every warp is done with K_kt
    if (kt + 1 < k_hi) {
      load_tile_async<HD>(sK, K, p.k_ss, k_start + kBk, kBk, p.t, p.hd);
      cp_async_commit();
    }

    // O += P V: P's accumulator fragments become A fragments, each split into a
    // bf16 head and a bf16 remainder (P ~ hi + lo to ~16 bits, where the reference
    // keeps P in fp32); V fragments come through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < 4; ++j) {          // 16 keys per step
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * j][0], sc[2 * j][1], hi[0], lo[0]);
      split_bf16(sc[2 * j][2], sc[2 * j][3], hi[1], lo[1]);
      split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* vrow = sV + (j * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < kDt / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vrow + dp * 16);
        mma_bf16(acc[2 * dp], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(acc[2 * dp], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma_bf16(acc[2 * dp + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
        mma_bf16(acc[2 * dp + 1], lo[0], lo[1], lo[2], lo[3], b2, b3);
      }
    }
  }

  cp_async_wait_all();                     // nothing left in flight at exit
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row < p.s) {
      __nv_bfloat16* orow = O + (long long)row * p.o_ss + tig * 2;
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        if (dt * 8 < p.hd)                 // not the masked columns past hd
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(acc[dt][2 * r] / lc, acc[dt][2 * r + 1] / lc);
      }
      if (tig == 0) p.lse[((long long)bi * p.hq + h) * p.s + row] = m[r] + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper body: bf16 at hd 64 and 128.

// Online softmax over one 64 x 64 tile of a consumer warpgroup, in the
// accumulator layout (element i: query row_a + 8 ((i >> 1) & 1), key
// col_a + 8 (i >> 2) + (i & 1)). sc holds q.k and becomes p; m (natural units)
// and l are the thread's two rows' running max and its share of their sums. A
// row whose max rises gets rose[r] and corr[r] = exp(m_old - m_new), which l
// takes here and the rows' O takes once the wgmmas writing it are done
// (rescale). kEdge: the per-element mask (a masked element is left out of the
// max and gets p = 0, so a row with no key yet keeps m = -1e30 and l = 0).
// kCap: softcap, per element.
template <bool kEdge, bool kCap>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], bool (&rose)[2],
                                             int row_a, int col_a) {
  uint32_t ok = 0xffffffffu;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    if constexpr (kCap) sc[i] = score_mod(p, sc[i]);
    if (kEdge && !attend(p, row_a + 8 * r, col_a + 8 * (i >> 2) + (i & 1))) {
      ok &= ~(1u << i);
    } else {
      mx[r] = fmaxf(mx[r], sc[i]);
    }
  }
  float mb[2];                             // the rows' max in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float t = quad_max(mx[r]);       // raw q.k without softcap (scale > 0)
    const float m_new = t == kNegInf ? m[r] : fmaxf(m[r], kCap ? t : t * p.scale);
    rose[r] = m_new > m[r];
    corr[r] = rose[r] ? ex2((m[r] - m_new) * kLog2e) : 1.f;
    l[r] *= corr[r];
    m[r] = m_new;
    mb[r] = m_new * kLog2e;
  }
  const float sl2 = p.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float pe = kCap ? expf(sc[i] - m[r]) : ex2(fmaf(sc[i], sl2, -mb[r]));
    if (kEdge && !((ok >> i) & 1u)) pe = 0.f;
    sc[i] = pe;
    l[r] += pe;
  }
}

// The rows of O (acc) whose max rose take their correction.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2],
                                        const bool (&rose)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rose[r]) continue;
#pragma unroll
    for (int nt = 0; nt < N / 4; ++nt) {
      acc[4 * nt + 2 * r] *= corr[r];
      acc[4 * nt + 2 * r + 1] *= corr[r];
    }
  }
}

// Keeps the registers of wgmma's A fragments live (and unchanged) until here:
// called after the wait that retires the wgmmas reading them.
__device__ __forceinline__ void fence_frags(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(x[j][r]) :: "memory");
}

// B1's Hopper layout: the 128-query Q tile (one own tensor) and a ring of K/V
// stages, deeper than B2's since the consumers hold two stages at a time.
template <int HD>
using FwdSh = Sm90<HD, 1, HD == 128 ? 5 : 6>;

// B1, Hopper: one block per (q-head, 128-query tile, batch); consumer warpgroup c
// owns queries 64c .. 64c + 63 of the tile and carries their (m, l, O) over the
// KV tiles relevant to them, which lie inside the block's relevant range that
// the producer streams through the ring. Within a warpgroup the products of two
// tiles overlap the softmax: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
// together, the softmax of S_j runs while P_{j-1} V_{j-1} is on the tensor
// cores, and O takes S_j's rescale once that product retires.
template <int HD>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_sm90(const Params p, const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v) {
  using Sh = FwdSh<HD>;
  extern __shared__ unsigned char smem_raw[];
  const Sm90Smem<HD, Sh> sm(smem_raw);
  const int h = blockIdx.x;
  const int q_blk = (gridDim.y - 1 - blockIdx.y) * Sh::kOwnRows;   // heaviest causal tiles first
  const int bi = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int nk = (p.t + 63) / 64;
  int k_lo, k_hi;
  relevant_range(p, true, q_blk, Sh::kOwnRows, 64, nk, k_lo, k_hi);
  const int n_iter = k_hi - k_lo;
  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  if (threadIdx.x < kWg) {                              // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0 && n_iter > 0) {
      mbar_expect_tx(sm.own_ready(), Sh::kOwnBytes);
      for (int bx = 0; bx < Sh::kBoxes; ++bx)
        tma_load(sm.own(0) + bx * Sh::kOwnBox, &tm_q, sm.own_ready(), bx * 64, q_blk, h, bi);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % Sh::kStages;
        const int k_start = (k_lo + it) * 64;
        mbar_wait(sm.empty(s), ((it / Sh::kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * Sh::kStreamBytes);
        for (int bx = 0; bx < Sh::kBoxes; ++bx) {
          tma_load(sm.stream(s, 0) + bx * Sh::kStreamBox, &tm_k, sm.full(s), bx * 64, k_start,
                   kvh, bi);
          tma_load(sm.stream(s, 1) + bx * Sh::kStreamBox, &tm_v, sm.full(s), bx * 64, k_start,
                   kvh, bi);
        }
      }
    }
  } else {                                              // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int c = threadIdx.x / kWg - 1;
    const int warp = (threadIdx.x % kWg) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const int q0 = q_blk + 64 * c;
    const int row_a = q0 + warp * 16 + g;                // rows of elements 0,1 / 2,3: +8
    // this warpgroup's tiles: a sub-range [lo, hi) of the block's [k_lo, k_hi)
    int lo = k_hi, hi = k_hi;
    if (q0 < p.s) relevant_range(p, true, q0, 64, 64, nk, lo, hi);
    float acc[HD / 2], sc[32];
    uint32_t p_hi[4][4], p_lo[4][4];                     // P of the tile in flight
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float corr[2];
    bool rose[2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint32_t a_q = sm.own(0) + c * 64 * 128;      // this warpgroup's rows of each box
    auto wait_full = [&](int it) {
      mbar_wait(sm.full((it - k_lo) % Sh::kStages), ((it - k_lo) / Sh::kStages) & 1);
    };
    auto release = [&](int it) { mbar_arrive(sm.empty((it - k_lo) % Sh::kStages)); };
    auto stage = [&](int it, int i) { return sm.stream((it - k_lo) % Sh::kStages, i); };
    auto softmax = [&](int it) {
      const int k_start = it * 64;
      const int col_a = k_start + tig * 2;
      if (p.softcap != 0.f)
        softmax_tile<true, true>(p, sc, m, l, corr, rose, row_a, col_a);
      else if (tile_straddles(p, q0, 64, k_start, 64))
        softmax_tile<true, false>(p, sc, m, l, corr, rose, row_a, col_a);
      else
        softmax_tile<false, false>(p, sc, m, l, corr, rose, row_a, col_a);
    };
    if (n_iter > 0) mbar_wait(sm.own_ready(), 0);
    for (int it = k_lo; it < lo; ++it) {                // the block's tiles before ours
      wait_full(it);
      release(it);
    }
    if (lo < hi) {
      wait_full(lo);
      wg_fence();
      wg_abt<HD>(sc, a_q, Sh::kOwnBox, stage(lo, 0), Sh::kStreamBox);        // S = Q K^T
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      softmax(lo);
      wg_split(sc, p_hi, p_lo);
      for (int it = lo + 1; it < hi; ++it) {
        wait_full(it);
        wg_fence();
        wg_abt<HD>(sc, a_q, Sh::kOwnBox, stage(it, 0), Sh::kStreamBox);      // S_j
        wg_commit();
        wg_xb_frags<HD>(acc, p_hi, p_lo, stage(it - 1, 1), Sh::kStreamBox);  // O += P_{j-1} V
        wg_commit();
        wg_wait<1>();                                   // S_j is done
        fence_regs(sc);
        softmax(it);
        wg_wait<0>();                                   // P_{j-1} V_{j-1} is done
        fence_regs(acc);
        fence_frags(p_hi);
        fence_frags(p_lo);
        release(it - 1);
        rescale(acc, corr, rose);
        wg_split(sc, p_hi, p_lo);
      }
      wg_fence();
      wg_xb_frags<HD>(acc, p_hi, p_lo, stage(hi - 1, 1), Sh::kStreamBox);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      fence_frags(p_hi);
      fence_frags(p_lo);
      release(hi - 1);
    }
    for (int it = hi; it < k_hi; ++it) {                // the block's tiles after ours
      wait_full(it);
      release(it);
    }

    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= p.s) continue;
      __nv_bfloat16* out = O + (long long)row * p.o_ss + tig * 2;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) = __floats2bfloat162_rn(
            acc[4 * nt + 2 * r] / lc, acc[4 * nt + 2 * r + 1] / lc);
      }
      if (tig == 0) p.lse[((long long)bi * p.hq + h) * p.s + row] = m[r] + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 body: plain FMA.

constexpr int kRowsPerWarp = 8;
constexpr int kBqF = 4 * kRowsPerWarp;   // 32
constexpr int kBkF = 32;

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  constexpr int kCols = HD / 32;         // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // kBqF x HD
  float* sK = sQ + kBqF * HD;                       // kBkF x (HD + 1)
  float* sV = sK + kBkF * (HD + 1);                 // kBkF x HD

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = qt * kBqF;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* Q = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  for (int idx = threadIdx.x; idx < kBqF * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    sQ[idx] = (q_start + r < p.s && d < p.hd) ? Q[(long long)(q_start + r) * p.q_ss + d] : 0.f;
  }

  float acc[kRowsPerWarp][kCols];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const int row0 = q_start + warp * kRowsPerWarp;
  const float* qw = sQ + warp * kRowsPerWarp * HD;

  const int nk = (p.t + kBkF - 1) / kBkF;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * kBkF;
    if (!tile_relevant(p, q_start, kBqF, k_start, kBkF)) continue;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBkF * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const bool in = k_start + r < p.t && d < p.hd;
      sK[r * (HD + 1) + d] = in ? K[(long long)(k_start + r) * p.k_ss + d] : 0.f;
      sV[idx] = in ? V[(long long)(k_start + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = sK + lane * (HD + 1);
    for (int d = 0; d < HD; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qw[r * HD + d], kd, s[r]);
    }
    const int col = k_start + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = attend(p, row0 + r, col);
      const float sv = ok ? score_mod(p, s[r]) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float pr = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = m_new;
      s[r] = pr;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < kBkF; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = sV[j * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

  float* O = static_cast<float*>(p.o) + bi * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= p.s) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (lane + 32 * c < p.hd) O[(long long)row * p.o_ss + lane + 32 * c] = acc[r][c] / lc;
    }
    if (lane == 0) p.lse[((long long)bi * p.hq + h) * p.s + row] = m[r] + logf(lc);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int block_q, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + block_q - 1) / block_q, p.hq, p.b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kBq + 2 * kBk) * (HD + 8) * sizeof(__nv_bfloat16);
  return launch(flash_fwd_bf16<HD>, p, kBq, smem, stream);
}

template <int HD>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kBqF * HD + kBkF * (HD + 1) + kBkF * HD) * sizeof(float);
  return launch(flash_fwd_f32<HD>, p, kBqF, smem, stream);
}

// The Hopper body: the tensor maps (Q in 128-row boxes, K and V in 64-row boxes),
// then the launch.
template <int HD>
int launch_sm90(const Params& p, cudaStream_t st) {
  using Sh = FwdSh<HD>;
  CUtensorMap tq, tk, tv;
  int err = encode_rows(&tq, p.q, HD, p.s, p.hq, p.b, p.q_ss, p.q_sh, p.q_sb, Sh::kOwnRows);
  if (!err) err = encode_rows(&tk, p.k, HD, p.t, p.hkv, p.b, p.k_ss, p.k_sh, p.k_sb,
                              Sh::kStreamRows);
  if (!err) err = encode_rows(&tv, p.v, HD, p.t, p.hkv, p.b, p.v_ss, p.v_sh, p.v_sb,
                              Sh::kStreamRows);
  if (err) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(p.hq, (p.s + Sh::kOwnRows - 1) / Sh::kOwnRows, p.b);
  flash_fwd_sm90<HD><<<grid, kSm90Threads, Sh::kSmemBytes, st>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

// The body's HD for a head dim hd (a multiple of 8 up to 256, the reference's rule
// for its kernel): the least of 32, 64, 128 and 256 that holds it. The fp32 and
// mma.sync bodies run at that HD with the columns past hd masked: loaded as zeros
// (they add nothing to q.k, and o's columns there are never stored), so nothing is
// copied to a padded tensor and the caller's scale stays hd^-0.5 of the true hd.
int body_hd(int hd) {
  if (hd < 8 || hd > 256 || hd % 8) return 0;
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

}  // namespace

// One launch of the body the caller names: 0 = fp32 (flash_fwd_f32), 1 = bf16
// mma.sync (flash_fwd_bf16), 2 = bf16 Hopper (flash_fwd_sm90, hd 64 and 128 only).
// Returns the cudaError_t of the launch (0 on success), 20000 when the driver
// offers no tensor-map encoder and 20001 + the CUresult of a failed encode.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         int b, int hq, int hkv, int s, int t, int hd, int body,
                         int causal, int window, int q_offset, float softcap, float scale,
                         void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.b = b; p.hq = hq; p.hkv = hkv; p.s = s; p.t = t; p.hd = hd;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (body == 2) {
    switch (hd) {
      case 64: return launch_sm90<64>(p, st);
      case 128: return launch_sm90<128>(p, st);
    }
  } else if (body == 1) {
    switch (body_hd(hd)) {
      case 32: return launch_bf16<32>(p, st);
      case 64: return launch_bf16<64>(p, st);
      case 128: return launch_bf16<128>(p, st);
      case 256: return launch_bf16<256>(p, st);
    }
  } else if (body == 0) {
    switch (body_hd(hd)) {
      case 32: return launch_f32<32>(p, st);
      case 64: return launch_f32<64>(p, st);
      case 128: return launch_f32<128>(p, st);
      case 256: return launch_f32<256>(p, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
