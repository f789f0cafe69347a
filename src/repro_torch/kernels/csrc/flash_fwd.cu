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
// Two bodies:
//  - flash_fwd_bf16<HD>: bf16 inputs. 4 warps x 16 query rows = 64-row q tile, 64-key
//    KV tiles. Q.K^T and P.V run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate). The reference keeps P in fp32; here P enters the second
//    product as two bf16 terms (head + remainder, ~16 bits), which doubles that
//    product's mma count but keeps the kernel's rounding at the reference's
//    (one rounding of O to bf16). Tiles sit in
//    padded shared memory (conflict-free fragment loads; V fragments via
//    ldmatrix.trans), filled by cp.async in a two-step pipeline (V of a tile loads
//    while its scores are computed, K of the next tile while P.V runs). Tiles wholly
//    inside the mask skip the per-element mask test. No TMA and no wgmma yet, so the
//    kernel is bound by mma.sync issue rate and the softmax's instruction count,
//    well below the card's bf16 rate (989 TFLOP/s dense). At the serving shape
//    (B 4, Hq 40, Hkv 8, S = T = 1000, hd 128, causal) the work is 4.1e10 FLOP,
//    a 41.5 us bound by operations; the bytes (~98 MB, 29 us at 3.35 TB/s) weigh less.
//  - flash_fwd_f32<HD>: fp32 inputs, plain fp32 FMA on the CUDA cores (the reference
//    computes in fp32, and TF32 would miss its 3e-5 tolerance). 4 warps x 8 rows,
//    32-key tiles; lane j owns key j for the scores and head-dim columns j, j+32, ...
//    for the output. Bound by the 67 TFLOP/s fp32 rate at best; not on the serving path.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point flash_fwd at the end of this file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
  int causal, window, q_offset;
  float softcap, scale;
};

// _tile_relevant: can any (query, key) pair of this tile pair attend?
__device__ __forceinline__ bool tile_relevant(const Params& p, int q_start, int bq,
                                              int k_start, int bk) {
  bool rel = true;
  if (p.causal) rel = k_start <= p.q_offset + q_start + bq - 1;
  if (p.window > 0) rel = rel && (k_start + bk - 1 > p.q_offset + q_start - p.window);
  return rel;
}

// _tile_mask for one element: row_l is the local query index, col the key index.
__device__ __forceinline__ bool attend(const Params& p, int row_l, int col) {
  if (row_l >= p.s || col >= p.t) return false;
  const int row_g = p.q_offset + row_l;
  if (p.causal && col > row_g) return false;
  if (p.window > 0 && row_g - col >= p.window) return false;
  return true;
}

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

// (x0, x1) -> bf16x2 head (rounded) and bf16x2 remainder, x ~ head + remainder.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
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
// shared tile with 16-byte cp.async copies, zero-filling rows at or past n_rows.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int rows,
                                                int n_rows) {
  constexpr int kChunks = HD / 8;        // 16-byte chunks per row
  constexpr int kPitch = HD + 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < n_rows;
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
  load_tile_async<HD>(sQ, Q, p.q_ss, q_start, kBq, p.s);
  if (k_lo < k_hi) load_tile_async<HD>(sK, K, p.k_ss, k_lo * kBk, kBk, p.t);
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
    load_tile_async<HD>(sV, V, p.v_ss, k_start, kBk, p.t);
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
      load_tile_async<HD>(sK, K, p.k_ss, k_start + kBk, kBk, p.t);
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
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * r] / lc, acc[dt][2 * r + 1] / lc);
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
    sQ[idx] = (q_start + r < p.s) ? Q[(long long)(q_start + r) * p.q_ss + d] : 0.f;
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
      const bool in = k_start + r < p.t;
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
    for (int c = 0; c < kCols; ++c) O[(long long)row * p.o_ss + lane + 32 * c] = acc[r][c] / lc;
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

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32, 1 = bf16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         int b, int hq, int hkv, int s, int t, int hd, int dtype,
                         int causal, int window, int q_offset, float softcap, float scale,
                         void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.b = b; p.hq = hq; p.hkv = hkv; p.s = s; p.t = t;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == 1) {
    switch (hd) {
      case 32: return launch_bf16<32>(p, st);
      case 64: return launch_bf16<64>(p, st);
      case 128: return launch_bf16<128>(p, st);
      case 256: return launch_bf16<256>(p, st);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(p, st);
      case 64: return launch_f32<64>(p, st);
      case 128: return launch_f32<128>(p, st);
      case 256: return launch_f32<256>(p, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
