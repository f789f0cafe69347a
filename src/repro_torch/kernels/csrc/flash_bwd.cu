// Flash-attention backward for Hopper (sm_90a), written by hand: dq and dk/dv.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (driven there by flash_attention_bwd). Computes exactly what
// they compute, against *given* lse and delta (B, Hq, S) fp32 -- the reference's
// chunk entry, where lse/delta may come from a softmax over more keys than (k, v):
//   s_c = softcap ? softcap * tanh(q.k * scale / softcap) : q.k * scale
//   p   = exp(where(mask, s_c - lse, NEG_INF))          (where before exp)
//   ds  = p * (dO.v - delta) * (softcap ? 1 - tanh^2 : 1)
//   dq  = sum_keys ds * k * scale;  dk = sum_queries ds * q * scale;  dv = sum p * dO
// with GQA (kv head = h / group), causal and sliding-window masks, a query
// position offset, and whole-tile skipping of tile pairs the mask rules out.
//
// Design. The TPU kernels carry their accumulators in VMEM across sequential
// grid steps. Hopper blocks run in parallel and carry nothing, so:
//  - dq (B2): one block owns one (batch, q-head, q-tile), loops over the
//    relevant KV tiles and writes its dq rows once.
//  - dk/dv (B3): one block owns one (batch, kv-head, kv-tile), loops over the
//    group's q-heads and, for each, over the relevant query tiles (the reverse
//    relevance range: the first query tile that can see the tile's first key up
//    to the last one within the window of its last key). dk/dv land on the KV
//    heads directly: no per-q-head fp32 buffer and no group-sum pass.
// Neither uses atomics, so both are deterministic run to run. A fully masked row
// (lse ~ -1e30) gets p = 0 from the mask test before the exp, so dq = 0 there
// and it adds nothing to dk/dv: no inf * 0. Ragged S and T are masked in the
// kernel (zero-filled tile rows); q/k/v/dO/dq/dk/dv go through batch/head/
// sequence strides with the head dim contiguous.
//
// Bodies:
//  - bf16 (mma.sync m16n8k16, bf16 in, fp32 accumulate): 4 warps of 16 rows.
//    dq: 64-row q tiles, 64-key KV tiles; S = Q K^T and dP = dO V^T, then
//    dq += dS K. dk/dv: each warp owns 16 keys and computes the transposed
//    tiles S^T = K Q^T and dP^T = V dO^T over 64-query tiles, then
//    dv += P^T dO and dk += dS^T Q. The accumulators are HD/2 fp32 registers
//    per thread each; at HD 256 two warps share a key row block, each keeping
//    half of the head dim (32-key tiles), so no thread holds more than 128.
//    The reference keeps p and ds in fp32. They enter the second products as
//    two bf16 terms (head + remainder, ~16 bits), which doubles those
//    products' mma count. Both choices were measured once at the training
//    shape (H100 80GB HBM3, 700 W, chip_smoke.py): two terms cost 0-3% more
//    time than one bf16 rounding (2^-9 relative per term) and keep dq, dk and
//    dv within 1 bf16 ulp of the plain version, while one term misses by 268
//    (dq) and 102 (dk/dv) ulps on small values, far outside the stated limit.
//    So the kernels always take two terms.
//  - fp32 (plain FMA on the CUDA cores; TF32 would miss the fp32 tolerance):
//    32-row / 32-key tiles, 4 warps of 8 rows (dq) or 8 keys (dk/dv); lanes own
//    keys (dq) or queries (dk/dv) for the scores and head-dim columns for the
//    accumulators.
// Bound at the training shape (B 1, Hq = Hkv = 20, S = T = 4096, hd 128, causal,
// bf16): dq does 3 products per attended pair (6 hd FLOP), 1.29e11 FLOP =
// 130 us at 989 TFLOP/s; dk/dv 4 products (8 hd FLOP), 1.72e11 FLOP = 174 us;
// the bytes (~105-127 MB each, ~31-38 us at 3.35 TB/s) weigh less. No TMA, no
// wgmma and no load pipeline yet: mma.sync issue rate, the elementwise
// recompute and the loads each tile waits for are the suspects for the gap to
// the bound (~10x, PERF.md), unmeasured.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point flash_bwd at the end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                 // contiguous (B, Hq, S)
  const float* delta;               // contiguous (B, Hq, S)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;       // strides in elements: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
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

// _recompute_ds for one element: raw dot products q.k and dO.v -> (p, ds).
__device__ __forceinline__ void recompute_ds(const Params& p, bool ok, float dot,
                                             float dpv, float lse, float delta,
                                             float& pe, float& dse) {
  const float s = dot * p.scale;
  float sc = s, dtanh = 1.f;
  if (p.softcap != 0.f) {
    const float th = tanhf(s / p.softcap);
    sc = p.softcap * th;
    dtanh = 1.f - th * th;
  }
  pe = ok ? expf(sc - lse) : 0.f;
  dse = pe * (dpv - delta) * dtanh;
}

// The first and one-past-last tile index of a contiguous relevant range: over
// KV tiles for a fixed q tile (over_k) or over q tiles for a fixed KV tile.
// Causality bounds the key range above and the query range below; the window
// bounds them the other way, so either range is one interval.
__device__ __forceinline__ void relevant_range(const Params& p, bool over_k, int fixed_start,
                                               int bq, int bk, int n, int& lo, int& hi) {
  auto rel = [&](int i) {
    return over_k ? tile_relevant(p, fixed_start, bq, i * bk, bk)
                  : tile_relevant(p, i * bq, bq, fixed_start, bk);
  };
  lo = 0;
  while (lo < n && !rel(lo)) ++lo;
  hi = lo;
  while (hi < n && rel(hi)) ++hi;
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16 on the tensor cores.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [row0, row0 + rows) of one (batch, head) slice into a padded
// shared tile, zero-filling rows at or past n_rows.
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

// c = A B^T for one warp: A is 16 rows of the padded tile sA, B the 64 rows of
// sB; both rows hold HD contiguous bf16 values. c[nt] is the m16n8 accumulator
// fragment of columns nt*8 .. nt*8+7.
template <int HD>
__device__ __forceinline__ void warp_abt(float (&c)[8][4], const __nv_bfloat16* sA,
                                         const __nv_bfloat16* sB, int g, int tig) {
  constexpr int kPitch = HD + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
  const __nv_bfloat16* r0 = sA + g * kPitch + tig * 2;
  const __nv_bfloat16* r1 = r0 + 8 * kPitch;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(r0 + kk),
                           *reinterpret_cast<const uint32_t*>(r1 + kk),
                           *reinterpret_cast<const uint32_t*>(r0 + kk + 8),
                           *reinterpret_cast<const uint32_t*>(r1 + kk + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* bp = sB + (nt * 8 + g) * kPitch + kk + tig * 2;
      mma_bf16(c[nt], a, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc += X B for one warp: X is the 16 x 64 fp32 tile x (accumulator fragments,
// as warp_abt leaves them), B the 64 rows of the padded tile sB starting at
// column sB's offset, NT 8-column output tiles. X enters as a bf16 head plus a
// bf16 remainder.
template <int HD, int NT>
__device__ __forceinline__ void warp_xb(float (&acc)[NT][4], const float (&x)[8][4],
                                        const __nv_bfloat16* sB, int lane) {
  constexpr int kPitch = HD + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {          // 16 rows of B per step
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
    split_bf16(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
    split_bf16(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
    const __nv_bfloat16* brow = sB + (j * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, brow + dp * 16);
      mma_bf16(acc[2 * dp], hi, b0, b1);
      mma_bf16(acc[2 * dp + 1], hi, b2, b3);
      mma_bf16(acc[2 * dp], lo, b0, b1);
      mma_bf16(acc[2 * dp + 1], lo, b2, b3);
    }
  }
}

constexpr int kBq = 64;      // bf16 dq: q tile (4 warps x 16 rows); dk/dv: q step
constexpr int kBk = 64;      // bf16 dq: KV tile

// B2, bf16: one block per (batch, q-head, 64-row q tile).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(Params p) {
  constexpr int kPitch = HD + 8;
  constexpr int kDt = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kBq * kPitch;
  __nv_bfloat16* sK = sdO + kBq * kPitch;
  __nv_bfloat16* sV = sK + kBk * kPitch;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal q tiles first
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = qt * kBq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dO =
      static_cast<const __nv_bfloat16*>(p.dout) + bi * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  load_tile_async<HD>(sQ, Q, p.q_ss, q_start, kBq, p.s);
  load_tile_async<HD>(sdO, dO, p.do_ss, q_start, kBq, p.s);
  cp_async_commit_wait();                      // visible to all after the loop's barrier

  const int row_a = q_start + warp * 16 + g;   // rows of fragment elements 0,1 / 2,3
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const long long off = ((long long)bi * p.hq + h) * p.s + row;
    lse[r] = row < p.s ? p.lse[off] : 0.f;
    dl[r] = row < p.s ? p.delta[off] : 0.f;
  }

  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int k_lo, k_hi;
  relevant_range(p, true, q_start, kBq, kBk, (p.t + kBk - 1) / kBk, k_lo, k_hi);
  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int k_start = kt * kBk;
    __syncthreads();                           // every warp is done with K/V of kt-1
    load_tile_async<HD>(sK, K, p.k_ss, k_start, kBk, p.t);
    load_tile_async<HD>(sV, V, p.v_ss, k_start, kBk, p.t);
    cp_async_commit_wait();
    __syncthreads();

    float sc[8][4], dp[8][4];
    warp_abt<HD>(sc, sQ + warp * 16 * kPitch, sK, g, tig);
    warp_abt<HD>(dp, sdO + warp * 16 * kPitch, sV, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = attend(p, row_a + r * 8, k_start + nt * 8 + tig * 2 + (e & 1));
        float pe, dse;
        recompute_ds(p, ok, sc[nt][e], dp[nt][e], lse[r], dl[r], pe, dse);
        sc[nt][e] = dse;
      }
    }
    warp_xb<HD, kDt>(acc, sc, sK, lane);   // dq += dS K
  }

  __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.dq) + bi * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= p.s) continue;
    __nv_bfloat16* out = dQ + (long long)row * p.dq_ss + tig * 2;
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) = __floats2bfloat162_rn(
          acc[dt][2 * r] * p.scale, acc[dt][2 * r + 1] * p.scale);
    }
  }
}

// B3, bf16: one block per (batch, kv-head, KV tile). kSplitN warps share each
// 16-key row block, each keeping HD / kSplitN columns of dk and dv.
template <int HD>
struct DkvShape {
  static constexpr int kSplitN = HD > 128 ? 2 : 1;
  static constexpr int kKeyWarps = 4 / kSplitN;
  static constexpr int kBkv = 16 * kKeyWarps;         // keys per block
  static constexpr int kCols = HD / kSplitN;          // dk/dv columns per warp
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(Params p) {
  using Sh = DkvShape<HD>;
  constexpr int kPitch = HD + 8;
  constexpr int kNt = Sh::kCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + Sh::kBkv * kPitch;
  __nv_bfloat16* sQ = sV + Sh::kBkv * kPitch;
  __nv_bfloat16* sdO = sQ + kBq * kPitch;
  float* sLse = reinterpret_cast<float*>(sdO + kBq * kPitch);
  float* sDl = sLse + kBq;

  const int kt = blockIdx.x;                   // early KV tiles (most queries) first
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int k_start = kt * Sh::kBkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int key_row = (warp % Sh::kKeyWarps) * 16;   // this warp's 16 keys in the tile
  const int col0 = (warp / Sh::kKeyWarps) * Sh::kCols;

  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  load_tile_async<HD>(sK, K, p.k_ss, k_start, Sh::kBkv, p.t);
  load_tile_async<HD>(sV, V, p.v_ss, k_start, Sh::kBkv, p.t);
  cp_async_commit_wait();

  float dk[kNt][4], dv[kNt][4];
#pragma unroll
  for (int i = 0; i < kNt; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key_a = k_start + key_row + g;     // keys of fragment elements 0,1 / 2,3

  int q_lo, q_hi;
  relevant_range(p, false, k_start, kBq, Sh::kBkv, (p.s + kBq - 1) / kBq, q_lo, q_hi);
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dO =
        static_cast<const __nv_bfloat16*>(p.dout) + bi * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((long long)bi * p.hq + h) * p.s;
    const float* dl = p.delta + ((long long)bi * p.hq + h) * p.s;
    for (int qt = q_lo; qt < q_hi; ++qt) {
      const int q_start = qt * kBq;
      __syncthreads();                         // every warp is done with the last Q/dO
      load_tile_async<HD>(sQ, Q, p.q_ss, q_start, kBq, p.s);
      load_tile_async<HD>(sdO, dO, p.do_ss, q_start, kBq, p.s);
      if (threadIdx.x < kBq) {
        const int row = q_start + threadIdx.x;
        sLse[threadIdx.x] = row < p.s ? lse[row] : 0.f;
        sDl[threadIdx.x] = row < p.s ? dl[row] : 0.f;
      }
      cp_async_commit_wait();
      __syncthreads();

      // transposed tiles: rows are this warp's keys, columns the tile's queries
      float sc[8][4], dp[8][4];
      warp_abt<HD>(sc, sK + key_row * kPitch, sQ, g, tig);
      warp_abt<HD>(dp, sV + key_row * kPitch, sdO, g, tig);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nt * 8 + tig * 2 + (e & 1);
          const bool ok = attend(p, q_start + ql, key_a + (e >> 1) * 8);
          float pe, dse;
          recompute_ds(p, ok, sc[nt][e], dp[nt][e], sLse[ql], sDl[ql], pe, dse);
          sc[nt][e] = pe;
          dp[nt][e] = dse;
        }
      }
      warp_xb<HD, kNt>(dv, sc, sdO + col0, lane);   // dv += P^T dO
      warp_xb<HD, kNt>(dk, dp, sQ + col0, lane);    // dk += dS^T Q
    }
  }

  __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.dk) + bi * p.dk_sb + kvh * p.dk_sh;
  __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(p.dv) + bi * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + r * 8;
    if (key >= p.t) continue;
    __nv_bfloat16* ok_ = dK + (long long)key * p.dk_ss + col0 + tig * 2;
    __nv_bfloat16* ov = dV + (long long)key * p.dv_ss + col0 + tig * 2;
#pragma unroll
    for (int dt = 0; dt < kNt; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(ok_ + dt * 8) = __floats2bfloat162_rn(
          dk[dt][2 * r] * p.scale, dk[dt][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(ov + dt * 8) =
          __floats2bfloat162_rn(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 body: plain FMA.

constexpr int kRowsF = 8;                 // rows (dq) or keys (dk/dv) per warp
constexpr int kBF = 4 * kRowsF;           // 32: q tile and KV tile

// Rows [row0, row0 + kBF) of one slice into shared memory with the given pitch,
// zero-filling rows at or past n_rows.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch, const float* src,
                                              long long row_stride, int row0, int n_rows) {
  for (int idx = threadIdx.x; idx < kBF * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    dst[r * pitch + d] = row0 + r < n_rows ? src[(long long)(row0 + r) * row_stride + d] : 0.f;
  }
}

// B2, fp32: one block per (batch, q-head, 32-row q tile); lane j owns key j of
// each KV tile for the scores and columns j, j+32, ... of dq.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(Params p) {
  constexpr int kCols = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // kBF x HD
  float* sdO = sQ + kBF * HD;                       // kBF x HD
  float* sK = sdO + kBF * HD;                       // kBF x (HD + 1)
  float* sV = sK + kBF * (HD + 1);                  // kBF x (HD + 1)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = qt * kBF;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* Q = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const float* dO = static_cast<const float*>(p.dout) + bi * p.do_sb + h * p.do_sh;
  const float* K = static_cast<const float*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  load_tile_f32<HD>(sQ, HD, Q, p.q_ss, q_start, p.s);
  load_tile_f32<HD>(sdO, HD, dO, p.do_ss, q_start, p.s);

  const int row0 = q_start + warp * kRowsF;
  float lse[kRowsF], dl[kRowsF], acc[kRowsF][kCols];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    const long long off = ((long long)bi * p.hq + h) * p.s + row;
    lse[r] = row < p.s ? p.lse[off] : 0.f;
    dl[r] = row < p.s ? p.delta[off] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const float* qw = sQ + warp * kRowsF * HD;
  const float* dow = sdO + warp * kRowsF * HD;

  int k_lo, k_hi;
  relevant_range(p, true, q_start, kBF, kBF, (p.t + kBF - 1) / kBF, k_lo, k_hi);
  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int k_start = kt * kBF;
    __syncthreads();
    load_tile_f32<HD>(sK, HD + 1, K, p.k_ss, k_start, p.t);
    load_tile_f32<HD>(sV, HD + 1, V, p.v_ss, k_start, p.t);
    __syncthreads();

    float s[kRowsF], dp[kRowsF];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) s[r] = dp[r] = 0.f;
    const float* kr = sK + lane * (HD + 1);
    const float* vr = sV + lane * (HD + 1);
    for (int d = 0; d < HD; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        s[r] = fmaf(qw[r * HD + d], kd, s[r]);
        dp[r] = fmaf(dow[r * HD + d], vd, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      float pe;
      recompute_ds(p, attend(p, row0 + r, k_start + lane), s[r], dp[r], lse[r], dl[r],
                   pe, s[r]);
    }
    for (int j = 0; j < kBF; ++j) {
      float kj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kj[c] = sK[j * (HD + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }

  float* dQ = static_cast<float*>(p.dq) + bi * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= p.s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dQ[(long long)row * p.dq_ss + lane + 32 * c] = acc[r][c] * p.scale;
  }
}

// B3, fp32: one block per (batch, kv-head, 32-key tile); each warp owns 8 keys;
// lane i owns query i of each q tile for the scores and columns i, i+32, ...
// of dk and dv.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(Params p) {
  constexpr int kCols = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // kBF x HD
  float* sV = sK + kBF * HD;                        // kBF x HD
  float* sQ = sV + kBF * HD;                        // kBF x (HD + 1)
  float* sdO = sQ + kBF * (HD + 1);                 // kBF x (HD + 1)
  float* sLse = sdO + kBF * (HD + 1);
  float* sDl = sLse + kBF;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int k_start = kt * kBF;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* K = static_cast<const float*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  load_tile_f32<HD>(sK, HD, K, p.k_ss, k_start, p.t);
  load_tile_f32<HD>(sV, HD, V, p.v_ss, k_start, p.t);

  float dk[kRowsF][kCols], dv[kRowsF][kCols];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  const int key0 = k_start + warp * kRowsF;
  const float* kw = sK + warp * kRowsF * HD;
  const float* vw = sV + warp * kRowsF * HD;

  int q_lo, q_hi;
  relevant_range(p, false, k_start, kBF, kBF, (p.s + kBF - 1) / kBF, q_lo, q_hi);
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const float* Q = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const float* dO = static_cast<const float*>(p.dout) + bi * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((long long)bi * p.hq + h) * p.s;
    const float* dl = p.delta + ((long long)bi * p.hq + h) * p.s;
    for (int qt = q_lo; qt < q_hi; ++qt) {
      const int q_start = qt * kBF;
      __syncthreads();
      load_tile_f32<HD>(sQ, HD + 1, Q, p.q_ss, q_start, p.s);
      load_tile_f32<HD>(sdO, HD + 1, dO, p.do_ss, q_start, p.s);
      if (threadIdx.x < kBF) {
        const int row = q_start + threadIdx.x;
        sLse[threadIdx.x] = row < p.s ? lse[row] : 0.f;
        sDl[threadIdx.x] = row < p.s ? dl[row] : 0.f;
      }
      __syncthreads();

      float st[kRowsF], dpt[kRowsF];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) st[r] = dpt[r] = 0.f;
      const float* qr = sQ + lane * (HD + 1);
      const float* dor = sdO + lane * (HD + 1);
      for (int d = 0; d < HD; ++d) {
        const float qd = qr[d], dod = dor[d];
#pragma unroll
        for (int r = 0; r < kRowsF; ++r) {
          st[r] = fmaf(kw[r * HD + d], qd, st[r]);
          dpt[r] = fmaf(vw[r * HD + d], dod, dpt[r]);
        }
      }
      const float lse_i = sLse[lane], dl_i = sDl[lane];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        recompute_ds(p, attend(p, q_start + lane, key0 + r), st[r], dpt[r], lse_i, dl_i,
                     st[r], dpt[r]);
      }
      for (int i = 0; i < kBF; ++i) {
        float qi[kCols], doi[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qi[c] = sQ[i * (HD + 1) + lane + 32 * c];
          doi[c] = sdO[i * (HD + 1) + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRowsF; ++r) {
          const float pi = __shfl_sync(0xffffffffu, st[r], i);
          const float dsi = __shfl_sync(0xffffffffu, dpt[r], i);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv[r][c] = fmaf(pi, doi[c], dv[r][c]);
            dk[r][c] = fmaf(dsi, qi[c], dk[r][c]);
          }
        }
      }
    }
  }

  float* dK = static_cast<float*>(p.dk) + bi * p.dk_sb + kvh * p.dk_sh;
  float* dV = static_cast<float*>(p.dv) + bi * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int key = key0 + r;
    if (key >= p.t) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dK[(long long)key * p.dk_ss + lane + 32 * c] = dk[r][c] * p.scale;
      dV[(long long)key * p.dv_ss + lane + 32 * c] = dv[r][c];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Params& p, int which, int dtype, cudaStream_t st) {
  constexpr size_t kPitchBytes = (HD + 8) * sizeof(__nv_bfloat16);
  if (dtype == 1 && which == 0) {
    const dim3 grid((p.s + kBq - 1) / kBq, p.hq, p.b);
    return launch(flash_bwd_dq_bf16<HD>, p, grid, (2 * kBq + 2 * kBk) * kPitchBytes, st);
  }
  if (dtype == 1) {
    using Sh = DkvShape<HD>;
    const dim3 grid((p.t + Sh::kBkv - 1) / Sh::kBkv, p.hkv, p.b);
    const size_t smem = (2 * Sh::kBkv + 2 * kBq) * kPitchBytes + 2 * kBq * sizeof(float);
    return launch(flash_bwd_dkv_bf16<HD>, p, grid, smem, st);
  }
  const size_t smem = (size_t)(2 * kBF * HD + 2 * kBF * (HD + 1)) * sizeof(float) +
                      (which == 0 ? 0 : 2 * kBF * sizeof(float));
  if (which == 0) {
    const dim3 grid((p.s + kBF - 1) / kBF, p.hq, p.b);
    return launch(flash_bwd_dq_f32<HD>, p, grid, smem, st);
  }
  const dim3 grid((p.t + kBF - 1) / kBF, p.hkv, p.b);
  return launch(flash_bwd_dkv_f32<HD>, p, grid, smem, st);
}

}  // namespace

// One launch: which = 0 runs the dq kernel (writes dq), which = 1 the dk/dv
// kernel (writes dk and dv). dtype: 0 = fp32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long do_sb, long long do_sh, long long do_ss,
                         long long dq_sb, long long dq_sh, long long dq_ss,
                         long long dk_sb, long long dk_sh, long long dk_ss,
                         long long dv_sb, long long dv_sh, long long dv_ss,
                         int b, int hq, int hkv, int s, int t, int hd, int dtype,
                         int causal, int window, int q_offset, float softcap, float scale,
                         int which, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.b = b; p.hq = hq; p.hkv = hkv; p.s = s; p.t = t;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<32>(p, which, dtype, st);
    case 64: return launch_hd<64>(p, which, dtype, st);
    case 128: return launch_hd<128>(p, which, dtype, st);
    case 256: return launch_hd<256>(p, which, dtype, st);
  }
  return (int)cudaErrorInvalidValue;
}
