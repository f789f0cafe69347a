// Shared pieces of the SSD chunk scan's Hopper bodies: ssd_fwd.cu (B5) and
// ssd_bwd.cu (B6) include it once each (build.py hashes it into both libraries).
//
// Both bodies first run the states pass here: one block per (batch, head) walks
// its chunks, computes each chunk's own increment on the tensor cores and carries
// the (P, N) state (forward) or its cotangent (backward) in registers, writing it
// once per chunk. Then the chunk-parallel output (ssd_fwd.cu) or gradient
// (ssd_bwd.cu) kernels read those states. This header also holds what those share:
// the shape the bodies take (chunk 128, P 64, N 64 or 128), the 128-byte swizzled
// bf16 tiles that wgmma reads (filled by cp.async from the strided inputs, or by
// threads from fp32 values split into a bf16 head and a bf16 remainder), the wgmma
// wrappers with either operand's major-ness, and the chunk's cumulative log-decays.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int kQ = 128;                  // the chunk the Hopper bodies take
constexpr int kP = 64;                   // the head dim P they take
constexpr int kTile = kQ * 128;          // bytes of one 64-column box of a 128-row bf16 tile
constexpr int kStateBox = kP * 128;      // ... of a 64-row (P x N state) bf16 tile
constexpr int kHalf = 64 * 128;          // bytes from a 128-row tile's row 0 to its row 64

// wgmma's accumulator operands: the register list and its constraints.
#define SSD_REGS32 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SSD_ACC32(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])
#define SSD_REGS64 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SSD_ACC64(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
    "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D (64 x 64 or 64 x 128, fp32) += A B, A and B bf16 from shared memory through
// descriptors; TA / TB are 1 where that operand is MN-major (its rows run along
// the contraction), 0 where it is K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SSD_ACC32(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SSD_REGS64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SSD_ACC64(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D += A B with A (64 x 16 bf16) from registers in the m64k16 fragment layout.
template <int TB>
__device__ __forceinline__ void mma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SSD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SSD_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SSD_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// The same, by output width N (64 or 128).
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) mma_ss128<TA, TB>(d, da, db); else mma_ss64<TA, TB>(d, da, db);
}

template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) mma_rs128<TB>(d, a, db); else mma_rs64<TB>(d, a, db);
}

// Descriptor of a K-major operand: the 16 contraction columns from `k` (a multiple
// of 16) of the 64 rows at `rows` of a tile whose 64-column boxes are `box` bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t rows, int k, int box) {
  return sw128_desc(rows + (k >> 6) * box + ((k & 63) >> 3) * 16, 16);
}

// Descriptor of an MN-major operand: the 16 contraction rows from `k` (a multiple
// of 16) at `tile`, whose 64-column boxes (along M or N) are `box` bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k, int box) {
  return sw128_desc(tile + k * 128, box);
}

template <int R, int C>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(f[i][j]) :: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The accumulator layout of a warpgroup's 64-row wgmma result: element i of
// thread (warp, lane) sits at row 16 warp + lane / 4 + acc_row8(i) and column
// acc_col(i, lane); elements i and i + 1 (i even) are neighbours in a row.
__device__ __forceinline__ int acc_row8(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Byte offset of element (r, c) of a bf16 tile of `rows` rows stored as 64-column
// boxes of 128-byte rows in the 128-byte swizzle (the layout wgmma reads).
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                    ((c & 7) << 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// Waits for this thread's cp.async copies and makes every thread's shared-memory
// writes visible to wgmma (the async proxy); ends with __syncthreads.
__device__ __forceinline__ void tiles_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_smem();
  __syncthreads();
}

// Rows [0, nrows) of a bf16 (rows, W) slice with row stride `stride` (elements),
// from `src` on, into the first nrows rows of a swizzled tile of `tile_rows` rows,
// by cp.async; rows at or past `live` are zero.
template <int W>
__device__ __forceinline__ void load_rows(uint32_t tile, int tile_rows, const __nv_bfloat16* src,
                                          long long stride, int nrows, int live, int tid,
                                          int nthr) {
  constexpr int kPieces = W / 8;                       // 16-byte pieces of a row
  for (int idx = tid; idx < nrows * kPieces; idx += nthr) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const bool ok = r < live;
    cp_async16(tile + sw_off(r, c, tile_rows), src + (ok ? r * stride + c : 0), ok ? 16 : 0);
  }
}

// fp32 values (a, b) at columns (c, c + 1) of a row: the bf16 heads into one tile,
// the bf16 remainders into another, at the same offset.
__device__ __forceinline__ void st_split(uint32_t hi, uint32_t lo, uint32_t off, float a,
                                         float b) {
  uint32_t h, l;
  split_bf16(a, b, h, l);
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(hi + off), "r"(h) : "memory");
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(lo + off), "r"(l) : "memory");
}

// fp32 rows (16-byte aligned, `stride` floats apart, zero at or past `live`) into
// split tiles of `rows` rows, W columns. Each thread issues kSplitBatch loads
// before its stores: the stores are asm with a memory clobber, which keeps the
// compiler from hoisting the next load above them. `dot` (if given) receives this
// thread's sum of the loaded values times `other` at the same offsets, in the
// order loaded.
constexpr int kSplitBatch = 4;

template <int W>
__device__ __forceinline__ void split_rows(uint32_t hi, uint32_t lo, const float* src,
                                           long long stride, int rows, int live, int tid,
                                           int nthr, const float* other = nullptr,
                                           float* dot = nullptr) {
  const int total = rows * (W / 4);
  for (int base = tid; base < total; base += kSplitBatch * nthr) {
    float4 v[kSplitBatch], o[kSplitBatch];
#pragma unroll
    for (int k = 0; k < kSplitBatch; ++k) {
      const int idx = base + k * nthr, r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      v[k] = o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && r < live) {
        v[k] = *reinterpret_cast<const float4*>(src + r * stride + c);
        if (other) o[k] = *reinterpret_cast<const float4*>(other + r * stride + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kSplitBatch; ++k) {
      const int idx = base + k * nthr, r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      if (idx < total) {
        st_split(hi, lo, sw_off(r, c, rows), v[k].x, v[k].y);
        st_split(hi, lo, sw_off(r, c + 2, rows), v[k].z, v[k].w);
        if (dot) {
          *dot = fmaf(v[k].x, o[k].x, *dot);
          *dot = fmaf(v[k].y, o[k].y, *dot);
          *dot = fmaf(v[k].z, o[k].z, *dot);
          *dot = fmaf(v[k].w, o[k].w, *dot);
        }
      }
    }
  }
}

// Two neighbouring bf16 values of a tile, widened.
__device__ __forceinline__ float2 ld_bf16x2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Sum over the four lanes of a quad (the lanes that share an accumulator row), in
// a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Inclusive prefix sum of v[0, kQ) in place, by one whole warp: each lane sums 4
// consecutive entries, the lane totals are scanned with shuffles.
__device__ __forceinline__ void warp_scan(float* v, int lane) {
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += v[lane * 4 + k];
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[lane * 4 + k] = excl + loc[k];
}

// The chunk's dt (0 past len) into dt_s and cs = cumsum(dt a) into cs_s; every
// thread of the block calls it (at least kQ of them); ends with __syncthreads.
__device__ __forceinline__ void chunk_cs(const float* dtp, long long sdl, float a, int len,
                                         float* dt_s, float* cs_s, int tid) {
  if (tid < kQ) {
    const float d = tid < len ? dtp[tid * sdl] : 0.f;
    dt_s[tid] = d;
    cs_s[tid] = d * a;
  }
  __syncthreads();
  if (tid < 32) warp_scan(cs_s, tid);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The states pass (pass 1 of both bodies): one block per (batch, head) walks its chunks in order
// (forward) or in reverse (backward), N / 64 warpgroups each holding 64 columns of
// the (P, N) state (or its cotangent) in registers. Per chunk it computes the
// chunk's own increment sum_j u[j, p] wt_j v[j, n] — forward u = x, v = B,
// wt = dt exp(cs[-1] - cs); backward u = dy, v = C, wt = exp(cs) — as one wgmma
// product (u o wt the A operand from registers, transposed and split into a bf16
// head and remainder: two products; v the exact bf16 B operand), writes the state entering
// the chunk (forward) or the cotangent of the state leaving it (backward) to `out`,
// then S <- exp(cs[-1]) S + increment, the reference's order. The next chunk's u and
// v tiles load by cp.async into the other of two stages while this one computes;
// each state is written once, so no (B, H, nc, P, N) increments round-trip
// through memory. (A chunk-parallel increment kernel followed by an elementwise
// state pass measured slower at every path shape: PERF.md.)
struct StateParams {
  const void* u; long long sub, suh, sul;      // x (bf16) or dy (fp32), P contiguous
  const float* dt; long long sdb, sdh, sdl;
  const float* a;
  const __nv_bfloat16* v; long long svb, svg, svl;   // B or C, N contiguous
  const float* seed;                           // backward: dS_final (B, H, P, N)
  float* out;                                  // (B, H, nc, P, N)
  float* final_state;                          // forward: (B, H, P, N)
  int heads, groups, len;
};

template <int N, bool kFwd>
struct StatesSh {
  static constexpr int kEsz = kFwd ? 2 : 4;                  // bytes of a u element
  static constexpr int kURow = kP * kEsz + 16;               // bytes of a u row (padded)
  static constexpr int kStage = kQ * N * 2 + kQ * kURow;     // the v tile, then u
  static constexpr int kBytes = 1024 + 2 * kStage + 3 * kQ * 4;
};

template <int N, bool kFwd>
__global__ void __launch_bounds__(N / 64 * kWg) ssd_states(const StateParams P) {
  using Sh = StatesSh<N, kFwd>;
  constexpr int kThreads = N / 64 * kWg;
  constexpr int kUPieces = kP * Sh::kEsz / 16;               // 16-byte pieces of a u row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  float* dt_s = reinterpret_cast<float*>(smem_raw + (base - raw) + 2 * Sh::kStage);
  float* cs_s = dt_s + kQ;
  float* wt_s = cs_s + kQ;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (P.heads / P.groups);
  const int tid = threadIdx.x, wg = tid / kWg, warp = (tid % kWg) / 32, lane = tid % 32;
  const int nc = (P.len + kQ - 1) / kQ;
  const long long bh = (long long)bi * P.heads + h;
  const float a = P.a[h];
  const float* dtp = P.dt + bi * P.sdb + h * P.sdh;
  const __nv_bfloat16* vp = P.v + bi * P.svb + g * P.svg;
  const unsigned char* up =
      static_cast<const unsigned char*>(P.u) + (bi * P.sub + h * P.suh) * Sh::kEsz;

  auto issue = [&](int c, int stage) {          // chunk c's tiles into a stage
    const int t0 = c * kQ, live = min(kQ, P.len - t0);
    const uint32_t v_tile = base + stage * Sh::kStage;
    const uint32_t u_tile = v_tile + kQ * N * 2;
    load_rows<N>(v_tile, kQ, vp + t0 * P.svl, P.svl, kQ, live, tid, kThreads);
    for (int idx = tid; idx < kQ * kUPieces; idx += kThreads) {
      const int r = idx / kUPieces, q = idx % kUPieces;
      const bool ok = r < live;
      cp_async16(u_tile + r * Sh::kURow + q * 16,
                 up + (ok ? (t0 + r) * P.sul * Sh::kEsz + q * 16 : 0), ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int m0 = 16 * warp + lane / 4;          // state rows (p) m0 and m0 + 8
  float st[32];                                 // this warpgroup's 64 x 64 of the state
  if constexpr (kFwd) {
    zero(st);
  } else {
    const float* sp = P.seed + bh * (long long)(kP * N);
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = sp[(m0 + acc_row8(i)) * N + 64 * wg + acc_col(i, lane)];
  }
  const int step = kFwd ? 1 : -1;
  int c = kFwd ? 0 : nc - 1;
  issue(c, 0);
  for (int k = 0; k < nc; ++k, c += step) {
    const int stage = k & 1;
    const int t0 = c * kQ, len = min(kQ, P.len - t0);
    if (k + 1 < nc) issue(c + step, stage ^ 1);
    if (tid < kQ) {
      const float d = tid < len ? dtp[(t0 + tid) * P.sdl] : 0.f;
      dt_s[tid] = d;
      cs_s[tid] = d * a;
    }
    __syncthreads();
    if (tid < 32) warp_scan(cs_s, tid);
    __syncthreads();
    const float cs_last = cs_s[kQ - 1];
    if (tid < kQ) wt_s[tid] = kFwd ? dt_s[tid] * expf(cs_last - cs_s[tid]) : expf(cs_s[tid]);
    if (k + 1 < nc)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    fence_async_smem();
    __syncthreads();

    const uint32_t v_tile = base + stage * Sh::kStage;
    const unsigned char* u_s = gbase + stage * Sh::kStage + kQ * N * 2;
    auto u_at = [&](int j, int p) -> float {
      const unsigned char* at = u_s + j * Sh::kURow + p * Sh::kEsz;
      if constexpr (kFwd) return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(at));
      else return *reinterpret_cast<const float*>(at);
    };
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 8 * (r & 1);
        const int j = 16 * s + 2 * (lane & 3) + 8 * (r >> 1);
        split_bf16(u_at(j, m) * wt_s[j], u_at(j + 1, m) * wt_s[j + 1], hi[s][r], lo[s][r]);
      }
    }
    float acc[32];
    zero(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint64_t dv = desc_mn(v_tile + wg * kTile, 16 * s, kTile);
      mma_rs64<1>(acc, hi[s], dv);
      mma_rs64<1>(acc, lo[s], dv);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_frags(hi);
    fence_frags(lo);
    float* op = P.out + (bh * nc + c) * (long long)(kP * N) + 64 * wg;
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      *reinterpret_cast<float2*>(op + (m0 + acc_row8(i)) * N + acc_col(i, lane)) =
          make_float2(st[i], st[i + 1]);
      st[i] = st[i] * decay + acc[i];
      st[i + 1] = st[i + 1] * decay + acc[i + 1];
    }
    __syncthreads();                            // this stage's readers are done
  }
  if constexpr (kFwd) {
    float* fp = P.final_state + bh * (long long)(kP * N) + 64 * wg;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(fp + (m0 + acc_row8(i)) * N + acc_col(i, lane)) =
          make_float2(st[i], st[i + 1]);
  }
}

template <class Kernel>
int set_smem(Kernel k, int bytes) {
  if (int err = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return err;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, bool kFwd>
int launch_states(const StateParams& p, int batch, cudaStream_t st) {
  constexpr int bytes = StatesSh<N, kFwd>::kBytes;
  if (int err = set_smem(ssd_states<N, kFwd>, bytes)) return err;
  ssd_states<N, kFwd><<<dim3(p.heads, batch), N / 64 * kWg, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
