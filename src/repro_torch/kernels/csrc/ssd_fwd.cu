// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_fwd_kernel (driven
// there by _ssd_forward). Computes what it computes, head-major: for x (B, H, L, P),
// dt (B, H, L) fp32, A (H,) fp32, B/C (B, G, L, N) per group (head h reads group
// h / (H / G)), per chunk of q positions with cs = cumsum(dt * A):
//   L[i, j]  = exp(cs[i] - cs[j]) for j <= i, else 0 (the mask comes before the exp:
//              the upper entries hold positive log-decays that overflow fp32)
//   y        = (C B^T o L) (x dt) + exp(cs) o (C state^T)
//   state'   = exp(cs[-1]) state + ((x dt) o exp(cs[-1] - cs))^T B
// and writes y (B, H, L, P) fp32 through strides, the final state (B, H, P, N) fp32
// and, when the backward will need them, the state entering each chunk
// (B, H, nc, P, N) fp32. A length that is not a multiple of the chunk is read with a
// masked load of its last chunk: positions past L read dt = 0 and x = B = C = 0,
// exactly the reference's padding with dt = 0 steps (decay 1, no input), and their
// y is not written. Two bodies, chosen by the wrapper's rule (ssd_scan.ssd_body).
//
// The Hopper body, ssd_fwd_sm90 (bf16 x, B, C; chunk 128, P 64, N 64 or 128; rows
// 16-byte aligned). The recurrence between chunks touches only the (P, N) state,
// so the TPU kernel's sequential walk over chunks becomes two launches; the heavy
// one runs parallel over (half chunk, head, batch) — 8,192 blocks at mamba2's
// training microbatch, 16,128 at its 4 x 8000 forward, against 128 (batch, head)
// blocks:
//  1. ssd_states<N, true> (ssd_sm90.cuh), one block per (batch, head) walking its
//     chunks in order: reads x, dt, A and B; writes the state entering each chunk
//     into `states` (fp32) and the final state. Per chunk, the chunk's own
//     increment ((x dt) o exp(cs[-1] - cs))^T B is one tensor-core product (wgmma
//     m64n64k16 per 64 state columns: (x o w)^T the A operand from registers,
//     split into a bf16 head and remainder, B the exact bf16 operand), and the
//     state in registers advances S <- exp(cs[-1]) S + increment in the reference's
//     order; the next chunk's x and B load by cp.async under this one's product.
//  2. ssd_fwd_out<N>, one warpgroup per half chunk (64 rows i; grid (2 nc, H, B),
//     so two or three blocks share an SM and one's loads run under another's
//     products): reads x, dt, A, B, C and the entering state; writes y. Per half,
//     C B_jb^T for the column blocks jb <= half (exact: bf16 products accumulate in fp32),
//     scores' = C B^T o L o dt_j on the fp32 side (mask, then exp), scores' x_jb
//     with scores' split in two (x stays exact), and C S^T with S split in two; y =
//     that + exp(cs_i) C S^T.
// So dt and every decay sit on the fp32 side of each product, whose other operand
// is an exact bf16 x, B or C; every fp32 operand enters as a bf16 head plus a bf16
// remainder (~2^-17 relative); TF32 is never used. The tiles (x, B, C) arrive by
// cp.async (16 bytes a thread, zero-filled past L) in the 128-byte swizzle that
// wgmma reads; fp32 values (S) are split by threads into tiles of the same layout.
// No atomics: every sum runs in a fixed order, so two launches give the same bits.
// Shared memory: 100,352 bytes for the output kernel at N 128 (two blocks per SM),
// 59,392 at N 64; 104,960 for the states pass (two stages). `passes` selects either
// launch, for checking and timing each on its own.
//
// The first version, ssd_fwd (everything else: fp32, other chunks, P or N): one
// block per (batch, head) walks its chunks in order, the state held in shared
// memory, grid (H, B), 256 threads. A chunk's B and C (q x N), x dt (q x P) and the
// state (P x N) sit in shared memory as fp32, rows padded to a multiple of 4 plus 4,
// so the products that contract over N read both operands as float4; the (q, q)
// score matrix is built in row strips of 32 (one warp owns 4 rows of a strip, its
// lanes the columns), each strip feeding that strip's rows of y at once (221,824
// bytes of shared memory at q 128, P 64, N 128). Every product is an fp32 FMA on the
// CUDA cores. Chunks from 1 to 128, P up to 64 and N up to 128 are taken; any other
// shape is refused (cudaErrorInvalidValue) and the wrapper raises.
//
// Bound. At mamba2-370m's serving shape (B 4, H 32, L 8000, P 64, N 128, q 128)
// the scan needs ~3.6 M multiply-adds per (batch, head, chunk), the causal half of
// each (q, q) product counted: ~59 GFLOP over the 8,064 units, 0.06 ms at the
// tensor cores' 989 TFLOP/s, and ~418 MB of traffic
// (mostly the fp32 y), 0.125 ms at 3.35 TB/s: bytes bound it. The Hopper body moves
// the entering states twice more (written by pass 1, read by pass 2) and is bound in
// practice by latency: a block runs its loads, products and stores in turn, and only
// two or three fit on an SM (PERF.md).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point ssd_fwd at the end of this file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;                   // rows of a score strip
constexpr int kRowsPerWarp = kStrip / kWarps;
constexpr int kQMax = 128, kPMax = 64, kNMax = 128;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a . b over four consecutive contraction steps, in their order
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct FwdParams {
  const void* x; const float* dt; const float* a; const void* b; const void* c;
  float* y; float* enters; float* final_state;
  long long sxb, sxh, sxl;        // x strides in elements (P contiguous)
  long long sdb, sdh, sdl;        // dt
  long long sbb, sbg, sbl;        // B (N contiguous)
  long long scb, scg, scl;        // C
  long long syb, syh, syl;        // y (P contiguous)
  int heads, groups, len, p, n, chunk;
};

// Inclusive prefix sum of v[0, q) in place (q <= 128), by one whole warp: each lane
// sums 4 consecutive entries, the lane totals are scanned with shuffles.
__device__ __forceinline__ void warp_cumsum(float* v, int q, int lane) {
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    run += (i < q) ? v[i] : 0.f;
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
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    if (i < q) v[i] = excl + loc[k];
  }
}

// Row strides: N and P rounded up to 4 (zero-filled) plus 4, so rows start 16-byte
// aligned and float4 loads of 8 consecutive rows (a quarter-warp) hit all 32 banks.
size_t fwd_smem_floats(int q, int p, int n) {
  return (size_t)q * (round4(n) + 4) * 2 + (size_t)q * (round4(p) + 4) +
         (size_t)p * (round4(n) + 4) + (size_t)kStrip * (q + 1) + 3 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_kernel(FwdParams P) {
  extern __shared__ float smem[];
  const int q = P.chunk, np = P.p, nn = P.n;
  const int n4 = round4(nn);
  const int ldn = n4 + 4, ldp = round4(np) + 4, ldq = q + 1;
  float* sB = smem;                      // q x ldn
  float* sC = sB + q * ldn;              // q x ldn
  float* sX = sC + q * ldn;              // q x ldp: x * dt
  float* sS = sX + q * ldp;              // np x ldn: the running state
  float* sT = sS + np * ldn;             // kStrip x ldq: a strip of C B^T o L
  float* sCs = sT + kStrip * ldq;        // q: dt * A, then its cumsum
  float* sW = sCs + q;                   // q: dt, then exp(cs[-1] - cs)
  float* sE = sW + q;                    // q: exp(cs)

  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (P.heads / P.groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xp = static_cast<const T*>(P.x) + bi * P.sxb + h * P.sxh;
  const float* dtp = P.dt + bi * P.sdb + h * P.sdh;
  const T* bp = static_cast<const T*>(P.b) + bi * P.sbb + g * P.sbg;
  const T* cp = static_cast<const T*>(P.c) + bi * P.scb + g * P.scg;
  float* yp = P.y + bi * P.syb + h * P.syh;
  const float a = P.a[h];
  const int nc = (P.len + q - 1) / q;
  const long long bh = (long long)bi * P.heads + h;

  for (int i = tid; i < np * ldn; i += kThreads) sS[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * q;
    const int len = min(q, P.len - t0);
    __syncthreads();                     // the last chunk's readers are done
    for (int i = tid; i < q; i += kThreads) {
      const float d = i < len ? dtp[(long long)(t0 + i) * P.sdl] : 0.f;
      sW[i] = d;
      sCs[i] = d * a;
    }
    __syncthreads();
    if (warp == 0) warp_cumsum(sCs, q, lane);
    for (int idx = tid; idx < q * n4; idx += kThreads) {
      const int i = idx / n4, j = idx - i * n4;
      const long long off = (long long)(t0 + i);
      const bool live = i < len && j < nn;
      sB[i * ldn + j] = live ? ld(bp + off * P.sbl + j) : 0.f;
      sC[i * ldn + j] = live ? ld(cp + off * P.scl + j) : 0.f;
    }
    for (int idx = tid; idx < q * np; idx += kThreads) {
      const int i = idx / np, j = idx - i * np;
      const float xv = i < len ? ld(xp + (long long)(t0 + i) * P.sxl + j) : 0.f;
      sX[i * ldp + j] = xv * sW[i];
    }
    if (P.enters) {
      float* ep = P.enters + (bh * nc + c) * (long long)np * nn;
      for (int idx = tid; idx < np * nn; idx += kThreads)
        ep[idx] = sS[(idx / nn) * ldn + idx % nn];
    }
    __syncthreads();
    const float cs_last = sCs[q - 1];
    for (int i = tid; i < q; i += kThreads) {
      sW[i] = expf(cs_last - sCs[i]);
      sE[i] = expf(sCs[i]);
    }
    __syncthreads();

    // y, one strip of kStrip rows at a time; a warp owns kRowsPerWarp rows
    for (int r0 = 0; r0 < len; r0 += kStrip) {
      const int ib = r0 + warp * kRowsPerWarp;       // this warp's first row
      const int jmax = min(r0 + kStrip, q);          // strip columns j < jmax
      if (ib < len) {
        float acc[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
        for (int m = 0; m < n4; m += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) cv[r] = ld4(sC + min(ib + r, q - 1) * ldn + m);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (32 * k < jmax) {
              const float4 bv = ld4(sB + min(lane + 32 * k, q - 1) * ldn + m);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) acc[r][k] = dot4(acc[r][k], cv[r], bv);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = ib + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            if (j < jmax) {
              float v = 0.f;
              if (i < len && j <= i) v = acc[r][k] * expf(sCs[i] - sCs[j]);
              sT[(warp * kRowsPerWarp + r) * ldq + j] = v;
            }
          }
        }
        __syncwarp();
        // y[i, p] = sum_j S[i, j] xd[j, p] + exp(cs_i) sum_n C[i, n] state[p, n]
        float ya[kRowsPerWarp][2], yo[kRowsPerWarp][2];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 2; ++k) ya[r][k] = yo[r][k] = 0.f;
        const int jw = min(ib + kRowsPerWarp, len);   // S[i, j] = 0 for j > i
        for (int j = 0; j < jw; ++j) {
          float sv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) sv[r] = sT[(warp * kRowsPerWarp + r) * ldq + j];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float xv = sX[j * ldp + min(lane + 32 * k, np - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) ya[r][k] = fmaf(sv[r], xv, ya[r][k]);
          }
        }
        for (int m = 0; m < n4; m += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) cv[r] = ld4(sC + min(ib + r, q - 1) * ldn + m);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 st = ld4(sS + min(lane + 32 * k, np - 1) * ldn + m);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) yo[r][k] = dot4(yo[r][k], cv[r], st);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = ib + r;
          if (i < len) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int pp = lane + 32 * k;
              if (pp < np) yp[(long long)(t0 + i) * P.syl + pp] = ya[r][k] + sE[i] * yo[r][k];
            }
          }
        }
      }
      __syncthreads();                   // the strip buffer is rewritten next
    }

    // state' = exp(cs[-1]) state + sum_j (xd[j] exp(cs[-1] - cs[j])) (x) B[j]
    {
      const float dec = expf(cs_last);
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < len; ++j) {
        float xw[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) xw[r] = sX[j * ldp + min(warp + 8 * r, np - 1)] * sW[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float bv = sB[j * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][k] = fmaf(xw[r], bv, acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int pp = warp + 8 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m = lane + 32 * k;
          if (pp < np && m < nn) sS[pp * ldn + m] = sS[pp * ldn + m] * dec + acc[r][k];
        }
      }
    }
  }
  __syncthreads();
  float* fp = P.final_state + bh * (long long)np * nn;
  for (int idx = tid; idx < np * nn; idx += kThreads) fp[idx] = sS[(idx / nn) * ldn + idx % nn];
}

template <typename T>
int launch(const FwdParams& p, int batch, cudaStream_t st) {
  const size_t bytes = fwd_smem_floats(p.chunk, p.p, p.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<T><<<dim3(p.heads, batch), kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, B and C); dt, A and every output fp32. enters may be
// null (forward-only calls skip that write). Returns a cudaError_t code.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, void* y, void* enters, void* final_state,
                       long long sxb, long long sxh, long long sxl,
                       long long sdb, long long sdh, long long sdl,
                       long long sbb, long long sbg, long long sbl,
                       long long scb, long long scg, long long scl,
                       long long syb, long long syh, long long syl,
                       int batch, int heads, int groups, int len, int p, int n,
                       int chunk, int dtype, void* stream) {
  if (chunk < 1 || chunk > kQMax || p < 1 || p > kPMax || n < 1 || n > kNMax ||
      groups < 1 || heads % groups || len < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  FwdParams P;
  P.x = x; P.dt = static_cast<const float*>(dt); P.a = static_cast<const float*>(a);
  P.b = b; P.c = c;
  P.y = static_cast<float*>(y); P.enters = static_cast<float*>(enters);
  P.final_state = static_cast<float*>(final_state);
  P.sxb = sxb; P.sxh = sxh; P.sxl = sxl;
  P.sdb = sdb; P.sdh = sdh; P.sdl = sdl;
  P.sbb = sbb; P.sbg = sbg; P.sbl = sbl;
  P.scb = scb; P.scg = scg; P.scl = scl;
  P.syb = syb; P.syh = syh; P.syl = syl;
  P.heads = heads; P.groups = groups; P.len = len; P.p = p; P.n = n; P.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == 0) return launch<float>(P, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(P, batch, st);
  return (int)cudaErrorInvalidValue;
}

// ===========================================================================
// The Hopper body (bf16 x, B, C at chunk 128, P 64, N 64 or 128): three passes,
// parallel over chunks (see the note at the top of this file).

namespace {

// Pass 3: y of one half of a chunk (rows i in [64 half, 64 half + 64)) from the
// state entering the chunk, one warpgroup per block, grid (2 nc, H, B), so that two
// blocks share an SM and one's loads run under the other's products:
//   yo = C_i S^T           (C exact, S split: two products)
//   y  = sum_{jb <= half} (C_i B_jb^T o L o dt_j) x_jb + exp(cs_i) yo
// C B^T is exact on bf16 inputs; the scores (fp32) enter split in two. The block
// holds its own 64 rows of C and the rows j < 64 (half + 1) of B and x.
struct OutParams {
  const __nv_bfloat16* x; long long sxb, sxh, sxl;
  const float* dt; long long sdb, sdh, sdl;
  const float* a;
  const __nv_bfloat16* b; long long sbb, sbg, sbl;
  const __nv_bfloat16* c; long long scb, scg, scl;
  const float* states;                       // (B, H, nc, P, N): the entering states
  float* y; long long syb, syh, syl;
  int heads, groups, len;
};

template <int N>
constexpr int out_smem_bytes() {
  return 1024 + 64 * N * 2 + kQ * N * 2 + kQ * kP * 2 + 2 * kP * N * 2 + 2 * kQ * 4;
}

template <int N>
__global__ void __launch_bounds__(kWg) ssd_fwd_out(const OutParams P) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t c_tile = (raw + 1023) & ~1023u;          // 64 x N: this half's rows
  const uint32_t b_tile = c_tile + 64 * N * 2;            // kQ x N
  const uint32_t x_tile = b_tile + kQ * N * 2;            // kQ x P
  const uint32_t s_hi = x_tile + kQ * kP * 2;             // P x N
  const uint32_t s_lo = s_hi + kP * N * 2;
  float* dt_s = reinterpret_cast<float*>(smem_raw + (s_lo + kP * N * 2 - raw));
  float* cs_s = dt_s + kQ;
  const int c = blockIdx.x >> 1, half = blockIdx.x & 1, h = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.x >> 1;
  const int g = h / (P.heads / P.groups);
  const int tid = threadIdx.x;
  const int t0 = c * kQ, len = min(kQ, P.len - t0);
  const int nj = 64 * (half + 1);                         // rows j this half reads
  const long long bh = (long long)bi * P.heads + h;

  load_rows<N>(c_tile, 64, P.c + bi * P.scb + g * P.scg + (t0 + 64 * half) * P.scl, P.scl,
               64, len - 64 * half, tid, kWg);
  load_rows<N>(b_tile, kQ, P.b + bi * P.sbb + g * P.sbg + t0 * P.sbl, P.sbl, nj, len, tid,
               kWg);
  load_rows<kP>(x_tile, kQ, P.x + bi * P.sxb + h * P.sxh + t0 * P.sxl, P.sxl, nj, len, tid,
                kWg);
  split_rows<N>(s_hi, s_lo, P.states + (bh * nc + c) * (long long)(kP * N), N, kP, kP, tid,
                kWg);
  chunk_cs(P.dt + bi * P.sdb + h * P.sdh + t0 * P.sdl, P.sdl, P.a[h], len, dt_s, cs_s, tid);
  tiles_ready();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 64 * half + 16 * warp + lane / 4;        // rows r0 and r0 + 8
  float yo[32], acc[32], sc[32];
  zero(yo);
  zero(acc);
  wg_fence();
#pragma unroll
  for (int k = 0; k < N; k += 16) {
    const uint64_t da = desc_k(c_tile, k, kHalf);
    mma_ss64<0, 0>(yo, da, desc_k(s_hi, k, kStateBox));
    mma_ss64<0, 0>(yo, da, desc_k(s_lo, k, kStateBox));
  }
  wg_commit();
  for (int jb = 0; jb <= half; ++jb) {
    zero(sc);
    wg_fence();
#pragma unroll
    for (int k = 0; k < N; k += 16)
      mma_ss64<0, 0>(sc, desc_k(c_tile, k, kHalf), desc_k(b_tile + jb * kHalf, k, kTile));
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(yo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + acc_row8(i), col = 64 * jb + acc_col(i, lane);
      sc[i] = (col <= row && row < len)
                  ? sc[i] * expf(cs_s[row] - cs_s[col]) * dt_s[col] : 0.f;
    }
    uint32_t hi[4][4], lo[4][4];
    wg_split(sc, hi, lo);
    wg_fence();
    wg_xb_frags<kP>(acc, hi, lo, x_tile + jb * kHalf, kTile);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_frags(hi);
    fence_frags(lo);
  }
  float* yp = P.y + bi * P.syb + h * P.syh + t0 * P.syl;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = r0 + acc_row8(i);
    if (row < len) {
      const float e = expf(cs_s[row]);
      *reinterpret_cast<float2*>(yp + row * P.syl + acc_col(i, lane)) =
          make_float2(acc[i] + e * yo[i], acc[i + 1] + e * yo[i + 1]);
    }
  }
}

template <int N>
int launch_sm90(const StateParams& sp, const OutParams& out, int batch, int nc, int passes,
                cudaStream_t st) {
  if (passes & 1)
    if (int err = launch_states<N, true>(sp, batch, st)) return err;
  if (passes & 2) {
    constexpr int bytes = out_smem_bytes<N>();
    if (int err = set_smem(ssd_fwd_out<N>, bytes)) return err;
    ssd_fwd_out<N><<<dim3(2 * nc, out.heads, batch), kWg, bytes, st>>>(out);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

}  // namespace

// The Hopper body. x, B, C bf16 (last dim contiguous, rows 16-byte aligned), P 64,
// N 64 or 128, chunk 128; dt, A and every output fp32. `states` (B, H, nc, P, N)
// receives the entering states (the backward's residual, or scratch). `passes`
// (bits 1, 2: the states pass, the output) runs a subset, for checking and timing
// each pass. Returns a cudaError_t code.
extern "C" int ssd_fwd_sm90(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* y, void* states, void* final_state,
                            long long sxb, long long sxh, long long sxl,
                            long long sdb, long long sdh, long long sdl,
                            long long sbb, long long sbg, long long sbl,
                            long long scb, long long scg, long long scl,
                            long long syb, long long syh, long long syl,
                            int batch, int heads, int groups, int len, int n, int passes,
                            void* stream) {
  if ((n != 64 && n != 128) || groups < 1 || heads % groups || len < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = (len + kQ - 1) / kQ;
  StateParams sp;
  sp.u = x; sp.sub = sxb; sp.suh = sxh; sp.sul = sxl;
  sp.dt = static_cast<const float*>(dt); sp.sdb = sdb; sp.sdh = sdh; sp.sdl = sdl;
  sp.a = static_cast<const float*>(a);
  sp.v = static_cast<const __nv_bfloat16*>(b); sp.svb = sbb; sp.svg = sbg; sp.svl = sbl;
  sp.seed = nullptr;
  sp.out = static_cast<float*>(states); sp.final_state = static_cast<float*>(final_state);
  sp.heads = heads; sp.groups = groups; sp.len = len;
  OutParams out;
  out.x = static_cast<const __nv_bfloat16*>(x); out.sxb = sxb; out.sxh = sxh; out.sxl = sxl;
  out.dt = sp.dt; out.sdb = sdb; out.sdh = sdh; out.sdl = sdl;
  out.a = sp.a;
  out.b = sp.v; out.sbb = sbb; out.sbg = sbg; out.sbl = sbl;
  out.c = static_cast<const __nv_bfloat16*>(c); out.scb = scb; out.scg = scg; out.scl = scl;
  out.states = sp.out;
  out.y = static_cast<float*>(y); out.syb = syb; out.syh = syh; out.syl = syl;
  out.heads = heads; out.groups = groups; out.len = len;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  return n == 128 ? launch_sm90<128>(sp, out, batch, nc, passes, st)
                  : launch_sm90<64>(sp, out, batch, nc, passes, st);
}
