// Mamba2 SSD chunk scan, backward, for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_bwd_kernel (driven
// there by _ssd_backward, the backward of the custom VJP). Computes what it computes,
// head-major: from the forward's inputs x (B, H, L, P), dt (B, H, L) fp32, A (H,),
// B/C (B, G, L, N) (head h reads group h / (H / G)), the state entering each chunk
// (B, H, nc, P, N) fp32 that the forward saved, the cotangents dy (B, H, L, P) and
// dS_final (B, H, P, N) fp32, it sweeps the chunks last to first with the state
// cotangent dS seeded by dS_final, and per chunk (cs = cumsum(dt A),
// L[i, j] = exp(cs_i - cs_j) for j <= i, scores = C B^T o L, dscores = dy xd^T):
//   dxd  = scores^T dy + exp(cs[-1] - cs) o (B dS^T)           dx = dxd dt
//   dC   = (dy o exp(cs)) S_in + (dscores o L) B                 (per head)
//   dB   = exp(cs[-1] - cs) o (xd dS) + (dscores o L)^T C        (per head)
//   dcs  = rowsum(G) - colsum(G) + rowsum(dy o y_off) - t,   G = dscores o scores,
//          y_off = exp(cs) o (C S_in^T), t = exp(cs[-1] - cs) o rowsum((xd dS) o B)
//   dda  = (sum(dcs) + last) - cumsum(dcs) + dcs,  last = sum(t) + exp(cs[-1]) <dS, S_in>
//   ddt  = dda A + rowsum(dxd o x)
//   dS  <- exp(cs[-1]) dS + (dy o exp(cs))^T C
// and writes dx (through strides), ddt, dda (B, H, L) and the per-head dB, dC
// (B, H, L, N), all fp32. As in the reference, the per-head dB/dC are summed onto
// the groups and dA = sum(dda dt) is taken outside the kernel (torch ops).
// Every product is an fp32 FMA on fp32 values; TF32 is never used.
//
// Design. One block owns one (batch, head) and sweeps its chunks in reverse, dS held
// in shared memory: grid (H, B), 256 threads. The reference's chunk step holds
// x, dy, B, C, S_in, dS and four (q, q) matrices; at q 128, P 64, N 128 in fp32 that
// is 512 KB, more than the 227 KB a block may have. So the (q, q) work is cut into
// strips of 32 and done twice, in two passes over the chunk:
//  - the row pass holds B, x dt and S_in whole and takes C and dy a strip of rows i
//    at a time: it builds the strip's rows of scores and dscores, and finishes what
//    is summed along a row: dC[i], rowsum(G)[i] and rowsum(dy o y_off)[i];
//  - the column pass holds C and dy whole and takes B and x a strip of columns j at a
//    time: it builds the strip's columns of scores and dscores, and finishes what is
//    summed down a column: dxd[j] (hence dx[j] and rowsum(dxd o x)[j]), dB[j], t[j]
//    and colsum(G)[j];
// a warp owns 4 rows (or columns) of a strip and its lanes the other index, so every
// row sum is a warp shuffle reduction in a fixed order (no atomics: the result does not
// change from run to run). Splitting B6 into two kernels (a sweep that writes dS for
// every chunk, then a chunk-parallel kernel) would need the same residency per chunk
// and another (B, H, nc, P, N) fp32 buffer, so the strips stay in one kernel. The
// (q, q) products are built twice: ~1.6 M extra multiply-adds a chunk of ~11 M. The
// dda fold (the reverse cumsum with its `last` term) is done by one warp with a warp
// scan, after both passes. Rows are padded to a multiple of 4 plus 4, so every
// product that contracts along a row with one row per lane reads float4s (a
// quarter-warp covers all 32 banks); the column pass keeps its (dscores o L)^T
// strip in S_in's buffer. Shared memory peaks at 216,740 bytes at q 128, P 64,
// N 128 (of 232,448). Only entries j <= i are exponentiated.
//
// Ragged lengths: positions past L read dt = 0 and x = B = C = dy = 0 (the
// reference's dt = 0 padding, whose cotangent is zero), and nothing is written for
// them. Chunks from 1 to 128, P up to 64 and N up to 128; any other shape is
// refused (cudaErrorInvalidValue) and the wrapper raises.
//
// Bound. At mamba2-370m's training microbatch (B 4, H 32, L 4096, P 64, N 128,
// q 128) the reference's chunk step is ~6.8 M multiply-adds: ~56 GFLOP over 4,096
// units (0.06 ms at 989 TFLOP/s); the traffic is ~1 GB (x, dy, B, C, the entering
// states in; dx, ddt, dda and the per-head fp32 dB/dC out), ~0.30 ms at 3.35 TB/s, so
// bytes bound it. This kernel runs ~11 M FMAs a unit on the CUDA cores at one block
// of 8 warps per SM; tensor cores and more parallelism per head are later work.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point ssd_bwd at the end of this file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;
constexpr int kRowsPerWarp = kStrip / kWarps;
constexpr int kQMax = 128, kPMax = 64, kNMax = 128;
constexpr int kVecs = 9;              // per-position vectors (see the kernel)

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

struct BwdParams {
  const void* x; const float* dt; const float* a; const void* b; const void* c;
  const float* enters; const float* dy; const float* dfinal;
  float* dx; float* ddt; float* dda; float* db; float* dc;
  long long sxb, sxh, sxl;        // x (P contiguous)
  long long sdb, sdh, sdl;        // dt
  long long sbb, sbg, sbl;        // B (N contiguous)
  long long scb, scg, scl;        // C
  long long syb, syh, syl;        // dy (P contiguous)
  long long sob, soh, sol;        // dx (P contiguous)
  int heads, groups, len, p, n, chunk;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Inclusive prefix sum of v[0, q) (q <= 128) into out, by one whole warp.
__device__ __forceinline__ void warp_cumsum(const float* v, float* out, int q, int lane) {
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
    if (i < q) out[i] = excl + loc[k];
  }
}

// Row strides: N and P rounded up to 4 (zero-filled) plus 4, so rows start 16-byte
// aligned and float4 loads of 8 consecutive rows (a quarter-warp) hit all 32 banks.
// S_in's buffer holds the column pass's (dscores o L)^T strip.
__host__ __device__ __forceinline__ int in_floats(int q, int p, int n) {
  const int a = p * (round4(n) + 4), b = kStrip * (q + 1);
  return round4(a > b ? a : b);
}

size_t bwd_smem_floats(int q, int p, int n) {
  const size_t ldn = round4(n) + 4, ldp = round4(p) + 4;
  return q * ldn + q * ldp + (size_t)in_floats(q, p, n) + p * ldn + kStrip * ldn + kStrip * ldp +
         (size_t)kStrip * (q + 1) + kVecs * (size_t)q + kWarps + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(BwdParams P) {
  extern __shared__ float smem[];
  const int q = P.chunk, np = P.p, nn = P.n;
  const int n4 = round4(nn), p4 = round4(np);
  const int ldn = n4 + 4, ldp = p4 + 4, ldq = q + 1;
  float* bufN = smem;                    // q x ldn: B (row pass), C (column pass)
  float* bufP = bufN + q * ldn;          // q x ldp: x dt (row pass), dy (column pass)
  float* sIn = bufP + q * ldp;           // np x ldn: the state entering the chunk
  float* stQ2 = sIn;                     // kStrip x ldq: (dscores o L)^T (column pass)
  float* sDS = sIn + in_floats(q, np, nn);   // np x ldn: the running state cotangent
  float* stN = sDS + np * ldn;           // kStrip x ldn: C rows / B rows of the strip
  float* stP = stN + kStrip * ldn;       // kStrip x ldp: dy rows / x rows of the strip
  float* stQ1 = stP + kStrip * ldp;      // kStrip x ldq: dscores o L (row pass), scores^T
  float* vDt = stQ1 + kStrip * ldq;      // q: dt
  float* vCs = vDt + q;                  // q: dt A, then cs
  float* vE = vCs + q;                   // q: exp(cs)
  float* vW = vE + q;                    // q: exp(cs[-1] - cs)
  float* vRowG = vW + q;                 // q: rowsum(G)
  float* vColG = vRowG + q;              // q: colsum(G)
  float* vR = vColG + q;                 // q: rowsum(dy o y_off)
  float* vT = vR + q;                    // q: t
  float* vDxx = vT + q;                  // q: rowsum(dxd o x)
  float* red = vDxx + q;                 // kWarps + 1: <dS, S_in>

  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (P.heads / P.groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xp = static_cast<const T*>(P.x) + bi * P.sxb + h * P.sxh;
  const float* dtp = P.dt + bi * P.sdb + h * P.sdh;
  const T* bp = static_cast<const T*>(P.b) + bi * P.sbb + g * P.sbg;
  const T* cp = static_cast<const T*>(P.c) + bi * P.scb + g * P.scg;
  const float* dyp = P.dy + bi * P.syb + h * P.syh;
  float* dxp = P.dx + bi * P.sob + h * P.soh;
  const long long bh = (long long)bi * P.heads + h;
  float* ddtp = P.ddt + bh * P.len;
  float* ddap = P.dda + bh * P.len;
  float* dbp = P.db + bh * (long long)P.len * nn;
  float* dcp = P.dc + bh * (long long)P.len * nn;
  const float a = P.a[h];
  const int nc = (P.len + q - 1) / q;

  {
    const float* src = P.dfinal + bh * (long long)np * nn;
    for (int idx = tid; idx < np * n4; idx += kThreads) {
      const int i = idx / n4, j = idx - i * n4;
      sDS[i * ldn + j] = j < nn ? src[i * nn + j] : 0.f;
    }
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * q;
    const int len = min(q, P.len - t0);
    __syncthreads();                     // the last chunk's readers are done
    for (int i = tid; i < q; i += kThreads) {
      const float d = i < len ? dtp[(long long)(t0 + i) * P.sdl] : 0.f;
      vDt[i] = d;
      vCs[i] = d * a;
      vRowG[i] = vColG[i] = vR[i] = vT[i] = vDxx[i] = 0.f;
    }
    __syncthreads();
    if (warp == 0) warp_cumsum(vCs, vCs, q, lane);
    // row pass residency: B, x dt and S_in whole
    for (int idx = tid; idx < q * n4; idx += kThreads) {
      const int i = idx / n4, j = idx - i * n4;
      bufN[i * ldn + j] = i < len && j < nn ? ld(bp + (long long)(t0 + i) * P.sbl + j) : 0.f;
    }
    for (int idx = tid; idx < q * p4; idx += kThreads) {
      const int i = idx / p4, j = idx - i * p4;
      const float xv = i < len && j < np ? ld(xp + (long long)(t0 + i) * P.sxl + j) : 0.f;
      bufP[i * ldp + j] = xv * vDt[i];
    }
    {
      const float* src = P.enters + (bh * nc + c) * (long long)np * nn;
      float part = 0.f;
      for (int idx = tid; idx < np * n4; idx += kThreads) {
        const int i = idx / n4, j = idx - i * n4;
        const float v = j < nn ? src[i * nn + j] : 0.f;
        sIn[i * ldn + j] = v;
        part = fmaf(sDS[i * ldn + j], v, part);
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    const float cs_last = vCs[q - 1];
    for (int i = tid; i < q; i += kThreads) {
      vE[i] = expf(vCs[i]);
      vW[i] = expf(cs_last - vCs[i]);
    }
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      red[kWarps] = s;                   // <dS, S_in>
    }

    // ---- row pass: strips of rows i
    for (int r0 = 0; r0 < len; r0 += kStrip) {
      __syncthreads();                   // vectors ready; the last strip's readers done
      for (int idx = tid; idx < kStrip * n4; idx += kThreads) {
        const int r = idx / n4, j = idx - r * n4, i = r0 + r;
        stN[r * ldn + j] = i < len && j < nn ? ld(cp + (long long)(t0 + i) * P.scl + j) : 0.f;
      }
      for (int idx = tid; idx < kStrip * p4; idx += kThreads) {
        const int r = idx / p4, j = idx - r * p4, i = r0 + r;
        stP[r * ldp + j] = i < len && j < np ? dyp[(long long)(t0 + i) * P.syl + j] : 0.f;
      }
      __syncthreads();
      const int ib = r0 + warp * kRowsPerWarp;
      const int lr = warp * kRowsPerWarp;          // the warp's first strip row
      const int jmax = min(r0 + kStrip, q);
      if (ib < len) {
        float cb[kRowsPerWarp][4], ds[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) cb[r][k] = ds[r][k] = 0.f;
        for (int m = 0; m < n4; m += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) cv[r] = ld4(stN + (lr + r) * ldn + m);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (32 * k < jmax) {
              const float4 bv = ld4(bufN + min(lane + 32 * k, q - 1) * ldn + m);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) cb[r][k] = dot4(cb[r][k], cv[r], bv);
            }
          }
        }
        for (int m = 0; m < p4; m += 4) {
          float4 dv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dv[r] = ld4(stP + (lr + r) * ldp + m);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (32 * k < jmax) {
              const float4 xv = ld4(bufP + min(lane + 32 * k, q - 1) * ldp + m);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) ds[r][k] = dot4(ds[r][k], dv[r], xv);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = ib + r;
          float gsum = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            if (j < jmax) {
              float dcb = 0.f;
              if (i < len && j <= i) {
                const float l = expf(vCs[i] - vCs[j]);
                const float sc = cb[r][k] * l;
                dcb = ds[r][k] * l;
                gsum += ds[r][k] * sc;
              }
              stQ1[(lr + r) * ldq + j] = dcb;
            }
          }
          gsum = warp_sum(gsum);
          if (lane == 0 && i < q) vRowG[i] = gsum;
        }
        // rowsum(dy o y_off), y_off[i, p] = exp(cs_i) sum_n C[i, n] S_in[p, n]
        float yo[kRowsPerWarp][2];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) yo[r][0] = yo[r][1] = 0.f;
        for (int m = 0; m < n4; m += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) cv[r] = ld4(stN + (lr + r) * ldn + m);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 sv = ld4(sIn + min(lane + 32 * k, np - 1) * ldn + m);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) yo[r][k] = dot4(yo[r][k], cv[r], sv);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = ib + r;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int pp = lane + 32 * k;
            if (pp < np && i < len) s += stP[(lr + r) * ldp + pp] * (vE[i] * yo[r][k]);
          }
          s = warp_sum(s);
          if (lane == 0 && i < q) vR[i] = s;
        }
        __syncwarp();
        // dC[i, n] = sum_p (dy[i, p] exp(cs_i)) S_in[p, n] + sum_j dcb[i, j] B[j, n]
        float d1[kRowsPerWarp][4], d2[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) d1[r][k] = d2[r][k] = 0.f;
        float ei[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) ei[r] = vE[min(ib + r, q - 1)];
        for (int m = 0; m < np; ++m) {
          float dv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dv[r] = stP[(lr + r) * ldp + m] * ei[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float sv = sIn[m * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) d1[r][k] = fmaf(dv[r], sv, d1[r][k]);
          }
        }
        const int jw = min(ib + kRowsPerWarp, len);
        for (int j = 0; j < jw; ++j) {
          float dv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dv[r] = stQ1[(lr + r) * ldq + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float bv = bufN[j * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) d2[r][k] = fmaf(dv[r], bv, d2[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = ib + r;
          if (i < len) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int m = lane + 32 * k;
              if (m < nn) dcp[(long long)(t0 + i) * nn + m] = d1[r][k] + d2[r][k];
            }
          }
        }
      }
    }

    // ---- column pass: C and dy whole, strips of columns j
    __syncthreads();
    for (int idx = tid; idx < q * n4; idx += kThreads) {
      const int i = idx / n4, j = idx - i * n4;
      bufN[i * ldn + j] = i < len && j < nn ? ld(cp + (long long)(t0 + i) * P.scl + j) : 0.f;
    }
    for (int idx = tid; idx < q * p4; idx += kThreads) {
      const int i = idx / p4, j = idx - i * p4;
      bufP[i * ldp + j] = i < len && j < np ? dyp[(long long)(t0 + i) * P.syl + j] : 0.f;
    }
    for (int c0 = 0; c0 < len; c0 += kStrip) {
      __syncthreads();                   // loads done; the last strip's readers done
      for (int idx = tid; idx < kStrip * n4; idx += kThreads) {
        const int r = idx / n4, j = idx - r * n4, i = c0 + r;
        stN[r * ldn + j] = i < len && j < nn ? ld(bp + (long long)(t0 + i) * P.sbl + j) : 0.f;
      }
      for (int idx = tid; idx < kStrip * p4; idx += kThreads) {
        const int r = idx / p4, j = idx - r * p4, i = c0 + r;
        stP[r * ldp + j] = i < len && j < np ? ld(xp + (long long)(t0 + i) * P.sxl + j) : 0.f;
      }
      __syncthreads();
      const int jb = c0 + warp * kRowsPerWarp;     // this warp's first column j
      const int lr = warp * kRowsPerWarp;
      if (jb < len) {
        float dtj[kRowsPerWarp], wj[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          dtj[r] = vDt[min(jb + r, q - 1)];
          wj[r] = vW[min(jb + r, q - 1)];
        }
        float cb[kRowsPerWarp][4], ds[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) cb[r][k] = ds[r][k] = 0.f;
        for (int m = 0; m < n4; m += 4) {
          float4 bv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) bv[r] = ld4(stN + (lr + r) * ldn + m);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (32 * k + 31 >= jb && 32 * k < q) {
              const float4 cv = ld4(bufN + min(lane + 32 * k, q - 1) * ldn + m);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) cb[r][k] = dot4(cb[r][k], cv, bv[r]);
            }
          }
        }
        for (int m = 0; m < p4; m += 4) {
          float4 xv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            xv[r] = ld4(stP + (lr + r) * ldp + m);
            xv[r].x *= dtj[r]; xv[r].y *= dtj[r]; xv[r].z *= dtj[r]; xv[r].w *= dtj[r];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (32 * k + 31 >= jb && 32 * k < q) {
              const float4 dv = ld4(bufP + min(lane + 32 * k, q - 1) * ldp + m);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) ds[r][k] = dot4(ds[r][k], dv, xv[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int j = jb + r;
          float gsum = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = lane + 32 * k;
            if (32 * k + 31 >= jb && i < q) {
              float sc = 0.f, dcb = 0.f;
              if (i < len && j <= i) {
                const float l = expf(vCs[i] - vCs[j]);
                sc = cb[r][k] * l;
                dcb = ds[r][k] * l;
                gsum += ds[r][k] * sc;
              }
              stQ1[(lr + r) * ldq + i] = sc;
              stQ2[(lr + r) * ldq + i] = dcb;
            }
          }
          gsum = warp_sum(gsum);
          if (lane == 0 && j < q) vColG[j] = gsum;
        }
        __syncwarp();
        // dxd[j, p] = sum_i scores[i, j] dy[i, p] + w_j sum_n B[j, n] dS[p, n]
        float a1[kRowsPerWarp][2], a2[kRowsPerWarp][2];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 2; ++k) a1[r][k] = a2[r][k] = 0.f;
        for (int i = jb; i < len; ++i) {
          float sv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) sv[r] = stQ1[(lr + r) * ldq + i];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float dv = bufP[i * ldp + min(lane + 32 * k, np - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) a1[r][k] = fmaf(sv[r], dv, a1[r][k]);
          }
        }
        for (int m = 0; m < n4; m += 4) {
          float4 bv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) bv[r] = ld4(stN + (lr + r) * ldn + m);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 sv = ld4(sDS + min(lane + 32 * k, np - 1) * ldn + m);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) a2[r][k] = dot4(a2[r][k], bv[r], sv);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int j = jb + r;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int pp = lane + 32 * k;
            if (pp < np && j < len) {
              const float dxd = a1[r][k] + wj[r] * a2[r][k];
              dxp[(long long)(t0 + j) * P.sol + pp] = dxd * dtj[r];
              s += dxd * stP[(lr + r) * ldp + pp];
            }
          }
          s = warp_sum(s);
          if (lane == 0 && j < q) vDxx[j] = s;
        }
        // dB[j, n] = w_j sum_p xd[j, p] dS[p, n] + sum_i dcb[i, j] C[i, n];
        // t_j = w_j sum_n (sum_p xd[j, p] dS[p, n]) B[j, n]
        float b1[kRowsPerWarp][4], b2[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) b1[r][k] = b2[r][k] = 0.f;
        for (int m = 0; m < np; ++m) {
          float xv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) xv[r] = stP[(lr + r) * ldp + m] * dtj[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float sv = sDS[m * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) b1[r][k] = fmaf(xv[r], sv, b1[r][k]);
          }
        }
        for (int i = jb; i < len; ++i) {
          float dv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dv[r] = stQ2[(lr + r) * ldq + i];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float cv = bufN[i * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) b2[r][k] = fmaf(dv[r], cv, b2[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int j = jb + r;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int m = lane + 32 * k;
            if (m < nn && j < len) {
              dbp[(long long)(t0 + j) * nn + m] = wj[r] * b1[r][k] + b2[r][k];
              s += b1[r][k] * stN[(lr + r) * ldn + m];
            }
          }
          s = warp_sum(s);
          if (lane == 0 && j < q) vT[j] = wj[r] * s;
        }
      }
    }
    __syncthreads();

    // ---- the dda fold and ddt, by warp 0
    if (warp == 0) {
      float dcs[4], tsum = 0.f, dsum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane * 4 + k;
        dcs[k] = 0.f;
        if (j < q) {
          dcs[k] = ((vRowG[j] - vColG[j]) + vR[j]) - vT[j];
          tsum += vT[j];
          dsum += dcs[k];
        }
      }
      tsum = warp_sum(tsum);
      dsum = warp_sum(dsum);
      const float last = tsum + expf(cs_last) * red[kWarps];
      const float total = dsum + last;
      // inclusive cumsum of dcs
      float run = 0.f, loc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) { run += dcs[k]; loc[k] = run; }
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
        const int j = lane * 4 + k;
        if (j < len) {
          const float dda = (total - (excl + loc[k])) + dcs[k];
          ddap[t0 + j] = dda;
          ddtp[t0 + j] = dda * a + vDxx[j];
        }
      }
    }

    // ---- dS <- exp(cs[-1]) dS + sum_i (dy[i] exp(cs_i)) (x) C[i]
    {
      const float dec = expf(cs_last);
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int i = 0; i < len; ++i) {
        float dv[8];
        const float e = vE[i];
#pragma unroll
        for (int r = 0; r < 8; ++r) dv[r] = bufP[i * ldp + min(warp + 8 * r, np - 1)] * e;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float cv = bufN[i * ldn + min(lane + 32 * k, nn - 1)];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][k] = fmaf(dv[r], cv, acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int pp = warp + 8 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m = lane + 32 * k;
          if (pp < np && m < nn) sDS[pp * ldn + m] = dec * sDS[pp * ldn + m] + acc[r][k];
        }
      }
    }
  }
}

template <typename T>
int launch(const BwdParams& p, int batch, cudaStream_t st) {
  const size_t bytes = bwd_smem_floats(p.chunk, p.p, p.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<T><<<dim3(p.heads, batch), kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, B and C); everything else fp32. ddt, dda (B, H, L)
// and db, dc (B, H, L, N) are contiguous; dx is written through its strides.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* enters, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* dda, void* db,
                       void* dc,
                       long long sxb, long long sxh, long long sxl,
                       long long sdb, long long sdh, long long sdl,
                       long long sbb, long long sbg, long long sbl,
                       long long scb, long long scg, long long scl,
                       long long syb, long long syh, long long syl,
                       long long sob, long long soh, long long sol,
                       int batch, int heads, int groups, int len, int p, int n,
                       int chunk, int dtype, void* stream) {
  if (chunk < 1 || chunk > kQMax || p < 1 || p > kPMax || n < 1 || n > kNMax ||
      groups < 1 || heads % groups || len < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  BwdParams P;
  P.x = x; P.dt = static_cast<const float*>(dt); P.a = static_cast<const float*>(a);
  P.b = b; P.c = c; P.enters = static_cast<const float*>(enters);
  P.dy = static_cast<const float*>(dy); P.dfinal = static_cast<const float*>(dfinal);
  P.dx = static_cast<float*>(dx); P.ddt = static_cast<float*>(ddt);
  P.dda = static_cast<float*>(dda); P.db = static_cast<float*>(db);
  P.dc = static_cast<float*>(dc);
  P.sxb = sxb; P.sxh = sxh; P.sxl = sxl;
  P.sdb = sdb; P.sdh = sdh; P.sdl = sdl;
  P.sbb = sbb; P.sbg = sbg; P.sbl = sbl;
  P.scb = scb; P.scg = scg; P.scl = scl;
  P.syb = syb; P.syh = syh; P.syl = syl;
  P.sob = sob; P.soh = soh; P.sol = sol;
  P.heads = heads; P.groups = groups; P.len = len; P.p = p; P.n = n; P.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == 0) return launch<float>(P, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(P, batch, st);
  return (int)cudaErrorInvalidValue;
}
