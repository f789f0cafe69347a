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
// and, only when the backward will need them, the state entering each chunk
// (B, H, nc, P, N) fp32. Every product is an fp32 FMA on fp32 values, as the
// reference computes them (x, B and C arrive in fp32 or bf16 and are widened at
// load; TF32 is never used).
//
// Design. The TPU kernel walks the chunks as the minor, sequential grid axis and
// carries the (P, N) state in VMEM. Here one block owns one (batch, head) and loops
// over the chunks itself, the state held in shared memory: grid (H, B), 256 threads.
// A chunk's B and C (q x N), x dt (q x P) and the state (P x N) sit in shared memory
// as fp32, rows padded to a multiple of 4 plus 4, so the products that contract over
// N read both operands as float4 (one row per lane, a quarter-warp covering all 32
// banks); the (q, q) score matrix is never held whole: it is built in row strips of
// 32 (one warp owns 4 rows of a strip, its lanes the columns), each strip feeding
// that strip's rows of y at once, so shared memory peaks at 221,824 bytes at q 128,
// P 64, N 128 (the TPU kernel's 230 KB working set, strip by strip). Only entries
// j <= i of a strip are exponentiated. The cumsum is a warp scan.
//
// Ragged lengths. A length that is not a multiple of the chunk is read with a masked
// load of its last chunk: positions past L read dt = 0 and x = B = C = 0, which is
// exactly the reference's padding with dt = 0 steps (decay 1, no input), and their
// y is not written. Chunks from 1 to 128, P up to 64 and N up to 128 are taken; any
// other shape is refused (cudaErrorInvalidValue) and the wrapper raises.
//
// Bound. At mamba2-370m's serving shape (B 4, H 32, L 8000, P 64, N 128, q 128)
// the scan needs ~5.2 M multiply-adds per (batch, head, chunk): ~85 GFLOP over the
// 8,064 units, 0.085 ms at the tensor cores' 989 TFLOP/s, and ~223 MB of traffic
// (mostly the fp32 y), 0.067 ms at 3.35 TB/s. This kernel runs the FMAs on the CUDA
// cores, whose fp32 peak (67 TFLOP/s) alone needs ~1.3 ms, at one block of 8 warps
// per SM; tensor-core products (C B^T is exact on bf16 inputs), more blocks per
// (batch, head) and a pipelined load are later work.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the C entry point ssd_fwd at the end of this file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
