// Hopper (sm_90a) building blocks shared by the hand-written kernels
// flash_fwd.cu (B1), flash_bwd.cu (B2/B3) and grouped_gemm.cu (B4): the
// attention masks of the reference (_tile_relevant, _tile_mask), the
// warp-specialised block's constants, mbarriers, TMA loads and the driver's
// tensor-map encoder, wgmma descriptors and wrappers. Each source includes it
// once (build.py compiles every source with -I csrc and hashes the headers it
// includes), so the helpers live in an anonymous namespace per library.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; no -lcuda (see tensor_map_encoder)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The reference's masks, for any parameter struct with s, t, causal, window and
// q_offset.

// _tile_relevant: can any (query, key) pair of this tile pair attend?
template <class P>
__device__ __forceinline__ bool tile_relevant(const P& p, int q_start, int bq,
                                              int k_start, int bk) {
  bool rel = true;
  if (p.causal) rel = k_start <= p.q_offset + q_start + bq - 1;
  if (p.window > 0) rel = rel && (k_start + bk - 1 > p.q_offset + q_start - p.window);
  return rel;
}

// _tile_mask for one element: row_l is the local query index, col the key index.
template <class P>
__device__ __forceinline__ bool attend(const P& p, int row_l, int col) {
  if (row_l >= p.s || col >= p.t) return false;
  const int row_g = p.q_offset + row_l;
  if (p.causal && col > row_g) return false;
  if (p.window > 0 && row_g - col >= p.window) return false;
  return true;
}

// The first and one-past-last tile index of a contiguous relevant range: over
// KV tiles for a fixed q tile (over_k) or over q tiles for a fixed KV tile.
// Causality bounds the key range above and the query range below; the window
// bounds them the other way, so either range is one interval.
template <class P>
__device__ __forceinline__ void relevant_range(const P& p, bool over_k, int fixed_start,
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

// Does any (query, key) pair of the tile fail the mask: a ragged end, the causal
// diagonal or the window edge? Tiles where none does skip the per-element test.
template <class P>
__device__ __forceinline__ bool tile_straddles(const P& p, int q_start, int bq,
                                               int k_start, int bk) {
  if (q_start + bq > p.s || k_start + bk > p.t) return true;
  const int q_first = p.q_offset + q_start;
  if (p.causal && k_start + bk - 1 > q_first) return true;
  return p.window > 0 && q_first + bq - 1 - k_start >= p.window;
}

// (x0, x1) -> bf16x2 head (rounded) and bf16x2 remainder, x ~ head + remainder.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// The warp-specialised block: a producer warpgroup and two consumer warpgroups.

constexpr int kWg = 128;                      // threads of a warpgroup
constexpr int kSm90Threads = 3 * kWg;         // producer + two consumers
constexpr int kProducerRegs = 24;             // setmaxnreg: 128 x 24 + 256 x 240 <= 64 K
constexpr int kConsumerRegs = 240;
// Codes above every cudaError_t value (cudaErrorUnknown is 999), so the caller
// can tell them from a launch error.
constexpr int kErrNoEncoder = 20000;          // the driver has no tensor-map encoder
constexpr int kErrTensorMap = 20001;          // + the CUresult of a failed encode

// Shared memory of one attention block (offsets from a 1024-byte aligned base).
// The block's own tile stays for the whole block (B1: Q of 128 queries, the
// second own tile unused; B2: Q and dO of 128 queries; B3: K and V of 128 keys);
// the streamed tiles (B1/B2: K and V, B3: Q and dO, 64 rows each) cycle through
// kStages stages. Every tile is stored as HD/64 boxes of 64 columns, one 128-byte
// row per tile row, in TMA's 128-byte swizzle, which is the layout wgmma reads
// through a descriptor. The stats region holds B3's lse/delta rows. kOwnTensors
// own tiles (B1 keeps one), kRing stages.
template <int HD, int kOwnTensors = 2, int kRing = (HD == 128 ? 3 : 4)>
struct Sm90 {
  static constexpr int kBoxes = HD / 64;
  static constexpr int kStages = kRing;
  static constexpr int kOwnRows = 128;                      // 2 consumers x 64
  static constexpr int kStreamRows = 64;
  static constexpr int kOwnBox = kOwnRows * 128;            // bytes of one box
  static constexpr int kStreamBox = kStreamRows * 128;
  static constexpr int kOwnBytes = kBoxes * kOwnBox;        // one tensor's tile
  static constexpr int kStreamBytes = kBoxes * kStreamBox;
  static constexpr int kRingOff = kOwnTensors * kOwnBytes;  // stage s: 2 tensors
  static constexpr int kStatsOff = kRingOff + kStages * 2 * kStreamBytes;
  static constexpr int kBarOff = kStatsOff + kStages * 2 * 64 * 4;   // lse, delta
  static constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-D tensor map (head dim, sequence, head, batch) into shared memory;
// completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
         "r"(batch), "r"(bar)
      : "memory");
}

// One box of a 3-D tensor map (contiguous dim, rows, expert) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}


// One box of shared memory (in the map's swizzle) to a 3-D tensor map's
// (contiguous dim, rows, expert) coordinates; elements past the tensor's ends are
// not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Makes this thread's st.shared writes visible to the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of wgmma registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma descriptor of a tile in 128-byte-swizzled rows, 8-row groups 1024 bytes
// apart (the stride offset). A K-major operand steps 32 bytes per 16 columns
// inside a 64-column box; an MN-major one steps 16 rows (2048 bytes) per slice
// and finds the next 64 columns lbo bytes on (the leading offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, fp32) = A B^T + (scale_d ? D : 0): A and B from shared memory, both
// K-major (rows of 16 bf16 along the contraction), through descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A B: A (64 x 16 bf16) from registers in the m64k16
// fragment layout, B (16 x 64) from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A B: A (64 x 16 bf16) from registers in the m64k16
// fragment layout, B (16 x 128) from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) = A B + (scale_d ? D : 0): A (64 x 16) and B (16 x 256) from
// shared memory through descriptors; TA / TB are 1 where that operand is MN-major
// (stored transposed: rows along the contraction), 0 where it is K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// acc (64 x 64) = A B^T over the head dim, for one warpgroup: A is the 64 rows at
// a, B the 64 rows at b, both K-major; boxes of 64 columns a_box / b_box bytes apart.
template <int HD>
__device__ __forceinline__ void wg_abt(float (&acc)[32], uint32_t a, int a_box, uint32_t b,
                                       int b_box) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, sw128_desc(a + (kk / 4) * a_box + off, 16),
                 sw128_desc(b + (kk / 4) * b_box + off, 16), kk > 0);
  }
}

// The 64 x 64 fp32 tile x in the accumulator layout as wgmma's register A
// fragments of its four 16-column slices: hi[j] the bf16 heads, lo[j] the bf16
// remainders.
__device__ __forceinline__ void wg_split(const float (&x)[32], uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
  }
}

// acc (64 x HD) += X B from X's fragments (wg_split), each a bf16 head and a bf16
// remainder as in wg_xb below. Issued after the caller's wg_fence, not waited for:
// hi/lo and acc must stay untouched until the wgmmas complete.
template <int HD>
__device__ __forceinline__ void wg_xb_frags(float (&acc)[HD / 2], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], uint32_t b, int b_box) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t db = sw128_desc(b + j * 2048, b_box);
    if constexpr (HD == 128) {
      wgmma_rs_n128(acc, hi[j], db);
      wgmma_rs_n128(acc, lo[j], db);
    } else {
      wgmma_rs_n64(acc, hi[j], db);
      wgmma_rs_n64(acc, lo[j], db);
    }
  }
}

// acc (64 x HD) += X B for one warpgroup: X is the 64 x 64 fp32 tile x in the
// accumulator layout, whose 16-column slices are already wgmma's register A
// fragments; each enters as a bf16 head plus a bf16 remainder. B is the 64 x HD
// tile at b (64 rows of 128 bytes a box, boxes b_box bytes apart), read MN-major,
// so K, Q or dO serve untransposed. Issued, not waited for.
template <int HD>
__device__ __forceinline__ void wg_xb(float (&acc)[HD / 2], const float (&x)[32], uint32_t b,
                                      int b_box) {
  uint32_t hi[4][4], lo[4][4];
  wg_split(x, hi, lo);
  wg_fence();
  wg_xb_frags<HD>(acc, hi, lo, b, b_box);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier and stage addresses of one block laid out as Sh.
template <int HD, class Sh = Sm90<HD>>
struct Sm90Smem {
  uint32_t base;
  float* stats;                        // generic pointer to the lse/delta stages
  __device__ explicit Sm90Smem(unsigned char* raw) {
    const uint32_t raw_u32 = smem_u32(raw);
    base = (raw_u32 + 1023) & ~1023u;
    stats = reinterpret_cast<float*>(raw + (base - raw_u32) + Sh::kStatsOff);
  }
  __device__ uint32_t own(int i) const { return base + i * Sh::kOwnBytes; }
  __device__ uint32_t stream(int s, int i) const {
    return base + Sh::kRingOff + (2 * s + i) * Sh::kStreamBytes;
  }
  __device__ uint32_t full(int s) const { return base + Sh::kBarOff + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + Sh::kBarOff + 8 * (Sh::kStages + s); }
  __device__ uint32_t own_ready() const { return base + Sh::kBarOff + 16 * Sh::kStages; }
  // called by thread 0, then __syncthreads
  __device__ void init(int full_count) const {
    for (int s = 0; s < Sh::kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 2 * kWg);
    }
    mbar_init(own_ready(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// ---------------------------------------------------------------------------
// Host side: the tensor maps.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, unit stride there; `strides`
// in bytes for the others), read in boxes of `box` elements in the 128-byte
// swizzle. Elements past a dim's end arrive as zeros.
int encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// The 4-D map (head dim, sequence, head, batch) of a bf16 (B, H, N, hd) tensor from
// its strides in elements, read in boxes of 64 head-dim columns x box_rows rows in
// the 128-byte swizzle. Rows at or past N arrive as zeros (the ragged edge).
int encode_rows(CUtensorMap* map, const void* ptr, int hd, int n, int heads, int batch,
                long long ss, long long sh, long long sb, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

}  // namespace
