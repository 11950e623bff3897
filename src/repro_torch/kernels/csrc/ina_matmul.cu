// INA matmul for Hopper (sm_90a): y[M,N] = x[M,K] @ w[K,N].
//
// Replaces: src/repro/kernels/ina_matmul.py, ina_matmul / _kernel (the
// Pallas kernel whose f32 accumulator stays in VMEM across the K grid axis
// and is cast and written once, at the last K block).
//
// The point kept: no partial sum is ever written to device memory or L2,
// there are no atomics and no second pass, and each output element is
// stored exactly once, as bf16.
//
// bf16 takes one of three paths.  plan_matmul (kernels/ina_matmul.py)
// picks the path, the tile and the cluster size; this file only launches
// what it is told and refuses a plan it has no instantiation for.
//
// * wide (M > 16) and narrow (M <= 16) share one warp-specialised
//   mainloop.  A producer warpgroup (one thread issues, the rest only join
//   the cluster barriers) fills a ring of shared-memory stages with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, K tile 64) and completes each
//   stage's "full" mbarrier by transaction bytes; one or two consumer
//   warpgroups run wgmma.mma_async on the stage, keep one wgmma group in
//   flight, and release the stage through its "empty" mbarrier.  setmaxnreg
//   moves registers from the producer to the consumers when there are two.
//   The f32 accumulator lives in registers across the CTA's whole K range.
//   Both operand layouts are read in place by the wgmma descriptors: x and
//   the tied head's embed^T view are K-major, a row-major w is MN-major
//   (the transpose bit).  TMA zero-fills boxes past M, N and K, so ragged
//   shapes need no load masks; the epilogue masks its stores.
//   - wide: A = x (64 rows per consumer warpgroup), B = w (128 or 256
//     columns).  At M = 4096 it is bound by operations (~1,365 per byte
//     moved at d x d, against the card's ~295); it keeps the tensor cores
//     fed from a 4-8 stage ring and rasterises output tiles in groups of 8
//     row tiles so that a wave's operands stay in L2.
//   - narrow: swap A and B, y^T = w^T x^T.  A 64-column weight tile is
//     wgmma's A, and x's M <= 16 rows become wgmma's N (8 or 16, TMA zero
//     fill past M).  At decode it is bound by bytes (the weight read); the
//     design keeps 8 stages of 8 KB weight tiles in flight per CTA, two
//     CTAs per SM.
// * The cluster K split is the in-network accumulation of this card.
//   When output tiles are fewer than SMs, c = 2, 4 or 8 CTAs of a thread
//   block cluster share one output tile, each accumulating one contiguous
//   slice of whole K tiles in registers.  Each stages its f32 partial tile
//   in its own shared memory; after a cluster barrier, CTA r reduces its
//   1/c share of the tile by reading the c partials over distributed shared
//   memory (mapa + ld.shared::cluster), summing them in rank order, and
//   stores that share once.  The partials move SM to SM and are summed on
//   arrival, the reduce-scatter of core/collectives.py's INA ring inside
//   one cluster; nothing goes to device memory, and the fixed order makes
//   every run give the same bits.  A second cluster barrier keeps each CTA
//   alive until its peers have read its partial.
// * generic: an mma.sync m16n8k16 kernel with element-by-element loads,
//   only for what TMA cannot describe (a row stride that is not a multiple
//   of 8 elements, or a base that is not 16-byte aligned).
//
// A row of y is not bit-for-bit the same in prefill and in decode:
// M = 2 and M = 64 take different regimes, tiles and K splits, so the f32
// sums of one element are added in different orders.  Each differs from
// the exact product by f32 rounding before the one bf16 rounding.
//
// f32 inputs take a plain FMA kernel (no TF32, k in ascending order),
// unchanged: it serves the exact-f32 checks, where engine and reference
// loop must produce the same tokens.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int REGIME_GENERIC = 0, REGIME_WIDE = 1, REGIME_NARROW = 2,
              REGIME_F32 = 3;

// ------------------------------------------------------- PTX wrappers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// never ends (a wrong phase, a lost copy) traps after ~2^34 cycles, which
// turns a hang into a launch error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  SBO: 1024 bytes from
// one group of 8 rows (K-major: 8 M/N rows; MN-major: 8 k rows) to the
// next.  LBO: for MN-major, the 8192 bytes from one 64-wide [64][64]
// sub-tile to the next along M/N; unused for K-major (set to 1).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}
__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


template <int WN, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db) {
  if constexpr (WN == 8) wgmma_n8<TA, TB>(d, da, db);
  else if constexpr (WN == 16) wgmma_n16<TA, TB>(d, da, db);
  else if constexpr (WN == 128) wgmma_n128<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
}

// ------------------------------------------------ TMA + wgmma, bf16 ----
constexpr int BK = 64;       // K tile: 64 bf16, one 128-byte swizzle row
constexpr int SUB = 8192;    // bytes of one [64][64] bf16 sub-tile
constexpr int GROUP_M = 8;   // row tiles per rasterisation group (c == 1)

template <int NWG, int WN, int STAGES>
struct Ring {
  static constexpr int A_BYTES = NWG * SUB;     // 64 * NWG rows x BK
  static constexpr int B_BYTES = WN * BK * 2;   // WN rows x BK
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BYTES = STAGES * STAGE;
  static constexpr int SMEM = 1024 + BYTES + 2 * STAGES * 8;  // + alignment
  static_assert(STAGE % 1024 == 0, "swizzled tiles need 1024-byte alignment");
};

// NWG consumer warpgroups, each a 64-row slice of A; WN columns of B.  TA
// / TB: A / B is MN-major (the transpose bit); otherwise K-major.  SWAP:
// A holds output columns and B output rows (the narrow regime), so the
// accumulator is y^T.  Output tiles are (64 NWG x WN), or (WN x 64) when
// SWAP.  c: cluster size along x; the c CTAs of one cluster share one
// output tile and split its K tiles.
template <int NWG, int WN, int TA, int TB, bool SWAP, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), SWAP ? 2 : 1)
ina_matmul_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      __nv_bfloat16* __restrict__ y, int M, int N, int K,
                      int tiles_m, int tiles_n, int c) {
  using R = Ring<NWG, WN, STAGES>;
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int AROWS = 64 * NWG;
  constexpr int TILE_M = SWAP ? WN : AROWS, TILE_N = SWAP ? AROWS : WN;
  constexpr int LDP = TILE_N + 4;   // f32 partial tile row, 16-byte aligned
  static_assert(TILE_M * LDP * 4 <= R::BYTES, "partial tile must fit the ring");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* part = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full0 = base + R::BYTES, empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x;

  int tm, tn, rank = 0;
  if (c == 1) {   // grouped rasterisation: a wave shares A and B tiles in L2
    const int lin = blockIdx.x, per_group = GROUP_M * tiles_n;
    const int first = lin / per_group * GROUP_M;
    const int rows = min(tiles_m - first, GROUP_M);
    tm = first + lin % per_group % rows;
    tn = lin % per_group / rows;
  } else {
    tm = blockIdx.y;
    tn = blockIdx.x / c;
    rank = static_cast<int>(cluster_rank());
  }
  const int out_m0 = tm * TILE_M, out_n0 = tn * TILE_N;
  const int a_row0 = SWAP ? out_n0 : out_m0, b_row0 = SWAP ? out_m0 : out_n0;
  const int kt = (K + BK - 1) / BK;
  const int kb = rank * kt / c, nk = (rank + 1) * kt / c - kb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------- producer warpgroup
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < nk; ++t) {
        mbar_wait(empty0 + 8 * s, phase ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, R::STAGE);
        const int k0 = (kb + t) * BK;
        const uint32_t sa = base + s * R::STAGE, sb = sa + R::A_BYTES;
        if constexpr (TA != 0) {
#pragma unroll
          for (int i = 0; i < NWG; ++i)
            tma_load(sa + i * SUB, &map_a, bar, a_row0 + 64 * i, k0);
        } else {
          tma_load(sa, &map_a, bar, k0, a_row0);
        }
        if constexpr (TB != 0) {
#pragma unroll
          for (int i = 0; i < WN / 64; ++i)
            tma_load(sb + i * SUB, &map_b, bar, b_row0 + 64 * i, k0);
        } else {
          tma_load(sb, &map_b, bar, k0, b_row0);
        }
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    if (c > 1) {   // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // --------------------------------------------- consumer warpgroups
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid / 128;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nk; ++t) {
      mbar_wait(full0 + 8 * s, phase);
      const uint32_t sa = base + s * R::STAGE + wg * SUB;
      const uint32_t sb = base + s * R::STAGE + R::A_BYTES;
      fence_acc<WN / 2>(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: the next 16 k are 32 bytes along the swizzled row;
        // MN-major: 16 k rows of 128 bytes further on.
        const uint64_t da = TA ? gmma_desc(sa + kk * 2048, SUB)
                               : gmma_desc(sa + kk * 32, 16);
        const uint64_t db = TB ? gmma_desc(sb + kk * 2048, SUB)
                               : gmma_desc(sb + kk * 32, 16);
        wgmma<WN, TA, TB>(acc, da, db);
      }
      wg_commit();
      fence_acc<WN / 2>(acc);
      wg_wait<1>();              // the previous stage's products are done
      fence_acc<WN / 2>(acc);
      if (t > 0) mbar_arrive(empty0 + 8 * prev);
      prev = s;
      if (++s == STAGES) { s = 0; phase ^= 1; }
    }
    wg_wait<0>();
    fence_acc<WN / 2>(acc);

    // Accumulator layout: acc[4j + 2h + e] is A row 16 warp + g + 8h and
    // B row 8j + 2q + e of this warpgroup's 64 x WN block.
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          const int ar = a_row0 + r0 + 8 * h, bc = b_row0 + 8 * j + 2 * q;
          if constexpr (!SWAP) {
            if (ar >= M) continue;
            __nv_bfloat16* row = y + static_cast<long long>(ar) * N;
            if ((N & 1) == 0 && bc + 1 < N) {
              *reinterpret_cast<__nv_bfloat162*>(row + bc) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (bc < N) row[bc] = __float2bfloat16(v0);
              if (bc + 1 < N) row[bc + 1] = __float2bfloat16(v1);
            }
          } else {
            if (ar >= N) continue;
            if (bc < M) y[static_cast<long long>(bc) * N + ar] = __float2bfloat16(v0);
            if (bc + 1 < M)
              y[static_cast<long long>(bc + 1) * N + ar] = __float2bfloat16(v1);
          }
        }
    } else {
      // The ring is idle (every stage consumed); both consumer warpgroups
      // must be done reading it before it holds the partial tile.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          const int ar = r0 + 8 * h, bc = 8 * j + 2 * q;
          if constexpr (!SWAP) {
            *reinterpret_cast<float2*>(part + ar * LDP + bc) = make_float2(v0, v1);
          } else {
            part[bc * LDP + ar] = v0;
            part[(bc + 1) * LDP + ar] = v1;
          }
        }
      cluster_sync();   // every partial of the cluster is in place

      // This CTA's 1/c share of the tile's valid rows, 4 columns a step.
      const int rows = min(TILE_M, M - out_m0);
      const int total = rows * (TILE_N / 4);
      const int lo = rank * total / c, hi = (rank + 1) * total / c;
      for (int i = lo + tid; i < hi; i += CONSUMERS) {
        const int row = i / (TILE_N / 4), col = i % (TILE_N / 4) * 4;
        const uint32_t addr = base + (row * LDP + col) * 4;
        float4 sum = ld_peer_f4(addr, 0);
        for (int p = 1; p < c; ++p) {   // rank order: the same bits every run
          const float4 v = ld_peer_f4(addr, p);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        const int n = out_n0 + col;
        __nv_bfloat16* dst = y + static_cast<long long>(out_m0 + row) * N + n;
        if ((N & 3) == 0 && n + 3 < N) {
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(sum.x, sum.y);
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(sum.z, sum.w);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&lo2);
          u.y = *reinterpret_cast<const uint32_t*>(&hi2);
          *reinterpret_cast<uint2*>(dst) = u;
        } else {
          const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) dst[e] = __float2bfloat16(v[e]);
        }
      }
      cluster_sync();   // no CTA leaves while a peer may read its partial
    }
  }
}

// ----------------------------------------------- tensor-map descriptors ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Descriptors are cached by (pointer, dims, row stride, box): a decode step
// asks for the same weights' maps hundreds of times, and the host is what
// holds a decode step back.  A map depends on nothing else, so a reused
// address with the same shape gets the same, still correct, map.
std::mutex cache_mutex;
std::map<std::array<uint64_t, 6>, CUtensorMap> cache;

// A 2-D bf16 tensor of `outer` rows of `inner` contiguous elements, rows
// `row_bytes` apart, read in boxes of box_inner x box_outer.
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner,
               uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
               uint32_t box_outer) {
  if (outer == 1) row_bytes = (inner * 2 + 15) / 16 * 16;  // never stepped
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const std::array<uint64_t, 6> key = {reinterpret_cast<uint64_t>(ptr), inner,
                                       outer, row_bytes, box_inner, box_outer};
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  // cuTensorMapEncodeTiled needs a current context.  A host
  // thread that has made no runtime call yet may have none: PyTorch's
  // autograd worker runs a backward whose first CUDA work is this
  // product's, and there the encode failed.  cudaFree(nullptr) makes the
  // runtime bind the device's primary context, once a thread.
  static thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

template <int NWG, int WN, int TA, int TB, bool SWAP, int STAGES>
int launch_tma(const CUtensorMap& ma, const CUtensorMap& mb, void* y, int M,
               int N, int K, int c, cudaStream_t s) {
  using R = Ring<NWG, WN, STAGES>;
  const auto kernel = ina_matmul_tma_kernel<NWG, WN, TA, TB, SWAP, STAGES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tile_m = SWAP ? WN : 64 * NWG, tile_n = SWAP ? 64 * NWG : WN;
  const int tiles_m = (M + tile_m - 1) / tile_m;
  const int tiles_n = (N + tile_n - 1) / tile_n;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  const dim3 block(128 * (NWG + 1));
  if (c == 1) {
    ina_matmul_tma_kernel<NWG, WN, TA, TB, SWAP, STAGES>
        <<<dim3(tiles_m * tiles_n), block, R::SMEM, s>>>(
        ma, mb, out, M, N, K, tiles_m, tiles_n, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * c, tiles_m);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = R::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = c;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, ma, mb, out, M, N, K,
                                           tiles_m, tiles_n, c);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The wide and narrow regimes: tensor maps for x ([M][K], K contiguous)
// and w (row-major [K][N], or k-major: N rows of K), then the instantiation
// the plan names.
int launch_planned(const void* x, const void* w, void* y, int M, int N, int K,
                   long long ldx, long long w_sk, long long w_sn, int w_kmajor,
                   int regime, int tile_m, int tile_n, int c, cudaStream_t s) {
  const bool narrow = regime == REGIME_NARROW;
  if ((c != 1 && c != 2 && c != 4 && c != 8) || (K + BK - 1) / BK < c ||
      (w_kmajor ? w_sk : w_sn) != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int err = tensor_map(&mx, x, K, M, ldx * 2, BK, tile_m);
  if (err == 0)
    err = w_kmajor ? tensor_map(&mw, w, K, N, w_sn * 2, BK, narrow ? 64 : tile_n)
                   : tensor_map(&mw, w, N, K, w_sk * 2, 64, BK);
  if (err != 0) return err;
  if (narrow && tile_n == 64 && M <= tile_m) {   // A = w, B = x
    if (tile_m == 8)
      return w_kmajor ? launch_tma<1, 8, 0, 0, true, 8>(mw, mx, y, M, N, K, c, s)
                      : launch_tma<1, 8, 1, 0, true, 8>(mw, mx, y, M, N, K, c, s);
    if (tile_m == 16)
      return w_kmajor ? launch_tma<1, 16, 0, 0, true, 8>(mw, mx, y, M, N, K, c, s)
                      : launch_tma<1, 16, 1, 0, true, 8>(mw, mx, y, M, N, K, c, s);
  } else if (!narrow) {                          // A = x, B = w
    if (tile_m == 128 && tile_n == 256)
      return w_kmajor ? launch_tma<2, 256, 0, 0, false, 4>(mx, mw, y, M, N, K, c, s)
                      : launch_tma<2, 256, 0, 1, false, 4>(mx, mw, y, M, N, K, c, s);
    if (tile_m == 128 && tile_n == 128)
      return w_kmajor ? launch_tma<2, 128, 0, 0, false, 6>(mx, mw, y, M, N, K, c, s)
                      : launch_tma<2, 128, 0, 1, false, 6>(mx, mw, y, M, N, K, c, s);
    if (tile_m == 64 && tile_n == 128)
      return w_kmajor ? launch_tma<1, 128, 0, 0, false, 8>(mx, mw, y, M, N, K, c, s)
                      : launch_tma<1, 128, 0, 1, false, 8>(mx, mw, y, M, N, K, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------- generic bf16 (mma.sync) --
// Any strides and alignment: element-by-element loads into shared memory,
// mma.sync m16n8k16 on 64 x 64 tiles, K tiles of 128 in order.
constexpr int GBM = 64, GBN = 64, GBK = 128, PAD = 8;
constexpr int GTHREADS = 128;  // 4 warps in a 2x2 grid, 32x32 outputs each

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// KMAJOR: w[k, n] is contiguous along k and the B tile is kept as
// Bs[n][k]; otherwise Bs[k][n].
template <bool KMAJOR>
__global__ void __launch_bounds__(GTHREADS)
ina_matmul_generic_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, int M, int N, int K,
                          long long ldx, long long w_sk, long long w_sn) {
  __shared__ __align__(16) __nv_bfloat16 As[GBM][GBK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[KMAJOR ? GBN : GBK]
                                           [(KMAJOR ? GBK : GBN) + PAD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int i = tid; i < GBM * GBK; i += GTHREADS) {
      const int r = i / GBK, c = i % GBK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? x[gm * ldx + gk] : zero;
    }
    for (int i = tid; i < GBN * GBK; i += GTHREADS) {
      const int n = KMAJOR ? i / GBK : i % GBN;
      const int k = KMAJOR ? i % GBK : i / GBN;
      const int gn = n0 + n, gk = k0 + k;
      const __nv_bfloat16 v =
          (gn < N && gk < K) ? w[gk * w_sk + gn * w_sn] : zero;
      if constexpr (KMAJOR) Bs[n][k] = v;
      else Bs[k][n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
        a[mi][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        if constexpr (KMAJOR) {
          b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 2 * t]);
          b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 2 * t + 8]);
        } else {
          b[ni][0] = pack2(&Bs[kk + 2 * t][c], &Bs[kk + 2 * t + 1][c]);
          b[ni][1] = pack2(&Bs[kk + 2 * t + 8][c], &Bs[kk + 2 * t + 9][c]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // The finished tile, written once: c0,c1 at (g, 2t..2t+1), c2,c3 at g+8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mi * 16 + g + half * 8;
        const int c = n0 + wn + ni * 8 + 2 * t;
        if (r >= M) continue;
        __nv_bfloat16* row = y + (long long)r * N;
        if (c < N) row[c] = __float2bfloat16(acc[mi][ni][half * 2]);
        if (c + 1 < N) row[c + 1] = __float2bfloat16(acc[mi][ni][half * 2 + 1]);
      }
}

// ----------------------------------------------------------------- f32 ----
constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int FTHREADS = 256;  // 16x16 threads, 4x4 outputs each

__global__ void __launch_bounds__(FTHREADS)
ina_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int M, int N, int K,
                      long long ldx, long long w_sk, long long w_sn,
                      int w_kmajor) {
  __shared__ float As[FBK][FBM + 4];  // [k][m]
  __shared__ float Bs[FBK][FBN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int it = 0; it < FBM * FBK / FTHREADS; ++it) {
      const int i = tid + it * FTHREADS;
      const int r = i / FBK, c = i % FBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[gm * ldx + gk] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < FBN * FBK / FTHREADS; ++it) {
      const int i = tid + it * FTHREADS;
      const int r = w_kmajor ? i % FBK : i / FBN;
      const int c = w_kmajor ? i / FBK : i % FBN;
      const int gn = n0 + c, gk = k0 + r;
      Bs[r][c] = (gn < N && gk < K) ? w[gk * w_sk + gn * w_sn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < N) y[(long long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// y is a contiguous [M, N] output; x has row stride ldx and unit column
// stride; w[k, n] sits at w + k * w_sk + n * w_sn.  `plan` packs what
// plan_matmul chose (one argument instead of five: a decode step makes
// hundreds of calls): bits 0-1 regime (0 generic bf16, 1 wide bf16,
// 2 narrow bf16, 3 float32), 2-9 tile_m, 10-19 tile_n, 20-23 cluster size
// (read by regimes 1 and 2 only), 24 w is k-major (w_sk == 1).  Returns
// the launch's cudaError_t.
extern "C" int ina_matmul(const void* x, const void* w, void* y, int M, int N,
                          int K, long long ldx, long long w_sk, long long w_sn,
                          int plan, void* stream) {
  const int regime = plan & 3, tile_m = (plan >> 2) & 0xFF;
  const int tile_n = (plan >> 10) & 0x3FF, cluster = (plan >> 20) & 0xF;
  const int w_kmajor = (plan >> 24) & 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (regime) {
    case REGIME_WIDE:
    case REGIME_NARROW:
      return launch_planned(x, w, y, M, N, K, ldx, w_sk, w_sn, w_kmajor,
                            regime, tile_m, tile_n, cluster, s);
    case REGIME_GENERIC: {
      const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      const auto* wb = static_cast<const __nv_bfloat16*>(w);
      auto* yb = static_cast<__nv_bfloat16*>(y);
      if (w_kmajor)
        ina_matmul_generic_kernel<true><<<grid, GTHREADS, 0, s>>>(
            xb, wb, yb, M, N, K, ldx, w_sk, w_sn);
      else
        ina_matmul_generic_kernel<false><<<grid, GTHREADS, 0, s>>>(
            xb, wb, yb, M, N, K, ldx, w_sk, w_sn);
      break;
    }
    case REGIME_F32: {
      const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
      ina_matmul_f32_kernel<<<grid, FTHREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(y), M, N, K, ldx, w_sk, w_sn, w_kmajor);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
