// Flash attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// with grouped KV heads, read in place from the model's layout.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention / _kernel
// (the Pallas kernel whose grid walks KV blocks sequentially with the
// online-softmax state m, l and acc kept in VMEM scratch).
//
// Same function: online softmax with m, l and acc in f32, scale 1/sqrt(D),
// the causal mask filled with -1e30, whole KV tiles past the diagonal
// skipped, p cast to v's dtype before the PV product, output
// acc / max(l, 1e-30).  Extensions: query row i sits at absolute position
// q_offset + i (q_offset = 0 with Sq == Sk is exactly the TPU kernel), so a
// prefill chunk attends to the cache prefix in place; and KV is not
// GQA-expanded: q is [B, Sq, H, D], k/v [B, Sk, KVH, D], every operand read
// through its (batch, seq, head) strides with unit stride along D, so k/v
// may be a slice of a longer KV cache.  o is written as a contiguous
// [B, Sq, H, D].  Sq and Sk need not divide the tiles: KV rows past Sk are
// zero-filled and excluded, query rows past Sq are not computed.
//
// What bounds it on an H100: at the serving shapes (a chunk of 64 queries,
// 12 query heads on 2 KV heads, D = 128, a cache prefix of 64-192 rows) a
// call moves well under 1 MB and does ~50 MFLOP: 0.2 us of memory time,
// 0.05 us of tensor-core time.  Neither is near.  What sets the time is
// launch latency, the latency of the first loads, and the chains of
// dependent instructions in each warp: the problem has only 24 row tiles of
// 16 rows, so a scheduler holds one or two warps and little hides an
// instruction's latency.
//
// What the design does about it:
// * Native GQA in the grid.  One CTA takes one (batch, KV head, tile of
//   packed rows), where packed row i*G + g is query head g of the KV head's
//   group of G = H/KVH at position i.  Each K/V tile is read from device
//   memory once for all G heads, and the causal mask applies per row by
//   its position.  A CTA's warps share its loads.
// * bf16 on tensor cores, FlashAttention-2 style: a row tile of 16 packed
//   rows is shared by KSPLIT = 2 warps, each taking half the keys of every
//   KV tile, which halves each warp's chain of products.  S = Q K^T by
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) stays in registers, is
//   scaled, masked and exponentiated there, rounded to bf16 and reused as
//   the A operand of P V (the TPU kernel's "p cast to v's dtype").  The two
//   warps trade their row maxima through shared memory, so both rescale by
//   the tile's maximum and p is what one warp over the whole tile would
//   compute; their partial acc and l are summed in a fixed order at the
//   end.  m, l and acc stay in registers across the KV loop.  Operands
//   come from shared memory by ldmatrix (.trans for V), rows padded by 16
//   bytes so the 8 rows of an 8x8 matrix hit 8 distinct bank groups.
// * K/V tiles stream through a ring of 2 stages with cp.async, 16 bytes a
//   thread: tile t + 1 loads while tile t computes.  A tile costs one CTA
//   barrier, plus one where its slot is refilled (none where Sk spans at
//   most two tiles: 128 keys in bf16, 64 in float32).
//   Each thread's copies are independent (no carried index), so they go
//   out back to back.  With the ring and the row tiles compiled in, every
//   serving shape ran 0.4-1.2 us faster than with a ring of up to 4 and
//   1 or 2 row tiles chosen per shape at run time (PERF.md).
// * Short instruction chains: exp2 on the MUFU unit with the scale folded
//   into log2 units, the mask as selects (branches cost more than the
//   products they guard) and only on tiles that cross a row's diagonal or
//   Sk, one reciprocal a row in the epilogue; a row tile skips the products
//   of a KV tile wholly past its rows' diagonal.
// * float32 (the exact-f32 phase) uses no tensor cores, since TF32 would
//   round the products.  Same grid and packing, 4 rows a warp (two warps a
//   row tile of 8): lane j scores KV row j of the tile for the warp's rows
//   with float4 loads and four partial sums per row (16 independent chains
//   of D/4 FMAs instead of one chain of D), then owns D/32 output columns
//   for P V.  Its exponent is expf on natural-log scores, as the plain
//   version's torch.exp, not the approximate exp2 of the bf16 kernel.
// Head dims 16 to 160 in steps of 16 are compiled in (160: zamba2's shared
// attention, 2 x 2560 over 32 heads).  At 160 a bf16 thread keeps 80
// accumulator floats and 40 Q fragment registers across the KV loop; ptxas
// gives it 215 registers under the 255 that 128 threads a CTA allow, with
// no spill.  Shared memory at 160: Q 10.5 KB and the K/V ring 84 KB.
// Why not wgmma: a serving call is ~50 MFLOP, under 0.1 us at the
// tensor-core rate; mma.sync's 16-row warp tiles keep each CTA's work short
// and the CTA count up.  A wgmma version for long prompts is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A CTA takes ROW_TILES row tiles of packed rows: 16 in bf16, each shared
// by KSPLIT warps that split every KV tile's keys; 8 in float32, split
// between warps of F32_WARP_ROWS rows: 4 warps, which share every K/V
// tile the CTA loads.  K/V tiles stream through a ring of STAGES.
constexpr int ROW_TILES = 2, KSPLIT = 2, F32_WARP_ROWS = 4, STAGES = 2;
constexpr int BKV_BF16 = 64, BKV_F32 = 32;
constexpr int ROWS_BF16 = 16, ROWS_F32 = 8;
constexpr int BQ_BF16 = ROW_TILES * ROWS_BF16, BQ_F32 = ROW_TILES * ROWS_F32;
constexpr int THREADS = ROW_TILES * KSPLIT * 32;
static_assert(THREADS == BQ_F32 / F32_WARP_ROWS * 32,
              "both kernels launch THREADS threads");
constexpr int MAXD = 160;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, KVH, G, q_offset, causal;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of the newest groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, which no sum here can tell from a denormal)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows row0 .. row0 + rows - 1 (D elements each, at base + row * stride)
// into shared memory rows of LD elements, one 16-byte chunk a copy; rows
// at or past `nrows` are zero-filled.  CHUNKS = D * sizeof(T) / 16 is a
// compile-time constant, so each copy's row and column cost a shift, and
// no index is carried from one copy to the next: they go out back to back.
template <typename T, int CHUNKS>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long stride, int row0,
                                          int nrows, int rows, int LD,
                                          int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll 4
  for (int i = tid; i < rows * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = row0 + r < nrows;
    const T* src = base + (in ? (row0 + r) * stride : 0) + c * VEC;
    cp_async16(dst + r * LD + c * VEC, src, in);
  }
}

// The bq packed rows of this CTA: row r0 + r is head kvh*G + (r0+r) % G at
// position (r0+r) / G; rows past G*Sq are zero-filled.
template <typename T, int CHUNKS>
__device__ __forceinline__ void load_q_rows(T* dst, const Params& p,
                                            const T* qb, int kvh, int r0,
                                            int bq, int LD, int tid,
                                            int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  const int rows = p.G * p.Sq;
#pragma unroll 4
  for (int i = tid; i < bq * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS, c = i % CHUNKS, pr = r0 + r;
    const bool in = pr < rows;
    const int pos = in ? pr / p.G : 0, h = kvh * p.G + (in ? pr % p.G : 0);
    cp_async16(dst + r * LD + c * VEC, qb + pos * p.q_ss + h * p.q_sh + c * VEC,
               in);
  }
}

// The K/V ring: STAGES slots, tile t in slot t % STAGES.  Commit groups,
// oldest first: {Q}, then {K t} and {V t} for every tile, tile t requested
// STAGES - 1 tiles ahead of the one computed; past the last tile the two
// groups are empty, so before tile t is computed exactly 2 STAGES - 1
// groups follow its K and 2 STAGES - 2 its V.
template <typename T, int CHUNKS>
__device__ __forceinline__ void load_tile(T* Ks, T* Vs, const T* kb,
                                           const T* vb, const Params& p,
                                           int t, int ntiles, int bkv, int LD,
                                           int tid, int nthreads) {
  const int slot = (t % STAGES) * bkv * LD;
  if (t < ntiles)
    load_rows<T, CHUNKS>(Ks + slot, kb, p.k_ss, t * bkv, p.Sk, bkv, LD, tid,
                         nthreads);
  cp_async_commit();
  if (t < ntiles)
    load_rows<T, CHUNKS>(Vs + slot, vb, p.v_ss, t * bkv, p.Sk, bkv, LD, tid,
                         nthreads);
  cp_async_commit();
}

// The KV range of a CTA (to its last row's diagonal) and of one warp of
// `rpw` rows starting at packed row wr0 (0 for a warp with no rows).
struct KvRange {
  int cta_end, warp_end, warp_first_pos;
  __device__ __forceinline__ KvRange(const Params& p, int r0, int bq, int wr0,
                                     int rpw) {
    const int rows = p.G * p.Sq;
    const int cta_last = min(r0 + bq, rows) - 1;
    cta_end = p.causal ? min(p.Sk, p.q_offset + cta_last / p.G + 1) : p.Sk;
    const int warp_last = min(wr0 + rpw, rows) - 1;
    warp_end = wr0 >= rows ? 0
               : p.causal ? min(p.Sk, p.q_offset + warp_last / p.G + 1)
                          : p.Sk;
    warp_first_pos = p.q_offset + wr0 / p.G;
  }
  // whether tile [kv0, kv0 + bkv) needs the mask for any row of the warp
  __device__ __forceinline__ bool masked(const Params& p, int kv0,
                                         int bkv) const {
    return kv0 + bkv > p.Sk || (p.causal && kv0 + bkv - 1 > warp_first_pos);
  }
};

// ------------------------------------------------------------ bf16 -------
// bar.sync on a named barrier for the `count` threads of one row tile
__device__ __forceinline__ void tile_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;       // shared row: D elements + 16 bytes
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int ND = D / 8;       // n-tiles of P V
  constexpr int KW = BKV_BF16 / KSPLIT;   // keys of a tile one warp takes
  constexpr int NT = KW / 8;      // its n-tiles of S
  constexpr int KK = KW / 16;     // its k-steps of P V
  constexpr int TILE = BKV_BF16 * LD;
  constexpr int CHUNKS = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[ROW_TILES][KSPLIT][ROWS_BF16];   // row maxima
  using bf16 = __nv_bfloat16;

  // KSPLIT warps share a row tile of 16 packed rows, each taking KW keys
  // of every KV tile
  constexpr int bq = BQ_BF16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = warp / KSPLIT, ks = warp % KSPLIT;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + bq * LD;             // [STAGES][BKV][LD]
  bf16* Vs = Ks + STAGES * TILE;       // [STAGES][BKV][LD]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * bq, rows = p.G * p.Sq;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int wr0 = r0 + rt * ROWS_BF16;
  const KvRange range(p, r0, bq, wr0, ROWS_BF16);
  const int ntiles = (range.cta_end + BKV_BF16 - 1) / BKV_BF16;

  load_q_rows<bf16, CHUNKS>(Qs, p, qb, kvh, r0, bq, LD, tid, THREADS);
  cp_async_commit();
  for (int t = 0; t < STAGES - 1; ++t)
    load_tile<bf16, CHUNKS>(Ks, Vs, kb, vb, p, t, ntiles, BKV_BF16, LD, tid,
                             THREADS);

  const int g = lane >> 2, t = lane & 3;
  // positions of this thread's two rows (g and g + 8 of the tile's 16)
  const int pos_lo = p.q_offset + (wr0 + g) / p.G;
  const int pos_hi = p.q_offset + (wr0 + g + 8) / p.G;
  const float scale2 = p.scale * LOG2E;   // scores in log2 units
  const int bar_id = 1 + rt, bar_count = KSPLIT * 32;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.0f, l_hi = 0.0f;
  uint32_t qf[KD][4];

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * BKV_BF16, slot = (it % STAGES) * TILE;
    load_tile<bf16, CHUNKS>(Ks, Vs, kb, vb, p, it + STAGES - 1, ntiles,
                             BKV_BF16, LD, tid, THREADS);
    cp_async_wait<2 * STAGES - 2>();   // K and V of tile it (and Q)
    __syncthreads();
    if (it == 0) {
      // Q A-fragments, kept in registers for the whole KV loop
      const uint32_t qa = smem_u32(Qs + (rt * ROWS_BF16 + (lane & 15)) * LD +
                                   (lane >> 4) * 8);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], qa + kd * 32);
    }
    const bool active = kv0 < range.warp_end;   // the same for the row tile
    const int k0 = kv0 + ks * KW;               // this warp's first key
    uint32_t pa[KK][4];
    if (active) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      // S = Q K^T: ldmatrix x4 gives the B fragments of two key n-tiles
      const uint32_t ka = smem_u32(Ks + slot +
                                   (ks * KW + (lane & 7) + ((lane >> 4) << 3)) *
                                       LD +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t kf[4];
          ldsm_x4(kf, ka + (n2 * 16 * LD + kd * 16) * 2);
          mma_bf16(s[2 * n2], qf[kd], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kd], kf[2], kf[3]);
        }
      }
      // scale into log2 units, mask where the tile needs it, row maxima
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
      if (range.masked(p, kv0, BKV_BF16)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + n * 8 + 2 * t + (e & 1);
            // selects, not branches: past the diagonal -1e30, past the
            // keys -inf (excluded from the max and from l)
            const float x = p.causal && (e < 2 ? pos_lo : pos_hi) < j
                                ? NEG_INF : s[n][e];
            s[n][e] = j >= p.Sk ? -INFINITY : x;
          }
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      // the row maxima over the whole tile, from the KSPLIT warps of the
      // row tile: every warp rescales with the same m, so p is what one
      // warp over the whole tile would compute
      if (t == 0) {
        red[rt][ks][g] = mx_lo;
        red[rt][ks][g + 8] = mx_hi;
      }
      tile_sync(bar_id, bar_count);
#pragma unroll
      for (int i = 0; i < KSPLIT; ++i) {
        mx_lo = fmaxf(mx_lo, red[rt][i][g]);
        mx_hi = fmaxf(mx_hi, red[rt][i][g + 8]);
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      const float a_lo = exp2_fast(m_lo - mn_lo);
      const float a_hi = exp2_fast(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      // p = exp(s - m) in f32 for l; rounded to bf16 for P V.  l stays a
      // per-thread partial sum, reduced at the end.
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2_fast(s[n][0] - mn_lo);
        const float p1 = exp2_fast(s[n][1] - mn_lo);
        const float p2 = exp2_fast(s[n][2] - mn_hi);
        const float p3 = exp2_fast(s[n][3] - mn_hi);
        sum_lo += p0 + p1;
        sum_hi += p2 + p3;
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= a_lo;
        acc[n][1] *= a_lo;
        acc[n][2] *= a_hi;
        acc[n][3] *= a_hi;
      }
    }
    if (active) {
      // acc += P V over this warp's keys: ldmatrix x4 .trans gives the B
      // fragments of two output n-tiles over 16 keys
      const uint32_t va = smem_u32(
          Vs + slot +
          (ks * KW + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, va + (kk * 16 * LD + n2 * 16) * 2);
          mma_bf16(acc[2 * n2], pa[kk], vf[0], vf[1]);
          mma_bf16(acc[2 * n2 + 1], pa[kk], vf[2], vf[3]);
        }
      }
    }
    // every warp is done with the slot before tile it + STAGES refills it
    if (it + STAGES < ntiles) __syncthreads();
  }
  __syncthreads();   // the ring is free for the partial sums

  // The KSPLIT partial acc and l of a row tile summed in a fixed tree
  // (warp ks + stride into warp ks) through the ring's shared memory, free
  // now; then o = acc / max(l, 1e-30), rows past G*Sq not written.
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  constexpr int NV = ND * 4 + 2;   // values a thread hands on
  float* cbuf = reinterpret_cast<float*>(Ks) + rt * (KSPLIT / 2) * NV * 32;
#pragma unroll
  for (int stride = KSPLIT / 2; stride >= 1; stride /= 2) {
    if (ks >= stride && ks < 2 * stride) {
      float* c = cbuf + (ks - stride) * NV * 32 + lane;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[(n * 4 + e) * 32] = acc[n][e];
      c[ND * 4 * 32] = l_lo;
      c[(ND * 4 + 1) * 32] = l_hi;
    }
    tile_sync(bar_id, bar_count);
    if (ks < stride) {
      const float* c = cbuf + ks * NV * 32 + lane;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += c[(n * 4 + e) * 32];
      l_lo += c[ND * 4 * 32];
      l_hi += c[(ND * 4 + 1) * 32];
    }
    tile_sync(bar_id, bar_count);
  }
  if (ks != 0) return;
  const float inv_lo = __frcp_rn(fmaxf(l_lo, 1e-30f));
  const float inv_hi = __frcp_rn(fmaxf(l_hi, 1e-30f));
  bf16* ob = static_cast<bf16*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = wr0 + g + half * 8;
    if (pr >= rows) continue;
    const int pos = pr / p.G, h = kvh * p.G + pr % p.G;
    bf16* orow = ob + (((long long)b * p.Sq + pos) * p.H + h) * D;
    const float inv = half ? inv_hi : inv_lo;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * half] * inv,
                                acc[n][2 * half + 1] * inv);
    }
  }
}

// ------------------------------------------------------------ float32 ----
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const Params p) {
  constexpr int LD = D + 4;        // shared row: D floats + 16 bytes
  constexpr int DPL = (D + 31) / 32;   // output columns a lane owns
  constexpr int TILE = BKV_F32 * LD;
  constexpr int CHUNKS = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RW = F32_WARP_ROWS, bq = BQ_F32;   // rows a warp, a CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + bq * LD;             // [STAGES][BKV][LD]
  float* Vs = Ks + STAGES * TILE;       // [STAGES][BKV][LD]
  float* Ps = Vs + STAGES * TILE;       // [warps][RW][BKV]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * bq, rows = p.G * p.Sq;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb;
  const float* kb =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int wr0 = r0 + warp * RW;
  const KvRange range(p, r0, bq, wr0, RW);
  const int ntiles = (range.cta_end + BKV_F32 - 1) / BKV_F32;

  // the same ring and commit groups as the bf16 kernel
  load_q_rows<float, CHUNKS>(Qs, p, qb, kvh, r0, bq, LD, tid, THREADS);
  cp_async_commit();
  for (int t = 0; t < STAGES - 1; ++t)
    load_tile<float, CHUNKS>(Ks, Vs, kb, vb, p, t, ntiles, BKV_F32, LD, tid,
                              THREADS);

  int pos[RW];
  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    pos[r] = p.q_offset + (wr0 + r) / p.G;
    m[r] = NEG_INF;
    l[r] = 0.0f;   // this lane's partial sum, reduced over the warp at the end
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.0f;
  }
  float* Pw = Ps + warp * RW * BKV_F32;
  const float* Qw = Qs + warp * RW * LD;

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * BKV_F32, slot = (it % STAGES) * TILE;
    load_tile<float, CHUNKS>(Ks, Vs, kb, vb, p, it + STAGES - 1, ntiles,
                              BKV_F32, LD, tid, THREADS);
    cp_async_wait<2 * STAGES - 2>();   // K and V of tile it (and Q)
    __syncthreads();
    const bool active = kv0 < range.warp_end;
    float alpha[RW];
    if (active) {
      // lane j scores key kv0 + j for the warp's rows: four partial
      // sums a row, float4 loads (the Q row is a broadcast)
      float4 part[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) part[r] = make_float4(0, 0, 0, 0);
      const float* krow = Ks + slot + lane * LD;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(Qw + r * LD + d);
          part[r].x = fmaf(qv.x, kv.x, part[r].x);
          part[r].y = fmaf(qv.y, kv.y, part[r].y);
          part[r].z = fmaf(qv.z, kv.z, part[r].z);
          part[r].w = fmaf(qv.w, kv.w, part[r].w);
        }
      }
      const int j = kv0 + lane;
      const bool masked = range.masked(p, kv0, BKV_F32);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float x =
            ((part[r].x + part[r].y) + (part[r].z + part[r].w)) * p.scale;
        if (masked) {
          x = p.causal && pos[r] < j ? NEG_INF : x;
          x = j >= p.Sk ? -INFINITY : x;
        }
        const float mn = fmaxf(m[r], warp_max(x));
        alpha[r] = expf(m[r] - mn);
        const float pr = expf(x - mn);
        l[r] = l[r] * alpha[r] + pr;
        m[r] = mn;
        Pw[r * BKV_F32 + lane] = pr;
      }
    }
    __syncwarp();   // the warp's P rows are written
    if (active) {
      const float* Vt = Vs + slot;
      // acc = acc * alpha + P V, lane owning columns lane + 32 c
      float pv[RW][DPL];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < DPL; ++c) pv[r][c] = 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < BKV_F32; ++jj) {
        float vv[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          vv[c] = d < D ? Vt[jj * LD + d] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float pj = Pw[r * BKV_F32 + jj];
#pragma unroll
          for (int c = 0; c < DPL; ++c) pv[r][c] = fmaf(pj, vv[c], pv[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] = acc[r][c] * alpha[r] + pv[r][c];
    }
    __syncwarp();   // P is read before the next tile rewrites it
    if (it + STAGES < ntiles) __syncthreads();   // the slot refills
  }

  float* ob = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float inv = __frcp_rn(fmaxf(warp_sum(l[r]), 1e-30f));
    const int pr = wr0 + r;
    if (pr >= rows) continue;
    const int h = kvh * p.G + pr % p.G;
    float* orow = ob + (((long long)b * p.Sq + pr / p.G) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[r][c] * inv;
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in; `opted` keeps
// the largest size this kernel has opted in for, so it is set once.
int launch(void (*kernel)(Params), dim3 grid, int threads, size_t smem,
           size_t& opted, cudaStream_t s, const Params& p) {
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(bool bf16, dim3 grid, size_t smem, cudaStream_t s,
             const Params& p) {
  static size_t opted_bf16 = 0, opted_f32 = 0;
  return bf16 ? launch(flash_attention_bf16_kernel<D>, grid, THREADS, smem,
                       opted_bf16, s, p)
              : launch(flash_attention_f32_kernel<D>, grid, THREADS, smem,
                       opted_f32, s, p);
}

}  // namespace

// q: [B, Sq, H, D] and k/v: [B, Sk, KVH, D], each through its (batch, seq,
// head) strides in elements with unit stride along D; o: contiguous
// [B, Sq, H, D].  H % KVH == 0; D in 16, 32, ..., 160.  dtype 0 = float32,
// 1 = bfloat16.  Bases and strides on the 16-byte grid.  bq (packed rows a
// CTA) and bkv (KV rows a tile) must be the dtype's: 32 and 64 in bf16, 16
// and 32 in f32.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KVH,
                               int D, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, int q_offset, float scale,
                               int causal, int dtype, int bq, int bkv,
                               void* stream) {
  const bool bf16 = dtype == 1;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 ||
      D > MAXD || D % 16 != 0 || (dtype != 0 && dtype != 1) ||
      bq != (bf16 ? BQ_BF16 : BQ_F32) || bkv != (bf16 ? BKV_BF16 : BKV_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Sq, Sk, H, KVH, H / KVH, q_offset, causal,
                 scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const dim3 grid(((H / KVH) * Sq + bq - 1) / bq, KVH, B);
  // Q, then the K and V rings (rows padded by 16 bytes); in bf16 the ring
  // later holds the partial sums of the key split, in f32 P follows it
  size_t smem;
  if (bf16) {
    const size_t ring = (size_t)2 * STAGES * BKV_BF16 * (D + 8) * 2;
    const size_t partial =
        (size_t)ROW_TILES * (KSPLIT / 2) * (D / 8 * 4 + 2) * 32 * 4;
    smem = (size_t)bq * (D + 8) * 2 + (ring > partial ? ring : partial);
  } else {
    smem = ((size_t)(bq + 2 * STAGES * BKV_F32) * (D + 4) +
            (size_t)ROW_TILES * ROWS_F32 * BKV_F32) * 4;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(bf16, grid, smem, s, p);
    case 32: return launch_d<32>(bf16, grid, smem, s, p);
    case 48: return launch_d<48>(bf16, grid, smem, s, p);
    case 64: return launch_d<64>(bf16, grid, smem, s, p);
    case 80: return launch_d<80>(bf16, grid, smem, s, p);
    case 96: return launch_d<96>(bf16, grid, smem, s, p);
    case 112: return launch_d<112>(bf16, grid, smem, s, p);
    case 128: return launch_d<128>(bf16, grid, smem, s, p);
    case 144: return launch_d<144>(bf16, grid, smem, s, p);
    default: return launch_d<160>(bf16, grid, smem, s, p);
  }
}
