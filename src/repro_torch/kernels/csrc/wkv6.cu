// RWKV6 WKV recurrence for Hopper (sm_90a), zero initial state:
//   y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
//
// Replaces: src/repro/kernels/wkv6.py, wkv6 / _kernel (the Pallas kernel whose
// grid walks sequence chunks in order with the [hd, hd] f32 state kept in
// VMEM scratch).
//
// Same function as repro.kernels.ref.wkv6_ref: r/k/v in bf16 or f32 (widened
// on load), logw and u in f32, every product an f32 FMA on the CUDA cores, y
// stored once in r's dtype.  Any S >= 1; a ragged last chunk is zero-filled.
//
// The chunked form.  A CTA walks its (batch, head) in chunks of C positions.
// With cum_t = logw summed from the chunk's start to t (cum_{c0-1} = 0), for
// t in the chunk:
//   y_t = r_t exp(cum_{t-1}) S                              (carried state)
//       + sum_{s<t} [sum_c r_tc k_sc exp(cum_{t-1,c} - cum_sc)] v_s  (scores)
//       + [sum_c r_tc u_c k_tc] v_t                         (u bonus)
//   S  <- diag(exp(cum_end)) S + sum_s (k_s exp(cum_end - cum_s))^T v_s
// Every exponent the kernel evaluates is logw summed over a span, so it is
// <= 0 for any logw <= 0: nothing is clamped (the TPU kernel clamps exp(-cum)
// at 80 nats and is wrong past it) and nothing overflows; a factor that
// underflows to 0 stands for a term below f32's range anyway.  The anchors,
// with the chunk cut in N sub-blocks of SUB positions (b = a sub-block's
// first position, e = its last; sums are taken in order, so with logw <= 0
// every running sum falls and each difference below is <= 0 in f32 too):
//   q_sub_t   = r_t exp(cum_{t-1} - cum_{b-1})      query at its block start
//   k_sub_s   = k_s exp(cum_e - cum_s)              key at its block end
//   d(beta,a) = exp(cum_{b(beta)-1} - cum_{e(a)})   block a's end to beta's
//   q_chunk_t = q_sub_t exp(cum_{b-1})              query at the chunk start
//   k_chunk_s = k_sub_s exp(cum_end - cum_e)        key at the chunk end
// so a query in sub-block beta and a key in an earlier sub-block a score
// sum_c q_sub_tc d_c k_sub_sc with no exponential per pair, and a pair inside
// one sub-block takes exp(cum_{t-1} - cum_s) directly (s <= t - 1).
//
// What bounds it on an H100: f32 operations.  The recurrence does 4 hd^2
// operations a position (B*S*H*4*hd^2, the bound chip_smoke.py reports:
// 0.064 ms at the rwkv6-7b forward, B 2, S 2048, H 64, hd 64, at 67 TFLOP/s;
// the bytes, each input read once and y written once, take 0.05 ms).  The
// chunked form does per position the same 2 hd^2 FMAs (y's carried state
// and the state's step), about C hd more (scores and scores x v, half a
// chunk each on average) and SUB hd / 2 exponentials (pairs inside a
// sub-block): at C 64, SUB 8, hd 64, 12.6 k FMAs a position, 1.54x the
// recurrence's operations.  The first version ran the recurrence step by
// step, one thread per state column, 128 CTAs of 2 warps: 2048 dependent
// steps of ~386 ns each, 12x the bound, a latency chain and not a rate.
//
// What the design does about it: a chunk's work is spread over 16 warps in
// five phases with a barrier after each: (1) cum, the sub-block anchors
// and, for bf16, v widened to f32, a thread a (channel, sub-block); (2) the
// decays between sub-blocks and to the chunk's ends; (3) the scores, inside
// a sub-block a warp a sub-block with a lane a channel and a reduce-scatter
// over the warp's shuffles, between sub-blocks 4x4 tiles of two lanes each;
// (4) the anchors moved to the chunk's ends in place (the sub-block anchors
// and the chunk anchors share shared memory); (5) y = q_chunk S + scores v
// on warps 0-7 and the state's step on warps 8-15, 8x8 register tiles (4
// FMAs for each float read from shared memory, 2 with 4x4 tiles, where the
// shared loads, not the FMAs, set the pace), each tile's K range dealt out
// to four lanes and summed over shuffles, so that a thread stays within the
// 128 registers 512 threads allow; warps w and w + 4 share a scheduler and
// take y's sub-blocks b and 7 - b, so the triangular scores x v work is
// even.  The state stays on chip for the whole sequence (the point the TPU
// kernel's docstring makes), in shared memory twice: this chunk's y reads
// one copy while its step writes the other.  Loads: 16-byte cp.async of the
// next chunk's r/k/v/logw into the second of two stages while this chunk
// computes; the top barrier of a chunk also frees the stage.  Anchor rows
// are padded by 16 bytes, and 16 more a sub-block, so the score tiles'
// float4 loads of rows 4 or 8 apart hit distinct banks.  Tiles are compiled
// in, the same for both dtypes, so bf16 and f32 inputs of equal values give
// equal bits: C 64 (16 at hd 128, where the state takes 128 KB; a build at
// C 32 ran slower on the H100: the per-chunk barriers and prep outweigh the
// scores' work that C adds), SUB 8, 16 warps; the host entry refuses
// others.  One CTA a (batch, head): 128 at the forward, 64 at B 1.
//
// Layout: r/k/v/logw are read as [B, S, H, hd] through one shared set of
// strides with unit stride along hd, which is the model's projection layout,
// so the model passes views and nothing is transposed or cast; the JAX
// signature [BH, S, hd] is the case H = 1.  u is [B, H, hd] through strides
// (stride 0 along B when the heads' u is shared by the batch).  y is written
// contiguous [B, S, H, hd].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;        // positions of a sub-block
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 8;       // y and the state's step: 8x8 tiles a lane

// C: 64 positions, 16 at hd 128 (where the state's two copies take 128 KB
// of shared memory)
constexpr int chunk_for(int hd) { return hd == 128 ? 16 : 64; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (rows past S)
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N (2, or a multiple of 4) consecutive floats of shared memory, aligned
template <int N>
__device__ __forceinline__ void ld(const float* p, float* out) {
  static_assert(N == 2 || N % 4 == 0, "8- and 16-byte loads");
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
    }
  }
}
__device__ __forceinline__ void st4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
// 4 consecutive elements of y, from f32
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* in) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(in[0], in[1]);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) =
      __floats2bfloat162_rn(in[2], in[3]);
}

// Lanes l and l ^ mask hold partial sums of one tile of R rows over parts
// of its K range; afterwards each holds half the rows of their sum: the
// upper half where lane & mask.
template <int R, int W>
__device__ __forceinline__ void halve(const float (&in)[R][W],
                                      float (&out)[R / 2][W], int lane,
                                      int mask) {
  const bool up = lane & mask;
#pragma unroll
  for (int r = 0; r < R / 2; ++r)
#pragma unroll
    for (int n = 0; n < W; ++n) {
      const float send = up ? in[r][n] : in[r + R / 2][n];
      const float keep = up ? in[r + R / 2][n] : in[r][n];
      out[r][n] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

// An 8x8 tile's 8 columns of a row of HD: c4 .. c4 + 3 and HD/2 + c4 .. + 3,
// so that 8 lanes with c4 = 0, 4, .., 28 load 128 contiguous bytes a half.
template <int HD>
__device__ __forceinline__ void ld_cols(const float* row, int c4, float* out) {
  ld<4>(row + c4, out);
  ld<4>(row + HD / 2 + c4, out + 4);
}

// Shared memory of one CTA, in bytes from the base; every offset 16-aligned.
template <typename T, int HD, int C>
struct Smem {
  static constexpr int N = C / SUB;                  // sub-blocks a chunk
  static constexpr int PAIRS = N * (N - 1) / 2;      // (later, earlier) blocks
  static constexpr int HDP = HD + 4;                 // padded f32 rows
  static constexpr int CP = C + 4;
  static constexpr bool WIDEN_V = sizeof(T) != 4;    // bf16 v widened once
  // two stages of the raw chunk: r, k, v (T) and logw (f32), [C][HD] each;
  // logw's slot becomes cum after the chunk's prep
  static constexpr size_t RAW_T = (size_t)C * HD * sizeof(T);
  static constexpr size_t STAGE = 3 * RAW_T + (size_t)C * HD * 4;
  // the query and key anchors, rows of HDP at arow(t): at the sub-block
  // for the scores, then, rescaled in place, at the chunk for y and the
  // state's step
  static constexpr int AFLOATS = C * HDP + N * 4;
  static constexpr size_t Q = 2 * STAGE;
  static constexpr size_t K = Q + (size_t)AFLOATS * 4;
  static constexpr size_t VF = K + (size_t)AFLOATS * 4;        // [C][HD]
  static constexpr size_t SCORES = VF + (WIDEN_V ? (size_t)C * HD * 4 : 0);
  // the state, [HD][HD], twice: read by this chunk's y, written by its step
  static constexpr size_t STATE = SCORES + (size_t)C * CP * 4;
  static constexpr size_t DEC = STATE + (size_t)2 * HD * HD * 4;  // [PAIRS][HD]
  static constexpr size_t DECAY = DEC + (size_t)(PAIRS > 0 ? PAIRS : 1) * HD * 4;
  static constexpr size_t SUBSUM = DECAY + (size_t)HD * 4;      // [N][HD]
  static constexpr size_t EQ = SUBSUM + (size_t)N * HD * 4;     // [N][HD]
  static constexpr size_t EK = EQ + (size_t)N * HD * 4;         // [N][HD]
  static constexpr size_t BYTES = EK + (size_t)N * HD * 4;
  static_assert(BYTES <= 232448, "over the 227 KB a block can use");
  static_assert(SUB == TILE && C % SUB == 0 && HD % 16 == 0, "tiles");
  // row t of the anchors: HD + 4 floats a row and 4 more a sub-block, so
  // that float4 loads of rows 4 or 8 apart (the score tiles') hit distinct
  // banks
  __host__ __device__ static constexpr int arow(int t) {
    return t * HDP + (t / SUB) * 4;
  }
};

// a loop over n items spread over the CTA, i = tid + THREADS * it, with a
// compile-time trip count so that the iterations interleave
#define FOR_CTA(i, n)                                                  \
  _Pragma("unroll") for (int it_##i = 0;                               \
                         it_##i < ((n) + THREADS - 1) / THREADS; ++it_##i) \
    if (const int i = tid + THREADS * it_##i;                          \
        (n) % THREADS == 0 || i < (n))

template <typename T, int HD, int C>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, T* __restrict__ y, int S, int H,
            long long sb, long long st, long long sh, long long usb,
            long long ush) {
  using L = Smem<T, HD, C>;
  constexpr int N = L::N, CP = L::CP;
  // y: (C/8) x (HD/8) tiles on the first YWARPS warps; the state's step:
  // (HD/8)^2 tiles on the others, in SROUNDS rounds; four lanes a tile
  // (lanes l, l^8, l^16, l^24), each a quarter of its K range
  constexpr int NCT = HD / TILE, NRT = C / TILE;
  constexpr int NYT = NRT * NCT, NST = NCT * NCT;
  constexpr int YWARPS = (NYT + 7) / 8, SWARPS = WARPS - YWARPS;
  constexpr int SROUNDS = (NST + 8 * SWARPS - 1) / (8 * SWARPS);
  static_assert(YWARPS < WARPS && N <= WARPS / 2, "warps for every role");
  // the scores between sub-blocks: 4 tiles a pair on warps N and up, two
  // lanes (l, l^16) a tile, each half of hd
  static_assert(4 * L::PAIRS <= 16 * (WARPS - N), "score tiles");
  constexpr int LANE_CH = HD >= 32 ? HD / 32 : 1;  // channels a lane, diag
  constexpr int PT = HD * (int)sizeof(T) / 16;     // 16-byte pieces a row
  constexpr int PW = HD / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qa = reinterpret_cast<float*>(smem + L::Q);
  float* ka = reinterpret_cast<float*>(smem + L::K);
  float* scores = reinterpret_cast<float*>(smem + L::SCORES);
  float* state = reinterpret_cast<float*>(smem + L::STATE);
  float* dec = reinterpret_cast<float*>(smem + L::DEC);
  float* decay = reinterpret_cast<float*>(smem + L::DECAY);
  float* subsum = reinterpret_cast<float*>(smem + L::SUBSUM);
  float* eq = reinterpret_cast<float*>(smem + L::EQ);
  float* ek = reinterpret_cast<float*>(smem + L::EK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  const int nchunks = (S + C - 1) / C;

  // the chunk's rows of r, k, v and logw into a stage, 16 bytes a copy
  auto load_chunk = [&](int ch, int stage) {
    unsigned char* dst = smem + stage * L::STAGE;
    const int t0 = ch * C;
    const T* src[3] = {r, k, v};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      FOR_CTA(i, C * PT) {
        const int row = i / PT, pc = i % PT;
        const bool in = t0 + row < S;
        cp_async16(dst + a * L::RAW_T + (size_t)i * 16,
                   in ? src[a] + base + (long long)(t0 + row) * st +
                            pc * (16 / sizeof(T))
                      : src[a],
                   in);
      }
    }
    FOR_CTA(i, C * PW) {
      const int row = i / PW, pc = i % PW;
      const bool in = t0 + row < S;
      cp_async16(dst + 3 * L::RAW_T + (size_t)i * 16,
                 in ? logw + base + (long long)(t0 + row) * st + pc * 4 : logw,
                 in);
    }
    cp_async_commit();
  };

  FOR_CTA(i, HD * HD) { state[i] = 0.0f; }   // the zero initial state
  float ureg[LANE_CH];
#pragma unroll
  for (int q = 0; q < LANE_CH; ++q) {
    const int c = lane + 32 * q;
    ureg[q] = c < HD ? u[b * usb + h * ush + c] : 0.0f;
  }

  load_chunk(0, 0);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * C;
    cp_async_wait_all();
    __syncthreads();   // chunk ch landed; chunk ch-1 is consumed
    if (ch + 1 < nchunks) load_chunk(ch + 1, (ch + 1) & 1);
    unsigned char* raw = smem + (ch & 1) * L::STAGE;
    const T* rr = reinterpret_cast<const T*>(raw);
    const T* kr = reinterpret_cast<const T*>(raw + L::RAW_T);
    const T* vr = reinterpret_cast<const T*>(raw + 2 * L::RAW_T);
    float* cum = reinterpret_cast<float*>(raw + 3 * L::RAW_T);  // logw first
    const float* vf = L::WIDEN_V ? reinterpret_cast<float*>(smem + L::VF)
                                 : reinterpret_cast<const float*>(vr);

    // ---- prep 1: cum and the sub-block anchors (and v widened)
    if constexpr (L::WIDEN_V) {
      float2* vw = reinterpret_cast<float2*>(smem + L::VF);
      FOR_CTA(i, C * HD / 2) {
        vw[i] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(vr)[i]);
      }
    }
    FOR_CTA(task, HD * N) {
      const int c = task % HD, sb0 = (task / HD) * SUB;
      float run = 0.0f;   // cum_{t-1} - cum_{b-1}: <= 0, falls with t
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        const int i = (sb0 + m) * HD + c;
        const float lw = cum[i];
        qa[L::arow(sb0 + m) + c] = to_f(rr[i]) * expf(run);   // q_sub
        run += lw;
        cum[i] = run;
      }
      subsum[(task / HD) * HD + c] = run;
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        const int i = (sb0 + m) * HD + c;
        ka[L::arow(sb0 + m) + c] = to_f(kr[i]) * expf(run - cum[i]);  // k_sub
      }
    }
    __syncthreads();

    // ---- prep 2: the decays between sub-blocks and to the chunk's ends
    FOR_CTA(task, HD * N) {
      const int c = task % HD, beta = task / HD;
      float G[N + 1];   // cum at the end of sub-block g - 1, in order
      G[0] = 0.0f;
#pragma unroll
      for (int g = 0; g < N; ++g) G[g + 1] = G[g] + subsum[g * HD + c];
      float gb = 0.0f, gb1 = G[1];
#pragma unroll
      for (int g = 1; g < N; ++g)
        if (g == beta) gb = G[g], gb1 = G[g + 1];
      eq[beta * HD + c] = expf(gb);             // G falls: gb <= 0
      ek[beta * HD + c] = expf(G[N] - gb1);     // G[N] <= gb1
#pragma unroll
      for (int a = 0; a + 1 < N; ++a)       // gb <= G[a+1] for a < beta
        if (a < beta) dec[(beta * (beta - 1) / 2 + a) * HD + c] =
            expf(gb - G[a + 1]);
      if (beta == 0) decay[c] = expf(G[N]);
    }
    __syncthreads();

    // ---- scores [C][C]: sub-block pairs as 4x4 tiles on warps N.. ...
    if (const int tt = (warp - N) * 16 + (lane & 15);
        warp >= N && tt < 16 * ((4 * L::PAIRS + 15) / 16)) {
      const int tile = tt < 4 * L::PAIRS ? tt : 0, p = tile >> 2;
      int beta = 1;
      while ((beta + 1) * beta / 2 <= p) ++beta;
      const int alpha = p - beta * (beta - 1) / 2;
      const int i0 = beta * SUB + 4 * (tile & 1);
      const int j0 = alpha * SUB + 2 * (tile & 2);
      float acc[4][4] = {};
      for (int c = (lane >> 4) * HD / 2; c < ((lane >> 4) + 1) * HD / 2; c += 4) {
        float d[4], qd[4][4], kb[4][4];
        ld<4>(dec + p * HD + c, d);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          ld<4>(qa + L::arow(i0 + m) + c, qd[m]);
#pragma unroll
          for (int x = 0; x < 4; ++x) qd[m][x] *= d[x];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) ld<4>(ka + L::arow(j0 + n) + c, kb[n]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[m][n] += qd[m][x] * kb[n][x];
      }
      float out[2][4];
      halve(acc, out, lane, 16);
      if (tt < 4 * L::PAIRS) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
          st4(scores + (i0 + 2 * (lane >> 4) + m) * CP + j0, out[m]);
      }
    }
    // ... and inside a sub-block: a warp a sub-block, a lane a channel
    if (warp < N) {
      constexpr int NP = SUB * (SUB + 1) / 2;   // pairs j <= i: (i, j) at
      float part[NP];                           // i (i + 1) / 2 + j
#pragma unroll
      for (int x = 0; x < NP; ++x) part[x] = 0.0f;
      const int b0 = warp * SUB;
#pragma unroll
      for (int q = 0; q < LANE_CH; ++q) {
        const int c = lane + 32 * q;
        if (c < HD) {
          float rv[SUB], kv[SUB], cv[SUB];
#pragma unroll
          for (int m = 0; m < SUB; ++m) {
            const int i = (b0 + m) * HD + c;
            rv[m] = to_f(rr[i]), kv[m] = to_f(kr[i]), cv[m] = cum[i];
          }
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
#pragma unroll
            for (int j = 0; j < i; ++j)   // cum falls: cv[i-1] <= cv[j]
              part[i * (i + 1) / 2 + j] += rv[i] * kv[j] * expf(cv[i - 1] - cv[j]);
            part[i * (i + 1) / 2 + i] += rv[i] * ureg[q] * kv[i];
          }
        }
      }
      // reduce-scatter over the warp: lane l ends with the sum of part[l]
      // (constant trip counts, so that part stays in registers)
#pragma unroll
      for (int step = 0; step < 5; ++step) {
        const int o = 16 >> step;
        const bool up = lane & o;
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m < o) {
            const float send = up ? part[m] : part[m + o];
            const float keep = up ? part[m + o] : part[m];
            part[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
      }
#pragma unroll
      for (int x = 32; x < NP; ++x)
#pragma unroll
        for (int step = 0; step < 5; ++step)
          part[x] += __shfl_xor_sync(0xffffffffu, part[x], 16 >> step);
      float* blk = scores + b0 * CP + b0;
#pragma unroll
      for (int e = lane; e < SUB * SUB; e += 32)
        if (e % SUB > e / SUB) blk[(e / SUB) * CP + e % SUB] = 0.0f;
      auto put = [&](int x, float val) {
        int i = 0;
        while ((i + 1) * (i + 2) / 2 <= x) ++i;
        blk[i * CP + x - i * (i + 1) / 2] = val;
      };
      put(lane, part[0]);
      if (lane == 0) {
#pragma unroll
        for (int x = 32; x < NP; ++x) put(x, part[x]);
      }
    }
    __syncthreads();

    // ---- the anchors move from the sub-block's ends to the chunk's:
    // q_chunk = q_sub exp(cum_{b-1}), k_chunk = k_sub exp(cum_end - cum_e)
    FOR_CTA(i, C * HD / 4) {
      const int t = i / (HD / 4), c = 4 * (i % (HD / 4)), e = (t / SUB) * HD + c;
      float4* q4 = reinterpret_cast<float4*>(qa + L::arow(t) + c);
      float4* k4 = reinterpret_cast<float4*>(ka + L::arow(t) + c);
      const float4 fq = *reinterpret_cast<const float4*>(eq + e);
      const float4 fk = *reinterpret_cast<const float4*>(ek + e);
      float4 x = *q4, z = *k4;
      x.x *= fq.x, x.y *= fq.y, x.z *= fq.z, x.w *= fq.w;
      z.x *= fk.x, z.y *= fk.y, z.z *= fk.z, z.w *= fk.w;
      *q4 = x, *k4 = z;
    }
    __syncthreads();

    // ---- y = q_chunk S + scores v (the bonus is on the scores' diagonal)
    // and the state's step: 8x8 tiles, each K range dealt out in steps of 2
    // to the tile's four lanes and summed over the warp's shuffles
    const float* s_old = state + (ch & 1) * HD * HD;
    const int quarter = lane >> 3;
    // after the sums, lane l holds rows 4 (l >> 4 & 1) + 2 (l >> 3 & 1) ..
    const int r0 = 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1);
    if (warp < YWARPS) {
      const int tile = warp * 8 + (lane & 7);
      const int x = (tile < NYT ? tile : 0) / NCT, c4 = 4 * (tile % NCT);
      // the scores x v work grows with the row's sub-block: warps w and
      // w + 4, which share a scheduler, take sub-blocks b and N - 1 - b
      const int i0 = TILE * (x < NRT / 2 ? x : 3 * NRT / 2 - 1 - x);
      float acc[TILE][TILE] = {};
#pragma unroll 1   // unrolled, the tile spills past 128 registers
      for (int c = 2 * quarter; c < HD; c += 8) {
        float a[TILE][2], bm[2][TILE];
#pragma unroll
        for (int m = 0; m < TILE; ++m) ld<2>(qa + L::arow(i0 + m) + c, a[m]);
#pragma unroll
        for (int z = 0; z < 2; ++z) ld_cols<HD>(s_old + (c + z) * HD, c4, bm[z]);
#pragma unroll
        for (int m = 0; m < TILE; ++m)
#pragma unroll
          for (int z = 0; z < 2; ++z)
#pragma unroll
            for (int n = 0; n < TILE; ++n) acc[m][n] += a[m][z] * bm[z][n];
      }
      for (int j = 2 * quarter; j < i0 + TILE; j += 8) {   // keys to i0 + 7
        float a[TILE][2], bm[2][TILE];
#pragma unroll
        for (int m = 0; m < TILE; ++m) ld<2>(scores + (i0 + m) * CP + j, a[m]);
#pragma unroll
        for (int z = 0; z < 2; ++z) ld_cols<HD>(vf + (j + z) * HD, c4, bm[z]);
#pragma unroll
        for (int m = 0; m < TILE; ++m)
#pragma unroll
          for (int z = 0; z < 2; ++z)
#pragma unroll
            for (int n = 0; n < TILE; ++n) acc[m][n] += a[m][z] * bm[z][n];
      }
      float h4[TILE / 2][TILE], out[TILE / 4][TILE];
      halve(acc, h4, lane, 16);
      halve(h4, out, lane, 8);
#pragma unroll
      for (int m = 0; m < TILE / 4; ++m) {
        const int pos = t0 + i0 + r0 + m;
        if (tile < NYT && pos < S) {
          T* row = y + (((long long)b * S + pos) * H + h) * HD;
          st4(row + c4, out[m]);
          st4(row + HD / 2 + c4, out[m] + 4);
        }
      }
    } else if (ch + 1 < nchunks) {   // no step after the last chunk
      float* s_new = state + ((ch + 1) & 1) * HD * HD;
#pragma unroll 1
      for (int round = 0; round < SROUNDS; ++round) {
        const int tile = ((warp - YWARPS) + SWARPS * round) * 8 + (lane & 7);
        const int t = tile < NST ? tile : 0;
        const int c0 = TILE * (t / NCT), c4 = 4 * (t % NCT);
        float acc[TILE][TILE] = {};
#pragma unroll 2
        for (int j = quarter; j < C; j += 4) {
          float a[TILE], bm[TILE];
          ld<TILE>(ka + L::arow(j) + c0, a);
          ld_cols<HD>(vf + j * HD, c4, bm);
#pragma unroll
          for (int m = 0; m < TILE; ++m)
#pragma unroll
            for (int n = 0; n < TILE; ++n) acc[m][n] += a[m] * bm[n];
        }
        float h4[TILE / 2][TILE], out[TILE / 4][TILE];
        halve(acc, h4, lane, 16);
        halve(h4, out, lane, 8);
        if (tile < NST) {
#pragma unroll
          for (int m = 0; m < TILE / 4; ++m) {
            const int c = c0 + r0 + m;
            const float dd = decay[c];
            float old[TILE];
            ld_cols<HD>(s_old + c * HD, c4, old);
#pragma unroll
            for (int n = 0; n < TILE; ++n) old[n] = dd * old[n] + out[m][n];
            st4(s_new + c * HD + c4, old);
            st4(s_new + c * HD + HD / 2 + c4, old + 4);
          }
        }
      }
    }
  }
}

template <typename T, int HD>
int launch_hd(dim3 grid, cudaStream_t s, const void* r, const void* k,
              const void* v, const void* logw, const void* u, void* y, int S,
              int H, long long sb, long long st, long long sh, long long usb,
              long long ush) {
  constexpr int C = chunk_for(HD);
  constexpr size_t smem = Smem<T, HD, C>::BYTES;
  auto kernel = wkv6_kernel<T, HD, C>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<T*>(y), S, H, sb, st, sh, usb,
      ush);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int hd, dim3 grid, cudaStream_t s, const void* r, const void* k,
           const void* v, const void* logw, const void* u, void* y, int S,
           int H, long long sb, long long st, long long sh, long long usb,
           long long ush) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(grid, s, r, k, v, logw, u, y, S, H, sb, st, sh,
                              usb, ush);
    case 32:
      return launch_hd<T, 32>(grid, s, r, k, v, logw, u, y, S, H, sb, st, sh,
                              usb, ush);
    case 64:
      return launch_hd<T, 64>(grid, s, r, k, v, logw, u, y, S, H, sb, st, sh,
                              usb, ush);
    case 128:
      return launch_hd<T, 128>(grid, s, r, k, v, logw, u, y, S, H, sb, st,
                               sh, usb, ush);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r/k/v (dtype) and logw (float32): [B, S, H, hd] at element strides
// (sb, st, sh, 1), bases and strides on the 16-byte grid; u (float32):
// [B, H, hd] at (usb, ush, 1); y (dtype): contiguous [B, S, H, hd].  hd in
// {16, 32, 64, 128}; dtype 0 = float32, 1 = bfloat16.  chunk, sub and warps
// must be the compiled tiles: chunk 64 (16 at hd 128), sub 8, warps 8.
// Returns the launch's cudaError_t.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, void* y, int B, int S,
                    int H, int hd, long long sb, long long st, long long sh,
                    long long usb, long long ush, int dtype, int chunk,
                    int sub, int warps, void* stream) {
  if (B < 1 || S < 1 || H < 1 || (dtype != 0 && dtype != 1) ||
      chunk != chunk_for(hd) || sub != SUB || warps != WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(hd, grid, s, r, k, v, logw, u, y, S, H, sb,
                                 st, sh, usb, ush);
  return launch<float>(hd, grid, s, r, k, v, logw, u, y, S, H, sb, st, sh,
                       usb, ush);
}
