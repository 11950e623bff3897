// INA matmul for Hopper (sm_90a): y[M,N] = x[M,K] @ w[K,N].
//
// Replaces: src/repro/kernels/ina_matmul.py, ina_matmul / _kernel (the
// Pallas kernel whose f32 accumulator stays in VMEM across the K grid axis
// and is cast and written once, at the last K block).
//
// The point kept: each block owns one output tile and walks the whole K
// range in a loop, with the f32 partial sums held in registers.  The tile is
// written to device memory once, after the last K step.  No partial sum is
// ever stored and re-read (that would be the eject/inject baseline), and
// there is no split-K and no atomic.
//
// What bounds it on an H100: at decode (M = number of slots, <= 4) every
// weight byte is used for at most 4 rows, far below the ~295 operations per
// byte where the tensor cores become the limit, so the time is the weight
// read (bytes-bound).  At a prefill chunk (M = 64) a [64,1536]x[1536,8960]
// product does 64 operations per weight byte: still under the ridge, but
// close enough that operation rate matters.
//
// What the design does about it: bf16 goes through the tensor cores
// (mma.sync m16n8k16, f32 accumulate) so arithmetic is never the limit; the
// weight tile is read once per block with neighbouring threads on
// neighbouring addresses along whichever axis of w is contiguous (row-major
// w, or the transposed view of the tied embedding table read in place).
// Loads are 16-byte vectors where the shape allows, with the next 128-deep K
// tile fetched into registers while the current one is multiplied, so one
// tile's loads are always in flight.  That is one tile of latency hiding, not
// a deep pipeline: at decode the kernel stays above the byte bound.  A
// multi-stage cp.async / TMA ring with wgmma is the next step.
//
// Every output element sums its K terms in the same order whatever M is
// (K tiles in order, fixed tile shape), so a row computed in a prefill chunk
// and the same row computed in a decode step agree bit for bit.
//
// f32 inputs take a plain FMA kernel (no TF32), k in ascending order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16 ----
constexpr int BM = 64, BN = 64, BK = 128, PAD = 8;
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid, 32x32 outputs each
constexpr int LDA = BK + PAD;  // As[m][k]
constexpr int LDK = BK + PAD;  // Bs[n][k] for a k-contiguous w
constexpr int LDN = BN + PAD;  // Bs[k][n] for an n-contiguous w
constexpr int AV = BM * BK / 8 / THREADS;  // 16-byte vectors per thread
constexpr int BV = BN * BK / 8 / THREADS;

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

// KMAJOR: w[k, n] is contiguous along k (the tied head's embed^T), and the
// B tile is kept as Bs[n][k]; otherwise w is contiguous along n and the tile
// is kept as Bs[k][n].  Either way every global load runs along the
// contiguous axis.  VEC: K, N, the strides and the pointers allow 16-byte
// loads; then the next K tile's loads are issued into registers before the
// current tile's products, so a load is always in flight.  Without VEC the
// tiles are loaded element by element (ragged or unaligned shapes).
template <bool KMAJOR, bool VEC>
__global__ void __launch_bounds__(THREADS)
ina_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, int M, int N, int K,
                       long long ldx, long long w_sk, long long w_sn) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[KMAJOR ? BN : BK][KMAJOR ? LDK : LDN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  uint4 ra[AV], rb[BV];
  // vector i of the A tile: row i / (BK/8), k offset (i % (BK/8)) * 8
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < AV; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      ra[it] = (gm < M && gk < K)
                   ? *reinterpret_cast<const uint4*>(x + gm * ldx + gk)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < BV; ++it) {
      const int i = tid + it * THREADS;
      int gk, gn;
      if constexpr (KMAJOR) {
        gn = n0 + i / (BK / 8);
        gk = k0 + (i % (BK / 8)) * 8;
      } else {
        gk = k0 + i / (BN / 8);
        gn = n0 + (i % (BN / 8)) * 8;
      }
      rb[it] = (gn < N && gk < K)
                   ? *reinterpret_cast<const uint4*>(w + gk * w_sk + gn * w_sn)
                   : make_uint4(0, 0, 0, 0);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int it = 0; it < AV; ++it) {
      const int i = tid + it * THREADS;
      *reinterpret_cast<uint4*>(&As[i / (BK / 8)][(i % (BK / 8)) * 8]) = ra[it];
    }
#pragma unroll
    for (int it = 0; it < BV; ++it) {
      const int i = tid + it * THREADS;
      if constexpr (KMAJOR)
        *reinterpret_cast<uint4*>(&Bs[i / (BK / 8)][(i % (BK / 8)) * 8]) = rb[it];
      else
        *reinterpret_cast<uint4*>(&Bs[i / (BN / 8)][(i % (BN / 8)) * 8]) = rb[it];
    }
  };
  auto load_scalar = [&](int k0) {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? x[gm * ldx + gk] : zero;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int n = KMAJOR ? i / BK : i % BN;
      const int k = KMAJOR ? i % BK : i / BN;
      const int gn = n0 + n, gk = k0 + k;
      const __nv_bfloat16 v =
          (gn < N && gk < K) ? w[gk * w_sk + gn * w_sn] : zero;
      if constexpr (KMAJOR) Bs[n][k] = v;
      else Bs[k][n] = v;
    }
  };

  if constexpr (VEC) fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (VEC) put(); else load_scalar(k0);
    __syncthreads();
    if constexpr (VEC) {
      if (k0 + BK < K) fetch(k0 + BK);  // in flight during the products
    }

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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

template <bool KMAJOR, bool VEC>
void launch_bf16(dim3 grid, cudaStream_t s, const void* x, const void* w,
                 void* y, int M, int N, int K, long long ldx, long long w_sk,
                 long long w_sn) {
  ina_matmul_bf16_kernel<KMAJOR, VEC><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y), M,
      N, K, ldx, w_sk, w_sn);
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

// dtype: 0 = float32, 1 = bfloat16.  y is a contiguous [M, N] output;
// x has row stride ldx and unit column stride; w[k, n] sits at
// w + k * w_sk + n * w_sn.  Returns the launch's cudaError_t.
extern "C" int ina_matmul(const void* x, const void* w, void* y, int M, int N,
                          int K, long long ldx, long long w_sk,
                          long long w_sn, int dtype, void* stream) {
  const int w_kmajor = (w_sk == 1 && w_sn != 1) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const long long w_step = w_kmajor ? w_sn : w_sk;  // stride between vectors
    const bool vec = K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 &&
                     w_step % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (w_kmajor && vec) launch_bf16<true, true>(grid, s, x, w, y, M, N, K, ldx, w_sk, w_sn);
    else if (w_kmajor) launch_bf16<true, false>(grid, s, x, w, y, M, N, K, ldx, w_sk, w_sn);
    else if (vec) launch_bf16<false, true>(grid, s, x, w, y, M, N, K, ldx, w_sk, w_sn);
    else launch_bf16<false, false>(grid, s, x, w, y, M, N, K, ldx, w_sk, w_sn);
  } else if (dtype == 0) {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    ina_matmul_f32_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), M, N, K, ldx, w_sk, w_sn, w_kmajor);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
