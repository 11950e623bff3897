// Flash attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention / _kernel
// (the Pallas kernel whose grid walks KV blocks sequentially with the
// online-softmax state m, l and acc kept in VMEM scratch).
//
// Same function: online softmax with m, l and acc in f32, scale 1/sqrt(D),
// the causal mask filled with -1e30, whole KV tiles past the diagonal
// skipped, p cast to v's dtype before the PV product, output
// acc / max(l, 1e-30).  One extension: query row i sits at absolute position
// q_offset + i (q_offset = 0 with Sq == Sk is exactly the TPU kernel), so a
// prefill chunk attends to the cache prefix in place.  Sq and Sk need not
// divide the tiles; KV rows past Sk are excluded, query rows past Sq are not
// computed.
//
// Grid: one block per (query tile of BQ rows, batch*head).  On Hopper the
// sequential KV grid axis of the TPU kernel becomes a loop inside the block,
// since nothing carries between blocks.  Each warp owns BQ/4 query rows;
// lane j scores KV row j of the tile, and for the PV product each lane owns
// D/32 output columns, so m, l and acc stay in registers for the whole loop.
//
// What bounds it on an H100: at the serving shapes (D = 128, a chunk of 64
// queries over at most a few hundred cached rows) the work is a few MFLOP per
// head against K and V reads of the same order in bytes: bytes-bound on KV.
// What the design does about it: each K/V tile is read from device memory
// once per block into shared memory (stride D+1 floats, so lane j reading row
// j hits distinct banks) and reused by all BQ query rows of the block; the
// score matrix never leaves registers and shared memory.  The products are
// f32 FMA, not tensor cores: this first version is simple and exact; an
// mma/wgmma version with more query rows per block is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16, BKV = 32, WARPS = 4, ROWS = BQ / WARPS;
constexpr int MAXD = 128, DPL = MAXD / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int D, int q_offset, float scale, int causal) {
  __shared__ float Qs[BQ][MAXD];
  __shared__ float Ks[BKV][MAXD + 1];
  __shared__ float Vs[BKV][MAXD + 1];
  __shared__ float Ps[WARPS][BKV];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  T* ob = o + bh * Sq * D;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < Sq) ? to_f(qb[(long long)(q0 + r) * D + d]) : 0.0f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.0f;
  }

  // Causal block skip: no row of this block sees a key past its last row.
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_offset + last_row + 1) : Sk;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < BKV * D; i += WARPS * 32) {
      const int r = i / D, d = i % D;
      const int j = kv0 + r;
      const bool in = j < Sk;
      Ks[r][d] = in ? to_f(kb[(long long)j * D + d]) : 0.0f;
      Vs[r][d] = in ? to_f(vb[(long long)j * D + d]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = warp * ROWS + rr;
      const int qi = q0 + row;
      if (qi >= Sq) continue;  // warp-uniform
      const int j = kv0 + lane;
      const bool valid = j < Sk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[row][d], Ks[lane][d], s);
      s *= scale;
      if (causal && q_offset + qi < j) s = NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(valid ? s : -INFINITY));
      const float alpha = expf(m[rr] - m_new);
      const float p = valid ? expf(s - m_new) : 0.0f;
      l[rr] = l[rr] * alpha + warp_sum(p);
      Ps[warp][lane] = to_f(from_f<T>(p));  // p in v's dtype, as the TPU kernel
      __syncwarp();
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float pv = 0.0f;
#pragma unroll 8
          for (int jj = 0; jj < BKV; ++jj) pv = fmaf(Ps[warp][jj], Vs[jj][d], pv);
          acc[rr][c] = acc[rr][c] * alpha + pv;
        }
      }
      __syncwarp();
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int qi = q0 + warp * ROWS + rr;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)qi * D + d] = from_f<T>(acc[rr][c] * inv);
    }
  }
}

}  // namespace

// q/o: contiguous [BH, Sq, D]; k/v: contiguous [BH, Sk, D]; D <= 128.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int D,
                               int q_offset, float scale, int causal,
                               int dtype, void* stream) {
  if (D > MAXD) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_attention_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, Sk, D, q_offset, scale, causal);
  } else if (dtype == 0) {
    flash_attention_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, D,
        q_offset, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
