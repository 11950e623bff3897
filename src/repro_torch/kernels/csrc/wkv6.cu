// RWKV6 WKV recurrence for Hopper (sm_90a), zero initial state:
//   y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
//
// Replaces: src/repro/kernels/wkv6.py, wkv6 / _kernel (the Pallas kernel whose
// grid walks sequence chunks in order with the [hd, hd] f32 state kept in
// VMEM scratch).
//
// Same function as repro.kernels.ref.wkv6_ref: r/k/v in bf16 or f32, logw and
// u in f32, all arithmetic in f32, y in r's dtype.  The TPU kernel factorises
// the decay inside a chunk and clamps exp(-cum) at 80 nats, so it equals the
// recurrence only while a chunk's cumulative decay stays under 80 nats.  This
// kernel runs the recurrence step by step: it is exact for every decay, and
// takes any S >= 1 (there is no chunk to divide S).
//
// Layout: r/k/v/logw are read as [B, S, H, hd] through one shared set of
// strides with unit stride along hd, which is the model's projection layout,
// so the model passes views and nothing is transposed or cast; the JAX
// signature [BH, S, hd] is the case H = 1.  u is [B, H, hd] through strides
// (stride 0 along B when the heads' u is shared by the batch).  y is written
// contiguous [B, S, H, hd].
//
// Grid: one block per (batch, head), hd threads.  Thread j keeps column j of
// the state, S[:, j], in hd registers for the whole sequence, so the state
// never leaves the chip (the point the TPU kernel's docstring makes); the
// columns never interact.  Every TS steps the block stages r, k, v and
// exp(logw) of the next TS steps in shared memory and forms each step's bonus
// sum_c r_c u_c k_c once; then each thread runs the TS steps from shared
// memory with no barrier.  Per step and column: hd FMAs for y and hd for the
// state update.
//
// What bounds it on an H100: each input is read once and y written once,
// B*S*H*hd*(3 elt + 4 + elt) bytes, against 4*B*S*H*hd^2 f32 operations; at
// the rwkv6-7b forward (B 2, S 2048, H 64, hd 64) both bounds are ~0.06 ms.
// What the design does about it: inputs are read once, coalesced along hd,
// and the state stays in registers.  But there are only B*H blocks of hd
// threads (128 blocks of two warps at B 2, one wave), so the time is the
// latency of the sequential step loop, not either bound.  A chunked
// tensor-core form (the TPU's factorisation on mma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int STAGE_FLOATS = 2048;  // TS * hd floats per staged array

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

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, T* __restrict__ y, int S, int H,
            long long sb, long long st, long long sh, long long usb,
            long long ush) {
  constexpr int TS = STAGE_FLOATS / HD;  // steps per stage
  __shared__ __align__(16) float rs[TS][HD];
  __shared__ __align__(16) float ks[TS][HD];
  __shared__ __align__(16) float ws[TS][HD];
  __shared__ float vs[TS][HD];
  __shared__ float ps[HD][TS + 1];  // r_c u_c k_c, transposed; +1: no conflicts
  __shared__ float bonus[TS];

  const int j = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long in0 = b * sb + h * sh + j;
  const float uj = u[b * usb + h * ush + j];
  T* yb = y + ((long long)b * S * H + h) * HD + j;
  const long long y_st = (long long)H * HD;

  float state[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) state[c] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int n = min(TS, S - t0);
    __syncthreads();  // the previous stage is consumed
    for (int t = 0; t < n; ++t) {
      const long long off = in0 + (long long)(t0 + t) * st;
      const float rv = to_f(r[off]), kv = to_f(k[off]);
      rs[t][j] = rv;
      ks[t][j] = kv;
      vs[t][j] = to_f(v[off]);
      ws[t][j] = expf(logw[off]);
      ps[j][t] = rv * uj * kv;
    }
    __syncthreads();
    for (int t = j; t < n; t += HD) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) acc += ps[c][t];
      bonus[t] = acc;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[t]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[t]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[t]);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const int c = 4 * q;
        a0 = fmaf(rr.x, state[c], a0);
        a1 = fmaf(rr.y, state[c + 1], a1);
        a2 = fmaf(rr.z, state[c + 2], a2);
        a3 = fmaf(rr.w, state[c + 3], a3);
        state[c] = fmaf(state[c], ww.x, kk.x * vj);
        state[c + 1] = fmaf(state[c + 1], ww.y, kk.y * vj);
        state[c + 2] = fmaf(state[c + 2], ww.z, kk.z * vj);
        state[c + 3] = fmaf(state[c + 3], ww.w, kk.w * vj);
      }
      yb[(long long)(t0 + t) * y_st] =
          from_f<T>((a0 + a1) + (a2 + a3) + bonus[t] * vj);
    }
  }
}

template <typename T>
int launch(int hd, dim3 grid, cudaStream_t s, const void* r, const void* k,
           const void* v, const void* logw, const void* u, void* y, int S,
           int H, long long sb, long long st, long long sh, long long usb,
           long long ush) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* wt = static_cast<const float*>(logw);
  const float* ut = static_cast<const float*>(u);
  T* yt = static_cast<T*>(y);
  switch (hd) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 16, 0, s>>>(rt, kt, vt, wt, ut, yt, S, H, sb,
                                             st, sh, usb, ush);
      break;
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, s>>>(rt, kt, vt, wt, ut, yt, S, H, sb,
                                             st, sh, usb, ush);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, s>>>(rt, kt, vt, wt, ut, yt, S, H, sb,
                                             st, sh, usb, ush);
      break;
    case 128:
      wkv6_kernel<T, 128><<<grid, 128, 0, s>>>(rt, kt, vt, wt, ut, yt, S, H,
                                               sb, st, sh, usb, ush);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v (dtype) and logw (float32): [B, S, H, hd] at element strides
// (sb, st, sh, 1); u (float32): [B, H, hd] at (usb, ush, 1); y (dtype):
// contiguous [B, S, H, hd].  hd in {16, 32, 64, 128}; dtype 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, void* y, int B, int S,
                    int H, int hd, long long sb, long long st, long long sh,
                    long long usb, long long ush, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(hd, grid, s, r, k, v, logw, u, y, S, H, sb,
                                 st, sh, usb, ush);
  if (dtype == 0)
    return launch<float>(hd, grid, s, r, k, v, logw, u, y, S, H, sb, st, sh,
                         usb, ush);
  return static_cast<int>(cudaErrorInvalidValue);
}
