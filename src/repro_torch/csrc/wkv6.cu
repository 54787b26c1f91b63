// K7: the RWKV6 chunked scan for Hopper (sm_90a), fp32 on CUDA cores.
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/wkv6/kernel.py:77 wkv6_bhsk.
//
// Computes, for r, k, v, log_w (B, H, S, K) fp32, contiguous, S a
// multiple of C = 64, and u (H, K) fp32, the scan from a zero state:
// per chunk of C steps, in order,
//   cum       = inclusive cumsum of log_w down the chunk (fp32, in order)
//   q_in      = r * exp(cum - log_w)
//   att       = q_in @ (k * exp(-cum))^T, kept on s < t (strict lower)
//   out       = q_in @ S + att @ v + sum(r * u * k) * v
//   S         = exp(total) * S + (k * exp(total - cum))^T @ v,
//               total = cum of the chunk's last step
// and writes out (B, H, S, K) and the final S (B, H, K, K). The products
// are the Pallas kernel's, as written: IEEE expf, no fast-math
// intrinsics, no rewrite of the exponentials.
//
// What bounds it: the work the function needs is, per (b, h, chunk),
// 4*C*K^2 flops for q_in @ S and the state update plus 2*C*(C-1)*K for
// att and att @ v on the strict lower triangle, against reading r, k,
// v, log_w and writing out once: 19 flops per byte at K = 64, just
// under the H100's 20 (67 TFLOP/s fp32 over 3.35 TB/s), so the bound is
// the bytes (fp32 parity with the JAX package rules out TF32). This
// kernel computes att and att @ v over the whole C x C square and zeroes
// the upper triangle, which is about a quarter of its FMAs. The chunks
// of one (b, h) are a sequential chain through S, so the design:
//   * one block of 256 threads (16 x 16) walks the chunks of one (b, h)
//     in order and keeps S in shared memory for the whole sequence;
//     the final S is written after the last chunk;
//   * each chunk is staged in shared memory: r, k, log_w in their
//     natural layout (stride K + 1: the column scan and the row sums
//     are free of bank conflicts), v row-major with a 16-byte-aligned
//     stride; the decay-weighted tiles are written where the products
//     read them as 16-byte vectors along the reduction: q_in and
//     k * exp(-cum) transposed, k * exp(total - cum) row-major;
//   * the (C x C) att and q_in @ S share one loop over K, att @ v and
//     the state update share one loop over the chunk's steps; a thread
//     owns a 4 x 4 tile of att and a 4 x K/16 tile of out and S;
//   * the cumulative sum is one thread per column, in order; the bonus
//     one thread per row.
// At the slice's prefill shape (B 1, H 40) that is 40 blocks on 132
// SMs: the kernel is bound by one SM's FMA rate per stream, not by the
// card's; splitting the value columns over blocks is a later step.
// Shared memory: 171,776 bytes at K = 64 (dynamic, after
// cudaFuncSetAttribute); a refused launch is returned by
// cudaGetLastError() and raised by the wrapper.
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;            // steps of a chunk
constexpr int THREADS = 256;     // 16 x 16
constexpr int TM = C / 16;       // rows of att / out per thread
constexpr int QS = C + 4;        // stride of the transposed tiles and att

__device__ __forceinline__ void ld(float (&d)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}
__device__ __forceinline__ void ld(float (&d)[2], const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  d[0] = x.x; d[1] = x.y;
}
__device__ __forceinline__ void st(float* p, const float (&d)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void st(float* p, const float (&d)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
}

template <int K>
constexpr int smem_floats() {
  return 4 * C * (K + 1) + 2 * C * (K + 4) + 2 * K * QS + K * (K + 4) +
         C * QS + C + 2 * K;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, float* __restrict__ out,
                float* __restrict__ state_out, int h, long long s) {
  constexpr int NS = K + 1;      // natural tiles, scalar access
  constexpr int VS = K + 4;      // row-major tiles, vector access
  constexpr int TN = K / 16;     // out / S columns per thread
  constexpr int RS = K / 16;     // S rows per thread
  constexpr int K4 = K / 4;      // float4s per row

  extern __shared__ __align__(16) float smem[];
  float* sR = smem;              // C x NS: r
  float* sK = sR + C * NS;       // C x NS: k
  float* sEx = sK + C * NS;      // C x NS: log_w, then cum - log_w
  float* sCum = sEx + C * NS;    // C x NS: cum
  float* sV = sCum + C * NS;     // C x VS: v
  float* sKc = sV + C * VS;      // C x VS: k * exp(total - cum)
  float* sQT = sKc + C * VS;     // K x QS: q_in, transposed
  float* sKdT = sQT + K * QS;    // K x QS: k * exp(-cum), transposed
  float* sS = sKdT + K * QS;     // K x VS: the state
  float* sAT = sS + K * VS;      // C x QS: masked att, transposed
  float* sBonus = sAT + C * QS;  // C
  float* sTotal = sBonus + C;    // K
  float* sU = sTotal + K;        // K

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.x;
  const long long bh = (long long)blockIdx.y * h + head;
  const long long base = bh * s * K;
  const long long n_chunks = s / C;

  for (int i = tid; i < K * VS; i += THREADS) sS[i] = 0.f;
  for (int i = tid; i < K; i += THREADS) sU[i] = u[(long long)head * K + i];

  for (long long c = 0; c < n_chunks; ++c) {
    const long long off = base + c * C * K;
    __syncthreads();   // the previous chunk is done with the tiles

    // the chunk's tiles, 16 bytes a thread, coalesced
    for (int i = tid; i < C * K4; i += THREADS) {
      const int t = i / K4, j = (i % K4) * 4;
      const long long g = off + (long long)t * K + j;
      const float4 rr = *reinterpret_cast<const float4*>(r + g);
      const float4 kk = *reinterpret_cast<const float4*>(k + g);
      const float4 ll = *reinterpret_cast<const float4*>(lw + g);
      *reinterpret_cast<float4*>(sV + t * VS + j) =
          *reinterpret_cast<const float4*>(v + g);
      float* pr = sR + t * NS + j;
      float* pk = sK + t * NS + j;
      float* pl = sEx + t * NS + j;
      pr[0] = rr.x; pr[1] = rr.y; pr[2] = rr.z; pr[3] = rr.w;
      pk[0] = kk.x; pk[1] = kk.y; pk[2] = kk.z; pk[3] = kk.w;
      pl[0] = ll.x; pl[1] = ll.y; pl[2] = ll.z; pl[3] = ll.w;
    }
    __syncthreads();

    // the inclusive cumsum, one thread per column, in order; the bonus
    // sum(r * u * k), one thread per row
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float l = sEx[t * NS + tid];
        acc = acc + l;
        sCum[t * NS + tid] = acc;
        sEx[t * NS + tid] = acc - l;
      }
      sTotal[tid] = acc;
    } else if (tid >= 64 && tid < 64 + C) {
      const int t = tid - 64;
      float acc = 0.f;
      for (int j = 0; j < K; ++j)
        acc = acc + sR[t * NS + j] * sU[j] * sK[t * NS + j];
      sBonus[t] = acc;
    }
    __syncthreads();

    // the decay-weighted tiles
    for (int i = tid; i < C * K; i += THREADS) {
      const int t = i % C, j = i / C;          // a warp spans 32 steps
      sQT[j * QS + t] = sR[t * NS + j] * expf(sEx[t * NS + j]);
      sKdT[j * QS + t] = sK[t * NS + j] * expf(-sCum[t * NS + j]);
    }
    for (int i = tid; i < C * K; i += THREADS) {
      const int j = i % K, t = i / K;          // a warp spans the columns
      sKc[t * VS + j] = sK[t * NS + j] * expf(sTotal[j] - sCum[t * NS + j]);
    }
    __syncthreads();

    // att = q_in @ kd^T and out_inter = q_in @ S, over K
    float att[TM][4], oi[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) att[a][b] = 0.f;
#pragma unroll
      for (int b = 0; b < TN; ++b) oi[a][b] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      float q[TM], kd[4], sv[TN];
      ld(q, sQT + j * QS + ty * TM);
      ld(kd, sKdT + j * QS + tx * 4);
      ld(sv, sS + j * VS + tx * TN);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) att[a][b] = fmaf(q[a], kd[b], att[a][b]);
#pragma unroll
        for (int b = 0; b < TN; ++b) oi[a][b] = fmaf(q[a], sv[b], oi[a][b]);
      }
    }
    // the strict lower triangle, stored transposed: sAT[s][t] = att[t][s]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int sp = tx * 4 + b;
      float col[4];
#pragma unroll
      for (int a = 0; a < TM; ++a)
        col[a] = sp < ty * TM + a ? att[a][b] : 0.f;
      st(sAT + sp * QS + ty * TM, col);
    }
    __syncthreads();

    // out_intra = att @ v and the new state's k_carry^T @ v, over the
    // chunk's steps
    float oa[TM][TN], sn[RS][TN];
#pragma unroll
    for (int b = 0; b < TN; ++b) {
#pragma unroll
      for (int a = 0; a < TM; ++a) oa[a][b] = 0.f;
#pragma unroll
      for (int a = 0; a < RS; ++a) sn[a][b] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      float at[TM], vv[TN], kc[RS];
      ld(at, sAT + j * QS + ty * TM);
      ld(vv, sV + j * VS + tx * TN);
      ld(kc, sKc + j * VS + ty * RS);
#pragma unroll
      for (int b = 0; b < TN; ++b) {
#pragma unroll
        for (int a = 0; a < TM; ++a) oa[a][b] = fmaf(at[a], vv[b], oa[a][b]);
#pragma unroll
        for (int a = 0; a < RS; ++a) sn[a][b] = fmaf(kc[a], vv[b], sn[a][b]);
      }
    }

    // out = (out_inter + out_intra) + bonus * v
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int t = ty * TM + a;
      float vt[TN], o[TN];
      ld(vt, sV + t * VS + tx * TN);
      const float bo = sBonus[t];
#pragma unroll
      for (int b = 0; b < TN; ++b) o[b] = (oi[a][b] + oa[a][b]) + bo * vt[b];
      st(out + off + (long long)t * K + tx * TN, o);
    }
    // S = exp(total) * S + k_carry^T @ v (each thread its own elements)
#pragma unroll
    for (int a = 0; a < RS; ++a) {
      const int kr = ty * RS + a;
      const float e = expf(sTotal[kr]);
      float cur[TN];
      ld(cur, sS + kr * VS + tx * TN);
#pragma unroll
      for (int b = 0; b < TN; ++b) cur[b] = e * cur[b] + sn[a][b];
      st(sS + kr * VS + tx * TN, cur);
      if (c == n_chunks - 1)
        st(state_out + bh * K * K + (long long)kr * K + tx * TN, cur);
    }
  }
}

template <int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* out, void* state,
                   long long b, int h, long long s, cudaStream_t stream) {
  constexpr int smem = smem_floats<K>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)h, (unsigned)b);
  wkv6_fwd_kernel<K><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(state), h, s);
  return cudaGetLastError();
}

}  // namespace

// All tensors fp32, contiguous, 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, void* out,
                        void* state, long long b, int h, long long s,
                        int dk, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || s % C != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 32:
      return (int)launch<32>(r, k, v, lw, u, out, state, b, h, s, st);
    case 64:
      return (int)launch<64>(r, k, v, lw, u, out, state, b, h, s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
