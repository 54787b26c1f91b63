// K6: forward GQA flash attention for Hopper (sm_90a), fp32 math on CUDA
// cores. Replaces the JAX package's Pallas kernel
// src/repro/kernels/flash_attn/kernel.py:143 flash_attention_bhsd.
//
// Computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D), fp32 or bf16,
// contiguous, out (B, Hq, S, D) in q's dtype:
//   logits = (q * scale) . k           (scale = 1/sqrt(D), applied to q)
//   logits = cap * tanh(logits * (1/cap))           (when cap > 0)
//   masked -> -2**30: k >= s_valid; causal k > q; window k <= q - window
//   online softmax over 64-key tiles: fp32 running max m, rescale
//   alpha = exp(m_old - m_new), denominator l; masked probabilities are
//   zeroed after the exp; out = acc / max(l, 1e-30).
//
// What bounds it: at prefill lengths the work is 4*D flops per unmasked
// (query head, query, key) triple against reading q, k, v and writing
// out once, hundreds of flops per byte, so it is bound by operations:
// fp32 FMAs at the H100's 67 TFLOP/s (CUDA cores). fp32 parity with the
// JAX package rules out TF32 and tensor-core products on fp32 data, so
// the design aims at keeping the FMA pipes fed from shared memory:
//   * a block serves 64 rows, the (q-head, query) pairs of ALL q-heads
//     of one KV head over 64 / group queries (the TPU kernel folds the
//     heads into its tile for the same reason): each K/V tile is read
//     from device memory once for the whole group;
//   * 256 threads as 16 x 16; a thread owns 4 rows x 4 key columns of
//     the score tile and 4 rows x D/16 output columns, so the inner
//     loops do 16 (scores) or 4*D/16 (output) FMAs per 5 or 1 + D/16
//     shared-memory loads; q and p are stored transposed (one 16-byte
//     load gives a thread its 4 rows), k transposed with a padded
//     stride, v row-major, all without bank conflicts on the reads;
//   * the Pallas kernel's pair table of surviving (q-block, k-block)
//     tiles becomes a k range per block, [k_lo, k_hi) from the causal,
//     window and tail masks; skip = 0 walks every k-tile and masks
//     inside, bit-identical because a fully masked tile is a no-op
//     (alpha = 1, p = 0);
//   * blocks are issued longest causal range first;
//   * IEEE expf / tanhf and true division, no fast-math intrinsics.
// Shared memory: (D*68 + D*65 + 64*D + 64*68) floats, 219,136 bytes at
// D = 256, so every D takes dynamic shared memory after
// cudaFuncSetAttribute; a refused launch is returned by
// cudaGetLastError() and raised by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;         // (q-head, query) rows of a block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int TM = 4;            // rows per thread
constexpr int TN = BK / 16;      // score columns per thread
constexpr int QSTR = ROWS + 4;   // stride of the transposed q and p tiles
constexpr int KSTR = BK + 1;     // stride of the transposed k tile
constexpr float NEG_INF = -1073741824.0f;   // -2**30, as the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool attends(long long kp, long long qp,
                                        long long s_valid, int causal,
                                        int window) {
  return kp < s_valid && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
          long long s, long long s_valid, int causal, int window,
          float scale, float cap, float inv_cap, int skip, int gh, int bq,
          int n_chunks) {
  constexpr int TD = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;               // D x QSTR: q * scale, transposed
  float* kT = qT + D * QSTR;      // D x KSTR: k tile, transposed
  float* vs = kT + D * KSTR;      // BK x D:   v tile
  float* pT = vs + BK * D;        // BK x QSTR: probabilities, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int group = hq / hkv;
  const long long qt = (long long)gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * gh;
  const long long b = blockIdx.z;
  const long long q0 = qt * bq;
  const int rows = gh * bq;
  const long long kv_base = (b * hkv + kvh) * s;

  // row r: q-head kvh * group + g0 + r / bq, query q0 + r % bq
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int gi = g0 + r / bq;
    const long long qp = q0 + r % bq;
    float x = 0.f;
    if (r < rows && gi < group && qp < s) {
      const long long h = (long long)kvh * group + gi;
      x = to_f(q[((b * hq + h) * s + qp) * D + d]) * scale;
    }
    qT[d * QSTR + r] = x;
  }

  long long qpos[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) qpos[i] = q0 + (ty * TM + i) % bq;

  long long k_begin = 0, k_end = s;
  if (skip) {
    const long long q_last = (q0 + bq < s ? q0 + bq : s) - 1;
    k_end = s_valid;
    if (causal && q_last + 1 < k_end) k_end = q_last + 1;
    if (window > 0 && q0 - window + 1 > 0)
      k_begin = (q0 - window + 1) / BK * BK;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  for (long long k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < s) {
        const long long off = (kv_base + k0 + c) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      kT[d * KSTR + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * QSTR + ty * TM]);
      const float qa[TM] = {qv.x, qv.y, qv.z, qv.w};
      float kx[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) kx[j] = kT[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(qa[i], kx[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = sc[i][j];
        if (cap > 0.f) x = cap * tanhf(x * inv_cap);
        if (!attends(k0 + tx + 16 * j, qpos[i], s_valid, causal, window))
          x = NEG_INF;
        sc[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p =
            attends(k0 + tx + 16 * j, qpos[i], s_valid, causal, window)
                ? expf(sc[i][j] - mn)
                : 0.f;
        pT[(tx + 16 * j) * QSTR + ty * TM + i] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&pT[c * QSTR + ty * TM]);
      const float pa[TM] = {pv.x, pv.y, pv.z, pv.w};
      float vx[TD];
#pragma unroll
      for (int j = 0; j < TD; ++j) vx[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pa[i], vx[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int gi = g0 + r / bq;
    if (r >= rows || gi >= group || qpos[i] >= s) continue;
    const long long h = (long long)kvh * group + gi;
    T* o = out + ((b * hq + h) * s + qpos[i]) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) store(o + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   long long b, int hq, int hkv, long long s,
                   long long s_valid, int causal, int window, float scale,
                   float cap, float inv_cap, int skip, cudaStream_t stream) {
  const int group = hq / hkv;
  const int gh = group > ROWS ? ROWS : group;
  const int bq = ROWS / gh;
  const int n_chunks = (group + gh - 1) / gh;
  const long long n_qt = (s + bq - 1) / bq;
  const size_t smem =
      (size_t)(D * QSTR + D * KSTR + BK * D + BK * QSTR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_qt, (unsigned)(hkv * n_chunks), (unsigned)b);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, s, s_valid,
      causal, window, scale, cap, inv_cap, skip, gh, bq, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* out, long long b, int hq, int hkv, long long s,
                     long long s_valid, int causal, int window, float scale,
                     float cap, float inv_cap, int skip,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, hq, hkv, s, s_valid, causal,
                           window, scale, cap, inv_cap, skip, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, hq, hkv, s, s_valid, causal,
                           window, scale, cap, inv_cap, skip, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, hq, hkv, s, s_valid, causal,
                            window, scale, cap, inv_cap, skip, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, hq, hkv, s, s_valid, causal,
                            window, scale, cap, inv_cap, skip, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, int dtype, long long b, int hq,
                              int hkv, long long s, int d, long long s_valid,
                              int causal, int window, float scale, float cap,
                              float inv_cap, int skip, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, out, b, hq, hkv, s, s_valid,
                                causal, window, scale, cap, inv_cap, skip,
                                st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, s,
                                        s_valid, causal, window, scale, cap,
                                        inv_cap, skip, st);
  return (int)cudaErrorInvalidValue;
}
