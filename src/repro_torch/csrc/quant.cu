// Hand-written Hopper (sm_90a) kernels for the rq8/rq4/rq2 codec of the
// checkpoint wire, the training step's gradient compression and the ring
// AllReduce: per-bucket min/max (K1), quantize + bit-pack (K2), unpack +
// dequantize (K3), the fused stochastic quantize -> dequantize (K4) and the
// fused ring hop decode + add + re-encode (K5). Plain C interface, loaded with ctypes by
// repro_torch/kernels/quant/kernel.py, which allocates every buffer,
// checks shapes and passes PyTorch's current stream.
//
// Build (done at first use by kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -o build/repro_torch/libquant.so quant.cu
// No --use_fast_math: the divisions in K2/K4/K5 and the multiply-adds in
// K3/K4/K5 must round exactly as the JAX reference does (see each kernel).
//
// Layout (the JAX package's wire format): a bucket of pack * R * 512 fp32
// elements is pack contiguous segments of R x 512; payload byte (r, c) of
// the bucket holds the b-bit code of segment k at bits [k*b, (k+1)*b).
// params is (B, 2) fp32: [lo, scale] per bucket for K2-K5, K1 writes
// [lo, hi].
//
// All five are bound by device memory, not arithmetic: each element is
// read once and written once, with coalesced accesses (neighbouring
// threads touch neighbouring addresses in every segment). A bucket is
// spread over many blocks (grid.y = bucket, grid.x strides over it), so
// the 110-odd buckets of a full-width checkpoint fill all 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// min/max that propagate NaN, as jnp.minimum / torch.amin do.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Reduce (lo, hi) over the block; thread 0 holds the result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32];
  __shared__ float s_hi[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kThreads / 32 ? s_lo[lane] : INFINITY;
    hi = lane < kThreads / 32 ? s_hi[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      lo = nan_min(lo, __shfl_down_sync(0xffffffffu, lo, off));
      hi = nan_max(hi, __shfl_down_sync(0xffffffffu, hi, off));
    }
  }
}

// ---------------------------------------------------------------------------
// K1 minmax_bucketed. Replaces repro/kernels/quant/kernel.py
// minmax_bucketed (and the range statistics of encode_packed[_bucketed]).
// The TPU kernel carried the running range across a sequential grid in
// its output block; blocks here run in no order, so each block reduces
// a contiguous slice of one bucket to a partial (lo, hi), and the last
// block of a bucket to finish folds the bucket's partials in the same
// launch: each block publishes its partial, __threadfence, then takes a
// ticket (atomicAdd on the bucket's counter); the block that draws the
// last ticket reads every partial and resets the counter to 0, so the
// next call starts clean without a memset. min and max are exact, so
// the order of reduction cannot change the result.
// Bound: bytes — reads B * cap * 4 bytes once. Each thread keeps four
// 16-byte loads in flight (a bucket is R x 512 floats, so its rows are
// 16-byte aligned when the base is; the wrapper refuses a base that is
// not); each block reads a contiguous slice, and the grid is sized to
// four waves of 8 blocks an SM over all buckets (k1_blocks).
// ---------------------------------------------------------------------------
constexpr int kMinmaxUnroll = 4;      // 16-byte loads in flight a thread
constexpr int kBlocksPerSM = 8;       // 8 x 256 threads fill an SM
constexpr int kSMs = 132;

__device__ __forceinline__ void fold4(float& lo, float& hi, float4 v) {
  lo = nan_min(nan_min(lo, v.x), nan_min(v.y, nan_min(v.z, v.w)));
  hi = nan_max(nan_max(hi, v.x), nan_max(v.y, nan_max(v.z, v.w)));
}

__global__ void __launch_bounds__(kThreads)
minmax_kernel(const float4* __restrict__ x, float2* __restrict__ partial,
              unsigned* __restrict__ ticket, float* __restrict__ out,
              long long n4) {
  const long long b = blockIdx.y;
  const unsigned nblk = gridDim.x;
  const float4* xb = x + b * n4;
  // a contiguous slice of the bucket, its start on a 512-byte boundary
  const long long begin = ((long long)blockIdx.x * n4 / nblk) & ~31LL;
  const long long end =
      blockIdx.x + 1 == nblk ? n4
                             : (((long long)blockIdx.x + 1) * n4 / nblk) & ~31LL;
  const long long step = (long long)kThreads * kMinmaxUnroll;
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = begin + threadIdx.x; i < end; i += step) {
    float4 v[kMinmaxUnroll];
#pragma unroll
    for (int u = 0; u < kMinmaxUnroll; ++u) {
      // past the slice, x[i] again: a repeated element moves no extreme
      const long long j = i + (long long)u * kThreads;
      v[u] = __ldg(xb + (j < end ? j : i));
    }
#pragma unroll
    for (int u = 0; u < kMinmaxUnroll; ++u) fold4(lo, hi, v[u]);
  }
  block_minmax(lo, hi);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[b * nblk + blockIdx.x] = make_float2(lo, hi);
    __threadfence();
    last = atomicAdd(ticket + b, 1u) == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  lo = INFINITY;
  hi = -INFINITY;
  for (unsigned i = threadIdx.x; i < nblk; i += kThreads) {
    const float2 p = __ldcg(partial + b * nblk + i);
    lo = nan_min(lo, p.x);
    hi = nan_max(hi, p.y);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    out[2 * b] = lo;
    out[2 * b + 1] = hi;
    ticket[b] = 0;
  }
}

// K1's blocks along one bucket of n4 float4s: four waves of
// kBlocksPerSM blocks on every SM across all buckets (fewer when the
// buckets are small), at least one block per bucket.
unsigned k1_blocks(long long n4, long long n_buckets) {
  const long long slots = 4LL * kSMs * kBlocksPerSM;
  long long want = slots / (n_buckets > 0 ? n_buckets : 1);
  const long long most = (n4 + kThreads * kMinmaxUnroll - 1) /
                         (kThreads * kMinmaxUnroll);
  if (want > most) want = most;
  return (unsigned)(want < 1 ? 1 : want);
}

// ---------------------------------------------------------------------------
// K2 encode_packed. Replaces repro/kernels/quant/kernel.py
// encode_packed_bucketed (full buckets) and encode_packed (the tail, run
// here as B = 1). One thread per output byte: it reads the pack segment
// values and uniforms of its byte position, rounds each stochastically
// and ORs code << k*bits. The division is __fdiv_rn, the correctly
// rounded fp32 quotient XLA computes for (x - lo) / scale.
// Bound: bytes — reads 8 B per element (x and u), writes 1/pack B.
// ---------------------------------------------------------------------------
template <int BITS>
__global__ void encode_packed_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ params,
                                     uint8_t* __restrict__ out,
                                     long long row_elems) {
  constexpr int kPack = 8 / BITS;
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const long long b = blockIdx.y;
  const float lo = params[2 * b];
  const float scale = params[2 * b + 1];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < row_elems; i += (long long)gridDim.x * kThreads) {
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const long long j = (b * kPack + k) * row_elems + i;
      const float norm = __fdiv_rn(x[j] - lo, scale);
      const float fl = floorf(norm);
      const float frac = norm - fl;
      float q = fl + (u[j] < frac ? 1.0f : 0.0f);
      q = fminf(fmaxf(q, 0.0f), kLevels);
      acc |= ((unsigned)q) << (k * BITS);
    }
    out[b * row_elems + i] = (uint8_t)acc;
  }
}

// ---------------------------------------------------------------------------
// K3 decode_packed. Replaces repro/kernels/quant/kernel.py
// decode_packed_bucketed (full buckets) and decode_packed (the tail, as
// B = 1). One thread per payload byte writes its pack dequantized values,
// code * scale + lo as ONE fused multiply-add (__fmaf_rn): XLA contracts
// the reference's multiply and add into an FMA, so a separate multiply
// and add would differ in the last bit.
// Bound: bytes — reads 1/pack B, writes 4 B per element.
// ---------------------------------------------------------------------------
template <int BITS>
__global__ void decode_packed_kernel(const uint8_t* __restrict__ payload,
                                     const float* __restrict__ params,
                                     float* __restrict__ out,
                                     long long row_elems) {
  constexpr int kPack = 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const long long b = blockIdx.y;
  const float lo = params[2 * b];
  const float scale = params[2 * b + 1];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < row_elems; i += (long long)gridDim.x * kThreads) {
    const unsigned p = payload[b * row_elems + i];
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const float code = (float)((p >> (k * BITS)) & kMask);
      out[(b * kPack + k) * row_elems + i] = __fmaf_rn(code, scale, lo);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 qdq_bucketed. Replaces repro/kernels/quant/kernel.py qdq_bucketed
// (:187, the full buckets of the training step's qdq_flat) and qdq (:77,
// the tail, run here as B = 1). Elementwise: the segment layout only
// orders the uniforms, and that order is flat element order, so a bucket
// is seen as one run of `elems` values and grid.y picks its params row.
// Per element, as the reference rounds:
//   norm = (x - lo) / scale          __fdiv_rn, the true fp32 quotient
//   q    = floor(norm) + (u < frac)  then clip to [0, levels], NaN kept
//                                    (XLA's min/max propagate NaN;
//                                    fminf/fmaxf would drop it)
//   out  = q * scale + lo            ONE rounding (__fmaf_rn): XLA
//                                    contracts the reference's multiply
//                                    and add, as in K3
// x and out may be the same buffer (the caller donates its input): each
// element is read and then written by the same thread, so neither pointer
// is __restrict__.
// Bound: bytes — reads 8 B per element (x and u), writes 4 B.
// ---------------------------------------------------------------------------
template <int BITS>
__global__ void qdq_kernel(const float* x, const float* __restrict__ u,
                           const float* __restrict__ params, float* out,
                           long long elems) {
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const long long b = blockIdx.y;
  const float lo = params[2 * b];
  const float scale = params[2 * b + 1];
  const long long base = b * elems;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < elems; i += (long long)gridDim.x * kThreads) {
    const float norm = __fdiv_rn(x[base + i] - lo, scale);
    const float fl = floorf(norm);
    float q = fl + (u[base + i] < norm - fl ? 1.0f : 0.0f);
    q = nan_min(nan_max(q, 0.0f), kLevels);
    out[base + i] = __fmaf_rn(q, scale, lo);
  }
}

// ---------------------------------------------------------------------------
// K5 decode_add_encode_bucketed. Replaces repro/kernels/quant/kernel.py
// decode_add_encode_bucketed (:349, pallas_call at :366): the partitioned
// ring AllReduce's reduce-scatter hop, for the full buckets of a partition
// and for its tail (as B = 1). Per bucket it computes
//   s     = code_k * scale_in + lo_in + x   ONE rounding for the multiply-add
//                                          (__fmaf_rn, as K3), then the add
//   lo,hi = exact, NaN-propagating min / max of s over the bucket
//   scale = (hi - lo) * f32(1/levels), or 1 where hi > lo fails
//   code  = the stochastic rounding of (s - lo) / scale against u, as K2,
//           with K4's NaN-keeping clip (a NaN code packs as 0, as XLA's and
//           PyTorch's float -> uint8 casts give)
// and packs segment k at bits [k*b, (k+1)*b) of the outgoing payload.
//
// The TPU kernel carried each bucket's [lo, hi] in VMEM scratch across a
// sequential grid: a stats phase, then an encode phase that recomputes the
// sum. Blocks here run in no order, so the carry becomes three launches on
// one stream: (1) grid-stride blocks per bucket decode + add and write
// per-block (min, max) partials; (2) one small block per bucket folds its
// partials and writes params_out = [lo, scale]; (3) the encode launch
// recomputes decode + add from payload and x and quantizes and packs with
// params_out. The fp32 sum never reaches device memory; min and max are
// exact, so the order of blocks cannot change the result.
// Bound: bytes — payload in (1/pack B), x and u (8 B) and payload out
// (1/pack B) per element: 9 B at rq4, 10 B at rq8. This two-pass design
// reads payload and x twice (13.5 B per element at rq4).
// ---------------------------------------------------------------------------
template <int BITS>
__device__ __forceinline__ float dae_sum(unsigned p, int k, float scale,
                                         float lo, float x) {
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const float code = (float)((p >> (k * BITS)) & kMask);
  return __fadd_rn(__fmaf_rn(code, scale, lo), x);
}

template <int BITS>
__global__ void dae_stats_kernel(const uint8_t* __restrict__ payload,
                                 const float* __restrict__ params,
                                 const float* __restrict__ x,
                                 float2* __restrict__ partial,
                                 long long row_elems) {
  constexpr int kPack = 8 / BITS;
  const long long b = blockIdx.y;
  const float lo_in = params[2 * b];
  const float scale_in = params[2 * b + 1];
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < row_elems; i += (long long)gridDim.x * kThreads) {
    const unsigned p = payload[b * row_elems + i];
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const float s = dae_sum<BITS>(p, k, scale_in, lo_in,
                                    x[(b * kPack + k) * row_elems + i]);
      lo = nan_min(lo, s);
      hi = nan_max(hi, s);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) partial[b * gridDim.x + blockIdx.x] = make_float2(lo, hi);
}

template <int BITS>
__global__ void dae_finalize_kernel(const float2* __restrict__ partial,
                                    float* __restrict__ params_out, int nblk) {
  // the jitted reference's scale: a multiply by the fp32 reciprocal
  constexpr float kInv = (float)(1.0 / (double)((1 << BITS) - 1));
  const long long b = blockIdx.x;
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    const float2 p = partial[b * nblk + i];
    lo = nan_min(lo, p.x);
    hi = nan_max(hi, p.y);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    params_out[2 * b] = lo;
    params_out[2 * b + 1] = hi > lo ? __fmul_rn(__fsub_rn(hi, lo), kInv) : 1.0f;
  }
}

template <int BITS>
__global__ void dae_encode_kernel(const uint8_t* __restrict__ payload,
                                  const float* __restrict__ params,
                                  const float* __restrict__ x,
                                  const float* __restrict__ u,
                                  const float* __restrict__ params_out,
                                  uint8_t* __restrict__ out,
                                  long long row_elems) {
  constexpr int kPack = 8 / BITS;
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const long long b = blockIdx.y;
  const float lo_in = params[2 * b];
  const float scale_in = params[2 * b + 1];
  const float lo = params_out[2 * b];
  const float scale = params_out[2 * b + 1];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < row_elems; i += (long long)gridDim.x * kThreads) {
    const unsigned p = payload[b * row_elems + i];
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const long long j = (b * kPack + k) * row_elems + i;
      const float s = dae_sum<BITS>(p, k, scale_in, lo_in, x[j]);
      const float norm = __fdiv_rn(__fsub_rn(s, lo), scale);
      const float fl = floorf(norm);
      float q = __fadd_rn(fl, u[j] < __fsub_rn(norm, fl) ? 1.0f : 0.0f);
      q = nan_min(nan_max(q, 0.0f), kLevels);
      const unsigned code = q != q ? 0u : (unsigned)q;
      acc |= code << (k * BITS);
    }
    out[b * row_elems + i] = (uint8_t)acc;
  }
}

template <int BITS>
cudaError_t dae_launch(const uint8_t* payload, const float* params,
                       const float* x, const float* u, float2* partial,
                       uint8_t* out, float* params_out, long long n_buckets,
                       long long row_elems, int nblk, cudaStream_t s) {
  const dim3 grid((unsigned)nblk, (unsigned)n_buckets);
  dae_stats_kernel<BITS><<<grid, kThreads, 0, s>>>(payload, params, x,
                                                   partial, row_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dae_finalize_kernel<BITS><<<(unsigned)n_buckets, kThreads, 0, s>>>(
      partial, params_out, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dae_encode_kernel<BITS><<<grid, kThreads, 0, s>>>(
      payload, params, x, u, params_out, out, row_elems);
  return cudaGetLastError();
}

// Blocks along one bucket: enough to cover it once, but no more than
// keeps ~64 resident blocks per SM across all buckets.
unsigned blocks_per_bucket(long long elems, long long n_buckets) {
  long long want = (elems + kThreads - 1) / kThreads;
  long long cap = (132LL * 64) / (n_buckets > 0 ? n_buckets : 1);
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  return (unsigned)(want < 1 ? 1 : want);
}

}  // namespace

extern "C" {

// x: (B, cap) fp32, 16-byte aligned, cap a multiple of 4; partial:
// (B, nblk) float2 scratch, nblk = quant_k1_blocks(B, cap); ticket: B
// zeroed uint32 counters (left zeroed); out: (B, 2) fp32. One launch.
int quant_minmax_bucketed(const void* x, void* partial, void* ticket,
                          void* out, long long n_buckets, long long cap,
                          int nblk, void* stream) {
  if (n_buckets < 1 || n_buckets > 65535 || cap < 4 || cap % 4 != 0 ||
      nblk < 1 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  minmax_kernel<<<dim3(nblk, (unsigned)n_buckets), kThreads, 0, s>>>(
      (const float4*)x, (float2*)partial, (unsigned*)ticket, (float*)out,
      cap / 4);
  return (int)cudaGetLastError();
}

// Blocks per bucket K1 launches for a bucket of cap elements (the
// wrapper sizes the partial scratch with it).
int quant_k1_blocks(long long n_buckets, long long cap) {
  return (int)k1_blocks(cap / 4, n_buckets);
}

// Blocks per bucket of K5's min/max partials for a bucket of cap
// elements (the wrapper sizes K5's partial scratch with it).
int quant_minmax_blocks(long long n_buckets, long long cap) {
  return (int)blocks_per_bucket(cap, n_buckets);
}

// x, u: (B, pack, R, 512) fp32; params: (B, 2); out: (B, R, 512) uint8.
int quant_encode_packed(const void* x, const void* u, const void* params,
                        void* out, long long n_buckets, long long rows,
                        int bits, void* stream) {
  if (n_buckets < 1 || n_buckets > 65535 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_elems = rows * 512;
  const dim3 grid(blocks_per_bucket(row_elems, n_buckets), (unsigned)n_buckets);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* uf = (const float*)u;
  const float* pf = (const float*)params;
  uint8_t* o = (uint8_t*)out;
  switch (bits) {
    case 8: encode_packed_kernel<8><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, row_elems); break;
    case 4: encode_packed_kernel<4><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, row_elems); break;
    case 2: encode_packed_kernel<2><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, row_elems); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// payload: (B, R, 512) uint8; params: (B, 2); out: (B, pack, R, 512) fp32.
int quant_decode_packed(const void* payload, const void* params, void* out,
                        long long n_buckets, long long rows, int bits,
                        void* stream) {
  if (n_buckets < 1 || n_buckets > 65535 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_elems = rows * 512;
  const dim3 grid(blocks_per_bucket(row_elems, n_buckets), (unsigned)n_buckets);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* p = (const uint8_t*)payload;
  const float* pf = (const float*)params;
  float* o = (float*)out;
  switch (bits) {
    case 8: decode_packed_kernel<8><<<grid, kThreads, 0, s>>>(p, pf, o, row_elems); break;
    case 4: decode_packed_kernel<4><<<grid, kThreads, 0, s>>>(p, pf, o, row_elems); break;
    case 2: decode_packed_kernel<2><<<grid, kThreads, 0, s>>>(p, pf, o, row_elems); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, u, out: (B, elems) fp32 (elems = pack * R * 512); params: (B, 2).
// out may equal x.
int quant_qdq_bucketed(const void* x, const void* u, const void* params,
                       void* out, long long n_buckets, long long elems,
                       int bits, void* stream) {
  if (n_buckets < 1 || n_buckets > 65535 || elems < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_bucket(elems, n_buckets), (unsigned)n_buckets);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* uf = (const float*)u;
  const float* pf = (const float*)params;
  float* o = (float*)out;
  switch (bits) {
    case 8: qdq_kernel<8><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, elems); break;
    case 4: qdq_kernel<4><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, elems); break;
    case 2: qdq_kernel<2><<<grid, kThreads, 0, s>>>(xf, uf, pf, o, elems); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// payload, out: (B, R, 512) uint8; params, params_out: (B, 2) fp32;
// x, u: (B, pack, R, 512) fp32; partial: (B, nblk) float2 scratch with
// nblk = quant_minmax_blocks(B, R * 512). out must not alias payload (the
// encode launch reads payload again).
int quant_decode_add_encode(const void* payload, const void* params,
                            const void* x, const void* u, void* partial,
                            void* out, void* params_out, long long n_buckets,
                            long long rows, int nblk, int bits, void* stream) {
  if (n_buckets < 1 || n_buckets > 65535 || rows < 1 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_elems = rows * 512;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* p = (const uint8_t*)payload;
  const float* pf = (const float*)params;
  const float* xf = (const float*)x;
  const float* uf = (const float*)u;
  float2* part = (float2*)partial;
  uint8_t* o = (uint8_t*)out;
  float* po = (float*)params_out;
  cudaError_t err;
  switch (bits) {
    case 8: err = dae_launch<8>(p, pf, xf, uf, part, o, po, n_buckets, row_elems, nblk, s); break;
    case 4: err = dae_launch<4>(p, pf, xf, uf, part, o, po, n_buckets, row_elems, nblk, s); break;
    case 2: err = dae_launch<2>(p, pf, xf, uf, part, o, po, n_buckets, row_elems, nblk, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
