// Hand-written Hopper (sm_90a) kernels for the rq8/rq4/rq2 codec of the
// checkpoint wire, the training step's gradient compression and the ring
// AllReduce: per-bucket min/max (K1), quantize + bit-pack (K2), unpack +
// dequantize (K3), the fused stochastic quantize -> dequantize (K4) and the
// fused ring hop decode + add + re-encode of every worker (K5). K2, K4 and
// K5 draw their own uniforms (threefry.cuh). Plain C interface, loaded with
// ctypes by repro_torch/kernels/quant/kernel.py, which allocates every
// buffer, checks shapes and passes PyTorch's current stream.
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
// K1 and K3 are bound by device memory, not arithmetic: each element is
// read once and written once, with coalesced accesses (neighbouring threads
// touch neighbouring addresses in every segment). A bucket is spread over
// many blocks (grid.y = bucket, grid.x strides over it), so the 110-odd
// buckets of a full-width checkpoint fill all 132 SMs. K2, K4 and K5 hash
// a Threefry counter for every element they round and are bound by the
// card's integer rate (see K5).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

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
// The keys K2 and K4 draw under, in the launch's argument block. Row b of a
// launch (grid.y = b: a bucket, or a leaf message) draws its uniforms under
//   fold: fold_in(root, first + b), one Threefry hash of the counter
//         (0, first + b) under the root key, taken once per block: the
//         bucketed tier, whose bucket b draws under fold_in(key, b) (the
//         tail bucket is a launch of one row with first = nb - 1);
//   else: key[b] itself: the per-leaf tier, one key a worker's leaf.
// Element i of the row's pack * R * 512 run (in flat (pack, R, 512) order,
// which is also the per-leaf (R * pack, 512) order) takes
// threefry::uniform(key_b, i): the bit prng.uniform(key_b, (pack, R, 512))
// would have drawn, so no uniform ever reaches device memory.
// ---------------------------------------------------------------------------
constexpr int kMaxRowKeys = 256;      // own keys in one launch (the wrapper
                                      // cuts a larger launch)

struct RowKeys {
  uint32_t root[2];
  uint32_t first;
  int fold;
  uint32_t key[kMaxRowKeys][2];
};

__device__ __forceinline__ threefry::Key row_key(const RowKeys& k,
                                                 unsigned b) {
  if (k.fold) {
    const uint2 y = threefry::hash(threefry::make_key(k.root[0], k.root[1]),
                                   0u, k.first + b);
    return threefry::make_key(y.x, y.y);
  }
  return threefry::make_key(k.key[b][0], k.key[b][1]);
}

// ---------------------------------------------------------------------------
// K2 encode_packed. Replaces repro/kernels/quant/kernel.py
// encode_packed_bucketed (:203; full buckets, the flat tier's tail as B = 1)
// and encode_packed (:96, the per-leaf message: B leaves of B stacked
// workers, one params row each; a leaf of 25,165,824 elements is one
// bucket), each together with the jax.random.uniform draw beside it
// (repro/kernels/quant/ops.py:121, :310, :315). Each thread takes 4
// neighbouring byte positions of a row: one 16-byte load of x a segment,
// the 4 x pack uniforms drawn from the row's key (in registers), and one
// 4-byte store of the packed bytes. Per element it rounds stochastically
// and ORs code << k*bits; the division is __fdiv_rn, the correctly
// rounded fp32 quotient XLA computes for (x - lo) / scale, and a NaN code
// packs as 0 (fmaxf drops the NaN, as the float -> uint8 casts give).
// Bound: the larger of the bytes (x 4 B an element, 1/pack B out) and the
// Threefry's integer instructions an element (as K5): operations.
// ---------------------------------------------------------------------------
template <int BITS>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const float* __restrict__ x,
                     const float* __restrict__ params,
                     uint8_t* __restrict__ out, long long row_elems,
                     const __grid_constant__ RowKeys keys) {
  constexpr int kPack = 8 / BITS;
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const unsigned b = blockIdx.y;
  const float lo = params[2 * b];
  const float scale = params[2 * b + 1];
  const threefry::Key key = row_key(keys, b);
  const float* xb = x + (long long)b * kPack * row_elems;
  unsigned* ob = reinterpret_cast<unsigned*>(out + (long long)b * row_elems);
  const long long n4 = row_elems / 4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const long long j = k * row_elems + 4 * i;
      const float4 v = __ldg(reinterpret_cast<const float4*>(xb + j));
      const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float norm = __fdiv_rn(xs[e] - lo, scale);
        const float fl = floorf(norm);
        const float frac = norm - fl;
        const float u = threefry::uniform(key, (uint32_t)j + (uint32_t)e);
        float q = fl + (u < frac ? 1.0f : 0.0f);
        q = fminf(fmaxf(q, 0.0f), kLevels);
        acc |= ((unsigned)q) << (8 * e + k * BITS);
      }
    }
    ob[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K3 decode_packed. Replaces repro/kernels/quant/kernel.py
// decode_packed_bucketed (full buckets; the flat tier's tail as B = 1) and
// decode_packed (:117, the per-leaf message, B leaves as for K2). One thread per payload byte writes its pack dequantized values,
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
// (:187, the full buckets of the training step's qdq_flat, its tail as
// B = 1) and qdq (:77, the per-leaf qdq: B leaves of B stacked workers,
// one params row each), each together with the jax.random.uniform draw
// beside it (repro/kernels/quant/ops.py:96, :310, :315). Elementwise: the
// segment layout only orders the uniforms, and that order is flat element
// order, so a bucket is seen as one run of `elems` values, grid.y picks
// its params row and key (RowKeys) and element i draws counter i. Each
// thread takes 4 neighbouring elements: one 16-byte load and store, four
// counters hashed under the key in registers. Per element, as the
// reference rounds:
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
// Bound: the larger of the bytes (x in, out: 8 B an element) and the
// Threefry's integer instructions an element (as K5): operations.
// ---------------------------------------------------------------------------
template <int BITS>
__device__ __forceinline__ float qdq1(float x, float lo, float scale,
                                      float u) {
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const float norm = __fdiv_rn(x - lo, scale);
  const float fl = floorf(norm);
  float q = fl + (u < norm - fl ? 1.0f : 0.0f);
  q = nan_min(nan_max(q, 0.0f), kLevels);
  return __fmaf_rn(q, scale, lo);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qdq_kernel(const float4* x, const float* __restrict__ params, float4* out,
           long long n4, const __grid_constant__ RowKeys keys) {
  const unsigned b = blockIdx.y;
  const float lo = params[2 * b];
  const float scale = params[2 * b + 1];
  const threefry::Key key = row_key(keys, b);
  const long long base = (long long)b * n4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const float4 v = x[base + i];
    const uint32_t c = (uint32_t)(4 * i);
    float4 o;
    o.x = qdq1<BITS>(v.x, lo, scale, threefry::uniform(key, c));
    o.y = qdq1<BITS>(v.y, lo, scale, threefry::uniform(key, c + 1u));
    o.z = qdq1<BITS>(v.z, lo, scale, threefry::uniform(key, c + 2u));
    o.w = qdq1<BITS>(v.w, lo, scale, threefry::uniform(key, c + 3u));
    out[base + i] = o;
  }
}

// ---------------------------------------------------------------------------
// K5 decode_add_encode_bucketed: one reduce-scatter hop of the partitioned
// ring AllReduce, for every worker, in one call. Replaces
// repro/kernels/quant/kernel.py decode_add_encode_bucketed (:349,
// pallas_call at :366) together with the jax.random.uniform draws beside
// it (repro/kernels/quant/ops.py decode_add_encode_flat: fold_in(key, b)
// per bucket): the unit the JAX package computes per worker and hop, here
// for all N workers at once. Per bucket, as the TPU kernel computes:
//   s     = code_k * scale_in + lo_in + x   ONE rounding for the multiply-add
//                                          (__fmaf_rn, as K3), then the add
//   lo,hi = exact, NaN-propagating min / max of s over the bucket
//   scale = (hi - lo) * f32(1/levels), or 1 where hi > lo fails
//   code  = the stochastic rounding of (s - lo) / scale (__fdiv_rn) against
//           u = uniform(fold_in(key_w, b), (pack, R, 512))[k, r, c], with
//           K4's NaN-keeping clip (a NaN code packs as 0, as XLA's and
//           PyTorch's float -> uint8 casts give)
// and packs segment k at bits [k*b, (k+1)*b) of the outgoing payload. The
// uniforms are drawn here by the Threefry of threefry.cuh from the
// bucket's key (computed on the host) and the element's counter
// k*R*512 + r*512 + c, so they are the bits prng.uniform would have drawn
// and never reach device memory.
//
// Worker w reads its incoming message (payload + params) and its local
// fp32 slice, and writes its outgoing message, through pointers of its
// own: the ring passes views (worker w's incoming message is w - 1's
// outgoing one, its slice a window of the stacked gradient), and nothing
// is copied into a stacked buffer first.
//
// The TPU kernel carried each bucket's [lo, hi] in VMEM scratch across a
// sequential grid: a stats phase, then an encode phase that recomputes the
// sum. Blocks here run in no order, so the two phases walk one flat list of
// slices (16Ki elements of one bucket of one worker each) on a persistent
// grid, as many blocks as the card holds at once:
//   phase 1  each slice's (min, max) of s to a partial; the block that
//            finishes a bucket's last slice (a ticket per bucket, as K1)
//            folds the bucket's partials and writes params_out = [lo,
//            scale], and resets the ticket;
//   barrier  the end of the first of two launches on one stream (a
//            cooperative launch with a grid sync in its place measured
//            slower on the H100, PERF.md);
//   phase 2  recompute s, draw u, encode and pack. Slices are walked in
//            reverse, so the first ones phase 2 reads are the last phase 1
//            read, still in the 50 MB L2.
// The fp32 sum never reaches device memory; min and max are exact, so the
// order of blocks cannot change the result. Each thread takes 4 columns of
// a row at a time: one 4-byte payload word (128 B a warp) and one 16-byte
// load of x a segment.
// Bound: the larger of the bytes -- payload in and out (2/pack B) and x
// (4 B) per element, 16 B of params a bucket: 5 B an element at rq4 -- and
// the Threefry's integer instructions an element, counted per pipe: ~52 on
// the ALU pipe (LOP3, SHF, IADD3) at 64 lanes an SM a clock, which binds
// over the ~17 IMAD the compiler moves to the FMA pipe (also 64 lanes) and
// over the dispatch rate (128 an SM a clock): ~2x the bytes, so K5 is bound by
// its arithmetic. The design itself reads payload and x twice (9.5 B an
// element at rq4), which the L2 shortens for the last slices of phase 1.
//
// One launch takes at most kHopMaxWorkers workers and kHopMaxKeys
// (worker, bucket) keys, which travel in its argument block; the wrapper
// cuts a larger hop into launches of whole buckets (kernel.hop_chunks).
// ---------------------------------------------------------------------------
constexpr int kHopMaxWorkers = 8;
constexpr int kHopMaxKeys = 256;      // (worker, bucket) keys in one launch
constexpr int kHopSliceElems = 16384;
constexpr int kHopMinBlocks = 4;      // blocks an SM its registers allow

struct HopArgs {
  const uint8_t* pay_in[kHopMaxWorkers];
  const float* par_in[kHopMaxWorkers];
  const float* x[kHopMaxWorkers];
  uint8_t* pay_out[kHopMaxWorkers];
  float* par_out[kHopMaxWorkers];
  uint32_t key[kHopMaxKeys][2];       // worker w, bucket b at w * nb + b
  float2* partial;                    // one (lo, hi) a slice
  unsigned* ticket;                   // one zeroed counter a (worker, bucket)
  int n_workers, n_buckets;
  int rows_b, rt;                     // rows of a full bucket, of the tail
  int slice_rows;                     // rows of one slice
  int spf, spt;                       // slices of a full bucket, of the tail
  int n_slices;
};

struct HopSlice {
  int w, b;        // worker, bucket
  int rows;        // the bucket's R
  int r0, r1;      // the slice's rows [r0, r1)
  int first;       // the bucket's first slice
  int count;       // the bucket's slices
};

__device__ __forceinline__ HopSlice hop_slice(const HopArgs& a, int s) {
  const int head = (a.n_buckets - 1) * a.spf;
  const int per_worker = head + a.spt;
  HopSlice q;
  q.w = s / per_worker;
  int j = s - q.w * per_worker;
  if (j < head) {
    q.b = j / a.spf;
    j -= q.b * a.spf;
    q.rows = a.rows_b;
    q.count = a.spf;
  } else {
    q.b = a.n_buckets - 1;
    j -= head;
    q.rows = a.rt;
    q.count = a.spt;
  }
  q.first = s - j;
  q.r0 = j * a.slice_rows;
  q.r1 = min(q.r0 + a.slice_rows, q.rows);
  return q;
}

template <int BITS>
__device__ __forceinline__ float dae_sum(unsigned p, int k, float scale,
                                         float lo, float x) {
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const float code = (float)((p >> (k * BITS)) & kMask);
  return __fadd_rn(__fmaf_rn(code, scale, lo), x);
}

// Phase 1 of slice s: its partial (lo, hi) of s; the bucket's last slice
// to finish folds the partials into params_out.
template <int BITS>
__device__ void hop_stats(const HopArgs& a, int s) {
  constexpr int kPack = 8 / BITS;
  // the jitted reference's scale: a multiply by the fp32 reciprocal
  constexpr float kInv = (float)(1.0 / (double)((1 << BITS) - 1));
  const HopSlice q = hop_slice(a, s);
  const long long bucket = (long long)q.b * a.rows_b * 512;
  const uint8_t* pay = a.pay_in[q.w] + bucket;
  const float* x = a.x[q.w] + kPack * bucket;
  const float lo_in = __ldg(a.par_in[q.w] + 2 * q.b);
  const float scale_in = __ldg(a.par_in[q.w] + 2 * q.b + 1);
  const long long seg = (long long)q.rows * 512;
  const int units = (q.r1 - q.r0) * 128;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const long long rc = (long long)(q.r0 + (u >> 7)) * 512 + ((u & 127) << 2);
    const unsigned p = __ldg(reinterpret_cast<const unsigned*>(pay + rc));
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + k * seg + rc));
      const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sum = dae_sum<BITS>((p >> (8 * j)) & 0xFFu, k, scale_in,
                                        lo_in, xs[j]);
        lo = nan_min(lo, sum);
        hi = nan_max(hi, sum);
      }
    }
  }
  block_minmax(lo, hi);
  __shared__ bool last;
  unsigned* ticket = a.ticket + q.w * a.n_buckets + q.b;
  if (threadIdx.x == 0) {
    a.partial[s] = make_float2(lo, hi);
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)q.count - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  lo = INFINITY;
  hi = -INFINITY;
  for (int i = threadIdx.x; i < q.count; i += kThreads) {
    const float2 p = __ldcg(a.partial + q.first + i);
    lo = nan_min(lo, p.x);
    hi = nan_max(hi, p.y);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    float* out = a.par_out[q.w] + 2 * q.b;
    out[0] = lo;
    out[1] = hi > lo ? __fmul_rn(__fsub_rn(hi, lo), kInv) : 1.0f;
    *ticket = 0u;
  }
  __syncthreads();   // warp 0 has read block_minmax's shared partials
}

// Phase 2 of slice s: re-encode against the bucket's params_out and the
// uniforms drawn from its key.
template <int BITS>
__device__ void hop_encode(const HopArgs& a, int s) {
  constexpr int kPack = 8 / BITS;
  constexpr float kLevels = (float)((1 << BITS) - 1);
  const HopSlice q = hop_slice(a, s);
  const long long bucket = (long long)q.b * a.rows_b * 512;
  const uint8_t* pay = a.pay_in[q.w] + bucket;
  const float* x = a.x[q.w] + kPack * bucket;
  uint8_t* out = a.pay_out[q.w] + bucket;
  const float lo_in = __ldg(a.par_in[q.w] + 2 * q.b);
  const float scale_in = __ldg(a.par_in[q.w] + 2 * q.b + 1);
  // written in this launch (or the one before) by another block
  const float lo = __ldcg(a.par_out[q.w] + 2 * q.b);
  const float scale = __ldcg(a.par_out[q.w] + 2 * q.b + 1);
  const int kw = q.w * a.n_buckets + q.b;
  const threefry::Key key = threefry::make_key(a.key[kw][0], a.key[kw][1]);
  const long long seg = (long long)q.rows * 512;
  const int units = (q.r1 - q.r0) * 128;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const long long rc = (long long)(q.r0 + (u >> 7)) * 512 + ((u & 127) << 2);
    const unsigned p = __ldg(reinterpret_cast<const unsigned*>(pay + rc));
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < kPack; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + k * seg + rc));
      const float xs[4] = {v.x, v.y, v.z, v.w};
      // the element's counter in its bucket's (pack, R, 512) draw
      const uint32_t ctr = (uint32_t)(k * seg + rc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sum = dae_sum<BITS>((p >> (8 * j)) & 0xFFu, k, scale_in,
                                        lo_in, xs[j]);
        const float norm = __fdiv_rn(__fsub_rn(sum, lo), scale);
        const float fl = floorf(norm);
        const float uni = threefry::uniform(key, ctr + (uint32_t)j);
        float qv = __fadd_rn(fl, uni < __fsub_rn(norm, fl) ? 1.0f : 0.0f);
        qv = nan_min(nan_max(qv, 0.0f), kLevels);
        const unsigned code = qv != qv ? 0u : (unsigned)qv;
        acc |= code << (8 * j + k * BITS);
      }
    }
    *reinterpret_cast<unsigned*>(out + rc) = acc;
  }
}

// PHASE 1 or 2 of the hop: two ordinary launches on one stream.
template <int BITS, int PHASE>
__global__ void __launch_bounds__(kThreads, kHopMinBlocks)
hop_kernel(const __grid_constant__ HopArgs a) {
  if (PHASE == 1)
    for (int s = blockIdx.x; s < a.n_slices; s += (int)gridDim.x)
      hop_stats<BITS>(a, s);
  else
    for (int s = a.n_slices - 1 - (int)blockIdx.x; s >= 0; s -= (int)gridDim.x)
      hop_encode<BITS>(a, s);
}

// Blocks of the persistent grid: as many as the card holds at once.
template <typename Kernel>
cudaError_t hop_grid(Kernel kern, int n_slices, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms < n_slices ? per_sm * sms : n_slices;
  return cudaSuccess;
}

template <int BITS>
cudaError_t hop_launch(const HopArgs& a, cudaStream_t s) {
  int grid = 0;
  cudaError_t err = hop_grid(hop_kernel<BITS, 1>, a.n_slices, &grid);
  if (err != cudaSuccess) return err;
  hop_kernel<BITS, 1><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = hop_grid(hop_kernel<BITS, 2>, a.n_slices, &grid);
  if (err != cudaSuccess) return err;
  hop_kernel<BITS, 2><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

int hop_slice_rows(int bits) { return kHopSliceElems / ((8 / bits) * 512); }

// ---------------------------------------------------------------------------
// The device Threefry alone, for checking it against prng.random_bits /
// prng.uniform (MODE 1: bits, 2: unit floats) and for counting its
// instructions in the SASS (MODE 0 writes the counter itself: the same
// kernel without the hash). One counter a thread.
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void threefry_kernel(uint32_t k0, uint32_t k1, uint32_t offset,
                                long long count, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const uint32_t ctr = offset + (uint32_t)i;
  if (MODE == 0) {
    out[i] = ctr;
    return;
  }
  const uint32_t b = threefry::bits(threefry::make_key(k0, k1), ctr);
  out[i] = MODE == 1 ? b : __float_as_uint(threefry::unit(b));
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

// The RowKeys of a launch of n_rows rows: fold != 0 takes keys[0..1] as the
// root key and row b's key as fold_in(root, first + b); fold == 0 takes
// keys as n_rows (k0, k1) pairs (n_rows <= kMaxRowKeys).
bool row_keys(const unsigned* keys, int fold, unsigned first,
              long long n_rows, RowKeys* k) {
  if (keys == nullptr || (!fold && n_rows > kMaxRowKeys)) return false;
  k->fold = fold ? 1 : 0;
  k->first = first;
  k->root[0] = fold ? keys[0] : 0u;
  k->root[1] = fold ? keys[1] : 0u;
  for (long long i = 0; i < (fold ? 0 : n_rows); ++i) {
    k->key[i][0] = keys[2 * i];
    k->key[i][1] = keys[2 * i + 1];
  }
  return true;
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


// x: (B, pack, R, 512) fp32, 16-byte aligned; params: (B, 2); out:
// (B, R, 512) uint8, 4-byte aligned; keys, fold, first: see row_keys. A
// row's pack * R * 512 counters stay below 2**32.
int quant_encode_packed(const void* x, const void* params, void* out,
                        long long n_buckets, long long rows, int bits,
                        const unsigned* keys, int fold, unsigned first,
                        void* stream) {
  RowKeys k;
  if ((bits != 8 && bits != 4 && bits != 2) || n_buckets < 1 ||
      n_buckets > 65535 || rows < 1 ||
      (8 / bits) * rows * 512 > 0x100000000LL ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0 ||
      !row_keys(keys, fold, first, n_buckets, &k))
    return (int)cudaErrorInvalidValue;
  const long long row_elems = rows * 512;
  const dim3 grid(blocks_per_bucket(row_elems / 4, n_buckets),
                  (unsigned)n_buckets);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* pf = (const float*)params;
  uint8_t* o = (uint8_t*)out;
  switch (bits) {
    case 8: encode_packed_kernel<8><<<grid, kThreads, 0, s>>>(xf, pf, o, row_elems, k); break;
    case 4: encode_packed_kernel<4><<<grid, kThreads, 0, s>>>(xf, pf, o, row_elems, k); break;
    case 2: encode_packed_kernel<2><<<grid, kThreads, 0, s>>>(xf, pf, o, row_elems, k); break;
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

// x, out: (B, elems) fp32 (elems = pack * R * 512 < 2**32 + 1), 16-byte
// aligned; out may equal x; params: (B, 2); keys, fold, first: see
// row_keys.
int quant_qdq_bucketed(const void* x, const void* params, void* out,
                       long long n_buckets, long long elems, int bits,
                       const unsigned* keys, int fold, unsigned first,
                       void* stream) {
  RowKeys k;
  if (n_buckets < 1 || n_buckets > 65535 || elems < 4 || elems % 4 != 0 ||
      elems > 0x100000000LL ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
       & 15) != 0 ||
      !row_keys(keys, fold, first, n_buckets, &k))
    return (int)cudaErrorInvalidValue;
  const long long n4 = elems / 4;
  const dim3 grid(blocks_per_bucket(n4, n_buckets), (unsigned)n_buckets);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* xf = (const float4*)x;
  const float* pf = (const float*)params;
  float4* o = (float4*)out;
  switch (bits) {
    case 8: qdq_kernel<8><<<grid, kThreads, 0, s>>>(xf, pf, o, n4, k); break;
    case 4: qdq_kernel<4><<<grid, kThreads, 0, s>>>(xf, pf, o, n4, k); break;
    case 2: qdq_kernel<2><<<grid, kThreads, 0, s>>>(xf, pf, o, n4, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The K5 hop over n_workers workers. ptrs: 5 * n_workers device pointers,
// [payload_in, params_in, x, payload_out, params_out] each for worker 0 ..
// n - 1 (payload (rows, 512) uint8 with rows = (nb - 1) * rows_b + rt,
// params (nb, 2) fp32, x (pack * rows * 512,) fp32; payloads and x 16-byte
// aligned; no output aliases an input). keys: n_workers * nb (k0, k1)
// pairs, worker-major. partial: quant_hop_slices(...) float2 scratch;
// ticket: n_workers * nb zeroed uint32 counters (left zeroed).
int quant_decode_add_encode_hop(const unsigned long long* ptrs,
                                const unsigned* keys, void* partial,
                                void* ticket, int n_workers, int n_buckets,
                                long long rows_b, long long rt, int bits,
                                void* stream) {
  if (bits != 8 && bits != 4 && bits != 2) return (int)cudaErrorInvalidValue;
  const long long pack = 8 / bits;
  if (n_workers < 1 || n_workers > kHopMaxWorkers || n_buckets < 1 ||
      (long long)n_workers * n_buckets > kHopMaxKeys || rt < 1 ||
      rows_b < rt || pack * rows_b * 512 > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  HopArgs a;
  for (int w = 0; w < n_workers; ++w) {
    a.pay_in[w] = (const uint8_t*)ptrs[w];
    a.par_in[w] = (const float*)ptrs[n_workers + w];
    a.x[w] = (const float*)ptrs[2 * n_workers + w];
    a.pay_out[w] = (uint8_t*)ptrs[3 * n_workers + w];
    a.par_out[w] = (float*)ptrs[4 * n_workers + w];
    if (((ptrs[w] | ptrs[2 * n_workers + w] | ptrs[3 * n_workers + w]) & 15)
        != 0)
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_workers * n_buckets; ++i) {
    a.key[i][0] = keys[2 * i];
    a.key[i][1] = keys[2 * i + 1];
  }
  a.partial = (float2*)partial;
  a.ticket = (unsigned*)ticket;
  a.n_workers = n_workers;
  a.n_buckets = n_buckets;
  a.rows_b = (int)rows_b;
  a.rt = (int)rt;
  a.slice_rows = hop_slice_rows(bits);
  a.spf = (int)((rows_b + a.slice_rows - 1) / a.slice_rows);
  a.spt = (int)((rt + a.slice_rows - 1) / a.slice_rows);
  a.n_slices = n_workers * ((n_buckets - 1) * a.spf + a.spt);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 8: return (int)hop_launch<8>(a, s);
    case 4: return (int)hop_launch<4>(a, s);
    default: return (int)hop_launch<2>(a, s);
  }
}

// The partial scratch K5 needs: its slices over the hop.
long long quant_hop_slices(int n_workers, int n_buckets, long long rows_b,
                           long long rt, int bits) {
  const long long sr = hop_slice_rows(bits);
  return (long long)n_workers *
         ((n_buckets - 1) * ((rows_b + sr - 1) / sr) + (rt + sr - 1) / sr);
}

// out[i] = the Threefry's bits (mode 1) or unit float (mode 2) of counter
// offset + i under (k0, k1), or the counter itself (mode 0), i < count.
int quant_threefry(unsigned k0, unsigned k1, unsigned offset, long long count,
                   void* out, int mode, void* stream) {
  if (count < 1 || count > 0x100000000LL || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((count + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  switch (mode) {
    case 0: threefry_kernel<0><<<grid, kThreads, 0, s>>>(k0, k1, offset, count, o); break;
    case 1: threefry_kernel<1><<<grid, kThreads, 0, s>>>(k0, k1, offset, count, o); break;
    default: threefry_kernel<2><<<grid, kThreads, 0, s>>>(k0, k1, offset, count, o); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
