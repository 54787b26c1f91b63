// K6: forward GQA flash attention for Hopper (sm_90a) on the tensor
// cores. Replaces the JAX package's Pallas kernel
// src/repro/kernels/flash_attn/kernel.py:143 flash_attention_bhsd.
//
// Computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D), fp32 or bf16,
// contiguous and 16-byte aligned, out (B, Hq, S, D) in q's dtype:
//   logits = (q * scale) . k           (scale = 1/sqrt(D))
//   logits = cap * tanh(logits * (1/cap))           (when cap > 0)
//   masked -> -2**30: k >= s_valid; causal k > q; window k <= q - window
//   online softmax over key tiles: fp32 running max m, rescale
//   alpha = exp(m_old - m_new), denominator l; masked probabilities are
//   zeroed after the exp; out = acc / max(l, 1e-30).
//
// What bounds it: at prefill lengths both products, S = (q*scale).k and
// O += P.v, run hundreds of flops per byte of q, k, v and out, so the
// tensor cores bound it.
//   * fp32: 3xTF32 on mma.sync m16n8k8 (tf32 in, fp32 accumulate). Each
//     fp32 operand x splits as big = x rounded to tf32 (nearest, ties
//     away: cvt.rna's rounding) and small = x - big, and a.b ~
//     a_small.b_big + a_big.b_small + a_big.b_big, the two small cross
//     terms accumulated before the big one (CUTLASS's
//     OpMultiplyAddFastF32, PyTorch's memory-efficient attention on
//     fp32). The dropped a_small.b_small term is ~2^-22 of the product,
//     the size of fp32 rounding in another summation order, so the
//     kernel keeps fp32 parity with the plain version (2e-5). Bound: 3 x
//     4*D flops per attended (q-head, query, key) triple at 495 TFLOP/s
//     dense TF32 (mma.sync itself reaches ~65 % of that rate).
//   * bf16: mma.sync m16n8k16 bf16 with fp32 accumulation (bf16 x bf16
//     products are exact in fp32); the scale is applied to the fp32
//     logits, and P is rounded to bf16 for P.v, as flash attention
//     kernels do. Bound: 4*D flops per triple at 989 TFLOP/s.
// Design:
//   * a block holds ROWS folded rows, the (q-head, query) pairs of ALL
//     q-heads of one KV head over ROWS / group queries (the TPU kernel
//     folds the heads into its tile for the same reason), so each K/V
//     tile is read from device memory once for the whole group; ROWS =
//     128 (8 warps), 64 (4 warps) at D = 256; each warp owns 16 rows;
//   * K/V tiles of BK keys (64 at D = 128, else 32) are double-buffered
//     with cp.async 16-byte copies: tile k + 1 loads while tile k
//     computes, one __syncthreads per tile; at D <= 64 the small tiles
//     let two blocks share an SM (128 registers a thread);
//   * q lands once a block; bf16 keeps its fragments in registers
//     (D <= 128), fp32 reads them from shared memory and splits them
//     each tile (its split fragments would not fit the registers);
//   * fp32 at D <= 64 splits each landed K/V tile once for the block
//     (k's big part in place, its small part beside, v's two parts
//     transposed with the keys in P.v's order, all read by ldmatrix):
//     8 warps splitting the same fragments was half their instructions;
//     at D = 128 and 256 the split tiles do not fit beside the others,
//     and each warp splits the fragments it reads;
//   * a row's m and l live in the quad of threads that hold that row of
//     the accumulator fragment: row reductions are two xor shuffles;
//   * P goes from the score fragment straight into the P.v A-fragment:
//     in fp32 by permuting the keys of each 8-key step (A column t ->
//     key 2t, t + 4 -> key 2t + 1, V's rows read in the same order), in
//     bf16 by the layout the two fragments share;
//   * fp32 P.v of a tile accumulates in fresh registers and joins o by
//     one fmaf: the tensor core truncates as it accumulates, and a
//     running o fed through it for hundreds of tiles drifts to ~2e-5;
//   * shared rows are padded by 16 bytes, so ldmatrix (q, k; v in bf16
//     with .trans) and the scalar reads of v in fp32 are free of bank
//     conflicts;
//   * the Pallas kernel's pair table of surviving (q-block, k-block)
//     tiles becomes a k range per block from the causal, window and
//     tail masks, and (skip = 1) a warp drops a tile that masks all its
//     rows; skip = 0 walks every k-tile, bit-identical because a fully
//     masked tile is an exact no-op (alpha = 1, P = 0, +0 through the
//     mma); only tiles that straddle a mask edge are masked elementwise;
//   * blocks are issued longest causal range first, across all heads;
//   * IEEE expf / tanhf and true division, no fast-math intrinsics.
// Shared memory: (ROWS + 4 * BK) * (D + 16 / sizeof(T)) elements (and
// the split tiles at D <= 64), at most 202,752 bytes (fp32, D = 128), as
// dynamic shared memory after
// cudaFuncSetAttribute; a refused launch is returned by
// cudaGetLastError() and raised by the wrapper.
// flash_fwd<T, D, LSE, DV>: v and out may have their own head dim DV
// (default D, so every square instantiation is the code it was; a v row
// lands in its own padded stride VSTR). Built at (D 192, DV 128) in fp32
// alone, for multi-head latent attention (DeepSeek-V2: q.k over 128
// nope + 64 rope dims, p.v over 128): it replaces no TPU kernel (the
// JAX package runs MLA as plain attention). 128 rows, 32-key tiles,
// 184,320 bytes of shared memory; each warp splits its fragments as at
// D = 128. Bound: 2 * (D + DV) flops a triple at 3xTF32's 165 TFLOP/s.
// flash_fwd<T, D, true> also stores each row's log-sum-exp, m + log(l)
// in fp32 (B, Hq, S), for the backward, after the key loop; it is built
// for fp32 at D 64 and 128 alone (what K6b covers). A prefill passes no
// lse pointer and runs flash_fwd<T, D, false>, whose code has no store.
//
// K6b: the backward of K6's fp32 function without softcap, which no TPU
// kernel has (the Pallas kernel is forward-only; the JAX package trains
// through its plain attention, whose gradient this computes). Given q,
// k, v, out, dout and lse it returns dq, dk, dv:
//   P = exp((q * scale) . k - lse) where attended, else 0
//   delta = rowsum(dout * out); dS = P * (dout . v - delta)
//   dv = P^T . dout, dk = dS^T . (q * scale)  (summed over the group)
//   dq = scale * dS . k
// What bounds it: five products of 2 * D flops a triple (S, dP, dV, dK,
// dQ), 10 * D a (q-head, query, key) triple, at 165 TFLOP/s for 3xTF32;
// this design recomputes S and dP in its dQ pass (seven products).
// Every product is 3xTF32 with K6's split and term order. Design:
//   * flash_bwd_delta: delta, a warp a row;
//   * flash_bwd_dkdv, a block per (batch, KV head, 128 keys), 16 keys a
//     warp: the block's K and V stay in shared memory, and it walks the
//     q-heads of its group and the query tiles (64 queries, 32 at D =
//     128) that the causal, window and s_valid masks leave, cp.async
//     double-buffered with their lse and delta. A warp computes S^T = k
//     . (q * scale)^T and dP^T = v . dout^T with k, v as A fragments and
//     q, dout as B fragments (ldmatrix, as K6 reads k), P^T and dS^T in
//     the accumulator registers, which become the A fragments of dV +=
//     P^T . dout and dK += dS^T . (q * scale) by K6's key permutation
//     (here the queries: A column t is query 2t, t + 4 query 2t + 1,
//     read from shared memory at rows 2t, 2t + 1). Summing the group
//     inside one block keeps dk and dv free of atomics;
//   * flash_bwd_dq, a block per K6 block (the same folded rows, the
//     same k range and edge tests): S and dP again, dS, and dQ += dS .
//     k; its q and dout rows stay in shared memory, k and v tiles are
//     double-buffered;
//   * a tile's dV, dK and dQ products sum in fresh registers, added to
//     the running sums once (the tensor core truncates as it
//     accumulates, as in K6's P.v);
//   * no float atomics: the same inputs give the same bits on every
//     call; a warp skips a tile its masks leave empty, and only tiles
//     on a mask edge are masked elementwise.
// Shared memory: dK/dV (2 * 128 + 4 * BQ) * (D + 4) + 4 * BQ floats,
// dQ (2 * 128 + 4 * BK) * (D + 4); at most 203,264 bytes (D = 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;   // -2**30, as the TPU kernel

template <typename T, int D, int DV = D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int ROWS = D == 256 ? 64 : 128;   // folded rows
  static constexpr int THREADS = ROWS / 16 * 32;     // a warp per 16 rows
  static constexpr int BK = D == 128 ? 64 : 32;      // keys per tile
  static constexpr int MINB = D <= 64 ? 2 : 1;       // blocks per SM
  static constexpr int VEC = 16 / (int)sizeof(T);    // elements in 16 B
  static constexpr int STR = D + VEC;                // padded shared row
  static constexpr int VSTR = DV + VEC;              // ... of a v row
  static constexpr int KSTEP = 2 * VEC;              // mma depth (32 B)
  static constexpr int NT = BK / 8;                  // score n-tiles
  static constexpr int ND = DV / 8;                  // output n-tiles
  static constexpr int KQ = D / KSTEP;               // k-steps of q.k
  static constexpr int KP = BK / KSTEP;              // k-steps of p.v
  static constexpr bool QREG = !F32 && D <= 128;      // q in registers
  // fp32 at D <= 64: k and v are split once a tile for all warps (the
  // split tiles fit the shared memory of two blocks an SM); above, each
  // warp splits the fragments it reads
  static constexpr bool PRESPLIT = F32 && D <= 64;
  static constexpr int Q_ELEMS = ROWS * STR;
  static constexpr int KV_ELEMS = BK * STR;
  static constexpr int V_ELEMS = BK * VSTR;
  // fp32: the tile's split operands, k's small part (its big part
  // overwrites the landed tile) and v's big and small parts transposed
  static constexpr int VT_STR = BK + 4;
  static constexpr int VT_ELEMS = DV * VT_STR;
  static constexpr int SPLIT_ELEMS = PRESPLIT ? KV_ELEMS + 2 * VT_ELEMS : 0;
  static constexpr size_t SMEM =
      (size_t)(Q_ELEMS + 2 * KV_ELEMS + 2 * V_ELEMS + SPLIT_ELEMS) *
      sizeof(T);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared (bytes = 0: zeros)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// x = big + small: big = x rounded to tf32, to nearest with ties away
// from zero (the rounding of cvt.rna.tf32.f32, in two integer ops on the
// full-rate pipes; cvt runs on the conversion pipe at 16 a clock an SM),
// small = x - big (exact in fp32), whose 13 low bits the tensor core
// drops (truncation, |error| < 2^-21 |x|)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: c += a.b with a = ab + as, b = bb + bs, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool attends(long long kp, long long qp,
                                        long long s_valid, int causal,
                                        int window) {
  return kp < s_valid && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

template <typename T, int D, bool LSE, int DV = D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, Cfg<T, D>::MINB)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int hq, int hkv,
          long long s, long long s_valid, int causal, int window,
          float scale, float cap, float inv_cap, int skip, int gh, int bq,
          int n_chunks) {
  using C = Cfg<T, D, DV>;
  constexpr int BK = C::BK, STR = C::STR, VEC = C::VEC, KSTEP = C::KSTEP;
  constexpr int VSTR = C::VSTR;
  constexpr int CH = D / VEC;                 // 16-byte chunks of a row
  constexpr int VCH = DV / VEC;               // ... of a v row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);     // ROWS x STR
  T* ks = qs + C::Q_ELEMS;                    // 2 stages of BK x STR
  T* vs = ks + 2 * C::KV_ELEMS;               // 2 stages of BK x VSTR
  float* k_small = reinterpret_cast<float*>(vs + 2 * C::V_ELEMS);
  float* vt_big = k_small + C::KV_ELEMS;      // DV x VT_STR
  float* vt_small = vt_big + C::VT_ELEMS;     // DV x VT_STR

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = hq / hkv;
  // x enumerates (q-tile, KV head, head chunk), the q-tile slowest and
  // the longest causal range first
  const int ny = hkv * n_chunks;
  const long long qt = (long long)(gridDim.x / ny) - 1 - blockIdx.x / ny;
  const int y = blockIdx.x % ny;
  const int kvh = y / n_chunks;
  const int g0 = (y % n_chunks) * gh;
  const long long b = blockIdx.z;
  const long long q0 = qt * bq;
  const int rows = gh * bq;
  const long long kv_base = (b * hkv + kvh) * s;

  // row r: q-head kvh * group + g0 + r / bq, query q0 + r % bq
  for (int idx = tid; idx < C::ROWS * CH; idx += C::THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int gi = g0 + r / bq;
    const long long qp = q0 + r % bq;
    const bool ok = r < rows && gi < group && qp < s;
    const T* src =
        ok ? q + ((b * hq + (long long)kvh * group + gi) * s + qp) * D +
                 c * VEC
           : q;
    cp_async16(smem_addr(qs + r * STR + c * VEC), src, ok ? 16 : 0);
  }
  auto load_kv = [&](long long k0, int stage) {
    T* kd = ks + stage * C::KV_ELEMS;
    T* vd = vs + stage * C::V_ELEMS;
    if constexpr (DV == D) {
      for (int idx = tid; idx < BK * CH; idx += C::THREADS) {
        const int r = idx / CH, c = idx % CH;
        const bool ok = k0 + r < s;
        const long long off = ok ? (kv_base + k0 + r) * D + c * VEC : 0;
        cp_async16(smem_addr(kd + r * STR + c * VEC), k + off, ok ? 16 : 0);
        cp_async16(smem_addr(vd + r * STR + c * VEC), v + off, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BK * CH; idx += C::THREADS) {
        const int r = idx / CH, c = idx % CH;
        const bool ok = k0 + r < s;
        const long long off = ok ? (kv_base + k0 + r) * D + c * VEC : 0;
        cp_async16(smem_addr(kd + r * STR + c * VEC), k + off, ok ? 16 : 0);
      }
      for (int idx = tid; idx < BK * VCH; idx += C::THREADS) {
        const int r = idx / VCH, c = idx % VCH;
        const bool ok = k0 + r < s;
        const long long off = ok ? (kv_base + k0 + r) * DV + c * VEC : 0;
        cp_async16(smem_addr(vd + r * VSTR + c * VEC), v + off,
                   ok ? 16 : 0);
      }
    }
  };

  long long k_begin = 0, k_end = s;
  if (skip) {
    const long long q_last = (q0 + bq < s ? q0 + bq : s) - 1;
    k_end = s_valid;
    if (causal && q_last + 1 < k_end) k_end = q_last + 1;
    if (window > 0 && q0 - window + 1 > 0)
      k_begin = (q0 - window + 1) / BK * BK;
  }
  const int n_tiles =
      k_end > k_begin ? (int)((k_end - k_begin + BK - 1) / BK) : 0;
  if (n_tiles > 0) load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16, and the warp's
  // query range [lo, hi] (for the edge and dead-tile tests)
  const int wr = warp * 16;
  long long qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (wr + g + 8 * i) % bq;
  long long lo = qpos[0] < qpos[1] ? qpos[0] : qpos[1];
  long long hi = qpos[0] < qpos[1] ? qpos[1] : qpos[0];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const long long l2 = __shfl_xor_sync(0xffffffffu, lo, off);
    const long long h2 = __shfl_xor_sync(0xffffffffu, hi, off);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }

  // ldmatrix row addresses: q's A fragment (lane -> row, 16-byte half)
  const uint32_t q_addr = smem_addr(
      qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
      (lane >> 4) * VEC);
  // k's B fragments of two n-tiles
  const int k_lane_off = ((lane >> 4) * 8 + (lane & 7)) * STR +
                         ((lane >> 3) & 1) * VEC;
  // fp32: k's small part at the same offsets; v's transposed parts, the
  // B fragments of two output n-tiles
  const uint32_t ks_addr = smem_addr(k_small + k_lane_off);
  const int vt_lane_off = ((lane >> 4) * 8 + (lane & 7)) * C::VT_STR +
                          ((lane >> 3) & 1) * 4;
  const uint32_t vtb_addr = smem_addr(vt_big + vt_lane_off);
  const uint32_t vts_addr = smem_addr(vt_small + vt_lane_off);

  cp_async_wait_all();
  __syncthreads();

  // fp32: 4 big + 4 small tf32 words per k-step; bf16: 4 words
  constexpr int QW = C::F32 ? 8 : 4;
  uint32_t qreg[C::QREG ? C::KQ : 1][QW];
  auto q_frag = [&](int kk, uint32_t (&w)[QW]) {
    uint32_t raw[4];
    ldsm4(raw, q_addr + kk * KSTEP * (int)sizeof(T));
    if constexpr (C::F32) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(raw[e]) * scale, w[e], w[4 + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = raw[e];
    }
  };
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) q_frag(kk, qreg[kk]);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait_all();   // tile it has landed (this thread's copies)
      __syncthreads();       // ... everyone's; tile it - 1 is consumed
    }
    if (it + 1 < n_tiles) {
      load_kv(k_begin + (long long)(it + 1) * BK, (it + 1) & 1);
      cp_async_commit();
    }
    const long long k0 = k_begin + (long long)it * BK;
    T* kt = ks + (it & 1) * C::KV_ELEMS;
    const T* vt = vs + (it & 1) * C::V_ELEMS;
    if constexpr (C::PRESPLIT) {
      // split the tile once for all warps: k's big part in place, its
      // small part beside; v's parts transposed (row d), the keys of each
      // 8-key step in the P.v A-fragment's order (key 2t at t, key 2t + 1
      // at t + 4), so that ldmatrix reads the B fragments
      float* kf = reinterpret_cast<float*>(kt);
      const float* vf = reinterpret_cast<const float*>(vt);
      for (int idx = tid; idx < BK * D / 4; idx += C::THREADS) {
        const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
        float4 x = *reinterpret_cast<const float4*>(kf + r * STR + c);
        uint32_t bg[4], sm[4];
        split(x.x, bg[0], sm[0]);
        split(x.y, bg[1], sm[1]);
        split(x.z, bg[2], sm[2]);
        split(x.w, bg[3], sm[3]);
        *reinterpret_cast<uint4*>(kf + r * STR + c) =
            make_uint4(bg[0], bg[1], bg[2], bg[3]);
        *reinterpret_cast<uint4*>(k_small + r * STR + c) =
            make_uint4(sm[0], sm[1], sm[2], sm[3]);
      }
      for (int idx = tid; idx < BK * DV / 4; idx += C::THREADS) {
        const int key = idx % BK, d = 4 * (idx / BK);
        const int pos = (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
        const float4 x =
            *reinterpret_cast<const float4*>(vf + key * VSTR + d);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bg, sm;
          split(xs[i], bg, sm);
          vt_big[(d + i) * C::VT_STR + pos] = __uint_as_float(bg);
          vt_small[(d + i) * C::VT_STR + pos] = __uint_as_float(sm);
        }
      }
      __syncthreads();
    }
    // a tile that masks every row of this warp is a no-op: skip drops it
    if (skip && ((causal && k0 > hi) ||
                 (window > 0 && k0 + BK - 1 <= lo - window)))
      continue;
    const bool edge = k0 + BK > s_valid || (causal && k0 + BK - 1 > lo) ||
                      (window > 0 && k0 <= hi - window);
    const uint32_t k_addr = smem_addr(kt + k_lane_off);

    // S = (q * scale) . k: sc[j] holds keys 8j + 2t, +1 of rows g, g + 8
    float sc[C::NT][4];
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      uint32_t qw[QW];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < QW; ++e) qw[e] = qreg[kk][e];
      } else {
        q_frag(kk, qw);
      }
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int off = (j * 8 * STR + kk * KSTEP) * (int)sizeof(T);
        uint32_t kb[4], ksm[4];
        ldsm4(kb, k_addr + off);
        if constexpr (C::PRESPLIT) {
          ldsm4(ksm, ks_addr + off);
        } else if constexpr (C::F32) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(__uint_as_float(kb[e]), kb[e], ksm[e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (C::F32) {
            uint32_t ab[4], as[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ab[e] = qw[e];
              as[e] = qw[4 + e];
            }
            mma_3xtf32(sc[j + h], ab, as, kb[2 * h], kb[2 * h + 1],
                       ksm[2 * h], ksm[2 * h + 1]);
          } else {
            const uint32_t a[4] = {qw[0], qw[1], qw[2], qw[3]};
            mma_bf16(sc[j + h], a, kb[2 * h], kb[2 * h + 1]);
          }
        }
      }
    }

    // online softmax; bit (4j + e) of keep: the element is attended
    uint32_t keep = 0xffffffffu;
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e];
        if constexpr (!C::F32) x *= scale;
        if (cap > 0.f) x = cap * tanhf(x * inv_cap);
        if (edge && !attends(k0 + 8 * j + 2 * t + (e & 1), qpos[e >> 1],
                             s_valid, causal, window)) {
          x = NEG_INF;
          keep &= ~(1u << (4 * j + e));
        }
        sc[j][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    float mn[2], ps[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      mn[i] = fmaxf(m[i], mc[i]);
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (keep >> (4 * j + e)) & 1u ? expf(sc[j][e] - mn[e >> 1]) : 0.f;
        sc[j][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
      alpha[i] = expf(m[i] - mn[i]);
      l[i] = alpha[i] * l[i] + ps[i];
      m[i] = mn[i];
      if constexpr (!C::F32) {
#pragma unroll
        for (int n = 0; n < C::ND; ++n) {
          o[n][2 * i] *= alpha[i];
          o[n][2 * i + 1] *= alpha[i];
        }
      }
    }

    // O += P . v
    if constexpr (C::F32) {
      // the tile's P.v goes into fresh accumulators, added to o once
      // (o = o * alpha + tile, one fmaf): the tensor core truncates as it
      // accumulates, which over hundreds of tiles drifts by ~1e-5; within
      // one tile it stays at the plain version's rounding. k-step c =
      // score tile c, keys permuted: A column t is key 2t, column t + 4
      // key 2t + 1 (B rows t, t + 4: v rows 2t, 2t + 1)
      constexpr int NG = C::ND < 8 ? C::ND : 8;   // output n-tiles at a time
      uint32_t pb[C::NT][4], psm[C::NT][4];
#pragma unroll
      for (int c = 0; c < C::NT; ++c) {
        split(sc[c][0], pb[c][0], psm[c][0]);
        split(sc[c][2], pb[c][1], psm[c][1]);
        split(sc[c][1], pb[c][2], psm[c][2]);
        split(sc[c][3], pb[c][3], psm[c][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < C::ND; n0 += NG) {
        float acc[NG][4];
#pragma unroll
        for (int nn = 0; nn < NG; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
#pragma unroll
        for (int c = 0; c < C::NT; ++c) {
          if constexpr (C::PRESPLIT) {
#pragma unroll
            for (int nn = 0; nn < NG; nn += 2) {
              const int off = (8 * (n0 + nn) * C::VT_STR + 8 * c) * 4;
              uint32_t vb[4], vsm[4];
              ldsm4(vb, vtb_addr + off);
              ldsm4(vsm, vts_addr + off);
              mma_3xtf32(acc[nn], pb[c], psm[c], vb[0], vb[1], vsm[0],
                         vsm[1]);
              mma_3xtf32(acc[nn + 1], pb[c], psm[c], vb[2], vb[3], vsm[2],
                         vsm[3]);
            }
          } else {
            const float* v0 = reinterpret_cast<const float*>(vt) +
                              (8 * c + 2 * t) * VSTR + g + 8 * n0;
#pragma unroll
            for (int nn = 0; nn < NG; ++nn) {
              uint32_t bb0, bs0, bb1, bs1;
              split(v0[8 * nn], bb0, bs0);
              split(v0[VSTR + 8 * nn], bb1, bs1);
              mma_3xtf32(acc[nn], pb[c], psm[c], bb0, bb1, bs0, bs1);
            }
          }
        }
#pragma unroll
        for (int nn = 0; nn < NG; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n0 + nn][e] = fmaf(o[n0 + nn][e], alpha[e >> 1], acc[nn][e]);
      }
    } else {
      const uint32_t v_addr = smem_addr(
          vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * VSTR +
          (lane >> 4) * 8);
#pragma unroll
      for (int c = 0; c < C::KP; ++c) {
        const uint32_t a[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                               pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                               pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                               pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
        for (int n = 0; n < C::ND; n += 2) {
          uint32_t vb[4];
          ldsm4_t(vb, v_addr + (16 * c * VSTR + 8 * n) * (int)sizeof(T));
          mma_bf16(o[n], a, vb[0], vb[1]);
          mma_bf16(o[n + 1], a, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    const int gi = g0 + r / bq;
    if (r >= rows || gi >= group || qpos[i] >= s) continue;
    const long long h = (long long)kvh * group + gi;
    T* orow = out + ((b * hq + h) * s + qpos[i]) * DV + 2 * t;
    if constexpr (LSE) {
      if (t == 0) lse[(b * hq + h) * s + qpos[i]] = m[i] + logf(l[i]);
    }
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
      store2(orow + 8 * n, o[n][2 * i] / den, o[n][2 * i + 1] / den);
  }
}

template <typename T, int D, bool LSE, int DV = D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, long long b, int hq, int hkv, long long s,
                   long long s_valid, int causal, int window, float scale,
                   float cap, float inv_cap, int skip, cudaStream_t stream) {
  using C = Cfg<T, D, DV>;
  const int group = hq / hkv;
  const int gh = group > C::ROWS ? C::ROWS : group;
  const int bq = C::ROWS / gh;
  const int n_chunks = (group + gh - 1) / gh;
  const long long n_x = (s + bq - 1) / bq * hkv * n_chunks;
  if (n_x > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D, LSE, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_x, 1u, (unsigned)b);
  flash_fwd<T, D, LSE, DV><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, hq, hkv, s,
      s_valid,
      causal, window, scale, cap, inv_cap, skip, gh, bq, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, int dv, const void* q, const void* k,
                     const void* v, void* out, float* lse, long long b,
                     int hq, int hkv, long long s, long long s_valid,
                     int causal, int window, float scale, float cap,
                     float inv_cap, int skip, cudaStream_t stream) {
  if (dv != d) {  // multi-head latent attention: q.k at 192, p.v at 128
    if constexpr (Cfg<T, 64>::F32) {
      if (lse == nullptr && d == 192 && dv == 128)
        return launch<T, 192, false, 128>(q, k, v, out, nullptr, b, hq, hkv,
                                          s, s_valid, causal, window, scale,
                                          cap, inv_cap, skip, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (lse != nullptr) {  // built where K6b covers the backward
    if constexpr (Cfg<T, 64>::F32) {
      if (d == 64)
        return launch<T, 64, true>(q, k, v, out, lse, b, hq, hkv, s, s_valid,
                                   causal, window, scale, cap, inv_cap, skip,
                                   stream);
      if (d == 128)
        return launch<T, 128, true>(q, k, v, out, lse, b, hq, hkv, s,
                                    s_valid, causal, window, scale, cap,
                                    inv_cap, skip, stream);
    }
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 32:
      return launch<T, 32, false>(q, k, v, out, nullptr, b, hq, hkv, s,
                                  s_valid, causal, window, scale, cap,
                                  inv_cap, skip, stream);
    case 64:
      return launch<T, 64, false>(q, k, v, out, nullptr, b, hq, hkv, s,
                                  s_valid, causal, window, scale, cap,
                                  inv_cap, skip, stream);
    case 128:
      return launch<T, 128, false>(q, k, v, out, nullptr, b, hq, hkv, s,
                                   s_valid, causal, window, scale, cap,
                                   inv_cap, skip, stream);
    case 256:
      return launch<T, 256, false>(q, k, v, out, nullptr, b, hq, hkv, s,
                                   s_valid, causal, window, scale, cap,
                                   inv_cap, skip, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ K6b --

template <int D>
struct BwdCfg {
  static constexpr int THREADS = 256;            // 8 warps, 16 rows each
  static constexpr int STR = D + 4;              // padded shared row
  static constexpr int CH = D / 4;               // 16-byte chunks of a row
  static constexpr int KD = D / 8;               // k-steps over D
  static constexpr int ND = D / 8;               // n-tiles over D
  static constexpr int NG = D == 128 ? 4 : 8;    // n-tiles summed at a time
  // dK/dV pass: BKV keys a block, query tiles of BQ
  static constexpr int BKV = 128;
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int NQ = BQ / 8;
  static constexpr size_t SMEM_KV =
      ((size_t)2 * BKV * STR + 4 * BQ * STR + 4 * BQ) * sizeof(float);
  // dQ pass: ROWS folded rows a block (K6's), key tiles of BK
  static constexpr int ROWS = 128;
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int NK = BK / 8;
  static constexpr size_t SMEM_Q =
      ((size_t)2 * ROWS * STR + 4 * BK * STR) * sizeof(float);
};

// four fp32 words by ldmatrix (an A fragment, or the B fragments of two
// n-tiles), scaled by mul and split
__device__ __forceinline__ void ldsm4_split(uint32_t addr, float mul,
                                            uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  uint32_t raw[4];
  ldsm4(raw, addr);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split(__uint_as_float(raw[e]) * mul, big[e], small[e]);
}

// acc[n] += x . y for the warp's 16 rows, where x (16 x 8 * NX) is held
// as accumulator fragments (x[c][e]: row g + 8 * (e >> 1), column 8c + 2t
// + (e & 1)) and y (8 * NX x D) lies row-major in shared memory at
// stride STR (scaled by mul): a k-step per n-tile c of x, columns
// permuted (A column t is x's column 2t, t + 4 is 2t + 1; y's rows read
// alike). Each group of NG output n-tiles sums in fresh registers, added
// to acc once.
template <int D, int NX>
__device__ __forceinline__ void acc_xy(float (&acc)[D / 8][4],
                                       float (&x)[NX][4],
                                       const float* y, float mul, int g,
                                       int t) {
  using C = BwdCfg<D>;
  constexpr int STR = C::STR, NG = C::NG;
#pragma unroll
  for (int n0 = 0; n0 < C::ND; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int nn = 0; nn < NG; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nn][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      uint32_t xb[4], xs[4];
      split(x[c][0], xb[0], xs[0]);
      split(x[c][2], xb[1], xs[1]);
      split(x[c][1], xb[2], xs[2]);
      split(x[c][3], xb[3], xs[3]);
      const float* y0 = y + (8 * c + 2 * t) * STR + g + 8 * n0;
#pragma unroll
      for (int nn = 0; nn < NG; ++nn) {
        uint32_t bb0, bs0, bb1, bs1;
        split(y0[8 * nn] * mul, bb0, bs0);
        split(y0[STR + 8 * nn] * mul, bb1, bs1);
        mma_3xtf32(part[nn], xb, xs, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NG; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + nn][e] += part[nn][e];
  }
}

// sc[j] (16 x 8 * NX) = a . b^T over D for the warp's 16 rows: a's rows
// at the A-fragment ldmatrix address a_addr (scaled by amul), b's rows
// (8 * NX of them) at the B-fragment address b_addr (scaled by bmul)
template <int D, int NX>
__device__ __forceinline__ void scores(float (&sc)[NX][4], uint32_t a_addr,
                                       float amul, uint32_t b_addr,
                                       float bmul) {
  constexpr int STR = BwdCfg<D>::STR;
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BwdCfg<D>::KD; ++kk) {
    uint32_t ab[4], as[4];
    ldsm4_split(a_addr + kk * 32, amul, ab, as);
#pragma unroll
    for (int j = 0; j < NX; j += 2) {
      uint32_t bb[4], bs[4];
      ldsm4_split(b_addr + (j * 8 * STR + kk * 8) * 4, bmul, bb, bs);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma_3xtf32(sc[j + h], ab, as, bb[2 * h], bb[2 * h + 1], bs[2 * h],
                   bs[2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(256)
flash_bwd_delta(const float* __restrict__ out,
                const float* __restrict__ dout, float* __restrict__ delta,
                long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + row * d;
  const float* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS, 1)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int hq, int hkv, long long s,
               long long s_valid, int causal, int window, float scale) {
  using C = BwdCfg<D>;
  constexpr int STR = C::STR, CH = C::CH, BKV = C::BKV, BQ = C::BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // BKV x STR
  float* vs = ks + BKV * STR;                       // BKV x STR
  float* qs = vs + BKV * STR;                       // 2 stages of BQ x STR
  float* gs = qs + 2 * BQ * STR;                    // dout, 2 stages
  float* ls = gs + 2 * BQ * STR;                    // lse, 2 stages of BQ
  float* es = ls + 2 * BQ;                          // delta, 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = hq / hkv;
  // x enumerates (key tile, KV head), the first keys (the longest
  // causal query range) first
  const int kvh = blockIdx.x % hkv;
  const long long k0 = (long long)(blockIdx.x / hkv) * BKV;
  const long long b = blockIdx.z;
  const long long kv_base = (b * hkv + kvh) * s;

  for (int idx = tid; idx < BKV * CH; idx += C::THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = k0 + r < s;
    const long long off = ok ? (kv_base + k0 + r) * D + c * 4 : 0;
    cp_async16(smem_addr(ks + r * STR + c * 4), k + off, ok ? 16 : 0);
    cp_async16(smem_addr(vs + r * STR + c * 4), v + off, ok ? 16 : 0);
  }
  // the queries that see a key of the block: causal q >= k0, a window
  // q < k0 + BKV - 1 + window; none when every key is padding
  long long q_begin = 0, q_end = k0 < s_valid ? s : 0;
  if (causal) q_begin = k0 / BQ * BQ;
  if (window > 0 && k0 + BKV - 1 + window < q_end)
    q_end = k0 + BKV - 1 + window;
  const int n_qt =
      q_end > q_begin ? (int)((q_end - q_begin + BQ - 1) / BQ) : 0;
  const int n_it = n_qt * group;   // (q-head of the group, query tile)

  auto load_q = [&](int it, int stage) {
    const long long h = (long long)kvh * group + it / n_qt;
    const long long q0 = q_begin + (long long)(it % n_qt) * BQ;
    const long long row0 = (b * hq + h) * s;
    float* qd = qs + stage * BQ * STR;
    float* gd = gs + stage * BQ * STR;
    for (int idx = tid; idx < BQ * CH; idx += C::THREADS) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = q0 + r < s;
      const long long off = ok ? (row0 + q0 + r) * D + c * 4 : 0;
      cp_async16(smem_addr(qd + r * STR + c * 4), q + off, ok ? 16 : 0);
      cp_async16(smem_addr(gd + r * STR + c * 4), dout + off, ok ? 16 : 0);
    }
    for (int r = tid; r < BQ; r += C::THREADS) {
      const bool ok = q0 + r < s;
      const long long off = ok ? row0 + q0 + r : 0;
      cp_async4(smem_addr(ls + stage * BQ + r), lse + off, ok ? 4 : 0);
      cp_async4(smem_addr(es + stage * BQ + r), delta + off, ok ? 4 : 0);
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  // this thread's keys g and g + 8 of the warp's 16
  const long long kw = k0 + warp * 16;
  const long long kpos[2] = {kw + g, kw + g + 8};
  // ldmatrix addresses: the warp's k and v rows as A fragments; q and
  // dout rows as the B fragments of two n-tiles
  const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                    (lane >> 4) * 4;
  const uint32_t ka = smem_addr(ks + a_off), va = smem_addr(vs + a_off);
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * STR +
                    ((lane >> 3) & 1) * 4;

  float dka[C::ND][4], dva[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    if (it > 0) {
      cp_async_wait_all();   // tile it has landed (this thread's copies)
      __syncthreads();       // ... everyone's; tile it - 1 is consumed
    }
    if (it + 1 < n_it) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const long long q0 = q_begin + (long long)(it % n_qt) * BQ;
    // a tile that masks every key of this warp is a no-op: dropped
    if (kw >= s_valid || (causal && kw > q0 + BQ - 1) ||
        (window > 0 && kw + 15 <= q0 - window))
      continue;
    const bool edge = kw + 15 >= s_valid || q0 + BQ > s ||
                      (causal && kw + 15 > q0) ||
                      (window > 0 && kw <= q0 + BQ - 1 - window);
    const float* qt = qs + (it & 1) * BQ * STR;
    const float* gt = gs + (it & 1) * BQ * STR;
    const float* lt = ls + (it & 1) * BQ;
    const float* et = es + (it & 1) * BQ;

    // S^T = k . (q * scale)^T; sc[j] holds queries 8j + 2t, +1 of keys
    // g, g + 8; then P^T = exp(S^T - lse) where attended
    float sc[C::NQ][4];
    scores<D, C::NQ>(sc, ka, 1.f, smem_addr(qt + b_off), scale);
#pragma unroll
    for (int j = 0; j < C::NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const bool on = !edge || (q0 + qc < s &&
                                  attends(kpos[e >> 1], q0 + qc, s_valid,
                                          causal, window));
        sc[j][e] = on ? expf(sc[j][e] - lt[qc]) : 0.f;
      }
    // dV += P^T . dout
    acc_xy<D, C::NQ>(dva, sc, gt, 1.f, g, t);
    // dP^T = v . dout^T; dS^T = P^T * (dP^T - delta)
    float dp[C::NQ][4];
    scores<D, C::NQ>(dp, va, 1.f, smem_addr(gt + b_off), 1.f);
#pragma unroll
    for (int j = 0; j < C::NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] *= dp[j][e] - et[8 * j + 2 * t + (e & 1)];
    // dK += dS^T . (q * scale)
    acc_xy<D, C::NQ>(dka, sc, qt, scale, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= s) continue;
    float* dkr = dk + (kv_base + kpos[i]) * D + 2 * t;
    float* dvr = dv + (kv_base + kpos[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < C::ND; ++n) {
      store2(dkr + 8 * n, dka[n][2 * i], dka[n][2 * i + 1]);
      store2(dvr + 8 * n, dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS, 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int hq, int hkv, long long s,
             long long s_valid, int causal, int window, float scale, int gh,
             int bq, int n_chunks) {
  using C = BwdCfg<D>;
  constexpr int STR = C::STR, CH = C::CH, BK = C::BK, ROWS = C::ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // ROWS x STR
  float* gs = qs + ROWS * STR;                      // dout, ROWS x STR
  float* ks = gs + ROWS * STR;                      // 2 stages of BK x STR
  float* vs = ks + 2 * BK * STR;                    // 2 stages of BK x STR

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = hq / hkv;
  // K6's blocks: x enumerates (q-tile, KV head, head chunk), the longest
  // causal range first
  const int ny = hkv * n_chunks;
  const long long qt = (long long)(gridDim.x / ny) - 1 - blockIdx.x / ny;
  const int y = blockIdx.x % ny;
  const int kvh = y / n_chunks;
  const int g0 = (y % n_chunks) * gh;
  const long long b = blockIdx.z;
  const long long q0 = qt * bq;
  const int rows = gh * bq;
  const long long kv_base = (b * hkv + kvh) * s;

  // row r: q-head kvh * group + g0 + r / bq, query q0 + r % bq
  for (int idx = tid; idx < ROWS * CH; idx += C::THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int gi = g0 + r / bq;
    const long long qp = q0 + r % bq;
    const bool ok = r < rows && gi < group && qp < s;
    const long long off =
        ok ? ((b * hq + (long long)kvh * group + gi) * s + qp) * D + c * 4
           : 0;
    cp_async16(smem_addr(qs + r * STR + c * 4), q + off, ok ? 16 : 0);
    cp_async16(smem_addr(gs + r * STR + c * 4), dout + off, ok ? 16 : 0);
  }
  auto load_kv = [&](long long k0, int stage) {
    float* kd = ks + stage * BK * STR;
    float* vd = vs + stage * BK * STR;
    for (int idx = tid; idx < BK * CH; idx += C::THREADS) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = k0 + r < s;
      const long long off = ok ? (kv_base + k0 + r) * D + c * 4 : 0;
      cp_async16(smem_addr(kd + r * STR + c * 4), k + off, ok ? 16 : 0);
      cp_async16(smem_addr(vd + r * STR + c * 4), v + off, ok ? 16 : 0);
    }
  };

  // K6's k range (skip on)
  const long long q_last = (q0 + bq < s ? q0 + bq : s) - 1;
  long long k_begin = 0, k_end = s_valid;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  if (window > 0 && q0 - window + 1 > 0)
    k_begin = (q0 - window + 1) / BK * BK;
  const int n_tiles =
      k_end > k_begin ? (int)((k_end - k_begin + BK - 1) / BK) : 0;
  if (n_tiles > 0) load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16: their queries, lse
  // and delta (0 on a row past the block's, whose q and dout are 0)
  const int wr = warp * 16;
  long long qpos[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    const int gi = g0 + r / bq;
    qpos[i] = q0 + r % bq;
    const bool ok = r < rows && gi < group && qpos[i] < s;
    const long long at = (b * hq + (long long)kvh * group + gi) * s + qpos[i];
    lrow[i] = ok ? lse[at] : 0.f;
    drow[i] = ok ? delta[at] : 0.f;
  }
  long long lo = qpos[0] < qpos[1] ? qpos[0] : qpos[1];
  long long hi = qpos[0] < qpos[1] ? qpos[1] : qpos[0];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const long long l2 = __shfl_xor_sync(0xffffffffu, lo, off);
    const long long h2 = __shfl_xor_sync(0xffffffffu, hi, off);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  const int a_off = (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                    (lane >> 4) * 4;
  const uint32_t qa = smem_addr(qs + a_off), ga = smem_addr(gs + a_off);
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * STR +
                    ((lane >> 3) & 1) * 4;

  float dqa[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {
      load_kv(k_begin + (long long)(it + 1) * BK, (it + 1) & 1);
      cp_async_commit();
    }
    const long long k0 = k_begin + (long long)it * BK;
    if ((causal && k0 > hi) || (window > 0 && k0 + BK - 1 <= lo - window))
      continue;
    const bool edge = k0 + BK > s_valid || (causal && k0 + BK - 1 > lo) ||
                      (window > 0 && k0 <= hi - window);
    const float* kt = ks + (it & 1) * BK * STR;
    const float* vt = vs + (it & 1) * BK * STR;

    // S = (q * scale) . k^T; P = exp(S - lse) where attended
    float sc[C::NK][4];
    scores<D, C::NK>(sc, qa, scale, smem_addr(kt + b_off), 1.f);
#pragma unroll
    for (int j = 0; j < C::NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on =
            !edge || attends(k0 + 8 * j + 2 * t + (e & 1), qpos[e >> 1],
                             s_valid, causal, window);
        sc[j][e] = on ? expf(sc[j][e] - lrow[e >> 1]) : 0.f;
      }
    // dP = dout . v^T; dS = P * (dP - delta)
    float dp[C::NK][4];
    scores<D, C::NK>(dp, ga, 1.f, smem_addr(vt + b_off), 1.f);
#pragma unroll
    for (int j = 0; j < C::NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= dp[j][e] - drow[e >> 1];
    // dQ += dS . k (scaled once at the end)
    acc_xy<D, C::NK>(dqa, sc, kt, 1.f, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    const int gi = g0 + r / bq;
    if (r >= rows || gi >= group || qpos[i] >= s) continue;
    float* row = dq + ((b * hq + (long long)kvh * group + gi) * s +
                       qpos[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
      store2(row + 8 * n, dqa[n][0 + 2 * i] * scale,
             dqa[n][1 + 2 * i] * scale);
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* out, const float* dout, const float* lse,
                       float* dq, float* dk, float* dv, float* delta,
                       long long b, int hq, int hkv, long long s,
                       long long s_valid, int causal, int window, float scale,
                       cudaStream_t stream) {
  using C = BwdCfg<D>;
  if (b > 65535) return cudaErrorInvalidValue;
  const long long rows = b * hq * s;
  const long long n_delta = (rows + 7) / 8;
  const long long n_kv = (s + C::BKV - 1) / C::BKV * hkv;
  const int group = hq / hkv;
  const int gh = group > C::ROWS ? C::ROWS : group;
  const int bq = C::ROWS / gh;
  const int n_chunks = (group + gh - 1) / gh;
  const long long n_q = (s + bq - 1) / bq * hkv * n_chunks;
  if (n_delta > 0x7fffffffLL || n_kv > 0x7fffffffLL || n_q > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  flash_bwd_delta<<<(unsigned)n_delta, 256, 0, stream>>>(out, dout, delta,
                                                         rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_KV);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D><<<dim3((unsigned)n_kv, 1u, (unsigned)b), C::THREADS,
                      C::SMEM_KV, stream>>>(q, k, v, dout, lse, delta, dk,
                                            dv, hq, hkv, s, s_valid, causal,
                                            window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_Q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D><<<dim3((unsigned)n_q, 1u, (unsigned)b), C::THREADS,
                    C::SMEM_Q, stream>>>(q, k, v, dout, lse, delta, dq, hq,
                                         hkv, s, s_valid, causal, window,
                                         scale, gh, bq, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; dv: v's and out's head dim (d, or 128
// at d = 192 in fp32). Returns the launch's cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int dtype, long long b,
                              int hq,
                              int hkv, long long s, int d, int dv,
                              long long s_valid,
                              int causal, int window, float scale, float cap,
                              float inv_cap, int skip, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15u)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch<float>(d, dv, q, k, v, out, ls, b, hq, hkv, s,
                                s_valid, causal, window, scale, cap, inv_cap,
                                skip, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, dv, q, k, v, out, ls, b, hq, hkv,
                                        s, s_valid, causal, window, scale,
                                        cap, inv_cap, skip, st);
  return (int)cudaErrorInvalidValue;
}

// K6b, fp32 only: dq, dk, dv of flash_attn_fwd's function (no softcap)
// from q, k, v, out, dout and lse; delta is (B, Hq, S) fp32 scratch.
// Three launches on the stream. Returns the first cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, long long b, int hq, int hkv,
                              long long s, int d, long long s_valid,
                              int causal, int window, float scale,
                              void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
       (uintptr_t)dout | (uintptr_t)lse | (uintptr_t)dq | (uintptr_t)dk |
       (uintptr_t)dv | (uintptr_t)delta) & 15u)
    return (int)cudaErrorMisalignedAddress;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(out);
  const float* fg = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  float* de = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return (int)launch_bwd<64>(fq, fk, fv, fo, fg, fl, gq, gk, gv, de, b,
                                 hq, hkv, s, s_valid, causal, window, scale,
                                 st);
    case 128:
      return (int)launch_bwd<128>(fq, fk, fv, fo, fg, fl, gq, gk, gv, de, b,
                                  hq, hkv, s, s_valid, causal, window, scale,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
