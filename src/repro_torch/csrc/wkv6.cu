// K7: the RWKV6 chunked scan for Hopper (sm_90a), a two-level chunk scan
// on the tensor cores (3xTF32). Replaces the JAX package's Pallas kernel
// src/repro/kernels/wkv6/kernel.py:77 wkv6_bhsk.
//
// Computes, for r, k, v, log_w (B, H, S, K) fp32, contiguous, S a
// multiple of C = 64, and u (H, K) fp32, the scan from a zero state:
// per chunk of C steps, in order,
//   cum       = inclusive cumsum of log_w down the chunk
//   q_in      = r * exp(cum - log_w)
//   att       = q_in @ (k * exp(-cum))^T, kept on s < t (strict lower)
//   out       = q_in @ S + att @ v + sum(r * u * k) * v
//   S         = exp(total) * S + (k * exp(total - cum))^T @ v,
//               total = cum of the chunk's last step
// and writes out (B, H, S, K) and the final S (B, H, K, K). IEEE expf,
// no fast-math intrinsics: exp(-cum) reaches large values under strong
// decays, where __expf's error grows with the argument.
//
// What bounds it: the work the function needs is, per (b, h, chunk),
// 4*C*K^2 flops for q_in @ S and the state update plus 2*C*(C-1)*K for
// att and att @ v on the strict lower triangle, against reading r, k,
// v, log_w and writing out once: 19 flops per byte at K = 64, 57 as
// 3xTF32 tensor flops, under the H100's 148 (495 TFLOP/s dense TF32 over
// 3.35 TB/s), so the bound is the bytes. The chunks of one (b, h) form a
// chain through S: one block per (b, h) (the first design) gave 40
// blocks on 132 SMs at rwkv6-3b's prefill shape. The design:
//   * a two-level chunk scan. S is linear in itself, so the sequence is
//     cut into groups of G chunks (the wrapper's GROUP_CHUNKS) and the
//     scan runs in three launches:
//     (a) every group runs the state recurrence from zero over its
//         chunks, giving its local state L_g and its per-row decay
//         D_g = prod exp(total) (multiplied in the chain's order);
//     (b) an elementwise scan over the groups, one thread per (b, h,
//         row, column): S_{g+1} = D_g * S_g + L_g from S_0 = 0, which
//         overwrites L_g with the group's entry state and writes the
//         final state;
//     (c) every group computes its outputs from its entry state,
//         carrying S through its chunks as the chain does.
//     Passes (a) and (c) run one block per (b, h, group), a chain of G
//     chunks each. The wrapper allocates the B*H*groups*(K*K + K) floats
//     of scratch. Pass (a) reads k, v and log_w and pass (c) all four
//     inputs, so the passes' own floor is about 1.6x the bound's bytes;
//   * the four products (q_in @ kd^T, q_in @ S, att @ v, k_carry^T @ v)
//     on mma.sync m16n8k8 as 3xTF32: each fp32 operand x splits as big
//     = x rounded to tf32 (nearest, ties away) and small = x - big, and
//     a.b ~ a_small.b_big + a_big.b_small + a_big.b_big, the small
//     cross terms first (as K6, csrc/flash_attn.cu). Each chunk's
//     products start from fresh accumulators and join S or out by one
//     fmaf or add: the tensor core truncates as it accumulates;
//   * att only on the 20 m16n8 tiles that touch the strict lower
//     triangle (of 32), masked only where a tile crosses the diagonal,
//     computed once a chunk and shared, split, through shared memory;
//   * each warp owns an 8-column block of out and S, so the B fragments
//     it reads (S's, v's) are its own and split once for all its row
//     blocks (q_in's A fragments come by ldmatrix and are split as they
//     are read); in pass (c) two warps share a column block, one taking
//     out's row blocks {0, 3} and the other {1, 2} (the same count of
//     att @ v steps), each half of S's rows. att @ v and the state update
//     read v's fragments with the steps of each 8-step slice permuted
//     (row t -> step 2t, t + 4 -> 2t + 1), which keeps the shared
//     memory reads free of bank conflicts; every warp's loops have the
//     same trip counts (the last att tile, which only some warps have,
//     runs in a loop of its own): a loop guarded per step serializes the
//     mma;
//   * the cumsum is a warp-shuffle inclusive scan down each column (a
//     lane holds rows l and l + 32; a Kogge-Stone scan over the lanes
//     for each half, the first half's total added to the second), so
//     every thread works; the same lane computes the decays of its
//     elements and writes q_in, k * exp(-cum) and k_carry in place of
//     r, k and log_w;
//   * cp.async double-buffers the chunk tiles: chunk c + 1 lands while
//     chunk c is scanned and multiplied. Three __syncthreads a chunk in
//     pass (c) (landed, scanned, att shared), two in pass (a).
// Shared memory at K = 64: 198,912 bytes in pass (c), one block of 16
// warps an SM; 104,704 in pass (a), two blocks of 8 warps. A refused
// launch is returned by cudaGetLastError() and raised by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;            // steps of a chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr int ATS = C + 8;       // att row stride
constexpr int ATT_TILES = 20;    // 16 x 8 att tiles on the strict lower triangle
constexpr int SCAN_THREADS = 256;

template <int K, bool OUT>
struct Cfg {
  // warps: pass (c) runs two a column block of out (16 at K = 64, 8 at
  // K = 32), pass (a) eight
  static constexpr int W = OUT && K == 64 ? 16 : 8;
  static constexpr int THREADS = 32 * W;
  static constexpr int TS = K + 4;       // chunk tile row stride (floats)
  static constexpr int SS = K + 8;       // state row stride
  static constexpr int TILE = C * TS;
  static constexpr int NT = OUT ? 4 : 3; // tiles a stage: [r,] k, log_w, v
  static constexpr int TR = 0, TK = OUT ? 1 : 0, TL = TK + 1, TV = TK + 2;
  static constexpr int KS = K / 8;       // mma k-steps over K
  static constexpr int CS = C / 8;       // mma k-steps over a chunk
  static constexpr int CPW = K / W;      // columns a warp scans
  static constexpr int NCOL = K / 8;     // 8-column blocks of out and S
  static constexpr int WPC = W / NCOL;   // warps sharing a column block
  static constexpr int MU = (K / 16) / WPC;  // 16-row blocks of S a warp owns
  static constexpr int SLOTS = (ATT_TILES + W - 1) / W;  // att tiles a warp
  // the stages; pass (c): S, att's big and small parts, the bonus
  // partials; the decays
  static constexpr size_t SMEM =
      (size_t)(2 * NT * TILE + (OUT ? K * SS + 2 * C * ATS + W * C : 0) +
               K) * sizeof(float);
  static_assert(CPW % 4 == 0, "a warp scans whole float4 columns");
  static_assert(!OUT || WPC == 2, "pass (c): two warps a column block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// four 8 x 4 fp32 matrices (as 8 x 8 b16) from shared memory: lane l
// gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// x = big + small: big = x rounded to tf32, to nearest with ties away
// from zero (cvt.rna's rounding, in two integer ops), small = x - big
// (exact in fp32), whose 13 low bits the tensor core drops
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
template <int N>
__device__ __forceinline__ void split_frag(const float (&a)[N],
                                           uint32_t (&ab)[N],
                                           uint32_t (&as)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(a[i], ab[i], as[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32: c += a.b with a = ab + as, b = bb + bs, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// inclusive scan over the 32 lanes (Kogge-Stone: x_l = x_{l-d} + x_l)
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = y + x;
  }
  return x;
}

// The chunk tiles at element offset `off` of one (b, h) into a stage
template <int K, bool OUT>
__device__ __forceinline__ void load_chunk(float* stage, const float* r,
                                           const float* k, const float* v,
                                           const float* lw, long long off,
                                           int tid) {
  using G = Cfg<K, OUT>;
  constexpr int K4 = K / 4;
  const float* src[G::NT];
  if (OUT) src[G::TR] = r;
  src[G::TK] = k;
  src[G::TL] = lw;
  src[G::TV] = v;
#pragma unroll
  for (int t = 0; t < G::NT; ++t) {
#pragma unroll
    for (int j = 0; j < C * K4 / G::THREADS; ++j) {
      const int i = tid + j * G::THREADS;
      const int row = i / K4, c4 = (i % K4) * 4;
      cp_async16(smem_addr(stage + t * G::TILE + row * G::TS + c4),
                 src[t] + off + (long long)row * K + c4);
    }
  }
}

// Phase E: the cumsum, the decays and the bonus partials of one landed
// chunk, in place: log_w -> k_carry, and in pass (c) r -> q_in and k ->
// kd = k * exp(-cum); etot[j] = exp(total_j); bp[w][t] = warp w's share
// of sum_j r * u * k. Warp w scans columns [CPW*w, CPW*(w+1)), lane l
// rows l and l + 32.
template <int K, bool OUT>
__device__ __forceinline__ void scan_chunk(float* stage, float* bp,
                                           float* etot, const float* uu,
                                           int warp, int lane) {
  using G = Cfg<K, OUT>;
  float* tr = stage + G::TR * G::TILE;
  float* tk = stage + G::TK * G::TILE;
  float* tl = stage + G::TL * G::TILE;
  float bonus[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < G::CPW / 4; ++q) {
    const int col = warp * G::CPW + 4 * q;
    const int o[2] = {lane * G::TS + col, (lane + 32) * G::TS + col};
    float lwv[2][4], kv[2][4], rv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 l4 = *reinterpret_cast<const float4*>(tl + o[h]);
      const float4 k4 = *reinterpret_cast<const float4*>(tk + o[h]);
      lwv[h][0] = l4.x; lwv[h][1] = l4.y; lwv[h][2] = l4.z; lwv[h][3] = l4.w;
      kv[h][0] = k4.x; kv[h][1] = k4.y; kv[h][2] = k4.z; kv[h][3] = k4.w;
      if (OUT) {
        const float4 r4 = *reinterpret_cast<const float4*>(tr + o[h]);
        rv[h][0] = r4.x; rv[h][1] = r4.y; rv[h][2] = r4.z; rv[h][3] = r4.w;
      }
    }
    float qv[2][4], dv[2][4], cv[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float cum[2];
      cum[0] = warp_scan(lwv[0][e], lane);
      cum[1] = __shfl_sync(FULL, cum[0], 31) + warp_scan(lwv[1][e], lane);
      const float total = __shfl_sync(FULL, cum[1], 31);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cv[h][e] = kv[h][e] * expf(total - cum[h]);
        if (OUT) {
          qv[h][e] = rv[h][e] * expf(cum[h] - lwv[h][e]);
          dv[h][e] = kv[h][e] * expf(-cum[h]);
          bonus[h] = bonus[h] + rv[h][e] * uu[q * 4 + e] * kv[h][e];
        }
      }
      if (lane == e) etot[col + e] = expf(total);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(tl + o[h]) =
          make_float4(cv[h][0], cv[h][1], cv[h][2], cv[h][3]);
      if (OUT) {
        *reinterpret_cast<float4*>(tk + o[h]) =
            make_float4(dv[h][0], dv[h][1], dv[h][2], dv[h][3]);
        *reinterpret_cast<float4*>(tr + o[h]) =
            make_float4(qv[h][0], qv[h][1], qv[h][2], qv[h][3]);
      }
    }
  }
  if (OUT) {
    bp[warp * C + lane] = bonus[0];
    bp[warp * C + lane + 32] = bonus[1];
  }
}

// q_in's A fragment at p (this lane's ldmatrix row address), split
__device__ __forceinline__ void q_frag(const float* p, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  uint32_t x[4];
  ldsm4(x, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), ab[i], as[i]);
}

// v's B fragment of k-slice kk (8 steps) and column block nc, split, the
// slice's steps permuted (B row t -> step 2t, t + 4 -> 2t + 1)
template <int K, bool OUT>
__device__ __forceinline__ void v_frag(const float* tv, int kk, int nc,
                                       int g, int t, uint32_t (&vb)[2],
                                       uint32_t (&vs)[2]) {
  using G = Cfg<K, OUT>;
  const float* p = tv + (8 * kk + 2 * t) * G::TS + 8 * nc + g;
  const float b[2] = {p[0], p[G::TS]};
  split_frag(b, vb, vs);
}

// acc[m] += (k_carry^T @ v) over k-slice kk on the state tiles (row
// block mi0 + m, the column block of v's fragment), the slice's steps
// permuted as v's rows are (A column t -> step 2t, t + 4 -> 2t + 1)
template <int K, bool OUT>
__device__ __forceinline__ void state_slice(float (&acc)[Cfg<K, OUT>::MU][4],
                                            const float* tl, int kk,
                                            int mi0, int g, int t,
                                            const uint32_t (&vb)[2],
                                            const uint32_t (&vs)[2]) {
  using G = Cfg<K, OUT>;
#pragma unroll
  for (int m = 0; m < G::MU; ++m) {
    const float* p = tl + (8 * kk + 2 * t) * G::TS + 16 * (mi0 + m) + g;
    const float a[4] = {p[0], p[8], p[G::TS], p[G::TS + 8]};
    uint32_t ab[4], as[4];
    split_frag(a, ab, as);
    mma3(acc[m], ab, as, vb, vs);
  }
}

// Pass (c), after att is in shared memory: out = (q_in @ S + att @ v) +
// bonus * v on row blocks RB0 and RB1 (a pair whose att tiles add up to
// the same count for both warps of a column block: {0, 3} and {1, 2}),
// and the state update's k_carry^T @ v into acc.
template <int K, int RB0, int RB1>
__device__ __forceinline__ void out_and_state(
    float (&oi)[2][4], float (&acc)[Cfg<K, true>::MU][4], const float* tl,
    const float* tv, const float* attb, const float* atts, const float* bp,
    float* out_rows, int ncol, int mi0, int g, int t) {
  using G = Cfg<K, true>;
  constexpr int RB[2] = {RB0, RB1};
  float oa[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < G::CS; ++kk) {
    uint32_t vb[2], vs[2];
    v_frag<K, true>(tv, kk, ncol, g, t, vb, vs);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kk > 2 * RB[i] + 1) continue;         // above the diagonal
      const int o0 = (16 * RB[i] + g) * ATS + 8 * kk + 2 * t;
      const int o1 = o0 + 8 * ATS;
      const uint2 b0 = *reinterpret_cast<const uint2*>(attb + o0);
      const uint2 b1 = *reinterpret_cast<const uint2*>(attb + o1);
      const uint2 s0 = *reinterpret_cast<const uint2*>(atts + o0);
      const uint2 s1 = *reinterpret_cast<const uint2*>(atts + o1);
      const uint32_t ab[4] = {b0.x, b1.x, b0.y, b1.y};
      const uint32_t as[4] = {s0.x, s1.x, s0.y, s1.y};
      mma3(oa[i], ab, as, vb, vs);
    }
    state_slice<K, true>(acc, tl, kk, mi0, g, t, vb, vs);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row0 = 16 * RB[i] + g, col = 8 * ncol + 2 * t;
    // the bonus of rows row0 and row0 + 8: the four lanes of a row each
    // sum a quarter of the warps' partials, then two xor shuffles
    float bo0 = 0.f, bo1 = 0.f;
#pragma unroll
    for (int w = t; w < G::W; w += 4) {
      bo0 = bo0 + bp[w * C + row0];
      bo1 = bo1 + bp[w * C + row0 + 8];
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      bo0 = bo0 + __shfl_xor_sync(FULL, bo0, d);
      bo1 = bo1 + __shfl_xor_sync(FULL, bo1, d);
    }
    const float2 v0 =
        *reinterpret_cast<const float2*>(tv + row0 * G::TS + col);
    const float2 v1 =
        *reinterpret_cast<const float2*>(tv + (row0 + 8) * G::TS + col);
    float* o0 = out_rows + (long long)row0 * K + col;
    *reinterpret_cast<float2*>(o0) =
        make_float2((oi[i][0] + oa[i][0]) + bo0 * v0.x,
                    (oi[i][1] + oa[i][1]) + bo0 * v0.y);
    *reinterpret_cast<float2*>(o0 + 8 * K) =
        make_float2((oi[i][2] + oa[i][2]) + bo1 * v1.x,
                    (oi[i][3] + oa[i][3]) + bo1 * v1.y);
  }
}

// The block's (b, h, group) from blockIdx = (group, h, b): bh, the
// group's number gi over all (b, h), its first chunk c0 and its chunks nc
struct Group {
  long long bh, gi, c0;
  int head, nc;
  __device__ Group(long long s, int group) {
    head = blockIdx.y;
    bh = (long long)blockIdx.z * gridDim.y + head;
    gi = bh * gridDim.x + blockIdx.x;
    c0 = (long long)blockIdx.x * group;
    const long long n_chunks = s / C;
    nc = (int)(n_chunks - c0 < group ? n_chunks - c0 : group);
  }
};

// Pass (a): one block per (b, h, group). The group's local state L_g
// (the recurrence from zero over its chunks) to lstate, its decay D_g to
// dec. Warp w owns the 8-column block w % NCOL of S and its row blocks
// mi0.., its tiles in registers.
template <int K>
__global__ void __launch_bounds__(Cfg<K, false>::THREADS, 2)
wkv6_local_states(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ lw, float* __restrict__ lstate,
                  float* __restrict__ dec, long long s, int group) {
  using G = Cfg<K, false>;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                         // 2 x NT x TILE
  float* etot = stages + 2 * G::NT * G::TILE;   // K

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Group gr(s, group);
  const long long base = gr.bh * s * K;
  const int ncol = warp % G::NCOL;
  const int mi0 = (warp / G::NCOL) * G::MU;
  const float uu[G::CPW] = {};

  float sreg[G::MU][4] = {};
  float dprod[G::CPW];
#pragma unroll
  for (int i = 0; i < G::CPW; ++i) dprod[i] = 1.f;

  load_chunk<K, false>(stages, nullptr, k, v, lw, base + gr.c0 * C * K, tid);
  cp_async_commit();
  for (int c = 0; c < gr.nc; ++c) {
    float* stage = stages + (c & 1) * G::NT * G::TILE;
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; chunk c - 1 is done everywhere
    if (c + 1 < gr.nc) {
      load_chunk<K, false>(stages + ((c + 1) & 1) * G::NT * G::TILE,
                           nullptr, k, v, lw,
                           base + (gr.c0 + c + 1) * C * K, tid);
      cp_async_commit();
    }
    scan_chunk<K, false>(stage, nullptr, etot, uu, warp, lane);
    __syncthreads();   // k_carry, etot visible

    const float* tl = stage + G::TL * G::TILE;
    const float* tv = stage + G::TV * G::TILE;
    float acc[G::MU][4] = {};
#pragma unroll
    for (int kk = 0; kk < G::CS; ++kk) {
      uint32_t vb[2], vs[2];
      v_frag<K, false>(tv, kk, ncol, g, t, vb, vs);
      state_slice<K, false>(acc, tl, kk, mi0, g, t, vb, vs);
    }
#pragma unroll
    for (int m = 0; m < G::MU; ++m) {
      const float e0 = etot[16 * (mi0 + m) + g];
      const float e1 = etot[16 * (mi0 + m) + g + 8];
      sreg[m][0] = fmaf(e0, sreg[m][0], acc[m][0]);
      sreg[m][1] = fmaf(e0, sreg[m][1], acc[m][1]);
      sreg[m][2] = fmaf(e1, sreg[m][2], acc[m][2]);
      sreg[m][3] = fmaf(e1, sreg[m][3], acc[m][3]);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < G::CPW; ++i)
        dprod[i] = dprod[i] * etot[warp * G::CPW + i];
    }
  }

  float* dst = lstate + gr.gi * K * K;
#pragma unroll
  for (int m = 0; m < G::MU; ++m) {
    const int j0 = 16 * (mi0 + m) + g, col = 8 * ncol + 2 * t;
    *reinterpret_cast<float2*>(dst + j0 * K + col) =
        make_float2(sreg[m][0], sreg[m][1]);
    *reinterpret_cast<float2*>(dst + (j0 + 8) * K + col) =
        make_float2(sreg[m][2], sreg[m][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < G::CPW; ++i)
      dec[gr.gi * K + warp * G::CPW + i] = dprod[i];
  }
}

// Pass (c): one block per (b, h, group), from the group's entry state
// in lstate, out for its chunks. Warp w owns the 8-column block nc = w %
// NCOL of out and S; two warps share a column block and split its rows:
// out's row blocks {0, 3} or {1, 2}, S's row blocks in halves. Every B
// fragment a warp reads (S's, v's) is split once for all its row
// blocks. att is computed once a chunk, tile by tile over the warps
// (tiles warp, warp + W, ...; the warps with one more tile than the
// others compute it in a loop of its own), and shared, split, through
// shared memory.
template <int K>
__global__ void __launch_bounds__(Cfg<K, true>::THREADS, 1)
wkv6_outputs(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, float* __restrict__ out,
             const float* __restrict__ entry, long long s, int group) {
  using G = Cfg<K, true>;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                         // 2 x NT x TILE
  float* sS = stages + 2 * G::NT * G::TILE;     // K x SS
  float* attb = sS + K * G::SS;                 // C x ATS
  float* atts = attb + C * ATS;                 // C x ATS
  float* bp = atts + C * ATS;                   // W x C
  float* etot = bp + G::W * C;                  // K

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Group gr(s, group);
  const long long base = gr.bh * s * K;
  const int ncol = warp % G::NCOL;              // this warp's columns
  const int share = warp / G::NCOL;             // 0 or 1
  const int mi0 = share * G::MU;                // its S row blocks
  const int rb0 = share == 0 ? 0 : 1, rb1 = 3 - rb0;   // its out rows

  float uu[G::CPW];
#pragma unroll
  for (int i = 0; i < G::CPW; ++i)
    uu[i] = u[(long long)gr.head * K + warp * G::CPW + i];
  {
    const float* src = entry + gr.gi * K * K;
    for (int i = tid; i < K * K / 4; i += G::THREADS) {
      const int row = (4 * i) / K, col = (4 * i) % K;
      *reinterpret_cast<float4*>(sS + row * G::SS + col) =
          *reinterpret_cast<const float4*>(src + 4 * i);
    }
  }
  // this warp's att tiles: numbers warp + W j < 20 (row block rb, key
  // block kb), row by row
  int att_rb[G::SLOTS], att_kb[G::SLOTS];
#pragma unroll
  for (int j = 0; j < G::SLOTS; ++j) {
    const int n = warp + G::W * j < ATT_TILES ? warp + G::W * j : 0;
    att_rb[j] = n < 2 ? 0 : n < 6 ? 1 : n < 12 ? 2 : 3;
    att_kb[j] = n - (att_rb[j] == 0 ? 0 : att_rb[j] == 1 ? 2
                     : att_rb[j] == 2 ? 6 : 12);
  }
  const int n_slots = (ATT_TILES - warp + G::W - 1) / G::W;
  // ldmatrix: lane l reads row l % 8 (+ 8 for l / 8 odd) at column
  // offset 4 (l / 16) of a 16 x 8 A tile
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 4;

  auto chunk_at = [&](int c) { return base + (gr.c0 + c) * C * K; };
  load_chunk<K, true>(stages, r, k, v, lw, chunk_at(0), tid);
  cp_async_commit();
  for (int c = 0; c < gr.nc; ++c) {
    float* stage = stages + (c & 1) * G::NT * G::TILE;
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; chunk c - 1 is done everywhere
    if (c + 1 < gr.nc) {
      load_chunk<K, true>(stages + ((c + 1) & 1) * G::NT * G::TILE, r, k,
                          v, lw, chunk_at(c + 1), tid);
      cp_async_commit();
    }
    scan_chunk<K, true>(stage, bp, etot, uu, warp, lane);
    __syncthreads();   // q_in, kd, k_carry, etot, bp visible
    const float* tq = stage + G::TR * G::TILE;
    const float* tkd = stage + G::TK * G::TILE;
    const float* tl = stage + G::TL * G::TILE;
    const float* tv = stage + G::TV * G::TILE;

    // phase 1: this warp's att tiles and out_inter = q_in @ S on its two
    // row blocks
    float att[G::SLOTS][4] = {}, oi[2][4] = {};
    auto att_step = [&](int j, int ks) {         // att tile j, k-step ks
      const int ao = (16 * att_rb[j] + lrow) * G::TS + 8 * ks + lcol;
      uint32_t ab[4], as[4];
      q_frag(tq + ao, ab, as);
      const float* pb = tkd + (8 * att_kb[j] + g) * G::TS + 8 * ks + t;
      const float b[2] = {pb[0], pb[4]};
      uint32_t bb[2], bs[2];
      split_frag(b, bb, bs);
      mma3(att[j], ab, as, bb, bs);
    };
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks) {
      // every warp has its first SLOTS - 1 tiles; the last only some
#pragma unroll
      for (int j = 0; j < G::SLOTS - 1; ++j) att_step(j, ks);
      const float* ps = sS + (8 * ks + t) * G::SS + 8 * ncol + g;
      const float b[2] = {ps[0], ps[4 * G::SS]};
      uint32_t bb[2], bs[2];
      split_frag(b, bb, bs);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ao = (16 * (i == 0 ? rb0 : rb1) + lrow) * G::TS + 8 * ks +
                       lcol;
        uint32_t ab[4], as[4];
        q_frag(tq + ao, ab, as);
        mma3(oi[i], ab, as, bb, bs);
      }
    }
    if (n_slots == G::SLOTS) {
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks) att_step(G::SLOTS - 1, ks);
    }
    // the strict lower triangle, split, into shared memory
#pragma unroll
    for (int j = 0; j < G::SLOTS; ++j) {
      if (j < n_slots) {
        const int row = 16 * att_rb[j] + g, key = 8 * att_kb[j] + 2 * t;
        const float a[4] = {key < row ? att[j][0] : 0.f,
                            key + 1 < row ? att[j][1] : 0.f,
                            key < row + 8 ? att[j][2] : 0.f,
                            key + 1 < row + 8 ? att[j][3] : 0.f};
        uint32_t hb[4], hs[4];
        split_frag(a, hb, hs);
        *reinterpret_cast<uint2*>(attb + row * ATS + key) =
            make_uint2(hb[0], hb[1]);
        *reinterpret_cast<uint2*>(atts + row * ATS + key) =
            make_uint2(hs[0], hs[1]);
        *reinterpret_cast<uint2*>(attb + (row + 8) * ATS + key) =
            make_uint2(hb[2], hb[3]);
        *reinterpret_cast<uint2*>(atts + (row + 8) * ATS + key) =
            make_uint2(hs[2], hs[3]);
      }
    }
    __syncthreads();   // att visible; S is read no more this chunk

    // phase 2: out_intra = att @ v, out and the state update's product
    // (also after the group's last chunk, whose S no output reads: a
    // branch there costs more than the products)
    float acc[G::MU][4] = {};
    float* out_rows = out + chunk_at(c);
    if (share == 0)
      out_and_state<K, 0, 3>(oi, acc, tl, tv, attb, atts, bp, out_rows,
                             ncol, mi0, g, t);
    else
      out_and_state<K, 1, 2>(oi, acc, tl, tv, attb, atts, bp, out_rows,
                             ncol, mi0, g, t);
    // S = exp(total) * S + k_carry^T @ v on this warp's tiles, in place
    // (every read of S this chunk was before the last barrier)
#pragma unroll
    for (int m = 0; m < G::MU; ++m) {
      const int j0 = 16 * (mi0 + m) + g, col = 8 * ncol + 2 * t;
      const float e0 = etot[j0], e1 = etot[j0 + 8];
      float2* p0 = reinterpret_cast<float2*>(sS + j0 * G::SS + col);
      float2* p1 = reinterpret_cast<float2*>(sS + (j0 + 8) * G::SS + col);
      const float2 s0 = *p0, s1 = *p1;
      *p0 = make_float2(fmaf(e0, s0.x, acc[m][0]), fmaf(e0, s0.y, acc[m][1]));
      *p1 = make_float2(fmaf(e1, s1.x, acc[m][2]), fmaf(e1, s1.y, acc[m][3]));
    }
  }
}

// Pass (b): one thread per (b, h, row j, column), in order over the
// groups: the entry state S_g replaces L_g, S_{g+1} = D_g * S_g + L_g;
// the last is the final state.
template <int K>
__global__ void __launch_bounds__(SCAN_THREADS)
wkv6_group_scan(float* __restrict__ lstate, const float* __restrict__ dec,
                float* __restrict__ state_out, long long n, int n_groups) {
  const long long i = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / (K * K);
  const int jv = (int)(i % (K * K)), j = jv / K;
  float* p = lstate + bh * n_groups * K * K + jv;
  const float* d = dec + bh * n_groups * K + j;
  float cur = 0.f;
  for (int gi = 0; gi < n_groups; ++gi) {
    const float l = p[(long long)gi * K * K];
    p[(long long)gi * K * K] = cur;
    cur = fmaf(d[(long long)gi * K], cur, l);
  }
  state_out[bh * K * K + jv] = cur;
}

template <int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* out, void* state,
                   void* lstate, void* dec, long long b, int h, long long s,
                   int group, cudaStream_t stream) {
  using GA = Cfg<K, false>;
  using GC = Cfg<K, true>;
  const long long n_chunks = s / C;
  const long long n_groups = (n_chunks + group - 1) / group;
  if (n_groups > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_local_states<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GA::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_outputs<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GC::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_groups, (unsigned)h, (unsigned)b);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* lf = static_cast<const float*>(lw);
  float* ls = static_cast<float*>(lstate);
  float* dc = static_cast<float*>(dec);
  wkv6_local_states<K><<<grid, GA::THREADS, GA::SMEM, stream>>>(
      kf, vf, lf, ls, dc, s, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = b * h * K * K;
  wkv6_group_scan<K><<<(unsigned)((n + SCAN_THREADS - 1) / SCAN_THREADS),
                       SCAN_THREADS, 0, stream>>>(
      ls, dc, static_cast<float*>(state), n, (int)n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_outputs<K><<<grid, GC::THREADS, GC::SMEM, stream>>>(
      rf, kf, vf, lf, static_cast<const float*>(u), static_cast<float*>(out),
      ls, s, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors fp32, contiguous, 16-byte aligned; lstate holds B * H *
// groups * K * K floats and dec B * H * groups * K, groups = ceil(S / (C
// * group)). Returns the first failing launch's cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* lw,
             const void* u, void* out, void* state, void* lstate, void* dec,
             long long b, int h, long long s, int dk, int group,
             void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || s % C != 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 32:
      return (int)launch<32>(r, k, v, lw, u, out, state, lstate, dec, b, h,
                             s, group, st);
    case 64:
      return (int)launch<64>(r, k, v, lw, u, out, state, lstate, dec, b, h,
                             s, group, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
