// The rate mma.sync reaches on the card, the ceiling of a kernel built
// on it (K6, src/repro_torch/csrc/flash_attn.cu): tf32 m16n8k8 and bf16
// m16n8k16 with fp32 accumulation, 8 warps a block, two blocks an SM,
// 8 independent accumulators a warp, no memory traffic.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/mma_sync_rate tools/mma_sync_rate.cu
//   build/mma_sync_rate
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <bool TF32>
__global__ void __launch_bounds__(256) rate(float* out, int iters,
                                            uint32_t seed) {
  float c[8][4] = {};
  const uint32_t a0 = seed, a1 = seed * 3u, a2 = seed * 5u, a3 = seed * 7u;
  const uint32_t b0 = seed ^ 11u, b1 = seed ^ 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = 2 * sms, iters = 20000;
  float* out = nullptr;
  cudaMalloc(&out, (size_t)blocks * 256 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int tf32 = 1; tf32 >= 0; --tf32) {
    float ms = 0.f;
    for (int rep = 0; rep < 2; ++rep) {   // the first is a warm-up
      cudaEventRecord(e0);
      if (tf32)
        rate<true><<<blocks, 256>>>(out, iters, 1u);
      else
        rate<false><<<blocks, 256>>>(out, iters, 1u);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
    }
    const double flops = (double)blocks * 8 * iters * 8 * 2 * 16 * 8 *
                         (tf32 ? 8 : 16);
    printf("{\"mma\": \"%s\", \"tflop_per_s\": %.1f, \"sms\": %d}\n",
           tf32 ? "tf32 m16n8k8" : "bf16 m16n8k16", flops / ms / 1e9, sms);
  }
  if (cudaGetLastError() != cudaSuccess) return 1;
  return 0;
}
