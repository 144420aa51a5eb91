// The rate of mma.sync.m16n8k8 TF32 on this card: the ceiling of the
// products ssd_scan.cu issues.  Each warp runs 8 independent accumulators
// through `iters` rounds; one CTA of 4 * warps_per_smsp warps per SM.
// Built and run by repro_torch/kernels/probe.py; no path of the port uses it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mma_tf32_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int mma_tf32_probe_launch(float* out, int sms, int warps_per_smsp, int iters,
                                     void* stream) {
  mma_tf32_loop<<<sms, 128 * warps_per_smsp, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
