// Mamba2 SSD recurrence for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/ssd_chunk.py::ssd_scan, the Pallas TPU kernel
// (body _ssd_kernel), and computes what it computes:
//
//   h_t = a_t h_{t-1} + dt_t x_t (outer) B_t ,   y_t = C_t . h_t
//
// with x (Bt, S, H, P), B and C (Bt, S, N), a and dt (Bt, S, H), y like x,
// all contiguous fp32, h_0 = 0.  The TPU kernel walks chunks of the sequence
// in order and keeps h (H, P, N) in VMEM scratch, doing the intra-chunk part
// as (c, c) decay-times-Gram products on the MXU.  On Hopper nothing carries
// between blocks, and each (b, h, p) row of the state evolves on its own, so
// this kernel runs the recurrence itself, step by step, with the state in
// registers.  The wrapper is repro_torch/kernels/ssd_chunk.py.
//
// What bounds it on the card: operations.  At Zamba2-7B's Mamba2 widths
// (H = 32, P = 224, N = 64, S = 4096) a call does ~5 FLOP per (t, h, p, n),
// 9.4 GFLOP in fp32 SIMT (the recurrence is no matrix product), on 237 MB of
// inputs and output: ~40 FLOP/byte, above the fp32 ridge (~20).
//
// Design:
// * G lanes share one (b, h, p) row: G is the largest power of two <= 8
//   dividing N, and lane g of the group owns n = g + G*i (i < N/G <= 16), so
//   the group reads B_t and C_t as consecutive words.  A warp holds 32/G rows
//   of one (b, h); a CTA of 4 warps holds 4*32/G rows.  Grid:
//   (ceil(P / rows per CTA), H, Bt).
// * Per step each lane updates its N/G state values (one FMA chain each,
//   independent of the loads, which the unrolled loop issues ahead) and
//   y_t[p] = sum_n C_t[n] h[n] is reduced over the G lanes with shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 16;
constexpr int kMaxGroup = 8;

int group_lanes(int N) {
  int g = kMaxGroup;
  while (N % g) g /= 2;
  return g;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ a,
                const float* __restrict__ dt, float* __restrict__ y, int S, int H,
                int P, int N, int G) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rows_per_warp = 32 / G;
  const int p = (blockIdx.x * kWarps + warp) * rows_per_warp + lane / G;
  const int g = lane % G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int npl = N / G;
  const bool live = p < P;

  const size_t HP = (size_t)H * P;
  const float* xp = x + (size_t)b * S * HP + (size_t)h * P + (live ? p : 0);
  float* yp = y + (size_t)b * S * HP + (size_t)h * P + (live ? p : 0);
  const float* Bp = B + (size_t)b * S * N + g;
  const float* Cp = C + (size_t)b * S * N + g;
  const float* ap = a + (size_t)b * S * H + h;
  const float* dtp = dt + (size_t)b * S * H + h;

  float st[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) st[i] = 0.f;

#pragma unroll 2
  for (int t = 0; t < S; ++t) {
    const float at = ap[(size_t)t * H];
    const float xd = (live ? xp[(size_t)t * HP] : 0.f) * dtp[(size_t)t * H];
    const float* Bt = Bp + (size_t)t * N;
    const float* Ct = Cp + (size_t)t * N;
    float yv = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (i < npl) {
        st[i] = fmaf(at, st[i], xd * Bt[G * i]);
        yv = fmaf(Ct[G * i], st[i], yv);
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
    if (live && g == 0) yp[(size_t)t * HP] = yv;
  }
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Lanes that share one state row for state size N (the wrapper mirrors it).
int ssd_scan_group_lanes(int N) { return group_lanes(N); }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int ssd_scan_launch(const float* x, const float* B, const float* C, const float* a,
                    const float* dt, float* y, int Bt, int S, int H, int P, int N,
                    void* stream) {
  if (Bt < 1 || Bt > 65535 || S < 1 || H < 1 || H > 65535 || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int G = group_lanes(N);
  if (N / G > kMaxPerLane) return (int)cudaErrorInvalidValue;
  const int rows_per_cta = kWarps * (32 / G);
  dim3 grid((P + rows_per_cta - 1) / rows_per_cta, H, Bt);
  ssd_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, B, C, a, dt, y, S, H, P,
                                                               N, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
