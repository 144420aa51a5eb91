// Row-block direct convolution for Hopper (sm_90a), fp32, NHWC x HWIO -> NHWC.
//
// Replaces src/repro/kernels/conv2d_rows.py::conv2d_rows, the Pallas TPU
// kernel (body _conv_kernel), and computes exactly what it computes:
//
//   y[b, i, j, co] = sum_{ki, kj, ci} xpad[b, i*s + ki, j*s + kj, ci] * w[ki, kj, ci, co]
//
// where xpad is x zero-padded by p on both sides of H and W, accumulated in
// fp32.  The wrapper is repro_torch/kernels/conv2d_rows.py; bias stays
// outside the kernel, as in the reference engine.
//
// What bounds it on the card: operations.  A 3x3 conv does 2*9*Cin FLOPs
// per output element and moves (Cin + Cout) * 4 bytes per pixel, so every
// VGG-16 layer sits far above the fp32 ridge (67 TFLOP/s over 3.35 TB/s,
// ~20 FLOP/byte): a VGG-16/224 forward at batch 32 is ~0.98 TFLOP through
// 13 such convs.  The tensor cores are not used: TF32 would break the 1e-5
// fp32 parity the port is held to, so the ceiling is the SIMT fp32 pipe.
//
// Design, and what it does about that bound:
// * One CTA owns BLOCK_H output rows (the plan's block_h) x TILE_W output
//   columns (BLOCK_H * TILE_W <= 128 pixels) x 64 output channels of one
//   image.  Grid: (row blocks * column tiles, ceil(Cout / 64), batch).
// * There is no dual-block fetch and no padded copy of x: the CTA loads its
//   own halo'd input window, (BLOCK_H - 1) * s + k rows by
//   (TILE_W - 1) * s + k columns, for a chunk of 8 input channels into
//   shared memory.  Out-of-range rows, columns and channels are stored as
//   zeros, which is the zero padding (and covers Cin = 3).  The same
//   chunk's weights, k * k * 8 * 64, sit beside it.  Chunking Cin keeps the
//   working set at tens of KiB where the TPU kernel held a whole W x Cin
//   row block in VMEM.
// * 256 threads; each accumulates 8 pixels x 4 output channels in
//   registers, so every shared-memory load of an input value feeds 4 FMAs
//   and every (float4) weight load feeds 32.
// * Ragged edges (H_out % BLOCK_H, W_out % TILE_W, Cout % 64) are masked
//   at the store.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;  // output pixels per CTA (block_h x tile_w)
constexpr int kCo = 64;    // output channels per CTA
constexpr int kCc = 8;     // input channels per shared-memory chunk
constexpr int kTm = 8;     // pixels per thread
constexpr int kTn = 4;     // output channels per thread

__host__ __device__ inline int in_rows(int k, int s, int block_h) {
  return (block_h - 1) * s + k;
}

__host__ __device__ inline int in_cols(int k, int s, int tile_w) {
  return (tile_w - 1) * s + k;
}

size_t smem_bytes(int k, int s, int block_h, int tile_w) {
  return sizeof(float) * ((size_t)in_rows(k, s, block_h) * in_cols(k, s, tile_w) * kCc +
                          (size_t)k * k * kCc * kCo);
}

__global__ void __launch_bounds__(kThreads)
conv2d_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int H, int W, int Cin, int Cout,
                   int H_out, int W_out, int k, int s, int p, int block_h,
                   int tile_w, int n_wt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = in_rows(k, s, block_h);
  const int cols = in_cols(k, s, tile_w);
  float* xs = smem;                     // [rows][cols][kCc]
  float* ws = smem + rows * cols * kCc; // [k*k][kCc][kCo]

  const int oh0 = (blockIdx.x / n_wt) * block_h;
  const int ow0 = (blockIdx.x % n_wt) * tile_w;
  const int co0 = blockIdx.y * kCo;
  const int b = blockIdx.z;
  const int ih0 = oh0 * s - p;
  const int iw0 = ow0 * s - p;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output-channel group: channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // pixel group: pixels ty, ty+16, ..., ty+112
  const int n_pix = block_h * tile_w;

  int xoff[kTm];
#pragma unroll
  for (int m = 0; m < kTm; ++m) {
    const int pix = ty + 16 * m;
    const int pr = pix < n_pix ? pix / tile_w : 0;
    const int pc = pix < n_pix ? pix % tile_w : 0;
    xoff[m] = (pr * s * cols + pc * s) * kCc;
  }

  float acc[kTm][kTn];
#pragma unroll
  for (int m = 0; m < kTm; ++m)
#pragma unroll
    for (int n = 0; n < kTn; ++n) acc[m][n] = 0.f;

  const float* xb = x + (size_t)b * H * W * Cin;
  const int n_x = rows * cols * kCc;
  const int n_w = k * k * kCc * kCo;
  for (int c0 = 0; c0 < Cin; c0 += kCc) {
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < n_x; i += kThreads) {
      const int ci = i % kCc;
      const int rc = i / kCc;
      const int h = ih0 + rc / cols;
      const int wc = iw0 + rc % cols;
      const int c = c0 + ci;
      float v = 0.f;
      if (h >= 0 && h < H && wc >= 0 && wc < W && c < Cin)
        v = xb[((size_t)h * W + wc) * Cin + c];
      xs[i] = v;
    }
    for (int i = tid; i < n_w; i += kThreads) {
      const int co = i % kCo;
      const int r = i / kCo;
      const int c = c0 + r % kCc;
      const int kk = r / kCc;  // ki * k + kj
      const int o = co0 + co;
      float v = 0.f;
      if (c < Cin && o < Cout) v = w[((size_t)kk * Cin + c) * Cout + o];
      ws[i] = v;
    }
    __syncthreads();
    for (int ki = 0; ki < k; ++ki) {
      for (int kj = 0; kj < k; ++kj) {
        const float* xk = xs + (ki * cols + kj) * kCc;
        const float* wk = ws + (ki * k + kj) * kCc * kCo + tx * kTn;
#pragma unroll
        for (int ci = 0; ci < kCc; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wk + ci * kCo);
#pragma unroll
          for (int m = 0; m < kTm; ++m) {
            const float xv = xk[xoff[m] + ci];
            acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
            acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
            acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
            acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kTm; ++m) {
    const int pix = ty + 16 * m;
    if (pix >= n_pix) continue;
    const int oh = oh0 + pix / tile_w;
    const int ow = ow0 + pix % tile_w;
    if (oh >= H_out || ow >= W_out) continue;
    float* yp = y + (((size_t)b * H_out + oh) * W_out + ow) * Cout;
#pragma unroll
    for (int n = 0; n < kTn; ++n) {
      const int co = co0 + tx * kTn + n;
      if (co < Cout) yp[co] = acc[m][n];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA takes; the planner prices the same formula
// (repro_torch/kernels/conv2d_rows.py::smem_bytes).
long long conv2d_rows_smem_bytes(int k, int s, int block_h, int tile_w) {
  return (long long)smem_bytes(k, s, block_h, tile_w);
}

const char* conv2d_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int conv2d_rows_launch(const float* x, const float* w, float* y, int B, int H,
                       int W, int Cin, int Cout, int H_out, int W_out, int k,
                       int s, int p, int block_h, int tile_w, void* stream) {
  if (block_h < 1 || tile_w < 1 || block_h * tile_w > kPix || B < 1 ||
      B > 65535 || k < 1 || s < 1 || p < 0 || Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  const int n_hb = (H_out + block_h - 1) / block_h;
  const int n_wt = (W_out + tile_w - 1) / tile_w;
  const size_t smem = smem_bytes(k, s, block_h, tile_w);
  cudaError_t e = cudaFuncSetAttribute(
      conv2d_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_hb * n_wt, (Cout + kCo - 1) / kCo, B);
  conv2d_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, y, H, W, Cin, Cout, H_out, W_out, k, s, p, block_h, tile_w, n_wt);
  return (int)cudaGetLastError();
}

}  // extern "C"
