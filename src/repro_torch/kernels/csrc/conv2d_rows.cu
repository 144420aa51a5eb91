// Row-block convolution as a pipelined implicit GEMM for Hopper (sm_90a),
// fp32, NHWC x HWIO -> NHWC.
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
// 13 such convs.  The tensor cores are not used: TF32 would break the 1e-4
// fp32 parity the port is held to, so the ceiling is the SIMT fp32 pipe,
// and the design keeps that pipe fed.
//
// Design: an implicit GEMM over the row-centric tiling.  M = the CTA's
// output pixels, N = output channels, K = k*k*Cin.
// * One CTA owns BLOCK_H output rows (the plan's block_h, the OverL row
//   block) x TILE_W output columns (BLOCK_H * TILE_W <= 128 pixels) x CO
//   output channels of one image: CO = 128, or 64 when Cout <= 64 (the
//   224^2 VGG layers), so that no half of the CTA computes zeros.  Grid:
//   (row blocks * column tiles, ceil(Cout / CO), batch).
// * Each thread accumulates 8 pixels x 8 output channels (two groups of 4,
//   CO/2 apart); a warp is 4 pixel groups x 8 channel groups, so its
//   weight reads are 8 contiguous float4s and its input reads 4
//   neighbouring pixels, one shared-memory wavefront each.  Per 4 input
//   channels a thread reads 4 pixels at a time as float4s over the
//   channels and the weights as float4s over Cout: 24 LDS.128 feed 256
//   FMAs.
// * No padded copy of x and no dual-block fetch: the CTA loads its own
//   halo'd input window, (BLOCK_H - 1) * s + k rows by (TILE_W - 1) * s + k
//   columns, one chunk of CC input channels at a time (CC = 8, or 4 where
//   8 would not fit a CTA's 227 KiB: large k), beside the chunk's
//   weights, k*k*CC*CO.  The chunks stream through a 2-stage cp.async ring
//   with one __syncthreads per chunk, so the copy of chunk c + 1 runs under
//   the FMAs of chunk c.  Copies are 16 bytes where channels are 4-aligned
//   and 4 bytes otherwise (Cin = 3); padding and out-of-range rows, columns,
//   channels and Cout are zero-filled by the copy (src-size 0).
// * Each window pixel's global offset (or -1 outside the image) is
//   computed once per CTA into shared memory, so the copy loops do no
//   div/mod per element: each thread copies a fixed channel quad (or
//   channel) of every n-th window pixel and a fixed 16-byte column of every
//   n-th weight row, in loops kept rolled so that the copies hold few
//   registers beside the accumulators.
// * Registers: the kernel takes 168 a thread with no spills, so one
//   256-thread CTA (8 warps) runs per SM at CO = 128 and three 128-thread
//   CTAs at CO = 64.  Capped at 128 (two CTAs per SM) every build spilled
//   in the copy code and ran the VGG-16 forward slower, so
//   __launch_bounds__ asks for one CTA per SM.
// * Ragged edges (H_out % BLOCK_H, W_out % TILE_W, Cout % CO) are masked
//   at the store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 128;    // output pixels per CTA (block_h x tile_w)
constexpr int kTm = 8;       // pixels per thread
constexpr int kTn = 8;       // output channels per thread
constexpr int kStages = 2;
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int in_rows(int k, int s, int block_h) {
  return (block_h - 1) * s + k;
}

__host__ __device__ inline int in_cols(int k, int s, int tile_w) {
  return (tile_w - 1) * s + k;
}

int co_tile(int cout) { return cout <= 64 ? 64 : 128; }

// offset table + kStages x (input window + weights) of one Cin chunk
size_t smem_for(int k, int s, int block_h, int tile_w, int co, int cc) {
  const size_t px = (size_t)in_rows(k, s, block_h) * in_cols(k, s, tile_w);
  return sizeof(float) * (px + kStages * (px * cc + (size_t)k * k * cc * co));
}

int cin_chunk(int k, int s, int block_h, int tile_w, int co) {
  return smem_for(k, s, block_h, tile_w, co, 8) <= kSmemLimit ? 8 : 4;
}

size_t smem_bytes(int k, int s, int block_h, int tile_w, int cout) {
  const int co = co_tile(cout);
  return smem_for(k, s, block_h, tile_w, co, cin_chunk(k, s, block_h, tile_w, co));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// global -> shared copies; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct ConvArgs {
  const float* x;
  const float* w;
  float* y;
  int H, W, Cin, Cout, H_out, W_out, k, s, p, block_h, tile_w, n_wt;
  bool vec_x, vec_w, vec_y;  // 16-byte copies / stores allowed
};

template <int CO, int CC>
__global__ void __launch_bounds__(kPix * CO / (kTm * kTn), 1)
conv2d_rows_kernel(const ConvArgs a) {
  constexpr int kThreads = kPix * CO / (kTm * kTn);  // 256 or 128
  constexpr int kTx = CO / kTn;                      // output-channel groups
  constexpr int kQ = CC / 4;                         // channel quads per chunk
  extern __shared__ float4 smem4[];
  const int k = a.k, s = a.s;
  const int rows = in_rows(k, s, a.block_h);
  const int cols = in_cols(k, s, a.tile_w);
  const int n_px = rows * cols;
  const int w_stage = k * k * CC * CO;
  const int x_stage = n_px * CC;
  float* ws = reinterpret_cast<float*>(smem4);  // [kStages][k*k][CC][CO]
  float* xs = ws + kStages * w_stage;           // [kStages][rows][cols][CC]
  int* offs = reinterpret_cast<int*>(xs + kStages * x_stage);  // [rows][cols]

  const int oh0 = (blockIdx.x / a.n_wt) * a.block_h;
  const int ow0 = (blockIdx.x % a.n_wt) * a.tile_w;
  const int co0 = blockIdx.y * CO;
  const int b = blockIdx.z;
  const int ih0 = oh0 * s - a.p;
  const int iw0 = ow0 * s - a.p;
  const int tid = threadIdx.x;
  // a warp is 4 pixel groups x 8 channel groups: its weight reads are 8
  // contiguous float4s (one wavefront), its input reads 4 neighbours
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = (lane & 7) + 8 * (warp % (kTx / 8));  // channels co0 + tx*4
                                                       // + {0..3} and + CO/2
  const int ty = (lane >> 3) + 4 * (warp / (kTx / 8));  // pixels ty + 16m
  const int n_pix = a.block_h * a.tile_w;
  const int Cin = a.Cin, Cout = a.Cout;
  const float* xb = a.x + (size_t)b * a.H * a.W * Cin;

#pragma unroll 1
  for (int i = tid; i < n_px; i += kThreads) {
    const int h = ih0 + i / cols;
    const int wc = iw0 + i % cols;
    offs[i] = (h >= 0 && h < a.H && wc >= 0 && wc < a.W) ? (h * a.W + wc) * Cin : -1;
  }
  __syncthreads();

  // The copy loops stay rolled and walk with per-thread constants (which
  // quad / channel / Cout chunk a thread copies), so the copy of the next
  // chunk holds few registers beside the accumulators.
  auto load_chunk = [&](int c0, int buf) {
    float* xd = xs + buf * x_stage;
    if (a.vec_x) {
      const int q = tid % kQ;  // this thread's channel quad of each pixel
      const bool ch_ok = c0 + 4 * q < Cin;
#pragma unroll 1
      for (int px = tid / kQ; px < n_px; px += kThreads / kQ) {
        const int off = offs[px];
        const bool ok = ch_ok && off >= 0;
        cp_async16(smem_addr(xd + px * CC + 4 * q), ok ? xb + off + c0 + 4 * q : xb, ok ? 16 : 0);
      }
    } else {
      const int ch = tid % CC;  // kThreads is a multiple of CC
      const bool ch_ok = c0 + ch < Cin;
#pragma unroll 1
      for (int px = tid / CC; px < n_px; px += kThreads / CC) {
        const int off = offs[px];
        const bool ok = ch_ok && off >= 0;
        cp_async4(smem_addr(xd + px * CC + ch), ok ? xb + off + c0 + ch : xb, ok ? 4 : 0);
      }
    }
    // weight rows (ki*k + kj, ci) of CO floats: this thread copies one
    // 16-byte column j of every kStep-th row
    float* wd = ws + buf * w_stage;
    const int n_rows = k * k * CC;
    if (a.vec_w) {
      constexpr int kRowQ = CO / 4;  // 16-byte chunks per weight row
      constexpr int kStep = kThreads / kRowQ;
      const int j = tid % kRowQ;
      const int co = co0 + 4 * j;
#pragma unroll 1
      for (int row = tid / kRowQ; row < n_rows; row += kStep) {
        const int kk = row / CC, ci = row % CC;
        const bool ok = c0 + ci < Cin && co < Cout;
        const float* src = a.w + ((size_t)kk * Cin + c0 + ci) * Cout + co;
        cp_async16(smem_addr(wd + row * CO + 4 * j), ok ? src : a.w, ok ? 16 : 0);
      }
    } else {
      constexpr int kStep = kThreads / CO;
      const int j = tid % CO;
      const int co = co0 + j;
#pragma unroll 1
      for (int row = tid / CO; row < n_rows; row += kStep) {
        const int kk = row / CC, ci = row % CC;
        const bool ok = c0 + ci < Cin && co < Cout;
        const float* src = a.w + ((size_t)kk * Cin + c0 + ci) * Cout + co;
        cp_async4(smem_addr(wd + row * CO + j), ok ? src : a.w, ok ? 4 : 0);
      }
    }
  };

  int xoff[kTm];
#pragma unroll
  for (int m = 0; m < kTm; ++m) {
    const int pix = ty + 16 * m;
    const int pr = pix < n_pix ? pix / a.tile_w : 0;
    const int pc = pix < n_pix ? pix % a.tile_w : 0;
    xoff[m] = (pr * s * cols + pc * s) * CC;
  }

  float acc[kTm][kTn];
#pragma unroll
  for (int m = 0; m < kTm; ++m)
#pragma unroll
    for (int n = 0; n < kTn; ++n) acc[m][n] = 0.f;

  const int n_chunks = (Cin + CC - 1) / CC;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1 is consumed
    if (c + 1 < n_chunks) load_chunk((c + 1) * CC, (c + 1) & 1);
    cp_async_commit();
    const float* xsb = xs + (c & 1) * x_stage;
    const float* wsb = ws + (c & 1) * w_stage + tx * 4;
    for (int ki = 0; ki < k; ++ki) {
      for (int kj = 0; kj < k; ++kj) {
        const float* xk = xsb + (ki * cols + kj) * CC;
        const float* wk = wsb + (ki * k + kj) * CC * CO;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          // half of the pixels at a time keeps registers at 2 CTAs per SM
#pragma unroll
          for (int mh = 0; mh < kTm; mh += 4) {
            float4 xv[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
              xv[m] = *reinterpret_cast<const float4*>(xk + xoff[mh + m] + 4 * q);
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) {
              const float4 w0 = *reinterpret_cast<const float4*>(wk + (4 * q + ci) * CO);
              const float4 w1 = *reinterpret_cast<const float4*>(wk + (4 * q + ci) * CO + CO / 2);
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const float xm = lane4(xv[m], ci);
                acc[mh + m][0] = fmaf(xm, w0.x, acc[mh + m][0]);
                acc[mh + m][1] = fmaf(xm, w0.y, acc[mh + m][1]);
                acc[mh + m][2] = fmaf(xm, w0.z, acc[mh + m][2]);
                acc[mh + m][3] = fmaf(xm, w0.w, acc[mh + m][3]);
                acc[mh + m][4] = fmaf(xm, w1.x, acc[mh + m][4]);
                acc[mh + m][5] = fmaf(xm, w1.y, acc[mh + m][5]);
                acc[mh + m][6] = fmaf(xm, w1.z, acc[mh + m][6]);
                acc[mh + m][7] = fmaf(xm, w1.w, acc[mh + m][7]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int m = 0; m < kTm; ++m) {
    const int pix = ty + 16 * m;
    if (pix >= n_pix) continue;
    const int oh = oh0 + pix / a.tile_w;
    const int ow = ow0 + pix % a.tile_w;
    if (oh >= a.H_out || ow >= a.W_out) continue;
    float* yp = a.y + (((size_t)b * a.H_out + oh) * a.W_out + ow) * Cout;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + half * (CO / 2) + tx * 4;
      const float v0 = acc[m][4 * half], v1 = acc[m][4 * half + 1];
      const float v2 = acc[m][4 * half + 2], v3 = acc[m][4 * half + 3];
      if (a.vec_y) {
        if (co < Cout) *reinterpret_cast<float4*>(yp + co) = make_float4(v0, v1, v2, v3);
      } else {
        if (co < Cout) yp[co] = v0;
        if (co + 1 < Cout) yp[co + 1] = v1;
        if (co + 2 < Cout) yp[co + 2] = v2;
        if (co + 3 < Cout) yp[co + 3] = v3;
      }
    }
  }
}

template <int CO, int CC>
int launch_t(const ConvArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(conv2d_rows_kernel<CO, CC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv2d_rows_kernel<CO, CC><<<grid, kPix * CO / (kTm * kTn), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA takes; the planner prices the same formula
// (repro_torch/kernels/conv2d_rows.py::smem_bytes).
long long conv2d_rows_smem_bytes(int k, int s, int block_h, int tile_w, int cout) {
  return (long long)smem_bytes(k, s, block_h, tile_w, cout);
}

const char* conv2d_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int conv2d_rows_launch(const float* x, const float* w, float* y, int B, int H,
                       int W, int Cin, int Cout, int H_out, int W_out, int k,
                       int s, int p, int block_h, int tile_w, void* stream) {
  if (block_h < 1 || tile_w < 1 || block_h * tile_w > kPix || B < 1 ||
      B > 65535 || k < 1 || s < 1 || p < 0 || Cin < 1 || Cout < 1 ||
      (long long)H * W * Cin >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int co = co_tile(Cout);
  const int cc = cin_chunk(k, s, block_h, tile_w, co);
  const size_t smem = smem_for(k, s, block_h, tile_w, co, cc);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.y = y;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.H_out = H_out;
  a.W_out = W_out;
  a.k = k;
  a.s = s;
  a.p = p;
  a.block_h = block_h;
  a.tile_w = tile_w;
  a.n_wt = (W_out + tile_w - 1) / tile_w;
  a.vec_x = Cin % 4 == 0 && (uintptr_t)x % 16 == 0;
  a.vec_w = Cout % 4 == 0 && (uintptr_t)w % 16 == 0;
  a.vec_y = Cout % 4 == 0 && (uintptr_t)y % 16 == 0;
  const int n_hb = (H_out + block_h - 1) / block_h;
  dim3 grid(n_hb * a.n_wt, (Cout + co - 1) / co, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (co == 64)
    return cc == 8 ? launch_t<64, 8>(a, grid, smem, st) : launch_t<64, 4>(a, grid, smem, st);
  return cc == 8 ? launch_t<128, 8>(a, grid, smem, st) : launch_t<128, 4>(a, grid, smem, st);
}

}  // extern "C"
