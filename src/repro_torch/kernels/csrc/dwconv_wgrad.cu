// Weight and bias gradient of a depthwise convolution (groups = channels)
// for Hopper (sm_90a), fp32, stride 1, an odd square kernel K <= 7:
//
//   dw[ky, kx, c] = sum_{n, oy, ox} g[n, oy, ox, c] * x[n, oy + ky - ph, ox + kx - pw, c]
//   db[c]         = sum_{n, oy, ox} g[n, oy, ox, c]
//
// with x zero outside [0, H) x [0, W).  x and g are NHWC: channel stride 1,
// column stride C, and the image and row strides given, so a row slice of
// a larger map is read in place.  dw is written as the storage of the
// HWIO (K, K, 1, C) parameter, db as (C).  The wrapper is
// repro_torch/kernels/dwconv_wgrad.py.
//
// Replaces no TPU kernel: the JAX package has no depthwise convolution.  It
// exists because cuDNN serves this gradient, for fp32 NHWC with TF32 off,
// with a grouped direct kernel about 350x slower than its byte bound at
// ConvNeXt's shapes (half of a ConvNeXt-B training step at 384^2).
//
// What bounds it on the card: bytes, nearly.  Each output element costs 2
// K^2 FLOPs (98 at K = 7) against two 4-byte reads, ~12 FLOP a byte, just
// under the fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20).  The design reads
// x and g from HBM once and reuses every read from registers:
// * A lane owns one channel (a warp 32 consecutive channels, so every load
//   is one 128-byte line) and all K^2 + 1 sums of it, for two output rows
//   at a time.  Along the row it slides a register window of K + 1 input
//   rows x K columns: each step loads one new input column (K + 1 values)
//   and the two rows' g, then does 2 K^2 FMAs.  The window is a ring whose
//   slots are fixed at compile time by unrolling the column loop K times;
//   columns past the output's end read zeros.
// * A CTA is 4 warps on 4 consecutive row pairs, so the 6 halo rows that
//   neighbouring warps share come from L1.  The CTAs along y split the
//   N * ceil(Ho / 2) row pairs into contiguous runs, sized so that the grid
//   is about two waves of the card: every lane sums a few thousand terms
//   at most, in order.
// * No float atomics: each CTA adds its warps' sums in a fixed order and
//   writes one partial per channel and tap to a scratch buffer; a second
//   kernel adds the partials in a fixed order.  Two launches on the same
//   inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // row pairs a CTA works on at once
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 2;       // output rows of a warp at a time
constexpr int kMinBlocks = 3;  // CTAs an SM holds (at most 170 registers)
constexpr int kWaves = 2;      // the grid's size in full waves of the card
constexpr int kFinishThreads = 256;

struct Args {
  const float* x;
  const float* g;
  float* part;
  long long sxn, sgn;  // image strides (elements)
  int sxh, sgh;        // row strides (elements)
  int C, H, W, Ho, Wo, ph, pw;
  int pairs_per_image;  // ceil(Ho / kRows)
  long long pairs;      // N * pairs_per_image
  long long units;      // ceil(pairs / kWarps): CTA-wide steps
  int parts;            // CTAs along y, one partial each
};

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dwconv_wgrad_partial(Args a) {
  constexpr int kTaps = K * K + 1;
  constexpr int kWinRows = K + kRows - 1;
  __shared__ float red[kWarps][kTaps][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool c_ok = c < a.C;
  const int p = blockIdx.y;
  const long long u_begin = a.units * p / a.parts;
  const long long u_end = a.units * (p + 1) / a.parts;

  float acc[K][K];
#pragma unroll
  for (int ky = 0; ky < K; ++ky)
#pragma unroll
    for (int kx = 0; kx < K; ++kx) acc[ky][kx] = 0.f;
  float acc_b = 0.f;

  for (long long u = u_begin; u < u_end; ++u) {
    const long long q = u * kWarps + warp;
    if (q >= a.pairs) break;
    const int n = (int)(q / a.pairs_per_image);
    const int oy = (int)(q - (long long)n * a.pairs_per_image) * kRows;
    // row oy - ph of x and row oy of g, channel c; never read where the
    // row, the column or the channel lies outside the tensor
    const float* xr = a.x + n * a.sxn + (long long)(oy - a.ph) * a.sxh + c;
    const float* gr = a.g + n * a.sgn + (long long)oy * a.sgh + c;
    unsigned x_rows = 0, g_rows = 0;
#pragma unroll
    for (int j = 0; j < kWinRows; ++j) {
      const int iy = oy - a.ph + j;
      if (c_ok && iy >= 0 && iy < a.H) x_rows |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (c_ok && oy + j < a.Ho) g_rows |= 1u << j;

    // win[j][m] holds x row oy - ph + j at the padded column t (= column
    // t - pw) with t % K == m; columns 0 .. K - 2 first
    float win[kWinRows][K];
#pragma unroll
    for (int t = 0; t < K - 1; ++t) {
      const int col = t - a.pw;
      const bool ok = col >= 0 && col < a.W;
#pragma unroll
      for (int j = 0; j < kWinRows; ++j)
        win[j][t] = ok && (x_rows >> j & 1) ? __ldg(xr + j * a.sxh + col * a.C) : 0.f;
    }
    for (int ox0 = 0; ox0 < a.Wo; ox0 += K) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int ox = ox0 + s;
        const int col = ox + K - 1 - a.pw;  // the window's new column
        const bool ok = col >= 0 && col < a.W;
#pragma unroll
        for (int j = 0; j < kWinRows; ++j)
          win[j][(s + K - 1) % K] =
              ok && (x_rows >> j & 1) ? __ldg(xr + j * a.sxh + col * a.C) : 0.f;
        float gv[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          gv[j] = ox < a.Wo && (g_rows >> j & 1) ? __ldg(gr + j * a.sgh + ox * a.C) : 0.f;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc_b += gv[j];
#pragma unroll
          for (int ky = 0; ky < K; ++ky)
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
              acc[ky][kx] = fmaf(gv[j], win[j + ky][(s + kx) % K], acc[ky][kx]);
        }
      }
    }
  }

  // the CTA's sums, warp 0 first, as one partial per tap and channel
#pragma unroll
  for (int ky = 0; ky < K; ++ky)
#pragma unroll
    for (int kx = 0; kx < K; ++kx) red[warp][ky * K + kx][lane] = acc[ky][kx];
  red[warp][K * K][lane] = acc_b;
  __syncthreads();
  float* out = a.part + (long long)p * kTaps * a.C;
  for (int i = threadIdx.x; i < kTaps * 32; i += kThreads) {
    const int tap = i >> 5, l = i & 31;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][tap][l];
    const int cc = blockIdx.x * 32 + l;
    if (cc < a.C) out[(long long)tap * a.C + cc] = sum;
  }
}

// dw and db: the partials of each tap and channel added in order
__global__ void dwconv_wgrad_finish(const float* __restrict__ part, float* __restrict__ dw,
                                    float* __restrict__ db, int parts, int taps, int C) {
  const int n = (taps + 1) * C;
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int p = 0; p < parts; ++p) sum += part[(long long)p * n + i];
  if (i < taps * C)
    dw[i] = sum;
  else
    db[i - taps * C] = sum;
}

template <int K>
const void* partial_fn() {
  return (const void*)dwconv_wgrad_partial<K>;
}

const void* kernel_for(int K) {
  switch (K) {
    case 1: return partial_fn<1>();
    case 3: return partial_fn<3>();
    case 5: return partial_fn<5>();
    case 7: return partial_fn<7>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

const char* dwconv_wgrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// CTAs along y (partials per channel and tap) a launch on the current
// device uses: about kWaves waves of the card over all channel tiles, at
// most one CTA-wide step of row pairs each.  The scratch holds
// parts * (K * K + 1) * C floats.  Returns 0 for a K without a kernel.
int dwconv_wgrad_parts(int N, int C, int Ho, int K) {
  const void* fn = kernel_for(K);
  if (fn == nullptr || N < 1 || C < 1 || Ho < 1) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0) != cudaSuccess)
    return 0;
  const long long tiles = (C + 31) / 32;
  const long long pairs = (long long)N * ((Ho + kRows - 1) / kRows);
  const long long units = (pairs + kWarps - 1) / kWarps;
  long long parts = ((long long)sms * (per_sm > 0 ? per_sm : 1) * kWaves + tiles - 1) / tiles;
  if (parts > units) parts = units;
  return (int)(parts < 1 ? 1 : parts);
}

// Launches the partial sums and the final sums on `stream`; returns the
// first cudaError_t (0 = success): cudaErrorInvalidValue for arguments it
// does not take, else what cudaGetLastError reports after each launch.
int dwconv_wgrad_launch(const float* x, const float* g, float* part, float* dw, float* db,
                        int N, int C, int H, int W, int Ho, int Wo, long long sxn,
                        long long sxh, long long sgn, long long sgh, int K, int ph, int pw,
                        int parts, void* stream) {
  const void* fn = kernel_for(K);
  if (fn == nullptr || N < 1 || C < 1 || H < 1 || W < 1 || ph < 0 || pw < 0 ||
      Ho != H + 2 * ph - K + 1 || Wo != W + 2 * pw - K + 1 || Ho < 1 || Wo < 1 || parts < 1 ||
      sxh < 0 || sgh < 0 || (long long)(W + K) * C >= (1LL << 31) ||
      (K + kRows) * sxh >= (1LL << 31) || kRows * sgh + (long long)(Wo + K) * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.g = g;
  a.part = part;
  a.sxn = sxn;
  a.sgn = sgn;
  a.sxh = (int)sxh;
  a.sgh = (int)sgh;
  a.C = C;
  a.H = H;
  a.W = W;
  a.Ho = Ho;
  a.Wo = Wo;
  a.ph = ph;
  a.pw = pw;
  a.pairs_per_image = (Ho + kRows - 1) / kRows;
  a.pairs = (long long)N * a.pairs_per_image;
  a.units = (a.pairs + kWarps - 1) / kWarps;
  a.parts = parts;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((C + 31) / 32, parts);
  switch (K) {
    case 1: dwconv_wgrad_partial<1><<<grid, kThreads, 0, st>>>(a); break;
    case 3: dwconv_wgrad_partial<3><<<grid, kThreads, 0, st>>>(a); break;
    case 5: dwconv_wgrad_partial<5><<<grid, kThreads, 0, st>>>(a); break;
    default: dwconv_wgrad_partial<7><<<grid, kThreads, 0, st>>>(a); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int taps = K * K;
  const int outs = (taps + 1) * C;
  dwconv_wgrad_finish<<<(outs + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      part, dw, db, parts, taps, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
