// Stride-1 depthwise convolution (groups = channels) for Hopper (sm_90a),
// fp32, an odd square kernel K <= 7, with its bias added in the epilogue:
//
//   y[n, oy, ox, c] = b[c] + sum_{ky, kx} x[n, oy + ky - ph, ox + kx - pw, c] * w[ky, kx, c]
//
// with x zero outside [0, H) x [0, W).  The data gradient of such a conv
// is the same conv of g with the filter flipped and padding K - 1 - p, so
// one kernel serves both passes: FLIP reads w[K - 1 - ky, K - 1 - kx].  x
// is NHWC: channel stride 1, column stride C, and the image and row
// strides given, so a row slice of a larger map is read in place.  w is the
// storage of the HWIO (K, K, 1, C) parameter, b (C) or null, y packed NHWC.
// The wrapper is repro_torch/kernels/dwconv2d.py.
//
// Replaces no TPU kernel: the JAX package has no depthwise convolution.  It
// exists because cuDNN serves this forward and data gradient, for fp32 NHWC
// with TF32 off, with conv2d_c1_k1_nhwc and dgrad2d_c1_k1_nhwc at about a
// tenth of their byte bound at ConvNeXt's shapes.
//
// What bounds it on the card: bytes, nearly.  Each output element costs 2
// K^2 FLOPs (98 at K = 7) against a 4-byte read and a 4-byte write, ~12
// FLOP a byte, under the fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20).  The
// design reads x from HBM about once and reuses every read from registers
// or L1:
// * A lane owns one channel (a warp 32 consecutive channels, so every load
//   and store is one 128-byte line) and holds its K^2 taps and its bias in
//   registers.  A warp makes kRows output rows and walks along them one
//   padded input column at a time: it loads the column's K + kRows - 1
//   rows and adds each value, times the taps, into the partial sums of the
//   K output columns it touches, then stores the column that is complete.
//   The partial sums are a ring of kRows x K registers whose slots are
//   fixed at compile time by unrolling the column loop K times: far fewer
//   registers than a window of the input (K + kRows - 1) x K, so six rows
//   a warp and four 128-thread CTAs an SM fit in 128 registers, and more
//   loads are in flight.  Padding columns are skipped, not multiplied.
// * A CTA is kWarps warps on consecutive row groups of the same 32
//   channels, so the K - 1 halo rows that neighbouring warps share come
//   from L1; the grid runs the channel tiles fastest, so CTAs in flight
//   together read whole pixels.
// * Each output is one thread's sum in a fixed order (taps column by
//   column, each column's rows in order, the bias last); there are no
//   atomics, so two launches give the same bits.
//
// At ConvNeXt-B's 36 depthwise convs at 384^2, batch 128, a pass takes
// 8.05 ms forward and 8.04 ms data gradient against cuDNN's 38.58 and
// 31.40, 52 % of the 4.19 ms byte bound (H100 80GB HBM3, 700 W;
// chip_smoke.py's kernel phase).  The constants were chosen by timing
// kRows 2-8, kWarps 4-8, 3-5 CTAs an SM and a column loaded a step ahead
// at those shapes: a window of the input in registers in place of the
// partial sums took 10.9 ms at best.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // row groups a CTA works on at once
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 6;       // output rows of a warp
constexpr int kMinBlocks = 4;  // CTAs an SM holds (at most 128 registers)

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  long long sxn;  // x's image stride (elements)
  int sxh;        // x's row stride (elements)
  int C, H, W, Ho, Wo, ph, pw;
  int tiles;            // ceil(C / 32)
  int rows_per_image;   // ceil(Ho / kRows): row groups of an image
  long long row_groups; // N * rows_per_image
};

template <int K, bool FLIP>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dwconv2d_kernel(Args a) {
  constexpr int kInRows = K + kRows - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x % a.tiles;
  const long long q = (long long)(blockIdx.x / a.tiles) * kWarps + warp;
  if (q >= a.row_groups) return;
  const int c = tile * 32 + lane;
  const bool c_ok = c < a.C;
  const int n = (int)(q / a.rows_per_image);
  const int oy = (int)(q - (long long)n * a.rows_per_image) * kRows;

  float wr[K][K];
#pragma unroll
  for (int ky = 0; ky < K; ++ky)
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      const int tap = FLIP ? (K - 1 - ky) * K + (K - 1 - kx) : ky * K + kx;
      wr[ky][kx] = c_ok ? __ldg(a.w + tap * a.C + c) : 0.f;
    }
  const float bias = a.b != nullptr && c_ok ? __ldg(a.b + c) : 0.f;

  // row oy - ph of x and row oy of y, channel c; never read or written
  // where the row, the column or the channel lies outside the tensor
  const float* xr = a.x + n * a.sxn + (long long)(oy - a.ph) * a.sxh + c;
  float* yr = a.y + ((long long)n * a.Ho + oy) * a.Wo * a.C + c;
  unsigned x_rows = 0;
#pragma unroll
  for (int j = 0; j < kInRows; ++j) {
    const int iy = oy - a.ph + j;
    if (c_ok && iy >= 0 && iy < a.H) x_rows |= 1u << j;
  }
  const int y_rows = c_ok ? min(kRows, a.Ho - oy) : 0;
  const int syh = a.Wo * a.C;

  // acc[r][m]: the partial sum of output row oy + r at the column ox with
  // ox % K == m.  The padded input column t (= column t - pw) adds to the
  // output columns t - kx; after it, column t - K + 1 is complete, and its
  // slot is zeroed for column t + 1.  A slot that a column left of the
  // output (t - kx < 0) wrote is zeroed before its first column's turn.
  float acc[kRows][K];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < K; ++m) acc[r][m] = 0.f;
  const int wp = a.Wo + K - 1;  // padded input columns
  for (int t0 = 0; t0 < wp; t0 += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int t = t0 + s;
      if (t >= wp) break;
      const int col = t - a.pw;
      if (col >= 0 && col < a.W) {
        float v[kInRows];
#pragma unroll
        for (int j = 0; j < kInRows; ++j)
          v[j] = x_rows >> j & 1 ? __ldg(xr + j * a.sxh + col * a.C) : 0.f;
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int ky = 0; ky < K; ++ky)
              acc[r][(s - kx + K) % K] = fmaf(v[r + ky], wr[ky][kx], acc[r][(s - kx + K) % K]);
      }
      if (t >= K - 1) {
        const int ox = t - (K - 1);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < y_rows) yr[r * syh + ox * a.C] = acc[r][(s + 1) % K] + bias;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][(s + 1) % K] = 0.f;
    }
  }
}

template <int K>
cudaError_t launch(const Args& a, unsigned blocks, bool flip, cudaStream_t st) {
  if (flip)
    dwconv2d_kernel<K, true><<<blocks, kThreads, 0, st>>>(a);
  else
    dwconv2d_kernel<K, false><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dwconv2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the conv on `stream` (flip != 0: with the filter flipped, the
// data gradient); returns the cudaError_t (0 = success):
// cudaErrorInvalidValue for arguments it does not take, else what
// cudaGetLastError reports after the launch.
int dwconv2d_launch(const float* x, const float* w, const float* b, float* y, int N, int C,
                    int H, int W, int Ho, int Wo, long long sxn, long long sxh, int K, int ph,
                    int pw, int flip, void* stream) {
  const bool k_ok = K == 1 || K == 3 || K == 5 || K == 7;
  if (!k_ok || N < 1 || C < 1 || H < 1 || W < 1 || ph < 0 || pw < 0 || ph > K - 1 ||
      pw > K - 1 || Ho != H + 2 * ph - K + 1 || Wo != W + 2 * pw - K + 1 || Ho < 1 || Wo < 1 ||
      sxn < 0 || sxh < 0 || (long long)(W + K) * C >= (1LL << 31) ||
      (K + kRows) * sxh >= (1LL << 31) || (long long)kRows * Wo * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.y = y;
  a.sxn = sxn;
  a.sxh = (int)sxh;
  a.C = C;
  a.H = H;
  a.W = W;
  a.Ho = Ho;
  a.Wo = Wo;
  a.ph = ph;
  a.pw = pw;
  a.tiles = (C + 31) / 32;
  a.rows_per_image = (Ho + kRows - 1) / kRows;
  a.row_groups = (long long)N * a.rows_per_image;
  const long long blocks = (a.row_groups + kWarps - 1) / kWarps * a.tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)launch<1>(a, (unsigned)blocks, flip != 0, st);
    case 3: return (int)launch<3>(a, (unsigned)blocks, flip != 0, st);
    case 5: return (int)launch<5>(a, (unsigned)blocks, flip != 0, st);
    default: return (int)launch<7>(a, (unsigned)blocks, flip != 0, st);
  }
}

}  // extern "C"
