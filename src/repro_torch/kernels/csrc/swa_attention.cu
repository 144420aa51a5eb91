// Causal sliding-window flash attention (forward) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/swa_attention.py::swa_attention, the Pallas TPU
// kernel (body _swa_kernel), and computes what it computes, on (B, H, S, D)
// views with any batch/head/sequence strides (D contiguous):
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// over keys j with j <= i and, when window > 0, j > i - window.  Query block
// qi of bq rows visits the n_kv key blocks of bk rows that end at its
// diagonal, block vi starting at key qi*bq + bq - (n_kv - vi)*bk; keys before
// 0 are the reference's zero front padding.  The online softmax keeps m, l
// and acc in fp32, masked scores are -1e30 exactly as in the reference, and
// the output is acc / max(l, 1e-30) in the input type.  fp32 and bf16.
// The wrapper is repro_torch/kernels/swa_attention.py.
//
// What bounds it on the card: operations.  Gemma-3 4B's local layers
// (H = 8 after the GQA repeat, S = 4096, D = 256, window 1024) do
// 4*H*D*sum_i min(i + 1, window) = 30.1 GFLOP per call on 67 MB of q, k, v
// and o: ~450 FLOP/byte, above the bf16 ridge (~295).  This first version
// does SIMT fp32 FMAs, not wgmma, so its ceiling is the fp32 pipe (67
// TFLOP/s) and, below that, shared-memory bandwidth.
//
// Design:
// * One CTA per (q block, b*h), 8 warps.  A pass over the q block keeps 32
//   query rows in flight, 4 per warp; each warp holds its rows' acc
//   (4 x D/32 fp32 per lane: lane owns d = lane + 32t), m and l in registers.
//   q rows are staged in shared memory in fp32, pre-scaled by 1/sqrt(D).
// * Per key block visit the CTA loads the K and V tiles (bk x D, input type)
//   into shared memory; K rows are padded by one 32-bit word so that lanes
//   reading different keys at the same d hit different banks.
// * Scores: lane owns keys j = lane + 32u (u < bk/32), 4 rows at once, so
//   every K word feeds 4-8 FMAs.  Row max and sum are warp shuffles.  PV:
//   each p_j is broadcast with a shuffle and V rows are read along d.
// * Visits that no row of the current pass can attend to (all before the
//   window, after the diagonal, or front padding) are skipped whole: they
//   add nothing the reference keeps (its alpha = 0 wipes them).
// Shared memory: 4 * (bk*(D/w + 1) + bk*D/w + 32*D) bytes with w elements per
// 32-bit word (1 fp32, 2 bf16) — swa_attention_smem_bytes, priced by the
// planner (repro_torch/kernels/swa_attention.py::smem_bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                   // query rows per warp in flight
constexpr int kPassRows = kWarps * kRows;  // query rows per pass
constexpr int kMaxGroups = 8;              // bk <= 256 keys = 8 x 32 lanes
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float to_float(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_float(float v) { return __float2bfloat16(v); }
  // element 0 sits in the low half of the little-endian word
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};

struct SwaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, S;
  // element strides (batch, head, seq) of q, k, v, o; d is contiguous
  long long sq[3], sk[3], sv[3], so[3];
  int window, bq, bk, n_kv;
  float scale;
};

size_t smem_bytes(int bk, int d, int dtype_bytes) {
  const size_t words = (size_t)d * dtype_bytes / 4;
  return 4 * ((size_t)bk * (words + 1) + (size_t)bk * words + (size_t)kPassRows * d);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) swa_kernel(const SwaArgs a) {
  constexpr int D = 32 * DT;
  constexpr int KW = Elem<T>::kPerWord;
  constexpr int DW = D / KW;  // 32-bit words per row
  extern __shared__ uint32_t smem[];
  const int bk = a.bk;
  uint32_t* Ks = smem;                                  // [bk][DW + 1]
  uint32_t* Vw = Ks + bk * (DW + 1);                    // [bk][DW]
  float* Qs = reinterpret_cast<float*>(Vw + bk * DW);   // [kPassRows][D]
  const T* Vs = reinterpret_cast<const T*>(Vw);

  const int qi = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  T* ob = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_groups = (bk + 31) / 32;
  const int window = a.window;
  float* qw = Qs + warp * kRows * D;  // this warp's staged q rows

  for (int r0 = 0; r0 < a.bq; r0 += kPassRows) {
    const int pass_lo = qi * a.bq + r0;
    const int pass_hi = qi * a.bq + min(r0 + kPassRows, a.bq) - 1;
    int qpos[kRows];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = r0 + warp * kRows + r;
      live[r] = rr < a.bq;
      qpos[r] = qi * a.bq + rr;
      for (int d = lane; d < D; d += 32)
        qw[r * D + d] = live[r] ? Elem<T>::to_float(qb[qpos[r] * a.sq[2] + d]) * a.scale : 0.f;
    }
    float m[kRows], l[kRows], acc[kRows][DT];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
    }

    for (int vi = 0; vi < a.n_kv; ++vi) {
      const int kv_start = qi * a.bq + a.bq - (a.n_kv - vi) * bk;
      const int kv_end = kv_start + bk - 1;
      if (kv_end < 0 || kv_start > pass_hi || (window > 0 && kv_end <= pass_lo - window))
        continue;  // uniform over the CTA: no row of this pass sees a key here
      __syncthreads();  // the previous tiles are consumed (and q is staged)
      for (int i = threadIdx.x; i < bk * DW; i += kThreads) {
        const int j = i / DW;
        const int w = i % DW;
        const int pos = kv_start + j;
        uint32_t kw = 0, vw = 0;
        if (pos >= 0) {
          kw = reinterpret_cast<const uint32_t*>(kb + pos * a.sk[2])[w];
          vw = reinterpret_cast<const uint32_t*>(vb + pos * a.sv[2])[w];
        }
        Ks[j * (DW + 1) + w] = kw;
        Vw[j * DW + w] = vw;
      }
      __syncthreads();

      float s[kRows][kMaxGroups];
#pragma unroll
      for (int u = 0; u < kMaxGroups; ++u) {
        if (u >= n_groups) break;
        const int j = u * 32 + lane;
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
        if (j < bk) {
          const uint32_t* kr = Ks + j * (DW + 1);
#pragma unroll 4
          for (int w = 0; w < DW; ++w) {
            float kf[KW];
            Elem<T>::unpack(kr[w], kf);
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int e = 0; e < KW; ++e) dot[r] = fmaf(qw[r * D + w * KW + e], kf[e], dot[r]);
          }
        }
        const int kp = kv_start + j;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool ok = j < bk && kp >= 0 && kp <= qpos[r] &&
                          (window <= 0 || kp > qpos[r] - window);
          s[r][u] = ok ? dot[r] : kNegInf;
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kMaxGroups; ++u)
          if (u < n_groups && u * 32 + lane < bk) mx = fmaxf(mx, s[r][u]);
        mx = warp_max(mx);
        const float m_new = fmaxf(m[r], mx);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kMaxGroups; ++u) {
          // keys past bk do not exist; masked keys count as the reference's
          const float p = (u < n_groups && u * 32 + lane < bk) ? expf(s[r][u] - m_new) : 0.f;
          s[r][u] = p;
          ps += p;
        }
        ps = warp_sum(ps);
        const float alpha = expf(m[r] - m_new);
        l[r] = alpha * l[r] + ps;
        m[r] = m_new;
#pragma unroll
        for (int t = 0; t < DT; ++t) acc[r][t] *= alpha;
      }

#pragma unroll
      for (int u = 0; u < kMaxGroups; ++u) {
        if (u >= n_groups) break;
        const int nj = min(32, bk - u * 32);
        for (int jl = 0; jl < nj; ++jl) {
          const T* vr = Vs + (u * 32 + jl) * D;
          float p[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) p[r] = __shfl_sync(0xffffffffu, s[r][u], jl);
#pragma unroll
          for (int t = 0; t < DT; ++t) {
            const float vv = Elem<T>::to_float(vr[lane + 32 * t]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r][t] = fmaf(p[r], vv, acc[r][t]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!live[r]) continue;
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = ob + qpos[r] * a.so[2];
#pragma unroll
      for (int t = 0; t < DT; ++t) orow[lane + 32 * t] = Elem<T>::from_float(acc[r][t] / den);
    }
  }
}

template <typename T, int DT>
int launch_t(const SwaArgs& a, int BH, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.bk, 32 * DT, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(swa_kernel<T, DT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S / a.bq, BH);
  swa_kernel<T, DT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const SwaArgs& a, int D, int BH, cudaStream_t stream) {
  switch (D / 32) {
    case 1: return launch_t<T, 1>(a, BH, stream);
    case 2: return launch_t<T, 2>(a, BH, stream);
    case 3: return launch_t<T, 3>(a, BH, stream);
    case 4: return launch_t<T, 4>(a, BH, stream);
    case 5: return launch_t<T, 5>(a, BH, stream);
    case 6: return launch_t<T, 6>(a, BH, stream);
    case 7: return launch_t<T, 7>(a, BH, stream);
    case 8: return launch_t<T, 8>(a, BH, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA takes (bq does not enter: a pass stages 32
// query rows whatever the q block).
long long swa_attention_smem_bytes(int bk, int d, int dtype_bytes) {
  return (long long)smem_bytes(bk, d, dtype_bytes);
}

const char* swa_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 fp32, 1 bf16.  strides: 12 element strides, (batch, head, seq) of
// q, k, v, o in that order.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                         int B, int H, int S, int D, const long long* strides, int window,
                         int bq, int bk, int n_kv, float scale, void* stream) {
  const int bytes = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || (long long)B * H > 65535 ||
      D % 32 || D < 32 || D > 256 || bk < 1 || bk > 32 * kMaxGroups || bq < bk || bq % bk ||
      S % bq || S % bk || n_kv < 1 || n_kv * bk < bq || window < 0 ||
      smem_bytes(bk, D, bytes) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  SwaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.H = H;
  a.S = S;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.window = window;
  a.bq = bq;
  a.bk = bk;
  a.n_kv = n_kv;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch_d<float>(a, D, B * H, st)
                    : launch_d<__nv_bfloat16>(a, D, B * H, st);
}

}  // extern "C"
