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
// and o: ~450 FLOP/byte, above the bf16 ridge (~295), so the ceiling is the
// tensor cores (989 TFLOP/s dense bf16).
//
// bf16 (the LM path): a FlashAttention-2-style forward on the tensor cores.
// * One CTA per (q block, b*h) with bq/16 warps (bq a multiple of 16 up to
//   128); each warp owns 16 query rows.  The whole q block sits in shared
//   memory; its fragments are re-read with ldmatrix at every stage, so the
//   registers hold only O (16 x D fp32 per warp: D/2 per thread), m and l.
// * Keys stream through shared memory in stages of kKeys = 64 rows, K and V
//   in bf16, in a 2-stage cp.async ring (16-byte copies, zero-fill for the
//   front padding) with one barrier per stage: the copy of stage t + 1 runs
//   under the math of stage t.  Rows are XOR-swizzled in 16-byte chunks so
//   that ldmatrix reads no bank twice.
// * S = Q K^T and O += P V are mma.sync.m16n8k16 with bf16 inputs and fp32
//   accumulation (V through ldmatrix.trans).  Scores are scaled in fp32
//   (1/sqrt(D) = 1/16 at D = 256, exact); P goes to bf16 only as the A
//   operand of P V, while l sums the fp32 p.
// * The masks are positional, so the visits of the reference's index map
//   compute the same function when cut into stages: the stages cover the
//   keys [max(0, q0 - window + 1), q0 + bq) that some row of the block can
//   see, aligned to end at the diagonal (bk only has to tile S).  A warp
//   skips a stage none of its rows sees and masks only stages on its
//   diagonal, its window edge or the front padding.
// * Shared memory: 2 * D * (bq + 2 * 2 * kKeys) bytes, 196,608 at the
//   Gemma tiles (bq = 128, D = 256): one CTA of 8 warps per SM.
//
// fp32: a SIMT kernel, the port's first design, kept.  A tensor-core fp32
// product would be TF32, which rounds the inputs to 10 mantissa bits and
// cannot hold the port's 2e-5 fp32 parity.  One CTA per (q block, b*h), 8 warps; a pass
// keeps 32 query rows in flight, 4 per warp, each lane owning d = lane + 32t
// of their fp32 acc; q rows are staged in fp32, pre-scaled; per key block
// visit the CTA loads K (rows padded one word against bank conflicts) and V;
// scores are lane-per-key FMAs, P V broadcasts each p with a shuffle.
// Shared memory: 4 * (bk*(D + 1) + bk*D + 32*D) bytes.
//
// swa_attention_smem_bytes gives both layouts; the planner prices the same
// (repro_torch/kernels/swa_attention.py::smem_bytes).

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
// tensor-core (bf16) kernel
constexpr int kKeys = 64;                  // keys per shared-memory stage
constexpr int kStages = 2;
constexpr int kMaxBq = 16 * kWarps;        // one warp per 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float to_float(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
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

// Dynamic shared memory of one CTA: the bf16 tensor-core layout (q block
// whole, kStages stages of K and V at kKeys rows) or the fp32 SIMT one.
size_t smem_bytes(int bq, int bk, int d, int dtype_bytes) {
  if (dtype_bytes == 2) return (size_t)2 * d * (bq + 2 * kStages * kKeys);
  return 4 * ((size_t)bk * (d + 1) + (size_t)bk * d + (size_t)kPassRows * d);
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

// ---- bf16 on the tensor cores -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled by the row: the 8 rows one ldmatrix phase reads
// at a fixed logical chunk land in 8 different bank groups (4 when D/8 is
// not a multiple of 8).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kSw = (D / 8) % 8 == 0 ? 7 : 3;
  return r * D + ((c ^ (r & kSw)) << 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) swa_tc_kernel(const SwaArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kNt = D / 8;      // 8-wide n tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [bq][D]
  bf16* Ks = Qs + a.bq * D;                      // [kStages][kKeys][D]
  bf16* Vs = Ks + kStages * kKeys * D;           // [kStages][kKeys][D]

  // heaviest q blocks (a full window of keys) first, the short front last
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1];
  bf16* ob = static_cast<bf16*>(a.o) + b * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int window = a.window;

  // the keys some row of the block can see: [lo_vis, hi), in stages of
  // kKeys that end at hi; keys below 0 are the zero front padding
  const int q0 = qi * a.bq;
  const int hi = q0 + a.bq;
  const int lo_vis = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_st = (hi - lo_vis + kKeys - 1) / kKeys;
  const int first = hi - n_st * kKeys;

  for (int i = tid; i < a.bq * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(smem_addr(Qs + swz<D>(r, c)), qb + (long long)(q0 + r) * a.sq[2] + c * 8, 16);
  }
  auto load_kv = [&](int st) {
    const int k0 = first + st * kKeys;
    bf16* kd = Ks + (st & 1) * kKeys * D;
    bf16* vd = Vs + (st & 1) * kKeys * D;
    for (int i = tid; i < kKeys * kChunks; i += nthreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int pos = k0 + r;
      const long long p = pos >= 0 ? pos : 0;
      const int n = pos >= 0 ? 16 : 0;
      cp_async16(smem_addr(kd + swz<D>(r, c)), kb + p * a.sk[2] + c * 8, n);
      cp_async16(smem_addr(vd + swz<D>(r, c)), vb + p * a.sv[2] + c * 8, n);
    }
  };
  load_kv(0);
  cp_async_commit();

  // mma fragment coordinates: this thread holds rows g and g + 8 of the
  // warp's 16, columns 2t and 2t + 1 of every 8-wide tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + warp * 16;
  const int qp[2] = {qw0 + g, qw0 + g + 8};
  float o[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; stage st - 1 is consumed
    if (st + 1 < n_st) load_kv(st + 1);
    cp_async_commit();
    const int k0 = first + st * kKeys;
    if (k0 > qw0 + 15 || (window > 0 && k0 + kKeys - 1 <= qw0 - window))
      continue;  // no row of this warp sees a key of the stage
    const bf16* kbuf = Ks + (st & 1) * kKeys * D;
    const bf16* vbuf = Vs + (st & 1) * kKeys * D;

    // S = Q K^T: 16 rows x kKeys keys per warp
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(smem_addr(Qs + swz<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))), qa);
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(smem_addr(kbuf + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1))),
                    kf);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    const bool edge = k0 < 0 || k0 + kKeys - 1 > qw0 ||
                      (window > 0 && k0 <= qw0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (edge) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int q = qp[e >> 1];
          if (!(kp >= 0 && kp <= q && (window <= 0 || kp > q - window))) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        s[j][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = alpha[r] * l[r] + ps[r];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A fragment of a 16-key step
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kNt / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(smem_addr(vbuf + swz<D>(ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                  2 * dp + (lane >> 4))),
                          vf);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (long long)qp[r] * a.so[2] + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = v;
    }
  }
}

template <int DT>
int launch_simt(const SwaArgs& a, int BH, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.bq, a.bk, 32 * DT, 4);
  cudaError_t e = cudaFuncSetAttribute(swa_kernel<float, DT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S / a.bq, BH);
  swa_kernel<float, DT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const SwaArgs& a, int BH, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.bq, a.bk, D, 2);
  cudaError_t e = cudaFuncSetAttribute(swa_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S / a.bq, BH);
  swa_tc_kernel<D><<<grid, 32 * (a.bq / 16), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_d(const SwaArgs& a, bool bf16, int D, int BH, cudaStream_t stream) {
  switch (D / 32) {
#define SWA_CASE(n)                                                                 \
  case n:                                                                           \
    return bf16 ? launch_tc<32 * n>(a, BH, stream) : launch_simt<n>(a, BH, stream);
    SWA_CASE(1)
    SWA_CASE(2)
    SWA_CASE(3)
    SWA_CASE(4)
    SWA_CASE(5)
    SWA_CASE(6)
    SWA_CASE(7)
    SWA_CASE(8)
#undef SWA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA takes (dtype_bytes 2: the bf16 tensor-core
// layout, where bq enters and bk does not; 4: the fp32 SIMT layout, where
// bk enters and bq does not).
long long swa_attention_smem_bytes(int bq, int bk, int d, int dtype_bytes) {
  return (long long)smem_bytes(bq, bk, d, dtype_bytes);
}

const char* swa_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 fp32, 1 bf16.  strides: 12 element strides, (batch, head, seq) of
// q, k, v, o in that order.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).  bf16 needs bq a multiple of 16 up to 128 and
// q, k, v rows on 16-byte boundaries (pointers and strides).
int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                         int B, int H, int S, int D, const long long* strides, int window,
                         int bq, int bk, int n_kv, float scale, void* stream) {
  const bool bf16 = dtype == 1;
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || (long long)B * H > 65535 ||
      D % 32 || D < 32 || D > 256 || bk < 1 || bq < bk || bq % bk || S % bq || S % bk ||
      n_kv < 1 || n_kv * bk < bq || window < 0 ||
      smem_bytes(bq, bk, D, bf16 ? 2 : 4) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    bool aligned = bq % 16 == 0 && bq <= kMaxBq;
    aligned = aligned && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    for (int i = 0; i < 9; ++i) aligned = aligned && strides[i] % 8 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
  } else if (bk > 32 * kMaxGroups) {
    return (int)cudaErrorInvalidValue;
  }
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
  return launch_d(a, bf16, D, B * H, (cudaStream_t)stream);
}

}  // extern "C"
