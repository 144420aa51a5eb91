// Mamba2 SSD scan for Hopper (sm_90a), fp32 in and out, chunked on the
// tensor cores.
//
// Replaces src/repro/kernels/ssd_chunk.py::ssd_scan, the Pallas TPU kernel
// (body _ssd_kernel), and computes what it computes:
//
//   h_t = a_t h_{t-1} + dt_t x_t (outer) B_t ,   y_t = C_t . h_t
//
// with x (Bt, S, H, P), B and C (Bt, S, N), a and dt (Bt, S, H), y like x,
// all contiguous fp32, h_0 = 0, in the TPU kernel's chunked form: for chunk
// c of the sequence (chunk rows, S % chunk == 0) and head h,
//
//   cum_t  = sum_{u <= t} log(a_u + 1e-12)                     (in-chunk)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//            + exp(cum_t) C_t . h_in
//   h_out  = exp(cum_last) h_in + sum_s dt_s exp(cum_last - cum_s) x_s B_s^T
//
// The wrapper is repro_torch/kernels/ssd_chunk.py; its plain version
// (ssd_scan_plain) repeats this index math in PyTorch.
//
// What bounds it on the card: bytes.  At Zamba2-7B's Mamba2 widths (H = 32,
// P = 224, N = 64, S = 4096) a call reads x, B, C, a, dt and writes y once:
// 238 MB, 0.071 ms at 3.35 TB/s.  The chunked form does 11.4 GFLOP at
// chunk 128, 34 GFLOP as 3xTF32 tensor-core work: 0.069 ms at the 495
// TFLOP/s TF32 peak.  The step-by-step recurrence the port ran before was
// latency-bound on its 4096 dependent steps (9.5 ms).  This kernel is bound
// by the rate of its mma.sync products and the fp32 work around them.
//
// Design:
// * One CTA of 4 warps per (b, h, 32-wide tile of P): grid
//   (ceil(P / 32), H, Bt).  It walks the chunks in order; the state tile
//   h (32 x N) is carried from chunk to chunk in registers, as the
//   accumulators of the state update, with a copy in shared memory for the
//   y product.  This loop takes the place of the TPU grid's sequential
//   chunk axis and its VMEM scratch.
// * Chunk inputs stream in with cp.async.  Two stages of the x tile, B and
//   C when they leave room for two CTAs per SM (chunk k + 1 loads while
//   chunk k computes), else one (chunk k loads at its start while the SM's
//   other CTA computes): at N 64, two stages up to chunk 64, one at 128 and
//   256.  a and dt run a chunk further ahead, and one warp turns them into
//   the next chunk's cum and tail while the others finish this one.
// * A first pass (ssd_gram_kernel) computes G = C B^T of every (b, chunk)
//   once in fp32, its causal 16 x 8 tiles stored in mma fragment order in a
//   workspace the wrapper allocates (1.2 MB at chunk 128); G has neither a
//   head nor a P axis, so every CTA would otherwise recompute it (a third
//   of the tensor work at chunk 64).  The scan reads each tile from L2 as
//   one float4 per lane.
// * The scan's two products run as mma.sync.m16n8k8 TF32 with the 3xTF32
//   split (v = hi + lo, a*b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi), which
//   keeps fp32 accuracy; single TF32 keeps about three digits.
//   - y = (C exp(cum_t)) h_in^T while the m tile's G loads are in flight;
//   - y += (G exp(cum_t - cum_s)) (dt x) over s up to the diagonal, the
//     mask applied before exp (s > t -> -inf, so exp gives 0 and no inf * 0
//     appears), the decayed G used directly as the A operand.  The k index
//     of every fragment is permuted (logical q, q + 4 -> physical 2q,
//     2q + 1) so that G's tiles are valid A fragments and shared-memory
//     reads are 2-word; y goes to global memory from registers.
//   - h = exp(cum_last) h + (dt exp(cum_last - cum_s) x)^T B.
// * A warp owns m tiles of y in a snake order (w, 2W-1-w, ...), which
//   balances the causal work when the chunk has 8 or more m tiles.
// * Chunks under 16 rows, P under the tile and N not a multiple of 16 are
//   padded with zeros in shared memory (log a = 0, dt = 0 on padded rows).
//   The scan is instantiated for each N / 8 (rounded up to even), so every
//   loop over N, over the state tiles and over a block of G has a trip
//   count known to the compiler: no branch splits the mma chains.
// * Shared memory, in floats: stages x rows x (36 + 2 ldb) + 2 x 32 ldb
//   + (6 + 2 stages) rows, rows = chunk rounded up to 16, ldb = N rounded
//   up to 16 and padded to 8 mod 16 words; at N 64: 113,152 B at chunk 64
//   (two stages), 114,688 B at 128 and 210,944 B at 256 (one stage).
//   ssd_scan_smem_bytes gives it and the planner prices the same
//   (repro_torch/kernels/ssd_chunk.py::smem_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPt = 32;                     // P columns per CTA
constexpr int kLdx = kPt + 4;               // x tile row stride (words)
constexpr int kMt = kPt / 16;               // m tiles of the state
constexpr int kMaxN = 128;                  // largest state size N
constexpr int kSBlock = 8;                  // n tiles (64 columns) of G in registers
constexpr size_t kSmemLimit = 232448;
// Shared memory a CTA may take for two to fit on one SM: half of the SM's
// 233,472 bytes less the 1,024 reserved per CTA.
constexpr size_t kTwoPerSm = 233472 / 2 - 1024;
constexpr float kLog2e = 1.4426950408889634f;

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride of the B, C and state tiles: N rounded up to 16, padded to
// 8 mod 16 words, so the 2-word fragment reads of a half-warp (rows g < 4)
// start in banks 0, 8, 16, 24 and hit 32 distinct banks.
__host__ __device__ int ld_bc(int np) { return np + (8 - np % 16 + 16) % 16; }

// Floats of shared memory: `stages` copies of the x, B and C tiles, the
// state tile split in hi and lo, a ring of a and dt with a slot per stage,
// and two Prep buffers of three rows.
size_t smem_floats(int rows, int ldb, int stages) {
  return (size_t)stages * rows * (kLdx + 2 * ldb) + (size_t)2 * kPt * ldb +
         (size_t)(6 + 2 * stages) * rows;
}

// Two stages when they leave room for two CTAs per SM, else one.
int stages_for(int chunk, int n) {
  const int rows = round_up(chunk, 16), ldb = ld_bc(round_up(n, 16));
  return 4 * smem_floats(rows, ldb, 2) <= kTwoPerSm ? 2 : 1;
}

size_t smem_bytes(int chunk, int n) {
  return 4 * smem_floats(round_up(chunk, 16), ld_bc(round_up(n, 16)), stages_for(chunk, n));
}

struct SsdArgs {
  const float* x;
  const float* B;
  const float* C;
  const float* a;
  const float* dt;
  const float* G;  // C B^T of every chunk, causal tiles in fragment order
  float* y;
  int S, H, P, N, chunk, stages;
  bool vec_x, vec_bc;  // 16-byte copies allowed for x rows / B and C rows
#ifdef SSD_PHASES
  long long* phases;
#endif
};

// Built with -DSSD_PHASES (repro_torch/kernels/probe.py), the scan also sums
// clock64() cycles of every warp over the chunks by phase: copies and wait,
// y, state update, next Prep, closing barrier; then the whole loop.
#ifdef SSD_PHASES
#define PHASE(i)                     \
  do {                               \
    const long long now_ = clock64(); \
    phase_[i] += now_ - mark_;       \
    mark_ = now_;                    \
  } while (0)
long long* g_phases = nullptr;
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// global -> shared copies; src_bytes below the copy size zero-fills the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// v = hi + lo: hi is v cut to TF32's 10 mantissa bits, lo = v - hi is exact
// in fp32 and goes in as it is (the tensor core reads its top 10 mantissa
// bits).  Cutting by mask is one logic instruction per value.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// A fragment from rows (g, g + 8) at physical k (2q, 2q + 1):
// a0 = (g, 2q), a1 = (g + 8, 2q), a2 = (g, 2q + 1), a3 = (g + 8, 2q + 1)
__device__ __forceinline__ FragA frag_a(float r0k0, float r1k0, float r0k1, float r1k1) {
  FragA f;
  split(r0k0, f.hi[0], f.lo[0]);
  split(r1k0, f.hi[1], f.lo[1]);
  split(r0k1, f.hi[2], f.lo[2]);
  split(r1k1, f.hi[3], f.lo[3]);
  return f;
}

// B fragment at column g, physical k (2q, 2q + 1)
__device__ __forceinline__ FragB frag_b(float k0, float k1) {
  FragB f;
  split(k0, f.hi[0], f.lo[0]);
  split(k1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32 (the small products first)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

struct Stage {
  float* x;   // [rows][kLdx]   x[t, h, p0 + j]
  float* Bm;  // [rows][ldb]
  float* Cm;  // [rows][ldb]
};

__device__ __forceinline__ Stage stage_at(float* base, int rows, int ldb) {
  Stage s;
  s.x = base;
  s.Bm = s.x + rows * kLdx;
  s.Cm = s.Bm + rows * ldb;
  return s;
}

// Per-chunk values of one head, computed a chunk ahead (double-buffered).
struct Prep {
  float* cum;    // [rows] in-chunk inclusive cumsum of log(a + 1e-12), times
                 // log2(e): every decay is one exp2f
  float* wtail;  // [rows] dt_s exp(cum_last - cum_s)
  float* dt;     // [rows] dt_s (0 on padded rows)
};

__device__ __forceinline__ Prep prep_at(float* base, int rows) {
  Prep p;
  p.cum = base;
  p.wtail = base + rows;
  p.dt = base + 2 * rows;
  return p;
}

// Issue the copies of chunk k into st (the caller commits): x and C when
// kXC is set, B when kB is.
template <int NP, bool kXC = true, bool kB = true>
__device__ __forceinline__ void load_chunk(const SsdArgs& A, const Stage& st, int k, int b, int h,
                                           int p0, int ldb) {
  const int c = A.chunk;
  const size_t row0 = (size_t)b * A.S + (size_t)k * c;  // first sequence row
  const int tid = threadIdx.x;
  const int hp = A.H * A.P;
  const float* xb = A.x + (row0 * A.H + h) * A.P + p0;
  const float* bb = A.B + row0 * A.N;
  const float* cb = A.C + row0 * A.N;
  if (kXC && A.vec_x) {
    for (int i = tid; i < c * (kPt / 4); i += kThreads) {
      const int t = i / (kPt / 4), j = 4 * (i % (kPt / 4));
      const int valid = max(0, min(4, A.P - p0 - j));
      cp_async16(st.x + t * kLdx + j, xb + t * hp + (valid ? j : 0), 4 * valid);
    }
  } else if (kXC) {
    for (int i = tid; i < c * kPt; i += kThreads) {
      const int t = i / kPt, j = i % kPt;
      const bool valid = p0 + j < A.P;
      cp_async4(st.x + t * kLdx + j, xb + t * hp + (valid ? j : 0), valid ? 4 : 0);
    }
  }
  if (A.vec_bc) {
    for (int i = tid; i < c * (NP / 4); i += kThreads) {
      const int t = i / (NP / 4), j = 4 * (i % (NP / 4));
      const int valid = max(0, min(4, A.N - j));
      const int off = t * A.N + (valid ? j : 0);
      if (kB) cp_async16(st.Bm + t * ldb + j, bb + off, 4 * valid);
      if (kXC) cp_async16(st.Cm + t * ldb + j, cb + off, 4 * valid);
    }
  } else {
    for (int i = tid; i < c * NP; i += kThreads) {
      const int t = i / NP, j = i % NP;
      const bool valid = j < A.N;
      const int off = t * A.N + (valid ? j : 0);
      if (kB) cp_async4(st.Bm + t * ldb + j, bb + off, valid ? 4 : 0);
      if (kXC) cp_async4(st.Cm + t * ldb + j, cb + off, valid ? 4 : 0);
    }
  }
}

// Issue the copies of a and dt of chunk k for head h into a_s, dt_s.
__device__ __forceinline__ void load_decay(const SsdArgs& A, float* a_s, float* dt_s, int k, int b,
                                           int h) {
  const int c = A.chunk;
  const size_t base = ((size_t)b * A.S + (size_t)k * c) * A.H + h;
  for (int t = threadIdx.x; t < c; t += kThreads) {
    cp_async4(a_s + t, A.a + base + (size_t)t * A.H, 4);
    cp_async4(dt_s + t, A.dt + base + (size_t)t * A.H, 4);
  }
}

// One warp: cum (inclusive scan of log(a + 1e-12), in log2 units), wtail and
// dt of a chunk from its a and dt.
__device__ __forceinline__ void prep_chunk(const float* a_s, const float* dt_s, const Prep& pr,
                                           int c, int rows, int lane) {
  const int per = (rows + 31) / 32;
  const int lo = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    const int t = lo + i;
    if (t < rows) {
      run += t < c ? logf(a_s[t] + 1e-12f) : 0.f;
      pr.cum[t] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int i = 0; i < per; ++i) {
    const int t = lo + i;
    if (t < rows) pr.cum[t] = (pr.cum[t] + excl) * kLog2e;
  }
  __syncwarp();
  const float last = pr.cum[c - 1];
  for (int t = lane; t < rows; t += 32) {
    const float d = t < c ? dt_s[t] : 0.f;
    pr.wtail[t] = d * exp2f(last - pr.cum[t]);
    pr.dt[t] = d;
  }
}

// Load NB G tiles (one float4 per lane each) of an m tile's s block.
__device__ __forceinline__ void load_g(const float* Gm, int nb, int lane,
                                       float4 (&gv)[kSBlock]) {
#pragma unroll
  for (int j = 0; j < kSBlock; ++j)
    if (j < nb) gv[j] = __ldg(reinterpret_cast<const float4*>(Gm) + j * 32 + lane);
}

// y += (G decay) (dt x) for one block of NB n tiles of s from column sb:
// G's tile j is (tA, s0), (tA, s1), (tB, s0), (tB, s1) in gv[j], decayed and
// masked in registers, then the A operand.
template <int NB>
__device__ __forceinline__ void y_intra(const Stage& st, const Prep& pr,
                                        const float4 (&gv)[kSBlock], int sb, int tA, int tB,
                                        int g, int q, float (&yacc)[kPt / 8][4]) {
  const float cumA = pr.cum[tA], cumB = pr.cum[tB];
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int s0 = sb + 8 * j + 2 * q, s1 = s0 + 1;
    const float c0 = pr.cum[s0], c1 = pr.cum[s1];
    // mask before exp: above the diagonal exp2(-inf) = 0, never inf * 0
    const float w00 = gv[j].x * exp2f(s0 <= tA ? cumA - c0 : -inf);
    const float w01 = gv[j].y * exp2f(s1 <= tA ? cumA - c1 : -inf);
    const float w10 = gv[j].z * exp2f(s0 <= tB ? cumB - c0 : -inf);
    const float w11 = gv[j].w * exp2f(s1 <= tB ? cumB - c1 : -inf);
    const FragA fa = frag_a(w00, w10, w01, w11);
    const float d0 = pr.dt[s0], d1 = pr.dt[s1];  // 0 on padded rows
    const float* x0 = st.x + s0 * kLdx + g;
    const float* x1 = st.x + s1 * kLdx + g;
#pragma unroll
    for (int pn = 0; pn < kPt / 8; ++pn)
      mma3(yacc[pn], fa, frag_b(x0[8 * pn] * d0, x1[8 * pn] * d1));
  }
}

// Causal 16 x 8 tiles of a chunk's G: m tile i has n tiles 0 .. 2i + 1.
__host__ __device__ __forceinline__ int gram_tiles(int m_tiles) { return m_tiles * (m_tiles + 1); }

// First pass: G = C B^T of every (b, chunk) in fp32, once for all heads and
// P tiles.  Tile i (i + 1) + j holds rows 16i .. 16i + 15 and columns
// 8j .. 8j + 7 in mma fragment order: lane l's float4 is (t, s), (t, s + 1),
// (t + 8, s), (t + 8, s + 1) with t = 16i + l / 4, s = 8j + 2 (l % 4).  Rows
// or columns past the chunk are 0.
// One thread per entry of the workspace (b, chunk, tile, lane, 4).
__global__ void __launch_bounds__(kThreads)
ssd_gram_kernel(const float* __restrict__ B, const float* __restrict__ C, float* __restrict__ G,
                int S, int N, int chunk, int tiles, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx < total) {
    const int e = (int)(idx % (tiles * 128));
    const long long bk = idx / (tiles * 128);  // b * n_chunks + chunk
    const size_t row0 = (size_t)bk * chunk;
    const int tile = e / 128, l = (e / 4) % 32, v = e % 4;
    int i = 0;
    while ((i + 1) * (i + 2) <= tile) ++i;
    const int t = 16 * i + l / 4 + 8 * (v / 2);
    const int s = 8 * (tile - i * (i + 1)) + 2 * (l % 4) + v % 2;
    float acc = 0.f;
    if (t < chunk && s < chunk) {
      const float* cr = C + (row0 + t) * N;
      const float* br = B + (row0 + s) * N;
      for (int n = 0; n < N; ++n) acc = fmaf(__ldg(cr + n), __ldg(br + n), acc);
    }
    G[idx] = acc;
  }
}

// One CTA per (b, h, P tile); NT = N / 8 rounded up to even.
template <int NT>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const SsdArgs A) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kHt = NT / 2;  // state n tiles per warp: j = hj0 + 2 i
  static_assert(kWarps / kMt == 2, "two warps share each state m tile");
  const int c = A.chunk;
  const int rows = (c + 15) / 16 * 16;
  const int ldb = ld_bc(8 * NT);
  const int stage_floats = rows * (kLdx + 2 * ldb);
  const int nst = A.stages;
  // the state at the chunk's start, [kPt][ldb] each, as its TF32 hi and lo
  float* hs_hi = smem + nst * stage_floats;
  float* hs_lo = hs_hi + kPt * ldb;
  float* adt = hs_lo + kPt * ldb;      // [nst][a, dt][rows]
  float* prep_base = adt + 2 * nst * rows;  // [2][3][rows] two Prep buffers

  const int p0 = blockIdx.x * kPt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row / column group
  const int q = lane % 4;  // fragment k pair: physical k = 2q, 2q + 1
  const int n_chunks = A.S / c;
  const int m_tiles = rows / 16;

  // zeros for the padding (rows >= c, columns >= P or N) and h_0 = 0
  for (int i = threadIdx.x; i < nst * stage_floats + 2 * kPt * ldb; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  // the state tiles this warp carries: m tile hm, n tiles hj0 + 2 i
  const int hm = warp % kMt;
  const int hj0 = warp / kMt;
  float hacc[kHt][4];
#pragma unroll
  for (int i = 0; i < kHt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[i][e] = 0.f;

  // a and dt of chunk k sit in slot k & 1 of the ring (slot 0 with one
  // stage); a warp turns them into Prep k & 1 during chunk k - 1.  Two
  // stages: chunk k + 1's x, B, C and chunk k + 2's a, dt load while chunk k
  // computes.  One stage (when two would leave room for only one CTA per
  // SM): chunk k's x and C load at its start, its B during y, and the SM's
  // other CTA computes meanwhile.
  {
    load_decay(A, adt, adt + rows, 0, b, h);
    if (nst == 2) {
      load_chunk<8 * NT>(A, stage_at(smem, rows, ldb), 0, b, h, p0, ldb);
      if (n_chunks > 1) load_decay(A, adt + 2 * rows, adt + 3 * rows, 1, b, h);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) prep_chunk(adt, adt + rows, prep_at(prep_base, rows), c, rows, lane);
    __syncthreads();  // before iteration 0 copies into slot 0 again
  }

#ifdef SSD_PHASES
  long long phase_[5] = {0, 0, 0, 0, 0}, mark_ = clock64();
  const long long start_ = mark_;
#endif
  for (int k = 0; k < n_chunks; ++k) {
    if (nst == 2) {
      if (k + 1 < n_chunks) {
        load_chunk<8 * NT>(A, stage_at(smem + ((k + 1) & 1) * stage_floats, rows, ldb), k + 1,
                           b, h, p0, ldb);
        if (k + 2 < n_chunks) {
          float* a_s = adt + (k & 1) * 2 * rows;
          load_decay(A, a_s, a_s + rows, k + 2, b, h);
        }
      }
      cp_async_commit();  // possibly empty: keeps one group per chunk
      cp_async_wait_1();  // chunk k's group has landed
    } else {
      // x, C and the next a, dt first; B (read only by the state update)
      // lands while y computes
      load_chunk<8 * NT, true, false>(A, stage_at(smem, rows, ldb), k, b, h, p0, ldb);
      if (k + 1 < n_chunks) load_decay(A, adt, adt + rows, k + 1, b, h);
      cp_async_commit();
      load_chunk<8 * NT, false, true>(A, stage_at(smem, rows, ldb), k, b, h, p0, ldb);
      cp_async_commit();
      cp_async_wait_1();
    }
    __syncthreads();  // ... for every thread, and Prep k is written
    const Stage st = stage_at(smem + (nst == 2 ? (k & 1) * stage_floats : 0), rows, ldb);
    const Prep pr = prep_at(prep_base + (k & 1) * 3 * rows, rows);
    PHASE(0);
    const float* Gk = A.G + ((size_t)b * n_chunks + k) * gram_tiles(m_tiles) * 128;

    // y for this warp's m tiles, in snake order over the warps
    for (int r = 0; r * kWarps < m_tiles; ++r) {
      const int mi = (r % 2 == 0) ? r * kWarps + warp : r * kWarps + kWarps - 1 - warp;
      if (mi >= m_tiles) continue;
      const int t0 = 16 * mi;
      const int tA = t0 + g, tB = t0 + g + 8;
      float yacc[kPt / 8][4];
#pragma unroll
      for (int j = 0; j < kPt / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      // G tiles of m tile mi: 2 mi + 2 of them from tile mi (mi + 1), in
      // blocks of up to 8 (64 columns of s); the first block's loads are
      // in flight during the carried-state product below
      const float* Gm = Gk + (size_t)mi * (mi + 1) * 128;
      const int n_g = 2 * mi + 2;
      float4 gv[kSBlock];
      load_g(Gm, min(kSBlock, n_g), lane, gv);
      // y += (C exp(cum_t)) h_in^T over K = N
      const float decA = exp2f(pr.cum[tA]), decB = exp2f(pr.cum[tB]);
      const float* cA = st.Cm + tA * ldb;
      const float* cB = st.Cm + tB * ldb;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const int n0 = 8 * kk + 2 * q;
        const float2 ca = *reinterpret_cast<const float2*>(cA + n0);
        const float2 cb = *reinterpret_cast<const float2*>(cB + n0);
        const FragA fa = frag_a(ca.x * decA, cb.x * decB, ca.y * decA, cb.y * decB);
#pragma unroll
        for (int pn = 0; pn < kPt / 8; ++pn) {
          const int o = (8 * pn + g) * ldb + n0;
          const float2 hh = *reinterpret_cast<const float2*>(hs_hi + o);
          const float2 hl = *reinterpret_cast<const float2*>(hs_lo + o);
          FragB fb;
          fb.hi[0] = __float_as_uint(hh.x);
          fb.hi[1] = __float_as_uint(hh.y);
          fb.lo[0] = __float_as_uint(hl.x);
          fb.lo[1] = __float_as_uint(hl.y);
          mma3(yacc[pn], fa, fb);
        }
      }
      // y += (G decay) (dt x) over the s blocks up to the diagonal; the
      // last block is 2, 4, 6 or 8 n tiles wide
      for (int j0 = 0; j0 < n_g; j0 += kSBlock) {
        if (j0) load_g(Gm + j0 * 128, min(kSBlock, n_g - j0), lane, gv);
        switch (min(kSBlock, n_g - j0)) {
          case 8: y_intra<8>(st, pr, gv, 8 * j0, tA, tB, g, q, yacc); break;
          case 6: y_intra<6>(st, pr, gv, 8 * j0, tA, tB, g, q, yacc); break;
          case 4: y_intra<4>(st, pr, gv, 8 * j0, tA, tB, g, q, yacc); break;
          default: y_intra<2>(st, pr, gv, 8 * j0, tA, tB, g, q, yacc); break;
        }
      }
      // store rows tA, tB (< c) at columns p0 + 8 pn + 2q (+1) (< P)
      const size_t rowA = (((size_t)b * A.S + (size_t)k * c + tA) * A.H + h) * A.P;
      const size_t rowB = rowA + (size_t)8 * A.H * A.P;
#pragma unroll
      for (int pn = 0; pn < kPt / 8; ++pn) {
        const int p = p0 + 8 * pn + 2 * q;
        if (tA < c) {
          if (p < A.P) A.y[rowA + p] = yacc[pn][0];
          if (p + 1 < A.P) A.y[rowA + p + 1] = yacc[pn][1];
        }
        if (tB < c) {
          if (p < A.P) A.y[rowB + p] = yacc[pn][2];
          if (p + 1 < A.P) A.y[rowB + p + 1] = yacc[pn][3];
        }
      }
    }

    PHASE(1);
    if (nst == 1) {  // B has landed, for every thread
      cp_async_wait_all();
      __syncthreads();
    }
    // h = exp(cum_last) h + (dt exp(cum_last - cum_s) x)^T B over K = s
    {
      const float dlast = exp2f(pr.cum[c - 1]);
#pragma unroll
      for (int i = 0; i < kHt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][e] *= dlast;
      const int pa = 16 * hm + g;
      for (int kk = 0; kk < rows / 8; ++kk) {
        const int s0 = 8 * kk + 2 * q, s1 = s0 + 1;
        const float w0 = pr.wtail[s0], w1 = pr.wtail[s1];
        const float* x0 = st.x + s0 * kLdx + pa;
        const float* x1 = st.x + s1 * kLdx + pa;
        const FragA fa = frag_a(x0[0] * w0, x0[8] * w0, x1[0] * w1, x1[8] * w1);
        const float* b0 = st.Bm + s0 * ldb + 8 * hj0 + g;
        const float* b1 = st.Bm + s1 * ldb + 8 * hj0 + g;
#pragma unroll
        for (int i = 0; i < kHt; ++i) mma3(hacc[i], fa, frag_b(b0[16 * i], b1[16 * i]));
      }
    }
    PHASE(2);
    // chunk k + 1's Prep, by the warp with the least y work: the last when
    // some warps have no m tile, else warp 0 (m tile 0 at chunk 64)
    if (warp == (m_tiles < kWarps ? kWarps - 1 : 0) && k + 1 < n_chunks) {
      const float* a_s = adt + (nst == 2 ? ((k + 1) & 1) * 2 * rows : 0);
      prep_chunk(a_s, a_s + rows, prep_at(prep_base + ((k + 1) & 1) * 3 * rows, rows), c, rows,
                 lane);
    }
    PHASE(3);
    __syncthreads();  // every read of hs, the stage and Prep k is done
#pragma unroll
    for (int i = 0; i < kHt; ++i) {
      const int p = 16 * hm + g, n = 8 * (hj0 + 2 * i) + 2 * q;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(hacc[i][e], hi[e], lo[e]);
      *reinterpret_cast<uint2*>(hs_hi + p * ldb + n) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(hs_hi + (p + 8) * ldb + n) = make_uint2(hi[2], hi[3]);
      *reinterpret_cast<uint2*>(hs_lo + p * ldb + n) = make_uint2(lo[0], lo[1]);
      *reinterpret_cast<uint2*>(hs_lo + (p + 8) * ldb + n) = make_uint2(lo[2], lo[3]);
    }
    PHASE(4);
  }
#ifdef SSD_PHASES
  if (lane == 0) {
    long long* out = A.phases + (((size_t)b * gridDim.y + h) * gridDim.x + blockIdx.x) * kWarps * 6 +
                     warp * 6;
    for (int i = 0; i < 5; ++i) out[i] = phase_[i];
    out[5] = clock64() - start_;
  }
#endif
}

template <int NT>
int launch_nt(const SsdArgs& A, int Bt, size_t smem, cudaStream_t stream) {
  const int tiles = gram_tiles(round_up(A.chunk, 16) / 16);
  const long long total = (long long)Bt * (A.S / A.chunk) * tiles * 128;
  ssd_gram_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      A.B, A.C, const_cast<float*>(A.G), A.S, A.N, A.chunk, tiles, total);
  cudaError_t e0 = cudaGetLastError();
  if (e0 != cudaSuccess) return (int)e0;
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)  // all of the SM's 228 KB as shared memory
    e = cudaFuncSetAttribute(ssd_chunk_kernel<NT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((A.P + kPt - 1) / kPt, A.H, Bt);
  ssd_chunk_kernel<NT><<<grid, kThreads, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the Gram workspace the wrapper allocates for one call.
long long ssd_scan_workspace_floats(int Bt, int S, int chunk) {
  return (long long)Bt * (S / chunk) * gram_tiles(round_up(chunk, 16) / 16) * 128;
}

// Dynamic shared memory of one CTA at this chunk and state size N.
long long ssd_scan_smem_bytes(int chunk, int n) { return (long long)smem_bytes(chunk, n); }

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef SSD_PHASES
// Where the next launch writes its phase cycles: (Bt, H, P tiles, warps, 6).
void ssd_scan_set_phases(long long* phases) { g_phases = phases; }
#endif

// Launches the Gram pass and the scan on `stream`; returns the cudaError_t
// of the launches (0 = success).  chunk must divide S; N is at most 128 and
// the shared memory must fit; workspace holds ssd_scan_workspace_floats.
int ssd_scan_launch(const float* x, const float* B, const float* C, const float* a,
                    const float* dt, float* y, float* workspace, int Bt, int S, int H, int P,
                    int N, int chunk, void* stream) {
  if (Bt < 1 || Bt > 65535 || S < 1 || H < 1 || H > 65535 || P < 1 || N < 1 || N > kMaxN ||
      chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(chunk, N);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  SsdArgs A;
  A.x = x;
  A.B = B;
  A.C = C;
  A.a = a;
  A.dt = dt;
  A.G = workspace;
  A.y = y;
  A.S = S;
  A.H = H;
  A.P = P;
  A.N = N;
  A.chunk = chunk;
  A.stages = stages_for(chunk, N);
#ifdef SSD_PHASES
  A.phases = g_phases;
#endif
  A.vec_x = P % 4 == 0 && (uintptr_t)x % 16 == 0;
  A.vec_bc = N % 4 == 0 && ((uintptr_t)B | (uintptr_t)C) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (round_up(N, 16) / 8) {
    case 2: return launch_nt<2>(A, Bt, smem, s);
    case 4: return launch_nt<4>(A, Bt, smem, s);
    case 6: return launch_nt<6>(A, Bt, smem, s);
    case 8: return launch_nt<8>(A, Bt, smem, s);
    case 10: return launch_nt<10>(A, Bt, smem, s);
    case 12: return launch_nt<12>(A, Bt, smem, s);
    case 14: return launch_nt<14>(A, Bt, smem, s);
    case 16: return launch_nt<16>(A, Bt, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
