// Reverse delta chain of the folded + factored DR-NMF recurrence (the
// backward of kernel B1), the whole reverse time scan in one cooperative
// launch.
//
// The port's own kernel: the JAX package runs this chain as an XLA scan
// (drnmf_tpu/models/batched_grad.py::_bwd, back_step :99-121); no Pallas
// kernel there has a backward.  Per step t from T-1 down to 0, with gamma
// the gradient that reaches the carry h_t from the later steps, g_t the
// loss's gradient of the step's output, m_t the step mask and h_k the
// forward's layer-k hidden state before the hold (B1's h_all):
//
//   go  = g_t + gamma;   g_h = go*m_t;   gamma' = go*(1 - m_t)
//   for k = K-1 .. 1:
//     d_k = g_h * (h_k > 0)
//     p   = d_k @ dka_k^T                 (a contraction over N = 2r)
//     g_h = d_k - p @ dk_k                (a contraction over F)
//     gamma' += c*rowsum(d_k)
//   d_0 = g_h * (h_0 > 0)
//   gamma' += d_0*(diag1 - off1) + off1*rowsum(d_0)
//
// Outputs: the deltas d_k in h_all's layout (K, N, T*Bp), each step's p
// (K-1, F, T*Bp), which the weight gradients reuse instead of recomputing
// it, and gamma after step 0 (the gradient of h0), (N, Bp).
//
// What bounds it on an H100.  Per row and step 2(K-1) thin products of
// 2*F*N flops (8.2 MFLOP at K=5, F=257, N=2000) against weights (dka^T and
// dk of layers 1..K-1: 16.4 MB in f32) that fit the 50 MB L2; the bytes are
// h_all read once and the deltas written once (640 MB each at B=32, T=500,
// K=5), so at the training batch the bytes bound it (0.45 ms against 1.9 ms
// of f32 CUDA-core operations).  What sets the pace at 32 rows is the chain
// of dependent phases: a grid synchronisation between phases (1.1 us each)
// and the round trips to L2 inside each.
//
// What this design does about it.  N is cut into stripes of W columns
// (W = 16: 125 stripes at the flagship), and block b owns stripes b,
// b+grid, ... for every layer and step, so the deltas of a stripe, their
// rowsums and the weights that touch them stay with one block.  Phases of
// step t (1 + 2(K-1) grid syncs a step, 9 at K = 5):
//
//   A    on its stripe: gamma of step t+1 finished (go*(1-m) and d_0 of
//        step t+1 are the stripe's own; the per-row total is the sum, in
//        stripe order, of the per-stripe totals of step t+1), then go,
//        g_h and d_{K-1}; and at once the stripe's partial back-projection
//        part[s] = d_{K-1}[:, stripe] @ dka_{K-1}^T[stripe, :] (Bp x F, a
//        contraction of W).
//   R_k  p_k = part[0] + ... + part[S-1], elementwise over (F, Bp), in
//        chunks of stripes whose sums a second pass adds in chunk order,
//        every load of a chunk in flight; into p_all.
//   P_k  the block copies p_k's row tile into shared memory, then computes
//        d_{k-1}[:, stripe] = (d_k - p_k @ dk_k[:, stripe]) * (h_{k-1} > 0),
//        the contraction over F cut into fixed sub-stretches added in
//        order, and (k-1 >= 1) in the same phase its partial
//        back-projection of d_{k-1} (its own stripe: no sync between).
//        After P_1 (which yields d_0) it writes one number a row for its
//        stripe, c*sum_{k>=1} rs(d_k) + off1*rs(d_0), which the next
//        step's A sums over the stripes: no phase of its own for the
//        rowsums.
//
// Every phase issues all of its operands (activations, the stripe's
// weights, the p tile, the row totals) as 16-byte cp.async copies before
// one wait.  Two instances: "streamed" copies the stripe's weights of the
// phase's layers from L2 with the phase's operands; "resident" keeps every
// later layer's stripe of dk and dka^T in shared memory for the whole scan
// (2 x (K-1) x W x F floats: 133 KB at the flagship), where the bytes fit
// and the grid covers every stripe (the wrapper's plan decides).  After
// step 0 one more phase writes gamma.  K = 1 runs A only and reads no
// weights.
//
// Inside a phase (256 threads, up to 255 registers, no spills): the
// projection in thread tiles of 4 stripe columns x 8 rows, one
// sub-stretch each; the back-projection in tiles of 8 rows x 4 columns of
// F, staged in shared memory and stored a whole row at a time; R one
// (position, chunk) a thread, consecutive threads on consecutive positions
// of a stripe.  Every loop with a large body stays rolled (or unrolled
// twice): the phases run one after another, and a wholly unrolled 16-deep
// back-projection was fetched from L2 again in every phase.
// tools/bwd_variants.py times the instances, W = 32 (a copy of this
// source with W patched), and (built with -DBWD_TRACE) where each phase's
// cycles go.
//
// Invariants.  Every output element is summed by one thread in a fixed
// order: a partial back-projection over the stripe's W columns ascending;
// p over the stripes ascending, in chunks of `chunk` stripes, the chunks
// then added in order; a projection over F in sub-stretches of `sub`
// depths, each ascending, the sub-stretches then added in order; a
// stripe's rowsum over its columns ascending, the row total over stripes
// as p is.  No float atomics, so a repeat is bit-equal; W, the
// sub-stretches and the chunks are fixed by (F, 2r), so a row's bits do not
// depend on the batch, the grid or the instance.  Rows past B read a zero
// gradient and a zero mask, so their deltas and gamma stay zero; stripe
// columns past N read zeros and are never written.  What another block
// wrote is read through L2 (cp.async.cg).  f32 FMA on the CUDA cores; no
// tensor cores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller hands it outputs and scratch), returns the
// CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int W = 16;          // columns of N a stripe holds
constexpr int MAX_CHUNKS = 32;  // most chunks of a cross-stripe sum
constexpr int BATCH = 16;      // loads of a chunk issued before their adds
static_assert(W % 4 == 0 && W >= 4 && W <= 64, "W: a multiple of 4");

// Phase tracing, built only with -DBWD_TRACE (tools/bwd_variants.py):
// thread 0 of every block writes clock64() at marks of each phase of the
// first traced steps (0 phase start, 1 operands in shared memory, 2
// product done, 3 epilogue done, 4 work done, 5 past the grid sync; and
// thread 0's back-projection: 6 start, 7 sums done, 8 stores issued) into
// [step][phase][block][MARKS].
constexpr int MARKS = 9;
#ifdef BWD_TRACE
__device__ long long* trace_buf;
__device__ int trace_steps;
#define MARK(ph, mark, t)                                                   \
  do {                                                                      \
    const int st_ = p.T - 1 - (t);                                          \
    if (threadIdx.x == 0 && st_ < trace_steps)                              \
      trace_buf[(((size_t)st_ * (2 * p.K - 1) + (ph)) * gridDim.x +         \
                 blockIdx.x) * MARKS + (mark)] = clock64();                 \
  } while (0)
#else
#define MARK(ph, mark, t) \
  do {                    \
    (void)(ph);           \
  } while (0)
#endif

struct Params {
  const float* g;             // (T, N, Bp): the output's gradient, 0 past B
  const unsigned char* mask;  // (T, Bp): the step mask, 0 past B
  const float* h_all;         // (K, N, T*Bp): the forward's layers
  const float* diag1;         // (S*W): 0 past N
  const float* off1;          // (1)
  const float* c_uk;          // (1)
  const float* wdkat;         // (K-1, S, W, Fp): dka_k^T by stripe, 0-padded
                              // (Fp: F rounded up to 4)
  const float* wdk;           // (K-1, S, F, W): Dhat_k by stripe, 0-padded
  float* delta;               // (K, N, T*Bp): out
  float* p_all;               // (K-1, F, T*Bp): out
  float* gb;                  // (N, Bp): go*(1-m) of the step last done
  float* part;                // (S, F, Bp): the stripes' back-projections
  float* rsu;                 // (S, Bp): the stripe's rowsums of d_{K-1..k}
  float* rowtot;              // (2, S, Bp): per-stripe row totals, by t & 1
  float* gamma;               // (N, Bp): out
  int B, Bp, T, F, Fp, N, K;
  int stripes, sub, subs, chunk, chunks;
};

// Shared-memory floats a block takes (the wrapper's plan asks for them
// through drnmf_scan_factored_backward_smem): a p tile or the row totals,
// the sub-stretch partials, the chunk partials, four W x RT tiles, two RT
// vectors, the step's mask (RT bytes, in RT floats' room), the stripe's
// diag1, and the weight stripes (one layer's pair streamed, every later
// layer's resident).
__host__ __device__ inline size_t layout_floats(int rt, bool resident, int F,
                                                int Fp, int S, int K,
                                                int subs) {
  size_t n = (size_t)(F > S ? F : S) * rt + (size_t)subs * W * rt +
             (size_t)MAX_CHUNKS * rt + 4 * (size_t)W * rt + 3 * (size_t)rt +
             W;
  const size_t pair = (size_t)F * W + (size_t)W * Fp;
  if (K > 1) n += resident ? (size_t)(K - 1) * pair : pair;
  return n;
}

struct Smem {
  float* big;  // [F][RT] p tile, or [S][RT] row totals
  float* red;  // [subs][W][RT] projection partials
  float* tch;  // [MAX_CHUNKS][RT] chunk partials of the row totals
  float* sd;   // [W][RT] the stripe's delta
  float* sa;   // [W][RT] A: g; P: h_{k-1}
  float* sb;   // [W][RT] A: gb
  float* sc;   // [W][RT] A: d_0 of step t+1
  float* tot;  // [RT] row totals
  float* rs;   // [RT] the stripe's rowsums so far
  unsigned char* msk;  // [RT] the step's mask
  float* dg;   // [W] the stripe's diag1
  float* w;    // weight stripes: [F][W] dk, then [W][Fp] dka^T (by layer)
};

template <int RT>
__device__ __forceinline__ Smem carve(float* s, const Params& p) {
  Smem m;
  m.big = s;
  s += (size_t)(p.F > p.stripes ? p.F : p.stripes) * RT;
  m.red = s;
  s += (size_t)p.subs * W * RT;
  m.tch = s;
  s += MAX_CHUNKS * RT;
  m.sd = s;
  m.sa = s + W * RT;
  m.sb = s + 2 * W * RT;
  m.sc = s + 3 * W * RT;
  s += 4 * W * RT;
  m.tot = s;
  m.rs = s + RT;
  m.msk = reinterpret_cast<unsigned char*>(s + 2 * RT);
  m.dg = s + 3 * RT;
  m.w = s + 3 * RT + W;
  return m;
}

// The weight stripes of layer k (1..K-1) in shared memory.
template <bool RES>
__device__ __forceinline__ const float* dk_of(const Smem& m, const Params& p,
                                              int k) {
  return RES ? m.w + (size_t)(k - 1) * ((size_t)p.F * W + (size_t)W * p.Fp)
             : m.w;
}
template <bool RES>
__device__ __forceinline__ const float* dkat_of(const Smem& m,
                                                const Params& p, int k) {
  return dk_of<RES>(m, p, k) + (size_t)p.F * W;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Wait for every copy this thread issued, then for the block's.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// rows x len floats (len a multiple of 4) into dst, row r from src +
// r*stride; rows from `valid` on are zero-filled.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int rows, int len, size_t stride,
                                          int valid) {
  const int q = len / 4;
  for (int i = threadIdx.x; i < rows * q; i += THREADS) {
    const int r = i / q;
    const int c = (i % q) * 4;
    const bool ok = r < valid;
    cp16(dst + r * len + c, ok ? src + (size_t)r * stride + c : src, ok);
  }
}

// n floats (a multiple of 4) from src into dst.
__device__ __forceinline__ void copy_flat(float* dst, const float* src,
                                          size_t n) {
  for (size_t i = (size_t)threadIdx.x * 4; i < n; i += THREADS * 4)
    cp16(dst + i, src + i, true);
}

// The stripe's weights into the streamed slots: dk of layer k_dk and
// dka^T of layer k_dkat (1..K-1 each; 0 copies none).  A phase P_k
// projects with dk_k and back-projects with dka_{k-1}^T.
__device__ __forceinline__ void copy_weights(const Smem& m, const Params& p,
                                             int s, int k_dk, int k_dkat) {
  const size_t dk_n = (size_t)p.F * W, dkat_n = (size_t)W * p.Fp;
  if (k_dk > 0)
    copy_flat(m.w, p.wdk + ((size_t)(k_dk - 1) * p.stripes + s) * dk_n, dk_n);
  if (k_dkat > 0)
    copy_flat(m.w + dk_n,
              p.wdkat + ((size_t)(k_dkat - 1) * p.stripes + s) * dkat_n,
              dkat_n);
}

// a[0] + a[stride] + ... + a[(n-1)*stride] in that order (n >= 1), the
// loads of each batch of 8 issued before its adds.
__device__ __forceinline__ float ordered_sum(const float* a, int n,
                                             int stride) {
  float v = a[0];
  for (int i = 1; i < n; i += 8) {
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = i + j < n ? a[(i + j) * stride] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + j < n) v += b[j];
  }
  return v;
}

// Row totals of the tile: tot[row] = sum over stripes of big[s][row], in
// chunks of p.chunk stripes (each ascending), the chunks added in order.
template <int RT>
__device__ __forceinline__ void row_totals(const Smem& m, const Params& p) {
  for (int u = threadIdx.x; u < p.chunks * RT; u += THREADS) {
    const int row = u % RT;
    const int ch = u / RT;
    const int s0 = ch * p.chunk;
    const int s1 = min(p.stripes, s0 + p.chunk);
    m.tch[ch * RT + row] = ordered_sum(m.big + s0 * RT + row, s1 - s0, RT);
  }
  __syncthreads();
  if (threadIdx.x < RT)
    m.tot[threadIdx.x] = ordered_sum(m.tch + threadIdx.x, p.chunks, RT);
  __syncthreads();
}

// The stripe's rowsum of sd, its columns ascending: rs(d) of each row.
template <int RT>
__device__ __forceinline__ float stripe_rowsum(const Smem& m, int row) {
  float v = m.sd[row];
#pragma unroll
  for (int j = 1; j < W; ++j) v += m.sd[j * RT + row];
  return v;
}

// part[s][:, rows rt0..] = d[:, stripe] @ dka_k^T[stripe, :], each sum over
// the W columns ascending: thread tiles of 8 rows x 4 columns of F over the
// first F - F%4 columns (256 tiles at F = 257 and 32 rows: one a thread),
// one thread an output past them; staged in shared memory (the p tile's
// room, free by now), then written a whole row of the tile at a time.
template <int RT>
__device__ __forceinline__ void back_project(const Smem& m, const Params& p,
                                             const float* wka, int s,
                                             int rt0, int ph, int t) {
  constexpr int RO = RT / 8;
  const int f4 = p.F / 4 * 4;
  const int tiles = RO * (f4 / 4);
  MARK(ph, 6, t);
  for (int u = threadIdx.x; u < tiles; u += THREADS) {
    const int ro = u % RO;
    const int f0 = (u / RO) * 4;
    float acc[4][8] = {};  // [column of F][row]
#pragma unroll 2
    for (int j = 0; j < W; ++j) {
      const float4 d0 = *reinterpret_cast<const float4*>(m.sd + j * RT + ro * 8);
      const float4 d1 =
          *reinterpret_cast<const float4*>(m.sd + j * RT + ro * 8 + 4);
      const float4 w = *reinterpret_cast<const float4*>(wka + j * p.Fp + f0);
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          acc[a][b] = fmaf(dv[b], wv[a], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* o = m.big + (f0 + a) * RT + ro * 8;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    }
  }
  for (int e = threadIdx.x; e < (p.F - f4) * RT; e += THREADS) {
    const int f = f4 + e / RT;
    const int row = e % RT;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) v = fmaf(m.sd[j * RT + row], wka[j * p.Fp + f], v);
    m.big[f * RT + row] = v;
  }
  MARK(ph, 7, t);
  __syncthreads();
  float* out = p.part + (size_t)s * p.F * p.Bp + rt0;
  for (int i = threadIdx.x; i < p.F * (RT / 4); i += THREADS) {
    const int f = i / (RT / 4);
    const int q = (i % (RT / 4)) * 4;
    *reinterpret_cast<float4*>(out + (size_t)f * p.Bp + q) =
        *reinterpret_cast<const float4*>(m.big + f * RT + q);
  }
  MARK(ph, 8, t);
}

// red[u][j][row] = sum over f in sub-stretch u of p[f][row] * dk[f][j]:
// thread tiles of 4 stripe columns x 8 rows, one sub-stretch each.
template <int RT>
__device__ __forceinline__ void project(const Smem& m, const Params& p,
                                        const float* wk) {
  constexpr int CQ = W / 4;
  constexpr int RO = RT / 8;
  constexpr int TILES = CQ * RO;
  for (int u = threadIdx.x; u < TILES * p.subs; u += THREADS) {
    const int tile = u % TILES;
    const int sub = u / TILES;
    const int cq = tile % CQ;
    const int ro = tile / CQ;
    const int f0 = sub * p.sub;
    const int f1 = min(p.F, f0 + p.sub);
    float acc[4][8] = {};  // [stripe column][row]
#pragma unroll 4
    for (int f = f0; f < f1; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(m.big + f * RT + ro * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(m.big + f * RT + ro * 8 + 4);
      const float4 w = *reinterpret_cast<const float4*>(wk + f * W + cq * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[c][r] = fmaf(av[r], wv[c], acc[c][r]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* o = m.red + ((size_t)sub * W + cq * 4 + c) * RT + ro * 8;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
    }
  }
}

// Phase A for (stripe s, rows rt0..): gamma of step t+1, go, gb, d_{K-1},
// its rowsums and (K > 1) its partial back-projection.
template <int RT, bool RES>
__device__ void top_phase(const Smem& m, const Params& p, int t, int s,
                          int rt0) {
  const int N = p.N, Bp = p.Bp, K = p.K;
  const size_t tbp = (size_t)p.T * Bp;
  const bool later = t + 1 < p.T;
  const int c0 = s * W;
  const int cols = min(W, N - c0);
  copy_tile(m.sa, p.g + ((size_t)t * N + c0) * Bp + rt0, W, RT, Bp, cols);
  copy_tile(m.sd, p.h_all + ((size_t)(K - 1) * N + c0) * tbp +
                      (size_t)t * Bp + rt0, W, RT, tbp, cols);
  if (later) {
    copy_tile(m.sb, p.gb + (size_t)c0 * Bp + rt0, W, RT, Bp, cols);
    copy_tile(m.sc, p.delta + (size_t)c0 * tbp + (size_t)(t + 1) * Bp + rt0,
              W, RT, tbp, cols);
    copy_tile(m.big, p.rowtot + (size_t)((t + 1) & 1) * p.stripes * Bp + rt0,
              p.stripes, RT, Bp, p.stripes);
  }
  if (threadIdx.x < RT / 16)
    cp16(m.msk + threadIdx.x * 16, p.mask + (size_t)t * Bp + rt0 + threadIdx.x * 16,
         true);
  if (later) copy_flat(m.dg, p.diag1 + c0, W);
  if (!RES && K > 1) copy_weights(m, p, s, 0, K - 1);
  cp_wait();
  MARK(0, 1, t);
  if (later) row_totals<RT>(m, p);
  MARK(0, 2, t);

  const float off1 = __ldg(p.off1);
  float* d_top = p.delta + (size_t)(K - 1) * N * tbp + (size_t)t * Bp + rt0;
  for (int e = threadIdx.x; e < W * RT; e += THREADS) {
    const int j = e / RT;
    const int row = e % RT;
    const int c = c0 + j;
    const int r = rt0 + row;
    float gamma = 0.f;
    if (later && c < N)
      gamma = m.sb[e] + m.sc[e] * (m.dg[j] - off1) + m.tot[row];
    const float go = m.sa[e] + gamma;
    const bool valid = m.msk[row] != 0;
    const float d = (valid && m.sd[e] > 0.f) ? go : 0.f;
    if (c < N) {
      p.gb[(size_t)c * Bp + r] = valid ? 0.f : go;
      d_top[(size_t)c * tbp + row] = d;
    }
    m.sd[e] = d;  // this thread read the h it replaces
  }
  __syncthreads();
  MARK(0, 3, t);
  if (threadIdx.x >= THREADS - RT) {  // warps past the back-projection's
    const int row = threadIdx.x - (THREADS - RT);
    const float v = stripe_rowsum<RT>(m, row);
    const size_t at = (size_t)s * Bp + rt0 + row;
    if (K > 1)
      p.rsu[at] = v;
    else
      p.rowtot[(size_t)(t & 1) * p.stripes * Bp + at] = off1 * v;
  }
  if (K > 1) back_project<RT>(m, p, dkat_of<RES>(m, p, K - 1), s, rt0, 0, t);
  __syncthreads();  // shared memory is reused by the next item
}

// R_k: p_k = part[0] + ... + part[S-1] over the (F, Bp) plane, as float4
// positions: block b sums a contiguous run of positions, each thread one
// (position, chunk) pair, consecutive threads consecutive positions of one
// stripe; the chunks' sums go through shared memory, then one thread a
// position adds them in chunk order.
template <int RT>
__device__ void sum_phase(const Smem& m, const Params& p, int t, int k) {
  const int Bp = p.Bp;
  const int quads = p.F * Bp / 4;
  const int per = (quads + gridDim.x - 1) / gridDim.x;
  const int q0 = blockIdx.x * per;
  const int q1 = min(quads, q0 + per);
  // positions one pass holds: the p tile's room, by chunk
  const int cap = (p.F > p.stripes ? p.F : p.stripes) * RT / 4 / p.chunks;
  const size_t fb = (size_t)p.F * Bp;
  const size_t tbp = (size_t)p.T * Bp;
  float4* red = reinterpret_cast<float4*>(m.big);
  float* p_t = p.p_all + (size_t)(k - 1) * p.F * tbp + (size_t)t * Bp;
  for (int a = q0; a < q1; a += cap) {
    const int np = min(cap, q1 - a);
    for (int u = threadIdx.x; u < np * p.chunks; u += THREADS) {
      const int i = u % np;
      const int ch = u / np;
      const float* src = p.part + (size_t)(a + i) * 4;
      const int s0 = ch * p.chunk;
      const int s1 = min(p.stripes, s0 + p.chunk);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = s0; s < s1; s += BATCH) {
        float4 buf[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          if (s + j < s1)
            buf[j] = __ldcg(reinterpret_cast<const float4*>(
                src + (size_t)(s + j) * fb));
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          if (s + j >= s1) break;
          if (s + j == s0) {
            v = buf[j];
          } else {
            v.x += buf[j].x;
            v.y += buf[j].y;
            v.z += buf[j].z;
            v.w += buf[j].w;
          }
        }
      }
      red[(size_t)ch * np + i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += THREADS) {
      float4 v = red[i];
      for (int c = 1; c < p.chunks; c += 8) {
        float4 o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < p.chunks) o[j] = red[(size_t)(c + j) * np + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c + j >= p.chunks) break;
          v.x += o[j].x;
          v.y += o[j].y;
          v.z += o[j].z;
          v.w += o[j].w;
        }
      }
      const int q = a + i;
      *reinterpret_cast<float4*>(p_t + (size_t)(q / (Bp / 4)) * tbp +
                                 (q % (Bp / 4)) * 4) = v;
    }
    __syncthreads();
  }
}

// P_k for (stripe s, rows rt0..): d_{k-1} of the stripe, its rowsums and
// (k > 1) its partial back-projection; after P_1 the stripe's row totals.
template <int RT, bool RES>
__device__ void project_phase(const Smem& m, const Params& p, int t, int k,
                              int s, int rt0) {
  const int N = p.N, Bp = p.Bp;
  const size_t tbp = (size_t)p.T * Bp;
  const size_t step = (size_t)t * Bp + rt0;
  const int c0 = s * W;
  const int cols = min(W, N - c0);
  const int ph = 2 + 2 * (p.K - 1 - k);  // the phase's index in its step
  copy_tile(m.big, p.p_all + (size_t)(k - 1) * p.F * tbp + step, p.F, RT, tbp,
            p.F);
  copy_tile(m.sd, p.delta + ((size_t)k * N + c0) * tbp + step, W, RT, tbp,
            cols);
  copy_tile(m.sa, p.h_all + ((size_t)(k - 1) * N + c0) * tbp + step, W, RT,
            tbp, cols);
  copy_flat(m.rs, p.rsu + (size_t)s * Bp + rt0, RT);
  if (!RES) copy_weights(m, p, s, k, k - 1);
  cp_wait();
  MARK(ph, 1, t);
  project<RT>(m, p, dk_of<RES>(m, p, k));
  __syncthreads();
  MARK(ph, 2, t);

  float* d_out = p.delta + (size_t)(k - 1) * N * tbp + step;
  for (int e = threadIdx.x; e < W * RT; e += THREADS) {
    const int j = e / RT;
    const int row = e % RT;
    const float v = ordered_sum(m.red + j * RT + row, p.subs, W * RT);
    const float d = m.sa[e] > 0.f ? m.sd[e] - v : 0.f;
    if (c0 + j < N) d_out[(size_t)(c0 + j) * tbp + row] = d;
    m.sd[e] = d;  // this thread read the d_k it replaces
  }
  __syncthreads();
  MARK(ph, 3, t);
  if (threadIdx.x >= THREADS - RT) {  // warps past the back-projection's
    const int row = threadIdx.x - (THREADS - RT);
    const float v = stripe_rowsum<RT>(m, row);
    const size_t at = (size_t)s * Bp + rt0 + row;
    if (k > 1)
      p.rsu[at] = m.rs[row] + v;
    else
      p.rowtot[(size_t)(t & 1) * p.stripes * Bp + at] =
          __ldg(p.c_uk) * m.rs[row] + __ldg(p.off1) * v;
  }
  if (k > 1)
    back_project<RT>(m, p, dkat_of<RES>(m, p, k - 1), s, rt0, ph, t);
  __syncthreads();  // shared memory is reused by the next item
}

// After step 0: gamma = go*(1-m) + d_0*(diag1 - off1) + the row total.
template <int RT>
__device__ void gamma_phase(const Smem& m, const Params& p, int s, int rt0) {
  const int N = p.N, Bp = p.Bp;
  const size_t tbp = (size_t)p.T * Bp;
  const int c0 = s * W;
  const int cols = min(W, N - c0);
  copy_tile(m.sb, p.gb + (size_t)c0 * Bp + rt0, W, RT, Bp, cols);
  copy_tile(m.sc, p.delta + (size_t)c0 * tbp + rt0, W, RT, tbp, cols);
  copy_tile(m.big, p.rowtot + rt0, p.stripes, RT, Bp, p.stripes);
  copy_flat(m.dg, p.diag1 + c0, W);
  cp_wait();
  row_totals<RT>(m, p);
  const float off1 = __ldg(p.off1);
  for (int e = threadIdx.x; e < W * RT; e += THREADS) {
    const int j = e / RT;
    const int row = e % RT;
    if (c0 + j < N)
      p.gamma[(size_t)(c0 + j) * Bp + rt0 + row] =
          m.sb[e] + m.sc[e] * (m.dg[j] - off1) + m.tot[row];
  }
  __syncthreads();
}

template <int RT, bool RES>
__global__ void __launch_bounds__(THREADS)
drnmf_scan_factored_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Smem m = carve<RT>(smem, p);
  cg::grid_group grid = cg::this_grid();

  if (RES) {  // one stripe a block: its weights of every later layer
    for (int k = 1; k < p.K; ++k) {
      const size_t dk_n = (size_t)p.F * W, dkat_n = (size_t)W * p.Fp;
      const size_t at = (size_t)(k - 1) * p.stripes + blockIdx.x;
      copy_flat(const_cast<float*>(dk_of<true>(m, p, k)), p.wdk + at * dk_n,
                dk_n);
      copy_flat(const_cast<float*>(dkat_of<true>(m, p, k)),
                p.wdkat + at * dkat_n, dkat_n);
    }
    cp_wait();
  }
  for (int t = p.T - 1; t >= 0; --t) {
    for (int s = blockIdx.x; s < p.stripes; s += gridDim.x)
      for (int rt0 = 0; rt0 < p.Bp; rt0 += RT) {
        MARK(0, 0, t);
        top_phase<RT, RES>(m, p, t, s, rt0);
      }
    MARK(0, 4, t);
    grid.sync();
    MARK(0, 5, t);
    for (int k = p.K - 1; k >= 1; --k) {
      const int ph = 1 + 2 * (p.K - 1 - k);
      MARK(ph, 0, t);
      sum_phase<RT>(m, p, t, k);
      MARK(ph, 4, t);
      grid.sync();
      MARK(ph, 5, t);
      MARK(ph + 1, 0, t);
      for (int s = blockIdx.x; s < p.stripes; s += gridDim.x)
        for (int rt0 = 0; rt0 < p.Bp; rt0 += RT)
          project_phase<RT, RES>(m, p, t, k, s, rt0);
      MARK(ph + 1, 4, t);
      grid.sync();
      MARK(ph + 1, 5, t);
    }
  }
  for (int s = blockIdx.x; s < p.stripes; s += gridDim.x)
    for (int rt0 = 0; rt0 < p.Bp; rt0 += RT) gamma_phase<RT>(m, p, s, rt0);
}

using Kernel = void (*)(Params);

Kernel pick(int rt, int resident) {
  if (rt == 16) return resident ? drnmf_scan_factored_bwd_kernel<16, true>
                                : drnmf_scan_factored_bwd_kernel<16, false>;
  if (rt == 32) return resident ? drnmf_scan_factored_bwd_kernel<32, true>
                                : drnmf_scan_factored_bwd_kernel<32, false>;
  return nullptr;
}

}  // namespace

#ifdef BWD_TRACE
// Where the marks go: `steps` steps of [2K-1][grid][6] int64 at `buf`.
extern "C" int drnmf_scan_factored_backward_trace(long long* buf, int steps) {
  cudaError_t err = cudaMemcpyToSymbol(trace_buf, &buf, sizeof(buf));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(trace_steps, &steps, sizeof(steps));
  return (int)err;
}
#endif

// Dynamic shared-memory bytes of one block of the (rt, resident) instance
// at F, S stripes, K layers and `subs` sub-stretches (layout_floats: the
// one definition of the layout, which the wrapper's plan asks for).
extern "C" int drnmf_scan_factored_backward_smem(int rt, int resident, int F,
                                                  int S, int K, int subs) {
  return (int)(4 * layout_floats(rt, resident != 0, F, (F + 3) / 4 * 4, S, K,
                                 subs));
}

// The most dynamic shared memory a block may take on the current device
// (bytes); a negative CUDA error code on failure.
extern "C" int drnmf_scan_factored_backward_max_smem() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -(int)err;
}

// The number of blocks of the (rt, resident) instance taking `smem` bytes
// of dynamic shared memory that the current device keeps resident at once,
// which bounds the grid of a cooperative launch; 0 when the device has no
// cooperative launch or the instance is not built; a negative CUDA error
// code on failure (the error is cleared).
extern "C" int drnmf_scan_factored_backward_capacity(int rt, int resident,
                                                      int smem) {
  Kernel kernel = pick(rt, resident);
  if (kernel == nullptr || smem < 0) return 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return coop ? sms * per_sm : 0;
}

extern "C" int drnmf_scan_factored_backward(
    const float* g, const unsigned char* mask, const float* h_all,
    const float* diag1, const float* off1, const float* c_uk,
    const float* wdkat, const float* wdk, float* delta, float* p_all,
    float* gb, float* part, float* rsu, float* rowtot, float* gamma, int B,
    int Bp, int T, int F, int Fp, int N, int K, int rt, int resident,
    int stripes, int sub, int subs, int chunk, int chunks,
    int smem, int grid, void* stream) {
  Kernel kernel = pick(rt, resident);
  if (kernel == nullptr || Bp % rt != 0 || B > Bp || K < 1 || F < 1 ||
      Fp != (F + 3) / 4 * 4 || stripes != (N + W - 1) / W ||
      sub < 1 || subs != (F + sub - 1) / sub || chunk < 1 ||
      chunks != (stripes + chunk - 1) / chunk || chunks > MAX_CHUNKS ||
      grid < 1 || grid > stripes || (resident && (K < 2 || grid != stripes)) ||
      (size_t)smem < 4 * layout_floats(rt, resident, F, Fp, stripes, K, subs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p{g,     mask,   h_all, diag1,   off1,   c_uk, wdkat, wdk,
           delta, p_all,  gb,    part,    rsu,    rowtot, gamma, B,
           Bp,    T,      F,     Fp,      N,      K,    stripes, sub,
           subs,  chunk,  chunks};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(THREADS),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
