// Sparse-NMF multiplicative-update (MU) passes under the ED objective
// (beta = 2), kernels B4 and B5.
//
// Replaces drnmf_tpu/ops/pallas/snmf_mu.py::_pass1_kernel (B4) and
// ::_pass2_kernel (B5).  With v (m x n), h (r x n), w (m x r), flr = 1e-9:
//
//   B4:  lam  = max(W h, flr)
//        h'   = h * (W^T v) / max(W^T lam + sp, flr)
//        lam' = max(W h', flr)
//        A    = v h'^T,  B = lam' h'^T   (m x r, summed over all n frames)
//        sp_sum = sp * sum(h')
//   B5:  div  = sum((v - max(W h, flr))^2)   (called with W', h')
//
// With every column of W frozen the solver takes another route, the same
// products in the same order for every value it reads (snmf_mu_frozen_*):
//
//   init:       numer = W^T v,  lam = max(W h, flr)
//   B4 each:    h' = h * numer / max(W^T lam + sp, flr),  sp_sum
//   B5 each:    lam = max(W h', flr) (kept for the next iteration) and div
//
// two products an iteration where the general route runs seven: W^T v does
// not change, the statistics A and B are not needed, and the lam' of step 3
// is the lam of the next iteration's step 1 and the product B5 repeats.
// Such an iteration is bound by its bytes: at m=257, r=2000, n=140,000 it
// reads h, numer, lam and v and writes h' and lam, 3.79 GB or 1.13 ms at
// 3.35 TB/s, where its two products take 0.58 ms in one TF32 pass.
//
// What bounds them on an H100.  B4 is six products of 2*m*r*n flops each
// (863.5 GFLOP at m=257, r=2000, n=140,000), B5 one, against 2.4 GB and
// 1.26 GB of compulsory traffic (0.7 and 0.38 ms at 3.35 TB/s).  On the
// tensor cores one TF32 pass at 495 TFLOP/s is 1.74 ms for B4 (operations
// bound it) and 0.29 ms for B5 (its bytes bound it).  This design keeps
// f32-class accuracy with three TF32 passes a term, so its own arithmetic
// can reach 5.2 and 0.87 ms; the f32 CUDA cores (67 TFLOP/s) could reach
// 12.9 and 2.15 ms.
//
// The design: one product mainloop on the tensor cores, an epilogue per use.
//
// * Error-compensated TF32 ("3xTF32").  Every operand x is split into
//   hi = tf32(x) (round to nearest) and lo = x - hi (exact in f32), and a
//   term is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in f32 in that
//   order.  The dropped a_lo*b_lo is 2^-22 of the term.  The split alone
//   is not enough: the tensor cores add into their accumulator rounding
//   toward zero, which biased a sum over 2000 positive terms by 2e-5 to
//   3e-5 of itself.  So the tensor cores sum chains of 8 stages (16
//   instructions' depth) only, and the chains are added on the CUDA cores,
//   round to nearest, into sums kept in shared memory (the registers hold
//   one accumulator, not two).  Measured against the f32 plain version at
//   257 x 140,000 x 2000 the outputs then differ by 1e-6 to 3e-6 of their
//   largest entry, as the f32 CUDA-core tiles did.  The H update contracts
//   over m = 257 only and needs no promotion.  One precision, no knob.
// * wgmma.mma_async m64nNk8 .tf32, D (64 x N) += A (64 x 8) B (8 x N), with
//   A from registers and B from shared memory (64-byte swizzle; without
//   the swizzle both kernels were 8% slower on an H100).  For TF32 both
//   shared-memory operands must be K-major; v (m, n) and h (r, n) are
//   n-contiguous and W (m, r) r-contiguous.  So the frames n ride the instruction's M axis
//   and m rides its N axis: lam^T (n x m) = h^T W^T.  A is read from a
//   shared-memory tile into registers element by element, which transposes
//   for free and splits hi/lo in registers.  B is W as stored.  N = 3 x 88
//   covers m = 257 with 2.7% padding (a 64-row tile on m wasted 24.5%).
//   The H update h'^T (n x r) = [v^T W, lam^T W] takes B from a transposed
//   copy of W that the wrapper makes once a call; the statistics
//   A^T (r x m) = h' v^T, B^T = h' lam'^T contract over n, where h', v and
//   lam' are all K-major as stored.
// * A block is two warpgroups, each 64 rows of a 128 x 88 output tile
//   (128 x 64 with two accumulators for the H update, which needs numer
//   and denom in one thread), and two blocks share an SM: each fills the
//   tensor cores while the other waits at its barrier.  (One block of four
//   warpgroups on a 128 x 272 tile was 20% slower: its warpgroups meet at
//   one barrier a stage and leave the tensor cores idle together.)  Tiles
//   that share their A rows are neighbours in the grid, so the large
//   operand comes from device memory once.
// * A ring of 3 stages of BK = 16 (4 for the H update, which keeps no sums
//   in shared memory) in dynamic shared memory, filled with cp.async.
//   TMA is not used: the rows of v, h and h' are not 16-byte aligned at
//   the recipe's n = 139,695.  B always takes 16-byte
//   copies: W, W^T and v come padded by the wrapper to rows of a multiple
//   of four floats, and lam is the kernel's own scratch with padded rows.
//   A takes 16-byte copies where its leading dimension is a multiple of
//   four, else 4-byte copies, which are slower (by a quarter at these
//   shapes); the solver therefore iterates on whole groups of four frames.
//   Copies out of range are zero-filled, so any m, r, n works and nothing
//   is read out of bounds.  Each thread splits the B elements it copied
//   itself into the hi and lo tiles once they have landed, before the
//   block's barrier; the tensor cores of the previous stage run meanwhile.
// * Epilogues on the accumulators: max(., flr) for lam; the H update in the
//   reference's order with a per-block partial of sum(h'); the squared
//   difference with a per-block partial for B5; per-slice (m, r) partials
//   of the statistics, transposed back to (m, r) as they are stored.
//
// No float atomics: every sum across blocks is per-block partials plus a
// pass in fixed order, so a run is reproducible bit for bit and the
// conv_eps stop does not move between runs.  Offsets are 64-bit.
//
// The PTX primitives (copies, wgmma, the swizzled B layout) are in
// tf32_mma.cuh, shared with kernel B3.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller passes a workspace of the size that
// snmf_mu_pass{1,2}_workspace returns, and the padded copies of W and W^T)
// and returns the first CUDA error.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr float FLR = 1e-9f;
constexpr int BM = 128;        // rows on the instruction's M axis per block
constexpr int BK = 16;         // contraction depth per stage: two k8 steps
constexpr int THREADS = 256;   // two warpgroups, 64 rows each
constexpr int A_MN_LD = BM + 8;  // A tile stored [k][row]: conflict-free
constexpr int A_K_LD = BK + 4;   // A tile stored [row][k]: conflict-free
constexpr int SUM_THREADS = 1024;
// frame slices for the (m, r) statistics: enough blocks to fill the card
constexpr int MAX_SLICES = 32;
constexpr long long FRAMES_PER_SLICE = 4096;

// the last template argument of mu_gemm; EPI_DIV (3) is B5's alone
enum Epi { EPI_LAM, EPI_HUPD, EPI_STATS, EPI_DIV, EPI_NUMER };

// D^T: out[col * ldc + row] for row on the M axis, col on the N axis, from
//   sum over k in [z*kchunk, (z+1)*kchunk) of A(row, k) B(col, k).
// A(row, k) is a[k * lda + row], or a[row * lda + k] when A_KMAJOR.
// B(col, k) is b[col * ldb + k].  EPI_HUPD has two A operands (v, lam) and
// two accumulators, or on the frozen route one (lam) and numer from memory;
// EPI_STATS picks b[0] or b[1] and out[0] or out[1] by the block's N tile.
struct Args {
  const float* a[2];
  long long lda;
  const float* b[2];
  long long ldb;
  int M;
  int N;
  long long Ma;      // readable rows of A (>= M; finite beyond M)
  long long K;       // contraction length of A (zero-filled beyond)
  long long Kb;      // readable length of B's rows (>= K; beyond K zero,
                     // or finite where A is zero-filled)
  long long kchunk;
  float* out[2];
  long long ldc;
  const float* e;    // EPI_HUPD: h; EPI_DIV: v (indexed like out)
  const float* numer;  // EPI_HUPD with one A operand: W^T v (like out)
  float sp;          // EPI_HUPD: the scalar sparsity
  float* partial;    // EPI_HUPD, EPI_DIV: one float per block
  int ntn;           // N tiles per B operand
};

// Sum of one float per thread in a fixed order; the result is on thread 0.
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// Shapes of one instantiation: NI the instruction's N (a warpgroup's
// columns), NA the number of A operands (and accumulators), AVEC the floats
// per copy of A (B always takes 16-byte copies).
template <int NI, int NA, bool A_KMAJOR, int AVEC, int PROMOTE>
struct Tile {
  static constexpr int BN = NI;
  // the promoted sums take shared memory, so a stage less fits
  static constexpr int STAGES = PROMOTE ? 3 : 4;
  static constexpr int PROMOTED_BYTES = PROMOTE ? NI / 2 * THREADS * 4 : 0;
  static constexpr int A_FLOATS = A_KMAJOR ? BM * A_K_LD : BK * A_MN_LD;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = NA * A_FLOATS * 4 + 2 * B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + PROMOTED_BYTES;
  static_assert(!PROMOTE || NA == 1, "one promoted accumulator");
  static constexpr int B_COPIES = BN * BK / 4;  // 16 bytes each
  static constexpr int B_PER_THREAD = (B_COPIES + THREADS - 1) / THREADS;
  static constexpr int A_PER_THREAD = BM * BK / AVEC / THREADS;
  static_assert(NI % 8 == 0 && BM * BK % (AVEC * THREADS) == 0, "tile shapes");
  static_assert(BK == 16, "a row of B is one 64-byte swizzle span");
  static_assert(A_FLOATS * 4 % 512 == 0 && B_BYTES % 512 == 0, "alignment");

  // byte offset of B(col, k) inside a B tile
  __device__ static __forceinline__ int b_offset(int col, int k) {
    return swizzle64_offset(col, k);
  }
  // (col, k) of this thread's q-th copy of B
  __device__ static __forceinline__ void b_copy_index(int q, int* col,
                                                      int* k) {
    const int e = threadIdx.x + q * THREADS;
    *col = e / (BK / 4);
    *k = (e % (BK / 4)) * 4;
  }
};

template <int NI, int NA, bool A_KMAJOR, int AVEC, int PROMOTE, int EPI>
__global__ void __launch_bounds__(THREADS, 2) mu_gemm(Args p) {
  using T = Tile<NI, NA, A_KMAJOR, AVEC, PROMOTE>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x;
  const int nt_all = p.ntn * (EPI == EPI_STATS ? 2 : 1);
  const int tn_all = blockIdx.x % nt_all;
  const int bsel = tn_all / p.ntn;
  const int row0 = (blockIdx.x / nt_all) * BM;
  const int col0 = (tn_all % p.ntn) * T::BN;
  const long long kbeg = (long long)blockIdx.z * p.kchunk;
  const long long kend = min(p.K, kbeg + p.kchunk);
  const long long kend_b = min(p.Kb, kbeg + p.kchunk);
  const int ktiles = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;
  const float* bsrc = p.b[bsel];

  // a warpgroup takes 64 of the block's 128 rows, a warp 16 of those
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int frag_row = (tid / 32) * 16 + g;

  auto stage_a = [&](int slot, int x) {
    return reinterpret_cast<float*>(smem + (size_t)slot * T::STAGE_BYTES) +
           x * T::A_FLOATS;
  };
  auto stage_b = [&](int slot) {
    return smem + (size_t)slot * T::STAGE_BYTES + NA * T::A_FLOATS * 4;
  };

  auto load_tile = [&](int kt) {
    const int slot = kt % STAGES;
    const long long k0 = kbeg + (long long)kt * BK;
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const float* a = p.a[x];
      const uint32_t dst = smem_u32(stage_a(slot, x));
#pragma unroll
      for (int q = 0; q < T::A_PER_THREAD; ++q) {
        const int e = tid + q * THREADS;
        const int i = A_KMAJOR ? e / (BK / AVEC) : (e % (BM / AVEC)) * AVEC;
        const int k = A_KMAJOR ? (e % (BK / AVEC)) * AVEC : e / (BM / AVEC);
        const bool ok = row0 + i < p.Ma && k0 + k < kend;
        const long long off =
            A_KMAJOR ? (long long)(row0 + i) * p.lda + (k0 + k)
                     : (k0 + k) * p.lda + (row0 + i);
        const int at = A_KMAJOR ? i * A_K_LD + k : k * A_MN_LD + i;
        if (AVEC == 4)
          cp_async16(dst + 4 * at, ok ? a + off : a, ok);
        else
          cp_async4(dst + 4 * at, ok ? a + off : a, ok);
      }
    }
    const uint32_t dst = smem_u32(stage_b(slot));
#pragma unroll
    for (int q = 0; q < T::B_PER_THREAD; ++q) {
      int col, k;
      T::b_copy_index(q, &col, &k);
      if (col >= T::BN) break;
      const bool ok = col0 + col < p.N && k0 + k < kend_b;
      const float* src =
          ok ? bsrc + (long long)(col0 + col) * p.ldb + (k0 + k) : bsrc;
      cp_async16(dst + T::b_offset(col, k), src, ok);
    }
  };

  // hi in place, lo into the tile behind it, for the B elements this
  // thread copied (its own copies are visible to it after the wait)
  auto split_tile = [&](int kt) {
    unsigned char* b = stage_b(kt % STAGES);
#pragma unroll
    for (int q = 0; q < T::B_PER_THREAD; ++q) {
      int col, k;
      T::b_copy_index(q, &col, &k);
      if (col >= T::BN) break;
      unsigned char* at = b + T::b_offset(col, k);
      const float4 x = *reinterpret_cast<const float4*>(at);
      const uint4 hi = {tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                        tf32_hi(x.w)};
      const float4 lo = {x.x - __uint_as_float(hi.x),
                         x.y - __uint_as_float(hi.y),
                         x.z - __uint_as_float(hi.z),
                         x.w - __uint_as_float(hi.w)};
      *reinterpret_cast<uint4*>(at) = hi;
      *reinterpret_cast<float4*>(at + T::B_BYTES) = lo;
    }
    // the tensor cores read shared memory through the asynchronous proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[NA][NI / 2];
#pragma unroll
  for (int x = 0; x < NA; ++x)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc[x][i] = 0.f;
  // The tensor cores add into acc rounding toward zero, which biases a long
  // sum of positive terms.  So acc holds a chain of PROMOTE stages only,
  // and the chains are summed here on the CUDA cores (round to nearest),
  // each thread's NI / 2 sums in its own column of shared memory.
  float* promoted =
      reinterpret_cast<float*>(smem + STAGES * T::STAGE_BYTES) + tid;
  if (PROMOTE) {
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) promoted[i * THREADS] = 0.f;
  }
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) {
      promoted[i * THREADS] += acc[0][i];
      acc[0][i] = 0.f;
    }
  };
  // A fragments of the two k8 steps of a stage: [step][operand][hi, lo][4]
  uint32_t frag[2][NA][2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int x = 0; x < NA; ++x)
#pragma unroll
      for (int i = 0; i < 4; ++i) frag[s][x][0][i] = frag[s][x][1][i] = 0u;

  // rows frag_row and frag_row + 8, depths t and t + 4 of step s
  auto load_frags = [&](int slot, int s) {
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const float* a = stage_a(slot, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = frag_row + (i & 1) * 8;
        const int k = 8 * s + t + (i >> 1) * 4;
        const float v = A_KMAJOR ? a[row * A_K_LD + k] : a[k * A_MN_LD + row];
        const uint32_t hi = tf32_hi(v);
        frag[s][x][0][i] = hi;
        frag[s][x][1][i] = __float_as_uint(v - __uint_as_float(hi));
      }
    }
  };

  // the three products of step s, small terms first
  auto start_products = [&](int slot, int s) {
    const uint32_t b = smem_u32(stage_b(slot)) + 32 * s;  // 8 floats a step
    const uint64_t hi = b_descriptor(b);
    const uint64_t lo = b_descriptor(b + T::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      wgmma_tf32(acc[x], frag[s][x][1], hi);
      wgmma_tf32(acc[x], frag[s][x][0], lo);
      wgmma_tf32(acc[x], frag[s][x][0], hi);
    }
    wgmma_commit();
  };

  auto wait_products = [&]() {
    wgmma_wait();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int x = 0; x < NA; ++x)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pin(frag[s][x][0][i]);
          pin(frag[s][x][1][i]);
        }
#pragma unroll
    for (int x = 0; x < NA; ++x)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) pin(acc[x][i]);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int slot = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    split_tile(kt);               // overlaps the products of tile kt - 1
    wait_products();              // which read the slot refilled below
    if (PROMOTE && kt > 0 && kt % (PROMOTE ? PROMOTE : 1) == 0) promote();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load_tile(kt + STAGES - 1);
    cp_async_commit();

    const bool two = kbeg + (long long)kt * BK + 8 < kend;
    load_frags(slot, 0);
    start_products(slot, 0);
    if (two) {
      load_frags(slot, 1);  // while step 0 runs
      start_products(slot, 1);
    }
  }
  wait_products();
  cp_async_wait<0>();

  float local = 0.f;
  float* out = p.out[bsel];
  const size_t slice = (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + frag_row + (i >> 1) * 8;
      const int col = col0 + 8 * j + 2 * t + (i & 1);
      // lam's rows are padded to ldc frames: the padding holds flr, so the
      // wide copies that read it later find finite numbers
      const bool writes_lam = EPI == EPI_LAM || (EPI == EPI_DIV && out);
      if (row >= (writes_lam ? p.ldc : p.M) || col >= p.N) continue;
      const size_t o = (size_t)col * p.ldc + row;
      const float d =
          PROMOTE ? promoted[(4 * j + i) * THREADS] + acc[0][4 * j + i]
                  : acc[0][4 * j + i];
      if (EPI == EPI_LAM) {
        out[o] = fmaxf(d, FLR);
      } else if (EPI == EPI_HUPD) {
        // the reference's order: h * numer / max(denom + sp, flr)
        const float numer = NA == 2 ? d : p.numer[o];
        const float hn =
            p.e[o] * numer / fmaxf(acc[NA - 1][4 * j + i] + p.sp, FLR);
        out[o] = hn;
        local += hn;
      } else if (EPI == EPI_STATS) {
        out[slice + o] = d;
      } else if (EPI == EPI_NUMER) {
        out[o] = d;
      } else {  // EPI_DIV, and lam for the next iteration where out is set
        const float lam = fmaxf(d, FLR);
        if (out) out[o] = lam;
        if (row < p.M) {
          const float diff = p.e[o] - lam;
          local = fmaf(diff, diff, local);
        }
      }
    }
  }
  if (EPI == EPI_HUPD || EPI == EPI_DIV) {
    const float s = block_sum(local, red);
    if (tid == 0) p.partial[blockIdx.x] = s;
  }
}

// out[i] = sum over z of part[z * count + i], z in increasing order.
__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, long long count,
                           int slices) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[(long long)z * count + i];
  out[i] = s;
}

// *out = scale * sum(part[0:count]) in a fixed order: one block, strided
// sums per thread, then a fixed tree.
__global__ void __launch_bounds__(SUM_THREADS)
    sum_partials(const float* __restrict__ part, long long count, float scale,
                 float* __restrict__ out) {
  __shared__ float s[SUM_THREADS];
  float x = 0.f;
  for (long long i = threadIdx.x; i < count; i += SUM_THREADS) x += part[i];
  s[threadIdx.x] = x;
  __syncthreads();
  for (int o = SUM_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = scale * s[0];
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Frame slices of the statistics product: (slices, frames per slice).
void stat_slices(long long n, int* slices, long long* kchunk) {
  long long s = cdiv(n, FRAMES_PER_SLICE);
  s = s < 1 ? 1 : (s > MAX_SLICES ? MAX_SLICES : s);
  *kchunk = cdiv(cdiv(n, s), BK) * BK;
  *slices = (int)cdiv(n, *kchunk);
}

// The instantiations: lam, the divergence and the statistics (one
// accumulator, 88 columns of m, promoted sums), the H update (two
// accumulators, 64 columns of r; one on the frozen route, whose W^T v is
// the same product with one accumulator and its own epilogue).
constexpr int NI_WIDE = 88;
// stages (of two k8 steps) the tensor cores sum before a promotion.  At
// 257 x 140,000 x 2000 on an H100 80GB HBM3 (700 W), 8 keeps the error at
// 3e-6 of the largest entry for 7% of the time; 4 reads 2e-6 for 13%, 16
// reads 5e-6 for 4%.
constexpr int PROMOTE_STAGES = 8;
constexpr int NI_HUPD = 64;

// Blocks of a product whose M axis has `rows` rows and N axis `cols`.
long long tiles(long long rows, long long cols, int ni) {
  return cdiv(rows, BM) * cdiv(cols, ni);
}

template <int NI, int NA, bool A_KMAJOR, int AVEC, int EPI>
cudaError_t launch_vec(Args p, int slices, cudaStream_t stream) {
  // the H update contracts over m, a few hundred terms: no promotion
  constexpr int PROMOTE =
      EPI == EPI_HUPD || EPI == EPI_NUMER ? 0 : PROMOTE_STAGES;
  using T = Tile<NI, NA, A_KMAJOR, AVEC, PROMOTE>;
  auto kernel = mu_gemm<NI, NA, A_KMAJOR, AVEC, PROMOTE, EPI>;
  p.ntn = (int)cdiv(p.N, T::BN);
  const long long blocks =
      tiles(p.M, p.N, NI) * (EPI == EPI_STATS ? 2 : 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)blocks, 1, slices);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte copies of A where its rows allow them: a leading dimension that
// is a multiple of four floats (then every tile row starts on 16 bytes, and
// a copy that starts in range ends in range), else 4-byte copies.
template <int NI, int NA, bool A_KMAJOR, int EPI>
cudaError_t launch(const Args& p, int slices, cudaStream_t stream) {
  bool wide = p.lda % 4 == 0 && p.Ma % 4 == 0 &&
              (!A_KMAJOR || (p.K % 4 == 0 && p.kchunk % 4 == 0));
  for (int x = 0; x < NA; ++x)
    wide = wide && reinterpret_cast<uintptr_t>(p.a[x]) % 16 == 0;
  return wide ? launch_vec<NI, NA, A_KMAJOR, 4, EPI>(p, slices, stream)
              : launch_vec<NI, NA, A_KMAJOR, 1, EPI>(p, slices, stream);
}

cudaError_t sum_all(const float* part, long long count, float scale,
                    float* out, cudaStream_t stream) {
  sum_partials<<<1, SUM_THREADS, 0, stream>>>(part, count, scale, out);
  return cudaGetLastError();
}

// max(W h, flr) over n frames.  Without `v`: into lam (m, ld) with rows
// padded to ld frames (EPI_LAM).  With `v` (m, ld): the divergence's
// per-block partials into `part` (EPI_DIV, B5), and lam as well where it is
// not null.
cudaError_t launch_wh(const float* h, const float* w_pad, long long r_pad,
                      const float* v, float* lam, float* part, long long ld,
                      int m, int r, long long n, cudaStream_t stream) {
  Args p = {};
  p.a[0] = h; p.lda = n; p.b[0] = w_pad; p.ldb = r_pad;
  p.M = (int)n; p.Ma = n; p.N = m; p.K = r; p.Kb = r_pad; p.kchunk = r_pad;
  p.out[0] = lam; p.ldc = ld;
  if (v == nullptr) return launch<NI_WIDE, 1, false, EPI_LAM>(p, 1, stream);
  p.e = v; p.partial = part;
  return launch<NI_WIDE, 1, false, EPI_DIV>(p, 1, stream);
}

// The H update's product, rows n, columns r, contraction m: A = v_pad or
// lam (m x n_pad), B = W^T padded.
Args hupd_args(const float* a, const float* wt_pad, int m, int r,
               long long n) {
  const long long n_pad = cdiv(n, 4) * 4, m_pad = cdiv(m, 4) * 4;
  Args p = {};
  p.a[0] = a; p.lda = n_pad; p.b[0] = wt_pad; p.ldb = m_pad;
  p.M = (int)n; p.Ma = n_pad; p.N = r; p.K = m; p.Kb = m_pad; p.kchunk = m_pad;
  p.ldc = n;
  return p;
}

}  // namespace

#define CHECK(call)                        \
  do {                                     \
    cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Workspace of B4, in floats: lam (m x n_pad, n_pad = n rounded up to 4),
// the per-block partials of sum(h'), and the per-slice partials of A and B.
extern "C" long long snmf_mu_pass1_workspace(int m, int r, long long n) {
  int slices;
  long long kchunk;
  stat_slices(n, &slices, &kchunk);
  return m * (cdiv(n, 4) * 4) + tiles(n, r, NI_HUPD) + 2LL * slices * m * r;
}

// v_pad: v (m x n) with rows padded with zeros to n_pad floats; w_pad:
// W (m x r) padded to r_pad; wt_pad: W^T (r x m) padded to m_pad.  Every pad
// is the length rounded up to a multiple of 4, every array 16-byte aligned.
extern "C" int snmf_mu_pass1(const float* v_pad, const float* h,
                             const float* w_pad, const float* wt_pad,
                             float sparsity, float* h_new, float* a, float* b,
                             float* sp_sum, float* workspace, int m, int r,
                             long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  const long long n_pad = cdiv(n, 4) * 4, r_pad = cdiv(r, 4) * 4;
  int slices;
  long long kchunk;
  stat_slices(n, &slices, &kchunk);
  float* lam = workspace;
  float* part_h = lam + (size_t)m * n_pad;
  const long long n_part_h = tiles(n, r, NI_HUPD);
  float* part_a = part_h + n_part_h;
  float* part_b = part_a + (size_t)slices * m * r;

  // 1. lam = max(W h, flr): rows n, columns m, contraction r
  CHECK(launch_wh(h, w_pad, r_pad, nullptr, lam, nullptr, n_pad, m, r, n,
                  stream));

  // 2. h' = h * (W^T v) / max(W^T lam + sp, flr)
  Args p = hupd_args(v_pad, wt_pad, m, r, n);
  p.a[1] = lam;
  p.out[0] = h_new; p.e = h; p.sp = sparsity; p.partial = part_h;
  CHECK((launch<NI_HUPD, 2, false, EPI_HUPD>(p, 1, stream)));

  // 3. lam' = max(W h', flr)
  CHECK(launch_wh(h_new, w_pad, r_pad, nullptr, lam, nullptr, n_pad, m, r, n,
                  stream));

  // 4. (v h'^T)^T and (lam' h'^T)^T per frame slice: rows r, columns m,
  //    contraction n; stored as (m, r)
  p = Args{};
  p.a[0] = h_new; p.lda = n; p.b[0] = v_pad; p.b[1] = lam; p.ldb = n_pad;
  p.M = r; p.Ma = r; p.N = m; p.K = n; p.Kb = n_pad; p.kchunk = kchunk;
  p.out[0] = part_a; p.out[1] = part_b; p.ldc = r;
  CHECK((launch<NI_WIDE, 1, true, EPI_STATS>(p, slices, stream)));

  // 5. the fixed-order sums
  const long long mr = (long long)m * r;
  const unsigned blocks = (unsigned)cdiv(mr, 256);
  sum_slices<<<blocks, 256, 0, stream>>>(part_a, a, mr, slices);
  CHECK(cudaGetLastError());
  sum_slices<<<blocks, 256, 0, stream>>>(part_b, b, mr, slices);
  CHECK(cudaGetLastError());
  CHECK(sum_all(part_h, n_part_h, sparsity, sp_sum, stream));
  return 0;
}

// Workspace of B5, in floats: one partial per block of W h.
extern "C" long long snmf_mu_pass2_workspace(int m, int r, long long n) {
  return tiles(n, m, NI_WIDE);
}

extern "C" int snmf_mu_pass2(const float* v, const float* h,
                             const float* w_pad, float* div, float* workspace,
                             int m, int r, long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  CHECK(launch_wh(h, w_pad, cdiv(r, 4) * 4, v, nullptr, workspace, n, m, r,
                  n, stream));
  CHECK(sum_all(workspace, tiles(n, m, NI_WIDE), 1.f, div, stream));
  return 0;
}

// The frozen route's B4, in floats of workspace: the per-block partials of
// sum(h').
extern "C" long long snmf_mu_frozen_pass1_workspace(int m, int r,
                                                    long long n) {
  return tiles(n, r, NI_HUPD);
}

// The frozen route's state, once a solve (or wherever it no longer holds
// the h of the next iteration): numer = W^T v (r x n), by the same k-chain
// as the general route's first accumulator, and lam = max(W h, flr)
// (m x n_pad, rows padded with flr).  Operands as for snmf_mu_pass1.
extern "C" int snmf_mu_frozen_init(const float* v_pad, const float* h,
                                   const float* w_pad, const float* wt_pad,
                                   float* numer, float* lam, int m, int r,
                                   long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  Args p = hupd_args(v_pad, wt_pad, m, r, n);
  p.out[0] = numer;
  CHECK((launch<NI_HUPD, 1, false, EPI_NUMER>(p, 1, stream)));
  CHECK(launch_wh(h, w_pad, cdiv(r, 4) * 4, nullptr, lam, nullptr,
                  cdiv(n, 4) * 4, m, r, n, stream));
  return 0;
}

// The frozen route's B4: h' = h * numer / max(W^T lam + sp, flr) and
// sp_sum = sp * sum(h'), numer and lam as snmf_mu_frozen_init or the last
// snmf_mu_frozen_pass2 left them.
extern "C" int snmf_mu_frozen_pass1(const float* h, const float* wt_pad,
                                    const float* numer, const float* lam,
                                    float sparsity, float* h_new,
                                    float* sp_sum, float* workspace, int m,
                                    int r, long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  Args p = hupd_args(lam, wt_pad, m, r, n);
  p.out[0] = h_new; p.e = h; p.numer = numer; p.sp = sparsity;
  p.partial = workspace;
  CHECK((launch<NI_HUPD, 1, false, EPI_HUPD>(p, 1, stream)));
  CHECK(sum_all(workspace, tiles(n, r, NI_HUPD), sparsity, sp_sum, stream));
  return 0;
}

// The frozen route's B5: the divergence of h against v_pad (m x n_pad), as
// snmf_mu_pass2, and max(W h, flr) into lam (m x n_pad, padding flr) for
// the next iteration.  Workspace: snmf_mu_pass2_workspace.
extern "C" int snmf_mu_frozen_pass2(const float* v_pad, const float* h,
                                    const float* w_pad, float* lam, float* div,
                                    float* workspace, int m, int r,
                                    long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  CHECK(launch_wh(h, w_pad, cdiv(r, 4) * 4, v_pad, lam, workspace,
                  cdiv(n, 4) * 4, m, r, n, stream));
  CHECK(sum_all(workspace, tiles(n, m, NI_WIDE), 1.f, div, stream));
  return 0;
}

extern "C" const char* snmf_mu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
