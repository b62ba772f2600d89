// Folded + factored DR-NMF recurrence, interleaved variant (kernel B2): the
// whole time scan in one cooperative launch, its products on the tensor
// cores in error-compensated TF32, the batch's two halves carried as two
// independent chains of products through every work item.
//
// Replaces drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored_interleaved
// (:213; entry drnmf_scan_pallas_factored with interleave=True, :265;
// pallas_call :320).  Per timestep t and batch row, with h the carried
// state (N = 2r wide) and x_t the input frame (F wide):
//
//   rs        = rowsum(h)
//   layer 0:  hid = relu(h*(diag1 - off1) + off1*rs + x_t @ dka_0 + b_0)
//   layer k:  hid = relu(c*rs + hid + (x_t - hid @ dkT_{k-1}) @ dka_k + b_k)
//   h         = mask[b, t] ? hid : h;   out[b, t, :] = h
//
// The TPU kernel splits the batch into two halves so that one half's
// matmul issues during the other half's dependency stall.  Here too: the
// first ceil(B/2) rows are chain A, the rest chain B (empty at B = 1).
//
// What bounds it on an H100.  2*F*N*(2K-1) useful flops a row-step (9.25
// MFLOP at K=5, F=257, N=2000): 2.418 TFLOP at B x T = 256 x 1,021, which
// is 4.89 ms in one TF32 pass at 495 TFLOP/s, 14.66 ms in the three passes
// a term this design does, 36.1 ms on the f32 CUDA cores.  Each input read
// once and the output written once is about 2.4 GB there, 0.7 ms.  At
// 64 x 16: 9.47 GFLOP, so 0.019, 0.057 and 0.141 ms, against about 28 MB
// of bytes, 8.3 us.  At a few rows the chain of dependent phases and the
// grid syncs bind it (about 1.13 us a sync on an H100), and inside each
// phase a block's wait for its own tensor-core products, stage by stage.
//
// The design.  Kernel B1's phases (drnmf_scan_factored.cu) in one
// cooperative launch, a grid sync after each, every phase a grid-stride
// loop over its work items:
//   P_0   x_t @ dka_0 with the epilogue, which needs the rowsums rs of
//         the carry: each item adds its rows' partial sums rsp (groups of
//         16 columns) in group order, the whole block staging them first;
//   BP_k  part[s] = hid_{k-1}[:, s*L..(s+1)*L) @ dkT_{k-1}[same rows]: the
//         back-projection over S fixed stretches of L of the 2r axis;
//   R_k   resid = x_t - part[0] - ... - part[S-1], in stretch order;
//   P_k   resid @ dka_k with the epilogue, in the product's item.
// The epilogue adds c*rs + hid (layer 0: h*(diag1-off1) + off1*rs), the
// product, the bias, takes relu; the last layer holds masked steps from
// the carry, writes the next carry and the output, and the carry's
// partial rowsums over fixed groups of 16 columns of 2r.  1 + 3(K-1) grid
// syncs a step (13 at K = 5).  Splitting P over stretches of F with a
// phase that adds the partials (B3's scheme) lost at every measured shape
// and is not built (PERF.md, section 6).
//
// Every product runs on the tensor cores transposed, as in B3: the
// weights are the A operand as stored, dka_k (F, ld) and dkT_{k-1}
// (N, Fp) both [contraction][output], so their output axis (2r for P, F
// for BP) rides the instruction's M axis (MT = 64 rows an item, one
// warpgroup) and the batch its N axis (NI = 8 or 16 columns of each
// chain).  128-row items and 32-column tiles spilled and lost at every
// measured shape, and no path's batch reaches them.  A term is
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the mainloop of B3 and B4/B5,
// tf32_mma.cuh), the tensor cores' sums promoted to f32 every 8 stages of
// 16.
//
// The interleave.  A work item is (an M tile of the weights, the same NI
// columns of chain A and of chain B, and for BP a stretch).  At each k8
// step it splits the A fragment into head and tail once for both chains,
// issues chain A's three products and commits them, then chain B's, and
// waits only for the older group (wgmma.wait_group 1): the tensor cores
// hold one chain's products while the other's are issued.
// The ring therefore refills the slot of the tile before last, whose
// groups are complete.  Built with -DB2_CHAINS=1 the same kernel waits for
// every group it issues (one chain in flight), and -DB2_RING=n sets the
// ring's stages.  tools/b2_variants.py times them: two chains and the
// deepest ring that fits are the default (see PERF.md).
//
// Invariants.  No float atomics.  Every output is summed by one thread in
// a fixed order: partials in stretch order, the residual's in stretch
// order, rowsums by 16 columns then by group.  L, S and the groups depend
// on (F, 2r) alone, so a repeat is bit-equal and the order of a row's sums
// does not depend on the batch or the grid.  Ragged edges
// are zero-filled: F is padded to Fp (a multiple of 4) in x, dkT and the
// scratch for the 16-byte copies, 2r to ld in dka, and depths past a
// product's end read as zero.  Rows past B run on zeros and are never
// written out; offsets are 64-bit.  What a block wrote before a grid sync
// is read with cp.async.cg or __ldcg, never through L1.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller hands it the scratch, zero-filled),
// returns the CUDA error code.  The wrapper passes half = ceil(B/2);
// half = B (chain B empty) runs the whole batch as one chain, which
// tools/b2_variants.py times against two.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

#ifndef B2_CHAINS
#define B2_CHAINS 2  // wgmma groups a warpgroup keeps running: 2 or 1
#endif
#ifndef B2_RING
#define B2_RING 0  // stages of the ring; 0: the depths of Ring below
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int MT = 64;                    // rows of the weights an item
constexpr int THREADS = 2 * MT;           // one warpgroup
constexpr int BK = 16;                    // contraction depth per stage
constexpr int PROMOTE = 8;                // stages the tensor cores sum
constexpr int GROUP = 16;                 // columns of one partial rowsum
constexpr int IN_FLIGHT = B2_CHAINS - 1;  // groups left running at a wait
static_assert(B2_CHAINS == 1 || B2_CHAINS == 2, "B2_CHAINS");

struct Params {
  const float* x;             // (T, R, Fp): frames by chain, zero-padded
  const unsigned char* mask;  // (B, T)
  const float* diag1;         // (N)
  const float* off1;          // (1)
  const float* c_uk;          // (1)
  const float* dkt;           // (max(1, K-1), N, Fp)
  const float* dka;           // (K, F, ld)
  const float* b;             // (K, N)
  float* h;                   // (2, R, ld): carry by step parity, h[0] = h0
  float* hid;                 // (2, R, ld): hidden state by layer parity
  float* part;                // (S, R, Fp): back-projection partials
  float* resid;               // (R, Fp)
  float* rsp;                 // (2, G, R): partial rowsums by step parity
  float* rs;                  // (R): rowsums of the step's carry
  float* out;                 // (B, T, N)
  int B, half, bpc, R, T, F, Fp, N, ld, K;
  int split, splits;  // L, S: stretches of the back-projection
  int groups;         // G
};

// The batch row of scratch row r: chain A holds rows [0, bpc) for batch
// rows [0, half), chain B rows [bpc, 2 bpc) for [half, B); -1 past them.
__device__ __forceinline__ int batch_row(const Params& p, int r) {
  if (r < p.bpc) return r < p.half ? r : -1;
  const int b = p.half + (r - p.bpc);
  return b < p.B ? b : -1;
}

// Shared memory of one block: a ring of stages (A tile [k][row], then the
// head and tail B tiles of chain A and of chain B), the promoted sums (NI
// a thread, NI / 2 a chain) and the rowsums of an item's columns.  The
// deepest ring that leaves room for three blocks an SM.
template <int NI>
struct Ring {
  static constexpr int A_LD = MT + 8;  // conflict-free fragment reads
  static constexpr int STAGES = B2_RING > 0 ? B2_RING : (NI == 8 ? 10 : 7);
  static constexpr int AHEAD = STAGES - 1 - IN_FLIGHT;  // tiles in flight
  static constexpr int A_BYTES = BK * A_LD * 4;
  static constexpr int B_BYTES = NI * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 4 * B_BYTES;
  static constexpr int PROMOTED = STAGES * STAGE_BYTES;
  static constexpr int SRS = PROMOTED + NI * THREADS * 4;
  static constexpr int SMEM_BYTES = SRS + 2 * NI * 4;
  static constexpr int A_PER_THREAD = MT * BK / 4 / THREADS;  // 16 bytes
  static constexpr int B_PER_THREAD =
      (2 * NI * BK / 4 + THREADS - 1) / THREADS;
  static_assert(NI == 8 || NI == 16, "batch tile");
  static_assert(AHEAD >= 1, "ring too shallow");
  static_assert(A_BYTES % 512 == 0 && B_BYTES % 512 == 0, "alignment");
  static_assert(MT * BK % (4 * THREADS) == 0, "A copies");
  static_assert(2 * NI * MT * 4 <= PROMOTED, "staging of the epilogue");
};

// One product of a work item: out(row, col) = sum over depths d in
// [v0, v1) of A(row, d) B(col, d), with A(row, d) = a[d * lda + row]
// (weights, zero at rows >= a_rows) and B(col, d) = act[col * ldb + d]
// (activations this kernel wrote, read through L2 only).  lda, ldb, v0
// and the row tiles are multiples of 4; the activations read as zero
// from v1 to the next multiple of 4.
struct Product {
  const float* a;
  int lda, a_rows;
  const float* act;
  int ldb;
  int v0, v1;
};

// acc[c] = the product for rows [row0, row0 + MT) of the weights and the
// NI columns from colA (chain A, c = 0) and from colB (chain B, c = 1,
// only when `two`).  Thread fragment layout of m64nNk8: rows
// (tid / 32) * 16 + g (+ 8), columns 8j + 2t (+ 1).  Ends with a barrier
// after which the ring is free.
template <int NI>
__device__ __forceinline__ void item_product(const Product& o, int row0,
                                             int colA, int colB, bool two,
                                             unsigned char* smem,
                                             float (&acc)[2][NI / 2]) {
  using Rg = Ring<NI>;
  constexpr int STAGES = Rg::STAGES;
  constexpr int B_COPIES = NI * BK / 4;  // of one chain
  const int tid = threadIdx.x;
  const int ktiles = (o.v1 - o.v0 + BK - 1) / BK;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int frag_row = (tid / 32) * 16 + g;

  auto stage_a = [&](int slot) {
    return reinterpret_cast<float*>(smem + (size_t)slot * Rg::STAGE_BYTES);
  };
  // chain c's head tile; its tail B_BYTES behind it
  auto stage_b = [&](int slot, int c) {
    return smem + (size_t)slot * Rg::STAGE_BYTES + Rg::A_BYTES +
           c * 2 * Rg::B_BYTES;
  };

  auto load_tile = [&](int kt) {
    const int slot = kt % STAGES;
    const int k0 = o.v0 + kt * BK;
    const uint32_t da = smem_u32(stage_a(slot));
#pragma unroll
    for (int q = 0; q < Rg::A_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int i = (e % (MT / 4)) * 4;
      const int k = e / (MT / 4);
      const bool ok = row0 + i < o.a_rows && k0 + k < o.v1;
      const float* src =
          ok ? o.a + (size_t)(k0 + k) * o.lda + (row0 + i) : o.a;
      cp_async16(da + 4 * (k * Rg::A_LD + i), src, ok);
    }
#pragma unroll
    for (int q = 0; q < Rg::B_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int c = e / B_COPIES;
      if (c >= 2 || (c == 1 && !two)) break;
      const int col = (e % B_COPIES) / (BK / 4);
      const int k = (e % (BK / 4)) * 4;
      const bool ok = k0 + k < o.v1;
      const float* src =
          o.act + (size_t)((c ? colB : colA) + col) * o.ldb + (k0 + k);
      cp_async16(smem_u32(stage_b(slot, c)) + swizzle64_offset(col, k),
                 ok ? src : o.act, ok);
    }
  };

  // hi in place, lo into the tile behind it, for the B elements this
  // thread copied (its own copies are visible to it after the wait)
  auto split_tile = [&](int kt) {
    const int slot = kt % STAGES;
#pragma unroll
    for (int q = 0; q < Rg::B_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int c = e / B_COPIES;
      if (c >= 2 || (c == 1 && !two)) break;
      const int col = (e % B_COPIES) / (BK / 4);
      const int k = (e % (BK / 4)) * 4;
      unsigned char* at = stage_b(slot, c) + swizzle64_offset(col, k);
      const float4 x = *reinterpret_cast<const float4*>(at);
      const uint4 hi = {tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                        tf32_hi(x.w)};
      const float4 lo = {x.x - __uint_as_float(hi.x),
                         x.y - __uint_as_float(hi.y),
                         x.z - __uint_as_float(hi.z),
                         x.w - __uint_as_float(hi.w)};
      *reinterpret_cast<uint4*>(at) = hi;
      *reinterpret_cast<float4*>(at + Rg::B_BYTES) = lo;
    }
    // the tensor cores read shared memory through the asynchronous proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc[c][i] = 0.f;
  // this thread's NI promoted sums, [chain][NI / 2], in its own column
  float* promoted =
      reinterpret_cast<float*>(smem + Rg::PROMOTED) + tid;
#pragma unroll
  for (int i = 0; i < NI; ++i) promoted[i * THREADS] = 0.f;
  auto promote = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        promoted[(c * NI / 2 + i) * THREADS] += acc[c][i];
        acc[c][i] = 0.f;
      }
  };
  // A fragments of the two k8 steps of a stage: [step][hi, lo][4]
  uint32_t frag[2][2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) frag[s][0][i] = frag[s][1][i] = 0u;

  // rows frag_row and frag_row + 8, depths t and t + 4 of step s
  auto load_frags = [&](int slot, int s) {
    const float* at = stage_a(slot);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = frag_row + (i & 1) * 8;
      const int k = 8 * s + t + (i >> 1) * 4;
      const float v = at[k * Rg::A_LD + row];
      const uint32_t hi = tf32_hi(v);
      frag[s][0][i] = hi;
      frag[s][1][i] = __float_as_uint(v - __uint_as_float(hi));
    }
  };

  // chain c's three products of step s, small terms first, as one group;
  // then wait until at most IN_FLIGHT groups run
  auto issue = [&](int slot, int s, int c) {
    const uint32_t b = smem_u32(stage_b(slot, c)) + 32 * s;  // 8 floats
    const uint64_t hi = b_descriptor(b);
    const uint64_t lo = b_descriptor(b + Rg::B_BYTES);
    wgmma_fence();
    wgmma_tf32(acc[c], frag[s][1], hi);
    wgmma_tf32(acc[c], frag[s][0], lo);
    wgmma_tf32(acc[c], frag[s][0], hi);
    wgmma_commit();
    wgmma_wait_group<IN_FLIGHT>();
  };

  auto drain = [&]() {
    wgmma_wait_group<0>();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pin(frag[s][0][i]);
        pin(frag[s][1][i]);
      }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) pin(acc[c][i]);
  };

#pragma unroll
  for (int s = 0; s < Rg::AHEAD; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int slot = kt % STAGES;
    cp_async_wait<Rg::AHEAD - 1>();  // this thread's copies of tile kt
    split_tile(kt);  // overlaps the products still running on tile kt - 1
    if (kt > 0 && kt % PROMOTE == 0) {
      drain();
      promote();
    }
    // every group of tile kt - 2 is complete in both warpgroups, so its
    // slot may be refilled (kt - 1's with one chain in flight)
    __syncthreads();
    if (kt + Rg::AHEAD < ktiles) load_tile(kt + Rg::AHEAD);
    cp_async_commit();

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && o.v0 + kt * BK + 8 >= o.v1) break;
      load_frags(slot, s);  // its last readers are complete
      issue(slot, s, 0);
      if (two) issue(slot, s, 1);
    }
  }
  drain();
  cp_async_wait<0>();
  __syncthreads();  // no warpgroup reads the ring any more

#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i)
      acc[c][i] = promoted[(c * NI / 2 + i) * THREADS] + acc[c][i];
}

// The epilogue of layer k at scratch row r (batch row b >= 0), column c of
// 2r (< N), on the whole product `prod`: writes the value where it goes
// and returns it.
__device__ __forceinline__ float finish(const Params& p, int t, int k, int r,
                                        int b, int c, float prod, float rs) {
  const size_t plane = (size_t)p.R * p.ld;
  const size_t at = (size_t)r * p.ld + c;
  const float* h_cur = p.h + (size_t)(t & 1) * plane;
  const float off1 = __ldg(p.off1);
  const float pre =
      k == 0 ? __ldcg(h_cur + at) * (__ldg(p.diag1 + c) - off1) + off1 * rs
             : __ldg(p.c_uk) * rs +
                   __ldcg(p.hid + (size_t)((k + 1) & 1) * plane + at);
  float v = fmaxf(pre + prod + __ldg(p.b + (size_t)k * p.N + c), 0.f);
  if (k < p.K - 1) {
    p.hid[(size_t)(k & 1) * plane + at] = v;
    return v;
  }
  if (!p.mask[(size_t)b * p.T + t]) v = __ldcg(h_cur + at);  // holds
  p.h[(size_t)((t + 1) & 1) * plane + at] = v;
  p.out[((size_t)b * p.T + t) * p.N + c] = v;
  return v;
}

// The store of a partial product: out[col * ld_out + row], rows < ld_out.
template <int NI>
__device__ __forceinline__ void store_partial(float* out, int ld_out,
                                              int row0, int colA, int colB,
                                              bool two,
                                              const float (&acc)[2][NI / 2]) {
  const int lane = threadIdx.x % 32;
  const int frag_row = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 1 && !two) break;
#pragma unroll
    for (int j = 0; j < NI / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + frag_row + (i >> 1) * 8;
        const int col = (c ? colB : colA) + 8 * j + 2 * (lane % 4) + (i & 1);
        if (row < ld_out) out[(size_t)col * ld_out + row] = acc[c][4 * j + i];
      }
  }
}

// BP_k: items (stretch s of 2r, MT rows of F, NI columns of each chain),
// the batch tile fastest so that neighbouring blocks share a weight tile.
template <int NI>
__device__ __forceinline__ void back_project_phase(const Params& p, int k,
                                                   unsigned char* smem) {
  Product o;
  o.a = p.dkt + (size_t)(k - 1) * p.N * p.Fp;
  o.lda = p.Fp;
  o.a_rows = p.Fp;
  o.act = p.hid + (size_t)((k + 1) & 1) * p.R * p.ld;  // layer k - 1
  o.ldb = p.ld;
  const int mt = (p.Fp + MT - 1) / MT;
  const int bt = p.bpc / NI;
  const int items = p.splits * mt * bt;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int col0 = (item % bt) * NI;
    const int row0 = (item / bt) % mt * MT;
    const int s = item / (bt * mt);
    o.v0 = s * p.split;
    o.v1 = min(p.N, (s + 1) * p.split);
    const bool two = col0 < p.B - p.half;
    float acc[2][NI / 2];
    item_product<NI>(o, row0, col0, p.bpc + col0, two, smem, acc);
    store_partial<NI>(p.part + (size_t)s * p.R * p.Fp, p.Fp, row0, col0,
                      p.bpc + col0, two, acc);
  }
}

// R_k: resid = x_t - part[0] - ... - part[S-1], four columns a thread.
__device__ __forceinline__ void residual_phase(const Params& p, int t) {
  const size_t plane = (size_t)p.R * p.Fp;
  const float* x_t = p.x + (size_t)t * plane;
  const int quads = p.Fp / 4;
  const long long n = (long long)p.R * quads;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / quads);
    if (batch_row(p, r) < 0) continue;
    const size_t at = (size_t)r * p.Fp + (size_t)(e % quads) * 4;
    float4 v = __ldg(reinterpret_cast<const float4*>(x_t + at));
    for (int s = 0; s < p.splits; ++s) {
      const float4 q =
          __ldcg(reinterpret_cast<const float4*>(p.part + s * plane + at));
      v.x -= q.x;
      v.y -= q.y;
      v.z -= q.z;
      v.w -= q.w;
    }
    *reinterpret_cast<float4*>(p.resid + at) = v;
  }
}

// srs[cl] = the rowsum of the carry at step t for the item's 2 NI scratch
// rows (cl < NI: chain A's from colA, else chain B's from colB): their
// partial sums, added in group order by one thread a row, after the whole
// block has staged them in shared memory (the ring, free between items),
// as many groups a pass as it holds.  Ends with a barrier.
template <int NI>
__device__ __forceinline__ void item_rowsums(const Params& p, int t,
                                             int colA, int colB,
                                             unsigned char* smem,
                                             float* srs) {
  using Rg = Ring<NI>;
  constexpr int COLS = 2 * NI;
  constexpr int CHUNK = Rg::PROMOTED / 4 / COLS;  // groups a pass
  const float* rsp = p.rsp + (size_t)(t & 1) * p.groups * p.R;
  float* stage = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int g0 = 0; g0 < p.groups; g0 += CHUNK) {
    const int gn = min(CHUNK, p.groups - g0);
    for (int e = tid; e < gn * COLS; e += THREADS) {
      const int cl = e % COLS;
      const int r = (cl < NI ? colA : colB) + cl % NI;
      stage[e] = __ldcg(rsp + (size_t)(g0 + e / COLS) * p.R + r);
    }
    __syncthreads();
    if (tid < COLS)
      for (int g = 0; g < gn; ++g) s += stage[g * COLS + tid];
    __syncthreads();
  }
  if (tid < COLS) srs[tid] = s;
  __syncthreads();
}

// P_k: items (MT rows of 2r, NI columns of each chain), each running the
// epilogue on its sums (at the last layer also the partial rowsums of its
// columns, through shared memory).  At k = 0 the items need the carry's
// rowsums (``item_rowsums``); those of the first row tile write them to rs
// for the later layers.
template <int NI>
__device__ __forceinline__ void project_phase(const Params& p, int t, int k,
                                              unsigned char* smem) {
  using Rg = Ring<NI>;
  Product o;
  o.a = p.dka + (size_t)k * p.F * p.ld;
  o.lda = p.ld;
  o.a_rows = p.ld;
  o.act = k == 0 ? p.x + (size_t)t * p.R * p.Fp : p.resid;
  o.ldb = p.Fp;
  o.v0 = 0;
  o.v1 = p.F;
  const bool last = k == p.K - 1;
  const int mt = (p.N + MT - 1) / MT;
  const int bt = p.bpc / NI;
  const int items = mt * bt;
  float* srs = reinterpret_cast<float*>(smem + Rg::SRS);
  float* rsp_next = p.rsp + (size_t)((t + 1) & 1) * p.groups * p.R;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int frag_row = (tid / 32) * 16 + lane / 4;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int col0 = (item % bt) * NI;
    const int row0 = item / bt * MT;
    const bool two = col0 < p.B - p.half;
    if (k == 0) {
      item_rowsums<NI>(p, t, col0, p.bpc + col0, smem, srs);
      if (row0 == 0 && tid < 2 * NI) {
        const int r = (tid < NI ? 0 : p.bpc) + col0 + tid % NI;
        if (batch_row(p, r) >= 0) p.rs[r] = srs[tid];
      }
    } else if (tid < 2 * NI) {  // read after item_product's barriers
      srs[tid] = __ldcg(p.rs + (tid < NI ? 0 : p.bpc) + col0 + tid % NI);
    }
    float acc[2][NI / 2];
    item_product<NI>(o, row0, col0, p.bpc + col0, two, smem, acc);
    float* tile_v = reinterpret_cast<float*>(smem);  // [2 NI][MT], the ring
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NI / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = frag_row + (i >> 1) * 8;
          const int cl = c * NI + 8 * j + 2 * (lane % 4) + (i & 1);
          const int r = (c ? p.bpc : 0) + col0 + cl % NI;
          const int b = batch_row(p, r);
          float v = 0.f;  // 0 past N and in rows past the batch
          if (row0 + rl < p.N && b >= 0)
            v = finish(p, t, k, r, b, row0 + rl, acc[c][4 * j + i], srs[cl]);
          if (last) tile_v[cl * MT + rl] = v;
        }
    if (last) {
      __syncthreads();
      // the new carry's partial rowsums, GROUP columns in column order
      for (int e = tid; e < 2 * NI * (MT / GROUP); e += THREADS) {
        const int gi = e % (MT / GROUP);
        const int cl = e / (MT / GROUP);
        const int r = (cl < NI ? 0 : p.bpc) + col0 + cl % NI;
        const int c0 = row0 + gi * GROUP;
        if (c0 >= p.N || batch_row(p, r) < 0) continue;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < GROUP; ++i) s += tile_v[cl * MT + gi * GROUP + i];
        rsp_next[(size_t)(c0 / GROUP) * p.R + r] = s;
      }
    }
    __syncthreads();  // the ring and srs are reused by the next item
  }
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 3)
drnmf_scan_factored_interleaved_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();

  // partial rowsums of h0, GROUP columns in column order, as the last
  // layer's epilogue sums every later carry
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < p.groups * p.R;
       e += gridDim.x * blockDim.x) {
    const int g = e / p.R;
    const int r = e % p.R;
    float s = 0.f;
    for (int c = 0; c < GROUP; ++c) {
      const int col = g * GROUP + c;
      s += col < p.N ? p.h[(size_t)r * p.ld + col] : 0.f;
    }
    p.rsp[e] = s;
  }
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    for (int k = 0; k < p.K; ++k) {
      if (k > 0) {
        back_project_phase<NI>(p, k, smem);
        grid.sync();
        residual_phase(p, t);
        grid.sync();
      }
      project_phase<NI>(p, t, k, smem);
      grid.sync();
    }
  }
}

using Kernel = void (*)(Params);

// The kernel of batch tile ni and its dynamic shared memory.
Kernel pick(int ni, int* smem) {
  if (ni == 8) {
    *smem = Ring<8>::SMEM_BYTES;
    return drnmf_scan_factored_interleaved_kernel<8>;
  }
  if (ni == 16) {
    *smem = Ring<16>::SMEM_BYTES;
    return drnmf_scan_factored_interleaved_kernel<16>;
  }
  return nullptr;
}

}  // namespace

// The number of blocks of the batch tile ni's kernel that the current
// device keeps resident at once with its dynamic shared memory, which
// bounds the grid of a cooperative launch; 0 when the device has no
// cooperative launch or ni is not built; a negative CUDA error code on
// failure.
extern "C" int drnmf_scan_factored_interleaved_capacity(int ni) {
  int smem = 0;
  Kernel kernel = pick(ni, &smem);
  if (kernel == nullptr) return 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  return coop ? sms * per_sm : 0;
}

extern "C" int drnmf_scan_factored_interleaved(
    const float* x, const unsigned char* mask, const float* diag1,
    const float* off1, const float* c_uk, const float* dkt, const float* dka,
    const float* b, float* h, float* hid, float* part, float* resid,
    float* rsp, float* rs, float* out, int B, int half, int bpc, int T, int F,
    int Fp, int N, int ld, int K, int ni, int split, int splits, int groups,
    int grid, void* stream) {
  int smem = 0;
  Kernel kernel = pick(ni, &smem);
  if (kernel == nullptr || B < 1 || half < (B + 1) / 2 || half > B ||
      bpc < half || bpc % ni != 0 || F < 1 || Fp < F || Fp % 4 != 0 ||
      N < 1 || ld < N || ld % 4 != 0 || K < 1 || split < 1 ||
      split % 16 != 0 || splits != (N + split - 1) / split ||
      groups != (N + GROUP - 1) / GROUP || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p{x,    mask, diag1, off1, c_uk, dkt, dka, b,       h, hid,
           part, resid, rsp, rs,  out,  B,   half, bpc, 2 * bpc, T,
           F,    Fp,   N,     ld,   K,    split, splits, groups};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(THREADS),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
