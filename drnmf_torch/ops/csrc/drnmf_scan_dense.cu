// Dense DR-NMF recurrence (full (2r, 2r) U and S matrices), kernel B3: the
// whole time scan in one cooperative launch, its products on the tensor
// cores in error-compensated TF32.
//
// Replaces drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel (entry
// drnmf_scan_pallas).  Per timestep t and batch row, with h the carried
// state (N = 2r wide) and x_t the input frame (F wide):
//
//   layer k:  hid_k = relu(h @ U_k + hid_{k-1} @ S_{k-1} + x_t @ W_k + b_k)
//             U_0 = u1, U_{k>0} = uk; the S term only for k > 0
//   h         = mask[b, t] ? hid_{K-1} : h;   out[b, t, :] = h
//
// What bounds it on an H100.  Per row and step 2*N*N*(2K-1) + 2*F*N*K flops
// (77.1 MFLOP at K=5, F=257, N=2000), so B=256, T=1021 is 20.2 TFLOP: 40.8
// ms in one TF32 pass at 495 TFLOP/s, 122 ms in the three passes a term
// this design does, 301 ms at the 67 TFLOP/s of the f32 CUDA cores.  The
// weights (u1, uk, K-1 S matrices, K W matrices: 106 MB at the flagship)
// fit neither shared memory nor the 50 MB L2, so each step reads at least
// the 56 MB past the L2 from HBM again.  Bound by operations at a large
// batch; by the weight reads and the grid synchronisations (10 a step at
// K=5, about 1.1 us each) at a batch of a few rows.
//
// The design.  Each layer is computed transposed, with the weights as the
// tensor cores' A operand as they are stored:
//   hid^T (N x B) = U_k^T h^T + S_{k-1}^T hid_{k-1}^T + W_k^T x_t^T.
// So 2r rides the instruction's M axis (128-row items, two warpgroups of 64)
// and the batch its N axis, NI = 8 .. 64 columns wide, so one row wastes
// 8x the tensor work, not 64x.  A(row j, depth k) = U[k * ld + j] is read
// with 16-byte cp.async.cg copies (the wrapper pads rows of the weights to
// a multiple of 4 floats only where 2r is not one) into a shared-memory
// tile [k][row], then into registers, split there into a TF32 head and an
// exact tail.  B = the activations h, hid (Bp, ld) and the frames x_t
// (Bp, Fp), all batch-major and contraction-contiguous (K-major), taken
// with 16-byte cp.async.cg copies into the 64-byte swizzle layout and split
// in place.  A term is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the mainloop of
// snmf_mu.cu, kernels B4/B5, whose primitives are in tf32_mma.cuh); a ring
// of 4 to 10 stages of 16 deep (more where the batch tile is narrow) in
// dynamic shared memory, two blocks an SM.
//
// The contraction of each layer, [h | hid_{k-1} | x_t] against
// [U_k ; S_{k-1} ; W_k], is taken as one axis of ld + ld + Fp depths (each
// segment padded to a multiple of 4 that reads as zero; no S segment at
// k = 0) and cut into stretches of a fixed length L, a multiple of 16 that
// the caller derives from (F, 2r) so that a later layer has 8 stretches:
// with 16 row tiles of 2r = 2000 that is 128 items a batch tile, one for
// each of the 132 SMs.  (Stretches cut per segment, L = 512, gave 9 a
// layer, 144 items: 12 SMs ran two, which doubled the layer's time at a
// few rows; see PERF.md.)  A work item is (stretch, 128 rows of 2r, NI
// columns of the batch); it runs the mainloop over its stretch and writes
// its partial to part[stretch] (Bp, ld).  Items that share a weight tile
// are neighbours in the grid order, so the blocks that run together read
// it from L2 and HBM sees each weight about once a step.  A second phase,
// elementwise over (B x ld), adds the partials in stretch order, then the
// bias, then relu; in the last layer it also holds masked steps from the
// carry, writes the carry's other buffer and the output.  Persistent
// blocks, a grid sync after each phase: 2 a layer.
//
// Accuracy.  The tensor cores add into their accumulator rounding toward
// zero, which biases long sums of the non-negative terms this recurrence
// has (h >= 0 after relu, U = exp(.) > 0, x >= 0, W >= 0).  As in B4/B5 the
// accumulator holds chains of PROMOTE = 8 stages (128 terms) only, and the
// chains are added in f32 on the CUDA cores into sums kept in shared
// memory; the stretches are then added in f32 by the second phase.
//
// Invariants.  No float atomics.  Every output element's partials are
// added in stretch order, then the bias.  L and the stretches depend on
// (F, 2r) alone, never on the batch or the grid, so a repeat is bit-equal
// and a row's sums do not depend on the rows it runs with (whether the
// tensor cores give a row the same bits at instruction widths 8 and 64 is
// measured on the card, chip_smoke.py).  Rows past B run on zeros and are
// never written; ragged edges are zero-filled on load and guarded on
// store; offsets are 64-bit.  Activations and partials that this kernel
// writes are read through L2 only (cp.async.cg, __ldcg).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller hands it the scratch), returns the CUDA
// error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;        // rows of 2r an item covers (M axis)
constexpr int BK = 16;         // contraction depth per stage: two k8 steps
constexpr int THREADS = 256;   // two warpgroups, 64 rows each
constexpr int A_LD = BM + 8;   // A tile stored [k][row]: conflict-free
constexpr int PROMOTE = 8;     // stages the tensor cores sum before f32

struct Params {
  const float* x;             // (T, Bp, Fp): frames, zero past F and B
  const unsigned char* mask;  // (B, T)
  const float* u1;            // (N, ld)
  const float* uk;            // (N, ld)
  const float* s;             // (max(1, K-1), N, ld)
  const float* w;             // (K, F, ld)
  const float* b;             // (K, N)
  float* state;               // (4, Bp, ld): h by step parity, hid by layer
  float* part;                // (S, Bp, ld): a layer's stretch partials
  float* out;                 // (B, T, N)
  int B, Bp, T, F, Fp, N, ld, K;
  int split;                  // L, the length of a stretch of a layer
};

// Shared memory of one block: a ring of stages (A tile, B hi tile, B lo
// tile) and the promoted sums, NI / 2 a thread.  The deepest ring that
// leaves room for two blocks an SM (94-101 KB a block): at 64 columns 4
// stages were 3.5% faster than 3, at a few rows more stages change nothing
// (tools/b3_variants.py).
template <int NI>
struct Ring {
  static constexpr int STAGES =
      NI == 8 ? 10 : (NI == 16 ? 8 : (NI == 32 ? 6 : 4));
  static constexpr int A_BYTES = BK * A_LD * 4;
  static constexpr int B_BYTES = NI * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + NI / 2 * THREADS * 4;
  static constexpr int A_PER_THREAD = BM * BK / 4 / THREADS;  // 16 bytes each
  static constexpr int B_PER_THREAD = (NI * BK / 4 + THREADS - 1) / THREADS;
  static_assert(NI % 8 == 0 && NI <= 64, "batch tile");
  static_assert(A_BYTES % 512 == 0 && B_BYTES % 512 == 0, "alignment");
  static_assert(BM * BK % (4 * THREADS) == 0, "A copies");
};

// Layer k of step t as one contraction over a virtual depth axis:
// [h (ld) | hid_{k-1} (ld, k > 0 only) | x_t (Fp)] against
// [U_k ; S_{k-1} ; W_k].  Every segment starts on a multiple of 4, and the
// depths past a segment's real length (its padding) read as zero.
struct Layer {
  const float* h;    // the carry (Bp, ld)
  const float* hid;  // hid_{k-1} (Bp, ld)
  const float* x;    // x_t (Bp, Fp)
  int k;
  int x_start;       // ld, or 2 ld when the S segment is there
  int total;         // x_start + Fp
};

// Segment of virtual depth d: 0 (h, U_k), 1 (hid, S_{k-1}) or 2 (x_t, W_k);
// *dl is the depth inside it.
__device__ __forceinline__ int segment(const Params& p, const Layer& l,
                                       int d, int* dl) {
  if (d >= l.x_start) {
    *dl = d - l.x_start;
    return 2;
  }
  const int j = d >= p.ld ? 1 : 0;
  *dl = d - j * p.ld;
  return j;
}

// out[col * ld + row] = sum over virtual depths d in [v0, v1) of A(row, d)
// B(col, d) for the item's rows [row0, row0 + 128) (stored where row < ld:
// past N the weights read as zero and 0 is stored) and columns
// [col0, col0 + NI): A(row, d) is the weight of d's segment at its depth
// there, as stored (rows of ld floats), B(col, d) the activation
// (contraction-contiguous).  v0 and v1 are multiples of 4.
template <int NI>
__device__ __forceinline__ void stretch_product(const Params& p,
                                                const Layer& l, int v0,
                                                int v1, int row0, int col0,
                                                float* out,
                                                unsigned char* smem) {
  using R = Ring<NI>;
  constexpr int STAGES = R::STAGES;
  const int tid = threadIdx.x;
  const int ktiles = (v1 - v0 + BK - 1) / BK;
  // a warpgroup takes 64 of the item's 128 rows, a warp 16 of those
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int frag_row = (tid / 32) * 16 + g;

  auto stage_a = [&](int slot) {
    return reinterpret_cast<float*>(smem + (size_t)slot * R::STAGE_BYTES);
  };
  auto stage_b = [&](int slot) {
    return smem + (size_t)slot * R::STAGE_BYTES + R::A_BYTES;
  };

  auto load_tile = [&](int kt) {
    const int slot = kt % STAGES;
    const int k0 = v0 + kt * BK;
    const uint32_t da = smem_u32(stage_a(slot));
#pragma unroll
    for (int q = 0; q < R::A_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int i = (e % (BM / 4)) * 4;
      int dl;
      const int j = segment(p, l, k0 + e / (BM / 4), &dl);
      const bool ok = row0 + i < p.ld && k0 + e / (BM / 4) < v1 &&
                      dl < (j == 2 ? p.F : p.N);
      const float* a = j == 0   ? (l.k == 0 ? p.u1 : p.uk)
                       : j == 1 ? p.s + (size_t)(l.k - 1) * p.N * p.ld
                                : p.w + (size_t)l.k * p.F * p.ld;
      const float* src = ok ? a + (size_t)dl * p.ld + (row0 + i) : p.u1;
      cp_async16(da + 4 * ((e / (BM / 4)) * A_LD + i), src, ok);
    }
    const uint32_t db = smem_u32(stage_b(slot));
#pragma unroll
    for (int q = 0; q < R::B_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int col = e / (BK / 4);
      const int k = (e % (BK / 4)) * 4;
      if (col >= NI) break;
      int dl;
      const int j = segment(p, l, k0 + k, &dl);
      const bool ok = k0 + k < v1 && dl < (j == 2 ? p.F : p.N);
      const float* src =
          j == 2 ? l.x + (size_t)(col0 + col) * p.Fp + dl
                 : (j == 0 ? l.h : l.hid) + (size_t)(col0 + col) * p.ld + dl;
      cp_async16(db + swizzle64_offset(col, k), ok ? src : l.x, ok);
    }
  };

  // hi in place, lo into the tile behind it, for the B elements this
  // thread copied (its own copies are visible to it after the wait)
  auto split_tile = [&](int kt) {
    unsigned char* b = stage_b(kt % STAGES);
#pragma unroll
    for (int q = 0; q < R::B_PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int col = e / (BK / 4);
      const int k = (e % (BK / 4)) * 4;
      if (col >= NI) break;
      unsigned char* at = b + swizzle64_offset(col, k);
      const float4 x = *reinterpret_cast<const float4*>(at);
      const uint4 hi = {tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                        tf32_hi(x.w)};
      const float4 lo = {x.x - __uint_as_float(hi.x),
                         x.y - __uint_as_float(hi.y),
                         x.z - __uint_as_float(hi.z),
                         x.w - __uint_as_float(hi.w)};
      *reinterpret_cast<uint4*>(at) = hi;
      *reinterpret_cast<float4*>(at + R::B_BYTES) = lo;
    }
    // the tensor cores read shared memory through the asynchronous proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = 0.f;
  // each thread's NI / 2 promoted sums in its own column of shared memory
  float* promoted =
      reinterpret_cast<float*>(smem + STAGES * R::STAGE_BYTES) + tid;
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) promoted[i * THREADS] = 0.f;
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) {
      promoted[i * THREADS] += acc[i];
      acc[i] = 0.f;
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
      const float v = at[k * A_LD + row];
      const uint32_t hi = tf32_hi(v);
      frag[s][0][i] = hi;
      frag[s][1][i] = __float_as_uint(v - __uint_as_float(hi));
    }
  };

  // the three products of step s, small terms first
  auto start_products = [&](int slot, int s) {
    const uint32_t b = smem_u32(stage_b(slot)) + 32 * s;  // 8 floats a step
    const uint64_t hi = b_descriptor(b);
    const uint64_t lo = b_descriptor(b + R::B_BYTES);
    wgmma_fence();
    wgmma_tf32(acc, frag[s][1], hi);
    wgmma_tf32(acc, frag[s][0], lo);
    wgmma_tf32(acc, frag[s][0], hi);
    wgmma_commit();
  };

  auto wait_products = [&]() {
    wgmma_wait();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pin(frag[s][0][i]);
        pin(frag[s][1][i]);
      }
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) pin(acc[i]);
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
    if (kt > 0 && kt % PROMOTE == 0) promote();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load_tile(kt + STAGES - 1);
    cp_async_commit();

    load_frags(slot, 0);
    start_products(slot, 0);
    if (v0 + kt * BK + 8 < v1) {
      load_frags(slot, 1);  // while step 0 runs
      start_products(slot, 1);
    }
  }
  wait_products();
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + frag_row + (i >> 1) * 8;
      const int col = col0 + 8 * j + 2 * t + (i & 1);
      if (row < p.ld)
        out[(size_t)col * p.ld + row] =
            promoted[(4 * j + i) * THREADS] + acc[4 * j + i];
    }
  }
  __syncthreads();  // the ring and the sums are reused by the next item
}

// Layer k's products: every (stretch, row tile, batch tile) item, the
// batch tile fastest so that neighbouring blocks share a weight tile.
template <int NI>
__device__ __forceinline__ void product_phase(const Params& p, int t, int k,
                                              unsigned char* smem) {
  const size_t plane = (size_t)p.Bp * p.ld;
  Layer l;
  l.h = p.state + (size_t)(t & 1) * plane;
  l.hid = p.state + (size_t)(2 + ((k + 1) & 1)) * plane;
  l.x = p.x + (size_t)t * p.Bp * p.Fp;
  l.k = k;
  l.x_start = (k > 0 ? 2 : 1) * p.ld;
  l.total = l.x_start + p.Fp;
  const int mt = (p.N + BM - 1) / BM;
  const int bt = p.Bp / NI;
  const int items = (l.total + p.split - 1) / p.split * mt * bt;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int col0 = (item % bt) * NI;
    const int row0 = (item / bt) % mt * BM;
    const int s = item / (bt * mt);
    stretch_product<NI>(p, l, s * p.split, min(l.total, (s + 1) * p.split),
                        row0, col0, p.part + (size_t)s * plane, smem);
  }
}

// Layer k's sums: part[0] + part[1] + ... in stretch order, + b_k, relu,
// four columns a thread, over the B real rows.  The last layer holds
// masked steps from the carry, writes the other carry buffer and out.
__device__ __forceinline__ void reduce_phase(const Params& p, int t, int k) {
  const size_t plane = (size_t)p.Bp * p.ld;
  const bool last = k == p.K - 1;
  const int stretches =
      ((k > 0 ? 2 : 1) * p.ld + p.Fp + p.split - 1) / p.split;
  const float* h_cur = p.state + (size_t)(t & 1) * plane;
  float* h_next = p.state + (size_t)((t + 1) & 1) * plane;
  float* hid_out = p.state + (size_t)(2 + (k & 1)) * plane;
  const float* bias = p.b + (size_t)k * p.N;
  const int quads = p.ld / 4;
  const long long n = (long long)p.B * quads;

  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const int row = (int)(e / quads);
    const int c0 = (int)(e % quads) * 4;
    const size_t at = (size_t)row * p.ld + c0;
    float4 v = __ldcg(reinterpret_cast<const float4*>(p.part + at));
    for (int s = 1; s < stretches; ++s) {
      const float4 q =
          __ldcg(reinterpret_cast<const float4*>(p.part + s * plane + at));
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)  // 0 in the padding past N
      r[i] = fmaxf(r[i] + (c0 + i < p.N ? __ldg(bias + c0 + i) : 0.f), 0.f);
    if (!last) {
      *reinterpret_cast<float4*>(hid_out + at) =
          make_float4(r[0], r[1], r[2], r[3]);
      continue;
    }
    if (!p.mask[(size_t)row * p.T + t]) {  // a masked step holds
      const float4 h = __ldcg(reinterpret_cast<const float4*>(h_cur + at));
      r[0] = h.x;
      r[1] = h.y;
      r[2] = h.z;
      r[3] = h.w;
    }
    *reinterpret_cast<float4*>(h_next + at) =
        make_float4(r[0], r[1], r[2], r[3]);
    float* o = p.out + ((size_t)row * p.T + t) * p.N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < p.N) o[c0 + i] = r[i];
  }
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 2)
drnmf_scan_dense_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < p.T; ++t) {
    for (int k = 0; k < p.K; ++k) {
      product_phase<NI>(p, t, k, smem);
      grid.sync();  // every partial of layer k is written
      reduce_phase(p, t, k);
      grid.sync();  // layer k is complete before anything reads it
    }
  }
}

using Kernel = void (*)(Params);

// The kernel of batch tile ni and its dynamic shared memory.
Kernel pick(int ni, int* smem) {
#define DRNMF_PICK(NI)                          \
  if (ni == NI) {                               \
    *smem = Ring<NI>::SMEM_BYTES;               \
    return drnmf_scan_dense_kernel<NI>;         \
  }
  DRNMF_PICK(8) DRNMF_PICK(16) DRNMF_PICK(32) DRNMF_PICK(64)
#undef DRNMF_PICK
  return nullptr;
}

}  // namespace

// The number of blocks of the ni-column kernel that the current device
// keeps resident at once with its dynamic shared memory, which bounds the
// grid of a cooperative launch; 0 when the device has no cooperative launch
// or ni is not built; a negative CUDA error code on failure.
extern "C" int drnmf_scan_dense_capacity(int ni) {
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

extern "C" int drnmf_scan_dense(const float* x, const unsigned char* mask,
                                const float* u1, const float* uk,
                                const float* s, const float* w,
                                const float* b, float* state, float* part,
                                float* out, int B, int Bp, int T, int F,
                                int Fp, int N, int ld, int K, int ni,
                                int split, int grid, void* stream) {
  int smem = 0;
  Kernel kernel = pick(ni, &smem);
  if (kernel == nullptr || B < 1 || Bp < B || Bp % ni != 0 || F < 1 ||
      Fp < F || Fp % 4 != 0 || N < 1 || ld < N || ld % 4 != 0 || K < 1 ||
      split < 1 || split % BK != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p{x, mask, u1, uk, s,  w, b,  state, part,
           out, B, Bp, T,  F, Fp, N, ld, K, split};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(THREADS),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
