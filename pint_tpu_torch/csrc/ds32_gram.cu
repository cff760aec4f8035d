// Double-single float32 Gram matrix G = A^T A with a compensated,
// in-order reduction across row blocks. CUDA C++ for sm_90a (H100).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_gram.py::_gram_kernel
// (launched by ds32_gram_pallas). It computes the same function:
//   a1 = f32(A), a2 = f32(A - f64(a1));
//   per row block b of `bn` rows: p_b = a1^T a1 + (a1^T a2 + a2^T a1),
//   f32 products accumulated in f32 (no tensor cores: TF32 keeps 10
//   mantissa bits, the demotion Precision.HIGHEST guards against on
//   the TPU), each 32-row chunk by sequential FFMAs in row order from
//   0, then added into the block's sum;
//   across blocks, in block order, a (hi, lo) f32 pair updated by
//   TwoSum; the result is f64(hi) + f64(lo).
//
// What bounds it on the card: f32 FMA issue on the CUDA cores. The
// function needs 2 * n * (q(q+1)/2 + q^2) flops against 8 * n * q bytes
// of f64 input: at the main path's G_BB (n = 100,000, q = 66) 19.6 us at
// the 67 TFLOP/s f32 peak against 15.8 us of memory traffic at
// 3.35 TB/s; the ECORR Schur term (n = 25,000 epochs) is a quarter of
// that. So the card must read A about once and keep the FMA pipes
// busy. What the design does about it:
//
//   * every output patch is the same work: a thread owns a 4 x 4 patch
//     of outputs (i, j) and carries three FFMA chains per output,
//     H_ij = a1_i a1_j, C_ij = a1_i a2_j and C_ji = a2_i a1_j
//     (fmaf(a2_i, a1_j, .) is exactly fmaf(a1_j, a2_i, .)), so
//     p_ij = H_ij + (C_ij + C_ji) is formed by the thread itself and only
//     the patches that hold some i <= j are computed: 48 FFMAs per four
//     16-byte shared loads a row, and no patch waits on another.
//   * the tiles follow q (ops/gram.py::_tile_plan, which the wrapper
//     passes as the tile edge and the task count), one build per range:
//       narrow, q <= 68: one diagonal tile as wide as q rounded up to 4,
//         one task (<= 153 patches on 160 threads), so q = 66 issues
//         1.125x the FFMAs of q = 64 (three 64 x 64 tile pairs issued
//         3.96x);
//       one-tile, q <= 128: one tile, its patch list dealt to the fewest
//         tasks of <= 128 patches, each on four warps, one per SM
//         sub-partition (a task of 136 patches on five warps would give
//         one sub-partition two warps and cost what 256 patches cost);
//       pairs, q > 128: 64-column tiles and one as wide as the remainder
//         rounded up to 4; a task is a tile pair (256 patches on eight
//         warps when both are full); where the last tile is at most 28
//         columns wide (q = 341), each full diagonal pair keeps 128 of
//         its 136 patches and the other 8 ride with its pair to the last
//         tile, so both fit four warps.
//   * at least two blocks per SM on every build, with no spill: a block
//     stages one f64 stage (cp.async, 8 bytes a copy: any q, any row
//     alignment) and two (a1, a2) f32 stages, 32 rows (narrow, pairs) or
//     16 (one-tile, whose blocks are short and fit four to an SM); the
//     16 sums of H per thread live in shared memory, so the 48 chains,
//     their operands and the 32 other sums fit 128 registers
//     (__launch_bounds__). A block's split and barrier then overlap other
//     blocks' FFMAs.
//   * A is read from device memory about once: the tasks are on
//     blockIdx.x, which the card dispatches fastest, so all tasks of a
//     row block run back to back while its rows are in L2 (q = 480: one
//     416-row block is 1.6 MB of the 50 MB L2).
//   * one barrier per stage: each thread copies, and then splits, the
//     same staged elements of every stage, so stage k + 2's copies go out
//     right after stage k + 1's split, while stage k is multiplied from
//     the other f32 stage.
//   * why 4 x 4 patches and not 8 x 4 or 8 x 8: three chains per output
//     make an 8 x 4 patch 96 chunk accumulators and 96 block sums, past
//     the 128 registers that two blocks of 256 threads leave, and wider
//     patches waste more at the diagonal and on a narrow last tile
//     (72 patches of 8 x 4 cover a 64-wide diagonal with 12% more FFMAs
//     than needed, 136 of 4 x 4 with 6%). The loop as it is, alone, runs
//     at ~80% of the f32 peak (tools/ds32_gram_probe.py section 5): its
//     shared loads are not what holds the pass back.
//
//   pass 1 (ds32_gram_partials_narrow / _tile / _pairs): grid = (task)
//     x (row block) x (batch member). Writes the f32 partial p_b, upper
//     triangle packed row by row, to the scratch P (batch, nb,
//     q(q+1)/2).
//   pass 2 (ds32_gram_reduce): one thread per upper element walks
//     b = 0 .. nb-1 in order with TwoSum into (hi, lo) and writes
//     G[i, j] = G[j, i] = f64 hi + lo. Deterministic: no atomics. It
//     stays a second launch: folded into the last block of each task, a
//     row block's q(q+1)/2 serial chains of nb steps would run on one SM
//     after the partials, where the separate pass spreads them over the
//     card.
//
// The batched form (the PTA joint fit's stage 2, one Gram per pulsar of
// a catalog; Pallas's batching rule turns the reference's vmap into a
// grid axis the same way) puts the member index on blockIdx.z of the
// partials and blockIdx.y of the reduce: A is (batch, n, q), each
// member's partials and output are offset by its index, and nothing
// else changes, so each member's G is bit for bit what a launch on that
// member alone gives. The 2-D wrapper (ops/gram.py::ds32_gram) launches
// it with batch = 1.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py,
// device time per GLS step, G_BB + Schur; PERF.md section 6):
//   q = 66 (main path)  0.0995-0.1002 ms, under cuBLAS f64 A^T A's
//                       0.1058-0.1067 ms, 1.008-1.017x q = 64's
//                       0.0985-0.0991; 24.5% of its 0.0245 ms bound
//                       (the three tile pairs before took 0.3751);
//   q = 341 (binary)    1.581-1.598 ms, 40.8-41.2% of 0.6515 ms;
//   q = 480 (noise)     2.891-2.923 ms, 44.1-44.6% of 1.2904 ms;
//   PTA, 68 members     1.334 ms, 28.4% of 0.3785 ms (torch.bmm 0.93).
// Builds: narrow 127-128 registers, 3 blocks per SM; one-tile 127-128,
// 4; pairs 127, 2; no spill. What holds the pass back:
// tools/ds32_gram_probe.py (the staging on every warp's path, sub-
// partition balance and block prologues, then the four shared loads a
// row: the loop alone runs at 47-50 TFLOP/s, 63 without them).
//
// The sums use __fmaf_rn / __fadd_rn / __fsub_rn so that no compiler
// pass can reassociate or contract them. Never build with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace {

constexpr int kRows = 32;          // rows per stage and per f32 chunk sum
constexpr int kPatch = 4;          // a thread's patch: kPatch x kPatch outputs
constexpr int kTile = 64;          // the pairs build's tile edge
constexpr int kNarrowEdge = 68;    // q <= 68: the narrow build's one tile
constexpr int kOneTile = 128;      // q <= 128: the one-tile build's tile

// A build: kThreads threads that own one patch each and stage kCols f64
// columns (kThreads / kCols rows of one column each) kStageRows rows at
// a time (a 32-row chunk or half of one); kMinBlocks blocks per SM.
template <int kThreads_, int kCols_, int kStageRows_, int kMinBlocks_>
struct Build {
  static constexpr int kThreads = kThreads_;
  static constexpr int kCols = kCols_;
  static constexpr int kStageRows = kStageRows_;
  static constexpr int kMinBlocks = kMinBlocks_;
  // dynamic shared memory: one f64 stage, two (a1, a2) f32 stages and
  // each thread's 16 sums of H
  static constexpr size_t kShared =
      (size_t)kStageRows * kCols * (sizeof(double) + 2 * 2 * sizeof(float)) +
      (size_t)16 * kThreads * sizeof(float);
};
// q <= 68: one diagonal tile, up to 17 * 18 / 2 = 153 patches
using Narrow = Build<160, 80, kRows, 2>;
// q <= 128: one tile, runs of up to 128 of its patches
using OneTile = Build<128, 128, kRows / 2, 4>;
// a tile pair of up to 64 + 64 columns: up to 16 * 16 = 256 patches
using Pairs = Build<256, 128, kRows, 2>;

// cp.async of kBytes (4 or 8) from device to shared memory; src-size 0
// fills the bytes with zeros (rows past the block's end, columns past q)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// packed index of (i, j), i <= j, in the row-by-row upper triangle
__device__ __forceinline__ size_t upper_index(int i, int j, int q) {
  return (size_t)i * (2 * (size_t)q - i + 1) / 2 + (j - i);
}

__device__ __forceinline__ void as_array(const float4 x, float (&v)[4]) {
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// Task t (blockIdx.x) of the plan: tiles of `edge` columns, the last
// one cut at q, each tile's width rounded up to kPatch (the padded
// columns are staged as zeros). With one tile (q <= edge) the ntasks
// tasks share its patch list in equal runs; otherwise task t is tile
// pair t (I <= J, row by row) with all its patches, but where the last
// tile is narrow enough (kTaskPatches - 8 patches or fewer in a pair
// with it), each full diagonal pair keeps its first kTaskPatches
// patches and the other 8 ride with the pair (I, last tile), whose
// block stages tile I too: every such task then fits four warps, one per
// SM sub-partition. As ops/gram.py::TilePlan.tasks lists them.
constexpr int kTaskPatches = 128;

struct Pair {
  int i0, wi;  // tile I: first column, padded width
  int j0, wj;  // tile J
  bool diag;
  int p0, p1;  // the run of the pair's patch list this task computes
  int x0, x1;  // and the run of tile I's diagonal patch list
};

__device__ __forceinline__ Pair pair_of(int t, int ntasks, int q, int edge) {
  const int nt = (q + edge - 1) / edge;
  auto width = [&](int k) {
    return (min(edge, q - k * edge) + kPatch - 1) / kPatch * kPatch;
  };
  if (nt == 1) {
    const int m = width(0) / kPatch;
    const int np = m * (m + 1) / 2;
    return {0, width(0), 0, width(0), true, t * np / ntasks,
            (t + 1) * np / ntasks, 0, 0};
  }
  int I = 0;
  while (t >= nt - I) { t -= nt - I; ++I; }
  const int J = I + t;
  const int wi = width(I), wj = width(J), m = wi / kPatch;
  const int full = m * (m + 1) / 2;  // a diagonal pair's patches
  const int rest = full - kTaskPatches;
  const bool ride = rest > 0 && width(nt - 1) < edge &&
                    m * (width(nt - 1) / kPatch) + rest <= kTaskPatches;
  if (I == J)
    return {I * edge, wi, J * edge, wj, true, 0,
            ride && J < nt - 1 ? kTaskPatches : full, 0, 0};
  const bool rides = ride && J == nt - 1;
  return {I * edge, wi, J * edge, wj, false, 0, m * (wj / kPatch),
          rides ? kTaskPatches : 0, rides ? full : 0};
}

// Entry e of the diagonal patch list of an m-patch-wide tile (gy <= gx
// row by row): (gy, gx).
__device__ __forceinline__ void diag_patch(int e, int m, int& gy, int& gx) {
  gy = 0;
  while (gy < m && e >= m - gy) { e -= m - gy; ++gy; }
  gx = gy + e;
}

// This thread's patch in task `pr`: entry p0 + threadIdx.x of the
// pair's patch list (a diagonal pair: the patches with gy <= gx row by
// row; otherwise all of them row by row) if it is before p1, else the
// next entry of the run [x0, x1) of tile I's diagonal list; threads
// past both only stage. si, sj: the patch's first staged column of i
// and of j; dj: the output column of staged column 0 of its j (its i's
// is pr.i0).
__device__ __forceinline__ bool patch_of(const Pair& pr, int& si, int& sj,
                                         int& dj) {
  const int p = pr.p0 + threadIdx.x;
  int gy, gx;
  if (p < pr.p1) {
    if (pr.diag) {
      diag_patch(p, pr.wi / kPatch, gy, gx);
    } else {
      const int mj = pr.wj / kPatch;
      gy = p / mj;
      gx = p - gy * mj;
    }
    si = kPatch * gy;
    sj = (pr.diag ? 0 : pr.wi) + kPatch * gx;
    dj = pr.diag ? pr.i0 : pr.j0 - pr.wi;
    return true;
  }
  const int e = pr.x0 + (p - pr.p1);
  diag_patch(e, pr.wi / kPatch, gy, gx);
  si = kPatch * gy;
  sj = kPatch * gx;
  dj = pr.i0;
  return e < pr.x1;
}

// kN rows of a patch's three chains, from row 0 of the stage `a1`, `a2`.
template <int kCols, int kN>
__device__ __forceinline__ void patch_rows(const float* __restrict__ a1,
                                           const float* __restrict__ a2,
                                           int si, int sj, float (&cH)[4][4],
                                           float (&c12)[4][4],
                                           float (&c21)[4][4]) {
#pragma unroll 8
  for (int rr = 0; rr < kN; ++rr) {
    float ai1[4], ai2[4], bj1[4], bj2[4];
    as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + si), ai1);
    as_array(*reinterpret_cast<const float4*>(a2 + rr * kCols + si), ai2);
    as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + sj), bj1);
    as_array(*reinterpret_cast<const float4*>(a2 + rr * kCols + sj), bj2);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        cH[u][v] = __fmaf_rn(ai1[u], bj1[v], cH[u][v]);
        c12[u][v] = __fmaf_rn(ai1[u], bj2[v], c12[u][v]);
        c21[u][v] = __fmaf_rn(ai2[u], bj1[v], c21[u][v]);
      }
  }
}

// A chunk's chains added into the block's sums and reset to 0. The sums
// of H live in shared memory (this thread's 16, kThreads apart from
// `sH`), so that the 48 chains, their operands and the other 32 sums fit
// 128 registers without a spill.
template <int kThreads>
__device__ __forceinline__ void add_chunk(float (&cH)[4][4], float (&c12)[4][4],
                                          float (&c21)[4][4], float* sH,
                                          float (&s12)[4][4],
                                          float (&s21)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float& h = sH[(4 * u + v) * kThreads];
      h = __fadd_rn(h, cH[u][v]);
      s12[u][v] = __fadd_rn(s12[u][v], c12[u][v]);
      s21[u][v] = __fadd_rn(s21[u][v], c21[u][v]);
      cH[u][v] = c12[u][v] = c21[u][v] = 0.f;
    }
}

// The partials of task blockIdx.x over row block blockIdx.y of member
// blockIdx.z.
template <class B>
__device__ __forceinline__ void partials(const double* __restrict__ A,
                                         float* __restrict__ P, int n, int q,
                                         int bn, int edge) {
  constexpr int kCols = B::kCols;
  constexpr int kSR = B::kStageRows;
  constexpr int kPerChunk = kRows / kSR;  // stages per 32-row chunk
  constexpr int kRowStep = B::kThreads / kCols;
  constexpr int kSteps = kSR / kRowStep;
  static_assert(B::kThreads % kCols == 0 && kSR % kRowStep == 0 &&
                    kRows % kSR == 0,
                "staging layout");
  extern __shared__ __align__(16) unsigned char smem[];
  double* stage = reinterpret_cast<double*>(smem);
  float* a1s = reinterpret_cast<float*>(stage + kSR * kCols);
  float* a2s = a1s + 2 * kSR * kCols;
  float* sH = a2s + 2 * kSR * kCols + threadIdx.x;  // [16][kThreads]

  // this block's rows, as stages of kSR rows (the last chunk's rows past
  // the block are zeros)
  const int row_begin = blockIdx.y * bn;
  const int row_end = min(row_begin + bn, n);
  const int nstages = (row_end - row_begin + kRows - 1) / kRows * kPerChunk;
  const Pair pr = pair_of(blockIdx.x, gridDim.x, q, edge);
  const int staged = pr.diag ? pr.wi : pr.wi + pr.wj;

  // staging: this thread copies, and later splits, column slot c (tile
  // I's columns, then tile J's) of rows r, r + kRowStep, ... of every
  // stage: after its own cp.async.wait_group they are visible to it
  // without a barrier, and it alone rewrites them. `src` is its element
  // of the next stage to copy (of this member, blockIdx.z) and `left`
  // the block's rows from there on; a copy of a row past the block or a
  // column past q reads nothing (src-size 0) and fills zeros.
  const int c = threadIdx.x % kCols;
  const int r = threadIdx.x / kCols;
  const bool stages = c < staged;
  const int col = c < pr.wi ? pr.i0 + c : pr.j0 + (c - pr.wi);
  const bool col_ok = stages && col < q;
  const int at = r * kCols + c;
  const double* src =
      A + ((size_t)blockIdx.z * n + row_begin + r) * q + (col_ok ? col : 0);
  int left = row_end - row_begin - r;

  // copies stage k (the calls come in stage order; nothing past the last)
  auto issue = [&](int k) {
    if (stages && k < nstages) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const bool valid = col_ok && s * kRowStep < left;
        cp_async<8>(stage + at + s * kRowStep * kCols,
                    src + (size_t)(s * kRowStep) * q, valid);
      }
    }
    cp_async_commit();  // an empty group keeps the count
    src += (size_t)kSR * q;
    left -= kSR;
  };
  // splits the landed stage k into f32 stage k & 1
  auto split = [&](int k) {
    cp_async_wait<0>();
    if (!stages) return;
    float* d1 = a1s + (k & 1) * kSR * kCols;
    float* d2 = a2s + (k & 1) * kSR * kCols;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int e = at + s * kRowStep * kCols;
      const double x = stage[e];
      const float x1 = __double2float_rn(x);
      d1[e] = x1;
      d2[e] = __double2float_rn(__dsub_rn(x, (double)x1));
    }
  };

  issue(0);
  split(0);
  issue(1);
  int si = 0, sj = 0, dj = 0;
  const bool active = patch_of(pr, si, sj, dj);
  float cH[4][4] = {}, c12[4][4] = {}, c21[4][4] = {};
  float s12[4][4] = {}, s21[4][4] = {};
#pragma unroll
  for (int e = 0; e < 16; ++e) sH[e * B::kThreads] = 0.f;
  __syncthreads();
  for (int k = 0; k < nstages; ++k) {
    if (active) {
      patch_rows<kCols, kSR>(a1s + (k & 1) * kSR * kCols,
                             a2s + (k & 1) * kSR * kCols, si, sj, cH, c12,
                             c21);
      if (k % kPerChunk == kPerChunk - 1)
        add_chunk<B::kThreads>(cH, c12, c21, sH, s12, s21);
    }
    if (k + 1 < nstages) split(k + 1);
    issue(k + 2);
    // stage k + 1's f32 rows are whole, and every thread is done with
    // stage k's, which stage k + 2's split overwrites
    __syncthreads();
  }

  if (!active) return;
  // this block's partials: p = H + (C_ij + C_ji) for i <= j < q
  const size_t nup = (size_t)q * (q + 1) / 2;
  float* Pb = P + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * nup;
  const int i0 = pr.i0 + si;
  const int j0 = dj + sj;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + u, j = j0 + v;
      if (i <= j && j < q)
        Pb[upper_index(i, j, q)] = __fadd_rn(
            sH[(4 * u + v) * B::kThreads], __fadd_rn(s12[u][v], s21[u][v]));
    }
}

__global__ void __launch_bounds__(Narrow::kThreads, Narrow::kMinBlocks)
    ds32_gram_partials_narrow(const double* __restrict__ A,
                              float* __restrict__ P, int n, int q, int bn,
                              int edge) {
  partials<Narrow>(A, P, n, q, bn, edge);
}

__global__ void __launch_bounds__(OneTile::kThreads, OneTile::kMinBlocks)
    ds32_gram_partials_tile(const double* __restrict__ A,
                            float* __restrict__ P, int n, int q, int bn,
                            int edge) {
  partials<OneTile>(A, P, n, q, bn, edge);
}

__global__ void __launch_bounds__(Pairs::kThreads, Pairs::kMinBlocks)
    ds32_gram_partials_pairs(const double* __restrict__ A,
                             float* __restrict__ P, int n, int q, int bn,
                             int edge) {
  partials<Pairs>(A, P, n, q, bn, edge);
}

// grid (ceil(q(q+1)/2 / 64), batch): one thread per upper element, in
// packed order, so consecutive threads read consecutive partials. Only
// q(q+1)/2 threads (2,211 at q = 66: fewer warps than SMs), each a chain
// of nb dependent steps, so load latency would set the pace: each thread
// stages its partials `stage` = min(nb, kStage) at a time into shared
// memory, every copy in flight at once, and then walks them there. The
// shared memory follows nb, so a batch's many short chains (the PTA
// fit: nb = 69 or 138) keep more blocks resident.
constexpr int kReduceThreads = 64;
constexpr int kStage = 256;
constexpr size_t reduce_shared(int stage) {
  return (size_t)stage * kReduceThreads * sizeof(float);
}

// (i, j) of packed upper index p of a q x q matrix: the largest i with
// upper_index(i, i, q) <= p
__device__ __forceinline__ void upper_ij(size_t p, int q, int& i, int& j) {
  const double b = 2.0 * q + 1.0;
  i = (int)((b - sqrt(b * b - 8.0 * (double)p)) * 0.5);
  i = max(0, min(i, q - 1));
  while (i > 0 && upper_index(i, i, q) > p) --i;
  while (i + 1 < q && upper_index(i + 1, i + 1, q) <= p) ++i;
  j = i + (int)(p - upper_index(i, i, q));
}

__global__ void __launch_bounds__(kReduceThreads)
    ds32_gram_reduce(const float* __restrict__ P, double* __restrict__ G,
                     int q, int nb, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [stage][kReduceThreads]
  const size_t nup = (size_t)q * (q + 1) / 2;
  const size_t e = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= nup) return;  // no barrier below: each thread reads what it copied
  // this block's batch member (blockIdx.y)
  G += (size_t)blockIdx.y * q * q;
  const float* p = P + (size_t)blockIdx.y * nb * nup + e;
  float* x = xs + threadIdx.x;
  float hi = 0.f;
  float lo = 0.f;
  for (int b0 = 0; b0 < nb; b0 += stage) {
    const int m = min(stage, nb - b0);
    for (int t = 0; t < m; ++t)
      cp_async<4>(x + t * kReduceThreads, p + (size_t)(b0 + t) * nup, true);
    cp_async_commit();
    cp_async_wait<0>();
    int t = 0;
    if (b0 == 0) hi = x[kReduceThreads * t++];
#pragma unroll 8
    for (; t < m; ++t) {
      const float v = x[t * kReduceThreads];
      // TwoSum(hi, v): exact in IEEE f32 round-to-nearest
      const float s = __fadd_rn(hi, v);
      const float bv = __fsub_rn(s, hi);
      const float err =
          __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bv)), __fsub_rn(v, bv));
      hi = s;
      lo = __fadd_rn(lo, err);
    }
  }
  int i, j;
  upper_ij(e, q, i, j);
  const double g = __dadd_rn((double)hi, (double)lo);
  G[(size_t)i * q + j] = g;
  G[(size_t)j * q + i] = g;
}

// The kernels' dynamic shared memory above 48 KiB, allowed once per
// process and device.
cudaError_t allow_shared() {
  cudaError_t err = cudaFuncSetAttribute(
      ds32_gram_partials_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Narrow::kShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ds32_gram_partials_tile,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)OneTile::kShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ds32_gram_partials_pairs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Pairs::kShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ds32_gram_reduce,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)reduce_shared(kStage));
  return err;
}

constexpr int kMaxDevices = 64;
std::once_flag g_shared_once[kMaxDevices];
cudaError_t g_shared_err[kMaxDevices];

// allow_shared() on the current device `device`, once
cudaError_t allow_shared_once(int device) {
  if (device < 0 || device >= kMaxDevices) return allow_shared();
  std::call_once(g_shared_once[device],
                 [device] { g_shared_err[device] = allow_shared(); });
  return g_shared_err[device];
}

// Makes `device` current for a scope, and the previous device again
// after it, only where they differ.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// A: (batch, n, q) f64 row-major on the card; P: (batch, nb, q(q+1)/2)
// f32 scratch; G: (batch, q, q) f64 output. `edge` and `ntasks` are the
// tile plan's (ops/gram.py::_tile_plan): edge 68 is the narrow build's
// one tile in one task, edge 128 the one-tile build's tile in ntasks
// runs of at most 128 patches, edge 64 the pairs build's tile pairs.
// Launches both passes on `stream` (a cudaStream_t passed as a pointer)
// and returns cudaGetLastError(), or cudaErrorInvalidValue for any other
// plan.
extern "C" int ds32_gram_batched_launch(const double* A, float* P, double* G,
                                        int batch, int n, int q, int bn,
                                        int nb, int edge, int ntasks,
                                        int device, void* stream) {
  const long long nt = edge > 0 ? (q + edge - 1) / edge : 0;
  const int m = (q + kPatch - 1) / kPatch;  // one tile's patch rows
  const bool ok =
      edge == kNarrowEdge ? nt == 1 && ntasks == 1
      : edge == kOneTile  ? nt == 1 && ntasks >= 1 &&
                               (m * (m + 1) / 2 + ntasks - 1) / ntasks <=
                                   OneTile::kThreads
                          : edge == kTile && nt > 1 &&
                               ntasks == nt * (nt + 1) / 2;
  if (!ok) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = allow_shared_once(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(ntasks, nb, batch);
  if (edge == kNarrowEdge)
    ds32_gram_partials_narrow<<<grid1, Narrow::kThreads, Narrow::kShared, s>>>(
        A, P, n, q, bn, edge);
  else if (edge == kOneTile)
    ds32_gram_partials_tile<<<grid1, OneTile::kThreads, OneTile::kShared, s>>>(
        A, P, n, q, bn, edge);
  else
    ds32_gram_partials_pairs<<<grid1, Pairs::kThreads, Pairs::kShared, s>>>(
        A, P, n, q, bn, edge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nup = (size_t)q * (q + 1) / 2;
  const dim3 grid2((unsigned)((nup + kReduceThreads - 1) / kReduceThreads),
                   batch);
  const int stage = nb < kStage ? nb : kStage;
  ds32_gram_reduce<<<grid2, kReduceThreads, reduce_shared(stage), s>>>(
      P, G, q, nb, stage);
  return (int)cudaGetLastError();
}

// What one kernel runs with on `device`: out[0..4] = threads per block,
// registers per thread, local (spill) bytes per thread, dynamic shared
// bytes per block, resident blocks per SM. kernel: 0 the narrow
// partials, 1 the one-tile partials, 2 the pairs partials, 3 the reduce.
extern "C" int ds32_gram_build_info(int kernel, int device, int* out) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = allow_shared_once(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn;
  int threads;
  size_t shared;
  switch (kernel) {
    case 0:
      fn = (const void*)ds32_gram_partials_narrow;
      threads = Narrow::kThreads;
      shared = Narrow::kShared;
      break;
    case 1:
      fn = (const void*)ds32_gram_partials_tile;
      threads = OneTile::kThreads;
      shared = OneTile::kShared;
      break;
    case 2:
      fn = (const void*)ds32_gram_partials_pairs;
      threads = Pairs::kThreads;
      shared = Pairs::kShared;
      break;
    case 3:
      fn = (const void*)ds32_gram_reduce;
      threads = kReduceThreads;
      shared = reduce_shared(kStage);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      shared);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shared;
  out[4] = blocks;
  return 0;
}
