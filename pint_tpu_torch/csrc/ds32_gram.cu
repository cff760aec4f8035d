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
// of f64 input: at the main path's G_BB (n = 100,000, q = 64) 18 us at
// the 67 TFLOP/s f32 peak against 15 us of memory traffic at 3.35 TB/s;
// the ECORR Schur term (n = 25,000 epochs) is a quarter of that. What
// the design does about it:
//   * the work done is the symmetric half. a2^T a1 is the transpose of
//     a1^T a2, so C = a1^T a2 is accumulated once and the cross term of
//     G[i, j] is C[i, j] + C[j, i] (fmaf(a2_i, a1_j, .) is exactly
//     fmaf(a1_j, a2_i, .), so this is bit for bit the separate product);
//     H = a1^T a1 is accumulated only on the 4 x 4 patches with i <= j;
//     only the upper triangle of each partial is written.
//   * enough blocks to fill 132 SMs: the wrapper sizes row blocks as
//     bn = min(1024, max(32, round_up(ceil(n / 256), 32))), so the main
//     path's shapes launch 241 and 196 blocks (ops/gram.py).
//   * one 256-thread block covers a 64 x 64 output tile pair (I <= J)
//     for its row block, so at q <= 64 each f64 element is read from
//     device memory by one block and split once. Each thread keeps 4 x 4
//     patches in registers and reads its operands as 16-byte shared
//     loads: per row 3 loads for up to 32 FFMAs.
//   * the f64 rows of each 32-row chunk are staged into shared memory
//     with 8-byte cp.async (any q, any row alignment), two stages deep,
//     so the next chunks load while this one is multiplied; each thread
//     splits the elements it copied itself into a1/a2 f32 arrays.
//   * thread-to-patch order: the 136 patches with i <= j come first, so
//     warps 0-3 hold only those, warps 5-7 only lower patches (C alone,
//     16 FFMAs a row instead of 32), and only warp 4 is mixed.
//
//   pass 1 (ds32_gram_partials): grid = (row block) x (tile pair) x
//     (batch member). Writes the f32 partial p_b, upper triangle packed
//     row by row, to the scratch P (batch, nb, q(q+1)/2).
//   pass 2 (ds32_gram_reduce): one thread per upper element walks
//     b = 0 .. nb-1 in order with TwoSum into (hi, lo) and writes
//     G[i, j] = G[j, i] = f64 hi + lo. Deterministic: no atomics. The
//     chain is serial, so each thread first stages its partials into
//     shared memory with every copy in flight.
//
// The batched form (the PTA joint fit's stage 2, one Gram per pulsar of
// a catalog; Pallas's batching rule turns the reference's vmap into a
// grid axis the same way) puts the member index on blockIdx.z of both
// passes: A is (batch, n, q), each member's partials and output are
// offset by its index, and nothing else changes, so each member's G is
// bit for bit what a launch on that member alone gives. The 2-D
// wrapper (ops/gram.py::ds32_gram) launches it with batch = 1.
//
// Measured on an H100 SXM at 700 W (PERF.md): the partials pass takes
// about twice the cycles its busiest sub-partition has instructions to
// issue, and the whole call is ~4x the operation bound. The likely
// stalls, not yet told apart: with 4 x 4 patches a warp issues 3
// shared loads per 32 FFMAs, 121 registers leave 4 warps per
// sub-partition to hide their latency, and a barrier every 32 rows
// makes the lower warps wait for the upper ones.
//
// The sums use __fmaf_rn / __fadd_rn / __fsub_rn so that no compiler
// pass can reassociate or contract them. Never build with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kRows = 32;      // rows per stage and per f32 chunk sum
constexpr int kThreads = 256;  // 16 x 16 patches of 4 x 4 outputs
constexpr int kPatch = 4;
constexpr int kPatches = kTile / kPatch;                     // 16
constexpr int kUpperPatches = kPatches * (kPatches + 1) / 2;  // 136

// Dynamic shared memory of a block staging kCols columns: two f64 stages
// and two (a1, a2) f32 stages. kCols = 64: the diagonal tile only
// (q <= 64); kCols = 128: tiles I and J side by side.
constexpr size_t shared_bytes(int cols) {
  return 2 * kRows * cols * sizeof(double) +
         2 * 2 * kRows * cols * sizeof(float);
}

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
  return (size_t)i * (2 * q - i + 1) / 2 + (j - i);
}

__device__ __forceinline__ void as_array(const float4 x, float (&v)[4]) {
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// The rows [row_begin, row_end) of the staged columns, chunk by chunk:
// cp.async two stages ahead, split into a1/a2, then body(a1, a2) on the
// chunk's kRows x kCols f32 arrays (row stride kCols). kWidth columns
// are staged: col_i .. col_i + 63, then col_j .. col_j + 63.
template <int kCols, int kWidth, class Body>
__device__ __forceinline__ void walk_chunks(const double* __restrict__ A,
                                            int q, int row_begin,
                                            int row_end, int col_i,
                                            int col_j, unsigned char* smem,
                                            Body body) {
  static_assert(kThreads % kWidth == 0 && kWidth <= kCols, "staging layout");
  constexpr int kRowStep = kThreads / kWidth;
  constexpr int kSteps = kRows / kRowStep;
  double* stage = reinterpret_cast<double*>(smem);
  float* a1s = reinterpret_cast<float*>(stage + 2 * kRows * kCols);
  float* a2s = a1s + 2 * kRows * kCols;
  const int nchunks = (row_end - row_begin + kRows - 1) / kRows;
  // each thread copies, and later splits, one column c of rows
  // r, r + kRowStep, ...: after its own cp.async.wait_group they are
  // visible to it without a barrier
  const int r = threadIdx.x / kWidth;
  const int c = threadIdx.x % kWidth;
  const int col = c < kTile ? col_i + c : col_j + (c - kTile);
  const bool col_ok = col < q;
  const int at = r * kCols + c;

  auto issue = [&](int k) {
    if (k < nchunks) {
      double* dst = stage + (k & 1) * kRows * kCols + at;
      const int row0 = row_begin + k * kRows + r;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int row = row0 + s * kRowStep;
        const bool valid = col_ok && row < row_end;
        cp_async<8>(dst + s * kRowStep * kCols,
                    valid ? A + (size_t)row * q + col : A, valid);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  issue(0);
  issue(1);
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<1>();  // chunk k has landed; chunk k + 1 may be in flight
    const double* src = stage + (k & 1) * kRows * kCols;
    float* d1 = a1s + (k & 1) * kRows * kCols;
    float* d2 = a2s + (k & 1) * kRows * kCols;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int e = at + s * kRowStep * kCols;
      const double x = src[e];
      const float x1 = __double2float_rn(x);
      d1[e] = x1;
      d2[e] = __double2float_rn(__dsub_rn(x, (double)x1));
    }
    // a1/a2 of chunk k are visible, and every thread is done with
    // chunk k - 1's arrays (the other f32 stage) and with this f64 stage
    __syncthreads();
    issue(k + 2);
    body(d1, d2);
  }
}

// Diagonal tile pair (I == J): H = a1^T a1 on the patches with i <= j,
// C = a1^T a2 on every patch. kH: 1 = every lane of the warp has i <= j,
// 0 = none has, 2 = per lane (the one mixed warp).
template <int kCols, int kH>
__device__ __forceinline__ void diag_chunk(const float* __restrict__ a1,
                                           const float* __restrict__ a2,
                                           int pi, int pj, bool upper,
                                           float (&sH)[4][4],
                                           float (&sC)[4][4]) {
  float cH[4][4] = {}, cC[4][4] = {};
#pragma unroll 8
  for (int rr = 0; rr < kRows; ++rr) {
    float ai[4], bj1[4], bj2[4];
    as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + pi), ai);
    as_array(*reinterpret_cast<const float4*>(a2 + rr * kCols + pj), bj2);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) cC[u][v] = __fmaf_rn(ai[u], bj2[v], cC[u][v]);
    if (kH == 1 || (kH == 2 && upper)) {
      as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + pj), bj1);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          cH[u][v] = __fmaf_rn(ai[u], bj1[v], cH[u][v]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sC[u][v] = __fadd_rn(sC[u][v], cC[u][v]);
      if (kH == 1 || (kH == 2 && upper)) sH[u][v] = __fadd_rn(sH[u][v], cH[u][v]);
    }
}

template <int kCols>
__device__ __forceinline__ void diag_tile(const double* __restrict__ A,
                                          float* __restrict__ P, int q,
                                          int row_begin, int row_end, int I,
                                          unsigned char* smem) {
  // this thread's patch: entry threadIdx.x of the list "the 136 patches
  // with pi <= pj row by row, then the 120 with pi > pj row by row"
  int py = 0, px = 0;
  {
    int t = threadIdx.x;
    if (t < kUpperPatches) {
      while (t >= kPatches - py) { t -= kPatches - py; ++py; }
      px = py + t;
    } else {
      t -= kUpperPatches;
      py = 1;
      while (t >= py) { t -= py; ++py; }
      px = t;
    }
  }
  const bool upper = py <= px;
  const int pi = kPatch * py;
  const int pj = kPatch * px;
  // warp-uniform choice of the chunk body (warps 0-3 all upper, 5-7 all
  // lower, warp 4 mixed)
  const int warp_first = threadIdx.x & ~31;
  const int kind = warp_first + 32 <= kUpperPatches ? 1
                   : warp_first >= kUpperPatches    ? 0
                                                    : 2;

  float sH[4][4] = {}, sC[4][4] = {};
  walk_chunks<kCols, kTile>(A, q, row_begin, row_end, I * kTile, I * kTile,
                            smem, [&](const float* a1, const float* a2) {
                       if (kind == 1)
                         diag_chunk<kCols, 1>(a1, a2, pi, pj, upper, sH, sC);
                       else if (kind == 0)
                         diag_chunk<kCols, 0>(a1, a2, pi, pj, upper, sH, sC);
                       else
                         diag_chunk<kCols, 2>(a1, a2, pi, pj, upper, sH, sC);
                     });

  // C through shared memory (over the f64 stages: every copy has landed
  // and been split before the last chunk's barrier), then
  // p_ij = H_ij + (C_ij + C_ji) for i <= j
  constexpr int kStride = kTile + 1;
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) Cs[(pi + u) * kStride + pj + v] = sC[u][v];
  __syncthreads();
  if (!upper) return;
  const int i0 = I * kTile;
  const size_t nup = (size_t)q * (q + 1) / 2;
  float* Pb = P + (size_t)blockIdx.x * nup;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = pi + u, j = pj + v;
      if (i <= j && i0 + j < q) {
        Pb[upper_index(i0 + i, i0 + j, q)] = __fadd_rn(
            sH[u][v], __fadd_rn(sC[u][v], Cs[j * kStride + i]));
      }
    }
}

// Off-diagonal tile pair (I < J): all three products, as p = H + (C12 +
// C21) with H = a1_I^T a1_J, C12 = a1_I^T a2_J, C21 = a2_I^T a1_J.
__device__ __forceinline__ void offdiag_tile(const double* __restrict__ A,
                                             float* __restrict__ P, int q,
                                             int row_begin, int row_end,
                                             int I, int J,
                                             unsigned char* smem) {
  constexpr int kCols = 2 * kTile;
  const int pi = kPatch * (threadIdx.x >> 4);
  const int pj = kTile + kPatch * (threadIdx.x & 15);
  float sH[4][4] = {}, s12[4][4] = {}, s21[4][4] = {};
  walk_chunks<kCols, kCols>(
      A, q, row_begin, row_end, I * kTile, J * kTile, smem,
      [&](const float* a1, const float* a2) {
        float cH[4][4] = {}, c12[4][4] = {}, c21[4][4] = {};
#pragma unroll 4
        for (int rr = 0; rr < kRows; ++rr) {
          float ai1[4], ai2[4], bj1[4], bj2[4];
          as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + pi), ai1);
          as_array(*reinterpret_cast<const float4*>(a2 + rr * kCols + pi), ai2);
          as_array(*reinterpret_cast<const float4*>(a1 + rr * kCols + pj), bj1);
          as_array(*reinterpret_cast<const float4*>(a2 + rr * kCols + pj), bj2);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              cH[u][v] = __fmaf_rn(ai1[u], bj1[v], cH[u][v]);
              c12[u][v] = __fmaf_rn(ai1[u], bj2[v], c12[u][v]);
              c21[u][v] = __fmaf_rn(ai2[u], bj1[v], c21[u][v]);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            sH[u][v] = __fadd_rn(sH[u][v], cH[u][v]);
            s12[u][v] = __fadd_rn(s12[u][v], c12[u][v]);
            s21[u][v] = __fadd_rn(s21[u][v], c21[u][v]);
          }
      });
  const int i0 = I * kTile + pi;
  const int j0 = J * kTile + pj - kTile;
  const size_t nup = (size_t)q * (q + 1) / 2;
  float* Pb = P + (size_t)blockIdx.x * nup;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (i0 + u < q && j0 + v < q) {
        Pb[upper_index(i0 + u, j0 + v, q)] =
            __fadd_rn(sH[u][v], __fadd_rn(s12[u][v], s21[u][v]));
      }
    }
}

// kCols = 64: q <= 64, one diagonal tile, two blocks per SM.
// kCols = 128: tile pairs (I, J), I <= J, row by row on blockIdx.y.
template <int kCols>
__global__ void __launch_bounds__(kThreads, kCols == kTile ? 2 : 1)
    ds32_gram_partials(const double* __restrict__ A, float* __restrict__ P,
                       int n, int q, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's batch member (blockIdx.z): its rows and its partials
  A += (size_t)blockIdx.z * n * q;
  P += (size_t)blockIdx.z * gridDim.x * ((size_t)q * (q + 1) / 2);
  const int row_begin = blockIdx.x * bn;
  const int row_end = min(row_begin + bn, n);
  if constexpr (kCols == kTile) {
    diag_tile<kCols>(A, P, q, row_begin, row_end, 0, smem);
  } else {
    const int nt = (q + kTile - 1) / kTile;
    int I = 0, t = blockIdx.y;
    while (t >= nt - I) { t -= nt - I; ++I; }
    const int J = I + t;
    if (I == J)
      diag_tile<kCols>(A, P, q, row_begin, row_end, I, smem);
    else
      offdiag_tile(A, P, q, row_begin, row_end, I, J, smem);
  }
}

// grid (ceil(q / 64), q, batch): block row i, thread j >= i. Only q(q+1)/2
// threads (2,080 at q = 64: fewer warps than SMs), each a chain of nb
// dependent steps, so load latency would set the pace: each thread
// stages its partials kStage at a time into shared memory, every copy
// in flight at once, and then walks them there.
constexpr int kReduceThreads = 64;
constexpr int kStage = 128;

__global__ void __launch_bounds__(kReduceThreads)
    ds32_gram_reduce(const float* __restrict__ P, double* __restrict__ G,
                     int q, int nb) {
  __shared__ float xs[kStage][kReduceThreads];
  const int i = blockIdx.y;
  const int j = i + blockIdx.x * kReduceThreads + threadIdx.x;
  if (j >= q) return;  // no barrier below: each thread reads what it copied
  const size_t nup = (size_t)q * (q + 1) / 2;
  // this block's batch member (blockIdx.z)
  G += (size_t)blockIdx.z * q * q;
  const float* p = P + (size_t)blockIdx.z * nb * nup + upper_index(i, j, q);
  float hi = 0.f;
  float lo = 0.f;
  for (int b0 = 0; b0 < nb; b0 += kStage) {
    const int m = min(kStage, nb - b0);
    for (int t = 0; t < m; ++t)
      cp_async<4>(&xs[t][threadIdx.x], p + (size_t)(b0 + t) * nup, true);
    cp_async_commit();
    cp_async_wait<0>();
    int t = 0;
    if (b0 == 0) hi = xs[t++][threadIdx.x];
#pragma unroll 8
    for (; t < m; ++t) {
      const float x = xs[t][threadIdx.x];
      // TwoSum(hi, x): exact in IEEE f32 round-to-nearest
      const float s = __fadd_rn(hi, x);
      const float bv = __fsub_rn(s, hi);
      const float err =
          __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bv)), __fsub_rn(x, bv));
      hi = s;
      lo = __fadd_rn(lo, err);
    }
  }
  const double g = __dadd_rn((double)hi, (double)lo);
  G[(size_t)i * q + j] = g;
  G[(size_t)j * q + i] = g;
}

// tile pairs (I <= J) of the partials grid (blockIdx.y) for q columns
int tile_pairs(int q) {
  const int nt = (q + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

template <int kCols>
cudaError_t launch_partials(dim3 grid, cudaStream_t s, const double* A,
                            float* P, int n, int q, int bn) {
  constexpr size_t smem = shared_bytes(kCols);
  cudaError_t err = cudaFuncSetAttribute(
      ds32_gram_partials<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ds32_gram_partials<kCols><<<grid, kThreads, smem, s>>>(A, P, n, q, bn);
  return cudaGetLastError();
}

}  // namespace

// A: (batch, n, q) f64 row-major on the card; P: (batch, nb, q(q+1)/2)
// f32 scratch; G: (batch, q, q) f64 output. Launches both passes on
// `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError().
extern "C" int ds32_gram_batched_launch(const double* A, float* P, double* G,
                                        int batch, int n, int q, int bn,
                                        int nb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(nb, tile_pairs(q), batch);
  err = q <= kTile ? launch_partials<kTile>(grid1, s, A, P, n, q, bn)
                   : launch_partials<2 * kTile>(grid1, s, A, P, n, q, bn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((q + kReduceThreads - 1) / kReduceThreads, q, batch);
  ds32_gram_reduce<<<grid2, kReduceThreads, 0, s>>>(P, G, q, nb);
  return (int)cudaGetLastError();
}
