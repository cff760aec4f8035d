// Double-single float32 Gram matrix G = A^T A with a compensated,
// in-order reduction across row blocks. CUDA C++ for sm_90a (H100).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_gram.py::_gram_kernel
// (launched by ds32_gram_pallas). It computes the same function:
//   a1 = f32(A), a2 = f32(A - f64(a1));
//   per row block b of `bn` rows: p_b = a1^T a1 + (a1^T a2 + a2^T a1),
//   f32 products accumulated in f32 (no tensor cores: TF32 keeps 10
//   mantissa bits, the demotion Precision.HIGHEST guards against on
//   the TPU);
//   across blocks, in block order, a (hi, lo) f32 pair updated by
//   TwoSum; the result is f64(hi) + f64(lo).
//
// What bounds it on the card: f32 operations on the CUDA cores. At the
// main path's G_BB (n = 100,000 rows, 100,352 once padded to 1024-row
// blocks, q = 64) it does 3 * 2 * n * q^2 = 2.46 GFLOP against 51 MB
// of f64 input, 37 us at the 67 TFLOP/s f32 peak against 15 us of
// memory traffic at 3.35 TB/s. The ECORR Schur term (n_e = 25,000
// epochs, 25,600 padded, q = 64) is 0.63 GFLOP. The function itself
// needs about half of that, 2 * n * (q(q+1)/2 + q^2): G is symmetric
// and a2^T a1 is the transpose of a1^T a2, so its bound at G_BB is
// 18 us, still operation-bound.
//
// Design (simple, right first):
//   pass 1: grid = (row block) x (32 x 32 output tile). Each block reads
//     its rows of the f64 A straight from device memory, splits them in
//     registers into a1/a2, stages the halves in shared memory (no
//     a1/a2 arrays ever reach device memory), and each thread keeps a
//     2 x 2 patch of three f32 FFMA accumulators (a1a1, a1a2, a2a1).
//     Each 32-row chunk is accumulated afresh and then added to the
//     block's sums: one sequential f32 sum over all 1024 rows would
//     carry ~sqrt(1024) ulps of error (~2e-6 of G), above the 1e-6
//     the reference's tests hold the TPU kernel to; over 32-row chunks
//     it stays near 2e-7. It writes p_b to an f32 scratch (nb, q, q).
//   pass 2: one thread per output element walks b = 0 .. nb-1 in order
//     with TwoSum into (hi, lo) and writes f64 hi + lo. Deterministic:
//     no atomics anywhere.
// Not done yet (later work): the lower triangle is computed although G
// is symmetric, and the loads are plain (no cp.async / TMA staging).
//
// The TwoSum uses __fadd_rn / __fsub_rn so that no compiler pass can
// reassociate or contract it. Never build with --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;     // output tile edge
constexpr int kRows = 32;     // rows staged in shared memory per step
constexpr int kThreads = 256; // 16 x 16 threads, 2 x 2 outputs each

__global__ void __launch_bounds__(kThreads)
ds32_gram_partials(const double* __restrict__ A, float* __restrict__ P,
                   int n, int q, int bn) {
  const int b = blockIdx.x;
  const int ntile = (q + kTile - 1) / kTile;
  const int i0 = (blockIdx.y / ntile) * kTile;
  const int j0 = (blockIdx.y % ntile) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  __shared__ float a1[kRows][kTile];
  __shared__ float a2[kRows][kTile];
  __shared__ float b1[kRows][kTile];
  __shared__ float b2[kRows][kTile];

  float s11[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float s12[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float s21[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  const int row_begin = b * bn;
  const int row_end = min(row_begin + bn, n);
  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile;
      const int cc = e % kTile;
      const int row = r0 + rr;
      double x = 0.0, y = 0.0;
      if (row < row_end) {
        const double* arow = A + (size_t)row * q;
        if (i0 + cc < q) x = arow[i0 + cc];
        if (j0 + cc < q) y = arow[j0 + cc];
      }
      const float x1 = __double2float_rn(x);
      const float y1 = __double2float_rn(y);
      a1[rr][cc] = x1;
      a2[rr][cc] = __double2float_rn(__dsub_rn(x, (double)x1));
      b1[rr][cc] = y1;
      b2[rr][cc] = __double2float_rn(__dsub_rn(y, (double)y1));
    }
    __syncthreads();
    // this chunk's products in fresh accumulators, then added to the
    // block's: sequential f32 sums over 32 rows, not over 1024, keep
    // the accumulation error near sqrt(32) ulps
    float c11[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float c12[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float c21[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      const float ai1[2] = {a1[rr][ty], a1[rr][ty + 16]};
      const float ai2[2] = {a2[rr][ty], a2[rr][ty + 16]};
      const float bj1[2] = {b1[rr][tx], b1[rr][tx + 16]};
      const float bj2[2] = {b2[rr][tx], b2[rr][tx + 16]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          c11[u][v] = __fmaf_rn(ai1[u], bj1[v], c11[u][v]);
          c12[u][v] = __fmaf_rn(ai1[u], bj2[v], c12[u][v]);
          c21[u][v] = __fmaf_rn(ai2[u], bj1[v], c21[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        s11[u][v] = __fadd_rn(s11[u][v], c11[u][v]);
        s12[u][v] = __fadd_rn(s12[u][v], c12[u][v]);
        s21[u][v] = __fadd_rn(s21[u][v], c21[u][v]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = i0 + ty + 16 * u;
      const int j = j0 + tx + 16 * v;
      if (i < q && j < q) {
        // the reference grouping: a1a1 + (a1a2 + a2a1)
        P[((size_t)b * q + i) * q + j] =
            __fadd_rn(s11[u][v], __fadd_rn(s12[u][v], s21[u][v]));
      }
    }
  }
}

__global__ void ds32_gram_reduce(const float* __restrict__ P,
                                 double* __restrict__ G, int qq, int nb) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= qq) return;
  float hi = P[k];
  float lo = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float p = P[(size_t)b * qq + k];
    // TwoSum(hi, p): exact in IEEE f32 round-to-nearest
    const float s = __fadd_rn(hi, p);
    const float bv = __fsub_rn(s, hi);
    const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bv)),
                                __fsub_rn(p, bv));
    hi = s;
    lo = __fadd_rn(lo, err);
  }
  G[k] = __dadd_rn((double)hi, (double)lo);
}

}  // namespace

// A: (n, q) f64 row-major on the card; P: (nb, q, q) f32 scratch;
// G: (q, q) f64 output. Launches both passes on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError().
extern "C" int ds32_gram_launch(const double* A, float* P, double* G,
                                int n, int q, int bn, int nb, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntile = (q + kTile - 1) / kTile;
  dim3 grid1(nb, ntile * ntile);
  ds32_gram_partials<<<grid1, kThreads, 0, s>>>(A, P, n, q, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int qq = q * q;
  ds32_gram_reduce<<<(qq + 255) / 256, 256, 0, s>>>(P, G, qq, nb);
  return (int)cudaGetLastError();
}
