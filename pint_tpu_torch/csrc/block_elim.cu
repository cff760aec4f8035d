// Per-pulsar block elimination of the PTA joint solve. CUDA C++ for
// sm_90a (H100).
//
// Replaces no TPU kernel: the JAX package leaves these solves to
// jax.scipy's cho_solve (pint_tpu/parallel/pta.py). On the card the
// library route was a chain of per-matrix cuSOLVER potrs calls (torch's
// cholesky_solve loops over the batch when a solve has more than one
// right-hand side), two cuBLAS trsm launches each, for every pulsar of
// every evaluation; this kernel does one pulsar's system per block.
//
// What it computes, per member g and system s of one launch, in float64
// (ops/block_elim.py::block_elim_reference is the same function in
// PyTorch operators). With S the member's reduced Gram (q x q), rhs its
// right-hand side, k GW columns, m = q - k, p timing columns and
// kpl = m - p red-noise columns:
//   s = 0, the full system: A = S[:m, :m], B = S[:m, m:], c = rhs[:m],
//     C = S[m:, m:], d = rhs[m:], A_j = A + eps tr(A) I. Writes
//     Yp = (A_j^-1 B)[:p], zp = (A_j^-1 c)[:p], a = diag(A_j^-1)[:p],
//     K = C - B^T A_j^-1 B and g = d - B^T A_j^-1 c;
//   s = 1, the noise-only system: the same with the rows and columns
//     [p, q) of S only (A = S[p:m, p:m]). Writes K, g and c^T A_j^-1 c.
// A system whose pivots are not all positive (or are NaN) gets NaN in
// every output it writes; the other systems are untouched.
//
// How: the system is bordered, [[A_j, B, c], [B^T, C, d], [c^T, d^T, 0]],
// and held in shared memory (lower triangle) with its rows in the order
// red noise, timing (full system only), GW, rhs. The kpl red-noise
// pivots are eliminated first, as the unscaled (LDL^T) form of a
// right-looking Cholesky: entry (i, l) of the trailing block takes
// -M[i][j] M[l][j] / M[j][j]. Then the p timing pivots are swept
// (symmetric Gauss-Jordan: the swept block holds -inverse, its rows
// the solved right-hand sides). After both, the timing block holds
// -(A_j^-1)[:p, :p], the timing rows hold (A_j^-1 [B c])[:p], and the
// GW and rhs block holds the Schur complement [[K, g], [g^T, -c^T z]]:
// no triangular solve follows. In exact arithmetic this is the
// Cholesky route's function; the pivot order (red noise first) differs,
// and the pivots are each positive exactly when A_j is positive
// definite.
//
// What bounds it on the card: the latency of the m dependent pivot
// steps. The work is small (about 0.2 M FMAs and 90 KB staged per
// system at the pta68 shapes, q = 106; 6.2 MB of reads for all 136
// systems, 2 us at 3.35 TB/s), so the bound by bytes or operations is a
// few microseconds, and a block spends its time waiting on one pivot
// after another. What the design does about that:
//   * one block per system, and both systems of every member in one
//     launch (grid = members x systems: 136 blocks at pta68 for 132 SMs,
//     two blocks to an SM where they share one), so one launch per shape
//     group per evaluation replaces ~550 library launches;
//   * one barrier per pivot: the column of the next pivot is written to
//     a second buffer by the threads that update it, during the update,
//     so the next step reads its pivot column from a buffer no thread of
//     this step writes (two buffers, alternating);
//   * the pivot column is kept in registers: lane x of a warp updates
//     columns lo + x + 32 s of the rows its warp owns, so each step
//     reads the column once per thread and the update is one shared
//     load, one FMA and one shared store per entry; two rows at a time,
//     so that one row's loads overlap the other's. Two builds, of 4
//     column slots (q + 1 <= 128, pta68's 107) and of 6 (up to 169),
//     so that a narrow system issues no idle slots;
//   * the red-noise pivots, all but p of them, run a loop with no
//     sweep cases, so an update is those three instructions and a
//     predicate (a first build, one general loop of 6 slots for every
//     pivot, ran 2.4x slower);
//   * the rows have an odd stride, so a warp walking a column (the
//     strided reads of the staging and of the outputs) hits every bank
//     once;
//   * no triangular solve: the timing rows are swept (above), so the
//     step and the uncertainties read their rows directly.

#include <cuda_runtime.h>

#include <initializer_list>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the column slots of a lane: a build holds bordered orders up to 32 x
// slots (kNarrowSlots, or kSlots up to kMaxOrder)
constexpr int kNarrowSlots = 4;
constexpr int kSlots = 6;
constexpr int kMaxOrder = 32 * kSlots;
// the dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxShared = 232448;
constexpr double kEps = 2.220446049250313e-16;  // float64 machine epsilon

__host__ __device__ inline int row_stride(int n1) { return n1 | 1; }

// The bordered matrix of order n1 (lower triangle in a square array of
// odd stride) and the two pivot-column buffers.
__host__ __device__ inline size_t shared_bytes(int n1) {
  return sizeof(double) *
         ((size_t)n1 * row_stride(n1) + 2 * (size_t)n1);
}

// Whether one block takes bordered order n1: the column slots hold it
// and its working set fits kMaxShared.
inline bool fits(int n1) {
  return n1 >= 2 && n1 <= kMaxOrder && shared_bytes(n1) <= kMaxShared;
}

// One sweep step on pivot j over the lower triangle of rows and columns
// [lo, n1): entry (i, l) takes -col[i] col[l] / d, the pivot's own row
// and column become col / d and its diagonal -1 / d. Writes the
// symmetric column j + 1 to `nxt`.
template <int kS>
__device__ inline void sweep_step(double* M, int ld, int n1, int lo, int j,
                                  const double* col, double* nxt, double rinv,
                                  int lane, int warp) {
  double cl[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int l = lo + lane + 32 * s;
    cl[s] = l < n1 ? col[l] : 0.0;
  }
  for (int i = lo + warp; i < n1; i += kWarps) {
    const double coli = col[i];
    const double ci = coli * rinv;
    double* row = M + i * ld;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int l = lo + lane + 32 * s;
      if (l <= i) {
        const double v = i == j || l == j
                             ? (i == l ? -rinv : (i == j ? cl[s] : coli) * rinv)
                             : fma(-ci, cl[s], row[l]);
        row[l] = v;
        if (l == j + 1)
          nxt[i] = v;
        else if (i == j + 1)
          nxt[l] = v;
      }
    }
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads)
    pta_block_elim(const double* __restrict__ S, long long s_member,
                   long long s_row, const double* __restrict__ rhs,
                   long long r_member, int q, int p, int k,
                   double* __restrict__ Yp, double* __restrict__ zp,
                   double* __restrict__ a, double* __restrict__ K,
                   double* __restrict__ g, double* __restrict__ nK,
                   double* __restrict__ ng, double* __restrict__ ncz) {
  extern __shared__ double smem[];
  const long long member = blockIdx.x;
  const bool full = blockIdx.y == 0;
  const int m = q - k, kpl = m - p;
  const int nA = kpl + (full ? p : 0);  // the order of A
  const int n1 = nA + k + 1;            // bordered by the GW columns and rhs
  const int ld = row_stride(n1);
  double* M = smem;
  double* cols = smem + (size_t)n1 * ld;
  const double* Sg = S + member * s_member;
  const double* cg = rhs + member * r_member;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the index into S of position `pos` (-1: the rhs border)
  auto src = [&](int pos) {
    if (pos < kpl) return p + pos;
    pos -= kpl;
    if (full) {
      if (pos < p) return pos;
      pos -= p;
    }
    return pos < k ? m + pos : -1;
  };

  // stage the lower triangle, a warp to a row: A from S's lower triangle,
  // B from S[:m, m:] and C from its lower triangle, as the library route
  // reads them
  for (int r = warp; r < n1; r += kWarps) {
    const int sr = src(r);
#pragma unroll 4
    for (int c = lane; c <= r; c += 32) {
      const int sc = src(c);
      const int hi = sr > sc ? sr : sc, lo = sr > sc ? sc : sr;
      double v;
      if (sr < 0)
        v = sc < 0 ? 0.0 : cg[sc];
      else if (hi < m || lo >= m)
        v = Sg[hi * s_row + lo];
      else
        v = Sg[lo * s_row + hi];
      M[r * ld + c] = v;
    }
  }
  __syncthreads();
  // the jitter eps * tr(A) on A's diagonal
  if (warp == 0) {
    double tr = 0.0;
    for (int i = lane; i < nA; i += 32) tr += M[i * ld + i];
    for (int o = 16; o > 0; o >>= 1) tr += __shfl_xor_sync(0xffffffffu, tr, o);
    for (int i = lane; i < nA; i += 32) M[i * ld + i] += kEps * tr;
  }
  __syncthreads();
  for (int i = tid; i < n1; i += kThreads) cols[i] = M[i * ld];
  __syncthreads();

  // the red-noise pivots: Schur updates of the trailing lower triangle.
  // Lane x owns columns lo + x + 32 s of its warp's rows, two rows at a
  // time: all their loads, then the FMAs and stores.
  bool ok = true;
  for (int j = 0; j < kpl; ++j) {
    const double* col = cols + (j & 1) * n1;
    double* nxt = cols + ((j + 1) & 1) * n1;
    const double d = col[j];
    ok = ok && d > 0.0;
    const double rinv = 1.0 / d;
    const int lo = j + 1;
    double cl[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int l = lo + lane + 32 * s;
      cl[s] = l < n1 ? col[l] : 0.0;
    }
    for (int i = lo + warp; i < n1; i += 2 * kWarps) {
      const int i2 = i + kWarps;
      const bool two = i2 < n1;
      const int w1 = i - lo, w2 = two ? i2 - lo : -1;
      double* r1 = M + i * ld + lo + lane;
      double* r2 = M + (two ? i2 : i) * ld + lo + lane;
      const double c1 = col[i] * rinv, c2 = two ? col[i2] * rinv : 0.0;
      double v1[kS], v2[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        v1[s] = lane + 32 * s <= w1 ? r1[32 * s] : 0.0;
        v2[s] = lane + 32 * s <= w2 ? r2[32 * s] : 0.0;
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        v1[s] = fma(-c1, cl[s], v1[s]);
        v2[s] = fma(-c2, cl[s], v2[s]);
        if (lane + 32 * s <= w1) r1[32 * s] = v1[s];
        if (lane + 32 * s <= w2) r2[32 * s] = v2[s];
      }
      if (lane == 0) {  // column j + 1: the next pivot's
        nxt[i] = v1[0];
        if (two) nxt[i2] = v2[0];
      }
    }
    __syncthreads();
  }
  // the full system's timing pivots: sweeps of the timing, GW and rhs
  // block, which leave -(A_j^-1)[:p, :p] in the timing block and the
  // solved right-hand sides in its rows
  if (full) {
    for (int j = kpl; j < nA; ++j) {
      const double* col = cols + (j & 1) * n1;
      const double d = col[j];
      ok = ok && d > 0.0;
      sweep_step<kS>(M, ld, n1, kpl, j, col, cols + ((j + 1) & 1) * n1,
                     1.0 / d, lane, warp);
      __syncthreads();
    }
  }

  // the outputs: NaN throughout where a pivot was not positive
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const int gw = nA, rb = n1 - 1;
  double* Ko = (full ? K : nK) + member * k * k;
  double* go = (full ? g : ng) + member * k;
  for (int e = tid; e < k * k; e += kThreads) {
    const int r = e / k, c = e - r * k;
    const int hi = r > c ? r : c, lo = r > c ? c : r;
    Ko[e] = ok ? M[(gw + hi) * ld + gw + lo] : nan;
  }
  for (int e = tid; e < k; e += kThreads) go[e] = ok ? M[rb * ld + gw + e] : nan;
  if (full) {
    for (int e = tid; e < p * k; e += kThreads) {
      const int r = e / k, c = e - r * k;
      Yp[member * p * k + e] = ok ? M[(gw + c) * ld + kpl + r] : nan;
    }
    for (int e = tid; e < p; e += kThreads) {
      zp[member * p + e] = ok ? M[rb * ld + kpl + e] : nan;
      a[member * p + e] = ok ? -M[(kpl + e) * ld + kpl + e] : nan;
    }
  } else if (tid == 0) {
    ncz[member] = ok ? -M[rb * ld + rb] : nan;
  }
}

// The build for bordered order n1.
inline const void* build_for(int n1) {
  return n1 <= 32 * kNarrowSlots ? (const void*)pta_block_elim<kNarrowSlots>
                                 : (const void*)pta_block_elim<kSlots>;
}

constexpr int kMaxDevices = 64;
std::once_flag g_shared_once[kMaxDevices];
cudaError_t g_shared_err[kMaxDevices];

cudaError_t allow_shared() {
  for (const void* fn : {(const void*)pta_block_elim<kNarrowSlots>,
                         (const void*)pta_block_elim<kSlots>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxShared);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The attribute is set once per device, before any capture (the first
// launch is eager), never inside one.
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

// S: (groups, q, q) f64 on the card, member stride s_member, row stride
// s_row, unit column stride; rhs: (groups, q), member stride r_member.
// systems = 2 launches the full and the noise-only system of every
// member (kpl > 0), 1 the full system alone. Outputs, contiguous:
// Yp (groups, p, k), zp and a (groups, p), K (groups, k, k), g (groups,
// k); with systems = 2 also nK (groups, k, k), ng (groups, k) and ncz
// (groups). Launches on `stream` (a cudaStream_t passed as a pointer)
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int pta_block_elim_launch(const double* S, long long s_member,
                                     long long s_row, const double* rhs,
                                     long long r_member, int groups, int q,
                                     int p, int k, int systems, double* Yp,
                                     double* zp, double* a, double* K,
                                     double* g, double* nK, double* ng,
                                     double* ncz, int device, void* stream) {
  const int m = q - k, kpl = m - p;
  if (groups < 1 || p < 0 || k < 0 || kpl < 0 ||
      m < 1 || (systems != 1 && systems != 2) || (systems == 2 && kpl < 1) ||
      !fits(q + 1))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = allow_shared_once(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(groups, systems);
  const size_t bytes = shared_bytes(q + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q + 1 <= 32 * kNarrowSlots)
    pta_block_elim<kNarrowSlots><<<grid, kThreads, bytes, s>>>(
        S, s_member, s_row, rhs, r_member, q, p, k, Yp, zp, a, K, g, nK, ng,
        ncz);
  else
    pta_block_elim<kSlots><<<grid, kThreads, bytes, s>>>(
        S, s_member, s_row, rhs, r_member, q, p, k, Yp, zp, a, K, g, nK, ng,
        ncz);
  return (int)cudaGetLastError();
}

// What the kernel runs with on `device` at bordered order n1: out[0..4] =
// threads per block, registers per thread, local (spill) bytes per
// thread, dynamic shared bytes per block, resident blocks per SM.
extern "C" int pta_block_elim_build_info(int n1, int device, int* out) {
  if (!fits(n1)) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = allow_shared_once(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = build_for(n1);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      shared_bytes(n1));
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shared_bytes(n1);
  out[4] = blocks;
  return 0;
}
