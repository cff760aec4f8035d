// Stage 1 of the GLS fit of an isolated pulsar, in one pass over the
// TOAs. CUDA C++ for sm_90a (H100), built with -fmad=false
// (ops/stage1.py::NVCC_FLAGS) so that no multiply is contracted into a
// following add: the double-double (DD) transforms stay exact, and every
// float64 operation rounds as the eager PyTorch components round on the
// card (a quotient by a Python number is a product with its reciprocal
// there; a sum over three coordinates adds the first and the third, then
// the second), so that the residuals and the design are the jacfwd
// route's bit for bit.
//
// Replaces no TPU kernel: the JAX package runs stage 1 as jitted XLA
// (pint_tpu/fitting/hybrid.py, jax.jacfwd over the DD phase pipeline,
// on the CPU). On the card the route before this kernel was
// fitting/hybrid.py::make_whiten_stage1's torch.func.jacfwd over the
// op-by-op DD pipeline: ~3,900 elementwise launches per evaluation of
// a stacked group, each streaming its operands through device memory.
//
// What it computes, per member g (a stacked group's member axis) and
// TOA i (ops/stage1.py::stage1_reference is the same arithmetic in
// PyTorch operators):
//   1. the parameters: base (+) delta in DD, a free one's delta seeding
//      its unit tangent;
//   2. the delays, in the components' order and formulas: Roemer with
//      proper motion and parallax (models/astrometry.py, equatorial),
//      the Sun's Shapiro delay (models/solar_system_shapiro.py), the DM
//      Taylor series over f^2 (models/dispersion.py::DispersionDM);
//   3. dt = (TDB - PEPOCH) 86400 - delay in DD, the spin phase by Horner
//      in DD over F_k / (k+1)! (models/spindown.py), PHOFF
//      (models/phase_offset.py), less the member's TZR anchor (one row,
//      computed in the same launch by an extra warp of each block);
//   4. beside every value, its forward tangents with respect to the free
//      parameters (Dv below), each operation's by torch's forward-mode
//      formula: the design column of a parameter is the tangent of
//      int + (hi + lo), jacfwd's;
//   5. the rows of stage 1's whitened design before its unit norms: the
//      columns [1 / F0 (the offset), -J / F0] times sw = sqrt(1 /
//      sigma^2); and the residual in turns.
// fitting/hybrid.py::make_whiten_stage1 finishes them in PyTorch
// operators, the jacfwd route's own (the weighted mean, the division by
// F0, the unit column norms): its sums over the TOAs are torch's, which
// a damped fit's step needs to the last bit (the order of a sum moves a
// 100,000-TOA step from a 1,000-sigma start by ~1e-8 sigma).
//
// What bounds it on the card: bytes. Per TOA it reads 80 B (TDB as DD,
// the observatory's and the Sun's positions, the frequency, sw) and
// writes 8 (q + 1) B (the columns and the residual): 136 B at q = 6, 82
// MB at pta68's 600,032 TOAs, 24 us at 3.35 TB/s. The arithmetic is a
// few thousand float64 operations per TOA (the DD Horner and its
// tangents, 5 sin/cos, a log). What the design does about that:
//   * every intermediate lives in registers: one thread per TOA carries
//     the phase and its tangents (P <= 8 per value, a template parameter)
//     from the inputs to the written row;
//   * the parameters are resolved once per block, into shared memory,
//     with the spin coefficients F_k / (k+1)! (a DD division each); every
//     row reads them as broadcasts;
//   * the TZR anchor is a ninth warp of each block, so it runs beside
//     the rows and not before them.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;             // row threads of a rows block
constexpr int kThreads = kRows + 32;   // and the anchor's warp
constexpr int kMaxFree = 8;
constexpr int kMaxSpin = 16;
constexpr int kMaxDm = 8;
constexpr int kAstro = 6;              // RAJ DECJ PMRA PMDEC PX POSEPOCH
constexpr int kMaxPar = kAstro + (kMaxDm + 1) + (kMaxSpin + 1) + 1;

// Row inputs: 0 tdb.hi, 1 tdb.lo, 2 observatory (n, 3) light-seconds,
// 3 the Sun relative to the observatory (n, 3), 4 frequency [MHz],
// 5 sw = 1 / sigma [1/s]; the anchor has the first five.
constexpr int kRowIn = 6;
constexpr int kTzrIn = 5;

struct Args {
  const double* tab_hi;
  const double* tab_lo;
  const double* delta;
  const double* row[kRowIn];
  const double* tz[kTzrIn];
  double* Mw;     // (G, n, q)
  double* resid;  // (G, n)
  long long s_tab, s_delta;
  long long s_row[kRowIn], r_row[kRowIn];  // member and row strides
  long long s_tz[kTzrIn];
  int G, n, nb, p, q, npar;
  int astro, shapiro, nd, nf, phoff, tzr, offset;
  int off_dm, off_spin, off_phoff;  // the table's blocks (astrometry at 0)
  int slot[kMaxFree];               // each free parameter's table column
  // the constants, and the reciprocals torch's CUDA quotients multiply by
  double t_sun, dm_const, rad_per_mas, day_s, inv_au, inv_year;
};

// ---------------------------------------------------------------------
// values with forward tangents
// ---------------------------------------------------------------------

// A value of the phase and its forward tangents, one per free parameter
// (zero where none moves it). Every operation combines them by torch's
// forward-mode formula (torchgen's derivatives.yaml), in the order it
// evaluates, so the tangents are torch.func.jacfwd's bit for bit: a
// term torch leaves out for an undefined tangent is here an exact zero.
template <int P>
struct Dv {
  double p;
  double t[P];
};

template <int P>
__device__ __forceinline__ Dv<P> cst(double x) {
  Dv<P> r;
  r.p = x;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = 0.0;
  return r;
}

// a + b, a - b: self_t + other_t, self_t - other_t
template <int P>
__device__ __forceinline__ Dv<P> add(const Dv<P>& a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a.p + b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] + b.t[j];
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> sub(const Dv<P>& a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a.p - b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] - b.t[j];
  return r;
}

// a value less a tangent-free tensor b, and the reverse (-other_t)
template <int P>
__device__ __forceinline__ Dv<P> sub(const Dv<P>& a, double b) {
  Dv<P> r = a;
  r.p = a.p - b;
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> sub(double a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a - b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = -b.t[j];
  return r;
}

// a * b: other_t * self_p + self_t * other_p
template <int P>
__device__ __forceinline__ Dv<P> mul(const Dv<P>& a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a.p * b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = b.t[j] * a.p + a.t[j] * b.p;
  return r;
}

// times a tangent-free factor b (a tensor or a Python number): self_t * b
template <int P>
__device__ __forceinline__ Dv<P> mul(const Dv<P>& a, double b) {
  Dv<P> r;
  r.p = a.p * b;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] * b;
  return r;
}

// a tangent-free tensor a times b: other_t * self_p
template <int P>
__device__ __forceinline__ Dv<P> mul(double a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a * b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = b.t[j] * a;
  return r;
}

// a / b of two tensors: (self_t - other_t * result) / other_p
template <int P>
__device__ __forceinline__ Dv<P> div(const Dv<P>& a, const Dv<P>& b) {
  Dv<P> r;
  r.p = a.p / b.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = (a.t[j] - b.t[j] * r.p) / b.p;
  return r;
}

// a / b, b a tangent-free tensor: self_t / other_p
template <int P>
__device__ __forceinline__ Dv<P> div(const Dv<P>& a, double b) {
  Dv<P> r;
  r.p = a.p / b;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] / b;
  return r;
}

// a / c for a Python number c, as the card runs it: a product with the
// reciprocal inv = 1 / c, the value's and the tangent's
template <int P>
__device__ __forceinline__ Dv<P> div_number(const Dv<P>& a, double inv) {
  return mul(a, inv);
}

template <int P>
__device__ __forceinline__ Dv<P> neg(const Dv<P>& a) {
  Dv<P> r;
  r.p = -a.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = -a.t[j];
  return r;
}

// cos: self_t * -sin(self_p); sin: self_t * cos(self_p); log: self_t /
// self_p; a ** 2: self_t * (2 * self_p); round: a zero tangent
template <int P>
__device__ __forceinline__ Dv<P> cos_(const Dv<P>& a) {
  const double ms = -sin(a.p);
  Dv<P> r;
  r.p = cos(a.p);
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] * ms;
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> sin_(const Dv<P>& a) {
  const double c = cos(a.p);
  Dv<P> r;
  r.p = sin(a.p);
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] * c;
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> log_(const Dv<P>& a) {
  Dv<P> r;
  r.p = log(a.p);
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] / a.p;
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> square(const Dv<P>& a) {
  const double two = 2.0 * a.p;
  Dv<P> r;
  r.p = a.p * a.p;
#pragma unroll
  for (int j = 0; j < P; ++j) r.t[j] = a.t[j] * two;
  return r;
}

template <int P>
__device__ __forceinline__ Dv<P> round_(const Dv<P>& a) {
  return cst<P>(rint(a.p));
}

// torch.sum over three coordinates on the card: two threads share the
// terms, one adding the first and the third, and the second joins
template <int P>
__device__ __forceinline__ Dv<P> sum3(const Dv<P>& x, const Dv<P>& y,
                                      const Dv<P>& z) {
  return add(add(x, z), y);
}

__device__ __forceinline__ double sum3(double x, double y, double z) {
  return (x + z) + y;
}

// the plain float64 forms, for the probes of dd.self_check
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }

// ---------------------------------------------------------------------
// double-double arithmetic (ops/dd.py, operation for operation)
// ---------------------------------------------------------------------

constexpr double kSplitter = 134217729.0;  // Dekker's 2^27 + 1

template <class T>
struct DDT {
  T hi, lo;
};

template <class T>
__device__ __forceinline__ DDT<T> two_sum(const T& a, const T& b) {
  const T s = add(a, b);
  const T bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

template <class T>
__device__ __forceinline__ DDT<T> quick_two_sum(const T& a, const T& b) {
  const T s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

template <class T>
__device__ __forceinline__ DDT<T> split(const T& a) {
  const T t = mul(a, kSplitter);
  const T hi = sub(t, sub(t, a));
  return {hi, sub(a, hi)};
}

// Dekker's TwoProd, its split included (the tangents of its error term
// follow the split's operations)
template <class T>
__device__ __forceinline__ DDT<T> two_prod(const T& a, const T& b) {
  const T p = mul(a, b);
  const DDT<T> as = split(a), bs = split(b);
  const T err = add(add(add(sub(mul(as.hi, bs.hi), p), mul(as.hi, bs.lo)),
                        mul(as.lo, bs.hi)),
                    mul(as.lo, bs.lo));
  return {p, err};
}

template <class T>
__device__ __forceinline__ DDT<T> dd_add(const DDT<T>& x, const DDT<T>& y) {
  DDT<T> s = two_sum(x.hi, y.hi);
  const DDT<T> t = two_sum(x.lo, y.lo);
  s = quick_two_sum(s.hi, add(s.lo, t.hi));
  return quick_two_sum(s.hi, add(s.lo, t.lo));
}

template <class T>
__device__ __forceinline__ DDT<T> dd_sub(const DDT<T>& x, const DDT<T>& y) {
  return dd_add(x, {neg(y.hi), neg(y.lo)});
}

template <class T>
__device__ __forceinline__ DDT<T> dd_mul(const DDT<T>& x, const DDT<T>& y) {
  const DDT<T> p = two_prod(x.hi, y.hi);
  return quick_two_sum(p.hi,
                       add(p.lo, add(mul(x.hi, y.lo), mul(x.lo, y.hi))));
}

// ops/dd.py::div of a DD by the Python float c, as it runs on the card:
// each quotient by c is a product with inv = 1 / c
template <int P>
__device__ __forceinline__ DDT<Dv<P>> dd_div_number(const DDT<Dv<P>>& x,
                                                    double c) {
  const double inv = 1.0 / c;
  const DDT<Dv<P>> y = {cst<P>(c), cst<P>(0.0)};
  const Dv<P> q1 = div_number(x.hi, inv);
  DDT<Dv<P>> r = dd_sub(x, dd_mul(y, {q1, cst<P>(0.0)}));
  const Dv<P> q2 = div_number(r.hi, inv);
  r = dd_sub(r, dd_mul(y, {q2, cst<P>(0.0)}));
  const Dv<P> q3 = div_number(r.hi, inv);
  const DDT<Dv<P>> q = quick_two_sum(q1, q2);
  return quick_two_sum(q.hi, add(q.lo, q3));
}

// A pulse phase: the integer part and the fractional DD in [-0.5, 0.5]
// (ops/phase.py).
template <int P>
struct Phase {
  Dv<P> n;
  DDT<Dv<P>> f;
};

// ops/dd.py::split_int_frac (rint rounds half to even, as torch.round
// does)
template <int P>
__device__ __forceinline__ Phase<P> from_dd(const DDT<Dv<P>>& x) {
  Dv<P> r = round_(x.hi);
  r = add(r, round_(add(sub(x.hi, r), x.lo)));
  const Dv<P> rem = add(sub(x.hi, r), x.lo);
  Dv<P> n = r;
  n.p = (r.p + (rem.p > 0.5 ? 1.0 : 0.0)) - (rem.p < -0.5 ? 1.0 : 0.0);
  return {n, dd_add<Dv<P>>({sub(x.hi, n), cst<P>(0.0)},
                           {x.lo, cst<P>(0.0)})};
}

template <int P>
__device__ __forceinline__ Phase<P> phase_add(const Phase<P>& a,
                                              const Phase<P>& b) {
  const Phase<P> k = from_dd(dd_add(a.f, b.f));
  return {add(add(a.n, b.n), k.n), k.f};
}

__device__ __forceinline__ double factorial(int k) {
  double f = 1.0;
  for (int i = 2; i <= k; ++i) f *= (double)i;
  return f;
}

// The block's resolved parameters (base (+) delta, a free one's delta
// seeding its unit tangent) and the spin coefficients F_k / (k+1)!.
template <int P>
struct Par {
  DDT<Dv<P>> v[kMaxPar];
  DDT<Dv<P>> c[kMaxSpin];
};

template <int P>
__device__ __forceinline__ Dv<P> f64(const Par<P>& par, int k) {
  return add(par.v[k].hi, par.v[k].lo);
}

// One row's phase with its tangents: the components' operations in their
// order (models/astrometry.py, solar_system_shapiro.py, dispersion.py,
// spindown.py, phase_offset.py and TimingModel._phase_at). `o` and `s`
// are the observatory's and the Sun's positions, `with_phoff` applies
// PHOFF (not at the anchor, as TimingModel.phase_fn_toas skips it there).
template <int P>
__device__ __forceinline__ Phase<P> row_phase(const Args& a,
                                              const Par<P>& par, double thi,
                                              double tlo, const double* o,
                                              const double* s, double freq,
                                              bool with_phoff) {
  const double t = thi + tlo;
  Dv<P> delay = cst<P>(0.0);
  Dv<P> lx, ly, lz;
  if (a.astro) {
    const double pe = par.v[5].hi.p + par.v[5].lo.p;  // POSEPOCH: no tangent
    const double dt_yr = (t - pe) * a.inv_year;
    const double m2r = a.rad_per_mas;
    const Dv<P> ra0 = f64(par, 0), dec0 = f64(par, 1);
    const Dv<P> dec = add(dec0, mul(mul(f64(par, 3), dt_yr), m2r));
    const Dv<P> ra =
        add(ra0, div(mul(mul(f64(par, 2), dt_yr), m2r), cos_(dec0)));
    const Dv<P> cd = cos_(dec);
    lx = mul(cd, cos_(ra));
    ly = mul(cd, sin_(ra));
    lz = sin_(dec);
    const Dv<P> rdl = sum3(mul(o[0], lx), mul(o[1], ly), mul(o[2], lz));
    const Dv<P> px_rad = mul(f64(par, 4), m2r);
    const double r2 = sum3(o[0] * o[0], o[1] * o[1], o[2] * o[2]);
    const Dv<P> half_px = mul(div_number(px_rad, a.inv_au), 0.5);
    delay = add(delay, add(neg(rdl), mul(half_px, sub(r2, square(rdl)))));
    if (a.shapiro) {
      const double r = sqrt(sum3(s[0] * s[0], s[1] * s[1], s[2] * s[2]));
      const Dv<P> rc = sum3(mul(s[0], lx), mul(s[1], ly), mul(s[2], lz));
      delay = add(delay, mul(log_(div_number(sub(r, rc), a.inv_au)),
                             -2.0 * a.t_sun));
    }
  }
  if (a.nd > 0) {
    const double de = par.v[a.off_dm].hi.p + par.v[a.off_dm].lo.p;
    const double dt_dm = (t - de) * a.inv_year;
    Dv<P> dm = cst<P>(0.0);
    for (int k = a.nd - 1; k >= 0; --k)
      dm = add(mul(dm, dt_dm), div_number(f64(par, a.off_dm + 1 + k),
                                          1.0 / factorial(k)));
    delay = add(delay, div(mul(dm, a.dm_const), freq * freq));
  }
  // dt = (TDB - PEPOCH) 86400 - delay, the Horner phase in DD
  const int sp = a.off_spin;
  DDT<Dv<P>> dt = dd_mul(dd_sub<Dv<P>>({cst<P>(thi), cst<P>(tlo)}, par.v[sp]),
                         {cst<P>(a.day_s), cst<P>(0.0)});
  dt = dd_sub(dt, {delay, cst<P>(0.0)});
  DDT<Dv<P>> acc = par.c[a.nf - 1];
  for (int k = a.nf - 2; k >= 0; --k) acc = dd_add(dd_mul(acc, dt), par.c[k]);
  const Dv<P> zero = cst<P>(0.0);
  Phase<P> ph = phase_add<P>({zero, {zero, zero}}, from_dd(dd_mul(acc, dt)));
  if (with_phoff && a.phoff) {
    const Dv<P> off = mul(neg(f64(par, a.off_phoff)), 1.0);
    ph = phase_add(ph, from_dd<P>({off, zero}));
  }
  return ph;
}

__device__ __forceinline__ const double* at(const double* base, long long m,
                                            long long r, int g, int i) {
  return base + g * m + i * r;
}

// The rows pass: blocks (row block, member) of kRows row threads and
// the anchor's warp.
template <int P>
__global__ void __launch_bounds__(kThreads)
    stage1_rows(const __grid_constant__ Args a) {
  __shared__ Par<P> par;
  __shared__ Phase<P> anchor;
  const int g = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * kRows + tid;
  if (tid < a.npar) {
    DDT<Dv<P>> v = {cst<P>(a.tab_hi[g * a.s_tab + tid]),
                    cst<P>(a.tab_lo[g * a.s_tab + tid])};
    for (int j = 0; j < a.p; ++j) {
      if (a.slot[j] == tid) {
        Dv<P> d = cst<P>(a.delta[g * a.s_delta + j]);
#pragma unroll
        for (int k = 0; k < P; ++k) d.t[k] = k == j ? 1.0 : 0.0;
        v = dd_add<Dv<P>>(v, {d, cst<P>(0.0)});
      }
    }
    par.v[tid] = v;
  }
  __syncthreads();
  if (tid < a.nf) {
    const DDT<Dv<P>> F = par.v[a.off_spin + 1 + tid];
    const double fact = factorial(tid + 1);
    par.c[tid] = fact != 1.0 ? dd_div_number(F, fact) : F;
  }
  __syncthreads();
  Phase<P> ph;
  const bool row = tid < kRows && i < a.n;
  if (tid >= kRows) {
    if (a.tzr) {
      ph = row_phase<P>(a, par, a.tz[0][g * a.s_tz[0]], a.tz[1][g * a.s_tz[1]],
                        a.tz[2] + g * a.s_tz[2], a.tz[3] + g * a.s_tz[3],
                        a.tz[4][g * a.s_tz[4]], false);
      if (tid == kRows) anchor = ph;
    }
  } else if (row) {
    ph = row_phase<P>(a, par, *at(a.row[0], a.s_row[0], a.r_row[0], g, i),
                      *at(a.row[1], a.s_row[1], a.r_row[1], g, i),
                      at(a.row[2], a.s_row[2], a.r_row[2], g, i),
                      at(a.row[3], a.s_row[3], a.r_row[3], g, i),
                      *at(a.row[4], a.s_row[4], a.r_row[4], g, i), true);
  }
  __syncthreads();
  if (!row) return;
  if (a.tzr) {
    const Phase<P> na = {neg(anchor.n), {neg(anchor.f.hi), neg(anchor.f.lo)}};
    ph = phase_add(ph, na);
  }
  // the residual, and the design's tangents: those of int + (hi + lo)
  const long long r = (long long)g * a.n + i;
  a.resid[r] = ph.f.hi.p + ph.f.lo.p;
  const double sw = *at(a.row[5], a.s_row[5], a.r_row[5], g, i);
  const double f0 = a.tab_hi[g * a.s_tab + a.off_spin + 1] +
                    a.tab_lo[g * a.s_tab + a.off_spin + 1];
  double* Mr = a.Mw + r * a.q;
  if (a.offset) Mr[0] = (1.0 / f0) * sw;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < a.p) {
      const double J = ph.n.t[j] + (ph.f.hi.t[j] + ph.f.lo.t[j]);
      Mr[a.offset + j] = (-J / f0) * sw;
    }
  }
}

// dd.self_check's probes with this file's transforms: TwoSum and
// TwoProd of (a, b 1e6), and the DD product (h, low) x (s_hi, s_lo).
__global__ void stage1_dd_probe(const double* a, const double* b,
                                const double* h, const double* low, int n,
                                double s_hi, double s_lo, double* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const DDT<double> s = two_sum(a[i], b[i]);
  const DDT<double> p = two_prod(a[i], b[i] * 1e6);
  const DDT<double> m = dd_mul<double>({h[i], low[i]}, {s_hi, s_lo});
  const double vals[6] = {s.hi, s.lo, p.hi, p.lo, m.hi, m.lo};
  for (int k = 0; k < 6; ++k) out[k * n + i] = vals[k];
}

// The builds of the rows pass, by the most free parameters they carry
// tangents for.
constexpr int kBuilds = 4;

const void* kernel_for(int which) {
  switch (which) {
    case 0:
      return (const void*)stage1_rows<2>;
    case 1:
      return (const void*)stage1_rows<4>;
    case 2:
      return (const void*)stage1_rows<6>;
    default:
      return (const void*)stage1_rows<8>;
  }
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

// One stacked group's stage-1 rows on `stream`. ptrs (16): tab_hi,
// tab_lo, delta, the six row inputs, the five anchor inputs, Mw, resid.
// strides (19): s_tab, s_delta, the row inputs' member strides, their
// row strides, the anchor inputs' member strides. ints (24): G, n, nb, p,
// q, npar, astro, shapiro, nd, nf, phoff, tzr, offset, off_dm, off_spin,
// off_phoff, slot[8]. consts (6): t_sun, dm_const, rad_per_mas, day_s,
// 1 / au, 1 / year. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a layout the kernel does not take.
extern "C" int stage1_fused_launch(const long long* ptrs,
                                   const long long* strides, const int* ints,
                                   const double* consts, int device,
                                   void* stream) {
  Args a;
  a.tab_hi = (const double*)ptrs[0];
  a.tab_lo = (const double*)ptrs[1];
  a.delta = (const double*)ptrs[2];
  for (int k = 0; k < kRowIn; ++k) a.row[k] = (const double*)ptrs[3 + k];
  for (int k = 0; k < kTzrIn; ++k) a.tz[k] = (const double*)ptrs[9 + k];
  a.Mw = (double*)ptrs[14];
  a.resid = (double*)ptrs[15];
  a.s_tab = strides[0];
  a.s_delta = strides[1];
  for (int k = 0; k < kRowIn; ++k) {
    a.s_row[k] = strides[2 + k];
    a.r_row[k] = strides[8 + k];
  }
  for (int k = 0; k < kTzrIn; ++k) a.s_tz[k] = strides[14 + k];
  int* fields[] = {&a.G,     &a.n,       &a.nb,  &a.p,      &a.q,
                   &a.npar,  &a.astro,   &a.shapiro, &a.nd, &a.nf,
                   &a.phoff, &a.tzr,     &a.offset, &a.off_dm,
                   &a.off_spin, &a.off_phoff};
  for (int k = 0; k < 16; ++k) *fields[k] = ints[k];
  for (int j = 0; j < kMaxFree; ++j) a.slot[j] = ints[16 + j];
  a.t_sun = consts[0];
  a.dm_const = consts[1];
  a.rad_per_mas = consts[2];
  a.day_s = consts[3];
  a.inv_au = consts[4];
  a.inv_year = consts[5];
  if (a.G < 1 || a.G > 65535 || a.n < 1 || a.p < 0 || a.p > kMaxFree ||
      a.q != a.p + a.offset || a.q < 1 || a.nf < 1 || a.nf > kMaxSpin ||
      a.nd < 0 || a.nd > kMaxDm || a.npar > kMaxPar ||
      a.nb != (a.n + kRows - 1) / kRows || (a.shapiro && !a.astro))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const dim3 grid(a.nb, a.G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.p <= 2)
    stage1_rows<2><<<grid, kThreads, 0, s>>>(a);
  else if (a.p <= 4)
    stage1_rows<4><<<grid, kThreads, 0, s>>>(a);
  else if (a.p <= 6)
    stage1_rows<6><<<grid, kThreads, 0, s>>>(a);
  else
    stage1_rows<8><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int stage1_dd_probe_launch(const double* a, const double* b,
                                      const double* h, const double* low,
                                      int n, double s_hi, double s_lo,
                                      double* out, int device, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  stage1_dd_probe<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, h, low, n,
                                                         s_hi, s_lo, out);
  return (int)cudaGetLastError();
}

// What build `which` (0-3: the rows pass with 2, 4, 6 or 8 tangents) runs
// with on `device`: out[0..4] = threads per block,
// registers per thread, local (spill) bytes per thread, static shared
// bytes per block, resident blocks per SM.
extern "C" int stage1_build_info(int which, int device, int* out) {
  if (which < 0 || which >= kBuilds) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const void* fn = kernel_for(which);
  const int threads = kThreads;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = blocks;
  return 0;
}
