#!/usr/bin/env python3
"""Drive pint_tpu_torch's main path on one NVIDIA card and check its kernel.

Usage (from the root of a checkout, on a host with one CUDA card):

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build every kernel of the path from its source (``nvcc``, ``sm_90a``);
3. ``dd.self_check`` on the card must pass: the DD phase runs there;
4. each kernel against its plain PyTorch version on the card at the main
   path's shapes, at an odd row count that pads and at two column tiles,
   and against float64 within 10x its error bound, with its time (CUDA
   events around one call, and each pass's device time), the plain
   version's, its bound and a library call's;
5. the main path: 100,000 barycentric TOAs in 4-TOA ECORR epochs,
   simulated from the bench par (without astrometry) on the card, then
   the damped GLS fit (``HybridGLSFitter(...).fit_toas(maxiter=10)``) —
   every kernel's launch count is set to 0 just before and read just
   after, and each must have launched; then the same fit with an exact
   float64 Gram as a witness of where the damped loop stops, the warm
   step's times and a torch.profiler trace of one warm step (the
   device's idle share and the kernels that take the time);
6. the same fit at 2,000 TOAs on the card and on the CPU (plain versions)
   must agree;
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs no network, and exits non-zero with no result when CUDA is
missing or the package is not beside it.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# The bench par (bench.py PAR) for barycentric TOAs: no RAJ/DECJ/POSEPOCH/
# EPHEM, TZRSITE @.
PAR_BARY = """
PSRJ           J1748-2021E
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
DM              223.9  1
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE @
EFAC 1.1
ECORR 1.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""
N_TOAS = 100_000
N_SMALL = 2_000
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
F32_FLOPS = 67e12     # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
# |kernel - plain version| / max|G|. The plain version adds in the
# kernel's chunk and block order, so the two agree bit for bit; a kernel
# that dropped the a1ᵀa2 + a2ᵀa1 correction would miss by ~1e-10 on
# these inputs. (The CPU tests hold the plain version to the TPU kernel,
# whose order differs, at 1e-6.)
PLAIN_BAR = 1e-12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def epoch_mjds(n, rng):
    """n MJDs in 4-TOA epochs within 0.5 s, MJD 50000-58000 (the bench's)."""
    n_ep = max(1, (n + 3) // 4)
    centers = np.sort(rng.uniform(50000.0, 58000.0, size=n_ep))
    return (centers[:, None]
            + rng.uniform(0, 0.5 / 86400.0, (n_ep, 4))).ravel()[:n]


def simulate(model, n, seed, device):
    """The bench's traffic: n TOAs in 4-TOA epochs at 1400/430 MHz, 1 us."""
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    return make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), model,
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs="@", add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=device)


def median_ms(fn, reps=20, warm=3):
    """Median device time of fn() over reps launches (CUDA events, warm)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps=7):
    """Median host wall time of fn() ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_fit(model, toas):
    """Construct the fitter on the card and run the damped fit, counting
    its calls. Returns (fitter, chi2, construction s, fit_toas s, full
    steps, probes)."""
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = HybridGLSFitter(toas, model)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    calls = {"step": 0, "probe": 0}
    step, probe = fitter._iterate, fitter._chi2_at

    def counted_step(base, deltas):
        calls["step"] += 1
        return step(base, deltas)

    def counted_probe(base, deltas):
        calls["probe"] += 1
        return probe(base, deltas)

    fitter._iterate, fitter._chi2_at = counted_step, counted_probe
    chi2 = fitter.fit_toas(maxiter=10)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fitter._iterate, fitter._chi2_at = step, probe
    return fitter, chi2, t1 - t0, t2 - t1, calls["step"], calls["probe"]


def profile_step(fitter, base, deltas, step_ms):
    """torch.profiler over one warm full step: the kernels that take the
    time, and the device's idle share of the unprofiled step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    float(fitter._iterate(base, deltas)[1]["chi2_at_input"])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(fitter._iterate(base, deltas)[1]["chi2_at_input"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms == 0.0:
        print("profile: the trace holds no device time (not measured)")
        return
    print(f"profile of one full step: wall {wall_ms:.2f} ms profiled, "
          f"{step_ms:.2f} ms not; device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / step_ms:.3f} of the unprofiled step, "
          f"{sum(c for _, c in by_name.values())} kernel launches")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}")


def kernel_name(text: str) -> str:
    """The first ds32_gram kernel named in `text` (a mangled symbol), as
    partials<64>, partials<128> or reduce."""
    m = re.search(r"ds32_gram_(partials|reduce)(?:ILi(\d+)E)?", text)
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def whitened(n, q, seed, device):
    """(n, q) f64 with unit columns, as gls_gram_whitened feeds the Gram."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((n, q), generator=g, dtype=torch.float64, device=device)
    return (A / torch.linalg.norm(A, dim=0)).contiguous()


def device_ms(fn, calls=20):
    """Device time per call of fn, by kernel name, from a torch.profiler
    trace of `calls` warm calls ({} where the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_gram(gram, dev):
    """ds32_gram against its plain version and f64 at the main path's
    shapes (timed), at an odd row count that pads and at q = 100, two
    column tiles (checked, and their passes timed).

    Times: `ms`, `library_ms` and `plain_ms` are CUDA events around one
    call on an idle card, so they include the launches' host latency;
    `device_ms` (`partials_ms` + `reduce_ms`) and `library_device_ms` are
    device time per call (torch.profiler, every kernel the call
    launches)."""
    shapes = []
    # G_BB: every TOA x (offset, DM, F0, F1, 60 Fourier columns); the
    # ECORR Schur term: one row per 4-TOA epoch; 137 rows pad the block
    # and its last 32-row chunk; 3,001 x 100 takes the off-diagonal
    # tile path and an odd row count
    for label, n, q in (("G_BB", N_TOAS, 64), ("Schur", N_TOAS // 4, 64),
                        ("padding", 137, 64), ("two tiles", 3001, 100)):
        A = whitened(n, q, seed=n, device=dev)
        bn, nb = gram._block_rows(n)
        before = gram.ds32_gram.launches
        G = gram.ds32_gram(A)
        torch.cuda.synchronize()
        if gram.ds32_gram.launches != before + 1:
            fail(f"ds32_gram counted {gram.ds32_gram.launches - before} "
                 f"launches for one call at {label}")
        G_plain = gram.ds32_gram_reference(A)
        G64 = A.T @ A
        scale = float(torch.max(torch.abs(G64)))
        err_plain = float(torch.max(torch.abs(G - G_plain)))
        err_f64 = float(torch.max(torch.abs(G - G64)))
        bound = gram.gram_error_bound(n)
        print(f"  {label} {n}x{q}: bn {bn}, nb {nb}; |kernel-plain|/max|G| = "
              f"{err_plain / scale:.3e} (bar {PLAIN_BAR:g}), |kernel-f64|/max|G|"
              f" = {err_f64 / scale:.3e} (bar {10 * bound:.3e})", flush=True)
        if not (err_plain <= PLAIN_BAR * scale and err_f64 < 10 * bound * scale):
            fail(f"ds32_gram disagrees at {label} {n}x{q}")
        if not torch.isfinite(G).all():
            fail(f"ds32_gram gave non-finite values at {label}")
        if not torch.equal(G, gram.ds32_gram(A)):
            fail(f"ds32_gram is not deterministic at {label}")
        by_name = device_ms(lambda: gram.ds32_gram(A))
        passes = {key: sum(ms for name, ms in by_name.items() if kernel in name)
                  or None
                  for key, kernel in (("partials_ms", "ds32_gram_partials"),
                                      ("reduce_ms", "ds32_gram_reduce"))}
        print(f"  {label}: partials {fmt_ms(passes['partials_ms'])} + reduce "
              f"{fmt_ms(passes['reduce_ms'])} of device time per call "
              f"(torch.profiler, 20 calls)", flush=True)
        if label in ("padding", "two tiles"):
            continue
        # the function's work: the upper triangle of a1ᵀa1 and one a1ᵀa2
        # (a2ᵀa1 is its transpose), 2 flops per FFMA
        flops = 2.0 * n * (q * (q + 1) / 2 + q * q)
        nbytes = 8.0 * (n * q + q * q)   # A read once, G written once
        bound_ms = max(flops / F32_FLOPS, nbytes / HBM_BYTES_S) * 1e3
        shapes.append({
            "shape": label, "n": n, "q": q, "bn": bn, "nb": nb,
            "ms": median_ms(lambda: gram.ds32_gram(A)),
            "device_ms": (None if None in passes.values()
                          else passes["partials_ms"] + passes["reduce_ms"]),
            **passes,
            "plain_ms": median_ms(lambda: gram.ds32_gram_reference(A), reps=5),
            "library_ms": median_ms(lambda: A.T @ A),
            "library_device_ms": sum(device_ms(lambda: A.T @ A).values()) or None,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / F32_FLOPS >= nbytes / HBM_BYTES_S
            else "bytes",
            "max_abs_err": err_plain, "rel_err_vs_f64": err_f64 / scale,
        })
        s = shapes[-1]
        print(f"  {label}: kernel {s['ms']:.4f} ms a call ({fmt_ms(s['device_ms'])}"
              f" device), plain {s['plain_ms']:.4f} ms a call, A.T@A f64 (cuBLAS)"
              f" {s['library_ms']:.4f} ms a call ({fmt_ms(s['library_device_ms'])}"
              f" device), bound {bound_ms:.4f} ms ({s['bound_by']})", flush=True)
    return shapes


def main() -> None:
    if not (ROOT / "pint_tpu_torch" / "ops" / "gram.py").is_file():
        fail("pint_tpu_torch/ is not beside this script: run it from a checkout")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from pint_tpu_torch.fitting import gls_step
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import dd, gram

    t_start = time.perf_counter()
    phase("1 card")
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda")

    phase("2 build")
    t0 = time.perf_counter()
    lib, log = gram.build()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            print(f"  nvcc: {kernel_name(line)}:")
        elif "registers" in line or "spill" in line or "smem" in line:
            print("  nvcc:", line.strip())

    phase("3 dd.self_check on the card")
    ok = dd.self_check(dev)
    print(f"dd.self_check(cuda) = {ok}", flush=True)
    if not ok:
        fail("double-double error-free transforms do not hold on the card")

    phase("4 ds32_gram against its plain version")
    shapes = check_gram(gram, dev)

    phase(f"5 main path: {N_TOAS} TOAs, damped GLS fit")
    model = get_model(PAR_BARY)
    t0 = time.perf_counter()
    toas = simulate(get_model(PAR_BARY), N_TOAS, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"simulated {len(toas)} TOAs on {toas.device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gram.ds32_gram.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fitter, chi2, build_s, fit_s, steps, probes = run_fit(model, toas)
    launches = gram.ds32_gram.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    red = fitter.resids.reduced_chi2
    dof = fitter.resids.dof
    print(f"fit (cold): {build_s + fit_s:.3f} s wall = construction "
          f"{build_s:.3f} s + fit_toas {fit_s:.3f} s; {steps} full steps, "
          f"{probes} probes, converged {fitter.converged}, GLS chi2 {chi2:.6f} "
          f"(chi2/dof {chi2 / dof:.6f}), post-fit residual chi2/dof {red:.6f}, "
          f"peak memory {peak_mb:.1f} MiB", flush=True)
    for k in fitter.fit_params:
        p = model[k]
        print(f"  {k} = {p.format_value()} +- {p.uncertainty:.6g}")
    print(f"ds32_gram launches in the fit: {launches}", flush=True)
    if not (math.isfinite(chi2) and fitter.converged):
        fail(f"fit did not converge to a finite chi2 ({chi2})")
    if not 0.8 <= red <= 1.25:
        fail(f"post-fit reduced chi2 {red} outside [0.8, 1.25]")
    if launches == 0 or launches < 2 * steps:
        fail(f"{launches} ds32_gram launches for {steps} full steps")
    # a second witness of where the damped loop stops: the same fit with
    # an exact f64 Gram in place of the kernel
    gls_step.ds32_gram = lambda A: A.T @ A
    try:
        _, chi2_f64, _, _, steps_f64, probes_f64 = run_fit(get_model(PAR_BARY),
                                                           toas)
    finally:
        gls_step.ds32_gram = gram.ds32_gram
    print(f"fit with an exact f64 Gram (witness): {steps_f64} full steps, "
          f"{probes_f64} probes, GLS chi2 {chi2_f64:.6f}, the kernel's fit "
          f"{chi2 - chi2_f64:+.6f} from it", flush=True)
    if not abs(chi2 - chi2_f64) <= 1e-6 * chi2_f64:
        fail(f"the fit's chi2 {chi2} is not the f64 Gram fit's {chi2_f64}")
    warm, _, wbuild_s, wfit_s, wsteps, wprobes = run_fit(
        get_model(PAR_BARY), toas)
    print(f"fit (warm, same table, fresh model): {wbuild_s + wfit_s:.3f} s wall"
          f" = construction {wbuild_s:.3f} s + fit_toas {wfit_s:.3f} s; "
          f"{wsteps} full steps, {wprobes} probes", flush=True)
    base = model.base_dd(dev)
    deltas = model.zero_deltas(device=dev)
    step_ms = host_ms(lambda: float(warm._iterate(base, deltas)[1]["chi2_at_input"]))
    stage1_ms = host_ms(lambda: warm._stage1(base, deltas, toas))
    probe_ms = host_ms(lambda: warm._chi2_at(base, deltas))
    print(f"one full step (warm): {step_ms:.2f} ms, of which stage 1 "
          f"(DD phase + jacfwd design) {stage1_ms:.2f} ms; one probe "
          f"{probe_ms:.2f} ms", flush=True)

    profile_step(warm, base, deltas, step_ms)

    phase(f"6 the fit on the card agrees with the CPU at {N_SMALL} TOAs")
    small = simulate(get_model(PAR_BARY), N_SMALL, seed=1, device="cpu")
    fits = []
    for d in ("cpu", dev):
        m = get_model(PAR_BARY)
        f = HybridGLSFitter(small, m, device=d)
        fits.append((m, f.fit_toas(maxiter=3), f.converged))
    (m_cpu, c_cpu, v_cpu), (m_gpu, c_gpu, v_gpu) = fits
    worst = max(abs(m_cpu[k].value_f64 - m_gpu[k].value_f64) / m_cpu[k].uncertainty
                for k in m_cpu.free_params)
    print(f"chi2 cpu {c_cpu:.9f} card {c_gpu:.9f}; worst parameter gap "
          f"{worst:.3e} sigma; converged {v_cpu}/{v_gpu}", flush=True)
    if not (v_cpu == v_gpu and abs(c_gpu - c_cpu) <= 1e-6 * abs(c_cpu)
            and worst < 0.05):
        fail("the fit on the card disagrees with the CPU fit")

    phase("7 result")
    per_step = {k: (None if any(s[k] is None for s in shapes)
                    else sum(s[k] for s in shapes))
                for k in ("ms", "device_ms", "plain_ms", "library_ms",
                          "library_device_ms", "bound_ms")}
    kernels = [{
        "name": "ds32_gram", "route": "cuda",
        "source": "pint_tpu_torch/csrc/ds32_gram.cu",
        "replaces": "pint_tpu/ops/pallas_gram.py:47",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        **per_step,
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in shapes) else "bytes"),
        "timing": "per GLS step: G_BB + Schur shapes summed; ms, plain_ms "
                  "and library_ms are CUDA events around one call, device_ms "
                  "and library_device_ms device time (torch.profiler)",
        "shapes": shapes,
    }]
    print("kernels: [ds32_gram: ok, " + ", ".join(
        f"{s['shape']} {s['n']}x{s['q']} {s['ms']:.4f} ms" for s in shapes)
        + f", {launches} launches]")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
