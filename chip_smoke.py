#!/usr/bin/env python3
"""Drive pint_tpu_torch's main path on one NVIDIA card and check its kernel.

Usage (from the root of a checkout, on a host with one CUDA card):

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build every kernel of the path from its source (``nvcc``, ``sm_90a``)
   and print each kernel's threads, registers, spill bytes, dynamic
   shared bytes and resident blocks per SM: every partials build, and
   the block elimination at the joint fit's q = 106, must run at 2 or
   more blocks per SM with no spill;
3. ``dd.self_check`` on the card must pass: the DD phase runs there;
4. each kernel against its plain PyTorch version on the card at the main
   path's shapes (q = 66: the bench par with RAJ/DECJ, the narrow
   build), at the barycentric path's (q = 64), at the binary path's
   (phase 7's q = 341, the pairs build), at the noise path's (phase 11's
   q = 480), at an odd row count that pads, and at 3,001 rows on every
   route of the tiling (q = 63, 65, 67, 68, 69, 100, 127, 128, 129, 200,
   341: both sides of each tile edge), and against float64 within 10x
   its error bound, the same bits on a second call, with its time (CUDA
   events around one call, and each pass's device time), the plain
   version's, its bound and a library call's;
5. the data layer: the same 2,000-row GBT table (clock chain, TDB,
   observatory and planet positions) built on the card and on the CPU
   must agree column by column;
6. the main path: bench.py's par verbatim (RAJ/DECJ fitted, EPHEM DE421
   through the analytic fallback, TZRSITE 1), 100,000 GBT TOAs in 4-TOA
   ECORR epochs simulated on the card, the table build timed, then the
   damped GLS fit (``HybridGLSFitter(...).fit_toas(maxiter=10)``) through
   the fused loop, whose first fit captures a full step and a probe as
   CUDA graphs and replays them — every kernel's launch count is set to
   0 just before and read just after (a replay counts the launches its
   graph recorded), and each must have launched, the stage-1 kernel once
   per full step with one launch recorded in the capture, cold, warm and
   in the host loop; captures, replays, host
   fetches, cold and warm wall and peak memory; then the host loop
   (``PINT_TORCH_DEVICE_LOOP=0``) as a witness (the same trace,
   counters, steps and probes, every full evaluation's chi2 within
   1e-12), the captured fit from a
   kicked start against the host loop from there (nothing stale baked
   in), the same fit with an exact float64 Gram as a witness of where the
   damped loop stops (its own capture), torch.profiler over one warm
   fused fit (whose trace must hold one ds32_gram partials and one reduce
   kernel per launch counted per replay) and one warm host-loop fit (the
   device's idle share of the whole fit), the graph replays' device span (CUDA events), no host
   sync in an eager step or probe
   (``torch.cuda.set_sync_debug_mode("error")``), the eager step's times
   and traces of one step and its stage 1;
7. slice 7's path, after the loop cache is cleared: a J1909-3744-like
   binary MSP (PAR_J1909: ELL1 with Shapiro, 267 fitted 30-day DMX
   windows, FD1/FD2, a receiver JUMP, the solar wind held fixed, EFAC/
   EQUAD/ECORR per receiver, bench.py's red noise), 100,000 GBT TOAs in
   4-TOA epochs at two receivers simulated on the card from that par,
   the table build timed, the hybrid fit through the fused loop (the
   Gram kernel's launch count set to 0 before and read after), cold and
   warm, with the host loop as its witness (the same gates as phase 6),
   every fitted parameter within 5 sigma of the truth, post-fit
   chi2/dof in [0.8, 1.25], peak memory, the warm fits' wall and idle
   share (torch.profiler, whose trace must hold one partials and one
   reduce kernel per counted launch);
8. each new component on the card against the CPU at 2,000 GBT TOAs at
   two receivers: the ten binary models, DMX (disjoint and overlapping
   windows), the solar wind, FD, FDJUMP, JUMP, DelayJump, DMJUMP, PHOFF,
   the troposphere, Glitch (with and without decay), PiecewiseSpindown,
   WAVE, WaveX, DMWaveX, ChromaticCM (a Taylor term, CMX windows),
   CMWaveX and IFunc (SIFUNC 0 and 2), each one's delay (phase, DM)
   within 1e-12 s and its jacfwd columns within 1e-10 of their largest
   entry; the PLDMNoise and PLChromNoise bases and prior variances (as
   the hybrid fitter and the GLS step build them) within 1e-12;
9. the topocentric fit and the barycentric one (the earlier path, at this
   smaller depth) at 2,000 TOAs on the card (fused), on the CPU (plain
   versions) and on the card through the host loop must agree, the
   kernel's launches counted in each;
10. the fitter API, whose float64 solves never launch the kernel (its
   launch count is set to 0 before and must read 0 after):
   ``Fitter.auto`` on bench.py's par at 20,000 GBT TOAs must pick
   ``DownhillGLSFitter`` (the dense noise basis, one column per ECORR
   epoch) and, from F0/F1/DM/RAJ/DECJ kicked by a few sigma, converge
   to a finite chi2 with every fitted parameter within 5 sigma of the
   truth: steps, trials, Gram builds, cold and warm wall, peak memory,
   the device's idle share of one warm step, the summary, the derived
   quantities and the par file; ``DownhillWLSFitter`` on phase 6's
   100,000 TOAs with the same gates; the fused ``dense_wls_fit`` and
   ``dense_gls_fit`` there, cold (capture) and warm (replays), each
   against the host loop over the same cached step/probe pair (the same
   gates, chi2 within 1e-12); one ``make_wls_step`` and one
   ``make_gls_step`` there, timed, the GLS step held to one hybrid step
   with an exact float64 Gram; ``WLSFitter``, ``GLSFitter`` (Woodbury
   and dense C), ``DownhillWLSFitter`` and ``DownhillGLSFitter`` on one
   2,000-TOA table on the card and on the CPU must agree;
11. the noise-model path, after the loop cache is cleared: an EPTA-DR2-like
   MSP (PAR_J1713: J1713+0747's astrometry, spin and DD orbit, DM/DM1/
   DM2, ChromaticCM's CM at a fixed TNCHROMIDX 4, FD1, a receiver JUMP,
   the troposphere, EFAC/EQUAD/ECORR per receiver, red noise (30
   harmonics), DM noise and scattering noise (100 each)), 100,000 GBT
   TOAs at two receivers simulated on the card from that par, with
   phase 7's gates (the fused fit with the Gram kernel counted per
   replay and seen in the profiler trace, the host loop as its witness,
   every fitted parameter within 5 sigma of the truth, chi2/dof in [0.8,
   1.25], peak memory, wall and idle share); then ``Fitter.auto`` on a
   Vela-like young pulsar (PAR_VELA: F0/F1/F2, one glitch with a decay,
   a 5-pair WAVE absorber) at 5,000 Parkes TOAs from a kicked start,
   every fitted parameter within 5 sigma of the truth;
12. the wideband path, after the loop cache is cleared: PAR_J1909_WB
   (phase 7's par as a wideband par: no ECORR, a fitted DMJUMP, DMEFAC
   and DMEQUAD per receiver), 100,000 GBT TOAs at two receivers each
   with a ``-pp_dm`` (the model DM plus noise at the scaled sigma) and
   ``-pp_dme`` (1e-4), simulated on the card; ``Fitter.auto`` must pick
   ``WidebandDownhillFitter`` and fit every parameter (DMJUMP too) within
   5 sigma of the truth at stacked chi2/dof in [0.8, 1.25];
   ``device_loop.dense_wideband_fit`` cold (capture) and warm, with the
   host loop over the same step/probe as its witness (phase 6's gates),
   and from a kicked start; peak memory, walls, idle shares, the table
   build time; the same fits at 2,000 TOAs card against CPU; zero
   ds32_gram launches (the wideband solves are float64);
13. the SPK ephemeris: a type-2 kernel fitted to the analytic ephemeris
   (Earth/EMB, EMB, the Sun and the planets, MJD 49990-58010; its fit
   error measured on the CPU first) written as ``de421.bsp``, found by
   ``get_ephemeris("DE421")`` under ``PINT_TORCH_EPHEM_DIR`` with
   ``PINT_TORCH_STRICT_EPHEM=1``; phase 6's 100,000-row table built
   through it and timed, a 2,000-row build card against CPU at phase 5's
   bars, the card's build against the analytic one within the fit's
   error, one warm fused fit of bench.py's par through it; a missing
   kernel raises FileNotFoundError, a time outside coverage ValueError
   before any kernel runs on the card;
14. photon events: a NICER-like file (1,000,000 events, TIMESYS TT /
   TIMEREF LOCAL with a LEO orbit file, MJDREFI/MJDREFF, PI) and a
   Fermi-like barycentered one (1,000,000 events, MJDREF, WEIGHT), each
   drawn from a two-peak template folded with an isolated MSP and
   barycentered through phase 13's kernel (strict switch on);
   ``load_event_TOAs``, ``photon_phases``, ``h_test`` and
   ``fit_template`` on the card, timed; on a 20,000-event subset card
   and CPU phases within F0 x 1e-13 s in turns and H within 1e-9
   relative; the NICER-like subset again through the analytic ephemeris
   (no kernel, no strict switch: what ``EPHEM DE421`` gives a user
   without a ``.bsp``), card against CPU, its observatory positions
   within phase 5's bar and its phases within F0 x (1e-13 s + their
   measured position gap); the fitted templates recover the injected
   peaks; a load's spans (the FITS read, the event MJDs in DD on the
   card against the CPU, equal bit for bit);
15. analysis and the command line, on the card: ``pintempo --fitter
   hybrid`` (in-process) on phase 6's 100,000 TOAs written as a tim file,
   the Gram kernel's launch count set to 0 before and read after, the
   tim parse and the fit timed, every post-fit value within 1e-3 sigma of
   phase 6's fit; ``grid_chisq`` over 32 x 32 (F0, F1) nodes of +-3 sigma
   at those TOAs (RAJ, DECJ, DM re-solved at each node, vmapped in
   chunks) and ``gls=True`` over 16 x 16 on phase 10's 20,000 TOAs (the
   dense ECORR and red-noise basis), each with its minimum at its damped
   fit's node and chi2 there the fit's within 1e-6; ``MCMCFitter`` at
   10,000 TOAs of bench.py's par without ECORR (default walkers, 500
   steps, no host sync in the step loop) within 0.5 sigma and 30% of the
   GLS fit; ``event_optimize`` on 100,000 of phase 14's Fermi-like
   events (F0 back within 5 sigma of the truth) and ``photonphase`` on
   its NICER-like file; one day of GBT polycos against the exact phase
   (1e-7 cycles) and evaluated at 1,000,000 MJDs;
   ``calculate_random_models`` (100 draws over 100,000 TOAs; card
   against CPU within 1e-9 cycles at 2,000); ``zima`` writing 100,000
   TOAs;
16. many pulsars, after the loop cache is cleared: the BASELINE config-4
   batch, 68 members x 8,824 GBT TOAs (600,032; bench.py's batch problem:
   the bench par with RA stepped by 5 h and F0 by 0.3 Hz per member),
   simulated on the card, fitted from kicked starts by
   ``BatchedPulsarFitter.fit_toas`` through the fused batched loop, as
   the GLS family (the par's EFAC, ECORR and red noise) and the WLS
   family (its noise lines stripped, as ``bench_batch``): cold (capture)
   and warm (replays) with the host batched loop as its witness (every
   member's decisions the same, every full evaluation's chi2 within
   1e-12), every member converged with chi2/dof in [0.8, 1.25] and every
   fitted parameter within 5 sigma of the truth, four members against
   their single-pulsar fused fits at the same row bucket, peak memory,
   the idle share of a warm fit (torch.profiler) and the 68 table
   builds' wall; a 4 x 2,000-TOA batch of each family card against CPU;
   ``ShardedGLSFitter`` on a 1 x 1 mesh over phase 6's table (within
   1e-3 sigma of phase 6's fit) and ``pintempo --fitter sharded`` on
   phase 15's tim file; with telemetry writing a JSON-lines file, a warm
   batch fit's span tree, counters, per-member records and rollup, and
   with ``PINT_TORCH_TELEMETRY=0`` the same fit writing nothing; zero
   ds32_gram launches in each of these sub-paths, counted from 0 before
   each (their Grams are float64);
17. the PTA joint fit, after the loop cache is cleared: the batched
   ds32 Gram at (68, 8,824, 106), (68, 2,206, 106), a q <= 64 shape and
   (3, 3,001, 129) (each member bit for bit its 2-D launch, through
   ``torch.func.vmap`` too, and within 1e-12 of max|G| of the batched
   plain version; times, bound, ``torch.bmm`` both ways); the block
   elimination at (68, q = 106, p = 6, k = 40) against its plain version
   within 1e-12 of each output's largest entry (times, bound, the route
   before it); BASELINE.md config 5 from
   ``generate_catalog`` (68 x 8,824 GBT TOAs, 600,032, ECORR + 30-harmonic
   red noise, a 20-harmonic HD-correlated GW background; each table then
   shifted by a draw of its par's noise; every model kicked by KICK)
   fitted by ``PTAGLSFitter`` through the fused joint loop (the batched
   Gram, the block elimination and the stage-1 kernel inside its
   captured graph, every kernel count set to 0 before: two batched Gram
   launches, one block elimination and one stage-1 launch per full
   evaluation, each of the last two recorded once in the capture, every
   member's stage 1 on the kernel by the gauges, no 2-D Gram), cold and
   warm, the host loop as witness (phase 6's gates, one stage-1 launch
   per full evaluation), converged with joint
   chi2/dof in [0.8, 1.25] and every fitted parameter within 5 sigma of
   the truth, peak memory, the idle share of a warm fit, and the float64
   route (``accel=False``) within 1e-3 sigma; 4 x 2,000 catalogs card
   against CPU on both routes (one of them heterogeneous: 2-D launches
   per pulsar); an 8 x 2,048 ``CatalogJob`` in 0.2 s slices, resumed
   from its first slice's checkpoint bit for bit; a 4-point hypergrid on
   one capture; ``generate_catalog`` twice, one manifest id; pintk's
   controller (fit, reset, fit, select and delete, fit, 100 random
   models, the par and tim written and read back) on phase 10's 20,000
   TOAs against ``Fitter.auto`` on the same selection, and at 2,000 TOAs
   card against CPU;
17s. the stage-1 kernel (``csrc/stage1.cu``): built (ptxas's report),
   its double-double transforms through ``dd.self_check``'s probes, and
   at phase 17's 68 x 8,824 TOAs against its plain version on the card
   (the whitened design and the residuals equal bit for bit), one launch
   counted; its time (CUDA events, device time), the whole stage 1 on
   its route, the plain version's, the jacfwd route's (the route before
   the kernel) and its byte bound;
18. the serving tier, after the loop cache is cleared, with telemetry
   on and both kernel counts set to 0 before: (a) bench.py's 64-fit
   stream (``_throughput_problems``: plain, FD, JUMP+EFAC and PHOFF
   structures x 50-61 and 90-119 GBT TOAs, per-request F0) through
   ``ThroughputScheduler`` against the same fits one after another
   through ``dense_wls_fit``, every member on its standalone fit (chi2
   within 1e-6 relative, parameters within 1e-9 relative or 5% of sigma,
   the same converged flag), cold and warm walls, one capture per plan
   key, replays and fetches per batch, the idle share of a warm drain;
   (b) bench.py's mixed frontier (``_mixed_problems``: WLS, GLS with
   ECORR, GLS with red noise, wideband) all batched, each member on its
   standalone fused fit; (c) a converged 100,000-TOA WLS session
   (bench.py's incremental problem) and a GLS session on phase 6's table,
   8 appends of 8 TOAs each through the scheduler (after one that
   captures; the sessions' own drift gates may choose a full refit),
   update p50/p95 against a warm-started fused refit over the
   accumulated table, the chi2 drift against it inside
   ``DRIFT_CHI2_REL``, replays and fetches per update,
   and a forced drift-gate trip bit for bit a cold populate; (d) reads of
   256 queries from the 100,000-TOA session: predictions/s, p50/p99 with
   and without a fit drain in flight, phase within 1e-7 cycles of the host
   ``Polycos`` and ``dense_predict``, frequency within 1e-9, the kill
   switch's host route; (e) a stream with a NaN member (quarantined), a
   singular member (ok, as the reference resolves it) and a transient
   device error per batch (retried); (f) 8 requests of (a)'s structures
   and a 2,000-TOA session with two appends, barycentric (at GBT the
   card's and the CPU's sin and cos part a converged chi2 by ~1e-8), on
   the card and on the CPU: the same plans, statuses and routes, chi2
   within 1e-9 relative; (g) zero
   ds32_gram launches in (a)-(f) (the serving tier's Grams are float64,
   as the reference's);
19. the fleet tier, each step failing the run on its gate (in the
   order a, b, c, f, d, e: the join comes before the durability stream,
   whose killed worker leaves one survivor): (a) phase 2's library put
   in a fresh program store; two more Python processes on that store
   (each its own empty build directory) run nvcc 0 times (each loads
   the stored library, digest checked), give phase 4's (100,000, 66) G
   bit for bit, the plain version within 1e-12 of max|G|, and drive 8
   fits of 18a's stream through a scheduler: the first journals its
   captures' program keys, the second derives the same keys from the
   same fits (nothing new journaled), counts each
   ``cache.fit_program.restored`` and as many captures as the first; a
   truncated copy of the library in a fourth store is a counted miss
   rebuilt by nvcc; (b) ``build_fleet(2)``:
   two schedulers on the card route 18a's 64-fit stream twice (no
   stealing: the measure is stickiness), round 2 on round 1's hosts
   with zero captures, every member at 18a's bars, both walls beside
   18a's warm drain; (c) two ``spawn_local_workers`` processes on the
   card over TCP in one gloo group (their ``init_distributed`` strings
   printed): the same stream twice, zero new ``cache.fit_program.miss``
   in either worker's ``report`` in round 2, the workers' ``programs``
   filled, then a third round whose busier worker is SIGKILLed holding
   its pending requests: every request resolves on the survivor at
   18a's bars; (f) a third worker with an empty store joins: it adopts
   the survivor's keys and library (nvcc 0 times in its process, the
   digest checked), its first fits are counted as captures
   (``cache.fit_program.miss``) with the donors' keys among them
   (``cache.fit_program.restored`` > 0), and model reads of a structure that
   did not move are timed before and after the join; (d) 18c's
   100,000-TOA WLS session populated through the TCP fleet, 4 appends
   of 8 TOAs, its pinned worker SIGKILLed holding the last one queued:
   the survivor restores it from the router's journal or replica, and
   its chi2 and parameters match a control session that was never
   killed (``DRIFT_CHI2_REL``; 1e-9 relative or 5% of sigma), with the
   restore wall; (e) ``python -m pint_tpu_torch.telemetry.top --once``
   while that append is pending, then the router's and the workers'
   JSON-lines artifacts merged into ONE rooted tree for the killed
   append (submit, accept, failover, replay, dispatch, commit; 3 pids),
   ``python -m pint_tpu_torch.telemetry.report`` over them with its
   fleet, mesh, read, programs, traces and SLO sections filled, and
   ``python -m pint_tpu_torch.telemetry.probe`` naming the card;
20. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs no network, and exits non-zero with no result when CUDA is
missing or the package is not beside it. Every process it starts
(phase 19's workers and tools) is stopped before it ends.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# bench.py's PAR, verbatim: the main path's model
PAR_FULL = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
EFAC 1.1
ECORR 1.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""
# The bench par for barycentric TOAs (the earlier path): no RAJ/DECJ/
# POSEPOCH/EPHEM, TZRSITE @.
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
SITES = {PAR_FULL: "gbt", PAR_BARY: "@"}
# Phase 7: a J1909-3744-like binary MSP with the NANOGrav delay set. The
# spin, astrometry and ELL1 orbit are J1909-3744's, rounded from the
# NANOGrav 15-year data set (Agazie et al. 2023, ApJL 951, L9), with the
# epochs (PEPOCH, POSEPOCH, TASC) moved to the data's middle. TASC is an
# epoch, which neither package fits; the other six orbital parameters
# are. DM is frozen: the DMX windows (j1909_par) tile the data.
PAR_J1909 = """
PSRJ           J1909-3744
RAJ            19:09:47.4335737  1
DECJ           -37:44:14.46674  1
PMRA           -9.51
PMDEC          -35.86
PX             0.86
F0             339.31568666962  1
F1             -1.614D-15  1
PEPOCH         54000
POSEPOCH       54000
DM             10.3932
EPHEM          DE421
UNITS          TDB
TZRMJD         54000.1
TZRFRQ         1400
TZRSITE        1
BINARY         ELL1
PB             1.533449474406  1
A1             1.89799111  1
TASC           54000.31
EPS1           2.7e-8  1
EPS2           -1.0e-8  1
M2             0.209  1
SINI           0.9980  1
FD1            -1.6e-5  1
FD2            1.2e-5  1
JUMP -fe Rcvr_800  -7.2e-6  1
NE_SW          7.9
EFAC -fe Rcvr_800  1.05
EFAC -fe Rcvr1_2  1.1
EQUAD -fe Rcvr_800  0.05
EQUAD -fe Rcvr1_2  0.03
ECORR -fe Rcvr_800  0.3
ECORR -fe Rcvr1_2  0.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""
# Phase 11: an EPTA-DR2-like MSP with three noise processes. Spin,
# astrometry and the DD orbit are J1713+0747's, rounded from the NANOGrav
# 15-year data set (Agazie et al. 2023, ApJL 951, L9), epochs moved to
# the data's middle; T0 is an epoch, which neither package fits. The
# noise model has the shape of the EPTA DR2 custom models (Chalumeau et
# al. 2022, MNRAS 509, 5538): achromatic red noise, DM noise and
# scattering (chromatic index 4) noise, each a power-law Fourier basis.
# TNCHROMIDX is held fixed: ChromaticCM could fit it, but the noise basis
# PLChromNoise builds at the fitter's construction reads it.
PAR_J1713 = """
PSRJ           J1713+0747
RAJ            17:13:49.5331497  1
DECJ           07:47:37.48796  1
PMRA           4.922  1
PMDEC          -3.909  1
PX             0.88  1
F0             218.81184381090227  1
F1             -4.0835D-16  1
PEPOCH         54000
POSEPOCH       54000
DM             15.917  1
DM1            -1.0e-4  1
DM2            2.0e-6  1
DMEPOCH        54000
CM             2.0e-4  1
TNCHROMIDX     4
EPHEM          DE421
UNITS          TDB
TZRMJD         54000.1
TZRFRQ         1400
TZRSITE        1
CORRECT_TROPOSPHERE Y
BINARY         DD
PB             67.8251299  1
A1             32.3424217  1
T0             54000.73
ECC            7.4940e-5  1
OM             176.2  1
M2             0.29  1
SINI           0.95  1
FD1            -1.5e-5  1
JUMP -fe Rcvr_800  -1.1e-6  1
EFAC -fe Rcvr_800  1.05
EFAC -fe Rcvr1_2  1.1
EQUAD -fe Rcvr_800  0.05
EQUAD -fe Rcvr1_2  0.03
ECORR -fe Rcvr_800  0.3
ECORR -fe Rcvr1_2  0.2
TNREDAMP -14.2
TNREDGAM 3.3
TNREDC 30
TNDMAMP -13.4
TNDMGAM 2.5
TNDMC 100
TNCHROMAMP -14.0
TNCHROMGAM 2.8
TNCHROMC 100
"""
# Phase 11's second fit: a Vela-like young pulsar at Parkes with one
# glitch (a step in phase, F0 and F1, and a decaying F0 term) and a
# 5-pair WAVE absorber of its timing noise (held fixed). F0/F1 and the
# position are Vela's, rounded (ATNF catalogue); the glitch's size is a
# typical Vela glitch's (dF0/F0 ~ 2e-6).
PAR_VELA = """
PSRJ           J0835-4510
RAJ            08:35:20.61149
DECJ           -45:10:34.8751
F0             11.1867  1
F1             -1.5575D-11  1
F2             1.2D-21  1
PEPOCH         57000
POSEPOCH       57000
DM             67.97
EPHEM          DE421
UNITS          TDB
TZRMJD         57000.1
TZRFRQ         1400
TZRSITE        parkes
GLEP_1         57050.5
GLPH_1         0.0  1
GLF0_1         2.5D-5  1
GLF1_1         -1.0D-13  1
GLF0D_1        1.0D-7  1
GLTD_1         5.0  1
WAVEEPOCH      57000
WAVE_OM        0.0057
WAVE1          1.2e-3 -0.8e-3
WAVE2          -0.5e-3 0.6e-3
WAVE3          0.3e-3 0.2e-3
WAVE4          -0.1e-3 -0.15e-3
WAVE5          0.05e-3 0.08e-3
"""
N_VELA = 5_000
# the Vela fit's start: the glitch and F0 kicked off the truth (~5-40
# sigma at 5,000 TOAs of 5 us), so that the damped loop must recover
# GLTD's nonlinear decay
VELA_KICK = {"F0": 2e-12, "GLF0_1": 2e-11, "GLTD_1": 0.05, "GLF0D_1": 5e-10,
             "GLPH_1": 1e-4}
# DMX windows 30 days wide from MJD 50000 (267 tile MJD 50000-58010), a
# 0.001-day gap between neighbours, values drawn from a seed
N_DMX = 267
# the receivers' sub-bands [MHz]: an epoch's four TOAs are one receiver's
RCVR_BANDS = {"Rcvr_800": (740.0, 790.0, 840.0, 890.0),
              "Rcvr1_2": (1180.0, 1330.0, 1480.0, 1630.0)}
# Phase 8: each new component on the card against the CPU. A DDK-ready
# pulsar (proper motion, parallax) carries each binary model in turn; a
# second par carries the delay set, and a third DMX windows that overlap.
CARD_BASE = """
PSRJ J1012+5307
RAJ 10:12:33.43 1
DECJ 53:07:02.5 1
PMRA 2.5
PMDEC -25.0
PX 1.2
F0 190.2678370 1
F1 -6.2e-16 1
PEPOCH 55000
POSEPOCH 55000
DM 9.02
EPHEM DE421
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE 1
"""
_ORBIT = "PB 0.60467 1\nA1 0.58182 1\nPBDOT 3.2 1\nXDOT -0.2 1\n"
_KEPLER = "T0 54999.92\nECC 0.087 1\nOM 112.0 1\nEDOT 1e-16 1\n"
_ELL1 = "TASC 54999.92\nEPS1 1.2e-5 1\nEPS2 -0.5e-5 1\n"
BINARY_LINES = {
    "ELL1": _ORBIT + _ELL1 + "EPS1DOT 1e-16 1\nM2 0.2 1\nSINI 0.98 1\n",
    "ELL1H": _ORBIT + _ELL1 + "H3 2.7e-7 1\nSTIG 0.8 1\n",
    "ELL1K": _ORBIT + _ELL1 + "OMDOT 3.5 1\nLNEDOT 1e-12 1\nM2 0.2 1\nSINI 0.98 1\n",
    "DD": _ORBIT + _KEPLER + "OMDOT 1.2 1\nM2 0.3 1\nSINI 0.95 1\nGAMMA 2e-4 1\n"
                             "A0 1e-6 1\nB0 -2e-6 1\n",
    "DDS": _ORBIT + _KEPLER + "OMDOT 1.2 1\nM2 0.3 1\nSHAPMAX 3.0 1\n",
    "DDH": _ORBIT + _KEPLER + "OMDOT 1.2 1\nH3 4e-7 1\nSTIG 0.75 1\n",
    "DDGR": _ORBIT + _KEPLER + "M2 0.3 1\nMTOT 1.7 1\nXOMDOT 0.1 1\nXPBDOT 1e-13 1\n",
    "DDK": _ORBIT + _KEPLER + "OMDOT 1.2 1\nM2 0.3 1\nKIN 60.0 1\nKOM 40.0 1\n",
    "BT": _ORBIT + _KEPLER + "OMDOT 1.2 1\nGAMMA 2e-4 1\n",
    "BTX": "A1 0.58182 1\nFB0 1.9141e-5 1\nFB1 -2e-21 1\n" + _KEPLER
           + "OMDOT 1.2 1\nGAMMA 2e-4 1\n",
}
DELAY_SET = """
DMX_0001 1.5e-4 1
DMXR1_0001 54000
DMXR2_0001 54600
DMX_0002 -2.5e-4 1
DMXR1_0002 54600.001
DMXR2_0002 55300
DMX_0003 3e-4 1
DMXR1_0003 55500
DMXR2_0003 56000
NE_SW 7.9 1
FD1 1.1e-5 1
FD2 -3e-6 1
FD3 4e-7 1
FD1JUMP -fe Rcvr_800 2e-6 1
FD2JUMP -fe Rcvr1_2 -1e-6 1
JUMP -fe Rcvr_800 1.3e-5 1
JUMP -mjd 54500 55000 -4e-6 1
DMJUMP -fe Rcvr1_2 2e-4 1
PHOFF 0.013 1
"""
OVERLAP_DMX = """
DMX_0001 1.5e-4 1
DMXR1_0001 54000
DMXR2_0001 55200
DMX_0002 -2.5e-4 1
DMXR1_0002 54300
DMXR2_0002 54700
DMX_0003 3e-4 1
DMXR1_0003 55000
DMXR2_0003 56000
"""
# (label, par, the components held card against CPU)
COMPONENT_CASES = [
    (model, CARD_BASE + f"BINARY {model}\n" + lines,
     ("BinaryELL1k" if model == "ELL1K" else f"Binary{model}",))
    for model, lines in BINARY_LINES.items()] + [
    ("delay set", CARD_BASE + DELAY_SET,
     ("SolarWindDispersion", "DispersionDMX", "FD", "FDJump", "PhaseJump",
      "DispersionJump", "PhaseOffset")),
    ("overlapping DMX", CARD_BASE + OVERLAP_DMX, ("DispersionDMX",)),
    ("DelayJump", CARD_BASE + DELAY_SET, ("DelayJump",))] + [
    (label, CARD_BASE + lines, (name,), free)
    for label, name, lines, free in (
        ("troposphere", "TroposphereDelay", "CORRECT_TROPOSPHERE Y\n", ()),
        ("glitch with decay", "Glitch",
         "GLEP_1 55100\nGLPH_1 0.1 1\nGLF0_1 1e-7 1\nGLF1_1 -1e-15 1\n"
         "GLF2_1 1e-24 1\nGLF0D_1 5e-8 1\nGLTD_1 50 1\n", ()),
        ("glitch without decay", "Glitch",
         "GLEP_1 55100\nGLPH_1 0.1 1\nGLF0_1 1e-7 1\nGLF1_1 -1e-15 1\n", ()),
        ("piecewise spindown", "PiecewiseSpindown",
         "PWEP_1 55100\nPWSTART_1 54500\nPWSTOP_1 55500\nPWF0_1 2e-9 1\n"
         "PWF1_1 1e-17 1\nPWF2_1 1e-25 1\n", ()),
        ("WAVE", "Wave", "WAVEEPOCH 55000\nWAVE_OM 0.01\nWAVE1 1e-5 -2e-5\n"
         "WAVE2 3e-6 1e-6\n", ("WAVE_OM", "WAVE1A", "WAVE1B", "WAVE2A", "WAVE2B")),
        ("WaveX", "WaveX", "WXEPOCH 55000\nWXFREQ_0001 0.01\nWXSIN_0001 1e-6 1\n"
         "WXCOS_0001 2e-6 1\nWXFREQ_0002 0.003\nWXSIN_0002 -1e-6 1\n"
         "WXCOS_0002 3e-6 1\n", ()),
        ("DMWaveX", "DMWaveX", "DMWXEPOCH 55000\nDMWXFREQ_0001 0.01\n"
         "DMWXSIN_0001 1e-4 1\nDMWXCOS_0001 -2e-4 1\n", ()),
        ("ChromaticCM (CM1, CMX)", "ChromaticCM",
         "CM 0.5 1\nCM1 1e-3 1\nTNCHROMIDX 4 1\nCMX_0001 1e-3 1\n"
         "CMXR1_0001 54000\nCMXR2_0001 54700\nCMX_0002 -2e-3 1\n"
         "CMXR1_0002 54500\nCMXR2_0002 55500\n", ()),
        ("CMWaveX", "CMWaveX", "CMWXEPOCH 55000\nTNCHROMIDX 3.5 1\n"
         "CMWXFREQ_0001 0.01\nCMWXSIN_0001 1e-4 1\nCMWXCOS_0001 5e-5 1\n", ()),
        ("IFunc SIFUNC 0", "IFunc", "SIFUNC 0\nIFUNC1 54300 1e-5\n"
         "IFUNC2 55000 3e-5\nIFUNC3 55700 -1e-5\n", ("IFUNC1", "IFUNC2", "IFUNC3")),
        ("IFunc SIFUNC 2", "IFunc", "SIFUNC 2\nIFUNC1 54300 1e-5\n"
         "IFUNC2 55000 3e-5\nIFUNC3 55700 -1e-5\n", ("IFUNC1", "IFUNC2", "IFUNC3")))]
# the chromatic noise bases (PLDMNoise, PLChromNoise) card against CPU:
# each block and its prior variances within 1e-12 of their largest entry
NOISE_CASE = CARD_BASE + """
TNDMAMP -13.4
TNDMGAM 2.5
TNDMC 20
TNCHROMAMP -14.0
TNCHROMGAM 2.8
TNCHROMC 20
TNCHROMIDX 4
"""
BASIS_RTOL = 1e-12
# card against CPU: delays (phases over F0) within 1 ps, each jacfwd
# column within 1e-10 of its largest entry (the CPU tests' bars)
COMPONENT_BAR_S = 1e-12
COLUMN_RTOL = 1e-10
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
# the card's table against the CPU's: both do the same IEEE operations
# and differ only in the last bits of sin/cos/log
TDB_BAR_S = 1e-12      # 1 ps
POS_BAR_LS = 1e-11     # light-seconds, 3 mm
VEL_BAR = 1e-15        # v/c
# Phase 10. The dense GLS fit's TOA count: its noise basis is one column
# per 4-TOA ECORR epoch, so F = [M, T] is 20,000 x 5,066 float64
N_DENSE = 20_000
# F0/F1/DM/RAJ/DECJ kicks off the truth: about 3 sigma of the 20,000-TOA
# GLS fit (the port's CPU fits of 2,000 and 4,000 bench-par TOAs, RAJ/
# DECJ/DM scaled as 1/sqrt(n); F0/F1 are held by the red-noise prior)
KICK = {"F0": 3e-13, "F1": 1.3e-20, "DM": 2.5e-6, "RAJ": 2e-10, "DECJ": 3e-9}
TRUTH_SIGMA = 5.0      # every fitted parameter within 5 sigma of the truth
# the same 2,000-TOA table fitted on the card and on the CPU, float64 on
# both: trial and final chi2 within rtol 1e-7 and values within 1e-5
# sigma (the CPU tests hold the port to the reference at these bars; two
# LAPACKs put the near-singular GLS steps ~3e-8 sigma apart). The card's
# sin/cos round the Roemer delay's last bit differently (~3e-14 s), which
# moves each chi2 by ~1e-9 relative, trial by trial: a damped loop's
# accept/halve decisions must agree wherever a trial is more than the
# chi2 bar from the kept value; where one is closer (the noise floor at
# which the loops stop), the two may halve a different number of times.
CARD_CHI2_RTOL = 1e-7
CARD_VALUE_SIGMA = 1e-5
# make_gls_step against one hybrid step with an exact float64 Gram, the
# same Schur solve whitened in another order (tests/test_torch_steps.py:
# 9.8e-11 sigma, 4.2e-11 in chi2 on the CPU)
STEP_VS_HYBRID_SIGMA = 1e-8
STEP_VS_HYBRID_RTOL = 1e-9
# The fused loop against the host loop on one card: the same kernels
# (replayed or launched eagerly) in the same order but for the atomics of
# the ECORR segment sums (main path: 1.5e-11 of 65,878 in chi2, 2e-16
# relative), so every full evaluation's chi2 within rtol 1e-12 and the
# same decisions, counters, steps and probes
LOOP_RTOL = 1e-12
LOOP_COUNTERS = ("iterations", "accepts", "halvings", "probe_evals",
                 "probe_rejects")


def j1909_par() -> str:
    """PAR_J1909 with its N_DMX fitted DMX windows."""
    rng = np.random.default_rng(1909)
    lines = []
    for i in range(1, N_DMX + 1):
        lo = 50000.0 + 30.0 * (i - 1)
        lines += [f"DMX_{i:04d} {rng.normal(0.0, 2e-4):.6e} 1",
                  f"DMXR1_{i:04d} {lo:.3f}", f"DMXR2_{i:04d} {lo + 29.999:.3f}"]
    return PAR_J1909 + "\n".join(lines) + "\n"


def two_receivers(n, rng):
    """(frequencies, flags) of n TOAs in 4-TOA epochs, each epoch at one
    receiver (half at each), its TOAs in the receiver's four sub-bands."""
    n_ep = (n + 3) // 4
    rcvr = np.repeat(np.where(rng.random(n_ep) < 0.5, "Rcvr_800", "Rcvr1_2"),
                     4)[:n]
    sub = np.tile(np.arange(4), n_ep)[:n]
    freq = np.asarray([RCVR_BANDS[r][k] for r, k in zip(rcvr, sub)])
    return freq, [{"fe": str(r)} for r in rcvr]


# Phase 12: PAR_J1909 as a wideband par, as NANOGrav's wideband par
# files carry it: no ECORR (one TOA per observation and receiver), a
# fitted DMJUMP on one receiver, DMEFAC and DMEQUAD per receiver
WB_NOISE = """DMJUMP -fe Rcvr_800 -3.0e-4 1
DMEFAC -fe Rcvr_800 1.1
DMEFAC -fe Rcvr1_2 1.05
DMEQUAD -fe Rcvr_800 2e-5
DMEQUAD -fe Rcvr1_2 1e-5
"""
PAR_J1909_WB = "\n".join(
    line for line in j1909_par().splitlines()
    if not line.startswith("ECORR")) + "\n" + WB_NOISE
SIGMA_DM = 1e-4   # -pp_dme [pc/cm^3], tests/test_wideband.py's scale
# the kicked start of the dense wideband fit: a few sigma of each
WB_KICK = {"F0": 2e-13, "DMJUMP1": 3e-6, "DMX_0100": 5e-5, "FD1": 3e-7}
# Phase 13: the synthetic kernel's span and the record lengths (days)
SPK_MJD = (49990.0, 58010.0)
SPK_BODIES = (("emb", 3, 0, 16.0), ("earth", 399, 3, 4.0), ("sun", 10, 0, 16.0),
              ("venus", 2, 0, 16.0), ("jupiter", 5, 0, 32.0),
              ("saturn", 6, 0, 32.0), ("uranus", 7, 0, 32.0),
              ("neptune", 8, 0, 32.0))
SPK_NCOEF = 12
# the analytic provider's batched path takes velocities at TT, the
# protocol path (an SPK kernel's) at TDB: |TDB - TT| <= 1.7 ms times the
# geocenter's 6e-3 m/s^2 is 3.4e-14 of c between the two builds
PATH_VEL_C = 4e-14
# Phase 14: an isolated MSP (bench.py's spin and astrometry, F1 = 0) and
# a two-peak template
PAR_PHOTON = """
PSRJ           J1748-2021E
RAJ             17:48:52.75
DECJ           -20:21:29.0
F0             61.485476554
F1             0.0
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9
EPHEM          DE421
UNITS          TDB
"""
PHOTON_F0 = 61.485476554
N_EVENTS = 1_000_000
N_EVENT_SUBSET = 20_000
PEAKS = {"locs": [0.25, 0.62], "widths": [0.03, 0.06], "norms": [0.45, 0.3]}
PEAKS_START = {"locs": [0.27, 0.6], "widths": [0.04, 0.08], "norms": [0.4, 0.3]}
PHOTON_TIME_BAR_S = 1e-13
PHOTON_PHASE_BAR = PHOTON_F0 * PHOTON_TIME_BAR_S   # turns
H_RTOL = 1e-9
PEAK_LOC_BAR = 2e-3        # turns
# the drawn phases against the model's at the written METs: half an ulp
# of a NICER MET near 1.2e8 s (7.5e-9 s) is 4.6e-7 turns
GEN_PHASE_BAR = 1e-6
PEAK_WIDTH_RTOL = 0.03


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header, with the script's wall so far."""
    print(f"== {name} (at {time.perf_counter() - _T_START:.1f} s)", flush=True)


def epoch_mjds(n, rng):
    """n MJDs in 4-TOA epochs within 0.5 s, MJD 50000-58000 (the bench's)."""
    n_ep = max(1, (n + 3) // 4)
    centers = np.sort(rng.uniform(50000.0, 58000.0, size=n_ep))
    return (centers[:, None]
            + rng.uniform(0, 0.5 / 86400.0, (n_ep, 4))).ravel()[:n]


def simulate(par, n, seed, device):
    """The bench's traffic from `par`: n TOAs in 4-TOA epochs at 1400/430
    MHz, 1 us, at GBT (PAR_FULL) or the barycenter (PAR_BARY)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    return make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), get_model(par),
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs=SITES[par], add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=device)


def simulate_binary(par, n, seed, device):
    """Phase 7's traffic from `par`: n GBT TOAs in 4-TOA epochs at two
    receivers (two_receivers), 1 us."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    freq, flags = two_receivers(n, rng)
    return make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), get_model(par), freq_mhz=freq, error_us=1.0,
        obs="gbt", flags=flags, add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=device)


def gbt_table(n, seed, device, ephem, receivers=False):
    """n GBT TOAs at the bench's MJDs, built (not simulated) on `device`:
    at 1400/430 MHz, or at phase 7's two receivers (with their flags)."""
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    if receivers:
        freq, flags = two_receivers(n, rng)
    else:
        freq, flags = np.where(rng.random(n) < 0.5, 1400.0, 430.0), None
    return build_TOAs_from_arrays(
        DD(mjds, np.zeros(n)), freq_mhz=freq, error_us=1.0, flags=flags,
        obs_names=("gbt",), eph=ephem, device=device)


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


def free_values(model):
    """The model's free parameters' values (hi, lo): a fit's start."""
    return {k: model[k].value for k in model.free_params}


def run_fit(fitter, start=None, loop="1", maxiter=10):
    """One damped fit of `fitter` (from `start`, when given), through the
    fused loop (``loop="1"``) or the host loop (``"0"``). Returns a
    record: chi2, wall s, full steps, probes, the loop's counters, the
    fused loop's captures/replays/fetches, the flight-recorder trace and
    the ds32_gram and stage1_fused launches (counted per replay)."""
    import os

    from pint_tpu_torch.ops import gram, stage1
    from pint_tpu_torch.telemetry import recorder

    if start is not None:
        for k, v in start.items():
            fitter.model[k].value = v
    os.environ["PINT_TORCH_DEVICE_LOOP"] = loop
    try:
        before = gram.ds32_gram.launches
        before_s1 = stage1.stage1_fused.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chi2 = fitter.fit_toas(maxiter=maxiter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("PINT_TORCH_DEVICE_LOOP")
    trace = recorder.last_trace()
    return {"chi2": chi2, "wall": wall, "steps": trace["n"],
            "probes": fitter.counters["probe_evals"],
            "counters": {k: fitter.counters[k] for k in LOOP_COUNTERS},
            "stats": dict(fitter.loop_stats), "trace": trace,
            "launches": gram.ds32_gram.launches - before,
            "stage1": stage1.stage1_fused.launches - before_s1,
            "converged": fitter.converged}


def replay_spans(fitter, start):
    """One warm fused fit of `fitter` from `start` with CUDA events around
    each graph replay: (replays, their summed device span in ms, the fit's
    wall in ms). A replay's span holds its kernels and the gaps between
    them on the card; the rest of the wall is the host's."""
    from pint_tpu_torch.fitting import device_loop

    events = []
    replay = device_loop._Captured.replay

    def timed(cap, kind):
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        replay(cap, kind)
        end_ev.record()
        events.append((start_ev, end_ev))

    device_loop._Captured.replay = timed
    try:
        wall_ms = run_fit(fitter, start)["wall"] * 1e3
    finally:
        device_loop._Captured.replay = replay
    return len(events), sum(a.elapsed_time(b) for a, b in events), wall_ms


def describe_fit(label, r):
    st = r["stats"]
    loop = (f"{st['captures']} captures, {st['replays']} graph replays, "
            f"{st['fetches']} host fetches" if st else "host loop")
    print(f"{label}: {r['wall']:.4f} s wall; {r['steps']} full "
          f"steps, {r['probes']} probes ({loop}); counters {r['counters']}; "
          f"ds32_gram launches {r['launches']}"
          + (f", stage1_fused {r['stage1']}" if "stage1" in r else "")
          + f"; GLS chi2 {r['chi2']:.9f}, converged {r['converged']}",
          flush=True)


def same_loop(a, b, rtol=LOOP_RTOL):
    """Two fits of one problem on one card (fused and host loop, or cold
    and warm) make the same loop: every full evaluation's chi2 and the
    final chi2 within `rtol`, the same trace otherwise (damping factors,
    decisions, halvings and probes after each evaluation), and equal
    counters, steps and probes."""
    ta, tb = a["trace"], b["trace"]
    same = (len(ta["chi2"]) == len(tb["chi2"])
            and all(abs(x - y) <= rtol * abs(y)
                    for x, y in zip(ta["chi2"], tb["chi2"]))
            and abs(a["chi2"] - b["chi2"]) <= rtol * abs(b["chi2"])
            and all(ta[f] == tb[f]
                    for f in ("lam", "accepted", "halvings", "probe_evals"))
            and (a["counters"], a["steps"], a["probes"])
            == (b["counters"], b["steps"], b["probes"]))
    if not same:
        for f in ("chi2", "lam", "accepted", "halvings", "probe_evals"):
            print(f"  loops differ; {f}: {ta[f]} / {tb[f]}", flush=True)
    return same


def kicked(par):
    """A fresh model of `par` with F0/F1/DM/RAJ/DECJ kicked by KICK."""
    from pint_tpu_torch.models import get_model

    model = get_model(par)
    for k, d in KICK.items():
        model[k].add_delta(d)
    return model


def run_dense_fit(make, toas, **kw):
    """Build ``make(toas, kicked model)`` and fit; count the trials
    (``_chi2_now``), the full steps (``_step``) and the Gram builds
    (``gls.gls_solve``). Returns (fitter, chi2, wall s, counts)."""
    from pint_tpu_torch.fitting import gls

    counts = {"steps": 0, "trials": 0, "G builds": 0}
    solve = gls.gls_solve

    def counted_solve(*args):
        counts["G builds"] += 1
        return solve(*args)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = make(toas, kicked(PAR_FULL))
    chi2_now, step = fitter._chi2_now, fitter._step

    def counted_chi2():
        counts["trials"] += 1
        return chi2_now()

    def counted_step(**k):
        counts["steps"] += 1
        return step(**k)

    fitter._chi2_now, fitter._step = counted_chi2, counted_step
    gls.gls_solve = counted_solve
    try:
        chi2 = fitter.fit_toas(maxiter=10, **kw)
        torch.cuda.synchronize()
    finally:
        gls.gls_solve = solve
    wall = time.perf_counter() - t0
    del fitter._chi2_now, fitter._step   # the class's methods again
    return fitter, chi2, wall, counts


def record_trials(fitter):
    """Wrap a Downhill fitter's ``_chi2_now`` (its trial judge) so that
    every trial chi2 is recorded in the returned list."""
    trials = []
    inner = getattr(fitter, "_chi2_now", None)
    if inner is not None:
        def recorded():
            trials.append(inner())
            return trials[-1]

        fitter._chi2_now = recorded
    return trials


def trial_decisions(trials, halvings=8):
    """Replay a Downhill fit's trial chi2 sequence (the first is the
    entry chi2): (trial chi2, kept chi2, accepted) per judged trial, in
    order. A step whose every halving was rejected ends the list (the
    fitter's re-evaluation at the restored point follows it)."""
    out, kept, i = [], trials[0], 1
    while i < len(trials):
        for _ in range(halvings):
            if i == len(trials):
                return out
            t = trials[i]
            i += 1
            out.append((t, kept, t <= kept + 1e-12))
            if out[-1][2]:
                kept = t
                break
        else:
            return out
    return out


def same_trials(tc, tg):
    """The card's trials `tg` against the CPU's `tc` (see CARD_CHI2_RTOL):
    equal chi2 within the bar and equal decisions up to and including the
    first decision resolved by less than the bar on either device; equal
    lengths where no such decision was met."""
    if abs(tg[0] - tc[0]) > CARD_CHI2_RTOL * abs(tc[0]):
        return False
    for (c, kc, ac), (g, kg, ag) in zip(trial_decisions(tc), trial_decisions(tg)):
        if abs(g - c) > CARD_CHI2_RTOL * abs(c):
            return False
        if min(abs(c - kc), abs(g - kg)) <= CARD_CHI2_RTOL * abs(kc):
            return True   # the noise floor: the paths may part here
        if ac != ag:
            return False
    return len(tc) == len(tg)


def check_truth(fitter, truth, label, kicks=KICK):
    """Fail unless the fit converged to a finite chi2 with every fitted
    parameter within TRUTH_SIGMA of the simulation's truth; the largest
    pulls (and the start's `kicks`, in sigma) are printed."""
    model = fitter.model
    pulls = {k: (model[k].value_f64 - truth[k].value_f64) / model[k].uncertainty
             for k in fitter.fit_params}
    worst = sorted(pulls.items(), key=lambda kv: -abs(kv[1]))
    kick_text = ("; kicks (sigma) " + ", ".join(
        f"{k} {d / model[k].uncertainty:.2f}" for k, d in kicks.items())
        if kicks else "")
    print(f"  {label}: {len(pulls)} fitted parameters; largest pulls from the "
          "truth (sigma) " + ", ".join(f"{k} {v:+.3f}" for k, v in worst[:8])
          + kick_text, flush=True)
    chi2 = fitter.resids.chi2
    if not (fitter.converged and not fitter.diverged and math.isfinite(chi2)):
        fail(f"{label} did not converge to a finite chi2 ({chi2})")
    if not abs(worst[0][1]) < TRUTH_SIGMA:
        fail(f"{label} left {worst[0][0]} {worst[0][1]:.2f} sigma from the truth")


def fitter_api(dev, toas):
    """Phase 10 (see the module docstring). `toas` is phase 6's table.
    Returns phase 15's inputs: the 20,000-TOA table, and the
    DownhillWLSFitter (phase 6's table) and DownhillGLSFitter (the
    20,000 TOAs) fits as fit_state()s."""
    from pint_tpu_torch.fitting import (DownhillGLSFitter, DownhillWLSFitter,
                                        Fitter, GLSFitter, WLSFitter, gls_step,
                                        step)
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram

    truth = get_model(PAR_FULL)
    gram.ds32_gram.launches = 0
    t0 = time.perf_counter()
    dense = simulate(PAR_FULL, N_DENSE, seed=5, device=dev)
    torch.cuda.synchronize()
    print(f"simulated {len(dense)} GBT TOAs on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for run in ("cold", "warm"):
        f = None   # the cold fit's basis is freed before the warm fit
        torch.cuda.reset_peak_memory_stats()
        f, chi2, wall, counts = run_dense_fit(Fitter.auto, dense)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        dims = f.model.noise_model_dimensions(dense)
        print(f"Fitter.auto ({run}): {type(f).__name__}, noise basis {dims}; "
              f"{wall:.3f} s wall (construction + fit_toas); {counts['steps']} "
              f"full steps, {counts['trials']} trials, {counts['G builds']} Gram "
              f"builds; GLS chi2 {chi2:.6f}, reduced {chi2 / f.resids.dof:.6f}; "
              f"converged {f.converged}; peak memory {peak_mb:.1f} MiB",
              flush=True)
        if type(f) is not DownhillGLSFitter:
            fail(f"Fitter.auto picked {type(f).__name__} for the bench par")
        check_truth(f, truth, f"DownhillGLSFitter at {N_DENSE} TOAs ({run})")
    gls_state = fit_state(f, chi2)
    step_ms = host_ms(lambda: f._step(), reps=3)
    print(f"one warm DownhillGLSFitter._step: {step_ms:.2f} ms wall", flush=True)
    profile_step("one warm DownhillGLSFitter._step", lambda: f._step(), step_ms)
    print(f.get_summary())
    print("derived: " + ", ".join(f"{k} {v:.6g} +- {e:.3g}"
                                  for k, (v, e) in f.get_derived_params().items()))
    print(f"as_parfile(): {len(f.model.as_parfile().splitlines())} lines",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    f, chi2, wall, counts = run_dense_fit(DownhillWLSFitter, toas)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"DownhillWLSFitter at {len(toas)} TOAs: {wall:.3f} s wall; "
          f"{counts['steps']} full steps, {counts['trials']} trials; chi2 "
          f"{chi2:.6f}, reduced {f.resids.reduced_chi2:.6f}; converged "
          f"{f.converged}; peak memory {peak_mb:.1f} MiB", flush=True)
    check_truth(f, truth, f"DownhillWLSFitter at {len(toas)} TOAs")
    wls_state = fit_state(f, chi2)

    model = kicked(PAR_FULL)
    base, d0 = model.base_dd(dev), model.zero_deltas(device=dev)
    noise, specs = gls_step.build_noise_statics(model, toas)
    wls = step.make_wls_step(model, device=dev)
    glss = gls_step.make_gls_step(model, pl_specs=specs, device=dev)
    wls_ms = median_ms(lambda: wls(base, d0, toas), reps=5, warm=1)
    gls_ms = median_ms(lambda: glss(base, d0, toas, noise), reps=5, warm=1)
    new, info = glss(base, d0, toas, noise)
    gls_step.ds32_gram = lambda A: A.T @ A
    try:
        hnew, hinfo = HybridGLSFitter(toas, model, device=dev)._iterate(base, d0)
    finally:
        gls_step.ds32_gram = gram.ds32_gram
    sig = torch.sqrt(torch.diagonal(hinfo["cov"]))
    gaps = {k: abs(float(new[k] - hnew[k])) / float(sig[i + 1])
            for i, k in enumerate(model.free_params)}
    rel = {key: abs(float(info[key]) / float(hinfo[key]) - 1)
           for key in ("chi2", "chi2_at_input")}
    print(f"single-call steps at {len(toas)} TOAs (CUDA events, median of 5): "
          f"make_wls_step {wls_ms:.2f} ms, make_gls_step {gls_ms:.2f} ms; "
          f"make_gls_step - exact-Gram hybrid step: worst "
          f"{max(gaps.values()):.3e} sigma (bar {STEP_VS_HYBRID_SIGMA:g}), chi2 "
          f"{rel['chi2']:.3e}, chi2 at input {rel['chi2_at_input']:.3e} (bar "
          f"{STEP_VS_HYBRID_RTOL:g})", flush=True)
    if not (max(gaps.values()) <= STEP_VS_HYBRID_SIGMA
            and max(rel.values()) <= STEP_VS_HYBRID_RTOL):
        fail("make_gls_step disagrees with the exact-Gram hybrid step")

    small = simulate(PAR_FULL, N_SMALL, seed=1, device="cpu")
    for label, make, kw in (
            ("WLSFitter", WLSFitter, {"maxiter": 2}),
            ("GLSFitter", GLSFitter, {"maxiter": 2}),
            ("GLSFitter full_cov", GLSFitter, {"full_cov": True}),
            ("DownhillWLSFitter", DownhillWLSFitter, {"maxiter": 10}),
            ("DownhillGLSFitter", DownhillGLSFitter, {"maxiter": 10})):
        runs = []
        for table in (small, small.to(dev)):
            f = make(table, kicked(PAR_FULL))
            trials = record_trials(f)
            runs.append((f, f.fit_toas(**kw), trials))
        (fc, cc, tc), (fg, cg, tg) = runs
        worst = max(abs(fc.model[k].value_f64 - fg.model[k].value_f64)
                    / fc.model[k].uncertainty for k in fc.fit_params)
        print(f"{label}: chi2 cpu {cc:.9f} card {cg:.9f}; worst parameter gap "
              f"{worst:.3e} sigma; trials cpu {len(tc)} card {len(tg)}; "
              f"converged {fc.converged}/{fg.converged}, diverged "
              f"{fc.diverged}/{fg.diverged}", flush=True)
        if tc:
            print(f"  trials cpu {tc}\n  trials card {tg}", flush=True)
        same = ((same_trials(tc, tg) if tc else not tg)
                and abs(cg - cc) <= CARD_CHI2_RTOL * abs(cc)
                and worst <= CARD_VALUE_SIGMA
                and (fc.converged, fc.diverged) == (fg.converged, fg.diverged))
        if not same:
            fail(f"{label} on the card disagrees with the CPU: trials "
                 f"{tc} / {tg}")
    dense_fits(toas)
    if gram.ds32_gram.launches:
        fail(f"the fitter API launched ds32_gram {gram.ds32_gram.launches} "
             "times; its solves are float64")
    return dense, wls_state, gls_state


def dense_host_loop(kind, model, toas):
    """``downhill_iterate`` over the cached step/probe pair that
    ``dense_<kind>_fit`` runs, on the same bucketed table and statics."""
    from pint_tpu_torch import bucketing
    from pint_tpu_torch.fitting import damped, device_loop, gls_step, step

    dev = toas.device
    base = model.base_dd(dev)
    if kind == "wls":
        toas_b = bucketing.bucket_toas(toas)
        s = step.cached_wls_step(model, device=dev)
        p = step.cached_wls_probe(model, device=dev)
        ops = model.scaled_toa_uncertainty(toas_b)
    else:
        toas_b, ops, specs = device_loop.dense_gls_operands(model, toas)
        s = gls_step.cached_gls_step(model, pl_specs=specs, device=dev)
        p = gls_step.cached_gls_probe(model, pl_specs=specs, device=dev)
    counters = {}
    _, _, chi2, conv = damped.downhill_iterate(
        lambda d: s(base, d, toas_b, ops), model.zero_deltas(device=dev),
        maxiter=10, chi2_at=lambda d: p(base, d, toas_b, ops),
        counters=counters)
    return chi2, conv, counters


def dense_fits(toas):
    """Phase 10: ``dense_wls_fit`` and ``dense_gls_fit`` on the main path's
    table, cold (capture) and warm (replays), each against the host loop
    over the same cached step/probe pair."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.telemetry import recorder

    def statics():
        device_loop.dense_gls_operands(kicked(PAR_FULL), toas)

    print(f"dense_gls_fit's host-built noise statics (ECORR epochs, scaled "
          f"sigma) at {len(toas)} TOAs: {host_ms(statics, reps=3):.2f} ms a "
          f"call", flush=True)
    for kind in ("wls", "gls"):
        fit = getattr(device_loop, f"dense_{kind}_fit")
        model = kicked(PAR_FULL)
        recs = {}
        for run in ("cold", "warm", "host loop"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run == "host loop":
                chi2, conv, counters = dense_host_loop(kind, model, toas)
                stats = {}
            else:
                stats = {}
                _, _, chi2, conv, counters = fit(toas, model, maxiter=10,
                                                 stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trace = recorder.last_trace()
            recs[run] = {"chi2": chi2, "wall": wall, "steps": trace["n"],
                         "probes": counters["probe_evals"], "trace": trace,
                         "counters": {k: counters[k] for k in LOOP_COUNTERS},
                         "stats": stats, "launches": 0, "converged": conv}
            describe_fit(f"dense_{kind}_fit at {len(toas)} TOAs ({run})",
                         recs[run])
        if not (recs["cold"]["stats"]["captures"] == 2
                and recs["warm"]["stats"]["captures"] == 0
                and recs["cold"]["converged"]
                and math.isfinite(recs["cold"]["chi2"])
                and same_loop(recs["cold"], recs["warm"])
                and same_loop(recs["cold"], recs["host loop"])):
            fail(f"dense_{kind}_fit disagrees with the host loop over its "
                 f"step and probe")


def hybrid_path(dev, par, q_want, label, shown):
    """Phases 7 and 11 (see the module docstring): the hybrid fit of `par`
    on N_TOAS GBT TOAs at two receivers simulated from it, fused and
    through the host loop; `shown` are the parameters printed. Returns the
    ds32_gram launches of its fits by name."""
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram

    model, truth = get_model(par), get_model(par)
    print("components: " + ", ".join(type(c).__name__ for c in model.components)
          + f"; {len(model.free_params)} free parameters", flush=True)
    t0 = time.perf_counter()
    toas = simulate_binary(par, N_TOAS, seed=7, device=dev)
    torch.cuda.synchronize()
    print(f"simulated {len(toas)} GBT TOAs at Rcvr_800 and Rcvr1_2 on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    build_ms = host_ms(lambda: gbt_table(N_TOAS, 7, dev, model.ephem,
                                         receivers=True), reps=3)
    print(f"one {N_TOAS}-row GBT table build at two receivers on the card "
          f"(warm): {build_ms:.2f} ms wall", flush=True)
    gram.ds32_gram.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = HybridGLSFitter(toas, model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = fitter._n_params + fitter._F.shape[1]
    blocks = " + ".join(f"{2 * s.nharm} {s.scale}" for s in fitter.pl_specs)
    print(f"q = {q} whitened columns: {fitter._n_params} timing (offset "
          f"included) + Fourier {blocks} (noise scale); "
          f"{fitter._ne} ECORR epochs; construction {build_s:.3f} s", flush=True)
    if q != q_want:
        fail(f"the {label}'s Gram has q = {q}, phase 4 timed {q_want}")
    start = free_values(model)
    cold = run_fit(fitter)
    launches = gram.ds32_gram.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    reserved_mb = torch.cuda.memory_reserved() / 2 ** 20
    st = cold["stats"]
    red = fitter.resids.reduced_chi2
    describe_fit(f"{label} (cold, fused loop, with capture)", cold)
    print(f"  chi2/dof {cold['chi2'] / fitter.resids.dof:.6f}, post-fit residual "
          f"chi2/dof {red:.6f}; peak memory {peak_mb:.1f} MiB allocated (graph "
          f"pool included), {reserved_mb:.1f} MiB reserved", flush=True)
    for k in shown:
        print(f"  {k} = {model[k].format_value()} +- {model[k].format_uncertainty()}")
    print(f"ds32_gram launches in the {label} (counted per replay): "
          f"{launches}", flush=True)
    if not 0.8 <= red <= 1.25:
        fail(f"{label}: post-fit reduced chi2 {red} outside [0.8, 1.25]")
    if launches == 0 or launches < 2 * cold["steps"]:
        fail(f"{launches} ds32_gram launches for {cold['steps']} full steps")
    if not (st["captures"] == 2 and st["full"] == cold["steps"]
            and st["replays"] == cold["steps"] + cold["probes"] - 1):
        fail(f"the {label} did not run as graph replays: {st}")
    check_truth(fitter, truth, f"the {label} at {N_TOAS} TOAs", kicks={})
    warm = run_fit(fitter, start)
    describe_fit(f"{label} (warm, fused loop, the same start)", warm)
    if not (warm["stats"]["captures"] == 0 and same_loop(cold, warm)):
        fail(f"the warm {label} is not the cold one replayed")
    hfitter = HybridGLSFitter(toas, get_model(par))
    hcold = run_fit(hfitter, loop="0")
    hwarm = run_fit(hfitter, start, loop="0")
    describe_fit(f"{label} (host loop, first)", hcold)
    gap = max(abs(x - y) / abs(y) for x, y in zip(cold["trace"]["chi2"],
                                                   hcold["trace"]["chi2"]))
    print(f"  fused - host loop chi2: {cold['chi2'] - hcold['chi2']:+.3e}; "
          f"largest relative gap of a full evaluation's chi2 {gap:.3e} (bar "
          f"{LOOP_RTOL:g})", flush=True)
    if not (same_loop(cold, hcold) and same_loop(warm, hwarm)):
        fail(f"the fused {label} disagrees with the host loop")
    fused_ms = host_ms(lambda: run_fit(fitter, start), reps=3)
    host_loop_ms = host_ms(lambda: run_fit(hfitter, start, loop="0"), reps=3)
    resid_ms = host_ms(fitter._new_resids, reps=3)
    print(f"one warm {label} (fused loop): {fused_ms:.2f} ms wall; through "
          f"the host loop: {host_loop_ms:.2f} ms (median of 3); of either, the "
          f"post-fit residuals (eager, after the loop) {resid_ms:.2f} ms",
          flush=True)
    n_rep, span_ms, wall_ms = replay_spans(fitter, start)
    print(f"one warm fused {label}: {n_rep} graph replays span "
          f"{span_ms:.2f} ms on the card (CUDA events around each replay) of "
          f"its {wall_ms:.2f} ms wall", flush=True)
    profiled = []
    by_name = profile_step(f"one warm fused {label}",
                           lambda: profiled.append(run_fit(fitter, start)),
                           fused_ms)
    traced = {p: sum(c for name, (_, c) in by_name.items()
                     if f"ds32_gram_{p}" in name)
              for p in ("partials", "reduce")}
    counted = profiled[-1]["launches"]
    print(f"  ds32_gram in the profiled {label}: {counted} launches counted "
          f"per replay; the trace holds {traced['partials']} partials and "
          f"{traced['reduce']} reduce kernels", flush=True)
    if by_name and traced != {"partials": counted, "reduce": counted}:
        fail(f"the trace of the {label} holds {traced} ds32_gram kernels, "
             f"not the {counted} launches counted per replay")
    profile_step(f"one warm host-loop {label}",
                 lambda: run_fit(hfitter, start, loop="0"), host_loop_ms)
    return {f"{label} {N_TOAS} (fused, cold)": launches,
            f"{label} {N_TOAS} (fused, warm)": warm["launches"],
            f"{label} {N_TOAS} (host loop, warm)": hwarm["launches"]}


def glitch_fit(dev):
    """Phase 11's second fit: ``Fitter.auto`` on PAR_VELA at N_VELA Parkes
    TOAs, from VELA_KICK off the truth; no Gram kernel launch."""
    from pint_tpu_torch.fitting import Fitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    truth = get_model(PAR_VELA)
    rng = np.random.default_rng(835)
    mjds = np.sort(rng.uniform(56500.0, 57600.0, N_VELA))
    freq = np.where(rng.random(N_VELA) < 0.5, 1369.0, 3100.0)
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(N_VELA)), truth, freq_mhz=freq, error_us=5.0,
        obs="parkes", add_noise=True, seed=int(rng.integers(2 ** 31)), niter=2,
        device=dev)
    model = get_model(PAR_VELA)
    for k, d in VELA_KICK.items():
        model[k].add_delta(d)
    before = gram.ds32_gram.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = Fitter.auto(toas, model)
    chi2 = fitter.fit_toas(maxiter=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"Fitter.auto on the Vela-like par at {N_VELA} Parkes TOAs picks "
          f"{type(fitter).__name__}; fit from the kicked start {wall:.3f} s "
          f"(cold, construction included); chi2 {chi2:.6f}, post-fit chi2/dof "
          f"{fitter.resids.reduced_chi2:.6f}, converged {fitter.converged}",
          flush=True)
    for k in fitter.fit_params:
        print(f"  {k} = {model[k].format_value()} +- {model[k].format_uncertainty()}")
    check_truth(fitter, truth, f"the glitch fit at {N_VELA} TOAs", kicks=VELA_KICK)
    if gram.ds32_gram.launches != before:
        fail("the glitch fit launched ds32_gram")
    return type(fitter).__name__


def component_eval(model, name, toas):
    """Component `name` of `model` on `toas`: its delay (a phase one's
    phase in seconds, DMJUMP's DM) and jacfwd columns in its free
    parameters, on the host."""
    c = model.get_component(name)
    p = model.base_dd(toas.device)
    acc = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
    aux: dict = {}
    for other in model.delay_components() if c.is_delay or c.is_phase else ():
        if other is c:
            break
        acc = acc + other.delay(p, toas, acc, aux)

    def fn(d):
        q = model.resolve(p, d)
        if c.is_delay:
            return c.delay(q, toas, acc, dict(aux))
        if c.is_phase:
            ph = c.phase(q, toas, acc, dict(aux))
            return (ph.int_part + (ph.frac.hi + ph.frac.lo)) / model.f0_f64
        return c.dm_value(q, toas)

    names = [q.name for q in c.params if not q.frozen and q.fittable]
    J = torch.func.jacfwd(fn)(model.zero_deltas(names, toas.device)) \
        if names else {}
    return fn({}).cpu(), {k: J[k].cpu() for k in names}


def components_card_vs_cpu(dev):
    """Phase 8: every new component card against CPU (COMPONENT_CASES)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.jump import DelayJump

    cpu = gbt_table(N_SMALL, seed=8, device="cpu", ephem="DE421",
                    receivers=True)
    card = cpu.to(dev)
    bad = []
    for label, par, names, *free in COMPONENT_CASES:
        model = get_model(par)
        for k in free[0] if free else ():   # params no par line can free
            model[k].frozen = False
        if label == "DelayJump":   # built programmatically, as the reference's
            jumps = [(model[k].selector, model[k].value_f64)
                     for k in ("JUMP1", "JUMP2")]
            model.remove_component("PhaseJump")
            dj = DelayJump()
            for sel, v in jumps:
                dj.add_jump(sel, value=v, frozen=False)
            model.add_component(dj)
        for name in names:
            (vc, cc), (vg, cg) = (component_eval(model, name, t)
                                  for t in (cpu, card))
            gap = float(torch.max(torch.abs(vc - vg)))
            col = max((float(torch.max(torch.abs(cc[k] - cg[k])))
                       / float(torch.max(torch.abs(cc[k]))) for k in cc),
                      default=0.0)
            unit = "pc/cm^3" if name == "DispersionJump" else "s"
            print(f"  {label}: {name} max |card - cpu| {gap:.3e} {unit} (max "
                  f"|value| {float(torch.max(torch.abs(vc))):.3e}); {len(cc)} "
                  f"jacfwd columns, worst gap {col:.3e} of max|column|",
                  flush=True)
            if not (gap <= COMPONENT_BAR_S and col <= COLUMN_RTOL
                    and float(torch.max(torch.abs(vc))) > 0.0):
                bad.append(f"{label}: {name}")
    # the chromatic noise bases, as the hybrid fitter and the GLS step
    # build them, and their prior variances
    from pint_tpu_torch.fitting.gls_step import build_noise_statics, pl_bases
    from pint_tpu_torch.fitting.hybrid import pl_basis_arrays

    model = get_model(NOISE_CASE)
    for label, build in (("hybrid", pl_basis_arrays), ("GLS step", pl_bases)):
        (Fc, pc), (Fg, pg) = (build(t, specs, noise.pl_params)
                              for t in (cpu, card)
                              for noise, specs in [build_noise_statics(model, t)])
        gaps = [float(torch.max(torch.abs(a - b.cpu()))) / float(torch.max(torch.abs(a)))
                for a, b in ((Fc, Fg), (pc, pg))]
        print(f"  PLDMNoise + PLChromNoise bases ({label}: {Fc.shape[1]} columns):"
              f" max |card - cpu| {gaps[0]:.3e} of max|F|, prior variances "
              f"{gaps[1]:.3e} of their largest", flush=True)
        if not max(gaps) <= BASIS_RTOL:
            bad.append(f"noise bases ({label})")
    if bad:
        fail(f"components differ between card and CPU: {bad}")


def profile_step(label, fn, wall_ms):
    """torch.profiler over one warm call of fn (a fit, a step or its
    stage 1): the kernels that take the time, and the device's idle share
    of the unprofiled call's wall time `wall_ms`. Returns the trace's
    device time (ms) and launches by kernel name. Only the card's
    activity is recorded: the host ops of an eager fit (~10^6 events)
    would take tens of seconds to parse and add nothing here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3

    by_name: dict = {}
    for e in prof.events():
        # a program span's range on the device's timeline is no work
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms == 0.0:
        print(f"profile of {label}: the trace holds no device time (not measured)")
        return by_name
    print(f"profile of {label}: wall {prof_ms:.2f} ms profiled, "
          f"{wall_ms:.2f} ms not; device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the unprofiled wall, "
          f"{sum(c for _, c in by_name.values())} kernel launches")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}")
    return by_name


def kernel_name(text: str) -> str:
    """The first ds32_gram kernel named in `text` (a mangled symbol), as
    partials_narrow, partials_tile, partials_pairs or reduce."""
    return re.search(r"ds32_gram_(partials_[a-z]+|reduce)", text).group(1)


def whitened(n, q, seed, device):
    """(n, q) f64 with unit columns, as gls_gram_whitened feeds the Gram."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((n, q), generator=g, dtype=torch.float64, device=device)
    return (A / torch.linalg.norm(A, dim=0)).contiguous()


def device_ms(fn, calls=20, kernels=(), tries=3):
    """Device time per call of fn, by kernel name, from a torch.profiler
    trace of `calls` warm calls. A trace counts only when it is whole:
    each kernel name's event count a positive multiple of `calls`, and
    each name fragment of `kernels` among the names. Up to `tries`
    traces are taken; {} where none is whole (device time not
    measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out: dict = {}
        counts: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out[e.name] = (out.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / calls)
                counts[e.name] = counts.get(e.name, 0) + 1
        if counts and all(c % calls == 0 for c in counts.values()) and all(
                any(k in name for name in counts) for k in kernels):
            return out
        print(f"  torch.profiler trace of {calls} calls not whole: "
              f"{ {k[:60]: c for k, c in counts.items()} }",
              flush=True)
    return {}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


# Gram shapes of phase 4: (label, n, q, timed, path). G_BB is every TOA
# x (offset, RAJ, DECJ, DM, F0, F1, 60 Fourier columns) on the main path
# ("main"), q = 64 without RAJ/DECJ on the barycentric one; the ECORR
# Schur term has one row per 4-TOA epoch. Phase 7's binary path
# ("binary": 6 tiles of 64) and phase 11's noise path ("noise": 8 tiles)
# add their q (check_gram's path_q). 2,000
# and 500 rows are phase 9's fits; 137 rows pad the block and its last
# 32-row chunk; the 3,001-row shapes (an odd row count) take every route
# of the tiling (ops/gram.py::_tile_plan) on both sides of each edge:
# the narrow build's one tile up to 68 columns, the one-tile build's
# task runs up to 128, the pairs build's 64-column tiles after that.
ROUTE_Q = (63, 65, 67, 68, 69, 100, 127, 128, 129, 200, 341)
GRAM_SHAPES = (
    ("G_BB", N_TOAS, 66, True, "main"),
    ("Schur", N_TOAS // 4, 66, True, "main"),
    ("G_BB q64", N_TOAS, 64, True, None),
    ("Schur q64", N_TOAS // 4, 64, True, None),
    ("G_BB small", N_SMALL, 66, False, None),
    ("Schur small", N_SMALL // 4, 66, False, None),
    ("G_BB small q64", N_SMALL, 64, False, None),
    ("Schur small q64", N_SMALL // 4, 64, False, None),
    ("padding", 137, 64, False, None),
    *((f"route q{q}", 3001, q, False, None) for q in ROUTE_Q),
)


def check_gram(gram, dev, path_q):
    """ds32_gram against its plain version and f64 at every shape of
    GRAM_SHAPES and at each path's of `path_q` ({path: q}: G_BB and Schur
    at q columns); the timed ones are returned with their times.

    Times: `ms`, `library_ms` and `plain_ms` are CUDA events around one
    call on an idle card, so they include the launches' host latency;
    `device_ms` (`partials_ms` + `reduce_ms`) and `library_device_ms` are
    device time per call (torch.profiler, every kernel the call
    launches)."""
    shapes = []
    for label, n, q, timed, path in GRAM_SHAPES + tuple(
            (f"{g} {path}", rows, q, True, path)
            for path, q in path_q.items()
            for g, rows in (("G_BB", N_TOAS), ("Schur", N_TOAS // 4))):
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
        by_name = device_ms(lambda: gram.ds32_gram(A),
                            kernels=("ds32_gram_partials", "ds32_gram_reduce"))
        passes = {key: sum(ms for name, ms in by_name.items() if kernel in name)
                  or None
                  for key, kernel in (("partials_ms", "ds32_gram_partials"),
                                      ("reduce_ms", "ds32_gram_reduce"))}
        print(f"  {label}: partials {fmt_ms(passes['partials_ms'])} + reduce "
              f"{fmt_ms(passes['reduce_ms'])} of device time per call "
              f"(torch.profiler, 20 calls)", flush=True)
        if not timed:
            continue
        # the function's work: the upper triangle of a1ᵀa1 and one a1ᵀa2
        # (a2ᵀa1 is its transpose), 2 flops per FFMA
        flops = 2.0 * n * (q * (q + 1) / 2 + q * q)
        nbytes = 8.0 * (n * q + q * q)   # A read once, G written once
        bound_ms = max(flops / F32_FLOPS, nbytes / HBM_BYTES_S) * 1e3
        shapes.append({
            "shape": label, "n": n, "q": q, "path": path,
            "bn": bn, "nb": nb,
            "ms": median_ms(lambda: gram.ds32_gram(A)),
            # the same launch through the torch.library op (the vmap
            # route's dispatch)
            "op_ms": median_ms(lambda: gram._ds32_gram_op(A)),
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
              f" device; {s['op_ms']:.4f} ms through the custom op), plain "
              f"{s['plain_ms']:.4f} ms a call, A.T@A f64 (cuBLAS)"
              f" {s['library_ms']:.4f} ms a call ({fmt_ms(s['library_device_ms'])}"
              f" device), bound {bound_ms:.4f} ms ({s['bound_by']})", flush=True)
    return shapes


def with_dm_data(toas, truth, seed):
    """`toas` with each TOA's wideband DM measurement: ``-pp_dm`` the
    model DM of `truth` plus Gaussian noise at the DMEFAC/DMEQUAD-scaled
    sigma, ``-pp_dme`` SIGMA_DM. The DM is evaluated on the table's
    device."""
    import dataclasses

    from pint_tpu_torch.toas import Flags

    rng = np.random.default_rng(seed)
    base = dataclasses.replace(toas, flags=Flags(
        dict(f, pp_dme=repr(SIGMA_DM)) for f in toas.flags))
    dm = truth.total_dm(base).cpu().numpy()
    scaled = truth.scaled_dm_uncertainty(base).cpu().numpy()
    meas = dm + rng.normal(0.0, 1.0, len(dm)) * scaled
    return dataclasses.replace(toas, flags=Flags(
        dict(f, pp_dm=repr(float(m)), pp_dme=repr(SIGMA_DM))
        for f, m in zip(toas.flags, meas)))


def wb_table(n, seed, device, ephem):
    """A wideband GBT table at two receivers built (not simulated) on
    `device`, its DM flags parsed (what a user's load of a wideband tim
    file does)."""
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    freq, flags = two_receivers(n, rng)
    dms = rng.normal(10.39, 1e-3, n)
    flags = [dict(f, pp_dm=repr(float(m)), pp_dme=repr(SIGMA_DM))
             for f, m in zip(flags, dms)]
    t = build_TOAs_from_arrays(
        DD(mjds, np.zeros(n)), freq_mhz=freq, error_us=1.0, flags=flags,
        obs_names=("gbt",), eph=ephem, device=device)
    t.get_dm_values(), t.get_dm_errors()
    return t


def simulate_wideband(n, seed, device, grid=False):
    """Phase 12's traffic: n GBT TOAs at two receivers simulated from
    PAR_J1909_WB (simulate_binary's, or on an even grid of epochs that
    puts TOAs in every DMX window) with wideband DM measurements."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    if not grid:
        toas = simulate_binary(PAR_J1909_WB, n, seed, device)
    else:
        rng = np.random.default_rng(seed)
        n_ep = n // 4
        centers = np.linspace(50005.0, 58005.0, n_ep) + rng.uniform(0, 1, n_ep)
        mjds = (centers[:, None]
                + rng.uniform(0, 0.5 / 86400.0, (n_ep, 4))).ravel()
        freq, flags = two_receivers(n, rng)
        toas = make_fake_toas_from_arrays(
            DD(mjds, np.zeros(n)), get_model(PAR_J1909_WB), freq_mhz=freq,
            error_us=1.0, obs="gbt", flags=flags, add_noise=True,
            seed=int(rng.integers(2 ** 31)), niter=2, device=device)
    return with_dm_data(toas, get_model(PAR_J1909_WB), seed + 1)


def wb_host_loop(model, toas, maxiter=10):
    """``downhill_iterate`` over the cached wideband step/probe pair that
    ``dense_wideband_fit`` runs, on the same bucketed table and statics:
    the fused loop's witness. Returns a run_fit-like record."""
    from pint_tpu_torch.fitting import damped, device_loop, wideband
    from pint_tpu_torch.telemetry import recorder

    dev = toas.device
    toas_b, noise, dm, specs = device_loop.dense_wb_operands(model, toas)
    s = wideband.cached_wb_step(model, pl_specs=specs, device=dev)
    p = wideband.cached_wb_probe(model, pl_specs=specs, device=dev)
    base = model.base_dd(dev)
    counters = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deltas, _, chi2, conv = damped.downhill_iterate(
        lambda d: s(base, d, toas_b, noise, dm), model.zero_deltas(device=dev),
        maxiter=maxiter, chi2_at=lambda d: p(base, d, toas_b, noise, dm),
        counters=counters)
    torch.cuda.synchronize()
    trace = recorder.last_trace()
    return {"chi2": chi2, "wall": time.perf_counter() - t0, "steps": trace["n"],
            "probes": counters["probe_evals"], "trace": trace,
            "counters": {k: counters[k] for k in LOOP_COUNTERS}, "stats": {},
            "launches": 0, "converged": conv,
            "deltas": {k: float(v) for k, v in deltas.items()}}


def wb_fused(model, toas, maxiter=10):
    """One ``dense_wideband_fit`` of `model` on `toas`, as a record."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.ops import gram
    from pint_tpu_torch.telemetry import recorder

    stats = {}
    before = gram.ds32_gram.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deltas, _, chi2, conv, counters = device_loop.dense_wideband_fit(
        toas, model, maxiter=maxiter, stats=stats)
    torch.cuda.synchronize()
    trace = recorder.last_trace()
    return {"chi2": chi2, "wall": time.perf_counter() - t0, "steps": trace["n"],
            "probes": counters["probe_evals"], "trace": trace,
            "counters": {k: counters[k] for k in LOOP_COUNTERS}, "stats": stats,
            "launches": gram.ds32_gram.launches - before, "converged": conv,
            "deltas": {k: float(v) for k, v in deltas.items()}}


def wideband_path(dev):
    """Phase 12 (see the module docstring). Returns its ds32_gram launches
    by fit."""
    from pint_tpu_torch.fitting import Fitter, device_loop
    from pint_tpu_torch.fitting.wideband import WidebandDownhillFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram

    gram.ds32_gram.launches = 0
    truth = get_model(PAR_J1909_WB)
    print("components: " + ", ".join(type(c).__name__ for c in truth.components)
          + f"; {len(truth.free_params)} free parameters", flush=True)
    t0 = time.perf_counter()
    toas = simulate_wideband(N_TOAS, seed=12, device=dev)
    torch.cuda.synchronize()
    print(f"simulated {len(toas)} wideband GBT TOAs at Rcvr_800 and Rcvr1_2 on "
          f"the card (DM measurements included) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    build_ms = host_ms(lambda: wb_table(N_TOAS, 12, dev, truth.ephem), reps=3)
    print(f"one {N_TOAS}-row wideband GBT table build at two receivers on the "
          f"card, -pp_dm/-pp_dme parsed (warm): {build_ms:.2f} ms wall",
          flush=True)

    # the user's route: Fitter.auto picks the wideband Downhill fitter;
    # the warm fit is the same fitter again from the truth
    def restart():
        for k in truth.free_params:
            fitter.model[k].value = truth[k].value

    fitter = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fitter is None:
            fitter = Fitter.auto(toas, get_model(PAR_J1909_WB))
        else:
            restart()
        trials = record_trials(fitter)
        chi2 = fitter.fit_toas(maxiter=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        del fitter._chi2_now   # the class method again
        red = fitter.resids.reduced_chi2
        print(f"Fitter.auto ({run}): {type(fitter).__name__}; {wall:.3f} s wall"
              f"{' (construction + fit_toas)' if run == 'cold' else ''}; "
              f"{len(trials)} trials; stacked chi2 {chi2:.6f}, chi2/dof "
              f"{red:.6f} (dof {fitter.resids.dof}); converged "
              f"{fitter.converged}; peak memory {peak_mb:.1f} MiB", flush=True)
        if type(fitter) is not WidebandDownhillFitter:
            fail(f"Fitter.auto picked {type(fitter).__name__} for wideband TOAs")
        if not 0.8 <= red <= 1.25:
            fail(f"wideband fit: stacked chi2/dof {red} outside [0.8, 1.25]")
    for k in ("F0", "PB", "A1", "FD1", "JUMP1", "DMJUMP1", "DMX_0001",
              "DMX_0134", "DMX_0267"):
        print(f"  {k} = {fitter.model[k].format_value()} +- "
              f"{fitter.model[k].format_uncertainty()}")
    check_truth(fitter, truth, f"the wideband fit at {N_TOAS} TOAs", kicks={})
    print(fitter.get_summary().splitlines()[-1], flush=True)

    def warm_fit():
        restart()
        fitter.fit_toas(maxiter=10)

    profile_step("one warm WidebandDownhillFitter fit", warm_fit, wall * 1e3)

    # the fused dense fit, cold and warm, the host loop its witness
    device_loop.clear_cache()
    model = get_model(PAR_J1909_WB)
    torch.cuda.reset_peak_memory_stats()
    cold = wb_fused(model, toas)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    warm = wb_fused(model, toas)
    host = wb_host_loop(model, toas)
    describe_fit(f"dense_wideband_fit at {N_TOAS} TOAs (cold, with capture)", cold)
    describe_fit(f"dense_wideband_fit at {N_TOAS} TOAs (warm)", warm)
    describe_fit(f"dense_wideband_fit's step/probe through the host loop", host)
    gap = max(abs(x - y) / abs(y) for x, y in zip(cold["trace"]["chi2"],
                                                   host["trace"]["chi2"]))
    print(f"  peak memory {peak_mb:.1f} MiB (graph pool included); fused - "
          f"host loop chi2 {cold['chi2'] - host['chi2']:+.3e}, largest relative "
          f"gap of a full evaluation's chi2 {gap:.3e} (bar {LOOP_RTOL:g})",
          flush=True)
    st = cold["stats"]
    if not (st["captures"] == 2 and warm["stats"]["captures"] == 0
            and cold["converged"] and math.isfinite(cold["chi2"])
            and st["replays"] == cold["steps"] + cold["probes"] - 1
            and same_loop(cold, warm) and same_loop(cold, host)
            and all(cold["deltas"][k] == host["deltas"][k] for k in host["deltas"])):
        fail("dense_wideband_fit is not its host loop")
    fused_ms = host_ms(lambda: wb_fused(model, toas), reps=3)
    host_loop_ms = host_ms(lambda: wb_host_loop(model, toas), reps=3)
    print(f"one warm dense_wideband_fit: {fused_ms:.2f} ms wall; its step/probe "
          f"through the host loop: {host_loop_ms:.2f} ms (median of 3)",
          flush=True)
    profile_step("one warm dense_wideband_fit", lambda: wb_fused(model, toas),
                 fused_ms)
    profile_step("one warm host-loop wideband fit",
                 lambda: wb_host_loop(model, toas), host_loop_ms)
    # a kicked start: the captured loop from there is the host loop's
    for k, d in WB_KICK.items():
        model[k].add_delta(d)
    moved, hmoved = wb_fused(model, toas), wb_host_loop(model, toas)
    describe_fit("dense_wideband_fit from a kicked start (replayed)", moved)
    describe_fit("the host loop from the kicked start", hmoved)
    if not (moved["stats"]["captures"] == 0 and same_loop(moved, hmoved)
            and all(moved["deltas"][k] == hmoved["deltas"][k]
                    for k in hmoved["deltas"])):
        fail("the captured wideband fit from a kicked start is not the host loop's")
    launches = {f"wideband {N_TOAS} (Fitter.auto, fused dense fits, host loop)":
                gram.ds32_gram.launches}
    device_loop.clear_cache()

    # card against CPU at N_SMALL TOAs (every DMX window holds TOAs)
    small = simulate_wideband(N_SMALL, seed=13, device="cpu", grid=True)
    runs = []
    for table in (small, small.to(dev)):
        f = WidebandDownhillFitter(table, get_model(PAR_J1909_WB))
        tr = record_trials(f)
        runs.append((f, f.fit_toas(maxiter=10), tr,
                     wb_fused(get_model(PAR_J1909_WB), table)))
    (fc, cc, tc, dc), (fg, cg, tg, dg) = runs
    worst = max(abs(fc.model[k].value_f64 - fg.model[k].value_f64)
                / fc.model[k].uncertainty for k in fc.fit_params)
    print(f"WidebandDownhillFitter at {N_SMALL} TOAs: chi2 cpu {cc:.9f} card "
          f"{cg:.9f}; worst parameter gap {worst:.3e} sigma; trials cpu "
          f"{len(tc)} card {len(tg)}; converged {fc.converged}/{fg.converged}\n"
          f"  trials cpu {tc}\n  trials card {tg}", flush=True)
    if not (same_trials(tc, tg) and abs(cg - cc) <= CARD_CHI2_RTOL * abs(cc)
            and worst <= CARD_VALUE_SIGMA and fc.converged == fg.converged):
        fail("the wideband fit on the card disagrees with the CPU's")
    dworst = max(abs(dc["deltas"][k] - dg["deltas"][k]) / fc.model[k].uncertainty
                 for k in dc["deltas"])
    print(f"dense_wideband_fit at {N_SMALL} TOAs: chi2 cpu {dc['chi2']:.9f} card "
          f"{dg['chi2']:.9f}; worst delta gap {dworst:.3e} sigma; steps "
          f"{dc['steps']}/{dg['steps']}, probes {dc['probes']}/{dg['probes']}; "
          f"converged {dc['converged']}/{dg['converged']}", flush=True)
    if not (dc["converged"] == dg["converged"] and dworst < 0.05
            and abs(dg["chi2"] - dc["chi2"]) <= 1e-6 * abs(dc["chi2"])):
        fail("dense_wideband_fit on the card disagrees with the CPU's")
    if gram.ds32_gram.launches:
        fail(f"the wideband path launched ds32_gram {gram.ds32_gram.launches} "
             "times; its solves are float64")
    return launches


def analytic_posfn_km(eph, body):
    """km positions of `body` wrt the SSB (or the Earth wrt the EMB) from
    the analytic ephemeris on the CPU, as a function of ET seconds."""
    from pint_tpu_torch.io import bsp

    def at(name, et):
        t = torch.as_tensor(bsp.ET_J2000_MJD + np.asarray(et) / 86400.0)
        return eph.planet_posvel_ssb(name, t)[0].numpy() * bsp.C_KM_S

    if body == "earth":
        return lambda et: at("earth", et) - at("emb", et)
    return lambda et: at(body, et)


def write_spk(path):
    """The synthetic DE-layout kernel of SPK_BODIES, fitted to the
    analytic ephemeris over SPK_MJD by the port's own writer."""
    from pint_tpu_torch.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.io import bsp

    eph = AnalyticEphemeris()
    et0, et1 = ((m - bsp.ET_J2000_MJD) * 86400.0 for m in SPK_MJD)
    segs = [bsp.chebyshev_fit_segment(analytic_posfn_km(eph, body), et0, et1,
                                      days * 86400.0, SPK_NCOEF, target, center)
            for body, target, center, days in SPK_BODIES]
    bsp.write_spk_type2(str(path), segs)


@contextlib.contextmanager
def analytic_fallback():
    """Neither ``PINT_TORCH_EPHEM_DIR`` nor ``PINT_TORCH_STRICT_EPHEM``
    inside the block (restored after it): a DE name with no kernel in the
    working directory resolves to the analytic ephemeris, as it does for
    a user who has no ``.bsp``."""
    import os

    names = ("PINT_TORCH_EPHEM_DIR", "PINT_TORCH_STRICT_EPHEM")
    saved = {k: os.environ.pop(k) for k in names if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


@contextlib.contextmanager
def strict_kernels(directory):
    """``PINT_TORCH_EPHEM_DIR`` = `directory` and
    ``PINT_TORCH_STRICT_EPHEM=1`` inside the block: a DE name resolves to
    the kernel there or raises, never to the analytic fallback."""
    import os

    os.environ["PINT_TORCH_EPHEM_DIR"] = str(directory)
    os.environ["PINT_TORCH_STRICT_EPHEM"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PINT_TORCH_EPHEM_DIR", None)
        os.environ.pop("PINT_TORCH_STRICT_EPHEM", None)


def spk_path(dev, work):
    """Phase 13 (see the module docstring): the kernel is written to
    `work` as de421.bsp (phase 14 reads it too). Returns ds32_gram
    launches by run."""
    import os

    from pint_tpu_torch import ephemeris
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.io import bsp
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    t0 = time.perf_counter()
    write_spk(work / "de421.bsp")
    print(f"wrote a type-2 SPK kernel ({len(SPK_BODIES)} segments, MJD "
          f"{SPK_MJD[0]:.0f}-{SPK_MJD[1]:.0f}, {SPK_NCOEF} coefficients) in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{(work / 'de421.bsp').stat().st_size / 2 ** 20:.1f} MiB", flush=True)
    # the Chebyshev fit's own error, measured on the CPU first: the bar
    # of the card's SPK build against its analytic build
    spk = bsp.SPKEphemeris(str(work / "de421.bsp"), name="DE421")
    ana = ephemeris.AnalyticEphemeris()
    t = torch.as_tensor(np.random.default_rng(13).uniform(
        SPK_MJD[0] + 1.0, SPK_MJD[1] - 1.0, 20_000))
    fit_err = {}
    for body in ("earth", "sun", "jupiter", "venus"):
        (ps, vs), (pa, va) = (e.planet_posvel_ssb(body, t) for e in (spk, ana))
        fit_err[body] = (float((ps - pa).abs().max()), float((vs - va).abs().max()))
    pos_err = max(p for p, _ in fit_err.values())
    vel_err = max(v for _, v in fit_err.values())
    print("the kernel against its source on the CPU (20,000 times): "
          + ", ".join(f"{b} {p:.3e} lt-s, {v:.3e} c" for b, (p, v) in fit_err.items()),
          flush=True)
    launches = {}
    with strict_kernels(work):
        eph = ephemeris.get_ephemeris("DE421")
        print(f'get_ephemeris("DE421") -> {type(eph).__name__} {eph.name}',
              flush=True)
        if type(eph) is not bsp.SPKEphemeris or \
                ephemeris.get_ephemeris("DE421") is not eph:
            fail("get_ephemeris did not return one interned SPKEphemeris")
        before = gram.ds32_gram.launches
        card = gbt_table(N_TOAS, 0, dev, eph)
        build_ms = host_ms(lambda: gbt_table(N_TOAS, 0, dev, eph), reps=3)
        print(f"one {N_TOAS}-row GBT table built through the SPK kernel on the "
              f"card (warm): {build_ms:.2f} ms wall", flush=True)
        profile_step("one table build through the SPK kernel",
                     lambda: gbt_table(N_TOAS, 0, dev, eph), build_ms)
        ana_card = gbt_table(N_TOAS, 0, dev, ana)
        gaps = {"obs_pos_ls": float((card.obs_pos_ls - ana_card.obs_pos_ls).abs().max()),
                "obs_vel_c": float((card.obs_vel_c - ana_card.obs_vel_c).abs().max()),
                "sun": float((card.planet_pos_ls["sun"]
                              - ana_card.planet_pos_ls["sun"]).abs().max()),
                "tdb_s": float(((card.tdb.hi - ana_card.tdb.hi) * 86400.0
                                + (card.tdb.lo - ana_card.tdb.lo) * 86400.0).abs().max())}
        vel_bar = 2 * vel_err + PATH_VEL_C
        print(f"  SPK build - analytic build on the card: {gaps} (bars: "
              f"positions 2 x {pos_err:.3e} lt-s, velocities 2 x {vel_err:.3e} + "
              f"{PATH_VEL_C:g} = {vel_bar:.3e}, TDB {TDB_BAR_S:g} s)", flush=True)
        if not (gaps["obs_pos_ls"] <= 2 * pos_err and gaps["sun"] <= 2 * pos_err
                and gaps["obs_vel_c"] <= vel_bar and gaps["tdb_s"] <= TDB_BAR_S):
            fail("the SPK build is not the analytic build within the fit's error")
        small_card = gbt_table(N_SMALL, 2, dev, eph)
        small_cpu = gbt_table(N_SMALL, 2, "cpu", eph)
        cols = {"tdb_s": (float(((small_card.tdb.hi.cpu() - small_cpu.tdb.hi) * 86400.0
                                 + (small_card.tdb.lo.cpu() - small_cpu.tdb.lo)
                                 * 86400.0).abs().max()), TDB_BAR_S),
                "obs_pos_ls": (float((small_card.obs_pos_ls.cpu()
                                      - small_cpu.obs_pos_ls).abs().max()), POS_BAR_LS),
                "obs_vel_c": (float((small_card.obs_vel_c.cpu()
                                     - small_cpu.obs_vel_c).abs().max()), VEL_BAR),
                **{f"planet_pos_ls[{k}]": (float((small_card.planet_pos_ls[k].cpu()
                                                  - v).abs().max()), POS_BAR_LS)
                   for k, v in small_cpu.planet_pos_ls.items()}}
        print(f"  {N_SMALL} rows through the kernel, card - CPU: "
              + ", ".join(f"{k} {g:.3e} (bar {b:g})" for k, (g, b) in cols.items()),
              flush=True)
        if any(g > b for g, b in cols.values()):
            fail("the card's SPK build differs from the CPU's")
        launches["SPK table builds"] = gram.ds32_gram.launches - before
        # bench.py's par through the kernel: its TZR row and its TOAs
        model = get_model(PAR_FULL)
        toas = simulate(PAR_FULL, N_TOAS, seed=0, device=dev)
        if toas.ephem_name != "DE421":
            fail(f"the main path's table used {toas.ephem_name}")
        fitter = HybridGLSFitter(toas, model, device=dev)
        start = free_values(model)
        cold = run_fit(fitter)
        warm = run_fit(fitter, start)
        describe_fit("bench.py's fit through the SPK kernel (cold, fused)", cold)
        describe_fit("bench.py's fit through the SPK kernel (warm, fused)", warm)
        red = fitter.resids.reduced_chi2
        print(f"  post-fit chi2/dof {red:.6f}", flush=True)
        if not (cold["converged"] and 0.8 <= red <= 1.25 and same_loop(cold, warm)):
            fail("the fit through the SPK kernel failed")
        check_truth(fitter, get_model(PAR_FULL),
                    f"the fit through the SPK kernel at {N_TOAS} TOAs", kicks={})
        launches[f"SPK: bench.py's fit {N_TOAS} (fused, warm)"] = warm["launches"]
        # refusals: a missing kernel under the strict switch, and a time
        # outside coverage before anything runs on the card
        os.environ["PINT_TORCH_EPHEM_DIR"] = str(work / "missing")
        try:
            ephemeris.get_ephemeris("DE440")
        except FileNotFoundError as exc:
            print(f"  strict switch, no de440.bsp: FileNotFoundError ({exc})")
        else:
            fail("a missing kernel under PINT_TORCH_STRICT_EPHEM=1 did not raise")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            try:
                build_TOAs_from_arrays(DD(np.asarray([59000.0, 59001.0]), np.zeros(2)),
                                       freq_mhz=1400.0, error_us=1.0,
                                       obs_names=("gbt",), eph=eph, device=dev)
            except ValueError as exc:
                refused = str(exc)
            else:
                refused = None
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        print(f"  MJD 59000 outside coverage: ValueError ({refused}); kernels on "
              f"the card before it: {kernels}", flush=True)
        if refused is None or "coverage" not in refused or kernels:
            fail("a time outside the kernel's coverage was not refused before "
                 "any launch")
    return launches


def draw_phases(n, rng, weights=None):
    """Photon phases from the two-peak template PEAKS by composition; a
    photon with weight w is the pulsar's with probability w (the rest
    are uniform background)."""
    pulsar = np.ones(n, bool) if weights is None else rng.random(n) < weights
    u = rng.random(n)
    c1 = PEAKS["norms"][0]
    c2 = c1 + PEAKS["norms"][1]
    phases = rng.random(n)
    for k, (lo, hi) in enumerate(((0.0, c1), (c1, c2))):
        sel = pulsar & (u >= lo) & (u < hi)
        phases[sel] = (PEAKS["locs"][k] + PEAKS["widths"][k]
                       * rng.standard_normal(int(sel.sum()))) % 1.0
    return phases


def write_photons(path, mission, met0, span_s, seed, dev, header, orbit=None,
                  weights=False):
    """N_EVENTS photons whose model phases (PAR_PHOTON) follow PEAKS: MET
    drawn uniformly over the span, then moved twice onto the drawn
    phases through the port's own load and phase on the card (the
    simulation's fixed-point inversion). Returns the drawn phases."""
    from pint_tpu_torch import event_toas, templates
    from pint_tpu_torch.io.fits import write_event_fits
    from pint_tpu_torch.models import get_model

    rng = np.random.default_rng(seed)
    model = get_model(PAR_PHOTON)
    w = np.clip(rng.random(N_EVENTS), 0.05, 1.0) if weights else None
    target = draw_phases(N_EVENTS, rng, w)
    met = np.sort(rng.uniform(met0, met0 + span_s, N_EVENTS))
    cols = {"TIME": met}
    if mission == "nicer":
        cols["PI"] = rng.integers(30, 1000, N_EVENTS).astype(np.int32)
    if w is not None:
        cols["WEIGHT"] = w
    for _ in range(3):
        write_event_fits(str(path), cols, header=header)
        toas = event_toas.load_event_TOAs(str(path), mission, orbfile=orbit,
                                          ephem=model.ephem, device=dev)
        phi = templates.photon_phases(model, toas).cpu().numpy()
        cols["TIME"] = cols["TIME"] + ((target - phi + 0.5) % 1.0 - 0.5) / PHOTON_F0
    write_event_fits(str(path), cols, header=header)
    return target, cols


def photon_path(dev, kernels, work):
    """Phase 14 (see the module docstring), through phase 13's kernel in
    `kernels` (PAR_PHOTON's EPHEM DE421) under the strict switch: photon
    timing barycenters with a JPL ephemeris. The event files stay in
    `work` for phase 15."""
    with strict_kernels(kernels):
        return photon_events(dev, work)


def photon_events(dev, work):
    from pint_tpu_torch import event_toas, templates
    from pint_tpu_torch.io.fits import write_event_fits
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram

    before = gram.ds32_gram.launches
    # a LEO orbit (ISS-like: r 6,790 km, 92.6 min, inclined 51.6 deg),
    # sampled every 2 s in km
    mjdrefi, mjdreff = 56658, 7.775925925925930e-4   # NICER's epoch
    met0 = (58000.0 - mjdrefi - mjdreff) * 86400.0
    span = 86400.0
    t_orb = np.arange(met0 - 60.0, met0 + span + 60.0, 2.0)
    w_orb, inc = 2 * np.pi / 5556.0, np.radians(51.6)
    r_orb = 6.79e6 * np.stack([np.cos(w_orb * t_orb),
                               np.sin(w_orb * t_orb) * np.cos(inc),
                               np.sin(w_orb * t_orb) * np.sin(inc)], axis=1)
    orbit = str(work / "orbit.fits")
    write_event_fits(orbit, {"TIME": t_orb, "POSITION": r_orb / 1e3},
                     header={"MJDREFI": mjdrefi, "MJDREFF": mjdreff,
                             "TUNIT2": "km"}, extname="ORBIT")
    files = {
        "NICER-like (TT, LOCAL, orbit file)": dict(
            mission="nicer", met0=met0, span_s=span, seed=14, orbit=orbit,
            header={"MJDREFI": mjdrefi, "MJDREFF": mjdreff, "TIMEZERO": 0.0,
                    "TIMESYS": "TT", "TIMEREF": "LOCAL", "TELESCOP": "NICER"}),
        "Fermi-like (TDB, barycentered, WEIGHT)": dict(
            mission="fermi", met0=0.0, span_s=30 * 86400.0, seed=15,
            weights=True,
            header={"MJDREF": 53750.0, "TIMESYS": "TDB",
                    "TIMEREF": "SOLARSYSTEM", "TELESCOP": "GLAST"}),
    }
    model = get_model(PAR_PHOTON)
    for label, spec in files.items():
        path = work / f"{spec['mission']}.fits"
        t0 = time.perf_counter()
        target, cols = write_photons(path, dev=dev, **spec)
        print(f"{label}: drew {N_EVENTS} photons and moved them onto their "
              f"phases (3 loads on the card) in {time.perf_counter() - t0:.2f} s",
              flush=True)
        kw = dict(orbfile=spec.get("orbit"), ephem=model.ephem,
                  weight_column="WEIGHT" if spec.get("weights") else None)
        load_ms = host_ms(lambda: event_toas.load_event_TOAs(
            str(path), spec["mission"], device=dev, **kw), reps=3)
        toas = event_toas.load_event_TOAs(str(path), spec["mission"], device=dev, **kw)
        w = toas.aux_columns.get("photon_weight")
        phase_ms = host_ms(lambda: templates.photon_phases(model, toas), reps=3)
        phases = templates.photon_phases(model, toas)
        h_ms = host_ms(lambda: templates.h_test(phases, w), reps=3)
        h, prob = templates.h_test(phases, w)
        gap = float(np.max(np.abs((phases.cpu().numpy() - target + 0.5) % 1.0 - 0.5)))
        start = templates.LCTemplate(**PEAKS_START)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted, lnl = templates.fit_template(phases, start, weights=w)
        fit_s = time.perf_counter() - t0
        if toas.ephem_name != "DE421":
            fail(f"{label}: barycentered with {toas.ephem_name}, not the kernel")
        print(f"  load_event_TOAs {load_ms:.2f} ms (ephemeris {toas.ephem_name}), "
              f"photon_phases {phase_ms:.2f} "
              f"ms, h_test {h_ms:.2f} ms (warm, median of 3); fit_template "
              f"(1000 Adam steps) {fit_s:.3f} s; H = {h:.1f} (P {prob:.3g}); "
              f"model phases - drawn phases: max {gap:.3e} turns", flush=True)
        print(f"  fitted peaks: locs {fitted.locs}, widths {fitted.widths}, norms "
              f"{fitted.norms} (injected {PEAKS}); log-likelihood {lnl:.3f}",
              flush=True)
        load_spans(path, dev)
        if not (len(toas) == N_EVENTS and h > 1000.0 and gap < GEN_PHASE_BAR
                and np.all(np.abs(fitted.locs - PEAKS["locs"]) < PEAK_LOC_BAR)
                and np.all(np.abs(fitted.widths / PEAKS["widths"] - 1)
                           < PEAK_WIDTH_RTOL)):
            fail(f"{label}: the photon path did not recover the injected template")
        # card against CPU on a subset
        sub = work / f"{spec['mission']}_subset.fits"
        write_event_fits(str(sub), {k: v[:N_EVENT_SUBSET] for k, v in cols.items()},
                         header=spec["header"])
        out = []
        for d in ("cpu", dev):
            t = event_toas.load_event_TOAs(str(sub), spec["mission"], device=d, **kw)
            ph = templates.photon_phases(model, t)
            out.append((ph.cpu().numpy(),
                        templates.h_test(ph, t.aux_columns.get("photon_weight"))[0]))
        (pc, hc), (pg, hg) = out
        dphi = float(np.max(np.abs((pg - pc + 0.5) % 1.0 - 0.5)))
        print(f"  {N_EVENT_SUBSET} events card - CPU: phases {dphi:.3e} turns "
              f"(bar {PHOTON_PHASE_BAR:.3e}), H {hg:.6f} / {hc:.6f} "
              f"({abs(hg / hc - 1):.3e}, bar {H_RTOL:g})", flush=True)
        if not (dphi <= PHOTON_PHASE_BAR and abs(hg / hc - 1) <= H_RTOL):
            fail(f"{label}: the card's photon phases differ from the CPU's")
        if spec.get("orbit"):
            analytic_subset(label, sub, spec["mission"], kw, model, dev)
    if gram.ds32_gram.launches != before:
        fail("the photon path launched ds32_gram")
    return {"photon events (loads, phases, H-test, template fits)":
            gram.ds32_gram.launches - before}


def load_spans(path, dev):
    """Where a load's host time goes: the FITS read, and the event MJDs
    in DD (with the TT -> UTC inversion for TT events) on the card,
    fetched to the host as the table builder fetches them, against the
    same arithmetic on the CPU. Medians of 3."""
    from pint_tpu_torch import event_toas
    from pint_tpu_torch.io.fits import read_fits

    read_ms = host_ms(lambda: read_fits(str(path)), reps=3)
    f = read_fits(str(path))
    tab = f.table("EVENTS")
    met = np.asarray(tab["TIME"], dtype=np.float64)
    refi, reff = event_toas._mjdref_days(tab.header, f.primary_header)
    tt = str(tab.header.get("TIMESYS", f.primary_header.get("TIMESYS", ""))
             ).strip().upper() == "TT"

    def mjds(d):
        m = event_toas._event_mjd(met, refi, reff, d)
        m = event_toas._tt_to_utc(m) if tt else m
        return m.hi.cpu(), m.lo.cpu()

    card_ms = host_ms(lambda: mjds(dev), reps=3)
    cpu_ms = host_ms(lambda: mjds("cpu"), reps=3)
    (hg, lg), (hc, lc) = mjds(dev), mjds("cpu")
    if not (torch.equal(hg, hc) and torch.equal(lg, lc)):
        fail(f"{path.name}: the card's event MJDs differ from the CPU's")
    print(f"  load spans: FITS read {read_ms:.2f} ms; event MJDs in DD"
          f"{' and TT -> UTC' if tt else ''}: on the card {card_ms:.2f} ms "
          f"(fetched), on the CPU {cpu_ms:.2f} ms; equal bit for bit",
          flush=True)


def analytic_subset(label, sub, mission, kw, model, dev):
    """The subset `sub` through the analytic ephemeris, card against CPU.

    The analytic series' sin/cos/atan2 part the card's positions from the
    CPU's by ~1.7e-13 lt-s (phase 5, within its POS_BAR_LS). A position
    gap dr moves the Roemer delay, r . n_psr, by at most |dr|; the rest
    of the path is held to PHOTON_TIME_BAR_S through the kernel above.
    So the positions are held to phase 5's bar and the phases to F0 x
    (PHOTON_TIME_BAR_S + the measured max |dr|) in turns. The TZR anchor
    is each device's cached row from the kernel's run above."""
    from pint_tpu_torch import event_toas, templates

    with analytic_fallback():
        out = []
        for d in ("cpu", dev):
            t = event_toas.load_event_TOAs(str(sub), mission, device=d, **kw)
            out.append((t, templates.photon_phases(model, t).cpu().numpy()))
    (tc, pc), (tg, pg) = out
    if tg.ephem_name == "DE421" or tc.ephem_name == "DE421":
        fail(f"{label}: the analytic subset was built through a kernel")
    pos_gap = float((tg.obs_pos_ls.cpu() - tc.obs_pos_ls).norm(dim=-1).max())
    dphi = float(np.max(np.abs((pg - pc + 0.5) % 1.0 - 0.5)))
    bar = PHOTON_F0 * (PHOTON_TIME_BAR_S + pos_gap)
    print(f"  {len(tg)} events, analytic ephemeris ({tg.ephem_name}), "
          f"card - CPU: positions {pos_gap:.3e} lt-s (bar {POS_BAR_LS:g}), "
          f"phases {dphi:.3e} turns (bar F0 x ({PHOTON_TIME_BAR_S:g} s + "
          f"{pos_gap:.3e} lt-s) = {bar:.3e})", flush=True)
    if not (pos_gap <= POS_BAR_LS and dphi <= bar):
        fail(f"{label}: through the analytic ephemeris the card's photon "
             "phases differ from the CPU's by more than their positions do")


# Phase 15: analysis and the command line. The grids span +-GRID_SIGMA of
# their fit's F0/F1 uncertainties; the minimum must be the fit's node
# (the centre, within one grid step) and chi2 there the fit's within
# GRID_CHI2_RTOL (the DownhillWLS/GLS fitters return chi2 at their values;
# GLSFitter's return is its last solve's linearized prediction, 5e-6
# below that at 2,000 TOAs on the CPU, so the grids are held to the
# damped fitters)
GRID_WHITE = 32
GRID_GLS = 16
GRID_SIGMA = 3.0
GRID_CHI2_RTOL = 1e-6
# pintempo's post-fit values against phase 6's fit of the same table
PINTEMPO_SIGMA = 1e-3
# MCMCFitter at N_MCMC TOAs (bench.py's par without ECORR): the posterior
# against the damped GLS fit of the same table
PAR_MCMC = PAR_FULL.replace("ECORR 1.2\n", "")
N_MCMC = 10_000
MCMC_STEPS = 500
MCMC_MEAN_SIGMA = 0.5
MCMC_STD_RTOL = 0.3
# event_optimize: the Fermi-like file's first N_OPT events; the par's F0
# is kicked by OPT_KICK Hz with uncertainty OPT_UNC (its default prior is
# +-10 x that), and the best sample must lie within OPT_SIGMA posterior
# sigma of the truth
N_OPT = 100_000
OPT_STEPS = 250
OPT_KICK = 1.5e-9
OPT_UNC = 1e-9
OPT_SIGMA = 5.0
# polycos: one day at GBT, the reference test's bar against the model
POLYCO_MJD = 55000.0
POLYCO_BAR = 1e-7
N_POLYCO_EVAL = 1_000_000
# calculate_random_models: draws over phase 6's table; a 2,000-row
# subset card against CPU
N_RANDOM = 100
RANDOM_BAR = 1e-9


def fit_state(fitter, chi2):
    """A fit's values (exact (hi, lo) pairs), uncertainties, chi2 and
    covariance, kept after the fitter is freed."""
    m = fitter.model
    return {"values": {k: m[k].value for k in fitter.fit_params},
            "unc": {k: m[k].uncertainty for k in fitter.fit_params},
            "chi2": float(chi2), "fit_params": list(fitter.fit_params),
            "cov": fitter.parameter_covariance_matrix}


def model_at(par, state):
    """get_model(par) carrying a fit_state's values and uncertainties."""
    from pint_tpu_torch.models import get_model

    m = get_model(par)
    for k, v in state["values"].items():
        m[k].value = v
        m[k].uncertainty = state["unc"][k]
    return m


def run_tool(main, argv):
    """A console tool's main(argv) in-process, its stdout captured and
    echoed indented; returns (stdout, wall s)."""
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    if rc != 0:
        fail(f"{main.__module__} {argv} returned {rc}")
    return out, wall


def grid_check(label, toas, par, state, n, gls):
    """grid_chisq over n x n (F0, F1) offsets of +-GRID_SIGMA about a
    fit, every other free parameter re-solved at each node."""
    from pint_tpu_torch import gridutils

    model = model_at(par, state)
    # node n // 2 is the fit; the steps are 2 GRID_SIGMA / n of its sigma
    grids = [(np.arange(n) - n // 2) * (2.0 * GRID_SIGMA / n) * state["unc"][k]
             for k in ("F0", "F1")]
    rest = [k for k in model.free_params if k not in ("F0", "F1")]
    chunk = gridutils.default_chunk_size(len(toas), len(rest))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chi2 = gridutils.grid_chisq(toas, model, ("F0", "F1"), grids, gls=gls)
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    i, j = np.unravel_index(np.argmin(chi2), chi2.shape)
    centre = n // 2
    at_fit = float(chi2[centre, centre])
    rel = abs(at_fit / state["chi2"] - 1)
    print(f"grid_chisq ({label}): {n} x {n} (F0, F1) nodes over +-{GRID_SIGMA:g} "
          f"sigma, {rest} re-solved at each node, {len(toas)} TOAs: "
          f"{wall:.3f} s wall, chunk {chunk} nodes, peak memory {peak_mb:.1f} "
          f"MiB; minimum at node ({i}, {j}) (the fit: {centre}, {centre}); "
          f"chi2 at the fit's node {at_fit:.6f} against the fit's "
          f"{state['chi2']:.6f} ({rel:.3e}, bar {GRID_CHI2_RTOL:g}); grid "
          f"range {chi2.min():.3f}..{chi2.max():.3f}", flush=True)
    if not (np.all(np.isfinite(chi2)) and abs(i - centre) <= 1
            and abs(j - centre) <= 1 and rel <= GRID_CHI2_RTOL):
        fail(f"grid_chisq ({label}) does not have its minimum at the fit")
    return wall


def simulate_mcmc(n, seed, device):
    """n TOAs of bench.py's traffic from its par without ECORR."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    return make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), get_model(PAR_MCMC),
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs="gbt", add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=device)


def mcmc_check(dev):
    """MCMCFitter on N_MCMC TOAs against the damped GLS fit there, with no
    host sync inside the sampler's step loop."""
    from pint_tpu_torch import bayesian, sampler
    from pint_tpu_torch.fitting import DownhillGLSFitter
    from pint_tpu_torch.models import get_model

    toas = simulate_mcmc(N_MCMC, seed=7, device=dev)
    gls = DownhillGLSFitter(toas, get_model(PAR_MCMC))
    gls.fit_toas(maxiter=10)
    state = fit_state(gls, gls.resids.chi2)
    model = model_at(PAR_MCMC, state)
    run_steps = sampler._run_steps

    def no_sync_steps(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_steps(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    sampler._run_steps = no_sync_steps
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = bayesian.MCMCFitter(toas, model, nsteps=MCMC_STEPS, burn_frac=0.25)
        best = f.fit_toas()
        wall = time.perf_counter() - t0
    finally:
        sampler._run_steps = run_steps
    pulls = {k: (model[k].value_f64 - gls.model[k].value_f64) / state["unc"][k]
             for k in f.bt.fit_params}
    ratios = {k: model[k].uncertainty / state["unc"][k] for k in f.bt.fit_params}
    print(f"MCMCFitter: {len(toas)} GBT TOAs (bench.py's par without ECORR, the "
          f"{model.noise_model_dimensions(toas)} red-noise basis marginalized), "
          f"{f.nwalkers} walkers x {MCMC_STEPS} steps (burn 0.25): {wall:.3f} s "
          f"wall, no host sync in the step loop; acceptance "
          f"{f.acceptance.mean():.3f}; best log posterior {best:.3f}; posterior "
          f"mean - GLS (sigma) " + ", ".join(f"{k} {v:+.3f}" for k, v in pulls.items())
          + "; posterior std / GLS uncertainty "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()), flush=True)
    if not (np.isfinite(best)
            and all(abs(v) <= MCMC_MEAN_SIGMA for v in pulls.values())
            and all(abs(v - 1) <= MCMC_STD_RTOL for v in ratios.values())):
        fail("the MCMC posterior disagrees with the GLS fit")
    # where a step's time goes: one vmapped evaluation of a half-ensemble
    lp = torch.func.vmap(f.bt._lnpost)
    half = torch.as_tensor(f.chain[-(f.nwalkers // 2):], device=dev)
    eval_ms = host_ms(lambda: lp(half), reps=5)
    print(f"one vmapped log posterior over {f.nwalkers // 2} walkers: "
          f"{eval_ms:.2f} ms wall (median of 5)", flush=True)
    profile_step(f"one vmapped log posterior ({f.nwalkers // 2} walkers)",
                 lambda: lp(half), eval_ms)
    return wall


def analysis_and_cli(dev, toas, state6, wls_state, dense, gls_state, photons):
    """Phase 15 (see the module docstring). `toas` is phase 6's table and
    `state6` its fit; `wls_state` phase 10's DownhillWLSFitter on it;
    `dense` phase 10's 20,000-TOA table and `gls_state` its
    DownhillGLSFitter fit; `photons` holds phase 14's event files.
    Returns the kernel launches and the directory holding the par and
    tim files, which phase 16 reads and removes."""
    from pint_tpu_torch import event_toas, polycos, simulation
    from pint_tpu_torch.io.fits import read_fits, write_event_fits
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import gram
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.scripts import (event_optimize, photonphase, pintempo,
                                        zima)
    from pint_tpu_torch.toas import build_TOAs_from_arrays, get_TOAs, write_TOA_file

    t_phase = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="cli_"))
    par = work / "bench.par"
    par.write_text(PAR_FULL)
    tim = work / "bench.tim"
    t0 = time.perf_counter()
    write_TOA_file(toas, str(tim))
    print(f"wrote phase 6's {len(toas)} TOAs as {tim.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 1. pintempo --fitter hybrid at the main path's width
    gram.ds32_gram.launches = 0
    out, wall = run_tool(pintempo.main, [str(par), str(tim), "--fitter", "hybrid",
                                         "--outfile", str(work / "post.par")])
    launches = gram.ds32_gram.launches
    read_s = float(re.search(r"Read \d+ TOAs in ([0-9.]+) s", out).group(1))
    fit_s = float(re.search(r"Fitted with \w+ in ([0-9.]+) s", out).group(1))
    print("  " + "\n  ".join(line for line in out.splitlines()
                             if line.startswith(("Read", "Prefit", "  chi2",
                                                 "Fitted", "Wrote"))))
    back = get_TOAs(str(tim), ephem="DE421", device=dev)
    moved = ((back.utc.hi - toas.utc.hi) + (back.utc.lo - toas.utc.lo)) * 86400.0
    rms_sigma = float(torch.sqrt(torch.mean(torch.square(moved / toas.get_errors_s()))))
    post = get_model(str(work / "post.par"))
    gaps = {k: abs(post[k].value_f64 - (state6["values"][k][0]
                                         + state6["values"][k][1])) / state6["unc"][k]
            for k in state6["fit_params"]}
    print(f"pintempo --fitter hybrid: {wall:.3f} s wall (tim parse {read_s:.3f} s, "
          f"fit {fit_s:.3f} s); ds32_gram launches {launches}; the tim round "
          f"trip moves the MJDs by max {float(moved.abs().max()):.3e} s, rms "
          f"{rms_sigma:.3e} of the TOA errors (so each fitted value by "
          f"~{rms_sigma:.1e} sigma); post-fit - phase 6's fit (sigma): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (bar {PINTEMPO_SIGMA:g})", flush=True)
    if launches == 0:
        fail("pintempo --fitter hybrid did not launch ds32_gram")
    if not (rms_sigma <= 0.1 * PINTEMPO_SIGMA
            and max(gaps.values()) <= PINTEMPO_SIGMA):
        fail("pintempo's post-fit values disagree with phase 6's fit")

    # 2-3. the chi2 grids, white at 100,000 TOAs and GLS at 20,000
    grid_check("white, phase 6's table, against DownhillWLSFitter", toas,
               PAR_FULL, wls_state, GRID_WHITE, gls=False)
    grid_check("gls=True, phase 10's table, against DownhillGLSFitter", dense,
               PAR_FULL, gls_state, GRID_GLS, gls=True)

    # 4. MCMCFitter at 10,000 TOAs
    mcmc_check(dev)

    # 5. event_optimize on the Fermi-like file's first N_OPT events,
    # photonphase on the NICER-like file
    f = read_fits(str(photons / "fermi.fits"))
    tab = f.table("EVENTS")
    opt = work / "fermi_opt.fits"
    write_event_fits(str(opt), {k: np.asarray(tab[k])[:N_OPT] for k in ("TIME", "WEIGHT")},
                     header={"MJDREF": 53750.0, "TIMESYS": "TDB",
                             "TIMEREF": "SOLARSYSTEM", "TELESCOP": "GLAST"})
    opt_par = work / "photon.par"
    opt_par.write_text(PAR_PHOTON.replace(
        f"F0             {PHOTON_F0}",
        f"F0             {PHOTON_F0 + OPT_KICK!r} 1 {OPT_UNC:g}"))
    gauss = work / "template.gauss"
    gauss.write_text("# phase width amplitude\n" + "".join(
        f"{loc} {w} {a}\n" for loc, w, a in zip(PEAKS["locs"], PEAKS["widths"],
                                                PEAKS["norms"])))
    out_par = work / "photon_post.par"
    out, opt_wall = run_tool(event_optimize.main, [
        str(opt), str(opt_par), str(gauss), "--mission", "fermi", "--weightcol",
        "WEIGHT", "--nsteps", str(OPT_STEPS), "--outpar", str(out_par)])
    opt_model = get_model(str(out_par))
    pull = (opt_model["F0"].value_f64 - PHOTON_F0) / opt_model["F0"].uncertainty
    print("  " + "\n  ".join(l for l in out.splitlines() if l.startswith(
        ("Photons", "log-posterior", "Htest", "  F0", "Sampled"))))
    print(f"event_optimize: {N_OPT} Fermi-like events, {OPT_STEPS} steps: "
          f"{opt_wall:.3f} s wall; F0 {opt_model['F0'].value_f64!r} +- "
          f"{opt_model['F0'].uncertainty:.3e} from a start {OPT_KICK:g} Hz off: "
          f"{pull:+.3f} sigma from the truth (bar {OPT_SIGMA:g})", flush=True)
    if not abs(pull) <= OPT_SIGMA:
        fail("event_optimize did not recover F0")
    phot_par = work / "photon_truth.par"
    phot_par.write_text(PAR_PHOTON)
    out, pp_wall = run_tool(photonphase.main, [
        str(photons / "nicer.fits"), str(phot_par), "--mission", "nicer",
        "--orbfile", str(photons / "orbit.fits")])
    h = float(re.search(r"Htest\s*:\s*([0-9.]+)", out).group(1))
    print("  " + "\n  ".join(l for l in out.splitlines()
                             if l.startswith(("Photons", "Htest", "Loaded"))))
    print(f"photonphase: the NICER-like file ({N_EVENTS} events, orbit file, "
          f"the analytic ephemeris): {pp_wall:.3f} s wall; H = {h:.1f}",
          flush=True)
    if not h > 1000.0:
        fail("photonphase did not find the pulsations")

    # 6. polycos: one day at GBT from bench.py's par
    model = get_model(PAR_FULL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcs = polycos.Polycos.generate_polycos(
        model, POLYCO_MJD, POLYCO_MJD + 1.0, obs="gbt", segment_length_min=60.0,
        ncoeff=12, freq_mhz=1400.0, device=dev)
    gen_s = time.perf_counter() - t0
    mjds = np.sort(np.random.default_rng(15).uniform(POLYCO_MJD + 1e-4,
                                                     POLYCO_MJD + 1.0 - 1e-4, N_SMALL))
    exact = build_TOAs_from_arrays(DD(mjds, np.zeros(N_SMALL)),
                                   freq_mhz=np.full(N_SMALL, 1400.0),
                                   error_us=np.ones(N_SMALL), obs_names=("gbt",),
                                   eph=model.ephem, device=dev)
    ph = model.phase(exact, abs_phase=True)
    ints, fracs = pcs.eval_abs_phase(mjds)
    gap = float(np.max(np.abs((ints - ph.int_part.cpu().numpy())
                              + (fracs - (ph.frac.hi + ph.frac.lo).cpu().numpy()))))
    many = np.random.default_rng(16).uniform(POLYCO_MJD + 1e-4, POLYCO_MJD + 1.0 - 1e-4,
                                             N_POLYCO_EVAL)
    t0 = time.perf_counter()
    pcs.eval_abs_phase(many)
    eval_s = time.perf_counter() - t0
    print(f"polycos: {len(pcs.entries)} segments of 60 min x 12 coefficients at "
          f"GBT generated in {gen_s:.3f} s (node phases on the card); polyco - "
          f"exact model phase at {N_SMALL} points {gap:.3e} cycles (bar "
          f"{POLYCO_BAR:g}); eval_abs_phase at {N_POLYCO_EVAL} MJDs (host) "
          f"{eval_s:.3f} s", flush=True)
    if not gap <= POLYCO_BAR:
        fail("the polycos disagree with the model's phase")

    # 7. calculate_random_models over phase 6's table
    fitter6 = types.SimpleNamespace(model=model_at(PAR_FULL, state6),
                                    fit_params=state6["fit_params"],
                                    parameter_covariance_matrix=state6["cov"])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spread = simulation.calculate_random_models(fitter6, toas, N_RANDOM, seed=3)
    rm_s = time.perf_counter() - t0
    rm_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    sub = toas.select(np.arange(len(toas)) < N_SMALL)
    card = simulation.calculate_random_models(fitter6, sub, N_RANDOM, seed=3)
    cpu = simulation.calculate_random_models(fitter6, sub.to("cpu"), N_RANDOM, seed=3)
    rm_gap = float(np.max(np.abs(card - cpu)))
    print(f"calculate_random_models: {N_RANDOM} draws x {len(toas)} TOAs in "
          f"{rm_s:.3f} s, peak memory {rm_peak:.1f} MiB; phase spread rms "
          f"{float(np.std(spread)):.3e} cycles; {N_SMALL} rows card - CPU "
          f"{rm_gap:.3e} cycles (bar {RANDOM_BAR:g})", flush=True)
    if not (spread.shape == (N_RANDOM, len(toas)) and np.all(np.isfinite(spread))
            and rm_gap <= RANDOM_BAR):
        fail("calculate_random_models on the card disagrees with the CPU")

    # 8. zima: 100,000 TOAs from bench.py's par
    sim = work / "zima.tim"
    out, zima_wall = run_tool(zima.main, [
        str(par), str(sim), "--ntoa", str(N_TOAS), "--startMJD", "53000",
        "--duration", "3000", "--freq", "1400", "430", "--addnoise", "--seed", "1"])
    t0 = time.perf_counter()
    zt = get_TOAs(str(sim), ephem="DE421", device=dev)
    parse_s = time.perf_counter() - t0
    zr = Residuals(zt, get_model(PAR_FULL), subtract_mean=False)
    rms_us = float(torch.sqrt(torch.mean(torch.square(zr.time_resids)))) * 1e6
    print(f"zima: {N_TOAS} TOAs from bench.py's par: {zima_wall:.3f} s wall "
          f"({out.strip()}); reloaded in {parse_s:.3f} s, residual rms "
          f"{rms_us:.4f} us (1 us white noise)", flush=True)
    if not (len(zt) == N_TOAS and 0.95 < rms_us < 1.05):
        fail("zima's TOAs do not carry the stated noise")
    print(f"phase 15 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {f"pintempo --fitter hybrid, {len(toas)} TOAs": launches}, work


# ----------------------------------------------------------------------
# phase 16: many pulsars (the BASELINE config-4 batch), sharded fits and
# the telemetry artifact
# ----------------------------------------------------------------------

# bench.py's batch problem (bench.py:961-1001): 68 members, each the bench
# par with RA stepped by 5 h and F0 by 0.3 Hz, 8,824 TOAs each: 600,032
N_PSR = 68
N_PER_PSR = 8_824
NOISE_LINES = ("EFAC", "ECORR", "TNREDAMP", "TNREDGAM", "TNREDC")
# members compared with their own single-pulsar fit at the same row bucket
NAMED_MEMBERS = (0, 22, 45, 67)
# a member of the batch against its single-pulsar fused fit: the same
# algebra over the same bucketed rows, but the batch's ECORR block padded
# to the basis bucket and every product batched (other cuBLAS kernels,
# other summation orders): values within 1e-6 sigma, uncertainties 1e-9
# and chi2 1e-9 relative (the CPU rehearsal: ~1e-13 and ~1e-15)
MEMBER_VALUE_SIGMA = 1e-6
MEMBER_RTOL = 1e-9
# the sharded GLS fit (f64 Grams) against phase 6's fit (the ds32 kernel):
# the ds32 conditioning trap moves the uncertainties by ~1e-3 relative
SHARDED_SIGMA = 1e-3
N_CARD_CPU_PSR = 4


def member_par(i, noise=True):
    """Member i of the batch: the bench par with RA stepped by 5 h and F0
    by 0.3 Hz; without its noise lines for the WLS family (bench_batch)."""
    par = PAR_FULL.replace("17:48:52.75", f"{(i * 5) % 24:02d}:48:52.75")
    par = par.replace("61.485476554", f"{61.485476554 + 0.3 * i:.9f}")
    if noise:
        return par
    return "".join(line + "\n" for line in par.splitlines()
                   if line.split()[:1] not in ([k] for k in NOISE_LINES))


def simulate_member(i, n, seed, device):
    """Member i's traffic, as `simulate`'s: n GBT TOAs in 4-TOA epochs at
    1400/430 MHz with stated errors of 1 us, the arrivals timed perfectly
    by its par. Returns (the GLS family's table, the WLS family's): the
    WLS table carries 1 us white noise (the stripped par's); the GLS table
    is the same arrivals shifted by a draw of the rest of the par's noise
    model: white noise to make up its EFAC, one ECORR offset per epoch
    and a power-law red-noise realization over its Fourier basis. Data
    that follow the model make a fit's chi2/dof ~1."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = epoch_mjds(n, rng)
    wls = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), get_model(member_par(i, noise=False)),
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs="gbt", add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=device)
    return with_model_noise(wls, get_model(member_par(i)), rng), wls


def with_model_noise(toas, model, rng):
    """`toas` (arrivals with 1 us white noise) shifted by a draw of the
    rest of `model`'s noise: white noise to make up its EFAC, one ECORR
    offset per epoch and (where it has red noise) a power-law realization
    over its Fourier basis, all from numpy's `rng`."""
    from pint_tpu_torch.fitting.gls_step import build_noise_statics, pl_bases
    from pint_tpu_torch.simulation import _shift_toas

    device, n = toas.device, len(toas)
    efac = model["EFAC1"].value_f64
    noise, specs = build_noise_statics(model, toas)
    phi_e = noise.ecorr_phi.cpu().numpy()
    offsets = np.append(rng.standard_normal(phi_e.shape[0]) * np.sqrt(phi_e), 0.0)
    dt = (torch.as_tensor(offsets[noise.epoch_idx.cpu().numpy()], device=device)
          + torch.as_tensor(rng.standard_normal(n), device=device)
          * (np.sqrt(efac ** 2 - 1.0) * 1e-6))
    F, phi = pl_bases(toas, specs, noise.pl_params)
    if F is not None:
        dt = dt + F @ (torch.sqrt(phi) * torch.as_tensor(
            rng.standard_normal(phi.shape[0]), device=device))
    return _shift_toas(toas, dt / 86400.0)


def dd_sigma(a, b, sigma):
    """|a - b| / sigma for two (hi, lo) values, in double-double."""
    return abs((a[0] - b[0]) + (a[1] - b[1])) / sigma


def run_batched(bf, start, loop="1", maxiter=10):
    """One batched fit of `bf` from `start` (each member's free values)
    through the fused loop (``loop="1"``) or the host loop (``"0"``): its
    chi2 and converged vectors, wall, captures/replays/fetches, counters,
    trace and the fitted values."""
    import os

    from pint_tpu_torch.telemetry import recorder

    for m, values in zip(bf.models, start):
        for k, v in values.items():
            m[k].value = v
    os.environ["PINT_TORCH_DEVICE_LOOP"] = loop
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chi2 = bf.fit_toas(maxiter=maxiter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("PINT_TORCH_DEVICE_LOOP")
    return {"chi2": chi2, "wall": wall, "stats": dict(bf.loop_stats),
            "counters": dict(bf.counters), "converged": bf.converged.copy(),
            "trace": recorder.last_trace(),
            "values": [{k: (m[k].value, m[k].uncertainty)
                        for k in m.free_params} for m in bf.models]}


def member_trials(trace, m):
    """Member m's full evaluations in a batched trace: the init pass and
    every later entry where it ran (a damping factor > 0), as (chi2, lam,
    accepted)."""
    return [(trace["chi2"][j][m], trace["lam"][j][m], trace["accepted"][j][m])
            for j in range(len(trace["chi2"]))
            if j == 0 or trace["lam"][j][m] > 0.0]


def same_member_loops(ta, tb, rtol, floor=None):
    """Every member makes the same decisions in traces `ta` and `tb`: the
    same damping factors and accepts at each full evaluation, every chi2
    within `rtol`. With `floor` (card against CPU) a member's comparison
    ends at its first evaluation resolved by less than `floor` relative
    on either side (the noise floor, where the two may part). Returns
    the members that differ."""
    bad = []
    for m in range(len(ta["chi2"][0])):
        a, b = member_trials(ta, m), member_trials(tb, m)
        kept = a[0][0]
        ok = len(a) == len(b) or floor is not None
        for (ca, la, aa), (cb, lb, ab) in zip(a, b):
            if abs(ca - cb) > rtol * abs(cb):
                ok = False
                break
            if floor is not None and min(abs(ca - kept), abs(cb - kept)) \
                    <= floor * abs(kept):
                break
            if (la, aa) != (lb, ab):
                ok = False
                break
            if aa:
                kept = ca
        else:
            ok = ok and len(a) == len(b)
        if not ok:
            bad.append(m)
    return bad


def batch_family(dev, tables, family):
    """One family (``"gls"``: the bench par's noise; ``"wls"``: stripped)
    of the N_PSR-member batch over `tables`: the fused fit cold and warm,
    the host loop as its witness, the gates, the named members against
    their single-pulsar fits and a profiled warm fit. Returns (the
    fitter, the members' start)."""
    from pint_tpu_torch import bucketing
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import BatchedPulsarFitter

    noise = family == "gls"
    pars = [member_par(i, noise) for i in range(len(tables))]
    models = []
    for par in pars:
        m = get_model(par)
        for k, d in KICK.items():
            m[k].add_delta(d)
        models.append(m)
    start = [free_values(m) for m in models]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf = BatchedPulsarFitter(list(zip(tables, models)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_rows = len(bf.toas)
    print(f"{family} batch: {len(tables)} members, {sum(map(len, tables))} "
          f"TOAs, bucketed to {len(tables)} x {n_rows} rows; family "
          f"{bf.family}, {len(bf.free_params)} fitted names "
          f"{bf.free_params}; ECORR epochs bucketed to {bf.basis_bucket}; "
          f"sigma in the statics {bf._trace_sigma}; construction (stacking, "
          f"statics, TZR tables) {build_s:.3f} s", flush=True)
    cold = run_batched(bf, start)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    warm = run_batched(bf, start)
    host = run_batched(bf, start, loop="0")
    fused_values = cold["values"]
    for label, r in (("cold (capture)", cold), ("warm (replays)", warm),
                     ("host loop (witness)", host)):
        print(f"  {label}: {r['wall']:.4f} s wall; {len(r['trace']['chi2'])} "
              f"full evaluations; loop {r['stats'] or 'host'}; counters "
              f"{r['counters']}", flush=True)
    print(f"  peak memory {peak_mb:.1f} MiB allocated over the cold fit "
          f"(graph pool included)", flush=True)
    st = cold["stats"]
    if not (st["captures"] == 2 and warm["stats"]["captures"] == 0
            and warm["stats"]["replays"] > 0):
        fail(f"the {family} batch did not run as graph replays: {st} / "
             f"{warm['stats']}")
    if not np.array_equal(cold["chi2"], warm["chi2"]) \
            or same_member_loops(cold["trace"], warm["trace"], 0.0):
        fail(f"the warm {family} batch is not the cold one replayed")
    differ = same_member_loops(cold["trace"], host["trace"], LOOP_RTOL)
    gap = float(np.max(np.abs(cold["chi2"] - host["chi2"]) / np.abs(host["chi2"])))
    print(f"  fused - host loop: {len(differ)} members differ in their "
          f"decisions or full-evaluation chi2 (bar {LOOP_RTOL:g}); final "
          f"chi2 largest relative gap {gap:.3e}", flush=True)
    if differ or gap > LOOP_RTOL or not (cold["converged"] == host["converged"]).all():
        fail(f"the fused {family} batch disagrees with its host loop "
             f"(members {differ[:8]})")
    # gates on the fused fit: each member's fit chi2 (GLS: r^T C^-1 r,
    # the noise marginalized) per degree of freedom, and the pulls from
    # the truth
    dof = np.array([len(t) - len(m.free_params) - 1
                    for t, m in zip(tables, models)])
    red = cold["chi2"] / dof
    pulls = []
    for i, (par, values) in enumerate(zip(pars, fused_values)):
        truth = get_model(par)
        for k, (v, unc) in values.items():
            pulls.append((dd_sigma(v, truth[k].value, unc), i, k))
    worst = max(pulls)
    print(f"  chi2/dof over members: min {red.min():.4f}, median "
          f"{np.median(red):.4f}, max {red.max():.4f}; converged "
          f"{int(cold['converged'].sum())}/{len(tables)}; largest pull from "
          f"the truth {worst[0]:.3f} sigma (member {worst[1]}, {worst[2]})",
          flush=True)
    if not cold["converged"].all():
        fail(f"{family} members {np.nonzero(~cold['converged'])[0][:8]} "
             "did not converge")
    if not (0.8 <= red.min() and red.max() <= 1.25):
        fail(f"{family} batch chi2/dof outside [0.8, 1.25]: {red.min()} .. "
             f"{red.max()}")
    if not worst[0] < TRUTH_SIGMA:
        fail(f"{family} member {worst[1]} left {worst[2]} {worst[0]:.2f} "
             "sigma from the truth")
    # named members against their single-pulsar fused fits
    single = (device_loop.dense_gls_fit if noise else device_loop.dense_wls_fit)
    for i in NAMED_MEMBERS:
        if i >= len(tables):
            continue
        m = get_model(pars[i])
        for k, v in start[i].items():
            m[k].value = v
        deltas, info, chi2, conv, _ = single(tables[i], m, maxiter=10)
        for k, d in deltas.items():
            m[k].add_delta(float(d))
        vgap = max(dd_sigma(fused_values[i][k][0], m[k].value,
                            fused_values[i][k][1]) for k in deltas)
        ugap = max(abs(fused_values[i][k][1] - float(info["errors"][k]))
                   / fused_values[i][k][1] for k in deltas)
        cgap = abs(cold["chi2"][i] - chi2) / chi2
        print(f"  member {i} against its single-pulsar fused fit "
              f"({'dense_gls_fit' if noise else 'dense_wls_fit'}, "
              f"{bucketing.bucket_size(len(tables[i]))} rows): values "
              f"{vgap:.3e} sigma, uncertainties {ugap:.3e}, chi2 {cgap:.3e} "
              f"relative (bars {MEMBER_VALUE_SIGMA:g}, {MEMBER_RTOL:g}); "
              f"converged {conv}", flush=True)
        if not (vgap <= MEMBER_VALUE_SIGMA and ugap <= MEMBER_RTOL
                and cgap <= MEMBER_RTOL and conv == cold["converged"][i]):
            fail(f"{family} member {i} differs from its single-pulsar fit")
    warm_ms = host_ms(lambda: run_batched(bf, start), reps=3)
    print(f"  one warm fused batch fit: {warm_ms:.2f} ms wall (median of 3)",
          flush=True)
    profile_step(f"one warm fused {family} batch fit",
                 lambda: run_batched(bf, start), warm_ms)
    return bf, start


def batch_card_vs_cpu(dev):
    """N_CARD_CPU_PSR members x N_SMALL TOAs of each family, fused on the
    card and on the CPU: the same decisions above the noise floor, chi2
    and values at phase 9's bars."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import BatchedPulsarFitter

    pairs = [simulate_member(i, N_SMALL, 300 + i, dev)
             for i in range(N_CARD_CPU_PSR)]
    for j, family in enumerate(("gls", "wls")):
        pars = [member_par(i, family == "gls") for i in range(N_CARD_CPU_PSR)]
        tables = [p[j] for p in pairs]
        out = {}
        for d in (dev, torch.device("cpu")):
            models = []
            for par in pars:
                m = get_model(par)
                for k, dk in KICK.items():
                    m[k].add_delta(dk)
                models.append(m)
            bf = BatchedPulsarFitter([(t.to(d), m) for t, m in
                                      zip(tables, models)], device=d)
            out[d.type] = run_batched(bf, [free_values(m) for m in models])
        card, cpu = out["cuda"], out["cpu"]
        differ = same_member_loops(card["trace"], cpu["trace"],
                                   CARD_CHI2_RTOL, floor=CARD_CHI2_RTOL)
        gap = float(np.max(np.abs(card["chi2"] - cpu["chi2"]) / cpu["chi2"]))
        worst = max(dd_sigma(a[k][0], b[k][0], b[k][1])
                    for a, b in zip(card["values"], cpu["values"]) for k in a)
        print(f"{family} batch of {N_CARD_CPU_PSR} x {N_SMALL}: card - CPU chi2 "
              f"{gap:.3e} relative (bar {CARD_CHI2_RTOL:g}), values "
              f"{worst:.3e} sigma (bar {CARD_VALUE_SIGMA:g}); members whose "
              f"decisions differ above the noise floor: {differ}; converged "
              f"{card['converged'].tolist()} / {cpu['converged'].tolist()}",
              flush=True)
        if differ or gap > CARD_CHI2_RTOL or worst > CARD_VALUE_SIGMA \
                or not (card["converged"] == cpu["converged"]).all():
            fail(f"the {family} batch on the card disagrees with the CPU")


def sharded_check(dev, toas, state6):
    """ShardedGLSFitter on a 1 x 1 mesh over phase 6's table against
    phase 6's fit."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import ShardedGLSFitter, make_mesh

    mesh = make_mesh(devices=[dev])
    model = get_model(PAR_FULL)
    start = free_values(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = ShardedGLSFitter(toas, model, mesh=mesh)
    chi2 = f.fit_toas(maxiter=10)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    stats = dict(f.loop_stats)
    for k, v in start.items():
        model[k].value = v
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f.fit_toas(maxiter=10)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    g = gaps6(model, state6)
    print(f"ShardedGLSFitter on a 1 x 1 mesh ({mesh}), {len(toas)} TOAs: "
          f"cold {cold_s:.3f} s ({stats}), warm {warm_s:.3f} s "
          f"({f.loop_stats}); chi2 {chi2:.6f} (phase 6 {state6['chi2']:.6f}), "
          f"converged {f.converged}; post-fit - phase 6's fit (sigma): "
          + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
          + f" (bar {SHARDED_SIGMA:g})", flush=True)
    if not (f.converged and max(g.values()) <= SHARDED_SIGMA
            and f.loop_stats["captures"] == 0):
        fail("the sharded GLS fit disagrees with phase 6's fit")


def gaps6(m, state6):
    """Each fitted value of model `m` less phase 6's, in phase 6's sigma."""
    return {k: dd_sigma(m[k].value, state6["values"][k], state6["unc"][k])
            for k in state6["fit_params"]}


def pintempo_sharded_check(state6, cli_dir):
    """``pintempo --fitter sharded`` on phase 15's tim file against phase
    6's fit."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts import pintempo

    par, tim = cli_dir / "bench.par", cli_dir / "bench.tim"
    out, wall = run_tool(pintempo.main, [str(par), str(tim), "--fitter",
                                         "sharded", "--outfile",
                                         str(cli_dir / "sharded.par")])
    print("  " + "\n  ".join(line for line in out.splitlines()
                             if line.startswith(("Read", "Fitted"))))
    g = gaps6(get_model(str(cli_dir / "sharded.par")), state6)
    print(f"pintempo --fitter sharded: {wall:.3f} s wall; post-fit - phase 6's "
          "fit (sigma): " + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
          + f" (bar {PINTEMPO_SIGMA:g})", flush=True)
    if "ShardedGLSFitter" not in out or max(g.values()) > PINTEMPO_SIGMA:
        fail("pintempo --fitter sharded disagrees with phase 6's fit")


def telemetry_checks(bf, start):
    """A warm batched fit with telemetry writing a JSON-lines artifact:
    its span tree, the loop's counters and the per-member records; the
    rollup equal to the counters; then the same fit with
    PINT_TORCH_TELEMETRY=0 writing nothing and counting nothing."""
    import os

    from pint_tpu_torch import telemetry

    work = pathlib.Path(tempfile.mkdtemp(prefix="telemetry_"))
    path = work / "fit.jsonl"
    telemetry.reset()
    telemetry.configure(enabled=True, jsonl_path=str(path))
    on = run_batched(bf, start)
    roll = telemetry.write_rollup()
    counters = telemetry.counters_snapshot()
    lines = [json.loads(line) for line in open(path)]
    spans = {r["name"]: r for r in lines if r["type"] == "span"}
    tree = {name: (spans[name]["depth"], spans[name]["parent"], spans[name]["kind"])
            for name in ("fit.batched", "fit.batched.dispatch",
                         "device_loop_batched.program",
                         "device_loop_batched.fetch") if name in spans}
    traces = [r for r in lines if r["type"] == "trace"]
    batch = [r for r in lines if r["type"] == "batch"]
    st, cnt = on["stats"], on["counters"]
    print(f"telemetry on: {path.stat().st_size} bytes, {len(lines)} lines "
          f"({sorted({r['type'] for r in lines})}); span tree {tree}; "
          f"counters {counters}", flush=True)
    want_tree = {"fit.batched": (0, None, None),
                 "fit.batched.dispatch": (1, "fit.batched", None),
                 "device_loop_batched.program": (2, "fit.batched.dispatch",
                                                 "replay"),
                 "device_loop_batched.fetch": (1, "fit.batched", None)}
    want = {"fit.device_loop.launches": 1,
            "fit.device_loop.replays": st["replays"],
            "fit.device_loop.fetches": st["fetches"],
            "cache.fit_program.hit": 1,
            **{f"fit.{k}": v for k, v in cnt.items() if v}}
    if tree != want_tree or any(counters.get(k, 0) != v
                                for k, v in want.items()):
        fail(f"the telemetry artifact's spans or counters are not the fit's "
             f"(want {want_tree}, {want})")
    if not (len(traces) == 1 and len(traces[0]["chi2"][0]) == len(bf.models)
            and len(batch) == 1 and batch[0]["n_members"] == bf.n_real
            and batch[0]["converged"] == on["converged"].tolist()):
        fail("the telemetry artifact lacks the recorder's per-member records")
    if roll["counters"] != counters or not lines[-1]["type"] == "rollup":
        fail("rollup() disagrees with the counters")
    # the kill switch beats configure()
    off_path = work / "off.jsonl"
    os.environ["PINT_TORCH_TELEMETRY"] = "0"
    try:
        telemetry.reset()
        telemetry.configure(enabled=True, jsonl_path=str(off_path))
        off = run_batched(bf, start)
        telemetry.flush()
        quiet = (not off_path.exists() and telemetry.counters_snapshot() == {}
                 and telemetry.span_stats() == {})
    finally:
        os.environ.pop("PINT_TORCH_TELEMETRY")
        telemetry.reset()
    print(f"telemetry off (PINT_TORCH_TELEMETRY=0 over configure): artifact "
          f"written {off_path.exists()}, counters and spans empty {quiet}; "
          f"warm batch fit {on['wall']:.4f} s with telemetry on, "
          f"{off['wall']:.4f} s off", flush=True)
    if not quiet or not np.array_equal(on["chi2"], off["chi2"]):
        fail("with telemetry off the fit wrote or counted something")
    shutil.rmtree(work)


def many_pulsars(dev, toas, state6, cli_dir, n_psr=N_PSR, n_per=N_PER_PSR):
    """Phase 16 (see the module docstring). Returns the ds32_gram
    launches of its sub-paths by name (each must be 0)."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.ops import gram

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = [simulate_member(i, n_per, 1000 + i, dev) for i in range(n_psr)]
    tables = {"gls": [p[0] for p in pairs], "wls": [p[1] for p in pairs]}
    del pairs
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    builds_s = host_ms(lambda: [gbt_table(n_per, 1000 + i, dev, "DE421")
                                for i in range(n_psr)], reps=1) / 1e3
    print(f"simulated {n_psr} members x {n_per} GBT TOAs "
          f"({n_psr * n_per} TOAs) of each family in {sim_s:.2f} s; the "
          f"{n_psr} table builds alone {builds_s:.3f} s", flush=True)
    launches = {}

    def counted(label, fn, *args):
        # each sub-path's ds32_gram launches, counted from 0
        device_loop.clear_cache()
        gram.ds32_gram.launches = 0
        out = fn(*args)
        launches[label] = gram.ds32_gram.launches
        return out

    def gls_batch():
        bf, start = batch_family(dev, tables["gls"], "gls")
        telemetry_checks(bf, start)

    counted(f"batched GLS fits {n_psr} x {n_per} (fused, host loop, "
            f"telemetry)", gls_batch)
    counted(f"batched WLS fits {n_psr} x {n_per} (fused, host loop)",
            batch_family, dev, tables["wls"], "wls")
    counted(f"batched fits {N_CARD_CPU_PSR} x {N_SMALL}, card against CPU",
            batch_card_vs_cpu, dev)
    counted(f"ShardedGLSFitter {len(toas)} (1 x 1 mesh)", sharded_check, dev,
            toas, state6)
    counted("pintempo --fitter sharded", pintempo_sharded_check, state6,
            cli_dir)
    device_loop.clear_cache()
    print(f"ds32_gram launches in phase 16 (its fits build their Grams in "
          f"float64): {launches}", flush=True)
    if any(launches.values()):
        fail(f"phase 16's fits launched ds32_gram: {launches}")
    print(f"phase 16 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# Phase 17: BASELINE.md config 5 (the full-PTA correlated GLS with
# Hellings-Downs GW) as the catalog generator makes it: 68 pulsars x
# 8,824 TOAs (600,032), ECORR + 30-harmonic red noise, a 20-harmonic
# HD-correlated GW background (q = 6 + 60 + 40 = 106 per pulsar, a
# 2,720-dimensional GW core). The generator's tables carry 1 us white
# noise and the injected background; the fit's tables add a draw of the
# rest of each par's noise (with_model_noise), so chi2/dof ~1.
PTA_SPEC = dict(n_pulsars=68, toas_per_pulsar=8_824, mix=("ecorr_red",),
                red_nharm=30, gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=20,
                seed=0)
PTA_GW = dict(gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=20)
# the batched kernel's shapes: G_BB (every TOA x q), the ECORR Schur term
# (one row per 4-TOA epoch), a q <= 68 case (the narrow build) and a
# pairs-build case with a one-column tile
PTA_GRAM_SHAPES = (("G_BB", 68, 8_824, 106, True),
                   ("Schur", 68, 2_206, 106, True),
                   ("q46", 68, 2_206, 46, False),
                   ("q129", 3, 3_001, 129, False))
# the block elimination of the joint solve at phase 17's shapes: 68
# members of q = 106 (p = 6 timing columns, 60 red-noise, k = 40 GW),
# both systems of each in one launch; the kernel against its plain
# version (the library route on the card), the largest gap of each
# output over its largest entry (the pivot order differs: rounding only)
ELIM_SHAPE = (68, 106, 6, 40)
ELIM_BAR = 1e-12
F64_FLOPS = 34e12     # float64 outside the tensor cores (the kernel's)
# the Gram-kernel route against the float64 route: the ds32 conditioning
# trap (ROADMAP Queue 3; 1.45e-4 sigma measured in phase 16's sharded
# fit), the sharded fit's bar
PTA_DS32_SIGMA = SHARDED_SIGMA
N_JOB_PSR, N_JOB_PER = 8, 2_048
N_PINTK = N_DENSE
PINTK_SELECT = 0.25        # the first quarter of the MJD range
N_PINTK_RANDOM = 100


def batched_whitened(P, n, q, seed, device):
    """(P, n, q) f64 with unit columns per member."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((P, n, q), generator=g, dtype=torch.float64, device=device)
    return (A / torch.linalg.norm(A, dim=1, keepdim=True)).contiguous()


def check_batched_gram(gram, dev):
    """17a: the batched kernel at the PTA fit's shapes: each member bit
    for bit the 2-D launch on that member, and ``torch.func.vmap`` over
    the 2-D wrapper the same launch; within PLAIN_BAR of max|G| of the
    batched plain version; times (CUDA events, device time), its bound
    and ``torch.bmm(A.mT, A)`` in f64 both ways."""
    shapes = []
    for label, P, n, q, timed in PTA_GRAM_SHAPES:
        A = batched_whitened(P, n, q, seed=n + q, device=dev)
        before = (gram.ds32_gram.launches, gram.ds32_gram_batched.launches)
        G = gram.ds32_gram_batched(A)
        Gv = torch.func.vmap(gram.ds32_gram)(A)
        singles = [gram.ds32_gram(A[p]) for p in range(P)]
        torch.cuda.synchronize()
        counts = (gram.ds32_gram.launches - before[0],
                  gram.ds32_gram_batched.launches - before[1])
        if counts != (P, 2):
            fail(f"{label}: {counts} (2-D, batched) launches counted for P 2-D "
                 f"calls and two batched ones")
        same = torch.equal(G, Gv) and all(torch.equal(G[p], singles[p])
                                          for p in range(P))
        G_plain = gram.ds32_gram_batched_reference(A)
        scale = float(torch.max(torch.abs(torch.bmm(A.mT, A))))
        err = float(torch.max(torch.abs(G - G_plain)))
        print(f"  batched {label} {P}x{n}x{q}: each member = its 2-D launch "
              f"bit for bit: {same}; |kernel-plain|/max|G| = {err / scale:.3e} "
              f"(bar {PLAIN_BAR:g})", flush=True)
        if not same or not err <= PLAIN_BAR * scale \
                or not torch.isfinite(G).all():
            fail(f"the batched ds32_gram disagrees at {label} {P}x{n}x{q}")
        del Gv, singles, G_plain
        if not timed:
            continue
        by_name = device_ms(lambda: gram.ds32_gram_batched(A),
                            kernels=("ds32_gram_partials", "ds32_gram_reduce"))
        flops = P * 2.0 * n * (q * (q + 1) / 2 + q * q)
        nbytes = P * 8.0 * (n * q + q * q)
        bound_ms = max(flops / F32_FLOPS, nbytes / HBM_BYTES_S) * 1e3
        shapes.append({
            "shape": label, "P": P, "n": n, "q": q,
            "ms": median_ms(lambda: gram.ds32_gram_batched(A)),
            "device_ms": sum(ms for name, ms in by_name.items()
                             if "ds32_gram" in name) or None,
            "plain_ms": median_ms(lambda: gram.ds32_gram_batched_reference(A),
                                  reps=3, warm=1),
            "library_ms": median_ms(lambda: torch.bmm(A.mT, A)),
            "library_device_ms": sum(device_ms(
                lambda: torch.bmm(A.mT, A)).values()) or None,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / F32_FLOPS >= nbytes / HBM_BYTES_S
            else "bytes",
            "max_abs_err": err})
        sh = shapes[-1]
        print(f"  batched {label}: kernel {sh['ms']:.4f} ms a launch "
              f"({fmt_ms(sh['device_ms'])} device), plain {sh['plain_ms']:.4f}"
              f" ms, torch.bmm f64 {sh['library_ms']:.4f} ms "
              f"({fmt_ms(sh['library_device_ms'])} device), bound "
              f"{bound_ms:.4f} ms ({sh['bound_by']})", flush=True)
        del A, G
    return shapes


def elim_work(G, q, p, k):
    """(flops, bytes) the block elimination of G members needs: the
    Schur updates of the red-noise pivots over each system's trailing
    lower triangle and the timing sweeps; each input element read once
    (A's and C's lower triangles, B, rhs) and each output written once."""
    m = q - k
    kpl = m - p
    fma = 0
    for n1, sweeps in ((q + 1, p), (q - p + 1, 0)):
        fma += sum((n1 - 1 - j) * (n1 - j) // 2 for j in range(kpl))
        fma += sweeps * (n1 - kpl) * (n1 - kpl + 1) // 2
    inputs = m * (m + 1) // 2 + m * k + k * (k + 1) // 2 + q
    outputs = p * k + 2 * p + 2 * (k * k + k) + 1
    return G * 2.0 * fma, G * 8.0 * (inputs + outputs)


def cholesky_route(S, rhs, p, k):
    """The joint solve's block eliminations as the port ran them before
    the kernel (the yardstick ``library_ms``, never called by the port):
    per system one jittered Cholesky and three ``cholesky_solve`` calls
    (the GW coupling, the right-hand side, the full inverse), then the
    Schur products."""
    from pint_tpu_torch.fitting import gls_step

    eps = torch.finfo(torch.float64).eps

    def elim(A, B, c):
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        L = gls_step.cholesky(A + eye * (eps * tr)[..., None, None])
        return (torch.cholesky_solve(B, L),
                torch.cholesky_solve(c[..., None], L)[..., 0],
                torch.cholesky_solve(eye.expand_as(A), L))

    m = S.shape[-1] - k
    B = S[:, :m, m:]
    Y, z, Ainv = elim(S[:, :m, :m], B, rhs[:, :m])
    K = S[:, m:, m:] - B.mT @ Y
    kpl = m - p
    Sn, cn = S[:, p:, p:], rhs[:, p:]
    nB = Sn[:, :kpl, kpl:]
    nY, nz, _ = elim(Sn[:, :kpl, :kpl], nB, cn[:, :kpl])
    return K, Sn[:, kpl:, kpl:] - nB.mT @ nY, torch.sum(cn[:, :kpl] * nz)


def check_block_elim(dev):
    """17a: the block-elimination kernel at the joint fit's shapes
    (ELIM_SHAPE, random positive definite systems) against its plain
    version on the card within ELIM_BAR of each output's largest entry,
    one launch counted; times (CUDA events, device time), the plain
    version's, the route before the kernel (``library_ms``) and the
    bound."""
    from pint_tpu_torch.ops import block_elim as be
    from pint_tpu_torch.parallel.batch import _cusolver

    G, q, p, k = ELIM_SHAPE
    gen = torch.Generator().manual_seed(q)
    X = torch.randn(G, 3 * q, q, generator=gen, dtype=torch.float64)
    prior = torch.rand(G, q, generator=gen, dtype=torch.float64) * 3.0
    S = (X.mT @ X / (3 * q) + torch.diag_embed(prior)).to(dev)
    rhs = torch.randn(G, q, generator=gen, dtype=torch.float64).to(dev)
    with _cusolver(dev):
        before = be.block_elim.launches
        out = be.block_elim(S, rhs, p, k)
        ref = be.block_elim_reference(S, rhs, p, k)
        torch.cuda.synchronize()
        gaps = {name: float((getattr(out, name) - getattr(ref, name)).abs().max()
                            / getattr(ref, name).abs().max())
                for name in ("Yp", "zp", "a", "K", "g", "nK", "ng", "ncz")}
        print(f"  block_elim {G} x (q {q}, p {p}, k {k}): route {out.route}, "
              f"{be.block_elim.launches - before} launch; |kernel - plain| "
              f"over max|plain| by output: "
              + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items())
              + f" (bar {ELIM_BAR:g})", flush=True)
        if out.route != "kernel" or be.block_elim.launches != before + 1 \
                or not max(gaps.values()) <= ELIM_BAR:
            fail("the block-elimination kernel disagrees with its plain "
                 "version")
        flops, nbytes = elim_work(G, q, p, k)
        bound_ms = max(flops / F64_FLOPS, nbytes / HBM_BYTES_S) * 1e3
        by_name = device_ms(lambda: be.block_elim(S, rhs, p, k),
                            kernels=("pta_block_elim",))
        rec = {"shape": f"{G} x q{q} p{p} k{k}", "G": G, "q": q, "p": p,
               "k": k, "ms": median_ms(lambda: be.block_elim(S, rhs, p, k)),
               "device_ms": sum(ms for name, ms in by_name.items()
                                if "pta_block_elim" in name) or None,
               "plain_ms": median_ms(
                   lambda: be.block_elim_reference(S, rhs, p, k), reps=5),
               "library_ms": median_ms(lambda: cholesky_route(S, rhs, p, k),
                                       reps=5),
               "library_device_ms": sum(device_ms(
                   lambda: cholesky_route(S, rhs, p, k), calls=5).values())
               or None,
               "bound_ms": bound_ms,
               "bound_by": ("operations" if flops / F64_FLOPS
                            >= nbytes / HBM_BYTES_S else "bytes"),
               "max_rel_err": max(gaps.values()),
               "build": be.build_info(q)}
    print(f"  block_elim: kernel {rec['ms']:.4f} ms a launch "
          f"({fmt_ms(rec['device_ms'])} device), plain version (cuSOLVER) "
          f"{rec['plain_ms']:.4f} ms, the route before the kernel "
          f"{rec['library_ms']:.4f} ms ({fmt_ms(rec['library_device_ms'])} "
          f"device), bound {bound_ms:.4f} ms ({rec['bound_by']}: "
          f"{flops:.3e} flops, {nbytes:.3e} bytes)", flush=True)
    return rec


def stage1_work(n_rows, q):
    """Bytes the stage-1 kernel reads and writes once over n_rows TOAs at
    q columns: TDB as DD, two positions, the frequency and sw in; the
    whitened design's rows and the residual out."""
    return n_rows * 8 * ((2 + 3 + 3 + 1 + 1) + (q + 1))


def check_stage1(dev):
    """17s: the stage-1 kernel at pta68's shapes (68 x 8,824 TOAs, 5
    free parameters and the offset) against its plain version on the
    card (the design and the residuals equal bit for bit), one launch
    counted; times (CUDA events, device time): the kernel's, the whole
    stage 1 on its route (the parameter table, the kernel and the
    finish's PyTorch operators), the plain version's, the jacfwd
    route's (the route before the kernel, ``library_ms``); the bound."""
    from pint_tpu_torch.catalog import CatalogSpec
    from pint_tpu_torch.fitting import hybrid
    from pint_tpu_torch.ops import stage1 as s1
    from pint_tpu_torch.parallel.batch import _vmap
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    problems, _, _ = pta_problems(CatalogSpec(**PTA_SPEC), dev)
    f = PTAGLSFitter(problems, **PTA_GW, device=dev, accel=True)
    f._prepare()
    st = f._stacked[0]
    P = st.hi - st.lo
    gen = torch.Generator().manual_seed(17)
    D = {k: (torch.randn(P, generator=gen, dtype=torch.float64) * 1e-10
             ).to(dev) for k in f.names}
    base = f._base()[0]
    layout = s1.kernel_layout(st.union, anchored=True)
    if layout is None or st.route != "kernel":
        fail("pta68's stacked group does not take the stage-1 kernel")
    ops = s1.stage1_operands(layout, base, D, st.toas.member(st.toas.leaves),
                             torch.sqrt(1.0 / (st.sigma * st.sigma)),
                             st.tzr.member(st.tzr.leaves))
    before = s1.stage1_fused.launches
    Mw, resid = s1.stage1_batched(*ops, layout)
    Mw0, resid0 = s1.stage1_reference(*ops, layout)
    torch.cuda.synchronize()
    print(f"  stage1 {P} x {st.toas.n} TOAs, q {layout.q}: "
          f"{s1.stage1_fused.launches - before} launch; against the plain "
          f"version: the design equal {torch.equal(Mw, Mw0)}, the residuals "
          f"equal {torch.equal(resid, resid0)}", flush=True)
    if s1.stage1_fused.launches != before + 1 or not torch.equal(Mw, Mw0) \
            or not torch.equal(resid, resid0):
        fail("the stage-1 kernel disagrees with its plain version")
    nbytes = stage1_work(P * st.toas.n, layout.q)
    routes = {}
    for route in ("kernel", "jacfwd"):
        saved = hybrid.kernel_layout
        if route == "jacfwd":   # as a model outside the kernel's set
            hybrid.kernel_layout = lambda *a: None
        try:
            one = hybrid.make_whiten_stage1(st.union, traced_tzr=True)
        finally:
            hybrid.kernel_layout = saved

        def run(one=one):
            return _vmap(lambda b, d, lv, sg, tl: one(
                b, d, st.toas.member(lv), sg, st.tzr.member(tl)))(
                base, D, st.toas.leaves, st.sigma, st.tzr.leaves)
        routes[route] = run

    def kernel():
        return s1.stage1_batched(*ops, layout)

    by_name = device_ms(kernel, kernels=("stage1_rows",))
    rec = {"shape": f"{P} x {st.toas.n} q{layout.q}", "P": P,
           "n": st.toas.n, "q": layout.q, "ms": median_ms(kernel),
           "device_ms": sum(ms for name, ms in by_name.items()
                            if "stage1_rows" in name) or None,
           "stage1_ms": median_ms(routes["kernel"]),
           "stage1_device_ms": sum(device_ms(routes["kernel"]).values())
           or None,
           "plain_ms": median_ms(lambda: s1.stage1_reference(*ops, layout),
                                 reps=5),
           "library_ms": median_ms(routes["jacfwd"], reps=5),
           "library_device_ms": sum(device_ms(routes["jacfwd"],
                                              calls=3).values()) or None,
           "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
           "build": s1.build_info()}
    share = (None if rec["device_ms"] is None
             else rec["bound_ms"] / rec["device_ms"])
    print(f"  stage1: kernel {rec['ms']:.4f} ms a call "
          f"({fmt_ms(rec['device_ms'])} device); stage 1 on its route "
          f"{rec['stage1_ms']:.4f} ms ({fmt_ms(rec['stage1_device_ms'])} "
          f"device); plain version {rec['plain_ms']:.4f} ms; the jacfwd route "
          f"{rec['library_ms']:.4f} ms ({fmt_ms(rec['library_device_ms'])} "
          f"device); bound {rec['bound_ms']:.4f} ms ({nbytes:.3e} bytes)"
          + ("" if share is None else f", {100 * share:.1f}% of the bound"),
          flush=True)
    # the local bytes are libdevice's sin/cos reduction for huge
    # arguments (a 40-byte frame; ptxas: 0 bytes spill stores)
    for name, b in rec["build"].items():
        print(f"  stage1 {name}: {b['threads']} threads, {b['registers']} "
              f"registers, {b['spill_bytes']} local bytes, "
              f"{b['shared_bytes']} B static shared, {b['blocks_per_sm']} "
              f"blocks per SM", flush=True)
    return rec


def pta_problems(spec, device, kick=True):
    """The catalog of `spec` (generated on `device`), its tables shifted
    by a draw of each par's noise, each model kicked by KICK; returns
    (problems, truth values, manifest id)."""
    from pint_tpu_torch.catalog import generate_catalog

    cat = generate_catalog(spec, device=device)
    truth = [{k: m.model[k] for k in m.model.free_params} for m in cat.members]
    truth = [{k: (p.value_f64, p.value) for k, p in t.items()} for t in truth]
    problems = []
    for i, m in enumerate(cat.members):
        rng = np.random.default_rng((spec.seed, 2000 + i))
        toas = with_model_noise(m.toas, m.model, rng)
        if kick:
            for k, d in KICK.items():
                m.model[k].add_delta(d)
        problems.append((toas, m.model))
    return problems, truth, cat.manifest_id()


def run_pta(f, starts=None, loop="1", maxiter=10):
    """One joint fit of PTAGLSFitter `f` (each model set to `starts`
    first, when given) through the fused loop or the host loop; the
    run_fit record, the ds32_gram launches split into 2-D and batched,
    the block-elimination and the stage-1 kernel's launches (each count
    set to 0 just before the fit and read just after)."""
    import os

    from pint_tpu_torch.ops import block_elim, gram, stage1
    from pint_tpu_torch.telemetry import recorder

    if starts is not None:
        for m, st in zip(f.models, starts):
            for k, v in st.items():
                m[k].value = v
    os.environ["PINT_TORCH_DEVICE_LOOP"] = loop
    try:
        torch.cuda.synchronize()
        gram.ds32_gram.launches = 0
        gram.ds32_gram_batched.launches = 0
        block_elim.block_elim.launches = 0
        stage1.stage1_fused.launches = 0
        t0 = time.perf_counter()
        chi2 = f.fit_toas(maxiter=maxiter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("PINT_TORCH_DEVICE_LOOP")
    trace = recorder.last_trace()
    return {"chi2": chi2, "wall": wall, "steps": trace["n"],
            "probes": f.counters["probe_evals"],
            "counters": {k: f.counters[k] for k in LOOP_COUNTERS},
            "stats": dict(f.loop_stats), "trace": trace,
            "launches": gram.ds32_gram.launches,
            "batched": gram.ds32_gram_batched.launches,
            "elim": block_elim.block_elim.launches,
            "stage1": stage1.stage1_fused.launches,
            "converged": f.converged}


def pta_values(f):
    return [{k: (m[k].value_f64, m[k].uncertainty) for k in m.free_params}
            for m in f.models]


def worst_sigma(a, b):
    """The largest |a - b| over every fitted value, in b's uncertainties."""
    return max(abs(x[k][0] - y[k][0]) / y[k][1]
               for x, y in zip(a, b) for k in y)


def pta_baseline(dev):
    """17b: BASELINE config 5 at full size through the fused joint loop.
    Returns (the launches of the main fit by kernel, its record)."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.catalog import CatalogSpec
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.ops import block_elim, gram, stage1
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(**PTA_SPEC)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problems, truth, mid = pta_problems(spec, dev)
    torch.cuda.synchronize()
    n_toas = sum(len(t) for t, _ in problems)
    print(f"generated catalog {mid}: {len(problems)} pulsars x "
          f"{spec.toas_per_pulsar} TOAs ({n_toas}), ECORR + {spec.red_nharm}"
          f"-harmonic red noise, a {spec.gw_nharm}-harmonic HD GW background, "
          f"on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    device_loop.clear_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = PTAGLSFitter(problems, **PTA_GW)
    f._prepare()
    torch.cuda.synchronize()
    print(f"PTAGLSFitter: route {'Gram kernel' if f.accel else 'float64'}, "
          f"stacked {f._stacked is not None}, q = "
          f"{f._groups[0]['q']}, GW core {len(problems) * 2 * spec.gw_nharm}; "
          f"prepared in {time.perf_counter() - t0:.2f} s", flush=True)
    starts = [{k: m[k].value for k in m.free_params} for m in f.models]
    # the main path: run_pta sets every kernel count to 0 just before the
    # fit and reads it just after
    elim_captured = block_elim.block_elim.captured
    s1_captured = stage1.stage1_fused.captured
    cold = run_pta(f)
    launches = {"ds32_gram": cold["launches"],
                "ds32_gram_batched": cold["batched"],
                "block_elim": cold["elim"], "stage1_fused": cold["stage1"]}
    elim_captured = block_elim.block_elim.captured - elim_captured
    s1_captured = stage1.stage1_fused.captured - s1_captured
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    vals = pta_values(f)
    describe_fit("joint fit (cold, fused loop, with capture)", cold)
    st = cold["stats"]
    dof = n_toas - sum(len(m.free_params) + 1 for m in f.models)
    print(f"  launches counted per replay: ds32_gram_batched "
          f"{launches['ds32_gram_batched']}, ds32_gram (2-D) "
          f"{launches['ds32_gram']}; recorded in the capture: batched "
          f"{gram.ds32_gram_batched.captured}; chi2/dof {cold['chi2'] / dof:.6f} "
          f"(dof {dof}); peak memory {peak_mb:.1f} MiB", flush=True)
    if not (math.isfinite(cold["chi2"]) and f.converged and not f.diverged):
        fail(f"the joint fit did not converge to a finite chi2 ({cold['chi2']})")
    if not 0.8 <= cold["chi2"] / dof <= 1.25:
        fail(f"joint chi2/dof {cold['chi2'] / dof} outside [0.8, 1.25]")
    # the route of every block: the gauges of one host-loop evaluation
    prev = telemetry.configure()
    telemetry.configure(enabled=True)
    try:
        f.step(f.zero_flat())
        gauges = telemetry.gauges_snapshot()
    finally:
        telemetry.configure(enabled=prev)
    routes = (gauges.get("joint.elim.kernel_blocks"),
              gauges.get("joint.elim.library_blocks"))
    s1_routes = (gauges.get("stage1.kernel_members"),
                 gauges.get("stage1.jacfwd_members"))
    print(f"  block_elim launches counted per replay: {cold['elim']}; "
          f"recorded in the capture: {elim_captured}; blocks of one "
          f"evaluation on the kernel {routes[0]}, on the library route "
          f"{routes[1]}", flush=True)
    print(f"  stage1_fused launches counted per replay: {cold['stage1']}; "
          f"recorded in the capture: {s1_captured}; members of one "
          f"evaluation on the kernel {s1_routes[0]}, on the jacfwd route "
          f"{s1_routes[1]}", flush=True)
    if routes != (2 * len(problems), 0):
        fail(f"not every block of the joint fit took the kernel: {routes}")
    if s1_routes != (len(problems), 0):
        fail(f"not every member's stage 1 took the kernel: {s1_routes}")
    if launches["ds32_gram"] != 0 or launches["ds32_gram_batched"] \
            != 2 * cold["steps"] or launches["block_elim"] != cold["steps"] \
            or elim_captured != 1 or launches["stage1_fused"] \
            != cold["steps"] or s1_captured != 1:
        fail(f"{launches} for {cold['steps']} full evaluations (two batched "
             f"Gram launches, one block elimination and one stage-1 launch "
             f"each, no 2-D Gram)")
    if not (st["captures"] == 1 and st["replays"] == cold["steps"] - 1):
        fail(f"the joint fit did not run as graph replays: {st}")
    pulls = sorted(((v[k][0] - t[k][0]) / v[k][1], i, k)
                   for i, (v, t) in enumerate(zip(vals, truth)) for k in t)
    worst = max(pulls, key=lambda x: abs(x[0]))
    print(f"  {sum(len(t) for t in truth)} fitted parameters; largest pull "
          f"from the truth {worst[0]:+.3f} sigma (pulsar {worst[1]}, "
          f"{worst[2]})", flush=True)
    if not abs(worst[0]) < TRUTH_SIGMA:
        fail(f"pulsar {worst[1]}'s {worst[2]} {worst[0]:.2f} sigma from the "
             "truth")
    warm = run_pta(f, starts)
    describe_fit("joint fit (warm, fused loop)", warm)
    if not (warm["stats"]["captures"] == 0
            and warm["stats"]["replays"] == warm["steps"]
            and same_loop(cold, warm) and warm["batched"] == 2 * warm["steps"]
            and warm["elim"] == warm["steps"]
            and warm["stage1"] == warm["steps"]):
        fail("the warm joint fit is not the cold one replayed")
    host = run_pta(f, starts, loop="0")
    describe_fit("joint fit (host loop, the witness)", host)
    print(f"  stage1_fused launches: warm {warm['stage1']} in {warm['steps']} "
          f"full evaluations, host loop {host['stage1']} in "
          f"{host['steps']}", flush=True)
    if host["stage1"] != host["steps"]:
        fail(f"the host-loop joint fit launched the stage-1 kernel "
             f"{host['stage1']} times in {host['steps']} full evaluations")
    gap = max(abs(x - y) / abs(y) for x, y in zip(cold["trace"]["chi2"],
                                                   host["trace"]["chi2"]))
    print(f"  fused - host loop: largest relative gap of a full evaluation's "
          f"chi2 {gap:.3e} (bar {LOOP_RTOL:g}); values "
          f"{worst_sigma(pta_values(f), vals):.3e} sigma", flush=True)
    if not same_loop(cold, host) or host["stats"]:
        fail("the fused joint fit disagrees with the host loop")
    fused_ms = host_ms(lambda: run_pta(f, starts), reps=3)
    by_name = profile_step("one warm fused joint fit",
                           lambda: run_pta(f, starts), fused_ms)
    traced = sum(c for name, (_, c) in by_name.items()
                 if "ds32_gram_partials" in name)
    print(f"  the trace holds {traced} ds32_gram partials kernels for "
          f"{warm['batched']} batched launches counted per replay", flush=True)
    # the float64 route on the same models and starts (its own capture)
    f64 = PTAGLSFitter([(t, m) for t, m in zip(f.toas_list, f.models)],
                       **PTA_GW, accel=False)
    r64 = run_pta(f64, starts)
    describe_fit("joint fit, float64 route (accel=False; cold)", r64)
    ds32_gap = worst_sigma(pta_values(f64), vals)
    print(f"  Gram-kernel route - float64 route: chi2 "
          f"{cold['chi2'] - r64['chi2']:+.6f}, values {ds32_gap:.3e} sigma "
          f"(bar {PTA_DS32_SIGMA:g}), batched launches {r64['batched']}",
          flush=True)
    if not ds32_gap <= PTA_DS32_SIGMA or r64["batched"] or r64["launches"]:
        fail("the Gram-kernel joint fit is not the float64 route's")
    del f, f64, problems
    device_loop.clear_cache()
    return launches, cold, warm, fused_ms


def pta_card_vs_cpu(dev):
    """17c: a 4 x 2,000 catalog on the card and on the CPU, on both Gram
    routes, and a heterogeneous one (2-D launches per pulsar)."""
    import copy

    from pint_tpu_torch.catalog import CatalogSpec
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    for mix in (("ecorr_red",), ("ecorr_red", "ecorr")):
        spec = CatalogSpec(**dict(PTA_SPEC, n_pulsars=4,
                                  toas_per_pulsar=N_SMALL, mix=mix))
        problems, _truth, _mid = pta_problems(spec, "cpu")
        for accel in (True, False):
            out = {}
            for d in (dev, torch.device("cpu")):
                probs = [(t.to(d), copy.deepcopy(m)) for t, m in problems]
                f = PTAGLSFitter(probs, **PTA_GW, device=d, accel=accel)
                out[d.type] = (run_pta(f), pta_values(f),
                               f._stacked is not None)
            (card, vcard, stacked), (cpu, vcpu, _) = out["cuda"], out["cpu"]
            gap = abs(card["chi2"] - cpu["chi2"]) / cpu["chi2"]
            worst = worst_sigma(vcard, vcpu)
            print(f"catalog {mix} 4 x {N_SMALL}, "
                  f"{'Gram kernel' if accel else 'float64'} route "
                  f"({'stacked' if stacked else 'per pulsar'}): card - CPU "
                  f"chi2 {gap:.3e} relative (bar {CARD_CHI2_RTOL:g}), values "
                  f"{worst:.3e} sigma (bar {CARD_VALUE_SIGMA:g}); card "
                  f"launches 2-D {card['launches']}, batched {card['batched']};"
                  f" converged {card['converged']}/{cpu['converged']}",
                  flush=True)
            if gap > CARD_CHI2_RTOL or worst > CARD_VALUE_SIGMA \
                    or card["converged"] != cpu["converged"]:
                fail(f"the {mix} joint fit on the card disagrees with the CPU")
            want = ((0, 2 * card["steps"]) if stacked
                    else (2 * len(probs) * card["steps"], 0)) if accel \
                else (0, 0)
            if (card["launches"], card["batched"]) != want \
                    or stacked != (len(mix) == 1):
                fail(f"the {mix} joint fit launched {card['launches']} 2-D and "
                     f"{card['batched']} batched Grams, not {want}")


def catalog_job_checks(dev):
    """17d: an 8 x 2,048 catalog job in budgeted slices, resumed from its
    first slice's checkpoint bit for bit; a 4-point hypergrid sharing one
    capture; the generator's manifest twice."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.catalog import (CatalogFitRequest, CatalogJob,
                                        CatalogSpec, generate_catalog)
    from pint_tpu_torch.catalog.hypergrid import run_grid
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(**dict(PTA_SPEC, n_pulsars=N_JOB_PSR,
                              toas_per_pulsar=N_JOB_PER))
    ids = [generate_catalog(spec, device=dev).manifest_id() for _ in range(2)]
    print(f"generate_catalog twice on the card: manifest ids {ids}", flush=True)
    if ids[0] != ids[1]:
        fail("two catalogs of one spec differ")
    req = CatalogFitRequest(spec=spec, maxiter=8, min_chi2_decrease=0.0,
                            **PTA_GW)
    t0 = time.perf_counter()
    ctrl = CatalogJob(req, "ctrl", device=dev)
    slices = 1
    while not ctrl.advance(0.2):
        slices += 1
    ctrl_s = time.perf_counter() - t0
    victim = CatalogJob(req, "victim", device=dev)
    victim.advance(0.0)
    ck = victim.checkpoint()
    del victim
    resumed = CatalogJob.from_checkpoint(ck, device=dev)
    while not resumed.advance(0.2):
        pass
    same = (resumed.chi2 == ctrl.chi2 and resumed.iterations == ctrl.iterations
            and all(a["F0"].value == b["F0"].value for (_, a), (_, b) in zip(
                ctrl.catalog.joint_problems(), resumed.catalog.joint_problems())))
    print(f"catalog job {N_JOB_PSR} x {N_JOB_PER}: {ctrl.state} in {slices} "
          f"slices of 0.2 s ({ctrl_s:.2f} s), {ctrl.iterations} iterations, "
          f"chi2 {ctrl.chi2:.9f}; resumed from the checkpoint after "
          f"{ck['iterations']} iteration(s): chi2 {resumed.chi2:.9f}, "
          f"{resumed.iterations} iterations, resume evaluations "
          f"{resumed.resume_evals}; bit for bit {same}", flush=True)
    if not (ctrl.state == "done" and same and resumed.resumes == 1):
        fail("the resumed catalog job is not the uninterrupted one")
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        f = PTAGLSFitter(generate_catalog(spec, device=dev).joint_problems(),
                         **PTA_GW)
        points = [(-13.8, 3.0), (-13.6, 3.1), (-13.4, 3.2), (-14.0, 3.6)]
        t0 = time.perf_counter()
        grid = run_grid(f, points, maxiter=6)
        grid_s = time.perf_counter() - t0
        miss = telemetry.counter_value("cache.fit_program.miss")
        hit = telemetry.counter_value("cache.fit_program.hit")
    finally:
        telemetry.reset()
    print(f"hypergrid of {len(points)} points in {grid_s:.2f} s: chi2 "
          + ", ".join(f"{r.point} {r.chi2:.3f}" for r in grid)
          + f"; captures (cache.fit_program.miss) {miss}, replayed fits "
          f"(hit) {hit}", flush=True)
    if miss != 1 or hit != len(points) - 1 \
            or not all(math.isfinite(r.chi2) for r in grid):
        fail("the hypergrid did not share one capture")


def pintk_actions(ctrl, select):
    """pintk's actions on `ctrl`: fit, reset, fit; select the first
    `select` of the MJD range, delete it, fit again (and the same fit
    by Fitter.auto directly); random models; the par and tim files
    written and read back. Returns the records."""
    import copy

    from pint_tpu_torch.fitting import Fitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toas import get_TOAs

    out = {"fit1": ctrl.fit()}
    ctrl.reset()
    out["fit2"] = ctrl.fit()
    mjds = ctrl.all_toas.get_mjds()
    lo, hi = mjds.min(), mjds.min() + select * (mjds.max() - mjds.min())
    out["selected"] = ctrl.select_range(lo, hi)
    out["remain"] = ctrl.delete_selected()
    start = copy.deepcopy(ctrl.postfit_model)
    out["fit3"] = ctrl.fit()
    direct = Fitter.auto(ctrl.active_toas(), start)
    out["direct_chi2"] = float(direct.fit_toas(maxiter=4))
    out["values"] = {k: (ctrl.postfit_model[k].value_f64,
                         ctrl.postfit_model[k].uncertainty)
                     for k in ctrl.postfit_model.free_params}
    out["direct"] = {k: (start[k].value_f64, start[k].uncertainty)
                     for k in start.free_params}
    t0 = time.perf_counter()
    out["random"] = ctrl.random_models(N_PINTK_RANDOM, seed=0)
    out["random_s"] = time.perf_counter() - t0
    work = pathlib.Path(tempfile.mkdtemp(prefix="pintk_"))
    try:
        ctrl.write_par(str(work / "out.par"))
        ctrl.write_tim(str(work / "out.tim"))
        back = get_model(str(work / "out.par"))
        out["par_back"] = max(abs(back[k].value_f64 - v[0]) / v[1]
                              for k, v in out["values"].items())
        out["tim_back"] = len(get_TOAs(str(work / "out.tim"), ephem=back.ephem,
                                       device=ctrl.all_toas.device))
    finally:
        shutil.rmtree(work)
    return out


def pintk_checks(dev, dense):
    """17e: pintk's controller, headless, on phase 10's 20,000-TOA table
    (Fitter.auto takes the dense GLS there) and card against CPU at
    2,000 TOAs."""
    from pint_tpu_torch.pintk import PintkController

    t0 = time.perf_counter()
    r = pintk_actions(PintkController(dense, kicked(PAR_FULL)), PINTK_SELECT)
    wall = time.perf_counter() - t0
    gap = max(abs(r["values"][k][0] - v[0]) / v[1] for k, v in r["direct"].items())
    refit = abs(r["fit1"]["chi2"] - r["fit2"]["chi2"]) / r["fit1"]["chi2"]
    direct = abs(r["fit3"]["chi2"] - r["direct_chi2"]) / r["direct_chi2"]
    print(f"pintk on {len(dense)} TOAs in {wall:.2f} s: fits "
          f"{r['fit1']['fitter']} chi2 {r['fit1']['chi2']:.6f} / after reset "
          f"{r['fit2']['chi2']:.6f} / {r['remain']} TOAs after deleting "
          f"{r['selected']} {r['fit3']['chi2']:.6f} (Fitter.auto directly "
          f"{r['direct_chi2']:.6f}, values {gap:.3e} sigma apart); "
          f"{N_PINTK_RANDOM} random models {r['random'].shape} in "
          f"{r['random_s']:.2f} s; par read back {r['par_back']:.3e} sigma, tim "
          f"read back {r['tim_back']} TOAs; chi2 gaps: refit after reset "
          f"{refit:.3e}, against the direct fit {direct:.3e} (bar "
          f"{LOOP_RTOL:g})", flush=True)
    if not (refit <= LOOP_RTOL and direct <= LOOP_RTOL and gap <= 1e-9
            and r["tim_back"] == r["remain"] and r["par_back"] < 1e-6
            and np.all(np.isfinite(r["random"]))):
        fail("pintk's actions on the card disagree with a direct fit")
    small = simulate(PAR_FULL, N_SMALL, seed=9, device="cpu")
    recs = {d: pintk_actions(PintkController(small.to(d), kicked(PAR_FULL)),
                             PINTK_SELECT) for d in ("cuda", "cpu")}
    card, cpu = recs["cuda"], recs["cpu"]
    gaps = [abs(card[k]["chi2"] - cpu[k]["chi2"]) / cpu[k]["chi2"]
            for k in ("fit1", "fit2", "fit3")]
    worst = max(abs(card["values"][k][0] - v[0]) / v[1]
                for k, v in cpu["values"].items())
    rnd = float(np.max(np.abs(card["random"] - cpu["random"]))
                / np.max(np.abs(cpu["random"])))
    print(f"pintk at {N_SMALL} TOAs, card - CPU: chi2 {max(gaps):.3e} relative "
          f"(bar {CARD_CHI2_RTOL:g}), values {worst:.3e} sigma (bar "
          f"{CARD_VALUE_SIGMA:g}), random models {rnd:.3e} of their scale (bar "
          f"{CARD_VALUE_SIGMA:g})", flush=True)
    if max(gaps) > CARD_CHI2_RTOL or worst > CARD_VALUE_SIGMA \
            or card["remain"] != cpu["remain"] or rnd > CARD_VALUE_SIGMA:
        fail("pintk on the card disagrees with the CPU")


def pta_catalogs_pintk(dev, dense):
    """Phase 17 (see the module docstring). Returns the batched kernel's
    shapes, the main fit's launches and records, and the block
    elimination's record."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.ops import gram

    t_phase = time.perf_counter()
    device_loop.clear_cache()
    shapes = check_batched_gram(gram, dev)
    elim = check_block_elim(dev)
    print(f"17a in {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches, cold, warm, fused_ms = pta_baseline(dev)
    print(f"17b at {time.perf_counter() - t_phase:.1f} s", flush=True)
    pta_card_vs_cpu(dev)
    print(f"17c at {time.perf_counter() - t_phase:.1f} s", flush=True)
    device_loop.clear_cache()
    catalog_job_checks(dev)
    print(f"17d at {time.perf_counter() - t_phase:.1f} s", flush=True)
    device_loop.clear_cache()
    pintk_checks(dev, dense)
    device_loop.clear_cache()
    print(f"phase 17 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return shapes, launches, {"cold": cold, "warm": warm, "warm_ms": fused_ms,
                              "elim": elim}


# ----------------------------------------------------------------------
# phase 18: the serving tier
# ----------------------------------------------------------------------

N_SERVE_FITS = 64          # bench.py's _throughput_problems / _mixed_problems
N_SESSION = 100_000        # bench.py's incremental and read problems
K_APPEND = 8
N_APPENDS = 8
N_READ_Q = 256             # bench.py's PINT_TPU_BENCH_READ_Q default
N_SERVE_CARD_CPU = 8
N_SESSION_SMALL = 2_000
SERVE_HYPER = dict(maxiter=20, min_chi2_decrease=1e-3)
# bench.py:624-640's parity bar of a scheduled member against its
# standalone fused fit
SERVE_CHI2_RTOL = 1e-6
SERVE_VALUE_RTOL = 1e-9
SERVE_VALUE_SIGMA = 0.05
CARD_CPU_CHI2_RTOL = 1e-9


def strip_par(par: str, names: tuple) -> str:
    """`par` without the lines whose first token is in `names` (bench.py's
    ``_strip_par_lines``)."""
    return "".join(line for line in par.splitlines(keepends=True)
                   if not line.split()[:1] or line.split()[0] not in names)


PAR_SERVE = strip_par(PAR_FULL, ("EFAC", "ECORR", "TNREDAMP", "TNREDGAM",
                                 "TNREDC"))
# its barycentric form (18f): at GBT the card's and the CPU's libm sin
# and cos part a converged chi2 by up to ~1e-8 (ROADMAP Queue 3, traps)
PAR_SERVE_BARY = strip_par(PAR_BARY, ("EFAC", "ECORR", "TNREDAMP",
                                      "TNREDGAM", "TNREDC"))


def sim_flagged(model, n, freqs, seed, dev, obs="gbt"):
    """bench.py's ``_sim_flagged``: n TOAs uniform over MJD 53000-56000 at
    `obs` at the given frequencies, simulated on the CPU, moved to `dev`."""
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    t = make_fake_toas_uniform(53000, 56000, n, model, obs=obs,
                               freq_mhz=np.asarray(freqs), error_us=1.0,
                               add_noise=True, seed=seed, device="cpu")
    return t if dev.type == "cpu" else t.to(dev)


def throughput_problems(n_fits, dev, base=PAR_SERVE, obs="gbt"):
    """bench.py's ``_throughput_problems``: (par, table) per fit, four
    structures (plain, FD, JUMP+EFAC, PHOFF) x two TOA buckets (50-61 and
    90-119 TOAs), per-request F0 (from `base`, observed at `obs`)."""
    from pint_tpu_torch.models import get_model

    variants = [base, base + "FD1 1.0e-5 1\n",
                base + "JUMP FREQ 300 500 1.0e-4 1\nEFAC FREQ 300 500 1.2\n",
                base + "PHOFF 0.0 1\n"]
    rng = np.random.default_rng(9)
    out = []
    for i in range(n_fits):
        par = variants[i % 4].replace(
            "61.485476554", f"{61.485476554 + 0.05 * (i // 4):.9f}")
        n = int(rng.integers(50, 62) if i % 2 == 0 else rng.integers(90, 120))
        k = np.arange(n) % 3
        freqs = np.where(k == 0, 430.0, np.where(k == 1, 1400.0, 800.0))
        out.append((par, sim_flagged(get_model(par), n, freqs,
                                     int(rng.integers(2 ** 31)), dev, obs)))
    return out


def mixed_problems(n_fits, dev):
    """bench.py's ``_mixed_problems``: (family, par, table) per fit, WLS,
    GLS with ECORR (duplicated arrivals, flagged), GLS with red noise and
    wideband, with per-request F0 and noise values."""
    import dataclasses

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toas import Flags, merge_TOAs

    rng = np.random.default_rng(12)
    out = []
    for i in range(n_fits):
        fam = ("wls", "gls_ecorr", "gls_red", "wb")[i % 4]
        par = PAR_SERVE.replace("61.485476554",
                                f"{61.485476554 + 0.05 * (i // 4):.9f}")
        if fam == "gls_ecorr":
            par += f"EFAC -f fake 1.2\nECORR -f fake 1.{1 + (i // 4) % 4}\n"
        elif fam == "gls_red":
            par += f"TNREDAMP -13.{5 + (i // 4) % 4}\nTNREDGAM 3.5\nTNREDC 6\n"
        truth = get_model(par)
        n = int(rng.integers(25, 32) if fam == "gls_ecorr"
                else rng.integers(50, 62))
        k = np.arange(n) % 3
        freqs = np.where(k == 0, 430.0, np.where(k == 1, 1400.0, 800.0))
        t = sim_flagged(truth, n, freqs, int(rng.integers(2 ** 31)), dev)
        if fam == "gls_ecorr":
            t = merge_TOAs([t, t])
            t = dataclasses.replace(t, flags=Flags(dict(d, f="fake")
                                                   for d in t.flags))
        elif fam == "wb":
            dm = truth.total_dm(t).cpu().numpy()
            t = dataclasses.replace(t, flags=Flags(
                dict(d, pp_dm=str(float(v)), pp_dme="1e-4")
                for d, v in zip(t.flags, dm)))
        out.append((fam, par, t))
    return out


def fresh_requests(problems, tagged=True):
    """One FitRequest per problem, its model's F0 moved by 2e-10."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import FitRequest

    reqs = []
    for i, prob in enumerate(problems):
        par, t = prob[-2], prob[-1]
        m = get_model(par)
        m["F0"].add_delta(2e-10)
        reqs.append(FitRequest(t, m, tag=i if tagged else None, **SERVE_HYPER))
    return reqs


def drain_stream(reqs, devices):
    """Submit `reqs` to a fresh scheduler over `devices` and drain it:
    (results, drain record, wall s, counter deltas, plans)."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.serve import ThroughputScheduler

    s = ThroughputScheduler(devices=devices, max_queue=max(len(reqs), 1))
    before = telemetry.counters_snapshot()
    if devices[0].type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        s.submit(r)
    plans = s.plan()
    res = s.drain()
    wall = time.perf_counter() - t0
    return res, s.last_drain, wall, telemetry.counters_delta(before), plans


def standalone(problems, fit=None):
    """Each problem fitted alone through the fused dense loop of its
    family: [(chi2, converged, {param: value})]; the models are kept (a
    second call replays their captures)."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.models import get_model

    out = []
    for prob in problems:
        fam = prob[0] if len(prob) == 3 else "wls"
        if fit is None or len(fit) < len(problems):
            m = get_model(prob[-2])
            m["F0"].add_delta(2e-10)
            if fit is not None:
                fit.append(m)
        else:
            m = fit[len(out)]
        dense = {"wls": device_loop.dense_wls_fit,
                 "gls_ecorr": device_loop.dense_gls_fit,
                 "gls_red": device_loop.dense_gls_fit,
                 "wb": device_loop.dense_wideband_fit}[fam]
        d, _info, chi2, conv, _cnt = dense(prob[-1], m, **SERVE_HYPER)
        out.append((float(chi2), bool(conv),
                    {k: m[k].value_f64 + float(d[k]) for k in m.free_params}))
    return out


def member_parity(res, reqs, alone, label):
    """bench.py's bar: every scheduled member on its standalone fit (chi2
    within 1e-6 relative, parameters within 1e-9 relative or 5% of
    sigma, the same converged flag)."""
    worst, bad = 0.0, []
    for r, q, (chi2, conv, vals) in zip(res, reqs, alone):
        rel = abs(r.chi2 - chi2) / abs(chi2)
        worst = max(worst, rel)
        m = q.model
        p_ok = all(abs(m[k].value_f64 - vals[k])
                   <= max(SERVE_VALUE_RTOL * abs(vals[k]),
                          SERVE_VALUE_SIGMA * m[k].uncertainty)
                   for k in m.free_params)
        if not (r.status in ("ok", "nonconverged") and rel <= SERVE_CHI2_RTOL
                and r.converged == conv and p_ok):
            bad.append((r.tag, r.status, r.chi2, chi2, r.converged, conv))
    print(f"  {label}: {len(res)} members against their standalone fits, "
          f"worst chi2 gap {worst:.3e} relative (bar {SERVE_CHI2_RTOL:g})",
          flush=True)
    if bad:
        fail(f"{label}: members off their standalone fits: {bad[:4]}")


def serve_throughput(dev, card):
    """18a: bench.py's 64-fit stream through the scheduler against the
    same fits one after another through ``dense_wls_fit``."""
    from pint_tpu_torch.fitting import device_loop

    problems = throughput_problems(N_SERVE_FITS, dev)
    # the sequential side's 64 fits each hold a capture (one model each):
    # the loop cache keeps them all, so its warm pass replays
    device_loop._LOOP_CACHE.maxsize = 4 * N_SERVE_FITS
    seq_models = []
    try:
        t0 = time.perf_counter()
        alone = standalone(problems, seq_models)
        torch.cuda.synchronize()
        seq_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = standalone(problems, seq_models)
        torch.cuda.synchronize()
        seq_warm = time.perf_counter() - t0
    finally:
        device_loop._LOOP_CACHE.maxsize = 8
        device_loop.clear_cache()
    reqs = fresh_requests(problems)
    res, rec, cold, d_cold, plans = drain_stream(reqs, [dev])
    member_parity(res, reqs, alone, "scheduled (cold)")
    reqs = fresh_requests(problems)
    res, rec, warm, d_warm, plans = drain_stream(reqs, [dev])
    member_parity(res, reqs, alone, "scheduled (warm)")
    keys = len({(p.group, p.toa_bucket) for p in plans})
    n_b = len(plans)
    print(f"{card}: {N_SERVE_FITS} fits in {n_b} batches over {keys} plan "
          f"keys (members {[p.n_members for p in plans]}, occupancy "
          f"{rec['occupancy']}); scheduled cold {cold:.3f} s, warm {warm:.3f} "
          f"s ({N_SERVE_FITS / warm:.1f} fits/s); one after another through "
          f"dense_wls_fit cold {seq_cold:.3f} s, warm {seq_warm:.3f} s "
          f"({N_SERVE_FITS / seq_warm:.1f} fits/s); warm speedup "
          f"{seq_warm / warm:.2f}x", flush=True)
    caps_cold = int(d_cold.get("fit.device_loop.captures", 0))
    caps_warm = int(d_warm.get("fit.device_loop.captures", 0))
    replays = int(d_warm.get("fit.device_loop.replays", 0))
    fetches = int(d_warm.get("fit.device_loop.fetches", 0))
    print(f"  captures cold {caps_cold} ({caps_cold // 2} loops: one per plan "
          f"key), warm {caps_warm}; warm replays {replays / n_b:.1f} and "
          f"fetches {fetches / n_b:.1f} per batch; statuses "
          f"{rec['statuses']}; overlap efficiency "
          f"{rec['overlap_efficiency']}", flush=True)
    # a capture is two graphs (full body, probe); the CPU captures none
    want = 2 * keys if dev.type == "cuda" else 0
    if not (caps_cold == want and caps_warm == 0
            and rec["statuses"] == {"ok": N_SERVE_FITS}):
        fail(f"18a: {caps_cold} captures cold for {keys} plan keys, "
             f"{caps_warm} warm, statuses {rec['statuses']}")
    profile_step("one warm drain of the 64-fit stream",
                 lambda: drain_stream(fresh_requests(problems), [dev]),
                 warm * 1e3)
    return problems, alone, warm


def serve_mixed(dev, card):
    """18b: bench.py's mixed frontier (WLS, GLS with ECORR, GLS with red
    noise, wideband) batched through the union loop."""
    problems = mixed_problems(N_SERVE_FITS, dev)
    alone = standalone(problems)
    reqs = fresh_requests(problems)
    res, rec, wall, delta, plans = drain_stream(reqs, [dev])
    member_parity(res, reqs, alone, "mixed frontier")
    print(f"{card}: {N_SERVE_FITS} mixed fits in {len(plans)} batches "
          f"({[(p.kind, p.n_members, p.basis_bucket) for p in plans]}) in "
          f"{wall:.3f} s cold; passthrough {rec['passthrough']}; statuses "
          f"{rec['statuses']}", flush=True)
    if rec["passthrough"]["requests"] or any(p.kind != "batched"
                                             for p in plans):
        fail(f"18b: mixed requests left the batched path: "
             f"{rec['passthrough']}")
    device_loop_clear()


def device_loop_clear():
    from pint_tpu_torch.fitting import device_loop

    device_loop.clear_cache()


def session_appends(dev, k, count, seed, par=PAR_SERVE, obs="gbt"):
    """`count` append tables of `k` TOAs (bench.py's: uniform over 15 days
    from MJD 58010 + 20 i, 1400 MHz, 1 us) from `par` at `obs`,
    simulated on the CPU."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    truth = get_model(par)
    out = []
    for i in range(count):
        mjds = np.sort(rng.uniform(58010 + 20 * i, 58025 + 20 * i, size=k))
        t = make_fake_toas_from_arrays(
            DD(mjds, np.zeros(k)), truth, freq_mhz=np.full(k, 1400.0),
            error_us=1.0, obs=obs, add_noise=True,
            seed=int(rng.integers(2 ** 31)), niter=2, device="cpu")
        out.append(t.to(dev) if dev.type == "cuda" else t)
    return out


def run_session(s, sid, table, model, appends, label):
    """Populate session `sid`, then append each table in its own drain.
    Every append must resolve ok through the incremental route, or
    through a full refit that the session's own drift gates chose (the
    reference's rule). Returns the populate wall, the update walls, the
    replays and fetches per update, the results and the gate trips."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.serve import FitRequest

    t0 = time.perf_counter()
    s.submit(FitRequest(table, model, session_id=sid, **SERVE_HYPER))
    r0 = s.drain()[0]
    populate_s = time.perf_counter() - t0
    if r0.status != "ok" or r0.session != "populate":
        fail(f"{label}: populate {r0.status} {r0.error}")
    walls, replays, fetches, res, trips = [], [], [], [], 0
    for app in appends:
        before = telemetry.counters_snapshot()
        t0 = time.perf_counter()
        s.submit(FitRequest(app, None, session_id=sid, **SERVE_HYPER))
        r = s.drain()[0]
        walls.append(time.perf_counter() - t0)
        delta = telemetry.counters_delta(before)
        replays.append(int(delta.get("fit.device_loop.replays", 0)))
        fetches.append(int(delta.get("fit.device_loop.fetches", 0)))
        res.append(r)
        gated = sum(int(delta.get(f"serve.session.refit.{g}", 0))
                    for g in ("drift_gate", "append_gate"))
        trips += gated
        if r.status != "ok" or not (r.session == "incremental"
                                    or (r.session == "full_refit" and gated)):
            fail(f"{label}: append {len(res)} took {r.session} ({r.status}, "
                 f"{r.error}; {delta})")
    return populate_s, walls, replays, fetches, res, trips


def serve_sessions(dev, card, toas6):
    """18c: a converged 100,000-TOA WLS session (bench.py's incremental
    problem) and a GLS session on phase 6's table, 8 appends of 8 TOAs
    each, against warm-started full fused refits; a forced drift-gate
    trip repopulates bit for bit."""
    import copy
    import os

    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import (DRIFT_CHI2_REL, FitRequest,
                                      ThroughputScheduler)
    from pint_tpu_torch.toas import merge_TOAs

    rng = np.random.default_rng(13)
    truth = get_model(PAR_SERVE)
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    mjds = np.sort(rng.uniform(50000.0, 58000.0, size=N_SESSION))
    t0 = time.perf_counter()
    table = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(N_SESSION)), truth,
        freq_mhz=np.where(rng.random(N_SESSION) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs="gbt", add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2, device=dev)
    torch.cuda.synchronize()
    print(f"simulated the {N_SESSION}-TOA session table on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    appends = session_appends(dev, K_APPEND, N_APPENDS + 2, 14)
    results = {}
    for kind, par, tab in (("WLS", PAR_SERVE, table),
                           ("GLS", PAR_FULL, toas6)):
        s = ThroughputScheduler(devices=[dev], max_queue=8)
        m = get_model(par)
        m["F0"].add_delta(2e-10)
        apps = appends if kind == "WLS" else session_appends(
            dev, K_APPEND, N_APPENDS + 2, 15)
        # the first append captures the update's loop (not timed, as
        # bench.py warms its program on append 0)
        populate_s, walls, replays, fetches, res, trips = run_session(
            s, "s", tab, m, apps[:N_APPENDS + 1], f"18c {kind}")
        walls, replays, fetches = walls[1:], replays[1:], fetches[1:]
        incr = [w for w, r in zip(walls, res[1:])
                if r.session == "incremental"]
        if not incr:
            fail(f"18c: no {kind} append took the incremental route")
        entry = s.sessions.entries[s.sessions._by_sid["s"]]
        if entry.family != kind.lower():
            fail(f"18c: the {kind} session holds a {entry.family} state")
        # the warm-started fused refit over the same accumulated table
        dense = (device_loop.dense_wls_fit if kind == "WLS"
                 else device_loop.dense_gls_fit)
        merged = merge_TOAs([tab] + apps[:N_APPENDS + 1])
        warm_walls = []
        for _ in range(3):
            mw = copy.deepcopy(entry.model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _d, _i, chi2_full, conv, _c = dense(merged, mw, **SERVE_HYPER)
            warm_walls.append(time.perf_counter() - t0)
        drift = abs(res[-1].chi2 - chi2_full) / chi2_full
        p50, p95 = np.percentile(incr, 50), np.percentile(incr, 95)
        print(f"{card}: {kind} session over {len(tab)} TOAs: populate "
              f"{populate_s:.3f} s; {N_APPENDS} timed appends of {K_APPEND} "
              f"TOAs (after one that captures): routes "
              f"{[r.session for r in res[1:]]} ({trips} drift-gate trips); "
              f"incremental update p50 {p50 * 1e3:.2f} ms, p95 "
              f"{p95 * 1e3:.2f} ms (scheduler submit + drain); warm-started "
              f"fused refit over the {len(merged)}-TOA accumulated table "
              f"{np.median(warm_walls) * 1e3:.2f} ms (median of 3), "
              f"{np.median(warm_walls) / p50:.1f}x the update; chi2 drift "
              f"against it {drift:.3e} (gate {DRIFT_CHI2_REL:g}); replays per "
              f"update {replays}, fetches {fetches}", flush=True)
        if not (conv and drift < DRIFT_CHI2_REL):
            fail(f"18c: the {kind} session drifted {drift} from its refit")
        results[kind] = (s, entry, apps)
    # a forced drift-gate trip: the refit's committed state is bit for
    # bit a cold populate from the same warm values over the same table
    s, entry, apps = results["WLS"]
    warm = copy.deepcopy(entry.model)
    os.environ["PINT_TORCH_SESSION_MAX_APPENDS"] = "0"
    try:
        s.submit(FitRequest(apps[N_APPENDS + 1], None, session_id="s",
                            **SERVE_HYPER))
        r = s.drain()[0]
    finally:
        os.environ.pop("PINT_TORCH_SESSION_MAX_APPENDS", None)
    s2 = ThroughputScheduler(devices=[dev], max_queue=8)
    s2.submit(FitRequest(entry.toas, warm, session_id="cold", **SERVE_HYPER))
    r2 = s2.drain()[0]
    e2 = s2.sessions.entries[s2.sessions._by_sid["cold"]]
    same = (r.session == "full_refit" and r.chi2 == r2.chi2
            and all(torch.equal(entry.state[f], e2.state[f])
                    for f in ("L", "norm", "mu", "chi2"))
            and all(entry.model[k].value == e2.model[k].value
                    for k in entry.model.free_params))
    print(f"  forced drift-gate trip: route {r.session}, chi2 {r.chi2!r}; a "
          f"cold populate from the same values {r2.chi2!r}; bit for bit "
          f"{same}", flush=True)
    if not same:
        fail("18c: the gate-tripped refit is not the cold populate")
    return results["WLS"][0], table, results["WLS"][2]


def serve_reads(dev, card, s):
    """18d: reads from the fitted 100,000-TOA session: the window warmed,
    batched predictions with and without a fit drain in flight, parity
    against the host Polycos and dense_predict, the kill switch."""
    import os

    from pint_tpu_torch import telemetry
    from pint_tpu_torch.parallel.batch import BatchedPulsarFitter
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.predict import (FREQ_PARITY_REL, PHASE_PARITY_CYCLES,
                                        dense_predict, engine)
    from pint_tpu_torch.serve import PredictRequest

    rng = np.random.default_rng(17)

    def q_batch():
        return np.sort(rng.uniform(54000.0005, 54000.9995, N_READ_Q))

    first = s.predict(PredictRequest(q_batch(), session_id="s"))
    hit = s.predict(PredictRequest(q_batch(), session_id="s"))
    if not (first.source == "dense" and hit.cache_hit
            and hit.source == "cheb"):
        fail(f"18d: the read ladder served {first.source} then {hit.source}")
    qp = q_batch()
    rp = s.predict(PredictRequest(qp, session_id="s"))
    model = s.sessions.lookup_for_read("s")[1].model
    dpi, dpf, _ = dense_predict(model, qp, device=dev)
    w = engine.window_days()
    pcs = Polycos.generate_polycos(
        model, np.floor(qp[0] / w) * w, np.floor(qp[0] / w) * w + w,
        obs="@", segment_length_min=engine.segment_minutes(),
        ncoeff=engine.read_ncoeff(), device=dev)
    hpi, hpf = pcs.eval_abs_phase(qp)
    gap_dense = float(np.max(np.abs((rp.phase_int - dpi)
                                    + (rp.phase_frac - dpf))))
    gap_host = float(np.max(np.abs((rp.phase_int - hpi)
                                   + (rp.phase_frac - hpf))))
    gap_freq = float(np.max(np.abs(rp.freq_hz / pcs.eval_spin_freq(qp) - 1)))
    before = telemetry.counters_snapshot()
    lats, t0 = [], time.perf_counter()
    while len(lats) < 400 and time.perf_counter() - t0 < 2.0:
        r = s.predict(PredictRequest(q_batch(), session_id="s"))
        if not (r.status == "ok" and r.cache_hit):
            fail(f"18d: a warm read {r.status} from {r.source}")
        lats.append(r.latency_s)
    wall = time.perf_counter() - t0
    fit_launches = int(telemetry.counters_delta(before).get(
        "fit.device_loop.launches", 0))
    # reads while a fit drain is in flight on the same card
    from pint_tpu_torch.models import get_model

    table = s.sessions.lookup_for_read("s")[1].accumulated()
    lats_c = []
    for rep in range(2):
        m = get_model(PAR_SERVE)
        m["F0"].add_delta(2e-10 * (1 + rep))
        bf = BatchedPulsarFitter([(table, m)], device=dev)
        h = bf.dispatch_fit(**SERVE_HYPER)
        while not h.ready() and len(lats_c) < 2000:
            r = s.predict(PredictRequest(q_batch(), session_id="s"))
            lats_c.append(r.latency_s)
        h.finish()
    os.environ["PINT_TORCH_READ_PATH"] = "0"
    try:
        kill = s.predict(PredictRequest(qp, session_id="s"))
    finally:
        os.environ.pop("PINT_TORCH_READ_PATH", None)
    gap_kill = float(np.max(np.abs((kill.phase_int - rp.phase_int)
                                   + (kill.phase_frac - rp.phase_frac))))

    def pct(v, p):
        return float(np.percentile(v, p)) * 1e3 if v else float("nan")

    print(f"{card}: {len(lats)} reads of {N_READ_Q} queries in {wall:.3f} s: "
          f"{len(lats) * N_READ_Q / wall:.1f} predictions/s; read p50 "
          f"{pct(lats, 50):.3f} ms, p99 {pct(lats, 99):.3f} ms; with a fit "
          f"drain in flight ({len(lats_c)} reads) p50 {pct(lats_c, 50):.3f} "
          f"ms, p99 {pct(lats_c, 99):.3f} ms; fit loops launched by the "
          f"reads {fit_launches}", flush=True)
    print(f"  phase against dense_predict {gap_dense:.3e} cycles, against "
          f"the host Polycos {gap_host:.3e} (bar {PHASE_PARITY_CYCLES:g}); "
          f"frequency {gap_freq:.3e} (bar {FREQ_PARITY_REL:g}); the kill "
          f"switch served {kill.source}, {gap_kill:.3e} cycles from the "
          f"engine", flush=True)
    if not (gap_dense < PHASE_PARITY_CYCLES and gap_host < PHASE_PARITY_CYCLES
            and gap_freq < FREQ_PARITY_REL and fit_launches == 0
            and kill.source == "host_polycos"
            and gap_kill < PHASE_PARITY_CYCLES):
        fail("18d: the read path is off its parity bars")


def serve_faults(dev, card, problems):
    """18e: a stream with a NaN member, a singular member and one
    transient device error: quarantined, ok (as the reference resolves
    it: the solve's eps floor absorbs the duplicate column) and retried;
    the drain returns."""
    import dataclasses

    from pint_tpu_torch.serve import ThroughputScheduler, faults

    reqs = fresh_requests([p for p in problems[:16:4]] * 2)
    t = reqs[1].toas
    err = t.error_us.clone()
    err[3] = float("nan")
    reqs[1].toas = dataclasses.replace(t, error_us=err)
    plan = faults.FaultPlan(seed=0, device_err=1.0)
    reqs[2].model = plan._singular_model(reqs[2].model)
    faults.configure(plan)
    try:
        s = ThroughputScheduler(devices=[dev], max_queue=16,
                                retry_backoff_s=0.0)
        for r in reqs:
            s.submit(r)
        res = s.drain()
    finally:
        faults.configure(None)
    statuses = [(r.status, r.attempts) for r in res]
    print(f"{card}: injected NaN (member 1), singular (member 2) and one "
          f"transient device error per batch: statuses and attempts "
          f"{statuses}; failed batches {s.last_drain['failed_batches']}",
          flush=True)
    if not (res[1].status == "quarantined" and res[1].trace is not None
            and res[2].status == "ok"
            and all(r.status == "ok" and r.attempts == 2
                    for i, r in enumerate(res) if i != 1)):
        fail(f"18e: {statuses}")


def serve_card_vs_cpu(dev, card):
    """18f: 8 requests of 18a's stream and a 2,000-TOA session with two
    appends, on the card and on the CPU: the same plans, statuses and
    routes, chi2 within 1e-9 relative. Barycentric: at GBT the card's and
    the CPU's sin and cos part a converged chi2 by up to ~1e-8."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import ThroughputScheduler

    cpu = torch.device("cpu")
    out = []
    problems = throughput_problems(N_SERVE_CARD_CPU, cpu, base=PAR_SERVE_BARY,
                                   obs="@")
    small = simulate(PAR_BARY, N_SESSION_SMALL, seed=21, device="cpu")
    apps = session_appends(cpu, K_APPEND, 2, 22, par=PAR_SERVE_BARY, obs="@")
    for d in (dev, cpu):
        probs = [(p, t.to(d)) for p, t in problems]
        res, _rec, _w, _delta, plans = drain_stream(fresh_requests(probs),
                                                    [d])
        s = ThroughputScheduler(devices=[d], max_queue=8)
        m = get_model(PAR_SERVE_BARY)
        m["F0"].add_delta(2e-10)
        tab = small.to(d) if d.type == "cuda" else small
        _p, _w, _r, _f, sres, _t = run_session(
            s, "x", tab, m, [a.to(d) for a in apps], "18f")
        out.append((res, [(p.kind, p.group, p.toa_bucket, p.n_members)
                          for p in plans], sres))
    (gres, gplans, gsres), (cres, cplans, csres) = out
    worst = max(abs(a.chi2 - b.chi2) / abs(b.chi2)
                for a, b in zip(gres + gsres, cres + csres))
    same = ([r.status for r in gres] == [r.status for r in cres]
            and [(r.status, r.session) for r in gsres]
            == [(r.status, r.session) for r in csres] and gplans == cplans)
    print(f"{card}: {N_SERVE_CARD_CPU} scheduled fits of 18a's structures "
          f"and a {N_SESSION_SMALL}-TOA session with 2 appends, barycentric, "
          f"card against CPU: plans, statuses and routes the same {same}; "
          f"worst chi2 gap {worst:.3e} relative (bar {CARD_CPU_CHI2_RTOL:g})",
          flush=True)
    if not (same and worst <= CARD_CPU_CHI2_RTOL):
        fail("18f: the serving tier on the card disagrees with the CPU")


def serving_tier(dev, toas6):
    """Phase 18: the serving tier on the card (18a-18g). Returns its
    ds32_gram launches, counted from 0 (the reference's serving tier
    reaches no Pallas kernel: its batched and incremental Grams are
    float64), and what phase 19 reuses: 18a's problems, their standalone
    fits and the warm drain's wall, 18c's WLS session table and its
    appends."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.ops import gram

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    device_loop_clear()
    telemetry.reset()
    telemetry.configure(enabled=True)
    # the per-table notices (no clock files, the analytic ephemeris) of
    # the ~300 tables built here are printed once, by the earlier phases
    quiet = [logging.getLogger(f"pint_tpu_torch.{m}")
             for m in ("observatory", "ephemeris")]
    levels = [lg.level for lg in quiet]
    for lg in quiet:
        lg.setLevel(logging.ERROR)
    gram.ds32_gram.launches = gram.ds32_gram_batched.launches = 0
    try:
        phase("18a throughput: bench.py's 64-fit stream")
        problems, alone, warm = serve_throughput(dev, card)
        phase("18b the mixed frontier: bench.py's _mixed_problems")
        serve_mixed(dev, card)
        phase(f"18c sessions: {N_SESSION}-TOA WLS and GLS sessions, "
              f"{N_APPENDS} appends of {K_APPEND} TOAs")
        s, session_table, session_apps = serve_sessions(dev, card, toas6)
        phase(f"18d reads: batched predictions of {N_READ_Q} queries")
        serve_reads(dev, card, s)
        phase("18e failure domains on the card")
        serve_faults(dev, card, problems)
        phase("18f card against CPU")
        serve_card_vs_cpu(dev, card)
    finally:
        telemetry.reset()
        for lg, level in zip(quiet, levels):
            lg.setLevel(level)
    launches = gram.ds32_gram.launches + gram.ds32_gram_batched.launches
    phase("18g ds32_gram launches in the serving tier")
    print(f"{card}: ds32_gram launches in 18a-18f: {gram.ds32_gram.launches}, "
          f"ds32_gram_batched {gram.ds32_gram_batched.launches} (the serving "
          f"tier's Grams are float64, as the reference's)", flush=True)
    if launches:
        fail(f"18g: the serving tier launched ds32_gram {launches} times")
    device_loop_clear()
    return {"launches": launches, "problems": problems, "alone": alone,
            "warm_s": warm, "session_table": session_table,
            "session_appends": session_apps}


# ----------------------------------------------------------------------
# phase 19: the fleet tier
# ----------------------------------------------------------------------

N_FLEET_APPENDS = 4        # 19d: appends of K_APPEND TOAs to the session
N_FLEET_READS = 20         # 19f: timed reads before and after the join
N_FLEET_READ_Q = 64        # queries per read
# 19b/19c measure stickiness: a queue never deep enough to steal a cold
# structure, so each of the stream's four structures lands on one host
NO_STEAL = dict(steal_depth=4 * N_SERVE_FITS)

# the second and third processes of 19a: each finds the kernel library
# in the store (and builds nothing), runs ds32_gram on phase 4's q = 66
# input, and drives the head of 18a's stream through a scheduler, whose
# captures journal their program keys in the store (the first) or find
# them there (the second: restored, byte-identical, nothing journaled)
STORE_CHILD = r"""
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from pint_tpu_torch import compile_cache, telemetry
from pint_tpu_torch.ops import gram, library
from pint_tpu_torch.programs.store import store
from pint_tpu_torch.serve import ThroughputScheduler
telemetry.configure(enabled=True)
compile_cache.enable_persistent_cache(sys.argv[2])
dev = torch.device(sys.argv[5])
A = torch.load(sys.argv[3]).to(dev)
G = gram.ds32_gram(A)
torch.save(G.cpu(), sys.argv[4])
launches = gram.ds32_gram.launches
sched = ThroughputScheduler(devices=[dev])
for r in cs.fresh_requests(cs.throughput_problems(int(sys.argv[6]), dev)):
    sched.submit(r)
res = sched.drain()
c = telemetry.counters_snapshot()
print(json.dumps({
    "keys": store().export_keys(), "library": gram.LIBRARY.key(),
    "restored": int(c.get("cache.fit_program.restored", 0)),
    "captures": int(c.get("cache.fit_program.miss", 0)),
    "status": sorted({r.status for r in res}),
    "builds": {k: int(c.get(f"programs.kernel.{k}", 0))
               for k in ("store", "build_dir", "nvcc", "corrupt")},
    "loaded": gram.LIBRARY.loaded, "launches": launches,
    "build_dir": str(library.BUILD_DIR)}))
"""
N_STORE_FITS = 8           # 19a: fits of 18a's stream in each process


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def store_child(work, root, dev, label):
    """One process of 19a on the store at `root`: (its record, its G,
    wall)."""
    out_g = work / f"G66_{label}.pt"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", STORE_CHILD, str(ROOT), str(work / label),
         str(work / "A66.pt"), str(out_g), str(dev), str(N_STORE_FITS)],
        env=dict(os.environ, PINT_TORCH_PROGRAM_CACHE_DIR=str(root)),
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"19a: the {label} process failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), \
        torch.load(out_g), wall


def fleet_store(dev, card, work):
    """19a: phase 2's library stored; two more processes on the store
    each build nothing and match this process's G bit for bit, and the
    second derives the first's program keys from the same fits (counted
    restored, nothing new journaled); a truncated library in a fourth
    store is a counted miss and is rebuilt from source. Returns (store
    root, library sha256, the other processes' ds32_gram launches)."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.ops import gram
    from pint_tpu_torch.programs import ProgramStore
    from pint_tpu_torch.programs.store import file_digest

    root = work / "store_a"
    st = ProgramStore(str(root))
    lib, _log = gram.build(store=st)
    size, digest = file_digest(lib)
    print(f"stored {lib.name} ({size} bytes, sha256 {digest[:16]}...) in a "
          f"fresh store: {st.stats()['kernels']}", flush=True)
    A = whitened(N_TOAS, 66, seed=N_TOAS, device=dev)
    G1 = gram.ds32_gram(A)
    torch.save(A.cpu(), work / "A66.pt")
    scale = float(G1.abs().max())
    manifest = root / "manifest.jsonl"
    recs, launches = {}, 0
    for label in ("first", "second"):
        out, G2, wall = store_child(work, root, dev, label)
        recs[label] = out
        launches += out["launches"]
        err_plain = float((G2.to(dev) - gram.ds32_gram_reference(A))
                          .abs().max())
        bitwise = torch.equal(G2, G1.cpu())
        lines = manifest.read_text().splitlines() if manifest.exists() else []
        out["manifest"] = lines
        print(f"{card}: the {label} process on the store ({wall:.2f} s, "
              f"fresh build directory {out['build_dir']}): builds "
              f"{out['builds']}, library from {out['loaded'].get('origin')}"
              f" (sha256 {str(out['loaded'].get('sha256'))[:16]}...), "
              f"{out['launches']} ds32_gram launch(es); G at ({N_TOAS}, 66) "
              f"bit for bit this process's {bitwise}, against the plain "
              f"version {err_plain / scale:.3e} of max|G| (bar "
              f"{PLAIN_BAR:g}); {N_STORE_FITS} fits of 18a's stream "
              f"{out['status']}: captures (cache.fit_program.miss) "
              f"{out['captures']}, cache.fit_program.restored "
              f"{out['restored']}, program keys held {len(out['keys'])}, "
              f"manifest lines {len(lines)}", flush=True)
        # (a CPU rehearsal runs the plain version: no library is loaded)
        loaded_ok = dev.type != "cuda" or (
            out["loaded"].get("origin") == "store"
            and out["loaded"].get("sha256") == digest
            and out["launches"] >= 1)
        if not (out["builds"]["nvcc"] == 0 and loaded_ok and bitwise
                and out["library"] == gram.LIBRARY.key()
                and err_plain <= PLAIN_BAR * scale):
            fail(f"19a: the {label} process: {out}")
    first, second = recs["first"], recs["second"]
    same = second["keys"] == first["keys"] and \
        second["manifest"] == first["manifest"]
    print(f"  program keys from real dispatches: the first process "
          f"journaled {len(first['keys'])}, the second derived the same "
          f"{same} and counted {second['restored']} restored beside "
          f"{second['captures']} captures (a capture is never a hit)",
          flush=True)
    if not (first["restored"] == 0 and len(first["keys"]) >= 1 and same
            and second["restored"] == len(first["keys"])
            and second["captures"] == first["captures"] >= 1):
        fail(f"19a: the program keys did not carry across processes: "
             f"{first['keys']} / {second['keys']}")
    # a fourth store holding a truncated copy of the library
    telemetry.configure(enabled=True)
    third = ProgramStore(str(work / "store_c"))
    bad = pathlib.Path(third.kernel_dir) / lib.name
    shutil.copyfile(lib, bad)
    shutil.copyfile(f"{lib}.sha256", f"{bad}.sha256")
    with open(bad, "r+b") as fh:
        fh.truncate(size // 2)
    before = telemetry.counters_snapshot()
    t0 = time.perf_counter()
    rebuilt, _log = gram.build(store=third, build_dir=work / "build_c")
    rebuild_s = time.perf_counter() - t0
    nvcc = int(telemetry.counters_delta(before).get("programs.kernel.nvcc",
                                                    0))
    gram.LIBRARY.bind(rebuilt)
    held = third.kernel_library(lib.name)
    print(f"  a truncated copy ({size // 2} of {size} bytes) in a fourth "
          f"store: store misses counted corrupt {third.counts['corrupt']}, "
          f"nvcc runs {nvcc}, rebuilt from source in {rebuild_s:.2f} s; the "
          f"rebuilt library loads and the store now holds it verified "
          f"{held is not None}", flush=True)
    if not (third.counts["corrupt"] == 1 and nvcc == 1 and held is not None):
        fail("19a: the truncated library was not a counted miss rebuilt "
             "from source")
    return root, digest, launches


def fleet_stream(router, problems, alone, label, kill=None):
    """One round of 18a's stream through `router`: (results, wall, the
    requests' hosts). `kill(handles)` (optional) runs after the submits,
    before the drain."""
    reqs = fresh_requests(problems)
    t0 = time.perf_counter()
    handles = [router.submit(r) for r in reqs]
    if kill is not None:
        kill(handles)
    res = router.drain()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    member_parity(res, reqs, alone, label)
    bad = [(r.tag, r.status) for r in res if r.status != "ok"]
    if bad or len(res) != len(reqs):
        fail(f"19: {label}: {len(res)} of {len(reqs)} resolved, {bad[:4]}")
    return res, wall, [h.host for h in handles]


def fleet_loopback(dev, card, serve):
    """19b: build_fleet(2) with two schedulers on the card, 18a's stream
    twice: round 2 lands on round 1's hosts and captures nothing."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.fleet import build_fleet

    device_loop_clear()
    device_loop._LOOP_CACHE.maxsize = 32
    try:
        router = build_fleet(2, devices=[dev], max_queue=4 * N_SERVE_FITS,
                             router_kwargs=NO_STEAL)
        walls, hosts, caps = [], [], []
        for rnd in (1, 2):
            before = telemetry.counters_snapshot()
            _res, wall, h = fleet_stream(router, serve["problems"],
                                         serve["alone"],
                                         f"loopback fleet round {rnd}")
            d = telemetry.counters_delta(before)
            walls.append(wall)
            hosts.append(h)
            caps.append(int(d.get("fit.device_loop.captures", 0)))
    finally:
        device_loop._LOOP_CACHE.maxsize = 8
        device_loop_clear()
    split = {hid: hosts[0].count(hid) for hid in sorted(set(hosts[0]))}
    print(f"{card}: loopback fleet of 2 schedulers on the card, 18a's "
          f"{N_SERVE_FITS}-fit stream: round 1 {walls[0]:.3f} s ({caps[0]} "
          f"captures), round 2 {walls[1]:.3f} s ({caps[1]} captures), "
          f"requests per host {split}; 18a's single-scheduler warm drain "
          f"{serve['warm_s']:.3f} s", flush=True)
    want = caps[0] > 0 if dev.type == "cuda" else True
    if not (hosts[1] == hosts[0] and caps[1] == 0 and want):
        fail(f"19b: round 2 moved or captured: captures {caps}, "
             f"split {split}")


def spawn(n, dev, env_per_worker, prefix, distributed=False):
    from pint_tpu_torch.fleet import TcpHost
    from pint_tpu_torch.fleet.worker import spawn_local_workers

    t0 = time.perf_counter()
    workers = spawn_local_workers(
        n, device="cuda" if dev.type == "cuda" else "cpu",
        env=dict(PYTHONPATH=str(ROOT), PINT_TORCH_TELEMETRY="1"),
        env_per_worker=env_per_worker, ready_timeout_s=180,
        distributed=distributed, coord_port=free_port(), prefix=prefix)
    wall = time.perf_counter() - t0
    hosts = [TcpHost(h, ("127.0.0.1", p), timeout_s=600)
             for h, p, _ in workers]
    SPAWNED.append((workers, hosts))
    return workers, hosts, wall


# every worker phase 19 starts, stopped at its end whatever happened
SPAWNED: list = []


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def stop_workers(workers, hosts):
    for h in hosts:
        try:
            h.shutdown()
        except Exception:  # noqa: BLE001 — a killed worker is gone
            pass
    for _hid, _port, p in workers:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def fleet_tcp(dev, card, serve, work, store_root, jsonl):
    """19c: two spawn_local_workers processes on the card over TCP, one
    gloo group: 18a's stream twice (round 2: zero new captures in either
    worker's report op), then a third round whose host is SIGKILLed with
    its requests pending: every request resolves on the survivor."""
    import signal

    from pint_tpu_torch.fleet import FleetRouter

    stores = []
    for i in range(2):
        st = work / f"store_w{i}"
        shutil.copytree(store_root, st)
        stores.append(st)
    workers, hosts, spawn_s = spawn(
        2, dev, [{"PINT_TORCH_PROGRAM_CACHE_DIR": str(stores[i]),
                  "PINT_TORCH_TELEMETRY_PATH": str(jsonl[f"w{i}"])}
                 for i in range(2)], "w", distributed=True)
    procs = {h: p for h, _port, p in workers}
    router = FleetRouter(hosts, **NO_STEAL)
    walls, misses = [], []
    for rnd in (1, 2):
        _res, wall, _h = fleet_stream(router, serve["problems"],
                                      serve["alone"], f"TCP fleet round {rnd}")
        walls.append(wall)
        misses.append({h.host_id: h.report()["program_misses"]
                       for h in hosts})
    reps = {h.host_id: h.report() for h in hosts}
    modes = {hid: r["distributed"] for hid, r in reps.items()}
    print(f"{card}: 2 worker processes on the card ({spawn_s:.2f} s to "
          f"ready): round 1 {walls[0]:.3f} s, round 2 {walls[1]:.3f} s; "
          f"cache.fit_program.miss per worker after each round {misses}; "
          f"init_distributed {modes}", flush=True)
    for hid, r in reps.items():
        print(f"  {hid} report: queue {r['queue_depth']}, sessions "
              f"{r['sessions']}, device {r['device']}, programs "
              f"{ {k: r['programs'][k] for k in ('kernels', 'kernel_put', 'kernel_hit', 'restored', 'corrupt')} }",
              flush=True)
    if not (misses[1] == misses[0] and all(
            r["programs"] and r["programs"]["kernels"] for r in reps.values())
            and all(m.startswith("initialized(N=2") for m in modes.values())):
        fail(f"19c: round 2 captured ({misses}) or the workers' reports "
             f"lack their stores or group: {modes}")
    killed = {}

    def kill(handles):
        victim = max(procs, key=lambda hid: sum(h.host == hid
                                                for h in handles))
        killed["hid"] = victim
        killed["pending"] = sum(h.host == victim for h in handles)
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)

    res, wall, _h = fleet_stream(router, serve["problems"], serve["alone"],
                                 "TCP fleet round 3 (a worker killed)", kill)
    survivors = {r.host for r in res}
    print(f"  round 3: {killed['hid']} SIGKILLed holding "
          f"{killed['pending']} pending requests; all {len(res)} resolved "
          f"on {sorted(survivors)} in {wall:.3f} s (failovers "
          f"{router.last_drain['failovers']})", flush=True)
    if killed["hid"] in survivors:
        fail("19c: a request resolved on the killed worker")
    return router, workers


def read_walls(router, model, n=N_FLEET_READS):
    from pint_tpu_torch.serve import PredictRequest

    rng = np.random.default_rng(23)
    out = []
    for _ in range(n):
        q = np.sort(rng.uniform(54000.0005, 54000.9995, N_FLEET_READ_Q))
        t0 = time.perf_counter()
        r = router.predict(PredictRequest(q, model=model))
        out.append(time.perf_counter() - t0)
        if r.status != "ok":
            fail(f"19f: a read {r.status}: {r.error}")
    return out, r.host


def fleet_join(dev, card, serve, work, router, jsonl, digest):
    """19f: a third worker with an empty store joins mid-stream: it
    adopts the donors' keys and the kernel library (nvcc runs 0 times in
    its process; the digest checked), its first sticky fits capture
    (counted as captures), and reads on structures that did not move
    keep their walls. Returns its worker."""
    from pint_tpu_torch.fleet import rendezvous_rank
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import fingerprint as fpm

    alive = router.alive_hosts()
    fp8s = {}
    for par, t in serve["problems"][:4]:
        fp8s[fpm.short_id(fpm.structure_fingerprint(get_model(par), None))] \
            = par
    stay = [par for fp8, par in fp8s.items()
            if rendezvous_rank(fp8, alive)[0]
            == rendezvous_rank(fp8, alive + ["j0"])[0]]
    if not stay:
        fail("19f: every structure moves to the joiner")
    model = get_model(stay[0])
    # the survivor serves the whole stream once: a round's batches are
    # what the donor journals (19c's failed-over requests re-fit in
    # other batches), so the joiner's first fits can find their keys
    _res, wall0, _h = fleet_stream(router, serve["problems"], serve["alone"],
                                   "the survivor alone")
    print(f"{card}: the stream on the survivor alone before the join: "
          f"{wall0:.3f} s", flush=True)
    before, host_before = read_walls(router, model)
    workers, hosts, spawn_s = spawn(
        1, dev, [{"PINT_TORCH_PROGRAM_CACHE_DIR": str(work / "store_j"),
                  "PINT_TORCH_TELEMETRY_PATH": str(jsonl["j0"])}], "j")
    t0 = time.perf_counter()
    router.add_host(hosts[0])
    join_s = time.perf_counter() - t0
    rep = hosts[0].report()
    progs = rep["programs"] or {}
    builds = progs.get("kernel_builds", {})
    loaded = progs.get("kernel_loaded", {}).get("ds32_gram", {})
    print(f"{card}: joiner j0 ready in {spawn_s:.2f} s, join handshake "
          f"{join_s:.3f} s: kernels adopted {progs.get('kernel_adopt')}, "
          f"keys {progs.get('prior')}, nvcc runs {builds.get('nvcc')}, "
          f"library from {loaded.get('origin')}, sha256 matches the donors' "
          f"{loaded.get('sha256') == digest}", flush=True)
    if dev.type == "cuda" and not (
            builds.get("nvcc") == 0 and loaded.get("origin") == "store"
            and loaded.get("sha256") == digest
            and progs.get("kernel_adopt", 0) >= 1):
        fail(f"19f: the joiner did not adopt the library: {progs}")
    res, wall, hosts_r = fleet_stream(router, serve["problems"],
                                      serve["alone"], "after the join")
    rep = hosts[0].report()
    n_j = hosts_r.count("j0")
    restored = int(rep["programs"].get("restored", 0))
    print(f"  the stream after the join: {wall:.3f} s, {n_j} requests on "
          f"j0, whose first sticky fits captured: cache.fit_program.miss "
          f"{rep['program_misses']} (captures, never hits); "
          f"cache.fit_program.restored {restored} (keys the donors "
          f"journaled)", flush=True)
    if n_j == 0 or rep["program_misses"] == 0 or restored == 0:
        fail("19f: the joiner took no sticky fit, its captures were not "
             "counted as misses, or none of its keys was the donors'")
    after, host_after = read_walls(router, model)
    print(f"  {N_FLEET_READS} reads of {N_FLEET_READ_Q} queries on a "
          f"structure that stayed on {host_before}: p50 "
          f"{np.median(before) * 1e3:.2f} ms before the join, "
          f"{np.median(after) * 1e3:.2f} ms after (on {host_after})",
          flush=True)
    if host_after != host_before:
        fail("19f: a structure that should not move moved")
    return workers


def fleet_durability(dev, card, serve, router, procs):
    """19d + 19e: 18c's 100,000-TOA WLS session through the TCP fleet,
    4 appends of 8 TOAs, its pinned worker SIGKILLed holding the last
    append queued; the survivor restores it; parity with a control that
    was never killed. Returns the killed append's trace id."""
    import signal

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import (DRIFT_CHI2_REL, FitRequest,
                                      ThroughputScheduler)

    table, apps = serve["session_table"], serve["session_appends"]
    apps = apps[:N_FLEET_APPENDS]

    def model():
        m = get_model(PAR_SERVE)
        m["F0"].add_delta(2e-10)
        return m

    t0 = time.perf_counter()
    h0 = router.submit(FitRequest(table, model(), session_id="big",
                                  **SERVE_HYPER))
    r0 = router.drain()[0]
    populate_s = time.perf_counter() - t0
    if r0.status != "ok":
        fail(f"19d: the populate {r0.status}: {r0.error}")
    pinned = h0.host
    for a in apps[:-1]:
        router.submit(FitRequest(a, None, session_id="big", **SERVE_HYPER))
        r = router.drain()[0]
        if r.status != "ok":
            fail(f"19d: an append {r.status}: {r.error}")
    h = router.submit(FitRequest(apps[-1], None, session_id="big",
                                 **SERVE_HYPER))
    addrs = ",".join(f"{hh.address[0]}:{hh.address[1]}"
                     for hid, hh in router.hosts.items()
                     if router._health[hid]["alive"])
    top = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.telemetry.top", "--connect",
         addrs, "--once"], capture_output=True, text=True, timeout=60,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if top.returncode != 0:
        fail(f"19e: top --once failed: {top.stderr[-1000:]}")
    agg = json.loads(top.stdout)
    print(f"{card}: top --once while the append is pending: "
          f"{agg['hosts_live']} live hosts, queue depth {agg['queue_depth']}, "
          f"in-flight traces {len(agg['inflight_traces'])}, SLO "
          f"{ {k: v['total'] for k, v in agg['slo'].items()} }", flush=True)
    if not (agg["hosts_live"] >= 2 and agg["queue_depth"] >= 1):
        fail(f"19e: top saw no pending work: {agg}")
    procs[pinned].send_signal(signal.SIGKILL)
    procs[pinned].wait(timeout=30)
    t0 = time.perf_counter()
    r = router.drain()[0]
    restore_s = time.perf_counter() - t0
    skey = router._sid_last["big"]
    owner = router._sticky[skey]
    summary = router.hosts[owner].session_summary(skey)
    dur = router.last_drain["durability"]
    # the control: the same stream on a scheduler that was never killed
    s = ThroughputScheduler(devices=[dev], max_queue=8)
    s.submit(FitRequest(table, model(), session_id="big", **SERVE_HYPER))
    s.drain()
    for a in apps:
        s.submit(FitRequest(a, None, session_id="big", **SERVE_HYPER))
        s.drain()
    e = s.sessions.entries[s.sessions._by_sid["big"]]
    chi2_gap = abs(summary["chi2"] - e.chi2) / abs(e.chi2)
    worst = 0.0
    for k in e.model.free_params:
        hi, lo, _unc = summary["params"][k]
        v, vc = hi + lo, e.model[k].value_f64
        bar = max(SERVE_VALUE_RTOL * abs(vc),
                  SERVE_VALUE_SIGMA * e.model[k].uncertainty)
        worst = max(worst, abs(v - vc) / bar)
    print(f"{card}: {len(table)}-TOA WLS session through the TCP fleet: "
          f"populate {populate_s:.3f} s on {pinned}; {len(apps)} appends of "
          f"{K_APPEND} TOAs, {pinned} SIGKILLed holding the last one queued; "
          f"restored on {owner} and the append served in {restore_s:.3f} s "
          f"(route {r.session}, status {r.status}; restores "
          f"{dur['restores']}, replayed {dur['replayed']}); against a "
          f"control never killed: chi2 {chi2_gap:.3e} relative (bar "
          f"{DRIFT_CHI2_REL:g}), worst parameter {worst:.3e} of its bar "
          f"(1e-9 relative or 5% of sigma); {summary['n_toas']} TOAs",
          flush=True)
    if not (r.status == "ok" and owner != pinned and chi2_gap <= DRIFT_CHI2_REL
            and worst <= 1.0 and summary["n_toas"] == e.n_toas):
        fail("19d: the restored session is off its control")
    return h.result().trace_ctx.trace_id


def fleet_traces(card, jsonl, tid, pids_min=3):
    """19e: the killed stream's artifacts merge into one rooted tree;
    the report renders its sections; the probe names the card."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.telemetry import trace

    telemetry.write_rollup()
    paths = [str(p) for k, p in jsonl.items() if k != "router"] + [
        str(jsonl["router"])]
    tree = trace.assemble(trace.load(paths))[tid]
    names = trace.hop_names(tree)
    print(f"{card}: the killed append's trace: {len(tree['roots'])} root(s), "
          f"{len(tree['orphans'])} orphans, pids {tree['pids']}, hosts "
          f"{tree['hosts']}, hops {names}", flush=True)
    for line in trace.render(tree):
        print("  " + line)
    chain = ("submit", "accept", "failover", "replay", "dispatch", "commit")
    if not (len(tree["roots"]) == 1 and not tree["orphans"]
            and all(n in names for n in chain)
            and len(tree["pids"]) >= pids_min):
        fail("19e: the killed stream is not one rooted tree over the chain")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    rep = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.telemetry.report", *paths,
         "--json"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    if rep.returncode != 0:
        fail(f"19e: report failed: {rep.stderr[-1000:]}")
    summary = json.loads(rep.stdout)
    sections = {"fleet": summary["fleet"].get("drains"),
                "mesh": summary["mesh"].get("drains"),
                "read": summary["reads"].get("records"),
                "programs": len(summary["programs"]),
                "traces": summary["dist_traces"].get("traces"),
                "SLO": sum(v["total"] for v in summary["slo"].values())}
    text = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.telemetry.report", *paths],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    print(f"  report over {len(paths)} artifacts: {sections}; "
          f"{len(text.stdout.splitlines())} lines of text", flush=True)
    if text.returncode != 0 or not all(sections.values()):
        fail(f"19e: empty report sections: {sections}")
    probe = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.telemetry.probe", "--timeout",
         "60"], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=env)
    rec = json.loads(probe.stdout.strip().splitlines()[-1]) \
        if probe.stdout.strip() else {}
    print(f"  probe: exit {probe.returncode}, {rec.get('n')} device(s), "
          f"{rec.get('device0')} {rec.get('capability')}, "
          f"{rec.get('latency_s')} s", flush=True)
    if torch.cuda.is_available() and not (
            probe.returncode == 0
            and rec.get("device0") == torch.cuda.get_device_name(0)):
        fail(f"19e: the probe did not name the card: {probe.stdout[-500:]}")


def fleet_tier(dev, serve, work=None):
    """Phase 19 (a)-(f). Returns the ds32_gram launches of the second
    process of 19a (the stored library's), the path's launches."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.ops import gram

    card = card_line()
    work = pathlib.Path(work or tempfile.mkdtemp(prefix="fleet_"))
    jsonl = {k: work / f"{k}.jsonl" for k in ("router", "w0", "w1", "j0")}
    quiet = [logging.getLogger(f"pint_tpu_torch.{m}")
             for m in ("observatory", "ephemeris")]
    levels = [lg.level for lg in quiet]
    for lg in quiet:
        lg.setLevel(logging.ERROR)
    gram.ds32_gram.launches = gram.ds32_gram_batched.launches = 0
    try:
        phase("19a the program store: two more processes, a truncated "
              "library")
        store_root, digest, child_launches = fleet_store(dev, card, work)
        telemetry.reset()
        telemetry.configure(enabled=True, jsonl_path=str(jsonl["router"]))
        phase("19b a loopback fleet: build_fleet(2) on the card")
        fleet_loopback(dev, card, serve)
        phase("19c a TCP fleet: two worker processes, a SIGKILL")
        router, workers = fleet_tcp(dev, card, serve, work, store_root,
                                    jsonl)
        phase("19f a cold join: a third worker with an empty store")
        jworkers = fleet_join(dev, card, serve, work, router, jsonl, digest)
        procs = {h: p for h, _port, p in workers + jworkers}
        phase(f"19d durability: the {N_SESSION}-TOA session, a SIGKILL with "
              f"an append queued")
        tid = fleet_durability(dev, card, serve, router, procs)
        phase("19e traces and the tools: report, top, probe")
        fleet_traces(card, jsonl, tid)
    finally:
        while SPAWNED:
            stop_workers(*SPAWNED.pop())
        telemetry.reset()
        for lg, level in zip(quiet, levels):
            lg.setLevel(level)
        shutil.rmtree(work, ignore_errors=True)
    print(f"{card}: ds32_gram launches in phase 19: the other processes "
          f"of 19a {child_launches} (the stored library), this process "
          f"{gram.ds32_gram.launches} (19a's comparison)", flush=True)
    return child_launches


def main() -> None:
    if not (ROOT / "pint_tpu_torch" / "ops" / "gram.py").is_file():
        fail("pint_tpu_torch/ is not beside this script: run it from a checkout")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from pint_tpu_torch.fitting import device_loop, gls_step
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import dd, gram
    from pint_tpu_torch.ops import stage1 as s1

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
    # the build directory is build/<tag>: the tag folds in the host's CPU
    # and the card's name and compute capability
    from pint_tpu_torch.compile_cache import enable_persistent_cache

    enable_persistent_cache(ROOT)
    t0 = time.perf_counter()
    lib, log = gram.build()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            print(f"  nvcc: {kernel_name(line)}:")
        elif "registers" in line or "spill" in line or "smem" in line:
            print("  nvcc:", line.strip())
    builds = gram.build_info()
    for name, b in builds.items():
        print(f"  {name}: {b['threads']} threads, {b['registers']} registers, "
              f"{b['spill_bytes']} spill bytes, {b['shared_bytes']} B dynamic "
              f"shared, {b['blocks_per_sm']} blocks per SM", flush=True)
    short = [name for name, b in builds.items() if name.startswith("partials")
             and (b["spill_bytes"] or b["blocks_per_sm"] < 2)]
    if short:
        fail(f"partials builds below 2 blocks per SM or spilling: {short}")
    from pint_tpu_torch.ops import block_elim

    t0 = time.perf_counter()
    lib, log = block_elim.build()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        slots = re.search(r"pta_block_elimILi(\d+)E", line)
        if "Compiling entry function" in line and slots:
            print(f"  nvcc: pta_block_elim<{slots.group(1)} slots>:")
        elif "registers" in line or "spill" in line or "smem" in line:
            print("  nvcc:", line.strip())
    b = block_elim.build_info(ELIM_SHAPE[1])
    print(f"  pta_block_elim at q = {ELIM_SHAPE[1]}: {b['threads']} threads, "
          f"{b['registers']} registers, {b['spill_bytes']} spill bytes, "
          f"{b['shared_bytes']} B dynamic shared, {b['blocks_per_sm']} blocks "
          f"per SM", flush=True)
    if b["spill_bytes"] or b["blocks_per_sm"] < 2:
        fail(f"the block-elimination kernel spills or holds under 2 blocks "
             f"per SM at the joint fit's shapes: {b}")

    phase("3 dd.self_check on the card")
    ok = dd.self_check(dev)
    print(f"dd.self_check(cuda) = {ok}", flush=True)
    if not ok:
        fail("double-double error-free transforms do not hold on the card")

    phase("4 ds32_gram against its plain version")
    # the binary path's q: its fitted parameters, the offset and 2 x 30
    # red-noise harmonics; the noise path's: its fitted parameters, the offset
    # and 2 x (30 red + 100 DM + 100 chromatic) harmonics
    path_q = {"binary": len(get_model(j1909_par()).free_params) + 1 + 60,
              "noise": len(get_model(PAR_J1713).free_params) + 1 + 460}
    shapes = check_gram(gram, dev, path_q)
    per_path = {path: [s for s in shapes if s["path"] == path]
                for path in ("main", "binary", "noise")}
    main_shapes = per_path["main"]
    for path, ss in per_path.items():
        print(f"bound per GLS step at the {path} path's shapes: "
              + " + ".join(f"{s['shape']} {s['bound_ms']:.4f}" for s in ss)
              + f" = {sum(s['bound_ms'] for s in ss):.4f} ms", flush=True)

    phase(f"5 the data layer: {N_SMALL} GBT TOAs built on the card and the CPU")
    ephem = get_model(PAR_FULL).ephem
    t0 = time.perf_counter()
    card = gbt_table(N_SMALL, seed=2, device=dev, ephem=ephem)
    torch.cuda.synchronize()
    print(f"built on the card in {time.perf_counter() - t0:.3f} s (first "
          f"build in the process), ephemeris {card.ephem_name}", flush=True)
    cpu = gbt_table(N_SMALL, seed=2, device="cpu", ephem=ephem)
    if not (torch.equal(card.utc.hi.cpu(), cpu.utc.hi)
            and torch.equal(card.utc.lo.cpu(), cpu.utc.lo)):
        fail("the clock-corrected UTC columns differ between card and CPU")
    tdb_gap = float(torch.max(torch.abs(
        (card.tdb.hi.cpu() - cpu.tdb.hi) * 86400.0
        + (card.tdb.lo.cpu() - cpu.tdb.lo) * 86400.0)))
    gaps = {"obs_pos_ls": (card.obs_pos_ls, cpu.obs_pos_ls, POS_BAR_LS),
            "obs_vel_c": (card.obs_vel_c, cpu.obs_vel_c, VEL_BAR),
            **{f"planet_pos_ls[{k}]": (card.planet_pos_ls[k],
                                       cpu.planet_pos_ls[k], POS_BAR_LS)
               for k in cpu.planet_pos_ls}}
    print(f"  TDB: max |card - cpu| {tdb_gap:.3e} s (bar {TDB_BAR_S:g})")
    bad = [] if tdb_gap <= TDB_BAR_S else ["TDB"]
    for key, (a, b, bar) in gaps.items():
        gap = float(torch.max(torch.abs(a.cpu() - b)))
        print(f"  {key}: max |card - cpu| {gap:.3e} (bar {bar:g})")
        if not gap <= bar:
            bad.append(key)
    if card.planet_pos_ls.keys() != cpu.planet_pos_ls.keys() or bad:
        fail(f"the card's TOA table differs from the CPU's: {bad}")

    phase(f"6 main path: bench.py's par, {N_TOAS} GBT TOAs, damped GLS fit")
    model = get_model(PAR_FULL)
    print("components: " + ", ".join(type(c).__name__ for c in model.components)
          + f"; free parameters {model.free_params}", flush=True)
    t0 = time.perf_counter()
    toas = simulate(PAR_FULL, N_TOAS, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"simulated {len(toas)} TOAs at {toas.obs_names} on {toas.device} in "
          f"{time.perf_counter() - t0:.2f} s (two table builds and two "
          f"inversion passes)", flush=True)
    build_ms = host_ms(lambda: gbt_table(N_TOAS, 0, dev, model.ephem), reps=3)
    print(f"one {N_TOAS}-row GBT table build on the card (warm): "
          f"{build_ms:.2f} ms wall", flush=True)
    profile_step("one table build", lambda: gbt_table(N_TOAS, 0, dev, model.ephem),
                 build_ms)
    # the main path: the damped fit through the fused loop (the first fit
    # captures a full step and a probe as CUDA graphs)
    gram.ds32_gram.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = HybridGLSFitter(toas, model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    start = free_values(model)
    s1_captured = s1.stage1_fused.captured
    cold = run_fit(fitter)
    s1_captured = s1.stage1_fused.captured - s1_captured
    launches = gram.ds32_gram.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    reserved_mb = torch.cuda.memory_reserved() / 2 ** 20
    chi2, steps, st = cold["chi2"], cold["steps"], cold["stats"]
    red = fitter.resids.reduced_chi2
    dof = fitter.resids.dof
    describe_fit(f"fit (cold, fused loop, with capture; construction "
                 f"{build_s:.3f} s more)", cold)
    print(f"  chi2/dof {chi2 / dof:.6f}, post-fit residual chi2/dof "
          f"{red:.6f}; peak memory {peak_mb:.1f} MiB allocated (graph pool "
          f"included), {reserved_mb:.1f} MiB reserved; kernel launches "
          f"recorded in the captures: ds32_gram {gram.ds32_gram.captured}",
          flush=True)
    for k in fitter.fit_params:
        p = model[k]
        print(f"  {k} = {p.format_value()} +- {p.format_uncertainty()}")
    print(f"ds32_gram launches in the fit (counted per replay): {launches}; "
          f"stage 1 on the {fitter._stage1.route} route, stage1_fused "
          f"launches {cold['stage1']} (recorded in the capture: "
          f"{s1_captured})", flush=True)
    state6 = fit_state(fitter, chi2)   # phase 15's pintempo run is held to it
    if not (math.isfinite(chi2) and fitter.converged):
        fail(f"fit did not converge to a finite chi2 ({chi2})")
    if not 0.8 <= red <= 1.25:
        fail(f"post-fit reduced chi2 {red} outside [0.8, 1.25]")
    if launches == 0 or launches < 2 * steps:
        fail(f"{launches} ds32_gram launches for {steps} full steps")
    if fitter._stage1.route != "kernel" or cold["stage1"] != steps \
            or s1_captured != 1:
        fail(f"stage 1 on the {fitter._stage1.route} route, "
             f"{cold['stage1']} stage1_fused launches for {steps} full "
             f"steps, {s1_captured} recorded in the capture")
    # every evaluation but the eager init pass (the capture's warm-up) is
    # a graph replay
    if not (st["captures"] == 2 and st["full"] == steps
            and st["probe"] == cold["probes"]
            and st["replays"] == steps + cold["probes"] - 1):
        fail(f"the fit did not run as graph replays: {st}")
    warm = run_fit(fitter, start)
    describe_fit("fit (warm, fused loop: the same fitter from the same start)",
                 warm)
    if not (warm["stats"]["captures"] == 0
            and warm["stats"]["replays"] == warm["steps"] + warm["probes"]
            and same_loop(cold, warm) and warm["stage1"] == warm["steps"]):
        fail("the warm fused fit is not the cold one replayed")
    # the host loop (PINT_TORCH_DEVICE_LOOP=0) as the witness: the same
    # trace, counters, steps and probes, chi2 within LOOP_RTOL
    hfitter = HybridGLSFitter(toas, get_model(PAR_FULL))
    hcold = run_fit(hfitter, loop="0")
    hwarm = run_fit(hfitter, start, loop="0")
    describe_fit("fit (host loop, first)", hcold)
    describe_fit("fit (host loop, warm)", hwarm)
    gap = max(abs(x - y) / abs(y) for x, y in zip(cold["trace"]["chi2"],
                                                   hwarm["trace"]["chi2"]))
    print(f"  fused - host loop chi2: {cold['chi2'] - hwarm['chi2']:+.3e}; "
          f"largest relative gap of a full evaluation's chi2 {gap:.3e} "
          f"(bar {LOOP_RTOL:g}); trace chi2 fused {cold['trace']['chi2']}\n  host "
          f"{hwarm['trace']['chi2']}", flush=True)
    if not (same_loop(cold, hcold) and same_loop(warm, hwarm)):
        fail("the fused fit disagrees with the host loop")
    if hwarm["stage1"] != hwarm["steps"]:
        fail(f"the host-loop fit launched the stage-1 kernel "
             f"{hwarm['stage1']} times in {hwarm['steps']} full steps")
    # baked values: the captured fit from another start must be the host
    # loop's fit from there
    for k, d in KICK.items():
        fitter.model[k].add_delta(d)
    start2 = free_values(fitter.model)
    moved = run_fit(fitter)
    hmoved = run_fit(hfitter, start2, loop="0")
    worst = max(abs(fitter.model[k].value_f64 - hfitter.model[k].value_f64)
                / hfitter.model[k].uncertainty for k in fitter.fit_params)
    describe_fit("fit from a kicked start (fused, replayed)", moved)
    describe_fit("fit from the kicked start (host loop)", hmoved)
    print(f"  worst parameter gap fused - host loop {worst:.3e} sigma",
          flush=True)
    if not (moved["stats"]["captures"] == 0 and worst <= 1e-6
            and same_loop(moved, hmoved)):
        fail("the captured fit from a new start is not the host loop's")
    # a second witness of where the damped loop stops: the same fit with
    # an exact f64 Gram in place of the kernel (a capture of its own)
    captured = gram.ds32_gram.captured
    gls_step.ds32_gram = lambda A: A.T @ A
    try:
        f64 = run_fit(HybridGLSFitter(toas, get_model(PAR_FULL)))
    finally:
        gls_step.ds32_gram = gram.ds32_gram
    describe_fit("fit with an exact f64 Gram (witness)", f64)
    print(f"  the kernel's fit {chi2 - f64['chi2']:+.6f} from it", flush=True)
    if not abs(chi2 - f64["chi2"]) <= 1e-6 * f64["chi2"]:
        fail(f"the fit's chi2 {chi2} is not the f64 Gram fit's {f64['chi2']}")
    if f64["launches"] or gram.ds32_gram.captured != captured \
            or f64["stats"]["captures"] != 2:
        fail("the f64-Gram witness replayed the kernel's capture")
    # the whole fit's idle share, fused and host loop (warm, same start)
    fused_ms = host_ms(lambda: run_fit(fitter, start), reps=3)
    host_ms_ = host_ms(lambda: run_fit(hfitter, start, loop="0"), reps=3)
    resid_ms = host_ms(fitter._new_resids, reps=3)
    print(f"one warm fit (fused loop): {fused_ms:.2f} ms wall; one warm fit "
          f"(host loop): {host_ms_:.2f} ms (median of 3, fit_toas from the "
          f"same start); of either, the post-fit residuals (eager, after the "
          f"loop) {resid_ms:.2f} ms", flush=True)
    # the profiled fit's kernels inside the graph replays: one partials
    # and one reduce pass for each ds32_gram launch counted per replay
    profiled = []
    by_name = profile_step("one warm fused fit",
                           lambda: profiled.append(run_fit(fitter, start)),
                           fused_ms)
    traced = {p: sum(c for name, (_, c) in by_name.items()
                     if f"ds32_gram_{p}" in name)
              for p in ("partials", "reduce")}
    counted = profiled[-1]["launches"]
    print(f"  ds32_gram in the profiled fit: {counted} launches counted per "
          f"replay; the trace holds {traced['partials']} partials and "
          f"{traced['reduce']} reduce kernels", flush=True)
    if traced != {"partials": counted, "reduce": counted}:
        fail(f"the trace of a fused fit holds {traced} ds32_gram kernels, "
             f"not the {counted} launches counted per replay")
    n_rep, span_ms, wall_ms = replay_spans(fitter, start)
    print(f"one warm fused fit: {n_rep} graph replays span {span_ms:.2f} ms "
          f"on the card (CUDA events around each replay) of its "
          f"{wall_ms:.2f} ms wall", flush=True)
    profile_step("one warm host-loop fit",
                 lambda: run_fit(hfitter, start, loop="0"), host_ms_)
    base = model.base_dd(dev)
    deltas = model.zero_deltas(device=dev)

    def full_step():
        float(fitter._iterate(base, deltas)[1]["chi2_at_input"])

    def stage1():
        fitter._stage1(base, deltas, fitter.toas, fitter._sigma)

    # what capture needs: no host sync in a step or a probe (raises here)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitter._iterate(base, deltas)
        fitter._chi2_at(base, deltas)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("no host sync in an eager full step or probe "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)
    step_ms = host_ms(full_step)
    stage1_ms = host_ms(stage1)
    probe_ms = host_ms(lambda: float(fitter._chi2_at(base, deltas)))
    print(f"one full step (warm, eager): {step_ms:.2f} ms, of which stage 1 "
          f"(DD phase + jacfwd design) {stage1_ms:.2f} ms; one probe "
          f"{probe_ms:.2f} ms", flush=True)
    profile_step("one full step", full_step, step_ms)
    profile_step("stage 1 of a step", stage1, stage1_ms)
    # phase 6's captured loops hold their graphs' memory: free it, so
    # that phase 7's peak measures phase 7
    del fitter, hfitter
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    device_loop.clear_cache()
    print(f"device_loop.clear_cache() freed "
          f"{held_mb - torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB of "
          f"captured loops", flush=True)

    phase(f"7 slice 7's path: a J1909-3744-like binary MSP (ELL1, {N_DMX} DMX "
          f"windows, FD, JUMP, the solar wind), {N_TOAS} GBT TOAs, damped GLS "
          f"fit")
    launches_binary = hybrid_path(
        dev, j1909_par(), path_q["binary"], "binary fit",
        ("PB", "A1", "EPS1", "EPS2", "M2", "SINI", "FD1", "FD2", "JUMP1",
         "DMX_0001", "DMX_0134", "DMX_0267"))
    device_loop.clear_cache()

    phase(f"8 each new component on the card against the CPU at {N_SMALL} "
          f"GBT TOAs")
    components_card_vs_cpu(dev)

    phase(f"9 the fits on the card agree with the CPU and the host loop at "
          f"{N_SMALL} TOAs")
    launches_by_path = {
        f"topocentric {N_TOAS} (main path, fused, cold)": launches,
        f"topocentric {N_TOAS} (fused, warm)": warm["launches"],
        f"topocentric {N_TOAS} (host loop, warm)": hwarm["launches"],
        **launches_binary}
    # the stage-1 kernel's launches on the fits that take it
    s1_by_path = {
        f"topocentric {N_TOAS} (main path, fused, cold)": cold["stage1"],
        f"topocentric {N_TOAS} (fused, warm)": warm["stage1"],
        f"topocentric {N_TOAS} (host loop, warm)": hwarm["stage1"]}
    for label, par in (("topocentric", PAR_FULL), ("barycentric", PAR_BARY)):
        small = simulate(par, N_SMALL, seed=1, device="cpu")
        recs = {}
        for name, d, loop in (("cpu", "cpu", "1"), ("card", dev, "1"),
                              ("card host loop", dev, "0")):
            f = HybridGLSFitter(small, get_model(par), device=d)
            recs[name] = (f.model, run_fit(f, loop=loop, maxiter=3))
        (m_cpu, r_cpu), (m_gpu, r_gpu), (_, r_host) = recs.values()
        c_cpu, c_gpu = r_cpu["chi2"], r_gpu["chi2"]
        launches_by_path[f"{label} {N_SMALL} (fused)"] = r_gpu["launches"]
        launches_by_path[f"{label} {N_SMALL} (host loop)"] = r_host["launches"]
        s1_by_path[f"{label} {N_SMALL} (fused)"] = r_gpu["stage1"]
        s1_by_path[f"{label} {N_SMALL} (host loop)"] = r_host["stage1"]
        worst = max(abs(m_cpu[k].value_f64 - m_gpu[k].value_f64)
                    / m_cpu[k].uncertainty for k in m_cpu.free_params)
        print(f"{label}: chi2 cpu {c_cpu:.9f} card {c_gpu:.9f} card host loop "
              f"{r_host['chi2']:.9f}; worst parameter gap {worst:.3e} sigma; "
              f"converged {r_cpu['converged']}/{r_gpu['converged']}; steps "
              f"{r_cpu['steps']}/{r_gpu['steps']}/{r_host['steps']}, probes "
              f"{r_cpu['probes']}/{r_gpu['probes']}/{r_host['probes']}; "
              f"ds32_gram launches cpu {r_cpu['launches']}, card "
              f"{r_gpu['launches']}, card host loop {r_host['launches']}; card "
              f"{r_gpu['stats']}", flush=True)
        if not (r_cpu["converged"] == r_gpu["converged"]
                and abs(c_gpu - c_cpu) <= 1e-6 * abs(c_cpu) and worst < 0.05):
            fail(f"the {label} fit on the card disagrees with the CPU fit")
        if not same_loop(r_gpu, r_host):
            fail(f"the {label} fused fit disagrees with the host loop")
        if r_gpu["launches"] == 0 or r_host["launches"] == 0 \
                or r_cpu["launches"] != 0:
            fail(f"the {label} fits launched ds32_gram {r_gpu['launches']} / "
                 f"{r_host['launches']} times on the card and "
                 f"{r_cpu['launches']} times on the CPU")

    phase(f"10 the fitter API: Fitter.auto at {N_DENSE} TOAs, the WLS fit and "
          f"the single-call steps at {N_TOAS}, card against CPU at {N_SMALL}")
    # the captured loops of phase 9 hold their graphs' memory; free it,
    # so that phase 10's peaks measure phase 10
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    device_loop.clear_cache()
    print(f"device_loop.clear_cache() freed "
          f"{held_mb - torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB of "
          f"captured loops", flush=True)
    dense, wls_state, gls_state = fitter_api(dev, toas)

    phase(f"11 the noise-model path: an EPTA-DR2-like MSP (DD, ChromaticCM, the "
          f"troposphere; red, DM and scattering noise), {N_TOAS} GBT TOAs, "
          f"damped GLS fit; a Vela-like glitch fit at {N_VELA} TOAs")
    device_loop.clear_cache()
    launches_by_path.update(hybrid_path(
        dev, PAR_J1713, path_q["noise"], "noise-model fit",
        ("RAJ", "PX", "DM", "DM1", "DM2", "CM", "PB", "A1", "ECC", "OM",
         "M2", "SINI", "FD1", "JUMP1")))
    device_loop.clear_cache()
    glitch_fit(dev)

    phase(f"12 the wideband path: PAR_J1909_WB at {N_TOAS} GBT TOAs with "
          f"-pp_dm/-pp_dme, Fitter.auto and dense_wideband_fit; card against "
          f"CPU at {N_SMALL}")
    device_loop.clear_cache()
    launches_by_path.update(wideband_path(dev))

    phase("13 the SPK ephemeris: a synthetic de421.bsp under "
          "PINT_TORCH_EPHEM_DIR with PINT_TORCH_STRICT_EPHEM=1")
    device_loop.clear_cache()
    kernels = pathlib.Path(tempfile.mkdtemp(prefix="spk_"))
    launches_by_path.update(spk_path(dev, kernels))
    device_loop.clear_cache()

    phase(f"14 photon events: {N_EVENTS} NICER-like and {N_EVENTS} Fermi-like "
          f"events on the card, through phase 13's kernel")
    photons = pathlib.Path(tempfile.mkdtemp(prefix="events_"))
    launches_by_path.update(photon_path(dev, kernels, photons))
    shutil.rmtree(kernels)

    phase(f"15 analysis and the command line: pintempo at {N_TOAS} TOAs, the "
          f"chi2 grids, MCMCFitter at {N_MCMC}, event_optimize, photonphase, "
          f"polycos, random models, zima")
    device_loop.clear_cache()
    launches15, cli_dir = analysis_and_cli(dev, toas, state6, wls_state,
                                           dense, gls_state, photons)
    launches_by_path.update(launches15)
    shutil.rmtree(photons)

    phase(f"16 many pulsars: {N_PSR} x {N_PER_PSR} TOAs through the fused "
          f"batched loop (GLS and WLS families), card against CPU, "
          f"ShardedGLSFitter and pintempo --fitter sharded, telemetry")
    launches_by_path.update(many_pulsars(dev, toas, state6, cli_dir))
    shutil.rmtree(cli_dir)

    phase(f"17 the PTA joint fit (BASELINE config 5: {PTA_SPEC['n_pulsars']} x "
          f"{PTA_SPEC['toas_per_pulsar']} TOAs, Hellings-Downs GW) on batched "
          f"ds32 Gram launches, card against CPU, the catalog job, pintk")
    pta_shapes, pta_launches, pta_fits = pta_catalogs_pintk(dev, dense)
    launches_by_path[f"PTA joint fit {PTA_SPEC['n_pulsars']} x "
                     f"{PTA_SPEC['toas_per_pulsar']} (fused, cold)"] = \
        pta_launches["ds32_gram"]
    s1_by_path[f"PTA joint fit {PTA_SPEC['n_pulsars']} x "
               f"{PTA_SPEC['toas_per_pulsar']} (fused, cold)"] = \
        pta_launches["stage1_fused"]
    s1_by_path["PTA joint fit (fused, warm)"] = pta_fits["warm"]["stage1"]

    phase(f"17s the stage-1 kernel: built, against its plain version and "
          f"timed at {PTA_SPEC['n_pulsars']} x {PTA_SPEC['toas_per_pulsar']} "
          f"TOAs")
    t0 = time.perf_counter()
    lib, log = s1.build()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry function", "registers",
                                   "spill", "smem")):
            print("  nvcc:", line.strip())
    if not s1.dd_self_check(dev):
        fail("the stage-1 kernel's double-double transforms fail "
             "dd.self_check's probes on the card")
    print("the stage-1 kernel's DD transforms pass dd.self_check's probes",
          flush=True)
    stage1_rec = check_stage1(dev)

    phase(f"18 the serving tier: {N_SERVE_FITS} scheduled fits, the mixed "
          f"frontier, {N_SESSION}-TOA sessions, reads, failure domains, card "
          f"against CPU")
    serve = serving_tier(dev, toas)
    launches_by_path["serving tier 18a-18f (counted from 0)"] = \
        serve["launches"]

    phase("19 the fleet tier: the program store, a loopback fleet, TCP "
          "workers, a killed 100,000-TOA session, traces and the tools, a "
          "cold join")
    launches_by_path["fleet tier 19 (counted from 0)"] = fleet_tier(
        dev, serve)

    phase("20 result")

    def per_step(ss):
        return {k: (None if any(s[k] is None for s in ss)
                    else sum(s[k] for s in ss))
                for k in ("ms", "device_ms", "plain_ms", "library_ms",
                          "library_device_ms", "bound_ms")}

    kernels = [{
        "name": "ds32_gram", "route": "cuda",
        "source": "pint_tpu_torch/csrc/ds32_gram.cu",
        "replaces": "pint_tpu/ops/pallas_gram.py:47",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        **per_step(main_shapes),
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in main_shapes) else "bytes"),
        "timing": "per GLS step of the main path: its G_BB + Schur shapes "
                  "summed; ms, plain_ms and library_ms are CUDA events around "
                  "one call, device_ms and library_device_ms device time "
                  "(torch.profiler)",
        "binary_path_per_step": per_step(per_path["binary"]),
        "noise_path_per_step": per_step(per_path["noise"]),
        "launches_by_path": launches_by_path,
        "shapes": shapes,
    }, {
        "name": "ds32_gram_batched", "route": "cuda",
        "source": "pint_tpu_torch/csrc/ds32_gram.cu",
        "replaces": "pint_tpu/ops/pallas_gram.py:47",
        "launches": pta_launches["ds32_gram_batched"],
        "max_abs_err": max(s["max_abs_err"] for s in pta_shapes),
        **{k: (None if any(s[k] is None for s in pta_shapes)
               else sum(s[k] for s in pta_shapes))
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "library_device_ms", "bound_ms")},
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in pta_shapes) else "bytes"),
        "timing": "per joint evaluation of phase 17's 68-pulsar fit: its "
                  "batched G_BB + Schur launches summed; library_ms is "
                  "torch.bmm(A.mT, A) in float64",
        "launches_by_path": {
            f"PTA joint fit {PTA_SPEC['n_pulsars']} x "
            f"{PTA_SPEC['toas_per_pulsar']} (fused, cold)":
                pta_launches["ds32_gram_batched"],
            "PTA joint fit (fused, warm)": pta_fits["warm"]["batched"]},
        "shapes": pta_shapes,
    }, {
        "name": "block_elim", "route": "cuda",
        "source": "pint_tpu_torch/csrc/block_elim.cu",
        "replaces": "none (the JAX package's jax.scipy cho_solve calls)",
        "launches": pta_launches["block_elim"],
        **{k: pta_fits["elim"][k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_rel_err", "build")},
        "timing": "per launch (both systems of the 68 members, one joint "
                  "evaluation); plain_ms is its plain version on the card "
                  "(cuSOLVER), library_ms the route before the kernel",
        "launches_by_path": {
            f"PTA joint fit {PTA_SPEC['n_pulsars']} x "
            f"{PTA_SPEC['toas_per_pulsar']} (fused, cold)":
                pta_launches["block_elim"],
            "PTA joint fit (fused, warm)": pta_fits["warm"]["elim"]},
        "shapes": [pta_fits["elim"]],
    }, {
        "name": "stage1_fused", "route": "cuda",
        "source": "pint_tpu_torch/csrc/stage1.cu",
        "replaces": "none (the JAX package's jax.jacfwd stage 1, "
                    "pint_tpu/fitting/hybrid.py)",
        "launches": pta_launches["stage1_fused"],
        **{k: stage1_rec[k] for k in (
            "ms", "device_ms", "stage1_ms", "stage1_device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by",
            "build")},
        "timing": "per launch (the 68 members' rows, one joint "
                  "evaluation); stage1_ms is the whole stage 1 on its "
                  "route, library_ms the jacfwd route (the route before "
                  "the kernel), vmapped",
        "launches_by_path": s1_by_path,
        "shapes": [stage1_rec],
    }]
    print("kernels: [ds32_gram: ok, " + ", ".join(
        f"{s['shape']} {s['n']}x{s['q']} {s['ms']:.4f} ms" for s in shapes)
        + f", {launches} launches; ds32_gram_batched: ok, " + ", ".join(
        f"{s['shape']} {s['P']}x{s['n']}x{s['q']} {s['ms']:.4f} ms"
        for s in pta_shapes)
        + f", {pta_launches['ds32_gram_batched']} launches; block_elim: ok, "
        f"{pta_fits['elim']['ms']:.4f} ms, {pta_launches['block_elim']} "
        f"launches; stage1_fused: ok, {stage1_rec['ms']:.4f} ms, "
        f"{pta_launches['stage1_fused']} launches]")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
