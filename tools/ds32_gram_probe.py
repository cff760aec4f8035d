#!/usr/bin/env python3
"""The ds32 Gram kernel's build, clock and limits on one CUDA card (a tuning aid).

Usage (from the root of a checkout, on a host with a CUDA card and the
CUDA toolkit):

    python3 tools/ds32_gram_probe.py

It checks nothing (chip_smoke.py does); it prints what tuning
pint_tpu_torch/csrc/ds32_gram.cu needs to read:

1. ptxas's registers and spills per kernel, and each kernel's threads,
   registers, local (spill) bytes, dynamic shared memory and resident
   blocks per SM as the loaded library reports them
   (``ops/gram.py::build_info``);
2. every innermost loop of the kernels' SASS (``cuobjdump -sass``) with
   its instruction, FFMA, FADD and shared-load counts: what one trip
   issues;
3. the highest SM clock ``nvidia-smi`` reads while calls at the main
   path's G_BB shape (100,000 x 66) run back to back;
4. what holds the partials pass back: its device time per call at the
   main path's G_BB, the binary and noise paths' G_BB (q = 341, 480) and
   the PTA fit's batched G_BB (68 x 8,824 x 106), as built, with its
   staging taken out of the chunk loop (the FFMAs alone) and with its
   FFMAs taken out (the copies and splits alone). The last two are
   diagnostic builds of the source, made in a temporary directory; their
   values are wrong and only their time is read;
5. the FFMA loop alone: the partials pass's inner loop (a 4 x 4 patch's
   three chains, four 16-byte shared loads a row) in a kernel that does
   nothing else, in TFLOP/s at 128, 160 and 256 threads a block and one
   to four blocks per SM: the rate the pass could reach if nothing else
   held it back.

It imports torch and pint_tpu_torch only.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# diagnostic builds of the source: (label, text in the source, its
# replacement); each leaves the C interface as it is
DIAGNOSTICS = (
    ("FFMAs alone (no staging in the loop)",
     "    if (k + 1 < nstages) split(k + 1);\n    issue(k + 2);\n", ""),
    ("staging alone (no FFMAs)",
     "    if (active) {\n      patch_rows<kCols, kSR>(",
     "    if (active && nstages < 0) {\n      patch_rows<kCols, kSR>("),
)
# (label, batch, n, q): the main path's G_BB, the binary and noise
# paths', the PTA fit's
LIMIT_SHAPES = (("main G_BB", 1, 100_000, 66), ("binary G_BB", 1, 100_000, 341),
                ("noise G_BB", 1, 100_000, 480), ("PTA G_BB", 68, 8_824, 106))

# the FFMA loop alone: template argument = float4 shared loads per row
MICRO = r"""
#include <cuda_runtime.h>
#include <stdio.h>
template <int kLoads>
__global__ void loop(float* out, int iters) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < 2 * 32 * 128; i += blockDim.x)
    sm[i] = 1.0f + i * 1e-7f;
  __syncthreads();
  const float* a1 = sm;
  const float* a2 = sm + 32 * 128;
  const int si = 4 * (threadIdx.x / 16) % 64, sj = 64 + 4 * (threadIdx.x % 16);
  float cH[4][4] = {}, c12[4][4] = {}, c21[4][4] = {};
  float ai1[4] = {1, 2, 3, 4}, ai2[4] = {1, 2, 3, 4};
  float bj1[4] = {1, 2, 3, 4}, bj2[4] = {1, 2, 3, 4};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int rr = 0; rr < 32; ++rr) {
      if (kLoads) {
        float4 x = *reinterpret_cast<const float4*>(a1 + rr * 128 + si);
        ai1[0] = x.x; ai1[1] = x.y; ai1[2] = x.z; ai1[3] = x.w;
        x = *reinterpret_cast<const float4*>(a2 + rr * 128 + si);
        ai2[0] = x.x; ai2[1] = x.y; ai2[2] = x.z; ai2[3] = x.w;
        x = *reinterpret_cast<const float4*>(a1 + rr * 128 + sj);
        bj1[0] = x.x; bj1[1] = x.y; bj1[2] = x.z; bj1[3] = x.w;
        x = *reinterpret_cast<const float4*>(a2 + rr * 128 + sj);
        bj2[0] = x.x; bj2[1] = x.y; bj2[2] = x.z; bj2[3] = x.w;
      }
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
  float s = 0.f;
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) s += cH[u][v] + c12[u][v] + c21[u][v];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  float* out;
  cudaMalloc(&out, 1 << 24);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 2000, shared = 2 * 32 * 128 * 4;
  void (*kernels[2])(float*, int) = {loop<0>, loop<4>};
  const char* names[2] = {"operands in registers", "4 float4 loads a row"};
  for (int k = 0; k < 2; ++k) {
    cudaFuncSetAttribute(kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                         shared);
    for (int threads : {128, 160, 256})
      for (int per_sm = 1; per_sm <= 4; ++per_sm) {
        int most = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&most, kernels[k], threads,
                                                      shared);
        if (per_sm > most) continue;
        const int grid = sms * per_sm;
        kernels[k]<<<grid, threads, shared>>>(out, 10);
        cudaEventRecord(a);
        kernels[k]<<<grid, threads, shared>>>(out, iters);
        cudaEventRecord(b);
        cudaEventSynchronize(b);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, a, b);
        const double flops = 2.0 * grid * threads * iters * 32 * 48;
        printf("  %s, %d threads, %d blocks per SM: %.1f TFLOP/s\n", names[k],
               threads, per_sm, flops / ms / 1e9);
      }
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def kernel_name(text: str) -> str:
    """The first ds32_gram kernel named in `text` (a mangled symbol), as
    partials_narrow, partials_tile, partials_pairs or reduce."""
    return re.search(r"ds32_gram_(partials_[a-z]+|reduce)", text).group(1)


def compile_source(source: pathlib.Path, lib: pathlib.Path) -> str:
    """nvcc with the library's flags; returns ptxas's report."""
    from pint_tpu_torch.ops.library import NVCC_FLAGS

    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(lib), str(source)],
                          capture_output=True, text=True, check=True, timeout=600)
    return proc.stdout + proc.stderr


def build_report(gram, lib: pathlib.Path) -> None:
    """Compile the source afresh into `lib`, print ptxas's report and what
    the loaded library's kernels run with."""
    name = None
    for line in compile_source(gram.SOURCE, lib).splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        elif "spill" in line:
            print(f"  {name}: {line.strip()}")
        elif re.search(r"Used (\d+) registers", line):
            print(f"  {name}: {line.split(':', 1)[1].strip()}")
    for name, b in gram.build_info().items():
        print(f"  {name}: {b['threads']} threads, {b['registers']} registers, "
              f"{b['spill_bytes']} spill bytes, {b['shared_bytes']} B of dynamic "
              f"shared memory, {b['blocks_per_sm']} blocks per SM")


def sass_loops(lib: pathlib.Path) -> None:
    """Print every innermost loop of the kernels' SASS with its counts."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for body in text.split("Function : ")[1:]:
        name = kernel_name(body)
        code = [(int(a, 16), t.split()[1] if t.startswith("@") else t.split()[0])
                for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = [(int(t, 16), int(a, 16)) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+[^;]*BRA[^;]*?0x([0-9a-f]+)", body)]
        loops = [(lo, hi) for lo, hi in loops if lo < hi]
        for lo, hi in sorted(set(loops)):
            if any((lo, hi) != o and lo <= o[0] and o[1] <= hi for o in loops):
                continue   # not innermost
            ops = [op.split(".")[0] for a, op in code if lo <= a <= hi]
            if len(ops) >= 32:
                print(f"  {name}: loop {lo:#x}-{hi:#x}, {len(ops)} instructions, "
                      f"{ops.count('FFMA')} FFMA, {ops.count('FADD')} FADD, "
                      f"{ops.count('LDS')} LDS")


def sm_clock_mhz(fn, calls=3000):
    """The highest SM clock nvidia-smi reads (every 20 ms) while `calls`
    calls of fn run back to back; None if it reads none."""
    proc = subprocess.Popen(
        [shutil.which("nvidia-smi"), "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    mhz = [int(v) for v in out.split() if v.isdigit()]
    return max(mhz) if mhz else None


def partials_ms(fn, calls=20):
    """Device time per call of fn's ds32_gram partials kernels
    (torch.profiler over `calls` warm calls); None if the trace holds
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "ds32_gram_partials" in e.name)
    return us / 1e3 / calls if us else None


def launcher(gram, lib):
    """A call of the library `lib` on a (batch, n, q) card tensor, as
    ops/gram.py launches it."""
    def call(A):
        batch, n, q = A.shape
        bn, nb = gram._block_rows(n)
        plan = gram._tile_plan(q)
        P = torch.empty((batch, nb, q * (q + 1) // 2), dtype=torch.float32,
                        device=A.device)
        G = torch.empty((batch, q, q), dtype=torch.float64, device=A.device)
        rc = lib.ds32_gram_batched_launch(
            A.data_ptr(), P.data_ptr(), G.data_ptr(), batch, n, q, bn, nb,
            plan.edge, plan.ntasks, A.device.index or 0,
            torch.cuda.current_stream(A.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return G
    return call


def limits(gram, lib: pathlib.Path, tmp: pathlib.Path) -> None:
    """Print section 4: the partials pass as built and its diagnostics."""
    source = gram.SOURCE.read_text()
    builds = {"as built": lib}
    for label, old, new in DIAGNOSTICS:
        if old not in source:
            print(f"  {label}: not measured (the source has changed)")
            continue
        cu = tmp / f"diag{len(builds)}.cu"
        cu.write_text(source.replace(old, new))
        builds[label] = tmp / f"libdiag{len(builds)}.so"
        compile_source(cu, builds[label])
    calls = {label: launcher(gram, gram.LIBRARY.bind(path))
             for label, path in builds.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, batch, n, q in LIMIT_SHAPES:
        A = torch.randn((batch, n, q), generator=g, dtype=torch.float64,
                        device="cuda")
        A = (A / torch.linalg.norm(A, dim=1, keepdim=True)).contiguous()
        times = {label: partials_ms(lambda: call(A))
                 for label, call in calls.items()}
        print(f"  {shape} ({batch} x {n} x {q}): " + "; ".join(
            f"{label} {'not measured' if ms is None else f'{ms:.4f} ms'}"
            for label, ms in times.items()))
        del A


def ffma_loop(tmp: pathlib.Path) -> None:
    """Print section 5: the FFMA loop alone."""
    cu, exe = tmp / "ffma_loop.cu", tmp / "ffma_loop"
    cu.write_text(MICRO)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(cu)], check=True, timeout=600)
    print(subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=600).stdout.rstrip())


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ds32_gram_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from pint_tpu_torch.ops import gram

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        lib = tmp / "libds32_gram.so"
        print("1. build (nvcc -Xptxas -v; the loaded library):")
        build_report(gram, lib)
        print("2. innermost SASS loops:")
        sass_loops(lib)
        g = torch.Generator(device="cuda").manual_seed(0)
        A = torch.randn((100_000, 66), generator=g, dtype=torch.float64,
                        device="cuda")
        A = A / torch.linalg.norm(A, dim=0)
        mhz = sm_clock_mhz(lambda: gram.ds32_gram(A))
        print(f"3. SM clock under back-to-back G_BB calls: "
              f"{'not measured' if mhz is None else f'{mhz} MHz'}")
        del A
        print("4. the partials pass's device time per call (torch.profiler):")
        limits(gram, lib, tmp)
        print("5. the FFMA loop alone:")
        ffma_loop(tmp)


if __name__ == "__main__":
    main()
