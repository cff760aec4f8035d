#!/usr/bin/env python3
"""The ds32 Gram kernel's build and clock on one CUDA card (a tuning aid).

Usage (from the root of a checkout, on a host with a CUDA card and the
CUDA toolkit):

    python3 tools/ds32_gram_probe.py

It checks nothing (chip_smoke.py does); it prints what tuning
pint_tpu_torch/csrc/ds32_gram.cu needs to read:

1. ptxas's registers and spills per kernel, and the partials pass's
   resident blocks per SM at q <= 64 and q > 64, from its registers and
   its dynamic shared memory against the H100's per-SM budgets;
2. every innermost loop of the kernels' SASS (``cuobjdump -sass``) with
   its instruction, FFMA, FADD and shared-load counts: what one trip
   issues;
3. the highest SM clock ``nvidia-smi`` reads while calls at the main
   path's G_BB shape (100,000 x 64) run back to back.

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
# H100 per-SM budgets for resident blocks: registers (allocated per warp
# in units of 256), shared memory (1 KiB of it reserved per block), threads
SM_REGISTERS = 65_536
SM_SHARED_BYTES = 233_472
SM_THREADS = 2048
PARTIALS_THREADS = 256   # kThreads in csrc/ds32_gram.cu


def partials_shared_bytes(cols: int) -> int:
    """shared_bytes(cols) in csrc/ds32_gram.cu: two f64 stages and two
    (a1, a2) f32 stages of 32 rows x cols."""
    return 2 * 32 * cols * 8 + 2 * 2 * 32 * cols * 4


def blocks_per_sm(registers: int, threads: int, shared: int) -> int:
    per_warp = -(-registers * 32 // 256) * 256
    return min(SM_REGISTERS // (threads // 32 * per_warp),
               SM_SHARED_BYTES // (shared + 1024), SM_THREADS // threads)


def kernel_name(text: str) -> str:
    """The first ds32_gram kernel named in `text` (a mangled symbol), as
    partials<64>, partials<128> or reduce."""
    m = re.search(r"ds32_gram_(partials|reduce)(?:ILi(\d+)E)?", text)
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def build_report(gram, lib: pathlib.Path) -> None:
    """Compile the source afresh into `lib` and print ptxas's report."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *gram.NVCC_FLAGS, "-o", str(lib), str(gram.SOURCE)],
                          capture_output=True, text=True, check=True, timeout=600)
    name, registers = None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        elif "spill" in line:
            print(f"  {name}: {line.strip()}")
        elif m := re.search(r"Used (\d+) registers", line):
            registers[name] = int(m.group(1))
            print(f"  {name}: {line.split(':', 1)[1].strip()}")
    for cols in (64, 128):
        regs = registers[f"partials<{cols}>"]
        shared = partials_shared_bytes(cols)
        print(f"  partials<{cols}>: {shared} B of dynamic shared memory, "
              f"{regs} registers: {blocks_per_sm(regs, PARTIALS_THREADS, shared)}"
              f" blocks per SM")


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ds32_gram_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from pint_tpu_torch.ops import gram

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib = pathlib.Path(tmp) / "libds32_gram.so"
        print("build (nvcc -Xptxas -v):")
        build_report(gram, lib)
        print("innermost SASS loops:")
        sass_loops(lib)
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((100_000, 64), generator=g, dtype=torch.float64, device="cuda")
    A = A / torch.linalg.norm(A, dim=0)
    mhz = sm_clock_mhz(lambda: gram.ds32_gram(A))
    print(f"SM clock under back-to-back G_BB calls: "
          f"{'not measured' if mhz is None else f'{mhz} MHz'}")


if __name__ == "__main__":
    main()
