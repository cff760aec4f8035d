"""No module the benchmark runs loads JAX or the JAX package, and the
harness's look at sys.modules catches one that does (whole top-level
names: ``pint_tpu_torch`` passes, ``pint_tpu`` fails)."""

import subprocess
import sys

from conftest import ROOT

MODULES = ["portbench.run", "portbench.calibrate", "portbench.trace",
           "portbench.roofline", "portbench.reference.gls",
           "portbench.reference.simulate"] + [
    f"portbench.{d}.{p.stem}" for d in ("entries", "metrics")
    for p in sorted((ROOT / "portbench" / d).glob("*.py"))
    if p.stem != "__init__"]


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout.strip()


def test_no_jax_after_importing_every_module():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import pint_tpu_torch.fitting.hybrid, pint_tpu_torch.parallel.pta\n"
            "import pint_tpu_torch.parallel.batch\n"
            "from portbench import run\n"
            "print(run.forbidden_modules())")
    assert _run(code) == "[]"


def test_a_planted_import_is_caught():
    code = ("import sys, types\n"
            "from portbench import run\n"
            "import pint_tpu_torch\n"
            "assert run.forbidden_modules() == []\n"
            "sys.modules['pint_tpu.models'] = types.ModuleType('pint_tpu.models')\n"
            "print(run.forbidden_modules())")
    assert _run(code) == "['pint_tpu']"


def test_the_reference_uses_no_program():
    code = ("import sys\n"
            "import portbench.reference.gls, portbench.reference.simulate\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'pint_tpu_torch', 'pint_tpu', 'jax', 'jaxlib'}))")
    assert _run(code) == "[]"
