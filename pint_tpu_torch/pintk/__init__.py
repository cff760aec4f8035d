"""pintk: interactive timing GUI (reference: src/pint/pintk/).

Counterpart of ``pint_tpu.pintk``, in two layers:

* :mod:`pint_tpu_torch.pintk.controller`: a headless state machine
  holding (TOAs, model, fits, selection, random-model draws). Every GUI
  action is a plain method, testable without a display, and the numerics
  go through the same fitters the console tools use;
* :mod:`pint_tpu_torch.pintk.app`: the thin Tk + matplotlib view.

Run as ``python -m pint_tpu_torch.pintk PARFILE TIMFILE`` (on the card;
``PINT_TORCH_DEVICE=cpu`` runs it on the CPU).
"""

from pint_tpu_torch.pintk.controller import PintkController  # noqa: F401


def main(argv=None) -> int:
    """Console entry point: ``pintk par tim``."""
    import argparse

    from pint_tpu_torch.scripts import script_init

    parser = argparse.ArgumentParser(
        prog="pintk", description="Interactive pulsar-timing GUI")
    parser.add_argument("parfile")
    parser.add_argument("timfile")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    dev = script_init(args.log_level)

    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.pintk.app import run_app

    model, toas = get_model_and_toas(args.parfile, args.timfile, device=dev)
    return run_app(PintkController(toas, model))
