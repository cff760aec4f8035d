"""Timing-model layer: parameters, components, TimingModel, builder."""

from pint_tpu_torch.models.builder import get_model, get_model_and_toas  # noqa: F401
