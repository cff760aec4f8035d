"""pint_tpu_torch.catalog: catalog-scale joint PTA fits as jobs.

Counterpart of ``pint_tpu.catalog``. The NANOGrav-15-year-class joint
PTA fit (68 pulsars, ~6e5 TOAs, ECORR + red noise, HD-correlated GW
background) as a generated catalog and a resumable job:

* :mod:`.generate`: the seeded synthetic catalog generator (N pulsars
  with noise structures drawn from the soak axes plus an injected
  HD-correlated GW signal, as in-memory (model, TOAs) problems and a
  deterministic manifest);
* :mod:`.job`: :class:`CatalogFitRequest` / :class:`CatalogJob`, the
  joint fit as a checkpointing state machine advanced in wall-budget
  slices, with ``type="longjob"`` progress records and the pollable
  :class:`CatalogHandle`;
* :mod:`.hypergrid`: the noise-hyperparameter grid over one prepared
  fitter (the fused loop's capture replayed at every point).
"""

from pint_tpu_torch.catalog.generate import (  # noqa: F401
    Catalog, CatalogMember, CatalogSpec, generate_catalog)
from pint_tpu_torch.catalog.job import (  # noqa: F401
    CatalogFitRequest, CatalogHandle, CatalogJob)
from pint_tpu_torch.catalog.hypergrid import (  # noqa: F401
    HypergridResult, grid_points, points_for_free_noise)

__all__ = [
    "Catalog", "CatalogFitRequest", "CatalogHandle", "CatalogJob",
    "CatalogMember", "CatalogSpec", "HypergridResult",
    "generate_catalog", "grid_points", "points_for_free_noise",
]
