"""The program supply chain: identity, persistence, distribution.

Counterpart of ``pint_tpu.programs``. The port's programs are captured
CUDA graphs (bound to their process) and the nvcc-built kernel libraries
(files that can be kept and shipped):

* :mod:`pint_tpu_torch.programs.key` — a serialization-stable program
  key: a content digest over a canonical repr (never ``hash()``/``id()``;
  a value whose repr is its address gives no key) of the fused loop's
  kind, its structure (the model's fingerprint, the fitted names, the
  layout), its argument shapes, the torch/CUDA/nvcc versions, the card,
  the TF32 switches and the traced-set gate. The same dispatch in two
  processes derives byte-identical keys.
* :mod:`pint_tpu_torch.programs.store` — the per-host persistent store
  under ``PINT_TORCH_PROGRAM_CACHE_DIR``: the kernel tier (built
  libraries with their digests and what they were built for) and a
  manifest journaling every program key, so a restarted process knows
  which of its captures an earlier process made
  (``cache.fit_program.restored``; the capture itself is still a
  ``miss``).
* :mod:`pint_tpu_torch.programs.ship` — the fleet shipping protocol:
  adopt-set selection for the router's join handshake, and a shipment's
  export and adoption (kernel libraries and keys), so a joining worker
  runs nvcc zero times.

A kernel library's ladder: an adopted library -> a library on disk ->
nvcc from source -> raise. A miss or a corrupt library steps down one
rung and counts a ``programs.store.*`` counter; nothing falls back to a
kernel's plain version. With the knob unset every rung above the build
directory disappears.
"""

from pint_tpu_torch.programs.key import (environment_facts, fingerprint_id,
                                         program_key)
# the store() accessor is deliberately NOT re-exported: a package
# attribute named ``store`` would shadow the submodule. Import it as
# ``from pint_tpu_torch.programs.store import store``.
from pint_tpu_torch.programs.store import ProgramStore, note_seen, store_stats

__all__ = [
    "ProgramStore", "environment_facts", "fingerprint_id",
    "note_seen", "program_key", "store_stats",
]
