"""Many-pulsar and TOA-sharded fitting.

Counterpart of ``pint_tpu.parallel`` (its PTA joint fit waits for ROADMAP
Queue 1 item 4):

* the **pulsar axis**: independent problems padded to one TOA count,
  stacked and run through one ``torch.func.vmap``-ed step in one fused
  batched loop (:class:`BatchedPulsarFitter`);
* the **TOA axis**: a table's rows split into blocks over the devices of
  a mesh, each block reduced on its device and the partial sums added in
  a fixed order on the first (:mod:`.sharded_fit`, :mod:`.mesh`). One
  process, no ``torch.distributed``; on one H100 the mesh is 1 x 1.
"""

from pint_tpu_torch.bucketing import pad_toas  # noqa: F401
from pint_tpu_torch.parallel.batch import BatchedPulsarFitter  # noqa: F401
from pint_tpu_torch.parallel.mesh import (make_mesh, replicate,  # noqa: F401
                                          shard_toas)
from pint_tpu_torch.parallel.sharded_fit import (  # noqa: F401
    ShardedGLSFitter, ShardedServeFitter, ShardedWLSFitter, sharded_fit,
    sharded_gls_fit)
