"""See parallax_tpu_torch/__init__.py.

The names of ``parallax_tpu/parallel/__init__.py``, but for one: there the
per-world ``rollout`` function shadows its module's name, while here
``parallel.rollout`` stays the module (callers use ``rollout.adam`` and
``rollout.make_train_step``) and the function is ``rollout.rollout``.
"""

from parallax_tpu_torch.parallel import mesh, rollout  # noqa: F401
from parallax_tpu_torch.parallel.mesh import (  # noqa: F401
    WORLD_AXIS,
    distributed_init,
    gather_batch,
    host_local_batch,
    make_world_mesh,
    replicated,
    shard_batch,
)
from parallax_tpu_torch.parallel.rollout import batched_rollout, make_train_step  # noqa: F401
