"""See parallax_tpu_torch/__init__.py."""

from parallax_tpu_torch.utils import dbc, metrics, pytree  # noqa: F401
from parallax_tpu_torch.utils.metrics import (  # noqa: F401
    contact_metrics,
    contact_metrics_bm,
    log_metrics,
    set_debug_logging,
    timestep_metrics,
)
from parallax_tpu_torch.utils.pytree import (  # noqa: F401
    tree_get,
    tree_select,
    tree_set,
    tree_stack,
    tree_unstack,
    tree_zeros_like,
)
