"""See parallax_tpu_torch/__init__.py."""

from parallax_tpu_torch.dynamics import bodies, impulses, integrator, joints, solver  # noqa: F401
from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState  # noqa: F401
from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig  # noqa: F401
from parallax_tpu_torch.dynamics.joints import Joints  # noqa: F401
