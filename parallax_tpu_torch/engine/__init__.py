"""See parallax_tpu_torch/__init__.py."""

from parallax_tpu_torch.engine import collider, world  # noqa: F401
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig  # noqa: F401
