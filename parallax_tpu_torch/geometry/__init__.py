"""See parallax_tpu_torch/__init__.py."""

from parallax_tpu_torch.geometry import math  # noqa: F401
from parallax_tpu_torch.geometry.math import (  # noqa: F401
    Transform2,
    cross2,
    fast_normal,
    is_point_in_triangle,
    order_clockwise,
    perpendicular_vector,
    random_direction,
    rotate,
)
