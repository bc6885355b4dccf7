"""See parallax_tpu_torch/__init__.py."""

from parallax_tpu_torch.envs import base, billiards, bouncer, lunar_lander, plane_env, robocup  # noqa: F401
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig  # noqa: F401
from parallax_tpu_torch.envs.bouncer import Bouncer, BouncerConfig  # noqa: F401
from parallax_tpu_torch.envs.base import (  # noqa: F401
    ConstantControl,
    Control,
    Environment,
    Judge,
    PolicyControl,
    TimeStep,
    evaluate,
)
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander  # noqa: F401
from parallax_tpu_torch.envs.plane_env import PlaneEnvMixin, PlaneState  # noqa: F401
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig  # noqa: F401
