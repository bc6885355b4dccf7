"""parallax_tpu_torch: the PyTorch and CUDA port of parallax_tpu.

The JAX package ``parallax_tpu`` is the reference; this package mirrors its
module paths and public names, all but the TPU-only pieces (the VMEM tile
models and the MXU split dots, the TPU tools): the four envs
(LunarLander, Bouncer, Billiards, RoboCup) with their batched plane-space
rollouts and their per-world API (``reset``/``step`` with in-graph
auto-reset, the continuous-time ``evaluate`` with its Judges and Controls;
``envs``), the rollouts and the train step over them (``parallel.rollout``),
the multi-device fleet over ``torch.distributed`` (``parallel.mesh``: a
world mesh with one rank a device, the batch sharded, mesh-aware waves in
the rollouts, one gradient all-reduce a train step; ``parallel.dryrun``:
the JAX package's two multi-chip programs), the batch-minor physics step
with every pair kind and its public world step ``step_batched``
(``engine.batched``; ``PARALLAX_REMAT_COLLIDE`` recomputes its collide in
the backward pass), the offset-rolled circle physics of billiards
(``engine.rolled``), the lander's terrain-candidate windows, the per-world step
``World.step`` and the geometry under it, the utils (``utils.dbc``,
``metrics``, ``checkpoint``, ``profiling``, ``pytree``) and ``viz``, and the
contact-solver and fused-step kernels for NVIDIA Hopper with their reverse
passes (``ops``, ``csrc/``).  It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from parallax_tpu_torch import geometry, utils  # noqa: E402, F401
