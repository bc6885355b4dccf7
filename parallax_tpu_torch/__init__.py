"""parallax_tpu_torch: the PyTorch and CUDA port of parallax_tpu.

The JAX package ``parallax_tpu`` is the reference; this package mirrors its
module paths and public names for the slice ported so far: the four envs
(LunarLander, Bouncer, Billiards, RoboCup) with their batched plane-space
rollouts and their per-world API (``reset``/``step`` with in-graph
auto-reset, the continuous-time ``evaluate`` with its Judges and Controls;
``envs``), the rollouts and the train step over them (``parallel.rollout``),
the batch-minor physics step with every pair kind and its public world
step ``step_batched`` (``engine.batched``), the per-world step
``World.step`` and the geometry under it, the utils (``utils.dbc``,
``metrics``, ``checkpoint``, ``profiling``) and ``viz``, and the
contact-solver and fused-step kernels for NVIDIA Hopper with their reverse
passes (``ops``, ``csrc/``).  It imports torch and numpy, never jax.
"""
