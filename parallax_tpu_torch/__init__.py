"""parallax_tpu_torch: the PyTorch and CUDA port of parallax_tpu.

The JAX package ``parallax_tpu`` is the reference; this package mirrors its
module paths and public names for the slice ported so far: the batched
plane-space rollouts of LunarLander, Bouncer, Billiards and RoboCup
(``envs``), the train step over them (``parallel.rollout``), the
batch-minor physics step with every pair kind and its public world step
``step_batched`` (``engine.batched``), and the contact-solver and
fused-step kernels for NVIDIA Hopper with their reverse passes (``ops``,
``csrc/``).  It imports torch and numpy, never jax.
"""
