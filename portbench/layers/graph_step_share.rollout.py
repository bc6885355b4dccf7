"""Share of the run's rollout steps replayed from a captured CUDA graph, in %:
the program's own counters (``envs/plane_env.py``: ``graph_steps`` over it
and ``eager_steps``), from the process's start to the reading, set-up,
window and traced stretches together.  Nothing to read from a program
without those counters."""


def read(traced):
    from parallax_tpu_torch.envs import plane_env

    graphed = getattr(plane_env, "graph_steps", None)
    eager = getattr(plane_env, "eager_steps", None)
    if graphed is None or eager is None or graphed + eager == 0:
        return None
    return 100.0 * graphed / (graphed + eager)
