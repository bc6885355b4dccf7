"""Device kernels a fleet step, over the traced stretch: the profiler's
kernel count over the env steps it ran (rollout loop, env hooks, auto-reset
and physics together)."""


def read(traced):
    if not traced.n_kernels:
        return None
    return traced.n_kernels / traced.steps
