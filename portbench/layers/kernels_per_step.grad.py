"""Device kernels a differentiated step, over the traced stretch: the
profiler's kernel count over the env steps it differentiated (each step's
forward, recompute and backward together, and the update)."""


def read(traced):
    if not traced.n_kernels:
        return None
    return traced.n_kernels / traced.steps
