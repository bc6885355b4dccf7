"""The contact-solve kernel's share of its roofline (kernel row 1,
``csrc/contact_solver.cu``): the frozen bound for the run's mean active
lanes a step over the kernel's mean time a call in the trace."""

from portbench import roofline, tracing


def read(traced):
    ms = tracing.kernel_ms(traced, "contact_solve_kernel")
    if ms is None:
        return None
    bound = roofline.solve_bound(traced.shapes, traced.active_per_step, traced.batch)
    return roofline.share(bound["ms"], ms)
