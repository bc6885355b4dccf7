"""The fused step's reverse-pass kernel's share of its roofline (kernel
row 4, ``csrc/fused_step_bwd.cu``): the frozen bound for the run's mean
active lanes and touched pairs a step over the kernel's mean time a call."""

from portbench import roofline, tracing


def read(traced):
    ms = tracing.kernel_ms(traced, "fused_step_bwd_kernel")
    if ms is None:
        return None
    bound = roofline.fused_bwd_bound(traced.shapes, traced.active_per_step,
                                     traced.touched_per_step, traced.batch)
    return roofline.share(bound["ms"], ms)
