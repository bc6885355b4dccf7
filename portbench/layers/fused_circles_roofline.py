"""The fused step kernel's share of its roofline (kernel row 3,
``csrc/fused_step.cu``) on circle, box and containment lanes: read as
``fused_fwd_roofline`` reads it, in the cells whose worlds are RoboCup's
cc, cb and area_cb lanes."""

from portbench import harness


def read(traced):
    return harness.reader("fused_fwd_roofline").read(traced)
