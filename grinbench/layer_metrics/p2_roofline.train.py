"""P2's share of its roofline in a train step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import pack_field


def read(run):
    return roofline_share(run, "pack_field_bwd_kernel", pack_field.p2)
