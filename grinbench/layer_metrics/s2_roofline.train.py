"""S2's share of its roofline in a brick train step (all its windows), in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import march_slab


def read(run):
    return roofline_share(run, "march_slab_bwd_kernel", march_slab.s2)
