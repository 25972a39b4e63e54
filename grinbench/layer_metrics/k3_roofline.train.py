"""K3's share of its roofline in a train step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import march_lines


def read(run):
    return roofline_share(run, "march_lines_bwd_kernel", march_lines.k3)
