"""K2's share of its roofline in a trace request, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import march_lines


def read(run):
    return roofline_share(run, "march_lines_fwd_kernel", march_lines.k2)
