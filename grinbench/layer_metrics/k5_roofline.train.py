"""K5's share of its roofline in a point-layout train step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import march_points


def read(run):
    return roofline_share(run, "march_points_fwd_kernel", march_points.k5)
