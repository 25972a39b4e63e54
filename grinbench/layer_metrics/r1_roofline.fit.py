"""R1's share of its roofline in a fit step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import render


def read(run):
    return roofline_share(run, "render_fwd_kernel", render.r1)
