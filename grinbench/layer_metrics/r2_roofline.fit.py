"""R2's share of its roofline in a fit step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import render


def read(run):
    return roofline_share(run, "render_bwd_kernel", render.r2)
