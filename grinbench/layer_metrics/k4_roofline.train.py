"""K4's share of its roofline in a train step, in %."""

from grinbench.readers import roofline_share
from grinbench.rooflines import line_table


def read(run):
    return roofline_share(run, "line_table_fold_kernel", line_table.k4)
