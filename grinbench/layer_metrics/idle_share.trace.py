"""The device's idle share of the profiled slice, in %."""

from grinbench.readers import idle_share as read  # noqa: F401
