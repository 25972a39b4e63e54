"""Device ms a step outside the port's kernels: plain torch around them."""

from grinbench.readers import other_device_ms as read  # noqa: F401
