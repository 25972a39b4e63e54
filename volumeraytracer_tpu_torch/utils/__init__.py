"""Host-side utilities of the port: instance serialization, logging, the
image codecs (PNG, baseline JPEG) and the stack exporter (numpy and the
standard library only), and profiling (``torch.profiler``, CUDA events)."""
