"""On-card probes of the port: old and new kernel versions timed in turns."""
