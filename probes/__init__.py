"""On-card probes of the port: two checkouts timed in turns, and the toolkit they share with chip_smoke.py."""
