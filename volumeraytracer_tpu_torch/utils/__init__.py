"""Host-side utilities of the port: instance serialization and logging
(numpy and the standard library only)."""
