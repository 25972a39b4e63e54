"""User-facing models: the scene API."""
