"""Rendering entry points (single device in this slice)."""
