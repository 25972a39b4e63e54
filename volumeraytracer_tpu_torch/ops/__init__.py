"""Plain torch ops: field preprocessing, interpolation, the float march."""
