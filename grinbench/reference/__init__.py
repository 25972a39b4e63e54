"""The plain reference: what the program computes, in plain torch and
float32, worked out again from the same inputs.  It imports nothing of
``volumeraytracer_tpu_torch`` and nothing of JAX."""
