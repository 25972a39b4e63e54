"""The float32 operations and bytes of each kernel family, per unit of
work (a train step, a request, a fit step), from the shapes and the
executed steps in a run's ``work`` record.  Frozen copies of
``chip_smoke.py``'s counts (``MARCH_OPS``, ``REPLAY_OPS``, ``PACK_OPS``,
``PACK_BWD_OPS``, ``render_ops``, ``render_bwd_ops`` and the byte counts of
its phases 7, 11, 17 and 21), each input counted once and each output
once."""
