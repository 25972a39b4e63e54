"""Loglevel plumbing with the reference's integer convention.

Counterpart of ``volumeraytracer_tpu/utils/logging.py``.  The reference
threads ``Options::_loglevel`` everywhere with *negative = more verbose*
(types.h:85, e.g. chunk progress at <0 .cu:823-826, field stats at <-1
image_util.cpp:562-573, per-ray dumps at <-2 image_util.cpp:747-751); it
maps onto the standard library's logging levels.
"""

from __future__ import annotations

import logging

_LOGGER_NAME = "volumeraytracer_tpu_torch"


def level_from_reference(loglevel: int) -> int:
    """Map the reference's integer loglevel to a standard library level."""
    if loglevel <= -2:
        return logging.DEBUG
    if loglevel < 0:
        return logging.INFO
    if loglevel == 0:
        return logging.WARNING
    return logging.ERROR


def get_logger(loglevel: int = 0) -> logging.Logger:
    """The package's logger, with one stream handler, at ``loglevel``."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level_from_reference(loglevel))
    return logger
