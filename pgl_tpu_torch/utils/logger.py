"""Single framework logger (port of ``pgl_tpu/utils/logger.py``; reference:
``pgl/utils/logger.py``)."""

import logging
import sys

log = logging.getLogger("pgl_tpu_torch")
if not log.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "[%(levelname)s] %(asctime)s [%(filename)s:%(lineno)4d]: %(message)s"))
    log.addHandler(_handler)
    log.setLevel(logging.INFO)
    log.propagate = False

__all__ = ["log"]
