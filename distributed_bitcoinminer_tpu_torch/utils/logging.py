"""Logging for the port's processes.

Counterpart of the JAX package's ``utils/logging.py``: one ``logging``
configuration of the ``dbmt`` logger tree (the scheduler server logs to
``log.txt``, as the reference's scheduler does).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname).1s %(message)s"
_DATEFMT = "%H:%M:%S"

# The handler this module installed and the sink it points at.
_state_lock = threading.Lock()
_installed: dict = {"handler": None, "sink": None}


def configure_logging(level: int = logging.INFO,
                      logfile: Optional[str] = None) -> logging.Logger:
    """Set up the ``dbmt`` logger tree; returns its root logger.

    Idempotent: calling it again with the same sink keeps the handler;
    with another sink it replaces only the handler this function
    installed, leaving other handlers (test capture, a user's sink)
    alone.
    """
    logger = logging.getLogger("dbmt")
    sink = ("file", os.path.abspath(logfile)) if logfile else ("stderr",)
    with _state_lock:
        logger.setLevel(level)
        prev = _installed["handler"]
        if prev is None or _installed["sink"] != sink \
                or prev not in logger.handlers:
            if prev is not None and prev in logger.handlers:
                logger.removeHandler(prev)
                prev.close()
            handler = (logging.FileHandler(logfile) if logfile
                       else logging.StreamHandler(sys.stderr))
            handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
            logger.addHandler(handler)
            _installed["handler"] = handler
            _installed["sink"] = sink
    return logger
