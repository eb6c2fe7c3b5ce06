"""One stderr handler for the port's loggers, as `repro.utils.log`."""
from __future__ import annotations

import logging
import sys

_ROOT = "repro_torch"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """Logger `name` under the "repro_torch" root, which gets one stderr
    handler at INFO the first time any logger is asked for."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logging.getLogger(name)
