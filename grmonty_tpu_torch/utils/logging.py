"""Logging set-up mirroring the reference's spdlog configuration.

Port of ``grmonty_tpu/utils/logging.py``: the reference's ``--verbosity``
level names (``main.cpp:24,35``, ``parse_verbosity.cpp:13-65``) mapped onto
the stdlib logging module, for the port's loggers (``grmonty_tpu_torch.*``).
"""

import logging
import sys

LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; fold into DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "err": logging.ERROR,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def setup(verbosity: str = "info") -> logging.Logger:
    """Set the port's logger to ``verbosity`` with one stderr handler."""
    level = LEVELS.get(verbosity.lower())
    if level is None:
        raise ValueError(
            f"invalid verbosity {verbosity!r}; expected one of {sorted(LEVELS)}"
        )
    log = logging.getLogger("grmonty_tpu_torch")
    log.setLevel(level)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S")
        )
        log.addHandler(handler)
    return log
