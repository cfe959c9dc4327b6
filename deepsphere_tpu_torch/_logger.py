"""Package logger.

Behavioral parity with the reference logger
(``deepsphere-cosmo-tf2 src/deepsphere/_logger.py``): stdout stream handler and a
``DEEPSPHERE_LOG_LEVEL`` environment variable mapping ints 1..5 to
CRITICAL..DEBUG.
"""

import logging
import os
import sys

logger = logging.getLogger("deepsphere_tpu_torch")
_formatter = logging.Formatter(
    fmt="%(asctime)s %(name)14s %(levelname).3s   %(message)s",
    datefmt="%y-%m-%d %H:%M:%S",
)
_handler = logging.StreamHandler(sys.stdout)
_handler.setFormatter(_formatter)
logger.addHandler(_handler)
logger.propagate = False
logger.setLevel(logging.INFO)

_LEVELS = {
    1: logging.CRITICAL,
    2: logging.ERROR,
    3: logging.WARNING,
    4: logging.INFO,
    5: logging.DEBUG,
}

if "DEEPSPHERE_LOG_LEVEL" in os.environ:
    _raw = os.environ["DEEPSPHERE_LOG_LEVEL"]
    try:
        _lvl = int(_raw)
    except ValueError:
        logger.warning(
            f"Loglevel set in DEEPSPHERE_LOG_LEVEL is not an int, got {_raw}. Using default INFO!"
        )
        _lvl = 4
    logger.setLevel(_LEVELS.get(max(1, min(5, _lvl)), logging.DEBUG))
