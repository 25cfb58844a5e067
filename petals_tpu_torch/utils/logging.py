"""Logging setup (petals_tpu/utils/logging.py).

Env vars:
- ``PETALS_TPU_LOGGING`` — the level of the port's loggers once
  ``initialize_logs()`` ran (default INFO).

Every module of the port logs through ``logging.getLogger(__name__)``, so
its records reach the root logger's handlers (a test's capture included);
``get_logger`` only prefixes a foreign name. A command-line entry point
calls ``initialize_logs()`` to give the ``petals_tpu_torch`` loggers a
handler of their own, in petals_tpu's format.
"""

import logging
import os

_initialized = False


def initialize_logs() -> None:
    global _initialized
    if _initialized:
        return
    level = os.environ.get("PETALS_TPU_LOGGING", "INFO").upper()
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            fmt="%(asctime)s.%(msecs)03d [%(levelname)s] [%(name)s:%(lineno)d] %(message)s",
            datefmt="%b %d %H:%M:%S",
        )
    )
    root = logging.getLogger("petals_tpu_torch")
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _initialized = True


def get_logger(name: str) -> logging.Logger:
    if not name.startswith("petals_tpu_torch"):
        name = f"petals_tpu_torch.{name}"
    return logging.getLogger(name)
