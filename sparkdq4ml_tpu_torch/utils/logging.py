"""Logging configuration mirroring the reference's log4j tiering (the port
of ``sparkdq4ml_tpu/utils/logging.py``): the port's namespace at DEBUG,
root INFO, torch's noise at WARN."""

from __future__ import annotations

import logging
import sys

# log4j pattern was "%d{yyyy-MM-dd HH:mm:ss} %-5p %c{1}:%L - %m%n"
_FORMAT = "%(asctime)s %(levelname)-5s %(name)s:%(lineno)d - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

#: The port's logger namespace.
NAMESPACE = "sparkdq4ml_tpu_torch"


def configure_logging(framework_level: int = logging.DEBUG,
                      root_level: int = logging.INFO,
                      stream=None, force: bool = False) -> None:
    """Install the log4j-style tiering.

    ``force=False`` appends the port's handler when the root logger
    already has handlers (a library must not own the root); ``force=True``
    replaces every root handler. Repeated calls replace the port's own
    handler instead of stacking another."""
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    handler._sparkdq4ml_torch = True     # marks the port's own handler
    root = logging.getLogger()
    if force or not root.handlers:
        root.handlers = [handler]
    else:
        root.handlers = [h for h in root.handlers
                         if not getattr(h, "_sparkdq4ml_torch", False)]
        root.addHandler(handler)
    root.setLevel(root_level)
    logging.getLogger(NAMESPACE).setLevel(framework_level)
    for noisy in ("torch", "torch._dynamo", "torch._inductor"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def format_kv(**fields) -> str:
    """Structured ``key=value`` event line (logfmt). Only ``None`` and the
    empty string are left out; values with spaces or ``=`` are quoted."""
    parts = []
    for k, v in fields.items():
        if v is None or (isinstance(v, str) and v == ""):
            continue
        s = str(v)
        if " " in s or "=" in s:
            s = '"' + s.replace('"', r'\"') + '"'
        parts.append(f"{k}={s}")
    return " ".join(parts)
