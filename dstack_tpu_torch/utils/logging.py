"""Structured logging for the port (own copy of dstack_tpu.utils.logging)."""

import logging
import os
import sys

_ROOT = "dstack_tpu_torch"


class _Formatter(logging.Formatter):
    default_msec_format = "%s.%03d"

    def format(self, record: logging.LogRecord) -> str:
        record.levelname = record.levelname.lower()
        return super().format(record)


def configure_logging(level: str | int | None = None) -> None:
    level = level or os.getenv("DTPU_LOG_LEVEL", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _Formatter(fmt="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    )
    root = logging.getLogger(_ROOT)
    root.handlers = [handler]
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    # modules pass short names ("serve.engine"); parent them under the
    # configured root or their records never reach its handler
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
