"""Rank-filtered logging.

Counterpart of ``deepspeed_tpu/utils/logging.py``: ``log_dist`` logs on the
given ranks only, ``warning_once`` deduplicates a warning for the process's
lifetime. The rank comes from ``torch.distributed`` when a process group is
initialised, else from the launcher's ``RANK`` environment variable.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch", level: str = LOG_LEVEL) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(getattr(logging, level, logging.INFO))
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger_.addHandler(handler)
    return logger_


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: rank 0);
    ``ranks=[-1]`` logs on every rank."""
    my_rank = _process_index()
    ranks = ranks if ranks else [0]
    if my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    _warn_once(message)


@functools.lru_cache(None)
def _warn_once(message: str) -> None:
    logger.warning(message)
