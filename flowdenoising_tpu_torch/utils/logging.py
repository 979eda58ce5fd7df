"""Logging setup matching the reference's format and verbosity mapping
(reference ``flowdenoising.py:32,433-440``)."""

from __future__ import annotations

import logging

LOGGING_FORMAT = "[%(asctime)s] (%(levelname)s) %(message)s"


def setup_logging(verbosity: int) -> None:
    if verbosity >= 2:
        level = logging.DEBUG
    elif verbosity == 1:
        level = logging.INFO
    else:
        level = logging.CRITICAL
    logging.basicConfig(format=LOGGING_FORMAT, level=level, force=True)
    if verbosity:
        logging.info(f"Verbosity level = {verbosity}")


def log_volume_stats(tag: str, vol) -> None:
    """shape/dtype/extremes logging as at flowdenoising.py:498-501,528-531."""
    import numpy as np
    vol = np.asarray(vol)
    logging.info(f"{tag} shape (Z, Y, X) = {vol.shape}")
    logging.info(f"{tag} type = {vol.dtype}")
    logging.info(f"{tag} size = {vol.dtype.itemsize * vol.size / (1024 * 1024):.1f} MB")
    logging.info(f"{tag} max = {vol.max()}")
    logging.info(f"{tag} min = {vol.min()}")
    logging.info(f"{tag} average = {vol.mean()}")
