"""Timestamped file+console logging, reconfigured per pipeline — matches the
reference's setup blocks (its functions.py:107-132, main.py:25-52). Copied
from ``multimodal_auv_tpu/utils/logging_utils.py``."""
from __future__ import annotations

import datetime
import logging
import os
import sys


def setup_pipeline_logging(log_root: str = "logs", name: str = "training") -> str:
    root_logger = logging.getLogger()
    root_logger.setLevel(logging.INFO)
    for handler in root_logger.handlers[:]:
        root_logger.removeHandler(handler)
        handler.close()  # else each pipeline run leaks the prior log fd

    log_dir = os.path.join(log_root,
                           datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"{name}.log")

    fh = logging.FileHandler(log_path)
    fh.setLevel(logging.INFO)
    fh.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    root_logger.addHandler(fh)

    ch = logging.StreamHandler(sys.stdout)
    ch.setLevel(logging.INFO)
    ch.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    root_logger.addHandler(ch)

    logging.info("Logging initialized -> %s", log_path)
    return log_dir
