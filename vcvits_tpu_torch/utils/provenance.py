"""Run provenance: the source commit beside a run's checkpoints, and a
per-run file logger (the port's copy of vcvits_tpu/utils/provenance.py)."""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Optional

logger = logging.getLogger(__name__)


def current_git_hash(source_dir: Optional[str] = None) -> Optional[str]:
    """HEAD of the checkout that holds this package, or None outside git."""
    source_dir = source_dir or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=source_dir,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def check_git_hash(model_dir: str) -> None:
    """Save the current commit to `<model_dir>/githash`; warn when a saved
    run was started from another commit."""
    cur = current_git_hash()
    if cur is None:
        logger.warning("not a git repository; git hash comparison skipped")
        return
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur:
            logger.warning("git hash differs from the one this run was started with: "
                           "%s (saved) != %s (current)", saved[:8], cur[:8])
    else:
        with open(path, "w") as f:
            f.write(cur)


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    """A logger that also writes to `<model_dir>/<filename>`."""
    lg = logging.getLogger(os.path.basename(os.path.abspath(model_dir)))
    lg.setLevel(logging.DEBUG)
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(model_dir, filename))
    if not any(isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == path
               for h in lg.handlers):
        h = logging.FileHandler(path)
        h.setLevel(logging.DEBUG)
        h.setFormatter(logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s"))
        lg.addHandler(h)
    return lg
