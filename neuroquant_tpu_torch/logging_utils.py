"""Run-dir logging and eval-line formatting, with the reference's log-line
contract (the counterpart of ``neuroquant_tpu/logging_utils.py``)."""

from __future__ import annotations

import logging
import sys


def setup_logger(log_path: str) -> None:
    """Attach file + stdout handlers to the root logger."""
    fmt = logging.Formatter("%(asctime)s [%(levelname)-5.5s]  %(message)s")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        if isinstance(h, (logging.FileHandler, logging.StreamHandler)):
            root.removeHandler(h)
    fh = logging.FileHandler(log_path, encoding="utf-8")
    fh.setFormatter(fmt)
    root.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    logging.info("Logging file is %s" % log_path)


def round_tensor(x, num: int = 2, group_str: bool = False) -> str:
    """Pretty-print an array the way eval log lines expect."""
    import numpy as np

    x = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
    if group_str:
        return "/".join(",".join(str(round(float(v), num)) for v in row.ravel())
                        for row in x)
    return ",".join(str(round(float(v), num)) for v in x.ravel())
