"""Experiment logger, copied from ``deft_tpu/utils/logger.py`` (the
reference's ``logger.py``).

Writes ``opt.txt`` (full config dump), a timestamped ``log.txt``, and --
since tensorboardX is not a dependency -- per-metric CSV scalar files that
plot with anything (``scalars/<name>.csv``: step,value,wall_time).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict


class Logger:
    def __init__(self, cfg, save_dir: str = None):
        self.save_dir = save_dir or cfg.save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        os.makedirs(os.path.join(self.save_dir, "scalars"), exist_ok=True)

        with open(os.path.join(self.save_dir, "opt.txt"), "w") as f:
            f.write(f"==> created at: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            f.write(f"==> cmdline: {' '.join(sys.argv)}\n")
            for k, v in sorted(dataclasses.asdict(cfg).items()):
                f.write(f"  {k}: {v}\n")

        self._log = open(os.path.join(self.save_dir, "log.txt"), "a")
        self._scalar_files: Dict[str, object] = {}
        self._start = time.time()

    def write(self, txt: str):
        stamp = time.strftime("%Y-%m-%d-%H-%M")
        self._log.write(f"{stamp}: {txt}")
        if not txt.endswith("\n"):
            self._log.write("\n")
        self._log.flush()

    def scalar_summary(self, tag: str, value: float, step: int):
        if tag not in self._scalar_files:
            path = os.path.join(self.save_dir, "scalars", f"{tag}.csv")
            new = not os.path.exists(path)
            self._scalar_files[tag] = open(path, "a")
            if new:
                self._scalar_files[tag].write("step,value,wall_time\n")
        f = self._scalar_files[tag]
        f.write(f"{step},{value},{time.time() - self._start:.1f}\n")
        f.flush()

    def close(self):
        self._log.close()
        for f in self._scalar_files.values():
            f.close()
