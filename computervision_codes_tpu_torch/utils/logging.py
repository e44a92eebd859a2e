"""Experiment logging: reference-style banner logfiles and a scalar event
stream.

The port's copy of ``utils/logging.py`` in the JAX package: the
append-only text logfile with centred ``**...**`` banner headers and
per-epoch lines (MT4MTLKD/Spatial_cnn/run.py:384-401, 409-422), and the
scalars the reference sends to tensorboardX (run.py:211,219,398,453) as a
JSONL event file, one ``{"tag", "step", "values", "time"}`` object per
line, which ``summarize_events`` reads back. The port writes no
tensorboard files.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class ExperimentLogger:
    def __init__(self, model_dir: str, modelname: str):
        os.makedirs(model_dir, exist_ok=True)
        self.model_dir = model_dir
        self.logfile = os.path.join(model_dir, f"{modelname}.log")
        self.events_path = os.path.join(model_dir,
                                        f"{modelname}.events.jsonl")
        self._events = open(self.events_path, "a+")

    def log(self, msg: str) -> None:
        with open(self.logfile, "a+") as f:
            f.write(msg + "\n")

    def banner(self, lines) -> None:
        """A centred banner block (the reference's run.py:384-401 format)."""
        maxlen = max(len(line) for line in lines)
        out = []
        for line in lines:
            pad = "*" * ((maxlen - len(line)) // 2 + 1)
            out.append(f"{pad}{line}{pad}")
        maxlen = max(len(line) for line in out)
        self.log("\n\n\n" + "*" * maxlen)
        for line in out:
            self.log(line)
        self.log("*" * maxlen)

    def run_header(self, script: str, modelname: str, version: str,
                   batch_size, lr_info: str) -> None:
        self.banner([
            f"** Run: {script} | Framework: PyTorch/CUDA | Method: "
            f"{modelname} | Version: {version} | Data: CholecT50 | Batch: "
            f"{batch_size} **",
            f"** Time: {time.ctime()} | Start: 0-epoch  0-steps **",
            f"** LR Config: {lr_info} **",
        ])

    def scalars(self, tag: str, values: Dict[str, float], step: int) -> None:
        rec = {"tag": tag, "step": int(step),
               "values": {k: float(v) for k, v in values.items()},
               "time": time.time()}
        self._events.write(json.dumps(rec) + "\n")
        self._events.flush()

    def close(self) -> None:
        self._events.close()


def summarize_events(events_path: str, tag: Optional[str] = None):
    """Read back a JSONL event file (optionally the records of one tag)."""
    out = []
    with open(events_path) as f:
        for line in f:
            rec = json.loads(line)
            if tag is None or rec["tag"] == tag:
                out.append(rec)
    return out
