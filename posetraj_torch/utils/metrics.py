"""Training metrics logging: JSONL always, TensorBoard when available (port
of posetraj_tpu/utils/metrics.py).

Stands in for the reference's accelerate trackers (init_trackers("SVDXtend"),
train_svd_traj_blender_14.py:1085-1086, per-step train_loss :1383) without the
accelerate dependency.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch


def host_floats(metrics: Dict) -> Dict[str, float]:
    """Each metric as a Python float. Tensors are read in one copy to the
    host (one device synchronisation for the lot, not one each)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    read = {}
    if keys:
        values = torch.stack([metrics[k].detach().reshape(()).float() for k in keys]).cpu().tolist()
        read = dict(zip(keys, values))
    return {k: read[k] if k in read else float(v) for k, v in metrics.items()}


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "posetraj"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        try:  # optional: a missing or broken TensorBoard leaves the JSONL
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(log_dir, "tb", run_name))
        except ImportError:
            pass
        except Exception as e:  # noqa: BLE001 - an optional writer must not stop training
            print(f"MetricsLogger: TensorBoard unavailable ({type(e).__name__}: {e}); JSONL only")

    def log(self, step: int, metrics: Dict):
        clean = host_floats(metrics)
        self._file.write(json.dumps({"step": int(step), "time": time.time(), **clean}) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
