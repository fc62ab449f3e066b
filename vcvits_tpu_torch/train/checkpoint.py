"""Checkpoints with resume and a shape-tolerant restore, in plain PyTorch
(the port's counterpart of vcvits_tpu/train/checkpoint.py).

Each saved step is a directory `<directory>/<step>/` holding one file,
`state.pt`: the step number, the generator's and discriminators' state
dicts, both AdamW states and the gradient accumulator (mini-step, update
count, running-mean gradients; `TrainStep.state_dict()`). `save` copies the
state from the device to the host at the step boundary, then writes the
file on a background thread into a temporary directory that is renamed to
`<step>` when the write is complete, and keeps the newest `max_to_keep`
steps; `wait` joins the writer. `latest_step` sees only complete step
directories. `restore_tolerant` keeps the fresh value of a tensor that is
missing or has another shape, drops a tensor the template lacks, and resets
both optimizers, the accumulator and the step if anything changed. A
checkpoint written before the accumulator existed restores without one,
and `TrainStep.load_state_dict` starts a fresh accumulator.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to_host(tree):
    """A copy of `tree` with every tensor copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # seconds of the last save: the blocking device-to-host copy, and
        # the background file write
        self.timings: Dict[str, float] = {}

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Mapping) -> None:
        """Copy `state` to the host now and write it in the background."""
        self.wait()
        t0 = time.perf_counter()
        host = _to_host(state)
        self.timings = {"blocking_s": time.perf_counter() - t0}
        self._writer = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._writer.start()

    def _write(self, step: int, host: Dict) -> None:
        t0 = time.perf_counter()
        try:
            tmp = os.path.join(self.directory, f".{step}.tmp{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, STATE_FILE))
            final = self.step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
        except BaseException as e:  # raised again by wait(), in the trainer's thread
            self._error = e
        self.timings["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Join the background write; raise its error, if it had one."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def all_steps(self) -> List[int]:
        """The complete saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict:
        """The saved state of `step` (the latest by default), on the host."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore_tolerant(self, template: Mapping, step: Optional[int] = None
                         ) -> Tuple[Dict, bool]:
        """Restore into the shapes of `template` (a fresh
        `TrainStep.state_dict()`). A weight that is missing or has another
        shape keeps the template's value, one the template lacks is
        dropped; if anything changed, the template's step, optimizer states
        and accumulator replace the saved ones. Returns (state, changed)."""
        raw = self.restore(step)
        changed = False
        merged = {}
        for side in ("gen", "disc"):
            fresh, saved = template[side], raw.get(side, {})
            out = {}
            for k, tv in fresh.items():
                rv = saved.get(k)
                if rv is None:
                    logger.info("ckpt[%s]: missing %s, keeping the fresh value", side, k)
                    changed = True
                    out[k] = tv
                elif tuple(rv.shape) != tuple(tv.shape):
                    logger.info("ckpt[%s]: shape mismatch %s (%s vs %s), keeping the fresh "
                                "value", side, k, tuple(rv.shape), tuple(tv.shape))
                    changed = True
                    out[k] = tv
                else:
                    out[k] = rv.to(tv.dtype)
            for k in saved:
                if k not in fresh:
                    logger.info("ckpt[%s]: dropping %s", side, k)
                    changed = True
            merged[side] = out
        if changed:
            return {"step": template["step"], **merged, "g_opt": template["g_opt"],
                    "d_opt": template["d_opt"], "accum": template.get("accum")}, True
        return {**raw, **merged}, False
