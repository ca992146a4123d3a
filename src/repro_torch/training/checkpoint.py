"""Fault-tolerant checkpointing, the port of `repro.training.checkpoint`,
in the reference's format unchanged, so either package reads the other's
checkpoint of the same tree.

Format: one directory per step, containing
    manifest.json   — step, monotonic save id, each leaf's dtype,
                      data-pipeline state ("extra"), "complete"
    arrays.npz      — the leaves, keyed by path (`training/tree.py`: dict
                      keys, sequence indices and NamedTuple field names
                      joined by "/")

Guarantees:
  * atomic publish: write to `step_<n>.tmp-<pid>`, fsync, rename — a crash
    mid-save never corrupts the latest checkpoint;
  * keep-N retention with never-delete-newest;
  * `restore_latest` skips torn/incomplete directories;
  * emergency save hook (signal handler) for preemption;
  * save/restore round-trips bf16, stored as its uint16 view (npz has no
    bfloat16, and `Tensor.numpy()` refuses it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import tree as tree_mod

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, the dtype name the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[Dict] = None, keep: int = 3) -> Path:
    """Atomically persist `tree` for `step`.  Returns the final path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f"step_{step:010d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays, meta = {}, {}
    for key, leaf in tree_mod.flatten_with_paths(tree):
        arrays[key], dtype = _to_numpy(leaf)
        meta[key] = {"dtype": dtype}
    np.savez(tmp / _ARRAYS, **arrays)
    del arrays

    manifest = {
        "step": int(step),
        "save_id": time.time_ns(),
        "leaves": meta,
        "extra": extra or {},
        "complete": True,
    }
    mpath = tmp / _MANIFEST
    mpath.write_text(json.dumps(manifest))
    with open(mpath) as f:           # fsync the manifest
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic publish

    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp")
                   and ".tmp-" not in p.name)
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def _is_complete(path: Path) -> bool:
    m = path / _MANIFEST
    a = path / _ARRAYS
    if not (m.exists() and a.exists()):
        return False
    try:
        return bool(json.loads(m.read_text()).get("complete"))
    except (json.JSONDecodeError, OSError):
        return False


def available_steps(ckpt_dir: str | Path) -> List[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in sorted(ckpt_dir.glob("step_*")):
        if ".tmp-" in p.name or not _is_complete(p):
            continue
        out.append(int(p.name.split("_")[1]))
    return out


def _leaf_device(leaf: Any, device) -> torch.device:
    """Where a restored leaf goes: the template leaf's device, unless it is
    the meta device (an abstract template) or not a tensor; then
    `device` (default the CPU)."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu" if device is None else device)


def restore(ckpt_dir: str | Path, step: int, template: Any, device=None,
            ) -> Tuple[Any, Dict]:
    """Restore `step` into the structure of `template` (shapes validated;
    a tree of meta tensors, `abstract_params`, is a template)."""
    path = Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((path / _MANIFEST).read_text())
    restored = []
    with np.load(path / _ARRAYS) as data:
        for key, leaf in tree_mod.flatten_with_paths(template):
            arr = data[key]
            if manifest["leaves"][key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint leaf {key}: shape {tuple(t.shape)} != "
                    f"template {tuple(np.shape(leaf))}")
            restored.append(t.to(_leaf_device(leaf, device)))
    return tree_mod.unflatten(template, restored), manifest.get("extra", {})


def restore_latest(ckpt_dir: str | Path, template: Any, device=None,
                   ) -> Optional[Tuple[int, Any, Dict]]:
    """(step, tree, extra) for the newest complete checkpoint, or None."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1]
    tree, extra = restore(ckpt_dir, step, template, device)
    return step, tree, extra


@dataclasses.dataclass
class CheckpointManager:
    """Periodic + emergency checkpointing for the training loop."""

    ckpt_dir: Path
    every_steps: int = 100
    keep: int = 3
    _emergency: bool = dataclasses.field(default=False, init=False)
    _previous: Dict = dataclasses.field(default_factory=dict, init=False)

    def __post_init__(self):
        self.ckpt_dir = Path(self.ckpt_dir)

    def install_signal_handler(self, signals=(signal.SIGTERM,)) -> None:
        """On SIGTERM (preemption), flag an emergency save for the next
        step boundary (async-safe: no IO inside the handler).  The handlers
        it replaces come back with `remove_signal_handler`."""
        def _handler(signum, frame):
            self._emergency = True
        for s in signals:
            self._previous.setdefault(s, signal.getsignal(s))
            signal.signal(s, _handler)

    def remove_signal_handler(self) -> None:
        """Put back the handlers that `install_signal_handler` replaced."""
        for s, handler in self._previous.items():
            # None: a handler not set from Python; the default stands in.
            signal.signal(s, signal.SIG_DFL if handler is None else handler)
        self._previous.clear()

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> Optional[Path]:
        if self._emergency or (step > 0 and step % self.every_steps == 0):
            self._emergency = False
            return save(self.ckpt_dir, step, tree, extra, self.keep)
        return None

    def restore_or_init(self, template: Any, init_fn: Callable[[], Any],
                        device=None) -> Tuple[int, Any, Dict]:
        got = restore_latest(self.ckpt_dir, template, device)
        if got is None:
            return 0, init_fn(), {}
        return got
