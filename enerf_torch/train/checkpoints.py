"""Checkpoint save/load/rotate for the full training state.

Counterpart of enerf_tpu/train/checkpoints.py (reference nerf/utils.py:
1295-1416), in the JAX package's file layout so that each package reads the
other's checkpoints: one `<name>_ep%04d.npz` (or `<name>_best.npz`) plus a
`.json` sidecar (epoch, global_step, stats).  The npz keys are the JAX
package's pytree key paths joined by '/':

  ['state']/.params/['<name>']           parameters
  ['state']/.opt_state/[0]/.count        Adam's update count (int32)
  ['state']/.opt_state/[0]/.mu/['<name>']   Adam's exp_avg
  ['state']/.opt_state/[0]/.nu/['<name>']   Adam's exp_avg_sq
  ['state']/.opt_state/[1]/.count        the LR schedule's count (int32)
  ['state']/.ema_params/['<name>']       EMA shadow
  ['state']/.step                        int32
  ['occupancy']/.density_grid, .occ_bitfield, .mean_density, .iter_density

Loading is lenient, as in the JAX package: a key that is missing or of
another shape keeps the template's value, unexpected keys are ignored, and
a prefix of which no key matched raises.
"""

import json
import os
import re
import threading

import numpy as np
import torch

from enerf_torch.parallel import multihost
from enerf_torch.render.occupancy import occupancy_state

S = "['state']"
O = "['occupancy']"
OCC_FIELDS = ("density_grid", "occ_bitfield", "mean_density", "iter_density")


def _np(x):
    return x.detach().cpu().numpy()


def _snapshot(state, occupancy):
    """The whole state as {key: np.ndarray} (copied off the device)."""
    out = {f"{S}/.step": np.asarray(state.step, np.int32)}
    for k, p in state.params.items():
        out[f"{S}/.params/['{k}']"] = _np(p)
        out[f"{S}/.ema_params/['{k}']"] = _np(state.ema_params[k])
        out[f"{S}/.opt_state/[0]/.mu/['{k}']"] = _np(state.exp_avg[k])
        out[f"{S}/.opt_state/[0]/.nu/['{k}']"] = _np(state.exp_avg_sq[k])
    # Adam's count and the schedule's: one device count in the port
    count = np.asarray(int(state.count), np.int32)
    out[f"{S}/.opt_state/[0]/.count"] = count
    out[f"{S}/.opt_state/[1]/.count"] = count
    if occupancy is not None:
        for f in OCC_FIELDS:
            v = getattr(occupancy, f)
            out[f"{O}/.{f}"] = (np.asarray(v, np.int32) if f == "iter_density" else _np(v))
    return out


def _write_arrays(path, arrays, meta):
    """Write <path>.npz and <path>.json atomically (tmp + os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".npz.tmp", "wb") as f:  # a file object: savez adds no suffix
        np.savez(f, **arrays)
    os.replace(path + ".npz.tmp", path + ".npz")
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    return path + ".npz"


def _meta(state, epoch, stats):
    return {"epoch": int(epoch), "global_step": int(state.step), "stats": stats or {}}


def save_checkpoint(path, state, occupancy=None, epoch=0, stats=None):
    """Write <path>.npz (+ .json).  Returns the npz path."""
    return _write_arrays(path, _snapshot(state, occupancy), _meta(state, epoch, stats))


def load_checkpoint(path, state, occupancy=None):
    """Load <path>.npz into `state` (in place) and a copy of `occupancy`.
    Returns (state, occupancy, meta)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    meta = {}
    if os.path.exists(path[:-4] + ".json"):
        with open(path[:-4] + ".json") as f:
            meta = json.load(f)

    def take(key, like):
        if key in data and data[key].shape == tuple(like.shape):
            return torch.as_tensor(data[key]).to(device=like.device, dtype=like.dtype)
        return None

    hits = 0
    with torch.no_grad():
        for k, p in state.params.items():
            for key, dst in ((f"{S}/.params/['{k}']", p),
                             (f"{S}/.ema_params/['{k}']", state.ema_params[k])):
                v = take(key, dst)
                if v is not None:
                    dst.copy_(v)
                    hits += 1
            mu, nu = (take(f"{S}/.opt_state/[0]/.{m}/['{k}']", p) for m in ("mu", "nu"))
            if mu is not None and nu is not None and f"{S}/.opt_state/[0]/.count" in data:
                state.exp_avg[k].copy_(mu)
                state.exp_avg_sq[k].copy_(nu)
        if f"{S}/.step" in data:
            state.step = int(data[f"{S}/.step"])
            hits += 1
        for c in ("[0]", "[1]"):  # Adam's count, else the schedule's
            if f"{S}/.opt_state/{c}/.count" in data:
                state.set_count(int(data[f"{S}/.opt_state/{c}/.count"]))
                break
    if hits == 0:
        raise KeyError(f"checkpoint {path} matched no keys under prefix {S!r}; "
                       f"sample stored keys: {list(data.keys())[:3]}")
    occ = None
    if occupancy is not None:
        fields = {}
        for f in OCC_FIELDS:
            key, tmpl = f"{O}/.{f}", getattr(occupancy, f)
            if f == "iter_density":
                fields[f] = int(data[key]) if key in data else tmpl
            else:
                v = take(key, tmpl)
                fields[f] = v if v is not None else tmpl
        if not any(f"{O}/.{f}" in data for f in OCC_FIELDS):
            raise KeyError(f"checkpoint {path} matched no keys under prefix {O!r}")
        occ = occupancy_state(**fields)
    return state, occ, meta


class CheckpointManager:
    """Rotating checkpoints + best tracking (reference Trainer semantics).

    With `async_save` the npz/json write and the rotation run on a worker
    thread (the device->host copy happens on the caller's thread, so the
    next step may update the state in place); `wait()` drains them and
    re-raises the first failure.

    In a data-parallel job every rank holds the same state and only rank 0
    writes; each save ends, on every rank, with rank 0's write drained and
    a barrier, so no rank reads a checkpoint before it is whole and every
    rank resolves the same file on resume.
    """

    def __init__(self, ckpt_dir, name="ngp", max_keep=2, async_save=False):
        self.ckpt_dir = ckpt_dir
        self.name = name
        self.max_keep = max_keep
        self.async_save = async_save
        self._pending = []
        self._errors = []
        self._lock = threading.Lock()
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for th in pending:
            th.join()
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def _list(self):
        pat = re.compile(rf"{re.escape(self.name)}_ep(\d+)\.npz$")
        found = (pat.match(f) for f in os.listdir(self.ckpt_dir))
        return sorted((int(m.group(1)), os.path.join(self.ckpt_dir, m.group(0)))
                      for m in found if m)

    def _save(self, path, snapshot, meta, rotate):
        """Write snapshot() (rank 0 only); in a job of several ranks, drain
        the write and wait for every rank."""
        if multihost.is_primary():
            self._write(path, snapshot(), meta, rotate)
        if multihost.world_size() > 1:
            self.wait()
            multihost.all_processes_barrier(f"checkpoint {os.path.basename(path)}")
        return path + ".npz"

    def _write(self, path, arrays, meta, rotate):
        def work():
            try:
                _write_arrays(path, arrays, meta)
                if rotate:
                    with self._lock:
                        ckpts = self._list()
                        while len(ckpts) > self.max_keep:
                            _, p = ckpts.pop(0)
                            for ext in (".npz", ".json"):
                                if os.path.exists(p[:-4] + ext):
                                    os.remove(p[:-4] + ext)
            except Exception as e:  # surfaced by the next wait()
                if not self.async_save:
                    raise
                with self._lock:
                    self._errors.append(e)

        if self.async_save:
            th = threading.Thread(target=work, daemon=True)
            with self._lock:
                self._pending.append(th)
            th.start()
        else:
            work()

    def save(self, state, occupancy, epoch, stats=None):
        path = os.path.join(self.ckpt_dir, f"{self.name}_ep{epoch:04d}")
        return self._save(path, lambda: _snapshot(state, occupancy),
                          _meta(state, epoch, stats), rotate=True)

    def save_best(self, state, occupancy, epoch, stats=None):
        """Best-by-metric checkpoint with the EMA weights as its params
        (utils.py:1337-1345)."""
        def snapshot():
            arrays = _snapshot(state, occupancy)
            for k in state.params:
                arrays[f"{S}/.params/['{k}']"] = arrays[f"{S}/.ema_params/['{k}']"]
            return arrays

        path = os.path.join(self.ckpt_dir, f"{self.name}_best")
        return self._save(path, snapshot, _meta(state, epoch, stats), rotate=False)

    def latest(self):
        self.wait()
        ckpts = self._list()
        return ckpts[-1][1] if ckpts else None

    def best(self):
        self.wait()
        p = os.path.join(self.ckpt_dir, f"{self.name}_best.npz")
        return p if os.path.exists(p) else None

    def resolve(self, which="latest"):
        """'latest' | 'best' | 'scratch' | an explicit path (utils.py:1353-1381)."""
        if which == "latest":
            return self.latest()
        if which == "best":
            return self.best() or self.latest()
        if which == "scratch":
            return None
        return which
