"""Fault-tolerant checkpointing in the reference's on-disk format (the
port of ``repro.train.checkpoint``), so a checkpoint written by either
package restores in the other.

* **Format** — ``step_XXXXXXXX/`` holds ``shards.npz`` (one array per
  leaf, under its dotted key) and ``manifest.json`` (``step``, ``time``
  and each leaf's ``shape`` and numpy dtype name).  npz cannot store
  bfloat16: such a leaf is stored as its uint16 bit pattern with the
  manifest dtype ``"bfloat16"``.  No ``ml_dtypes`` is needed: the bits
  are viewed through torch.
* **Atomicity** — writes go to ``step_XXXXXXXX.tmp/`` and are published
  by ``os.rename``; a crashed write never corrupts the latest checkpoint.
* **Retention** — the ``keep`` newest complete checkpoints are kept;
  restore picks the newest *complete* manifest, so a torn checkpoint
  falls back to the previous one.

* **A mesh** — a tree with DTensor leaves is saved in the same format:
  every rank gathers each leaf's full value (a collective, so every rank
  calls :func:`save_checkpoint`), rank 0 writes, and the others wait at a
  barrier.  ``restore_checkpoint(..., shardings=...)`` places each leaf
  on a mesh, which need not be the one that wrote it (the elastic
  path); :func:`train_state_shardings` gives that tree for a model.

Leaves may be torch tensors (on any device), DTensors or numpy arrays;
a restored tree holds CPU tensors, or DTensors placed by ``shardings``.
A training checkpoint holds the reference's
tree (:func:`train_state`): ``params.*`` in the reference's stacked
layout (:func:`~repro_torch.models.model.params_to_reference`: ``layers``
and ``xattn`` on ``num_layers``, ``encoder.layers`` on
``encoder_layers``; each leaf in its own dtype, so the MoE router stays
float32 in a bf16 checkpoint),
``opt.mu.*`` and ``opt.nu.*`` laid out the same way, and ``opt.step``;
:func:`load_train_state` puts one back into a model.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Sharding,
    ShardingRules,
    distribute,
    placements,
    tree_partition_specs,
)
from repro_torch.models.model import Model, params_from_reference, params_to_reference

__all__ = ["CheckpointManager", "latest_step", "load_train_state", "restore_checkpoint",
           "save_checkpoint", "train_state", "train_state_shardings"]

_MANIFEST = "manifest.json"


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else k, node[k])
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _host_array(v) -> Tuple[np.ndarray, str]:
    """A leaf as the host array npz stores and its manifest dtype name."""
    if isinstance(v, torch.Tensor):
        if hasattr(v, "full_tensor"):  # a DTensor: its whole value (a collective)
            v = v.full_tensor()
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A freshly read (owned, writable) npz array as a tensor, no copy."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(directory: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    """Atomically write ``state`` (nested dicts of tensors or arrays) for
    ``step``.  Returns the final path.  With DTensor leaves every rank of
    their mesh calls this: each gathers the leaves, rank 0 writes, and
    all return after a barrier."""
    final = os.path.join(directory, f"step_{step:08d}")
    flat = _flatten(state)
    mesh = next((v.device_mesh for v in flat.values() if hasattr(v, "device_mesh")), None)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _host_array(v)
    if mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(directory, final, step, arrays, dtypes, keep)
        dist.barrier()
        return final
    _write(directory, final, step, arrays, dtypes, keep)
    return final


def _write(directory: str, final: str, step: int, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "shards.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]} for k, a in arrays.items()},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish

    _gc(directory, keep)


def _gc(directory: str, keep: int):
    done = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, _MANIFEST))
    )
    for d in done[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a COMPLETE manifest (torn writes are skipped)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, _MANIFEST)):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       shardings=None) -> Tuple[int, Dict[str, Any]]:
    """Restore the newest (or ``step``) checkpoint as ``(step, tree)``,
    the tree's leaves CPU tensors (bfloat16 where the manifest says so).
    With ``shardings`` (a matching tree of :class:`~repro_torch.distributed.sharding.Sharding`,
    ``None`` for a leaf to leave on the host) each leaf is moved to its
    mesh's device and placed there, every rank keeping its chunk: the
    elastic path, onto a mesh that may differ from the one that wrote
    the checkpoint."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shards.npz")) as z:
        flat = {k: _tensor(z[k], manifest["leaves"].get(k, {}).get("dtype")) for k in z.files}
    if shardings is not None:
        want = _flatten(shardings)
        if set(want) != set(flat):
            raise ValueError(f"shardings do not match the checkpoint's leaves: "
                             f"{sorted(set(want) ^ set(flat))[:8]}")
        for k, sh in want.items():
            if sh is not None:
                flat[k] = distribute(flat[k].to(sh.mesh.device_type), sh.mesh, sh.placements)
    return step, _unflatten(flat)


class CheckpointManager:
    """Save-every-N plus restore-on-start, as the training loop uses it."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, state: Union[Dict, Callable[[], Dict]]) -> Optional[str]:
        """Save at every ``every``-th step past 0.  ``state`` is the tree,
        or a function returning it, called only when a save is due."""
        if step % self.every == 0 and step > 0:
            return save_checkpoint(self.directory, step, state() if callable(state) else state,
                                   self.keep)
        return None

    def restore_or_init(self, init_fn, shardings=None):
        try:
            return restore_checkpoint(self.directory, shardings=shardings)
        except FileNotFoundError:
            return 0, init_fn()


# ---------------------------------------------------------------------------
# the training state, in the reference's tree
# ---------------------------------------------------------------------------

def train_state(model: Model, params: Dict[str, torch.Tensor], opt_state: Dict) -> Dict[str, Any]:
    """The reference's training tree of ``params`` (the model's, by port
    name) and ``opt_state``: ``{"params": ..., "opt": {"mu", "nu",
    "step"}}`` with every per-layer leaf stacked on a leading L axis."""
    cfg = model.cfg
    return {"params": params_to_reference(cfg, params),
            "opt": {"mu": params_to_reference(cfg, opt_state["mu"]),
                    "nu": params_to_reference(cfg, opt_state["nu"]),
                    "step": opt_state["step"].detach()}}


def train_state_shardings(model: Model, mesh, rules: ShardingRules = DEFAULT_RULES):
    """The :class:`Sharding` tree of :func:`train_state`'s layout on
    ``mesh``: every ``params`` and ``opt.mu``/``opt.nu`` leaf placed by
    the reference's rules at its stacked shape, ``opt.step`` on the host."""
    cfg = model.cfg
    shapes = params_to_reference(cfg, {name: torch.empty(p.shape, device="meta")
                                       for name, p in model.named_parameters()})
    specs = tree_partition_specs(shapes, rules, mesh)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        return Sharding(mesh, placements(node, mesh))

    tree = place(specs)
    return {"params": tree, "opt": {"mu": tree, "nu": tree, "step": None}}


@torch.no_grad()
def load_train_state(model: Model, tree: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Load a reference training tree (a restored checkpoint) into
    ``model``: returns ``(params, opt_state)``, the model's trainable
    parameters (:meth:`Model.trainable`) holding the tree's values and
    the moments and step on the model's device, bit for bit."""
    cfg, dev = model.cfg, model.device
    model.load_state_dict(params_from_reference(cfg, tree["params"]))
    params = model.trainable()
    opt = tree["opt"]
    moments = {}
    for key in ("mu", "nu"):
        flat = params_from_reference(cfg, opt[key])
        moments[key] = {name: flat[name].to(dev) for name in params}
    step = torch.as_tensor(opt["step"]).to(dev, torch.int32)
    return params, {"mu": moments["mu"], "nu": moments["nu"], "step": step}
