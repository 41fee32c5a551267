"""Checkpoint exchange between the PyTorch port and the JAX package's
orbax format (``valley_tpu/utils/checkpoint.py``), on the host.

The JAX package writes ``checkpoint-N`` (its trainer's state: the
parameters, optax's state and the step), ``final/`` (the parameters, or
the adapters alone after LoRA) and ``adapter-N/`` with orbax's
``StandardCheckpointer``: a ``_METADATA`` file that lists every leaf of
the tree by its key path, and each array a zarr array over one OCDBT
key-value store in the directory, at the leaf's dotted path.  This module
reads and writes that format with ``tensorstore`` alone (imported at
first use; JAX is never imported), and converts both ways between it and
the port's own format (`utils.checkpoint`: one ``torch.save`` file a
directory):

* the parameters go through the carrier of `weights` (the port keeps the
  JAX layouts; a quantized ``lm_head`` is transposed), every leaf keeping
  its dtype, bf16 included;
* the step, and AdamW's moments where both sides hold them: optax's
  ``mu``/``nu`` of each label (``base``, ``lora``; ``frozen`` has none)
  are the port's ``exp_avg``/``exp_avg_sq`` of that label's parameter
  group, optax's ``count`` its per-parameter ``step``.  A JAX state kept
  in optax's ``MultiSteps`` (``gradient_accumulation_steps`` above 1) is
  read (an accumulation still pending is dropped), and written for the
  accumulation given.  The port's trainer resumes from the converted
  state with its own hyperparameters and checks the groups' names;
* ``valley_config.json``, ``valley_meta.json`` and any other file beside
  the trees are copied as they are (both packages write and read them
  alike).

Run: ``python -m valley_tpu_torch.utils.orbax_io {to-port,to-orbax} SRC
DST``, SRC a training output directory (every ``checkpoint-N``,
``final``, ``adapter-N`` in it) or one tree's directory.  ``tensorstore``
is installed where the JAX package runs, not on the card's machine: the
exchange runs on the host that holds both, and raises with the reason
where ``tensorstore`` is missing.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from valley_tpu_torch.models.llama import QUANTIZED
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.weights import from_jax_params, from_state_dict, \
    to_tensor

METADATA = "_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_TREES = re.compile(r"(checkpoint|adapter)-\d+|final")
LABELS = ("base", "lora")
# the leaves orbax lists without data, by their value type
_EMPTY = {"None": None, "Dict": {}, "Tuple": ()}


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "the orbax checkpoint exchange needs the tensorstore package, "
            "which is not installed here: convert on a host that has it "
            "(where the JAX package runs)") from e
    return tensorstore


def _spec(path: str, key: str) -> dict:
    return {"driver": "zarr", "path": key,
            "kvstore": {"driver": "ocdbt",
                        "base": "file://" + os.path.abspath(path)}}


# -- the on-disk format --------------------------------------------------

def read_tree(path: str) -> Any:
    """The tree orbax saved in directory ``path``: nested dicts (and
    lists, for sequence nodes) of numpy arrays, an empty dict or tuple as
    itself, a leaf orbax skipped (optax's empty states, masked leaves) as
    None; bf16 arrays as ml_dtypes bfloat16."""
    ts = _tensorstore()
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    ctx = ts.Context()
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        kinds = [k["key_type"] for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            leaf = _EMPTY.get(value["value_type"])
        else:
            leaf = ts.open(_spec(path, ".".join(keys)), context=ctx,
                           open=True).result().read().result()
        node = root
        for key, kind in zip(keys[:-1], kinds[:-1]):
            node = node.setdefault((key, kind), {})
        node[(keys[-1], kinds[-1])] = leaf
    return _unkey(root)


def _unkey(node):
    """Nested {(key, key type): child} -> dicts, and lists where the keys
    are sequence indices (key type 1)."""
    if not isinstance(node, dict) or not node:
        return node
    if all(kind == 1 for _, kind in node):
        items = sorted(node.items(), key=lambda kv: int(kv[0][0]))
        return [_unkey(v) for _, v in items]
    return {key: _unkey(v) for (key, _), v in node.items()}


def _leaves(tree, path=()):
    """((key, key type) path, leaf) of every leaf of a nested tree, in
    orbax's order (dict keys sorted)."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            for got in _leaves(tree[k], path + ((str(k), 2),)):
                yield got
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            for got in _leaves(v, path + ((str(i), 1),)):
                yield got
    else:
        yield path, tree


def write_tree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts and lists of numpy arrays; None, empty
    dicts and tuples for orbax's skipped leaves) into the new directory
    ``path`` as orbax's ``StandardCheckpointer`` does: ``_METADATA``,
    ``_CHECKPOINT_METADATA`` and every array a zstd-compressed zarr array
    in one OCDBT store, at its dotted key path."""
    ts = _tensorstore()
    os.makedirs(path)
    ctx = ts.Context()
    meta, pending = {}, []
    now = time.time_ns()
    for keys, leaf in _leaves(tree):
        key_meta = [{"key": k, "key_type": t} for k, t in keys]
        names = tuple(k for k, _ in keys)
        if leaf is None or isinstance(leaf, (dict, tuple)):
            kind = "None" if leaf is None else type(leaf).__name__.title()
            value = {"value_type": kind, "skip_deserialize": True}
        else:
            arr = np.asarray(leaf)
            shape = list(arr.shape)
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": shape}
            store = ts.open({**_spec(path, ".".join(names)),
                             "dtype": arr.dtype.name,
                             "metadata": {"shape": shape, "chunks": shape,
                                          "compressor": {"id": "zstd",
                                                         "level": 1}}},
                            context=ctx, create=True).result()
            pending.append(store.write(arr))
        meta[str(names)] = {"key_metadata": key_meta,
                            "value_metadata": value}
    for p in pending:
        p.result()
    with open(os.path.join(path, METADATA), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


# -- the trees -----------------------------------------------------------

def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 as ml_dtypes bfloat16 (as JAX holds
    it)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _nest(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    """{dotted name: leaf} of a nested dict, None leaves dropped."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = v
    return out


def params_to_port(tree) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (numpy leaves) as the port's ``state_dict``,
    every leaf in its own dtype."""
    return from_jax_params(tree, "cpu", None).state_dict()


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` as the JAX package's parameter tree
    (numpy leaves in their own dtypes; a quantized ``lm_head`` back in
    (in, out))."""
    out = {}
    for name, t in from_state_dict(state).state_dict().items():
        if name == "llama.lm_head" and t.dtype in QUANTIZED:
            t = t.t()
        out[name] = _numpy(t)
    return {"temporal": {}, **_nest(out)}


def _adam_states(opt_state) -> dict:
    """{label: (count, {name: mu}, {name: nu})} of optax's state of the
    JAX trainer (``multi_transform`` of clip-and-AdamW chains, inside
    ``MultiSteps`` with accumulation)."""
    if "inner_opt_state" in opt_state:
        opt_state = opt_state["inner_opt_state"]
    out = {}
    for label in LABELS:
        inner = opt_state["inner_states"].get(label, {}).get("inner_state")
        if not inner:
            continue
        adam = inner[1][0]
        out[label] = (int(np.asarray(adam["count"])), _flat(adam["mu"]),
                      _flat(adam["nu"]))
    return out


def state_to_port(tree) -> dict:
    """A JAX ``checkpoint-N`` tree as the port trainer's state:
    {"params", "optimizer" (``torch.optim.AdamW.state_dict`` form: a
    group per label, in the port's parameter order, named), "step" (the
    updates made; under ``MultiSteps`` a pending accumulation is
    dropped, as the port saves only at an update)}."""
    params = params_to_port(tree["params"])
    groups, state, i = [], {}, 0
    for label, (count, mu, nu) in _adam_states(tree["opt_state"]).items():
        names = [n for n in params if n in mu]
        if not names:
            continue
        groups.append({"label": label, "names": names,
                       "params": list(range(i, i + len(names)))})
        for n in names:
            state[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": to_tensor(mu[n]),
                        "exp_avg_sq": to_tensor(nu[n])}
            i += 1
    step = tree["opt_state"].get("gradient_step", tree["step"])
    return {"params": params, "optimizer": {"state": state,
                                            "param_groups": groups},
            "step": int(np.asarray(step))}


def state_to_jax(state: dict, accumulation: int = 1) -> dict:
    """The port trainer's ``checkpoint-N`` state as the JAX trainer's
    ``TrainState`` (the parameters, optax's state, the step) of a run with
    ``accumulation`` micro-batches an update: above 1 optax's
    ``MultiSteps`` state at an update's end (nothing accumulated) and a
    step that counts micro-batches, as the JAX trainer's does.  A label's
    moments are zeros before its first update, as optax initializes
    them."""
    params = params_to_jax(state["params"])
    flat = _flat(params)
    step = int(state["step"])
    osd = state["optimizer"]
    inner = {"frozen": {"inner_state": None}}
    for label in LABELS:
        mu, nu = dict.fromkeys(flat), dict.fromkeys(flat)
        count = step
        group = next((g for g in osd["param_groups"]
                      if g.get("label") == label), {"params": [], "names": []})
        for i, name in zip(group["params"], group["names"]):
            st = osd["state"].get(i)
            if st is None:
                mu[name] = np.zeros_like(flat[name])
                nu[name] = np.zeros_like(flat[name])
                continue
            mu[name], nu[name] = _numpy(st["exp_avg"]), \
                _numpy(st["exp_avg_sq"])
            count = int(st["step"])
        adam = {"count": np.int32(count),
                "mu": {"temporal": {}, **_nest(mu)},
                "nu": {"temporal": {}, **_nest(nu)}}
        inner[label] = {"inner_state": [
            None, [adam, None, {"count": np.int32(count)}]]}
    opt = {"inner_states": inner}
    if accumulation > 1:
        opt = {"mini_step": np.int32(0), "gradient_step": np.int32(step),
               "inner_opt_state": opt, "skip_state": (),
               "acc_grads": {"temporal": {}, **_nest(
                   {n: np.zeros_like(a) for n, a in flat.items()})}}
    return {"params": params, "opt_state": opt,
            "step": np.int32(step * accumulation)}


def adapter_to_port(tree) -> Dict[str, torch.Tensor]:
    """A JAX adapter tree ({leaf: array}, ``lora.split_lora``) as the
    port's."""
    return {k: to_tensor(v) for k, v in tree.items()}


def adapter_to_jax(adapter: Dict[str, torch.Tensor]) -> dict:
    return {k: _numpy(v) for k, v in adapter.items()}


def _is_adapter(tree) -> bool:
    return "llama" not in tree and "params" not in tree


# -- conversion of directories -------------------------------------------

def tree_to_port(src: str, dst: str) -> None:
    """One orbax tree directory (a ``checkpoint-N``, ``final`` or
    ``adapter-N``) as the port's, in the new directory ``dst``."""
    tree = read_tree(src)
    if "opt_state" in tree:
        out = state_to_port(tree)
    elif _is_adapter(tree):
        out = adapter_to_port(tree)
    else:
        out = params_to_port(tree)
    ckpt_lib.save_pytree(dst, out)


def tree_to_orbax(src: str, dst: str, accumulation: int = 1) -> None:
    """One of the port's tree directories as orbax's, in the new
    directory ``dst`` (a trainer's state for a JAX run of
    ``accumulation`` micro-batches an update)."""
    tree = ckpt_lib.restore_pytree(src, map_location="cpu")
    if "optimizer" in tree:
        out = state_to_jax(tree, accumulation)
    elif all("." not in k for k in tree):
        out = adapter_to_jax(tree)
    else:
        out = params_to_jax(tree)
    write_tree(dst, out)


def _is_tree(path: str, to_port: bool) -> bool:
    marker = METADATA if to_port else ckpt_lib._FILE
    return os.path.isfile(os.path.join(path, marker))


def convert(src: str, dst: str, to_port: bool, accumulation: int = 1
            ) -> list:
    """Convert ``src`` into ``dst`` (which must not exist): one tree, or an
    output directory's every ``checkpoint-N``, ``final`` and
    ``adapter-N`` with the other files beside them copied.  Returns the
    trees converted."""
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; convert into a new directory")
    one = tree_to_port if to_port else functools.partial(
        tree_to_orbax, accumulation=accumulation)
    if _is_tree(src, to_port):
        one(src, dst)
        return [src]
    os.makedirs(dst)
    done = []
    for name in sorted(os.listdir(src)):
        path = os.path.join(src, name)
        if os.path.isdir(path) and _TREES.fullmatch(name):
            if not _is_tree(path, to_port):
                raise ValueError(f"{path} is not a tree of the "
                                 f"{'orbax' if to_port else 'port'} format")
            one(path, os.path.join(dst, name))
            done.append(path)
        elif os.path.isfile(path):
            shutil.copy2(path, os.path.join(dst, name))
    if not done:
        raise ValueError(f"no checkpoint-N, final or adapter-N under {src}")
    return done


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert checkpoints between the JAX package's orbax "
        "format and the PyTorch port's own.")
    ap.add_argument("direction", choices=("to-port", "to-orbax"))
    ap.add_argument("src", help="an output directory, or one tree")
    ap.add_argument("dst", help="a new directory")
    ap.add_argument("--gradient-accumulation-steps", type=int, default=1,
                    help="to-orbax: the JAX run's accumulation, whose "
                    "optimizer state a checkpoint-N takes")
    args = ap.parse_args(argv)
    for path in convert(args.src, args.dst, args.direction == "to-port",
                        args.gradient_accumulation_steps):
        print(f"converted {path}")


if __name__ == "__main__":
    main()
