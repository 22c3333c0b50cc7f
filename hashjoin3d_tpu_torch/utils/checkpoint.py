"""Save and load built tables.

Port of ``hashjoin3d_tpu/utils/checkpoint.py``: the reference has no
persistence (every run regenerates its data from a fixed seed); an engine
that builds once and probes many times wants its tables on disk.  A table
(``ChainingTable``, ``NestedTable``, ``GroupIndex`` or any dataclass of
the port) is written as one ``.npz`` of its columns plus a JSON manifest
of its fields, walked by name, so optional fields round-trip exactly.

:func:`load_table` also reads a file the JAX package's ``save_table``
wrote: its chaining and nested tables (and bare group indexes) come
across through ``convert.py``'s field rules, every u32 column as the int32
carrier and every u64 one as the int64 carrier, with no import of the JAX
package.  Only classes of this package are instantiated from a manifest.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import torch

from ..ops.layout import GroupIndex, I32, key_column, resolve_device

_PORT = "hashjoin3d_tpu_torch."
#: the JAX package's class names a manifest may hold
_JAX_TABLES = {"hashjoin3d_tpu.ops.chaining:ChainingTable": "chaining",
               "hashjoin3d_tpu.ops.nested:NestedTable": "nested",
               "hashjoin3d_tpu.ops.layout:GroupIndex": "groups"}


def _encode(obj, path: str, arrays: dict):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        spec = {"__dataclass__":
                type(obj).__module__ + ":" + type(obj).__qualname__}
        for f in dataclasses.fields(obj):
            spec[f.name] = _encode(getattr(obj, f.name), f"{path}.{f.name}",
                                   arrays)
        return spec
    if obj is None:
        return {"__none__": True}
    if isinstance(obj, (bool, int, float, str)):
        return {"__scalar__": obj}
    if isinstance(obj, torch.Tensor):
        arrays[path] = obj.detach().cpu().numpy()
        return {"__array__": path}
    raise TypeError(f"{path}: cannot save a {type(obj).__name__} "
                    "(tensors, scalars, None and dataclasses only)")


def _port_class(name: str):
    mod, _, qual = name.partition(":")
    if not mod.startswith(_PORT):
        raise ValueError(f"the manifest names {name!r}, not a class of "
                         "this package or a JAX table the port loads")
    return getattr(importlib.import_module(mod), qual)


def _decode(spec: dict, arrays, device):
    if "__dataclass__" in spec:
        name = spec["__dataclass__"]
        if name in _JAX_TABLES:
            return _from_jax(_JAX_TABLES[name], spec, arrays, device)
        cls = _port_class(name)
        return cls(**{k: _decode(v, arrays, device)
                      for k, v in spec.items() if k != "__dataclass__"})
    if spec.get("__none__"):
        return None
    if "__scalar__" in spec:
        return spec["__scalar__"]
    return torch.from_numpy(np.array(arrays[spec["__array__"]])).to(device)


def _flat(spec: dict, arrays, prefix: str = "") -> dict:
    """A JAX table's fields as ``convert.py`` takes them: ``groups.*``
    for the directory, numpy arrays, scalars and None."""
    out = {}
    for k, v in spec.items():
        if k == "__dataclass__":
            continue
        if "__dataclass__" in v:
            out.update(_flat(v, arrays, f"{prefix}{k}."))
        elif v.get("__none__"):
            out[prefix + k] = None
        elif "__scalar__" in v:
            out[prefix + k] = v["__scalar__"]
        else:
            out[prefix + k] = arrays[v["__array__"]]
    return out


def _from_jax(kind: str, spec: dict, arrays, device):
    from ..convert import (GROUP_FIELDS, chaining_table_from_numpy,
                           nested_table_from_numpy)

    fields = _flat(spec, arrays)
    if kind == "groups":
        cols = {f: key_column(fields[f.split(".")[1]], device)
                for f in GROUP_FIELDS if f != "groups.n_keys"}
        return GroupIndex(
            **{f.split(".")[1]: c for f, c in cols.items()},
            n_keys=torch.tensor(int(fields["n_keys"]), dtype=I32,
                                device=device))
    build = (chaining_table_from_numpy if kind == "chaining"
             else nested_table_from_numpy)
    return build(fields, num_buckets=int(fields["num_buckets"]),
                 hashfun=fields["hashfun"], device=device,
                 direct_shift=int(fields["direct_shift"]))


def _manifest(path: Path) -> Path:
    return path if path.suffix == ".json" else Path(str(path) + ".json")


def save_table(path, table) -> None:
    """Write ``table`` (any dataclass of the port) to ``path`` (``.npz``
    appended by numpy where missing) and its manifest to ``path.json``."""
    path = Path(path)
    arrays: dict = {}
    spec = _encode(table, "root", arrays)
    np.savez_compressed(path, **arrays)
    _manifest(path).write_text(json.dumps(spec))


def load_table(path, device="cuda"):
    """The table :func:`save_table` (or the JAX package's ``save_table``)
    wrote to ``path``, its columns on ``device``."""
    path = Path(path)
    dev = resolve_device(device)
    npz = path if path.suffix == ".npz" else Path(str(path) + ".npz")
    if not npz.exists():
        npz = path
    spec = json.loads(_manifest(path).read_text())
    with np.load(npz) as arrays:
        return _decode(spec, arrays, dev)
