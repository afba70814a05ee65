"""Orbax step directories, read without orbax or tensorstore.

A step directory that orbax's ``PyTreeCheckpointer`` saved (the JAX
package's ``Checkpointer`` writes one whenever orbax is installed) holds

    _METADATA            the tree: each leaf's path ((key, key_type) pairs,
                         key_type 2 a dict key, 1 a sequence index) and its
                         value type
    manifest.ocdbt, d/   an OCDBT database (``utils/ocdbt.py``) that leads
    ocdbt.process_0/     into the per-process one, holding each leaf as a
                         zarr v2 array under its dot-joined path:
                         ``<path>/.zarray`` and the chunks ``<path>/0``,
                         ``<path>/0.0``, ...
    _CHECKPOINT_METADATA and, from newer orbax, ``_sharding`` and
    ``array_metadatas/`` (device placement; not needed to read the values)

:func:`restore_step` gives the tree as orbax's restore without a target
does: dicts for dict keys, lists for sequence indices (optax's tuple
state), None for a leaf saved as None, numpy arrays for the arrays (a
bfloat16 leaf as a bfloat16 torch tensor, as ``utils/checkpoint.load_npz``
reads one) and Python numbers for the scalars.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .ocdbt import MissingFile, OcdbtStore


def _require(path: str, name: str) -> str:
    full = os.path.join(path, name)
    if not os.path.exists(full):
        raise SystemExit(f"{path}: incomplete orbax step directory, no {name}")
    return full


def _bfloat16(raw: np.ndarray):
    import torch
    return torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)


def _dtype(name) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")          # read as raw 2-byte words
    if not isinstance(name, str):
        raise ValueError(f"zarr structured dtype {name!r} is not supported")
    return np.dtype(name)


def read_array(store: OcdbtStore, path: str):
    """The zarr v2 array stored under ``path`` (dot-joined tree path)."""
    meta = json.loads(store.read(f"{path}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{path}: zarr format {meta.get('zarr_format')} is not 2")
    if meta.get("filters"):
        raise ValueError(f"{path}: zarr filters {meta['filters']} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{path}: compressor {compressor} is not supported")
    dtype = _dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    elif meta["dtype"] == "bfloat16":
        fill = int(np.array(fill, np.float32).view(np.uint32) >> 16)
    out = np.full(shape, fill, dtype)
    if out.size:
        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        for index in np.ndindex(*grid) if grid else [()]:
            key = f"{path}/{sep.join(str(i) for i in index) or '0'}"
            if key not in store:
                continue                # never written: the fill value
            raw = store.read(key)
            if compressor is not None:
                raw = native.zstd_decompress(raw)
            chunk = np.frombuffer(raw, dtype)
            if chunk.size != int(np.prod(chunks)):
                raise ValueError(f"{key}: {chunk.size} values, the chunk holds "
                                 f"{int(np.prod(chunks))}")
            chunk = chunk.reshape(chunks, order=order)
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(index, chunks, shape))
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    return _bfloat16(out) if meta["dtype"] == "bfloat16" else out


def _insert(tree: Dict, path: List[Tuple[str, int]], leaf) -> None:
    """Place ``leaf`` at ``path`` in ``tree`` (dicts and index-keyed dicts,
    turned into lists by :func:`_lists`)."""
    node = tree
    for key, _ in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1][0]] = leaf


def _lists(node, kinds: Dict[Tuple[str, ...], int], at: Tuple[str, ...] = ()):
    if not isinstance(node, dict):
        return node
    items = {k: _lists(v, kinds, at + (k,)) for k, v in node.items()}
    if items and all(kinds.get(at + (k,)) == 1 for k in items):
        return [items[str(i)] for i in range(len(items))]
    return items


def restore_step(path: str, subtree: Optional[str] = None) -> Dict:
    """The nested state of the orbax step directory ``path``; with
    ``subtree`` (e.g. ``"params"``) only ``{subtree: ...}``, the other
    leaves (an optimizer's moments) left unread.  Raises SystemExit naming
    the file an incomplete step lacks."""
    try:
        return _restore(path, subtree)
    except MissingFile as e:
        raise SystemExit(f"{path}: incomplete orbax step directory, {e}") from e


def _restore(path: str, subtree: Optional[str]) -> Dict:
    with open(_require(path, "_METADATA")) as f:
        metadata = json.load(f)
    _require(path, "manifest.ocdbt")
    store = OcdbtStore(path)
    tree: Dict = {}
    kinds: Dict[Tuple[str, ...], int] = {}
    for entry in metadata["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if subtree is not None and keys[0][0] != subtree:
            continue
        for depth in range(1, len(keys) + 1):
            kinds[tuple(k for k, _ in keys[:depth])] = keys[depth - 1][1]
        value_type = entry["value_metadata"]["value_type"]
        if value_type == "None":
            leaf = None
        else:
            name = ".".join(k for k, _ in keys)
            if f"{name}/.zarray" not in store:
                raise SystemExit(f"{path}: incomplete orbax step directory, no "
                                 f"{name}/.zarray in its OCDBT database")
            leaf = read_array(store, name)
            if value_type == "scalar":
                leaf = leaf.item()
            elif value_type not in ("np.ndarray", "jax.Array"):
                raise ValueError(f"{path}: leaf {name} of value type {value_type!r} "
                                 "is not supported")
        _insert(tree, keys, leaf)
    if subtree is not None and subtree not in tree:
        raise SystemExit(f"{path}: _METADATA holds no {subtree!r} subtree")
    return _lists(tree, kinds)
