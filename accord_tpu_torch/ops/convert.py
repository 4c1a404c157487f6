"""Carry device state across from the JAX package as numpy columns.

``tables_from_numpy`` builds the port's NamedTuples from plain numpy
arrays: ``np.asarray`` of each field of the reference's JAX NamedTuples
(``fields`` does that for any NamedTuple whose fields convert with
``np.asarray``), or the host arrays of a ``_DepsMirror`` / ``_DrainMirror``.
Feeding both packages the same bytes this way is how the tests hold the
port against the reference.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from .deps_kernel import AttrCols, AttrIndex, BucketTable, DepsTable
from .drain_kernel import DrainState, EllDrainState

TYPES = {
    "table": DepsTable,
    "buckets": BucketTable,
    "attr": AttrCols,
    "aidx": AttrIndex,
    "drain": DrainState,
    "ell": EllDrainState,
}

Columns = Union[Mapping[str, np.ndarray], Sequence[np.ndarray]]


def fields(nt) -> Dict[str, np.ndarray]:
    """{field: np.asarray(value)} of one NamedTuple (JAX or torch on CPU)."""
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def tables_from_numpy(arrays: Mapping[str, Columns],
                      device="cuda") -> Dict[str, tuple]:
    """{kind: columns} -> {kind: port NamedTuple on ``device``}.

    ``kind`` is one of ``TYPES`` ("table", "buckets", "attr", "aidx",
    "drain", "ell"); ``columns`` is a {field: array} mapping or a sequence
    in field order.  Dtypes and shapes are kept exactly as given; the
    tensors own copies of the bytes."""
    out = {}
    for kind, cols in arrays.items():
        nt = TYPES[kind]
        if isinstance(cols, Mapping):
            cols = [cols[f] for f in nt._fields]
        if len(cols) != len(nt._fields):
            raise ValueError(f"{kind}: {len(cols)} columns for "
                             f"{len(nt._fields)} fields")
        out[kind] = nt(*(torch.from_numpy(np.array(a, copy=True)).to(device)
                         for a in cols))
    return out
