"""Packing/compare helpers for the 128-bit timestamp format, in PyTorch.

The host format (primitives.timestamp) packs a timestamp as
``msb = epoch<<16 | hlc_hi16``, ``lsb = hlc_lo48<<16 | flags``, plus an
int32 node id; the total order is (msb, lsb, node) compared *unsigned*
(ref: accord-core/src/main/java/accord/primitives/Timestamp.java:41-45 and
its compareTo).  On the device the layout stays three tensors (int64,
int64, int32) so TxnIds are usable directly as sort/compare keys.

torch has no full uint64 arithmetic, so unsigned comparison flips the sign
bit — ``x ^ i64min`` maps unsigned order onto signed order.  The CUDA
kernels (ops/csrc/common.cuh) compare the words as ``unsigned long long``
directly, which is the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..primitives.timestamp import Timestamp, TxnId, TxnKind

_MASK64 = (1 << 64) - 1
I64_SIGN = -(1 << 63)


def to_i64(v: int) -> int:
    """Unsigned 64-bit value -> the same bits as a python int in int64 range."""
    v &= _MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


def to_u64(v: int) -> int:
    """Signed int64 bits -> unsigned python int."""
    return int(v) & _MASK64


def _flip(x: torch.Tensor) -> torch.Tensor:
    """Map unsigned int64 order onto signed order."""
    return torch.bitwise_xor(x, I64_SIGN)


def ts_lt(a_msb, a_lsb, a_node, b_msb, b_lsb, b_node) -> torch.Tensor:
    """Elementwise (a < b) under the timestamp total order, unsigned on the
    two int64 words, then node id."""
    am, bm = _flip(a_msb), _flip(b_msb)
    al, bl = _flip(a_lsb), _flip(b_lsb)
    return (am < bm) | ((am == bm) & ((al < bl)
                                      | ((al == bl) & (a_node < b_node))))


def ts_le(a_msb, a_lsb, a_node, b_msb, b_lsb, b_node) -> torch.Tensor:
    return ~ts_lt(b_msb, b_lsb, b_node, a_msb, a_lsb, a_node)


def ts_eq(a_msb, a_lsb, a_node, b_msb, b_lsb, b_node) -> torch.Tensor:
    return (a_msb == b_msb) & (a_lsb == b_lsb) & (a_node == b_node)


def masked_ts_max(msb, lsb, node, mask):
    """Lexicographic max of the timestamps selected by ``mask`` along the
    last axis; Timestamp.NONE's bits (zeros) where the mask is empty.
    Three passes: max msb, then max lsb among msb ties, then node."""
    msb, lsb, node, mask = torch.broadcast_tensors(msb, lsb, node, mask)
    if mask.shape[-1] == 0:   # no candidates (an empty slot slice)
        zero = torch.zeros(mask.shape[:-1], dtype=torch.int64,
                           device=msb.device)
        return zero, zero.clone(), zero.to(node.dtype)
    neg = torch.tensor(I64_SIGN, dtype=torch.int64, device=msb.device)
    fm = torch.where(mask, _flip(msb), neg)
    m1 = fm.max(dim=-1, keepdim=True).values
    tie1 = mask & (fm == m1)
    fl = torch.where(tie1, _flip(lsb), neg)
    m2 = fl.max(dim=-1, keepdim=True).values
    tie2 = tie1 & (fl == m2)
    nn = torch.where(tie2, node, torch.full_like(node, -1))
    m3 = nn.max(dim=-1).values
    any_ = mask.any(dim=-1)
    zero = torch.zeros((), dtype=torch.int64, device=msb.device)
    return (torch.where(any_, _flip(m1[..., 0]), zero),
            torch.where(any_, _flip(m2[..., 0]), zero),
            torch.where(any_, m3, torch.zeros_like(m3)))


# -- host-side packing --------------------------------------------------------

def pack_timestamps(ts_list) -> tuple:
    """[Timestamp] -> (msb int64[n], lsb int64[n], node int32[n]) numpy."""
    n = len(ts_list)
    msb = np.zeros(n, dtype=np.int64)
    lsb = np.zeros(n, dtype=np.int64)
    node = np.zeros(n, dtype=np.int32)
    for i, t in enumerate(ts_list):
        msb[i] = to_i64(t.msb)
        lsb[i] = to_i64(t.lsb)
        node[i] = t.node
    return msb, lsb, node


def unpack_timestamp(msb: int, lsb: int, node: int) -> Timestamp:
    return Timestamp(to_u64(msb), to_u64(lsb), int(node))


def unpack_txn_id(msb: int, lsb: int, node: int) -> TxnId:
    return TxnId(to_u64(msb), to_u64(lsb), int(node))


def kind_ordinal(t: TxnId) -> int:
    return int(t.kind())


KIND_COUNT = len(TxnKind)
