"""The port's graft entries (``accord_tpu_torch/graft_entry.py``) against
the repository's ``__graft_entry__.py``.

``entry()``: the one-device protocol step (K1a bucketed scan, K11 dense
scan with max-conflict, K8 dense and ELL fixpoint drains) gives the
reference step's bytes on the same example inputs.  ``dryrun_multichip(8)``
runs its own checks (the sharded step against the single-device kernels,
the live sim cluster over the mesh, the row-sharded frontier, the mesh
bucketed and pruned routes) on an 8-slice CPU mesh.  Tolerance zero."""

import numpy as np
import torch

import __graft_entry__ as ref_graft
from accord_tpu_torch import graft_entry


def _flat(x):
    if isinstance(x, (tuple, list)):
        out = []
        for y in x:
            out.extend(_flat(y))
        return out
    return [x.numpy() if torch.is_tensor(x) else np.asarray(x)]


def test_entry_equals_reference():
    rfn, rargs = ref_graft.entry()
    pfn, pargs = graft_entry.entry("cpu")
    want = _flat(rfn(*rargs))
    got = _flat(pfn(*pargs))
    assert len(want) == len(got) == 10
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    # the step found deps and drained something
    assert int(got[0][0]) > 0 and got[2].any() and got[6].any()


def test_entry_inputs_equal_reference():
    _rfn, rargs = ref_graft.entry()
    _pfn, pargs = graft_entry.entry("cpu")
    for w, g in zip(_flat(rargs), _flat(pargs)):
        np.testing.assert_array_equal(w, g)


def test_dryrun_multichip_cpu():
    graft_entry.dryrun_multichip(8, device="cpu")
