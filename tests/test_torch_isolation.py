"""The port stands alone: importing ``accord_tpu_torch`` and running a tiny
burn on the CPU loads no JAX and nothing of the JAX package.  Run in a
subprocess (this test process imports JAX through the conftest), plus a
static check over every source file of the port."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "accord_tpu_torch"

PROBE = r"""
import json, sys
from accord_tpu_torch.sim.burn import run_burn
r = run_burn(2, n_ops=8, node_ids=(1, 2, 3), rf=3, shards=2, device="cpu")
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "accord_tpu"))
print(json.dumps({"mods": mods, "ok": r.ops_ok,
                  "unresolved": r.ops_unresolved}))
"""


def test_no_jax_and_no_reference_in_a_port_run():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mods"] == [], res["mods"]
    assert res["unresolved"] == 0 and res["ok"] > 0


IMPORT = re.compile(r"^\s*(import|from)\s+(\S+)", re.M)


def test_no_source_imports_jax_or_the_reference():
    bad = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 90
    for f in files:
        for m in IMPORT.finditer(f.read_text()):
            top = m.group(2).split(".")[0]
            if top in ("jax", "jaxlib", "accord_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert bad == []
