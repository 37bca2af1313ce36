"""Nothing the run or the reference loads is JAX or the JAX package,
compared by whole top-level names (kintinuous_tpu_torch starts with
kintinuous_tpu and is neither)."""

import json
import subprocess
import sys

from slambench import run
from slambench.spec import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import slambench.compare, slambench.reference.step
ref_only = sorted({{m.split('.')[0] for m in sys.modules}})
import slambench.run, slambench.session, slambench.sets, slambench.trace
from slambench import spec
for m in spec.load_benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
import kintinuous_tpu_torch.runtime.engine, kintinuous_tpu_torch.cli
print(json.dumps({{"ref": ref_only, "run": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""


def test_top_level_names_are_compared_whole():
    assert run.forbidden_modules({"kintinuous_tpu_torch": 0, "kintinuous_tpu_torch.ops": 0,
                                  "jaxtyping": 0, "flaxen": 0}) == []
    assert run.forbidden_modules({"kintinuous_tpu.ops.tsdf": 0}) == ["kintinuous_tpu"]
    assert run.forbidden_modules({"jax": 0, "jaxlib.xla": 0, "flax": 0}) == \
        ["flax", "jax", "jaxlib"]


def test_run_and_reference_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("ref", "run"):
        assert not set(mods[key]) & set(run.FORBIDDEN), (key, set(mods[key]) & set(run.FORBIDDEN))
    # the reference imports nothing of the program
    assert "kintinuous_tpu_torch" not in mods["ref"]
    assert "kintinuous_tpu_torch" in mods["run"]
