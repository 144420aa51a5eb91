"""Nothing the harness, the references or a cell loads is JAX or the JAX
package: top-level module names compared whole (the port's name,
``repro_torch``, begins with the JAX package's)."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

from harness.runner import FORBIDDEN, forbidden_modules

SCRIPT = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
""" + """
import torch
from harness import check, data, faults, program, runner, spec, trace

bench = json.load(open(spec.ROOT / "BENCHMARK.json"))
for w in bench["workloads"]:
    cell = spec.cell(w["name"])
    spec.reference(cell.cfg["arch"]).flops_per_image(cell.cfg)
    program.Job  # the program's step builder
    spec.program(cell.cfg["arch"]).modules(cell.cfg)
    for m in cell.end_to_end + cell.per_layer:
        spec.metric(m["name"])
import repro_torch.exec, repro_torch.obs
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_or_reference_package_is_loaded(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in roots
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.exec", "jaxtyping",
                              "torch"]) == []
    assert forbidden_modules(["repro.exec", "jax", "flax.linen",
                              "jaxlib"]) == ["flax", "jax", "jaxlib", "repro"]
