"""The PyTorch port stands alone: no module under ``src/repro_torch/`` (nor
``chip_smoke.py``, the tools or the port's examples) imports ``jax`` or the
JAX package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("*.py")) \
    + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_serving_modules_are_walked():
    """The walk covers the serving subpackage and its CLI."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"serve/__init__.py", "serve/cache_pool.py", "serve/engine.py",
            "serve/pages.py", "serve/request.py", "serve/scheduler.py",
            "launch/serve.py"} <= names


def test_pipeline_mesh_and_checkpoint_modules_are_walked():
    """The walk covers the row pipeline, the mesh, the sharding rules, the
    shard wrappers' collectives and the checkpoint store."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"exec/pipeline.py", "exec/collectives.py", "launch/mesh.py",
            "launch/sharding.py", "ckpt/__init__.py",
            "ckpt/store.py"} <= names


def test_dry_run_modules_are_walked():
    """The walk covers the dry run, its analysis, the trace-rate tool and
    the dry-run example."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/launch/dryrun.py",
            "src/repro_torch/analysis/costmodel.py",
            "src/repro_torch/analysis/roofline.py",
            "src/repro_torch/analysis/report.py",
            "tools/trace_rate.py",
            "examples/torch_dryrun_roofline.py"} <= names


def test_fake_process_group_is_imported_only_where_it_is_joined():
    """``torch.testing._internal.distributed.fake_pg`` (a private module,
    whose import registers the ``fake`` backend) is imported by no port
    module at module level: only inside ``launch.mesh.join_fake_group``."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not any(n.startswith("torch.testing") for n in names), \
                path
    mesh = (PORT / "launch" / "mesh.py").read_text()
    assert "torch.testing._internal.distributed.fake_pg" in mesh
