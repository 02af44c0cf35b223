"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package ``repro``, nor
``msgpack``, which the card's machine does not have (the checkpoint
format is decoded by hand, ``train/_msgpack.py``)."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


def test_no_import_names_jax_or_repro():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad
    assert len(_sources()) > 15


def test_every_module_imports_without_jax():
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None          # any import of them now fails
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
assert {{"repro_torch.graphs.fx_import",
         "repro_torch.graphs.model_zoo"}} <= set(mods)   # the importer
for name in mods:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
