"""What the benchmark imports: no module under chipbench/ imports JAX,
jaxlib, flax or the JAX package (`repro`), compared by whole top-level
names (the port, `repro_torch`, is not `repro`); the reference also
imports nothing of the port."""
import ast

import pytest

from chipbench.bench import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_names_are_compared_whole(tmp_path):
    path = tmp_path / "x.py"
    path.write_text("import repro_torch.api\nfrom repro_torch import x\n"
                    "import reprox\n")
    assert top_level_imports(path) == {"repro_torch", "reprox"}
    path.write_text("from repro.api import y\n")
    assert top_level_imports(path) & FORBIDDEN == {"repro"}
