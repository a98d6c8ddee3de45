"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's ``ffpa_attn_tpu_torch`` begins with
``ffpa_attn_tpu``), and the plain reference imports nothing of the port."""

import ast
import sys

import pytest

from perfbench import harness

FILES = sorted(harness.BENCH_DIR.rglob("*.py"))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "refs").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert _top_level_imports(path) <= {"torch", "__future__"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import ffpa_attn_tpu_torch  # noqa: F401

    for name in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "jaxlibrary_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ffpa_attn_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert harness.forbidden_modules() == ["ffpa_attn_tpu", "flax"]
