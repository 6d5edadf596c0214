"""No module of the benchmark imports JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from port_bench.cell import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set:
    """Every imported module's full name in a file, relative imports resolved against its package."""
    tree = ast.parse(path.read_text(), str(path))
    package = ".".join(("port_bench", *path.relative_to(BENCH).parent.parts))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                names.add(".".join(base + ([node.module] if node.module else [])))
            else:
                names.add(node.module)
    return names


FILES = sorted(BENCH.rglob("*.py"))


def test_found_the_modules():
    assert any(p.name == "run.py" for p in FILES) and any("reference" in p.parts for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    top = {name.partition(".")[0] for name in imported(path)}
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.relative_to(BENCH).parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_is_plain(path):
    names = imported(path)
    assert not any(n.partition(".")[0] == "muggled_dpt_tpu_torch" for n in names), names
    assert all(n.partition(".")[0] in {"torch", "numpy", "math", "contextlib", "__future__"}
               or n.startswith("port_bench.reference") for n in names), names


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys

    from port_bench import cell

    monkeypatch.setitem(sys.modules, "muggled_dpt_tpu_torch_fake", object())
    assert "muggled_dpt_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "muggled_dpt_tpu.fake", object())
    assert "muggled_dpt_tpu" in cell.forbidden_modules()
