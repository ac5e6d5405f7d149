"""What the harness may import: nothing of JAX or the JAX package anywhere
under ``portbench/`` (the top-level module name compared whole, since the
port's ``repro_torch`` begins with ``repro``), and nothing of the port in
the plain reference.  And what it may know of an architecture: outside
``reference/`` and the tests, no file imports an architecture's module by
name (``spec.py`` resolves the one a configuration names) or reads a key
of an ``arch`` but ``vocab_size``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "ml_dtypes"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not set(top_level_imports(path)) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "repro_torch" not in names and "portbench" not in names


def test_whole_name_comparison():
    from portbench.run import BANNED as RUN_BANNED
    assert set(RUN_BANNED) == BANNED
    assert "repro_torch".split(".")[0] not in BANNED


# harness files, outside the architectures' modules and the tests
HARNESS = [p for p in FILES if p.relative_to(HERE).parts[0] not in ("reference", "tests")]
SHARED = {"train"}           # reference/ modules that know no architecture: AdamW
ARCH_KEYS = {"vocab_size"}


def reference_imports(source: str, rel: str):
    """The ``portbench.reference`` modules that the file ``portbench/<rel>``
    holding ``source`` imports, by name."""
    pkg = "portbench.reference"
    here = ["portbench", *Path(rel).parts[:-1]]
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(here[:len(here) - node.level + 1] if node.level else [])
            mod = ".".join(p for p in (base, node.module or "") if p)
            names = [f"{mod}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            names = [arg.value] if isinstance(arg, ast.Constant) else []
        else:
            continue
        for n in names:
            if n == pkg or n.startswith(pkg + "."):
                yield n[len(pkg) + 1:].split(".")[0] or "reference"


def _is_arch(node) -> bool:
    return ((isinstance(node, ast.Name) and node.id == "arch")
            or (isinstance(node, ast.Attribute) and node.attr == "arch")
            or (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
                and node.slice.value == "arch"))


def arch_keys(source: str):
    """The keys a file reads of an ``arch``: ``arch[k]``, ``x.arch[k]``,
    ``config["arch"][k]`` and their ``.get(k)``."""
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Subscript) and _is_arch(node.value)
                and isinstance(node.slice, ast.Constant)):
            yield node.slice.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get" and _is_arch(node.func.value) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(HERE)))
def test_no_architecture_reached_by_name(path):
    source = path.read_text()
    assert set(reference_imports(source, path.relative_to(HERE))) <= SHARED
    assert set(arch_keys(source)) <= ARCH_KEYS


def test_the_rule_sees_what_it_forbids():
    bad = ("from ..reference import decoder\n"
                   "from portbench.reference.decoder import make_weights\n"
                   "import portbench.reference.decoder\n"
                   "from .. import reference\n"
                   "importlib.import_module('portbench.reference.decoder')\n"
                   "L = arch['num_layers'] + obs.arch.get('d_model') + cfg['arch']['head_dim']\n")
    assert set(reference_imports(bad, "drivers/bad.py")) == {"decoder", "reference"}
    assert set(arch_keys(bad)) == {"num_layers", "d_model", "head_dim"}
    train = (HERE / "drivers" / "train.py").read_text()
    assert set(reference_imports(train, "drivers/train.py")) == {"train"}
    assert "vocab_size" in set(arch_keys((HERE / "drivers" / "serve.py").read_text()))
