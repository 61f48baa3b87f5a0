"""The port answers to the JAX package's public names.

A user who switches packages keeps their imports: every name a JAX
``__init__.py`` binds (its imports, definitions and the lazy names of a
module ``__getattr__``) resolves from the port's package of the same path,
and every public name a JAX module defines (functions, classes, constants)
resolves from the port's module of the same path.  The JAX sources are read
by AST: nothing of JAX is imported.  LEFT_OUT lists the names the port
does not carry, each with its reason; MOVED the names it carries in
another module.
"""
import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "finitestateentropy_tpu"
PORT = "finitestateentropy_tpu_torch"

# JAX module (path in the package) -> {name: why the port has no such name}
LEFT_OUT = {
    "turbo/kernels.py": {"MAX_STEP_BITS": "the v0 Pallas kernel's VMEM bound; the CUDA "
                                          "kernel has no such bound"},
    "turbo/rans_kernels.py": {
        "TSIZE": "the Pallas kernels' chunk-select table layout",
        "TCHUNKS": "the Pallas kernels' chunk-select table layout"},
}
# JAX module -> {name: the port's module that holds it}: the pure-numpy
# table packers and routing helpers of jax-importing modules are copied
# into turbo/tables.py
_TABLES = "turbo/tables.py"
MOVED = {"turbo/rans_kernels.py": {n: _TABLES for n in (
    "pack_pair_dtable", "pack_quad_dtable", "pack_rans16_ctables", "pack_rans16_dtable",
    "pack_rans16x_ctables", "pack_rans16x_dtable", "pack_rans_ctables", "pack_rans_dtable",
    "pack_stream_words", "v2_pick_nway")}}


def _module(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    parts = parts[:-1] if parts[-1] == "__init__" else parts
    return ".".join((PORT, *parts))


def _bound_names(tree: ast.Module, init: bool) -> set[str]:
    """Public names a module binds at top level: definitions and constants,
    and in an __init__ also its imports and its __getattr__'s lazy names."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name == "__getattr__" and init:
                out |= {c.value for c in ast.walk(node)
                        if isinstance(c, ast.Constant) and isinstance(c.value, str)
                        and c.value.isidentifier()}
            else:
                out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif init:
            for imp in ast.walk(node):
                if isinstance(imp, ast.ImportFrom) and imp.module != "__future__":
                    out |= {a.asname or a.name for a in imp.names}
    return {n for n in out if not n.startswith("_")}


JAX_FILES = sorted(str(f.relative_to(JAX_PKG)) for f in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_FILES)
def test_jax_public_names_resolve_in_port(rel):
    left = LEFT_OUT.get(rel, {})
    tree = ast.parse((JAX_PKG / rel).read_text())
    names = _bound_names(tree, rel.endswith("__init__.py"))
    assert names or rel.endswith("__init__.py")
    port = importlib.import_module(_module(rel))
    moved = MOVED.get(rel, {})
    missing = []
    for name in sorted(names):
        if name in left:
            continue
        where = importlib.import_module(_module(moved[name])) if name in moved else port
        if not hasattr(where, name):
            missing.append(name)
    assert missing == [], f"{rel}: the port lacks {missing}"
    # the lists name only names the JAX module has and the port lacks
    for name in left:
        assert name in names and not hasattr(port, name), (rel, name)
    assert set(moved) <= names


def test_left_out_and_moved_name_jax_modules():
    assert set(JAX_FILES) >= set(LEFT_OUT) | set(MOVED)


def test_codec_config_equals_jax():
    """CodecConfig, the one class the port lacked: the same fields,
    defaults and block size."""
    import dataclasses

    from finitestateentropy_tpu.config import CodecConfig as JCodecConfig
    from finitestateentropy_tpu_torch import CodecConfig

    fields = [(f.name, f.default) for f in dataclasses.fields(CodecConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JCodecConfig)]
    for bid in range(7):
        assert CodecConfig(block_size_id=bid).block_size == JCodecConfig(block_size_id=bid).block_size


def test_cli_tablelog_default_equals_jax_and_rans():
    """The CLI's import-free RANS_TABLELOG_DEFAULT: the JAX CLI's value and
    the port's ratio-mode tableLog."""
    from finitestateentropy_tpu import cli as jcli
    from finitestateentropy_tpu_torch import cli
    from finitestateentropy_tpu_torch.turbo.rans import RANS_TABLELOG

    assert cli.RANS_TABLELOG_DEFAULT == jcli.RANS_TABLELOG_DEFAULT == RANS_TABLELOG
