"""The port's kernel-wrapper layer on the CPU: every ``extern "C"`` entry
of ``csrc/*.cu`` against the table its wrapper registers with
``ops._build`` (ctypes converts untyped or mistyped arguments silently, and
a list one int short segfaulted the host once), and the layering of
``ops/``: imports run one way, at module level, to public names, and only
``_build`` speaks ctypes or reads a stream."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import ctypes  # noqa: E402
import glob  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import pkgutil  # noqa: E402
import re  # noqa: E402

from speech_decoding_tpu_torch import ops  # noqa: E402
from speech_decoding_tpu_torch.ops import _build  # noqa: E402

OPS_DIR = os.path.dirname(ops.__file__)
PKG = "speech_decoding_tpu_torch"
KIND = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "int": ctypes.c_int,
        "long long": ctypes.c_longlong, "float": ctypes.c_float, "double": ctypes.c_double}

for _m in pkgutil.iter_modules(ops.__path__):  # every wrapper registers its table on import
    importlib.import_module(f"{ops.__name__}.{_m.name}")


def _c_entries():
    """{(library, entry): [parameter types]} of every ``extern "C"`` entry of
    csrc/*.cu, an entry a macro stamps out (``name##SUF``) once for each
    suffix the macro is invoked with."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.SRC_DIR, "*.cu"))):
        lib = os.path.basename(path)[:-3]
        with open(path) as f:
            src = f.read().replace("\\\n", "\n")
        suffixes = [s for macro in re.findall(r"#define (\w+)\(SUF\b", src)
                    for s in re.findall(rf"^{macro}\((\w+)", src, re.M)]
        for name, params in re.findall(r'extern "C" int ([\w#]+)\(([^)]*)\)', src):
            types = [re.sub(r"\s+\w+$", "", p.strip()) for p in params.split(",")]
            for suf in suffixes if name.endswith("##SUF") else ("",):
                out[lib, name.replace("##SUF", suf)] = types
    return out


C_ENTRIES = _c_entries()


@pytest.mark.parametrize("lib,entry", sorted(C_ENTRIES), ids=[f"{lib}:{e}" for lib, e in sorted(C_ENTRIES)])
def test_every_c_entry_has_its_signature_registered(lib, entry):
    """The entry's library registers a table with ``_build``, the table
    lists exactly the source's entries, and the entry's argtypes (its table
    row and the trailing stream) are its C declaration's, in order."""
    assert lib in _build.LIBRARIES, f"csrc/{lib}.cu has no table registered with ops._build"
    table = _build.LIBRARIES[lib]
    assert sorted(table.signatures) == sorted(e for lb, e in C_ENTRIES if lb == lib)
    params = C_ENTRIES[lib, entry]
    assert [KIND[p] for p in params] == table.argtypes(entry), (entry, params)


def _imports(tree):
    """(node, inside a function) for every import of ``tree``."""
    found = []

    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                found.append((child, in_fn))
            walk(child, in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    walk(tree, False)
    return found


def test_ops_layering():
    """In ``ops/*.py``: no import of an ``ops`` module inside a function; no
    ``_``-prefixed name imported from a port module (``_build`` imported as
    a module aside); ``argtypes`` and ``cuda_stream`` touched in ``_build``
    alone; and the imports among ``ops`` modules form no cycle."""
    bad, deps = [], {}
    for path in sorted(glob.glob(os.path.join(OPS_DIR, "*.py"))):
        name = os.path.basename(path)[:-3]
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        deps[name] = set()
        for node, in_fn in _imports(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                base = node.module or ""
                mods = [base] + [f"{base}.{a.name}" for a in node.names]
                for a in node.names:
                    if base.startswith(PKG) and a.name.startswith("_") and (base, a.name) != (ops.__name__, "_build"):
                        bad.append(f"{name}: imports the private {base}.{a.name}")
            siblings = {m.split(".")[2] for m in mods if m.startswith(f"{ops.__name__}.")}
            if siblings and in_fn:
                bad.append(f"{name}: imports {sorted(siblings)} inside a function")
            deps[name] |= siblings - {name}
        if name != "_build":
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and node.attr in ("argtypes", "cuda_stream"):
                    bad.append(f"{name}:{node.lineno}: .{node.attr} outside _build")
    done, path = set(), []

    def visit(m):
        if m in path:
            bad.append(f"import cycle: {' -> '.join(path[path.index(m):] + [m])}")
            return
        if m in done:
            return
        path.append(m)
        for d in sorted(deps.get(m, ())):
            visit(d)
        path.pop()
        done.add(m)

    for m in sorted(deps):
        visit(m)
    assert not bad, bad
