"""tpu_ecc_torch and the chip scripts import neither jax, tpu_ecc nor the
repo's tools/ (AST scan), and nothing in tpu_ecc_torch names a path into
tpu_ecc/ or tools/, so no source is built or loaded from there. The port's
own tools live in tpu_ecc_torch/tools/."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_ecc_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
FORBIDDEN = ("jax", "jaxlib", "tpu_ecc", "tools")
# a "file:line" reference to the TPU kernel a CUDA kernel replaces is text,
# not a path the code opens
_REFERENCE = re.compile(r"(tpu_ecc|tools)/[\w/]+\.py:\d+")
# a path into tpu_ecc/ or into the repo's tools/ (the port's own
# tpu_ecc_torch/tools/ is not one)
_INTO_REFERENCE = re.compile(r"(^|[/\\])tpu_ecc([/\\]|$)|(^|(?<!tpu_ecc_torch)[/\\])tools([/\\]|$)")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
              and (getattr(node.func, "id", None) == "__import__"
                   or getattr(node.func, "attr", None) == "import_module")):
            yield str(node.args[0].value)


def _strings(tree: ast.AST):
    """String constants other than docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [v for v in _strings(tree)
           if _INTO_REFERENCE.search(v) and not _REFERENCE.fullmatch(v)]
    assert not bad, f"{path.name} names paths into tpu_ecc/ or tools/: {bad}"


@pytest.mark.parametrize("src, bad", [
    ("import tools.bench_mxu_mul", True), ("from tools import profile_ladder", True),
    ("importlib.import_module('tools.bench_gather_probe')", True),
    ("from tpu_ecc_torch.tools import profile_ladder", False),
    ("from . import bench_mxu_mul", False)])
def test_import_scan_catches_the_repos_tools(src, bad):
    names = [m for m in _imported(ast.parse(src)) if m.split(".")[0] in FORBIDDEN]
    assert bool(names) == bad


@pytest.mark.parametrize("text, bad", [
    ("tools/bench_mxu_mul.py", True), ("../tools/x.py", True), ("tools", True),
    ("/repo/tools/profile_ladder.py", True), ("tpu_ecc/ops/fe.py", True),
    ("tools/bench_mxu_mul.py:232", False), ("tpu_ecc/ops/pallas_kernels.py:887", False),
    ("tpu_ecc_torch/tools/profile_ladder.py", False), ("tpu_ecc_torch.tools", False)])
def test_path_scan_catches_the_repos_tools(text, bad):
    assert bool(_INTO_REFERENCE.search(text) and not _REFERENCE.fullmatch(text)) == bad


def test_native_sources_are_the_ports_own():
    """The native code and the CUDA kernels build from files inside
    tpu_ecc_torch; the native source is the JAX package's file, unchanged;
    no C++ source includes a file from tpu_ecc/."""
    from tpu_ecc_torch import native
    from tpu_ecc_torch.ops import kernels

    for p in (native.SOURCE, kernels.CSRC):
        assert pathlib.Path(p).resolve().is_relative_to(PKG)
    assert (pathlib.Path(native.SOURCE).read_bytes()
            == (ROOT / "tpu_ecc" / "native" / "fastcrypt.cpp").read_bytes())
    for src in list(PKG.rglob("*.cu")) + list(PKG.rglob("*.cpp")):
        includes = re.findall(r'#include\s*"([^"]+)"', src.read_text())
        assert not [i for i in includes if "tpu_ecc" in i], src.name


def test_scan_sees_the_package():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"tpu_ecc_torch/ops/fe.py", "tpu_ecc_torch/ops/kfe.py",
            "tpu_ecc_torch/ops/kernels.py", "tpu_ecc_torch/protocols/ecdsa.py",
            "tpu_ecc_torch/protocols/rfc6979.py", "tpu_ecc_torch/native/__init__.py",
            "tpu_ecc_torch/parallel/msm.py", "tpu_ecc_torch/tools/bench_gather_probe.py",
            "tpu_ecc_torch/tools/bench_mxu_mul.py", "tpu_ecc_torch/tools/profile_ladder.py",
            "tpu_ecc_torch/protocols/schnorr.py", "tpu_ecc_torch/protocols/ecdh.py",
            "tpu_ecc_torch/protocols/hash2curve.py", "tpu_ecc_torch/utils/keccak.py",
            "tpu_ecc_torch/encoding/keys.py", "tpu_ecc_torch/encoding/asn1.py",
            "tpu_ecc_torch/encoding/serde.py", "tpu_ecc_torch/curves/scalars.py",
            "chip_smoke.py"} <= names
