"""The kernel field engine (ops/kfe.py) and the C++ it generates.

Three evaluations of each generated function must give the same limbs on the
same steady inputs (tolerance: exact):

- the KFE ledger code run on numpy uint32 arrays (the kernels' arithmetic,
  wraparound included);
- the plain torch path (ops/fe.py, ops/points.py) that the kernels' twins use;
- the generated `__host__ __device__` C++ compiled with g++ into a host
  harness: the only check of the CUDA kernels' own arithmetic without a card.

Each runs on secp256k1 (a = 0, solinas base field) and on P-256 (a = -3,
Montgomery base field, no endomorphism); the secp256k1 cases keep their
bare ids.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np

CURVE = get_curve("secp256k1")
CURVES = ("secp256k1", "p256")
NAMES = {c: list(kfe.function_table(get_curve(c))) for c in CURVES}
CASES = [pytest.param(c, name, id=name if c == "secp256k1" else f"{c}-{name}")
         for c in CURVES for name in NAMES[c]]
B = 8


def _field_limbs(spec, rng):
    """Steady limbs [n, B]: the largest and smallest values, then random."""
    if spec.kind == "solinas":            # steady: any limbs <= mask
        arr = rng.integers(0, spec.mask + 1, (spec.n_limbs, B)).astype(np.uint32)
        arr[:, 0] = spec.mask
        arr[:, 1] = 0
        return arr
    vals = [4 * spec.p - 1, 0] + [int.from_bytes(rng.bytes(34), "big") % (4 * spec.p)
                                  for _ in range(B - 2)]
    return ints_to_limbs_np(vals, spec.n_limbs, spec.limb_bits)


def _inputs(curve, name, seed):
    rng = np.random.default_rng(seed)
    params, _ = kfe.function_table(curve)[name]
    spec = curve.scalar if name.startswith("fn_") else curve.field
    out = []
    for _, cnt in params:
        parts = [_field_limbs(spec, rng) for _ in range(cnt // spec.n_limbs)]
        out.append(np.concatenate(parts, 0))
    return out


def _torch(curve, name, args):
    """The plain torch path's result for the generated function `name`."""
    t = [torch.from_numpy(a.astype(np.int64)) for a in args]
    f = curve.scalar if name.startswith("fn_") else curve.field
    if name in ("padd", "pdouble"):
        pts = [P.point_from_limbs(curve, a.reshape(3, f.n_limbs, B)) for a in t]
        out = P.padd(*pts) if name == "padd" else P.pdouble(*pts)
        return P.point_limbs(P.steady(out)).reshape(-1, B)
    if name == "padd_mixed":
        acc = P.point_from_limbs(curve, t[0].reshape(3, f.n_limbs, B))
        out = P.padd_mixed(acc, F.fe_steady(f, t[1]), F.fe_steady(f, t[2]))
        return P.point_limbs(P.steady(out)).reshape(-1, B)
    xs = [F.fe_steady(f, a) for a in t]
    op = name.split("_", 1)[1]
    if op == "mul_beta":
        beta = F.fe_from_int(f, curve.glv["beta"], (B,), "cpu")
        return F.fmul(beta, xs[0]).limbs
    out = {"mul": lambda: F.fmul(*xs), "sqr": lambda: F.fsquare(xs[0]),
           "neg": lambda: F.fneg(xs[0])}[op]()
    return F.fsteady(out).limbs


@pytest.mark.parametrize("cname, name", CASES)
def test_numpy_engine_equals_torch(cname, name):
    curve = get_curve(cname)
    args = _inputs(curve, name, 1)
    got = kfe.evaluate(curve, name, *args)
    np.testing.assert_array_equal(got, _torch(curve, name, args).numpy().astype(np.uint32))


@pytest.mark.parametrize("cname, which", [
    pytest.param(c, w, id=w if c == "secp256k1" else f"{c}-{w}")
    for c in CURVES for w in ("field", "scalar")])
def test_numpy_steady_equals_torch(cname, which):
    spec = getattr(get_curve(cname), which)
    rng = np.random.default_rng(2)
    x, y = _field_limbs(spec, rng), _field_limbs(spec, rng)
    k = kfe.ksteady(kfe.kadd(kfe.kfe_from_rows(spec, list(x)),
                             kfe.kfe_from_rows(spec, list(y))))
    t = F.fsteady(F.fadd(F.fe_steady(spec, torch.from_numpy(x.astype(np.int64))),
                         F.fe_steady(spec, torch.from_numpy(y.astype(np.int64)))))
    np.testing.assert_array_equal(np.stack(k.limbs), t.limbs.numpy())


def test_instruction_count_fuses():
    """A multiply whose only use is an add is one IMAD with it, a right
    shift used only by an add one LEA.HI, an add of a two-term add used
    only there one IADD3; a value used twice is not fused."""
    em = kfe.Emitter({})
    a, b, c, d = (kfe.Sym(em, name=f"x[{i}]") for i in range(4))
    s = a * b + c * d            # IMUL, IMAD
    t = (s >> 13) + a            # LEA.HI
    u = (t + b) - c              # IADD3
    q = a * c                    # IMUL, used by two adds
    _, counts = em.function("f", [("x", 4)], [u & 8191, q + a, q + b])
    assert counts == {"imad": 3, "alu": 1, "other": 4}
    # the generated mixed add (11 field multiplies) counts fewer of each
    # class than the full add (12), and its callees' counts are in it
    _, by_fn = kfe.kernel_header(CURVE, ["padd", "padd_mixed", "fp_mul"])
    mixed, full = by_fn["padd_mixed"], by_fn["padd"]
    assert all(0 < mixed[c] < full[c] for c in kfe.INSTRUCTION_CLASSES)
    assert mixed["imad"] > 8 * by_fn["fp_mul"]["imad"]


def test_formulas_not_ported_raise():
    """The 13-bit generator, which no kernel builds from (its counts are the
    "kfe" design of the bounds), keeps two strategies: the generic-a
    formulas of the brainpool r1 curves are on the plain and 32-bit
    layers only."""
    with pytest.raises(NotImplementedError):
        kfe.kernel_header(get_curve("bp256r1"), ["padd"])


def test_ladder_functions_follow_the_endomorphism():
    """The ladder takes beta * x (its header, on the 32-bit layer, sets
    HAS_BETA and the constant beta) only for a curve with an endomorphism;
    every kernel's header generates for P-256, which has none (the probes'
    chains for its bare field)."""
    k256, p256 = get_curve("secp256k1"), get_curve("p256")
    assert "ladder" in kernels.FE32_KERNELS
    assert "static constexpr bool HAS_BETA = true;" in kernels._header("ladder", k256)
    assert "static constexpr bool HAS_BETA = false;" in kernels._header("ladder", p256)
    assert "fp_mul_beta" not in kfe.function_table(p256)
    assert "fp_mul_beta" in kfe.function_table(k256)
    for name in kernels.KERNELS:
        if name in kernels.FIELD_KERNELS:
            assert "struct Field32" in kernels._header(name, p256.field)
        elif name in kernels.FE32_KERNELS:
            assert "struct Curve32" in kernels._header(name, p256)
        else:                           # dma_gather: no generated header
            assert kernels._header(name, None) == ""
    # the 13-bit generator (the "kfe" design of the bounds) still generates
    header, counts = kfe.kernel_header(p256, ["fp_mul", "padd"])
    assert "#define KFE_FP_N 21" in header and all(sum(c.values()) > 0
                                                   for c in counts.values())
    assert kernels.work("ladder", p256, 8, T=2, nw=65, glv=False)[0]["imad"] > 0


_HARNESS = """\
#include <cstdio>
#include <cstring>
#include "kfe_all.cuh"
int main(int argc, char** argv) {{
  int B;
  if (argc != 2 || scanf("%d", &B) != 1) return 2;
{cases}
  return 3;
}}
"""

_CASE = """\
  if (!strcmp(argv[1], "{name}")) {{
    for (int l = 0; l < B; ++l) {{
{decls}      uint32_t out[{nout}];
      kfe_{name}({args}, out);
      for (int i = 0; i < {nout}; ++i) printf("%u ", out[i]);
      printf("\\n");
    }}
    return 0;
  }}
"""


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """The g++ harness of each curve, built at first use."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    built = {}

    def get(cname):
        if cname not in built:
            built[cname] = _build_harness(gxx, tmp_path_factory.mktemp(f"kfe-{cname}"),
                                          get_curve(cname))
        return built[cname]

    return get


def _build_harness(gxx, d, curve):
    names = list(kfe.function_table(curve))
    header, counts = kfe.kernel_header(curve, names)
    assert set(counts) == set(names) and all(sum(c.values()) > 0 for c in counts.values())
    (d / "kfe_all.cuh").write_text(header)
    cases = []
    for name in names:
        params, _ = kfe.function_table(curve)[name]
        decls = "".join(
            f"      uint32_t {p}[{c}];\n"
            f"      for (int i = 0; i < {c}; ++i) if (scanf(\"%u\", &{p}[i]) != 1) return 4;\n"
            for p, c in params)
        cases.append(_CASE.format(name=name, decls=decls, nout=params[0][1],
                                  args=", ".join(p for p, _ in params)))
    (d / "harness.cpp").write_text(_HARNESS.format(cases="".join(cases)))
    exe = d / "harness"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(d), "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True)
    return exe


@pytest.mark.parametrize("cname, name", CASES)
def test_generated_cpp_equals_numpy(harnesses, cname, name):
    curve = get_curve(cname)
    args = _inputs(curve, name, 3)
    lanes = [" ".join(str(int(v)) for a in args for v in a[:, lane]) for lane in range(B)]
    res = subprocess.run([str(harnesses(cname)), name], input=f"{B}\n" + "\n".join(lanes),
                         capture_output=True, text=True, check=True)
    got = np.array([[int(v) for v in ln.split()] for ln in res.stdout.splitlines()],
                   np.uint32).T
    np.testing.assert_array_equal(got, kfe.evaluate(curve, name, *args))
