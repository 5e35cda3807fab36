"""The probe kernels' plain twins (ops/kernels.py) and the port's probe tools
(tpu_ecc_torch/tools/) against the JAX repo's own probe code, on the same
numpy-made inputs (tolerance: exact, limb for limb or word for word):

- B13 `dma_gather_plain` against tools/bench_gather_probe.py's
  `dma_gather_call` in Pallas interpret mode;
- B14 `fmul_chain_plain` against the tool's 16-multiply loop body on
  tpu_ecc's kernel field engine (`kfe_from_rows`, `kmul`, `ksteady`), and
  against the 13-bit generator's `kfe_fp_mul` (the "kfe" design of the
  bound, which no kernel builds) through numpy and through g++;
- B15 `mxu_chain_plain` against 16 applications of tools/bench_mxu_mul.py's
  `make_mxu_mul` (the port's `make_mxu_mul` too);
- B16 `ladder_probe_plain` against the profile_ladder.py body's semantics
  on tpu_ecc's `_KADD`, `_KDOUBLE` and `_ident_rows`, and the host oracle.

The JAX tools are loaded from their files; nothing in them changes. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py);
here g++ builds their lane code on the 32-bit layer (csrc/fe32.cuh,
csrc/chain32.cuh) against each probe field's generated header
(`kfe.fe32_field_header`), and holds it mod p: `fmul_chain`'s lane body
against `fmul_chain_plain`; `mxu_chain`'s step on the CUDA cores (the
digits' layout, the folds of the column sums into words), fed the column
sums that numpy computes from the byte matrices the kernel loads, one step
against Python integers and sixteen through the load and store against
`mxu_chain_plain`; and the byte matrices against `mont_matrices`.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ecc.curves.specs import get_curve as jax_curve
from tpu_ecc.ops import fe as JF
from tpu_ecc.ops import fe_kernel as JK
from tpu_ecc.ops import pallas_kernels as PK
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.tools import bench_gather_probe, bench_mxu_mul
from tpu_ecc_torch.utils import ec_host

from fe32_harness import _from_words, _limb_ints, _to_words, runner

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ["p256.fp", "k256mxu.fp", "secp256k1.fp"]
MONT = FIELDS[:2]


@functools.lru_cache(maxsize=None)
def _tool(name):
    """The JAX repo's tools/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(name):
    """(the port's spec, tpu_ecc's spec) of a probe field."""
    if name == "k256mxu.fp":
        p = get_curve("secp256k1").p
        return F.make_field_spec(name, p, "mont"), JF.make_field_spec(name, p, "mont")
    curve = name.split(".")[0]
    return get_curve(curve).field, jax_curve(curve).field


@pytest.mark.parametrize("name", FIELDS)
def test_probe_fields_match_tpu_ecc(name):
    """The forced-Montgomery secp256k1 field (13-bit limbs, n = 21) and the
    other two have tpu_ecc's plan, field for field."""
    port, ref = _fields(name)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    if name == "k256mxu.fp":
        assert (port.kind, port.limb_bits, port.n_limbs) == ("mont", 13, 21)


# -- B13: the gather probe ----------------------------------------------------

@pytest.mark.parametrize("depth", [2, 8])
def test_dma_gather_plain_matches_the_tool(depth):
    N, W, M, Cb = 1024, 128, 256, 64
    tool = _tool("bench_gather_probe")
    pay = np.array(tool._device_payload(N, W))
    assert np.array_equal(bench_gather_probe.device_payload(N, W, "cpu").numpy().view(np.uint32),
                          pay)
    idx = np.random.default_rng(depth).permutation(N).astype(np.int32)[:M]
    want = np.asarray(tool.dma_gather_call(N, W, M, Cb, depth, interpret=True)(
        jnp.asarray(idx), jnp.asarray(pay)))
    assert np.array_equal(want, np.bitwise_xor.reduce(pay[idx], axis=0, keepdims=True))
    got = kernels.dma_gather(torch.from_numpy(pay.view(np.int32)), torch.from_numpy(idx),
                             Cb, depth)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_dma_gather_rejects_what_the_kernel_does_not_take():
    pay = bench_gather_probe.device_payload(64, 128, "cpu")
    idx = torch.arange(32, dtype=torch.int32)
    for Cb, depth in ((12, 4), (16, 3)):              # Cb must divide M, depth Cb
        with pytest.raises(ValueError):
            kernels.dma_gather(pay, idx, Cb, depth)
    with pytest.raises(ValueError):                    # a row of 40 bytes
        kernels.dma_gather(pay[:, :10].contiguous(), idx, 16, 4)
    wide = bench_gather_probe.device_payload(64, 1024, "cpu")
    with pytest.raises(ValueError, match="ring"):      # 64 slots of 4 KB: above a block's
        kernels.dma_gather(wide, torch.arange(64, dtype=torch.int32), 64, 64)


# -- B14: the field-multiply chain ---------------------------------------------

def _field_inputs(name, B, seed):
    """Canonical limbs of B random elements and of the same reversed, as
    numpy int64 [n, B] (the same from both packages' encoders)."""
    port, ref = _fields(name)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "big") % port.p for _ in range(B)]
    a, b = (np.asarray(JF.fe_from_ints(ref, v).limbs).astype(np.int64)
            for v in (vals, vals[::-1]))
    assert np.array_equal(F.fe_from_ints(port, vals, "cpu").limbs.numpy(), a)
    return vals, a, b


@pytest.mark.parametrize("name", FIELDS)
def test_fmul_chain_plain_matches_the_kfe_chain(name):
    """The tool's loop body (bench_mxu_mul.py:358-366) on tpu_ecc's kernel
    field engine, eagerly on jnp arrays; and the generated kfe_fp_mul, 16
    times, on the port's numpy engine."""
    port, ref = _fields(name)
    n = port.n_limbs
    vals, a, b = _field_inputs(name, 128, 1)
    A = JK.kfe_from_rows(ref, [jnp.asarray(a[i], jnp.uint32) for i in range(n)])
    Bk = JK.kfe_from_rows(ref, [jnp.asarray(b[i], jnp.uint32) for i in range(n)])
    for _ in range(kernels.CHAIN):
        A = JK.ksteady(JK.kmul(A, Bk))
    want = np.stack([np.asarray(r) for r in A.limbs]).astype(np.int64)
    got = kernels.fmul_chain(port, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    x = a.astype(np.uint32)
    for _ in range(kernels.CHAIN):
        x = kfe.evaluate(port, "fp_mul", x, b.astype(np.uint32))
    np.testing.assert_array_equal(x.astype(np.int64), want)
    out = F.fe_to_ints(F.fe_steady(port, torch.from_numpy(got)))
    assert out == [v * pow(w, kernels.CHAIN, port.p) % port.p for v, w in zip(vals, vals[::-1])]


_HARNESS = """\
#include <cstdio>
#include "kfe_fmul_chain.cuh"
int main() {{
  int B;
  if (scanf("%d", &B) != 1) return 2;
  for (int l = 0; l < B; ++l) {{
    uint32_t a[{n}], b[{n}], o[{n}];
    for (int i = 0; i < {n}; ++i) if (scanf("%u", &a[i]) != 1) return 3;
    for (int i = 0; i < {n}; ++i) if (scanf("%u", &b[i]) != 1) return 3;
    for (int r = 0; r < {chain}; ++r) {{
      kfe_fp_mul(a, b, o);
      for (int i = 0; i < {n}; ++i) a[i] = o[i];
    }}
    for (int i = 0; i < {n}; ++i) printf("%u ", a[i]);
    printf("\\n");
  }}
  return 0;
}}
"""


@pytest.mark.parametrize("name", FIELDS)
def test_fmul_chain_generated_cpp_matches_plain(tmp_path, name):
    """The 13-bit generator's kfe_fp_mul for the bare field spec (the "kfe"
    design of fmul_chain's bound; no kernel includes it) compiled with g++
    and run 16 times per lane, as the 13-bit chain ran it, equals the
    twin limb for limb."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    port, _ = _fields(name)
    n = port.n_limbs
    header, counts = kfe.kernel_header(port, ("fp_mul",))
    assert set(counts) == {"fp_mul"} and f"#define KFE_FP_N {n}" in header
    (tmp_path / "kfe_fmul_chain.cuh").write_text(header)
    (tmp_path / "h.cpp").write_text(_HARNESS.format(n=n, chain=kernels.CHAIN))
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(tmp_path), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp")], check=True, capture_output=True)
    _, a, b = _field_inputs(name, 8, 2)
    lanes = [" ".join(str(int(v)) for v in np.concatenate([a[:, l], b[:, l]])) for l in range(8)]
    res = subprocess.run([str(tmp_path / "h")], input="8\n" + "\n".join(lanes),
                         capture_output=True, text=True, check=True)
    got = np.array([[int(v) for v in ln.split()] for ln in res.stdout.splitlines()]).T
    want = kernels.fmul_chain_plain(port, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fmul_instruction_counts():
    """The 13-bit generator's count of fp_mul on each probe field (the "kfe"
    design of fmul_chain's bound): secp256k1's and P-256's as their curves'
    headers count them."""
    totals = {name: sum(kernels.op_counts(_fields(name)[0])["fp_mul"].values())
              for name in FIELDS}
    assert totals == {"secp256k1.fp": 692, "p256.fp": 776, "k256mxu.fp": 965}
    for curve in ("secp256k1", "p256"):
        assert kernels.op_counts(get_curve(curve))["fp_mul"] == \
            kernels.op_counts(get_curve(curve).field)["fp_mul"]


# -- B15: the int8 Montgomery chain ----------------------------------------------

@pytest.mark.parametrize("name", MONT)
def test_mxu_chain_plain_matches_the_tools_mxu_mul(name):
    """16 applications of the tool's make_mxu_mul (bench_mxu_mul.py:239-300)
    under jax.disable_jit(). Its step equals the in-kernel chain's step of
    bench_mxu_kernel_chain (:470-484 against :286-298: the same convolution,
    carries of 2n, n and 2n, and the same two int8-plane constant products),
    which needs B >= 1024 in interpret mode and is too slow for these tests."""
    port, ref = _fields(name)
    _, a, b = _field_inputs(name, 64, 3)
    mul = _tool("bench_mxu_mul").make_mxu_mul(ref)
    x, y = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    with jax.disable_jit():
        for _ in range(kernels.CHAIN):
            x = mul(x, y)
    want = np.asarray(x).astype(np.int64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(kernels.mxu_chain(port, ta, tb).numpy(), want)
    port_mul, z = bench_mxu_mul.make_mxu_mul(port), ta
    for _ in range(kernels.CHAIN):
        z = port_mul(z, tb)
    np.testing.assert_array_equal(z.numpy(), want)
    Mc, Pc = kernels.mont_matrices(port)
    assert np.array_equal(Pc, _tool("bench_mxu_mul")._toeplitz(port.p_limbs, 2 * port.n_limbs,
                                                               port.n_limbs))
    assert Mc.shape == (port.n_limbs, port.n_limbs) and not np.triu(Mc, 1).any()


def test_mxu_chain_refuses_a_solinas_field():
    port, _ = _fields("secp256k1.fp")
    x = torch.zeros((port.n_limbs, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.mxu_chain(port, x, x)


# -- the chains' lane code on the 32-bit layer, through g++ ----------------------

LAYER_FIELDS = ["secp256k1.fp", "p256.fp", "k256mxu.fp", "p384.fp"]
MXU_FIELDS = ["p256.fp", "k256mxu.fp", "p384.fp"]

_CHAIN_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "kfe_field.cuh"
#include "chain32.cuh"
using C = Field32;
using S = fe32::MxuShape<C::N>;
using namespace fe32;
typedef std::vector<uint32_t> V;
static V rd(size_t n) {
  V v(n);
  if (n && fread(v.data(), 4, n, stdin) != n) exit(4);
  return v;
}
static void wr(const V& v) { fwrite(v.data(), 4, v.size(), stdout); }
// harness <mode> <lanes>: uint32 arrays in on stdin, out on stdout; rows
// [NL, lanes] limb-major, words and sums lane-major
int main(int argc, char** argv) {
  if (argc < 3) return 2;
  const char* m = argv[1];
  const size_t n = (size_t)atoi(argv[2]), N = C::N, NL = C::NL;
  if (!strcmp(m, "shape")) {
    wr(V{(uint32_t)N, S::KB, S::M1, S::M2, S::SS});
  } else if (!strcmp(m, "fmul")) {  // fmul_chain's lane body: a, b -> out
    V a = rd(NL * n), b = rd(NL * n), out(NL * n);
    for (size_t l = 0; l < n; ++l) fmul_chain_lane<C>(a.data(), b.data(), out.data(), (int)n, (int)l);
    wr(out);
  } else if (!strcmp(m, "load")) {  // rows -> N words a lane
    V in = rd(NL * n), out(N * n);
    for (size_t l = 0; l < n; ++l) {
      const E<C> x = from_limbs<C>(&in[l], (uint32_t)n);
      for (size_t i = 0; i < N; ++i) out[l * N + i] = x.w[i];
    }
    wr(out);
  } else if (!strcmp(m, "store")) {  // N words a lane -> rows
    V in = rd(N * n), out(NL * n);
    for (size_t l = 0; l < n; ++l) {
      E<C> x;
      for (size_t i = 0; i < N; ++i) x.w[i] = in[l * N + i];
      to_limbs<C>(x, &out[l], (uint32_t)n);
    }
    wr(out);
  } else if (!strcmp(m, "put")) {  // N words a lane -> the operand's bytes
    V in = rd(N * n), out(n * S::KB / 4);
    std::vector<uint8_t> op(n * S::KB, 0xAB);
    for (size_t l = 0; l < n; ++l) mxu_put<C::N>(op.data(), (uint32_t)l, &in[l * N]);
    memcpy(out.data(), op.data(), op.size());
    wr(out);
  } else if (!strcmp(m, "fold_m")) {  // 4N sums a lane -> m
    V s = rd(4 * N * n), out(N * n);
    for (size_t l = 0; l < n; ++l) {
      uint32_t w[C::N];
      mxu_fold_m<C::N>(&s[l * 4 * N], w);
      for (size_t i = 0; i < N; ++i) out[l * N + i] = w[i];
    }
    wr(out);
  } else if (!strcmp(m, "fold_u")) {  // 8N sums, T's high half, nz -> (T + m p) / R32
    V s = rd(8 * N * n), th = rd(N * n), nz = rd(n), out(N * n);
    for (size_t l = 0; l < n; ++l) {
      uint32_t h[C::N];
      for (size_t i = 0; i < N; ++i) h[i] = th[l * N + i];
      const E<C> u = mxu_fold_u<C>(&s[l * 8 * N], h, nz[l]);
      for (size_t i = 0; i < N; ++i) out[l * N + i] = u.w[i];
    }
    wr(out);
  } else {
    return 3;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def chain_harness(tmp_path_factory):
    """name -> run(mode, lanes, arrays=[...]) on the chain harness of that
    probe field: chain32.cuh and fe32.cuh against the field's generated
    header, built with g++ -O0, the four fields' builds started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    procs = {}
    for name in LAYER_FIELDS:
        d = tmp_path_factory.mktemp(name.replace(".", "_"))
        (d / "kfe_field.cuh").write_text(kernels._header("fmul_chain", _fields(name)[0]))
        (d / "h.cpp").write_text(_CHAIN_HARNESS)
        exe = d / "h"
        procs[name] = (exe, subprocess.Popen(
            [gxx, "-O0", "-std=c++17", "-I", str(d), "-I", kernels.CSRC, "-o", str(exe),
             str(d / "h.cpp")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    runs = {}
    for name, (exe, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out.decode()
        runs[name] = runner(exe)
    return runs


def _edge_values(p, rng, count):
    """0, 1, p - 1, then random values below p."""
    return [0, 1, p - 1] + [int.from_bytes(rng.bytes(64), "big") % p for _ in range(count - 3)]


def _field_rows(spec, vals):
    """Canonical 13-bit limbs [n, lanes] uint32 of the field's encoding."""
    return F.fe_from_ints(spec, vals, "cpu").limbs.numpy().astype(np.uint32)


def _row_ints(spec, rows):
    return [int(v) for v in _limb_ints(rows, spec.limb_bits)]


@pytest.mark.parametrize("name", FIELDS)
def test_fmul_chain_lane_matches_plain(chain_harness, name):
    """fmul_chain's lane body (chain32.cuh on the layer's `mul`), 16
    multiplies from the loaded rows to the stored ones, equals the twin
    mod p with canonical limbs, on 0, 1, p - 1 and random lanes."""
    spec, _ = _fields(name)
    rng = np.random.default_rng(21)
    vals = _edge_values(spec.p, rng, 12)
    a, b = _field_rows(spec, vals), _field_rows(spec, vals[::-1])
    got = chain_harness[name]("fmul", len(vals), arrays=[a, b]).reshape(a.shape)
    want = kernels.fmul_chain_plain(spec, torch.from_numpy(a.astype(np.int64)),
                                    torch.from_numpy(b.astype(np.int64))).numpy()
    assert int(got.max()) <= spec.mask
    gi, wi = _row_ints(spec, got), _row_ints(spec, want)
    assert all(g < spec.p for g in gi)
    assert gi == [w % spec.p for w in wi]


def test_mxu_shapes_follow_the_header(chain_harness):
    """kernels.mxu_shape (the tiles the wrapper builds) is the header's
    MxuShape (what the kernel indexes) on every probe field."""
    for name in LAYER_FIELDS:
        spec, _ = _fields(name)
        sh = kernels.mxu_shape(spec)
        got = chain_harness[name]("shape", 0, arrays=[]).tolist()
        assert got == [sh[k] for k in ("N", "KB", "M1", "M2", "SS")], name
        assert sh["SS"] >= 8 * sh["N"] and sh["SS"] % 16 == 4


def _sums(mat, words, rows):
    """The column sums of the byte matrix mat [M, KB] times each lane's
    digits (its words' bytes, zero-padded to KB), as the tensor cores give
    them: uint32 [lanes, rows]."""
    KB = mat.shape[1]
    dig = np.zeros((len(words), KB), np.int64)
    raw = np.ascontiguousarray(words, np.uint32).view(np.uint8).reshape(len(words), -1)
    dig[:, :raw.shape[1]] = raw
    sums = mat.astype(np.int64) @ dig.T
    assert sums.max() < 1 << 22
    return np.ascontiguousarray(sums[:rows].T, np.uint32)


def _step(run, spec, x, y):
    """One mxu_chain step on the lanes' words x, y [lanes, N] (uint32):
    T = x y by Python integers, the two products' column sums by numpy from
    the byte matrices the kernel loads, the folds by the harness. Returns
    (m [lanes, N], the step's result [lanes, N])."""
    N = kfe.fe32_words(spec)
    A1, A2 = kernels.mont_byte_matrices(spec)
    xi, yi = _from_words(x), _from_words(y)
    T = [u * v for u, v in zip(xi, yi)]
    lo = _to_words([t % (1 << (32 * N)) for t in T], N)
    hi = _to_words([t >> (32 * N) for t in T], N)
    nz = np.array([t % (1 << (32 * N)) != 0 for t in T], np.uint32)
    lanes = len(T)
    m = run("fold_m", lanes, arrays=[_sums(A1, lo, 4 * N)]).reshape(lanes, N)
    u = run("fold_u", lanes, arrays=[_sums(A2, m, 8 * N), hi, nz]).reshape(lanes, N)
    return m, u


@pytest.mark.parametrize("name", MXU_FIELDS)
def test_mxu_step_matches_ints(chain_harness, name):
    """One step on the CUDA cores' code, fed the byte products' column sums:
    m = (T mod R32) N' mod R32 and the canonical x y R32^-1 mod p, on every
    pair of 0, 1, p - 1 and on random lanes."""
    spec, _ = _fields(name)
    p, N = spec.p, kfe.fe32_words(spec)
    R = 1 << (32 * N)
    rng = np.random.default_rng(22)
    edges = [0, 1, p - 1]
    xs = [u for u in edges for _ in edges] + _edge_values(p, rng, 19)[3:]
    ys = [v for _ in edges for v in edges] + _edge_values(p, rng, 19)[3:]
    m, u = _step(chain_harness[name], spec, _to_words(xs, N), _to_words(ys, N))
    nprime = -pow(p, -1, R) % R
    assert _from_words(m) == [(x * y % R) * nprime % R for x, y in zip(xs, ys)]
    assert _from_words(u) == [x * y * pow(R, -1, p) % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", MXU_FIELDS)
def test_mxu_chain_steps_match_plain(chain_harness, name):
    """Sixteen steps from the loaded rows (R13 -> R32) to the stored ones
    (back to R13) equal mxu_chain_plain mod p, with canonical limbs, on 0,
    1, p - 1 and random lanes."""
    spec, _ = _fields(name)
    run = chain_harness[name]
    rng = np.random.default_rng(23)
    vals = _edge_values(spec.p, rng, 8)
    a, b = _field_rows(spec, vals), _field_rows(spec, vals[::-1])
    lanes = len(vals)
    N = kfe.fe32_words(spec)
    x = run("load", lanes, arrays=[a]).reshape(lanes, N)
    y = run("load", lanes, arrays=[b]).reshape(lanes, N)
    for _ in range(kernels.CHAIN):
        x = _step(run, spec, x, y)[1]
    got = run("store", lanes, arrays=[x]).reshape(a.shape)
    want = kernels.mxu_chain_plain(spec, torch.from_numpy(a.astype(np.int64)),
                                   torch.from_numpy(b.astype(np.int64))).numpy()
    gi = _row_ints(spec, got)
    assert int(got.max()) <= spec.mask and all(g < spec.p for g in gi)
    assert gi == [w % spec.p for w in _row_ints(spec, want)]


@pytest.mark.parametrize("name", MXU_FIELDS)
def test_mxu_byte_matrices_match_mont_matrices(chain_harness, name):
    """The byte matrices hold the same p and the same N' as mont_matrices'
    13-bit ones (N' = -p^-1 mod 2^(32N) against mod 2^(13n): equal mod the
    smaller), banded Toeplitz and zero-padded; their tiles are the layout
    in which the kernel's threads put the lanes' digits (the harness's
    mxu_put, chain32.cuh)."""
    spec, _ = _fields(name)
    sh = kernels.mxu_shape(spec)
    N, KB = sh["N"], sh["KB"]
    A1, A2 = kernels.mont_byte_matrices(spec)
    Mc, Pc = kernels.mont_matrices(spec)
    assert A1.shape == (sh["M1"], KB) and A2.shape == (sh["M2"], KB)

    def col0(mat, rows, bits):
        return sum(int(v) << (bits * k) for k, v in enumerate(mat[:rows, 0]))

    n, b = spec.n_limbs, spec.limb_bits
    n32, n13 = col0(A1, 4 * N, 8), col0(Mc, n, b)
    assert col0(A2, 4 * N, 8) == col0(Pc, n, b) == spec.p
    assert n32 * spec.p % (1 << (32 * N)) == (1 << (32 * N)) - 1
    low = min(32 * N, b * n)
    assert n32 % (1 << low) == n13 % (1 << low)
    for mat, rows in ((A1, 4 * N), (A2, 8 * N)):
        for j in range(4 * N):      # column j is column 0 moved down j rows
            want = np.zeros(mat.shape[0], np.uint8)
            want[j:rows] = mat[:rows - j, 0]
            np.testing.assert_array_equal(mat[:, j], want)
        assert not mat[:, 4 * N:].any() and not mat[rows:].any()
    assert not np.triu(A1[:4 * N, :4 * N], 1).any()
    tiles = kernels.mxu_tiles(spec)
    assert np.array_equal(tiles, np.concatenate([kernels.core_tiles(A1),
                                                 kernels.core_tiles(A2)]))
    rng = np.random.default_rng(24)
    words = rng.integers(0, 1 << 32, (16, N), dtype=np.uint64).astype(np.uint32)
    put = chain_harness[name]("put", 16, arrays=[words]).view(np.uint8)
    dig = np.zeros((16, KB), np.uint8)
    dig[:, :4 * N] = words.view(np.uint8).reshape(16, 4 * N)
    np.testing.assert_array_equal(put, kernels.core_tiles(dig))


@pytest.mark.parametrize("name", MXU_FIELDS)
def test_mxu_bound_counts_the_function(name):
    """mxu_chain's bound counts what its function needs: the int8 part is
    the byte multiply-adds of the two products' Toeplitz bands, not the
    zero rows and columns that pad them to tiles; its "cios" design is
    fmul_chain's count on the same field, so the row's bound (the least of
    its designs) is never above the layer's own multiply's; and the split
    step counts no shared-memory traffic, only T = x y, the folds and the
    subtraction."""
    spec, _ = _fields(name)
    N = kernels.mxu_shape(spec)["N"]
    A1, A2 = kernels.mont_byte_matrices(spec)
    band = 0
    for mat, rows in ((A1, 4 * N), (A2, 8 * N)):
        k, j = np.indices(mat.shape)
        inside = (k - j >= 0) & (k - j < 4 * N) & (j < 4 * N) & (k < rows)
        assert not mat[~inside].any()
        band += int(inside.sum())
    B = 64
    ops = kernels.work("mxu_chain", spec, B, design="fe32")[0]
    assert ops["int8"] == 2 * kernels.CHAIN * B * band
    assert kernels.designs("mxu_chain", spec) == ("kfe", "fe32", "cios")
    assert (kernels.work("mxu_chain", spec, B, design="cios")
            == kernels.work("fmul_chain", spec, B, design="fe32"))
    step, macs = kernels.mxu_step_counts(kernels.mxu_shape(spec))
    assert macs == band and step["wide"] == N * N
    assert step["wide"] + step["imad"] + step["alu"] + step["other"] == (
        N * N + (N - 1) ** 2 + 2 * N + 1 + 24 * N + 3 * N + 2)


# -- B16: the ladder variants ---------------------------------------------------

B16, NW16 = 128, 2


@functools.lru_cache(maxsize=None)
def _ladder_inputs():
    """8 bases k*G tiled over B16 lanes, random digits mag [NW16, 2, B16] in
    [0, 8] and signs; the port's steady limbs and numpy copies."""
    curve = get_curve("secp256k1")
    rng = np.random.default_rng(11)
    ks = [int(k) for k in rng.integers(1, 2**31, 8)]
    pts = [ec_host.aff_mul(curve, k, ec_host.aff_generator(curve)) for k in ks] * (B16 // 8)
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], "cpu")
    bases = P.point_limbs(P.steady(Q))
    mag = rng.integers(0, 9, (NW16, 2, B16))
    neg = rng.integers(0, 2, (NW16, 2, B16)).astype(bool)
    return bases, mag, neg, pts


def _rows(arr2d):
    return [jnp.asarray(r, jnp.uint32) for r in np.asarray(arr2d)]


@functools.lru_cache(maxsize=None)
def _tool_ladder(kind: str):
    """The profile_ladder.py body (:75-151) on tpu_ecc's kernel engine,
    eagerly: from the identity, per window 4 doublings, then for h = 0, 1
    an add of entry 1 ("entry1": bare, unroll, build), of the entry
    selected by mag from the 7-add table ("select") or of that entry with y
    negated where neg is set ("negate")."""
    curve = jax_curve("secp256k1")
    f = curve.field
    n = f.n_limbs
    kadd, kdouble = PK._KADD[curve.strategy], PK._KDOUBLE[curve.strategy]
    bases, mag, neg, _ = _ladder_inputs()
    base = [JK.kfe_from_rows(f, _rows(bases[c].numpy())) for c in range(3)]
    ident = PK._ident_rows(f, (B16,))

    def flat(fes):
        return [r for fe in fes for r in fe.limbs]

    def unflat(rows):
        return [JK.kfe_from_rows(f, rows[c * n:(c + 1) * n]) for c in range(3)]

    tbl = [flat(unflat([r for c in ident for r in c])), flat(base)]
    if kind != "entry1":
        for _ in range(2, kernels.TBL):
            tbl.append(flat([JK.ksteady(v) for v in kadd(curve, *unflat(tbl[-1]), *base)]))
    acc = [r for c in ident for r in c]
    for w in range(NW16):
        for _ in range(4):
            acc = flat([JK.ksteady(v) for v in kdouble(curve, *unflat(acc))])
        for h in range(2):
            if kind == "entry1":
                sel = tbl[1]
            else:
                m = jnp.asarray(mag[w, h].astype(np.uint32))
                sel = [r for c in ident for r in c]
                for k in range(kernels.TBL):
                    sel = [jnp.where(m == k, t, s) for t, s in zip(tbl[k], sel)]
            X, Y, Z = unflat(sel)
            if kind == "negate":
                Yn = JK.ksteady(JK.kneg(Y))
                Y = JK.kfe_from_rows(f, [jnp.where(jnp.asarray(neg[w, h]), a, b)
                                         for a, b in zip(Yn.limbs, Y.limbs)])
            acc = flat([JK.ksteady(v) for v in kadd(curve, *unflat(acc), X, Y, Z)])
    return np.stack([np.asarray(r) for r in acc]).astype(np.int64)


@pytest.mark.parametrize("variant", kernels.PROBE_VARIANTS)
def test_ladder_probe_plain_matches_the_tool_body(variant):
    curve = get_curve("secp256k1")
    n = curve.field.n_limbs
    bases, mag, neg, pts = _ladder_inputs()
    kind = {"select": "select", "negate": "negate"}.get(variant, "entry1")
    got = kernels.ladder_probe(curve, bases, torch.from_numpy(mag), torch.from_numpy(neg),
                               variant)
    np.testing.assert_array_equal(got.reshape(3 * n, B16).numpy(), _tool_ladder(kind))
    # the host oracle: sum_w 16^(nw-1-w) (d_w0 + d_w1) times each lane's base
    digits = np.ones_like(mag) if kind == "entry1" else np.where(
        neg & (kind == "negate"), -mag, mag)
    x, y, inf = P.to_affine(P.point_from_limbs(curve, got))
    xs, ys = F.fe_to_ints(x), F.fe_to_ints(y)
    for lane in range(0, B16, 13):
        k = sum(16 ** (NW16 - 1 - w) * int(digits[w, :, lane].sum()) for w in range(NW16))
        want = ec_host.aff_mul(curve, k % curve.n, pts[lane])
        assert (None if bool(inf[lane]) else (xs[lane], ys[lane])) == want, (variant, lane)


def test_ladder_probe_refuses_an_unknown_variant():
    bases, mag, neg, _ = _ladder_inputs()
    with pytest.raises(ValueError):
        kernels.ladder_probe(get_curve("secp256k1"), bases, torch.from_numpy(mag),
                             torch.from_numpy(neg), "fold")


def test_gather_tool_runs_on_the_cpu():
    """The gather probe's main at a small size on the CPU: both probes run
    (the kernel's twin), and the result names every width, depth and chunk."""
    out = bench_gather_probe.main(["1024", "--device", "cpu"])
    assert set(out["take"]) == {32, 40, 64, 128} and set(out["dma_gather"]) == {2, 8, 16}
    assert set(out["dma_gather_cb"]) == {1024, 256}
    assert all(r > 0 for part in out.values() for r in part.values())
