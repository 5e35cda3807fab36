"""tpu_ecc_torch's field layer against tpu_ecc's, limb for limb.

The same uint32 limb arrays, made from a seed with numpy, go through
tpu_ecc.ops.fe (one jitted program per field) and tpu_ecc_torch.ops.fe on
the CPU. Tolerance: exact — equal limbs and equal bound ledgers.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ecc.curves import specs as JS
from tpu_ecc.ops import fe as JF
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves import specs as TS
from tpu_ecc_torch.ops import fe as TF

FIELDS = [("secp256k1", "field"), ("secp256k1", "scalar"), ("p256", "field"),
          ("p521", "field")]           # 41 limbs: 81 product columns
B = 8


@pytest.mark.parametrize("name", sorted(JS.list_curves()))
def test_specs_equal_reference(name):
    jc, tc = JS.get_curve(name), TS.get_curve(name)
    for fld in ("field", "scalar"):
        js, ts = getattr(jc, fld), getattr(tc, fld)
        for f in dataclasses.fields(js):
            assert getattr(ts, f.name) == getattr(js, f.name), (name, fld, f.name)
        assert ts.W == js.W
    for f in dataclasses.fields(jc):
        if f.name not in ("field", "scalar"):
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)


def _values(spec, seed):
    """B canonical values: edge cases first, then random ones."""
    rng = np.random.default_rng(seed)
    p = spec.p
    vals = [0, 1, p - 1, p - 2, (1 << (spec.bits - 1)) % p]
    while len(vals) < B:
        vals.append(int.from_bytes(rng.bytes((spec.bits + 7) // 8), "big") % p)
    return vals


@functools.lru_cache(maxsize=None)
def _results(curve_name, which):
    """Both packages' outputs and bound ledgers on the same inputs."""
    jspec = getattr(JS.get_curve(curve_name), which)
    tspec = getattr(TS.get_curve(curve_name), which)
    xs, ys = _values(jspec, 1), _values(jspec, 2)[::-1]
    xl = np.asarray(JF.fe_from_ints(jspec, xs).limbs)
    yl = np.asarray(JF.fe_from_ints(jspec, ys).limbs)
    words = JF.words_from_ints(xs, jspec.bits)
    nw = words.shape[0]
    k256 = curve_name == "secp256k1"

    def ops(F, spec, x, y, w):
        s = F.fadd(x, y)
        d = F.fsub(x, y)
        out = {
            "fmul": F.fmul(x, y), "fsquare": F.fsquare(x), "fadd": s, "fsub": d,
            "fneg": F.fneg(x), "fcanonical": F.fcanonical(s),
            "fmul_lazy": F.fmul(s, d), "fsquare_lazy": F.fsquare(d),
            "fe_from_words": F.fe_from_words(spec, w, spec.bits),
        }
        if k256:
            out["finv"] = F.finv(x)
        return out

    ledger = {}

    @jax.jit
    def run(x, y, w):
        out = ops(JF, jspec, JF.FE(x, jspec, jspec.mask, jspec.p - 1),
                  JF.FE(y, jspec, jspec.mask, jspec.p - 1), w)
        ledger.update({k: (v.bound, v.vmax) for k, v in out.items()})
        limbs = {k: v.limbs for k, v in out.items()}
        limbs["relimb"] = JF.relimb(x, jspec.limb_bits, 32, nw)
        limbs["fe_to_words"] = JF.fe_to_words(JF.FE(x, jspec, jspec.mask, jspec.p - 1))
        return limbs

    ref = {k: np.asarray(v) for k, v in run(jnp.asarray(xl), jnp.asarray(yl),
                                                jnp.asarray(words)).items()}
    x_t = interop.from_reference_limbs(xl, "cpu")
    y_t = interop.from_reference_limbs(yl, "cpu")
    w_t = interop.from_reference_limbs(words, "cpu")
    out = ops(TF, tspec, TF.FE(x_t, tspec, tspec.mask, tspec.p - 1),
              TF.FE(y_t, tspec, tspec.mask, tspec.p - 1), w_t)
    got = {k: interop.to_reference_limbs(v.limbs) for k, v in out.items()}
    got["relimb"] = interop.to_reference_limbs(TF.relimb(x_t, tspec.limb_bits, 32, nw))
    got["fe_to_words"] = interop.to_reference_limbs(
        TF.fe_to_words(TF.FE(x_t, tspec, tspec.mask, tspec.p - 1)))
    tledger = {k: (v.bound, v.vmax) for k, v in out.items()}
    return ref, got, ledger, tledger, xs, ys, words


OPS = ["fmul", "fsquare", "fadd", "fsub", "fneg", "fcanonical", "fmul_lazy",
       "fsquare_lazy", "fe_from_words", "relimb", "fe_to_words"]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f"{f[0]}.{f[1]}")
@pytest.mark.parametrize("op", OPS)
def test_op_limb_equal(field, op):
    ref, got, ledger, tledger, *_ = _results(*field)
    np.testing.assert_array_equal(got[op], ref[op])
    if op in ledger:
        assert tledger[op] == ledger[op]


@pytest.mark.parametrize("field", FIELDS[:2], ids=lambda f: f"{f[0]}.{f[1]}")
def test_finv_limb_equal(field):
    ref, got, ledger, tledger, xs, *_ = _results(*field)
    np.testing.assert_array_equal(got["finv"], ref["finv"])
    spec = getattr(TS.get_curve(field[0]), field[1])
    inv = TF.fe_to_ints(TF.FE(interop.from_reference_limbs(got["finv"], "cpu"),
                              spec, *tledger["finv"]))
    assert inv == [pow(v, -1, spec.p) if v else 0 for v in xs]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f"{f[0]}.{f[1]}")
def test_word_codecs_equal(field):
    *_, xs, ys, words = _results(*field)
    spec = getattr(TS.get_curve(field[0]), field[1])
    np.testing.assert_array_equal(TF.words_from_ints(xs, spec.bits), words)
    assert TF.ints_from_words(words) == JF.ints_from_words(words) == xs


@pytest.mark.parametrize("name", ["secp256k1", "p256", "bign256"])
def test_field_dbl_vectors(name):
    """The reference's field doubling-chain vectors, through the port."""
    path = os.path.join(os.path.dirname(__file__), "vectors", f"field_dbl_{name}.json")
    vals = [int(h, 16) for h in json.load(open(path))]
    spec = TS.get_curve(name).field
    x = TF.fe_from_ints(spec, vals[:-1], "cpu")
    assert TF.fe_to_ints(TF.fcanonical(x + x)) == vals[1:]


@pytest.mark.parametrize("bound", [8192, 8191 + 5000, 1 << 20, (1 << 31) - 1])
def test_carry_scan_equals_sequential_chain(bound):
    """The carry in whole-tensor steps (passes, then a carry-lookahead) gives
    the sequential chain's limbs and carry-out, long 0/1 ripples included."""
    b, mask = 13, 8191
    rng = np.random.default_rng(bound)
    x = rng.integers(0, bound + 1, (39, 64), dtype=np.int64)
    x[rng.random(x.shape) < 0.7] = mask          # runs of mask limbs ripple
    x[0, ::2] = bound
    out, carry = TF._carry_scan(torch.from_numpy(x), bound, b, mask)
    want, c = [], np.zeros(x.shape[1], np.int64)
    for row in x:
        t = row + c
        want.append(t & mask)
        c = t >> b
    np.testing.assert_array_equal(out.numpy(), np.stack(want))
    np.testing.assert_array_equal(carry.numpy(), c)


def _ripple_cummax(x, mask):
    """The ripple by its definition, an independent reference: a limb takes
    a carry exactly when the nearest limb below it that is not equal to mask
    exceeds mask. x [n, B] <= mask + 1 -> (limbs <= mask, carry-out)."""
    idx = torch.arange(x.shape[0])[:, None]
    last = torch.where(x != mask, idx, -1).cummax(0).values
    gen = (x > mask).gather(0, last.clamp(min=0)) & (last >= 0)   # carry out of limb i
    out = x.clone()
    out[1:] += gen[:-1]
    return out & mask, gen[-1].to(x.dtype)


@pytest.mark.parametrize("n", [20, 39, 62, 63, 82, 130])
def test_ripple_cummax_equals_ripple_bits(n):
    """The carry-lookahead (integer additions of bit masks, 62 limbs at a
    time) resolves the ripple as its cummax definition does, long runs of
    mask limbs across the chunk boundaries and the carry out of the top
    included; P-521's product has 81 rows."""
    mask = 8191
    rng = np.random.default_rng(n)
    x = rng.integers(0, mask + 2, (n, 256), dtype=np.int64)
    x[rng.random(x.shape) < 0.8] = mask
    x[:, :4] = mask
    x[0, :2] = mask + 1
    x[-1, 2] = mask + 1
    x[:, 5] = mask
    x[min(61, n - 1), 5] = mask + 1              # a carry from the top of a chunk
    carry = torch.full((x.shape[1],), 7, dtype=torch.int64)
    want, want_c = _ripple_cummax(torch.from_numpy(x), mask)
    got, got_c = TF._ripple(torch.from_numpy(x.copy()), carry, mask)
    assert torch.equal(got, want) and torch.equal(got_c, carry + want_c)
    assert int(got_c[0]) == 8 and int(got_c[3]) == 7
    assert int(got[min(62, n - 1), 5]) == 0


def test_diagonals_skew_equals_index_add():
    """The convolution's anti-diagonal sums (index_add_) equal the skew
    trick's, an independent reference: pad each row of [n, m, *b] to m + n,
    flatten, drop the last n entries and re-view as [n, m + n - 1]."""
    rng = np.random.default_rng(5)
    for n, m in ((20, 20), (13, 20), (41, 41)):
        x = torch.from_numpy(rng.integers(0, 1 << 13, (n, 3, 64), dtype=np.int64))
        y = torch.from_numpy(rng.integers(0, 1 << 13, (m, 3, 64), dtype=np.int64))
        prod = x[:, None] * y[None, :]
        skew = torch.cat([prod, prod.new_zeros((n, n, 3, 64))], 1)
        skew = skew.reshape((n * (m + n), 3, 64))[: n * (m + n - 1)]
        want = skew.reshape((n, m + n - 1, 3, 64)).sum(0)
        assert torch.equal(TF._conv_arr(x, y), want)
