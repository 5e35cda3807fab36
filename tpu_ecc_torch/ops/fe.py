"""Batched prime-field arithmetic in 13/12-bit limbs on int64 torch tensors.

The limb plan is tpu_ecc's, unchanged (tpu_ecc/ops/fe.py): the same
`FieldSpec`, the same Montgomery R and the same static bound/vmax ledger that
decides at trace time where carry passes go. The ledger proves every limb and
every convolution column stays below 2^32, so int64 limbs give exactly the
uint32 results of the hand-written kernels (csrc/) with no wraparound; the two
spots that rely on uint32 wrap (`(col * n0) & mask` in the Montgomery step and
`relimb`'s left shifts) are masked right after, so the low bits agree.

- A batch of field elements is `int64[n_limbs, *batch]` (limb-major; batch on
  the last axis), the same layout as tpu_ecc's uint32 arrays.
- `FE` carries the static bounds `bound` (max limb) and `vmax` (max integer);
  ops insert carries exactly where tpu_ecc's do, so results are limb-equal.
- Two reduction backends: 'solinas' (p = 2^t - c, fold the high limbs) and
  'mont' (word-by-word Montgomery with one headroom limb).
- The schoolbook convolution is one batched outer product summed along its
  anti-diagonals; only the carry chains are Python loops over limbs.

Big fixed exponents (Fermat inversion) go through the `pow` kernel wrapper in
ops/kernels.py, which launches the CUDA kernel on a CUDA tensor and runs its
plain twin on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils.bigint import int_to_limbs, ints_to_limbs_np, limbs_to_int

LIMB = torch.int64
_MAX32 = (1 << 32) - 1


def _inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class FieldSpec:
    """All static data for one prime field. Built via make_field_spec()."""

    name: str
    p: int
    kind: str                 # 'solinas' | 'mont'
    limb_bits: int
    n_limbs: int
    # derived
    bits: int = 0
    mask: int = 0
    mul_in_bound: int = 0     # max limb bound admissible as multiply input
    sq_in_bound: int = 0      # max limb bound admissible as (symmetric) square input
    sq_symmetric: bool = False
    carry_in_vmax: int = 0    # max vmax admissible at carry() entry
    carried_vmax: int = 0     # steady-state vmax for carried values (loop invariant)
    # solinas
    fold1: tuple = ()         # limbs of 2^(b*n) mod p (the fold constant)
    fold1_val: int = 0
    # montgomery
    r: int = 1                # R (1 for solinas)
    r2: int = 0               # R^2 mod p
    n0: int = 0               # -p^-1 mod 2^b
    p_limbs: tuple = ()

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"FieldSpec({self.name}, {self.kind}, {self.n_limbs}x{self.limb_bits})"

    @property
    def W(self) -> int:
        """Representation modulus 2^(b*n)."""
        return 1 << (self.limb_bits * self.n_limbs)

    # ---- host-side domain codecs ----
    def encode_int(self, x: int) -> int:
        """Math value -> internal-domain value (Montgomery form for 'mont')."""
        x %= self.p
        return (x * self.r) % self.p if self.kind == "mont" else x

    def decode_int(self, x: int) -> int:
        x %= self.p
        return (x * _inv_mod(self.r, self.p)) % self.p if self.kind == "mont" else x


def make_field_spec(name: str, p: int, kind: Optional[str] = None) -> FieldSpec:
    bits = p.bit_length()
    c = (1 << bits) - p
    if kind is None:
        kind = "solinas" if c.bit_length() <= 40 else "mont"

    if kind == "solinas":
        b = 13
        n = -(-bits // b)                       # weak form: values < 2^(b*n)
        fold1_val = (1 << (b * n)) % p
        nf = -(-fold1_val.bit_length() // b)
        fold1 = int_to_limbs(fold1_val, nf, b)
        if max(fold1) > (1 << b):
            raise ValueError(f"{name}: fold digits too large for solinas backend")
        mask = (1 << b) - 1
        mul_in = int((_MAX32 / n) ** 0.5)
        sq_in = int((_MAX32 / (2 * n)) ** 0.5)
        sq_symmetric = sq_in >= mask + 8
        if not sq_symmetric:
            sq_in = mul_in
        if mul_in < mask + 8:
            raise ValueError(f"{name}: solinas limb plan infeasible (n={n})")
        W = 1 << (b * n)
        return FieldSpec(
            name=name, p=p, kind=kind, limb_bits=b, n_limbs=n, bits=bits, mask=mask,
            mul_in_bound=mul_in, sq_in_bound=sq_in, sq_symmetric=sq_symmetric,
            carry_in_vmax=W << 17, carried_vmax=W - 1,
            fold1=fold1, fold1_val=fold1_val,
            p_limbs=int_to_limbs(p, n, b),
        )

    # --- montgomery ---
    b = 13 if (-(-bits // 13) + 1) <= 31 else 12
    n = -(-bits // b) + 1                       # headroom limb: R >= 2^b * p
    mask = (1 << b) - 1
    R = 1 << (b * n)
    assert R >= (1 << b) * p
    # overflow budget: n*B^2 (conv) + n*2^2b (m*p additions) + carries < 2^32
    slack = _MAX32 - n * (1 << (2 * b)) - (1 << 21)
    mul_in = int((slack / n) ** 0.5)
    sq_in = int((slack / (2 * n)) ** 0.5)
    sq_symmetric = sq_in >= mask + 8
    if not sq_symmetric:
        sq_in = mul_in
    if mul_in < mask + 8:
        raise ValueError(f"{name}: mont limb plan infeasible (n={n}, b={b})")
    return FieldSpec(
        name=name, p=p, kind=kind, limb_bits=b, n_limbs=n, bits=bits, mask=mask,
        mul_in_bound=mul_in, sq_in_bound=sq_in, sq_symmetric=sq_symmetric,
        carry_in_vmax=R, carried_vmax=4 * p,
        r=R % p, r2=(R * R) % p, n0=(-_inv_mod(p, 1 << b)) % (1 << b),
        p_limbs=int_to_limbs(p, n, b),
    )


@functools.lru_cache(maxsize=None)
def _sub_bias(spec: FieldSpec, y_bound: int, y_vmax_bits: int):
    """Limbs of c*p with per-limb values >= any possible limb of y.

    K[j] = need[j] + digit_j(c*p - N) where N = sum need[j] 2^(b j); c minimal.
    Guarantees x + K - y never underflows limbwise. Returns (limbs, value, max).
    Shared by the tensor engine here and the kernel engine (ops/kfe.py), so
    the two cannot drift apart.
    """
    b, n, p = spec.limb_bits, spec.n_limbs, spec.p
    y_vmax = (1 << y_vmax_bits) - 1
    need = [min(y_bound, y_vmax >> (b * j)) for j in range(n)]
    N = sum(nd << (b * j) for j, nd in enumerate(need))
    c = max(1, -(-N // p))
    while (c * p - N) >> (b * n):
        c += 1  # keep the excess-digit decomposition inside n limbs
    D = c * p - N
    dd = int_to_limbs(D, n, b)
    K = tuple(nd + d for nd, d in zip(need, dd))
    return K, c * p, max(K)


# ---------------------------------------------------------------------------
# FE: a batch of field elements with static bounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FE:
    limbs: torch.Tensor       # int64[n_limbs, *batch], each limb in [0, 2^32)
    spec: FieldSpec           # static
    bound: int                # static: max possible limb value
    vmax: int                 # static: max possible integer value

    # -- operators make RCB formula code read like the paper --
    def __add__(self, other):
        return fadd(self, other)

    def __sub__(self, other):
        return fsub(self, other)

    def __mul__(self, other):
        if isinstance(other, FE):
            return fmul(self, other)
        return fmul_small(self, int(other))

    __rmul__ = __mul__

    def __neg__(self):
        return fneg(self)

    def square(self):
        return fsquare(self)

    def carry(self):
        return fcarry(self)

    def invert(self):
        return finv(self)

    @property
    def batch_shape(self):
        return tuple(self.limbs.shape[1:])

    @property
    def device(self):
        return self.limbs.device


@functools.lru_cache(maxsize=None)
def _const_vec(limbs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=LIMB, device=device)


def _const_arr(limbs, ndim: int, device) -> torch.Tensor:
    """Host limb constants as [len, 1, ...] broadcasting against [len, *batch]."""
    vec = _const_vec(tuple(int(v) for v in limbs), torch.device(device))
    return vec.reshape((len(limbs),) + (1,) * (ndim - 1))


def fe_zeros(spec: FieldSpec, batch_shape=(), device=None) -> FE:
    return FE(torch.zeros((spec.n_limbs, *batch_shape), dtype=LIMB,
                          device=resolve_device(device)), spec, 0, 0)


def fe_from_int(spec: FieldSpec, value: int, batch_shape=(), device=None) -> FE:
    """Constant element (host int, math domain) broadcast over a batch."""
    v = spec.encode_int(value)
    arr = _const_arr(int_to_limbs(v, spec.n_limbs, spec.limb_bits),
                     1 + len(batch_shape), resolve_device(device))
    return FE(arr.expand((spec.n_limbs, *batch_shape)), spec, spec.mask, max(v, 1))


def fe_from_ints(spec: FieldSpec, values, device=None, batch_shape=None) -> FE:
    """Host batch of math-domain ints -> FE on `device` (canonical, carried)."""
    vs = [spec.encode_int(v) for v in values]
    arr = ints_to_limbs_np(vs, spec.n_limbs, spec.limb_bits).astype(np.int64)
    if batch_shape is not None:
        arr = arr.reshape((spec.n_limbs, *batch_shape))
    return FE(torch.from_numpy(arr).to(resolve_device(device)), spec, spec.mask,
              spec.p - 1 if vs else 0)


def fe_to_ints(x: FE) -> list[int]:
    """FE -> host list of canonical math-domain ints."""
    if not (x.bound <= x.spec.mask and x.vmax < x.spec.p):
        x = fcanonical(x)
    flat = x.limbs.reshape(x.spec.n_limbs, -1).cpu().numpy()
    return [
        x.spec.decode_int(limbs_to_int(flat[:, k], x.spec.limb_bits))
        for k in range(flat.shape[1])
    ]


def fe_steady(spec: FieldSpec, limbs: torch.Tensor) -> FE:
    """Wrap raw limbs known to be carried steady-state (for loop-carried state)."""
    return FE(limbs, spec, spec.mask, spec.carried_vmax)


# ---------------------------------------------------------------------------
# carry passes and reduction
# ---------------------------------------------------------------------------

def _carry_scan(cols: torch.Tensor, bound: int, b: int, mask: int):
    """Carry chain over the limb axis, with the result of the sequential
    chain (tpu_ecc's): limbs <= mask and the carry-out, i.e. the unique
    digits of the same value.

    Returns (cols <= mask, carry_out[*batch]). The carry-out is mathematically
    zero whenever the value fits the limb count; callers drop it in that
    (statically asserted) case.

    Computed in a few whole-tensor steps, not one per limb: value-preserving
    passes move each limb's bits above b one limb up until every limb is at
    most mask + 1 (the bound says how many passes), then a carry-lookahead
    (`_ripple`) resolves the 0/1 ripple.
    """
    assert bound + (bound >> b) + 2 < (1 << 32), "carry pass would overflow uint32"
    x = cols.clone()
    carry = torch.zeros_like(cols[0])
    while bound > mask + 1:
        hi = x >> b
        carry += hi[-1]
        x &= mask
        x[1:] += hi[:-1]
        bound = mask + (bound >> b)
    return _ripple(x, carry, mask)


_RIPPLE_ROWS = 62
"""Limbs per integer addition in `_ripple`: the sum of a chunk needs one bit
more than its limbs, and an int64 holds 63."""


def _ripple(x: torch.Tensor, carry: torch.Tensor, mask: int):
    """Resolve the 0/1 ripple of limbs x <= mask + 1 as integer additions, a
    bit per limb. Limb i generates a carry where x_i = mask + 1 (g_i) and
    passes one on where x_i = mask (p_i); the carries into the limbs are
    those of A + G for the bit masks A = P + G and G, i.e. the bits of
    S ^ P with S = P + 2G = sum_i s_i 2^i, s_i = max(x_i - mask + 1, 0) in
    {0, 1, 2} and p_i = s_i & 1. Chunks of `_RIPPLE_ROWS` limbs go bottom
    up, each taking the carry out of the one below at its bit 0. Returns
    (limbs <= mask, carry + the carry-out)."""
    s = (x - (mask - 1)).clamp_(min=0)
    out, c = [], None
    for lo in range(0, x.shape[0], _RIPPLE_ROWS):
        sc = s[lo:lo + _RIPPLE_ROWS]
        k = sc.shape[0]
        idx = _row_index(k, sc.ndim, x.device)
        tot = (sc << idx).sum(0)
        if c is not None:
            tot += c
        out.append((x[lo:lo + k] + (((tot >> idx) ^ sc) & 1)) & mask)
        c = tot >> k                      # 0 or 1: tot < 2^(k + 1)
    return (out[0] if len(out) == 1 else torch.cat(out, 0)), carry + c


@functools.lru_cache(maxsize=None)
def _row_index(k: int, ndim: int, device: torch.device) -> torch.Tensor:
    """0 .. k - 1 as [k, 1, ...] broadcasting over a batch of ndim - 1 axes."""
    return torch.arange(k, device=device).view(-1, *([1] * (ndim - 1)))


def _grow(cols: torch.Tensor, m: int) -> torch.Tensor:
    if cols.shape[0] >= m:
        return cols
    pad = cols.new_zeros((m - cols.shape[0],) + tuple(cols.shape[1:]))
    return torch.cat([cols, pad], 0)


def _slice_add(arr: torch.Tensor, start: int, upd: torch.Tensor) -> torch.Tensor:
    """arr with arr[start:start+len(upd)] += upd (a new tensor)."""
    out = arr.clone()
    out[start:start + upd.shape[0]] += upd
    return out


def _fold_arr(lo: torch.Tensor, hi: torch.Tensor, fold1) -> torch.Tensor:
    """lo[k:k+len(hi)] += hi * fold1[k] for each fold digit (value-preserving
    mod p since fold1 represents 2^(b*n))."""
    h = hi.shape[0]
    for k, f in enumerate(fold1):
        if f == 0:
            continue
        lo = _grow(lo, k + h)
        lo = _slice_add(lo, k, hi * f)
    return lo


def _solinas_reduce(spec: FieldSpec, cols: torch.Tensor, bound: int, vmax: int) -> FE:
    """Reduce an m-limb bounded value to n carried limbs, value < 2^(b*n).

    The static Python bound arithmetic decides how many carry+fold rounds to
    emit, exactly as tpu_ecc's `_solinas_reduce` does.
    """
    b, n, mask = spec.limb_bits, spec.n_limbs, spec.mask
    f_val, fold1 = spec.fold1_val, spec.fold1
    W = spec.W
    fold_bound = mask + len(fold1) * mask * max(fold1)
    assert fold_bound < (1 << 31)

    def _fit(cols, bound, vmax):
        """Tighten vmax to the limbs' reach; trim provably-zero high limbs; pad."""
        m0 = cols.shape[0]
        vmax = min(vmax, sum(bound << (b * j) for j in range(m0)))
        m = max(n, -(-max(vmax.bit_length(), 1) // b))
        if m0 > m:
            cols = cols[:m]  # cols[j] <= vmax / 2^(b*j) < 1 for j >= m
        else:
            cols = _grow(cols, m)
        return cols, vmax

    rounds = 0
    cols, vmax = _fit(cols, bound, vmax)
    while vmax >= (W << 17):
        rounds += 1
        assert rounds < 6, "solinas reduction failed to converge (bug)"
        cols, _ = _carry_scan(cols, bound, b, mask)     # carry-out provably 0
        cols = _fold_arr(cols[:n], cols[n:], fold1)
        vmax = (W - 1) + f_val * (vmax >> (b * n))
        bound = fold_bound
        cols, vmax = _fit(cols, bound, vmax)

    # final phase: vmax < W << 17
    m = cols.shape[0]
    cols, _ = _carry_scan(cols, bound, b, mask)         # carry-out provably 0
    if m > n:
        assert (m - n - 1) + (len(fold1) - 1) < n       # fold tail stays inside n
        cols = _fold_arr(cols[:n], cols[n:], fold1)[:n]
        vmax = (W - 1) + f_val * (vmax >> (b * n))
        assert vmax < 2 * W
        cols, c = _carry_scan(cols, fold_bound, b, mask)
        # fold the 0/1 carry-out and absorb with a bounded mini-pass: when c=1
        # the remaining value is < f_val << 17, so limbs above that range are
        # zero and the pass cannot ripple past them (carry-out provably 0).
        excess_bits = f_val.bit_length() + 17
        L = min(n, -(-excess_bits // b) + 2)
        assert len(fold1) <= L
        fold_c = _const_arr(fold1, cols.ndim, cols.device) * c
        head = _slice_add(cols[:L], 0, fold_c)
        head, _ = _carry_scan(head, mask + max(fold1), b, mask)
        cols = torch.cat([head, cols[L:]], 0)
    return FE(cols, spec, mask, min(vmax, W - 1))


def fcarry(x: FE) -> FE:
    """Carry-normalize: limbs -> <= mask; value preserved (solinas also folds)."""
    s = x.spec
    if x.bound <= s.mask:
        return x
    if s.kind == "mont":
        assert x.vmax < s.W, (
            f"{s.name}: value bound 2^{x.vmax.bit_length()} overflows representation;"
            " insert an explicit reduction"
        )
        cols, _ = _carry_scan(x.limbs, x.bound, s.limb_bits, s.mask)
        return FE(cols, s, s.mask, x.vmax)
    assert x.vmax < s.carry_in_vmax, f"{s.name}: carry entry vmax too large"
    return _solinas_reduce(s, x.limbs, x.bound, x.vmax)


# ---------------------------------------------------------------------------
# add / sub / neg / small-mul
# ---------------------------------------------------------------------------

def fadd(x: FE, y: FE) -> FE:
    s = x.spec
    assert y.spec is s
    if x.bound + y.bound >= (1 << 32):
        x, y = fcarry(x), fcarry(y)
    return FE(x.limbs + y.limbs, s, x.bound + y.bound, x.vmax + y.vmax)


def fsub(x: FE, y: FE) -> FE:
    s = x.spec
    assert y.spec is s
    if y.bound > s.mask:
        y = fcarry(y)
    K, K_val, K_max = _sub_bias(s, y.bound, y.vmax.bit_length())
    if x.bound + K_max >= (1 << 32):
        x = fcarry(x)
    out = x.limbs + _const_arr(K, x.limbs.ndim, x.device) - y.limbs
    bound = x.bound + K_max
    assert bound < (1 << 32)
    return FE(out, s, bound, x.vmax + K_val)


def fneg(y: FE) -> FE:
    s = y.spec
    if y.bound > s.mask:
        y = fcarry(y)
    K, K_val, K_max = _sub_bias(s, y.bound, y.vmax.bit_length())
    return FE(_const_arr(K, y.limbs.ndim, y.device) - y.limbs, s, K_max, K_val)


def fmul_small(x: FE, k: int) -> FE:
    """Multiply by a small non-negative host constant (e.g. 3b in RCB formulas)."""
    if k == 0:
        return fe_zeros(x.spec, x.batch_shape, x.device)
    if k == 1:
        return x
    if x.bound * k >= (1 << 32):
        x = fcarry(x)
    assert x.bound * k < (1 << 32)
    return FE(x.limbs * k, x.spec, x.bound * k, x.vmax * k)


# ---------------------------------------------------------------------------
# multiply / square
# ---------------------------------------------------------------------------

def _conv_arr(xl: torch.Tensor, yl: torch.Tensor) -> torch.Tensor:
    """Convolution columns col[k] = sum_{i+j=k} x_i * y_j: the anti-diagonal
    sums of one outer product [n, m, *b], one index_add_ of its rows by
    i + j (integer sums, so exact in any order)."""
    n, m = xl.shape[0], yl.shape[0]
    bshape = torch.broadcast_shapes(xl.shape[1:], yl.shape[1:])
    prod = xl.expand((n, *bshape))[:, None] * yl.expand((m, *bshape))[None, :]
    return prod.new_zeros((n + m - 1, *bshape)).index_add_(
        0, _diagonal_index(n, m, prod.device), prod.reshape((n * m, *bshape)))


@functools.lru_cache(maxsize=None)
def _diagonal_index(n: int, m: int, device: torch.device) -> torch.Tensor:
    """i + j for the rows of an [n, m] outer product, flattened."""
    return (torch.arange(n, device=device)[:, None]
            + torch.arange(m, device=device)[None, :]).reshape(-1)


def _mont_reduce(spec: FieldSpec, cols: torch.Tensor, in_vmax: int) -> FE:
    """Word-by-word Montgomery reduction of 2n columns -> n limbs, < ~1.1p.

    out = (in + m*p)/R with R = 2^(b*n); out <= in/R + p. `(col * n0) & mask`
    may exceed 2^32 in int64 where uint32 wraps; the mask keeps the low b bits,
    which agree.
    """
    b, n, mask, n0 = spec.limb_bits, spec.n_limbs, spec.mask, spec.n0
    cols = _grow(cols, 2 * n).clone()
    p_arr = _const_arr(spec.p_limbs, cols.ndim, cols.device)
    for i in range(n):
        m = (cols[i] * n0) & mask
        cols[i:i + n] += m * p_arr
        cols[i + 1] += cols[i] >> b
    out_vmax = in_vmax // spec.W + spec.p + 1
    assert out_vmax < spec.W
    rows, _ = _carry_scan(cols[n:2 * n], (1 << 32) - 1 - (1 << 21), b, mask)
    return FE(rows, spec, mask, out_vmax)


def fmul(x: FE, y: FE) -> FE:
    s = x.spec
    assert y.spec is s, f"field mismatch {x.spec} vs {y.spec}"
    if x.bound > s.mul_in_bound:
        x = fcarry(x)
    if y.bound > s.mul_in_bound:
        y = fcarry(y)
    cols = _conv_arr(x.limbs, y.limbs)
    col_bound = s.n_limbs * x.bound * y.bound
    if s.kind == "mont":
        assert col_bound + s.n_limbs * (1 << (2 * s.limb_bits)) + (1 << 21) < (1 << 32)
        return _mont_reduce(s, cols, x.vmax * y.vmax)
    assert col_bound < (1 << 32)
    return _solinas_reduce(s, cols, col_bound, x.vmax * y.vmax)


def fsquare(x: FE) -> FE:
    """x^2 with tpu_ecc's symmetric-square ledger (its own input bound and
    column bound). The columns of x*x are the symmetric-square columns
    2*x_i*x_j + x_i^2 as integers, so one convolution serves both."""
    s = x.spec
    if not s.sq_symmetric:
        return fmul(x, x)
    if x.bound > s.sq_in_bound:
        x = fcarry(x)
    cols = _conv_arr(x.limbs, x.limbs)
    col_bound = 2 * s.n_limbs * x.bound * x.bound
    if s.kind == "mont":
        assert col_bound + s.n_limbs * (1 << (2 * s.limb_bits)) + (1 << 21) < (1 << 32)
        return _mont_reduce(s, cols, x.vmax * x.vmax)
    assert col_bound < (1 << 32)
    return _solinas_reduce(s, cols, col_bound, x.vmax * x.vmax)


# ---------------------------------------------------------------------------
# canonicalization, comparison
# ---------------------------------------------------------------------------

def _cond_sub(spec: FieldSpec, cols: torch.Tensor, m_limbs):
    """Constant-time conditional subtract: cols - m if cols >= m else cols."""
    b, mask = spec.limb_bits, spec.mask
    borrow = torch.zeros_like(cols[0])
    outs = []
    for row, ml in zip(cols.unbind(0), m_limbs):
        t = row + ((1 << b) - ml) - borrow
        outs.append(t & mask)
        borrow = 1 - (t >> b)
    ge = borrow == 0  # no final borrow -> cols >= m
    return torch.where(ge, torch.stack(outs, 0), cols), ge


def freduce(x: FE, mult: int = 1) -> FE:
    """Constant-time reduce below mult*p (mult a power of two) via conditional
    subtractions of p << i. mult=1 canonicalizes into [0, p)."""
    s = x.spec
    x = fcarry(x)
    cols = x.limbs
    vmax = min(x.vmax, s.W - 1)
    lo = mult.bit_length() - 1
    assert mult == 1 << lo
    i = max(lo, (vmax // s.p).bit_length() - 1)
    while vmax >= mult * s.p and i >= lo:
        m = s.p << i
        if m < s.W:
            cols, _ = _cond_sub(s, cols, int_to_limbs(m, s.n_limbs, s.limb_bits))
            vmax = max(m - 1, vmax - m)
        i -= 1
    assert vmax < mult * s.p
    return FE(cols, s, s.mask, vmax)


def fcanonical(x: FE) -> FE:
    """Fully reduce into [0, p) (internal domain). For serialization/compares."""
    return freduce(x, 1)


def fsteady(x: FE) -> FE:
    """Clamp one coordinate to the spec's steady loop invariant, the way the
    kernels' `ksteady` does (ops/kfe.py): Montgomery values reduce below 4p,
    solinas values carry. (tpu_ecc spells this scalarmul._coord_steady.)"""
    s = x.spec
    if s.kind == "mont":
        v = freduce(x, 4)
        return FE(v.limbs, s, s.mask, s.carried_vmax)
    return _steady(x)


def words_from_ints(vals, bits: int) -> np.ndarray:
    """Host ints -> packed little-endian 32-bit words uint32[n_words, B].
    Vectorised over the batch (numpy object arrays); the loop runs over the
    few words, not the elements."""
    nw = (bits + 31) // 32
    obj = np.array([int(v) for v in vals], dtype=object)
    out = np.zeros((nw, len(obj)), np.uint32)
    for j in range(nw):
        out[j] = ((obj >> (32 * j)) & _MAX32).astype(np.uint32)
    return out


def ints_from_words(arr) -> list[int]:
    """uint32[n_words, B] -> host ints (vectorised over the batch)."""
    a = np.asarray(arr)
    acc = np.zeros(a.shape[1], dtype=object)
    for j in range(a.shape[0] - 1, -1, -1):
        acc = (acc << 32) | a[j].astype(np.uint64).astype(object)
    return [int(v) for v in acc]


def fe_from_words(spec: FieldSpec, words: torch.Tensor, value_bits: int,
                  encode: bool = True) -> FE:
    """Packed 32-bit words (int64 tensor, each < 2^32) -> FE, Montgomery-encoded
    on the device when the spec is 'mont' and encode=True."""
    raw = relimb(words, 32, spec.limb_bits, spec.n_limbs)
    vmax = min((1 << value_bits), spec.W) - 1
    fe = FE(raw, spec, spec.mask, vmax)
    if encode and spec.kind == "mont":
        # multiply raw limbs by enc(R) = R^2: raw * R^2 / R = mont(value)
        fe = fmul(fe, fe_from_int(spec, spec.r, tuple(words.shape[1:]), words.device))
    return fe


def fe_to_words(x: FE, bits: int | None = None) -> torch.Tensor:
    """FE -> canonical integer packed as 32-bit words (int64 tensor)."""
    s = x.spec
    bits = bits or s.bits
    raw = fto_raw_canonical(x)
    return relimb(raw, s.limb_bits, 32, (bits + 31) // 32)


def fto_raw_canonical(x: FE) -> torch.Tensor:
    """Canonical *integer-domain* limbs (Montgomery factor removed) [n, *b]."""
    s = x.spec
    if s.kind == "mont":
        one_raw = FE(_const_arr(int_to_limbs(1, s.n_limbs, s.limb_bits),
                                x.limbs.ndim, x.device), s, s.mask, 1)
        x = fmul(x, one_raw)          # (x*R) * 1 / R = x
    return fcanonical(x).limbs


def relimb(limbs: torch.Tensor, src_b: int, dst_b: int, dst_n: int) -> torch.Tensor:
    """Repack canonical limbs between limb widths (e.g. 32-bit words -> 13-bit
    limbs). Static shifts only; bits above dst_b are masked off as in uint32."""
    src_n = limbs.shape[0]
    masks = (1 << dst_b) - 1
    out = []
    for j in range(dst_n):
        lo, hi = dst_b * j, dst_b * (j + 1)
        acc = None
        for i in range(lo // src_b, min(src_n - 1, (hi - 1) // src_b) + 1):
            base = src_b * i
            if base >= lo:
                t = limbs[i] << (base - lo)
            else:
                t = limbs[i] >> (lo - base)
            acc = t if acc is None else (acc | t)
        if acc is None:
            acc = torch.zeros_like(limbs[0])
        out.append(acc & masks)
    return torch.stack(out, 0)


def fmul_shift(spec: FieldSpec, u_limbs: torch.Tensor, g: int,
               shift_limbs: int, out_limbs: int) -> torch.Tensor:
    """floor(u * g / 2^(b*shift_limbs)) for canonical limbs u (bound <= mask)
    and a host constant g -> limbs [out_limbs, *batch] (branchless)."""
    b, mask = spec.limb_bits, spec.mask
    ng = -(-max(g.bit_length(), 1) // b)
    g_arr = _const_arr(int_to_limbs(g, ng, b), u_limbs.ndim, u_limbs.device)
    col_bound = min(spec.n_limbs, ng) * mask * mask
    assert col_bound < (1 << 32), "fmul_shift columns overflow uint32"
    cols = _conv_arr(u_limbs, g_arr)
    carried, _ = _carry_scan(cols, col_bound, b, mask)
    carried = _grow(carried, shift_limbs + out_limbs)
    return carried[shift_limbs:shift_limbs + out_limbs]


def field_to_scalar_raw(field: FieldSpec, scalar: FieldSpec, x: FE):
    """Field element -> canonical integer limbs mod the group order n.

    Uses p < 2n (Hasse), so one conditional subtract reduces. Returns
    (limbs [ns, *b], was_reduced bool[*batch]); the flag is RecoveryId's
    x-overflow bit (k256/src/ecdsa.rs:192-197)."""
    assert field.p < 2 * scalar.p
    raw = fto_raw_canonical(x)
    if (field.limb_bits, field.n_limbs) != (scalar.limb_bits, scalar.n_limbs):
        raw = relimb(raw, field.limb_bits, scalar.limb_bits, scalar.n_limbs)
    return _cond_sub(scalar, raw,
                     int_to_limbs(scalar.p, scalar.n_limbs, scalar.limb_bits))


def feq(x: FE, y: FE) -> torch.Tensor:
    """Batched equality -> bool[*batch]."""
    xc, yc = fcanonical(x), fcanonical(y)
    return torch.all(xc.limbs == yc.limbs, dim=0)


def fis_zero(x: FE) -> torch.Tensor:
    xc = fcanonical(x)
    return torch.all(xc.limbs == 0, dim=0)


def fselect(mask_arr: torch.Tensor, a: FE, b: FE) -> FE:
    """where(mask, a, b) elementwise over the batch. mask: bool[*batch]."""
    assert a.spec is b.spec
    return FE(torch.where(mask_arr, a.limbs, b.limbs), a.spec,
              max(a.bound, b.bound), max(a.vmax, b.vmax))


# ---------------------------------------------------------------------------
# pow / invert
# ---------------------------------------------------------------------------

def fone(spec: FieldSpec, batch_shape=(), device=None) -> FE:
    return fe_from_int(spec, 1, batch_shape, device)


def _steady(x: FE) -> FE:
    """Carry and clamp vmax to the spec's steady-state loop invariant."""
    s = x.spec
    x = fcarry(x)
    assert x.vmax <= s.carried_vmax, f"{s.name}: value not steady ({x.vmax.bit_length()}b)"
    return FE(x.limbs, s, s.mask, s.carried_vmax)


def fpow_const(x: FE, e: int) -> FE:
    """x^e for a fixed host exponent: 4-bit fixed windows, MSB first.

    Exponents of 64 bits or more (Fermat inversion) go through the `pow`
    kernel wrapper, as tpu_ecc routes them to its pow kernel; shorter ones
    run the same algorithm as plain tensor code."""
    from . import kernels

    s = x.spec
    if e == 0:
        return fone(s, x.batch_shape, x.device)
    if e == 1:
        return x
    x = _steady(x)
    if e.bit_length() >= 64:
        return fe_steady(s, kernels.fpow(s, x.limbs, e))
    return fe_steady(s, kernels.fpow_plain(s, x.limbs, e))


def finv(x: FE) -> FE:
    """Constant-time Fermat inversion x^(p-2); maps 0 -> 0 (callers mask the
    CtOption-none case separately, as with the reference's invert)."""
    return fpow_const(x, x.spec.p - 2)


def _associative_scan(combine, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last axis with the pairing tree of
    jax.lax.associative_scan (combine adjacent pairs, scan the half
    recursively, fill the even slots), so that a combine whose limbs depend
    on the order of association gives tpu_ecc's limbs."""
    num = x.shape[-1]
    if num < 2:
        return x
    odd = _associative_scan(combine, combine(x[..., 0:-1:2], x[..., 1::2]))
    if num % 2 == 0:
        even = combine(odd[..., :-1], x[..., 2::2])
    else:
        even = combine(odd, x[..., 2::2])
    even = torch.cat([x[..., :1], even], -1)
    out = torch.empty_like(x)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def fbatch_inv(x: FE) -> FE:
    """Batched Montgomery-trick inversion over the last batch axis:
    x_i^-1 = prefix_i * suffix_i * total^-1, with the exclusive prefix and
    suffix products from two associative scans and one Fermat inversion of
    the total (BatchInvert, primeorder/src/projective.rs:382-413). Zeros map
    to zero."""
    s = x.spec
    x = _steady(x)
    zero_mask = fis_zero(x)
    one = fone(s, x.batch_shape, x.device)
    x = fselect(zero_mask, one, x)        # mask zeros to 1 (reference :394-399)
    limbs = x.limbs

    def combine(a, b):
        return _steady(fmul(fe_steady(s, a), fe_steady(s, b))).limbs

    incl = _associative_scan(combine, limbs)
    tinv = finv(fe_steady(s, incl[..., -1:]))              # [n, ..., 1]
    one_col = one.limbs[..., :1].expand(limbs[..., :1].shape)
    excl_prefix = torch.cat([one_col, incl[..., :-1]], -1)
    incl_r = _associative_scan(combine, limbs.flip(-1)).flip(-1)
    excl_suffix = torch.cat([incl_r[..., 1:], one_col], -1)
    out = fmul(fe_steady(s, excl_prefix), fe_steady(s, excl_suffix))
    out = _steady(fmul(out, FE(tinv.limbs.expand(limbs.shape), s, s.mask,
                               s.carried_vmax)))
    return fselect(zero_mask, fe_zeros(s, x.batch_shape, x.device), out)


@functools.lru_cache(maxsize=None)
def _ts_constants(spec: FieldSpec):
    """Tonelli–Shanks constants: p-1 = q * 2^s with q odd; z = a non-residue."""
    p = spec.p
    q, s_ = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s_ += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return q, s_, z


def fsqrt(x: FE):
    """Batched square root. Returns (root, is_square: bool[*batch]).

    p = 3 mod 4: one power (p+1)/4, which runs on the `pow` kernel (cf.
    p192/src/arithmetic/field.rs:103-107, k256 field.rs:220-255). Otherwise
    constant-time Tonelli–Shanks with a fixed trip count: every step runs
    for every lane and a mask keeps or drops its result (cf. the p224 field
    sqrt, k256 scalar.rs:290-327). The inner squarings that tpu_ecc masks
    by its public loop counters (j < i - 2) are left out here, which gives
    the same limbs."""
    s = x.spec
    p = s.p
    if p % 4 == 3:
        r = fpow_const(x, (p + 1) // 4)
        return r, feq(fsquare(r), x)

    q, s2, znr = _ts_constants(s)
    x = _steady(x)
    c = _steady(fe_from_int(s, pow(znr, q, p), x.batch_shape, x.device))
    t = fpow_const(x, q)                  # order divides 2^(s2-1) for squares
    r = fpow_const(x, (q + 1) // 2)
    one = fone(s, x.batch_shape, x.device)
    for k in range(s2 - 1):
        i = s2 - k                        # i runs s2 .. 2
        b = t                             # b = t^(2^(i-2))
        for _ in range(i - 2):
            b = _steady(fsquare(b))
        flag = ~feq(b, one)
        c2 = _steady(fsquare(c))
        r = fselect(flag, _steady(fmul(r, c)), r)
        t = fselect(flag, _steady(fmul(t, c2)), t)
        c = c2
    return r, feq(fsquare(r), x)
