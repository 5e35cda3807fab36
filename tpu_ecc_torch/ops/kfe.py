"""The kernel field engine (KFE), generic over its limb type, and the CUDA
code generator built on it.

tpu_ecc's kernel engine (tpu_ecc/ops/fe_kernel.py) holds a field element as
a Python list of per-limb values plus the static bound/vmax ledger that
decides, at trace time, where carries go: `kadd`/`ksub`/`kmul` insert a carry
only where a bound would cross 2^32, `_solinas_reduce_k` picks its fold
rounds from vmax, `kreduce` its conditional subtractions. The engine only
ever does `+`, `-`, `*`, `&`, `>>`, a zero test and a select on limbs, with
Python-int constants. So the same ledger code here runs on two limb types:

- numpy `uint32` arrays, which evaluate the kernels' exact arithmetic
  (wraparound included) on the CPU;
- `Sym`, a symbolic uint32 that records each operation as one C statement
  on `uint32_t`. `kernel_header` turns a formula into straight-line
  `__host__ __device__` functions for csrc/ (each field multiply and square
  a function of its own, one per input ledger), and counts the 32-bit
  integer instructions each one needs at least (after dead-code
  elimination and the multiply-add and three-input-add fusions), by
  class; the kernels' operation bounds come from those counts.

No kernel builds from `kernel_header` any more: every kernel of csrc/ runs
on the hand-written 32-bit layer (csrc/fe32.cuh), whose constants come
from `fe32_header` and `fe32_field_header` and whose instruction count is
`fe32_counts`. The generator stays as the "kfe" design of each kernel's
bound (ops/kernels.py `work`) and is held against tpu_ecc's engine
(tests/test_torch_kfe.py).

Each generated function takes steady inputs and returns `ksteady` outputs,
exactly as tpu_ecc's Pallas bodies trace them (pallas_kernels.py:56-104,
:173-197, :440-447, :955-998, :1094-1102, :1174-1205).
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np

from ..utils.bigint import int_to_limbs
from .fe import FieldSpec, _sub_bias

_M32 = (1 << 32) - 1


# ---------------------------------------------------------------------------
# the symbolic limb type
# ---------------------------------------------------------------------------

def _nodes(syms) -> tuple:
    """The statements a C expression reads: `v12` for `v12` or `v12[3]`."""
    return tuple(s.name.split("[")[0] for s in syms if s.const is None)


INSTRUCTION_CLASSES = ("imad", "alu", "other")
"""How the operation bound sorts the instructions a function needs at least:
`imad` multiplies (alone or fused with the add that is their only use) on
the FMA pipe; `alu` bitwise AND, compares and selects (LOP3, ISETP, SEL),
which only the integer ALU pipe runs; `other` adds (IADD3, or LEA/LEA.HI
where the add's operand is a shift used only there), shifts and multiplies
by a power of two, which either pipe can take."""

_CLASS = {"mul": "imad", "and": "alu", "eq": "alu", "sel": "alu",
          "add": "other", "sub": "other", "shr": "other", "shl": "other"}


class Emitter:
    """Collects the statements of one generated function. `lib` is shared by
    every function of one header: C body text -> (function name, source,
    instruction counts) of the field multiplies and squares called out of
    line."""

    def __init__(self, lib: dict):
        # (node name, C statement, nodes read, operation kind or the
        #  callee's instruction counts)
        self.stmts = []
        self.lib = lib

    def const(self, v: int) -> "Sym":
        return Sym(self, const=int(v) & _M32)

    def emit(self, expr: str, deps, kind: str) -> "Sym":
        name = f"v{len(self.stmts)}"
        self.stmts.append((name, f"const uint32_t {name} = {expr};",
                           _nodes(deps), kind))
        return Sym(self, name=name)

    def call(self, fname: str, count: dict, args, n_out: int) -> list:
        """One call of a generated function: each argument list becomes a
        local array; the results are the elements of `v<k>[n_out]`."""
        name = f"v{len(self.stmts)}"
        lines = [f"const uint32_t {name}_{j}[{len(a)}] = {{{', '.join(map(str, a))}}};"
                 for j, a in enumerate(args)]
        lines.append(f"uint32_t {name}[{n_out}];")
        lines.append(f"{fname}({', '.join(f'{name}_{j}' for j in range(len(args)))}, {name});")
        self.stmts.append((name, "\n  ".join(lines),
                           _nodes([s for a in args for s in a]), dict(count)))
        return [Sym(self, name=f"{name}[{i}]") for i in range(n_out)]

    def function(self, cname: str, params, outs) -> tuple:
        """C source of the function `cname(params..., out)` returning `outs`,
        after dead-code elimination, and the 32-bit integer instructions it
        executes at least, by class (see `instructions`)."""
        outs = [o if isinstance(o, Sym) else self.const(int(o)) for o in outs]
        table = {name: deps for name, _, deps, _ in self.stmts}
        live, stack = set(), list(_nodes(outs))
        while stack:
            v = stack.pop()
            if v in table and v not in live:
                live.add(v)
                stack.extend(table[v])
        args = ", ".join(f"const uint32_t* __restrict__ {p}" for p, _ in params)
        lines = [f"static __host__ __device__ __noinline__ void {cname}("
                 f"{args}, uint32_t* __restrict__ out) {{"]
        lines += [f"  {stmt}" for name, stmt, _, _ in self.stmts if name in live]
        lines += [f"  out[{i}] = {o};" for i, o in enumerate(outs)]
        lines.append("}")
        return "\n".join(lines) + "\n", self.instructions(live, outs)

    def instructions(self, live: set, outs) -> dict:
        """The instructions the live statements need at least, by class
        (INSTRUCTION_CLASSES), with the fusions Hopper's integer
        instructions offer: an add absorbs an operand used only there that
        is a multiply (one IMAD), a shift (one LEA or LEA.HI) or a two-term
        add or subtract (one IADD3). A call counts its callee's."""
        uses = {}
        for name, _, deps, _ in self.stmts:
            if name in live:
                for d in deps:
                    uses[d] = uses.get(d, 0) + 1
        for d in _nodes(outs):
            uses[d] = uses.get(d, 0) + 1
        cls, open_kind = {}, {}    # node -> class; node -> kind an add may absorb
        counts = dict.fromkeys(INSTRUCTION_CLASSES, 0)
        for name, _, deps, kind in self.stmts:
            if name not in live:
                continue
            if isinstance(kind, dict):                   # a call
                for c, v in kind.items():
                    counts[c] += v
                continue
            cls[name] = _CLASS[kind]
            open_kind[name] = "add2" if kind in ("add", "sub") else kind
            if kind not in ("add", "sub"):
                continue
            for d in deps:
                k = open_kind.get(d) if uses[d] == 1 else None
                if k == "add2" or (kind == "add" and k in ("mul", "shl", "shr")):
                    if k == "mul":
                        cls[name] = "imad"
                    del cls[d]
                    open_kind[d] = open_kind[name] = None
                    break
        for c in cls.values():
            counts[c] += 1
        return counts


def _is_sym(x: "KFE") -> bool:
    return isinstance(x.limbs[0], Sym)


def _out_of_line(kind: str, fn, *xs: "KFE") -> "KFE":
    """fn(*xs) as a call of its own generated function (one per distinct
    body: the bound ledger of the inputs shapes the code). Constant limbs
    stay literals inside the callee. Keeps each generated function to a few
    thousand statements, which nvcc compiles; the whole add inlined is too
    much for it."""
    em = xs[0].limbs[0].em
    if all(l.const is not None for x in xs for l in x.limbs):
        return fn(*xs)
    child = Emitter(em.lib)
    params, ins = [], []
    for pname, x in zip("xyzw", xs):
        live = [l for l in x.limbs if l.const is None]
        it = iter(range(len(live)))
        limbs = [child.const(l.const) if l.const is not None
                 else Sym(child, name=f"{pname}[{next(it)}]") for l in x.limbs]
        if live:
            params.append((pname, live))
        ins.append(KFE(limbs, x.spec, x.bound, x.vmax))
    out = fn(*ins)
    src, count = child.function("@NAME@", [(p, len(a)) for p, a in params],
                                out.limbs)
    if src not in em.lib:
        fname = f"kfe_{kind}_{len(em.lib)}"
        em.lib[src] = (fname, src.replace("@NAME@", fname), count)
    fname, _, count = em.lib[src]
    limbs = em.call(fname, count, [a for _, a in params], len(out.limbs))
    return KFE(limbs, out.spec, out.bound, out.vmax)


class Sym:
    """A uint32_t value in generated C: a named value or a folded literal."""

    __slots__ = ("em", "name", "const")

    def __init__(self, em: Emitter, name: str | None = None,
                 const: int | None = None):
        self.em, self.name, self.const = em, name, const

    def __str__(self):
        return self.name if self.const is None else f"{self.const}u"

    def _sym(self, o) -> "Sym":
        return o if isinstance(o, Sym) else self.em.const(int(o))

    def __add__(self, o):
        o = self._sym(o)
        if self.const is not None and o.const is not None:
            return self.em.const(self.const + o.const)
        if self.const == 0:
            return o
        if o.const == 0:
            return self
        return self.em.emit(f"{self} + {o}", (self, o), "add")

    __radd__ = __add__

    def __sub__(self, o):
        o = self._sym(o)
        if self.const is not None and o.const is not None:
            return self.em.const(self.const - o.const)
        if o.const == 0:
            return self
        return self.em.emit(f"{self} - {o}", (self, o), "sub")

    def __rsub__(self, o):
        return self._sym(o) - self

    def __mul__(self, o):
        o = self._sym(o)
        if self.const is not None and o.const is not None:
            return self.em.const(self.const * o.const)
        if self.const == 0 or o.const == 0:
            return self.em.const(0)
        if self.const == 1:
            return o
        if o.const == 1:
            return self
        c = self.const if self.const is not None else o.const
        kind = "shl" if c is not None and c & (c - 1) == 0 else "mul"
        return self.em.emit(f"{self} * {o}", (self, o), kind)

    __rmul__ = __mul__

    def __and__(self, o):
        o = self._sym(o)
        if self.const is not None and o.const is not None:
            return self.em.const(self.const & o.const)
        if self.const == 0 or o.const == 0:
            return self.em.const(0)
        return self.em.emit(f"{self} & {o}", (self, o), "and")

    __rand__ = __and__

    def __rshift__(self, k: int):
        k = int(k)
        if self.const is not None:
            return self.em.const(self.const >> k)
        if k == 0:
            return self
        return self.em.emit(f"{self} >> {k}", (self,), "shr")


# the four operations that are not Python operators, for either limb type

def _zeros_like(x):
    return x.em.const(0) if isinstance(x, Sym) else np.zeros_like(x)


def _full_like(x, v: int):
    return x.em.const(v) if isinstance(x, Sym) else np.full_like(x, v)


def _eq0(x):
    """1 where x == 0 (a uint32 0/1 flag for Sym, a bool array for numpy)."""
    if isinstance(x, Sym):
        if x.const is not None:
            return x.em.const(int(x.const == 0))
        return x.em.emit(f"(uint32_t)({x} == 0u)", (x,), "eq")
    return x == 0


def _where(m, a, b):
    if isinstance(m, Sym):
        a, b = m._sym(a), m._sym(b)
        if m.const is not None:
            return a if m.const else b
        return m.em.emit(f"{m} ? {a} : {b}", (m, a, b), "sel")
    return np.where(m, a, b)


# ---------------------------------------------------------------------------
# the engine: tpu_ecc/ops/fe_kernel.py, limb type left open
# ---------------------------------------------------------------------------

class KFE:
    """Kernel field element: list of per-limb values + static bounds."""

    __slots__ = ("limbs", "spec", "bound", "vmax")

    def __init__(self, limbs, spec: FieldSpec, bound: int, vmax: int):
        self.limbs = list(limbs)
        self.spec = spec
        self.bound = bound
        self.vmax = vmax

    def __add__(self, other):
        return kadd(self, other)

    def __sub__(self, other):
        return ksub(self, other)

    def __mul__(self, other):
        if isinstance(other, KFE):
            return kmul(self, other)
        return kmul_small(self, int(other))

    __rmul__ = __mul__

    def __neg__(self):
        return kneg(self)

    def square(self):
        return ksquare(self)


def kfe_from_rows(spec: FieldSpec, rows) -> KFE:
    """Wrap per-limb values known to be carried steady-state."""
    return KFE(rows, spec, spec.mask, spec.carried_vmax)


def kfe_const(spec: FieldSpec, value: int, like) -> KFE:
    v = spec.encode_int(value)
    rows = [_full_like(like, l)
            for l in int_to_limbs(v, spec.n_limbs, spec.limb_bits)]
    return KFE(rows, spec, spec.mask, max(v, 1))


def _carry_unrolled(cols, b: int, mask: int):
    """Sequential carry chain, unrolled over the limb list. Returns
    (normalized cols, carry-out or None)."""
    out, c = [], None
    for col in cols:
        t = col if c is None else col + c
        out.append(t & mask)
        c = t >> b
    return out, c


def _solinas_reduce_k(spec: FieldSpec, cols: list, bound: int, vmax: int) -> KFE:
    """List-form tpu_ecc fe._solinas_reduce: identical static control flow
    (same bound ledger, same carry/fold rounds)."""
    b, n, mask = spec.limb_bits, spec.n_limbs, spec.mask
    f_val, fold1 = spec.fold1_val, spec.fold1
    W = spec.W
    fold_bound = mask + len(fold1) * mask * max(fold1)
    assert fold_bound < (1 << 31)
    zero = _zeros_like(cols[0])

    def _fold(lo, hi):
        lo = list(lo)
        for k, f in enumerate(fold1):
            if f == 0:
                continue
            for j, h in enumerate(hi):
                idx = k + j
                while len(lo) <= idx:
                    lo.append(zero)
                lo[idx] = lo[idx] + h * f
        return lo

    def _fit(cols, bound, vmax):
        m0 = len(cols)
        vmax = min(vmax, sum(bound << (b * j) for j in range(m0)))
        m = max(n, -(-max(vmax.bit_length(), 1) // b))
        cols = cols[:m] + [zero] * (m - len(cols))
        return cols, vmax

    rounds = 0
    cols, vmax = _fit(list(cols), bound, vmax)
    while vmax >= (W << 17):
        rounds += 1
        assert rounds < 6, "solinas reduction failed to converge (bug)"
        cols, _ = _carry_unrolled(cols, b, mask)        # carry-out provably 0
        cols = _fold(cols[:n], cols[n:])
        vmax = (W - 1) + f_val * (vmax >> (b * n))
        bound = fold_bound
        cols, vmax = _fit(cols, bound, vmax)

    m = len(cols)
    cols, _ = _carry_unrolled(cols, b, mask)            # carry-out provably 0
    if m > n:
        assert (m - n - 1) + (len(fold1) - 1) < n
        cols = _fold(cols[:n], cols[n:])[:n]
        vmax = (W - 1) + f_val * (vmax >> (b * n))
        assert vmax < 2 * W
        cols, c = _carry_unrolled(cols, b, mask)
        excess_bits = f_val.bit_length() + 17
        L = min(n, -(-excess_bits // b) + 2)
        assert len(fold1) <= L
        head = list(cols[:L])
        for k, f in enumerate(fold1):
            if f:
                head[k] = head[k] + c * f
        head, _ = _carry_unrolled(head, b, mask)
        cols = head + cols[L:]
    return KFE(cols, spec, mask, min(vmax, W - 1))


def _mont_reduce_k(spec: FieldSpec, cols: list, in_vmax: int) -> KFE:
    """List-form tpu_ecc fe._mont_reduce (word-by-word Montgomery): 2n column
    values, the m*p accumulation as per-limb multiply-adds (zero p-limbs
    skipped), carry chain unrolled."""
    b, n, mask, n0 = spec.limb_bits, spec.n_limbs, spec.mask, spec.n0
    cols = list(cols)
    zero = _zeros_like(cols[0])
    while len(cols) < 2 * n:
        cols.append(zero)
    for i in range(n):
        m = (cols[i] * n0) & mask
        for j, pj in enumerate(spec.p_limbs):
            if pj:
                cols[i + j] = cols[i + j] + m * pj
        cols[i + 1] = cols[i + 1] + (cols[i] >> b)
    out_vmax = in_vmax // spec.W + spec.p + 1
    assert out_vmax < spec.W
    rows, _ = _carry_unrolled(cols[n:2 * n], b, mask)  # carry-out provably 0
    return KFE(rows, spec, mask, out_vmax)


def kcarry(x: KFE) -> KFE:
    s = x.spec
    if x.bound <= s.mask:
        return x
    if s.kind == "mont":
        assert x.vmax < s.W, (
            f"{s.name}: value bound 2^{x.vmax.bit_length()} overflows"
            " representation; insert an explicit reduction")
        assert x.bound + (x.bound >> s.limb_bits) + 2 < (1 << 32)
        rows, _ = _carry_unrolled(x.limbs, s.limb_bits, s.mask)
        return KFE(rows, s, s.mask, x.vmax)
    assert x.vmax < s.carry_in_vmax, f"{s.name}: carry entry vmax too large"
    return _solinas_reduce_k(s, x.limbs, x.bound, x.vmax)


def _cond_sub_k(spec: FieldSpec, cols: list, m_limbs):
    """Constant-time conditional subtract: the borrow chain unrolled."""
    b, mask = spec.limb_bits, spec.mask
    borrow = _zeros_like(cols[0])
    sub = []
    for r, ml in zip(cols, m_limbs):
        t = r + ((1 << b) - ml) - borrow
        sub.append(t & mask)
        borrow = 1 - (t >> b)
    ge = _eq0(borrow)              # no final borrow -> cols >= m
    return [_where(ge, sv, cv) for sv, cv in zip(sub, cols)], ge


def kreduce(x: KFE, mult: int = 1) -> KFE:
    """Constant-time reduce below mult*p: the static schedule of conditional
    subtractions of p << i that tpu_ecc's fe.freduce uses."""
    s = x.spec
    x = kcarry(x)
    cols = list(x.limbs)
    vmax = min(x.vmax, s.W - 1)
    lo = mult.bit_length() - 1
    assert mult == 1 << lo
    i = max(lo, (vmax // s.p).bit_length() - 1)
    while vmax >= mult * s.p and i >= lo:
        m = s.p << i
        if m < s.W:
            cols, _ = _cond_sub_k(s, cols,
                                  int_to_limbs(m, s.n_limbs, s.limb_bits))
            vmax = max(m - 1, vmax - m)
        i -= 1
    assert vmax < mult * s.p
    return KFE(cols, s, s.mask, vmax)


def ksteady(x: KFE) -> KFE:
    s = x.spec
    if s.kind == "mont":
        x = kreduce(x, 4)
        return KFE(x.limbs, s, s.mask, s.carried_vmax)
    x = kcarry(x)
    assert x.vmax <= s.carried_vmax, f"{s.name}: not steady"
    return KFE(x.limbs, s, s.mask, s.carried_vmax)


def kadd(x: KFE, y: KFE) -> KFE:
    s = x.spec
    assert y.spec is s
    if x.bound + y.bound >= (1 << 32):
        x, y = kcarry(x), kcarry(y)
    return KFE([a + b for a, b in zip(x.limbs, y.limbs)], s,
               x.bound + y.bound, x.vmax + y.vmax)


def ksub(x: KFE, y: KFE) -> KFE:
    s = x.spec
    assert y.spec is s
    if y.bound > s.mask:
        y = kcarry(y)
    K, K_val, K_max = _sub_bias(s, y.bound, y.vmax.bit_length())
    if x.bound + K_max >= (1 << 32):
        x = kcarry(x)
    out = [a + k - b for a, k, b in zip(x.limbs, K, y.limbs)]
    bound = x.bound + K_max
    assert bound < (1 << 32)
    return KFE(out, s, bound, x.vmax + K_val)


def kneg(y: KFE) -> KFE:
    s = y.spec
    if y.bound > s.mask:
        y = kcarry(y)
    K, K_val, K_max = _sub_bias(s, y.bound, y.vmax.bit_length())
    return KFE([k - b for k, b in zip(K, y.limbs)], s, K_max, K_val)


def kmul_small(x: KFE, k: int) -> KFE:
    if k == 0:
        return KFE([_zeros_like(x.limbs[0])] * x.spec.n_limbs, x.spec, 0, 0)
    if k == 1:
        return x
    if x.bound * k >= (1 << 32):
        x = kcarry(x)
    assert x.bound * k < (1 << 32)
    return KFE([a * k for a in x.limbs], x.spec, x.bound * k, x.vmax * k)


def _conv_k(xl: list, yl: list) -> list:
    """Schoolbook convolution into 2n-1 explicit accumulators."""
    n, m = len(xl), len(yl)
    acc = [None] * (n + m - 1)
    for i in range(n):
        for j in range(m):
            p = xl[i] * yl[j]
            k = i + j
            acc[k] = p if acc[k] is None else acc[k] + p
    return acc


def kmul(x: KFE, y: KFE) -> KFE:
    if _is_sym(x) or _is_sym(y):
        return _out_of_line("mul", _kmul, x, y)
    return _kmul(x, y)


def _kmul(x: KFE, y: KFE) -> KFE:
    s = x.spec
    assert y.spec is s
    if x.bound > s.mul_in_bound:
        x = kcarry(x)
    if y.bound > s.mul_in_bound:
        y = kcarry(y)
    cols = _conv_k(x.limbs, y.limbs)
    col_bound = s.n_limbs * x.bound * y.bound
    if s.kind == "mont":
        assert (col_bound + s.n_limbs * (1 << (2 * s.limb_bits))
                + (1 << 21) < (1 << 32))
        return _mont_reduce_k(s, cols, x.vmax * y.vmax)
    assert col_bound < (1 << 32)
    return _solinas_reduce_k(s, cols, col_bound, x.vmax * y.vmax)


def ksquare(x: KFE) -> KFE:
    if _is_sym(x):
        return _out_of_line("sqr", _ksquare, x)
    return _ksquare(x)


def _ksquare(x: KFE) -> KFE:
    s = x.spec
    if not s.sq_symmetric:
        return _kmul(x, x)
    if x.bound > s.sq_in_bound:
        x = kcarry(x)
    n = len(x.limbs)
    acc = [None] * (2 * n - 1)

    def put(k, v):
        acc[k] = v if acc[k] is None else acc[k] + v

    for i in range(n):
        put(2 * i, x.limbs[i] * x.limbs[i])
        d = x.limbs[i] + x.limbs[i]
        for j in range(i + 1, n):
            put(i + j, d * x.limbs[j])
    col_bound = 2 * s.n_limbs * x.bound * x.bound
    if s.kind == "mont":
        assert (col_bound + s.n_limbs * (1 << (2 * s.limb_bits))
                + (1 << 21) < (1 << 32))
        return _mont_reduce_k(s, acc, x.vmax * x.vmax)
    assert col_bound < (1 << 32)
    return _solinas_reduce_k(s, acc, col_bound, x.vmax * x.vmax)


# ---------------------------------------------------------------------------
# RCB 2015 formulas on KFE (tpu_ecc pallas_kernels.py:39-225)
# ---------------------------------------------------------------------------

def _b3_mul_k(curve, t: KFE) -> KFE:
    b3 = (3 * curve.b) % curve.p
    if curve.field.kind == "solinas" and b3 < (1 << 14):
        return kmul_small(t, b3)
    return kmul(kfe_const(curve.field, b3, t.limbs[0]), t)


def _b_mul_k(curve, t: KFE) -> KFE:
    """b * t; b enters in the field's own encoding (Montgomery form on a
    Montgomery field, `kfe_const`)."""
    if curve.field.kind == "solinas" and curve.b < (1 << 14):
        return kmul_small(t, curve.b)
    return kmul(kfe_const(curve.field, curve.b, t.limbs[0]), t)


def _kadd_a0(c, X1, Y1, Z1, X2, Y2, Z2):
    """RCB 2015 Algorithm 7 (a = 0)."""
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)
    t0 = t0 + t0 + t0
    t2 = _b3_mul_k(c, t2)
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = _b3_mul_k(c, Y3)
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return X3, Y3, Z3


def _kadd_mixed_a0(c, X1, Y1, Z1, x2, y2):
    """RCB 2015 Algorithm 8 (a = 0, Z2 = 1)."""
    t0 = X1 * x2
    t1 = Y1 * y2
    t3 = (x2 + y2) * (X1 + Y1)
    t3 = t3 - (t0 + t1)
    t4 = y2 * Z1 + Y1
    Y3 = x2 * Z1 + X1
    t0 = t0 + t0 + t0
    t2 = _b3_mul_k(c, Z1)
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = _b3_mul_k(c, Y3)
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return X3, Y3, Z3


def _kdouble_a0(c, X, Y, Z):
    """RCB 2015 Algorithm 9 (a = 0)."""
    t0 = Y * Y
    Z3 = t0 + t0
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    t1 = Y * Z
    t2 = Z * Z
    t2 = _b3_mul_k(c, t2)
    X3 = t2 * Z3
    Y3 = t0 + t2
    Z3 = t1 * Z3
    t1 = t2 + t2
    t2 = t1 + t2
    t0 = t0 - t2
    Y3 = t0 * Y3
    Y3 = X3 + Y3
    t1 = X * Y
    X3 = t0 * t1
    X3 = X3 + X3
    return X3, Y3, Z3


def _kadd_am3(c, X1, Y1, Z1, X2, Y2, Z2):
    """RCB 2015 Algorithm 4 (a = -3)."""
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)
    Z3 = _b_mul_k(c, t2)
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = _b_mul_k(c, Y3)
    t1 = t2 + t2 + t2
    Y3 = Y3 - t1 - t0
    Y3 = Y3 + Y3 + Y3
    t0 = t0 + t0 + t0
    t0 = t0 - t1
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3 + t2
    X3 = t3 * X3 - t1
    Z3 = t4 * Z3 + t3 * t0
    return X3, Y3, Z3


def _kdouble_am3(c, X, Y, Z):
    """RCB 2015 Algorithm 6 (a = -3)."""
    t0 = X * X
    t1 = Y * Y
    t2 = Z * Z
    t3 = X * Y
    t3 = t3 + t3
    Z3 = X * Z
    Z3 = Z3 + Z3
    Y3 = _b_mul_k(c, t2)
    Y3 = Y3 - Z3
    X3 = Y3 + Y3
    Y3 = X3 + Y3
    X3 = t1 - Y3
    Y3 = t1 + Y3
    Y3 = X3 * Y3
    X3 = X3 * t3
    t2 = t2 + t2 + t2
    Z3 = _b_mul_k(c, Z3)
    Z3 = Z3 - t2 - t0
    Z3 = Z3 + Z3 + Z3
    t0 = t0 + t0 + t0
    t0 = t0 - t2
    t0 = t0 * Z3
    Y3 = Y3 + t0
    t0 = Y * Z
    t0 = t0 + t0
    Z3 = t0 * Z3
    X3 = X3 - Z3
    Z3 = t0 * t1
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    return X3, Y3, Z3


def _kadd_mixed_am3(c, X1, Y1, Z1, x2, y2):
    """RCB 2015 Algorithm 5 (a = -3, Z2 = 1)."""
    t0 = X1 * x2
    t1 = Y1 * y2
    t3 = (x2 + y2) * (X1 + Y1)
    t3 = t3 - (t0 + t1)
    t4 = y2 * Z1 + Y1
    Y3 = x2 * Z1 + X1
    Z3 = _b_mul_k(c, Z1)
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = _b_mul_k(c, Y3)
    t1 = Z1 + Z1 + Z1
    Y3 = Y3 - t1 - t0
    Y3 = Y3 + Y3 + Y3
    t0 = t0 + t0 + t0
    t0 = t0 - t1
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3 + t2
    X3 = t3 * X3 - t1
    Z3 = t4 * Z3 + t3 * t0
    return X3, Y3, Z3


_KADD = {"a0": _kadd_a0, "a_minus3": _kadd_am3}
_KADD_MIXED = {"a0": _kadd_mixed_a0, "a_minus3": _kadd_mixed_am3}
_KDOUBLE = {"a0": _kdouble_a0, "a_minus3": _kdouble_am3}


def has_formulas(curve) -> bool:
    """Whether this generator has `curve`'s point formulas: a = 0 and
    a = -3. The generic a's are on the plain and 32-bit layers only."""
    return curve.strategy in _KADD


def _formula(table: dict, curve):
    if not has_formulas(curve):
        raise NotImplementedError(
            f"{curve.name}: the {curve.strategy} formulas are not ported yet")
    return table[curve.strategy]


# ---------------------------------------------------------------------------
# the functions the kernels call: steady in, ksteady out
# ---------------------------------------------------------------------------

def _point(spec, flat):
    n = spec.n_limbs
    return [kfe_from_rows(spec, flat[c * n:(c + 1) * n]) for c in range(3)]


def _flat_steady(fes):
    return [r for fe in fes for r in ksteady(fe).limbs]


def padd(curve, a: list, b: list) -> list:
    """Complete add of two steady points (flat [3n] limb lists)."""
    f = curve.field
    return _flat_steady(_formula(_KADD, curve)(curve, *_point(f, a),
                                               *_point(f, b)))


def padd_mixed(curve, a: list, x: list, y: list) -> list:
    """Complete mixed add of a steady point (flat [3n]) and a steady affine
    point (x [n], y [n])."""
    f = curve.field
    return _flat_steady(_formula(_KADD_MIXED, curve)(
        curve, *_point(f, a), kfe_from_rows(f, x), kfe_from_rows(f, y)))


def pdouble(curve, a: list) -> list:
    f = curve.field
    return _flat_steady(_formula(_KDOUBLE, curve)(curve, *_point(f, a)))


def fe_mul(spec, x: list, y: list) -> list:
    return ksteady(kmul(kfe_from_rows(spec, x), kfe_from_rows(spec, y))).limbs


def fe_sqr(spec, x: list) -> list:
    return ksteady(ksquare(kfe_from_rows(spec, x))).limbs


def fe_neg(spec, x: list) -> list:
    return ksteady(kneg(kfe_from_rows(spec, x))).limbs


def fe_mul_beta(curve, x: list) -> list:
    """beta * X for the odd GLV terms. tpu_ecc's ladder uses the bare kmul
    product (pallas_kernels.py:991-992); its ledger equals the steady one,
    so the steady-input formulas that follow see the same ledger."""
    f = curve.field
    xk = kfe_from_rows(f, x)
    out = kmul(kfe_const(f, curve.glv["beta"], x[0]), xk)
    assert out.bound <= f.mask and out.vmax == f.carried_vmax
    return out.limbs


# ---------------------------------------------------------------------------
# numpy evaluation (the kernels' exact uint32 arithmetic on the CPU)
# ---------------------------------------------------------------------------

def evaluate(curve, name: str, *args) -> np.ndarray:
    """Run the generated function `name` of `curve` (see `function_table`)
    on uint32 arrays [k, B], one per parameter, and return uint32 [k_out, B]:
    the kernels' exact arithmetic on the CPU."""
    _, body = function_table(curve)[name]
    rows = [list(np.asarray(a, np.uint32)) for a in args]
    like = rows[0][0]
    return np.stack([np.broadcast_to(np.asarray(v, np.uint32), like.shape)
                     for v in body(*rows)], 0).astype(np.uint32)


# ---------------------------------------------------------------------------
# C generation
# ---------------------------------------------------------------------------

_PREAMBLE = """\
// Generated by tpu_ecc_torch/ops/kfe.py from the KFE bound ledger. Do not edit.
// Straight-line functions on uint32_t arrays in limb order (points: X, Y, Z).
// The kfe_<formula> functions take steady limbs and return ksteady limbs; each
// field multiply or square inside them is a call of its own kfe_mul_<k> or
// kfe_sqr_<k>, one per distinct input bound ledger.
#pragma once
#include <stdint.h>
#ifndef __CUDACC__
#define __host__
#define __device__
#define __noinline__ __attribute__((noinline))
#endif
"""


def _c_function(lib: dict, cname: str, params, body):
    """params: [(name, limb count)] of inputs; body(*input lists) -> outputs.
    Returns (C source, instruction counts by class); the multiplies
    it calls land in `lib`."""
    em = Emitter(lib)
    ins = [[Sym(em, name=f"{p}[{i}]") for i in range(cnt)] for p, cnt in params]
    return em.function(cname, params, body(*ins))


def _const_function(cname: str, limbs) -> str:
    body = "".join(f"  out[{i}] = {int(v)}u;\n" for i, v in enumerate(limbs))
    return (f"static __host__ __device__ void {cname}(uint32_t* __restrict__ out) "
            f"{{\n{body}}}\n")


def _field_functions(spec, pre: str) -> dict:
    """The multiply, square and negation of one field, named `<pre>_mul` etc."""
    n = spec.n_limbs
    return {f"{pre}_mul": ([("x", n), ("y", n)], lambda x, y: fe_mul(spec, x, y)),
            f"{pre}_sqr": ([("x", n)], lambda x: fe_sqr(spec, x)),
            f"{pre}_neg": ([("x", n)], lambda x: fe_neg(spec, x))}


def _fields(target) -> tuple:
    """(prefix, field spec) of each field of a curve, or of a bare field spec."""
    if isinstance(target, FieldSpec):
        return (("fp", target),)
    return (("fp", target.field), ("fn", target.scalar))


def function_table(target) -> dict:
    """Every generated function for `target`: name -> (params, body). A
    curve has the point formulas and both fields' functions; a bare field
    spec (no curve, such as the forced-Montgomery secp256k1 field of the
    multiply probes) only its own fp_mul, fp_sqr and fp_neg."""
    table = {}
    if not isinstance(target, FieldSpec):
        curve, nf = target, target.field.n_limbs
        table = {
            "padd": ([("a", 3 * nf), ("b", 3 * nf)], lambda a, b: padd(curve, a, b)),
            "padd_mixed": ([("a", 3 * nf), ("x", nf), ("y", nf)],
                           lambda a, x, y: padd_mixed(curve, a, x, y)),
            "pdouble": ([("a", 3 * nf)], lambda a: pdouble(curve, a)),
        }
    for pre, spec in _fields(target):
        table.update(_field_functions(spec, pre))
    if not isinstance(target, FieldSpec) and target.glv:
        table["fp_mul_beta"] = ([("x", nf)], lambda x: fe_mul_beta(curve, x))
    return table


def kernel_header(target, names) -> tuple[str, dict]:
    """C++ header for `target` (a curve, or a bare field spec) with the
    generated 13-bit functions `names` (no kernel includes it: their counts
    are the "kfe" design of the bounds), each named `kfe_<name>`, the limb counts
    KFE_FP_N (and for a curve KFE_FN_N), the base field's limb width
    KFE_FP_BITS, and each field's encoded one. Returns (source, {name:
    instruction counts by class})."""
    fields = _fields(target)
    kind = "field" if isinstance(target, FieldSpec) else "curve"
    parts = [_PREAMBLE, f"// {kind}: {target.name}\n",
             f"#define KFE_FP_BITS {fields[0][1].limb_bits}\n"]
    for pre, spec in fields:
        parts += [f"#define KFE_{pre.upper()}_N {spec.n_limbs}\n",
                  _const_function(f"kfe_{pre}_one",
                                  int_to_limbs(spec.encode_int(1), spec.n_limbs, spec.limb_bits))]
    table = function_table(target)
    lib, counts, tops = {}, {}, []
    for name in names:
        params, body = table[name]
        src, counts[name] = _c_function(lib, f"kfe_{name}", params, body)
        tops.append(src)
    parts += [src for _, src, _ in lib.values()] + tops
    return "".join(parts), counts


# ---------------------------------------------------------------------------
# the 32-bit field layer (csrc/fe32.cuh, csrc/point32.cuh): its per-curve
# constants and its instruction count
# ---------------------------------------------------------------------------

FE32_CLASSES = ("wide",) + INSTRUCTION_CLASSES
"""The 32-bit layer's instruction classes: `wide` is IMAD.WIDE.U32 (the
32 x 32 -> 64 multiply-add, on the FMA pipe), the others as
INSTRUCTION_CLASSES."""


def _words(v: int, n: int) -> list:
    return [(v >> (32 * i)) & _M32 for i in range(n)]


def fe32_words(spec: FieldSpec) -> int:
    """The 32-bit layer's word count for the field `spec`: N = ceil(bits(p)
    / 32), the curve's own (a curve's two fields have the same)."""
    return -(-spec.p.bit_length() // 32)


def _fold_bit(spec: FieldSpec, N: int) -> int:
    """C::KB: p's bit length for a solinas field below 2^(32N-1), whose
    values fold at p's top bit (csrc/fe32.cuh), else 0."""
    p = spec.p
    return p.bit_length() if spec.kind != "mont" and p < 1 << (32 * N - 1) else 0


def fe32_small_fits(spec: FieldSpec, k: int, n_words: int | None = None) -> bool:
    """Whether reduce_top takes t + h 2^(32N) for every h < k (mul_small by
    k, or a row load whose top word is below k): (k - 1) F < 2^(32N), k F
    <= 2^(32N), and a value below 2^(32N) reduces below 2p, because 2^(32N)
    < 2p or the field folds at its top bit (the carry analysis of
    csrc/fe32.cuh)."""
    N = fe32_words(spec) if n_words is None else n_words
    W = 1 << (32 * N)
    F = W % spec.p
    below = W < 2 * spec.p or _fold_bit(spec, N) != 0
    return below and (k - 1) * F < W and k * F <= W


def _rows_top(spec: FieldSpec, N: int) -> int:
    """The largest top word h of a 13-bit row at N words: the row's NL LB
    bits above the low 32N."""
    return ((1 << (spec.n_limbs * spec.limb_bits)) - 1) >> (32 * N)


@functools.lru_cache(maxsize=None)
def fe32_fits(spec: FieldSpec, n_words: int | None = None) -> str:
    """Why the 32-bit layer at N words (default the field's own,
    `fe32_words`) cannot take the field `spec`, or "" where it can: the
    layer needs an odd p with 2^(32N-32) < p < 2^(32N) and a 13-bit row
    whose bits above the low 32N fit one word; a solinas field loads its
    rows through reduce_top, needs p = 2^k - 1 where p < 2^(32N-1) (the
    fold at p's top bit) and otherwise an F = 2^(32N) mod p that folds
    twice within N words; a Montgomery field takes any such p (CIOS, and
    the load mont(lo, to32) + mont(to32h, h) where reduce_top cannot take
    the row). The carry analysis of csrc/fe32.cuh."""
    p = spec.p
    N = fe32_words(spec) if n_words is None else n_words
    W = 1 << (32 * N)
    if not (p % 2 and W >> 32 < p < W):
        return (f"{spec.name}: the 32-bit layer at N = {N} takes an odd "
                f"2^{32 * N - 32} < p < 2^{32 * N}")
    NL, LB = spec.n_limbs, spec.limb_bits
    if NL * LB > 32 * (N + 1):
        return (f"{spec.name}: a 13-bit row's {NL * LB} bits exceed the {32 * (N + 1)} "
                "of N + 1 words")
    if spec.kind == "mont":
        return ""
    F = W % p
    FW = -(-F.bit_length() // 32)
    KB = _fold_bit(spec, N)
    if KB and (p != (1 << KB) - 1 or KB % 32 == 0 or 2 ** (32 * N - KB) > p - 1):
        return (f"{spec.name}: a solinas p below 2^{32 * N - 1} must be 2^k - 1 (k not a "
                "multiple of 32) for the 32-bit layer's fold at p's top bit")
    if not fe32_small_fits(spec, _rows_top(spec, N) + 1, N):
        return f"{spec.name}: a loaded 13-bit row overflows the 32-bit layer's reduce_top"
    if not KB and not (F * (F + 1) <= W and 2 * FW - 1 <= N):
        return f"{spec.name}: 2^{32 * N} mod p is too wide for the 32-bit layer's solinas fold"
    return ""


def fe32_field_constants(spec: FieldSpec) -> dict:
    """The 32-bit layer's constants of one field, solinas or Montgomery in
    the 13-bit plan, at the field's word count N (`fe32_words`):
    p, F = 2^(32N) mod p in FW words, the fold bit KB (p = 2^KB - 1 for a
    solinas p below 2^(32N-1), else 0), the domain (Montgomery with R32 =
    2^(32N) where the 13-bit plan is Montgomery: N0 = -p^-1 mod 2^32 and
    the maps to and from the plan's R13), the load form (MLOAD: mont(lo,
    to32) + mont(to32h, h) for a Montgomery field whose rows reduce_top
    cannot take), one in the domain, and the 13-bit rows' limb plan (NL
    limbs of LB bits). Raises NotImplementedError for a field the layer
    cannot take (`fe32_fits`)."""
    why = fe32_fits(spec)
    if why:
        raise NotImplementedError(why)
    p, N = spec.p, fe32_words(spec)
    W = 1 << (32 * N)
    mont = spec.kind == "mont"
    F = W % p
    FW = -(-F.bit_length() // 32)
    mload = mont and not fe32_small_fits(spec, _rows_top(spec, N) + 1, N)
    # mont(v, R32^2 R13^-1) = v R13^-1 R32; mont(x, R13) = x R32^-1 R13
    to32 = F * F * pow(spec.W, -1, p) % p if mont else 0
    return {
        "N": N, "NL": spec.n_limbs, "LB": spec.limb_bits, "FW": FW, "KB": _fold_bit(spec, N),
        "MONT": mont, "MLOAD": mload,
        "N0": (-pow(p, -1, 1 << 32)) % (1 << 32),
        "p": _words(p, N), "f": _words(F, FW), "one": _words(_fe32_enc(spec, N, 1), N),
        "to32": _words(to32, N), "to32h": _words(F * to32 % p if mload else 0, N),
        "to13": _words(spec.W % p if mont else 0, N),
    }


def _fe32_enc(spec: FieldSpec, N: int, v: int) -> int:
    """v in the 32-bit layer's domain: v R32 mod p (Montgomery) or v mod p."""
    return v * (1 << (32 * N)) % spec.p if spec.kind == "mont" else v % spec.p


def fe32_constants(curve) -> dict:
    """The constants of the 32-bit layer for `curve`, at its word count: its
    base field's (`fe32_field_constants`) and the curve's own, with the
    carry analysis of csrc/fe32.cuh checked for them: which formulas
    csrc/point32.cuh runs (A0: a = 0, RCB Algorithms 7-9; AGEN: generic
    a, Algorithms 1-3; neither: a = -3, Algorithms 4-6), the formula's b
    multiplier in the domain (3b for a = 0 and generic a, b for a = -3;
    BSMALL where it fits mul_small), a in the domain (`amul`, which only
    the generic formulas multiply by), and the GLV beta in the domain
    where the curve has an endomorphism (HAS_BETA). Raises
    NotImplementedError for a field the layer cannot take."""
    f = curve.field
    k = fe32_field_constants(f)
    N, p = k["N"], f.p
    b_plain = (curve.b if curve.strategy == "a_minus3" else 3 * curve.b) % p
    bsmall = b_plain if b_plain < (1 << 16) and fe32_small_fits(f, b_plain, N) else 0
    return {
        **k, "A0": curve.strategy == "a0", "AGEN": curve.strategy == "generic",
        "BSMALL": bsmall,
        "bmul": _words(_fe32_enc(f, N, b_plain), N), "HAS_BETA": bool(curve.glv),
        "amul": _words(_fe32_enc(f, N, curve.a), N),
        "beta": _words(_fe32_enc(f, N, curve.glv["beta"]) if curve.glv else 0, N),
    }


def _word_function(name: str, words) -> str:
    chain = "".join(f"i == {i} ? 0x{w:08x}u : " for i, w in enumerate(words))
    return (f"  static __host__ __device__ constexpr uint32_t {name}(int i) {{\n"
            f"    return {chain}0u;\n  }}\n")


def _traits(name: str, k: dict) -> str:
    """A traits class of csrc/fe32.cuh: the constants in `k` (each word
    array a constexpr function of the word index, folded where the layer's
    loops are unrolled)."""
    def has(names):
        return [n for n in names if n in k]

    ints = "".join(f"  static constexpr int {n} = {k[n]};\n"
                   for n in ("N", "NL", "LB", "FW", "KB"))
    flags = "".join(f"  static constexpr bool {n} = {str(k[n]).lower()};\n"
                    for n in has(("MONT", "MLOAD", "A0", "AGEN", "HAS_BETA")))
    words = "".join(f"  static constexpr uint32_t {n} = 0x{k[n]:08x}u;\n"
                    for n in has(("N0", "BSMALL")))
    funcs = "".join(_word_function(n, k[n])
                    for n in has(("p", "f", "one", "bmul", "amul", "beta", "to32", "to32h",
                                  "to13")))
    return f"struct {name} {{\n{ints}{flags}{words}{funcs}}};\n"


def fe32_header(curve, fields_only: bool = False) -> str:
    """The generated header of a kernel on the 32-bit layer: the traits
    classes that csrc/fe32.cuh and csrc/point32.cuh take, `Curve32` (the
    base field and the curve, `fe32_constants`) and `Scalar32` (the scalar
    field, `fe32_field_constants`). With `fields_only` (`pow`'s header,
    which runs no point formula) `Curve32` holds the base field's
    constants alone, so that it needs no more of the curve than its two
    fields. Both classes are at the curve's word count: its two fields
    have the same (`fe32_words`)."""
    assert fe32_words(curve.field) == fe32_words(curve.scalar), curve.name
    base = fe32_field_constants(curve.field) if fields_only else fe32_constants(curve)
    return ("// Generated by tpu_ecc_torch/ops/kfe.py (fe32_header). Do not edit.\n"
            f"// The 32-bit field layer's constants for {curve.name}.\n"
            "#pragma once\n#include <stdint.h>\n"
            "#ifndef __CUDACC__\n#ifndef __host__\n#define __host__\n#endif\n"
            "#ifndef __device__\n#define __device__\n#endif\n#endif\n"
            + _traits("Curve32", base)
            + _traits("Scalar32", fe32_field_constants(curve.scalar)))


def fe32_field_header(spec: FieldSpec) -> str:
    """The generated header of a kernel on the 32-bit layer built for a bare
    field (csrc/fmul_chain.cu, csrc/mxu_chain.cu): one traits class,
    `Field32`, of `fe32_field_constants(spec)`, at the field's word count. A
    bare field may belong to no curve (the probes' `k256mxu.fp`,
    secp256k1's p forced onto Montgomery)."""
    return ("// Generated by tpu_ecc_torch/ops/kfe.py (fe32_field_header). Do not edit.\n"
            f"// The 32-bit field layer's constants for the field {spec.name}.\n"
            "#pragma once\n#include <stdint.h>\n"
            "#ifndef __CUDACC__\n#ifndef __host__\n#define __host__\n#endif\n"
            "#ifndef __device__\n#define __device__\n#endif\n#endif\n"
            + _traits("Field32", fe32_field_constants(spec)))


class _Tally:
    """Instruction counts by FE32_CLASSES, added up by the mirrors of the
    header's functions in `fe32_counts`."""

    def __init__(self):
        self.c = dict.fromkeys(FE32_CLASSES, 0)

    def __call__(self, **kw) -> "_Tally":
        for k, v in kw.items():
            self.c[k] += v
        return self

    def mac(self, k=None, addends: int = 2) -> None:
        """One `mac(a, k, r, c)`: a multiplier k (None where it is a
        variable) and how many of r, c may be nonzero. A product is one
        IMAD.WIDE.U32, which adds one 64-bit addend; a second addend is one
        add. A constant 0 needs an add; a power of two or 2^32 - 1 no
        multiply, a shift or (a << 32) - a in two instructions."""
        if k == 0:
            self(other=1)
        elif k is not None and (k & (k - 1) == 0 or k == _M32):
            self(other=2)
        else:
            self(wide=1, other=max(0, addends - 1))


_POINT32 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "csrc", "point32.cuh")
_FE32_CALL = re.compile(r"\b(mul_a|mul_b|mul|add|sub)<C>\(")
_FE32_SUFFIX = {"a0": "a0", "a_minus3": "am3", "generic": "gen"}
FE32_POINT_FNS = ("padd", "padd_mixed", "pdouble")
"""The point formulas of csrc/point32.cuh, each with a body per strategy
(`padd_a0`, `padd_am3`, `padd_gen`, ...)."""


def fe32_point_ops(fn: str, strategy: str) -> dict:
    """{mul, mul_a, mul_b, add, sub: calls} in the body of the point
    formula `fn` (FE32_POINT_FNS) for `strategy` (csrc/point32.cuh
    `<fn>_a0`, `<fn>_am3` or `<fn>_gen`), read from the header. A multiply
    by a (`mul_a`) is a full `mul` by a constant, as `mul_b` is where b
    does not fit mul_small; each keeps its own class, so that the count
    shows which constant a formula multiplies by."""
    name = f"{fn}_{_FE32_SUFFIX[strategy]}"
    with open(_POINT32) as fh:
        text = fh.read()
    body = re.search(r"FE32_FN Pt<C> %s\(.*?\) \{\n(.*?)\n\}" % name, text, re.S)
    if body is None:
        raise ValueError(f"{_POINT32}: no {name} body")
    ops = dict.fromkeys(("mul", "mul_a", "mul_b", "add", "sub"), 0)
    for op in _FE32_CALL.findall(body.group(1)):
        ops[op] += 1
    return ops


def fe32_counts(target) -> dict:
    """The instructions each function of the 32-bit layer needs at least, by
    class (FE32_CLASSES), counted from the structure of csrc/fe32.cuh and
    csrc/point32.cuh with the constants of `target`, a curve (its base
    field and its formulas) or a field spec (a field alone, such as a
    curve's scalar field): one instruction per word of an add, subtract or
    select, one IMAD.WIDE.U32 per product (plus an add where it has a
    second addend), none for a multiply by a constant 0, a power of two or
    2^32 - 1, by N0 = 1 or by a word of all ones masked (see
    `_Tally.mac`), and one shift-add (LEA) per limb part packed or one
    funnel shift and one AND per limb unpacked. Returns {name: counts} for
    add, sub, neg, mul, sqr, load (a 13-bit element to the domain) and
    store (back); for a curve also mul_a, mul_b, mul_beta, cneg (y or p - y),
    pselect (a point's select), select_point and select_affine (an entry
    of 9 points or 9 affine points, a compare and a select of each word
    for each entry but the first), and the point formulas FE32_POINT_FNS."""
    curve = None if isinstance(target, FieldSpec) else target
    k = fe32_field_constants(target) if curve is None else fe32_constants(curve)
    N, FW, NL, LB = k["N"], k["FW"], k["NL"], k["LB"]
    P, Fw = k["p"], k["f"]

    def reduce_once(t):
        t(other=N, alu=1 + N)              # subtract p, the flag, the selects

    def add(t):
        t(other=N)
        reduce_once(t)

    def sub(t):
        masked = sum(1 for w in P if w not in (0, _M32))
        t(other=2 * N + 1, alu=masked)     # a - b, the mask, + (p & mask)

    def fold(t):
        for w in Fw:
            t.mac(w, addends=2)
        t(other=N - FW)

    KW = k["KB"] // 32

    def reduce_below(t):
        if k["KB"]:                         # the top fold: a funnel shift a word of
            t(other=2 * N - KW, alu=1)      # v >> KB, the mask, the add
        reduce_once(t)

    def reduce_top(t):
        fold(t)
        fold(t)
        reduce_below(t)

    def mul_wide(t):
        for i in range(N):
            for j in range(N):
                t.mac(None, addends=(i > 0) + (j > 0))

    def reduce_solinas(t):
        for j in range(FW):
            for _ in range(N):
                t.mac(Fw[j], addends=2)
            t(other=FW - j)
        for j in range(FW):
            for _ in range(FW):
                t.mac(Fw[j], addends=2)
            t(other=N - FW - j + 1)
        fold(t)
        reduce_once(t)

    def reduce_mont(t):
        # CIOS's reduction rows (interleaved with the product rows in
        # fe32.cuh; the count is the same): m = t0 N0, then m p added
        for _ in range(N):
            t(other=1, imad=int(k["N0"] != 1))
            for j in range(N):
                t.mac(P[j], addends=2)
            t(other=2)
        reduce_once(t)

    def mul_mont(t):
        mul_wide(t)
        reduce_mont(t)

    def sqr_wide(t):
        # the cross products a_i a_j (i < j) once, their 2N-word sum doubled
        # (a funnel shift a word), then the diagonal a_i^2 added
        for i in range(N):
            for j in range(i + 1, N):
                t.mac(None, addends=(i > 0) + (j > i + 1))
        t(other=2 * N)
        for _ in range(N):
            t.mac(None, addends=2)

    def reduce_mersenne(t):
        t(other=2 * N, alu=1)               # T >> KB a funnel shift a word, the add
        reduce_below(t)

    def mont_word(t):
        # one product row (N products), then CIOS's N reduction rows
        for j in range(N):
            t.mac(None, addends=int(j > 0))
        reduce_mont(t)

    reduce = reduce_mont if k["MONT"] else reduce_mersenne if k["KB"] else reduce_solinas

    def mul(t):
        mul_wide(t)
        reduce(t)

    def sqr(t):
        # what a squaring needs: N(N+1)/2 products, the reduction as mul's
        # (csrc/fe32.cuh's sqr is mul(a, a), N^2 products)
        sqr_wide(t)
        reduce(t)

    def mul_b(t):
        if k["BSMALL"]:
            t(wide=N)
            reduce_top(t)
        else:
            mul(t)

    def load(t):
        filled = set()
        for i in range(NL):
            w, off = divmod(i * LB, 32)
            if off or w in filled:
                t(other=1)
            filled.add(w)
            if off + LB > 32:
                t(other=1)
                filled.add(w + 1)
        if k["MLOAD"]:                      # mont(lo, to32) + mont(to32h, h)
            mul_mont(t)
            if NL * LB > 32 * N:
                mont_word(t)
                add(t)
            return
        reduce_top(t)
        if k["MONT"]:
            mul_mont(t)

    def store(t):
        if k["MONT"]:
            mul_mont(t)
        t(other=sum(1 for i in range(NL) if (i * LB) % 32), alu=NL)

    def cneg(t):
        sub(t)
        t(alu=N)

    fns = {"add": add, "sub": sub, "neg": sub, "mul": mul, "sqr": sqr, "load": load,
           "store": store}
    if curve is not None:
        fns.update({"mul_a": mul, "mul_b": mul_b, "mul_beta": mul, "cneg": cneg,
                    "pselect": lambda t: t(alu=3 * N),
                    "select_point": lambda t: t(alu=8 * (1 + 3 * N)),
                    "select_affine": lambda t: t(alu=8 * (1 + 2 * N))})
    out = {}
    for name, fn in fns.items():
        t = _Tally()
        fn(t)
        out[name] = t.c
    if curve is None:
        return out
    for name in FE32_POINT_FNS:
        t = _Tally()
        for op, times in fe32_point_ops(name, curve.strategy).items():
            t(**{c: times * v for c, v in out[op].items()})
        out[name] = t.c
    return out

