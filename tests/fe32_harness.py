"""The host harness of the 32-bit field layer's tests (tests/test_torch_fe32.py,
tests/test_torch_fe32_wide.py): a C++ program on the real
tpu_ecc_torch/csrc/fe32.cuh and point32.cuh, built with g++ at -O0 against a
curve's generated header (kfe.fe32_header), that runs the field operations,
the boundary converters and the kernels' per-lane bodies on uint32 arrays
from stdin; and the helpers that make its inputs and read its outputs.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "kfe_fe32.cuh"
#include "point32.cuh"
using C = Curve32;
using namespace fe32;
typedef std::vector<uint32_t> V;
static V rd(size_t n) {
  V v(n);
  if (n && fread(v.data(), 4, n, stdin) != n) exit(4);
  return v;
}
static void wr(const V& v) { fwrite(v.data(), 4, v.size(), stdout); }
// pow on field T (Curve32 or Scalar32): x [NL, B], digits [ndig] -> out;
// blocks of TL lanes share a table buffer, as the kernel's shared memory
template <class T>
static void run_pow(size_t n, int ndig, size_t TL) {
  V x = rd(T::NL * n), dig = rd(ndig), out(T::NL * n), tbl(15 * T::N * TL, 0xFFFFFFFFu);
  for (size_t l = 0; l < n; ++l)
    pow_lane<T>(x.data(), out.data(), &tbl[l % TL], (uint32_t)TL, dig.data(), ndig, (int)n,
                (int)l);
  wr(out);
}
// the field modes on field T (Curve32, or Scalar32 with the prefix "s_"):
// N words a lane in (two operands for add, sub, mul), N words out; load:
// NL limbs a lane -> N words; store: N words -> NL limbs
template <class T>
static int run_field(const char* m, size_t n, char** argv) {
  const size_t N = T::N, NL = T::NL;
  auto el = [&](const uint32_t* p) {
    E<T> r;
    for (size_t i = 0; i < N; ++i) r.w[i] = p[i];
    return r;
  };
  if (!strcmp(m, "load")) {
    V in = rd(NL * n), out(N * n);
    for (size_t l = 0; l < n; ++l) {
      const E<T> x = from_limbs<T>(&in[l * NL], 1);
      for (size_t i = 0; i < N; ++i) out[l * N + i] = x.w[i];
    }
    wr(out);
    return 0;
  }
  if (!strcmp(m, "store")) {
    V in = rd(N * n), out(NL * n);
    for (size_t l = 0; l < n; ++l) to_limbs<T>(el(&in[l * N]), &out[l * NL], 1);
    wr(out);
    return 0;
  }
  const bool binary = !strcmp(m, "add") || !strcmp(m, "sub") || !strcmp(m, "mul");
  V in = rd((binary ? 2 : 1) * N * n), out(N * n);
  for (size_t l = 0; l < n; ++l) {
    const E<T> a = el(&in[l * N]), b = binary ? el(&in[(n + l) * N]) : a;
    E<T> r;
    if (!strcmp(m, "add")) r = add<T>(a, b);
    else if (!strcmp(m, "sub")) r = sub<T>(a, b);
    else if (!strcmp(m, "mul")) r = mul<T>(a, b);
    else if (!strcmp(m, "neg")) r = neg<T>(a);
    else if (!strcmp(m, "sqr")) r = sqr<T>(a);
    else if (!strcmp(m, "mul_small")) r = mul_small<T>(a, (uint32_t)atoi(argv[3]));
    else if (!strcmp(m, "mul_b")) r = mul_b<C>(a);
    else if (!strcmp(m, "mul_a")) r = mul_a<C>(a);
    else if (!strcmp(m, "mul_beta")) r = mul_beta<C>(a);
    else return 3;
    for (size_t i = 0; i < N; ++i) out[l * N + i] = r.w[i];
  }
  wr(out);
  return 0;
}
// ladder_probe variant K: bases [3, NL, B], mag, neg [nw, 2, B] -> out;
// blocks of TL lanes share a table buffer, as the kernel's shared memory
template <int K>
static void run_probe(size_t n, int nw, size_t TL) {
  V bases = rd(3 * C::NL * n), mag = rd(nw * 2 * n), neg = rd(nw * 2 * n),
    out(3 * C::NL * n), tbl(TBL * 3 * C::N * TL, 0xFFFFFFFFu);
  for (size_t l = 0; l < n; ++l)
    ladder_probe_lane<C, K>(bases.data(), mag.data(), neg.data(), out.data(), &tbl[l % TL],
                            (uint32_t)TL, nw, (int)n, (int)l);
  wr(out);
}
// harness <mode> <lanes> [args]: uint32 arrays in on stdin, out on stdout
int main(int argc, char** argv) {
  if (argc < 3) return 2;
  const char* m = argv[1];
  const size_t n = (size_t)atoi(argv[2]);
  const size_t N = C::N, NL = C::NL, PN = 3 * C::NL;
  if (!strcmp(m, "chain")) {  // chain B repeat: a, b [3, NL, B] -> out
    const int repeat = atoi(argv[3]);
    V a = rd(PN * n), b = rd(PN * n), out(PN * n);
    for (size_t l = 0; l < n; ++l)
      padd_chain_lane<C>(a.data(), b.data(), out.data(), (int)n, (int)l, repeat);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "segscan")) {  // segscan L C nbuck signed
    const int rows = atoi(argv[3]), sg = atoi(argv[5]);
    const uint32_t nbuck = (uint32_t)atoi(argv[4]);
    V key = rd(rows * n), val = rd(rows * PN * n), neg = rd(sg ? rows * n : 0);
    V scanned(rows * PN * n, 0xFFFFFFFFu), last(n), tail(PN * n), lead(PN * n, 0xFFFFFFFFu);
    for (size_t l = 0; l < n; ++l)
      segscan_lane<C>(key.data(), val.data(), sg ? neg.data() : nullptr, scanned.data(),
                      last.data(), tail.data(), lead.data(), rows, (int)n, nbuck, (int)l);
    wr(scanned), wr(last), wr(tail), wr(lead);
    return 0;
  }
  if (!strcmp(m, "double") || !strcmp(m, "mixed")) {  // a [3, NL, B] (x, y [2, NL, B])
    V a = rd(PN * n), xy = rd(!strcmp(m, "mixed") ? 2 * NL * n : 0), out(PN * n);
    for (size_t l = 0; l < n; ++l) {
      const Pt<C> p = load_point<C>(&a[l], (uint32_t)n);
      store_point<C>(xy.empty() ? pdouble<C>(p)
                                : padd_mixed<C>(p, from_limbs<C>(&xy[l], (uint32_t)n),
                                                from_limbs<C>(&xy[NL * n + l], (uint32_t)n)),
                     &out[l], (uint32_t)n);
    }
    wr(out);
    return 0;
  }
  if (!strcmp(m, "ladder")) {  // ladder B T H nw glv TL: blocks of TL lanes share a table
    const int T = atoi(argv[3]), H = atoi(argv[4]), nw = atoi(argv[5]), glv = atoi(argv[6]);
    const size_t TL = (size_t)atoi(argv[7]);
    V bases = rd(T * PN * n), mag = rd(nw * H * n), neg = rd(nw * H * n), out(PN * n);
    V tbl(T * TBL * 3 * N * TL, 0xFFFFFFFFu);
    for (size_t l = 0; l < n; ++l)
      ladder_lane<C>(bases.data(), mag.data(), neg.data(), out.data(), &tbl[l % TL],
                     (uint32_t)TL, T, H, nw, glv != 0, (int)n, (int)l);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "probe")) {  // probe B nw variant TL
    const int nw = atoi(argv[3]), v = atoi(argv[4]);
    const size_t TL = (size_t)atoi(argv[5]);
    if (v == PROBE_BARE) run_probe<PROBE_BARE>(n, nw, TL);
    else if (v == PROBE_UNROLL) run_probe<PROBE_UNROLL>(n, nw, TL);
    else if (v == PROBE_BUILD) run_probe<PROBE_BUILD>(n, nw, TL);
    else if (v == PROBE_SELECT) run_probe<PROBE_SELECT>(n, nw, TL);
    else if (v == PROBE_NEGATE) run_probe<PROBE_NEGATE>(n, nw, TL);
    else return 3;
    return 0;
  }
  if (!strcmp(m, "genmul")) {  // genmul B nw threads: the prologue by `threads` threads
    const int nw = atoi(argv[3]), threads = atoi(argv[4]), coords = nw * TBL * 2;
    V tbl = rd(coords * NL), mag = rd(nw * n), neg = rd(nw * n), out(PN * n);
    V ctab(coords * N, 0xFFFFFFFFu);
    for (int t = 0; t < threads; ++t) genmul_table<C>(tbl.data(), ctab.data(), coords, t, threads);
    for (size_t l = 0; l < n; ++l)
      genmul_lane<C>(ctab.data(), mag.data(), neg.data(), out.data(), nw, (int)n, (int)l);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "bucket")) {  // bucket total nbuck drop0: the launch's steps, rows -> rows
    const uint32_t nb = (uint32_t)atoi(argv[3]), total = (uint32_t)n, groups = total / nb;
    const bool drop0 = atoi(argv[4]) != 0;
    V rows = rd(PN * n), out(PN * groups);
    V bufs[2] = {V(3 * N * n, 0xFFFFFFFFu), V(3 * N * n, 0xFFFFFFFFu)};
    const uint32_t* src = rows.data();
    int k = 0;
    for (uint32_t s = 1; s < nb; s *= 2, ++k) {
      uint32_t* dst = bufs[k & 1].data();
      for (uint32_t b = 0; b < total; ++b) {
        if (s == 1) bucket_suffix_lane<C, true>(src, dst, s, nb, total, b);
        else bucket_suffix_lane<C, false>(src, dst, s, nb, total, b);
      }
      src = dst;
    }
    for (uint32_t width = nb; width > 1; width /= 2, ++k) {
      const uint32_t len = groups * width;
      const bool z = drop0 && width == nb;
      uint32_t* dst = width == 2 ? out.data() : bufs[k & 1].data();
      for (uint32_t t = 0; t < len / 2; ++t) {
        if (width == 2) bucket_pair_lane<C, true>(src, dst, width, len, z, t);
        else bucket_pair_lane<C, false>(src, dst, width, len, z, t);
      }
      src = dst;
    }
    wr(out);
    return 0;
  }
  if (!strcmp(m, "fixup")) {  // fixup lanes L: t_l, last_key, first_key, lead -> out
    const uint32_t L = (uint32_t)atoi(argv[3]), lanes = (uint32_t)n;
    V t = rd(PN * n), lk = rd(n), fk = rd(n), lead = rd(PN * n), out(PN * n);
    V bufs[2] = {V(3 * N * n, 0xFFFFFFFFu), V(3 * N * n, 0xFFFFFFFFu)};
    const uint32_t* src = t.data();
    int k = 0;
    for (uint32_t s = 1; s < L; s *= 2, ++k) {  // the launch's steps
      uint32_t* dst = bufs[k & 1].data();
      for (uint32_t l = 0; l < lanes; ++l) {
        if (s == 1) fixup_step_lane<C, true>(src, dst, lk.data(), s, L, lanes, l);
        else fixup_step_lane<C, false>(src, dst, lk.data(), s, L, lanes, l);
      }
      src = dst;
    }
    for (uint32_t l = 0; l < lanes; ++l)
      fixup_final_lane<C>(src, lk.data(), fk.data(), lead.data(), out.data(), L, lanes, l);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "horner")) {  // horner 1 nw w: s_all [nw, 3, NL] -> [3, NL]
    const int nw = atoi(argv[3]), w = atoi(argv[4]);
    V s_all = rd(nw * PN), out(PN);
    horner_lane<C>(s_all.data(), out.data(), nw, w);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "pow")) {  // pow B field ndig TL
    const int field = atoi(argv[3]), ndig = atoi(argv[4]);
    const size_t TL = (size_t)atoi(argv[5]);
    if (field == 0) run_pow<Curve32>(n, ndig, TL);
    else run_pow<Scalar32>(n, ndig, TL);
    return 0;
  }
  if (!strncmp(m, "s_", 2)) return run_field<Scalar32>(m + 2, n, argv);
  return run_field<Curve32>(m, n, argv);
}
"""


def compile_harness(cname: str, d: pathlib.Path):
    """Start g++ on the harness for curve `cname` in directory d (-O0).
    Returns (the executable's path, the g++ process)."""
    gxx = shutil.which("g++")
    d.mkdir(parents=True, exist_ok=True)
    (d / "kfe_fe32.cuh").write_text(kfe.fe32_header(get_curve(cname)))
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    cmd = [gxx, "-O0", "-std=c++17", "-I", str(d), "-I", kernels.CSRC, "-o", str(exe),
           str(d / "harness.cpp")]
    return exe, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def runner(exe):
    """run(mode, lanes, *args, arrays=[...]) -> uint32 words, on the built
    harness `exe`."""
    def run(mode, lanes, *args, arrays):
        data = b"".join(np.ascontiguousarray(a, np.uint32).tobytes() for a in arrays)
        res = subprocess.run([str(exe), mode, str(lanes), *map(str, args)],
                             input=data, capture_output=True, check=True)
        return np.frombuffer(res.stdout, np.uint32)

    return run


# ---------------------------------------------------------------------------
# integers, words and limbs
# ---------------------------------------------------------------------------

def _to_words(vals, n):
    """ints -> uint32 [lanes, n] (lane-major, as the harness's field modes)."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)] for v in vals], np.uint32)


def _from_words(arr):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in arr]


def _limb_ints(limbs, bits, axis=0):
    """Little-endian limbs along `axis` -> the integers (numpy object array)."""
    a = np.moveaxis(np.asarray(limbs), axis, 0).astype(object)
    acc = np.zeros(a.shape[1:], object)
    for i in reversed(range(a.shape[0])):
        acc = acc * (1 << bits) + a[i]
    return acc


def _mod_p(curve, limbs, axis):
    """Coordinates' integers mod p of limb arrays (limb axis `axis`)."""
    return _limb_ints(limbs, curve.field.limb_bits, axis) % curve.p


def _canonical(curve, limbs, axis):
    """The limbs are below 2^13 and the integers below p."""
    f = curve.field
    assert int(np.asarray(limbs).max()) <= f.mask
    assert (_limb_ints(limbs, f.limb_bits, axis) < f.p).all()


def _domain(curve):
    """(R32 or 1, R13 or 1): the layer's and the 13-bit plan's Montgomery R."""
    f = curve.field
    if f.kind != "mont":
        return 1, 1
    return 1 << (32 * kfe.fe32_words(f)), f.W


def _steady_top(spec):
    """The largest steady value: carried_vmax (solinas: every limb at the
    mask, 2^260 - 1) or 4p - 1 (Montgomery)."""
    return spec.carried_vmax if spec.kind == "solinas" else 4 * spec.p - 1


def _affine_pairs(curve, B=16):
    """(a, b) affine pairs, None for O: O + O, P + O, O + P, P + P,
    P + (-P), then random pairs."""
    rng = np.random.default_rng(4)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 2 * B)]
    a, b = pts[:B], pts[B:]
    a[0] = b[0] = None
    b[1] = None
    a[2] = None
    b[3] = a[3]
    b[4] = (a[4][0], curve.p - a[4][1])
    return a, b


def _steady_limbs(curve, pts, rng):
    """Steady projective limbs uint32 [3, n, B] of affine points with random
    representatives: X, Y scaled by a random Z, each coordinate plus a
    random multiple of p that stays steady."""
    f = curve.field
    top = _steady_top(f)
    coords = [[], [], []]
    for pt in pts:
        if pt is None:
            xyz = (0, 1, 0)
        else:
            z = int(rng.integers(1, 2**62))
            xyz = (pt[0] * z % curve.p, pt[1] * z % curve.p, z)
        for c, v in zip(coords, xyz):
            v = f.encode_int(v)
            c.append(v + int(rng.integers(0, (top - v) // f.p + 1)) * f.p)
    return np.stack([ints_to_limbs_np(c, f.n_limbs, f.limb_bits) for c in coords], 0)


def _affine_of(curve, limbs):
    """Steady point limbs [3, n, B] -> [(x, y) or None for O]."""
    x, y, inf = P.to_affine(P.point_from_limbs(curve, torch.from_numpy(limbs.astype(np.int64))))
    return [None if i else (xv, yv) for xv, yv, i in
            zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())]


def _affine_limbs(curve, pts, rng):
    """Steady limbs uint32 [2, n, B] of affine points (x, y) in the field's
    encoding, each plus a random multiple of p that stays steady."""
    f = curve.field
    top = _steady_top(f)
    coords = [[], []]
    for pt in pts:
        for c, v in zip(coords, pt):
            v = f.encode_int(v)
            c.append(v + int(rng.integers(0, (top - v) // f.p + 1)) * f.p)
    return np.stack([ints_to_limbs_np(c, f.n_limbs, f.limb_bits) for c in coords], 0)


def _host_sum(curve, terms):
    """sum k * P over (k, P or None) by the host oracle."""
    acc = None
    for k, pt in terms:
        acc = H.aff_add(curve, acc, H.aff_mul(curve, k, pt))
    return acc
