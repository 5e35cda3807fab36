"""The host harness of the 32-bit field layer's tests (tests/test_torch_fe32.py,
tests/test_torch_fe32_wide.py): a C++ program on the real
tpu_ecc_torch/csrc/fe32.cuh and point32.cuh, built with g++ at -O0 against a
curve's generated header (kfe.fe32_header), that runs the field operations,
the boundary converters and the kernels' per-lane bodies on uint32 arrays
from stdin; and the helpers that make its inputs and read its outputs.
"""

import hashlib
import os
import pathlib
import shlex
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


HARNESS_CACHE = pathlib.Path(kernels.BUILD_DIR).parent / "harness"
"""Built harnesses, one directory a curve and content hash, so that the
test files that build the same curve's harness (tests/test_torch_fe32_wide.py
and the MSM bodies' file) build it once a checkout."""


def compile_harness(cname: str, d: pathlib.Path):
    """Start g++ on the harness for curve `cname` in directory d (-O0), or
    take the one HARNESS_CACHE holds for the same header, harness and csrc/
    headers. Returns (the executable's path, the g++ process: a finished
    no-op where the cache held it)."""
    header = kfe.fe32_header(get_curve(cname))
    cmd_flags = ["-O0", "-std=c++17"]
    texts = [header, _HARNESS, *cmd_flags] + [
        (pathlib.Path(kernels.CSRC) / f).read_text() for f in ("fe32.cuh", "point32.cuh")]
    key = hashlib.sha256("\0".join(texts).encode()).hexdigest()[:16]
    cached = HARNESS_CACHE / f"{cname}-{key}" / "harness"
    if cached.exists():
        return cached, subprocess.Popen(["true"], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT)
    gxx = shutil.which("g++")
    d.mkdir(parents=True, exist_ok=True)
    (d / "kfe_fe32.cuh").write_text(header)
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    tmp = cached.with_name(f"harness.{os.getpid()}.{d.name}")
    build = " ".join(shlex.quote(a) for a in [
        gxx, *cmd_flags, "-I", str(d), "-I", kernels.CSRC, "-o", str(exe), str(d / "harness.cpp")])
    # the copy into the cache lands whole (a rename) or not at all
    cache = (f"mkdir -p {shlex.quote(str(cached.parent))} && cp {shlex.quote(str(exe))} "
             f"{shlex.quote(str(tmp))} && mv -f {shlex.quote(str(tmp))} "
             f"{shlex.quote(str(cached))}")
    return exe, subprocess.Popen(["sh", "-c", f"{build} && {{ {cache} || true; }}"],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


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


# ---------------------------------------------------------------------------
# the MSM's lane bodies (segscan, bucket_reduce, horner, fixup) on a
# curve's harness `run`, against the plain twins and the host oracle
# (tests/test_torch_fe32.py at N = 8, tests/test_torch_fe32_wide.py at the
# other word counts)
# ---------------------------------------------------------------------------

def window_group(curve, N, L, w, signed, windows):
    """The first `windows` windows of a Pippenger MSM over N points (16
    distinct, tiled) with random full-width scalars plus 0 and n - 1, sorted
    and laid out as msm_pippenger gives them to segscan (the shapes of
    tests/test_torch_kernels_cuda.py's small case)."""
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M

    rng = np.random.default_rng(N + w + signed)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 16)]
    pts = [pts[i % 16] for i in range(N)]
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], "cpu")
    ks = [0, curve.n - 1] + [int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                             for _ in range(N - 2)]
    payload, keys, negs, nbuck = M.pippenger_inputs(
        curve, Q.x, Q.y, torch.zeros(N, dtype=torch.bool),
        SM.pack_scalars(curve, ks, "cpu"), w, signed=signed)
    negs = None if negs is None else negs[:windows]
    return M.sorted_windows(payload, keys[:windows], negs, L), nbuck


def check_segscan_body(run, curve, signed):
    """segscan_lane at N = 512, L = 32, w = 8, two windows side by side:
    the rows at the run ends, last_key, tail and lead against segscan_plain
    (mod p); the rows that end no run stay unwritten; bucket_lookup on
    either's rows and fixup gives the same buckets mod p."""
    from tpu_ecc_torch.parallel import msm as M

    (skey, key2, val2, neg2), nbuck = window_group(curve, 512, 32, 8, signed, 2)
    C, lanes, n = key2.shape[0], key2[0].numel(), curve.field.n_limbs
    arrays = [key2.numpy(), val2.numpy()] + ([neg2.numpy()] if signed else [])
    out = run("segscan", lanes, C, nbuck, int(signed), arrays=arrays)
    cut = np.cumsum([C * 3 * n * lanes, lanes, 3 * n * lanes])
    scanned, last_key, tail, lead = np.split(out, cut)
    scanned = scanned.reshape(val2.shape)
    tail, lead = tail.reshape(3, n, *key2.shape[1:]), lead.reshape(3, n, *key2.shape[1:])
    want = [t.numpy() for t in kernels.segscan_plain(curve, key2, val2, nbuck, neg2)]

    k = key2.numpy()
    ends = np.ones(k.shape, bool)
    ends[:-1] = k[1:] != k[:-1]
    assert 0 < ends.sum() < ends.size
    rows = np.moveaxis(scanned, 0, 2)[..., ends]          # [3, n, run ends]
    rows_want = np.moveaxis(want[0], 0, 2)[..., ends]
    _canonical(curve, rows, 1)
    assert (_mod_p(curve, rows, 1) == _mod_p(curve, rows_want, 1)).all()
    assert (np.moveaxis(scanned, 0, 2)[..., ~ends] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(last_key.reshape(k.shape[1:]).view(np.int32), want[1])
    for got, ref in ((tail, want[2]), (lead, want[3])):
        _canonical(curve, got, 1)
        assert (_mod_p(curve, got, 1) == _mod_p(curve, ref, 1)).all()

    def buckets(sc, lk, tl, ld):
        sc, lk, tl, ld = (torch.from_numpy(np.asarray(x).astype(np.int32)) for x in (sc, lk, tl, ld))
        fixed = kernels.fixup_plain(curve, tl, lk, key2[0], ld)
        return M.bucket_lookup(curve, skey, sc, fixed, key2[0], nbuck).numpy()

    mine = buckets(scanned, last_key.reshape(k.shape[1:]).view(np.int32), tail, lead)
    assert (_mod_p(curve, mine, 1) == _mod_p(curve, buckets(*want), 1)).all()


def check_bucket_body(run, curve, drop0):
    """bucket_suffix_lane and bucket_pair_lane step by step as the launch
    runs them, on 2 windows of 64 buckets, against bucket_reduce_plain mod
    p, and sum_b (b + 1) S_b (b S_b with drop0) of each window by the host
    oracle. Among the buckets: O (alone and at a window's ends), P and -P
    side by side, and two equal points side by side, so that the first
    step adds a point to itself."""
    nbuck, groups = 64, 2
    rng = np.random.default_rng(11 + drop0)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, groups * nbuck)]
    for b in (0, 9, 10, 63, 64, 100, 127):
        pts[b] = None
    pts[5] = pts[6]
    pts[70] = pts[71]
    pts[30] = (pts[31][0], curve.p - pts[31][1])
    rows = _steady_limbs(curve, pts, rng)
    out = run("bucket", groups * nbuck, nbuck, int(drop0), arrays=[rows])
    got = out.reshape(3, curve.field.n_limbs, groups)
    _canonical(curve, got, 1)
    want = kernels.bucket_reduce_plain(
        curve, torch.from_numpy(rows.astype(np.int64)).reshape(3, -1, groups, nbuck),
        drop0).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()
    assert _affine_of(curve, got) == [
        _host_sum(curve, [(b + (not drop0), pts[g * nbuck + b]) for b in range(nbuck)])
        for g in range(groups)]


def check_horner_body(run, curve):
    """horner_lane at w = 4 over 5 window sums (one of them O), MSB first,
    against horner_plain mod p, and sum_j 2^(4 (4 - j)) S_j by the host
    oracle."""
    w, nw = 4, 5
    rng = np.random.default_rng(12)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, nw)]
    pts[2] = None
    s_all = np.ascontiguousarray(np.moveaxis(_steady_limbs(curve, pts, rng), 2, 0))
    got = run("horner", 1, nw, w, arrays=[s_all])
    got = got.reshape(3, curve.field.n_limbs, 1)
    _canonical(curve, got, 1)
    want = kernels.horner_plain(curve, torch.from_numpy(s_all.astype(np.int64)), w).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want[..., None], 1)).all()
    assert _affine_of(curve, got) == [
        _host_sum(curve, [(1 << (w * (nw - 1 - j)), pts[j]) for j in range(nw)])]


def _fixup_inputs(curve, L, rng):
    """Two windows of L lanes: the keys (sorted in each window; runs that
    cross several lanes, one of about 15 lanes; window 1 starts at window
    0's last key, a run the scan must stop at the window's start) and the
    affine tails and leads (None for O; a tail beside its negation and two
    equal tails in one run, so that an add doubles)."""
    G = H.aff_generator(curve)
    keys, start = [], 0
    for _ in range(2):
        ks = np.sort(np.concatenate([rng.integers(0, 24, 2 * L - 34), np.full(30, 11),
                                     np.zeros(4, np.int64)])) + start
        keys.append(ks)
        start = int(ks[-1])
    keys = np.stack(keys)                                   # [2, 2L]: lane l's rows 2l, 2l + 1
    first_key, last_key = keys[:, 0::2], keys[:, 1::2]
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 4 * L)]
    tails, leads = pts[:2 * L], pts[2 * L:]
    run = [l for l in range(1, L) if last_key[0, l] == last_key[0, l - 1]]
    neg, eq = run[1], run[-1]
    tails[neg] = (tails[neg - 1][0], curve.p - tails[neg - 1][1])
    tails[eq] = tails[eq - 1]
    for i in {0, 7, 30, 64, 100} - {neg - 1, neg, eq - 1, eq}:
        tails[i] = None
    leads[3] = leads[70] = None
    return first_key, last_key, tails, leads


def _fixup_host(curve, first_key, last_key, tails, leads, L):
    """lead[l] + T[l - 1] where the key continues, T the sum of the tails of
    l's run up to l within its window, by the host oracle."""
    out = []
    for w in range(first_key.shape[0]):
        T = []
        for i in range(L):
            same = i > 0 and last_key[w, i] == last_key[w, i - 1]
            T.append(H.aff_add(curve, T[-1], tails[w * L + i]) if same else tails[w * L + i])
        for i in range(L):
            carry = T[i - 1] if i > 0 and first_key[w, i] == last_key[w, i - 1] else None
            out.append(H.aff_add(curve, leads[w * L + i], carry))
    return out


def check_fixup_body(run, curve):
    """fixup_step_lane (6 steps) and fixup_final_lane as the launch runs
    them, on 2 windows of 64 lanes, against kernels.fixup_plain mod p, and
    the fixed lanes by the host oracle; then windows of one lane (L = 1,
    the last launch alone)."""
    L = 64
    rng = np.random.default_rng(14)
    first_key, last_key, tails, leads = _fixup_inputs(curve, L, rng)
    t_l, lead = _steady_limbs(curve, tails, rng), _steady_limbs(curve, leads, rng)
    out = run("fixup", 2 * L, L, arrays=[t_l, last_key, first_key, lead])
    got = out.reshape(3, curve.field.n_limbs, 2 * L)
    _canonical(curve, got, 1)
    n = curve.field.n_limbs
    want = kernels.fixup_plain(
        curve, torch.from_numpy(t_l.astype(np.int32)).reshape(3, n, 2, L),
        torch.from_numpy(last_key.astype(np.int32)), torch.from_numpy(first_key.astype(np.int32)),
        torch.from_numpy(lead.astype(np.int32)).reshape(3, n, 2, L)).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want.reshape(got.shape), 1)).all()
    assert _affine_of(curve, got) == _fixup_host(curve, first_key, last_key, tails, leads, L)
    assert last_key[1, 0] == last_key[0, -1]           # a key the scan must not carry over
    # L = 1: no step, the last launch alone; every lane adds O to its lead
    w = 6
    got1 = run("fixup", w, 1, arrays=[t_l[..., :w], last_key[0, :w], first_key[0, :w],
                                      lead[..., :w]]).reshape(3, n, w)
    want1 = kernels.fixup_plain(
        curve, torch.from_numpy(t_l[..., :w].astype(np.int32)).reshape(3, n, w, 1),
        torch.from_numpy(last_key[0, :w].astype(np.int32)).reshape(w, 1),
        torch.from_numpy(first_key[0, :w].astype(np.int32)).reshape(w, 1),
        torch.from_numpy(lead[..., :w].astype(np.int32)).reshape(3, n, w, 1)).numpy()
    assert (_mod_p(curve, got1, 1) == _mod_p(curve, want1.reshape(got1.shape), 1)).all()
    assert _affine_of(curve, got1) == leads[:w]
