"""The arithmetic of the port's tensor-core kernels, emulated in plain
PyTorch on the CPU and held against the JAX package.

``flash_attention.cu`` takes its products on the tensor cores:

* bf16 / fp16 inputs: q.k^T with exact 16-bit products summed in
  float32, and P.V as two products of ``p = p_hi + p_lo`` (each half
  rounded to nearest even in the input type) against V;
* float32 inputs: 3xTF32, every operand split into ``hi = tf32(x)`` and
  ``lo = tf32(x - hi)`` (``cvt.rna``: 10 mantissa bits, ties away from
  zero) and each product summed as lo.hi + hi.lo + hi.hi in float32.

The emulations below run the kernel's online-softmax schedule (KV tiles
of ``bk`` keys, the Pallas update order) with those products, and are
held against ``repro/kernels/flash_attention/ref.py`` on the shapes of
``tests/test_flash_kernel.py`` within the kernel's own bars
(``within_tolerance``: 2e-5 in float32, plus one step of a 16-bit output
type).  The negative cases show why the splits are there: p rounded once
to bf16, or plain TF32 products, miss those bars.

``rns_matmul.cu`` takes unsigned-byte products on the integer tensor
cores, 128-deep K steps reduced mod m every ``lazy_chunk - 1`` terms,
and, when a tile's K steps are shared among ``splits`` blocks, each
block's sum mod m added up and reduced once more.  That schedule is
emulated in int64 (checking that no int32 accumulator could overflow)
and held bit for bit against the Pallas kernel in interpret mode on
every profile, rns8_u8's int32 residues included, at ragged M, D, N.

``rns_fused_mma.cu`` (the fused dot, B.4, matmul + normalize, B.6, and
encode + matmul, B.5) runs the same products with its own ring's K
step; the dot's and the encode + matmul's a operand is the quantized x
itself as signed bytes when it fits one (bits <= 8: s8 x u8 products,
signed sums reduced by a floor-mod, lazily and at the end), else
residues computed from it by a multiply-high mod; the MRC epilogue's
mod is a multiply-high too.  Those steps are emulated and held bit for
bit against the JAX package's fused references (``rns_fused/ref.py``)
and, for B.5's residues, against the Pallas kernel
``rns_fused_encode_matmul_tiles`` in interpret mode on every profile,
at bits 8 and 16, ragged M, D, N and every split the launch may take;
the multiply-high mods are checked against floor-mod over every operand
they can meet (the offset form of rns_convert's residues exhaustively
over 16 and 17 bits), for every modulus.

``csrc/rns_mrc.cuh`` is the port's one MRC (rns_normalize.cu and the
fused epilogue): one pass of direct-remainder terms (``mrc_term``: an
add, a multiply-low by the table's ``mrc_c``, a multiply-high by m_j,
checked over every residue pair of every profile), the magnitude of a
negative value from the same digits (the complement plus a carried one,
checked against a second MRC), the float32 sum digit-ascending.  Its
emulation is held bit for bit against the JAX package's
``core.mrc.decode_float`` and the port's plain version on every profile.

The tests marked ``gpu`` run the kernels themselves on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.rns_fused import ref as jfused
from repro.kernels.rns_fused.kernel import rns_fused_encode_matmul_tiles
from repro.kernels.rns_matmul.ops import rns_matmul as j_matmul
from repro_torch.analysis.kernel_audit import fused_ring
from repro_torch.core.moduli import PROFILES, get_profile
from repro_torch.core.mrc import is_negative_digits
from repro_torch.core.quantize import quantize_with_scale
from repro_torch.core.rns import tables
from repro_torch.kernels import autotune, build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rns_fused import ops as fused
from repro_torch.kernels.rns_matmul import ops as mm
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# tests/test_flash_kernel.py's shapes: (B, Tq, Tk, H, Hk, D)
SHAPES = [(1, 128, 128, 2, 1, 16), (2, 96, 200, 4, 2, 32),
          (1, 17, 33, 2, 2, 64), (1, 130, 257, 2, 1, 32),
          (2, 7, 5, 2, 2, 16), (1, 65, 64, 2, 1, 16)]
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _own_table(tmp_path, monkeypatch):
    """Keep a developer's tuned table out of the tiles these tests see."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


# --------------------------------------------------------- emulations ----
def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b as three TF32 products summed in float32: lo.hi + hi.lo +
    hi.hi (each TF32 x TF32 product is exact in float32)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def pv_split(dtype):
    """P.V with p = p_hi + p_lo, both rounded to ``dtype``."""
    def pv(p, v):
        hi = p.to(dtype).float()
        lo = (p - hi).to(dtype).float()
        return lo @ v + hi @ v
    return pv


def pv_once(dtype):
    def pv(p, v):
        return p.to(dtype).float() @ v
    return pv


def emulate_flash(q, k, v, *, causal, qk, pv, bk=64):
    """q [BH,Tq,D], k/v [BH,Tk,D] in their input type -> [BH,Tq,D] in
    that type: the kernel's online softmax over KV tiles of ``bk`` keys
    in the Pallas update order, with the products ``qk`` and ``pv``."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((BH, Tq, 1), NEG_INF)
    l = torch.zeros((BH, Tq, 1))
    acc = torch.zeros((BH, Tq, v.shape[-1]))
    rows = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = qk(q, kt.transpose(1, 2)) * scale
        keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
        valid = rows >= keys if causal else torch.ones_like(rows >= keys)
        s = torch.where(valid[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv(p, vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(dtype)


def _bhtd(shape, seed, dtype):
    """q, k, v of ``shape`` (model layout) made from ``seed``, rounded to
    ``dtype``, with the KV heads repeated and the heads folded into the
    batch (as the JAX wrapper does)."""
    B, Tq, Tk, H, Hk, D = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((B, Tq, H, D), (B, Tk, Hk, D),
                                    (B, Tk, Hk, D)))
    G = H // Hk
    k, v = (t.repeat_interleave(G, 2) for t in (k, v))
    return tuple(t.transpose(1, 2).reshape(B * H, t.shape[1], D)
                 for t in (q, k, v))


def _jax_ref(q, k, v, causal):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[q.dtype]
    qj, kj, vj = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (q, k, v))
    out = flash_attention_ref(qj, kj, vj, causal=causal,
                              tk_valid=k.shape[1])
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(q.dtype)


def _within(got, want):
    return fa.within_tolerance(got, want)


# ------------------------------------------------- flash: 16-bit path ----
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_16bit_split_matches_jax_ref(dtype, causal, shape):
    q, k, v = _bhtd(shape, sum(shape) + causal, dtype)
    want = _jax_ref(q, k, v, causal)
    for bk in (32, 64, 128):
        got = emulate_flash(q, k, v, causal=causal, qk=torch.matmul,
                            pv=pv_split(dtype), bk=bk)
        ok, err = _within(got, want)
        assert ok, (bk, err)


def test_flash_bf16_without_the_split_misses_the_bar():
    """p rounded once to bf16 (8 significant bits) before P.V: the same
    schedule leaves the bar on at least one shape."""
    missed = []
    for causal in (True, False):
        for shape in SHAPES:
            q, k, v = _bhtd(shape, sum(shape) + causal, torch.bfloat16)
            got = emulate_flash(q, k, v, causal=causal, qk=torch.matmul,
                                pv=pv_once(torch.bfloat16))
            ok, err = _within(got, _jax_ref(q, k, v, causal))
            if not ok:
                missed.append((shape, causal, err))
    assert missed


# ------------------------------------------------ flash: float32 path ----
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_3xtf32_matches_jax_ref(causal, shape):
    q, k, v = _bhtd(shape, sum(shape) + causal, torch.float32)
    want = _jax_ref(q, k, v, causal)
    for bk in (32, 64, 128):
        got = emulate_flash(q, k, v, causal=causal, qk=mm_3xtf32,
                            pv=mm_3xtf32, bk=bk)
        ok, err = _within(got, want)
        assert ok, (bk, err)


def test_flash_plain_tf32_misses_the_bar():
    missed = []
    for causal in (True, False):
        for shape in SHAPES:
            q, k, v = _bhtd(shape, sum(shape) + causal, torch.float32)
            got = emulate_flash(q, k, v, causal=causal, qk=mm_tf32,
                                pv=mm_tf32)
            ok, err = _within(got, _jax_ref(q, k, v, causal))
            if not ok:
                missed.append((shape, causal, err))
    assert missed


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),           # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),         # below the tie: down
    (2 - 2 ** -23, 2.0),                    # carries into the exponent
    (-3.0 * 2 ** -12, -3.0 * 2 ** -12),     # exact: unchanged
])
def test_tf32_rna_rounds_to_nearest_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert got.view(torch.int32).item() & 0x1FFF == 0


def test_split_tf32_keeps_about_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel < 2.0 ** -21
    assert ((hi - tf32_rna(x)) == 0).all()


# ---------------------------------------------------- rns_matmul path ----
def emulate_rns_matmul(p, a, b, splits=1, lim=None, bk=mm.BK,
                       signed=False):
    """The kernel's schedule in int64: residues narrowed to a byte (or,
    ``signed``, a's values as signed bytes), K steps
    of ``bk`` split among ``splits`` blocks as the launch splits them,
    each block's int32 accumulator reduced mod m whenever the next step
    could pass ``lim`` (lazy_chunk - 1) terms, then its sum mod m; the
    blocks' residues summed and reduced once more."""
    lim = p.lazy_chunk - 1 if lim is None else lim
    a8 = (a.long() & 0xFF) if not signed else a.long()
    b8 = (b.long() & 0xFF)
    assert torch.equal(a8, a.long()) and torch.equal(b8, b.long())
    assert int(a8.abs().max()) <= (127 if signed else 255)
    m = torch.tensor(p.moduli, dtype=torch.int64)[:, None, None]
    D = a.shape[-1]
    ksteps = -(-D // bk)
    per = -(-ksteps // splits)
    total = 0
    for kb in range(0, ksteps, per):
        acc = torch.zeros(a.shape[0], a.shape[1], b.shape[-1],
                          dtype=torch.int64)
        since = 0
        for ks in range(kb, min(ksteps, kb + per)):
            k0, k1 = ks * bk, min(D, (ks + 1) * bk)
            acc = acc + a8[:, :, k0:k1] @ b8[:, k0:k1, :]
            assert int(acc.abs().max()) <= 2 ** 31 - 1   # int32 accumulators
            since += bk
            if since + bk > lim:
                acc, since = acc % m, 0
        total = total + acc % m
    return (total % m).to(torch.int32)


def _residues(p, shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, m, shape) for m in p.moduli]).astype(dtype))


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("M,D,N", [(8, 576, 48), (37, 300, 70),
                                   (3, 129, 5), (1, 1, 1)])
def test_rns_matmul_schedule_matches_pallas(name, M, D, N):
    p = get_profile(name)
    dt = np.int8 if p.int8_safe else np.int32
    a = _residues(p, (M, D), M * D + N, dt)
    b = _residues(p, (D, N), M + D * N, dt)
    want = torch.from_numpy(np.array(j_matmul(name, a.numpy(), b.numpy(),
                                                interpret=True)))
    ksteps = -(-D // mm.BK)
    for splits in sorted({1, 2, 3, ksteps}):
        got = emulate_rns_matmul(p, a, b, splits)
        assert torch.equal(got, want), splits


@pytest.mark.parametrize("name", ["rns9", "rns8_u8", "rns21"])
def test_rns_matmul_schedule_at_the_top_residues(name):
    """Every residue m - 1: the largest sums; a reduction forced after
    every other K step (lim = 2 BK) gives the same residues."""
    p = get_profile(name)
    dt = np.int8 if p.int8_safe else np.int32
    a = torch.from_numpy(np.stack([np.full((5, 700), m - 1) for m in
                                   p.moduli]).astype(dt))
    b = torch.from_numpy(np.stack([np.full((700, 9), m - 1) for m in
                                   p.moduli]).astype(dt))
    want = torch.from_numpy(np.array(j_matmul(name, a.numpy(), b.numpy(),
                                                interpret=True)))
    for splits in (1, 2, 6):
        assert torch.equal(emulate_rns_matmul(p, a, b, splits), want)
        assert torch.equal(emulate_rns_matmul(p, a, b, splits,
                                              lim=2 * mm.BK), want)


@pytest.mark.parametrize("S,M,D,N,bm,bn,want", [
    (9, 8, 576, 1536, 32, 64, 1),        # 216 tiles fill 132 SMs
    (9, 8, 1536, 576, 32, 64, 4),        # 81 tiles: K shared by 4 blocks
    (9, 144, 576, 1536, 32, 64, 1),
    (9, 144, 1536, 576, 64, 128, 1),     # 135 tiles
    (9, 8, 300, 70, 32, 64, 1),          # too few K steps to share
    (1, 8, 4096, 64, 32, 64, 4),
])
def test_splits_for_the_main_path(S, M, D, N, bm, bn, want):
    got = mm.splits_for(S, M, D, N, bm, bn, 132)
    assert got == want
    ksteps = -(-D // mm.BK)
    per = -(-ksteps // got)
    assert (got - 1) * per < ksteps <= got * per    # no empty split


def test_rns_matmul_cpu_call_launches_nothing():
    before = mm.launches
    p = get_profile("rns8_u8")
    a = _residues(p, (3, 20), 1, np.int32)
    b = _residues(p, (20, 4), 2, np.int32)
    assert torch.equal(mm.rns_matmul(p, a, b), emulate_rns_matmul(p, a, b))
    assert mm.launches == before


# ------------------------------------------------ rns_fused_mma path ----
def _mulhi_mod(x, m):
    """rns_tables.cuh's mulhi_mod (x in [0, 2**31)) with the magic of
    ``build.mulhi_magic``, its domain checked."""
    assert int(x.min()) >= 0 and int(x.max()) < 2 ** 31
    return build.mulhi_mod(x, m)


def emulate_dot_residues(p, v):
    """rns_fused_mma.cu's residues of the quantized x: |v| by mulhi_mod,
    reflected for v < 0 -> [K, ...] int64."""
    out = []
    for m in p.moduli:
        q = _mulhi_mod(v.abs(), m)
        out.append(torch.where((v < 0) & (q != 0), m - q, q))
    return torch.stack(out)


def mrc_term(c, ri, rj, i, j):
    """rns_mrc.cuh's mrc_term with the by-value tables ``c``: (r_j - r_i
    + roff_j) times mrc_c (mod 2**32), then the high word of its product
    with m_j -> (r_j - r_i) * inv_ij mod m_j."""
    x = rj - ri + int(c.roff[j])
    assert int(x.min()) >= 0
    lo = (x * int(c.mrc_c[build.rns_pair(i, j)])) % 2 ** 32
    return (lo * int(c.moduli[j])) >> 32


def emulate_mrc(p, r, digits_out=None):
    """rns_mrc.cuh's mrc_decode_float (rns_normalize.cu and the fused
    epilogue) on [K, ...] residues in [0, m_j), with the constants of the
    kernel's by-value tables (``build.rns_tables_c``): one MRC pass,
    every term by :func:`mrc_term`; the sign as the borrow out of X - M/2
    digit by digit (the lexicographic rule); a negative value's magnitude
    digits m_j - 1 - d_j with one carried in digit-ascending; the float32
    sum digit-ascending, one rounding per operation, negated last.
    ``digits_out`` (a list) receives the magnitude's digits."""
    c = build.rns_tables_c(p)
    K = p.n_digits
    ms = [int(c.moduli[j]) for j in range(K)]
    d = list(r.long())
    for i in range(K - 1):
        for j in range(i + 1, K):
            d[j] = mrc_term(c, d[i], d[j], i, j)
    borrow = torch.zeros(d[0].shape, dtype=torch.int64)
    for j in range(K):              # X - M/2 digit by digit: 0 or -1
        borrow = (d[j] - int(c.half[j]) + borrow) >> 31
    neg = borrow == 0
    # the lexicographic rule of core/mrc.is_negative_digits
    assert torch.equal(neg, is_negative_digits(p, torch.stack(d)))
    w = np.frombuffer(bytes(c.w), np.float32)
    carry = torch.ones(d[0].shape, dtype=torch.int64)
    acc = torch.zeros(d[0].shape, dtype=torch.float32)
    for j in range(K):
        g = ms[j] - 1 - d[j] + carry
        carry = (g == ms[j]).long()
        g = torch.where(neg, torch.where(carry == 1, 0, g), d[j])
        if digits_out is not None:
            digits_out.append(g)
        # digit_float: 2**23 + g as float32 bits, less 2**23 (exact)
        gf = (g + 0x4B000000).to(torch.int32).view(torch.float32) - 2.0 ** 23
        assert torch.equal(gf, g.to(torch.float32))
        acc = acc + gf * torch.tensor(w[j])
    return torch.where(neg, -acc, acc)


def _mrc_cases(name, n, seed):
    """[K, n + 6 (+ 2)] residues: n uniform vectors from a numpy seed,
    then the values 0, 1, M/2 - 1, M/2, M/2 + 1 and M - 1 (and, for
    rns5, ROADMAP C.1's pair)."""
    from repro_torch.core.rns import encode_exact

    p = get_profile(name)
    rng = np.random.default_rng(seed)
    r = np.stack([rng.integers(0, m, n) for m in p.moduli])
    vals = [0, 1, p.M // 2 - 1, p.M // 2, p.M // 2 + 1, p.M - 1]
    if name == "rns5":
        vals += [4_503_599_542_737_792, -4_503_599_542_737_792]
    return np.concatenate([r, encode_exact(name, vals)], axis=1).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mrc_one_pass_matches_decode_float(name):
    """The one-pass MRC of multiply-high terms, bit for bit against the JAX
    package's ``core.mrc.decode_float`` and the port's plain version, on
    10^4 uniform residue vectors and the edge values of every profile:
    each digit count of ``SUPPORTED_K`` and rns8_u8 (modulus 256);
    rns21's float32 weights overflow, and the inf / NaN land where the
    reference's do.  The MRC terms' multiply-high mod over every operand
    it can meet is checked exhaustively by
    test_mrc_term_equals_floor_mod_for_every_residue_pair."""
    from repro.core import mrc as jmrc
    from repro_torch.kernels.rns_normalize import ops as norm

    p = get_profile(name)
    assert p.n_digits in norm.SUPPORTED_K
    r = _mrc_cases(name, 10_000, 18 + p.n_digits)
    got = emulate_mrc(p, torch.from_numpy(r)).numpy()
    want = np.asarray(jmrc.decode_float(name, jnp.asarray(r)))
    plain = norm.rns_normalize_plain(p, torch.from_numpy(r)).numpy()
    for ref in (want, plain):       # NaN at the same places, else bits
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      ref[~nan].view(np.int32))
    if name == "rns21":     # W_20 past float32's range: inf, or 0 * inf
        assert np.isinf(got).any() and np.isnan(got).any()
        return
    edge = got[-6:] if name != "rns5" else got[-8:-2]
    assert edge[0] == 0.0 and edge[1] == 1.0 and edge[3] < 0 < edge[2]
    assert edge[5] == -1.0 and edge[4] == -edge[2]
    if name == "rns5":
        assert got[-2:].tolist() == [13505986560.0, -13505986560.0]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mrc_term_equals_floor_mod_for_every_residue_pair(name):
    """mrc_term over every (r_i, r_j) in [0, m_i) x [0, m_j) of every
    pair i < j of the profile -- every term (r_j - r_i) * inv_ij, within
    (-m_i * m_j, m_j**2), the MRC can meet -- equals its floor-mod, and
    the tables hold build.mrc_c / mrc_offset at their packed places."""
    from repro_torch.core.rns import tables

    p = get_profile(name)
    c = build.rns_tables_c(p)
    t = tables(p)
    ms = [int(m) for m in p.moduli]
    for i in range(p.n_digits):
        ri = torch.arange(ms[i], dtype=torch.int64)[None, :]
        for j in range(i + 1, p.n_digits):
            inv = int(t.mrc_inv[i][j])
            assert c.mrc_c[build.rns_pair(i, j)] == build.mrc_c(ms[j], inv)
            assert c.roff[j] == build.mrc_offset(ms[j]) >= 256
            rj = torch.arange(ms[j], dtype=torch.int64)[:, None]
            got = mrc_term(c, ri, rj, i, j)
            assert torch.equal(got, torch.remainder((rj - ri) * inv, ms[j]))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mrc_one_pass_magnitude_is_the_second_pass(name):
    """The complement-plus-carry digits of a negative value are those an
    MRC of its negated residues ((m_j - r_j) mod m_j, the reference's
    second pass) gives; a non-negative value keeps its own digits."""
    from repro_torch.core import mrc

    p = get_profile(name)
    r = torch.from_numpy(_mrc_cases(name, 10_000, 40 + p.n_digits))
    mag = []
    emulate_mrc(p, r, mag)
    neg = mrc.is_negative(p, r)
    m = torch.tensor(p.moduli).reshape(-1, 1)
    want = mrc.mrc_digits(p, torch.where(neg[None], torch.remainder(
        m - r.long(), m), r.long()))
    assert neg.any() and (~neg).any()
    assert torch.equal(torch.stack(mag), want.long())


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mulhi_mod_equals_floor_mod_for_every_operand(name):
    """Every modulus of the profile: quantized values over -65536..65536
    (offset moff, then mulhi_mod: quant_residue), the dot's |v| up to
    2**30 and the accumulators up to 2**31 - 1 give floor-mod's
    integers."""
    p = get_profile(name)
    x = torch.arange(-2 ** 16, 2 ** 16 + 1, dtype=torch.int64)
    big = torch.cat([torch.arange(0, 2 ** 17),
                     torch.arange(2 ** 30 - 2 ** 17, 2 ** 30 + 1),
                     torch.arange(2 ** 31 - 2 ** 17, 2 ** 31)])
    for m in p.moduli:
        assert build.mulhi_offset(m) % m == 0
        assert build.mulhi_offset(m) >= 2 ** 16
        got = _mulhi_mod(x + build.mulhi_offset(m), m)
        assert torch.equal(got, torch.remainder(x, m)), m
        assert torch.equal(_mulhi_mod(big, m), torch.remainder(big, m)), m
        assert build.rns_tables_c(p).magic[p.moduli.index(m)] == \
            build.mulhi_magic(m)


def _fused_case(name, M, D, N, seed):
    p = get_profile(name)
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((M, D))).astype(np.float32)
    x.reshape(-1)[:4] = [0.25, -0.25, 0.75, -63.75]     # half-way, clip
    s = (127.0 / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)
    dt = np.int8 if p.int8_safe else np.int32
    b = _residues(p, (D, N), seed + 1, dt)
    a = _residues(p, (M, D), seed + 2, np.int32)
    return p, x, s, a, b


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("M,D,N,bm,bn", [(8, 1536, 48, 16, 32),
                                         (13, 1100, 70, 32, 64),
                                         (37, 130, 37, 16, 64)])
def test_fused_mma_arithmetic_matches_jax_ref(name, M, D, N, bm, bn):
    """rns_fused_mma.cu's arithmetic -- x quantized, residues by the
    multiply-high rule, u8 products in the ring's K steps split as the
    launch splits them, the one-pass MRC -- equals ``rns_fused/ref.py`` bit
    for bit, for the dot and the matmul + normalize."""
    p, x, s, a, b = _fused_case(name, M, D, N, M + D)
    for kind in ("rns_fused_dot", "rns_fused_matmul_normalize"):
        ring = fused_ring(kind, p.n_digits, bm, bn)
        if ring is None or p.n_digits * bn > 1024:
            continue                      # the checker refuses the tile
        bk = ring[0]
        splits = fused.splits_for(M, D, N, bm, bn, bk, 132)
        runs = []                   # (a operand, signed, reference)
        if kind == "rns_fused_dot":
            for bits in (8, 12):    # s8 operand; residues of wider values
                sb = (s * (2 ** (bits - 1) - 1) / 127).astype(np.float32)
                v = quantize_with_scale(torch.from_numpy(x),
                                        torch.from_numpy(sb), bits).long()
                runs.append((
                    v.expand((p.n_digits,) + v.shape) if bits <= 8
                    else emulate_dot_residues(p, v), bits <= 8,
                    jfused.rns_fused_dot_ref(name, jnp.asarray(x),
                                             jnp.asarray(sb),
                                             jnp.asarray(b.numpy()),
                                             bits=bits)))
        else:
            runs.append((a, False, jfused.rns_fused_matmul_normalize_ref(
                name, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
        for a_op, signed, want in runs:
            for sp in sorted({1, splits}):
                res = emulate_rns_matmul(p, a_op, b, sp, bk=bk,
                                         signed=signed)
                got = emulate_mrc(p, res)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_mma_mrc_c1():
    """ROADMAP C.1's rns5 value through the one-pass MRC: one rounding per
    operation, 13505986560.0 (the FMA-contracted sum is 13505985536.0)."""
    from repro_torch.core.rns import encode_exact

    r = torch.as_tensor(encode_exact("rns5", [4_503_599_542_737_792,
                                              -4_503_599_542_737_792]))
    assert emulate_mrc(get_profile("rns5"), r).tolist() == [
        13505986560.0, -13505986560.0]


@pytest.mark.parametrize("M,D,N,bm,bn,bk,want", [
    (8, 1536, 576, 16, 32, 128, 6),      # B.6 decode: 18 tiles
    (8, 576, 1536, 16, 32, 128, 2),      # B.4 decode: 48 tiles, 5 steps
    (8, 576, 1536, 16, 64, 64, 3),       # 24 tiles, 9 steps
    (144, 1536, 576, 16, 32, 128, 1),    # prefill: 162 tiles fill the SMs
    (144, 576, 1536, 32, 64, 64, 1),     # 120 tiles: one block an SM
    (13, 1100, 70, 16, 32, 128, 3),      # 3 tiles, 9 steps
    (8, 300, 64, 16, 32, 128, 1),        # 3 K steps: too few to share
])
def test_fused_splits_for_the_main_path(M, D, N, bm, bn, bk, want):
    got = fused.splits_for(M, D, N, bm, bn, bk, 132)
    assert got == want
    ksteps = -(-D // bk)
    per = -(-ksteps // got)
    assert (got - 1) * per < ksteps <= got * per    # no empty split
    assert got == 1 or per >= 2


# ----------------------------------------- fused encode + matmul (B.5) --
def emulate_encode_matmul(p, x, s, b, bits, bk, splits=1, lim=None):
    """rns_encode_residues_kernel's arithmetic (rns_fused_mma.cu with its
    residue epilogue): x quantized (elementwise, so once for all of x
    here); at bits <= 8 the quantized values are the s8 a operand of
    every digit, else each digit's residues by the dot's multiply-high
    rule; then the ring's ``bk``-deep K steps, the lazy floor-mod and the
    splits -> [K, M, N] residues."""
    v = quantize_with_scale(x, s, bits).long()
    if bits <= 8:
        a_op = v.expand((p.n_digits,) + tuple(v.shape))
    else:
        a_op = emulate_dot_residues(p, v)
    return emulate_rns_matmul(p, a_op, b, splits, lim=lim, bk=bk,
                              signed=bits <= 8)


def _pallas_encode_matmul(p, x, s, b, bits):
    """rns_fused_encode_matmul_tiles in interpret mode, on operands
    zero-padded to whole blocks (one block a digit: zero rows quantize to
    0, zero columns of x and rows of b add nothing)."""
    M, D = x.shape
    N = b.shape[-1]
    Mp, Dp, Np = -(-M // 8) * 8, -(-D // 128) * 128, -(-N // 128) * 128
    xp = np.zeros((Mp, Dp), np.float32)
    xp[:M, :D] = x
    sp = np.ones((Mp, 1), np.float32)
    sp[:M] = s
    bp = np.zeros((p.n_digits, Dp, Np), b.numpy().dtype)
    bp[:, :D, :N] = b.numpy()
    out = rns_fused_encode_matmul_tiles(
        jnp.asarray(np.array(p.moduli, np.int32)), jnp.asarray(xp),
        jnp.asarray(sp), jnp.asarray(bp), bits=bits, bm=Mp, bn=Np, bk=Dp,
        interpret=True)
    return torch.from_numpy(np.array(out)[:, :M, :N])


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("M,D,N,bm,bn", [(8, 576, 48, 16, 32),
                                         (13, 1100, 70, 32, 64),
                                         (37, 130, 37, 16, 64)])
def test_encode_matmul_arithmetic_matches_pallas(name, M, D, N, bm, bn):
    """B.5 at bits 8 (s8 operand) and 16 (residues), in the K steps of
    the tile's ring, at every split the launch can take (1, 2, 3, the
    rule's and one per K step), and with a reduction forced after every
    other K step (lim = 2 bk): bit for bit the Pallas kernel's
    residues."""
    p, x, s, _, b = _fused_case(name, M, D, N, M + D + N)
    ring = fused_ring("rns_fused_encode_matmul", p.n_digits, bm, bn)
    if ring is None or p.n_digits * bn > 1024:
        bm, bn = 16, 32                   # the tile legal at every profile
        ring = fused_ring("rns_fused_encode_matmul", p.n_digits, bm, bn)
    bk = ring[0]
    ksteps = -(-D // bk)
    rule = fused.splits_for(M, D, N, bm, bn, bk, 132,
                            fused.MIN_STEPS["rns_fused_encode_matmul"])
    for bits in (8, 16):
        sb = (s * (2 ** (bits - 1) - 1) / 127).astype(np.float32)
        want = _pallas_encode_matmul(p, x, sb, b, bits)
        for splits in sorted({1, 2, 3, rule, ksteps}):
            got = emulate_encode_matmul(p, torch.from_numpy(x),
                                        torch.from_numpy(sb), b, bits, bk,
                                        splits)
            assert torch.equal(got, want), (bits, splits)
        got = emulate_encode_matmul(p, torch.from_numpy(x),
                                    torch.from_numpy(sb), b, bits, bk,
                                    lim=2 * bk)
        assert torch.equal(got, want), bits


@pytest.mark.parametrize("name", ["rns9", "rns8_u8", "rns21"])
def test_encode_matmul_at_the_clip(name):
    """Every x at +-qmax and every residue of b at m - 1: the largest
    signed sums (bits 8) and residue sums (bits 16) the accumulators can
    meet, against the Pallas kernel, at the rings' K steps."""
    p = get_profile(name)
    dt = np.int8 if p.int8_safe else np.int32
    x = np.where(np.arange(700) % 3 == 0, -1e6, 1e6).astype(np.float32)
    x = np.stack([x, -x, x[::-1]])
    b = torch.from_numpy(np.stack([np.full((700, 9), m - 1) for m in
                                   p.moduli]).astype(dt))
    s = np.ones((3, 1), np.float32)
    for bits in (8, 16):
        want = _pallas_encode_matmul(p, x, s, b, bits)
        for bk, splits in ((128, 1), (64, 6), (32, 11)):
            assert torch.equal(emulate_encode_matmul(
                p, torch.from_numpy(x), torch.from_numpy(s), b, bits, bk,
                splits), want)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_quant_residue_equals_floor_mod_at_16_bits(name):
    """quant_residue<true> (rns_tables.cuh, rns_convert's residues),
    exhaustively over the values a 16-bit quantize gives: mulhi_mod(v +
    moff, m) == v mod m for every v in [-32767, 32767] and every
    modulus, the offset sum inside mulhi_mod's domain -- and up to 17
    bits, the kernels' NARROW bound."""
    p = get_profile(name)
    t = build.rns_tables_c(p)
    for qmax in (32767, 65535):
        v = torch.arange(-qmax, qmax + 1, dtype=torch.int64)
        for j, m in enumerate(p.moduli):
            assert t.moff[j] == build.mulhi_offset(m)
            assert int((v + t.moff[j]).min()) >= 0
            got = _mulhi_mod(v + t.moff[j], m)
            assert torch.equal(got, torch.remainder(v, m)), (m, qmax)
        assert torch.equal(emulate_dot_residues(p, v),
                           torch.stack([torch.remainder(v, m)
                                        for m in p.moduli]))


@pytest.mark.parametrize("M,D,N,bm,bn,want", [
    (8, 576, 1536, 16, 32, 2),           # B.5 decode: 48 tiles, 5 steps
    (8, 576, 1536, 16, 64, 5),           # 24 tiles, 9 steps of 64
    (144, 576, 1536, 32, 64, 1),         # prefill: 120 tiles
    (13, 1100, 70, 16, 32, 5),           # [kernels]' split-forcing case
])
def test_encode_splits_follow_the_fused_dot(M, D, N, bm, bn, want):
    """B.5 takes the dot's ring and split rule (all digits a block), its
    splits down to one K step each."""
    bk = fused_ring("rns_fused_encode_matmul", 9, bm, bn)[0]
    assert bk == fused_ring("rns_fused_dot", 9, bm, bn)[0]
    got = fused.splits_for(M, D, N, bm, bn, bk, 132,
                           fused.MIN_STEPS["rns_fused_encode_matmul"])
    assert got == want
    per = -(-(-(-D // bk)) // got)
    assert (got - 1) * per < -(-D // bk) <= got * per   # no empty split


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rns9", "rns5", "rns21", "rns8_u8"])
def test_gpu_rns_matmul_every_tile_and_split(cuda, name, monkeypatch):
    p = get_profile(name)
    dt = np.int8 if p.int8_safe else np.int32
    for M, D, N in ((8, 1536, 576), (144, 576, 64), (37, 300, 70),
                    (13, 130, 37)):
        a = _residues(p, (M, D), M + D, dt).to(cuda)
        b = _residues(p, (D, N), D + N, dt).to(cuda)
        want = mm.rns_matmul_plain(p, a, b)
        for tile in autotune.CANDIDATES["rns_matmul"]:
            for splits in (1, 2, 5):
                monkeypatch.setattr(mm, "splits_for",
                                    lambda *_, s=splits: s)
                got = mm.rns_matmul(p, a, b, **tile)
                assert torch.equal(got, want), (M, D, N, tile, splits)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rns9", "rns5", "rns21", "rns8_u8"])
def test_gpu_encode_matmul_every_tile_and_split(cuda, name, monkeypatch):
    """B.5 on the card at every legal tile with its split forced to 1, 2
    and 5 ways, at bits 8 and 16, on the main path's shapes and ragged
    ones, against the plain version."""
    p = get_profile(name)
    for M, D, N in ((8, 576, 1536), (144, 576, 1536), (13, 1100, 70),
                    (37, 130, 37)):
        _, x, s, _, b = _fused_case(name, M, D, N, M + D)
        x, s, b = torch.from_numpy(x).to(cuda), torch.from_numpy(s).to(cuda), \
            b.to(cuda)
        for bits in (8, 16):
            sb = s * ((2 ** (bits - 1) - 1) / 127)
            want = fused.rns_fused_encode_matmul_plain(p, x, sb, b,
                                                       bits=bits)
            legal, _ = autotune.legal_candidates(
                "rns_fused_encode_matmul", name, (M, D, N))
            for tile in legal:
                for splits in (1, 2, 5):
                    monkeypatch.setattr(fused, "splits_for",
                                        lambda *_, n=splits: n)
                    got = fused.rns_fused_encode_matmul(p, x, sb, b,
                                                        bits=bits, **tile)
                    assert torch.equal(got, want), (M, D, N, bits, tile,
                                                    splits)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gpu_flash_every_tile_and_head_width(cuda, dtype):
    for shape in SHAPES + [(1, 100, 90, 2, 1, 128), (1, 50, 70, 2, 2, 20)]:
        B, Tq, Tk, H, Hk, D = shape
        g = torch.Generator(device=cuda).manual_seed(sum(shape))
        q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((B, Tq, H, D), (B, Tk, Hk, D), (B, Tk, Hk, D)))
        legal, _ = autotune.legal_candidates(
            "flash_attention", str(dtype)[6:], (Tq, Tk, D))
        for causal in (True, False):
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            for blocks in legal:
                got = fa.flash_attention(q, k, v, causal=causal, **blocks)
                ok, err = fa.within_tolerance(got, want)
                assert ok, (shape, causal, blocks, err)
    torch.cuda.synchronize()
