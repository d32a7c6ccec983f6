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

The tests marked ``gpu`` run the kernels themselves on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.rns_matmul.ops import rns_matmul as j_matmul
from repro_torch.core.moduli import PROFILES, get_profile
from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rns_matmul import ops as mm

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
def emulate_rns_matmul(p, a, b, splits=1, lim=None):
    """The kernel's schedule in int64: residues narrowed to a byte, K steps
    of ``mm.BK`` split among ``splits`` blocks as the launch splits them,
    each block's int32 accumulator reduced mod m whenever the next step
    could pass ``lim`` (lazy_chunk - 1) terms, then its sum mod m; the
    blocks' residues summed and reduced once more."""
    lim = p.lazy_chunk - 1 if lim is None else lim
    a8 = (a.long() & 0xFF)
    b8 = (b.long() & 0xFF)
    assert torch.equal(a8, a.long()) and torch.equal(b8, b.long())
    m = torch.tensor(p.moduli, dtype=torch.int64)[:, None, None]
    D = a.shape[-1]
    ksteps = -(-D // mm.BK)
    per = -(-ksteps // splits)
    total = 0
    for kb in range(0, ksteps, per):
        acc = torch.zeros(a.shape[0], a.shape[1], b.shape[-1],
                          dtype=torch.int64)
        since = 0
        for ks in range(kb, min(ksteps, kb + per)):
            k0, k1 = ks * mm.BK, min(D, (ks + 1) * mm.BK)
            acc = acc + a8[:, :, k0:k1] @ b8[:, k0:k1, :]
            assert int(acc.max()) <= 2 ** 31 - 1      # int32 accumulators
            since += mm.BK
            if since + mm.BK > lim:
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
