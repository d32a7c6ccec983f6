"""The port's three kernel modules (repro_torch.kernels) against the JAX
package's Pallas kernels, bit for bit.

On the CPU a wrapper takes its kernel's plain version; those are held
against the Pallas kernels in interpret mode (convert, matmul) or their
``ref.py`` oracle (normalize: ROADMAP C.1, the interpreted kernel's sum
is FMA-contracted).  ``rns_convert.cu``'s own arithmetic -- 4 elements a
thread with a masked tail, the scale's runs stepped by a counter, the
offset multiply-high residues up to 17 bits -- is emulated and held
against the Pallas kernel too.  The tests marked ``gpu`` hold each CUDA
kernel against its plain version on the card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rns_convert.kernel import rns_convert_tiles
from repro.kernels.rns_convert.ops import rns_convert as j_convert
from repro.kernels.rns_convert.ref import rns_convert_ref
from repro.kernels.rns_matmul.ops import rns_matmul as j_matmul
from repro.kernels.rns_matmul.ref import rns_matmul_ref
from repro.kernels.rns_normalize.ref import rns_normalize_ref
from repro_torch.core.moduli import PROFILES, get_profile
from repro_torch.core.quantize import quantize_with_scale
from repro_torch.core.rns import encode_exact
from repro_torch.kernels import build
from repro_torch.kernels.rns_convert import ops as convert_ops
from repro_torch.kernels.rns_matmul import ops as matmul_ops
from repro_torch.kernels.rns_normalize import ops as normalize_ops

INT8_SAFE = sorted(n for n, p in PROFILES.items() if p.int8_safe)
C1_VALUE, C1_FLOAT = 4_503_599_542_737_792, 13505986560.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x(seed, shape, amp):
    rng = np.random.default_rng(seed)
    x = (amp * rng.standard_normal(shape)).astype(np.float32)
    # exact half-way products for the scale 2.0 below (k + 0.5 after x*s)
    x.reshape(-1)[:6] = [0.25, 0.75, -0.25, -0.75, 63.25, -63.75]
    return x


def _scales(x):
    B, T = x.shape[:2]
    rng = np.random.default_rng(0)
    return {
        "scalar": np.float32(2.0),
        "row": (2.0 * rng.integers(1, 4, (B, 1, 1))).astype(np.float32),
        "token": (2.0 * rng.integers(1, 4, (B, T, 1))).astype(np.float32),
    }


# ------------------------------------------------------------ convert ----
@pytest.mark.parametrize("name", INT8_SAFE + ["rns8_u8"])
@pytest.mark.parametrize("grid", ["scalar", "row", "token"])
def test_convert_plain_matches_pallas(name, grid):
    p = get_profile(name)
    x = _x(1, (2, 5, 24), 40)
    s = _scales(x)[grid]
    out_dtype = torch.int8 if p.int8_safe else torch.int32
    jdt = jnp.int8 if p.int8_safe else jnp.int32
    got = convert_ops.rns_convert(p, _t(x), _t(np.asarray(s)), bits=8,
                                  out_dtype=out_dtype)
    want = j_convert(name, x, s, bits=8, interpret=True, out_dtype=jdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = rns_convert_ref(jnp.asarray(x), jnp.asarray(s), profile=name,
                          bits=8, out_dtype=jdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def emulate_convert(p, x, s_flat, group, bits):
    """rns_convert.cu on a flat x [T]: threads of 4 elements (the last
    one's tail masked), the scale once (group >= T) or from the run of
    the first element (one division) stepped by a counter, quantize, then
    each digit's residue by the offset multiply-high mod while qmax <=
    65535, else floor-mod -> [K, T] int64."""
    T = x.numel()
    qmax = 2 ** (bits - 1) - 1
    i0 = torch.arange(0, T, 4)
    sc = torch.zeros((len(i0), 4))
    if group >= T:
        sc[:] = s_flat[0]
    else:
        q, r = i0 // group, i0 % group
        for e in range(4):
            live = i0 + e < T
            sc[live, e] = s_flat[q[live]]
            r = r + 1
            wrap = r == group
            r, q = torch.where(wrap, 0, r), torch.where(wrap, q + 1, q)
    v = quantize_with_scale(x, sc.reshape(-1)[:T], bits).long()
    out = []
    for m in p.moduli:
        if qmax <= 65535:
            off = v + build.mulhi_offset(m)
            assert int(off.min()) >= 0
            out.append(build.mulhi_mod(off, m))
        else:
            out.append(torch.remainder(v, m))
    return torch.stack(out)


def _pallas_convert(name, x, s_elem, bits, jdt):
    """rns_convert_tiles in interpret mode, x and a per-element scale (or
    a scalar) zero-padded to one whole tile."""
    T = x.size
    Tp = -(-T // 128) * 128
    xp = np.zeros(Tp, np.float32)
    xp[:T] = x
    if np.ndim(s_elem):
        sp = np.ones(Tp, np.float32)
        sp[:T] = s_elem
    else:
        sp = np.float32(s_elem)
    out = rns_convert_tiles(jnp.asarray(xp), jnp.asarray(sp), profile=name,
                            bits=bits, bt=Tp, interpret=True, out_dtype=jdt)
    return np.asarray(out)[:, :T]


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("group", ["scalar", 7, 3, 1])
def test_convert_kernel_arithmetic_matches_pallas(name, group):
    """The kernel's vectorised schedule at T = 1001, 13 (ragged tails)
    and 4096, scale runs of 7, 3 and 1 elements (per row, shorter than a
    thread's 4, per element) or a scalar, bits 8 and 16."""
    p = get_profile(name)
    jdt = jnp.int8 if p.int8_safe else jnp.int32
    for T in (1001, 13, 4096):
        x = _x(T + 11, (T,), 200).reshape(-1)
        g = T if group == "scalar" else group
        rng = np.random.default_rng(T)
        s_flat = (2.0 * rng.integers(1, 4, -(-T // g))).astype(np.float32)
        s_elem = s_flat[0] if group == "scalar" else \
            np.repeat(s_flat, g)[:T]
        for bits in (8, 16):
            got = emulate_convert(p, _t(x), _t(s_flat), g, bits)
            want = _pallas_convert(name, x, s_elem, bits, jdt)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("scale_shape", [(), (1,), (3, 1, 1), (3, 4, 1),
                                         (1, 4, 1), (3, 4, 5), (5,)])
def test_convert_scale_runs(scale_shape):
    """The CUDA wrapper's scale layout: (flat, group) reproduces the
    broadcast scale of every element of a contiguous x."""
    x_shape = (3, 4, 5)
    s = torch.arange(1, 1 + int(np.prod(scale_shape or (1,))),
                     dtype=torch.float32).reshape(scale_shape)
    flat, group = convert_ops._scale_runs(x_shape, s)
    idx = torch.arange(int(np.prod(x_shape))) // group
    np.testing.assert_array_equal(flat[idx].numpy(),
                                  s.expand(x_shape).reshape(-1).numpy())


# ------------------------------------------------------------- matmul ----
@pytest.mark.parametrize("name", INT8_SAFE)
def test_matmul_plain_matches_pallas(name):
    p = get_profile(name)
    rng = np.random.default_rng(2)
    K = p.n_digits
    a = np.stack([rng.integers(0, m, (3, 40)) for m in p.moduli]).astype(
        np.int8)
    b = np.stack([rng.integers(0, m, (40, 20)) for m in p.moduli]).astype(
        np.int8)
    got = matmul_ops.rns_matmul(p, _t(a), _t(b)).numpy()
    want = j_matmul(name, a, b, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    ref = rns_matmul_ref(jnp.asarray(p.moduli), a, b)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # residues at the top of every modulus: the largest product-sums
    top = np.stack([np.full((2, 40), m - 1) for m in p.moduli]).astype(
        np.int8)
    got = matmul_ops.rns_matmul(p, _t(top), _t(top.transpose(0, 2, 1)))
    want = j_matmul(name, top, top.transpose(0, 2, 1), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (K, 2, 2)


def test_matmul_plain_batched_lead_dims():
    p = get_profile("rns9")
    rng = np.random.default_rng(3)
    a = np.stack([rng.integers(0, m, (2, 3, 16)) for m in p.moduli]).astype(
        np.int8)
    b = np.stack([rng.integers(0, m, (16, 8)) for m in p.moduli]).astype(
        np.int8)
    got = matmul_ops.rns_matmul(p, _t(a), _t(b))
    want = j_matmul("rns9", a, b, interpret=True)
    assert got.shape == (9, 2, 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- normalize ----
def _residues(name, n, seed):
    p = get_profile(name)
    rng = np.random.default_rng(seed)
    r = np.stack([rng.integers(0, m, n) for m in p.moduli]).astype(np.int32)
    edge = encode_exact(name, [0, 1, -1, p.M // 2 - 1, -(p.M // 2)])
    return np.concatenate([r, edge], axis=1)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_normalize_plain_matches_ref(name):
    r = _residues(name, 257, seed=4)
    got = normalize_ops.rns_normalize(name, _t(r)).numpy()
    want = np.asarray(rns_normalize_ref(jnp.asarray(r), profile=name))
    np.testing.assert_array_equal(got, want)     # NaN where rns21 has NaN


def _edge_residues(name, T, seed):
    """[K, T] int32: uniform residues with the values 0, 1, M/2 - 1, M/2,
    M/2 + 1 and M - 1 at the front and again at the end (the last run's
    tail)."""
    p = get_profile(name)
    rng = np.random.default_rng(seed)
    r = np.stack([rng.integers(0, m, T) for m in p.moduli]).astype(np.int32)
    edge = encode_exact(name, [0, 1, p.M // 2 - 1, p.M // 2, p.M // 2 + 1,
                               p.M - 1])
    n = min(T, edge.shape[1])
    r[:, :n] = edge[:, :n]
    r[:, T - n:] = edge[:, edge.shape[1] - n:]
    return r


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_normalize_plain_edges_and_tails_match_ref(name):
    """The edge values and ragged T of the card's case below, through the
    wrapper on the CPU (its plain version), against the JAX oracle."""
    for T in (4099, 3):
        r = _edge_residues(name, T, seed=T)
        got = normalize_ops.rns_normalize(name, _t(r)).numpy()
        want = np.asarray(rns_normalize_ref(jnp.asarray(r), profile=name))
        np.testing.assert_array_equal(got, want)


def test_normalize_c1_regression():
    r = encode_exact("rns5", [C1_VALUE, -C1_VALUE])
    got = normalize_ops.rns_normalize("rns5", _t(r)).numpy()
    assert got.tolist() == [C1_FLOAT, -C1_FLOAT]


def test_tables_struct_carries_float32_bits():
    """The by-value kernel tables hold the float32 weights bit for bit,
    inf included (rns21), and the MRC inverses, folded into each pair's
    mrc_c: the term (1 - 0) * inv_ij mod m_j (mrc_term) gives them back."""
    for name in ("rns9", "rns21"):
        c = build.rns_tables_c(name)
        t = normalize_ops.mrc.tables(name)
        K = t.profile.n_digits
        w = np.frombuffer(bytes(c.w), np.float32)[:K]
        np.testing.assert_array_equal(w.view(np.int32),
                                      t.W_f32.view(np.int32))
        for i in range(K):
            for j in range(i + 1, K):
                lo = (1 + c.roff[j]) * c.mrc_c[build.rns_pair(i, j)] % 2 ** 32
                assert lo * c.moduli[j] >> 32 == t.mrc_inv[i][j], (i, j)
    assert np.isinf(np.frombuffer(bytes(build.rns_tables_c("rns21").w),
                                  np.float32)).any()


def test_wrappers_count_only_kernel_launches():
    before = (convert_ops.launches, matmul_ops.launches,
              normalize_ops.launches)
    r = _t(_residues("rns9", 8, seed=5))
    normalize_ops.rns_normalize("rns9", r)
    matmul_ops.rns_matmul("rns9", torch.zeros(9, 2, 4, dtype=torch.int8),
                          torch.zeros(9, 4, 2, dtype=torch.int8))
    convert_ops.rns_convert("rns9", torch.ones(4), 1.0, bits=8)
    assert (convert_ops.launches, matmul_ops.launches,
            normalize_ops.launches) == before


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", INT8_SAFE)
def test_gpu_kernels_match_plain(cuda, name):
    p = get_profile(name)
    x = _t(_x(6, (4, 3, 96), 30)).to(cuda)
    for s in _scales(x.cpu().numpy()).values():
        s = torch.as_tensor(np.asarray(s)).to(cuda)
        got = convert_ops.rns_convert(p, x, s, bits=8)
        want = convert_ops.rns_convert_plain(p, x, s, bits=8)
        assert torch.equal(got, want)
    rng = np.random.default_rng(7)
    a = _t(np.stack([rng.integers(0, m, (37, 200)) for m in p.moduli])
           .astype(np.int8)).to(cuda)
    b = _t(np.stack([rng.integers(0, m, (200, 70)) for m in p.moduli])
           .astype(np.int8)).to(cuda)
    assert torch.equal(matmul_ops.rns_matmul(p, a, b),
                       matmul_ops.rns_matmul_plain(p, a, b))
    r = _t(_residues(name, 1000, seed=8)).to(cuda)
    got = normalize_ops.rns_normalize(p, r)
    want = normalize_ops.rns_normalize_plain(p, r)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_normalize_c1_and_rns21(cuda):
    r = _t(encode_exact("rns5", [C1_VALUE, -C1_VALUE])).to(cuda)
    assert normalize_ops.rns_normalize("rns5", r).tolist() == [C1_FLOAT,
                                                               -C1_FLOAT]
    r = _t(_residues("rns21", 500, seed=9)).to(cuda)
    got = normalize_ops.rns_normalize("rns21", r).cpu().numpy()
    want = np.asarray(rns_normalize_ref(jnp.asarray(r.cpu().numpy()),
                                        profile="rns21"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_gpu_normalize_edges_tails_and_misaligned(cuda, name):
    """rns_normalize on the card, bit for bit against its plain version at
    every candidate bt: the edge values among uniform residues; T = 4096,
    8, 4097, 4098, 4099, 1, 2 and 3 (a partial last block, and planes
    that start off a 16-byte boundary when T % 4 != 0); and a contiguous
    [K, T] view 1, 2 or 3 int32 past a 16-byte boundary."""
    from repro_torch.kernels import autotune

    p = get_profile(name)
    K = p.n_digits
    for T in (4096, 8, 4097, 4098, 4099, 1, 2, 3):
        r = _t(_edge_residues(name, T, seed=T)).to(cuda)
        legal, _ = autotune.legal_candidates("rns_normalize", p, (T,))
        assert legal
        for off in (0, 1, 2, 3):
            buf = torch.zeros(K * T + 4, dtype=torch.int32, device=cuda)
            view = buf[off:off + K * T].view(K, T)
            view.copy_(r)
            assert (view.data_ptr() % 16 == 0) == (off == 0)
            want = normalize_ops.rns_normalize_plain(p, view)
            for cand in legal:
                got = normalize_ops.rns_normalize(p, view, **cand)
                assert torch.equal(got.isnan(), want.isnan()), (T, off, cand)
                assert torch.equal(got.nan_to_num(), want.nan_to_num()), (
                    T, off, cand)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rns9", "rns21", "rns8_u8", "rns5"])
def test_gpu_convert_ragged_misaligned_and_wide(cuda, name):
    """rns_convert on the card against its plain version: T not a
    multiple of 4, x a view offset by one element (no float4 loads),
    scalar, per-element and per-row scales, bits 8 and 16, and the
    main path's weight rows; rns8_u8 with int32 residues."""
    p = get_profile(name)
    od = torch.int8 if p.int8_safe else torch.int32
    base = _t(_x(10, (576 * 1536 + 1,), 30)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    shapes = [(7, 143), (13,), (64, 64), (576, 1536), (1536, 576)]
    for shape in shapes:
        T = int(np.prod(shape))
        for off in (0, 1):
            x = base[off:off + T].reshape(shape)
            assert (x.data_ptr() % 16 == 0) == (off == 0)
            scales = [torch.tensor(2.0, device=cuda),
                      1 + 3 * torch.rand(shape, generator=g, device=cuda)]
            if len(shape) == 2:
                scales.append(1 + 3 * torch.rand((shape[0], 1), generator=g,
                                                 device=cuda))
            for sc in scales:
                for bits in (8, 16):
                    got = convert_ops.rns_convert(p, x, sc, bits=bits,
                                                  out_dtype=od)
                    want = convert_ops.rns_convert_plain(p, x, sc, bits=bits,
                                                         out_dtype=od)
                    assert torch.equal(got, want), (shape, off, sc.shape,
                                                    bits)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_convert_refuses_what_it_does_not_index(cuda):
    from repro_torch.core.moduli import RnsProfile, greedy_coprime_moduli

    p = RnsProfile("custom10", greedy_coprime_moduli(128, 10), 2)
    with pytest.raises(ValueError, match="K=10"):
        convert_ops.rns_convert(p, torch.ones(8, device=cuda), 1.0)
