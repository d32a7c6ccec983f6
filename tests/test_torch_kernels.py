"""The port's three kernel modules (repro_torch.kernels) against the JAX
package's Pallas kernels, bit for bit.

On the CPU a wrapper takes its kernel's plain version; those are held
against the Pallas kernels in interpret mode (convert, matmul) or their
``ref.py`` oracle (normalize: ROADMAP C.1, the interpreted kernel's sum
is FMA-contracted).  The tests marked ``gpu`` hold each CUDA kernel
against its plain version on the card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rns_convert.ops import rns_convert as j_convert
from repro.kernels.rns_convert.ref import rns_convert_ref
from repro.kernels.rns_matmul.ops import rns_matmul as j_matmul
from repro.kernels.rns_matmul.ref import rns_matmul_ref
from repro.kernels.rns_normalize.ref import rns_normalize_ref
from repro_torch.core.moduli import PROFILES, get_profile
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


def test_normalize_c1_regression():
    r = encode_exact("rns5", [C1_VALUE, -C1_VALUE])
    got = normalize_ops.rns_normalize("rns5", _t(r)).numpy()
    assert got.tolist() == [C1_FLOAT, -C1_FLOAT]


def test_tables_struct_carries_float32_bits():
    """The by-value kernel tables hold the float32 weights bit for bit,
    inf included (rns21), and the MRC inverses at stride RNS_MAX_K."""
    for name in ("rns9", "rns21"):
        c = build.rns_tables_c(name)
        t = normalize_ops.mrc.tables(name)
        K = t.profile.n_digits
        w = np.frombuffer(bytes(c.w), np.float32)[:K]
        np.testing.assert_array_equal(w.view(np.int32),
                                      t.W_f32.view(np.int32))
        inv = np.frombuffer(bytes(c.inv), np.int32).reshape(21, 21)
        np.testing.assert_array_equal(inv[:K, :K], t.mrc_inv)
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
