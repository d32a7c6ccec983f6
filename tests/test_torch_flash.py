"""The port's flash_attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel and its oracle.

On the CPU the wrapper takes its plain version; it is held against the
Pallas kernel run in interpret mode (as tests/test_flash_kernel.py runs
it) and against ``flash_attention/ref.py``, within ATOL = 2e-5: the two
sides sum the same float32 products in different orders.  The tests
marked ``gpu`` hold the CUDA kernel against the plain version on the
card at every candidate tiling and skip without one.
"""

import numpy as np
import pytest
import torch
from _hypothesis_stub import given, st

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attention import ops as fa

ATOL = 2e-5     # float32, different summation orders (fa.ATOL)

# tests/test_flash_kernel.py's shapes: (B, Tq, Tk, H, Hk, D)
SHAPES = [(1, 128, 128, 2, 1, 16), (2, 96, 200, 4, 2, 32),
          (1, 17, 33, 2, 2, 64), (1, 130, 257, 2, 1, 32),
          (2, 7, 5, 2, 2, 16), (1, 65, 64, 2, 1, 16)]


@pytest.fixture(autouse=True)
def _own_table(tmp_path, monkeypatch):
    """Keep a developer's tuned table out of the tiles these tests see."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _qkv(seed, shape):
    B, Tq, Tk, H, Hk, D = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Tq, H, D), (B, Tk, Hk, D), (B, Tk, Hk, D)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_matches_pallas(causal, shape):
    q, k, v = _qkv(sum(shape) + causal, shape)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, bq=64,
                             bk=64)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, bq=64, bk=64, interpret=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@given(st.integers(1, 70), st.integers(1, 70), st.booleans())
def test_flash_property_ragged(Tq, Tk, causal):
    """Arbitrary ragged (Tq, Tk) at 32-row tiles: tails mask out."""
    shape = (1, Tq, Tk, 2, 1, 16)
    q, k, v = _qkv(Tq * 97 + Tk * 3 + causal, shape)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, bq=32,
                             bk=32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d,tk_valid", [
    (3, 16, 16, 8, 16), (2, 9, 40, 16, 40), (2, 40, 9, 16, 9),
    (1, 33, 64, 32, 50)])
def test_plain_bhtd_matches_ref(causal, bh, tq, tk, d, tk_valid):
    rng = np.random.default_rng(bh * 1000 + tq + tk + tk_valid)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d)))
    got = fa.flash_attention_plain_bhtd(_t(q), _t(k), _t(v), causal=causal,
                                        tk_valid=tk_valid)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               tk_valid=tk_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_keeps_the_input_dtype():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(3, SHAPES[2]))
    assert fa.flash_attention(q, k, v).dtype == torch.bfloat16


@pytest.mark.parametrize("blocks,dims,why", [
    ({"bq": 128, "bk": 128}, (1, 8, 8, 2, 1, 128), "shared memory"),
    ({"bq": 64, "bk": 64}, (1, 8, 8, 2, 1, 256), "widest head"),
    ({"bq": 48, "bk": 64}, (1, 8, 8, 2, 1, 16), "not compiled"),
])
def test_illegal_tiles_raise(blocks, dims, why):
    q, k, v = (_t(a) for a in _qkv(4, dims))
    with pytest.raises(ValueError, match=why):
        fa.flash_attention(q, k, v, **blocks)


def test_cpu_calls_launch_nothing():
    before = fa.launches
    fa.flash_attention(*(_t(a) for a in _qkv(5, SHAPES[4])))
    assert fa.launches == before


def test_within_tolerance_allows_one_step_of_bfloat16():
    want = torch.tensor([1.0, -0.5, 3e-3], dtype=torch.bfloat16)
    step = torch.tensor([2.0 ** -7, 2.0 ** -8, 2.0 ** -16])
    one = (want.float() + step).to(torch.bfloat16)
    two = (want.float() + 2 * step).to(torch.bfloat16)
    assert fa.within_tolerance(one, want)[0]
    assert not fa.within_tolerance(two, want)[0]
    f = torch.tensor([1.0, 2.0])
    assert fa.within_tolerance(f + 1.5e-5, f)[0]
    assert not fa.within_tolerance(f + 3e-5, f)[0]


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_every_tiling_matches_plain(cuda, dtype):
    for shape in SHAPES + [(1, 120, 120, 9, 3, 64)]:
        q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(6, shape))
        for causal in (True, False):
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            for blocks in autotune.CANDIDATES["flash_attention"]:
                got = fa.flash_attention(q, k, v, causal=causal, **blocks)
                ok, err = fa.within_tolerance(got, want)
                assert ok, (shape, causal, blocks, err)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_wrapper_counts_launches_and_blocks(cuda):
    q, k, v = (_t(a).to(cuda) for a in _qkv(7, SHAPES[1]))
    before = fa.launches
    fa.flash_attention(q, k, v, bq=32, bk=128)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert autotune.last_launch["flash_attention"][1] == {"bq": 32,
                                                          "bk": 128}
