"""The port's block table (repro_torch.kernels.autotune) and its Hopper
tile checker (repro_torch.analysis.kernel_audit), held against the JAX
package's autotuner where they share a contract: the same buckets and
keys, lookup, measure -> persist -> reload, corruption tolerance.

The tests marked ``gpu`` run every RNS kernel against its plain version
at every candidate tiling on the card, and the built-in bench."""

import json
import logging

import numpy as np
import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro_torch.analysis import kernel_audit as ka
from repro_torch.core.moduli import PROFILES, get_profile
from repro_torch.kernels import autotune, wrappers
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MATMUL_KINDS = ("rns_matmul", "rns_fused_encode_matmul",
                "rns_fused_matmul_normalize", "rns_fused_dot")
# the main path's inputs at smollm-135m rns9 (d_model 576, d_ff 1536,
# decode rows 8, prefill pad 144), as shapes the wrappers bucket on
MAIN_PATH_SHAPES = {
    "rns_convert": [(576 * 1536,), (8 * 1536,), (8 * 576,), (144 * 1536,),
                    (144 * 576,)],
    "rns_normalize": [(8 * 1536,), (8 * 576,), (144 * 1536,), (144 * 576,)],
    **{k: [(8, 576, 1536), (8, 1536, 576), (144, 576, 1536),
           (144, 1536, 576)] for k in MATMUL_KINDS},
    "flash_attention": [(120, 120, 64), (2048, 2048, 64)],
}


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_cache()
    yield path
    autotune.clear_cache()


def _profile(kind):
    return "float32" if kind == "flash_attention" else "rns9"


# ------------------------------------------------- buckets and keys ----
@pytest.mark.parametrize("seed", range(6))
def test_buckets_and_keys_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for kind in autotune.DEFAULTS:
        nd = {"rns_convert": 1, "rns_normalize": 1}.get(kind, 3)
        shape = tuple(int(d) for d in rng.integers(1, 5000, nd))
        assert autotune.shape_bucket(shape) == j_autotune.shape_bucket(shape)
        prof = _profile(kind)
        assert autotune._key(kind, prof, shape, "cpu") == \
            j_autotune._key(kind, prof, shape, "cpu")
        card = "NVIDIA H100 80GB HBM3"
        assert autotune._key(kind, prof, shape, card) == \
            j_autotune._key(kind, prof, shape, "cpu")[:-3] + card
    for n in (0, 1, 8, 9, 127, 128, 129, 5000):
        assert autotune.pow2_at_least(n) == j_autotune.pow2_at_least(n)


def test_backend_tag_of_a_device():
    assert autotune._backend_tag(torch.device("cpu")) == "cpu"
    assert autotune._backend_tag("cpu") == "cpu"


# ------------------------------------------------------------ lookup ----
def test_get_blocks_defaults_without_cache(tmp_cache):
    assert autotune.get_blocks("rns_matmul", "rns9", (64, 256, 64)) == {
        "bm": 32, "bn": 64}
    assert autotune.get_blocks("rns_fused_dot", "rns9", (8, 576, 1536)) == {
        "bm": 16, "bn": 32}
    assert autotune.get_blocks("rns_fused_encode_matmul", "rns9",
                               (8, 576, 1536)) == {"bm": 16, "bn": 32}
    assert autotune.get_blocks("rns_normalize", "rns9", (100,)) == {"bt": 256}
    assert autotune.get_blocks("rns_convert", "rns9", (100,)) == {"bt": 256}
    assert autotune.get_blocks("flash_attention", "float32",
                               (120, 120, 64)) == {"bq": 64, "bk": 64}
    assert not tmp_cache.exists()      # a pure lookup never writes


def test_tune_picks_argmin_and_persists(tmp_cache):
    want = {"bm": 64, "bn": 64}

    def fake_bench(blocks):
        return 0.001 if blocks == want else 1.0

    got = autotune.tune("rns_matmul", "rns9", (64, 256, 64), "cpu",
                        bench_fn=fake_bench, repeats=1)
    assert got == want
    data = json.loads(tmp_cache.read_text())
    assert data["version"] == 1
    (key, entry), = data["entries"].items()
    assert key == "rns_matmul|rns9|64x256x64|cpu"
    assert entry["blocks"] == want

    autotune.clear_cache()             # reload from disk
    assert autotune.get_blocks("rns_matmul", "rns9", (64, 256, 64),
                               "cpu") == want
    assert autotune.get_blocks("rns_matmul", "rns9", (512, 512, 512),
                               "cpu") == autotune.DEFAULTS["rns_matmul"]


def test_tune_clears_the_lookup_memo():
    shape = (4096,)
    assert autotune.get_blocks("rns_normalize", "rns9", shape,
                               "cpu") == {"bt": 256}
    autotune.tune("rns_normalize", "rns9", shape, "cpu",
                  bench_fn=lambda b: 0.0 if b["bt"] == 128 else 1.0,
                  repeats=1)
    assert autotune.get_blocks("rns_normalize", "rns9", shape,
                               "cpu") == {"bt": 128}


def test_wrappers_resolve_through_the_table():
    autotune.tune("rns_convert", "rns9", (100,), "cpu",
                  bench_fn=lambda b: 0.0 if b["bt"] == 512 else 1.0,
                  repeats=1)
    cpu = torch.device("cpu")
    key, blk = autotune.resolve("rns_convert", "rns9", (99,), cpu)
    assert blk == {"bt": 512} and key == "rns_convert|rns9|128|cpu"
    assert autotune.resolve("rns_convert", "rns9", (99,), cpu,
                            bt=1024)[1] == {"bt": 1024}
    x = torch.linspace(-3, 3, 99)
    from repro_torch.kernels.rns_convert.ops import (rns_convert,
                                                     rns_convert_plain)
    assert torch.equal(rns_convert("rns9", x, 2.0, bits=8),
                       rns_convert_plain("rns9", x, 2.0, bits=8))


def test_resolve_memo_hit_is_one_lookup_and_gates_once(monkeypatch):
    """A repeated call with no explicit tiles returns the memoized
    answer (same objects, no checker run); explicit tiles are gated on
    every call; clear_cache and tune drop the memo."""
    cpu = torch.device("cpu")
    gated = []
    real = autotune._gate
    monkeypatch.setattr(autotune, "_gate",
                        lambda *a: (gated.append(a[0]), real(*a)))
    first = autotune.resolve("rns_matmul", "rns9", (8, 576, 1536), cpu)
    again = autotune.resolve("rns_matmul", "rns9", (8, 576, 1536), cpu,
                             bm=None, bn=None)
    assert again is first and len(gated) == 1
    assert first == ("rns_matmul|rns9|8x1024x2048|cpu",
                     autotune.DEFAULTS["rns_matmul"])
    _, blk = autotune.resolve("rns_matmul", "rns9", (8, 576, 1536), cpu,
                              bm=64)
    assert blk == {"bm": 64, "bn": 64} and len(gated) == 2
    assert first[1] == autotune.DEFAULTS["rns_matmul"]  # memo untouched
    with pytest.raises(ValueError, match="not compiled"):
        autotune.resolve("rns_matmul", "rns9", (8, 576, 1536), cpu, bm=16)
    autotune.tune("rns_matmul", "rns9", (8, 576, 1536), "cpu",
                  bench_fn=lambda b: 0.0 if b["bm"] == 64 else 1.0,
                  repeats=1)
    assert autotune.resolve("rns_matmul", "rns9", (8, 576, 1536),
                            cpu)[1] == {"bm": 64, "bn": 64}
    autotune.clear_cache()
    n = len(gated)
    autotune.resolve("rns_matmul", "rns9", (8, 576, 1536), cpu)
    assert len(gated) == n + 1


def test_wrappers_gate_a_profile_outside_the_named_ones():
    """A profile object that is not in PROFILES is gated on its own digit
    count (a K the normalize kernel lacks skips the gate on the CPU)."""
    from repro_torch.core.moduli import RnsProfile, greedy_coprime_moduli
    from repro_torch.kernels.rns_matmul.ops import rns_matmul
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    p = RnsProfile("custom10", greedy_coprime_moduli(128, 10), 2)
    a = torch.ones(10, 3, 4, dtype=torch.int8)
    assert rns_matmul(p, a, torch.ones(10, 4, 2, dtype=torch.int8)).shape \
        == (10, 3, 2)
    assert rns_normalize(p, torch.zeros(10, 5, dtype=torch.int32)).shape \
        == (5,)
    with pytest.raises(ValueError, match="not compiled"):
        rns_matmul(p, a, torch.ones(10, 4, 2, dtype=torch.int8), bn=16)


def test_resolve_gates_flash_on_the_value_width():
    """flash's Dv is not in its key (Tq, Tk, D), so it travels as a
    checker dim and is part of the memo key."""
    cpu = torch.device("cpu")
    autotune.resolve("flash_attention", "float32", (8, 8, 64), cpu,
                     dims=(("Dv", 64),))
    with pytest.raises(ValueError, match="Dv=256"):
        autotune.resolve("flash_attention", "float32", (8, 8, 64), cpu,
                         dims=(("Dv", 256),))


def test_tune_without_a_card_or_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.tune("rns_matmul", "rns9", (8, 64, 64))


# -------------------------------------------------------- corruption ----
@pytest.mark.parametrize("payload", [
    "{not json",                                         # invalid JSON
    "[1, 2, 3]",                                         # wrong top level
    '{"version": 99, "entries": {}}',                    # future version
    '{"version": 1, "entries": 5}',                      # entries wrong type
    '{"version": 1, "entries": {"k": "junk"}}',          # row wrong type
    '{"version": 1, "entries": {"k": {"us": 1.0}}}',     # row missing blocks
    '{"version": 1, "entries": {"k": {"blocks": ["bm"]}}}',
    '{"version": 1, "entries": {"k": {"blocks": {"bm": "big"}}}}',
    '{"version": 1, "entries": {"k": {"blocks": {"evil": 8}}}}',
    '{"version": 1, "entries": {"k": {"blocks": {"bm": -8}}}}',
    '{"version": 1, "entries": {"k": {"blocks": {"bm": true}}}}',
])
def test_corrupt_cache_falls_back_to_defaults(tmp_cache, payload):
    tmp_cache.write_text(payload)
    autotune.clear_cache()
    assert autotune.get_blocks("rns_matmul", "rns9", (64, 256, 64)) == \
        autotune.DEFAULTS["rns_matmul"]
    assert autotune.get_blocks("rns_normalize", "rns9", (100,)) == \
        autotune.DEFAULTS["rns_normalize"]


def test_corrupt_cache_survives_partial_poisoning(tmp_cache):
    good_key = autotune._key("rns_matmul", "rns9", (64, 256, 64), "cpu")
    tmp_cache.write_text(json.dumps({
        "version": 1,
        "entries": {
            good_key: {"blocks": {"bm": 64, "bn": 64}},
            "bad-row": {"blocks": {"bm": "nope"}},
            3: {"blocks": {"bm": 64}},
        }}))
    autotune.clear_cache()
    assert autotune.get_blocks("rns_matmul", "rns9", (64, 256, 64),
                               "cpu") == {"bm": 64, "bn": 64}


def test_tune_rewrites_corrupt_cache(tmp_cache):
    tmp_cache.write_text("{definitely not json")
    autotune.clear_cache()
    want = {"bm": 32, "bn": 32}
    autotune.tune("rns_fused_dot", "rns9", (32, 64, 32), "cpu",
                  bench_fn=lambda b: 0.0 if b == want else 1.0, repeats=1)
    data = json.loads(tmp_cache.read_text())
    assert data["version"] == 1
    (entry,) = data["entries"].values()
    assert entry["blocks"] == want
    autotune.clear_cache()
    assert autotune.get_blocks("rns_fused_dot", "rns9", (32, 64, 32),
                               "cpu") == want


@pytest.mark.parametrize("key,blocks,why", [
    ("flash_attention|float32|128x128x128|cpu", {"bq": 128, "bk": 128},
     "shared memory"),
    ("rns_normalize|rns21|4096|cpu", {"bt": 512}, "registers"),
    # a row of the fused dot's CUDA-core template: its tiles are not compiled
    # on the tensor-core kernel, so the row resolves to the new default
    ("rns_fused_dot|rns9|8x1024x2048|cpu", {"bm": 8, "bn": 16},
     "not compiled"),
    # a row of the fused encode + matmul's retired CUDA-core template
    ("rns_fused_encode_matmul|rns5|8x512x512|cpu", {"bm": 8, "bn": 16},
     "not compiled"),
    ("rns_matmul|rns9|8x512x512|cpu", {"bm": 128, "bn": 128},
     "not compiled"),
    ("rns_matmul|rns9|8x512x512|cpu", {"bm": 32, "bn": 64, "bk": 32},
     "unknown block 'bk'"),
    ("rns_matmul|nosuchprofile|8x512x512|cpu", {"bm": 32}, "unreadable"),
])
def test_illegal_rows_dropped_with_a_reason(tmp_cache, caplog, key, blocks,
                                            why, capped_registers):
    """A structurally valid row whose tiles are illegal on Hopper (hand
    edited, or from another card's limits) is dropped with the checker's
    reason logged; lookups fall back to the defaults.  (The rns21 row is
    held to a synthetic register model that refuses it.)"""
    tmp_cache.write_text(json.dumps({"version": 1, "entries": {
        key: {"blocks": blocks}}}))
    autotune.clear_cache()
    kind, prof, dims, _ = key.split("|")
    shape = tuple(int(d) for d in dims.split("x"))
    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        got = autotune.get_blocks(kind, prof, shape, "cpu")
    assert got == autotune.DEFAULTS[kind]
    assert any("dropping illegal cache row" in r.message and why in
               r.getMessage() for r in caplog.records)


def test_tune_skips_illegal_candidates(caplog):
    seen = []

    def bench(blocks):
        seen.append(dict(blocks))
        return 1.0

    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        autotune.tune("flash_attention", "float32", (256, 256, 128), "cpu",
                      bench_fn=bench, repeats=1)
    # float32 K and V tiles of 128 keys at D = 128 need 270 336 bytes of
    # shared memory, whatever bq is: the three bk = 128 candidates go
    assert all(b["bk"] != 128 for b in seen)
    assert len(seen) == len(autotune.CANDIDATES["flash_attention"]) - 3
    assert any("skipping illegal candidate" in r.getMessage()
               for r in caplog.records)


# ------------------------------------------------------------ checker ----
#: a synthetic register model of rns_normalize, heavy enough at wide K
#: that the register rule refuses bt 512 at rns16 and rns21: it exercises
#: the rule, which the shipped kernel (every bt fits) never meets
CAPPED_REGISTERS = {5: 30, 6: 30, 7: 30, 8: 39, 9: 48, 12: 95, 16: 180,
                    18: 215, 21: 255}


@pytest.fixture
def capped_registers(monkeypatch):
    """Hold rns_normalize to the synthetic :data:`CAPPED_REGISTERS` (the
    shipped kernel fits every bt:
    test_one_pass_normalize_fits_every_candidate), with the checker's
    memo cleared around it."""
    monkeypatch.setitem(ka.REGISTERS, "rns_normalize", CAPPED_REGISTERS)
    ka._check_cached.cache_clear()
    autotune.clear_cache()
    yield
    ka._check_cached.cache_clear()
    autotune.clear_cache()


def test_one_pass_normalize_fits_every_candidate():
    """The one-pass normalize keeps one residue copy in registers: every
    candidate bt is legal for every digit count, rns21's 512 included."""
    from repro_torch.kernels.rns_normalize.ops import SUPPORTED_K

    for K in SUPPORTED_K:
        assert ka.REGISTERS["rns_normalize"][K] <= 64
        for cand in autotune.CANDIDATES["rns_normalize"]:
            assert ka.validate_blocks("rns_normalize", cand,
                                      n_digits=K) == [], (K, cand)


@pytest.mark.parametrize("kind", sorted(autotune.DEFAULTS))
def test_every_default_and_candidate_is_legal_on_the_main_path(kind):
    prof = _profile(kind)
    for shape in MAIN_PATH_SHAPES[kind]:
        legal, dropped = autotune.legal_candidates(kind, prof, shape)
        assert not dropped, (shape, dropped)
        assert autotune._violations(kind, prof, shape,
                                    autotune.DEFAULTS[kind]) == []
        assert len(legal) >= 2


@pytest.mark.parametrize("kind,blocks,meta,why", [
    ("flash_attention", {"bq": 128, "bk": 128}, dict(dims={"D": 128}),
     "270336 bytes of shared memory per block > 232448"),
    ("rns_normalize", {"bt": 512}, dict(n_digits=21),
     "512 threads x 255 registers = 131072 > 65536"),
    ("rns_normalize", {"bt": 512}, dict(n_digits=16), "registers"),
    ("rns_fused_dot", {"bm": 32, "bn": 64},
     dict(n_digits=21, res_bytes=1), "1344 threads per block > 1024"),
    ("rns_fused_encode_matmul", {"bm": 16, "bn": 32},
     dict(n_digits=9, res_bytes=1, lazy_chunk=100),
     "K tile 128 > lazy_chunk - 1 = 99"),
    ("rns_fused_matmul_normalize", {"bm": 16, "bn": 32},
     dict(n_digits=9, lazy_chunk=50), "K tile 64 > lazy_chunk - 1 = 49"),
    ("rns_fused_encode_matmul", {"bm": 16, "bn": 16},
     dict(n_digits=5, res_bytes=1), "tile 16x16 is not compiled"),
    ("rns_matmul", {"bm": 32, "bn": 64},
     dict(n_digits=9, lazy_chunk=20), "lazy_chunk - 1 = 19"),
    ("rns_fused_dot", {"bm": 16, "bn": 32, "bk": 64}, dict(n_digits=9),
     "unknown block 'bk'"),
    ("rns_convert", {"bt": 2048}, dict(n_digits=9), "threads per block"),
    ("rns_convert", {"bt": 100}, dict(n_digits=9), "multiple of 32"),
    ("rns_fused_dot", {"bm": 8, "bn": 16}, dict(n_digits=9),
     "not compiled"),
    ("rns_fused_encode_matmul", {"bm": 8, "bn": 64}, dict(n_digits=9),
     "not compiled"),
    ("rns_normalize", {"bt": 256}, dict(n_digits=10), "no instantiation"),
    ("rns_matmul", {"bm": "big", "bn": 64}, {},
     "need a positive int"),
    ("rns_matmul", {"bm": 32}, {}, "'bn' is None"),
    ("no_such_kernel", {"bt": 256}, {}, "unknown kernel kind"),
])
def test_checker_names_known_illegal_cases(kind, blocks, meta, why,
                                           capped_registers):
    """(rns_normalize's register cases under a synthetic register model
    that refuses bt 512 at wide K.)"""
    bad = ka.validate_blocks(kind, blocks, **meta)
    assert any(why in b for b in bad), bad


def test_checker_gate_raises_value_error_naming_kernel_and_bytes():
    # rns21 at 32 x 64: 1344 threads; its ring (32 deep, 3 stages), the
    # dot's residue, quantized and scale tiles and the flag need 213648
    # bytes
    with pytest.raises(ValueError, match=r"rns_fused_dot: illegal block "
                       r"config .*\(213648 bytes of shared memory "
                       r".* 1344 threads"):
        ka.check_wrapper_blocks("rns_fused_dot", {"bm": 32, "bn": 64},
                                n_digits=21, res_bytes=1)
    ka.check_wrapper_blocks("rns_fused_dot", {"bm": 16, "bn": 32},
                            n_digits=21, res_bytes=1)
    # the retired CUDA-core tile on rns_fused_mma.cu's model, the dot's:
    # rns21's shallowest ring, its digits' tiles, the quantized tile, the
    # row scales and the flag
    with pytest.raises(ValueError, match=r"rns_fused_encode_matmul: "
                       r"illegal block config .*\(174160 bytes .* not "
                       r"compiled"):
        ka.check_wrapper_blocks("rns_fused_encode_matmul",
                                {"bm": 16, "bn": 16}, n_digits=21,
                                res_bytes=1)


def test_checker_models_the_launch_code():
    """Shared memory as rns_fused_mma.cu / rns_matmul.cu /
    flash_attention.cu allocate it, and the register caps ptxas applies
    under __launch_bounds__."""
    # the fused encode + matmul stages and quantizes x as the dot does, K
    # x bn threads, and its stored residues need no parked tile beyond the
    # dot's
    for K in (5, 9, 21):
        blk = {"bm": 32, "bn": 64}
        assert ka.smem_bytes("rns_fused_encode_matmul", blk, K, 1) == \
            ka.smem_bytes("rns_fused_dot", blk, K, 1)
        assert ka.fused_ring("rns_fused_encode_matmul", K, 32, 64) == \
            ka.fused_ring("rns_fused_dot", K, 32, 64)
        assert ka.threads("rns_fused_encode_matmul", blk, K) == K * 64
    # rns9 at 16 x 32 takes the deepest ring, 128 deep in 3 stages: b's
    # 9 tiles [128][32 + 16] and x [16][128 + 4] floats a stage, then the
    # 9 u8 tiles [16][128 + 16], quantized x [16][128 + 16] ints, 16 row
    # scales and the 16-byte flag
    assert ka.fused_ring("rns_fused_dot", 9, 16, 32) == (128, 3)
    assert ka.smem_bytes("rns_fused_dot", {"bm": 16, "bn": 32}, 9, 1) == \
        3 * (9 * 128 * 48 + 4 * 16 * 132) + 9 * 16 * 144 + 4 * 16 * 144 \
        + 4 * 16 + 16
    # rns8_u8 (int32 b, narrowed while staged): a's 8 tiles are sized for
    # int32 residues [16][64 + 16], so the ring is 64 deep in 3 stages
    assert ka.fused_ring("rns_fused_matmul_normalize", 8, 16, 32) == (64, 3)
    assert ka.smem_bytes("rns_fused_matmul_normalize",
                         {"bm": 16, "bn": 32}, 8, 4) == \
        3 * (8 * 64 * 48 + 4 * 8 * 16 * 80) + 16
    # rns21: only a 32-deep ring in 2 stages fits
    assert ka.fused_ring("rns_fused_matmul_normalize", 21, 16, 32) == (32, 2)
    assert ka.register_cap(9 * 32) == 224
    # 3 stages of A [bm][128 + 16] and B [128][bn + 16] bytes
    assert ka.smem_bytes("rns_matmul", {"bm": 32, "bn": 64}) == \
        3 * (32 * 144 + 128 * 80)
    # 2 stages of K and V [bk][DP + pad], DP = 64 for D = 48
    assert ka.smem_bytes("flash_attention", {"bq": 32, "bk": 64}, 1, 4,
                         {"D": 48}) == 4 * 2 * 2 * 64 * 68
    assert ka.smem_bytes("flash_attention", {"bq": 32, "bk": 64}, 1, 2,
                         {"D": 48}) == 2 * 2 * 2 * 64 * 72
    assert ka.register_cap(256) == 255
    assert ka.register_cap(32 * 9) == 224
    assert ka.register_cap(32 * 21) == 96


@pytest.mark.parametrize("kind", ["rns_fused_dot",
                                  "rns_fused_matmul_normalize",
                                  "rns_fused_encode_matmul"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_every_profile_has_a_legal_tensor_core_fused_tile(kind, profile):
    """The tensor-core fused kernels have a legal tile at every profile,
    the default among them; every candidate is compiled, and those the
    checker drops go for their thread count (K x bn > 1024) or because
    no ring fits in shared memory (wide K, int32-sized a tiles)."""
    K = get_profile(profile).n_digits
    legal, dropped = autotune.legal_candidates(kind, profile, (8, 576, 1536))
    assert autotune.DEFAULTS[kind] in legal
    assert all((c["bm"], c["bn"]) in ka.FUSED_MMA_TILES
               for c in autotune.CANDIDATES[kind])
    for cand, why in dropped:
        assert ("threads per block" in why and K * cand["bn"] > 1024) or \
            "bytes of shared memory" in why, why
    for c in legal:
        assert ka.fused_ring(kind, K, c["bm"], c["bn"]) is not None


def test_wrappers_refuse_an_illegal_tile_on_the_cpu(capped_registers):
    from repro_torch.kernels.rns_matmul.ops import rns_matmul
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    a = torch.zeros(9, 2, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="not compiled"):
        rns_matmul("rns9", a, torch.zeros(9, 4, 2, dtype=torch.int8), bm=16)
    with pytest.raises(ValueError, match="registers"):
        rns_normalize("rns21", torch.zeros(21, 8, dtype=torch.int32), bt=512)


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [k for k in autotune.DEFAULTS
                                  if k != "flash_attention"])
def test_gpu_every_tiling_matches_plain(cuda, kind):
    wrapper, plain = wrappers()[kind]
    rng = np.random.default_rng(1)
    for name in ("rns9", "rns5", "rns21", "rns8_u8"):
        shape = (5000,) if kind in ("rns_convert", "rns_normalize") \
            else (13, 130, 37)
        args, kw = autotune._random_call(kind, name, shape, cuda, rng)
        want = plain(name, *args, **kw)
        legal, _ = autotune.legal_candidates(kind, name, shape)
        for blocks in legal:
            got = wrapper(name, *args, **kw, **blocks)
            if got.dtype.is_floating_point:
                assert torch.equal(got.nan_to_num(), want.nan_to_num())
            else:
                assert torch.equal(got, want), (name, blocks)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_tune_measures_and_persists(cuda, tmp_cache):
    best = autotune.tune("rns_normalize", "rns9", (4096,), repeats=1)
    assert best in [dict(c) for c in autotune.CANDIDATES["rns_normalize"]]
    (key,) = json.loads(tmp_cache.read_text())["entries"]
    assert key.endswith(torch.cuda.get_device_name(0))


def test_profiles_table_covers_every_normalize_instantiation():
    from repro_torch.kernels.rns_normalize.ops import SUPPORTED_K

    assert set(ka.REGISTERS["rns_normalize"]) == set(SUPPORTED_K)
    assert {get_profile(p).n_digits for p in PROFILES} <= set(SUPPORTED_K)


def test_registers_table_covers_every_convert_instantiation():
    """rns_convert.cu instantiates every digit count for int8 and int32
    residues; the checker's model names each, and a digit count without
    an instantiation has no model (the wrapper refuses it on the card)."""
    from repro_torch.kernels.rns_convert.ops import SUPPORTED_K

    for out in ("int8", "int32"):
        assert set(ka.REGISTERS["rns_convert"][out]) == set(SUPPORTED_K)
    assert ka.registers_per_thread("rns_convert", 9, 1) == \
        ka.REGISTERS["rns_convert"]["int8"][9]
    assert ka.registers_per_thread("rns_convert", 10, 1) is None
    assert any("no instantiation for K=10" in b for b in ka.validate_blocks(
        "rns_convert", {"bt": 256}, n_digits=10, res_bytes=1))
