"""``scripts/kernel_variants.py`` builds its variants on the card by
regular-expression substitutions on kernel sources; a substitution that
matches nothing stops the script there.  Each study's every
substitution is held against its source here, on the CPU."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", ROOT / "scripts" / "kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KV = _script()


def _source(key: str) -> Path:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rns_convert import ops as co
    from repro_torch.kernels.rns_fused import ops as fo
    from repro_torch.kernels.rns_matmul import ops as mm
    from repro_torch.kernels.rns_normalize import ops as no

    return {"rns_matmul": mm.SOURCE, "rns_fused_mma": fo.SOURCE,
            "rns_convert": co.SOURCE, "flash_attention": fa.SOURCE,
            "rns_normalize": no.SOURCE,
            "one_digit": KV.ONE_DIGIT_SOURCE,
            "normalize_two_pass": KV.TWO_PASS_SOURCE,
            "normalize_elems": KV.ELEMS_SOURCE}[key]


@pytest.mark.parametrize("study", sorted(KV.STUDIES))
def test_every_substitution_matches_its_source(study):
    for name, variant in KV.STUDIES[study][1].items():
        key, subs = KV.variant_source(study, variant)
        text = _source(key).read_text()
        for pattern, replacement in subs:
            text, n = re.subn(pattern, replacement, text)
            assert n, (study, name, pattern)
