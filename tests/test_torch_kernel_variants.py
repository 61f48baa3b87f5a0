"""utils/kernel_variants.py, the variant builder PERF.md's ablations come
from: every variant's substitutions still match the committed kernel
sources once each, and the tool refuses to run without a card."""
import pytest
import torch

from finitestateentropy_tpu_torch.turbo._build import CSRC
from finitestateentropy_tpu_torch.utils import kernel_variants as kv


@pytest.mark.parametrize("name", list(kv.VARIANTS))
def test_variant_substitutions_match_the_sources(name):
    src, subs = kv.VARIANTS[name]
    text = kv.variant_source(name)
    assert (text == (CSRC / f"{src}.cu").read_text()) == (not subs)
    for _old, new in subs:
        assert new in text


def test_timing_only_variants_exist():
    assert set(kv.TIMING_ONLY) <= set(kv.VARIANTS)


def test_variants_need_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kv.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
