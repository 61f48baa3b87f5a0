"""The traffic generator: the reference's corpora, seeded."""
import numpy as np
import pytest

from finitestateentropy_tpu_torch.utils.probagen import generate_proba
from h100_bench.traffic.proba_pool import make_pool, proba_stream


@pytest.mark.parametrize("percent", [80, 14, 2, 0])
def test_lcg_seed_1_is_the_reference_corpus(percent):
    n = 200_003
    assert proba_stream(percent, n, 1).tobytes() == generate_proba(percent, n)
    assert proba_stream(percent, n, 2).tobytes() != generate_proba(percent, n)


def test_pool_is_a_function_of_the_seed():
    params = {"percent": 80, "call_bytes": 50_000, "pool": 6, "streams": 2,
              "stream_bytes": 100_000}
    a, b = make_pool(params, 2**33 + 17), make_pool(params, 2**33 + 17)
    c = make_pool(params, 5)
    assert [len(x) for x in a] == [50_000] * 6
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert len({x.tobytes() for x in a}) == 6      # rotations are distinct


def test_cuts_of_one_stream():
    params = {"percent": 80, "call_bytes": 1000, "pool": 5, "streams": 1,
              "stream_bytes": 5000}
    pool = make_pool(params, 3)
    assert np.array_equal(np.concatenate(pool), make_pool(
        dict(params, call_bytes=5000, pool=1), 3)[0])
