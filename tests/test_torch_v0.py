"""The v0 TurboFSE decode (turbo/kernels.py) against the JAX package.

Frames come from the port's turbo_fse_compress; the plain PyTorch version
of turbo_fse_decode on the CPU must equal JAX turbo_fse_decode in
interpret mode in both out and err (the final cursor), as
tests/test_turbo.py:68-90 composes it: turbo_fse_compress -> parse_group
-> pack_dtable -> turbo_fse_decode.  Tests marked ``gpu`` hold the CUDA
kernel against the plain version.  Tolerance is 0: the codec is integer.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                       turbo_fse_compress,
                                                       turbo_fse_decompress)
from finitestateentropy_tpu_torch.turbo.kernels import (stage_groups,
                                                        turbo_fse_decode,
                                                        turbo_fse_decode_plain)
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.utils import generate_proba

CORPORA = {"p80": 80, "p14": 14, "p02": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _batch(datas):
    """Staged decode inputs of the datas' v0 frames, and the frames."""
    blobs = [turbo_fse_compress(d) for d in datas]
    arrays = stage_groups([parse_group(b)[0] for b in blobs])
    return arrays, blobs


def _tensors(device, cs, tbl, init, streams):
    ins = to_tensors(device, csize_bits=cs, tables=tbl, init_states=init,
                     streams=streams)
    return ins["csize_bits"], ins["tables"], ins["init_states"], ins["streams"]


def _jax_decode(cs, tbl, init, streams, t4, wrows):
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.kernels import turbo_fse_decode as j_decode

    out, err = j_decode(*(jnp.asarray(a) for a in (cs, tbl, init, streams)),
                        t4, wrows, True)
    return np.asarray(out), np.asarray(err)


def _check_against_jax(datas, flip=None):
    """Port plain decode vs JAX interpret on the datas' frames (one padded
    size); flip = (group, row, col, bit) corrupts one payload bit.
    Returns the port's err."""
    (cs, tbl, init, streams, t4, wrows), _blobs = _batch(datas)
    if flip is not None:
        g, r, c, b = flip
        streams[g, r, c] ^= 1 << b
    j_out, j_err = _jax_decode(cs, tbl, init, streams, t4, wrows)
    out, err = turbo_fse_decode(*_tensors("cpu", cs, tbl, init, streams), t4,
                                wrows)
    if flip is None:
        assert np.array_equal(out.numpy(), j_out)
        assert np.array_equal(err.numpy(), j_err) and not j_err.any()
        for j, d in enumerate(datas):
            assert out[j].numpy().tobytes()[:len(d)] == d
    else:
        assert ((err.numpy() != 0) == (j_err != 0)).all()
    return err


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("n", [12288, 65536])
def test_plain_v0_decode_matches_jax_interpret(name, n):
    """8-64 KiB groups (12 KiB: below it Proba2 frames go raw)."""
    datas = [generate_proba(CORPORA[name], n),
             generate_proba(CORPORA[name], 2 * n)[n:]]
    _check_against_jax(datas)


def test_plain_v0_decode_small_table_log():
    data = generate_proba(80, 5000)
    assert parse_group(turbo_fse_compress(data))[0].table_log < 11
    _check_against_jax([data])


def test_plain_v0_decode_one_mib_plus_one():
    """1028 steps: the JAX kernel's 8-row stream window slides down the
    whole stream; the direct read here must match it bit for bit."""
    _check_against_jax([generate_proba(80, (1 << 20) + 1)])


def test_flipped_payload_bit_flags_only_its_group():
    datas = [generate_proba(p, 65536) for p in (80, 14, 2)]
    err = _check_against_jax(datas, flip=(1, 3, 5, 7))
    assert (err != 0).tolist() == [False, True, False]


def test_batch_decode_equals_twin_decompress():
    """Groups of one padded size but different payload lengths batch into
    one call; each decodes to the twin's output."""
    datas = [generate_proba(80, 40000), generate_proba(14, 40960),
             generate_proba(2, 37000)]
    (cs, tbl, init, streams, t4, wrows), blobs = _batch(datas)
    assert len({len(b) for b in blobs}) == 3
    out, err = turbo_fse_decode_plain(*_tensors("cpu", cs, tbl, init, streams),
                                      t4, wrows)
    assert err.tolist() == [0, 0, 0]
    for j, (d, b) in enumerate(zip(datas, blobs)):
        assert out[j].numpy().tobytes()[:len(d)] == d == turbo_fse_decompress(b)


def test_stage_groups_rejects_mixed_batches():
    g80 = parse_group(turbo_fse_compress(generate_proba(80, 8192)))[0]
    g_big = parse_group(turbo_fse_compress(generate_proba(80, 20000)))[0]
    rle = parse_group(turbo_fse_compress(b"Q" * 8192))[0]
    for groups in ([g80, g_big], [g80, rle]):
        with pytest.raises(ValueError, match="one padded size"):
            stage_groups(groups)


@pytest.mark.gpu
def test_cuda_v0_decode_matches_plain(cuda):
    datas = [generate_proba(p, 1 << 20) for p in (80, 14, 2)]
    (cs, tbl, init, streams, t4, wrows), _blobs = _batch(datas)
    streams[1, 7, 9] ^= 1 << 11                   # corrupt group 1
    args = (*_tensors(cuda, cs, tbl, init, streams), t4, wrows)
    before = rk.launches["turbo_fse_decode:v0"]
    out, err = turbo_fse_decode(*args)
    torch.cuda.synchronize()
    assert rk.launches["turbo_fse_decode:v0"] == before + 1
    p_out, p_err = turbo_fse_decode_plain(*args)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert (err != 0).tolist() == [False, True, False]
    for j in (0, 2):
        assert out[j].cpu().numpy().tobytes() == datas[j]
