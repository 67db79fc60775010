"""The port's flit packer (``repro_torch.kernels.flit_pack``) against the
JAX reference on the CPU: the plain ``pack_flits_ref`` against the
reference's ``pack_flits_ref`` and its Pallas kernel (interpret mode),
the unpack round trip and the checksum, all EXACTLY equal (int32 bytes).
Inputs are made with numpy from a seed and fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flit_pack import kernel as jkernel
from repro.kernels.flit_pack import ref as jref
from repro_torch import convert
from repro_torch.kernels.flit_pack import ops
from repro_torch.kernels.flit_pack import ref as tref

SIZES = [1, 14, 15, 16, 64, 1000]


def _inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed + n)
    f = tref.flits_needed(n)
    return (rng.integers(0, 256, (n, 64), dtype=np.int32),
            rng.integers(0, 256, (f, 10), dtype=np.int32),
            rng.integers(0, 256, (f, 4), dtype=np.int32))


def _port(arrays):
    return [convert.byte_rows(a, "cpu") for a in arrays]


def test_layout_constants_equal():
    for name in ("G_SLOTS", "SLOT_BYTES", "FLIT_BYTES", "HS_BYTES",
                 "DATA_BYTES"):
        assert getattr(tref, name) == getattr(jref, name), name
    for n in range(0, 200):
        assert tref.flits_needed(n) == jref.flits_needed(n)


@pytest.mark.parametrize("n", SIZES)
def test_pack_matches_reference_exactly(n):
    arrays = _inputs(n)
    got = tref.pack_flits_ref(*_port(arrays))
    assert got.dtype == torch.int32
    assert got.shape == (tref.flits_needed(n), tref.FLIT_BYTES)
    j_in = [jnp.asarray(a) for a in arrays]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.pack_flits_ref(*j_in)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkernel.pack_flits(*j_in, interpret=True)))


@pytest.mark.parametrize("n", SIZES)
def test_unpack_round_trip_matches_reference(n):
    arrays = _inputs(n)
    flits = tref.pack_flits_ref(*_port(arrays))
    got = ops.unpack(flits, n)
    want = jref.unpack_flits_ref(jnp.asarray(flits.numpy()), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lines, headers, meta, ok = got
    for g, a in zip((lines, headers, meta), arrays):
        np.testing.assert_array_equal(g.numpy(), a)
    assert bool(ok.all())


def test_xor_fold_matches_reference_on_odd_widths():
    rng = np.random.default_rng(7)
    for width in (1, 2, 5, 127, 254, 255):
        body = rng.integers(0, 256, (9, width), dtype=np.int32)
        np.testing.assert_array_equal(
            tref._xor_fold(torch.from_numpy(body)).numpy(),
            np.asarray(jref._xor_fold(jnp.asarray(body))))


def test_corrupted_byte_fails_checksum():
    flits = tref.pack_flits_ref(*_port(_inputs(64)))
    for f, b in ((0, 0), (3, 129), (16, 253), (7, 254)):
        bad = flits.clone()
        bad[f, b] ^= 0x10
        ok = ops.unpack(bad, 64)[3]
        assert not bool(ok[f]) and int(ok.sum()) == flits.shape[0] - 1


def test_pack_wrapper_routes_cpu_and_validates():
    lines, headers, meta = _port(_inputs(16))
    ops.reset_launches()
    out = ops.pack(lines, headers, meta)
    assert torch.equal(out, tref.pack_flits_ref(lines, headers, meta))
    assert ops.launches == {"pack_flits": 0}
    with pytest.raises(ValueError, match="int32"):
        ops.pack(lines.long(), headers, meta)
    with pytest.raises(ValueError, match="flits_needed"):
        ops.pack(lines, headers[:-1].contiguous(), meta[:-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pack(lines.t().contiguous().t(), headers, meta)
    with pytest.raises(ValueError, match="shape"):
        ops.pack(lines, headers, meta[:, :3].contiguous())
    with pytest.raises(ValueError, match="several devices"):
        ops.pack(lines, headers, meta.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.pack(lines.to("meta"), headers.to("meta"), meta.to("meta"))


def test_byte_rows_keeps_values_exact():
    a = np.asarray([[0, 255, 2 ** 31 - 1], [-5, 7, 9]], np.int64)
    t = convert.byte_rows(a, "cpu")
    assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="integer"):
        convert.byte_rows(a.astype(np.float32), "cpu")
    with pytest.raises(ValueError, match="int32"):
        convert.byte_rows(a * 4, "cpu")
