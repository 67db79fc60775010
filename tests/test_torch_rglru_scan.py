"""The port's RG-LRU scan on the CPU (its plain version, which the wrapper
runs for CPU tensors) against the JAX reference: the kernel oracle
``lru_ref`` (sequential) and the model's ``lru_scan`` (associative scan),
on inputs made with numpy from a seed, at atol 1e-5 / rtol 1e-4 (the
reference's own tolerance for its kernel; the associative scan rounds in
another order).  Sequence lengths include ones that are not a multiple of
the TPU kernel's block of 128."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import lru_ref as jax_lru_ref
from repro.models.rglru import lru_scan
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import lru_ref

TOL = dict(atol=1e-5, rtol=1e-4)
_jax_ref = jax.jit(jax_lru_ref)
_jax_scan = jax.jit(lru_scan)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    # log a in [-2, 0): decays between e^-2 and 1, as the gates give
    log_a = -rng.uniform(0.0, 2.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return log_a, b


@pytest.mark.parametrize("shape", [(2, 128, 64), (1, 77, 40), (3, 200, 16),
                                   (1, 1, 8)])
def test_matches_reference_oracle_and_model_scan(shape):
    log_a, b = _inputs(shape[1], shape)
    ops.reset_launches()
    got = ops.lru(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape
    assert ops.launches["rglru_scan"] == 0           # CPU: plain version
    args = (jnp.asarray(log_a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_ref(*args)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_scan(*args)),
                               **TOL)


def test_initial_state_matches_reference():
    log_a, b = _inputs(9, (2, 33, 24))
    h0 = np.random.default_rng(1).standard_normal((2, 24)).astype(np.float32)
    got = lru_ref(torch.from_numpy(log_a), torch.from_numpy(b),
                  torch.from_numpy(h0))
    want = jax_lru_ref(jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_operands_are_cast_to_f32():
    """The wrapper casts to f32 as the reference's ``ops.lru`` does."""
    log_a, b = _inputs(4, (1, 50, 8))
    la16 = torch.from_numpy(log_a).to(torch.bfloat16)
    b16 = torch.from_numpy(b).to(torch.bfloat16)
    got = ops.lru(la16, b16)
    want = jax_lru_ref(jnp.asarray(log_a).astype(jnp.bfloat16),
                       jnp.asarray(b).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="one shape"):
        ops.lru(x, torch.zeros((1, 4, 9)))
    with pytest.raises(ValueError, match="one shape"):
        ops.lru(x[0], x[0])
    with pytest.raises(ValueError, match="no kernel"):
        ops.lru(x.to("meta"), x.to("meta"))


# -- the binding's host-side plan (a plain function; no card needed) --------

#: 16-byte aligned addresses, as a fresh CUDA allocation gives them
_ALIGNED = (1 << 20, 1 << 21)


@pytest.mark.parametrize("shape,route,blocks", [
    ((1, 7, 2560), "tma", 160),
    ((1, 2304, 2560), "tma", 160),
    ((1, 2305, 2560), "tma", 160),
    ((4, 4096, 2560), "tma", 640),
    ((2, 300, 37), "cp.async", 6),
    ((1, 129, 12), "tma", 1),
    ((3, 77, 40), "tma", 9),
    ((2, 1, 8), "tma", 2),
])
def test_plan_at_the_card_shapes(shape, route, blocks):
    """Route, block count, tile and ring of the shapes the card tests run:
    blocks of 16 channels, so at B = 1, C = 2560 every one of the 132 SMs
    gets one; C % 4 != 0 takes the cp.async copies; C = 12 is below one
    block's width."""
    from repro_torch.kernels.rglru_scan import kernel as k
    p = k.plan(shape, _ALIGNED)
    assert (p.route, p.width, p.blocks) == (route, 16, blocks)
    assert (p.tile, p.stages) == (64, 4)
    # the ring's operands in flight at B = 1, C = 2560: 160 blocks x 4
    # stages x 8 KB = 5.1 MB, above the ~2.5-3 MB that 3.35 TB/s needs
    if shape[0] == 1 and shape[2] == 2560:
        assert p.blocks >= 132
        assert p.blocks * p.stages * p.tile * p.width * 8 > 5.0e6


def test_plan_of_an_offset_view_takes_cp_async():
    """A view one element into its storage is contiguous but not 16-byte
    aligned: no TMA map can describe it, so the ring is filled by
    cp.async; the same tensor at offset 0 takes TMA."""
    from repro_torch.kernels.rglru_scan import kernel as k
    store = torch.zeros(1 * 256 * 2560 + 4)
    view = store[1:1 + 256 * 2560].view(1, 256, 2560)
    whole = store[:256 * 2560].view(1, 256, 2560)
    assert view.is_contiguous() and view.storage_offset() == 1
    base = 1 << 20                  # an aligned allocation's address
    p = k.plan(view.shape, (base + 4 * view.storage_offset(),) * 2)
    assert p.route == "cp.async" and p.blocks == 160
    assert k.plan(whole.shape, (base, base)).route == "tma"
    # one operand unaligned is enough
    assert k.plan(whole.shape, (base, base + 4)).route == "cp.async"


def test_probe_leaves_out_a_variant_whose_text_is_gone(tmp_path, capsys,
                                                        monkeypatch):
    """``launch/probe_rglru.py`` builds its variants by replacing text of
    the kernel's source; a variant whose text is not there is reported and
    left out, the others are built."""
    from repro_torch.launch import probe_rglru
    src = tmp_path / "rglru_scan.cu"
    src.write_text("constexpr int W = 16;\nconstexpr int EXP_WARPS = 2;\n")
    monkeypatch.setattr(probe_rglru, "SOURCE", src)
    got = probe_rglru.variant_sources()
    assert got["width 8"] == ("constexpr int W = 8;\n"
                              "constexpr int EXP_WARPS = 2;\n")
    assert "one exp warp" in got and "3 stages" not in got
    assert "width 32, 3 stages" not in got       # one of its two texts gone
    assert "'3 stages' left out" in capsys.readouterr().out
