"""The port's int8 KV-page helpers (bigdl_tpu_torch/quant/) against the
JAX package's ``bigdl_tpu.quant.kv`` and the mode knobs of
``bigdl_tpu.quant``, on the same numpy inputs: int8 values bit-equal,
scales within 1e-7 relative, the round trip within amax/254 per head-row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import quant as jax_quant
from bigdl_tpu.quant import kv as jax_kvq
from bigdl_tpu_torch import quant
from bigdl_tpu_torch.quant import kv as kvq


def _rows(seed, scale, shape=(3, 4, 5, 2, 16)):
    """K/V rows (..., H, hd) with a zero head-row (the EPS floor) and one
    value at an exact half step of its row's scale (round half to even)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * scale).astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    x[0, 0, 0, 1, :2] = (127.0, 0.5)
    return x


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_matches_jax(scale):
    x = _rows(int(scale * 7) % 100, scale)
    q_j, s_j = (np.asarray(a) for a in jax_kvq.quantize_rows(jnp.asarray(x)))
    q_t, s_t = kvq.quantize_rows(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert q_t.shape == x.shape and tuple(s_t.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-7, atol=0)
    # the half-step value rounds to even: 0.5 / (127 / 127) -> 0
    assert int(q_t[0, 0, 0, 1, 1]) == 0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_round_trip_within_half_a_step(scale):
    x = _rows(3, scale)
    back = kvq.dequantize_view(*kvq.quantize_rows(torch.from_numpy(x)))
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(back.numpy() - x) <= amax / 254 + 1e-7 * scale)
    np.testing.assert_allclose(
        back.numpy(),
        np.asarray(jax_kvq.dequantize_view(*jax_kvq.quantize_rows(
            jnp.asarray(x)))), rtol=1e-7, atol=0)


def test_scale_shape_and_bytes_per_token_match_jax():
    """tests/test_quant.py::test_bytes_per_token_accounting's values."""
    assert kvq.bytes_per_token(2, 4, 16, "off") == 2 * 2 * 64 * 4
    assert kvq.bytes_per_token(2, 4, 16, "int8") == 2 * 2 * (64 + 16)
    for args in ((2, 4, 16), (6, 4, 256), (1, 1, 8)):
        for mode in kvq.MODES:
            assert (kvq.bytes_per_token(*args, mode)
                    == jax_kvq.bytes_per_token(*args, mode))
    assert kvq.scale_shape((6, 513, 16, 4, 256)) == (6, 513, 16, 4)
    assert (kvq.scale_shape((2, 5, 4, 2, 8))
            == jax_kvq.scale_shape((2, 5, 4, 2, 8)))
    assert kvq.MODES == jax_kvq.MODES and kvq.ON_MODES == jax_kvq.ON_MODES


@pytest.mark.parametrize("raw,want", [("", "off"), ("0", "off"),
                                      ("OFF", "off"), (" none ", "off"),
                                      ("Int8", "int8"), (None, "off")])
def test_normalize_mode_matches_jax(raw, want):
    raw = "None" if raw is None else raw
    assert quant.normalize_mode(raw, kvq.ON_MODES, "kv_quant") == want
    assert jax_quant.normalize_mode(raw, jax_kvq.ON_MODES, "kv_quant") == want


@pytest.mark.parametrize("raw", ["int4", "fp8", "yes"])
def test_normalize_mode_names_an_unknown_mode(raw):
    with pytest.raises(ValueError, match=f"kv_quant='{raw}' is not a known"):
        quant.normalize_mode(raw, kvq.ON_MODES, "kv_quant")
    with pytest.raises(ValueError, match=f"kv_quant='{raw}' is not a known"):
        jax_quant.normalize_mode(raw, jax_kvq.ON_MODES, "kv_quant")


def test_kv_mode_default_reads_the_env(monkeypatch):
    assert quant.ENV_KV_QUANT == jax_quant.ENV_KV_QUANT
    assert quant.KV_TOKEN_DRIFT_BUDGET == jax_quant.KV_TOKEN_DRIFT_BUDGET
    monkeypatch.delenv(quant.ENV_KV_QUANT, raising=False)
    assert quant.kv_mode_default() == "off"
    for raw, want in (("int8", "int8"), ("off", "off"), (" INT8", "int8")):
        monkeypatch.setenv(quant.ENV_KV_QUANT, raw)
        assert quant.kv_mode_default() == want == jax_quant.kv_mode_default()
    monkeypatch.setenv(quant.ENV_KV_QUANT, "int4")
    with pytest.raises(ValueError, match="BIGDL_SERVE_KV_QUANT='int4'"):
        quant.kv_mode_default()
