"""The port's KV codecs (``repro_torch.serving.quant``) against the JAX
package's ``serving/quant.py`` on the same numpy inputs: int8 and fp8 codes
equal bitwise, scales within 1 f32 ulp (both divide the same f32 amax by
the same constant; the ulp allows another rounding of that one division),
dequantized values equal. ``paged_write`` (in place in the port) is pinned
on the sentinel drop and the untouched-page identity, and against JAX's
copy-returning version on a write that grows some pages' scales."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serving import quant as jq
from repro_torch.serving import quant as tq

MODES = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _codes(t: torch.Tensor) -> np.ndarray:
    """Raw code bits of a torch code tensor."""
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()


def _jcodes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _inputs(seed, shape, mag):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    x.reshape(-1, shape[-1])[::5] = 0.0  # all-zero rows (and pages, for small shapes)
    x.flat[rng.integers(0, x.size)] = 40.0 * mag  # one outlier
    return x


def test_modes_and_code_max():
    for mode, (td, jd) in MODES.items():
        assert tq.storage_dtype(mode) == td
        assert tq.code_max(td) == jq.code_max(jd)
    assert tq.storage_dtype("none") is None and tq.storage_dtype(None) is None
    with pytest.raises(ValueError, match="storage dtype"):
        tq.code_max(torch.bfloat16)
    with pytest.raises(ValueError, match="int4"):
        tq.storage_dtype("int4")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,mag", [(0, 1.0), (1, 1e-3), (2, 300.0)])
@pytest.mark.parametrize("ps", [1, 7, 16])
def test_quantize_block_bitwise(mode, seed, mag, ps):
    td, jd = MODES[mode]
    x = _inputs(seed, (3, ps, 2, 32), mag)
    tc, ts = tq.quantize_block(torch.from_numpy(x), td)
    jc, js = jq.quantize_block(jnp.asarray(x), jd)
    np.testing.assert_array_equal(_codes(tc), _jcodes(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_array_equal(
        tq.dequantize(tc, ts[:, None, :]).numpy(),
        np.asarray(jq.dequantize(jc, js[:, None, :])),
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,mag", [(3, 1.0), (4, 50.0)])
def test_quantize_rows_bitwise(mode, seed, mag):
    td, jd = MODES[mode]
    x = _inputs(seed, (5, 9, 2, 64), mag)
    tc, ts = tq.quantize_rows(torch.from_numpy(x), td)
    jc, js = jq.quantize_rows(jnp.asarray(x), jd)
    np.testing.assert_array_equal(_codes(tc), _jcodes(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


def _pool(mode, seed, N=6, ps=4, nkv=2, dh=16):
    td, jd = MODES[mode]
    x = _inputs(seed, (N, ps, nkv, dh), 1.0)
    jc, js = jq.quantize_block(jnp.asarray(x), jd)
    tc = torch.from_numpy(_jcodes(jc).copy())
    if td == torch.float8_e4m3fn:
        tc = tc.view(torch.float8_e4m3fn)
    return tc, torch.from_numpy(np.asarray(js).copy()), jc, js


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mag", [0.5, 4.0])
def test_paged_write_matches_jax(mode, mag):
    """Rows into pages 1 and 4 (page 4 twice); magnitude 4 grows those
    pages' scales and rescales their resident codes; entries 6 = N drop."""
    tc, ts, jc, js = _pool(mode, 5)
    new = (np.random.default_rng(6).standard_normal((3, 2, 2, 16)) * mag).astype(np.float32)
    page_idx = np.array([[1, 4], [4, 6], [6, 6]], np.int32)
    off = np.array([[0, 1], [3, 2], [0, 1]], np.int32)
    tq.paged_write(tc, ts, torch.from_numpy(new), torch.from_numpy(page_idx), torch.from_numpy(off))
    jc2, js2 = jq.paged_write(jc, js, jnp.asarray(new), jnp.asarray(page_idx), jnp.asarray(off))
    np.testing.assert_array_equal(_codes(tc), _jcodes(jc2))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js2), maxulp=1)


@pytest.mark.parametrize("mode", MODES)
def test_paged_write_sentinel_drops_and_untouched_pages_identical(mode):
    tc, ts, _, _ = _pool(mode, 7)
    codes0, scales0 = _codes(tc).copy(), ts.numpy().copy()
    new = torch.full((2, 3, 2, 16), 1e3)  # would grow every scale it touched
    tq.paged_write(tc, ts, new, torch.full((2, 3), 6), torch.zeros((2, 3), dtype=torch.int32))
    np.testing.assert_array_equal(_codes(tc), codes0)
    np.testing.assert_array_equal(ts.numpy(), scales0)
    small = torch.full((1, 1, 2, 16), 1e-6)  # below page 2's scale: no growth
    tq.paged_write(tc, ts, small, torch.tensor([[2]]), torch.tensor([[1]]))
    changed = np.nonzero((_codes(tc) != codes0).reshape(6, -1).any(axis=1))[0]
    assert changed.tolist() in ([], [2])  # only the written page may change
    np.testing.assert_array_equal(ts.numpy(), scales0)
    np.testing.assert_array_equal(_codes(tc)[[0, 1, 3, 4, 5]], codes0[[0, 1, 3, 4, 5]])
