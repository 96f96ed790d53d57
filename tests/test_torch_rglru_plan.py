"""The RG-LRU scan kernel's plan and its order of operations, on the CPU.

``csrc/rglru_scan.cu`` gives a block L = 16 lanes and cuts time into tiles
of G = 16 segments of Q = 8 steps, carrying between segments in a fixed
order; :func:`scan_plan` gives the grid and the tiles for the shapes, and
:func:`scan_model` is a numpy model of the kernel's floating-point order.  Here the plan is checked for what the kernel needs, and the
model is held to the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and to ``linear_scan`` at the fp32 bar
the port holds the kernel to (atol 2e-5 / rtol 2e-4).  On the card
``tests/test_torch_cuda.py`` holds the kernel to this model within an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.kernels import rglru_scan as RS

F32 = dict(atol=2e-5, rtol=2e-4)
H100_SMS = 132
SHARED_LIMIT = 232_448      # bytes of shared memory a block may use on an H100


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def inputs(seed, b, s, w, lo=0.3, with_h0=True):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 0.999, (b, s, w)).astype(np.float32)
    bb = rng.normal(0, 0.3, (b, s, w)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, w)).astype(np.float32) if with_h0 else None
    return a, bb, h0


def test_scan_plan_is_a_function_of_the_shapes_that_fits_and_covers():
    assert RS.SEGS * RS.LANES == RS.THREADS and RS.TILE == RS.SEGS * RS.SEG
    # under the 48 KB a launch takes without asking, so under the block's limit
    assert RS.SHARED_BYTES == 38_976 and RS.SHARED_BYTES <= 48 * 1024 <= SHARED_LIMIT
    shapes = [(b, s, w, n_sm) for b in (1, 2, 3, 4, 9) for s in (1, 2, 15, 17, 37, 128, 129,
                                                                   300, 2032, 8192)
              for w in (1, 16, 33, 100, 2560, 2563) for n_sm in (8, 132)]
    for b, s, w, n_sm in shapes:
        pl = RS.scan_plan(b, s, w, n_sm)
        assert pl == RS.scan_plan(b, s, w, n_sm)
        # S and W covered exactly: no tile and no block without a live row or lane
        assert (pl.tiles - 1) * RS.TILE < s <= pl.tiles * RS.TILE
        cols = pl.blocks // b
        assert pl.blocks == b * cols and (cols - 1) * RS.LANES < w <= cols * RS.LANES
    one_prompt = RS.scan_plan(1, 2032, 2560, H100_SMS)      # recurrentgemma-2b's long join
    assert one_prompt.blocks > H100_SMS and one_prompt.tiles == 16
    join = RS.scan_plan(1, 128, 2560, H100_SMS)             # a 128-token join: one tile
    assert join.tiles == 1 and join.blocks > H100_SMS


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("w", [16, 100])
@pytest.mark.parametrize("s", [1, 37, 128, 300])
def test_scan_model_matches_pallas_and_linear_scan(s, w, with_h0):
    a, bb, h0 = inputs(20 + s + w, 2, s, w, with_h0=with_h0)
    got = RS.scan_model(a, bb, h0)
    assert got.shape == (2, s, w) and got.dtype == np.float32 and np.isfinite(got).all()
    jh0 = jnp.asarray(h0 if with_h0 else np.zeros((2, w), np.float32))
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(bb), jh0)
    assoc = RS.linear_scan(t(a), t(bb), None if h0 is None else t(h0))[0]
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, assoc.numpy(), **F32)


def test_scan_model_long_sequence_near_one_matches_linear_scan():
    """S 8192 with a in [0.99, 0.999]: the slowest decay, where the carry
    folds and the segment products have the most error to carry along."""
    a, bb, h0 = inputs(30, 1, 8192, 100, lo=0.99)
    assert RS.scan_plan(1, 8192, 100, H100_SMS).tiles == 64
    got = RS.scan_model(a, bb, h0)
    want = RS.linear_scan(t(a), t(bb), t(h0))[0].numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 5      # a sum over many steps
    np.testing.assert_allclose(got, want, **F32)


def test_scan_model_over_tiles_and_batch_rows_matches_pallas_and_linear_scan():
    """Three batch rows of a ragged width over three tiles, the last one
    ragged: each row's carry runs from its own h0 through every tile."""
    a, bb, h0 = inputs(40, 3, 300, 300)
    assert RS.scan_plan(3, 300, 300, H100_SMS) == (3 * 19, 3)
    got = RS.scan_model(a, bb, h0)
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, RS.linear_scan(t(a), t(bb), t(h0))[0].numpy(), **F32)
