"""``repro_torch.jrandom`` against ``jax.random`` (jax 0.9.0), on the CPU.

Keys, ``fold_in``, ``bits`` and ``uniform`` must be bit-equal; Gumbel noise
within 2 ulp (``log`` may round differently in the two libraries); tokens
equal, under the near-tie rule: where the port and the reference draw
different tokens, the reference's two highest perturbed scores
(``gumbel + logits / T``) must lie within 1e-5 relative of each other, and
the comparison of that row stops there.  Any other difference fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import jrandom as JR

NEAR_TIE = 1e-5
SHAPES = [(1000,), (3, 700), (2, 50280)]


def words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def assert_near_tie(scores, what) -> None:
    """The near-tie rule: the two highest of ``scores`` within 1e-5 relative."""
    second, top = np.sort(np.asarray(scores, np.float64))[-2:]
    assert top - second <= NEAR_TIE * abs(top), (
        f"{what}: draws differ off a near tie (top two {top!r}, {second!r})")


def perturbed(key, logits, temperature):
    """The reference's scores that ``categorical`` takes the argmax of."""
    logits = jnp.asarray(logits) / temperature
    return np.asarray(jax.random.gumbel(key, logits.shape, logits.dtype) + logits)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 + 5, -1, -7, -2**31, -2**31 - 1,
                                  2**32, 2**40, 2**63 - 1, -2**63])
def test_key_equals_prngkey(seed):
    assert np.array_equal(JR.key(seed).numpy(), words(jax.random.PRNGKey(seed)))
    assert JR.key(seed).dtype == torch.int64


def test_key_refuses_a_seed_outside_int64():
    """The seeds jax refuses: those outside a signed 64-bit integer, the
    most negative one below -2**63 among them."""
    for seed in (-2**63 - 1, 2**63):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError, match="signed 64-bit"):
            JR.key(seed)


def test_fold_in_chains_are_bit_equal():
    for seed in (0, 3, 2**31 - 1):
        want, got = jax.random.PRNGKey(seed), JR.key(seed)
        for d in (0, 1, 5, 12345, 2**31, 2**32 - 1):
            want, got = jax.random.fold_in(want, d), JR.fold_in(got, d)
            assert np.array_equal(got.numpy(), words(want)), (seed, d)
    # batched: keys (R, 2) with data (R,)
    base = jax.random.PRNGKey(9)
    keys = JR.fold_in(JR.key(9), torch.arange(6))
    rows = JR.fold_in(keys, torch.tensor([0, 1, 2, 30, 400, 2**32 - 1]))
    for r, d in enumerate((0, 1, 2, 30, 400, 2**32 - 1)):
        want = jax.random.fold_in(jax.random.fold_in(base, r), d)
        assert np.array_equal(rows[r].numpy(), words(want)), r


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_are_bit_equal(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    got = JR.bits(JR.fold_in(JR.key(4), 2), shape)
    assert got.shape == shape
    assert np.array_equal(got.numpy(), words(jax.random.bits(key, shape)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_uniform_is_bit_equal(shape, dtype, jdtype):
    """The draw under ``gumbel``: minval ``tiny``; bf16 takes jax's 8-bit path."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    want = jax.random.uniform(key, shape, jdtype, minval=jnp.finfo(jdtype).tiny)
    got = JR.uniform(JR.fold_in(JR.key(5), 1), shape, dtype)
    assert got.dtype == dtype and got.shape == shape
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulp(shape):
    """2 ulp of the value, or of 1 where the value is smaller: near 0 the
    inner ``log``'s rounding (about -1 there) is what is left."""
    key = jax.random.fold_in(jax.random.PRNGKey(6), 3)
    want = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    got = JR.gumbel(JR.fold_in(JR.key(6), 3), shape).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert np.all(np.abs(got - want) <= 2 * ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("vocab", [1000, 50280, 256000])
@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0])
def test_categorical_draws_the_reference_tokens(vocab, temperature):
    """One key over (4, V) logits (the static engine's draw), and one key
    per row (the continuous engine's), logits / T divided in fp32."""
    logits = np.random.default_rng(vocab).normal(0, 3, (4, vocab)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(11), vocab)
    tkey = JR.fold_in(JR.key(11), vocab)
    scaled = torch.from_numpy(logits) / torch.tensor(temperature, dtype=torch.float32)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits) / temperature))
    got = JR.categorical(tkey, scaled).numpy()
    scores = perturbed(key, logits, temperature)
    for r in range(4):
        if got[r] != want[r]:
            assert_near_tie(scores[r], f"static draw, row {r}")
    keys = JR.fold_in(tkey, torch.arange(4))
    rows = JR.categorical_rows(keys, scaled).numpy()
    for r in range(4):
        sub = jax.random.fold_in(key, r)
        want_r = int(jax.random.categorical(sub, jnp.asarray(logits[r]) / temperature))
        if rows[r] != want_r:
            assert_near_tie(perturbed(sub, logits[r], temperature), f"row draw {r}")


def test_categorical_rows_equals_one_call_per_row():
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(0, 2, (5, 777)).astype(np.float32))
    keys = JR.fold_in(JR.key(2), torch.tensor([3, 1, 4, 1, 5]))
    rows = JR.categorical_rows(keys, logits)
    each = torch.stack([JR.categorical(keys[r], logits[r]) for r in range(5)])
    assert torch.equal(rows, each)
    # the same noise, not merely the same argmax
    noise = torch.stack([JR.uniform(keys[r], (777,)) for r in range(5)])
    raw = JR._hash(keys[:, :1], keys[:, 1:], torch.arange(777)[None, :])
    assert torch.equal(JR._uniform_from(raw, torch.float32), noise)
