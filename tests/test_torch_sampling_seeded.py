"""The port's seeded sampling against ``jax.random`` and the JAX package's
sampler on the CPU (JAX 0.9 with ``jax_threefry_partitionable=True``).

- ``prng_key``, ``split``, ``fold_in``, the 32-bit bits (one key over a
  (B, V) draw, and per-row keys), ``uniform`` with a ``minval`` and
  ``fold_positions`` equal ``jax.random`` bit for bit, for seeds 0, 1,
  2^31, 2^32 + 5 and -1.
- Gumbel noise agrees to 2 ulp of the noise's largest magnitude: XLA:CPU's
  ``log`` and torch's differ by up to one ulp.
- ``sample_logits`` gives the JAX sampler's tokens with one key and with
  per-row keys, nucleus on and off, mixed temperatures and top_p (greedy
  rows included).
- The k = 2 verify's draws (acceptance uniforms under ``fold_in(key, 0)``
  with minval 1e-20, the corrective categorical under ``fold_in(key, 1)``)
  equal the JAX verify's on the same keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.engine import sampling as jsampling
from dots_ocr_tpu_torch.engine import sampling as tsampling
from dots_ocr_tpu_torch.ops import sampling as ops_sampling

SEEDS = [0, 1, 2**31, 2**32 + 5, -1]


def _key(seed):
    return jax.random.PRNGKey(seed)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_functions_equal_jax_random(seed):
    jk, tk = _key(seed), tsampling.prng_key(seed)
    assert (_np(jk) == tk.numpy()).all()
    assert (_np(jax.random.split(jk, 5)) == tsampling.split(tk, 5).numpy()).all()
    for data in (0, 1, 17, 2**31 + 3, 2**32 - 1):
        assert (_np(jax.random.fold_in(jk, data)) == tsampling.fold_in(tk, data).numpy()).all()
    # one key over a (B, V) draw counts over the flat index
    bits = ops_sampling.random_bits(tk, 6 * 37).reshape(6, 37).numpy()
    assert (_np(jax.random.bits(jk, (6, 37))) == bits).all()
    # per-row keys are vmap's draws
    rows = jax.random.split(jk, 4)
    trows = torch.from_numpy(_np(rows))
    assert (_np(jax.vmap(lambda k: jax.random.bits(k, (29,)))(rows))
            == ops_sampling.random_bits(trows, 29).numpy()).all()
    for minval in (0.0, 1e-20):
        ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (300,), minval=minval))(rows))
        assert (ju == tsampling.uniform(trows, 300, minval).numpy()).all()
    positions = np.array([0, 5, 123456, 2**31 - 1])
    jf = jsampling.fold_positions(rows, jnp.asarray(positions, jnp.int32))
    assert (_np(jf) == tsampling.fold_positions(trows, torch.from_numpy(positions)).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_within_two_ulp(seed):
    jg = np.asarray(jax.random.gumbel(_key(seed), (4096,)))
    tg = tsampling.gumbel(tsampling.prng_key(seed), 4096).numpy()
    bound = 2 * np.spacing(np.float32(np.abs(jg).max()))
    assert np.abs(jg - tg).max() <= bound
    assert (jg == tg).mean() > 0.5  # most draws bit-equal


def _logits(rng, b, v, scale=3.0):
    return (rng.randn(b, v) * scale).astype(np.float32)


@pytest.mark.parametrize("nucleus", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_sample_logits_tokens_equal_jax(nucleus, per_row):
    rng = np.random.RandomState(3 + 2 * nucleus + per_row)
    b, v = 8, 1000
    temps = np.array([0.0, 0.5, 1.0, 0.7, 1.3, 0.1, 0.9, 0.0], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 0.3, 0.8], np.float32)
    n_draws = 0
    for seed in range(12):
        logits = _logits(rng, b, v)
        if per_row:
            jkeys = jax.random.split(_key(seed), b)
        else:
            jkeys = _key(seed)
        want = np.asarray(jsampling.sample_logits(
            jkeys, jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps), nucleus=nucleus))
        got = tsampling.sample_logits(
            torch.from_numpy(_np(jkeys)), torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ps), nucleus=nucleus).numpy()
        assert (want == got).all(), (seed, want, got)
        n_draws += int((temps > 0).sum())
    assert n_draws == 12 * 6


def test_all_greedy_batch_is_argmax():
    logits = _logits(np.random.RandomState(0), 4, 50)
    got = tsampling.sample_logits(tsampling.prng_key(0), torch.from_numpy(logits), 0.0, 1.0)
    assert (got.numpy() == logits.argmax(-1)).all()


def test_categorical_ties_and_neg_inf_rows():
    """Ties go to the lowest index; -inf never wins; an all -inf row gives 0
    (jnp.argmax's rules) -- the plain version the card kernel is held to."""
    keys = jax.random.split(_key(9), 3)
    logits = np.full((3, 64), -np.inf, np.float32)
    logits[1, 40] = 0.0
    logits[2, :] = 0.0
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))
    got = tsampling.categorical(torch.from_numpy(_np(keys)), torch.from_numpy(logits)).numpy()
    assert (want == got).all() and got[0] == 0 and got[1] == 40


def test_verify_draws_equal_jax():
    """The k = 2 verify's keys and draws, as ``spec_decode_program`` forms
    them: it_keys = fold_positions(slot_keys, pos + 1), acceptance uniforms
    under fold_in(it_key, 0), the corrective categorical under
    fold_in(it_key, 1) (over the full vocabulary and over a nucleus pool)."""
    rng = np.random.RandomState(5)
    s, nq, v, kk = 6, 3, 500, 256
    slot_keys = jax.random.split(_key(77), s)
    pos = np.array([3, 10, 99, 0, 2048, 7], np.int32)
    it_keys = jsampling.fold_positions(slot_keys, jnp.asarray(pos + 1))
    r_acc = jax.vmap(jax.random.fold_in, in_axes=(0, None))(it_keys, 0)
    r_cor = jax.vmap(jax.random.fold_in, in_axes=(0, None))(it_keys, 1)
    u = jax.vmap(lambda k: jax.random.uniform(k, (nq - 1,), minval=1e-20))(r_acc)
    la = _logits(rng, s, v)
    temps = np.array([0.7, 1.0, 0.3, 0.0, 1.2, 0.7], np.float32)
    corr = jsampling.sample_logits(r_cor, jnp.asarray(la), jnp.asarray(temps),
                                   jnp.ones_like(jnp.asarray(temps)), nucleus=False)
    pool = _logits(rng, s, kk)
    pool[:, 100:] = -np.inf
    pick = jax.vmap(jax.random.categorical)(r_cor, jnp.asarray(pool))

    t_it = tsampling.fold_positions(torch.from_numpy(_np(slot_keys)), torch.from_numpy(pos + 1))
    assert (_np(it_keys) == t_it.numpy()).all()
    t_acc, t_cor = tsampling.fold_in(t_it, 0), tsampling.fold_in(t_it, 1)
    assert (_np(r_acc) == t_acc.numpy()).all() and (_np(r_cor) == t_cor.numpy()).all()
    assert (np.asarray(u) == tsampling.uniform(t_acc, nq - 1, minval=1e-20).numpy()).all()
    t_corr = tsampling.sample_logits(t_cor, torch.from_numpy(la), torch.from_numpy(temps),
                                     torch.ones(s), nucleus=False)
    assert (np.asarray(corr) == t_corr.numpy()).all()
    assert (np.asarray(pick) == tsampling.categorical(t_cor, torch.from_numpy(pool)).numpy()).all()


def test_spec_accept_greedy_rows_and_shapes():
    """Greedy rows of the verify accept exactly the drafts argmax
    reproduces; the corrective token is the argmax at column a."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(_logits(rng, 3, 3 * 40).reshape(3, 3, 40))
    arg = logits.argmax(-1)
    x_all = torch.stack([torch.tensor([1, 1, 1]), arg[:, 0], arg[:, 1]], dim=1)
    x_all[1, 2] = (arg[1, 1] + 1) % 40  # row 1 rejects its second draft
    keys = tsampling.split(tsampling.prng_key(0), 3)
    a, corr = tsampling.spec_accept(logits, x_all, torch.zeros(3), torch.ones(3), keys,
                                    any_sampled=False, nucleus=False)
    assert a.tolist() == [2, 1, 2]
    assert corr.tolist() == [int(logits[0, 2].argmax()), int(logits[1, 1].argmax()),
                             int(logits[2, 2].argmax())]


@pytest.mark.parametrize("tag", [None, 0, 1])
@pytest.mark.parametrize("with_temps", [False, True])
def test_prologue_folded_draw_equals_jax(with_temps, tag):
    """The draw that folds its rows' keys itself (slot keys, positions, a
    tag: ``fold_in(fold_in(key, position), tag)``, the draw kernel's
    prologue on the card) gives ``jax.random.categorical``'s tokens under
    the keys folded by JAX, with and without temperatures, over rows with
    -inf entries and a row of only -inf (token 0)."""
    rng = np.random.RandomState(11 + with_temps + 3 * (tag or 0))
    b, v = 6, 700
    slot_keys = jax.random.split(_key(21), b)
    pos = np.array([0, 7, 2048, 123456, 2**31 - 1, 40], np.int64)
    logits = _logits(rng, b, v)
    logits[:, rng.rand(v) < 0.3] = -np.inf
    logits[4] = -np.inf
    temps = rng.uniform(0.1, 1.5, b).astype(np.float32)
    jk = jax.vmap(jax.random.fold_in)(slot_keys, jnp.asarray(pos, jnp.uint32))
    if tag is not None:
        jk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, tag)
    scaled = logits / temps[:, None] if with_temps else logits
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, jnp.asarray(scaled)))
    got = ops_sampling.gumbel_argmax(
        torch.from_numpy(logits), torch.from_numpy(_np(slot_keys)),
        torch.from_numpy(temps) if with_temps else None,
        positions=torch.from_numpy(pos), tag=tag).numpy()
    assert (want == got).all(), (want, got)
    assert got[4] == 0


@pytest.mark.parametrize("nucleus", [False, True])
def test_sample_logits_with_positions_equals_jax_on_folded_keys(nucleus):
    """``sample_logits(slot_keys, ..., positions=pos)`` (the scheduler's
    call: the folds go to the draw) gives the JAX sampler's tokens under
    ``fold_positions(slot_keys, pos)``, nucleus on and off, greedy rows
    included."""
    rng = np.random.RandomState(31 + nucleus)
    b, v = 8, 900
    temps = np.array([0.0, 0.5, 1.0, 0.7, 1.3, 0.1, 0.9, 1.0], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 0.3, 0.8], np.float32)
    for seed in range(6):
        logits = _logits(rng, b, v)
        slot_keys = jax.random.split(_key(50 + seed), b)
        pos = rng.randint(0, 40000, b).astype(np.int64)
        jkeys = jsampling.fold_positions(slot_keys, jnp.asarray(pos, jnp.int32))
        want = np.asarray(jsampling.sample_logits(
            jkeys, jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps), nucleus=nucleus))
        got = tsampling.sample_logits(
            torch.from_numpy(_np(slot_keys)), torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ps), nucleus=nucleus, positions=torch.from_numpy(pos)).numpy()
        assert (want == got).all(), (seed, want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_entry_plain_equals_jax_words(seed):
    """The threefry entry's plain version (``threefry_grid_reference``: the
    two words, their xor, the uniform; keys and counters broadcast, the
    counter along the last axis) equals ``jax.random``'s threefry2x32
    words bit for bit."""
    from jax._src import prng

    jk = _key(seed)
    keys = jax.random.split(jk, 5)
    tkeys = torch.from_numpy(_np(keys))
    rng = np.random.RandomState(seed & 0xFFFF)
    hi = rng.randint(0, 2**32, 37, dtype=np.uint64).astype(np.uint32)
    lo = rng.randint(0, 2**32, 37, dtype=np.uint64).astype(np.uint32)
    for r in range(5):
        words = np.asarray(prng.threefry_2x32(keys[r], jnp.concatenate([hi, lo]))).astype(np.int64)
        got = ops_sampling.threefry_grid_reference(
            tkeys[r, 0], tkeys[r, 1], torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)))
        assert got.shape == (37, 2)
        assert (got[:, 0].numpy() == words[:37]).all() and (got[:, 1].numpy() == words[37:]).all()
        y0, y1 = ops_sampling.threefry2x32_reference(tkeys[r, 0], tkeys[r, 1],
                                                     torch.from_numpy(hi.astype(np.int64)),
                                                     torch.from_numpy(lo.astype(np.int64)))
        assert (y0.numpy() == words[:37]).all() and (y1.numpy() == words[37:]).all()
    bits = ops_sampling.threefry_grid_reference(tkeys[:, 0:1], tkeys[:, 1:2], 0, 0, 33,
                                                ops_sampling.BITS)
    assert (bits.numpy() == _np(jax.vmap(lambda k: jax.random.bits(k, (33,)))(keys))).all()
    uni = ops_sampling.threefry_grid_reference(tkeys[:, 0:1], tkeys[:, 1:2], 0, 0, 9,
                                               ops_sampling.UNIFORM, 1e-20)
    assert (uni.numpy() == np.asarray(
        jax.vmap(lambda k: jax.random.uniform(k, (9,), minval=1e-20))(keys))).all()
    split = ops_sampling.threefry_grid_reference(tkeys[2, 0], tkeys[2, 1], 0, 0, 4)
    assert (split.numpy() == _np(jax.random.split(keys[2], 4))).all()
