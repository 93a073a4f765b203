"""JAX's random streams of the Stage-B trainer, reproduced in numpy.

The JAX package draws every random number of a ``RecTrainer.fit`` from
``jax.random`` with the default threefry-2x32 keys and
``jax_threefry_partitionable=True`` (JAX 0.9): each draw is the
threefry-2x32 hash of integer counters under a key, which is uint32
arithmetic.  This module computes the same bits with numpy, so that the
port can train on the JAX trainer's own initial parameters and epoch draws
without JAX (a parity tool: nothing on the port's main path calls it; the
port's own streams are ``torch.Generator`` draws).

Primitives, each bit-equal to its ``jax.random`` counterpart on raw
``uint32[2]`` keys:

  threefry2x32(k1, k2, x1, x2)   the hash (``jax._src.prng.threefry2x32_p``)
  prng_key(seed)                 ``jax.random.PRNGKey``
  split(key, n)                  ``jax.random.split`` (counters (0, i))
  random_bits(key, shape)        32 random bits: ``bits1 ^ bits2`` of the
                                 counters (0, flat index)
  randint(key, shape, lo, hi)    int32 in [lo, hi), ``hi`` may be an array
  uniform(key, shape, lo, hi)    float32 in [lo, hi)
  permutation(key, x)            rounds of a stable sort on 32-bit keys

The trainer's streams, on them:

  init_state(seed, cfg, U, I)    ``RecTrainer.init_state``: (params, key)
  epoch_draws(key, users, csr, cfg, num_items, popmix)
                                 one epoch's ``(users, pos, neg, mask)``
                                 batches of ``epoch_fn`` and the next key
                                 (``epoch_samples``: its positives and
                                 negatives of given users)

The membership tests the samplers make (hash table or binary search in the
JAX package) are exact, so a search over the sorted train CSR gives the
same booleans.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_UINT32_MAX = 0xFFFFFFFF


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``: two uint32 arrays of the counters' shape."""
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(_PARITY)))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, np.uint32) + ks[0]
        b = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a += b
                b = (b << np.uint32(r)) | (b >> np.uint32(32 - r))
                b ^= a
            a += ks[(i + 1) % 3]
            b += ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in int32 (JAX
    without x64 holds it as one): ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return np.array([0, seed & _UINT32_MAX], np.uint32)


def _hash_counters(key, n: int):
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws need 64-bit counters")
    return threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: ``(n, 2)`` uint32 keys."""
    a, b = _hash_counters(key, n)
    return np.stack([a, b], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits for each element of ``shape`` (row-major counters)."""
    shape = tuple(shape)
    a, b = _hash_counters(key, math.prod(shape))
    return (a ^ b).reshape(shape)


def randint(key, shape, lo, hi) -> np.ndarray:
    """``jax.random.randint(key, shape, lo, hi)`` (int32): two bit draws
    reduced modulo the span, the high one scaled by 2^32 mod span; a slot
    with ``hi <= lo`` returns ``lo``."""
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    i32 = np.iinfo(np.int32)
    lo = np.broadcast_to(np.clip(np.asarray(lo, np.int64), i32.min, i32.max),
                         shape)
    hi = np.broadcast_to(np.clip(np.asarray(hi, np.int64), i32.min, i32.max),
                         shape)
    span = ((hi - lo) & _UINT32_MAX).astype(np.uint32)
    span = np.where(hi <= lo, np.uint32(1), span)
    multiplier = np.uint32(2 ** 16) % span
    with np.errstate(over="ignore"):
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + lower % span
    offset %= span
    return (lo + offset.astype(np.int64)).astype(np.int32)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 values rounded once to float32, as XLA's
    CPU code contracts the two into a fused multiply-add.  The product is
    exact in float64; the float64 sum's rounding error (Knuth's two-sum)
    decides the one case where rounding the float64 sum to float32 is not
    the fused result: a sum that falls exactly halfway between two
    float32 values."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.float64(
        np.float32(b))
    c = np.float64(np.float32(c))
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.float32(np.inf),
                                     np.float32(-np.inf))).astype(np.float64)
    tie = (s != r64) & (s - r64 == other - s) & (err != 0)
    up = tie & ((err > 0) == (other > r64))
    return np.where(up, other.astype(np.float32), r)


def uniform(key, shape, lo=0.0, hi=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``: the top 23 bits
    as the mantissa of a float in [1, 2), less 1, scaled and shifted in
    float32 (one fused multiply-add), then held at ``lo`` from below."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, fma32(f, hi - lo, lo))


def permutation(key, x) -> np.ndarray:
    """``jax.random.permutation(key, x)`` of a 1-D array (or of
    ``arange(x)`` for an int): ceil(3 ln n / ln(2^32 - 1)) rounds, each a
    fresh split and a stable sort on 32-bit random keys."""
    x = np.arange(x) if np.ndim(x) == 0 else np.asarray(x)
    rounds = int(np.ceil(3 * np.log(max(1, x.size)) / np.log(_UINT32_MAX)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, x.shape), kind="stable")]
    return x


# ---------------------------------------------------------------------------
# the trainer's streams

def xavier_uniform(key, shape) -> np.ndarray:
    """The JAX package's Xavier table: uniform in +/- sqrt(6 / (N + D))."""
    fan_out, fan_in = shape
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return uniform(key, shape, -limit, limit)


def init_state(seed: int, cfg, num_users: int, num_items: int):
    """``RecTrainer.init_state(seed)`` on one device: the initial tables
    (``{"emb"}`` for a joint layout, else ``{"user_emb", "item_emb"}``) and
    the key the first epoch splits."""
    key, kinit = split(prng_key(seed))
    if cfg.table_layout == "joint":
        return {"emb": xavier_uniform(
            kinit, (num_users + num_items, cfg.emb_dim))}, key
    ku, ki = split(kinit)
    return {"user_emb": xavier_uniform(ku, (num_users, cfg.emb_dim)),
            "item_emb": xavier_uniform(ki, (num_items, cfg.emb_dim))}, key


def _members(csr, rows, cand, num_items: int) -> np.ndarray:
    """Whether ``cand[b, ...]`` is in row ``rows[b]`` of the sorted ``csr``."""
    keys = (np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                      np.diff(csr.indptr)) * num_items
            + np.asarray(csr.indices, np.int64))
    q = np.asarray(rows, np.int64).reshape(
        (-1,) + (1,) * (cand.ndim - 1)) * num_items + cand
    if keys.size == 0:
        return np.zeros(q.shape, bool)
    at = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    return keys[at] == q


def _first_good(cand: np.ndarray, good: np.ndarray) -> np.ndarray:
    """For each row, the first candidate whose flag is set, else the last
    candidate (``JAX: ops/sampling.py _first_good``)."""
    pick = np.argmax(np.concatenate(
        [good, np.ones(good.shape[:-1] + (1,), bool)], axis=-1), axis=-1)
    pick = np.minimum(pick, cand.shape[-1] - 1)
    return np.take_along_axis(cand, pick[..., None], axis=-1)[..., 0]


def sample_positives(key, csr, rows) -> np.ndarray:
    """A uniform train item of each row (a row of degree 0 gets its first
    slot, which the mask drops)."""
    lo = np.asarray(csr.indptr, np.int64)[rows]
    deg = np.asarray(csr.indptr, np.int64)[np.asarray(rows) + 1] - lo
    off = randint(key, np.shape(rows), 0, np.maximum(deg, 1))
    nnz = csr.indices.shape[0]
    return np.asarray(csr.indices)[np.clip(lo + off, 0, nnz - 1)]


def sample_negatives_uniform(key, csr, rows, num_items: int,
                             rounds: int) -> np.ndarray:
    """``rounds + 1`` uniform candidates a row: the first of the first
    ``rounds`` that is not a train item, else the last, unchecked."""
    cand = randint(key, np.shape(rows) + (rounds + 1,), 0, num_items)
    good = ~_members(csr, rows, cand[..., :rounds], num_items)
    return _first_good(cand, good)


def _array(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def popmix_draw(key, popmix, shape) -> np.ndarray:
    """The pop-mix mixture (``PopMixSampler.draw``): the alias table's draw
    with probability ``mix_pop``, else uniform."""
    ku, km, kb, ka = split(key, 4)
    use_pop = uniform(km, shape) < np.float32(popmix.mix_pop)
    bucket = randint(kb, shape, 0, popmix.num_items)
    keep = uniform(ka, shape) < _array(popmix.accept).astype(
        np.float32)[bucket]
    pop_draw = np.where(keep, bucket, _array(popmix.alias)[bucket])
    uni_draw = randint(ku, shape, 0, popmix.num_items)
    return np.where(use_pop, pop_draw, uni_draw)


def sample_negatives_popmix(key, csr, rows, popmix, rounds: int
                            ) -> np.ndarray:
    """``rounds + 1`` mixture candidates a row, all checked: the first that
    is not a train item, else one more uniform draw, unchecked."""
    kp, kf = split(key)
    cand = popmix_draw(kp, popmix, np.shape(rows) + (rounds + 1,))
    good = ~_members(csr, rows, cand, popmix.num_items)
    chosen = _first_good(cand, good)
    fallback = randint(kf, np.shape(rows), 0, popmix.num_items)
    return np.where(good.any(axis=-1), chosen, fallback)


def epoch_samples(key, users, csr, cfg, num_items: int, popmix=None):
    """``RecTrainer._sample_epoch``: the positives and negatives of the
    epoch's padded users from the epoch's sampling key."""
    kp, kn = split(key)
    pos = sample_positives(kp, csr, users)
    if popmix is not None:
        return pos, sample_negatives_popmix(kn, csr, users, popmix,
                                            cfg.neg_rounds)
    return pos, sample_negatives_uniform(kn, csr, users, num_items,
                                         cfg.neg_rounds)


def epoch_draws(key, train_users, csr, cfg, num_items: int, popmix=None):
    """One epoch of ``RecTrainer._build_epoch_fn``'s draws from ``key``:
    the permuted train users padded with user 0 to whole batches, their
    positives and negatives (pop-mix when ``popmix`` is given: an object
    with ``accept``, ``alias``, ``mix_pop`` and ``num_items``, as the
    port's ``PopMixSampler`` on the CPU), the mask of the real slots, each
    ``(nb, batch_size)`` (int64, the mask bool), and the next epoch's key.
    ``csr`` is the host train CSR (``graph.user_csr("train")``)."""
    B = cfg.batch_size
    n = np.asarray(train_users).size
    nb = -(-n // B)
    kperm, ksamp, key = split(key, 3)
    perm = permutation(kperm, np.asarray(train_users, np.int32))
    users = np.concatenate([perm, np.zeros(nb * B - n, np.int32)])
    pos, neg = epoch_samples(ksamp, users, csr, cfg, num_items, popmix)
    mask = np.arange(nb * B) < n
    batches = tuple(np.asarray(x, np.int64).reshape(nb, B)
                    for x in (users, pos, neg)) + (mask.reshape(nb, B),)
    return batches, key
