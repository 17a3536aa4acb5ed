"""Inputs for the merge tests, made from seeds with numpy: the runs' edge
cases, the merge kernel's own, and a brute-force count of the splits.  No
JAX here, so the kernel tests that use them run on a machine without it."""

import numpy as np

SENT = (1 << 63) - 1  # the engine's sentinel key


def edge_cases():
    """(name, a_keys, a_vals, b_keys, b_vals) as int64 numpy arrays."""
    rng = np.random.default_rng(5)

    def run(n, space=1 << 50, sent=0):
        k = np.concatenate([np.sort(rng.integers(0, space, n)),
                            np.full(sent, SENT)]).astype(np.int64)
        return k, rng.integers(-1 << 40, 1 << 40, len(k))

    low = np.arange(5000, dtype=np.int64)
    return [
        ("equal keys, distinct values", *run(7001, 16), *run(9003, 16)),
        ("A of 0 lanes", *run(0), *run(4099)),
        ("B of 0 lanes", *run(4099), *run(0)),
        ("both of 0 lanes", *run(0), *run(0)),
        ("all-sentinel runs", *run(0, sent=3000), *run(0, sent=2500)),
        ("sentinel tails", *run(3001, sent=777), *run(2049, sent=1)),
        ("lengths off every tile", *run(2047), *run(6143)),
        ("A entirely below B", low, low + 1, low + 10_000, low),
        ("B entirely below A", low + 10_000, low, low, low + 1),
    ]


def card_cases(tile, resident):
    """The kernel's own edges, as :func:`edge_cases` gives them: ``tile``
    merged lanes a tile, ``resident`` blocks on the card at once (tiles
    past them are a block's second and later ones)."""
    rng = np.random.default_rng(9)

    def run(n, space=1 << 50):
        return (np.sort(rng.integers(0, space, n)).astype(np.int64),
                rng.integers(-1 << 40, 1 << 40, n))

    many = 3 * resident * tile + 5
    cases = [
        ("more tiles than resident blocks", *run(many // 2, 1 << 20),
         *run(many - many // 2, 1 << 20)),
        ("exactly one tile", *run(tile // 3), *run(tile - tile // 3)),
        ("one repeated key across many tiles",
         np.full(20 * tile + 3, 42), np.arange(20 * tile + 3),
         np.full(9 * tile + 1, 42), -np.arange(9 * tile + 1)),
    ]
    for k in (1, 2, 3):  # one stage holds one tile
        for d in (-1, 1):
            cases.append((f"{k} tiles {d:+d} lanes", *run(k * tile // 3),
                          *run(k * tile - k * tile // 3 + d)))
    return cases


def brute_splits(ak, bk, tile):
    """A lanes among the first min(t * tile, n) lanes of a stable sort of
    A ++ B, for every tile boundary t."""
    n = len(ak) + len(bk)
    order = np.argsort(np.concatenate([ak, bk]), kind="stable")
    from_a = np.concatenate([[0], np.cumsum(order < len(ak))])
    return from_a[np.minimum(np.arange(-(-n // tile) + 1) * tile, n)]
