"""Filter and topic generators of the bench's cfg3/cfg4/cfg5 workloads.

Copies of ``bench.py``'s ``VOCAB6``, ``_tree_topic``, ``gen_mixed`` and
``gen_topics_uniform``, so the port builds the cfg3 stream (1M mixed
``+``/``#`` filters over a 6-level topic tree, uniform publish topics)
without importing the JAX bench, and of cfg5's retained draw and
``run_retained``'s subscriber mix. Same generators, same ``random.Random``
seed → the same filters and topics.
"""

from __future__ import annotations

VOCAB6 = [50, 80, 100, 150, 200, 400]  # per-level vocabulary of the 6-level tree


def _tree_topic(rng, depth=6):
    return "/".join(f"v{d}_{rng.randrange(VOCAB6[d])}" for d in range(depth))


def gen_mixed(rng, n, shared_frac=0.0):
    """Configs 3/4: mixed +/# wildcards over a 6-level topic tree."""
    filters = set()
    while len(filters) < n:
        depth = rng.randint(2, 6)
        levels = [f"v{d}_{rng.randrange(VOCAB6[d])}" for d in range(depth)]
        r = rng.random()
        if r < 0.35:  # sprinkle +
            for _ in range(rng.randint(1, 2)):
                levels[rng.randrange(depth)] = "+"
        if r >= 0.25 and r < 0.55:
            levels[-1] = "#"
        f = "/".join(levels)
        if shared_frac and rng.random() < shared_frac:
            f = "$share/g%d/%s" % (rng.randrange(16), f)
        filters.add(f)
    return sorted(filters)


def gen_topics_uniform(rng, n, depth=6):
    return [_tree_topic(rng, depth) for _ in range(n)]


def gen_retained_topics(rng, n):
    """cfg5's retained side (``bench.py``'s ``cfg5``): ``n`` draws of
    ``_tree_topic(rng, rng.randint(3, 6))``, duplicates dropped. The bench
    keeps them in a set's order, which changes with the string hash seed;
    here they stay in the order of their first draw, so a seed gives the
    same list in every process."""
    return list(dict.fromkeys(_tree_topic(rng, rng.randint(3, 6)) for _ in range(n)))


def retained_sub_filters(rng, n=512):
    """``run_retained``'s subscriber mix (``bench.py``, with
    ``random.Random(5)`` there): 70% ``v0_x/v1_y/+`` (half of them with
    ``/#``), 20% ``v0_x/+/+/#``, 10% one to four ``+`` levels then ``#``."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.7:
            f = f"v0_{rng.randrange(VOCAB6[0])}/v1_{rng.randrange(VOCAB6[1])}/+"
            if rng.random() < 0.5:
                f += "/#"
        elif r < 0.9:
            f = f"v0_{rng.randrange(VOCAB6[0])}/+/+/#"
        else:
            f = "/".join(["+"] * rng.randint(1, 4)) + "/#"
        out.append(f)
    return out
