"""Seeds derived from a run's ``--seed`` and a tag, the same on any machine.

Every input of a run is drawn from a generator seeded by
:func:`derive` of the run's seed and the input's tag (and, for a corpus,
its chunk), so any piece can be made again alone, on any device, and the
same seed always gives the same inputs."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` (any whole number) and ``tags``."""
    text = ":".join(str(t) for t in (int(seed), *tags))
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8).digest(), "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    """A numpy generator for ``(seed, *tags)``."""
    return np.random.default_rng(derive(seed, *tags))


def torch_generator(seed: int, device, *tags):
    """A ``torch.Generator`` on ``device`` for ``(seed, *tags)``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g
