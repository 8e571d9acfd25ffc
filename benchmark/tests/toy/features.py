"""A configuration's own genome feature, for the harness's tests: one
CpG island a chromosome, ``toy_island`` bases of ``CGCG...`` at a place
drawn from the generator ``genome.py`` hands over."""

import numpy as np


def apply(seq: np.ndarray, rng, cfg: dict, index: int) -> None:
    n = int(cfg["toy_island"])
    at = int(rng.integers(0, len(seq) - n))
    seq[at: at + n] = np.resize(np.array([1, 2], dtype=np.uint8), n)
