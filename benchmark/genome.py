"""The synthetic human-class genome of a configuration, made from its seed.

Each chromosome is i.i.d. sequence near the configured GC share, into
which copies of repeat families are pasted at random places and
orientations until they cover their ``share`` of the bases: an Alu-like
family of 300 bp units and an L1-like family of 6 kb, mostly
5'-truncated, each copy diverged from one of a few subfamily consensus
sequences (``configs/*.json``).  Then CpG is depleted to about
``cpg_ratio`` of its expected rate.  A configuration that names
``genome_features`` (a module under ``benchmark/``) has its ``apply(seq,
rng, cfg, index)`` change each chromosome's codes in place after that,
with a generator of its own from the genome's seed and the chromosome's
index (CpG islands, for example).  The same seed gives the same bytes.

    python benchmark/genome.py --config benchmark/configs/hs_wgbs_se100.json \\
        --out benchmark/.cache/hs_wgbs_se100

writes ``genome.fa`` there (the file the aligner reads), ``genome.npy``
(the chromosomes' codes end to end, which the read generator and the
reference map) and a stamp ``genome.ok``.  Codes are A=0, C=1, G=2, T=3
throughout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
    CODE[_c + 32] = _i
LINE = 70
FEATURES_STREAM = 0xFEA7


def _random_codes(rng, n: int, gc: float) -> np.ndarray:
    """i.i.d. bases: A and T at (1 - gc)/2 each, C and G at gc/2."""
    u = rng.random(n, dtype=np.float32)
    at, c = (1.0 - gc) / 2, gc / 2
    return ((u >= at).astype(np.uint8) + (u >= at + c) + (u >= at + 2 * c))


def _deplete_cpg(rng, seq: np.ndarray, keep: float) -> None:
    """Each CpG survives with probability ``keep``; the others lose the C
    (C->T) or the G (G->A), as deamination of methylated C does on
    either strand."""
    at = np.flatnonzero((seq[:-1] == 1) & (seq[1:] == 2))
    hit = at[rng.random(len(at)) >= keep]
    left = rng.random(len(hit)) < 0.5
    seq[hit[left]] = 3
    seq[hit[~left] + 1] = 0


def _mutate(rng, seq: np.ndarray, rate) -> np.ndarray:
    """Each base replaced by one of the other three with probability
    ``rate`` (a scalar, or one per row of a 2-D ``seq``)."""
    rate = np.asarray(rate, dtype=np.float64)
    if seq.ndim == 2 and rate.ndim == 1:
        rate = rate[:, None]
    m = rng.random(seq.shape) < rate
    out = seq.copy()
    out[m] = (out[m] + rng.integers(1, 4, size=int(m.sum()),
                                    dtype=np.uint8)) % 4
    return out


def _revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq)[..., ::-1]


def _paste_family(rng, seq: np.ndarray, fam: dict) -> None:
    """Paste copies of one repeat family into ``seq`` until they cover
    ``share`` of it (later copies overwrite earlier ones where they
    overlap)."""
    unit = int(fam["unit"])
    master = _random_codes(rng, unit, float(fam["gc"]))
    subs = [_mutate(rng, master, float(fam["subfamily_divergence"]))
            for _ in range(int(fam["subfamilies"]))]
    lo, hi = fam["divergence"]
    full = float(fam["full_length_share"])
    min_len = int(fam["min_len"])
    mean_len = full * unit + (1 - full) * (min_len + unit) / 2
    n = int(round(len(seq) * float(fam["share"]) / mean_len))
    lens = np.where(rng.random(n) < full, unit,
                    rng.integers(min_len, unit + 1, size=n))
    which = rng.integers(0, len(subs), size=n)
    div = rng.uniform(lo, hi, size=n)
    flip = rng.random(n) < 0.5
    pos = rng.integers(0, len(seq) - unit, size=n)
    if full >= 1.0:
        # one matrix for all copies of a fixed-length family
        mat = _mutate(rng, np.stack(subs)[which], div)
        mat[flip] = _revcomp(mat[flip])
        idx = pos[:, None] + np.arange(unit)[None, :]
        seq[idx.ravel()] = mat.ravel()
        return
    for k in range(n):
        # 5'-truncated: the copy keeps the 3' end of the unit
        copy = _mutate(rng, subs[which[k]][unit - lens[k]:], div[k])
        if flip[k]:
            copy = _revcomp(copy)
        seq[pos[k]: pos[k] + lens[k]] = copy


def make_chromosome(gcfg: dict, index: int, length: int) -> np.ndarray:
    """Chromosome ``index`` of the genome ``gcfg`` (its own stream of the
    genome seed, so chromosomes can be made one at a time)."""
    rng = np.random.default_rng([int(gcfg["seed"]), index])
    gc, keep = float(gcfg["gc"]), float(gcfg["cpg_ratio"])
    # drawn GC-richer by what the CpG depletion takes away again
    seq = _random_codes(rng, length, gc + (1 - keep) * (gc / 2) ** 2)
    for fam in gcfg["repeats"]:
        _paste_family(rng, seq, fam)
    _deplete_cpg(rng, seq, keep)
    return seq


def write_fasta(f, name: str, seq: np.ndarray) -> None:
    """One FASTA record, ``LINE`` bases a line."""
    f.write(b">" + name.encode() + b"\n")
    n = len(seq)
    full = n // LINE
    body = np.empty((full, LINE + 1), dtype=np.uint8)
    body[:, :LINE] = ASCII[seq[: full * LINE]].reshape(full, LINE)
    body[:, LINE] = ord("\n")
    f.write(body.tobytes())
    if n > full * LINE:
        f.write(ASCII[seq[full * LINE:]].tobytes() + b"\n")


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """(name, codes) of every record of a FASTA file, N and other letters
    as code 4."""
    raw = np.fromfile(path, dtype=np.uint8)
    heads = np.flatnonzero(raw == ord(">"))
    out = []
    for k, h in enumerate(heads):
        end = heads[k + 1] if k + 1 < len(heads) else len(raw)
        eol = h + int(np.argmax(raw[h:end] == ord("\n")))
        name = raw[h + 1: eol].tobytes().decode().split()[0]
        body = raw[eol + 1: end]
        body = body[body != ord("\n")]
        out.append((name, CODE[body]))
    return out


def genome_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "genome.fa")


def ensure_genome(cfg: dict, cache_dir: str) -> str:
    """The configuration's FASTA in ``cache_dir``, written with its codes
    and a stamp naming its seed and lengths when missing or stale."""
    os.makedirs(cache_dir, exist_ok=True)
    path = genome_path(cache_dir)
    g = cfg["genome"]
    stamp = os.path.join(cache_dir, "genome.ok")
    want = json.dumps(g, sort_keys=True)
    if os.path.exists(stamp) and os.path.exists(path):
        with open(stamp) as f:
            if f.read() == want:
                return path
    from spec import load_module
    features = load_module(cfg, "genome_features")
    total = sum(int(n) for _, n in g["chromosomes"])
    npy = os.path.join(cache_dir, "genome.npy")
    codes = np.lib.format.open_memmap(npy + ".part", mode="w+",
                                      dtype=np.uint8, shape=(total,))
    at = 0
    with open(path + ".part", "wb") as f:
        for k, (name, length) in enumerate(g["chromosomes"]):
            seq = make_chromosome(g, k, int(length))
            if features is not None:
                features.apply(seq, np.random.default_rng(
                    [int(g["seed"]), k, FEATURES_STREAM]), cfg, k)
            write_fasta(f, name, seq)
            codes[at: at + len(seq)] = seq
            at += len(seq)
    codes.flush()
    del codes
    os.replace(npy + ".part", npy)
    os.replace(path + ".part", path)
    with open(stamp, "w") as f:
        f.write(want)
    return path


def load_codes(cfg: dict, cache_dir: str) -> list[tuple[str, np.ndarray]]:
    """(name, codes) of each chromosome, views of the mapped
    ``genome.npy`` that ``ensure_genome`` wrote."""
    cat = np.load(os.path.join(cache_dir, "genome.npy"), mmap_mode="r")
    out, at = [], 0
    for name, length in cfg["genome"]["chromosomes"]:
        out.append((name, cat[at: at + int(length)]))
        at += int(length)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    print(ensure_genome(cfg, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
