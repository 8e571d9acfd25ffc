"""The output sink keeps a pass's header and the sampled reads' lines
whatever the pipe's chunks cut, as a plain split of the whole output
does."""

import random

import pytest

from drain import PassScan


def _sam(n_reads: int, seed: int) -> tuple[bytes, dict]:
    rng = random.Random(seed)
    head = b"@HD\tVN:1.0\n@SQ\tSN:chrA\tLN:1000\n@PG\tID:BSMAP\n"
    lines, by_name = [], {}
    for i in range(n_reads):
        name = f"p{i:09d}"
        for _ in range(rng.choice((0, 1, 2, 2))):
            ln = f"{name}\t{rng.randrange(256)}\tchrA\t{rng.randrange(999)}" \
                 f"\t255\t{'A' * rng.randrange(1, 60)}\n"
            lines.append(ln)
            by_name.setdefault(name, []).append(ln)
    return head + "".join(lines).encode(), by_name


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000, 1 << 20])
def test_pass_scan_matches_a_plain_split(chunk):
    data, by_name = _sam(400, chunk)
    names = [f"p{i:09d}" for i in sorted(random.Random(3).sample(
        range(400), 60))] + ["p000000000", "p000000399"]
    scan = PassScan(sorted(set(names)))
    for i in range(0, len(data), chunk):
        scan.feed(data[i:i + chunk])
    out = scan.finish()
    assert out["bytes"] == len(data)
    assert out["header"] == data[:data.index(b"p0")].decode()
    assert out["lines"] == {n: by_name.get(n, []) for n in sorted(set(names))}
