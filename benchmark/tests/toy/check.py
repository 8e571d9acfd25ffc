"""A configuration's own check, for the harness's tests: BSMAP's check
(``compare.check_run``) with one number more, ``toy_reads_checked``, the
reads or pairs sampled (at least 1)."""

import compare


def check_run(cfg, traffic, cache_dir, reads, sample, passes, device):
    v = compare.check_run(cfg, traffic, cache_dir, reads, sample, passes,
                          device)
    n = len(sample)
    v["checks"] = {"toy_reads_checked": {"value": n, "limit": 1},
                   **v["checks"]}
    v["correct"] = v["correct"] and n >= 1
    return v
