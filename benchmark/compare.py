"""The check that decides ``correct``: every sampled read's SAM lines, in
every timed pass, held to what BSMAP's semantics allow, as the plain
reference (``refalign.py``) derives them from the genome and the raw reads.

A read's lines are judged so (``judge_se``, ``judge_pe``):

* the read is trimmed as FilterReads trims it, a filtered read (or pair
  mate) prints nothing, and SEQ, QUAL, FLAG, RNAME, POS, CIGAR, the mate
  fields and the tags are byte for byte the line BSMAP prints for the hit
  (or pair) the line names;
* the hit the line names is one of the reference's: within the budget,
  with NM its mismatch count; a pair is proper (one chromosome and strand,
  insert within -m/-x) with TLEN its insert;
* *exact* reads, where BSMAP's seeding is bound to find every hit of the
  best level (each breaks fewer seed segments than its level allows, the
  level is below the segment count, and fewer than -w hits share it):
  the hit is of the best level (pair-end: the least worse-mate level, then
  the least total), and flag 0x100 is set exactly when more than one hit
  (or pair) shares it;
* the other reads: the level is no better than the reference's best and
  no worse than the seeding guarantees (``upper_level``); a read with a
  hit the seeding must find is printed.

The numbers compared are ``bad_records`` (reads whose lines break a rule,
summed over passes) and ``bad_headers`` (passes whose SAM header is not
BSMAP's), each with the limit 0, and ``passes`` (at least 1).
"""

from __future__ import annotations

from refalign import (SEG_CAP, Hit, Options, Query, Targets, count_at,
                      prepare, revcomp, search)

CHAIN = "+-"


# -- reading the reference's answer -------------------------------------------

def best(q: Query):
    """(best level, hits at it) of a query; (None, []) with no hit."""
    if not q.hits:
        return None, []
    lv = min(h.w for h in q.hits)
    return lv, [h for h in q.hits if h.w == lv]


def exact_se(q: Query, early_stop: bool = True) -> bool:
    """Whether BSMAP's seeding must report exactly the best level and all
    its hits for this read (single-end, or a pair-end mate's unpaired
    report when ``early_stop`` is False: then every segment runs)."""
    if not q.searched:
        return False
    lv, top = best(q)
    if lv is None:
        return True
    if len(top) >= SEG_CAP:
        return False
    if early_stop:
        return lv <= q.nseg - 1 and all(h.broken <= lv for h in top)
    return all(h.broken <= q.nseg - 1 for h in top)


def must_map(q: Query) -> bool:
    """A hit that BSMAP's seeding finds whatever its schedule: one seed
    segment it cannot break."""
    return any(h.broken <= q.nseg - 1 for h in q.hits)


def upper_level(q: Query) -> int:
    """The worst level BSMAP may report for a printed read: for every
    hit it must find, its level, or one below the segments that hit
    breaks (the schedule may stop before reaching it)."""
    ups = [max(h.w, h.broken - 1) for h in q.hits if h.broken <= q.nseg - 1]
    return min(ups) if ups else q.budget


# -- SAM lines ----------------------------------------------------------------

def sam_header(names, lens) -> str:
    return ("@HD\tVN:1.0\n"
            + "".join(f"@SQ\tSN:{n}\tLN:{int(n_)}\n"
                      for n, n_ in zip(names, lens))
            + "@PG\tID:BSMAP_2.6\n")


def se_line(q: Query, hit, multi: bool, names) -> str:
    flag = 0x100 if multi else 0
    seq, qual = q.seq, q.qual
    if q.chain ^ hit.parity:
        flag |= 0x10
        seq, qual = revcomp(seq), qual[::-1]
    return (f"{q.name}\t{flag}\t{names[hit.chr]}\t{hit.wloc + 1}\t255\t"
            f"{len(seq)}M\t*\t0\t0\t{seq}\t{qual}\tNM:i:{hit.w}\t"
            f"ZS:Z:{CHAIN[hit.parity]}{CHAIN[q.chain]}\n")


def unpaired_line(q: Query, readset: int, hit, multi: bool, mate, mq,
                  names) -> str:
    """A pair-end mate printed alone; ``mate`` its mate's hit (None when
    the mate has none) and ``mq`` the mate's query."""
    flag = 1 | 0x40 * readset | (0x100 if multi else 0)
    seq, qual = q.seq, q.qual
    if q.chain ^ hit.parity:
        flag |= 0x10
        seq, qual = revcomp(seq), qual[::-1]
    if mate is None:
        flag |= 0x8
        rnext, pnext = "*", 0
    else:
        if mq.chain ^ mate.parity:
            flag |= 0x20
        rnext, pnext = names[mate.chr], mate.wloc + 1
    return (f"{q.name}\t{flag}\t{names[hit.chr]}\t{hit.wloc + 1}\t255\t"
            f"{len(seq)}M\t{rnext}\t{pnext}\t0\t{seq}\t{qual}\tNM:i:{hit.w}"
            f"\tZS:Z:{CHAIN[hit.parity]}{CHAIN[q.chain]}\n")


def insert_of(ha, hb, La: int, Lb: int) -> int:
    """BSMAP's insert of mate 1's hit ``ha`` and mate 2's ``hb`` (one
    chromosome and strand)."""
    if ha.parity:
        return ha.wloc + La - hb.wloc
    return hb.wloc + Lb - ha.wloc


def pair_lines(qa: Query, qb: Query, ha, hb, ins: int, multi: bool,
               names) -> str:
    """The two lines of a proper pair, mate run-through trimmed as BSMAP
    trims it at output."""
    out = []
    locs = {}
    seqs = {}
    for key, q, h, ch in (("a", qa, ha, 0), ("b", qb, hb, 1)):
        loc, seq, qual = h.wloc, q.seq, q.qual
        if ins < len(seq):
            if ch ^ h.parity:
                loc += len(seq) - ins
            seq, qual = seq[:ins], qual[:ins]
        locs[key] = loc
        seqs[key] = (seq, qual)
    for key, mkey, q, h, ch, rs in (("a", "b", qa, ha, 0, 1),
                                    ("b", "a", qb, hb, 1, 2)):
        flag = 0x3 | (0x100 if multi else 0) | 0x40 * rs
        seq, qual = seqs[key]
        if ch ^ h.parity:
            flag |= 0x10
            tlen = -ins
            seq, qual = revcomp(seq), qual[::-1]
        else:
            flag |= 0x20
            tlen = ins
        out.append(f"{q.name}\t{flag}\t{names[h.chr]}\t{locs[key] + 1}\t255"
                   f"\t{len(seq)}M\t=\t{locs[mkey] + 1}\t{tlen}\t{seq}\t"
                   f"{qual}\tNM:i:{h.w}\tZS:Z:{CHAIN[h.parity]}{CHAIN[ch]}\n")
    return "".join(out)


def hit_of_line(line: str, names) -> tuple | None:
    """(chr, parity, wloc) a SAM line names, or None."""
    f = line.rstrip("\n").split("\t")
    tags = dict(t.split(":", 1) for t in f[11:] if ":" in t)
    zs = tags.get("ZS", "")
    if len(f) < 12 or f[2] not in names or not zs.startswith("Z:"):
        return None
    return names.index(f[2]), "+-".index(zs[2]), int(f[3]) - 1


# -- judging ------------------------------------------------------------------

def _find(q: Query, chr_, parity, wloc):
    for h in q.hits:
        if (h.chr, h.parity, h.wloc) == (chr_, parity, wloc):
            return h
    return None


def _counted(q: Query, place, tg: Targets):
    """The hit a line names, counted at its place, for a read the
    reference could not cut into windows (too many Ns); None when it is no
    hit within the budget."""
    w = count_at(tg, q, place[1], place[2], place[0])
    if w is None or w > q.budget:
        return None
    return Hit(place[0], place[1], place[2], w, 0)


def judge_se(q: Query, lines: list[str], tg: Targets) -> str | None:
    """None when the read's lines are what BSMAP may print, else why
    not."""
    names = tg.names
    if not q.kept:
        return "filtered read printed" if lines else None
    if not lines:
        if must_map(q):
            return "a read with a hit the seeding finds is missing"
        return None
    if len(lines) != 1:
        return f"{len(lines)} lines"
    place = hit_of_line(lines[0], names)
    if place is None:
        return "unparsable line"
    h = _find(q, *place) if q.searched else _counted(q, place, tg)
    if h is None:
        return "the line's hit is no hit of the read"
    lv, top = best(q)
    multi = bool(int(lines[0].split("\t")[1]) & 0x100)
    if q.searched and exact_se(q):
        if h.w != lv:
            return f"level {h.w}, the best is {lv}"
        if multi != (len(top) > 1):
            return f"0x100 is {multi} with {len(top)} best hits"
    elif q.searched and not (lv <= h.w <= upper_level(q)):
        return f"level {h.w} outside {lv}..{upper_level(q)}"
    want = se_line(q, h, multi, names)
    return None if lines[0] == want else "line differs"


def proper_pairs(qa: Query, qb: Query, o: Options) -> list:
    La, Lb = len(qa.seq), len(qb.seq)
    by = {}
    for hb in qb.hits:
        by.setdefault((hb.chr, hb.parity), []).append(hb)
    out = []
    for ha in qa.hits:
        for hb in by.get((ha.chr, ha.parity), []):
            ins = insert_of(ha, hb, La, Lb)
            if o.min_insert <= ins <= o.max_insert:
                out.append((max(ha.w, hb.w), ha.w + hb.w, ha, hb, ins))
    return out


def pair_found(p, qa: Query, qb: Query) -> bool:
    """Whether BSMAP's lockstep seeding must detect pair ``p``: both hits
    found by the step of the pair's worse level."""
    step, _, ha, hb, _ = p
    return (ha.broken <= min(step, qa.nseg - 1)
            and hb.broken <= min(step, qb.nseg - 1))


def judge_pe(qa: Query, qb: Query, lines: list[str], tg: Targets,
             o: Options) -> str | None:
    """``judge_se`` for a pair's lines (mate 1 ``qa``, mate 2 ``qb``)."""
    if not qa.kept or not qb.kept:
        alone = qb if not qa.kept else qa
        if not alone.kept:
            return "a pair of filtered mates printed" if lines else None
        return _judge_unpaired(alone, None, lines, tg, early_stop=True)
    paired = [ln for ln in lines if int(ln.split("\t")[1]) & 0x2]
    if paired:
        return _judge_pair(qa, qb, lines, tg, o)
    if not (qa.searched and qb.searched):
        return _judge_unpaired(qa, qb, lines, tg, early_stop=False)
    pairs = proper_pairs(qa, qb, o)
    if any(pair_found(p, qa, qb) for p in pairs):
        return "no pair printed for a pair the seeding finds"
    return _judge_unpaired(qa, qb, lines, tg, early_stop=False)


def _judge_pair(qa, qb, lines, tg, o) -> str | None:
    names = tg.names
    if len(lines) != 2:
        return f"{len(lines)} lines of a pair"
    pa, pb = (hit_of_line(ln, names) for ln in lines)
    if pa is None or pb is None:
        return "unparsable pair line"
    pairs = proper_pairs(qa, qb, o)
    multi = bool(int(lines[0].split("\t")[1]) & 0x100)
    for p in pairs:
        step, tot, ha, hb, ins = p
        want = pair_lines(qa, qb, ha, hb, ins, multi, names)
        if want == "".join(lines):
            break
    else:
        return "the pair is no proper pair of the reads"
    if not (qa.searched and qb.searched):
        return None
    i_star = min(x[0] for x in pairs)
    t_star = min(x[1] for x in pairs if x[0] == i_star)
    if (step, tot) < (i_star, t_star):
        return "a pair better than the reference's best"
    top = [x for x in pairs if x[0] == i_star and x[1] == t_star]
    used = [x for x in pairs if x[0] <= i_star]
    exact = (all(pair_found(x, qa, qb) for x in used)
             and len(top) < SEG_CAP)
    if exact:
        if (step, tot) != (i_star, t_star):
            return (f"pair levels ({step}, {tot}), the best is "
                    f"({i_star}, {t_star})")
        if multi != (len(top) > 1):
            return f"0x100 is {multi} with {len(top)} best pairs"
    return None


def _judge_unpaired(qa, qb, lines, tg, early_stop: bool) -> str | None:
    """Mates printed alone: ``qb`` None when the other mate was
    filtered."""
    names = tg.names
    mates = [(qa, 1 if qa.chain == 0 else 2)]
    if qb is not None:
        mates.append((qb, 2))
    printed = {}
    for ln in lines:
        f = ln.split("\t")
        rs = 1 if int(f[1]) & 0x40 else 2
        if rs in printed:
            return "a mate printed twice"
        printed[rs] = ln
    want_rs = {rs for _, rs in mates}
    if set(printed) - want_rs:
        return "a filtered mate printed"
    chosen = {}
    for q, rs in mates:
        ln = printed.get(rs)
        if ln is None:
            if must_map(q):
                return f"mate {rs} with a hit the seeding finds is missing"
            continue
        place = hit_of_line(ln, names)
        if place is None:
            return "unparsable line"
        h = _find(q, *place) if q.searched else _counted(q, place, tg)
        if h is None:
            return f"mate {rs}'s hit is no hit of the read"
        lv, top = best(q)
        multi = bool(int(ln.split("\t")[1]) & 0x100)
        if q.searched and exact_se(q, early_stop):
            if h.w != lv:
                return f"mate {rs} level {h.w}, the best is {lv}"
            if multi != (len(top) > 1):
                return f"mate {rs}: 0x100 is {multi} with {len(top)} hits"
        elif q.searched and h.w < lv:
            return f"mate {rs} level {h.w} under the best {lv}"
        chosen[rs] = (q, h, multi)
    for rs, (q, h, multi) in chosen.items():
        other = chosen.get(3 - rs)
        want = unpaired_line(q, rs, h, multi,
                             other[1] if other else None,
                             other[0] if other else None, names)
        if printed[rs] != want:
            return f"mate {rs}'s line differs"
    return None


# -- a run --------------------------------------------------------------------

def expectations(cfg: dict, traffic: dict, cache_dir: str, reads: list[str],
                 sample, device: str, rule: str = "bs"):
    """(targets, options, queries a, queries b or None) of the sample."""
    from genome import load_codes
    from reads import read_records
    o = Options.from_argv(list(cfg["options"]) + list(traffic["options"]))
    tg = Targets(load_codes(cfg, cache_dir), device)
    L = int(cfg["read_len"])
    qa = prepare(read_records(reads[0], L, sample), o, chain=0)
    qb = None
    if cfg["layout"] == "pe":
        qb = prepare(read_records(reads[1], L, sample), o, chain=1)
    search(tg, qa + (qb or []), o, rule)
    return tg, o, qa, qb


def judge_pass(tg, o, qa, qb, pass_, header: str) -> tuple[int, int, dict]:
    """(bad records, bad header, reasons) of one pass."""
    bad, why = 0, {}
    for k, q in enumerate(qa):
        lines = pass_["lines"].get(q.name, [])
        r = (judge_se(q, lines, tg) if qb is None
             else judge_pe(q, qb[k], lines, tg, o))
        if r is not None:
            bad += 1
            why.setdefault(r, q.name)
    return bad, int(pass_["header"] != header), why


def check_run(cfg, traffic, cache_dir, reads, sample, passes, device):
    """The verdict of one run (``harness.run_cell``'s ``check``)."""
    import sys
    import torch
    tg, o, qa, qb = expectations(cfg, traffic, cache_dir, reads, sample,
                                 device)
    header = sam_header(tg.names, tg.lens)
    bad = bad_h = 0
    reasons: dict = {}
    for p in passes:
        b, h, why = judge_pass(tg, o, qa, qb, p, header)
        bad += b
        bad_h += h
        for r, n in why.items():
            reasons.setdefault(r, n)
    qs = qa + (qb or [])
    exact = sum(1 for q in qa if q.kept and exact_se(q))
    print(f"check: {len(passes)} passes, {len(qa)} sampled "
          f"{'pairs' if qb else 'reads'}, {sum(q.kept for q in qs)} kept, "
          f"{sum(bool(q.hits) for q in qs)} with hits, {exact} exact; "
          f"pass bytes {sorted({p['bytes'] for p in passes})}; "
          f"reasons {dict(list(reasons.items())[:8])}", file=sys.stderr)
    del tg
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = {"bad_records": {"value": bad, "limit": 0},
              "bad_headers": {"value": bad_h, "limit": 0},
              "passes": {"value": len(passes), "limit": 1}}
    correct = bad == 0 and bad_h == 0 and len(passes) >= 1
    return {"correct": correct, "failed": bad, "checks": checks}
