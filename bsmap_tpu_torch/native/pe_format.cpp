// Pair-end block formatter of the PyTorch port: s_OutHitPair and
// s_OutHitUnpair (pairs.cpp:288-498) for SAM, SAM with XR:Z: reference
// context (-R) and BSP, every pair of a block from one row.
//
// bsmap_native.cpp's bsmap_format_pair_block covers plain SAM with the
// replayed pairs spliced in as text.  Here host-replayed pairs and pairs
// with a filtered mate arrive as synthesized rows like the device's, so the
// stateful context buffers (the reference's _mapseq, one per mate's
// SingleAlign: align.h:132) advance in one place and in pair order.
// Plain C ABI, loaded with ctypes by native/pe_format.py; every array is a
// caller-allocated numpy buffer.

#include <cstdint>
#include <cstring>

namespace {

// prow columns (int32): the 22 of bsmap_native.cpp's pair formatter, then
// the FilterReads verdict of each mate (pairs.cpp:206-212)
enum {
    P_PAIRED = 0, P_CNT, P_CHAIN, P_NA, P_NB, P_INS,
    P_ACHR, P_ALOC, P_BCHR, P_BLOC,
    P_FND_A, P_II_A, P_SSUM_A, P_SCH_A, P_CHRP_A, P_WLOC_A,
    P_FND_B, P_II_B, P_SSUM_B, P_SCH_B, P_CHRP_B, P_WLOC_B,
    P_FLT_A, P_FLT_B,
    P_NCOL
};

inline uint8_t* put_u32(uint8_t* o, uint32_t v) {
    char tmp[10];
    int k = 0;
    do {
        tmp[k++] = '0' + (v % 10);
        v /= 10;
    } while (v);
    while (k) *o++ = tmp[--k];
    return o;
}

inline uint8_t* put_i64(uint8_t* o, int64_t v) {
    if (v < 0) { *o++ = '-'; v = -v; }
    return put_u32(o, (uint32_t)v);
}

inline uint8_t* put_str(uint8_t* o, const char* s) {
    while (*s) *o++ = (uint8_t)*s++;
    return o;
}

inline uint8_t* put_mem(uint8_t* o, const uint8_t* s, int64_t len) {
    memcpy(o, s, (size_t)len);
    return o + len;
}

inline uint8_t* put_seq(uint8_t* o, const uint8_t* s, int64_t len,
                        const uint8_t* revc, bool rc) {
    if (!rc) return put_mem(o, s, len);
    for (int64_t k = len - 1; k >= 0; k--) *o++ = revc[s[k]];
    return o;
}

// quality of qlen bytes (seq_len synthetic bytes for FASTA), reversed
// with a reverse-complemented sequence
inline uint8_t* put_qual(uint8_t* o, const uint8_t* buf, int64_t qual_off,
                         int64_t qlen, int64_t seq_len, uint8_t synth,
                         bool rev) {
    if (qual_off < 0) {
        memset(o, synth, (size_t)seq_len);
        return o + seq_len;
    }
    const uint8_t* q = buf + qual_off;
    if (!rev) return put_mem(o, q, qlen);
    for (int64_t k = qlen - 1; k >= 0; k--) *o++ = q[k];
    return o;
}

inline uint8_t* put_chr(uint8_t* o, const uint8_t* chrnames,
                        const int64_t* chrname_off, int64_t chrp) {
    int64_t c = chrp >> 1;
    return put_mem(o, chrnames + chrname_off[c],
                   chrname_off[c + 1] - chrname_off[c]);
}

struct Ctx {
    const uint8_t* chrnames;
    const int64_t* chrname_off;
    const uint8_t* revc;
    int32_t out_unmap, rrhits, max_num_hits, out_ref;
    const uint32_t* refcat;
    int64_t total_codes;
    const int64_t* anchors;
    const char* useful_nt;
    int64_t maxseg;
};

// the reference-context string (align.cpp:670-688) into mapseq, as
// bsmap_native.cpp's ref_context: leading slots keep their stale content
// when loc < 2.  Returns its length, read_len + 4.
inline int64_t ref_context(const Ctx& c, uint8_t* mapseq, int64_t chrp,
                           int64_t loc, int64_t read_len) {
    int64_t anchor = c.anchors[chrp >> 1];
    int64_t ptr = 0;
    for (int64_t ii = 2; ii >= 1; ii--) {
        if (loc >= ii) {
            int64_t g = anchor + loc - ii;
            uint32_t v = (g >= 0 && g < c.total_codes)
                ? ((c.refcat[g >> 4] >> (2 * (15 - (g & 15)))) & 3u) : 0u;
            mapseq[ptr] = (uint8_t)(c.useful_nt[v] + 32);
        }
        ptr++;
    }
    for (int64_t ii = 0; ii < read_len + 2; ii++) {
        int64_t g = anchor + loc + ii;
        uint32_t v = (g >= 0 && g < c.total_codes)
            ? ((c.refcat[g >> 4] >> (2 * (15 - (g & 15)))) & 3u) : 0u;
        mapseq[ptr++] = (uint8_t)c.useful_nt[v];
    }
    mapseq[ptr - 1] += 32;
    mapseq[ptr - 2] += 32;
    return ptr;
}

// the range-start carry of a multi-process run (parallel/carry.py): a
// context byte printed from a leading slot that this range has not written
// yet is recorded as (file, slot, offset in that file's block bytes); the
// merge sets it to the slot's value at the end of the ranges before.
// Slots: mate 1's 0 and 1, mate 2's 0 and 1.  written == nullptr: off.
struct Track {
    int32_t* written;
    int64_t* rec;            // (cap, 3)
    int64_t cap, n;
    const uint8_t* base[2];  // out, out2
};

// slot s (0, 1) of a context at loc is written when loc >= 2 - s, else
// printed as the buffer holds it
inline void track_context(Track* t, int file, int mate, const uint8_t* o,
                          int64_t loc) {
    if (!t->written) return;
    for (int s = 0; s < 2; s++) {
        int id = 2 * mate + s;
        if (loc >= 2 - s) {
            t->written[id] = 1;
        } else if (!t->written[id]) {
            if (t->n < t->cap) {
                int64_t* r = t->rec + 3 * t->n;
                r[0] = file;
                r[1] = id;
                r[2] = (o - t->base[file]) + s;
            }
            t->n++;
        }
    }
}

inline uint8_t* put_context(uint8_t* o, const Ctx& c, uint8_t* mapseq,
                            int64_t chrp, int64_t loc, int64_t read_len,
                            Track* t, int file, int mate) {
    track_context(t, file, mate, o, loc);
    int64_t n = ref_context(c, mapseq, chrp, loc, read_len);
    return put_mem(o, mapseq, n);
}

// one BSP line (s_OutHit's BSP branch, align.cpp:723-760; output/sam.py
// _out_bsp): n < 0 QC, 0 NM, else the hit count; counts are the mate's
// (n, 2*maxseg) per-level (fwd, rc) pairs
uint8_t* bsp_line(uint8_t* o, const Ctx& c, const uint8_t* buf,
                  const int64_t* r, int64_t slen, int64_t qlen,
                  uint8_t synth, int32_t chain, int64_t n, int32_t nsnps,
                  int32_t chrp, int64_t loc, int64_t insert,
                  const int32_t* counts, int32_t budget, uint8_t* mapseq,
                  int64_t* n_aligned, Track* t, int file, int mate) {
    if (!c.out_unmap && (n <= 0 || (n > 1 && c.rrhits == 0))) return o;
    bool rc = n != 0 && ((chain ^ (chrp & 1)) != 0);
    o = put_mem(o, buf + r[0], r[1]);
    *o++ = '\t';
    o = put_seq(o, buf + r[2], slen, c.revc, rc);
    *o++ = '\t';
    o = put_qual(o, buf, r[4], qlen, slen, synth, rc);
    *o++ = '\t';
    const char* cls = (n < 0) ? "QC" : (n == 0) ? "NM" : (n == 1) ? "UM"
        : (n >= c.max_num_hits) ? "OF" : "MA";
    *o++ = cls[0];
    *o++ = cls[1];
    if ((n > 0 && c.rrhits == 1) || (n == 1 && c.rrhits == 0)) {
        (*n_aligned)++;
        *o++ = '\t';
        o = put_chr(o, c.chrnames, c.chrname_off, chrp);
        *o++ = '\t';
        o = put_u32(o, (uint32_t)(loc + 1));
        *o++ = '\t';
        *o++ = (chrp & 1) ? '-' : '+';
        *o++ = chain ? '-' : '+';
        *o++ = '\t';
        o = put_i64(o, insert);
        *o++ = '\t';
        o = put_context(o, c, mapseq, chrp, loc, slen, t, file, mate);
        *o++ = '\t';
        o = put_u32(o, (uint32_t)nsnps);
        *o++ = '\t';
        for (int64_t ii = 0; ii <= budget; ii++) {
            if (ii) *o++ = ':';
            uint32_t h = ii < c.maxseg
                ? (uint32_t)(counts[2 * ii] + counts[2 * ii + 1]) : 0u;
            o = put_u32(o, h);
        }
    }
    *o++ = '\n';
    return o;
}

// one mate's s_OutHitUnpair SAM line (pairs.cpp:426-498; output/pair_sam.py
// out_hit_unpair): ma < 0 filtered, 0 no hit, else the hit count
uint8_t* sam_unpair(uint8_t* o, const Ctx& c, const uint8_t* buf,
                    const int64_t* r, int32_t readset, uint8_t synth,
                    int64_t ma, int32_t na, int32_t sch, int32_t chrp,
                    int32_t wloc, int64_t mb, int32_t m_sch, int32_t m_chrp,
                    int32_t m_wloc, uint8_t* mapseq, int64_t* n_aligned,
                    Track* t) {
    int64_t seq_len = r[3], qual_len = r[5];
    uint32_t flag = 1u | (uint32_t)(0x40 * readset);
    bool mate_bad = (mb <= 0) || (mb > 1 && c.rrhits == 0);
    if (ma <= 0 || (ma > 1 && c.rrhits == 0)) {
        if (!c.out_unmap) return o;
        flag |= (ma < 0) ? 0x204u : (ma == 0) ? 0x004u : 0x104u;
        if (mate_bad) flag |= 0x008u;
        else if ((m_sch ^ (m_chrp & 1)) != 0) flag |= 0x020u;
        o = put_mem(o, buf + r[0], r[1]);
        *o++ = '\t';
        o = put_u32(o, flag);
        if (mate_bad) {
            o = put_str(o, "\t*\t0\t0\t*\t*\t0\t0\t");
        } else {
            o = put_str(o, "\t*\t0\t0\t*\t");
            o = put_chr(o, c.chrnames, c.chrname_off, m_chrp);
            *o++ = '\t';
            o = put_u32(o, (uint32_t)(m_wloc + 1));
            o = put_str(o, "\t0\t");
        }
        o = put_mem(o, buf + r[2], seq_len);
        *o++ = '\t';
        o = put_qual(o, buf, r[4], qual_len, seq_len, synth, false);
        *o++ = '\n';
        return o;
    }
    (*n_aligned)++;
    if (ma > 1) flag |= 0x100u;
    bool rc = (sch ^ (chrp & 1)) != 0;
    if (rc) flag |= 0x010u;
    if (mate_bad) flag |= 0x008u;
    else if ((m_sch ^ (m_chrp & 1)) != 0) flag |= 0x020u;
    o = put_mem(o, buf + r[0], r[1]);
    *o++ = '\t';
    o = put_u32(o, flag);
    *o++ = '\t';
    o = put_chr(o, c.chrnames, c.chrname_off, chrp);
    *o++ = '\t';
    o = put_u32(o, (uint32_t)(wloc + 1));
    o = put_str(o, "\t255\t");
    o = put_u32(o, (uint32_t)seq_len);
    o = put_str(o, "M\t");
    if (mate_bad) {
        o = put_str(o, "*\t0\t0\t");
    } else {
        o = put_chr(o, c.chrnames, c.chrname_off, m_chrp);
        *o++ = '\t';
        o = put_u32(o, (uint32_t)(m_wloc + 1));
        o = put_str(o, "\t0\t");
    }
    o = put_seq(o, buf + r[2], seq_len, c.revc, rc);
    *o++ = '\t';
    o = put_qual(o, buf, r[4], qual_len, seq_len, synth, rc);
    o = put_str(o, "\tNM:i:");
    o = put_u32(o, (uint32_t)na);
    if (c.out_ref) {
        o = put_str(o, "\tXR:Z:");
        o = put_context(o, c, mapseq, chrp, wloc, seq_len, t, 0,
                        readset - 1);
    }
    o = put_str(o, "\tZS:Z:");
    *o++ = (chrp & 1) ? '-' : '+';
    *o++ = sch ? '-' : '+';
    *o++ = '\n';
    return o;
}

}  // namespace

extern "C" {

// Format one block of pairs.  out_sam: 1 = SAM (every line to out),
// 0 = BSP (pair lines to out, unpaired lines to out2, the -2 file).
// prow: (n, 24) int32, P_* above.  cnt_a/cnt_b: (n, 2*maxseg) int32
// per-level counts and bud_a/bud_b the mates' post-trim mismatch budgets
// (BSP only; null otherwise).  mapseq_a/mapseq_b: the caller's persistent
// 256-byte context buffers of mate 1's and mate 2's SingleAlign (SAM pair
// lines use mate 1's for both mates, output/pair_sam.py _xr).
// out_len[2] gets the bytes written to out and out2; counters[3] +=
// {pairs, single a, single b} aligned.  track != 0: the range-start carry
// (Track above) with written[4], rec (rec_cap, 3) and *n_rec set to the
// records' count.  Returns 0, -1 when a buffer could overflow (the caller
// grows both, restores the context buffers and written and calls again)
// or -2 when *n_rec exceeds rec_cap (the same, with rec_cap >= *n_rec).
int64_t bsmap_pe_format_block(
    const uint8_t* bufa, const int64_t* reca,
    const uint8_t* bufb, const int64_t* recb, int64_t n,
    const int32_t* prow, const int32_t* cnt_a, const int32_t* cnt_b,
    int64_t maxseg, const int32_t* bud_a, const int32_t* bud_b,
    const uint8_t* chrnames, const int64_t* chrname_off,
    int64_t max_chrname, const uint8_t* revc, int32_t out_sam,
    int32_t out_ref, int32_t out_unmap, int32_t rrhits,
    int32_t max_num_hits, uint8_t synth_a, uint8_t synth_b,
    const uint32_t* refcat, int64_t total_codes, const int64_t* anchors,
    const char* useful_nt, uint8_t* mapseq_a, uint8_t* mapseq_b,
    uint8_t* out, int64_t out_cap, uint8_t* out2, int64_t out2_cap,
    int64_t* out_len, int64_t* counters, int32_t track, int32_t* written,
    int64_t* rec, int64_t rec_cap, int64_t* n_rec) {
    Ctx c{chrnames, chrname_off, revc, out_unmap, rrhits, max_num_hits,
          out_ref, refcat, total_codes, anchors, useful_nt, maxseg};
    Track tr{track ? written : nullptr, rec, rec_cap, 0, {out, out2}};
    uint8_t* o = out;
    uint8_t* o2 = out_sam ? nullptr : out2;
    int64_t dummy = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t* ra = reca + i * 6;
        const int64_t* rb = recb + i * 6;
        const int32_t* pr = prow + i * P_NCOL;
        // two lines of each mate at most: name, 3x seq (seq, context),
        // qual, two chromosome names, the histogram and the fixed fields
        int64_t need = 2 * (ra[1] + rb[1] + 3 * (ra[3] + rb[3]) + ra[5]
                            + rb[5] + 4 * max_chrname + 11 * maxseg + 256);
        if (out_cap - (o - out) < need
                || (o2 && out2_cap - (o2 - out2) < need))
            return -1;
        if (pr[P_PAIRED] > 0 && (pr[P_CNT] == 1 || rrhits == 1)) {
            counters[0]++;
            int64_t ins = pr[P_INS];
            int32_t chain = pr[P_CHAIN];
            int32_t achr = pr[P_ACHR], bchr = pr[P_BCHR];
            int64_t aloc = pr[P_ALOC], bloc = pr[P_BLOC];
            int64_t la = ra[3], qa = ra[5], lb = rb[3], qb = rb[5];
            // adapter run-through removal at output time (pairs.cpp:296-306)
            if (ins < la) {
                if ((chain ^ (achr & 1)) != 0) aloc += la - ins;
                la = ins;
                if (qa > ins) qa = ins;
            }
            if (ins < lb) {
                if (((1 - chain) ^ (bchr & 1)) != 0) bloc += lb - ins;
                lb = ins;
                if (qb > ins) qb = ins;
            }
            for (int m = 0; m < 2; m++) {
                const int64_t* r = m == 0 ? ra : rb;
                const uint8_t* buf = m == 0 ? bufa : bufb;
                int32_t chain_m = m == 0 ? chain : 1 - chain;
                int32_t chrp = m == 0 ? achr : bchr;
                int64_t loc = m == 0 ? aloc : bloc;
                int64_t mloc = m == 0 ? bloc : aloc;
                int32_t nm = m == 0 ? pr[P_NA] : pr[P_NB];
                int64_t slen = m == 0 ? la : lb;
                int64_t qlen = m == 0 ? qa : qb;
                uint8_t synth = m == 0 ? synth_a : synth_b;
                bool rc = (chain_m ^ (chrp & 1)) != 0;
                if (!out_sam) {
                    o = bsp_line(o, c, buf, r, slen, qlen, synth, chain_m,
                                 pr[P_CNT], nm, chrp, loc, ins,
                                 (m == 0 ? cnt_a : cnt_b) + i * 2 * maxseg,
                                 (m == 0 ? bud_a : bud_b)[i],
                                 m == 0 ? mapseq_a : mapseq_b, &dummy, &tr,
                                 0, m);
                    continue;
                }
                uint32_t flag = 0x3u | (pr[P_CNT] > 1 ? 0x100u : 0u)
                                | (uint32_t)(0x40 << m) | (rc ? 0x10u : 0x20u);
                o = put_mem(o, buf + r[0], r[1]);
                *o++ = '\t';
                o = put_u32(o, flag);
                *o++ = '\t';
                o = put_chr(o, chrnames, chrname_off, chrp);
                *o++ = '\t';
                o = put_u32(o, (uint32_t)(loc + 1));
                o = put_str(o, "\t255\t");
                o = put_u32(o, (uint32_t)slen);
                o = put_str(o, "M\t=\t");
                o = put_u32(o, (uint32_t)(mloc + 1));
                *o++ = '\t';
                o = put_i64(o, rc ? -ins : ins);
                *o++ = '\t';
                o = put_seq(o, buf + r[2], slen, revc, rc);
                *o++ = '\t';
                o = put_qual(o, buf, r[4], qlen, slen, synth, rc);
                o = put_str(o, "\tNM:i:");
                o = put_u32(o, (uint32_t)nm);
                if (out_ref) {
                    o = put_str(o, "\tXR:Z:");
                    o = put_context(o, c, mapseq_a, chrp, loc, slen, &tr,
                                    0, 0);
                }
                o = put_str(o, "\tZS:Z:");
                *o++ = (chrp & 1) ? '-' : '+';
                *o++ = chain_m ? '-' : '+';
                *o++ = '\n';
            }
            continue;
        }
        // unpaired fallback (pairs.cpp:244-286): each mate's selection
        int64_t ma = pr[P_FLT_A] ? -1 : (pr[P_FND_A] ? pr[P_SSUM_A] : 0);
        int64_t mb = pr[P_FLT_B] ? -1 : (pr[P_FND_B] ? pr[P_SSUM_B] : 0);
        if (out_sam) {
            o = sam_unpair(o, c, bufa, ra, 1, synth_a, ma, pr[P_II_A],
                           pr[P_SCH_A], pr[P_CHRP_A], pr[P_WLOC_A], mb,
                           pr[P_SCH_B], pr[P_CHRP_B], pr[P_WLOC_B],
                           mapseq_a, &counters[1], &tr);
            o = sam_unpair(o, c, bufb, rb, 2, synth_b, mb, pr[P_II_B],
                           pr[P_SCH_B], pr[P_CHRP_B], pr[P_WLOC_B], ma,
                           pr[P_SCH_A], pr[P_CHRP_A], pr[P_WLOC_A],
                           mapseq_b, &counters[2], &tr);
        } else {
            o2 = bsp_line(o2, c, bufa, ra, ra[3], ra[5], synth_a,
                          pr[P_SCH_A], ma, pr[P_II_A], pr[P_CHRP_A],
                          pr[P_WLOC_A], 0, cnt_a + i * 2 * maxseg, bud_a[i],
                          mapseq_a, &dummy, &tr, 1, 0);
            o2 = bsp_line(o2, c, bufb, rb, rb[3], rb[5], synth_b,
                          pr[P_SCH_B], mb, pr[P_II_B], pr[P_CHRP_B],
                          pr[P_WLOC_B], 0, cnt_b + i * 2 * maxseg, bud_b[i],
                          mapseq_b, &dummy, &tr, 1, 1);
        }
    }
    out_len[0] = o - out;
    out_len[1] = o2 ? o2 - out2 : 0;
    *n_rec = tr.n;
    return tr.n > rec_cap ? -2 : 0;
}

}  // extern "C"
