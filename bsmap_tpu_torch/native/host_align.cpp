// Exact sequential WGBS aligner of the PyTorch port: the native form of
// engine/host_engine.py's HostEngine (SingleAlign's RunAlign,
// align.cpp:435-452) and engine/pair_host.py's PairHostEngine._run_pair
// (PairAlign's RunAlign, pairs.cpp:137-190), for the reads and pairs the
// device engines send to the host.  It follows the Python step for step:
//
//  - ConvertBinaySeq: the read's seed prefix goes into the caller's
//    MateState buffers; entries past len - S keep earlier reads' values.
//  - ReorderSeed / AdjustSeedStartArray: a bucket costs count + 2, sums are
//    taken & 0xFFFFFFFF, a probe outside the buffer costs 0, the start
//    offsets keep their values when max_offset == 0, and (cost, n) sort.
//  - SnpAlign's WGBS scan: lanes outside the genome read as code 0, Crick
//    hits map to Watson by rc_offsets - L - local, hits dedup by (chr, loc)
//    across both chains and all levels in insertion order, snp_thres
//    tightens when a level fills, a level-0 fill returns, and -r 0 aborts
//    on a second best hit when not pair-end.
//  - the pair lockstep: each step's level sorted by (chr, loc), GetPairs'
//    sweep in its order with its early stop at max_num_hits.
//  - the MateState sync of a span of device-handled reads, read straight
//    from a parsed block's buffer and records.
//
// The genome is read packed (16 bases a uint32 word) and the index by
// pointer: nothing is copied.  Plain C ABI, loaded with ctypes by
// native/host_align.py; every output array is the caller's.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int MAXSNPS = 15;
constexpr int NLEV = MAXSNPS + 1;
constexpr int NPAIR = 2 * MAXSNPS + 1;
constexpr int SEEDBUF = 160;       // MateState.SEEDBUF
constexpr int MAXW = 16;           // packed words of the longest read
constexpr uint64_t MASK32 = 0xFFFFFFFFull;

// Field order and types match native/host_align.py's _Ctx.
struct Ctx {
    const uint32_t* refcat;
    const uint32_t* crefcat;
    int64_t n_words;
    const int64_t* offsets;
    const uint32_t* locs;
    const int32_t* wcounts;
    const int64_t* anchors;        // n_chr entries
    const int64_t* sizes;
    const int64_t* rc_offsets;
    int64_t n_chr;
    const uint8_t* alphabet;       // 256 entries each
    const uint8_t* rev_alphabet;
    const int32_t* profile;        // [NLEV][index_interval]
    int32_t seed_size;
    int32_t index_interval;
    int32_t max_num_hits;
    int32_t report_repeat_hits;
    int32_t pairend;
    int32_t chains;
    int32_t min_insert;
    int32_t max_insert;
};

inline int64_t floordiv(int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

inline int64_t pymod(int64_t a, int64_t b) {
    int64_t r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

inline bool is_base(uint8_t ch) {
    switch (ch) {
        case 'A': case 'C': case 'G': case 'T':
        case 'a': case 'c': case 'g': case 't':
            return true;
        default:
            return false;
    }
}

using Hit = std::pair<int64_t, int64_t>;    // (chr_packed, watson_loc)

// (c, wloc) set with O(1) clear: a slot is live when its stamp is the
// current generation.
struct HitSet {
    std::vector<uint64_t> keys;
    std::vector<uint32_t> stamp;
    uint32_t gen = 0;
    size_t n = 0;

    void clear() {
        if (keys.empty()) {
            keys.assign(4096, 0);
            stamp.assign(4096, 0);
            gen = 0;
        }
        if (++gen == 0) {
            std::fill(stamp.begin(), stamp.end(), 0);
            gen = 1;
        }
        n = 0;
    }

    // True when the key was absent (and is now present).
    bool insert(uint64_t key) {
        if (4 * (n + 1) > keys.size()) grow();
        size_t mask = keys.size() - 1;
        size_t h = (size_t)((key * 0x9E3779B97F4A7C15ull) >> 17) & mask;
        while (stamp[h] == gen) {
            if (keys[h] == key) return false;
            h = (h + 1) & mask;
        }
        stamp[h] = gen;
        keys[h] = key;
        n++;
        return true;
    }

    void grow() {
        std::vector<uint64_t> live;
        for (size_t k = 0; k < keys.size(); k++)
            if (stamp[k] == gen) live.push_back(keys[k]);
        keys.assign(keys.size() * 2, 0);
        stamp.assign(keys.size(), 0);
        gen = 1;
        n = 0;
        for (uint64_t k : live) insert(k);
    }
};

// One read as SingleAlign holds it: packed code and valid-lane words of
// both chains, their seed arrays (the caller's MateState buffers) and the
// alignment state.
struct Mate {
    int64_t L = 0;
    int32_t budget = 0;
    int seg = 0;
    int nw = 0;
    bool flag = false, cflag = false;
    uint32_t q[2][MAXW], r[2][MAXW];
    int64_t* sarr[2] = {nullptr, nullptr};
    int64_t* offs = nullptr;       // [seed_start_offset, cseed_start_offset]
    int arr[2][NLEV];
    int order[2][NLEV];
    int snp_thres = 0;
    bool returned = false, aborted = false;
    std::vector<Hit> hits[2][NLEV];
    HitSet hitset;
};

// Seed values (XT, dbseq.cpp:286-291: code 3 counts as 1, base-3 digits,
// a window's last base least significant) of the windows of ``codes``
// starting at [from, to), into out[from, to): the first in full, each
// next one rolled on from the one before.
void seed_windows(const uint8_t* codes, int64_t from, int64_t to, int S,
                  int64_t* out) {
    if (from >= to) return;
    auto col = [](uint8_t c) -> int64_t { return c == 3 ? 1 : c; };
    int64_t top = 1;               // the weight of a window's first base
    for (int k = 1; k < S; k++) top *= 3;
    int64_t v = 0;
    for (int k = 0; k < S; k++) v = 3 * v + col(codes[from + k]);
    out[from] = v;
    for (int64_t p = from + 1; p < to; p++) {
        v = 3 * (v - col(codes[p - 1]) * top) + col(codes[p + S - 1]);
        out[p] = v;
    }
}

// ConvertBinaySeq (align.cpp:90-162): code words of the read and of its
// reverse complement, and the seed prefix written into the seed buffers.
void convert(const Ctx& cx, Mate& m, const uint8_t* seq) {
    const int64_t L = m.L;
    const int S = cx.seed_size;
    m.nw = (int)((L + 15) / 16);
    std::memset(m.q, 0, sizeof(m.q));
    std::memset(m.r, 0, sizeof(m.r));
    uint8_t codes[2][MAXW * 16];
    for (int64_t k = 0; k < L; k++) {
        uint8_t ch = seq[k], rch = seq[L - 1 - k];
        codes[0][k] = cx.alphabet[ch];
        codes[1][k] = cx.rev_alphabet[rch];
        int sh = 2 * (15 - (int)(k & 15));
        m.q[0][k >> 4] |= (uint32_t)codes[0][k] << sh;
        m.q[1][k >> 4] |= (uint32_t)codes[1][k] << sh;
        if (is_base(ch)) m.r[0][k >> 4] |= 3u << sh;
        if (is_base(rch)) m.r[1][k >> 4] |= 3u << sh;
    }
    if (L < S) return;
    for (int ch = 0; ch < 2; ch++)
        seed_windows(codes[ch], 0, L - S + 1, S, m.sarr[ch]);
}

// Bucket costs of the seed buffer's entries, read once each.
struct Costs {
    const Ctx& cx;
    const int64_t* sarr;
    int64_t memo[SEEDBUF];
    bool have[SEEDBUF];

    Costs(const Ctx& c, const int64_t* s) : cx(c), sarr(s) {
        std::memset(have, 0, sizeof(have));
    }

    // WGBS bucket cost: index2[s][0] holds count + 2 (dbseq.cpp:381-382).
    int64_t at(int64_t idx) {
        if (idx < 0 || idx >= SEEDBUF) return 0;
        if (!have[idx]) {
            int64_t sd = sarr[idx];
            int64_t c = cx.offsets[sd + 1] - cx.offsets[sd];
            memo[idx] = c > 0 ? c + 2 : 0;
            have[idx] = true;
        }
        return memo[idx];
    }

    int64_t count_seeds(int n, int64_t start) {
        const int I = cx.index_interval;
        int64_t total = 0;
        for (int i = 0; i < I; i++)
            total += at(cx.profile[n * I + i] + start - i);
        return total;
    }
};

// AdjustSeedStartArray (align.cpp:506-547).
void adjust_start_array(Costs& cs, int seg, int start_offset, int max_offset,
                        int* arr) {
    for (int n = 0; n < seg; n++) arr[n] = start_offset;
    for (int i = 0; i < seg; i++) {
        int ptr = i % 2 == 0 ? i / 2 : seg - 1 - i / 2;
        int start = ptr == 0 ? 0 : arr[ptr - 1];
        int end = ptr == seg - 1 ? max_offset : arr[ptr + 1];
        int best = start;
        uint64_t total = MASK32;
        arr[ptr] = start;
        for (int ii = start; ii <= end; ii++) {
            uint64_t tt = (uint64_t)cs.count_seeds(ptr, ii) & MASK32;
            if (tt < total) {
                total = tt;
                best = ii;
            }
        }
        arr[ptr] = best;
    }
}

// ReorderSeed (align.cpp:454-504), WGBS.
void reorder(const Ctx& cx, Mate& m) {
    const int S = cx.seed_size, I = cx.index_interval;
    const int seg = m.seg;
    Costs cf(cx, m.sarr[0]), cr(cx, m.sarr[1]);
    int max_offset = (int)pymod(m.L - I + 1, S);
    int s_off = (int)m.offs[0], c_off = (int)m.offs[1];
    uint64_t best = MASK32, cbest = MASK32;
    for (int i = 0; i < max_offset; i++) {
        if (m.flag) {
            uint64_t tt = 0;
            for (int n = 0; n < seg; n++) tt += cf.count_seeds(n, i);
            tt &= MASK32;
            if (tt < best) {
                best = tt;
                s_off = i;
            }
        }
        if (m.cflag) {
            uint64_t tt = 0;
            for (int n = 0; n < seg; n++) tt += cr.count_seeds(n, i);
            tt &= MASK32;
            if (tt < cbest) {
                cbest = tt;
                c_off = i;
            }
        }
    }
    if (m.flag) m.offs[0] = s_off;
    if (m.cflag) m.offs[1] = c_off;
    for (int ch = 0; ch < 2; ch++) {
        if (!(ch == 0 ? m.flag : m.cflag)) continue;
        Costs& cs = ch == 0 ? cf : cr;
        adjust_start_array(cs, seg, ch == 0 ? s_off : c_off, max_offset,
                           m.arr[ch]);
        std::pair<int64_t, int> costs[NLEV];
        for (int n = 0; n < seg; n++)
            costs[n] = {cs.count_seeds(n, m.arr[ch][n]), n};
        std::sort(costs, costs + seg);
        for (int n = 0; n < seg; n++) m.order[ch][n] = costs[n].second;
    }
}

// 16 genome lanes from base g on; lanes outside the array read as 0.
inline uint32_t window(const uint32_t* cat, int64_t nwords, int64_t g) {
    int64_t w = g >> 4;
    int sh = (int)(g & 15);
    uint32_t hi = (w >= 0 && w < nwords) ? cat[w] : 0u;
    if (sh == 0) return hi;
    uint32_t lo = (w + 1 >= 0 && w + 1 < nwords) ? cat[w + 1] : 0u;
    return (hi << (2 * sh)) | (lo >> (32 - 2 * sh));
}

// CountMismatch (align.h:167-200): ((q & XC(s)) ^ s) & r lanes, stopping
// once the count passes ``thres``.
inline int count_mismatch(const uint32_t* q, const uint32_t* r, int nw,
                          const uint32_t* cat, int64_t nwords, int64_t g,
                          int thres) {
    int mism = 0;
    const bool inside = g >= 0 && (g >> 4) + nw + 1 <= nwords;
    const int sh = (int)(g & 15);
    const uint32_t* base = inside ? cat + (g >> 4) : cat;
    for (int k = 0; k < nw; k++) {
        uint32_t s;
        if (inside) {
            s = sh == 0 ? base[k]
                        : (base[k] << (2 * sh)) | (base[k + 1] >> (32 - 2 * sh));
        } else {
            s = window(cat, nwords, g + 16 * (int64_t)k);
        }
        uint32_t xc = ((~s) << 1) | s | 0x55555555u;
        uint32_t x = ((q[k] & xc) ^ s) & r[k];
        mism += __builtin_popcount((x | (x >> 1)) & 0x55555555u);
        if (mism > thres) return mism;
    }
    return mism;
}

// One segment x all interval phases against the WGBS CSR index
// (align.cpp:253-345).
void wgbs_scan(const Ctx& cx, Mate& m, int chain, int modeindex, int mode) {
    const int I = cx.index_interval;
    const int64_t L = m.L;
    const int64_t nch = cx.n_chr;
    const int* arr = m.arr[chain];
    for (int i = 0; i < I; i++) {
        int a = cx.profile[modeindex * I + i];
        int64_t k = (int64_t)a + arr[modeindex] - i;
        if (k < 0 || k >= SEEDBUF) continue;
        int64_t seed = m.sarr[chain][k];
        int64_t o0 = cx.offsets[seed], o1 = cx.offsets[seed + 1];
        if (o1 == o0) continue;
        int64_t wc = cx.wcounts[seed];
        int64_t h = -(int64_t)a + i - arr[modeindex];
        for (int64_t j = 0; j < o1 - o0; j++) {
            if (j + 8 < o1 - o0) {
                int64_t gp = (int64_t)cx.locs[o0 + j + 8] + h;
                if (gp >= 0 && (gp >> 4) < cx.n_words)
                    __builtin_prefetch((j + 8 >= wc ? cx.crefcat : cx.refcat)
                                       + (gp >> 4));
            }
            bool crick_ref = j >= wc;
            int64_t g = (int64_t)cx.locs[o0 + j] + h;
            const uint32_t* cat = crick_ref ? cx.crefcat : cx.refcat;
            int w = count_mismatch(m.q[chain], m.r[chain], m.nw, cat,
                                   cx.n_words, g, m.snp_thres);
            if (w > m.snp_thres) continue;
            int64_t c = (int64_t)(std::upper_bound(cx.anchors,
                                                   cx.anchors + nch, g)
                                  - cx.anchors) - 1;
            c = c < 0 ? 0 : (c > nch - 1 ? nch - 1 : c);
            int64_t loc_local = g - cx.anchors[c];
            int64_t wloc, chrp;
            if (crick_ref) {
                wloc = cx.rc_offsets[c] - L - loc_local;
                chrp = 2 * c + 1;
            } else {
                wloc = loc_local;
                chrp = 2 * c;
            }
            if (wloc < 0 || wloc + L > cx.sizes[c]) continue;
            if (!m.hitset.insert(((uint64_t)c << 40) | (uint64_t)wloc))
                continue;
            m.hits[chain][w].push_back({chrp, wloc});
            size_t nsum = m.hits[0][w].size() + m.hits[1][w].size();
            if (w == mode && !cx.pairend && cx.report_repeat_hits == 0
                    && nsum > 1) {
                m.returned = true;
                m.aborted = true;
                return;
            }
            if ((int64_t)nsum >= cx.max_num_hits) {
                if (w == 0) {
                    m.returned = true;
                    return;
                }
                m.snp_thres = w - 1;
            }
        }
    }
}

// SnpAlign (align.cpp:168-347), WGBS: a return ends this call only.
void snp_align(const Ctx& cx, Mate& m, int mode) {
    m.returned = false;
    if (m.flag) {
        wgbs_scan(cx, m, 0, m.order[0][mode], mode);
        if (m.returned) return;
    }
    if (m.cflag) wgbs_scan(cx, m, 1, m.order[1][mode], mode);
}

void begin(const Ctx& cx, Mate& m, const uint8_t* seq, int64_t L,
           int32_t budget, int32_t readset, int64_t* seed_buf,
           int64_t* cseed_buf, int64_t* offs) {
    const int S = cx.seed_size, I = cx.index_interval;
    m.L = L;
    m.budget = budget;
    m.seg = (int)std::min<int64_t>(floordiv(L - I + 1, S), budget + 1);
    if (m.seg < 0) m.seg = 0;
    m.flag = cx.chains || readset < 2;
    m.cflag = cx.chains || readset == 2;
    m.sarr[0] = seed_buf;
    m.sarr[1] = cseed_buf;
    m.offs = offs;
    m.snp_thres = budget;
    m.returned = m.aborted = false;
    for (int ch = 0; ch < 2; ch++)
        for (int l = 0; l < NLEV; l++) m.hits[ch][l].clear();
    m.hitset.clear();
    convert(cx, m, seq);
    reorder(cx, m);
}

// Hits of both chains, chain-major then level, into ``out`` (chr, loc
// pairs); ``counts`` [2][NLEV].  False if they do not fit.
bool put_hits(const Mate& m, int64_t* out, int64_t cap, int32_t* counts) {
    int64_t k = 0;
    for (int ch = 0; ch < 2; ch++) {
        for (int l = 0; l < NLEV; l++) {
            const auto& v = m.hits[ch][l];
            counts[ch * NLEV + l] = (int32_t)v.size();
            if (k + (int64_t)v.size() > cap) return false;
            for (const Hit& hh : v) {
                out[2 * k] = hh.first;
                out[2 * k + 1] = hh.second;
                k++;
            }
        }
    }
    return true;
}

struct PairHitRow {
    int64_t v[8];     // chain, na, nb, insert, a chr, a loc, b chr, b loc
};

struct PairState {
    std::vector<PairHitRow> buckets[NPAIR];
};

// GetPairs' sweep (pairs.cpp:34-135) over one orientation; true at the
// early stop.
bool sweep(const Ctx& cx, const std::vector<Hit>& alist,
           const std::vector<Hit>& blist, int chain, int na, int nb,
           int64_t La, int64_t Lb, std::vector<PairHitRow>& bucket) {
    bool have = false;
    int64_t chra = 0;
    size_t bstart = 0, bend = 0;
    const size_t nbl = blist.size();
    for (const Hit& ah : alist) {
        if (!have || chra != ah.first) {
            have = true;
            chra = ah.first;
            bstart = bend;
            while (bstart < nbl && blist[bstart].first < chra) bstart++;
            bend = bstart;
            while (bend < nbl && blist[bend].first <= chra) bend++;
        }
        for (size_t j = bstart; j < bend; j++) {
            const Hit& bh = blist[j];
            int64_t seg_start, seg_end;
            bool b_first = chain == 0 ? (chra & 1) != 0 : (chra & 1) == 0;
            if (b_first) {
                seg_start = bh.second;
                seg_end = ah.second + La;
            } else {
                seg_start = ah.second;
                seg_end = bh.second + Lb;
            }
            int64_t insert = seg_end - seg_start;
            if (cx.min_insert <= insert && insert <= cx.max_insert) {
                bucket.push_back({{chain, na, nb, insert, ah.first,
                                   ah.second, bh.first, bh.second}});
                if ((int64_t)bucket.size() >= cx.max_num_hits) return true;
            }
        }
    }
    return false;
}

int get_pairs(const Ctx& cx, const Mate& a, const Mate& b, int na, int nb,
              PairState& ps) {
    if (na > a.budget || nb > b.budget) return 0;
    auto& bucket = ps.buckets[na + nb];
    if (sweep(cx, a.hits[0][na], b.hits[1][nb], 0, na, nb, a.L, b.L, bucket))
        return 1;
    if (sweep(cx, a.hits[1][na], b.hits[0][nb], 1, na, nb, a.L, b.L, bucket))
        return 1;
    return bucket.empty() ? 0 : 1;
}

thread_local Mate t_mate[2];
thread_local PairState t_pairs;

}  // namespace

extern "C" {

// RunAlign (align.cpp:435-452) of one filtered read, or with ``sync_only``
// only its MateState effects (HostEngine.sync_schedule).  Returns 0, or -1
// when the hits do not fit ``cap``.  ``flags``: [aborted_repeat].
int64_t bsmap_host_align(const Ctx* cx, const uint8_t* seq, int64_t L,
                         int32_t budget, int32_t readset, int64_t* seed_buf,
                         int64_t* cseed_buf, int64_t* offs, int32_t sync_only,
                         int64_t* hits_out, int64_t cap, int32_t* counts,
                         int32_t* flags) {
    Mate& m = t_mate[0];
    begin(*cx, m, seq, L, budget, readset, seed_buf, cseed_buf, offs);
    if (sync_only) return 0;
    for (int mode = 0; mode < m.seg; mode++) {
        snp_align(*cx, m, mode);
        // the WGBS progressive check (align.cpp:445-449)
        bool stop = m.returned;
        for (int ii = 0; ii <= mode && !stop; ii++)
            stop = !m.hits[0][ii].empty() || !m.hits[1][ii].empty();
        if (stop) break;
    }
    flags[0] = m.aborted ? 1 : 0;
    return put_hits(m, hits_out, cap, counts) ? 0 : -1;
}

// The MateState effects of a span of device-handled reads, in batch order
// (DeviceEngine._sync_state_span).  Read k is block record pos[k] of
// ``buf`` (rec rows of 6: its bases at rec[2], rec[3] of them); ``lens``
// are the lengths the device saw.  Both seed buffers take the last-writer-
// wins backward fill up to the span's cover (host_engine.fill_seed_buffers:
// newest read first, reads shorter than the seed skipped); the start
// offsets come from the last read with max_offset > 0 unless it is
// replayed: from ``soff``/``coff`` where the device rows carry them (``mode``
// bit 1 forward, bit 2 reverse), else by the schedule sync on its bases
// after the fill.  Returns 0, or -1 with nothing written when a read's
// seeds overrun the buffers.
int64_t bsmap_sync_span(const Ctx* cx, const uint8_t* buf, const int64_t* rec,
                        const int64_t* pos, const int64_t* lens,
                        const uint8_t* replay, int64_t n, int32_t readset,
                        int32_t max_snp_num, const int32_t* soff,
                        const int32_t* coff, int32_t mode, int64_t* seed_buf,
                        int64_t* cseed_buf, int64_t* offs) {
    const int S = cx->seed_size, I = cx->index_interval;
    int64_t maxlen = 0;
    for (int64_t k = 0; k < n; k++) {
        if (rec[6 * pos[k] + 3] > SEEDBUF + S - 1) return -1;
        maxlen = std::max(maxlen, lens[k]);
    }
    int64_t off_read = -1;
    for (int64_t k = n - 1; k >= 0; k--) {
        if (pymod(lens[k] - I + 1, S) == 0) continue;
        if (!replay[k]) {
            if (soff == nullptr) {
                off_read = k;
            } else {
                if (mode & 1) offs[0] = soff[k];
                if (mode & 2) offs[1] = coff[k];
            }
        }
        break;
    }
    if (off_read >= 0 && rec[6 * pos[off_read] + 3] <= 0) return -1;
    const int64_t cover = std::min<int64_t>(
        std::max<int64_t>(0, maxlen - S + 1), SEEDBUF);
    int64_t filled = 0;        // entries [0, filled) hold newer reads' seeds
    uint8_t codes[2][MAXW * 16];
    for (int64_t k = n - 1; k >= 0; k--) {
        const int64_t L = rec[6 * pos[k] + 3];
        if (L < S) continue;
        const uint8_t* seq = buf + rec[6 * pos[k] + 2];
        const int64_t n_ent = L - S + 1;
        if (n_ent > filled) {
            for (int64_t i = filled; i < L; i++) {
                codes[0][i] = cx->alphabet[seq[i]];
                codes[1][i] = cx->rev_alphabet[seq[L - 1 - i]];
            }
            seed_windows(codes[0], filled, n_ent, S, seed_buf);
            seed_windows(codes[1], filled, n_ent, S, cseed_buf);
            filled = n_ent;
        }
        if (filled >= cover) break;
    }
    if (off_read >= 0) {
        const int64_t L = rec[6 * pos[off_read] + 3];
        const int32_t budget = (int32_t)((max_snp_num + 1) * (L - 1) / L);
        begin(*cx, t_mate[0], buf + rec[6 * pos[off_read] + 2], L, budget,
              readset, seed_buf, cseed_buf, offs);
    }
    return 0;
}

// PairAlign::RunAlign (pairs.cpp:137-190) of a pair with both mates
// filtered in.  ``pair_out``: the pair hits, bucket by bucket in order
// (PairHitRow), ``pair_counts`` [NPAIR]; ``paired`` [1].  Returns 0, or -1
// when an output does not fit.
int64_t bsmap_host_align_pair(
        const Ctx* cx,
        const uint8_t* seq_a, int64_t La, int32_t bud_a, int32_t rs_a,
        int64_t* sb_a, int64_t* csb_a, int64_t* offs_a,
        const uint8_t* seq_b, int64_t Lb, int32_t bud_b, int32_t rs_b,
        int64_t* sb_b, int64_t* csb_b, int64_t* offs_b,
        int64_t* hits_a, int32_t* counts_a, int64_t* hits_b,
        int32_t* counts_b, int64_t cap, int64_t* pair_out,
        int32_t* pair_counts, int64_t cap_pairs, int32_t* paired) {
    Mate& a = t_mate[0];
    Mate& b = t_mate[1];
    PairState& ps = t_pairs;
    for (auto& v : ps.buckets) v.clear();
    begin(*cx, a, seq_a, La, bud_a, rs_a, sb_a, csb_a, offs_a);
    begin(*cx, b, seq_b, Lb, bud_b, rs_b, sb_b, csb_b, offs_b);
    int maxi = std::max(bud_a, bud_b);
    paired[0] = 0;
    for (int i = 0; i <= maxi; i++) {
        if (i < a.seg) snp_align(*cx, a, i);
        if (i < b.seg) snp_align(*cx, b, i);
        // SortHits4PE: (chr, loc) order
        if (i <= bud_a) {
            std::sort(a.hits[0][i].begin(), a.hits[0][i].end());
            std::sort(a.hits[1][i].begin(), a.hits[1][i].end());
        }
        if (i <= bud_b) {
            std::sort(b.hits[0][i].begin(), b.hits[0][i].end());
            std::sort(b.hits[1][i].begin(), b.hits[1][i].end());
        }
        int n = get_pairs(*cx, a, b, i, i, ps);
        for (int j = 0; j < i; j++) {
            n += get_pairs(*cx, a, b, i, j, ps);
            n += get_pairs(*cx, a, b, j, i, ps);
        }
        if (n > 0) {
            paired[0] = i + 1;
            break;
        }
    }
    if (!put_hits(a, hits_a, cap, counts_a)) return -1;
    if (!put_hits(b, hits_b, cap, counts_b)) return -1;
    int64_t k = 0;
    for (int t = 0; t < NPAIR; t++) {
        const auto& v = ps.buckets[t];
        pair_counts[t] = (int32_t)v.size();
        if (k + (int64_t)v.size() > cap_pairs) return -1;
        for (const PairHitRow& row : v) {
            std::memcpy(pair_out + 8 * k, row.v, sizeof(row.v));
            k++;
        }
    }
    return 0;
}

}  // extern "C"
