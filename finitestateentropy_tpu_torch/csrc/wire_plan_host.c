/* The plan of a byte group's multi-byte TurboRANS wires in one pass:
 * the alphabets, ids and escapes that turbo/pair.py's pair_plan and
 * turbo/quad.py's quad_plan build, bit for bit, and the group's byte
 * histogram for the wire pick (turbo/api.py's _wire_ests).
 *
 * The pass counts the group's quads (the u32 view, the tail padded by
 * repeating the last byte, as quad_view pads it) in an open-addressing
 * table sized from the group's quad count: no more than 255 + max_esc_frac
 * of the quads can be distinct in a group the quad wire takes, since all
 * but 255 distinct values escape.  The pair counts (the u16 view, an odd
 * tail repeating the last byte, as pair_view pads it) and the byte
 * histogram then follow from the distinct quads and their counts, less
 * what the padding adds, so a hot symbol costs one counter per distinct
 * quad.  Where the quads outgrow the table (the quad wire is then
 * ineligible) or the quad wire is not asked for, the pairs are counted
 * over the u16 view instead, even and odd positions in tables of their own
 * (a hot pair would otherwise chain its increments, as a hot byte does in
 * the reference's HIST_count_simple), and the byte histogram follows from
 * them.
 *
 * Per wire, as the numpy plans decide: at most 256 distinct values take
 * ids in ascending value; more keep the top 255 by (count descending,
 * value ascending), the stable argsort of -counts over ascending values,
 * and the escape id 255 codes the rest, unless more than max_esc_frac of
 * the wire's items would escape (the test in IEEE double, as numpy makes
 * it).  A group shorter than one item of the wire (2 bytes, 4 bytes) or
 * with one distinct value has no plan.  A wire without a plan stops before
 * any id is written.  One more pass writes the planned wires' ids and
 * their escapes, in ascending position.
 *
 * Build: cc -O3 -fPIC -shared -o libwire_plan_host.so wire_plan_host.c
 * (turbo/wire_plan.py builds it at the first plan and calls it through
 * ctypes).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the pair and quad views are little-endian"
#endif

#define KEEP 255           /* values kept beside the escape id */
#define ESC 255            /* the escape id of both wires */
#define LIVE (1u << 24)    /* marks a slot once its ids are written */
#define HAS_ESC (1u << 25) /* the slot's quad or one of its pairs escapes */

typedef struct {
    uint32_t key;
    uint32_t cnt; /* 0: empty; once the ids are known, LIVE | ids */
} slot_t;

typedef struct {
    slot_t *s;
    uint32_t mask, shift, used;
} table_t;

static inline uint32_t home(uint32_t key, uint32_t shift)
{
    return (key * 0x9E3779B1u) >> shift;
}

static inline uint32_t load32(const uint8_t *p)
{
    uint32_t w;
    memcpy(&w, p, 4);
    return w;
}

static inline uint16_t load16(const uint8_t *p)
{
    uint16_t w;
    memcpy(&w, p, 2);
    return w;
}

/* Count the n_quads quads (the last one `last`) into a table of room for
 * `limit` distinct keys at half load.  Returns 1 when counted, 0 when the
 * limit was reached, -1 when memory ran short. */
static int count_quads(table_t *t, const uint8_t *src, int64_t n_full,
                       int64_t n_quads, uint32_t last, int64_t limit)
{
    uint32_t log2n = 4;
    while (((int64_t)1 << log2n) < 2 * limit)
        log2n++;
    t->s = calloc((size_t)1 << log2n, sizeof(slot_t));
    if (!t->s)
        return -1;
    t->mask = (1u << log2n) - 1;
    t->shift = 32 - log2n;
    t->used = 0;
    for (int64_t q = 0; q < n_quads; q++) {
        uint32_t key = q < n_full ? load32(src + 4 * q) : last;
        uint32_t i = home(key, t->shift);
        for (;;) {
            slot_t *e = &t->s[i];
            if (e->key == key && e->cnt) {
                e->cnt++;
                break;
            }
            if (!e->cnt) {
                e->key = key;
                e->cnt = 1;
                if (++t->used >= limit)
                    return 0;
                break;
            }
            i = (i + 1) & t->mask;
        }
    }
    return 1;
}

/* The slot of a key the table holds (the table's fields passed by value:
 * the id stores may alias a table_t, not locals). */
static inline slot_t *table_find(slot_t *s, uint32_t mask, uint32_t shift,
                                 uint32_t key)
{
    uint32_t i = home(key, shift);
    while (s[i].key != key || !s[i].cnt)
        i = (i + 1) & mask;
    return &s[i];
}

typedef struct {
    uint32_t key;
    uint64_t cnt;
} entry_t;

/* a ranks below b: fewer, or as many and a larger value */
static inline int below(const entry_t *a, const entry_t *b)
{
    return a->cnt < b->cnt || (a->cnt == b->cnt && a->key > b->key);
}

static void sift_down(entry_t *h, int n, int i)
{
    for (;;) {
        int l = 2 * i + 1, r = l + 1, m = i;
        if (l < n && below(&h[l], &h[m]))
            m = l;
        if (r < n && below(&h[r], &h[m]))
            m = r;
        if (m == i)
            return;
        entry_t x = h[i];
        h[i] = h[m];
        h[m] = x;
        i = m;
    }
}

static int by_key(const void *a, const void *b)
{
    uint32_t x = ((const entry_t *)a)->key, y = ((const entry_t *)b)->key;
    return (x > y) - (x < y);
}

/* One wire's alphabet from its d distinct (value, count) entries over
 * n_items items: the kept values, ascending, into e[0..kept).  Returns the
 * number kept, or -1 with no plan (one value; too many escapes).  *n_esc
 * is -1 without an escape id. */
static int64_t alphabet(entry_t *e, int64_t d, int64_t n_items, double frac,
                        int64_t *n_esc)
{
    entry_t heap[KEEP];
    *n_esc = -1;
    if (d <= KEEP + 1) {
        if (d <= 1)
            return -1;
        qsort(e, d, sizeof *e, by_key);
        return d;
    }
    for (int i = 0; i < KEEP; i++)
        heap[i] = e[i];
    for (int j = KEEP / 2 - 1; j >= 0; j--)
        sift_down(heap, KEEP, j);
    for (int64_t i = KEEP; i < d; i++)
        if (below(&heap[0], &e[i])) {
            heap[0] = e[i];
            sift_down(heap, KEEP, 0);
        }
    uint64_t kept = 0;
    for (int i = 0; i < KEEP; i++)
        kept += heap[i].cnt;
    int64_t esc = n_items - (int64_t)kept;
    if ((double)esc > frac * (double)n_items)
        return -1;
    qsort(heap, KEEP, sizeof *heap, by_key);
    memcpy(e, heap, sizeof heap);
    *n_esc = esc;
    return KEEP;
}

/* res: [pair kept, pair escapes, quad kept, quad escapes]; kept -1 is no
 * plan (a wire not asked for too), escapes -1 no escape id.  byte_counts
 * gets the group's 256 byte counts.  Ids go to pair_ids (n_pairs u16) and
 * quad_ids (n_quads u8), escapes to *_esc_pos / *_esc_val (room for *_cap
 * of each).  Returns 0, or -1 when memory or an escape array ran short. */
int wire_plan(const uint8_t *src, int64_t n,
              int do_pair, double pair_frac, int do_quad, double quad_frac,
              int64_t *byte_counts, int64_t *res,
              uint16_t *pair_lut, int64_t *pair_cnt, uint16_t *pair_ids,
              uint32_t *pair_esc_pos, uint16_t *pair_esc_val, int64_t pair_cap,
              uint32_t *quad_lut, int64_t *quad_cnt, uint8_t *quad_ids,
              uint32_t *quad_esc_pos, uint32_t *quad_esc_val, int64_t quad_cap)
{
    const int64_t n_quads = (n + 3) / 4, n_full = n / 4, n_pairs = (n + 1) / 2;
    const int tail = (int)(n & 3);
    int rc = -1, counted = 0;
    table_t t = {0};
    uint32_t *pcount = NULL, *podd = NULL;
    uint8_t *pair_id_of = NULL;
    entry_t *ents = NULL;
    int64_t pair_kept = -1, pair_esc = -1, quad_kept = -1, quad_esc = -1;

    memset(byte_counts, 0, 256 * sizeof *byte_counts);
    res[0] = res[1] = res[2] = res[3] = -1;
    if (n <= 0)
        return 0;
    uint8_t pad[4];
    for (int k = 0; k < 4; k++)
        pad[k] = src[4 * n_full + k < n ? 4 * n_full + k : n - 1];
    const uint32_t last = load32(pad);   /* the last quad as padded */

    pcount = calloc(65536, sizeof *pcount);
    if (!pcount)
        goto out;
    if (do_quad && n >= 4) {
        /* an eligible group holds fewer than `limit` distinct quads */
        int64_t limit = KEEP + (int64_t)floor(quad_frac * (double)n_quads) + 1;
        counted = count_quads(&t, src, n_full, n_quads, last, limit);
        if (counted < 0)
            goto out;
    }
    int64_t d_quads = 0;
    if (counted) {
        ents = malloc((size_t)t.used * sizeof *ents);
        if (!ents)
            goto out;
        for (uint32_t i = 0; i <= t.mask; i++) {
            uint32_t c = t.s[i].cnt, k = t.s[i].key;
            if (!c)
                continue;
            ents[d_quads].key = k;
            ents[d_quads++].cnt = c;
            byte_counts[k & 255] += c;
            byte_counts[k >> 8 & 255] += c;
            byte_counts[k >> 16 & 255] += c;
            byte_counts[k >> 24] += c;
            pcount[k & 0xFFFF] += c;
            pcount[k >> 16] += c;
        }
        byte_counts[src[n - 1]] -= (4 - tail) & 3;   /* the quad view's pad */
        if (tail == 1 || tail == 2)
            pcount[last >> 16]--;                    /* past the pair view */
    } else {
        podd = calloc(65536, sizeof *podd);
        if (!podd)
            goto out;
        int64_t i = 0;
        for (; i + 1 < n / 2; i += 2) {   /* whole pairs, two at a time */
            pcount[load16(src + 2 * i)]++;
            podd[load16(src + 2 * i + 2)]++;
        }
        for (; i < n_pairs; i++)
            pcount[2 * i + 1 < n ? load16(src + 2 * i) : src[n - 1] * 257u]++;
        for (uint32_t v = 0; v < 65536; v++) {
            uint32_t c = pcount[v] += podd[v];
            byte_counts[v & 255] += c;
            byte_counts[v >> 8] += c;
        }
        byte_counts[src[n - 1]] -= n & 1;            /* the pair view's pad */
    }

    if (counted > 0 && do_quad) {
        quad_kept = alphabet(ents, d_quads, n_quads, quad_frac, &quad_esc);
        if (quad_esc > quad_cap)
            goto out;
        for (int64_t r = 0; r < quad_kept; r++) {
            quad_lut[r] = ents[r].key;
            quad_cnt[r] = (int64_t)ents[r].cnt;
        }
        if (quad_esc >= 0)
            quad_cnt[quad_kept] = quad_esc;
    }
    if (do_pair && n >= 2) {
        int64_t d_pairs = 0;
        for (uint32_t v = 0; v < 65536; v++)
            d_pairs += pcount[v] != 0;
        free(ents);
        ents = malloc((size_t)d_pairs * sizeof *ents);
        if (!ents)
            goto out;
        d_pairs = 0;
        for (uint32_t v = 0; v < 65536; v++)
            if (pcount[v]) {
                ents[d_pairs].key = v;
                ents[d_pairs++].cnt = pcount[v];
            }
        pair_kept = alphabet(ents, d_pairs, n_pairs, pair_frac, &pair_esc);
        if (pair_esc > pair_cap)
            goto out;
        pair_id_of = malloc(65536);
        if (!pair_id_of)
            goto out;
        memset(pair_id_of, ESC, 65536);
        for (int64_t r = 0; r < pair_kept; r++) {
            pair_lut[r] = (uint16_t)ents[r].key;
            pair_cnt[r] = (int64_t)ents[r].cnt;
            pair_id_of[ents[r].key] = (uint8_t)r;
        }
        if (pair_esc >= 0)
            pair_cnt[pair_kept] = pair_esc;
    }
    res[0] = pair_kept;
    res[1] = pair_esc;
    res[2] = quad_kept;
    res[3] = quad_esc;

    const int pair_on = pair_kept > 0, quad_on = quad_kept > 0;
    int64_t pe = 0, qe = 0;
    if (quad_on) {
        /* each slot's ids: its quad's, its low pair's, its high pair's */
        for (uint32_t i = 0; i <= t.mask; i++)
            if (t.s[i].cnt)
                t.s[i].cnt = LIVE | ESC;
        for (int64_t r = 0; r < quad_kept; r++)
            table_find(t.s, t.mask, t.shift, quad_lut[r])->cnt = LIVE | (uint32_t)r;
        for (uint32_t i = 0; i <= t.mask; i++) {
            slot_t *e = &t.s[i];
            if (!e->cnt)
                continue;
            uint32_t q = e->cnt & 255, lo = 0, hi = 0;
            int esc = quad_esc >= 0 && q == ESC;
            if (pair_on) {
                lo = pair_id_of[e->key & 0xFFFF];
                hi = pair_id_of[e->key >> 16];
                esc |= pair_esc >= 0 && (lo == ESC || hi == ESC);
            }
            e->cnt = LIVE | q | lo << 8 | hi << 16 | (esc ? HAS_ESC : 0);
        }
        slot_t *const slots = t.s;
        const uint32_t mask = t.mask, shift = t.shift;
        for (int64_t i = 0; i < n_quads; i++) {
            uint32_t key = i < n_full ? load32(src + 4 * i) : last;
            uint32_t c = table_find(slots, mask, shift, key)->cnt;
            int both = i < n_full || tail == 3;    /* the high half is a pair */
            quad_ids[i] = (uint8_t)c;
            if (pair_on) {
                pair_ids[2 * i] = (uint16_t)(c >> 8 & 255);
                if (both)
                    pair_ids[2 * i + 1] = (uint16_t)(c >> 16 & 255);
            }
            if (!(c & HAS_ESC))
                continue;
            if (quad_esc >= 0 && (c & 255) == ESC) {
                quad_esc_pos[qe] = (uint32_t)i;
                quad_esc_val[qe++] = key;
            }
            if (pair_on && pair_esc >= 0) {
                if ((c >> 8 & 255) == ESC) {
                    pair_esc_pos[pe] = (uint32_t)(2 * i);
                    pair_esc_val[pe++] = (uint16_t)key;
                }
                if (both && (c >> 16 & 255) == ESC) {
                    pair_esc_pos[pe] = (uint32_t)(2 * i + 1);
                    pair_esc_val[pe++] = (uint16_t)(key >> 16);
                }
            }
        }
    } else if (pair_on) {
        for (int64_t i = 0; i < n_pairs; i++) {
            uint16_t v = 2 * i + 1 < n ? load16(src + 2 * i) : src[n - 1] * 257u;
            uint8_t id = pair_id_of[v];
            pair_ids[i] = id;
            if (pair_esc >= 0 && id == ESC) {
                pair_esc_pos[pe] = (uint32_t)i;
                pair_esc_val[pe++] = v;
            }
        }
    }
    rc = pe == (pair_on && pair_esc > 0 ? pair_esc : 0)
         && qe == (quad_on && quad_esc > 0 ? quad_esc : 0) ? 0 : -1;
out:
    free(t.s);
    free(pcount);
    free(podd);
    free(pair_id_of);
    free(ents);
    return rc;
}
