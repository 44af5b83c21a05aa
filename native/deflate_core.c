/*
 * tpu-deflate native runtime: host-side codec core.
 *
 * The reference library's runtime is a JVM stream stack; this framework's
 * host runtime is this small C core, driven from Python via ctypes with
 * the GIL released, so independent gzip members decode/encode on all host
 * cores while the accelerator handles the batched kernel paths.
 *
 * Contents:
 *   - td_crc32 / td_adler32: slice-by-8 CRC-32, blocked Adler-32
 *   - td_inflate: complete RFC 1951 decoder (stored/fixed/dynamic,
 *     32 KiB window, full error taxonomy; error codes = Python
 *     Reason + 1, see tpu_deflate/format/errors.py)
 *   - td_deflate_member: one-shot encoder for a 64 KiB member payload
 *     (hash-chain lazy matcher, optimal-with-repair Huffman lengths
 *     capped at a configurable code length, canonical codes, clen RLE) —
 *     single final DEFLATE block, matching the TD stream profile.
 *
 * Behavioral contracts mirror the reference decoder semantics
 * (/root/reference/src/io/nayuki/deflate/decomp/Open.java): degenerate
 * distance codes, reserved symbols, error precedence; differentially
 * tested against the Python host state machine.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Error codes: 0 = ok, otherwise Reason value + 1                     */
/* ------------------------------------------------------------------ */
enum {
    TD_OK = 0,
    TD_E_UNEXPECTED_END = 1,
    TD_E_RESERVED_BLOCK_TYPE = 2,
    TD_E_LEN_MISMATCH = 3,
    TD_E_UNDER_FULL = 4,
    TD_E_OVER_FULL = 5,
    TD_E_NO_PREV_CODE_LEN = 6,
    TD_E_CLEN_OVER_FULL = 7,
    TD_E_EOB_ZERO_LEN = 8,
    TD_E_RESERVED_LEN_SYM = 9,
    TD_E_RESERVED_DIST_SYM = 10,
    TD_E_EMPTY_DIST_CODE = 11,
    TD_E_BEFORE_START = 12,
    TD_E_OUTPUT_OVERFLOW = 100, /* internal: out_cap too small */
};

/* ------------------------------------------------------------------ */
/* Checksums                                                           */
/* ------------------------------------------------------------------ */

static uint32_t crc_tab[8][256];
static int crc_tab_init = 0;

static void crc_init(void) {
    if (crc_tab_init) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int t = 1; t < 8; t++)
            crc_tab[t][i] = (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
    crc_tab_init = 1;
}

uint32_t td_crc32(const uint8_t *buf, size_t len, uint32_t init) {
    crc_init();
    uint32_t c = init ^ 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4);
        memcpy(&hi, buf + 4, 4);
        lo ^= c;
        c = crc_tab[7][lo & 0xFF] ^ crc_tab[6][(lo >> 8) & 0xFF] ^
            crc_tab[5][(lo >> 16) & 0xFF] ^ crc_tab[4][lo >> 24] ^
            crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
            crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--) c = (c >> 8) ^ crc_tab[0][(c ^ *buf++) & 0xFF];
    return c ^ 0xFFFFFFFFu;
}

uint32_t td_adler32(const uint8_t *buf, size_t len, uint32_t init) {
    uint32_t a = init & 0xFFFF, b = (init >> 16) & 0xFFFF;
    while (len > 0) {
        size_t n = len > 5552 ? 5552 : len;
        len -= n;
        for (size_t i = 0; i < n; i++) {
            a += buf[i];
            b += a;
        }
        buf += n;
        a %= 65521;
        b %= 65521;
    }
    return (b << 16) | a;
}

/* ------------------------------------------------------------------ */
/* Bit reader                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *in;
    size_t in_len;
    size_t pos;      /* next byte */
    uint64_t reg;
    int reg_bits;
    int eof_err;
} BitIn;

static void bi_init(BitIn *b, const uint8_t *in, size_t n) {
    b->in = in; b->in_len = n; b->pos = 0; b->reg = 0; b->reg_bits = 0; b->eof_err = 0;
}

static void bi_fill(BitIn *b) {
    if (b->pos + 8 <= b->in_len) {
        /* bulk refill: one unaligned load tops the register up to >=56
         * bits; bytes shifted past bit 63 are re-read next time because
         * pos only advances by the bytes actually accounted. */
        uint64_t x;
        memcpy(&x, b->in + b->pos, 8);
        b->reg |= x << b->reg_bits;
        int add = (63 - b->reg_bits) >> 3;
        b->pos += (size_t)add;
        b->reg_bits += add * 8;
        return;
    }
    while (b->reg_bits <= 56 && b->pos < b->in_len)
        b->reg |= (uint64_t)b->in[b->pos++] << b->reg_bits, b->reg_bits += 8;
}

static int bi_read(BitIn *b, int n, uint32_t *out) {
    if (b->reg_bits < n) {
        bi_fill(b);
        if (b->reg_bits < n) return TD_E_UNEXPECTED_END;
    }
    *out = (uint32_t)(b->reg & ((1u << n) - 1));
    b->reg >>= n;
    b->reg_bits -= n;
    return TD_OK;
}

static void bi_align(BitIn *b) {
    int drop = b->reg_bits & 7;
    b->reg >>= drop;
    b->reg_bits -= drop;
}

/* peek up to 15 bits without consuming; returns available count */
static int bi_peek15(BitIn *b, uint32_t *val) {
    if (b->reg_bits < 15) bi_fill(b);
    *val = (uint32_t)(b->reg & 0x7FFF);
    return b->reg_bits < 15 ? b->reg_bits : 15;
}

/* ------------------------------------------------------------------ */
/* Canonical decode tables (15-bit flat LUT)                           */
/* ------------------------------------------------------------------ */

typedef struct {
    uint16_t e[1 << 15]; /* sym<<4 | len, one load per decode */
    uint32_t mask;       /* (1 << max present code length) - 1 */
} Lut;

/* Validate + build 15-bit LUT; replicates the reference's incremental
 * tree construction error precedence (Open.java:705-756). */
static int build_lut(const uint8_t *lens, int n, Lut *lut) {
    int counts[16] = {0};
    int total = 0;
    int max_present = 0;
    for (int i = 0; i < n; i++) {
        if (lens[i]) {
            counts[lens[i]]++;
            total++;
            if (lens[i] > max_present) max_present = lens[i];
        }
    }
    if (total < 2) return TD_E_UNDER_FULL;
    {
        long open_slots = 2, internals = 1, remaining = total;
        for (int l = 1; l <= max_present; l++) {
            if (counts[l] > open_slots) return TD_E_OVER_FULL;
            open_slots -= counts[l];
            remaining -= counts[l];
            if (remaining == 0) break;
            internals += open_slots;
            if (internals > total - 1) return TD_E_UNDER_FULL;
            open_slots *= 2;
        }
        if (open_slots > 0) return TD_E_UNDER_FULL;
    }
    /* canonical codes, bit-reversed fill */
    int next_code[16];
    int code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    /* table sized to the longest present code: profile streams cap
     * lengths at 12 bits, so the fill loop touches 4 K entries (8 KiB)
     * instead of 32 K — build cost and cache footprint both shrink. */
    int tbits = max_present;
    lut->mask = (1u << tbits) - 1;
    for (int s = 0; s < n; s++) {
        int l = lens[s];
        if (!l) continue;
        int c = next_code[l]++;
        /* bit reverse */
        int rev = 0;
        for (int k = 0; k < l; k++) rev |= ((c >> k) & 1) << (l - 1 - k);
        int step = 1 << l;
        uint16_t ent = (uint16_t)((s << 4) | l);
        for (int idx = rev; idx <= (int)lut->mask; idx += step)
            lut->e[idx] = ent;
    }
    return TD_OK;
}

static int decode_sym(BitIn *b, const Lut *lut, int *sym) {
    if (b->reg_bits < 15) bi_fill(b);
    uint32_t e = lut->e[b->reg & lut->mask];
    int l = (int)(e & 15);
    if (l > b->reg_bits) return TD_E_UNEXPECTED_END;
    b->reg >>= l;
    b->reg_bits -= l;
    *sym = (int)(e >> 4);
    return TD_OK;
}

/* run/dist base+extra tables (closed form at init) */
static const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
    35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
    3,3,3,3,4,4,4,4,5,5,5,5,0};
static const uint16_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
    257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
    7,7,8,8,9,9,10,10,11,11,12,12,13,13};

static const uint8_t CLEN_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

/* ------------------------------------------------------------------ */
/* Inflate                                                             */
/* ------------------------------------------------------------------ */

/* Full raw-DEFLATE decode. Returns TD_OK or an error code.
 * consumed: whole input bytes consumed (partial byte counts as consumed). */
int td_inflate(const uint8_t *in, size_t in_len, uint8_t *out, size_t out_cap,
               size_t *out_len, size_t *consumed) {
    static __thread Lut litlen_lut, dist_lut;
    static __thread Lut fixed_ll, fixed_d;
    static __thread int fixed_init = 0;
    BitIn b;
    bi_init(&b, in, in_len);
    size_t op = 0;
    int last = 0;
    int err;
    uint32_t v;

    if (!fixed_init) {
        uint8_t lens[288];
        for (int i = 0; i < 144; i++) lens[i] = 8;
        for (int i = 144; i < 256; i++) lens[i] = 9;
        for (int i = 256; i < 280; i++) lens[i] = 7;
        for (int i = 280; i < 288; i++) lens[i] = 8;
        build_lut(lens, 288, &fixed_ll);
        uint8_t dl[32];
        for (int i = 0; i < 32; i++) dl[i] = 5;
        build_lut(dl, 32, &fixed_d);
        fixed_init = 1;
    }

    while (!last) {
        if ((err = bi_read(&b, 1, &v))) return err;
        last = (int)v;
        if ((err = bi_read(&b, 2, &v))) return err;
        int btype = (int)v;
        if (btype == 3) return TD_E_RESERVED_BLOCK_TYPE;

        if (btype == 0) {
            bi_align(&b);
            uint32_t len, nlen;
            if ((err = bi_read(&b, 16, &len))) return err;
            if ((err = bi_read(&b, 16, &nlen))) return err;
            if (len != (nlen ^ 0xFFFFu)) return TD_E_LEN_MISMATCH;
            if (op + len > out_cap) return TD_E_OUTPUT_OVERFLOW;
            /* drain register first, then memcpy */
            uint32_t remaining = len;
            while (remaining && b.reg_bits >= 8) {
                out[op++] = (uint8_t)(b.reg & 0xFF);
                b.reg >>= 8;
                b.reg_bits -= 8;
                remaining--;
            }
            if (remaining) {
                if (b.pos + remaining > b.in_len) return TD_E_UNEXPECTED_END;
                memcpy(out + op, b.in + b.pos, remaining);
                op += remaining;
                b.pos += remaining;
                /* pos jumped: stale bulk-refill bits above reg_bits no
                 * longer mirror in[pos..], so drop them */
                b.reg &= (1ull << b.reg_bits) - 1;
            }
            continue;
        }

        const Lut *ll, *dd;
        int dist_empty = 0;
        if (btype == 1) {
            ll = &fixed_ll;
            dd = &fixed_d;
        } else {
            uint32_t hlit, hdist, hclen;
            if ((err = bi_read(&b, 5, &hlit))) return err;
            if ((err = bi_read(&b, 5, &hdist))) return err;
            if ((err = bi_read(&b, 4, &hclen))) return err;
            int nlit = (int)hlit + 257, ndist = (int)hdist + 1, nclen = (int)hclen + 4;
            uint8_t clen_lens[19];
            memset(clen_lens, 0, sizeof clen_lens);
            for (int i = 0; i < nclen; i++) {
                if ((err = bi_read(&b, 3, &v))) return err;
                clen_lens[CLEN_ORDER[i]] = (uint8_t)v;
            }
            static __thread Lut clen_lut;
            if ((err = build_lut(clen_lens, 19, &clen_lut))) return err;

            uint8_t lens[288 + 32];
            int total = nlit + ndist;
            int i = 0, prev = -1;
            while (i < total) {
                int s;
                if ((err = decode_sym(&b, &clen_lut, &s))) return err;
                if (s < 16) {
                    lens[i++] = (uint8_t)s;
                    prev = s;
                } else {
                    int run, val;
                    if (s == 16) {
                        if (prev < 0) return TD_E_NO_PREV_CODE_LEN;
                        if ((err = bi_read(&b, 2, &v))) return err;
                        run = 3 + (int)v; val = prev;
                    } else if (s == 17) {
                        if ((err = bi_read(&b, 3, &v))) return err;
                        run = 3 + (int)v; val = 0; prev = 0;
                    } else {
                        if ((err = bi_read(&b, 7, &v))) return err;
                        run = 11 + (int)v; val = 0; prev = 0;
                    }
                    if (i + run > total) return TD_E_CLEN_OVER_FULL;
                    while (run--) lens[i++] = (uint8_t)val;
                }
            }
            if (lens[256] == 0) return TD_E_EOB_ZERO_LEN;
            uint8_t ll_lens[288];
            memset(ll_lens, 0, sizeof ll_lens);
            memcpy(ll_lens, lens, nlit);
            if ((err = build_lut(ll_lens, 288, &litlen_lut))) return err;
            ll = &litlen_lut;

            uint8_t d_lens[32];
            memset(d_lens, 0, sizeof d_lens);
            memcpy(d_lens, lens + nlit, ndist);
            if (ndist == 1 && d_lens[0] == 0) {
                dist_empty = 1;
                dd = NULL;
            } else {
                int ones = 0, others = 0;
                for (int k = 0; k < 32; k++) {
                    if (d_lens[k] == 1) ones++;
                    else if (d_lens[k] > 1) others++;
                }
                if (ones == 1 && others == 0) d_lens[31] = 1; /* dummy: Open.java:421-425 */
                if ((err = build_lut(d_lens, 32, &dist_lut))) return err;
                dd = &dist_lut;
            }
        }

        /* block body */
        for (;;) {
            /* Fast path (≙ the reference's maxBitsPerIteration scheme,
             * Open.java:479-563): with >=48 register bits — the worst
             * case for litlen(15)+len extra(5)+dist(15)+dist extra(13)
             * — and >=272 output slack, one iteration runs with no
             * refill or bounds checks and a sloppy 8-byte-wide copy. */
            if (b.reg_bits < 48) bi_fill(&b);
            while (b.reg_bits >= 48 && out_cap - op >= 272) {
                uint32_t e = ll->e[b.reg & ll->mask];
                int l = (int)(e & 15);
                int sym = (int)(e >> 4);
                b.reg >>= l;
                b.reg_bits -= l;
                if (sym < 256) {
                    out[op++] = (uint8_t)sym;
                    if (b.reg_bits < 48) bi_fill(&b);
                    continue;
                }
                if (sym == 256) goto block_done;
                if (sym > 285) return TD_E_RESERVED_LEN_SYM;
                int eb = LEN_EXTRA[sym - 257];
                uint32_t run = LEN_BASE[sym - 257] +
                               (uint32_t)(b.reg & ((1u << eb) - 1));
                b.reg >>= eb;
                b.reg_bits -= eb;
                if (dist_empty) return TD_E_EMPTY_DIST_CODE;
                e = dd->e[b.reg & dd->mask];
                l = (int)(e & 15);
                int dsym = (int)(e >> 4);
                b.reg >>= l;
                b.reg_bits -= l;
                if (dsym > 29) return TD_E_RESERVED_DIST_SYM;
                eb = DIST_EXTRA[dsym];
                uint32_t dist = DIST_BASE[dsym] +
                                (uint32_t)(b.reg & ((1u << eb) - 1));
                b.reg >>= eb;
                b.reg_bits -= eb;
                if (dist > op) return TD_E_BEFORE_START;
                uint8_t *dst = out + op;
                const uint8_t *src = dst - dist;
                op += run;
                if (dist >= 8) {
                    /* sloppy word copy: may write up to 7 bytes past
                     * run, covered by the 272-byte slack guard */
                    do {
                        memcpy(dst, src, 8);
                        dst += 8;
                        src += 8;
                    } while (dst < out + op);
                } else if (dist == 1) {
                    memset(dst, src[0], run);
                } else {
                    for (uint32_t k = 0; k < run; k++) dst[k] = src[k];
                }
                if (b.reg_bits < 48) bi_fill(&b);
            }
            /* checked path: near end of input or output */
            int sym;
            if ((err = decode_sym(&b, ll, &sym))) return err;
            if (sym < 256) {
                if (op >= out_cap) return TD_E_OUTPUT_OVERFLOW;
                out[op++] = (uint8_t)sym;
                continue;
            }
            if (sym == 256) break;
            if (sym > 285) return TD_E_RESERVED_LEN_SYM;
            uint32_t extra;
            if ((err = bi_read(&b, LEN_EXTRA[sym - 257], &extra))) return err;
            uint32_t run = LEN_BASE[sym - 257] + extra;
            if (dist_empty) return TD_E_EMPTY_DIST_CODE;
            int dsym;
            if ((err = decode_sym(&b, dd, &dsym))) return err;
            if (dsym > 29) return TD_E_RESERVED_DIST_SYM;
            if ((err = bi_read(&b, DIST_EXTRA[dsym], &extra))) return err;
            uint32_t dist = DIST_BASE[dsym] + extra;
            if (dist > op) return TD_E_BEFORE_START;
            if (op + run > out_cap) return TD_E_OUTPUT_OVERFLOW;
            if (dist >= run) {
                memcpy(out + op, out + op - dist, run);
                op += run;
            } else {
                const uint8_t *src = out + op - dist;
                uint8_t *dst = out + op;
                for (uint32_t k = 0; k < run; k++) dst[k] = src[k];
                op += run;
            }
        }
    block_done:;
    }
    *out_len = op;
    *consumed = b.pos - (size_t)(b.reg_bits / 8);
    return TD_OK;
}

/* ------------------------------------------------------------------ */
/* Token resolve: expand a device-decoded token stream to bytes        */
/* (phase 2 of the device decoder: LZ77 expansion is memcpy-bound host */
/* work; tokens are literal byte, or bit26 | run<<16 | (dist-1)).      */
/* ------------------------------------------------------------------ */

int td_resolve_tokens(const int32_t *tokens, size_t ntok, uint8_t *out,
                      size_t out_cap, size_t *out_len) {
    size_t op = 0;
    for (size_t k = 0; k < ntok; k++) {
        int32_t t = tokens[k];
        if (!(t & (1 << 26))) {
            if (op >= out_cap) return TD_E_OUTPUT_OVERFLOW;
            out[op++] = (uint8_t)(t & 0xFF);
            continue;
        }
        uint32_t run = ((uint32_t)t >> 16) & 0x3FF;
        uint32_t dist = ((uint32_t)t & 0xFFFF) + 1;
        if (dist > op) return TD_E_BEFORE_START;
        if (op + run > out_cap) return TD_E_OUTPUT_OVERFLOW;
        if (dist >= run) {
            memcpy(out + op, out + op - dist, run);
        } else {
            const uint8_t *src = out + op - dist;
            uint8_t *dst = out + op;
            for (uint32_t j = 0; j < run; j++) dst[j] = src[j];
        }
        op += run;
    }
    *out_len = op;
    return TD_OK;
}

/* ------------------------------------------------------------------ */
/* Deflate: one-shot member payload encoder (single final block)       */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *out;
    size_t cap;
    size_t pos;       /* bytes written */
    uint64_t reg;
    int reg_bits;
    int overflow;
} BitOut;

static void bo_init(BitOut *o, uint8_t *out, size_t cap) {
    o->out = out; o->cap = cap; o->pos = 0; o->reg = 0; o->reg_bits = 0; o->overflow = 0;
}

static void bo_write(BitOut *o, uint32_t val, int n) {
    o->reg |= (uint64_t)val << o->reg_bits;
    o->reg_bits += n;
    while (o->reg_bits >= 8) {
        if (o->pos >= o->cap) { o->overflow = 1; o->reg_bits = 0; return; }
        o->out[o->pos++] = (uint8_t)(o->reg & 0xFF);
        o->reg >>= 8;
        o->reg_bits -= 8;
    }
}

static size_t bo_finish(BitOut *o) {
    if (o->reg_bits > 0) {
        if (o->pos >= o->cap) { o->overflow = 1; return o->pos; }
        o->out[o->pos++] = (uint8_t)(o->reg & 0xFF);
        o->reg = 0; o->reg_bits = 0;
    }
    return o->pos;
}

/* ---- Huffman code length computation (heap Huffman + Kraft repair) -- */

static void heap_push(uint64_t *h, int *n, uint64_t v) {
    int i = (*n)++;
    h[i] = v;
    while (i > 0) {
        int p = (i - 1) >> 1;
        if (h[p] <= h[i]) break;
        uint64_t t = h[p]; h[p] = h[i]; h[i] = t;
        i = p;
    }
}

static uint64_t heap_pop(uint64_t *h, int *n) {
    uint64_t top = h[0];
    h[0] = h[--(*n)];
    int i = 0;
    for (;;) {
        int l = 2 * i + 1, r = l + 1, m = i;
        if (l < *n && h[l] < h[m]) m = l;
        if (r < *n && h[r] < h[m]) m = r;
        if (m == i) break;
        uint64_t t = h[m]; h[m] = h[i]; h[i] = t;
        i = m;
    }
    return top;
}

/* freqs[n] -> lens[n], max_len-limited complete code (>=2 used symbols
 * assumed handled by caller fixes). */
static void huff_lengths(const uint32_t *freqs, int n, int max_len, uint8_t *lens) {
    /* nodes: leaf i in [0,n); internal from n. value packed freq<<16|id */
    uint64_t heap[640];
    int hn = 0;
    int parent[1280];
    int used = 0, lastsym = -1;
    for (int i = 0; i < n; i++) {
        lens[i] = 0;
        if (freqs[i]) { used++; lastsym = i; }
    }
    if (used == 0) return;
    if (used == 1) { lens[lastsym] = 1; return; }
    for (int i = 0; i < n; i++)
        if (freqs[i]) heap_push(heap, &hn, ((uint64_t)freqs[i] << 16) | (uint64_t)i);
    int next_id = n;
    while (hn > 1) {
        uint64_t a = heap_pop(heap, &hn), bnd = heap_pop(heap, &hn);
        uint64_t f = (a >> 16) + (bnd >> 16);
        parent[a & 0xFFFF] = next_id;
        parent[bnd & 0xFFFF] = next_id;
        heap_push(heap, &hn, (f << 16) | (uint64_t)next_id);
        next_id++;
    }
    int root = next_id - 1;
    /* depths: parents have higher ids; iterate down */
    static __thread int depth_buf[1280];
    depth_buf[root] = 0;
    for (int id = root - 1; id >= 0; id--) {
        if (id < n && !freqs[id]) continue;
        depth_buf[id] = depth_buf[parent[id]] + 1;
    }
    /* bl_count with clamp + exact slot repair (same algebra as
     * kernels/huffman.py huffman_lengths_batch) */
    long bl_count[64];
    memset(bl_count, 0, sizeof bl_count);
    for (int i = 0; i < n; i++) {
        if (!freqs[i]) continue;
        int d = depth_buf[i];
        if (d > max_len) d = max_len;
        if (d < 1) d = 1;
        bl_count[d]++;
    }
    long full = 1L << max_len;
    long needed = 0;
    for (int l = 1; l <= max_len; l++) needed += bl_count[l] << (max_len - l);
    while (needed > full) {
        int bits = max_len - 1;
        while (bits > 0 && bl_count[bits] == 0) bits--;
        bl_count[bits]--;
        bl_count[bits + 1] += 2;
        bl_count[max_len]--;
        needed--;
    }
    /* assign: ascending frequency -> descending length. sort used symbols
     * by (freq, sym) via simple index sort (n <= 320). */
    int order[320];
    int m = 0;
    for (int i = 0; i < n; i++)
        if (freqs[i]) order[m++] = i;
    /* insertion sort by freq then sym (stable enough; n small) */
    for (int i = 1; i < m; i++) {
        int key = order[i];
        int j = i - 1;
        while (j >= 0 && (freqs[order[j]] > freqs[key] ||
               (freqs[order[j]] == freqs[key] && order[j] > key))) {
            order[j + 1] = order[j];
            j--;
        }
        order[j + 1] = key;
    }
    int oi = 0;
    for (int l = max_len; l >= 1; l--)
        for (long c = 0; c < bl_count[l]; c++)
            lens[order[oi++]] = (uint8_t)l;
}

static void canon_codes(const uint8_t *lens, int n, uint16_t *codes) {
    int counts[16];
    memset(counts, 0, sizeof counts);
    for (int i = 0; i < n; i++) counts[lens[i]]++;
    counts[0] = 0;
    int next_code[16];
    int code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int s = 0; s < n; s++) {
        int l = lens[s];
        if (!l) { codes[s] = 0; continue; }
        int c = next_code[l]++;
        int rev = 0;
        for (int k = 0; k < l; k++) rev |= ((c >> k) & 1) << (l - 1 - k);
        codes[s] = (uint16_t)rev;
    }
}

/* run -> (sym, extra bits, extra val) */
static inline void run_sym(uint32_t run, int *sym, int *eb, uint32_t *ev) {
    int lo = 0, hi = 28;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (LEN_BASE[mid] <= run) lo = mid; else hi = mid - 1;
    }
    if (run == 258) lo = 28;
    *sym = 257 + lo;
    *eb = LEN_EXTRA[lo];
    *ev = run - LEN_BASE[lo];
}

static inline void dist_sym(uint32_t dist, int *sym, int *eb, uint32_t *ev) {
    int lo = 0, hi = 29;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (DIST_BASE[mid] <= dist) lo = mid; else hi = mid - 1;
    }
    *sym = lo;
    *eb = DIST_EXTRA[lo];
    *ev = dist - DIST_BASE[lo];
}

#define HASH_BITS 15
#define HASH_SIZE (1 << HASH_BITS)
#define WIN 32768

static inline uint32_t hash4(const uint8_t *p) {
    uint32_t x;
    memcpy(&x, p, 4);
    return (x * 2654435761u) >> (32 - HASH_BITS);
}

/* 3-byte hash: chains keyed on the minimum match length, so length-3
 * matches are discoverable (a 4-byte key silently loses every len-3
 * match; ≙ the reference searches all distances down to minRun=3,
 * comp/Lz77Huffman.java:71-84). */
static inline uint32_t hash3(const uint8_t *p) {
    uint32_t x = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (x * 2654435761u) >> (32 - HASH_BITS);
}

/* Core block encoder.
 *
 * in = [history (hist_len bytes) | data (n bytes)], total <= 128 KiB.
 * Emits ONE DEFLATE block covering the data (dynamic, or stored when
 * smaller and byte-alignable), starting at bit position start_bit (0-7)
 * with seed_byte's low start_bit bits already occupied. Matches may
 * reach into the history (the continuous-stream mode: ≙ the reference's
 * sliding [history][data] buffer, DeflaterOutputStream.java:38-45).
 *
 * Returns the TOTAL bit count (including start_bit) written into out
 * (out[0] is OR-seeded with seed_byte), or 0 on error. */
static size_t deflate_block(const uint8_t *in, size_t hist_len, size_t n,
                            uint8_t *out, size_t out_cap, int final,
                            int start_bit, uint8_t seed_byte,
                            int max_code_len, int max_chain);

/* Encode one member payload (<= 64 KiB data) as a single final DEFLATE
 * block with code lengths capped at max_code_len. Falls back to stored
 * blocks when that is smaller. Returns compressed size, or 0 on error. */
size_t td_deflate_member(const uint8_t *in, size_t n, uint8_t *out, size_t out_cap,
                         int max_code_len, int max_chain) {
    size_t bits = deflate_block(in, 0, n, out, out_cap, 1, 0, 0,
                                max_code_len, max_chain);
    if (bits == 0 && n > 0) return 0;
    return (bits + 7) / 8;
}

/* Exported generalized block encoder (continuous-stream building block). */
size_t td_deflate_block(const uint8_t *in, size_t hist_len, size_t n,
                        uint8_t *out, size_t out_cap, int final,
                        int start_bit, unsigned seed_byte,
                        int max_code_len, int max_chain) {
    return deflate_block(in, hist_len, n, out, out_cap, final, start_bit,
                         (uint8_t)seed_byte, max_code_len, max_chain);
}

#define ENC_MAX_TOTAL (1 << 17)

static size_t deflate_block(const uint8_t *in, size_t hist_len, size_t n,
                            uint8_t *out, size_t out_cap, int final,
                            int start_bit, uint8_t seed_byte,
                            int max_code_len, int max_chain) {
    /* --- tokenize: hash-chain lazy matcher over [history | data] --- */
    static __thread int32_t head[HASH_SIZE];
    static __thread int32_t prevtab[ENC_MAX_TOTAL];
    static __thread uint16_t tok_run[1 << 16];
    static __thread uint16_t tok_dist[1 << 16];
    static __thread uint8_t tok_lit[1 << 16];
    static __thread uint32_t freqs_ll[288], freqs_d[30];
    size_t total = hist_len + n;
    if (n > (1 << 16) || total > ENC_MAX_TOTAL || out_cap < 64) return 0;
    if (start_bit < 0 || start_bit > 7) return 0;
    memset(freqs_ll, 0, sizeof freqs_ll);
    memset(freqs_d, 0, sizeof freqs_d);
    memset(head, -1, sizeof head);
    int ntok = 0;
    size_t i = hist_len;
    /* zlib-style "nice length": once a match this long is found, stop
     * walking the chain (derived from max_chain to keep the ABI). */
    uint32_t nice_len = max_chain <= 8 ? 32 : max_chain <= 64 ? 96 : 258;

    if (max_chain <= 4) {
        /* Greedy hash4 fast mode (effort 1): a single-entry head table,
         * no chains, no lazy pass — one hash+verify per position, match
         * length >=4 (the classic fast-level trade: len-3 matches are
         * not discoverable). Several times the throughput of the lazy
         * matcher at a few percent ratio cost. */
        for (size_t j = 0; j + 4 <= hist_len; j++)
            head[hash4(in + j)] = (int32_t)j;
        i = hist_len;
        while (i < total) {
            uint32_t x, y;
            if (i + 4 > total) goto fast_lit;
            {
                uint32_t h = hash4(in + i);
                int32_t c = head[h];
                head[h] = (int32_t)i;
                memcpy(&x, in + i, 4);
                if (c < 0 || i - (size_t)c > WIN) goto fast_lit;
                memcpy(&y, in + (size_t)c, 4);
                if (x != y) goto fast_lit;
                uint32_t lim = total - i < 258 ? (uint32_t)(total - i) : 258;
                uint32_t l = 4;
                const uint8_t *a = in + i, *bb = in + (size_t)c;
                while (l + 8 <= lim) {
                    uint64_t xa, xb;
                    memcpy(&xa, a + l, 8);
                    memcpy(&xb, bb + l, 8);
                    uint64_t d = xa ^ xb;
                    if (d) { l += (uint32_t)(__builtin_ctzll(d) >> 3); break; }
                    l += 8;
                }
                while (l < lim && a[l] == bb[l]) l++;
                uint32_t dist = (uint32_t)(i - (size_t)c);
                int s, eb; uint32_t ev;
                run_sym(l, &s, &eb, &ev);
                freqs_ll[s]++;
                dist_sym(dist, &s, &eb, &ev);
                freqs_d[s]++;
                tok_run[ntok] = (uint16_t)l;
                tok_dist[ntok] = (uint16_t)(dist - 1);
                tok_lit[ntok] = 0;
                ntok++;
                /* keep the table warm without hashing the whole span */
                size_t p1 = i + (l >> 1), p2 = i + l - 2;
                if (p1 + 4 <= total) head[hash4(in + p1)] = (int32_t)p1;
                if (p2 + 4 <= total && p2 != p1) head[hash4(in + p2)] = (int32_t)p2;
                i += l;
                continue;
            }
        fast_lit:
            freqs_ll[in[i]]++;
            tok_run[ntok] = 0;
            tok_dist[ntok] = 0;
            tok_lit[ntok] = in[i];
            ntok++;
            i++;
        }
        goto tokens_done;
    }

    #define FIND(ipos, bestlen_out, bestdist_out) do { \
        uint32_t _bl = 0, _bd = 0; \
        if ((ipos) + 3 <= total) { \
            uint32_t _h = hash3(in + (ipos)); \
            int32_t _c = head[_h]; \
            int _chain = max_chain; \
            uint32_t _lim = total - (ipos) < 258 ? (uint32_t)(total - (ipos)) : 258; \
            const uint8_t *_a = in + (ipos); \
            while (_c >= 0 && _chain-- > 0) { \
                uint32_t _d = (uint32_t)((ipos) - _c); \
                if (_d > WIN) break; \
                const uint8_t *_b2 = in + _c; \
                /* one-byte pre-filter: once a decent match is held, a \
                 * candidate that can't extend past it loses on score \
                 * almost surely — skip it with a single load. */ \
                if (_bl >= 6 && _b2[_bl] != _a[_bl]) { _c = prevtab[_c]; continue; } \
                uint32_t _l = 0; \
                while (_l + 8 <= _lim) { \
                    uint64_t _xa, _xb; \
                    memcpy(&_xa, _a + _l, 8); \
                    memcpy(&_xb, _b2 + _l, 8); \
                    uint64_t _x = _xa ^ _xb; \
                    if (_x) { _l += (uint32_t)(__builtin_ctzll(_x) >> 3); break; } \
                    _l += 8; \
                } \
                while (_l < _lim && _a[_l] == _b2[_l]) _l++; \
                /* cost-aware: a longer match must pay for its extra \
                 * distance bits (dist extra ~ 2*(log2(d)-2); len gain is \
                 * ~8 bits/byte of literals saved). Score = 8*len - dbits. */ \
                uint32_t _db = _d <= 4 ? 0 : (uint32_t)(30 - __builtin_clz(_d - 1) - 2) * 2; \
                uint32_t _bdb = _bd <= 4 ? 0 : (uint32_t)(30 - __builtin_clz(_bd - 1) - 2) * 2; \
                int _sc = (int)(_l * 8) - (int)_db, _bsc = (int)(_bl * 8) - (int)_bdb; \
                if (_bl == 0 || _sc > _bsc || (_sc == _bsc && _d < _bd)) { _bl = _l; _bd = _d; } \
                if (_l >= _lim || _bl >= nice_len) break; \
                _c = prevtab[_c]; \
            } \
        } \
        bestlen_out = _bl; bestdist_out = _bd; \
    } while (0)

    #define INSERT(ipos) do { \
        if ((ipos) + 3 <= total) { \
            uint32_t _h = hash3(in + (ipos)); \
            prevtab[ipos] = head[_h]; \
            head[_h] = (int32_t)(ipos); \
        } \
    } while (0)

    size_t ins = 0;
    #define INS_UPTO(x) do { while (ins < (x) && ins < total) { INSERT(ins); ins++; } } while (0)

    uint32_t cur_len = 0, cur_dist = 0;
    INS_UPTO(hist_len);
    FIND(hist_len, cur_len, cur_dist);
    INS_UPTO(hist_len + 1);
    while (i < total) {
        uint32_t nl = 0, nd = 0;
        /* lazy evaluation pays only for middling matches: a match at
         * nice_len+ is taken immediately (zlib's max_lazy rule). */
        if (i + 1 < total && cur_len < nice_len) {
            INS_UPTO(i + 1);
            FIND(i + 1, nl, nd);
        }
        /* score-aware lazy: defer to the next position's match only when
         * its cost-adjusted gain beats the current match plus the literal
         * byte deferral forces out (~8 bits). Same scoring as FIND. */
        int cur_sc = (int)(cur_len * 8) -
                     (cur_dist <= 4 ? 0 : (int)(30 - __builtin_clz(cur_dist - 1) - 2) * 2);
        int nxt_sc = (int)(nl * 8) -
                     (nd <= 4 || nl == 0 ? 0 : (int)(30 - __builtin_clz(nd - 1) - 2) * 2);
        int take = cur_len >= 3 && !(cur_len == 3 && cur_dist > 4096) &&
                   cur_sc + 8 >= nxt_sc;
        if (take) {
            int s, eb; uint32_t ev;
            run_sym(cur_len, &s, &eb, &ev);
            freqs_ll[s]++;
            dist_sym(cur_dist, &s, &eb, &ev);
            freqs_d[s]++;
            tok_run[ntok] = (uint16_t)cur_len;
            tok_dist[ntok] = (uint16_t)(cur_dist - 1);
            tok_lit[ntok] = 0;
            ntok++;
            i += cur_len;
            if (i < total) {
                /* long matches (typically runs) skip interior inserts:
                 * the chain already holds the span's start, and hashing
                 * every covered position costs more than the sliver of
                 * ratio it buys. */
                if (cur_len >= nice_len && ins < i) ins = i > 2 ? i - 2 : ins;
                INS_UPTO(i);
                FIND(i, cur_len, cur_dist);
            } else cur_len = 0;
        } else {
            freqs_ll[in[i]]++;
            tok_run[ntok] = 0;
            tok_dist[ntok] = 0;
            tok_lit[ntok] = in[i];
            ntok++;
            i++;
            cur_len = nl; cur_dist = nd;
        }
    }
tokens_done:
    freqs_ll[256]++;

    /* --- code lengths + degenerate fixes (reference semantics) --- */
    int used_d = 0, last_d = -1;
    for (int k = 0; k < 30; k++)
        if (freqs_d[k]) { used_d++; last_d = k; }
    if (used_d == 1) {
        if (last_d + 1 < 30) freqs_d[last_d + 1] = 1;
        else freqs_d[last_d - 1] = 1;
    }
    int used_ll = 0;
    for (int k = 0; k < 288; k++) if (freqs_ll[k]) used_ll++;
    if (used_ll < 2) freqs_ll[0]++;

    static __thread uint8_t ll_lens[288], d_lens[30], clen_lens[19];
    static __thread uint16_t ll_codes[288], d_codes[30], clen_codes[19];
    huff_lengths(freqs_ll, 288, max_code_len, ll_lens);
    huff_lengths(freqs_d, 30, max_code_len, d_lens);
    canon_codes(ll_lens, 288, ll_codes);
    canon_codes(d_lens, 30, d_codes);

    int hlit = 288;
    while (hlit > 257 && ll_lens[hlit - 1] == 0) hlit--;
    int hdist = 30;
    while (hdist > 1 && d_lens[hdist - 1] == 0) hdist--;

    /* clen RLE (greedy, comp/Lz77Huffman.java:189-223 rules) */
    uint8_t all_lens[288 + 30];
    memcpy(all_lens, ll_lens, hlit);
    memcpy(all_lens + hlit, d_lens, hdist);
    int rle_total = hlit + hdist;
    static __thread uint8_t rle_sym[320];
    static __thread uint8_t rle_extra[320];
    int nrle = 0;
    uint32_t clen_freq[19];
    memset(clen_freq, 0, sizeof clen_freq);
    {
        int p = 0;
        while (p < rle_total) {
            int val = all_lens[p];
            if (val == 0) {
                int run = 1;
                while (run < 138 && p + run < rle_total && all_lens[p + run] == 0) run++;
                if (run < 3) { rle_sym[nrle] = 0; rle_extra[nrle++] = 0; clen_freq[0]++; p++; }
                else if (run < 11) { rle_sym[nrle] = 17; rle_extra[nrle++] = (uint8_t)(run - 3); clen_freq[17]++; p += run; }
                else { rle_sym[nrle] = 18; rle_extra[nrle++] = (uint8_t)(run - 11); clen_freq[18]++; p += run; }
                continue;
            }
            if (p > 0) {
                int run = 0;
                while (run < 6 && p + run < rle_total && all_lens[p + run] == all_lens[p - 1]) run++;
                if (run >= 3) { rle_sym[nrle] = 16; rle_extra[nrle++] = (uint8_t)(run - 3); clen_freq[16]++; p += run; continue; }
            }
            rle_sym[nrle] = (uint8_t)val; rle_extra[nrle++] = 0; clen_freq[val]++; p++;
        }
    }
    {
        int used_c = 0, first_c = 0;
        for (int k = 0; k < 19; k++) if (clen_freq[k]) { used_c++; first_c = k; }
        if (used_c < 2) clen_freq[(first_c + 1) % 19]++;
    }
    huff_lengths(clen_freq, 19, 7, clen_lens);
    canon_codes(clen_lens, 19, clen_codes);
    int hclen = 19;
    while (hclen > 4 && clen_lens[CLEN_ORDER[hclen - 1]] == 0) hclen--;

    /* --- emit dynamic block --- */
    BitOut o;
    bo_init(&o, out, out_cap);
    if (start_bit) {
        out[0] = 0;
        o.reg = seed_byte & ((1u << start_bit) - 1);
        o.reg_bits = start_bit;
    }
    bo_write(&o, final ? 1 : 0, 1);
    bo_write(&o, 2, 2); /* dynamic */
    bo_write(&o, (uint32_t)(hlit - 257), 5);
    bo_write(&o, (uint32_t)(hdist - 1), 5);
    bo_write(&o, (uint32_t)(hclen - 4), 4);
    for (int k = 0; k < hclen; k++) bo_write(&o, clen_lens[CLEN_ORDER[k]], 3);
    for (int k = 0; k < nrle; k++) {
        int s = rle_sym[k];
        bo_write(&o, clen_codes[s], clen_lens[s]);
        if (s == 16) bo_write(&o, rle_extra[k], 2);
        else if (s == 17) bo_write(&o, rle_extra[k], 3);
        else if (s == 18) bo_write(&o, rle_extra[k], 7);
    }
    for (int k = 0; k < ntok && !o.overflow; k++) {
        if (tok_run[k] == 0) {
            int s2 = tok_lit[k];
            bo_write(&o, ll_codes[s2], ll_lens[s2]);
        } else {
            int s2, eb; uint32_t ev;
            run_sym(tok_run[k], &s2, &eb, &ev);
            bo_write(&o, ll_codes[s2], ll_lens[s2]);
            if (eb) bo_write(&o, ev, eb);
            dist_sym((uint32_t)tok_dist[k] + 1, &s2, &eb, &ev);
            bo_write(&o, d_codes[s2], d_lens[s2]);
            if (eb) bo_write(&o, ev, eb);
        }
    }
    bo_write(&o, ll_codes[256], ll_lens[256]);
    size_t dyn_bits = (size_t)o.pos * 8 + (size_t)o.reg_bits;
    bo_finish(&o);

    /* stored fallback: header(3) + pad-to-byte + (5-byte hdr + data)/block */
    size_t stored_bits;
    {
        size_t blocks = n ? (n + 65534) / 65535 : 1;
        size_t pad = (8 - ((start_bit + 3) & 7)) & 7;
        /* first block: 3-bit header + pad + 32-bit len/nlen; each later
           block starts byte-aligned: 3 + 5 pad + 32 = 40 bits */
        stored_bits = (size_t)start_bit + 3 + pad + 32 + n * 8 + (blocks - 1) * 40;
    }
    if (o.overflow || dyn_bits >= stored_bits) {
        if ((stored_bits + 7) / 8 > out_cap) return 0;
        BitOut so;
        bo_init(&so, out, out_cap);
        if (start_bit) {
            out[0] = 0;
            so.reg = seed_byte & ((1u << start_bit) - 1);
            so.reg_bits = start_bit;
        }
        size_t ip = 0;
        do {
            size_t blk = n - ip > 65535 ? 65535 : n - ip;
            int fin = final && (ip + blk == n);
            bo_write(&so, (uint32_t)(fin ? 1 : 0), 1);
            bo_write(&so, 0, 2);
            int pad = (int)((8 - (((size_t)so.pos * 8 + so.reg_bits) & 7)) & 7);
            if (pad) bo_write(&so, 0, pad);
            bo_write(&so, (uint32_t)(blk & 0xFFFF), 16);
            bo_write(&so, (uint32_t)(~blk & 0xFFFF), 16);
            for (size_t k2 = 0; k2 < blk; k2++) bo_write(&so, in[hist_len + ip + k2], 8);
            ip += blk;
        } while (ip < n);
        size_t sbits = (size_t)so.pos * 8 + (size_t)so.reg_bits;
        bo_finish(&so);
        if (so.overflow) return 0;
        return sbits;
    }
    return dyn_bits;
}

/* ================================================================== */
/* Parallel foreign-stream decode (rapidgzip-style resync prepass)     */
/*                                                                     */
/* Any real-world .gz has unmarked, non-byte-aligned block boundaries  */
/* (decomp/Open.java:83-110 walks them serially). Parallel decode:     */
/*   1. td_find_sync: scan a byte range for a bit offset where a       */
/*      dynamic block header parses + a trial decode survives — a      */
/*      speculative candidate boundary (cheap 17-bit prefilter, then   */
/*      counts-only Kraft checks, big LUTs only for finalists).        */
/*   2. td_inflate_marker: decode a segment from a candidate in        */
/*      *marker* space: u16 output where 0..255 are literal bytes and  */
/*      256+r means "window byte r before segment start" — back-refs   */
/*      into the unknown 32 KiB pre-segment window propagate through   */
/*      copies unresolved (the two-pass LZ77 of SURVEY.md §2.1).       */
/*   3. The host driver chains segments: a segment is adopted iff the  */
/*      serial block walk lands exactly on its start bit (handover     */
/*      validation => bit-exactness regardless of probe quality).      */
/*   4. td_resolve_markers: substitute markers against the resolved    */
/*      window of the adopted prefix.                                  */
/* ================================================================== */

static void bi_init_at(BitIn *b, const uint8_t *in, size_t n, int64_t bit) {
    bi_init(b, in, n);
    b->pos = (size_t)(bit >> 3);
    int rem = (int)(bit & 7);
    if (rem) {
        bi_fill(b);
        b->reg >>= rem;
        b->reg_bits -= rem;
    }
}

static int64_t bi_bitpos(const BitIn *b) {
    return (int64_t)b->pos * 8 - b->reg_bits;
}

/* Parse a dynamic-block header into caller LUTs (mirrors td_inflate's
 * inline parse; same validation order). b is positioned after the 3-bit
 * block header. */
static int parse_dyn_to_luts(BitIn *b, Lut *ll_lut, Lut *d_lut,
                             const Lut **ll, const Lut **dd, int *dist_empty) {
    int err;
    uint32_t v, hlit, hdist, hclen;
    if ((err = bi_read(b, 5, &hlit))) return err;
    if ((err = bi_read(b, 5, &hdist))) return err;
    if ((err = bi_read(b, 4, &hclen))) return err;
    int nlit = (int)hlit + 257, ndist = (int)hdist + 1, nclen = (int)hclen + 4;
    uint8_t clen_lens[19];
    memset(clen_lens, 0, sizeof clen_lens);
    for (int i = 0; i < nclen; i++) {
        if ((err = bi_read(b, 3, &v))) return err;
        clen_lens[CLEN_ORDER[i]] = (uint8_t)v;
    }
    static __thread Lut clen_lut;
    if ((err = build_lut(clen_lens, 19, &clen_lut))) return err;

    uint8_t lens[288 + 32];
    int total = nlit + ndist;
    int i = 0, prev = -1;
    while (i < total) {
        int s;
        if ((err = decode_sym(b, &clen_lut, &s))) return err;
        if (s < 16) {
            lens[i++] = (uint8_t)s;
            prev = s;
        } else {
            int run, val;
            if (s == 16) {
                if (prev < 0) return TD_E_NO_PREV_CODE_LEN;
                if ((err = bi_read(b, 2, &v))) return err;
                run = 3 + (int)v; val = prev;
            } else if (s == 17) {
                if ((err = bi_read(b, 3, &v))) return err;
                run = 3 + (int)v; val = 0; prev = 0;
            } else {
                if ((err = bi_read(b, 7, &v))) return err;
                run = 11 + (int)v; val = 0; prev = 0;
            }
            if (i + run > total) return TD_E_CLEN_OVER_FULL;
            while (run--) lens[i++] = (uint8_t)val;
        }
    }
    if (lens[256] == 0) return TD_E_EOB_ZERO_LEN;
    uint8_t ll_lens[288];
    memset(ll_lens, 0, sizeof ll_lens);
    memcpy(ll_lens, lens, nlit);
    if ((err = build_lut(ll_lens, 288, ll_lut))) return err;
    *ll = ll_lut;

    uint8_t d_lens[32];
    memset(d_lens, 0, sizeof d_lens);
    memcpy(d_lens, lens + nlit, ndist);
    *dist_empty = 0;
    if (ndist == 1 && d_lens[0] == 0) {
        *dist_empty = 1;
        *dd = NULL;
    } else {
        int ones = 0, others = 0;
        for (int k = 0; k < 32; k++) {
            if (d_lens[k] == 1) ones++;
            else if (d_lens[k] > 1) others++;
        }
        if (ones == 1 && others == 0) d_lens[31] = 1; /* dummy: Open.java:421-425 */
        if ((err = build_lut(d_lens, 32, d_lut))) return err;
        *dd = d_lut;
    }
    return TD_OK;
}

static void get_fixed_luts(const Lut **ll, const Lut **dd) {
    static __thread Lut fixed_ll, fixed_d;
    static __thread int init = 0;
    if (!init) {
        uint8_t lens[288];
        for (int i = 0; i < 144; i++) lens[i] = 8;
        for (int i = 144; i < 256; i++) lens[i] = 9;
        for (int i = 256; i < 280; i++) lens[i] = 7;
        for (int i = 280; i < 288; i++) lens[i] = 8;
        build_lut(lens, 288, &fixed_ll);
        uint8_t dl[32];
        for (int i = 0; i < 32; i++) dl[i] = 5;
        build_lut(dl, 32, &fixed_d);
        init = 1;
    }
    *ll = &fixed_ll;
    *dd = &fixed_d;
}

/* --- find_sync ----------------------------------------------------- */

/* 17-bit prefilter bitmap: bfinal=0, btype=2 (dynamic), hlit<=29,
 * hdist<=29. One bit per pattern, 16 KiB, L1-resident. */
static __thread uint8_t sync_tab[1 << 14];
static __thread int sync_tab_init = 0;

static void sync_tab_build(void) {
    memset(sync_tab, 0, sizeof sync_tab);
    for (uint32_t w = 0; w < (1u << 17); w++) {
        if ((w & 1) != 0) continue;            /* bfinal must be 0 */
        if (((w >> 1) & 3) != 2) continue;     /* btype dynamic */
        if (((w >> 3) & 31) > 29) continue;    /* hlit <= 29 */
        if (((w >> 8) & 31) > 29) continue;    /* hdist <= 29 */
        sync_tab[w >> 3] |= (uint8_t)(1u << (w & 7));
    }
    sync_tab_init = 1;
}

/* Counts-only Kraft completeness (exactly full), no LUT fill. */
static int kraft_exact(const int counts[16], int total, int max_len) {
    if (total < 2) return 0;
    long open_slots = 2, remaining = total;
    for (int l = 1; l <= max_len; l++) {
        if (counts[l] > open_slots) return 0;
        open_slots -= counts[l];
        remaining -= counts[l];
        if (remaining == 0) break;
        open_slots *= 2;
        if (open_slots > (1 << 20)) open_slots = 1 << 20; /* clamp */
    }
    return open_slots == 0 || remaining == 0 ? (open_slots == 0) : 0;
}

/* Cheap header validation without big-LUT fills. Returns TD_OK if the
 * dynamic header fully parses with exactly-full clen/litlen/dist codes.
 * b positioned after the 3-bit block header. */
static int probe_dyn_header(BitIn *b) {
    int err;
    uint32_t v, hlit, hdist, hclen;
    if ((err = bi_read(b, 5, &hlit))) return err;
    if ((err = bi_read(b, 5, &hdist))) return err;
    if ((err = bi_read(b, 4, &hclen))) return err;
    int nlit = (int)hlit + 257, ndist = (int)hdist + 1, nclen = (int)hclen + 4;
    if (nlit > 286 || ndist > 30) return TD_E_RESERVED_LEN_SYM; /* heuristic */
    uint8_t clen_lens[19];
    memset(clen_lens, 0, sizeof clen_lens);
    int counts7[16] = {0};
    int total7 = 0;
    for (int i = 0; i < nclen; i++) {
        if ((err = bi_read(b, 3, &v))) return err;
        clen_lens[CLEN_ORDER[i]] = (uint8_t)v;
        if (v) { counts7[v]++; total7++; }
    }
    if (!kraft_exact(counts7, total7, 7)) return TD_E_OVER_FULL;
    /* tiny 7-bit clen decode table */
    uint8_t tsym[128], tlen[128];
    memset(tlen, 0, sizeof tlen);
    {
        int next_code[8], code = 0;
        int cnt[8] = {0};
        for (int s = 0; s < 19; s++) if (clen_lens[s]) cnt[clen_lens[s]]++;
        for (int l = 1; l <= 7; l++) { code = (code + cnt[l - 1]) << 1; next_code[l] = code; }
        for (int s = 0; s < 19; s++) {
            int l = clen_lens[s];
            if (!l) continue;
            int c = next_code[l]++;
            int rev = 0;
            for (int k = 0; k < l; k++) rev |= ((c >> k) & 1) << (l - 1 - k);
            for (int idx = rev; idx < 128; idx += (1 << l)) { tsym[idx] = (uint8_t)s; tlen[idx] = (uint8_t)l; }
        }
    }
    int total = nlit + ndist;
    int i = 0, prev = -1;
    int counts15_ll[16] = {0}, total_ll = 0;
    int counts15_d[16] = {0}, total_d = 0, d_nonzero = 0;
    uint8_t eob_len = 0;
    while (i < total) {
        if (b->reg_bits < 7) bi_fill(b);
        int l = tlen[b->reg & 127];
        if (l == 0 || l > b->reg_bits) return TD_E_UNEXPECTED_END;
        int s = tsym[b->reg & 127];
        b->reg >>= l; b->reg_bits -= l;
        int run, val;
        if (s < 16) { run = 1; val = s; prev = s; }
        else if (s == 16) {
            if (prev < 0) return TD_E_NO_PREV_CODE_LEN;
            if ((err = bi_read(b, 2, &v))) return err;
            run = 3 + (int)v; val = prev;
        } else if (s == 17) {
            if ((err = bi_read(b, 3, &v))) return err;
            run = 3 + (int)v; val = 0; prev = 0;
        } else {
            if ((err = bi_read(b, 7, &v))) return err;
            run = 11 + (int)v; val = 0; prev = 0;
        }
        if (i + run > total) return TD_E_CLEN_OVER_FULL;
        while (run--) {
            if (val) {
                if (i == 256) eob_len = (uint8_t)val;
                if (i < nlit) { counts15_ll[val]++; total_ll++; }
                else { counts15_d[val]++; total_d++; d_nonzero++; }
            }
            i++;
        }
    }
    if (nlit > 256 && eob_len == 0) return TD_E_EOB_ZERO_LEN;
    if (!kraft_exact(counts15_ll, total_ll, 15)) return TD_E_OVER_FULL;
    if (d_nonzero == 0) return TD_OK;              /* empty dist code: legal */
    if (d_nonzero == 1 && counts15_d[1] == 1) return TD_OK; /* one 1-bit code */
    if (!kraft_exact(counts15_d, total_d, 15)) return TD_E_OVER_FULL;
    return TD_OK;
}

/* Trial decode (count-only, no output) of up to min_syms symbols. */
static int trial_decode(BitIn *b, const Lut *ll, const Lut *dd, int dist_empty,
                        int min_syms) {
    int err;
    uint32_t v;
    int64_t op = 0;
    for (int k = 0; k < min_syms; k++) {
        int sym;
        if ((err = decode_sym(b, ll, &sym))) return err;
        if (sym < 256) { op++; continue; }
        if (sym == 256) return TD_OK; /* clean EOB */
        if (sym > 285) return TD_E_RESERVED_LEN_SYM;
        if ((err = bi_read(b, LEN_EXTRA[sym - 257], &v))) return err;
        uint32_t run = LEN_BASE[sym - 257] + v;
        if (dist_empty) return TD_E_EMPTY_DIST_CODE;
        int dsym;
        if ((err = decode_sym(b, dd, &dsym))) return err;
        if (dsym > 29) return TD_E_RESERVED_DIST_SYM;
        if ((err = bi_read(b, DIST_EXTRA[dsym], &v))) return err;
        uint32_t dist = DIST_BASE[dsym] + v;
        if ((int64_t)dist > op + 32768) return TD_E_BEFORE_START;
        op += run;
    }
    return TD_OK;
}

/* Scan [from_bit, limit_bit) for the first plausible dynamic-block
 * start; returns the bit offset or -1. */
int64_t td_find_sync(const uint8_t *in, size_t in_len, int64_t from_bit,
                     int64_t limit_bit, int min_syms) {
    if (!sync_tab_init) sync_tab_build();
    int64_t max_bit = (int64_t)in_len * 8;
    if (limit_bit > max_bit) limit_bit = max_bit;
    static __thread Lut ll_lut, d_lut;
    for (int64_t bit = from_bit; bit < limit_bit; bit++) {
        size_t byte = (size_t)(bit >> 3);
        if (byte + 8 > in_len) break;
        uint64_t w;
        memcpy(&w, in + byte, 8);
        uint32_t w17 = (uint32_t)((w >> (bit & 7)) & 0x1FFFF);
        if (!(sync_tab[w17 >> 3] & (1u << (w17 & 7)))) continue;
        BitIn b;
        bi_init_at(&b, in, in_len, bit + 3); /* skip bfinal+btype */
        if (probe_dyn_header(&b) != TD_OK) continue;
        /* finalists: full parse + trial decode */
        bi_init_at(&b, in, in_len, bit + 3);
        const Lut *ll, *dd;
        int dist_empty;
        if (parse_dyn_to_luts(&b, &ll_lut, &d_lut, &ll, &dd, &dist_empty) != TD_OK)
            continue;
        if (trial_decode(&b, ll, dd, dist_empty, min_syms) != TD_OK) continue;
        return bit;
    }
    return -1;
}

/* --- marker-mode segment decode ------------------------------------ */

/* Decode blocks from start_bit until the first block boundary at or
 * past stop_bit, or the final block, in marker space (u16: 0..255
 * literal, 256+r = window byte r before segment start, r in [1,32768]).
 * window_allow: how far back-refs may reach before the segment start
 * (0 for the true stream head, 32768 for speculative segments).
 * Returns TD_OK / error; *end_bit = cursor at return (block boundary on
 * success), *hit_final = decoded the bfinal block. */
int td_inflate_marker(const uint8_t *in, size_t in_len, int64_t start_bit,
                      int64_t stop_bit, int64_t window_allow, uint16_t *out,
                      size_t out_cap, size_t *out_len, int64_t *end_bit,
                      int *hit_final) {
    static __thread Lut ll_lut, d_lut;
    BitIn b;
    bi_init_at(&b, in, in_len, start_bit);
    size_t op = 0;
    int err = TD_OK;
    uint32_t v;
    *hit_final = 0;
    for (;;) {
        int64_t boundary = bi_bitpos(&b);
        if (*hit_final || boundary >= stop_bit) {
            *end_bit = boundary;
            *out_len = op;
            return TD_OK;
        }
        if ((err = bi_read(&b, 1, &v))) goto fail;
        int last = (int)v;
        if ((err = bi_read(&b, 2, &v))) goto fail;
        int btype = (int)v;
        if (btype == 3) { err = TD_E_RESERVED_BLOCK_TYPE; goto fail; }

        if (btype == 0) {
            bi_align(&b);
            uint32_t len, nlen;
            if ((err = bi_read(&b, 16, &len))) goto fail;
            if ((err = bi_read(&b, 16, &nlen))) goto fail;
            if (len != (nlen ^ 0xFFFFu)) { err = TD_E_LEN_MISMATCH; goto fail; }
            if (op + len > out_cap) { err = TD_E_OUTPUT_OVERFLOW; goto fail; }
            uint32_t remaining = len;
            while (remaining && b.reg_bits >= 8) {
                out[op++] = (uint16_t)(b.reg & 0xFF);
                b.reg >>= 8; b.reg_bits -= 8; remaining--;
            }
            if (remaining) {
                if (b.pos + remaining > b.in_len) { err = TD_E_UNEXPECTED_END; goto fail; }
                for (uint32_t k = 0; k < remaining; k++) out[op + k] = b.in[b.pos + k];
                op += remaining;
                b.pos += remaining;
                /* pos jumped: drop stale bulk-refill bits (see td_inflate) */
                b.reg &= (1ull << b.reg_bits) - 1;
            }
            *hit_final = last;
            continue;
        }

        const Lut *ll, *dd;
        int dist_empty = 0;
        if (btype == 1) {
            get_fixed_luts(&ll, &dd);
        } else {
            if ((err = parse_dyn_to_luts(&b, &ll_lut, &d_lut, &ll, &dd, &dist_empty)))
                goto fail;
        }
        for (;;) {
            int sym;
            if ((err = decode_sym(&b, ll, &sym))) goto fail;
            if (sym < 256) {
                if (op >= out_cap) { err = TD_E_OUTPUT_OVERFLOW; goto fail; }
                out[op++] = (uint16_t)sym;
                continue;
            }
            if (sym == 256) break;
            if (sym > 285) { err = TD_E_RESERVED_LEN_SYM; goto fail; }
            if ((err = bi_read(&b, LEN_EXTRA[sym - 257], &v))) goto fail;
            uint32_t run = LEN_BASE[sym - 257] + v;
            if (dist_empty) { err = TD_E_EMPTY_DIST_CODE; goto fail; }
            int dsym;
            if ((err = decode_sym(&b, dd, &dsym))) goto fail;
            if (dsym > 29) { err = TD_E_RESERVED_DIST_SYM; goto fail; }
            if ((err = bi_read(&b, DIST_EXTRA[dsym], &v))) goto fail;
            uint32_t dist = DIST_BASE[dsym] + v;
            if ((int64_t)dist > (int64_t)op + window_allow) { err = TD_E_BEFORE_START; goto fail; }
            if (op + run > out_cap) { err = TD_E_OUTPUT_OVERFLOW; goto fail; }
            if (op >= dist) {
                /* whole copy stays in-segment: plain LZ77 move (the
                 * common case everywhere past the first 32 KiB) */
                if (dist >= run) {
                    memcpy(out + op, out + op - dist, (size_t)run * 2);
                } else {
                    const uint16_t *src = out + op - dist;
                    uint16_t *dst = out + op;
                    for (uint32_t k = 0; k < run; k++) dst[k] = src[k];
                }
                op += run;
            } else {
                for (uint32_t k = 0; k < run; k++) {
                    int64_t s = (int64_t)op - dist;
                    /* rel = -s in [1, 32768]; marker m = 255 + rel
                     * (resolve inverts as rel = m - 255) */
                    out[op] = s >= 0 ? out[s] : (uint16_t)(255 + (uint32_t)(-s));
                    op++;
                }
            }
        }
        *hit_final = last;
    }
fail:
    *end_bit = bi_bitpos(&b);
    *out_len = op;
    return err;
}

/* Substitute markers against the resolved pre-segment window.
 * win holds win_len bytes immediately before the segment. */
int td_resolve_markers(const uint16_t *seg, size_t n, const uint8_t *win,
                       size_t win_len, uint8_t *out) {
    for (size_t i = 0; i < n; i++) {
        uint16_t m = seg[i];
        if (m < 256) {
            out[i] = (uint8_t)m;
        } else {
            uint32_t rel = (uint32_t)m - 255; /* 1..32768 */
            if (rel > win_len) return TD_E_BEFORE_START;
            out[i] = win[win_len - rel];
        }
    }
    return TD_OK;
}

/* ------------------------------------------------------------------ */
/* Reference-semantics oracle tokenizer                                */
/* ------------------------------------------------------------------ */

/* Serial greedy LZ77 with an exhaustive distance scan — the exact match
 * semantics of the reference encoder (≙ comp/Lz77Huffman.java:68-130):
 * all distances in [min_dist, min(max_dist, i)] examined ascending, best
 * run wins with smallest-distance tie-break (strict > while ascending),
 * overlapping matches via wraparound, greedy commit, literal iff
 * best_run < min_run. Used only as the ratio-measurement oracle (the
 * production encoders use hash chains); O(n * max_dist) by design.
 *
 * buf[0..hist_len) is history; tokens cover buf[hist_len..n).
 * Outputs: tok_pos (relative to hist_len), tok_run (0 = literal),
 * tok_dist. Returns the token count (<= n - hist_len).
 */
size_t td_oracle_tokenize(const uint8_t *buf, size_t n, size_t hist_len,
                          uint32_t min_run, uint32_t max_run,
                          uint32_t min_dist, uint32_t max_dist,
                          int32_t *tok_pos, int32_t *tok_run,
                          int32_t *tok_dist) {
    size_t ntok = 0;
    size_t i = hist_len;
    while (i < n) {
        uint32_t best_run = 0, best_dist = 0;
        if (min_run > 0) {
            size_t dmax = i < (size_t)max_dist ? i : (size_t)max_dist;
            for (size_t dist = min_dist; dist <= dmax; dist++) {
                size_t h = i - dist;
                uint32_t run = 0;
                while (run < max_run && i + run < n && buf[h] == buf[i + run]) {
                    run++;
                    h++;
                    if (h == i) h -= dist; /* overlap wraparound */
                }
                if (run > best_run) {
                    best_run = run;
                    best_dist = (uint32_t)dist;
                    if (run >= max_run) break; /* no longer match possible */
                }
            }
        }
        tok_pos[ntok] = (int32_t)(i - hist_len);
        if (min_run > 0 && best_run >= min_run) {
            tok_run[ntok] = (int32_t)best_run;
            tok_dist[ntok] = (int32_t)best_dist;
            i += best_run;
        } else {
            tok_run[ntok] = 0;
            tok_dist[ntok] = 0;
            i += 1;
        }
        ntok++;
    }
    return ntok;
}

/* ------------------------------------------------------------------ */
/* Member-parallel inflate: pthread work queue over independent gzip  */
/* members (the DP seam of the TD stream profile, ≙ SURVEY.md §2.1).  */
/* Each worker decodes straight into the shared output buffer at the  */
/* member's precomputed offset and verifies its CRC-32, so the driver */
/* makes ONE foreign call for the whole stream: no per-member Python  */
/* slices, buffer allocs, or GIL round-trips.                         */
/* ------------------------------------------------------------------ */

#include <pthread.h>
#include <stdlib.h>

typedef struct {
    const uint8_t *data;      /* whole gzip stream */
    const uint64_t *pay_off;  /* per member: payload byte offset */
    const uint64_t *pay_len;  /* per member: payload byte length */
    const uint64_t *out_off;  /* per member: output offset; [n] = total */
    const uint32_t *want_crc; /* per member: trailer CRC-32 */
    uint8_t *out;
    long n;
    long next;                /* atomic work index */
    uint8_t *err;             /* per member: 0 ok, else Reason+1 */
} MemberJob;

static void *member_worker(void *arg) {
    MemberJob *j = (MemberJob *)arg;
    for (;;) {
        long i = __sync_fetch_and_add(&j->next, 1);
        if (i >= j->n) break;
        size_t cap = (size_t)(j->out_off[i + 1] - j->out_off[i]);
        uint8_t *dst = j->out + j->out_off[i];
        size_t out_len = 0, consumed = 0;
        int rc = td_inflate(j->data + j->pay_off[i], (size_t)j->pay_len[i],
                            dst, cap, &out_len, &consumed);
        if (rc == TD_E_OUTPUT_OVERFLOW || (rc == TD_OK && out_len != cap))
            rc = 16; /* DECOMPRESSED_SIZE_MISMATCH + 1 */
        else if (rc == TD_OK && td_crc32(dst, cap, 0) != j->want_crc[i])
            rc = 15; /* DECOMPRESSED_CHECKSUM_MISMATCH + 1 */
        j->err[i] = (uint8_t)rc;
    }
    return NULL;
}

/* Decode n gzip members concurrently. Offsets come from the TD index
 * (out_off = exclusive prefix sum of trailer ISIZEs, n+1 entries).
 * Returns 0 on success; otherwise the Reason+1 code of the FIRST
 * failing member in stream order (reference error-precedence:
 * /root/reference/src/io/nayuki/deflate/decomp/Open.java:516-593),
 * with *err_member set to its index. */
int td_inflate_members(const uint8_t *data, const uint64_t *pay_off,
                       const uint64_t *pay_len, const uint64_t *out_off,
                       const uint32_t *want_crc, uint8_t *out, long n,
                       int n_threads, long *err_member) {
    uint8_t err_small[256];
    uint8_t *err = err_small;
    static __thread uint8_t *err_heap = NULL;
    static __thread long err_heap_cap = 0;
    if (n > 256) {
        if (n > err_heap_cap) {
            free(err_heap);
            err_heap = (uint8_t *)malloc((size_t)n);
            err_heap_cap = err_heap ? n : 0;
            if (!err_heap) return 16;
        }
        err = err_heap;
    }
    memset(err, 0, (size_t)n);
    MemberJob job = {data, pay_off, pay_len, out_off, want_crc, out, n, 0, err};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = (int)n;
    if (n_threads > 64) n_threads = 64;
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++)
        if (pthread_create(&tids[t], NULL, member_worker, &job) == 0) spawned++;
    member_worker(&job); /* caller thread works too */
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    for (long i = 0; i < n; i++) {
        if (err[i]) {
            if (err_member) *err_member = i;
            return (int)err[i];
        }
    }
    return TD_OK;
}

/* Scan a TD-profile gzip stream (fixed header + FEXTRA 'TD' subfield =
 * u32 total member length) into per-member offset arrays — the O(members)
 * index walk of tpu_deflate/codec/decode_jax.py::split_members, done in C
 * so a 48 MiB stream indexes in microseconds. isize_out/crc_out read the
 * member trailers. Returns the member count, -1 if any member lacks the
 * TD subfield (caller falls back to the generic path), or -2 when cap is
 * too small (caller grows the arrays and retries). */
long td_split_members(const uint8_t *buf, size_t n, uint64_t *pay_off,
                      uint64_t *pay_len, uint64_t *isize_out, uint32_t *crc_out,
                      long cap) {
    size_t pos = 0;
    long cnt = 0;
    while (pos < n) {
        if (pos + 10 > n || buf[pos] != 0x1F || buf[pos + 1] != 0x8B) return -1;
        unsigned flags = buf[pos + 3];
        if (!(flags & 0x04)) return -1;
        size_t p = pos + 10;
        if (p + 2 > n) return -1;
        size_t xlen = buf[p] | ((size_t)buf[p + 1] << 8);
        if (p + 2 + xlen > n) return -1;
        const uint8_t *extra = buf + p + 2;
        p += 2 + xlen;
        int64_t member_len = -1;
        size_t q = 0;
        while (q + 4 <= xlen) {
            size_t slen = extra[q + 2] | ((size_t)extra[q + 3] << 8);
            if (extra[q] == 'T' && extra[q + 1] == 'D' && slen == 4 && q + 8 <= xlen)
                member_len = extra[q + 4] | ((uint32_t)extra[q + 5] << 8) |
                             ((uint32_t)extra[q + 6] << 16) |
                             ((int64_t)extra[q + 7] << 24);
            q += 4 + slen;
        }
        if (member_len < 0) return -1;
        if (flags & 0x08) { while (p < n && buf[p]) p++; p++; } /* FNAME */
        if (flags & 0x10) { while (p < n && buf[p]) p++; p++; } /* FCOMMENT */
        if (flags & 0x02) p += 2;                               /* FHCRC */
        size_t end = pos + (size_t)member_len;
        if (end > n || end < pos + 8 || end - 8 < p) return -1;
        if (cnt >= cap) return -2;
        pay_off[cnt] = p;
        pay_len[cnt] = end - 8 - p;
        crc_out[cnt] = buf[end - 8] | ((uint32_t)buf[end - 7] << 8) |
                       ((uint32_t)buf[end - 6] << 16) | ((uint32_t)buf[end - 5] << 24);
        isize_out[cnt] = buf[end - 4] | ((uint32_t)buf[end - 3] << 8) |
                         ((uint32_t)buf[end - 2] << 16) | ((uint32_t)buf[end - 1] << 24);
        cnt++;
        pos = end;
    }
    return cnt;
}

/* ------------------------------------------------------------------ */
/* Member-parallel deflate: encode fixed-size chunks as independent   */
/* TD-profile gzip members on a pthread work queue. Workers encode    */
/* into a reusable per-thread slot (warm pages), then commit to the   */
/* shared output IN MEMBER ORDER (spin on a committed counter), so    */
/* the result is deterministic and needs no giant scratch buffer.     */
/* ------------------------------------------------------------------ */

#include <sched.h>

#define MEMBER_HDR 20 /* 10-byte gzip header + XLEN + 'TD' u32 subfield */

typedef struct {
    const uint8_t *data;
    size_t n;
    size_t member_data;
    int max_code_len, max_chain;
    uint8_t *out;
    size_t out_cap;
    long nm;
    long next;       /* atomic: next member to encode */
    long committed;  /* members fully written to out */
    size_t out_pos;  /* write cursor (owned by the committing thread) */
    int failed;
} EncJob;

static void enc_frame(uint8_t *slot, const uint8_t *src, size_t len, size_t pay) {
    static const uint8_t HDR10[10] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff};
    uint32_t total = (uint32_t)(MEMBER_HDR + pay + 8);
    memcpy(slot, HDR10, 10);
    slot[10] = 8; slot[11] = 0;                  /* XLEN */
    slot[12] = 'T'; slot[13] = 'D';
    slot[14] = 4; slot[15] = 0;                  /* subfield len */
    slot[16] = (uint8_t)total; slot[17] = (uint8_t)(total >> 8);
    slot[18] = (uint8_t)(total >> 16); slot[19] = (uint8_t)(total >> 24);
    uint32_t crc = td_crc32(src, len, 0);
    uint8_t *tr = slot + MEMBER_HDR + pay;
    tr[0] = (uint8_t)crc; tr[1] = (uint8_t)(crc >> 8);
    tr[2] = (uint8_t)(crc >> 16); tr[3] = (uint8_t)(crc >> 24);
    uint32_t is = (uint32_t)len;
    tr[4] = (uint8_t)is; tr[5] = (uint8_t)(is >> 8);
    tr[6] = (uint8_t)(is >> 16); tr[7] = (uint8_t)(is >> 24);
}

static void *enc_worker(void *arg) {
    EncJob *j = (EncJob *)arg;
    size_t slot_cap = MEMBER_HDR + j->member_data + j->member_data / 8 + 1024 + 8;
    uint8_t *slot = (uint8_t *)malloc(slot_cap);
    if (!slot) { j->failed = 1; return NULL; }
    for (;;) {
        long i = __sync_fetch_and_add(&j->next, 1);
        if (i >= j->nm || j->failed) break;
        size_t start = (size_t)i * j->member_data;
        size_t len = j->n - start;
        if (len > j->member_data) len = j->member_data;
        size_t pay = td_deflate_member(j->data + start, len, slot + MEMBER_HDR,
                                       slot_cap - MEMBER_HDR - 8,
                                       j->max_code_len, j->max_chain);
        if (pay == 0 && len > 0) { j->failed = 1; break; }
        enc_frame(slot, j->data + start, len, pay);
        size_t total = MEMBER_HDR + pay + 8;
        while (__sync_fetch_and_add(&j->committed, 0) != i) {
            if (j->failed) goto done;
            sched_yield();
        }
        if (j->out_pos + total > j->out_cap) { j->failed = 1; break; }
        memcpy(j->out + j->out_pos, slot, total);
        j->out_pos += total;
        __sync_fetch_and_add(&j->committed, 1);
    }
done:
    free(slot);
    return NULL;
}

/* Encode n bytes as ceil(n/member_data) TD-profile gzip members in
 * parallel. Returns total output size, or 0 on failure. */
size_t td_deflate_members(const uint8_t *data, size_t n, size_t member_data,
                          int max_code_len, int max_chain, int n_threads,
                          uint8_t *out, size_t out_cap) {
    if (n == 0 || member_data == 0) return 0;
    EncJob job = {data, n, member_data, max_code_len, max_chain,
                  out, out_cap, 0, 0, 0, 0, 0};
    job.nm = (long)((n + member_data - 1) / member_data);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > job.nm) n_threads = (int)job.nm;
    if (n_threads > 64) n_threads = 64;
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++)
        if (pthread_create(&tids[t], NULL, enc_worker, &job) == 0) spawned++;
    enc_worker(&job);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    if (job.failed || job.committed != job.nm) return 0;
    return job.out_pos;
}
