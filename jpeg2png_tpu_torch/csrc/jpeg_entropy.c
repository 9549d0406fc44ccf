/* The port's JPEG entropy decoder: one scan, Huffman- or arithmetic-
 * coded, into the quantized DCT coefficient planes.  Plain C11 host code,
 * no CUDA and no Python or PyTorch headers; built with the C compiler at
 * first use (kernels/_build.py) and called through ctypes, which releases
 * the interpreter lock for the call, so reader threads overlap.
 *
 * Replaces the entropy decode that the JAX package leaves to libjpeg
 * (jpeg2png_tpu/native/jpegio.c, jpeg_read_coefficients).  Marker parsing
 * stays in Python (io/jpeg_reader.py); it calls j2p_decode_scan once per
 * SOS with the scan's components, tables and parameters.
 *
 * Scans: sequential (Ss=0, Se=63, Ah=Al=0) and the four progressive kinds
 * of ITU T.81 G.1.2 (DC first with point transform Al, DC refine, AC first
 * with EOB runs, AC refine), interleaved or single-component.  Block
 * addresses come from each component's geometry: an interleaved scan walks
 * the MCU grid, padding blocks included; a single-component scan walks the
 * component's own unpadded block grid.
 *
 * Huffman streams are read the way libjpeg-turbo reads them (jdhuff.c,
 * jdphuff.c, jdmarker.c, jdatasrc.c), so corrupt and truncated input
 * decodes to the same coefficients with the same warnings:
 *   - the bit buffer is filled to 57 bits at a time and stops at a marker;
 *     bits needed past the marker read as zero, with one "premature end of
 *     data segment" warning, and the rest of the restart interval is
 *     skipped (left as earlier scans left it; DC refine scans read on,
 *     since zero bits change nothing);
 *   - past the end of the buffer the source warns "Premature end of JPEG
 *     file" and supplies a fake EOI marker, as jpeg_mem_src does;
 *   - RSTn markers are checked against the expected number and resynced by
 *     jpeg_resync_to_restart's rules; DC predictors and EOBRUN reset there;
 *   - an MCU of a sequential scan without restart intervals, with at least
 *     512 bytes a block left, goes through libjpeg-turbo's fast path: six
 *     bytes read at a time, an invalid Huffman code read as 0 without a
 *     warning, and the MCU decoded again the slow way if it meets a
 *     marker; the bytes read ahead decide how many extraneous bytes a
 *     corrupt scan leaves before its marker, so this decoder reads as far.
 *
 * Arithmetic-coded streams (SOF9, SOF10) go through the QM decoder of
 * T.81 Annex D with the statistical models of Annex F.1.4.4 and G.1.3.3,
 * as libjpeg-turbo's jdarith.c decodes them:
 *   - one byte at a time, no read-ahead; at a marker the decoder is fed
 *     zero bytes from then on (legal in arithmetic coding) and the marker
 *     is left unread; past the end of the buffer, the fake EOI above;
 *   - each scan starts with its statistics bins cleared; the DC bins are
 *     conditioned on the previous difference of the same component by
 *     the DAC values L and U, the AC magnitude bins split at K;
 *   - at each restart: the marker read as above, then the bins of the
 *     scan's tables, the DC predictors and contexts, and the coder's
 *     registers reset;
 *   - a bad code (a magnitude past 2^15, or a run past Se) warns "bad
 *     arithmetic code" and leaves the rest of the restart interval
 *     undecoded (DC refine scans have no such code and read on).
 * Every read and write is bounds-checked against the buffers passed in.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define MIN_GET_BITS 57   /* 64-bit buffer, as libjpeg-turbo fills it */
#define LOOKAHEAD 8
#define MAX_BLOCKS 10     /* D_MAX_BLOCKS_IN_MCU */
#define FAST_BYTES 512    /* libjpeg-turbo's BUFSIZE per block */

/* warning codes (texts in io/jpeg_reader.py) */
enum { W_EOF = 1, W_HIT_MARKER = 2, W_BAD_CODE = 3, W_MUST_RESYNC = 4,
       W_EXTRANEOUS = 5, W_ARITH_BAD_CODE = 6 };
/* error returns */
enum { E_BAD_TABLE = -1, E_DC_RANGE = -2, E_ARGS = -3 };

/* zigzag -> natural order, with 16 extra entries for corrupt runs that
 * step past coefficient 63 (libjpeg's jpeg_natural_order) */
static const uint8_t NATURAL[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t lookup[1 << LOOKAHEAD];   /* code length << 8 | symbol */
} htab;

typedef struct {
    const uint8_t *data;
    int64_t len, pos;
    int fake_left;          /* bytes left of the fake EOI at end of data */
    uint64_t buf;
    int bits;
    int marker;             /* unread marker code, 0 if none */
    int insufficient;
    int64_t discarded;      /* extraneous bytes not yet reported */
    int32_t *warn;          /* [warn_cap][3]: code, arg, arg */
    int32_t warn_cap;
    int32_t n_warn;
} reader;

static void warn(reader *r, int code, int a, int b) {
    if (r->n_warn < r->warn_cap) {
        int32_t *w = r->warn + 3 * r->n_warn;
        w[0] = code;
        w[1] = a;
        w[2] = b;
    }
    r->n_warn++;
}

/* the next source byte; past the end, jpeg_mem_src's fake EOI (FF D9),
 * with a warning each time it is handed out */
static int next_byte(reader *r) {
    if (r->pos < r->len)
        return r->data[r->pos++];
    if (r->fake_left == 0) {
        warn(r, W_EOF, 0, 0);
        r->fake_left = 2;
    }
    return r->fake_left-- == 2 ? 0xFF : 0xD9;
}

/* jpeg_fill_bit_buffer: load bytes until 57 bits or a marker; if fewer
 * than nbits are then available, pad with zero bits (one warning) */
static void fill(reader *r, int nbits) {
    while (r->bits < MIN_GET_BITS && !r->marker) {
        int c = next_byte(r);
        if (c == 0xFF) {
            do
                c = next_byte(r);
            while (c == 0xFF);
            if (c != 0) {
                r->marker = c;
                break;
            }
            c = 0xFF;
        }
        r->buf = (r->buf << 8) | (uint64_t)c;
        r->bits += 8;
    }
    if (r->bits < MIN_GET_BITS && nbits > r->bits) {
        if (!r->insufficient) {
            warn(r, W_HIT_MARKER, 0, 0);
            r->insufficient = 1;
        }
        r->buf <<= MIN_GET_BITS - r->bits;
        r->bits = MIN_GET_BITS;
    }
}

static inline int get_bits(reader *r, int n) {
    if (r->bits < n)
        fill(r, n);
    r->bits -= n;
    return (int)(r->buf >> r->bits) & ((1 << n) - 1);
}

static inline int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x + (int)(-1u << s) + 1 : x;
}

/* HUFF_DECODE + jpeg_huff_decode: the next symbol; an invalid code (17
 * bits read) gives 0, with a warning */
static int decode_symbol(reader *r, const htab *t) {
    int nb;
    if (r->bits < LOOKAHEAD) {
        fill(r, 0);
        if (r->bits < LOOKAHEAD) {
            nb = 1;
            goto slow;
        }
    }
    {
        int look = (int)(r->buf >> (r->bits - LOOKAHEAD)) & 0xFF;
        int e = t->lookup[look];
        nb = e >> LOOKAHEAD;
        if (nb <= LOOKAHEAD) {
            r->bits -= nb;
            return e & 0xFF;
        }
    }
slow: {
        int32_t code = get_bits(r, nb);
        while (code > t->maxcode[nb]) {
            code = (code << 1) | get_bits(r, 1);
            nb++;
        }
        if (nb > 16) {
            warn(r, W_BAD_CODE, 0, 0);
            return 0;
        }
        return t->vals[(code + t->valoffset[nb]) & 0xFF];
    }
}

/* libjpeg-turbo's fast path (decode_mcu_fast): six bytes at a time
 * whenever 16 bits or fewer are left; at a marker it feeds zero bytes and
 * records the marker, and the caller then decodes the MCU again on the
 * path above */
static void fill_fast(reader *r) {
    if (r->bits > 16)
        return;
    for (int i = 0; i < 6; i++) {
        if (r->pos + 1 >= r->len) {     /* never within 512 bytes a block */
            r->marker = 0xD9;
            r->buf <<= 8;
            r->bits += 8;
            continue;
        }
        int c0 = r->data[r->pos++], c1 = r->data[r->pos];
        r->buf = (r->buf << 8) | (uint64_t)c0;
        r->bits += 8;
        if (c0 == 0xFF) {
            r->pos++;
            if (c1 != 0) {
                r->marker = c1;
                r->pos -= 2;
                r->buf &= ~(uint64_t)0xFF;
            }
        }
    }
}

static inline int get_bits_fast(reader *r, int n) {
    fill_fast(r);
    r->bits -= n;
    return (int)(r->buf >> r->bits) & ((1 << n) - 1);
}

/* HUFF_DECODE_FAST: an invalid code gives 0 without a warning */
static int decode_symbol_fast(reader *r, const htab *t) {
    fill_fast(r);
    int e = t->lookup[(int)(r->buf >> (r->bits - LOOKAHEAD)) & 0xFF];
    int nb = e >> LOOKAHEAD;
    r->bits -= nb;
    if (nb <= LOOKAHEAD)
        return e & 0xFF;
    int32_t code = (int32_t)(r->buf >> r->bits) & ((1 << nb) - 1);
    while (code > t->maxcode[nb]) {
        r->bits--;
        code = (code << 1) | (int32_t)((r->buf >> r->bits) & 1);
        nb++;
    }
    return nb > 16 ? 0 : t->vals[(code + t->valoffset[nb]) & 0xFF];
}

/* one MCU of a sequential scan (decode_mcu_slow, or decode_mcu_fast) */
static void decode_sequential(reader *r, int fast, int nb, int16_t **blk,
                              const int *blk_comp, const htab *dc_tab,
                              const htab *ac_tab, int *last_dc) {
    for (int b = 0; b < nb; b++) {
        int c = blk_comp[b];
        int16_t *block = blk[b];
        int s = fast ? decode_symbol_fast(r, &dc_tab[c])
                     : decode_symbol(r, &dc_tab[c]);
        if (s)
            s = extend(fast ? get_bits_fast(r, s) : get_bits(r, s), s);
        last_dc[c] = (int)((unsigned)last_dc[c] + (unsigned)s);
        block[0] = (int16_t)last_dc[c];
        for (int k = 1; k < 64; k++) {
            int rs = fast ? decode_symbol_fast(r, &ac_tab[c])
                          : decode_symbol(r, &ac_tab[c]);
            int run = rs >> 4;
            s = rs & 15;
            if (s) {
                k += run;
                s = extend(fast ? get_bits_fast(r, s) : get_bits(r, s), s);
                block[NATURAL[k]] = (int16_t)s;
            } else {
                if (run != 15)
                    break;
                k += 15;
            }
        }
    }
}

/* jpeg_make_d_derived_tbl, with its validation */
static int build_table(const uint8_t *spec, int is_dc, htab *t) {
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int n = spec[l - 1];
        if (p + n > 256)
            return E_BAD_TABLE;
        while (n--)
            size[p++] = (uint8_t)l;
    }
    size[p] = 0;
    int nsym = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si)
            code_of[p++] = code++;
        if (code >= (1u << si))
            return E_BAD_TABLE;
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (spec[l - 1]) {
            t->valoffset[l] = p - (int32_t)code_of[p];
            p += spec[l - 1];
            t->maxcode[l] = (int32_t)code_of[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    memcpy(t->vals, spec + 16, 256);
    for (int i = 0; i < (1 << LOOKAHEAD); i++)
        t->lookup[i] = (LOOKAHEAD + 1) << LOOKAHEAD;
    p = 0;
    for (int l = 1; l <= LOOKAHEAD; l++) {
        for (int i = 0; i < spec[l - 1]; i++, p++) {
            int look = (int)(code_of[p] << (LOOKAHEAD - l));
            for (int k = 1 << (LOOKAHEAD - l); k > 0; k--)
                t->lookup[look++] = (uint16_t)((l << LOOKAHEAD) | t->vals[p]);
        }
    }
    if (is_dc)
        for (int i = 0; i < nsym; i++)
            if (t->vals[i] > 15)
                return E_BAD_TABLE;
    return 0;
}

/* jdmarker.c next_marker: skip to the next marker, counting what it
 * skips, and leave it unread */
static void next_marker(reader *r) {
    int c;
    for (;;) {
        c = next_byte(r);
        while (c != 0xFF) {
            r->discarded++;
            c = next_byte(r);
        }
        do
            c = next_byte(r);
        while (c == 0xFF);
        if (c != 0)
            break;
        r->discarded += 2;
    }
    if (r->discarded) {
        warn(r, W_EXTRANEOUS, (int)r->discarded, c);
        r->discarded = 0;
    }
    r->marker = c;
}

/* read_restart_marker + jpeg_resync_to_restart */
static void read_restart(reader *r, int desired) {
    if (!r->marker)
        next_marker(r);
    if (r->marker == 0xD0 + desired) {
        r->marker = 0;
        return;
    }
    warn(r, W_MUST_RESYNC, r->marker, desired);
    for (;;) {
        int m = r->marker, action;
        if (m < 0xC0)
            action = 2;                 /* invalid marker */
        else if (m < 0xD0 || m > 0xD7)
            action = 3;                 /* valid non-restart marker */
        else if (m == 0xD0 + ((desired + 1) & 7) ||
                 m == 0xD0 + ((desired + 2) & 7))
            action = 3;                 /* one of the next two restarts */
        else if (m == 0xD0 + ((desired - 1) & 7) ||
                 m == 0xD0 + ((desired - 2) & 7))
            action = 2;                 /* a prior restart: advance */
        else
            action = 1;                 /* desired, or too far away */
        if (action == 1) {
            r->marker = 0;
            return;
        }
        if (action == 3)
            return;
        next_marker(r);
    }
}

/* ---- arithmetic decoding (T.81 Annex D, F.1.4.4, G.1.3.3; jdarith.c) */

/* Table D.2, one entry per probability state: Qe, the next state after
 * an LPS | Switch_MPS << 7, the next state after an MPS; entry 113 is
 * the fixed estimate of 0.5 (T.851 Table 5) for sign and refinement bits */
static const uint16_t QE[114] = {
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f,
    0x0036, 0x001a, 0x000d, 0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25,
    0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1, 0x072f, 0x055c,
    0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a,
    0x0068, 0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1,
    0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177, 0x0e74, 0x0bfb, 0x09f8,
    0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4, 0x025c,
    0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f,
    0x5b12, 0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf,
    0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51, 0x0bb6, 0x0a40,
    0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8,
    0x4f46, 0x47e5, 0x41cf, 0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639,
    0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f, 0x5a10, 0x5522,
    0x59eb, 0x5a1d};
#define S 0x80  /* Switch_MPS */
static const uint8_t NEXT_LPS[114] = {
    1 | S, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15 | S, 36,
    38, 39, 40, 42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60,
    62, 63, 32, 33, 37 | S, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77,
    78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61,
    65 | S, 80, 81, 82, 83, 84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77,
    80 | S, 88, 89, 90, 91, 92, 93, 86, 88 | S, 95, 96, 97, 99, 99, 93,
    95 | S, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105 | S, 108, 109,
    110, 111, 110 | S, 112, 112 | S, 113};
#undef S
static const uint8_t NEXT_MPS[114] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 9, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 48,
    81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92, 93, 94, 86, 96,
    97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111,
    109, 111, 113};

#define DC_BINS 64
#define AC_BINS 256
#define N_ARITH_TABLES 16

typedef struct {
    int64_t c;              /* C register: interval base and input bits */
    int64_t a;              /* A register: the interval's size */
    int ct;                 /* bits left in C's input byte; -16 before the
                               first two bytes, -1 after a bad code */
    uint8_t dc_stats[N_ARITH_TABLES][DC_BINS];
    uint8_t ac_stats[N_ARITH_TABLES][AC_BINS];
    uint8_t fixed_bin;      /* state 113, the fixed estimate */
} qm_decoder;

/* jdarith.c get_byte + the marker rule of arith_decode: the next byte
 * of coded data; at a marker, zero from then on */
static int qm_byte(reader *r) {
    if (r->marker)
        return 0;
    int c = next_byte(r);
    if (c != 0xFF)
        return c;
    do
        c = next_byte(r);
    while (c == 0xFF);
    if (c == 0)
        return 0xFF;
    r->marker = c;
    return 0;
}

/* arith_decode: one binary decision in the context of bin `st` (state
 * and MPS sense), which it updates (D.2.4-D.2.6) */
static int qm_decode(reader *r, qm_decoder *q, uint8_t *st) {
    while (q->a < 0x8000) {
        if (--q->ct < 0) {
            q->c = (q->c << 8) | qm_byte(r);
            if ((q->ct += 8) < 0 && ++q->ct == 0)
                q->a = 0x8000;      /* two bytes in: A is 0x10000 below */
        }
        q->a <<= 1;
    }
    int sv = *st;
    int64_t qe = QE[sv & 0x7F];
    int nl = NEXT_LPS[sv & 0x7F], nm = NEXT_MPS[sv & 0x7F];
    int64_t temp = q->a - qe;
    q->a = temp;
    temp <<= q->ct;
    if (q->c >= temp) {
        q->c -= temp;
        if (q->a < qe) {            /* conditional exchange: MPS */
            q->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {                    /* LPS */
            q->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (q->a < 0x8000) {
        if (q->a < qe) {            /* conditional exchange: LPS */
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {                    /* MPS */
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

static void qm_reset(qm_decoder *q) {
    q->c = 0;
    q->a = 0;
    q->ct = -16;                    /* read 2 bytes before the first bit */
}

/* Figures F.23-F.24 after the sign: the magnitude category from bin `st`
 * on (the rest of the category at `x`), then its bits from st + 14.
 * Returns |v| - 1 and its top bit in *cat (0 for |v| = 1), or -1 (a bad
 * code) where the category passes 2^15.  The AC form decodes the first
 * bin twice before moving to `x` */
static int qm_magnitude(reader *r, qm_decoder *q, uint8_t *st, uint8_t *x,
                        int ac, int *cat) {
    int m = qm_decode(r, q, st);
    if (m && (!ac || qm_decode(r, q, st))) {
        if (ac)
            m <<= 1;
        st = x;
        while (qm_decode(r, q, st)) {
            if ((m <<= 1) == 0x8000)
                return -1;
            st++;
        }
    }
    *cat = m;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (qm_decode(r, q, st))
            v |= m;
    return v;
}

/* Figure F.19 with F.1.4.4.1.2's conditioning: one DC difference of
 * component c added to its predictor (modulo 2^16).  Returns -1 on a bad
 * code */
static int qm_dc(reader *r, qm_decoder *q, int tbl, int L, int U,
                 int *context, int *last_dc) {
    uint8_t *st = q->dc_stats[tbl] + *context;
    if (qm_decode(r, q, st) == 0) {
        *context = 0;
        return 0;
    }
    int sign = qm_decode(r, q, st + 1);
    st += 2 + sign;
    int m;
    int v = qm_magnitude(r, q, st, q->dc_stats[tbl] + 20, 0, &m);
    if (v < 0)
        return -1;
    if (m < (int)((1L << L) >> 1))
        *context = 0;
    else if (m > (int)((1L << U) >> 1))
        *context = 12 + sign * 4;
    else
        *context = 4 + sign * 4;
    v += 1;
    *last_dc = (*last_dc + (sign ? -v : v)) & 0xFFFF;
    return 0;
}

/* decode_mcu_AC_first, and the AC half of decode_mcu (Ss = 1, Se = 63,
 * Al = 0): Figure F.20's coefficients Ss..Se of one block.  Returns -1 on
 * a bad code */
static int qm_ac_first(reader *r, qm_decoder *q, int tbl, int K,
                       int16_t *block, int ss, int se, int al) {
    uint8_t *stats = q->ac_stats[tbl];
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (qm_decode(r, q, st))
            break;                          /* end of block */
        while (qm_decode(r, q, st + 1) == 0) {
            st += 3;
            if (++k > se)
                return -1;                  /* a run past Se */
        }
        int sign = qm_decode(r, q, &q->fixed_bin), m;
        int v = qm_magnitude(r, q, st + 2, stats + (k <= K ? 189 : 217), 1,
                             &m);
        if (v < 0)
            return -1;
        v += 1;
        block[NATURAL[k]] = (int16_t)(uint32_t)((unsigned)(sign ? -v : v)
                                                << al);
    }
    return 0;
}

/* decode_mcu_AC_refine: G.1.3.3's correction bits of the coefficients
 * already nonzero and the newly nonzero ones (+-1 << Al).  Returns -1 on
 * a bad code */
static int qm_ac_refine(reader *r, qm_decoder *q, int tbl, int16_t *block,
                        int ss, int se, int al) {
    uint8_t *stats = q->ac_stats[tbl];
    const int p1 = 1 << al;
    const int m1 = (int)(-1u << al);
    int kex = se;                           /* the previous stage's EOB */
    while (kex > 0 && !block[NATURAL[kex]])
        kex--;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (k > kex && qm_decode(r, q, st))
            break;                          /* end of block */
        for (;;) {
            int16_t *coef = block + NATURAL[k];
            if (*coef) {
                if (qm_decode(r, q, st + 2))
                    *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                break;
            }
            if (qm_decode(r, q, st + 1)) {
                *coef = (int16_t)(qm_decode(r, q, &q->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > se)
                return -1;                  /* a run past Se */
        }
    }
    return 0;
}

/* start_pass / process_restart: clear the bins of the scan's tables (DC
 * bins, predictors and contexts where the scan codes DC differences; AC
 * bins where it codes AC coefficients) and the coder's registers */
static void qm_start(qm_decoder *q, int ns, const int32_t *arith,
                     int dc_diffs, int ac, int *context, int *last_dc) {
    for (int c = 0; c < ns; c++) {
        if (dc_diffs) {
            memset(q->dc_stats[arith[5 * c]], 0, DC_BINS);
            last_dc[c] = 0;
            context[c] = 0;
        }
        if (ac)
            memset(q->ac_stats[arith[5 * c + 1]], 0, AC_BINS);
    }
    qm_reset(q);
}

/* One MCU of an arithmetic scan (decode_mcu and the four progressive
 * decode_mcu_*).  Returns -1 on a bad code */
static int qm_mcu(reader *r, qm_decoder *q, const int32_t *arith,
                  int progressive, int ss, int se, int ah, int al, int nb,
                  int16_t **blk, const int *blk_comp, int *context,
                  int *last_dc) {
    if (progressive && ss > 0)              /* one block, one component */
        return ah ? qm_ac_refine(r, q, arith[1], blk[0], ss, se, al)
                  : qm_ac_first(r, q, arith[1], arith[4], blk[0], ss, se,
                                al);
    for (int b = 0; b < nb; b++) {
        int c = blk_comp[b];
        const int32_t *t = arith + 5 * c;
        if (progressive && ah) {            /* DC refine: the next bit */
            if (qm_decode(r, q, &q->fixed_bin))
                blk[b][0] = (int16_t)(blk[b][0] | (1 << al));
            continue;
        }
        if (qm_dc(r, q, t[0], t[2], t[3], &context[c], &last_dc[c]))
            return -1;
        if (progressive) {                  /* DC first */
            blk[b][0] = (int16_t)(uint32_t)((unsigned)last_dc[c] << al);
            continue;
        }
        blk[b][0] = (int16_t)last_dc[c];
        if (qm_ac_first(r, q, t[1], t[4], blk[b], 1, 63, 0))
            return -1;
    }
    return 0;
}

/* Decode one scan in place.
 *
 *   data, len      the whole file; state[0] the offset just past the SOS
 *                  segment (in), of the next unread byte (out); state[1]
 *                  out: the marker that ended the scan, already read, or
 *                  0; state[2] extraneous bytes not yet reported and
 *                  state[3] bytes left of a fake EOI (in/out)
 *   ns             components in the scan (1-4)
 *   geom           per scan component: h, v, nbx, nby, stride, rows (the
 *                  allocated plane is rows x stride blocks of 64 int16)
 *   coefs          per scan component: its plane
 *   dc_specs,      per scan component: 16 code counts + 256 symbols of
 *   ac_specs       the Huffman table it uses (NULL where the scan needs
 *                  none, and in an arithmetic scan)
 *   mcus_x, mcus_y the frame's MCU grid (interleaved scans)
 *   progressive, ss, se, ah, al, restart_interval   scan parameters,
 *                  validated by the caller
 *   arith          NULL for a Huffman scan; for an arithmetic scan, per
 *                  scan component: its DC and AC conditioning table
 *                  (0-15; components that share one share its bins) and
 *                  that DC table's L and U and AC table's K (DAC values)
 *   warn, warn_cap, n_warn   warnings: the first warn_cap as (code, arg,
 *                  arg), n_warn counts all
 * Returns 0, or E_BAD_TABLE / E_DC_RANGE / E_ARGS.
 */
int j2p_decode_scan(const uint8_t *data, int64_t len, int64_t *state,
                    int32_t ns, const int32_t *geom, int16_t *const *coefs,
                    const uint8_t *const *dc_specs,
                    const uint8_t *const *ac_specs, int32_t mcus_x,
                    int32_t mcus_y, int32_t progressive, int32_t ss,
                    int32_t se, int32_t ah, int32_t al,
                    int32_t restart_interval, const int32_t *arith,
                    int32_t *warn_out,
                    int32_t warn_cap, int32_t *n_warn) {
    if (ns < 1 || ns > 4 || len < 0 || state[0] < 0 || state[0] > len ||
        mcus_x < 1 || mcus_y < 1 || restart_interval < 0)
        return E_ARGS;
    if (progressive && (ss < 0 || se > 63 || ss > se || (ss == 0 && se) ||
                        (ss > 0 && ns != 1) || al < 0 || al > 13 ||
                        (ah != 0 && ah != al + 1)))
        return E_ARGS;
    int dc_scan = !progressive || ss == 0;
    int ac_scan = !progressive || ss > 0;
    int refine = progressive && ah != 0;

    htab dc_tab[4], ac_tab[4];
    int32_t h[4], v[4], nbx[4], nby[4], stride[4];
    int nblocks = 0;
    for (int c = 0; c < ns; c++) {
        const int32_t *g = geom + 6 * c;
        h[c] = g[0];
        v[c] = g[1];
        nbx[c] = g[2];
        nby[c] = g[3];
        stride[c] = g[4];
        int32_t rows = g[5];
        if (h[c] < 1 || h[c] > 4 || v[c] < 1 || v[c] > 4 || nbx[c] < 1 ||
            nby[c] < 1 || nbx[c] > stride[c] || nby[c] > rows ||
            coefs[c] == NULL)
            return E_ARGS;
        if (ns > 1 && ((int64_t)mcus_x * h[c] > stride[c] ||
                       (int64_t)mcus_y * v[c] > rows))
            return E_ARGS;
        nblocks += ns > 1 ? h[c] * v[c] : 1;
        if (arith) {
            const int32_t *t = arith + 5 * c;
            if (t[0] < 0 || t[0] >= N_ARITH_TABLES || t[1] < 0 ||
                t[1] >= N_ARITH_TABLES || t[2] < 0 || t[2] > t[3] ||
                t[3] > 15 || t[4] < 0 || t[4] > 255)
                return E_ARGS;
            continue;
        }
        if (dc_scan && !refine) {
            if (!dc_specs[c])
                return E_ARGS;
            int err = build_table(dc_specs[c], 1, &dc_tab[c]);
            if (err)
                return err;
        }
        if (ac_scan) {
            if (!ac_specs[c])
                return E_ARGS;
            int err = build_table(ac_specs[c], 0, &ac_tab[c]);
            if (err)
                return err;
        }
    }
    if (nblocks > MAX_BLOCKS)
        return E_ARGS;

    reader rd = {0};
    reader *r = &rd;
    r->data = data;
    r->len = len;
    r->pos = state[0];
    r->discarded = state[2];
    r->fake_left = (int)state[3] & 3;
    r->warn = warn_out;
    r->warn_cap = warn_cap;

    int64_t n_mcus = ns > 1 ? (int64_t)mcus_x * mcus_y
                            : (int64_t)nbx[0] * nby[0];
    int last_dc[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    int64_t restarts_to_go = restart_interval;
    int next_restart = 0;
    int16_t *blk[MAX_BLOCKS];
    int blk_comp[MAX_BLOCKS];
    const int p1 = 1 << al;
    const int m1 = (int)(-1u << al);
    qm_decoder q;
    int context[4] = {0, 0, 0, 0};
    int dc_diffs = !progressive || (ss == 0 && ah == 0);
    if (arith) {
        q.fixed_bin = 113;
        qm_start(&q, ns, arith, dc_diffs, ac_scan, context, last_dc);
    }

    for (int64_t m = 0; m < n_mcus; m++) {
        /* the MCU's blocks */
        int nb = 0;
        if (ns > 1) {
            int64_t my = m / mcus_x, mx = m % mcus_x;
            for (int c = 0; c < ns; c++)
                for (int y = 0; y < v[c]; y++)
                    for (int x = 0; x < h[c]; x++) {
                        int64_t by = my * v[c] + y, bx = mx * h[c] + x;
                        blk[nb] = coefs[c] + (by * stride[c] + bx) * 64;
                        blk_comp[nb++] = c;
                    }
        } else {
            int64_t by = m / nbx[0], bx = m % nbx[0];
            blk[0] = coefs[0] + (by * stride[0] + bx) * 64;
            blk_comp[0] = 0;
            nb = 1;
        }

        if (arith) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    read_restart(r, next_restart);
                    next_restart = (next_restart + 1) & 7;
                    qm_start(&q, ns, arith, dc_diffs, ac_scan, context,
                             last_dc);
                    restarts_to_go = restart_interval;
                }
                restarts_to_go--;
            }
            if (q.ct != -1 &&
                qm_mcu(r, &q, arith, progressive, ss, se, ah, al, nb, blk,
                       blk_comp, context, last_dc)) {
                warn(r, W_ARITH_BAD_CODE, 0, 0);
                q.ct = -1;          /* nothing more until a restart */
            }
            continue;
        }

        if (restart_interval) {
            if (restarts_to_go == 0) {
                /* process_restart */
                r->discarded += r->bits / 8;
                r->bits = 0;
                read_restart(r, next_restart);
                next_restart = (next_restart + 1) & 7;
                for (int c = 0; c < 4; c++)
                    last_dc[c] = 0;
                eobrun = 0;
                restarts_to_go = restart_interval;
                if (!r->marker)
                    r->insufficient = 0;
            }
        }

        if (!progressive) {
            if (!r->insufficient) {
                int fast = restart_interval == 0 && !r->marker &&
                           r->len - r->pos >= (int64_t)FAST_BYTES * nb;
                reader saved = *r;
                int saved_dc[4];
                memcpy(saved_dc, last_dc, sizeof saved_dc);
                decode_sequential(r, fast, nb, blk, blk_comp, dc_tab, ac_tab,
                                  last_dc);
                if (fast && r->marker) {
                    /* the fast path met a marker: decode the MCU again */
                    *r = saved;
                    memcpy(last_dc, saved_dc, sizeof saved_dc);
                    decode_sequential(r, 0, nb, blk, blk_comp, dc_tab,
                                      ac_tab, last_dc);
                }
            }
        } else if (ss == 0 && ah == 0) {            /* DC first */
            if (!r->insufficient) {
                for (int b = 0; b < nb; b++) {
                    int c = blk_comp[b];
                    int s = decode_symbol(r, &dc_tab[c]);
                    if (s)
                        s = extend(get_bits(r, s), s);
                    int last = last_dc[c];
                    if ((last >= 0 && s > INT32_MAX - last) ||
                        (last < 0 && s < INT32_MIN - last))
                        return E_DC_RANGE;
                    last_dc[c] = last + s;
                    blk[b][0] = (int16_t)(uint32_t)((unsigned)last_dc[c]
                                                     << al);
                }
            }
        } else if (ss == 0) {                       /* DC refine */
            for (int b = 0; b < nb; b++)
                if (get_bits(r, 1))
                    blk[b][0] = (int16_t)(blk[b][0] | p1);
        } else if (ah == 0) {                       /* AC first */
            if (!r->insufficient) {
                if (eobrun > 0) {
                    eobrun--;
                } else {
                    int16_t *block = blk[0];
                    for (int k = ss; k <= se; k++) {
                        int rs = decode_symbol(r, &ac_tab[0]);
                        int run = rs >> 4;
                        int s = rs & 15;
                        if (s) {
                            k += run;
                            s = extend(get_bits(r, s), s);
                            block[NATURAL[k]] =
                                (int16_t)(uint32_t)((unsigned)s << al);
                        } else if (run == 15) {
                            k += 15;
                        } else {
                            eobrun = 1u << run;
                            if (run)
                                eobrun += (unsigned)get_bits(r, run);
                            eobrun--;
                            break;
                        }
                    }
                }
            }
        } else {                                    /* AC refine */
            if (!r->insufficient) {
                int16_t *block = blk[0];
                int k = ss;
                if (eobrun == 0) {
                    for (; k <= se; k++) {
                        int rs = decode_symbol(r, &ac_tab[0]);
                        int run = rs >> 4;
                        int s = rs & 15;
                        if (s) {
                            if (s != 1)
                                warn(r, W_BAD_CODE, 0, 0);
                            s = get_bits(r, 1) ? p1 : m1;
                        } else if (run != 15) {
                            eobrun = 1u << run;
                            if (run)
                                eobrun += (unsigned)get_bits(r, run);
                            break;
                        }
                        /* advance over already-nonzero coefficients and
                         * run still-zero ones, refining the nonzero */
                        do {
                            int16_t *coef = block + NATURAL[k];
                            if (*coef != 0) {
                                if (get_bits(r, 1) && (*coef & p1) == 0)
                                    *coef = (int16_t)(*coef +
                                                      (*coef >= 0 ? p1 : m1));
                            } else if (--run < 0) {
                                break;
                            }
                            k++;
                        } while (k <= se);
                        if (s)
                            block[NATURAL[k]] = (int16_t)s;
                    }
                }
                if (eobrun > 0) {
                    /* the rest of the band: correction bits only */
                    for (; k <= se; k++) {
                        int16_t *coef = block + NATURAL[k];
                        if (*coef != 0 && get_bits(r, 1) &&
                            (*coef & p1) == 0)
                            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                    }
                    eobrun--;
                }
            }
        }

        if (restart_interval)
            restarts_to_go--;
    }

    state[0] = r->pos;
    state[1] = r->marker;
    state[2] = r->discarded;
    state[3] = r->fake_left;
    *n_warn = r->n_warn;
    return 0;
}
