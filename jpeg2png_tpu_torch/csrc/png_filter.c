/* The port's PNG row filter: libpng 1.6's adaptive filtering, without
 * libpng.  Plain C11 host code, no CUDA and no Python, PyTorch, zlib or
 * libpng headers; built with the C compiler at first use
 * (kernels/_build.py) and called through ctypes, which releases the
 * interpreter lock for the call, so the PNG threads of the serving runner
 * filter in parallel.
 *
 * Replaces the filtering that the JAX package leaves to libpng
 * (jpeg2png_tpu/native/pngio.c: png_write_image with libpng's defaults).
 * io/png_writer.py deflates the result with zlib's settings of libpng's
 * png_deflate_claim, so the file of an image of up to 128 KiB of filtered
 * rows is byte for byte libpng's; a larger one is filtered and deflated in
 * row strips on several threads (j2p_png_filter_rows).
 *
 * The heuristic is png_write_find_filter (pngwutil.c) for bit depths >= 8
 * with PNG_ALL_FILTERS:
 *   - each row is filtered with None, Sub, Up, Average and Paeth, the
 *     previous row of row 0 being all zeros, and each result is scored by
 *     the sum over its bytes of min(v, 256 - v) (the filter-type byte is
 *     not scored);
 *   - the first strict minimum wins, in that order;
 *   - png_write_start_row narrows the set first: an image one row high
 *     tries None and Sub only, one pixel wide None and Up only, and one
 *     pixel in all None alone.
 * `bpp` is the bytes per pixel (1 / 2 / 3 / 6 for gray8 / gray16 / RGB8 /
 * RGB16, 16-bit samples big-endian), the distance of the left neighbour.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

enum { F_NONE = 0, F_SUB = 1, F_UP = 2, F_AVG = 3, F_PAETH = 4 };
enum { E_ARGS = -1 };

static inline unsigned score(unsigned v) { return v < 128 ? v : 256 - v; }

static inline int paeth(int a, int b, int c) {
    int p = b - c, pc = a - c;
    int pa = p < 0 ? -p : p;
    int pb = pc < 0 ? -pc : pc;
    int pcc = p + pc < 0 ? -(p + pc) : p + pc;
    return (pa <= pb && pa <= pcc) ? a : (pb <= pcc) ? b : c;
}

/* The byte of filter `f` at index i of a row: x less its predictor from
 * a, b, c (left, up, up-left), which are zero left of the first pixel and,
 * for row 0 (prev NULL), above it. */
static inline uint8_t filtered(int f, const uint8_t *row, const uint8_t *prev,
                               int64_t i, int64_t bpp) {
    int x = row[i];
    int a = i >= bpp ? row[i - bpp] : 0;
    int b = prev ? prev[i] : 0;
    int c = prev && i >= bpp ? prev[i - bpp] : 0;
    switch (f) {
    case F_SUB: return (uint8_t)(x - a);
    case F_UP: return (uint8_t)(x - b);
    case F_AVG: return (uint8_t)(x - ((a + b) >> 1));
    case F_PAETH: return (uint8_t)(x - paeth(a, b, c));
    default: return (uint8_t)x;
    }
}

/* adds byte i's score under each filter to sums[] */
static inline void add_scores(uint64_t sums[5], int x, int a, int b, int c) {
    sums[F_NONE] += score((unsigned)x);
    sums[F_SUB] += score((uint8_t)(x - a));
    sums[F_UP] += score((uint8_t)(x - b));
    sums[F_AVG] += score((uint8_t)(x - ((a + b) >> 1)));
    sums[F_PAETH] += score((uint8_t)(x - paeth(a, b, c)));
}

/* the row's score under each filter; the first pixel and row 0 (prev
 * NULL) through `add_scores` with zero neighbours, the rest in one loop
 * without branches, so the compiler vectorises it */
static void row_scores(const uint8_t *row, const uint8_t *prev,
                       int64_t row_bytes, int64_t bpp, uint64_t sums[5]) {
    memset(sums, 0, 5 * sizeof(uint64_t));
    if (prev == NULL) {
        for (int64_t i = 0; i < row_bytes; i++)
            add_scores(sums, row[i], i >= bpp ? row[i - bpp] : 0, 0, 0);
        return;
    }
    for (int64_t i = 0; i < bpp; i++)
        add_scores(sums, row[i], 0, prev[i], 0);
    uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0;
    for (int64_t i = bpp; i < row_bytes; i++) {
        int x = row[i], a = row[i - bpp], b = prev[i], c = prev[i - bpp];
        s0 += score((unsigned)x);
        s1 += score((uint8_t)(x - a));
        s2 += score((uint8_t)(x - b));
        s3 += score((uint8_t)(x - ((a + b) >> 1)));
        s4 += score((uint8_t)(x - paeth(a, b, c)));
    }
    sums[F_NONE] += s0;
    sums[F_SUB] += s1;
    sums[F_UP] += s2;
    sums[F_AVG] += s3;
    sums[F_PAETH] += s4;
}

/* writes the row filtered by `f` into dst */
static void filter_row(int f, const uint8_t *row, const uint8_t *prev,
                       int64_t row_bytes, int64_t bpp, uint8_t *dst) {
    if (f == F_NONE) {
        memcpy(dst, row, (size_t)row_bytes);
    } else if (prev == NULL || f == F_SUB) {
        for (int64_t i = 0; i < row_bytes; i++)
            dst[i] = filtered(f, row, prev, i, bpp);
    } else {
        for (int64_t i = 0; i < bpp; i++)
            dst[i] = filtered(f, row, prev, i, bpp);
        if (f == F_UP)
            for (int64_t i = bpp; i < row_bytes; i++)
                dst[i] = (uint8_t)(row[i] - prev[i]);
        else if (f == F_AVG)
            for (int64_t i = bpp; i < row_bytes; i++)
                dst[i] = (uint8_t)(row[i] - ((row[i - bpp] + prev[i]) >> 1));
        else
            for (int64_t i = bpp; i < row_bytes; i++)
                dst[i] = (uint8_t)(row[i] - paeth(row[i - bpp], prev[i],
                                                  prev[i - bpp]));
    }
}

/* Filters rows [y0, y1) of the h rows of `raw` (row_bytes each) into
 * `out`, (y1 - y0) x (1 + row_bytes) bytes: each row's filter type, then
 * its filtered bytes.  Row y0 - 1 of `raw` is the row above row y0 (none
 * above row 0), and the filters tried follow the whole image's h and
 * row_bytes, as png_write_start_row narrows them, so any split of [0, h)
 * gives the bytes of one call over [0, h) (io/png_writer.filter_rows):
 * png_writer.py filters a large image's row strips on several threads.
 * Returns 0, or E_ARGS for
 * a geometry that is not whole pixels or rows outside [0, h). */
int j2p_png_filter_rows(const uint8_t *raw, int64_t h, int64_t row_bytes,
                        int32_t bpp, int64_t y0, int64_t y1, uint8_t *out) {
    if (h < 1 || bpp < 1 || row_bytes < bpp || row_bytes % bpp != 0
        || y0 < 0 || y1 > h || y0 >= y1)
        return E_ARGS;
    int tries[5] = {1, 1, 1, 1, 1};    /* None, Sub, Up, Average, Paeth */
    if (h == 1)
        tries[F_UP] = tries[F_AVG] = tries[F_PAETH] = 0;
    if (row_bytes == bpp)
        tries[F_SUB] = tries[F_AVG] = tries[F_PAETH] = 0;
    const int only_none = !tries[F_SUB] && !tries[F_UP];

    for (int64_t y = y0; y < y1; y++) {
        const uint8_t *row = raw + y * row_bytes;
        const uint8_t *prev = y > 0 ? row - row_bytes : NULL;
        uint8_t *dst = out + (y - y0) * (row_bytes + 1);
        int best = F_NONE;
        if (!only_none) {
            uint64_t sums[5];
            row_scores(row, prev, row_bytes, bpp, sums);
            /* None's sum is the first minimum; a later filter replaces the
             * minimum only if its sum is strictly less */
            for (int f = F_SUB; f <= F_PAETH; f++)
                if (tries[f] && sums[f] < sums[best])
                    best = f;
        }
        dst[0] = (uint8_t)best;
        filter_row(best, row, prev, row_bytes, bpp, dst + 1);
    }
    return 0;
}
