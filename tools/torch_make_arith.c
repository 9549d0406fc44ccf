/* torch_make_arith — transcode a JPEG to arithmetic coding without
 * touching its coefficients (the jpegtran -arithmetic analog).
 *
 * Mints the arithmetic twins under tests/fixtures/torch_arith/: each
 * carries exactly the quantized DCT coefficients and quantization tables
 * of its Huffman original, so the port's reader can be held against the
 * original (and against libjpeg) bit for bit, also on a machine without
 * libjpeg.  Sequential (SOF9) by default; with -p, libjpeg's standard
 * progression script (SOF10: jpeg_simple_progression's spectral selection
 * and successive approximation); with -r N, a restart marker every N
 * MCUs; with -d T:L,U,K (repeatable), conditioning table T's DAC values
 * instead of the defaults L = 0, U = 1, K = 5 (L <= U <= 15: the DC
 * difference categories; K: where the AC magnitude bins split).
 *
 * Build: cc -O2 -o /tmp/torch_make_arith tools/torch_make_arith.c -ljpeg
 * Run:   /tmp/torch_make_arith [-p] [-r N] [-d T:L,U,K]... in.jpg out.jpg
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

#define MAX_DAC 16

int main(int argc, char **argv)
{
    int progressive = 0, n_dac = 0;
    unsigned restart = 0;
    int dac[MAX_DAC][4];
    int a = 1;
    for (; a < argc && argv[a][0] == '-'; a++) {
        if (strcmp(argv[a], "-p") == 0) {
            progressive = 1;
        } else if (strcmp(argv[a], "-r") == 0 && a + 1 < argc) {
            restart = (unsigned)strtoul(argv[++a], NULL, 10);
        } else if (strcmp(argv[a], "-d") == 0 && a + 1 < argc &&
                   n_dac < MAX_DAC) {
            int *d = dac[n_dac++];
            if (sscanf(argv[++a], "%d:%d,%d,%d", &d[0], &d[1], &d[2],
                       &d[3]) != 4 || d[0] < 0 || d[0] >= NUM_ARITH_TBLS ||
                d[1] < 0 || d[1] > d[2] || d[2] > 15 || d[3] < 1 ||
                d[3] > 63) {
                fprintf(stderr, "bad -d %s (T:L,U,K)\n", argv[a]);
                return 2;
            }
        } else {
            break;
        }
    }
    if (argc - a != 2) {
        fprintf(stderr, "usage: %s [-p] [-r N] [-d T:L,U,K]... in.jpg "
                "out.jpg\n", argv[0]);
        return 2;
    }
    FILE *in = fopen(argv[a], "rb");
    if (!in) { perror("open in"); return 1; }
    FILE *out = fopen(argv[a + 1], "wb");
    if (!out) { perror("open out"); return 1; }

    struct jpeg_decompress_struct src;
    struct jpeg_compress_struct dst;
    struct jpeg_error_mgr jerr_s, jerr_d;

    src.err = jpeg_std_error(&jerr_s);
    jpeg_create_decompress(&src);
    jpeg_stdio_src(&src, in);
    jpeg_read_header(&src, TRUE);
    jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
    if (!coefs) { fprintf(stderr, "read_coefficients failed\n"); return 1; }

    dst.err = jpeg_std_error(&jerr_d);
    jpeg_create_compress(&dst);
    jpeg_copy_critical_parameters(&src, &dst);
    dst.arith_code = TRUE;              /* the point of this program */
    dst.optimize_coding = FALSE;
    if (progressive)
        jpeg_simple_progression(&dst);
    dst.restart_interval = restart;     /* MCUs; 0: none */
    for (int i = 0; i < n_dac; i++) {
        dst.arith_dc_L[dac[i][0]] = (UINT8)dac[i][1];
        dst.arith_dc_U[dac[i][0]] = (UINT8)dac[i][2];
        dst.arith_ac_K[dac[i][0]] = (UINT8)dac[i][3];
    }
    jpeg_stdio_dest(&dst, out);
    jpeg_write_coefficients(&dst, coefs);
    jpeg_finish_compress(&dst);
    jpeg_destroy_compress(&dst);
    jpeg_finish_decompress(&src);
    jpeg_destroy_decompress(&src);
    fclose(in);
    fclose(out);
    return 0;
}
