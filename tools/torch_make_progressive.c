/* torch_make_progressive — transcode a JPEG to progressive Huffman coding
 * without touching its coefficients (the jpegtran -progressive analog).
 *
 * Mints the progressive twins under tests/fixtures/torch_progressive/:
 * each carries exactly the quantized DCT coefficients and quantization
 * tables of its sequential original, so the port's reader can be held
 * against the original (and against libjpeg) bit for bit, also on a
 * machine without libjpeg.  libjpeg's standard progression script
 * (jpeg_simple_progression: spectral selection and successive
 * approximation, DC and AC refinement scans); with -r N, a restart marker
 * every N MCUs.
 *
 * Build: cc -O2 -o /tmp/torch_make_progressive tools/torch_make_progressive.c -ljpeg
 * Run:   /tmp/torch_make_progressive [-r N] in.jpg out.jpg
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv)
{
    unsigned restart = 0;
    int a = 1;
    if (argc == 5 && strcmp(argv[1], "-r") == 0) {
        restart = (unsigned)strtoul(argv[2], NULL, 10);
        a = 3;
    }
    if (argc - a != 2) {
        fprintf(stderr, "usage: %s [-r N] in.jpg out.jpg\n", argv[0]);
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
    jpeg_simple_progression(&dst);      /* the point of this program */
    dst.restart_interval = restart;     /* MCUs; 0: none */
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
