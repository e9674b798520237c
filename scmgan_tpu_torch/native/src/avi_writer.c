/* Minimal uncompressed-AVI (RIFF / DIB) writer.
 *
 * Native video-encode path: the reference shells out to ffmpeg/libx264
 * through imutil (reference README.md:20); this image has no ffmpeg, so
 * evaluation videos are written as uncompressed AVI by this C module
 * (fallback chain in scmgan_tpu_torch/analysis/video.py).  Frames are 24-bit
 * BGR, bottom-up rows, 4-byte row alignment, with an idx1 index so players
 * can seek.
 *
 * Exposed via ctypes (see scmgan_tpu_torch/native/__init__.py):
 *   int write_avi(const char *path, const unsigned char *rgb,
 *                 int n_frames, int height, int width, int fps);
 * rgb is n_frames * height * width * 3, RGB row-major top-down.
 * Returns 0 on success, negative errno-style codes on failure.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static void put_u32(FILE *f, uint32_t v) {
    unsigned char b[4] = {v & 0xff, (v >> 8) & 0xff, (v >> 16) & 0xff,
                          (v >> 24) & 0xff};
    fwrite(b, 1, 4, f);
}

static void put_u16(FILE *f, uint16_t v) {
    unsigned char b[2] = {v & 0xff, (v >> 8) & 0xff};
    fwrite(b, 1, 2, f);
}

static void put_4cc(FILE *f, const char *s) { fwrite(s, 1, 4, f); }

int write_avi(const char *path, const unsigned char *rgb, int n_frames,
              int height, int width, int fps) {
    if (!path || !rgb || n_frames <= 0 || height <= 0 || width <= 0 ||
        fps <= 0)
        return -1;

    const uint32_t row_bytes = ((uint32_t)width * 3 + 3) & ~3u;
    const uint32_t frame_bytes = row_bytes * (uint32_t)height;
    const uint32_t movi_data = (uint32_t)n_frames * (frame_bytes + 8);
    const uint32_t hdrl_size = 4 + (8 + 56) + (8 + 4 + (8 + 56) + (8 + 40));
    const uint32_t movi_size = 4 + movi_data;
    const uint32_t idx1_size = (uint32_t)n_frames * 16;
    const uint32_t riff_size =
        4 + (8 + hdrl_size) + (8 + movi_size) + (8 + idx1_size);

    FILE *f = fopen(path, "wb");
    if (!f) return -2;

    /* RIFF header */
    put_4cc(f, "RIFF"); put_u32(f, riff_size); put_4cc(f, "AVI ");

    /* LIST hdrl */
    put_4cc(f, "LIST"); put_u32(f, hdrl_size); put_4cc(f, "hdrl");

    /* avih: main header */
    put_4cc(f, "avih"); put_u32(f, 56);
    put_u32(f, 1000000u / (uint32_t)fps);  /* us per frame */
    put_u32(f, frame_bytes * (uint32_t)fps); /* max bytes/sec */
    put_u32(f, 0);                          /* padding */
    put_u32(f, 0x10);                       /* AVIF_HASINDEX */
    put_u32(f, (uint32_t)n_frames);
    put_u32(f, 0);                          /* initial frames */
    put_u32(f, 1);                          /* streams */
    put_u32(f, frame_bytes);                /* suggested buffer */
    put_u32(f, (uint32_t)width);
    put_u32(f, (uint32_t)height);
    put_u32(f, 0); put_u32(f, 0); put_u32(f, 0); put_u32(f, 0);

    /* LIST strl */
    put_4cc(f, "LIST"); put_u32(f, 4 + (8 + 56) + (8 + 40));
    put_4cc(f, "strl");

    /* strh: stream header */
    put_4cc(f, "strh"); put_u32(f, 56);
    put_4cc(f, "vids"); put_4cc(f, "DIB ");
    put_u32(f, 0); put_u16(f, 0); put_u16(f, 0);
    put_u32(f, 0);                          /* initial frames */
    put_u32(f, 1);                          /* scale */
    put_u32(f, (uint32_t)fps);              /* rate */
    put_u32(f, 0);                          /* start */
    put_u32(f, (uint32_t)n_frames);         /* length */
    put_u32(f, frame_bytes);                /* suggested buffer */
    put_u32(f, 0xFFFFFFFFu);                /* quality */
    put_u32(f, 0);                          /* sample size */
    put_u16(f, 0); put_u16(f, 0);
    put_u16(f, (uint16_t)width); put_u16(f, (uint16_t)height);

    /* strf: BITMAPINFOHEADER */
    put_4cc(f, "strf"); put_u32(f, 40);
    put_u32(f, 40);
    put_u32(f, (uint32_t)width);
    put_u32(f, (uint32_t)height);
    put_u16(f, 1);                          /* planes */
    put_u16(f, 24);                         /* bpp */
    put_u32(f, 0);                          /* BI_RGB */
    put_u32(f, frame_bytes);
    put_u32(f, 0); put_u32(f, 0); put_u32(f, 0); put_u32(f, 0);

    /* LIST movi */
    put_4cc(f, "LIST"); put_u32(f, movi_size); put_4cc(f, "movi");

    unsigned char *row = (unsigned char *)malloc(row_bytes);
    if (!row) { fclose(f); return -3; }
    memset(row, 0, row_bytes);

    for (int i = 0; i < n_frames; i++) {
        put_4cc(f, "00db"); put_u32(f, frame_bytes);
        const unsigned char *frame =
            rgb + (size_t)i * (size_t)height * (size_t)width * 3;
        for (int y = height - 1; y >= 0; y--) {   /* bottom-up */
            const unsigned char *src = frame + (size_t)y * width * 3;
            for (int x = 0; x < width; x++) {     /* RGB -> BGR */
                row[x * 3 + 0] = src[x * 3 + 2];
                row[x * 3 + 1] = src[x * 3 + 1];
                row[x * 3 + 2] = src[x * 3 + 0];
            }
            fwrite(row, 1, row_bytes, f);
        }
    }
    free(row);

    /* idx1 */
    put_4cc(f, "idx1"); put_u32(f, idx1_size);
    uint32_t offset = 4;
    for (int i = 0; i < n_frames; i++) {
        put_4cc(f, "00db");
        put_u32(f, 0x10);                   /* AVIIF_KEYFRAME */
        put_u32(f, offset);
        put_u32(f, frame_bytes);
        offset += frame_bytes + 8;
    }

    if (fclose(f) != 0) return -4;
    return 0;
}
