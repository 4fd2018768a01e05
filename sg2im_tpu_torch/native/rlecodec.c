/* COCO RLE codec — native fast path for mask decode/encode.
 *
 * Plays the role pycocotools' C extension plays in the reference data
 * pipeline (sg2im/data/coco.py:27,362-373): per-sample RLE mask decoding is
 * on the host hot path that feeds the TPU, so it must not bottleneck the
 * input pipeline.  Exposed via ctypes (sg2im_tpu/native/__init__.py); the
 * numpy implementation in sg2im_tpu/data/rle.py is the reference fallback.
 *
 * Format: COCO compressed counts — base-48 LEB128-style varints (5 data
 * bits per byte, bit 0x20 = continuation, sign-extension via 0x10 on the
 * last byte), with run lengths delta-coded against counts[i-2] from the
 * third run on.  Runs alternate background/foreground in column-major
 * (Fortran) order.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Decode a compressed counts string into a column-major (h x w) mask.
 * Returns 0 on success, -1 if runs overflow the mask area. */
int rle_decode(const char *counts, long counts_len, uint8_t *mask,
               long h, long w) {
  long area = h * w;
  long pos = 0;
  long i = 0;
  long prev2 = 0, prev1 = 0;
  long run_idx = 0;
  uint8_t val = 0;
  memset(mask, 0, (size_t)area);
  while (i < counts_len) {
    long x = 0;
    int k = 0;
    int more = 1;
    while (more) {
      long c = (long)counts[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (int)(c & 0x20);
      i++;
      k++;
      if (!more && (c & 0x10)) {
        x |= -1L << (5 * k);
      }
      if (i > counts_len) return -1;
    }
    if (run_idx > 2) x += prev2;
    prev2 = prev1;
    prev1 = x;
    run_idx++;
    if (x < 0 || pos + x > area) return -1;
    if (val) memset(mask + pos, 1, (size_t)x);
    pos += x;
    val = (uint8_t)(1 - val);
  }
  return 0;
}

/* Encode a column-major (h x w) binary mask into compressed counts.
 * out must have room for ~(area/2)*7 bytes worst case; returns the number
 * of bytes written, or -1 if out_cap is exceeded. */
long rle_encode(const uint8_t *mask, long h, long w, char *out,
                long out_cap) {
  long area = h * w;
  long pos = 0;
  uint8_t cur = 0;
  long out_len = 0;
  long prev_runs[2] = {0, 0};
  long run_idx = 0;
  while (pos <= area) {
    long start = pos;
    while (pos < area && mask[pos] == cur) pos++;
    long x = pos - start;
    long orig = x;
    if (run_idx > 2) x -= prev_runs[0];
    prev_runs[0] = prev_runs[1];
    prev_runs[1] = orig;
    run_idx++;
    /* varint emit */
    int more = 1;
    while (more) {
      long c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (out_len >= out_cap) return -1;
      out[out_len++] = (char)(c + 48);
    }
    cur = (uint8_t)(1 - cur);
    if (pos == area) break;
  }
  return out_len;
}
