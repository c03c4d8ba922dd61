// fastpng: a PNG encoder for RGB8 frames, loaded with ctypes.
//
// The port's copy of bhr_tpu/native/fastpng.cpp, with the same C ABI and
// the same bytes for the same image, level and deflate backend. Each row
// gets the cheapest of the None, Sub and Up filters by libpng's
// minimum-sum rule; frames are mostly smooth or black, so this comes
// within a few percent of an adaptive five-filter search at a fraction
// of the time. One thread per call: the video's writer threads encode
// several frames at once.
//
// Deflate backend: libdeflate when the build defines USE_LIBDEFLATE
// (whole-buffer API, ~3x zlib's throughput), else zlib streaming.
// bhr_tpu_torch/_build.py tries libdeflate first, then zlib, so the
// library links against what the host has.
//
// C ABI only: no exception crosses the boundary.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#else
#include <zlib.h>
#endif

namespace {

inline void put_u32be(uint8_t *p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

inline uint32_t chunk_crc(const uint8_t *type_and_payload, size_t n) {
#ifdef USE_LIBDEFLATE
  return static_cast<uint32_t>(libdeflate_crc32(0, type_and_payload, n));
#else
  uint32_t crc = crc32(0L, Z_NULL, 0);
  return crc32(crc, type_and_payload, static_cast<uInt>(n));
#endif
}

// Append one PNG chunk (length, type, payload, crc) to buf at *pos.
void append_chunk(uint8_t *buf, size_t *pos, const char type[4],
                  const uint8_t *payload, uint32_t len) {
  put_u32be(buf + *pos, len);
  std::memcpy(buf + *pos + 4, type, 4);
  if (len) std::memcpy(buf + *pos + 8, payload, len);
  put_u32be(buf + *pos + 8 + len, chunk_crc(buf + *pos + 4, 4 + len));
  *pos += 12 + len;
}

// Sum of |signed byte| over a buffer, as a plain reduction so that the
// compiler vectorizes it under -O3.
uint64_t abs_sum(const uint8_t *p, size_t n) {
  uint64_t s = 0;
  for (size_t x = 0; x < n; ++x) {
    const uint8_t b = p[x];
    s += b < 128 ? b : 256u - b;
  }
  return s;
}

// Filter one row into dst (1 filter byte + rowbytes), choosing among
// None, Sub and Up by the smallest sum (libpng's heuristic). prev is
// nullptr for the first row. Each candidate is built by its own
// branch-free loop so that -O3 vectorizes it.
void filter_row(const uint8_t *cur, const uint8_t *prev, size_t rowbytes,
                uint8_t *dst, uint8_t *scratch) {
  uint8_t *f_sub = scratch;
  uint8_t *f_up = scratch + rowbytes;

  f_sub[0] = cur[0];
  f_sub[1] = cur[1];
  f_sub[2] = cur[2];
  for (size_t x = 3; x < rowbytes; ++x) {
    f_sub[x] = static_cast<uint8_t>(cur[x] - cur[x - 3]);
  }
  const uint64_t s_sub = abs_sum(f_sub, rowbytes);
  const uint64_t s_none = abs_sum(cur, rowbytes);

  uint64_t s_up = ~0ULL;
  if (prev) {
    for (size_t x = 0; x < rowbytes; ++x) {
      f_up[x] = static_cast<uint8_t>(cur[x] - prev[x]);
    }
    s_up = abs_sum(f_up, rowbytes);
  }

  if (s_sub < s_none && s_sub <= s_up) {
    dst[0] = 1;
    std::memcpy(dst + 1, f_sub, rowbytes);
  } else if (s_up < s_none) {
    dst[0] = 2;
    std::memcpy(dst + 1, f_up, rowbytes);
  } else {
    dst[0] = 0;
    std::memcpy(dst + 1, cur, rowbytes);
  }
}

}  // namespace

extern "C" {

// The deflate backend this library was built with: 1 = libdeflate,
// 0 = zlib.
int fastpng_backend(void) {
#ifdef USE_LIBDEFLATE
  return 1;
#else
  return 0;
#endif
}

// Encode an interleaved RGB8 image (row-major, 3 * width bytes a row)
// into a complete PNG byte stream.
//
// Returns 0 on success and fills *out (malloc'd; the caller frees it
// with fastpng_free) and *out_len. A nonzero return is an error, and
// nothing is allocated then.
int fastpng_encode_rgb8(const uint8_t *rgb, int32_t width, int32_t height,
                        int32_t level, uint8_t **out, size_t *out_len) {
  if (!rgb || !out || !out_len || width <= 0 || height <= 0) return 1;
  if (level < 0 || level > 9) level = 2;

  const size_t rowbytes = static_cast<size_t>(width) * 3;
  const size_t raw_len = (rowbytes + 1) * static_cast<size_t>(height);

#ifdef USE_LIBDEFLATE
  // libdeflate takes zlib's levels 0..9 as they are (0 stores).
  struct libdeflate_compressor *comp = libdeflate_alloc_compressor(level);
  if (!comp) return 2;
  const size_t bound = libdeflate_zlib_compress_bound(comp, raw_len);
#else
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit(&zs, level) != Z_OK) return 2;
  const size_t bound = deflateBound(&zs, static_cast<uLong>(raw_len));
  // avail_out is a uInt: a bound past 4 GiB would wrap and truncate the
  // IDAT. No real frame comes close; fail loudly.
  if (bound > 0xffffffffu) {
    deflateEnd(&zs);
    return 7;
  }
#endif

  // Layout: 8 (signature) + 25 (IHDR) + [12 + bound] (IDAT) + 12 (IEND).
  uint8_t *buf = static_cast<uint8_t *>(std::malloc(8 + 25 + 12 + bound + 12));
  // Scratch: two candidate filtered rows (and the filtered image for the
  // whole-buffer backend).
  uint8_t *scratch = static_cast<uint8_t *>(std::malloc(2 * rowbytes));
#ifdef USE_LIBDEFLATE
  uint8_t *filtered = static_cast<uint8_t *>(std::malloc(raw_len));
#else
  uint8_t *filtered = static_cast<uint8_t *>(std::malloc(rowbytes + 1));
#endif
  if (!buf || !scratch || !filtered) {
    std::free(buf);
    std::free(scratch);
    std::free(filtered);
#ifdef USE_LIBDEFLATE
    libdeflate_free_compressor(comp);
#else
    deflateEnd(&zs);
#endif
    return 3;
  }

  size_t pos = 0;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::memcpy(buf, sig, 8);
  pos = 8;

  uint8_t ihdr[13];
  put_u32be(ihdr, static_cast<uint32_t>(width));
  put_u32be(ihdr + 4, static_cast<uint32_t>(height));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter method
  ihdr[12] = 0;  // no interlace
  append_chunk(buf, &pos, "IHDR", ihdr, 13);

  const size_t idat_payload_at = pos + 8;
  size_t idat_len = 0;

#ifdef USE_LIBDEFLATE
  for (int32_t y = 0; y < height; ++y) {
    const uint8_t *cur = rgb + static_cast<size_t>(y) * rowbytes;
    const uint8_t *prev =
        y ? rgb + static_cast<size_t>(y - 1) * rowbytes : nullptr;
    filter_row(cur, prev, rowbytes,
               filtered + static_cast<size_t>(y) * (rowbytes + 1), scratch);
  }
  idat_len = libdeflate_zlib_compress(comp, filtered, raw_len,
                                      buf + idat_payload_at, bound);
  libdeflate_free_compressor(comp);
  std::free(scratch);
  std::free(filtered);
  if (idat_len == 0) {
    std::free(buf);
    return 4;
  }
#else
  zs.next_out = buf + idat_payload_at;
  zs.avail_out = static_cast<uInt>(bound);
  int zrc = Z_OK;
  for (int32_t y = 0; y < height && zrc == Z_OK; ++y) {
    const uint8_t *cur = rgb + static_cast<size_t>(y) * rowbytes;
    const uint8_t *prev =
        y ? rgb + static_cast<size_t>(y - 1) * rowbytes : nullptr;
    filter_row(cur, prev, rowbytes, filtered, scratch);
    zs.next_in = filtered;
    zs.avail_in = static_cast<uInt>(rowbytes + 1);
    zrc = deflate(&zs, y + 1 == height ? Z_FINISH : Z_NO_FLUSH);
  }
  std::free(scratch);
  std::free(filtered);
  // Only Z_STREAM_END shows that the final Z_FINISH consumed everything;
  // stopping at Z_OK would report a truncated stream as a success.
  if (zrc != Z_STREAM_END) {
    std::free(buf);
    deflateEnd(&zs);
    return 4;
  }
  idat_len = static_cast<size_t>(zs.total_out);
  deflateEnd(&zs);
#endif

  // The IDAT's header and crc around the payload already written.
  put_u32be(buf + pos, static_cast<uint32_t>(idat_len));
  std::memcpy(buf + pos + 4, "IDAT", 4);
  put_u32be(buf + pos + 8 + idat_len, chunk_crc(buf + pos + 4, 4 + idat_len));
  pos += 12 + idat_len;

  append_chunk(buf, &pos, "IEND", nullptr, 0);

  *out = buf;
  *out_len = pos;
  return 0;
}

void fastpng_free(uint8_t *p) { std::free(p); }

// Encode and write to path in one write call. The video's resume
// protocol treats a missing or truncated frame as not completed, and
// progress.json is what makes a frame count as done, so a plain write
// is enough.
int fastpng_write_rgb8(const uint8_t *rgb, int32_t width, int32_t height,
                       int32_t level, const char *path) {
  uint8_t *out = nullptr;
  size_t out_len = 0;
  const int rc = fastpng_encode_rgb8(rgb, width, height, level, &out, &out_len);
  if (rc != 0) return rc;
  std::FILE *fh = std::fopen(path, "wb");
  if (!fh) {
    fastpng_free(out);
    return 5;
  }
  const size_t wrote = std::fwrite(out, 1, out_len, fh);
  const int close_rc = std::fclose(fh);
  fastpng_free(out);
  return (wrote == out_len && close_rc == 0) ? 0 : 6;
}

}  // extern "C"
