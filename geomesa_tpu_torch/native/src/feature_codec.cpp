// Native feature codec of the port: row-interleave / column-extract for
// the SFB (simple-feature-binary) format, the analog of the reference's
// Kryo serializer hot path (geomesa-features/.../kryo/
// KryoFeatureSerializer.scala, KryoBufferSimpleFeature.scala). A copy of
// the JAX package's source, byte-compatible with it: both packages read
// each other's blobs.
//
// Row layout (version 1, little-endian):
//   u8   version
//   u8[] null bitmap, ceil(n_attrs/8) bytes (bit set = non-null)
//   u32  offsets[n_attrs]   // payload-relative start of each attr
//   u8[] payload            // attr i spans [off[i], off[i+1]) where
//                           // off[n_attrs] == payload length
// Null attrs are zero-length. Lazy single-attribute access = read the
// offset table, jump, decode one cell (the KryoBufferSimpleFeature
// offset-table trick, without deserializing the rest of the row).
//
// Python (features/codec.py) prepares columnar inputs: fixed-width
// cells as contiguous arrays, var-width as bytes+offsets; this library
// does the per-row byte shuffling both directions. Its plain twins are
// FeatureCodec.encode_batch_plain and decode_attribute_plain.

#include <cstdint>
#include <cstring>

extern "C" {

// Exact blob size for a batch (python uses this to pre-allocate).
int64_t sfb_encoded_size(int32_t n_rows, int32_t n_attrs,
                         const uint8_t *kinds, const int32_t *widths,
                         const int64_t *const *var_offsets,
                         const uint8_t *const *valids) {
  const int32_t bitmap = (n_attrs + 7) / 8;
  const int64_t header = 1 + bitmap + 4LL * n_attrs;
  int64_t total = header * n_rows;
  for (int32_t a = 0; a < n_attrs; ++a) {
    const uint8_t *valid = valids[a];
    if (kinds[a] == 0) {
      const int64_t w = widths[a];
      for (int32_t r = 0; r < n_rows; ++r)
        if (valid[r]) total += w;
    } else {
      const int64_t *off = var_offsets[a];
      for (int32_t r = 0; r < n_rows; ++r)
        if (valid[r]) total += off[r + 1] - off[r];
    }
  }
  return total;
}

// Interleave columns into row buffers. Returns bytes written, or -1 on
// overflow of `out_cap`. row_offsets gets n_rows+1 entries.
int64_t sfb_encode_batch(int32_t n_rows, int32_t n_attrs,
                         const uint8_t *kinds, const int32_t *widths,
                         const uint8_t *const *fixed_data,
                         const uint8_t *const *var_data,
                         const int64_t *const *var_offsets,
                         const uint8_t *const *valids, uint8_t *out,
                         int64_t out_cap, int64_t *row_offsets) {
  const int32_t bitmap_len = (n_attrs + 7) / 8;
  const int64_t header = 1 + bitmap_len + 4LL * n_attrs;
  int64_t pos = 0;
  for (int32_t r = 0; r < n_rows; ++r) {
    row_offsets[r] = pos;
    if (pos + header > out_cap) return -1;
    uint8_t *row = out + pos;
    row[0] = 1;  // version
    uint8_t *bm = row + 1;
    std::memset(bm, 0, bitmap_len);
    uint32_t *offs = reinterpret_cast<uint32_t *>(row + 1 + bitmap_len);
    uint8_t *payload = row + header;
    uint32_t ppos = 0;
    for (int32_t a = 0; a < n_attrs; ++a) {
      offs[a] = ppos;
      if (!valids[a][r]) continue;
      bm[a >> 3] |= uint8_t(1u << (a & 7));
      if (kinds[a] == 0) {
        const int32_t w = widths[a];
        if (pos + header + ppos + w > out_cap) return -1;
        std::memcpy(payload + ppos, fixed_data[a] + int64_t(r) * w, w);
        ppos += w;
      } else {
        const int64_t *off = var_offsets[a];
        const int64_t len = off[r + 1] - off[r];
        if (pos + header + ppos + len > out_cap) return -1;
        std::memcpy(payload + ppos, var_data[a] + off[r], len);
        ppos += uint32_t(len);
      }
    }
    pos += header + ppos;
  }
  row_offsets[n_rows] = pos;
  return pos;
}

static inline const uint8_t *row_payload(const uint8_t *row, int32_t n_attrs,
                                         int32_t bitmap_len, int32_t attr,
                                         uint32_t *start, uint32_t *end,
                                         int64_t row_len, bool *valid) {
  const uint8_t *bm = row + 1;
  *valid = (bm[attr >> 3] >> (attr & 7)) & 1;
  const uint32_t *offs =
      reinterpret_cast<const uint32_t *>(row + 1 + bitmap_len);
  const int64_t header = 1 + bitmap_len + 4LL * n_attrs;
  *start = offs[attr];
  *end = (attr + 1 < n_attrs) ? offs[attr + 1]
                              : uint32_t(row_len - header);
  return row + header;
}

// Extract one fixed-width attribute column. out_vals must hold
// n_rows*width bytes (null rows left zeroed); out_valid n_rows bytes.
int64_t sfb_decode_fixed(const uint8_t *blob, const int64_t *row_offsets,
                         int32_t n_rows, int32_t n_attrs, int32_t attr,
                         int32_t width, uint8_t *out_vals,
                         uint8_t *out_valid) {
  const int32_t bitmap_len = (n_attrs + 7) / 8;
  for (int32_t r = 0; r < n_rows; ++r) {
    const uint8_t *row = blob + row_offsets[r];
    uint32_t s, e;
    bool valid;
    const uint8_t *payload =
        row_payload(row, n_attrs, bitmap_len, attr, &s, &e,
                    row_offsets[r + 1] - row_offsets[r], &valid);
    out_valid[r] = valid ? 1 : 0;
    if (valid) {
      if (int32_t(e - s) != width) return -1;
      std::memcpy(out_vals + int64_t(r) * width, payload + s, width);
    }
  }
  return n_rows;
}

// Pass 1 for var-width extraction: per-row byte lengths (0 for null).
int64_t sfb_decode_varlen_sizes(const uint8_t *blob,
                                const int64_t *row_offsets, int32_t n_rows,
                                int32_t n_attrs, int32_t attr,
                                int64_t *out_lens, uint8_t *out_valid) {
  const int32_t bitmap_len = (n_attrs + 7) / 8;
  int64_t total = 0;
  for (int32_t r = 0; r < n_rows; ++r) {
    const uint8_t *row = blob + row_offsets[r];
    uint32_t s, e;
    bool valid;
    row_payload(row, n_attrs, bitmap_len, attr, &s, &e,
                row_offsets[r + 1] - row_offsets[r], &valid);
    out_valid[r] = valid ? 1 : 0;
    out_lens[r] = valid ? (e - s) : 0;
    total += out_lens[r];
  }
  return total;
}

// Pass 2: copy var-width cells into a concatenated buffer at out_offsets.
int64_t sfb_decode_varlen(const uint8_t *blob, const int64_t *row_offsets,
                          int32_t n_rows, int32_t n_attrs, int32_t attr,
                          const int64_t *out_offsets, uint8_t *out_bytes) {
  const int32_t bitmap_len = (n_attrs + 7) / 8;
  for (int32_t r = 0; r < n_rows; ++r) {
    const uint8_t *row = blob + row_offsets[r];
    uint32_t s, e;
    bool valid;
    const uint8_t *payload =
        row_payload(row, n_attrs, bitmap_len, attr, &s, &e,
                    row_offsets[r + 1] - row_offsets[r], &valid);
    if (valid && e > s)
      std::memcpy(out_bytes + out_offsets[r], payload + s, e - s);
  }
  return n_rows;
}

}  // extern "C"
