// atlas_tiff.cc — self-contained TIFF / Aperio-SVS pyramid decoder.
//
// The host I/O plane of the framework (SURVEY.md §7 item 1): replaces the
// reference's OpenSlide dependency with first-party native code. Parses the
// TIFF container directly (classic + BigTIFF, both byte orders), enumerates
// pyramid levels, and decodes tiles/strips with:
//   * JPEG (compression 7, incl. abbreviated streams via JPEGTables) — libjpeg
//   * Deflate (8 / 32946) — zlib, with TIFF predictor 2
//   * LZW (5) — own implementation, with predictor 2
//   * PackBits (32773) and uncompressed (1)
//   * JPEG2000 (Aperio 33003 YCbCr / 33005 RGB, plus standard 34712) —
//     openjpeg via dlopen (atlas_j2k.cc); clean error if the lib is absent
//
// Thread safety: handles are immutable after open; reads use pread(2); every
// decode uses local codec state — safe for concurrent region reads from
// Python threads (the GIL is released during ctypes calls).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC atlas_tiff.cc atlas_j2k.cc
//        -o libatlas_tiff.so -ljpeg -lz -ldl
// (atlaspatch_tpu_torch/io/native.py; where the system has no libjpeg headers
// it compiles against vendor/libjpeg/ and links Pillow's bundled libjpeg).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include <jpeglib.h>
#include <csetjmp>
#include <zlib.h>

// atlas_j2k.cc — openjpeg-backed JPEG2000 decode (dlopen'd at first use)
bool j2k_decode(const uint8_t* src, size_t n, uint8_t* out, uint64_t cw,
                uint64_t ch, uint32_t spp, bool force_ycbcr, std::string* err);

namespace {

// ---------------------------------------------------------------- low level IO
struct FileReader {
  int fd = -1;
  uint64_t size = 0;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    off_t end = ::lseek(fd, 0, SEEK_END);
    if (end < 0) return false;
    size = static_cast<uint64_t>(end);
    return true;
  }
  ~FileReader() {
    if (fd >= 0) ::close(fd);
  }
  bool read_at(uint64_t off, void* dst, size_t n) const {
    size_t done = 0;
    while (done < n) {
      ssize_t r = ::pread(fd, static_cast<char*>(dst) + done, n - done, off + done);
      if (r <= 0) return false;
      done += static_cast<size_t>(r);
    }
    return true;
  }
};

struct ByteOrder {
  bool little = true;
  uint16_t u16(const uint8_t* p) const {
    return little ? (uint16_t)(p[0] | p[1] << 8) : (uint16_t)(p[1] | p[0] << 8);
  }
  uint32_t u32(const uint8_t* p) const {
    return little ? (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                        (uint32_t)p[3] << 24
                  : (uint32_t)p[3] | (uint32_t)p[2] << 8 | (uint32_t)p[1] << 16 |
                        (uint32_t)p[0] << 24;
  }
  uint64_t u64(const uint8_t* p) const {
    uint64_t lo, hi;
    if (little) {
      lo = u32(p);
      hi = u32(p + 4);
    } else {
      hi = u32(p);
      lo = u32(p + 4);
    }
    return lo | (hi << 32);
  }
};

// ------------------------------------------------------------------- tag model
enum Tag : uint16_t {
  kWidth = 256,
  kHeight = 257,
  kBits = 258,
  kCompression = 259,
  kPhotometric = 262,
  kDescription = 270,
  kStripOffsets = 273,
  kSamplesPerPixel = 277,
  kRowsPerStrip = 278,
  kStripByteCounts = 279,
  kXResolution = 282,
  kYResolution = 283,
  kPlanarConfig = 284,
  kResolutionUnit = 296,
  kPredictor = 317,
  kTileWidth = 322,
  kTileHeight = 323,
  kTileOffsets = 324,
  kTileByteCounts = 325,
  kColorMap = 320,
  kSubIFDs = 330,  // reduced-resolution pyramid levels (OME-TIFF/libvips layout)
  kJPEGTables = 347,
  kSoftware = 305,
  kXMP = 700,  // XML packet; Ventana BIF stores the iScan element here
};

// Vendor private tags (Hamamatsu NDPI; see openslide.org/formats/hamamatsu
// and the ndpitools NDPI format notes — values re-derived, no code reused).
enum VendorTag : uint16_t {
  kNdpiMagic = 65420,       // present on every IFD of an NDPI file
  kNdpiSourceLens = 65421,  // objective power; -1 = macro image, -2 = map
  kNdpiZOffset = 65422,     // z-plane offset in nm; we expose the z=0 plane
};

struct Entry {
  uint16_t type = 0;
  uint64_t count = 0;
  std::vector<uint8_t> data;  // raw value bytes (already fetched)
};

static size_t type_size(uint16_t type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;   // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                    // SHORT
    case 4: case 9: case 11: case 13: return 4;  // LONG/SLONG/FLOAT/IFD
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

struct IFD {
  std::map<uint16_t, Entry> entries;
  uint64_t width = 0, height = 0;
  uint32_t compression = 1, photometric = 2, spp = 3, planar = 1, predictor = 1;
  uint64_t tile_w = 0, tile_h = 0, rows_per_strip = 0;
  std::vector<uint64_t> chunk_offsets, chunk_counts;
  std::string description;
  std::string software;
  std::string xmp;
  bool tiled = false;
  bool bits8 = true;  // every BitsPerSample value is 8 (tag absent = 8)
  int sub_of = -1;  // index of the main-chain IFD this SubIFD belongs to
  std::vector<uint8_t> palette;  // 768-byte RGB lookup (photometric 3 only)
  std::vector<uint8_t> jpeg_tables;
  double x_resolution = 0.0, y_resolution = 0.0;
  uint32_t resolution_unit = 2;

  bool has(uint16_t tag) const { return entries.count(tag) != 0; }

  uint64_t scalar(const ByteOrder& bo, uint16_t tag, uint64_t fallback = 0) const {
    auto it = entries.find(tag);
    if (it == entries.end() || it->second.count == 0) return fallback;
    const Entry& e = it->second;
    const uint8_t* p = e.data.data();
    switch (e.type) {
      case 1: return p[0];
      case 3: return bo.u16(p);
      case 4: return bo.u32(p);
      case 16: return bo.u64(p);
      default: return fallback;
    }
  }

  std::vector<uint64_t> array(const ByteOrder& bo, uint16_t tag) const {
    std::vector<uint64_t> out;
    auto it = entries.find(tag);
    if (it == entries.end()) return out;
    const Entry& e = it->second;
    size_t ts = type_size(e.type);
    for (uint64_t i = 0; i < e.count; ++i) {
      const uint8_t* p = e.data.data() + i * ts;
      switch (e.type) {
        case 3: out.push_back(bo.u16(p)); break;
        case 4: case 13: out.push_back(bo.u32(p)); break;  // LONG / IFD
        case 16: case 18: out.push_back(bo.u64(p)); break;  // LONG8 / IFD8
        default: out.push_back(0); break;
      }
    }
    return out;
  }

  // Read a possibly-signed numeric tag (NDPI SourceLens is FLOAT and can be
  // negative). Returns false when the tag is absent or of a non-numeric type.
  bool signed_double(const ByteOrder& bo, uint16_t tag, double* out) const {
    auto it = entries.find(tag);
    if (it == entries.end() || it->second.count == 0) return false;
    const Entry& e = it->second;
    if (e.data.size() < type_size(e.type)) return false;  // defensive
    const uint8_t* p = e.data.data();
    switch (e.type) {
      case 1: *out = p[0]; return true;
      case 3: *out = bo.u16(p); return true;
      case 4: *out = bo.u32(p); return true;
      case 8: *out = (int16_t)bo.u16(p); return true;
      case 9: *out = (int32_t)bo.u32(p); return true;
      case 5: {
        uint32_t num = bo.u32(p), den = bo.u32(p + 4);
        if (!den) return false;
        *out = (double)num / den;
        return true;
      }
      case 10: {
        int32_t num = (int32_t)bo.u32(p), den = (int32_t)bo.u32(p + 4);
        if (!den) return false;
        *out = (double)num / den;
        return true;
      }
      case 11: {
        uint32_t bits = bo.u32(p);
        float f;
        std::memcpy(&f, &bits, 4);
        *out = f;
        return true;
      }
      case 12: {
        uint64_t bits = bo.u64(p);
        double d;
        std::memcpy(&d, &bits, 8);
        *out = d;
        return true;
      }
      default: return false;
    }
  }

  double rational(const ByteOrder& bo, uint16_t tag) const {
    auto it = entries.find(tag);
    // Size, not just type: a RATIONAL entry with a corrupt count of 0 holds
    // no data and reading 8 bytes from it was a fuzz-found segfault.
    if (it == entries.end() || it->second.type != 5 ||
        it->second.data.size() < 8)
      return 0.0;
    const uint8_t* p = it->second.data.data();
    uint32_t num = bo.u32(p), den = bo.u32(p + 4);
    return den ? (double)num / den : 0.0;
  }
};

// ------------------------------------------------------------------- decoders
static bool unpackbits(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t si = 0, di = 0;
  while (si < n && di < cap) {
    int8_t c = static_cast<int8_t>(src[si++]);
    if (c >= 0) {
      size_t cnt = static_cast<size_t>(c) + 1;
      if (si + cnt > n || di + cnt > cap) return false;
      std::memcpy(dst + di, src + si, cnt);
      si += cnt;
      di += cnt;
    } else if (c != -128) {
      size_t cnt = static_cast<size_t>(-c) + 1;
      if (si >= n || di + cnt > cap) return false;
      std::memset(dst + di, src[si++], cnt);
      di += cnt;
    }
  }
  return di == cap;
}

// TIFF LZW: MSB-first variable-width codes, early-change convention.
static bool lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  constexpr int kClear = 256, kEOI = 257;
  struct Str { int prev; uint8_t ch; uint16_t len; };
  std::vector<Str> table(4096);
  for (int i = 0; i < 256; ++i) table[i] = {-1, static_cast<uint8_t>(i), 1};
  int next_code = 258, code_bits = 9;
  uint64_t bitbuf = 0;
  int bits = 0;
  size_t si = 0, di = 0;
  int prev_code = -1;
  std::vector<uint8_t> scratch(4096);

  auto emit = [&](int code) -> int {
    int len = table[code].len;
    if (di + static_cast<size_t>(len) > cap) return -1;
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      scratch[i] = table[c].ch;
      c = table[c].prev;
    }
    std::memcpy(dst + di, scratch.data(), len);
    di += static_cast<size_t>(len);
    return table[code].len;
  };

  while (true) {
    while (bits < code_bits) {
      if (si >= n) return di == cap;
      bitbuf = (bitbuf << 8) | src[si++];
      bits += 8;
    }
    int code = static_cast<int>((bitbuf >> (bits - code_bits)) & ((1u << code_bits) - 1));
    bits -= code_bits;
    if (code == kEOI) return di == cap;
    if (code == kClear) {
      next_code = 258;
      code_bits = 9;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      if (code >= 256) return false;
      if (emit(code) < 0) return false;
      prev_code = code;
      continue;
    }
    if (code < next_code) {
      int start = static_cast<int>(di);
      if (emit(code) < 0) return false;
      if (next_code < 4096) {
        table[next_code] = {prev_code, dst[start],
                            static_cast<uint16_t>(table[prev_code].len + 1)};
        ++next_code;
      }
    } else if (code == next_code && next_code < 4096) {
      // KwKwK case
      uint8_t first;
      {
        int c = prev_code;
        while (table[c].prev >= 0) c = table[c].prev;
        first = table[c].ch;
      }
      table[next_code] = {prev_code, first,
                          static_cast<uint16_t>(table[prev_code].len + 1)};
      ++next_code;
      if (emit(code) < 0) return false;
    } else {
      return false;
    }
    prev_code = code;
    if (next_code == (1 << code_bits) - 1 && code_bits < 12) ++code_bits;
    if (di >= cap) return true;
  }
}

static bool zlib_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  uLongf out_len = cap;
  return uncompress(dst, &out_len, src, n) == Z_OK && out_len == cap;
}

static void apply_predictor2(uint8_t* row, uint64_t width, uint32_t spp) {
  for (uint64_t x = 1; x < width; ++x)
    for (uint32_t c = 0; c < spp; ++c) row[x * spp + c] += row[(x - 1) * spp + c];
}

// libjpeg error handling without exit()
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

static bool jpeg_decode_rgb(const std::vector<uint8_t>& tables, const uint8_t* data,
                            size_t n, uint8_t* dst, uint64_t w, uint64_t h,
                            uint32_t want_spp, unsigned scale_denom = 1) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (!tables.empty()) {
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(tables.data()),
                 static_cast<unsigned long>(tables.size()));
    jpeg_read_header(&cinfo, FALSE);
  }
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (want_spp == 1) ? JCS_GRAYSCALE : JCS_RGB;
  // IDCT-domain downscale: 1/2, 1/4, 1/8 decode almost for free (smaller
  // inverse DCT + fewer output pixels), used by the thumbnail fast path.
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width > w || cinfo.output_height > h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  uint32_t comps = cinfo.output_components;
  std::vector<uint8_t> rowbuf(cinfo.output_width * comps);
  JSAMPROW rowptr = rowbuf.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    uint32_t y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    std::memcpy(dst + (uint64_t)y * w * comps, rowbuf.data(), rowbuf.size());
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// --- NDPI giant-JPEG striped decode ----------------------------------------
// Hamamatsu NDPI stores each pyramid level as ONE whole-image JPEG strip.
// Beyond 65,535 px the true dimensions cannot be expressed in the SOF marker
// (16-bit fields; writers emit 0 or wrapped values), and a whole-image decode
// would need a W*H*3 buffer regardless. NDPI streams carry restart markers,
// which reset the entropy coder and DC predictors — every restart segment is
// independently decodable. We index segment boundaries once per IFD, then
// decode only the segments covering a requested window by synthesizing a
// mini-JPEG per segment (copied headers, SOF patched to the segment
// rectangle, DRI dropped). Pixels are bit-identical to a full decode for
// 4:4:4 streams; 4:2:0 chroma interpolation can differ by a few LSBs along
// segment boundaries (fancy upsampling has no cross-segment neighbors).
// Format background: openslide.org/formats/hamamatsu (re-derived, no code
// reused). Replaces OpenSlide for the reference's .ndpi coverage
// (reference: atlas_patch/core/wsi/wsi_factory.py:20-39).
struct JpegStripeIndex {
  bool usable = false;   // header parsed AND segment geometry viable
  bool scanned = false;  // entropy segments enumerated (lazy; see below)
  bool sof_seen = false;  // a baseline SOF was parsed (hdr dims are real)
  bool seq_ok = false;   // header + entropy span usable for sequential decode
  std::string reason;
  uint64_t hdr_w = 0, hdr_h = 0;  // dims as declared in the SOF marker
  std::vector<uint8_t> header;    // SOI..SOS inclusive, DRI removed
  size_t sof_dims_off = 0;        // offset of the big-endian h,w pair in header
  size_t sos_off = 0;             // offset of the SOS segment in header
  uint32_t dri = 0;               // restart interval declared by the stream
  uint64_t mcu_w = 8, mcu_h = 8;
  uint64_t seg_px_w = 0, seg_px_h = 0;  // segment rectangle (clamped at edges)
  uint64_t segs_per_row = 1;            // segments per MCU-row band
  uint64_t expected_segs = 0;
  uint64_t entropy_start = 0, entropy_end = 0;      // file offsets
  std::vector<std::pair<uint64_t, uint64_t>> segs;  // (file offset, length)
};

// Stream through entropy-coded data splitting at restart markers; stops at
// the first true marker (EOI, DNL, ...). Byte-stuffed 0xFF00 and 0xFFFF fill
// runs are skipped.
static bool stripe_scan_entropy(const FileReader& file, uint64_t off, uint64_t end,
                                std::vector<std::pair<uint64_t, uint64_t>>* segs) {
  std::vector<uint8_t> buf(4u << 20);
  uint64_t seg_start = off;
  uint64_t pos = off;
  bool pending_ff = false;
  while (pos < end) {
    size_t n = (size_t)std::min<uint64_t>(buf.size(), end - pos);
    if (!file.read_at(pos, buf.data(), n)) return false;
    for (size_t i = 0; i < n; ++i) {
      uint8_t b = buf[i];
      if (pending_ff) {
        if (b == 0xFF) continue;  // fill byte; stay armed
        pending_ff = false;
        if (b == 0x00) continue;  // stuffed data byte
        uint64_t marker_at = pos + i - 1;
        if (marker_at < off) marker_at = off;  // FF at previous buffer tail
        if (b >= 0xD0 && b <= 0xD7) {          // restart marker
          segs->push_back({seg_start, marker_at - seg_start});
          seg_start = marker_at + 2;
          continue;
        }
        segs->push_back({seg_start, marker_at - seg_start});
        return true;  // EOI/DNL/any true marker: entropy data ends here
      }
      if (b == 0xFF) pending_ff = true;
    }
    pos += n;
  }
  if (seg_start < end) segs->push_back({seg_start, end - seg_start});
  return true;
}

static void build_stripe_index(const FileReader& file, const IFD& d,
                               JpegStripeIndex* si) {
  si->usable = false;
  uint64_t off = d.chunk_offsets.empty() ? 0 : d.chunk_offsets[0];
  uint64_t len = d.chunk_counts.empty() ? 0 : d.chunk_counts[0];
  if (len < 4) {
    si->reason = "empty strip";
    return;
  }
  // Headers sit at the front; 1 MiB is far beyond any real table set.
  std::vector<uint8_t> head((size_t)std::min<uint64_t>(len, 1u << 20));
  if (!file.read_at(off, head.data(), head.size())) {
    si->reason = "read failed";
    return;
  }
  if (head[0] != 0xFF || head[1] != 0xD8) {
    si->reason = "not a JPEG stream";
    return;
  }
  std::vector<uint8_t>& hdr = si->header;
  hdr.assign({0xFF, 0xD8});
  uint32_t dri = 0;
  uint64_t max_h = 1, max_v = 1;
  size_t p = 2;
  uint64_t entropy_start = 0;
  while (p + 4 <= head.size()) {
    if (head[p] != 0xFF) {
      si->reason = "bad marker structure";
      return;
    }
    uint8_t m = head[p + 1];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      p += 2;
      continue;
    }
    uint16_t seglen = (uint16_t)((head[p + 2] << 8) | head[p + 3]);
    if (seglen < 2 || p + 2 + seglen > head.size()) {
      si->reason = "truncated JPEG header";
      return;
    }
    const uint8_t* seg = head.data() + p;
    size_t total = 2 + (size_t)seglen;
    if (m == 0xC0 || m == 0xC1) {  // baseline SOF
      si->sof_seen = true;
      si->sof_dims_off = hdr.size() + 5;  // after FF Cx len16 precision8
      si->hdr_h = (uint64_t)((seg[5] << 8) | seg[6]);
      si->hdr_w = (uint64_t)((seg[7] << 8) | seg[8]);
      uint8_t ncomp = seg[9];
      for (uint8_t c = 0; c < ncomp && 10 + 3 * (size_t)c + 1 < total; ++c) {
        uint8_t hv = seg[10 + 3 * (size_t)c + 1];
        max_h = std::max<uint64_t>(max_h, hv >> 4);
        max_v = std::max<uint64_t>(max_v, hv & 0xF);
      }
      hdr.insert(hdr.end(), seg, seg + total);
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA) {
      si->reason = "non-baseline JPEG";
      return;
    } else if (m == 0xDD) {  // DRI: record, drop from the per-segment header
      if (seglen >= 4) dri = (uint32_t)((seg[4] << 8) | seg[5]);
    } else if (m == 0xDA) {  // SOS: header complete, entropy follows
      si->sos_off = hdr.size();
      hdr.insert(hdr.end(), seg, seg + total);
      entropy_start = off + p + total;
      break;
    } else {
      hdr.insert(hdr.end(), seg, seg + total);
    }
    p += total;
  }
  if (!entropy_start) {
    si->reason = "no SOS marker in the first MiB";
    return;
  }
  if (!si->sof_dims_off) {
    si->reason = "no SOF marker";
    return;
  }
  // Header + entropy span are enough for the sequential (row-capped)
  // fallback even when restart-marker striping is impossible below. The
  // DRI value is kept so the fallback can re-insert it: sequential decode
  // consumes the WHOLE entropy stream, restart markers included.
  si->mcu_w = 8 * max_h;
  si->mcu_h = 8 * max_v;
  si->entropy_start = entropy_start;
  si->entropy_end = off + len;
  si->dri = dri;
  si->seq_ok = true;
  if (!dri) {
    si->reason = "no restart interval";
    return;
  }
  uint64_t mcus_per_row = (d.width + si->mcu_w - 1) / si->mcu_w;
  if (mcus_per_row == 0) {
    si->reason = "zero-width image";
    return;
  }
  if (dri % mcus_per_row == 0) {  // each segment spans whole MCU rows
    si->segs_per_row = 1;
    si->seg_px_w = d.width;
    si->seg_px_h = (dri / mcus_per_row) * si->mcu_h;
  } else if (mcus_per_row % dri == 0) {  // several segments per MCU row
    si->segs_per_row = mcus_per_row / dri;
    si->seg_px_w = (uint64_t)dri * si->mcu_w;
    si->seg_px_h = si->mcu_h;
  } else {
    si->reason = "restart interval not MCU-row aligned";
    return;
  }
  if (si->seg_px_w > 65535 || si->seg_px_h > 65535) {
    si->reason = "segment rectangle exceeds JPEG dimensions";
    return;
  }
  if (si->seg_px_w * si->seg_px_h * 3 > (256ull << 20)) {
    si->reason = "segment too large";
    return;
  }
  uint64_t bands = (d.height + si->seg_px_h - 1) / si->seg_px_h;
  si->expected_segs = bands * si->segs_per_row;
  si->entropy_start = entropy_start;
  si->entropy_end = off + len;
  si->usable = true;  // geometry viable; segments enumerate lazily on use
}

// Enumerate the restart segments (the expensive full-strip scan) — called
// only once striping is actually chosen for an IFD. When the declared strip
// byte count undercounts (NDPI >4 GiB files wrap StripByteCounts the same
// way they wrap offsets), rescan to the end of the file: the scan stops at
// the first true marker (EOI), so a generous window stays correct.
static bool scan_stripe_segments(const FileReader& file, JpegStripeIndex* si) {
  if (si->scanned) return si->usable;
  si->scanned = true;
  if (!stripe_scan_entropy(file, si->entropy_start, si->entropy_end, &si->segs)) {
    si->usable = false;
    si->reason = "entropy scan failed";
    return false;
  }
  if (si->segs.size() < si->expected_segs && si->entropy_end < file.size) {
    si->segs.clear();
    if (!stripe_scan_entropy(file, si->entropy_start, file.size, &si->segs)) {
      si->usable = false;
      si->reason = "entropy scan failed";
      return false;
    }
  }
  if (si->segs.size() < si->expected_segs) {
    si->usable = false;
    si->reason = "restart segment count mismatch";
    return false;
  }
  si->segs.resize(si->expected_segs);
  return true;
}

// --- sequential (row-capped) fallback for streams without usable restarts ----
// A libjpeg source manager that serves (1) the rebuilt header with patched SOF
// dims, then (2) entropy bytes streamed from the file in bounded chunks, then
// (3) a synthetic EOI. Lets a giant single-JPEG level decode top-down without
// ever materializing the whole strip, stopping after the rows a window needs.
struct StreamJpegSrc {
  jpeg_source_mgr mgr;
  const FileReader* file = nullptr;
  uint64_t pos = 0, end = 0;
  std::vector<uint8_t> chunk;
  const std::vector<uint8_t>* header = nullptr;
  int state = 0;  // 0 = serve header, 1 = stream entropy, 2 = EOI served
  bool io_error = false;
};

static void stream_src_init(j_decompress_ptr) {}
static void stream_src_term(j_decompress_ptr) {}

static boolean stream_src_fill(j_decompress_ptr cinfo) {
  static const uint8_t kEOI[2] = {0xFF, 0xD9};
  auto* s = reinterpret_cast<StreamJpegSrc*>(cinfo->src);
  if (s->state == 0) {
    s->state = 1;
    s->mgr.next_input_byte = s->header->data();
    s->mgr.bytes_in_buffer = s->header->size();
    return TRUE;
  }
  if (s->state == 1 && s->pos < s->end) {
    size_t n = (size_t)std::min<uint64_t>(s->chunk.size(), s->end - s->pos);
    if (!s->file->read_at(s->pos, s->chunk.data(), n)) {
      s->io_error = true;
      s->state = 2;
    } else {
      s->pos += n;
      s->mgr.next_input_byte = s->chunk.data();
      s->mgr.bytes_in_buffer = n;
      return TRUE;
    }
  }
  s->state = 2;
  s->mgr.next_input_byte = kEOI;
  s->mgr.bytes_in_buffer = 2;
  return TRUE;
}

static void stream_src_skip(j_decompress_ptr cinfo, long num_bytes) {
  auto* s = reinterpret_cast<StreamJpegSrc*>(cinfo->src);
  while (num_bytes > 0) {
    if ((size_t)num_bytes <= s->mgr.bytes_in_buffer) {
      s->mgr.next_input_byte += num_bytes;
      s->mgr.bytes_in_buffer -= num_bytes;
      return;
    }
    num_bytes -= (long)s->mgr.bytes_in_buffer;
    s->mgr.bytes_in_buffer = 0;
    stream_src_fill(cinfo);
  }
}

// Decode rows [y0,y1) × cols [x0,x1) of a single-strip JPEG without restart
// markers by streaming a sequential top-down decode capped at y1 (SOF height
// patched down so libjpeg stops exactly at the last needed MCU row). Matches
// OpenSlide's ability to open such files (the reference relies on it via
// openslide_wsi.py:198); whole-strip decode would need W*H*3 bytes.
struct AtlasTiff;
static bool read_region_jpeg_sequential(const AtlasTiff* t, const IFD& d,
                                        const JpegStripeIndex& si, int64_t x,
                                        int64_t y, int64_t w, int64_t x0,
                                        int64_t y0, int64_t x1, int64_t y1,
                                        uint8_t* out, std::string* err);

// --------------------------------------------------------------------- handle
struct Level {
  size_t ifd_index;
  uint64_t width, height;
  double downsample;
  // Ventana BIF AOI join-overlap correction: when > 0, the level's tiles
  // overlap and tile (c, r) is painted at (round(c*adv_x), round(r*adv_y))
  // instead of (c*tile_w, r*tile_h); width/height above are the corrected
  // (stitched) canvas, smaller than the IFD's declared dimensions.
  double adv_x = 0.0, adv_y = 0.0;
};

struct AtlasTiff {
  FileReader file;
  ByteOrder bo;
  bool bigtiff = false;
  std::vector<IFD> ifds;
  std::vector<Level> levels;
  std::string properties_json;
  std::string error;
  bool ndpi = false;           // Hamamatsu NDPI container (tag 65420 on IFD0)
  double ndpi_lens0 = 0.0;     // SourceLens of the base level (objective power)
  bool scn = false;            // Leica SCN container (XML collection on IFD0)
  double scn_objective = 0.0;  // <objective> of the selected main image
  bool ventana = false;        // Ventana/Roche BIF (iScan element in XMP)
  double ventana_mag = 0.0;    // iScan Magnification attribute
  double ventana_scanres = 0.0;  // iScan ScanRes attribute (µm/pixel)
  double ventana_overlap_x = 0.0;  // mean RIGHT-joint overlap (px, level 0)
  double ventana_overlap_y = 0.0;  // mean UP-joint overlap (px, level 0)
  long ventana_joints = 0;         // TileJointInfo elements accepted
  bool philips = false;        // Philips TIFF (Software tag "Philips …")
  double philips_mpp = 0.0;    // DICOM_PIXEL_SPACING from the UFS XML (µm)
  bool trestle = false;        // Trestle .tif (Software tag "MedScan")
  // OverlapsXY pairs from IFD0's ImageDescription: (x, y) per level in file
  // order, each in that level's own pixel scale (openslide.org/formats/trestle).
  std::vector<uint32_t> trestle_overlaps;
  double trestle_objective = 0.0;  // "Objective Power" key (magnification)
  mutable std::mutex stripe_mu;
  mutable std::map<size_t, std::unique_ptr<JpegStripeIndex>> stripe_cache;

  // Decoded-chunk LRU cache, byte-capped. OpenSlide keeps an equivalent
  // (32 MB default) and the reference pipeline leans on it: patch-grid
  // region reads at unaligned offsets cover up to 4 tiles each, so without
  // a cache every JPEG tile is entropy-decoded up to ~4x per slide.
  // ATLASPATCH_TIFF_CACHE_MB overrides the cap (0 disables).
  struct ChunkCache {
    std::mutex mu;
    std::list<uint64_t> lru;  // front = most recently used
    struct Entry {
      // shared_ptr so hits can copy OUTSIDE the lock (readers keep evicted
      // buffers alive); the mutex guards only map/list/bytes bookkeeping.
      std::shared_ptr<const std::vector<uint8_t>> data;
      std::list<uint64_t>::iterator pos;
    };
    std::map<uint64_t, Entry> map;
    size_t bytes = 0;
    size_t cap = []() -> size_t {
      if (const char* e = std::getenv("ATLASPATCH_TIFF_CACHE_MB")) {
        char* end = nullptr;
        unsigned long long v = std::strtoull(e, &end, 10);
        if (end != e) return (size_t)v << 20;
      }
      return (size_t)32 << 20;
    }();
  };
  mutable ChunkCache chunk_cache;

  const IFD& level_ifd(int level) const { return ifds[levels[level].ifd_index]; }

  // Lazily built, cached per IFD; thread-safe (region reads come from the
  // host prep thread pools concurrently). Builds the cheap header probe
  // only; callers run scan_stripe_segments under stripe_mu when striping
  // is actually chosen.
  JpegStripeIndex* stripe_index(size_t ifd_index) const {
    std::lock_guard<std::mutex> g(stripe_mu);
    auto it = stripe_cache.find(ifd_index);
    if (it == stripe_cache.end()) {
      auto si = std::make_unique<JpegStripeIndex>();
      build_stripe_index(file, ifds[ifd_index], si.get());
      it = stripe_cache.emplace(ifd_index, std::move(si)).first;
    }
    return it->second.get();
  }

  // Decode chunk `idx` of an IFD into an spp-interleaved buffer of
  // chunk_w × chunk_h (the IFD's tile box, or strip box for striped images).
  bool decode_chunk(const IFD& d, uint64_t idx, uint8_t* out, uint64_t cw,
                    uint64_t ch, std::string* err) const {
    if (idx >= d.chunk_offsets.size()) {
      *err = "chunk index out of range";
      return false;
    }
    uint64_t off = d.chunk_offsets[idx];
    uint64_t n = idx < d.chunk_counts.size() ? d.chunk_counts[idx] : 0;
    if (n == 0) {  // missing tile ⇒ white
      std::memset(out, 255, cw * ch * d.spp);
      return true;
    }
    if (off >= file.size || n > file.size - off) {
      // Validate BEFORE allocating: a corrupt byte count would zero-init
      // gigabytes here just to have the read fail anyway.
      *err = "chunk extends past end of file";
      return false;
    }
    std::vector<uint8_t> raw(n);
    if (!file.read_at(off, raw.data(), n)) {
      *err = "read failed";
      return false;
    }
    const uint64_t cap = cw * ch * d.spp;
    switch (d.compression) {
      case 1:
        if (n < cap) {
          *err = "raw chunk too small";
          return false;
        }
        std::memcpy(out, raw.data(), cap);
        break;  // fall through to predictor: legal (if unusual) combination
      case 5:
        if (!lzw_decode(raw.data(), n, out, cap)) {
          *err = "LZW decode failed";
          return false;
        }
        break;
      case 7:
        // jpeg rows land at stride w*output_components; any spp outside
        // {1,3} (e.g. RGBA extra samples) would mismatch the chunk stride.
        if (d.spp != 1 && d.spp != 3) {
          *err = "JPEG chunks with samples_per_pixel " + std::to_string(d.spp) +
                 " are not supported";
          return false;
        }
        return jpeg_decode_rgb(d.jpeg_tables, raw.data(), n, out, cw, ch, d.spp)
                   ? true
                   : (*err = "JPEG decode failed", false);
      case 8:
      case 32946:
        if (!zlib_decode(raw.data(), n, out, cap)) {
          *err = "deflate decode failed";
          return false;
        }
        break;
      case 32773:
        if (!unpackbits(raw.data(), n, out, cap)) {
          *err = "packbits decode failed";
          return false;
        }
        break;
      case 33003:  // Aperio J2K, YCbCr components (transform outside codestream)
      case 33005:  // Aperio J2K, RGB components
      case 34712:  // standard TIFF JPEG2000
        return j2k_decode(raw.data(), n, out, cw, ch, d.spp,
                          /*force_ycbcr=*/d.compression == 33003, err);
      default:
        *err = "unsupported compression " + std::to_string(d.compression);
        return false;
    }
    if (d.predictor == 2)
      for (uint64_t y = 0; y < ch; ++y) apply_predictor2(out + y * cw * d.spp, cw, d.spp);
    return true;
  }

  // decode_chunk with the LRU cache in front. `ifd_index` keys the cache
  // (chunk indices repeat across IFDs). Concurrent misses on the same chunk
  // may both decode (no per-chunk latch); the second insert is a no-op.
  bool decode_chunk_cached(const IFD& d, size_t ifd_index, uint64_t idx,
                           uint8_t* out, uint64_t cw, uint64_t ch,
                           std::string* err) const {
    const size_t sz = (size_t)(cw * ch * d.spp);
    // Bypass: disabled cache, whole-image chunks that would thrash it, and
    // missing/sparse tiles (zero byte count — e.g. Philips empty regions),
    // whose solid-white fill is cheaper to re-memset than to cache.
    if (chunk_cache.cap == 0 || sz == 0 || sz > chunk_cache.cap / 2 ||
        idx >= d.chunk_counts.size() || d.chunk_counts[idx] == 0)
      return decode_chunk(d, idx, out, cw, ch, err);
    const uint64_t key = ((uint64_t)ifd_index << 40) | idx;
    std::shared_ptr<const std::vector<uint8_t>> hit;
    {
      std::lock_guard<std::mutex> g(chunk_cache.mu);
      auto it = chunk_cache.map.find(key);
      if (it != chunk_cache.map.end()) {
        hit = it->second.data;
        chunk_cache.lru.splice(chunk_cache.lru.begin(), chunk_cache.lru,
                               it->second.pos);
      }
    }
    if (hit) {  // copy outside the lock — hits don't serialize reader pools
      std::memcpy(out, hit->data(), sz);
      return true;
    }
    if (!decode_chunk(d, idx, out, cw, ch, err)) return false;
    auto fresh = std::make_shared<const std::vector<uint8_t>>(out, out + sz);
    std::lock_guard<std::mutex> g(chunk_cache.mu);
    if (chunk_cache.map.find(key) != chunk_cache.map.end()) return true;
    while (chunk_cache.bytes + sz > chunk_cache.cap && !chunk_cache.lru.empty()) {
      uint64_t victim = chunk_cache.lru.back();
      chunk_cache.lru.pop_back();
      auto vit = chunk_cache.map.find(victim);
      if (vit != chunk_cache.map.end()) {
        chunk_cache.bytes -= vit->second.data->size();
        chunk_cache.map.erase(vit);
      }
    }
    chunk_cache.lru.push_front(key);
    auto& e = chunk_cache.map[key];
    e.data = std::move(fresh);
    e.pos = chunk_cache.lru.begin();
    chunk_cache.bytes += sz;
    return true;
  }

  // Decode chunk `idx` at 1/scale via libjpeg's IDCT-domain downscaling into
  // an spp-interleaved buffer of ceil(cw/s) × ceil(ch/s). JPEG chunks only —
  // callers check d.compression == 7 first.
  bool decode_chunk_scaled(const IFD& d, uint64_t idx, uint8_t* out, uint64_t cw,
                           uint64_t ch, unsigned s, std::string* err) const {
    if (idx >= d.chunk_offsets.size()) {
      *err = "chunk index out of range";
      return false;
    }
    uint64_t cws = (cw + s - 1) / s, chs = (ch + s - 1) / s;
    uint64_t off = d.chunk_offsets[idx];
    uint64_t n = idx < d.chunk_counts.size() ? d.chunk_counts[idx] : 0;
    if (n == 0) {  // missing tile ⇒ white
      std::memset(out, 255, cws * chs * d.spp);
      return true;
    }
    if (off >= file.size || n > file.size - off) {
      *err = "chunk extends past end of file";
      return false;
    }
    std::vector<uint8_t> raw(n);
    if (!file.read_at(off, raw.data(), n)) {
      *err = "read failed";
      return false;
    }
    if (!jpeg_decode_rgb(d.jpeg_tables, raw.data(), n, out, cws, chs, d.spp, s)) {
      *err = "scaled JPEG decode failed";
      return false;
    }
    return true;
  }
};

static bool read_region_jpeg_sequential(const AtlasTiff* t, const IFD& d,
                                        const JpegStripeIndex& si, int64_t x,
                                        int64_t y, int64_t w, int64_t x0,
                                        int64_t y0, int64_t x1, int64_t y1,
                                        uint8_t* out, std::string* err) {
  const int64_t W = (int64_t)d.width;
  if (W > 65535) {
    *err = "width beyond 65535 needs restart markers";
    return false;
  }
  if (y1 > 65535) {
    *err = "window rows beyond 65535 need restart markers";
    return false;
  }
  const uint64_t mcu_h = si.mcu_h ? si.mcu_h : 8;
  uint64_t hp = std::min<uint64_t>((uint64_t)d.height, 65535);
  hp = std::min<uint64_t>(hp, (((uint64_t)y1 + mcu_h - 1) / mcu_h) * mcu_h);

  std::vector<uint8_t> hdr = si.header;  // SOF patched to (W, hp)
  // Patch only zeroed (NDPI "unrepresentable") or already-matching SOF
  // dims. A real declared width that disagrees with the TIFF tags means the
  // entropy stream unwraps at a different MCUs-per-row count — patching it
  // over would silently return scrambled pixels.
  const uint64_t decl_w = ((uint64_t)hdr[si.sof_dims_off + 2] << 8) |
                          hdr[si.sof_dims_off + 3];
  if (decl_w != 0 && (int64_t)decl_w != W) {
    *err = "sequential decode width mismatch";
    return false;
  }
  hdr[si.sof_dims_off + 0] = (uint8_t)(hp >> 8);
  hdr[si.sof_dims_off + 1] = (uint8_t)(hp & 0xFF);
  hdr[si.sof_dims_off + 2] = (uint8_t)((uint64_t)W >> 8);
  hdr[si.sof_dims_off + 3] = (uint8_t)((uint64_t)W & 0xFF);
  // Re-insert the DRI segment the striped header drops: this decode walks
  // the full entropy stream, so libjpeg must expect its restart markers or
  // it resyncs through them as corrupt data (silent garbage pixels).
  if (si.dri != 0 && si.sos_off != 0) {
    const uint8_t dri_seg[6] = {0xFF, 0xDD, 0x00, 0x04,
                                (uint8_t)(si.dri >> 8), (uint8_t)(si.dri & 0xFF)};
    hdr.insert(hdr.begin() + si.sos_off, dri_seg, dri_seg + 6);
  }

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    *err = "sequential JPEG decode failed";
    return false;
  }
  jpeg_create_decompress(&cinfo);
  StreamJpegSrc src;
  src.file = &t->file;
  src.pos = si.entropy_start;
  // Stream to EOF, not the declared strip length: NDPI >4 GiB files wrap
  // StripByteCounts; the decode is height-capped, so a generous end is safe.
  src.end = std::max<uint64_t>(si.entropy_end, t->file.size);
  src.chunk.resize(4u << 20);
  src.header = &hdr;
  src.mgr.init_source = stream_src_init;
  src.mgr.fill_input_buffer = stream_src_fill;
  src.mgr.skip_input_data = stream_src_skip;
  src.mgr.resync_to_restart = jpeg_resync_to_restart;
  src.mgr.term_source = stream_src_term;
  src.mgr.bytes_in_buffer = 0;
  src.mgr.next_input_byte = nullptr;
  cinfo.src = &src.mgr;

  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (d.spp == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const uint32_t comps = cinfo.output_components;
  if ((int64_t)cinfo.output_width != W) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *err = "sequential decode width mismatch";
    return false;
  }
  std::vector<uint8_t> rowbuf((size_t)cinfo.output_width * comps);
  JSAMPROW rowptr = rowbuf.data();
  const bool invert = d.photometric == 0 && d.spp == 1;
  while (cinfo.output_scanline < cinfo.output_height) {
    int64_t yy = (int64_t)cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    if (src.io_error) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      *err = "read failed during sequential decode";
      return false;
    }
    if (yy >= y0 && yy < y1) {
      uint8_t* dstp = out + (size_t)((yy - y) * w + (x0 - x)) * 3;
      int64_t count = x1 - x0;
      if (comps >= 3) {
        const uint8_t* srcp = rowbuf.data() + (size_t)x0 * comps;
        for (int64_t i = 0; i < count; ++i) {
          dstp[i * 3 + 0] = srcp[i * comps + 0];
          dstp[i * 3 + 1] = srcp[i * comps + 1];
          dstp[i * 3 + 2] = srcp[i * comps + 2];
        }
      } else {
        const uint8_t* srcp = rowbuf.data() + (size_t)x0;
        for (int64_t i = 0; i < count; ++i) {
          uint8_t v = invert ? (uint8_t)(255 - srcp[i]) : srcp[i];
          dstp[i * 3 + 0] = dstp[i * 3 + 1] = dstp[i * 3 + 2] = v;
        }
      }
    }
    if (yy + 1 >= y1) break;  // everything needed is copied
  }
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------------ IFD parse
static bool parse_one_ifd(AtlasTiff* t, uint64_t ifd_off, IFD* out,
                          uint64_t* next_off);
static bool finish_parse(AtlasTiff* t);

static bool parse_ifds(AtlasTiff* t) {
  uint8_t header[16];
  if (!t->file.read_at(0, header, 8)) return false;
  if (header[0] == 'I' && header[1] == 'I')
    t->bo.little = true;
  else if (header[0] == 'M' && header[1] == 'M')
    t->bo.little = false;
  else {
    t->error = "not a TIFF file";
    return false;
  }
  uint16_t magic = t->bo.u16(header + 2);
  uint64_t ifd_off;
  if (magic == 42) {
    t->bigtiff = false;
    ifd_off = t->bo.u32(header + 4);
  } else if (magic == 43) {
    t->bigtiff = true;
    if (!t->file.read_at(0, header, 16)) return false;
    ifd_off = t->bo.u64(header + 8);
  } else {
    t->error = "bad TIFF magic";
    return false;
  }

  int guard = 0;
  while (ifd_off != 0 && guard++ < 1024) {
    IFD d;
    uint64_t next_off = 0;
    if (!parse_one_ifd(t, ifd_off, &d, &next_off)) return false;
    t->ifds.push_back(std::move(d));
    ifd_off = next_off;
  }
  if (t->ifds.empty()) return false;

  // OME-TIFF / libvips pyramids place reduced levels in SubIFDs (tag 330)
  // of the full-resolution directory rather than on the main chain. Walk
  // one nesting level deep (each entry may itself chain via next pointers);
  // global caps bound corrupt files that point SubIFDs back at the chain.
  const size_t n_main = t->ifds.size();
  for (size_t i = 0; i < n_main && t->ifds.size() < 1024; ++i) {
    std::vector<uint64_t> subs = t->ifds[i].array(t->bo, kSubIFDs);
    for (uint64_t off : subs) {
      int sguard = 0;
      while (off != 0 && off < t->file.size && sguard++ < 64 &&
             t->ifds.size() < 1024) {
        IFD sd;
        uint64_t next = 0;
        if (!parse_one_ifd(t, off, &sd, &next)) break;
        sd.sub_of = (int)i;
        t->ifds.push_back(std::move(sd));
        off = next;
      }
    }
  }
  return finish_parse(t);
}

// Parse the IFD at `ifd_off` into *out and report the chained next-IFD
// offset. Failure means the structure itself is unreadable (I/O error or an
// implausible entry count); individual bad entries are skipped.
static bool parse_one_ifd(AtlasTiff* t, uint64_t ifd_off, IFD* out,
                          uint64_t* next_off) {
  const size_t entry_size = t->bigtiff ? 20 : 12;
  uint64_t count;
  uint64_t entries_off;
  {
    if (t->bigtiff) {
      uint8_t buf[8];
      if (!t->file.read_at(ifd_off, buf, 8)) return false;
      count = t->bo.u64(buf);
      entries_off = ifd_off + 8;
    } else {
      uint8_t buf[2];
      if (!t->file.read_at(ifd_off, buf, 2)) return false;
      count = t->bo.u16(buf);
      entries_off = ifd_off + 2;
    }
    if (count > 4096) {
      t->error = "suspicious IFD entry count";
      return false;
    }
    std::vector<uint8_t> raw(count * entry_size);
    if (!t->file.read_at(entries_off, raw.data(), raw.size())) return false;

    IFD& d = *out;
    for (uint64_t i = 0; i < count; ++i) {
      const uint8_t* p = raw.data() + i * entry_size;
      uint16_t tag = t->bo.u16(p);
      uint16_t type = t->bo.u16(p + 2);
      uint64_t cnt = t->bigtiff ? t->bo.u64(p + 4) : t->bo.u32(p + 4);
      size_t ts = type_size(type);
      if (ts == 0) continue;
      // Cap entry payloads at 1 GiB BEFORE allocating (also guards cnt*ts
      // overflowing uint64 to a small value on a corrupt IFD).
      if (cnt > (1ull << 30) / ts) continue;
      uint64_t nbytes = cnt * ts;
      size_t inline_cap = t->bigtiff ? 8 : 4;
      const uint8_t* vp = p + (t->bigtiff ? 12 : 8);
      Entry e;
      e.type = type;
      e.count = cnt;
      if (nbytes <= inline_cap) {
        e.data.resize(nbytes);
        std::memcpy(e.data.data(), vp, nbytes);
      } else {
        uint64_t off = t->bigtiff ? t->bo.u64(vp) : t->bo.u32(vp);
        // Bounds-check BEFORE the resize: a corrupt count inside the 1 GiB
        // cap would still zero-init that much per entry (×4096 entries)
        // just to fail the read.
        if (off >= t->file.size || nbytes > t->file.size - off) continue;
        e.data.resize(nbytes);
        if (!t->file.read_at(off, e.data.data(), nbytes)) continue;
      }
      d.entries[tag] = std::move(e);
    }

    d.width = d.scalar(t->bo, kWidth);
    d.height = d.scalar(t->bo, kHeight);
    d.compression = (uint32_t)d.scalar(t->bo, kCompression, 1);
    d.photometric = (uint32_t)d.scalar(t->bo, kPhotometric, 2);
    d.spp = (uint32_t)d.scalar(t->bo, kSamplesPerPixel, 1);
    d.planar = (uint32_t)d.scalar(t->bo, kPlanarConfig, 1);
    d.predictor = (uint32_t)d.scalar(t->bo, kPredictor, 1);
    d.tile_w = d.scalar(t->bo, kTileWidth);
    d.tile_h = d.scalar(t->bo, kTileHeight);
    d.rows_per_strip = d.scalar(t->bo, kRowsPerStrip, d.height);
    // A strip never exceeds the image (clamping also bounds per-strip
    // decode buffers against corrupt RowsPerStrip values).
    if (d.rows_per_strip == 0 || d.rows_per_strip > d.height)
      d.rows_per_strip = d.height;
    if (d.has(kBits)) {
      // Every decode path assumes 8-bit samples; a 16-bit (or bilevel) TIFF
      // must be rejected loudly, not reinterpreted byte-wise as garbage.
      for (uint64_t b : d.array(t->bo, kBits)) {
        if (b != 8) {
          d.bits8 = false;
          break;
        }
      }
    }
    if (d.photometric == 3 && d.has(kColorMap)) {
      // ColorMap: 3 planes of 2^bits SHORTs (all R, all G, all B). Values
      // are nominally 16-bit (use the high byte); some writers store 8-bit
      // values directly — detected when every entry fits a byte, the same
      // heuristic libtiff applies.
      std::vector<uint64_t> cm = d.array(t->bo, kColorMap);
      if (d.bits8 && cm.size() >= 768) {
        uint64_t mx = 0;
        for (size_t i = 0; i < 768; ++i) mx = std::max(mx, cm[i]);
        d.palette.resize(768);
        for (size_t i = 0; i < 256; ++i)
          for (size_t c = 0; c < 3; ++c) {
            uint64_t v = cm[c * 256 + i];
            d.palette[i * 3 + c] = (uint8_t)(mx > 255 ? v >> 8 : v);
          }
      }
    }
    d.tiled = d.has(kTileWidth) && d.has(kTileOffsets);
    d.chunk_offsets = d.array(t->bo, d.tiled ? kTileOffsets : kStripOffsets);
    d.chunk_counts = d.array(t->bo, d.tiled ? kTileByteCounts : kStripByteCounts);
    d.x_resolution = d.rational(t->bo, kXResolution);
    d.y_resolution = d.rational(t->bo, kYResolution);
    d.resolution_unit = (uint32_t)d.scalar(t->bo, kResolutionUnit, 2);
    if (d.has(kDescription)) {
      const Entry& e = d.entries[kDescription];
      d.description.assign(reinterpret_cast<const char*>(e.data.data()),
                           strnlen(reinterpret_cast<const char*>(e.data.data()),
                                   e.data.size()));
    }
    if (d.has(kJPEGTables)) d.jpeg_tables = d.entries[kJPEGTables].data;
    if (d.has(kSoftware)) {
      const Entry& e = d.entries[kSoftware];
      d.software.assign(reinterpret_cast<const char*>(e.data.data()),
                        strnlen(reinterpret_cast<const char*>(e.data.data()),
                                e.data.size()));
    }
    if (d.has(kXMP)) {
      // XMP is BYTE/UNDEFINED (sometimes ASCII); treat as a text blob.
      const Entry& e = d.entries[kXMP];
      if (e.type == 1 || e.type == 2 || e.type == 7)
        d.xmp.assign(reinterpret_cast<const char*>(e.data.data()),
                     strnlen(reinterpret_cast<const char*>(e.data.data()),
                             e.data.size()));
    }
    uint8_t nextbuf[8] = {0};
    if (t->file.read_at(entries_off + count * entry_size, nextbuf,
                        t->bigtiff ? 8 : 4))
      *next_off = t->bigtiff ? t->bo.u64(nextbuf) : t->bo.u32(nextbuf);
  }
  return true;
}

// Post-chain fixups shared by every container family.
static bool finish_parse(AtlasTiff* t) {
  if (t->ifds.empty()) return false;

  t->ndpi = t->ifds[0].has(kNdpiMagic);
  // NDPI keeps a classic-TIFF (32-bit) header even when the file exceeds
  // 4 GiB; stored chunk offsets are the low 32 bits of the true offset.
  // Restore them by monotonic unwrapping: image data for consecutive chunks
  // is written in ascending file order (same recovery the ndpitools suite
  // documents). IFD structures themselves sit below 4 GiB in practice.
  if (t->ndpi && !t->bigtiff && t->file.size > (1ull << 32)) {
    // The cursor carries across IFDs: NDPI writers emit image data
    // sequentially, so each image's chunks start past the previous image's.
    uint64_t prev_end = 0;
    for (IFD& d : t->ifds) {
      for (size_t i = 0; i < d.chunk_offsets.size(); ++i) {
        uint64_t off = d.chunk_offsets[i];
        while (off + (1ull << 32) <= t->file.size && off < prev_end)
          off += 1ull << 32;
        d.chunk_offsets[i] = off;
        uint64_t cnt = i < d.chunk_counts.size() ? d.chunk_counts[i] : 0;
        prev_end = off + cnt;
      }
    }
  }
  return true;
}

static std::string to_lower(std::string s) {
  for (char& c : s) c = (char)tolower((unsigned char)c);
  return s;
}

// Corrupt-header guard: reject levels beyond any plausible slide size
// (largest real WSIs are ~20 gigapixels) so callers never size buffers
// from garbage dimensions.
static bool plausible_dims(const IFD& d) {
  if (d.width == 0 || d.height == 0 || d.planar != 1 || !d.bits8) return false;
  // Photometrics the RGB expansion understands. CMYK (5), CIELab (8), and
  // anything newer would render garbage silently — skip the IFD instead
  // (a file with no decodable IFD fails open with "no decodable pyramid
  // levels"). Palette-color needs its lookup table and only occurs with
  // raw-sample compressions (the JPEG/J2K decoders emit gray or RGB, never
  // palette indices); YCbCr is valid only where a JPEG-family decoder does
  // the color conversion.
  switch (d.photometric) {
    case 0: case 1: case 2: break;
    case 3:
      if (d.palette.empty() || d.spp != 1 || d.compression == 6 ||
          d.compression == 7 || d.compression >= 33000)
        return false;
      break;
    case 6:
      if (!(d.compression == 7 || d.compression == 33003 ||
            d.compression == 33005 || d.compression == 34712))
        return false;
      break;
    default:
      return false;
  }
  if (d.width > (1ull << 30) || d.height > (1ull << 30) ||
      d.width * d.height > (1ull << 36))
    return false;
  // Per-chunk decode buffers are sized from tile dims × spp; corrupt tags
  // (a fuzzed TileLength count turned the value into a file offset) would
  // otherwise declare multi-gigabyte tiles that stall the paint loops for
  // minutes. Real tiles top out at 4096² and spp at 4.
  if (d.spp == 0 || d.spp > 16) return false;
  if (d.tiled &&
      (d.tile_w > (1ull << 16) || d.tile_h > (1ull << 16) ||
       d.tile_w * d.tile_h > (1ull << 26)))
    return false;
  // Corrupt dimension tags can pass the size bounds while declaring a chunk
  // grid the offset arrays cannot cover (a fuzzed ImageWidth of 50M px made
  // whole-level thumbnail reads stall for minutes painting a 24 GB canvas).
  // A real writer always covers the image, so an under-provisioned array
  // means garbage dimensions — reject the IFD. Exception: a single-chunk
  // whole-image JPEG (the NDPI layout) is accepted regardless of the
  // RowsPerStrip tag, which is unreliable in that family; its decode paths
  // re-validate the declared dims against the JPEG's own SOF fields.
  if (d.tiled) {
    if (d.tile_w == 0 || d.tile_h == 0) return false;
    uint64_t need = ((d.width + d.tile_w - 1) / d.tile_w) *
                    ((d.height + d.tile_h - 1) / d.tile_h);
    if (d.chunk_offsets.size() < need) return false;
  } else if (!(d.compression == 7 && d.chunk_offsets.size() == 1)) {
    uint64_t rps = d.rows_per_strip ? d.rows_per_strip : d.height;
    uint64_t need = (d.height + rps - 1) / rps;
    if (d.chunk_offsets.size() < need) return false;
    // Per-strip decode buffers are width × rows_per_strip × spp: a corrupt
    // width inside the total-pixel cap (e.g. 167M × 96) still declared a
    // 10 GB strip. Real strips are a few MB.
    if (d.width * rps > (1ull << 28)) return false;
  }
  return true;
}

// --- Leica SCN XML --------------------------------------------------------
// SCN files store a <scn><collection> XML in IFD0's ImageDescription listing
// every image on the slide: a macro overview of the whole glass plus one or
// more scanned regions, each declaring its pyramid as <dimension ifd="N">
// entries (format notes: openslide.org/formats/leica; parsing re-derived).
// We select the image with the widest base plane as the slide pyramid; the
// macro and any smaller regions are excluded as associated images.
struct ScnImage {
  uint64_t base_w = 0;
  std::vector<size_t> ifd_indices;
  double objective = 0.0;
};

static bool xml_attr_u64(const std::string& s, size_t from, size_t to,
                         const char* name, uint64_t* out) {
  std::string pat = std::string(name) + "=\"";
  size_t p = s.find(pat, from);
  if (p == std::string::npos || p >= to) return false;
  *out = strtoull(s.c_str() + p + pat.size(), nullptr, 10);
  return true;
}

static void parse_scn(const std::string& xml, std::vector<ScnImage>* out) {
  size_t pos = 0;
  while (true) {
    size_t ib = xml.find("<image", pos);
    if (ib == std::string::npos) break;
    size_t ie = xml.find("</image>", ib);
    if (ie == std::string::npos) ie = xml.size();
    ScnImage img;
    size_t pb = xml.find("<pixels", ib);
    if (pb != std::string::npos && pb < ie) {
      size_t pe = xml.find("</pixels>", pb);
      if (pe == std::string::npos || pe > ie) pe = ie;
      size_t dp = pb;
      while (true) {
        size_t db = xml.find("<dimension", dp);
        if (db == std::string::npos || db >= pe) break;
        size_t de = xml.find('>', db);
        if (de == std::string::npos || de > pe) break;
        uint64_t sx = 0, ifd = 0, z = 0;
        bool ok = xml_attr_u64(xml, db, de, "sizeX", &sx) &&
                  xml_attr_u64(xml, db, de, "ifd", &ifd);
        xml_attr_u64(xml, db, de, "z", &z);  // z-stacks: keep the z=0 plane
        if (ok && z == 0) {
          img.ifd_indices.push_back((size_t)ifd);
          if (sx > img.base_w) img.base_w = sx;
        }
        dp = de;
      }
    }
    size_t ob = xml.find("<objective>", ib);
    if (ob != std::string::npos && ob < ie)
      img.objective = atof(xml.c_str() + ob + 11);
    if (!img.ifd_indices.empty()) out->push_back(std::move(img));
    pos = ie;
  }
}

static void build_levels_scn(AtlasTiff* t) {
  std::vector<ScnImage> images;
  parse_scn(t->ifds[0].description, &images);
  if (images.empty()) return;
  const ScnImage* main_img = &images[0];
  for (const ScnImage& im : images)
    if (im.base_w > main_img->base_w) main_img = &im;
  for (size_t idx : main_img->ifd_indices) {
    if (idx >= t->ifds.size()) continue;
    const IFD& d = t->ifds[idx];
    if (!plausible_dims(d)) continue;
    t->levels.push_back({idx, d.width, d.height, 1.0});
  }
  if (!t->levels.empty()) t->scn_objective = main_img->objective;
}

// Hamamatsu NDPI: every IFD carries tag 65420. SourceLens (65421) classifies
// the image — > 0 is a pyramid level at that objective power, -1 the macro
// photo, -2 the slide map. Z-stacked files repeat each power per z-offset
// (65422); we expose the z = 0 plane.
static void build_levels_ndpi(AtlasTiff* t) {
  for (size_t i = 0; i < t->ifds.size(); ++i) {
    const IFD& d = t->ifds[i];
    if (!plausible_dims(d)) continue;
    double lens = 0.0;
    if (!d.signed_double(t->bo, kNdpiSourceLens, &lens)) continue;
    if (lens <= 0) continue;
    double z = 0.0;
    if (d.signed_double(t->bo, kNdpiZOffset, &z) && z != 0) continue;
    t->levels.push_back({i, d.width, d.height, 1.0});
    if (lens > t->ndpi_lens0) t->ndpi_lens0 = lens;
  }
}

static bool associated_ifd(const IFD& d) {
  std::string desc = to_lower(d.description);
  return desc.find("label") != std::string::npos ||
         desc.find("macro") != std::string::npos ||
         desc.find("thumbnail") != std::string::npos ||
         desc.find("probability") != std::string::npos ||
         desc.find("overview") != std::string::npos;
}

// Shrink a tiled level whose adjacent tiles overlap by (ox, oy) pixels:
// advances become tile-size − overlap and the canvas is the positioned span
// of the tile grid. Junk overlaps (≤0 or ≥ tile−1, i.e. sub-pixel advances)
// leave the abutting grid untouched — see the gating notes at the Ventana
// call site. Shared by Ventana BIF (mean TileJointInfo overlaps on the base)
// and Trestle (per-level OverlapsXY pairs).
static void overlap_correct_level(const IFD& b, double ox, double oy,
                                  uint64_t* lw, uint64_t* lh, double* adv_x,
                                  double* adv_y) {
  if (!b.tiled || b.tile_w == 0 || b.tile_h == 0) return;
  int64_t tw = (int64_t)b.tile_w, th = (int64_t)b.tile_h;
  int64_t cols = ((int64_t)b.width + tw - 1) / tw;
  int64_t rows = ((int64_t)b.height + th - 1) / th;
  if (ox > 0.0 && ox <= (double)(tw - 1) && cols > 1) {
    *adv_x = (double)tw - ox;
    int64_t last_w = (int64_t)b.width - (cols - 1) * tw;  // partial last col
    *lw = (uint64_t)(llround((double)(cols - 1) * *adv_x) + last_w);
  }
  if (oy > 0.0 && oy <= (double)(th - 1) && rows > 1) {
    *adv_y = (double)th - oy;
    int64_t last_h = (int64_t)b.height - (rows - 1) * th;
    *lh = (uint64_t)(llround((double)(rows - 1) * *adv_y) + last_h);
  }
}

static void build_levels_generic(AtlasTiff* t) {
  // Pyramid levels: the base is IFD0 (TIFF convention: full resolution
  // first). Ventana/Roche BIF is the exception — it places a striped
  // overview at directory 0 with the full-resolution tiled image later
  // (openslide.org/formats/ventana) — so ONLY for detected Ventana files
  // (iScan XMP, classified before level building) the largest tiled
  // non-associated directory becomes the base. An ungated rescan would let
  // any generic multi-image TIFF with a larger tiled secondary image hijack
  // the pyramid. Other IFDs qualify when they are reductions of the base
  // (same aspect ratio), decodable, and not label/macro/thumbnail associated
  // images. Aperio SVS stores the pyramid as tiled IFDs with a striped
  // thumbnail at IFD1 — for Aperio files only tiled IFDs count.
  bool aperio = t->ifds[0].description.rfind("Aperio", 0) == 0;
  size_t base = 0;
  uint64_t base_area =
      plausible_dims(t->ifds[0]) ? t->ifds[0].width * t->ifds[0].height : 0;
  if (t->ventana) {
    for (size_t i = 1; i < t->ifds.size(); ++i) {
      const IFD& d = t->ifds[i];
      if (!plausible_dims(d) || !d.tiled || associated_ifd(d)) continue;
      if (d.width * d.height > base_area) {
        base = i;
        base_area = d.width * d.height;
      }
    }
  }
  double aspect0 = 0.0;
  if (base != 0 || plausible_dims(t->ifds[0])) {
    const IFD& b = t->ifds[base];
    // Ventana AOI join-overlap correction: adjacent level-0 tiles overlap by
    // the mean TileJointInfo overlap; the stitched canvas is smaller than
    // the declared tile mosaic. Advances stay fractional (rounded per tile
    // at paint time) so rounding error never accumulates across the grid.
    // Gated on sane overlaps — a junk overlap (≤0 or ≥ tile size − 1) keeps
    // the uncorrected abutting grid, which is what the file decodes to
    // anyway. The ≥1px-advance floor also keeps read_region_positioned's
    // first-tile estimate exact: with sub-pixel advances the floor estimate
    // could land past the first overlapping tile.
    uint64_t lw = b.width, lh = b.height;
    double adv_x = 0.0, adv_y = 0.0;
    if (t->ventana && t->ventana_joints > 0)
      overlap_correct_level(b, t->ventana_overlap_x, t->ventana_overlap_y, &lw,
                            &lh, &adv_x, &adv_y);
    else if (t->trestle && t->trestle_overlaps.size() >= 2)
      overlap_correct_level(b, (double)t->trestle_overlaps[0],
                            (double)t->trestle_overlaps[1], &lw, &lh, &adv_x,
                            &adv_y);
    aspect0 = (double)lw / (double)lh;
    t->levels.push_back({base, lw, lh, 1.0, adv_x, adv_y});
  }
  for (size_t i = 0; i < t->ifds.size(); ++i) {
    if (i == base) continue;
    const IFD& d = t->ifds[i];
    if (!plausible_dims(d)) continue;
    if (associated_ifd(d)) continue;
    // SubIFD levels belong to their parent image: only the base's reductions
    // join its pyramid (a macro/label image may carry SubIFDs of its own).
    if (d.sub_of >= 0 && (size_t)d.sub_of != base) continue;
    if (aperio && !d.tiled) continue;  // SVS striped IFD1 = thumbnail image
    if (base != 0) {
      // BIF-style base rescue: striped dirs are overviews, and nothing
      // larger than the chosen base belongs to its pyramid.
      if (!d.tiled) continue;
      if (d.width * d.height > base_area) continue;
    }
    // Trestle levels each overlap by their own OverlapsXY pair. Pairs are
    // per TIFF directory in FILE ORDER: OpenSlide's trestle driver makes
    // EVERY directory a level, so pair k belongs to raw directory k. Using
    // the raw position (not a filtered count) keeps alignment even when an
    // intermediate directory is skipped by the aspect/dup checks below —
    // its pair is skipped with it, exactly as OpenSlide would have applied
    // it to that directory. Correct dims BEFORE the aspect/dup checks so
    // they compare stitched canvases, not raw mosaics. (SubIFDs have no
    // directory ordinal in OpenSlide's walk; trestle files don't use them.)
    uint64_t lw = d.width, lh = d.height;
    double ax = 0.0, ay = 0.0;
    if (t->trestle && d.sub_of < 0) {
      size_t lvl = i;  // raw top-level directory position in file order
      if (2 * lvl + 1 < t->trestle_overlaps.size())
        overlap_correct_level(d, (double)t->trestle_overlaps[2 * lvl],
                              (double)t->trestle_overlaps[2 * lvl + 1], &lw,
                              &lh, &ax, &ay);
    }
    double aspect = (double)lw / (double)lh;
    if (aspect0 > 0 && std::abs(aspect - aspect0) / aspect0 > 0.05) continue;
    // A real pyramid never repeats a level size; duplicates are sibling
    // planes of a multi-page image (OME-TIFF channels/timepoints share the
    // base dims) — expose the first plane only, like OpenSlide's generic
    // driver keeps one image series.
    bool dup = false;
    for (const Level& L : t->levels)
      if (L.width == lw && L.height == lh) {
        dup = true;
        break;
      }
    if (dup) continue;
    t->levels.push_back({i, lw, lh, 1.0, ax, ay});
  }
}

// --- Ventana/Roche BIF + Philips TIFF vendor metadata -----------------------
// Re-derived from the public openslide.org format notes (formats/ventana,
// formats/philips) — no vendor files available offline, so both are
// validated on spec-conformant synthetic slides (tests/test_vendor_formats
// .py). Ventana AOI join-overlap correction: the XMP's TileJointInfo
// elements record the measured overlap between each pair of adjacent level-0
// tiles; we average them into uniform fractional tile advances and paint
// tiles at the corrected positions (see read_region_positioned), the same
// placement OpenSlide derives. Residual vs OpenSlide: per-AOI origins from
// the SlideStitchInfo ImageInfo elements are not modeled (one uniform grid),
// and tile positions are rounded to whole pixels per tile rather than
// composited at sub-pixel offsets.

// Find `name="value"` (or '…') in an XML fragment, requiring a whitespace
// separator before the attribute name so e.g. Magnification never matches
// ObjectiveMagnification.
static bool find_xml_attr(const std::string& s, const char* name,
                          std::string* out) {
  std::string pat = std::string(name) + "=";
  size_t p = 0;
  while ((p = s.find(pat, p)) != std::string::npos) {
    if (p > 0 && !std::isspace((unsigned char)s[p - 1])) {
      p += pat.size();
      continue;
    }
    size_t v = p + pat.size();
    if (v >= s.size() || (s[v] != '"' && s[v] != '\'')) return false;
    char q = s[v++];
    size_t e = s.find(q, v);
    if (e == std::string::npos) return false;
    *out = s.substr(v, e - v);
    return true;
  }
  return false;
}

// Ventana BIF: any directory's XMP packet (tag 700) carrying an <iScan …>
// element marks the file; Magnification and ScanRes (µm/pixel) are iScan
// attributes.
static void detect_ventana(AtlasTiff* t) {
  for (const IFD& d : t->ifds) {
    // Require an element delimiter after the name so <iScanList> or
    // <iScanSettings> in third-party XMP never misclassifies the file.
    size_t p = 0;
    while ((p = d.xmp.find("<iScan", p)) != std::string::npos) {
      size_t after = p + 6;
      if (after < d.xmp.size() &&
          (std::isspace((unsigned char)d.xmp[after]) || d.xmp[after] == '/' ||
           d.xmp[after] == '>'))
        break;
      p = after;
    }
    if (p == std::string::npos) continue;
    size_t end = d.xmp.find('>', p);
    std::string el =
        d.xmp.substr(p, end == std::string::npos ? std::string::npos : end - p);
    t->ventana = true;
    std::string v;
    if (find_xml_attr(el, "Magnification", &v)) t->ventana_mag = std::atof(v.c_str());
    if (find_xml_attr(el, "ScanRes", &v)) t->ventana_scanres = std::atof(v.c_str());
    break;
  }
  if (!t->ventana) return;

  // AOI join overlaps: each TileJointInfo element records the stitcher's
  // measured overlap between two adjacent tiles (Direction="RIGHT" pairs
  // horizontal neighbours — OverlapX is the meaningful axis; "UP" pairs
  // vertical neighbours — OverlapY). Average the accepted joints into one
  // overlap per axis. Joints the stitcher could not match confidently
  // (Confidence < 1) are skipped — their overlap fields are not
  // measurements. Values are validated again (0 < overlap < tile size)
  // before any correction is applied in build_levels_generic.
  double sum_x = 0.0, sum_y = 0.0;
  long nx = 0, ny = 0;
  for (const IFD& d : t->ifds) {
    size_t q = 0;
    while ((q = d.xmp.find("<TileJointInfo", q)) != std::string::npos) {
      // Bound the element slice: an unterminated tag in hostile XMP must not
      // turn each joint into a copy of the remaining packet (O(n²)).
      size_t close = d.xmp.find('>', q);
      size_t len = close == std::string::npos ? d.xmp.size() - q : close - q;
      std::string el = d.xmp.substr(q, std::min<size_t>(len, 4096));
      q += 14;
      std::string v;
      if (find_xml_attr(el, "Confidence", &v) && std::atof(v.c_str()) < 1.0)
        continue;
      std::string dir;
      if (!find_xml_attr(el, "Direction", &dir)) continue;
      if (dir == "RIGHT" || dir == "LEFT") {
        if (find_xml_attr(el, "OverlapX", &v) || find_xml_attr(el, "Overlap", &v)) {
          double o = std::atof(v.c_str());
          if (std::isfinite(o)) {
            sum_x += o;
            ++nx;
          }
        }
      } else if (dir == "UP" || dir == "DOWN") {
        if (find_xml_attr(el, "OverlapY", &v) || find_xml_attr(el, "Overlap", &v)) {
          double o = std::atof(v.c_str());
          if (std::isfinite(o)) {
            sum_y += o;
            ++ny;
          }
        }
      }
    }
  }
  if (nx > 0) t->ventana_overlap_x = sum_x / (double)nx;
  if (ny > 0) t->ventana_overlap_y = sum_y / (double)ny;
  t->ventana_joints = nx + ny;
}

// Philips TIFF: Software tag starts with "Philips"; IFD0's ImageDescription
// is the UFS DataObject XML. Pixel spacing (mm, quoted pair, possibly
// &quot;-escaped) comes from the DICOM_PIXEL_SPACING attribute element;
// missing tiles have zero offset/bytecount and already render white in
// decode_chunk.
static void detect_philips(AtlasTiff* t) {
  if (t->ifds[0].software.rfind("Philips", 0) != 0) return;
  t->philips = true;
  const std::string& x = t->ifds[0].description;
  size_t p = x.find("\"DICOM_PIXEL_SPACING\"");
  if (p == std::string::npos) return;
  size_t close = x.find('>', p);
  if (close == std::string::npos) return;
  // Scan to the first (possibly signed) number in the element body; a
  // negative spacing parses but is rejected by the mm > 0 guard below.
  size_t i = close + 1;
  auto num_start = [&](size_t j) {
    if (std::isdigit((unsigned char)x[j])) return true;
    if ((x[j] == '.' || x[j] == '-') && j + 1 < x.size())
      return std::isdigit((unsigned char)x[j + 1]) ||
             (x[j] == '-' && x[j + 1] == '.' && j + 2 < x.size() &&
              std::isdigit((unsigned char)x[j + 2]));
    return false;
  };
  while (i < x.size() && x[i] != '<' && !num_start(i)) ++i;
  if (i >= x.size() || x[i] == '<') return;
  double mm = std::atof(x.c_str() + i);
  if (mm > 0) t->philips_mpp = mm * 1000.0;
}

// Trestle .tif: Software tag starts with "MedScan"; IFD0's ImageDescription
// is ';'-separated key=value pairs (openslide.org/formats/trestle — the
// reference reads these files through OpenSlide's trestle driver via the
// generic .tif mapping, wsi_factory.py:22). "OverlapsXY" lists per-level
// tile overlaps as space-separated x y pairs in that level's own pixels —
// adjacent tiles share that many pixels, so the stitched canvas is smaller
// than the raw tile mosaic. "Objective Power" feeds magnification.
static void detect_trestle(AtlasTiff* t) {
  if (t->ifds[0].software.rfind("MedScan", 0) != 0) return;
  t->trestle = true;
  const std::string& desc = t->ifds[0].description;
  size_t start = 0;
  bool seen_overlaps = false;  // only the FIRST OverlapsXY key counts: a
  // duplicate key must neither concatenate onto the first one's pairs nor
  // repopulate the vector after a junk value cleared it.
  while (start <= desc.size()) {
    size_t end = desc.find(';', start);
    std::string field =
        desc.substr(start, end == std::string::npos ? std::string::npos
                                                    : end - start);
    size_t eq = field.find('=');
    if (eq != std::string::npos) {
      std::string key = field.substr(0, eq);
      std::string val = field.substr(eq + 1);
      if (key == "OverlapsXY" && !seen_overlaps) {
        seen_overlaps = true;
        size_t i = 0;
        bool junk = false;
        while (i < val.size()) {
          // A negative overlap is junk for the whole value (OpenSlide's
          // strtoll would read −16 and the ≤0 gate would drop it; silently
          // reading it as +16 would shrink the canvas).
          if (val[i] == '-' && i + 1 < val.size() &&
              std::isdigit((unsigned char)val[i + 1])) {
            junk = true;
            break;
          }
          if (!std::isdigit((unsigned char)val[i])) {
            ++i;
            continue;
          }
          unsigned long v = strtoul(val.c_str() + i, nullptr, 10);
          // Bound: an overlap ≥ any plausible tile size is junk; the
          // per-level ox ≤ tile−1 gate re-validates against real geometry.
          if (v > 1u << 20) {
            junk = true;
            break;
          }
          t->trestle_overlaps.push_back((uint32_t)v);
          while (i < val.size() && std::isdigit((unsigned char)val[i])) ++i;
        }
        if (junk) t->trestle_overlaps.clear();
      } else if (key == "Objective Power") {
        double v = std::atof(val.c_str());
        if (v > 0 && v < 1000) t->trestle_objective = v;
      }
    }
    if (end == std::string::npos) break;
    start = end + 1;
  }
  if (t->trestle_overlaps.size() % 2) t->trestle_overlaps.pop_back();
}

static void build_levels(AtlasTiff* t) {
  // Vendor classification first: build_levels_generic gates its BIF-style
  // base rescan on t->ventana and overlap correction on t->trestle.
  detect_ventana(t);
  detect_philips(t);
  detect_trestle(t);
  if (t->ndpi) build_levels_ndpi(t);
  if (t->levels.empty() &&
      t->ifds[0].description.find("<scn") != std::string::npos) {
    build_levels_scn(t);
    t->scn = !t->levels.empty();
  }
  if (t->levels.empty()) build_levels_generic(t);
  std::sort(t->levels.begin(), t->levels.end(),
            [](const Level& a, const Level& b) { return a.width > b.width; });
  if (!t->levels.empty()) {
    double w0 = (double)t->levels[0].width;
    for (auto& lv : t->levels) lv.downsample = w0 / (double)lv.width;
  }
}

static std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

static void build_properties(AtlasTiff* t) {
  std::string j = "{";
  auto add = [&](const std::string& k, const std::string& v) {
    if (j.size() > 1) j += ",";
    j += "\"" + json_escape(k) + "\":\"" + json_escape(v) + "\"";
  };
  const IFD& d0 = t->ifds[t->levels.empty() ? 0 : t->levels[0].ifd_index];
  if (!d0.description.empty()) add("tiff.ImageDescription", d0.description);
  if (d0.x_resolution > 0) {
    char buf[64];
    snprintf(buf, sizeof buf, "%.10g", d0.x_resolution);
    add("tiff.XResolution", buf);
    snprintf(buf, sizeof buf, "%.10g", d0.y_resolution);
    add("tiff.YResolution", buf);
    add("tiff.ResolutionUnit", d0.resolution_unit == 3 ? "centimeter"
                               : d0.resolution_unit == 2 ? "inch"
                                                         : "none");
  }
  // Aperio SVS: description fields are |-separated "Key = Value" pairs.
  const std::string& desc = d0.description;
  if (desc.rfind("Aperio", 0) == 0 || desc.find("|AppMag") != std::string::npos ||
      desc.find("|MPP") != std::string::npos) {
    add("atlas.vendor", "aperio");
    size_t start = 0;
    while (start < desc.size()) {
      size_t end = desc.find('|', start);
      std::string field = desc.substr(start, end == std::string::npos ? std::string::npos
                                                                      : end - start);
      size_t eq = field.find('=');
      if (eq != std::string::npos) {
        auto trim = [](std::string s) {
          size_t a = s.find_first_not_of(" \t\r\n");
          size_t b = s.find_last_not_of(" \t\r\n");
          return a == std::string::npos ? std::string() : s.substr(a, b - a + 1);
        };
        std::string key = trim(field.substr(0, eq));
        std::string val = trim(field.substr(eq + 1));
        if (!key.empty() && !val.empty()) add("aperio." + key, val);
      }
      if (end == std::string::npos) break;
      start = end + 1;
    }
  }
  if (t->ndpi) {
    add("atlas.vendor", "hamamatsu-ndpi");
    if (t->ndpi_lens0 > 0) {
      char buf[32];
      snprintf(buf, sizeof buf, "%g", t->ndpi_lens0);
      add("hamamatsu.SourceLens", buf);
    }
  } else if (t->scn) {
    add("atlas.vendor", "leica");
    if (t->scn_objective > 0) {
      char buf[32];
      snprintf(buf, sizeof buf, "%g", t->scn_objective);
      add("leica.objective", buf);
    }
  } else if (t->ventana) {
    add("atlas.vendor", "ventana");
    char buf[32];
    if (t->ventana_mag > 0) {
      snprintf(buf, sizeof buf, "%g", t->ventana_mag);
      add("ventana.Magnification", buf);
    }
    if (t->ventana_scanres > 0) {
      snprintf(buf, sizeof buf, "%g", t->ventana_scanres);
      add("ventana.ScanRes", buf);
    }
    if (t->ventana_joints > 0) {
      snprintf(buf, sizeof buf, "%g", t->ventana_overlap_x);
      add("ventana.OverlapX", buf);
      snprintf(buf, sizeof buf, "%g", t->ventana_overlap_y);
      add("ventana.OverlapY", buf);
    }
  } else if (t->philips) {
    add("atlas.vendor", "philips");
    if (t->philips_mpp > 0) {
      char buf[32];
      snprintf(buf, sizeof buf, "%.10g", t->philips_mpp);
      add("philips.PixelSpacing", buf);
    }
  } else if (t->trestle) {
    add("atlas.vendor", "trestle");
    if (t->trestle_objective > 0) {
      char buf[32];
      snprintf(buf, sizeof buf, "%g", t->trestle_objective);
      add("trestle.Objective Power", buf);
    }
    if (!t->trestle_overlaps.empty()) {
      std::string ov;
      for (size_t i = 0; i < t->trestle_overlaps.size(); ++i) {
        if (i) ov += ' ';
        ov += std::to_string(t->trestle_overlaps[i]);
      }
      add("trestle.OverlapsXY", ov);
    }
  }
  {
    char buf[32];
    snprintf(buf, sizeof buf, "%zu", t->levels.size());
    add("atlas.level-count", buf);
  }
  j += "}";
  t->properties_json = j;
}

// Decode the restart segments covering rows [y0,y1) × cols [x0,x1) of a
// single-strip JPEG image and write them into the RGB out window.
static bool read_region_striped(const AtlasTiff* t, const IFD& d,
                                const JpegStripeIndex& si, int64_t x, int64_t y,
                                int64_t w, int64_t x0, int64_t y0, int64_t x1,
                                int64_t y1, uint8_t* out, std::string* err) {
  const int64_t W = (int64_t)d.width, H = (int64_t)d.height;
  std::vector<uint8_t> mini, px;
  int64_t band0 = y0 / (int64_t)si.seg_px_h;
  int64_t band1 = (y1 - 1) / (int64_t)si.seg_px_h;
  int64_t gx0 = x0 / (int64_t)si.seg_px_w;
  int64_t gx1 = (x1 - 1) / (int64_t)si.seg_px_w;
  for (int64_t band = band0; band <= band1; ++band) {
    for (int64_t gx = gx0; gx <= gx1 && gx < (int64_t)si.segs_per_row; ++gx) {
      uint64_t sidx = (uint64_t)band * si.segs_per_row + (uint64_t)gx;
      if (sidx >= si.segs.size()) continue;
      int64_t sx = gx * (int64_t)si.seg_px_w;
      int64_t sy = band * (int64_t)si.seg_px_h;
      int64_t sw = std::min<int64_t>((int64_t)si.seg_px_w, W - sx);
      int64_t sh = std::min<int64_t>((int64_t)si.seg_px_h, H - sy);
      if (sw <= 0 || sh <= 0) continue;
      uint64_t soff = si.segs[sidx].first, slen = si.segs[sidx].second;
      // Mini-JPEG: copied headers, SOF patched to this segment's rectangle,
      // the segment's entropy bytes, EOI.
      mini.assign(si.header.begin(), si.header.end());
      mini[si.sof_dims_off + 0] = (uint8_t)(sh >> 8);
      mini[si.sof_dims_off + 1] = (uint8_t)(sh & 0xFF);
      mini[si.sof_dims_off + 2] = (uint8_t)(sw >> 8);
      mini[si.sof_dims_off + 3] = (uint8_t)(sw & 0xFF);
      size_t data_at = mini.size();
      mini.resize(data_at + (size_t)slen + 2);
      if (!t->file.read_at(soff, mini.data() + data_at, (size_t)slen)) {
        *err = "striped read failed";
        return false;
      }
      mini[mini.size() - 2] = 0xFF;
      mini[mini.size() - 1] = 0xD9;
      px.resize((size_t)(sw * sh * 3));
      if (!jpeg_decode_rgb({}, mini.data(), mini.size(), px.data(), (uint64_t)sw,
                           (uint64_t)sh, 3)) {
        *err = "striped JPEG decode failed";
        return false;
      }
      int64_t cx0 = std::max(x0, sx), cx1 = std::min(x1, sx + sw);
      int64_t cy0 = std::max(y0, sy), cy1 = std::min(y1, sy + sh);
      // MinIsWhite grayscale inverts, matching the generic chunk path.
      bool invert = d.photometric == 0 && d.spp == 1;
      for (int64_t yy = cy0; yy < cy1; ++yy) {
        const uint8_t* src = px.data() + (size_t)((yy - sy) * sw + (cx0 - sx)) * 3;
        uint8_t* dstp = out + (size_t)((yy - y) * w + (cx0 - x)) * 3;
        size_t nbytes = (size_t)(cx1 - cx0) * 3;
        if (invert) {
          for (size_t i = 0; i < nbytes; ++i) dstp[i] = (uint8_t)(255 - src[i]);
        } else {
          std::memcpy(dstp, src, nbytes);
        }
      }
    }
  }
  return true;
}

// Expand one run of decoded chunk samples to RGB: spp>=3 copies the first
// three channels, palette-color (photometric 3) looks indices up in the
// 8-bit RGB table, grayscale replicates (inverting for MinIsWhite).
static void samples_to_rgb(const IFD& d, const uint8_t* src, uint8_t* dst,
                           int64_t count) {
  if (d.spp >= 3) {
    for (int64_t i = 0; i < count; ++i) {
      dst[i * 3 + 0] = src[i * d.spp + 0];
      dst[i * 3 + 1] = src[i * d.spp + 1];
      dst[i * 3 + 2] = src[i * d.spp + 2];
    }
  } else if (!d.palette.empty()) {
    for (int64_t i = 0; i < count; ++i) {
      const uint8_t* p = d.palette.data() + (size_t)src[i] * 3;
      dst[i * 3 + 0] = p[0];
      dst[i * 3 + 1] = p[1];
      dst[i * 3 + 2] = p[2];
    }
  } else {
    // Walk at the sample stride: spp 2 is gray+alpha (ExtraSamples), whose
    // luma sits at every other byte — a stride-1 read would render the
    // interleaved alpha bytes as pixels.
    const bool invert = d.photometric == 0;
    for (int64_t i = 0; i < count; ++i) {
      uint8_t v = src[i * d.spp];
      if (invert) v = (uint8_t)(255 - v);
      dst[i * 3 + 0] = dst[i * 3 + 1] = dst[i * 3 + 2] = v;
    }
  }
}

// Fill an RGB window from one level. x/y are LEVEL coordinates.
// Positioned-tile painter for levels whose tiles overlap (Ventana BIF base
// level, Level::adv_x/adv_y > 0). Tile (c, r) of the raw mosaic is painted at
// (round(c*adv_x), round(r*adv_y)) in raster order, so the later (right /
// lower) tile wins the overlap strip — matching how OpenSlide's grid renders
// the TileJointInfo-derived placement. x0..y1 are the window's clamped bounds
// in CORRECTED level coordinates.
static bool read_region_positioned(const AtlasTiff* t, const IFD& d,
                                   size_t ifd_index, const Level& L, int64_t x,
                                   int64_t y, int64_t w, int64_t x0, int64_t y0,
                                   int64_t x1, int64_t y1, uint8_t* out,
                                   std::string* err) {
  const int64_t tw = (int64_t)d.tile_w, th = (int64_t)d.tile_h;
  if (tw <= 0 || th <= 0) {
    *err = "bad tile geometry";
    return false;
  }
  const int64_t cols = ((int64_t)d.width + tw - 1) / tw;
  const int64_t rows = ((int64_t)d.height + th - 1) / th;
  const double ax = L.adv_x > 0.0 ? L.adv_x : (double)tw;
  const double ay = L.adv_y > 0.0 ? L.adv_y : (double)th;
  auto px = [&](int64_t c) { return (int64_t)llround((double)c * ax); };
  auto py = [&](int64_t r) { return (int64_t)llround((double)r * ay); };
  // First/last tile columns touching [x0, x1): start from the float estimate,
  // then nudge — per-tile rounding can move an edge by one pixel either way.
  int64_t c0 = std::max<int64_t>(0, (int64_t)std::floor((double)(x0 - tw) / ax));
  while (c0 < cols && px(c0) + tw <= x0) ++c0;
  int64_t c1 = std::min<int64_t>(cols - 1, (int64_t)std::floor((double)x1 / ax));
  while (c1 >= 0 && px(c1) >= x1) --c1;
  int64_t r0 = std::max<int64_t>(0, (int64_t)std::floor((double)(y0 - th) / ay));
  while (r0 < rows && py(r0) + th <= y0) ++r0;
  int64_t r1 = std::min<int64_t>(rows - 1, (int64_t)std::floor((double)y1 / ay));
  while (r1 >= 0 && py(r1) >= y1) --r1;
  if (c0 > c1 || r0 > r1) return true;

  std::vector<uint8_t> chunk((size_t)(tw * th * d.spp));
  for (int64_t r = r0; r <= r1; ++r) {
    const int64_t oy = py(r);
    // Valid content of edge tiles is bounded by the RAW mosaic dims; the
    // padding beyond it is tile-box fill, never slide pixels.
    const int64_t vh = std::min<int64_t>(th, (int64_t)d.height - r * th);
    for (int64_t c = c0; c <= c1; ++c) {
      const int64_t ox = px(c);
      const int64_t vw = std::min<int64_t>(tw, (int64_t)d.width - c * tw);
      int64_t cx0 = std::max(x0, ox), cx1 = std::min(x1, ox + vw);
      int64_t cy0 = std::max(y0, oy), cy1 = std::min(y1, oy + vh);
      if (cx0 >= cx1 || cy0 >= cy1) continue;
      if (!t->decode_chunk_cached(d, ifd_index, (uint64_t)(r * cols + c),
                                  chunk.data(), (uint64_t)tw, (uint64_t)th, err))
        return false;
      for (int64_t yy = cy0; yy < cy1; ++yy) {
        const uint8_t* src =
            chunk.data() + (size_t)((yy - oy) * tw + (cx0 - ox)) * d.spp;
        uint8_t* dstp = out + (size_t)((yy - y) * w + (cx0 - x)) * 3;
        samples_to_rgb(d, src, dstp, cx1 - cx0);
      }
    }
  }
  return true;
}

static bool read_region_impl(const AtlasTiff* t, int level, int64_t x, int64_t y,
                             int64_t w, int64_t h, uint8_t* out, std::string* err) {
  if (level < 0 || level >= (int)t->levels.size()) {
    *err = "level out of range";
    return false;
  }
  const IFD& d = t->level_ifd(level);
  const Level& L = t->levels[level];
  // Level dims, not IFD dims: they differ when AOI join-overlap correction
  // shrinks the canvas (equal everywhere else).
  const int64_t W = (int64_t)L.width, H = (int64_t)L.height;
  // Out-of-bounds background: black, matching OpenSlide's read_region
  // semantics (transparent RGBA -> black after RGB conversion), which the
  // reference pipeline sees (openslide_wsi.py:198). Deferred until a paint
  // path is actually chosen: on corrupt files the decode checks below can
  // reject the request cheaply, and pre-filling a multi-gigabyte window
  // first was a measured multi-minute stall on fuzzed dimension tags.
  bool bg_filled = false;
  auto fill_bg = [&] {
    if (!bg_filled) std::memset(out, 0, (size_t)(w * h * 3));
    bg_filled = true;
  };

  int64_t cw = d.tiled ? (int64_t)d.tile_w : W;
  int64_t chh = d.tiled ? (int64_t)d.tile_h : (int64_t)d.rows_per_strip;
  if (cw <= 0 || chh <= 0) {
    *err = "bad chunk geometry";
    return false;
  }
  int64_t tiles_across = d.tiled ? (W + cw - 1) / cw : 1;

  int64_t x0 = std::max<int64_t>(0, x), y0 = std::max<int64_t>(0, y);
  int64_t x1 = std::min<int64_t>(W, x + w), y1 = std::min<int64_t>(H, y + h);
  if (x0 >= x1 || y0 >= y1) {
    fill_bg();  // fully out of bounds: the window IS the background
    return true;
  }

  if (L.adv_x > 0.0 || L.adv_y > 0.0) {
    fill_bg();
    return read_region_positioned(t, d, L.ifd_index, L, x, y, w, x0, y0, x1, y1,
                                  out, err);
  }

  // Single-strip whole-image JPEGs (NDPI levels): decode stripe-wise via
  // restart markers when the declared SOF dims disagree with the TIFF tags
  // (images beyond JPEG's 65,535-px fields) or a full decode would be huge.
  // The header probe is cheap; the entropy scan runs only if striping is
  // actually chosen. A stream whose header we cannot parse (e.g.
  // progressive) with no evidence of mismatch falls through to the normal
  // whole-strip libjpeg decode.
  if (!d.tiled && d.compression == 7 && d.chunk_offsets.size() == 1 &&
      d.jpeg_tables.empty() && (d.spp == 1 || d.spp == 3)) {
    // The size-only trigger avoids whole-level decodes of multi-GiB
    // single-JPEG levels (NDPI or generic). It is advisory: when the stripe
    // index is unusable we try the row-capped sequential decode, then fall
    // back to the whole-strip decode rather than failing files that used to
    // work.
    // Threshold overridable for tests (real trigger files are >1 GiB).
    uint64_t huge_bytes = 1ull << 30;
    if (const char* e = std::getenv("ATLASPATCH_TIFF_HUGE_BYTES")) {
      char* end = nullptr;
      unsigned long long v = std::strtoull(e, &end, 10);
      if (end != e && v > 0) huge_bytes = (uint64_t)v;
    }
    bool huge = (uint64_t)W * (uint64_t)H * 3ull > huge_bytes;
    JpegStripeIndex* si = t->stripe_index(t->levels[level].ifd_index);
    // Evidence of mismatch requires an actually-parsed baseline SOF; zeroed
    // dims (what NDPI writers emit past 65,535 px) count as mismatching.
    // Headers we cannot parse (e.g. progressive) fall through to libjpeg.
    bool mismatch = si->sof_seen &&
                    (si->hdr_w != d.width || si->hdr_h != d.height);
    if (huge || mismatch) {
      // Generic (non-NDPI) huge streams with trustworthy dims prefer the
      // row-capped sequential decode: bit-identical to the whole-strip
      // decode these files previously got (striping's standalone-segment
      // 4:2:0 upsampling can differ by a few LSBs at segment boundaries)
      // while keeping memory bounded to one scanline. NDPI keeps the
      // striped path — its giant levels need the random access.
      if (!t->ndpi && huge && !mismatch && si->seq_ok) {
        std::string seq_err;
        fill_bg();
        if (read_region_jpeg_sequential(t, d, *si, x, y, w, x0, y0, x1, y1, out,
                                        &seq_err))
          return true;
      }
      bool ok;
      {
        std::lock_guard<std::mutex> g(t->stripe_mu);
        ok = si->usable && scan_stripe_segments(t->file, si);
      }
      if (!ok) {
        // No usable restart segments (e.g. no DRI, misaligned interval):
        // stream a sequential top-down decode capped at the needed rows —
        // bounded memory, bit-identical pixels. Feasibility checks (width/
        // rows beyond JPEG's 65,535 fields) run BEFORE the background fill
        // so corrupt giant dims fail without touching the window.
        std::string seq_err;
        if (si->seq_ok && (int64_t)d.width <= 65535 && y1 <= 65535) {
          fill_bg();
          if (read_region_jpeg_sequential(t, d, *si, x, y, w, x0, y0, x1, y1,
                                          out, &seq_err))
            return true;
        } else if (si->seq_ok) {
          seq_err = "window needs restart markers (dims beyond 65,535)";
        }
        if (huge && !mismatch) goto whole_strip;  // size heuristic only: retry whole
        *err = "single-strip JPEG needs striped decode but " + si->reason;
        if (!seq_err.empty()) *err += "; sequential fallback: " + seq_err;
        return false;
      }
      fill_bg();
      return read_region_striped(t, d, *si, x, y, w, x0, y0, x1, y1, out, err);
    }
  }
whole_strip:

  // Single-chunk whole-image JPEGs are exempt from the parse-time strip
  // bounds (legit NDPI levels are genuinely giant), so a corrupt width can
  // reach this fallback declaring a multi-gigabyte decode buffer. Real
  // whole-strip decodes are bounded by JPEG's 65,535-px SOF fields; refuse
  // before committing the background fill + chunk allocation.
  if ((uint64_t)cw * (uint64_t)chh * d.spp > (2ull << 30)) {
    *err = "chunk decode buffer implausibly large (corrupt dims?)";
    return false;
  }
  fill_bg();
  std::vector<uint8_t> chunk((size_t)(cw * chh * d.spp));
  for (int64_t ty = y0 / chh; ty * chh < y1; ++ty) {
    for (int64_t tx = (d.tiled ? x0 / cw : 0); tx * cw < (d.tiled ? x1 : 1); ++tx) {
      uint64_t idx = d.tiled ? (uint64_t)(ty * tiles_across + tx) : (uint64_t)ty;
      // strip height may be clamped at image bottom; decode into full box anyway
      int64_t this_ch = chh;
      if (!d.tiled) this_ch = std::min<int64_t>(chh, H - ty * chh);
      if (!t->decode_chunk_cached(d, t->levels[level].ifd_index, idx, chunk.data(),
                                  (uint64_t)cw, (uint64_t)this_ch, err))
        return false;
      int64_t cx0 = std::max<int64_t>(x0, tx * cw);
      int64_t cx1 = std::min<int64_t>(x1, d.tiled ? (tx + 1) * cw : W);
      int64_t cy0 = std::max<int64_t>(y0, ty * chh);
      int64_t cy1 = std::min<int64_t>(y1, ty * chh + this_ch);
      for (int64_t yy = cy0; yy < cy1; ++yy) {
        const uint8_t* src =
            chunk.data() + (size_t)((yy - ty * chh) * cw + (cx0 - tx * cw)) * d.spp;
        uint8_t* dstp = out + (size_t)((yy - y) * w + (cx0 - x)) * 3;
        samples_to_rgb(d, src, dstp, cx1 - cx0);
      }
    }
  }
  return true;
}

// Fill an RGB window decoded at 1/scale. x/y/w/h are LEVEL coordinates; out
// holds ceil(w/s) × ceil(h/s) × 3 bytes. Only JPEG-compressed chunked levels
// qualify (the DCT-domain downscale is what makes this cheap); anything else
// returns kScaledUnsupported and the caller falls back to a full-resolution
// read plus host resize. Thumbnail generation is the target: the reference
// reads a whole pyramid level then cv2-resizes it down (reference:
// atlas_patch/core/wsi/iwsi.py:246-323); decoding at 1/4 via libjpeg does the
// same work in ~1/5 the cycles on this path.
static constexpr int kScaledUnsupported = -2;

static int read_region_scaled_impl(const AtlasTiff* t, int level, int64_t x,
                                   int64_t y, int64_t w, int64_t h, unsigned s,
                                   uint8_t* out, std::string* err) {
  if (s == 1) return read_region_impl(t, level, x, y, w, h, out, err) ? 0 : -1;
  if (s != 2 && s != 4 && s != 8) return kScaledUnsupported;
  if (level < 0 || level >= (int)t->levels.size()) {
    *err = "level out of range";
    return -1;
  }
  const IFD& d = t->level_ifd(level);
  // Overlap-corrected (Ventana) levels paint tiles at fractional advances;
  // the scaled fast path assumes an abutting grid — fall back.
  if (t->levels[level].adv_x > 0.0 || t->levels[level].adv_y > 0.0)
    return kScaledUnsupported;
  if (d.compression != 7 || (d.spp != 1 && d.spp != 3)) return kScaledUnsupported;
  // NDPI-style giant single-strip JPEGs go through the striped decoder; keep
  // the fast path to plain tiled/striped pyramids.
  if (!d.tiled && d.chunk_offsets.size() == 1 && d.jpeg_tables.empty())
    return kScaledUnsupported;

  const int64_t W = (int64_t)d.width, H = (int64_t)d.height;
  int64_t cw = d.tiled ? (int64_t)d.tile_w : W;
  int64_t chh = d.tiled ? (int64_t)d.tile_h : (int64_t)d.rows_per_strip;
  if (cw <= 0 || chh <= 0) {
    *err = "bad chunk geometry";
    return -1;
  }
  // Chunk boxes must land on the scale grid or tile seams would shift. A
  // ragged chunk height is fine only when it is the single/last chunk row.
  if (x % s || y % s || cw % s) return kScaledUnsupported;
  if (chh % s && chh < H) return kScaledUnsupported;

  const int64_t Ws = (W + s - 1) / s, Hs = (H + s - 1) / s;
  const int64_t xs = x / (int64_t)s, ys = y / (int64_t)s;
  const int64_t ws = (w + s - 1) / s, hs = (h + s - 1) / s;
  std::memset(out, 0, (size_t)(ws * hs * 3));

  int64_t x0s = std::max<int64_t>(0, xs), y0s = std::max<int64_t>(0, ys);
  int64_t x1s = std::min<int64_t>(Ws, xs + ws), y1s = std::min<int64_t>(Hs, ys + hs);
  if (x0s >= x1s || y0s >= y1s) return 0;

  const int64_t cws = cw / s;                    // chunk box in scaled space
  const int64_t chs_box = (chh + s - 1) / s;     // strip rows (ceil: last strip)
  int64_t tiles_across = d.tiled ? (W + cw - 1) / cw : 1;

  std::vector<uint8_t> chunk((size_t)(cws * chs_box * d.spp));
  int64_t ty0 = (y0s * (int64_t)s) / chh, ty1 = ((y1s - 1) * (int64_t)s) / chh;
  int64_t tx0 = d.tiled ? (x0s * (int64_t)s) / cw : 0;
  int64_t tx1 = d.tiled ? ((x1s - 1) * (int64_t)s) / cw : 0;
  for (int64_t ty = ty0; ty <= ty1; ++ty) {
    for (int64_t tx = tx0; tx <= tx1; ++tx) {
      uint64_t idx = d.tiled ? (uint64_t)(ty * tiles_across + tx) : (uint64_t)ty;
      int64_t this_ch = d.tiled ? chh : std::min<int64_t>(chh, H - ty * chh);
      if (!t->decode_chunk_scaled(d, idx, chunk.data(), (uint64_t)cw,
                                  (uint64_t)this_ch, s, err))
        return -1;
      int64_t cxs = tx * cws;                       // chunk origin, scaled space
      int64_t cys = ty * (chh / (int64_t)s);
      int64_t chs = (this_ch + (int64_t)s - 1) / (int64_t)s;
      int64_t cx0 = std::max(x0s, cxs), cx1 = std::min(x1s, cxs + cws);
      int64_t cy0 = std::max(y0s, cys), cy1 = std::min(y1s, cys + chs);
      for (int64_t yy = cy0; yy < cy1; ++yy) {
        const uint8_t* src =
            chunk.data() + (size_t)((yy - cys) * cws + (cx0 - cxs)) * d.spp;
        uint8_t* dstp = out + (size_t)((yy - ys) * ws + (cx0 - xs)) * 3;
        int64_t count = cx1 - cx0;
        if (d.spp == 3) {
          std::memcpy(dstp, src, (size_t)count * 3);
        } else {  // grayscale (JPEG-only path: palette never reaches here)
          samples_to_rgb(d, src, dstp, count);
        }
      }
    }
  }
  return 0;
}

}  // namespace

// ----------------------------------------------------------------- public API
extern "C" {

void* atlas_open(const char* path, char* err, int errlen) {
  auto fail = [&](const std::string& msg) -> void* {
    if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
    return nullptr;
  };
  // Corrupt headers can declare absurd dimensions/counts; allocation failures
  // must surface as errors, never std::terminate.
  try {
    auto t = std::make_unique<AtlasTiff>();
    if (!t->file.open(path)) return fail("cannot open file");
    if (!parse_ifds(t.get())) return fail(t->error.empty() ? "parse failed" : t->error);
    build_levels(t.get());
    if (t->levels.empty()) return fail("no decodable pyramid levels");
    build_properties(t.get());
    return t.release();
  } catch (const std::exception& ex) {
    return fail(std::string("open failed: ") + ex.what());
  } catch (...) {
    return fail("open failed: unknown C++ exception");
  }
}

void atlas_close(void* handle) { delete static_cast<AtlasTiff*>(handle); }

int atlas_num_levels(void* handle) {
  return (int)static_cast<AtlasTiff*>(handle)->levels.size();
}

void atlas_level_info(void* handle, int level, int64_t* w, int64_t* h, double* ds) {
  auto* t = static_cast<AtlasTiff*>(handle);
  if (level < 0 || level >= (int)t->levels.size()) {
    *w = *h = 0;
    *ds = 0;
    return;
  }
  *w = (int64_t)t->levels[level].width;
  *h = (int64_t)t->levels[level].height;
  *ds = t->levels[level].downsample;
}

const char* atlas_properties_json(void* handle) {
  return static_cast<AtlasTiff*>(handle)->properties_json.c_str();
}

// x, y are LEVEL coordinates; out must hold w*h*3 bytes (RGB).
int atlas_read_region(void* handle, int level, int64_t x, int64_t y, int64_t w,
                      int64_t h, uint8_t* out, char* err, int errlen) {
  auto* t = static_cast<AtlasTiff*>(handle);
  std::string e;
  try {
    if (read_region_impl(t, level, x, y, w, h, out, &e)) return 0;
  } catch (const std::exception& ex) {
    e = std::string("read failed: ") + ex.what();
  } catch (...) {
    e = "read failed: unknown C++ exception";
  }
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.c_str());
  return -1;
}

// Scaled region read: decode at 1/scale_denom via libjpeg IDCT downscaling.
// out must hold ceil(w/scale)*ceil(h/scale)*3 bytes. Returns 0 on success,
// -2 when this level/geometry does not support scaled decode (caller falls
// back to atlas_read_region + host resize), -1 on error.
int atlas_read_region_scaled(void* handle, int level, int64_t x, int64_t y,
                             int64_t w, int64_t h, int scale_denom, uint8_t* out,
                             char* err, int errlen) {
  auto* t = static_cast<AtlasTiff*>(handle);
  std::string e;
  int rc = -1;
  try {
    rc = read_region_scaled_impl(t, level, x, y, w, h,
                                 scale_denom > 0 ? (unsigned)scale_denom : 1, out, &e);
    if (rc >= 0 || rc == kScaledUnsupported) return rc;
  } catch (const std::exception& ex) {
    e = std::string("scaled read failed: ") + ex.what();
  } catch (...) {
    e = "scaled read failed: unknown C++ exception";
  }
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.c_str());
  return -1;
}

// Standalone JPEG2000 decode (DICOM transfer syntaxes 1.2.840.10008.1.2.4.90/.91).
// out must hold w*h*spp bytes; dims/spp come from the container's metadata.
int atlas_j2k_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t w,
                     int64_t h, int spp, int force_ycbcr, char* err, int errlen) {
  std::string e;
  if (j2k_decode(data, (size_t)n, out, (uint64_t)w, (uint64_t)h, (uint32_t)spp,
                 force_ycbcr != 0, &e))
    return 0;
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.c_str());
  return -1;
}

// --- standalone JPEG helpers ---------------------------------------------
// Tile decode for the non-TIFF slide containers (MIRAX .mrxs, Hamamatsu .vms,
// DICOM WSI) whose tiles are raw JFIF streams rather than TIFF chunks
// (reference reads these via OpenSlide: atlas_patch/core/wsi/wsi_factory.py:20-39).
// scale_denom ∈ {1,2,4,8} exposes libjpeg's DCT-domain downscaling, used by
// the Hamamatsu backend to derive pyramid levels the way OpenSlide does.

// Probe output dimensions at a given scale. Returns 0 on success.
int atlas_jpeg_info(const uint8_t* data, int64_t n, int scale_denom, int64_t* w,
                    int64_t* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? (unsigned)scale_denom : 1;
  jpeg_calc_output_dimensions(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode a whole JPEG stream to RGB at 1/scale_denom. out must hold exactly
// w*h*3 bytes where (w,h) came from atlas_jpeg_info at the same scale.
// Returns 0 on success.
int atlas_jpeg_decode(const uint8_t* data, int64_t n, int scale_denom,
                      uint8_t* out, int64_t w, int64_t h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts grayscale/YCbCr for us
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? (unsigned)scale_denom : 1;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != (JDIMENSION)w || cinfo.output_height != (JDIMENSION)h ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  JSAMPROW rowptr;
  while (cinfo.output_scanline < cinfo.output_height) {
    rowptr = out + (uint64_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Windowed standalone-JPEG decode: only the (x, y, w, h) window — in SCALED
// output coordinates — is produced, via libjpeg-turbo's jpeg_crop_scanline
// (horizontal iMCU crop) + jpeg_skip_scanlines (cheap vertical skip). A
// multi-gigapixel Hamamatsu VMS image no longer decodes (or allocates)
// whole per patch read; cost scales with the window's MCU rows, not the
// image (OpenSlide uses its restart-marker optimisation file for the same
// purpose). out must hold w*h*3 bytes. Returns 0 on success.
int atlas_jpeg_decode_window(const uint8_t* data, int64_t n, int scale_denom,
                             int64_t x, int64_t y, int64_t w, int64_t h,
                             uint8_t* out) {
  if (w <= 0 || h <= 0 || x < 0 || y < 0) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? (unsigned)scale_denom : 1;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3 ||
      (JDIMENSION)(x + w) > cinfo.output_width ||
      (JDIMENSION)(y + h) > cinfo.output_height) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  // Decode with a 16px margin on every side, then trim: fancy chroma
  // upsampling needs neighbor context, so pixels right at a crop/skip
  // boundary would differ from a whole-image decode by a few LSBs. One
  // iMCU of margin restores full context — output is bit-identical.
  const int64_t W = cinfo.output_width;
  const int64_t margin = 16;
  const int64_t mx = std::max<int64_t>(0, x - margin);
  const int64_t my = std::max<int64_t>(0, y - margin);
  const int64_t mw = std::min<int64_t>(W - mx, (x - mx) + w + margin);
  JDIMENSION cx = (JDIMENSION)mx, cw = (JDIMENSION)mw;
  jpeg_crop_scanline(&cinfo, &cx, &cw);
  const int64_t x_in_crop = x - (int64_t)cx;
  std::vector<uint8_t> rowbuf((size_t)cw * 3);
  JSAMPROW rowptr = rowbuf.data();
  if (my > 0) jpeg_skip_scanlines(&cinfo, (JDIMENSION)my);
  for (int64_t row = (int64_t)my; row < y + h; ++row) {
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    if (row < y) continue;  // vertical margin rows: context only
    std::memcpy(out + (size_t)(row - y) * w * 3,
                rowbuf.data() + (size_t)x_in_crop * 3, (size_t)w * 3);
  }
  jpeg_abort_decompress(&cinfo);  // remaining rows intentionally unread
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
