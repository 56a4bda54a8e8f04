// JPEG2000 tile decode for Aperio SVS (TIFF compression 33003 / 33005).
//
// Aperio stores each tile as a raw JPEG2000 codestream (SOC marker ff4f).
// Compression 33005 carries RGB components; 33003 carries YCbCr components
// with the color transform applied OUTSIDE the codestream (no MCT flag), so
// the decoder must convert back to RGB itself — the same contract OpenSlide
// implements for these tags (reference behavior: atlas_patch uses OpenSlide
// for SVS decode; see SURVEY.md §2 "WSI backends").
//
// openjpeg is linked at runtime via dlopen("libopenjp2.so.7") with a locally
// declared ABI (the distro ships the shared library but no headers). Where
// the system has no libopenjp2, the loader tries the path handed to
// atlas_j2k_set_library() (the copy bundled with Pillow, under a hashed
// name). If neither loads, j2k_decode reports a clear error and every other
// compression scheme keeps working.

#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <mutex>
#include <string>
#include <vector>

// ----------------------------------------------------------- openjpeg 2.x ABI
// Minimal declarations matching openjpeg.h (v2.1+ stable public ABI).
typedef int OPJ_BOOL;
typedef uint32_t OPJ_UINT32;
typedef int32_t OPJ_INT32;
typedef uint16_t OPJ_UINT16;
typedef uint64_t OPJ_UINT64;
typedef int64_t OPJ_OFF_T;
typedef size_t OPJ_SIZE_T;

enum { OPJ_CODEC_J2K = 0, OPJ_CODEC_JP2 = 2 };
enum { OPJ_CLRSPC_SYCC = 3 };

struct opj_image_comp {
  OPJ_UINT32 dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
  OPJ_INT32* data;
  OPJ_UINT16 alpha;
};

struct opj_image {
  OPJ_UINT32 x0, y0, x1, y1, numcomps;
  int color_space;
  opj_image_comp* comps;
  uint8_t* icc_profile_buf;
  OPJ_UINT32 icc_profile_len;
};

typedef OPJ_SIZE_T (*opj_stream_read_fn)(void*, OPJ_SIZE_T, void*);
typedef OPJ_OFF_T (*opj_stream_skip_fn)(OPJ_OFF_T, void*);
typedef OPJ_BOOL (*opj_stream_seek_fn)(OPJ_OFF_T, void*);
typedef void (*opj_stream_free_user_data_fn)(void*);

struct OpjApi {
  void* (*create_decompress)(int);
  void (*destroy_codec)(void*);
  void (*set_default_decoder_parameters)(void*);
  OPJ_BOOL (*setup_decoder)(void*, void*);
  void* (*stream_default_create)(OPJ_BOOL);
  void (*stream_destroy)(void*);
  void (*stream_set_read_function)(void*, opj_stream_read_fn);
  void (*stream_set_skip_function)(void*, opj_stream_skip_fn);
  void (*stream_set_seek_function)(void*, opj_stream_seek_fn);
  void (*stream_set_user_data)(void*, void*, opj_stream_free_user_data_fn);
  void (*stream_set_user_data_length)(void*, OPJ_UINT64);
  OPJ_BOOL (*read_header)(void*, void*, opj_image**);
  OPJ_BOOL (*decode)(void*, void*, opj_image*);
  OPJ_BOOL (*end_decompress)(void*, void*);
  void (*image_destroy)(opj_image*);
  OPJ_BOOL (*codec_set_threads)(void*, int);  // optional (2.2+); may be null
  bool ok = false;
};

static OpjApi g_opj;
static std::once_flag g_opj_once;
static std::string g_opj_fallback;  // set before the first decode

static void load_opj() {
  void* h = dlopen("libopenjp2.so.7", RTLD_NOW | RTLD_LOCAL);
  if (!h) h = dlopen("libopenjp2.so", RTLD_NOW | RTLD_LOCAL);
  if (!h && !g_opj_fallback.empty()) h = dlopen(g_opj_fallback.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!h) return;
  auto sym = [&](const char* n) { return dlsym(h, n); };
  g_opj.create_decompress = (void* (*)(int))sym("opj_create_decompress");
  g_opj.destroy_codec = (void (*)(void*))sym("opj_destroy_codec");
  g_opj.set_default_decoder_parameters =
      (void (*)(void*))sym("opj_set_default_decoder_parameters");
  g_opj.setup_decoder = (OPJ_BOOL(*)(void*, void*))sym("opj_setup_decoder");
  g_opj.stream_default_create =
      (void* (*)(OPJ_BOOL))sym("opj_stream_default_create");
  g_opj.stream_destroy = (void (*)(void*))sym("opj_stream_destroy");
  g_opj.stream_set_read_function =
      (void (*)(void*, opj_stream_read_fn))sym("opj_stream_set_read_function");
  g_opj.stream_set_skip_function =
      (void (*)(void*, opj_stream_skip_fn))sym("opj_stream_set_skip_function");
  g_opj.stream_set_seek_function =
      (void (*)(void*, opj_stream_seek_fn))sym("opj_stream_set_seek_function");
  g_opj.stream_set_user_data = (void (*)(void*, void*, opj_stream_free_user_data_fn))sym(
      "opj_stream_set_user_data");
  g_opj.stream_set_user_data_length =
      (void (*)(void*, OPJ_UINT64))sym("opj_stream_set_user_data_length");
  g_opj.read_header = (OPJ_BOOL(*)(void*, void*, opj_image**))sym("opj_read_header");
  g_opj.decode = (OPJ_BOOL(*)(void*, void*, opj_image*))sym("opj_decode");
  g_opj.end_decompress = (OPJ_BOOL(*)(void*, void*))sym("opj_end_decompress");
  g_opj.image_destroy = (void (*)(opj_image*))sym("opj_image_destroy");
  g_opj.codec_set_threads = (OPJ_BOOL(*)(void*, int))sym("opj_codec_set_threads");
  g_opj.ok = g_opj.create_decompress && g_opj.destroy_codec &&
             g_opj.set_default_decoder_parameters && g_opj.setup_decoder &&
             g_opj.stream_default_create && g_opj.stream_destroy &&
             g_opj.stream_set_read_function && g_opj.stream_set_skip_function &&
             g_opj.stream_set_seek_function && g_opj.stream_set_user_data &&
             g_opj.stream_set_user_data_length && g_opj.read_header &&
             g_opj.decode && g_opj.end_decompress && g_opj.image_destroy;
}

// ------------------------------------------------------------- memory stream
struct MemStream {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

static OPJ_SIZE_T mem_read(void* buf, OPJ_SIZE_T n, void* user) {
  MemStream* s = (MemStream*)user;
  if (s->pos >= s->size) return (OPJ_SIZE_T)-1;
  size_t take = std::min((size_t)n, s->size - s->pos);
  memcpy(buf, s->data + s->pos, take);
  s->pos += take;
  return take;
}

static OPJ_OFF_T mem_skip(OPJ_OFF_T n, void* user) {
  MemStream* s = (MemStream*)user;
  if (n < 0) return -1;
  size_t take = std::min((size_t)n, s->size - s->pos);
  s->pos += take;
  return take ? (OPJ_OFF_T)take : (OPJ_OFF_T)-1;
}

static OPJ_BOOL mem_seek(OPJ_OFF_T n, void* user) {
  MemStream* s = (MemStream*)user;
  if (n < 0 || (size_t)n > s->size) return 0;
  s->pos = (size_t)n;
  return 1;
}

// ------------------------------------------------------------------- decode
static inline uint8_t clamp_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Sample component `c` at full-resolution pixel (x, y), honoring chroma
// subsampling (dx/dy) and precision.
static inline int comp_sample(const opj_image_comp& c, uint64_t x, uint64_t y) {
  uint64_t sx = x / (c.dx ? c.dx : 1);
  uint64_t sy = y / (c.dy ? c.dy : 1);
  if (sx >= c.w) sx = c.w ? c.w - 1 : 0;
  if (sy >= c.h) sy = c.h ? c.h - 1 : 0;
  int v = c.data[sy * c.w + sx];
  if (c.sgnd) v += 1 << (c.prec - 1);
  if (c.prec > 8)
    v >>= (c.prec - 8);
  else if (c.prec < 8)
    v <<= (8 - c.prec);
  return v;
}

// Library to dlopen when neither system soname exists. It takes effect only
// when set before the first decode (the loader runs once).
extern "C" void atlas_j2k_set_library(const char* path) {
  if (path) g_opj_fallback = path;
}

// Decode one J2K/JP2 codestream into an spp-interleaved (cw × ch) buffer.
// force_ycbcr: compression tag 33003 — components are YCbCr regardless of the
// codestream's (usually unspecified) color-space field.
bool j2k_decode(const uint8_t* src, size_t n, uint8_t* out, uint64_t cw,
                uint64_t ch, uint32_t spp, bool force_ycbcr, std::string* err) {
  std::call_once(g_opj_once, load_opj);
  if (!g_opj.ok) {
    *err = "JPEG2000 tile but libopenjp2 is not available";
    return false;
  }
  int fmt = OPJ_CODEC_J2K;
  static const uint8_t jp2_magic[8] = {0, 0, 0, 0x0c, 'j', 'P', ' ', ' '};
  if (n >= 8 && memcmp(src, jp2_magic, 8) == 0) fmt = OPJ_CODEC_JP2;

  void* codec = g_opj.create_decompress(fmt);
  if (!codec) {
    *err = "opj_create_decompress failed";
    return false;
  }
  // opj_dparameters_t is ~8.3 KB (two 4096-byte path buffers); over-allocate
  // so the default-parameters write can never run past our buffer.
  std::vector<uint8_t> params(16384, 0);
  g_opj.set_default_decoder_parameters(params.data());
  if (!g_opj.setup_decoder(codec, params.data())) {
    g_opj.destroy_codec(codec);
    *err = "opj_setup_decoder failed";
    return false;
  }
  if (g_opj.codec_set_threads) g_opj.codec_set_threads(codec, 1);

  void* stream = g_opj.stream_default_create(1 /*input*/);
  if (!stream) {
    g_opj.destroy_codec(codec);
    *err = "opj_stream create failed";
    return false;
  }
  MemStream ms{src, n, 0};
  g_opj.stream_set_read_function(stream, mem_read);
  g_opj.stream_set_skip_function(stream, mem_skip);
  g_opj.stream_set_seek_function(stream, mem_seek);
  g_opj.stream_set_user_data(stream, &ms, nullptr);
  g_opj.stream_set_user_data_length(stream, n);

  opj_image* image = nullptr;
  bool ok = g_opj.read_header(stream, codec, &image) &&
            g_opj.decode(codec, stream, image) &&
            g_opj.end_decompress(codec, stream);
  if (!ok || !image || image->numcomps == 0 || !image->comps ||
      !image->comps[0].data) {
    *err = "JPEG2000 decode failed";
    if (image) g_opj.image_destroy(image);
    g_opj.stream_destroy(stream);
    g_opj.destroy_codec(codec);
    return false;
  }

  // Validate everything the sampling loop assumes BEFORE touching pixel
  // data: this entry point also serves DICOM streams (less controlled than
  // Aperio tiles), and openjpeg accepts states the loop below would turn
  // into null derefs / UB shifts / silently shifted pixels.
  const uint32_t nc = image->numcomps;
  const uint32_t used = nc >= 3 ? 3 : 1;
  auto fail = [&](const char* what) {
    *err = what;
    g_opj.image_destroy(image);
    g_opj.stream_destroy(stream);
    g_opj.destroy_codec(codec);
    return false;
  };
  if (spp == 0 || spp > 4)
    return fail("unsupported samples_per_pixel for JPEG2000 chunk");
  if (image->x0 != 0 || image->y0 != 0)
    return fail("JPEG2000 nonzero reference-grid origin is not supported");
  for (uint32_t c = 0; c < used; ++c) {
    const opj_image_comp& cc = image->comps[c];
    if (!cc.data || cc.w == 0 || cc.h == 0)
      return fail("JPEG2000 component missing decoded data");
    if (cc.x0 != 0 || cc.y0 != 0)
      return fail("JPEG2000 nonzero component origin is not supported");
    if (cc.prec < 1 || cc.prec > 16)
      return fail("JPEG2000 component precision outside 1..16");
  }
  bool ycc = force_ycbcr || (nc >= 3 && image->color_space == OPJ_CLRSPC_SYCC);
  const opj_image_comp* comps = image->comps;

  // Fast paths for the dominant shapes (8-bit unsigned, no chroma
  // subsampling, full-size components): walk component rows directly — the
  // generic loop below pays per-pixel divides and clamps the compiler can't
  // hoist, which is measurable host time per tile on small hosts.
  auto plain8 = [&](const opj_image_comp& c) {
    return c.dx <= 1 && c.dy <= 1 && c.prec == 8 && !c.sgnd && c.w >= cw &&
           c.h >= ch;
  };
  if (spp == 3 && nc >= 3 && plain8(comps[0]) && plain8(comps[1]) &&
      plain8(comps[2])) {
    for (uint64_t y = 0; y < ch; ++y) {
      uint8_t* row = out + y * cw * 3;
      const OPJ_INT32* c0 = comps[0].data + y * comps[0].w;
      const OPJ_INT32* c1 = comps[1].data + y * comps[1].w;
      const OPJ_INT32* c2 = comps[2].data + y * comps[2].w;
      if (ycc) {
        for (uint64_t x = 0; x < cw; ++x) {
          int Y = c0[x], cb = c1[x] - 128, cr = c2[x] - 128;
          row[x * 3 + 0] = clamp_u8(Y + ((91881 * cr + 32768) >> 16));
          row[x * 3 + 1] =
              clamp_u8(Y - ((22554 * cb + 46802 * cr + 32768) >> 16));
          row[x * 3 + 2] = clamp_u8(Y + ((116130 * cb + 32768) >> 16));
        }
      } else {
        // Clamp like the generic path: corrupt streams can decode
        // coefficients outside 0..255 even at prec 8, and a bare cast would
        // wrap them instead of saturating.
        for (uint64_t x = 0; x < cw; ++x) {
          row[x * 3 + 0] = clamp_u8(c0[x]);
          row[x * 3 + 1] = clamp_u8(c1[x]);
          row[x * 3 + 2] = clamp_u8(c2[x]);
        }
      }
    }
    g_opj.image_destroy(image);
    g_opj.stream_destroy(stream);
    g_opj.destroy_codec(codec);
    return true;
  }

  for (uint64_t y = 0; y < ch; ++y) {
    uint8_t* row = out + y * cw * spp;
    for (uint64_t x = 0; x < cw; ++x) {
      uint8_t px[4] = {0, 0, 0, 255};
      if (nc >= 3 && ycc) {
        // Full-range YCbCr → RGB, libjpeg-style 16-bit fixed point.
        int Y = comp_sample(comps[0], x, y);
        int cb = comp_sample(comps[1], x, y) - 128;
        int cr = comp_sample(comps[2], x, y) - 128;
        px[0] = clamp_u8(Y + ((91881 * cr + 32768) >> 16));
        px[1] = clamp_u8(Y - ((22554 * cb + 46802 * cr + 32768) >> 16));
        px[2] = clamp_u8(Y + ((116130 * cb + 32768) >> 16));
      } else if (nc >= 3) {
        // comp_sample does not saturate: corrupt streams can decode
        // coefficients outside [0, 2^prec), which a bare cast would wrap.
        px[0] = clamp_u8(comp_sample(comps[0], x, y));
        px[1] = clamp_u8(comp_sample(comps[1], x, y));
        px[2] = clamp_u8(comp_sample(comps[2], x, y));
      } else {
        uint8_t g = clamp_u8(comp_sample(comps[0], x, y));
        px[0] = px[1] = px[2] = g;
      }
      for (uint32_t c = 0; c < spp && c < 4; ++c) row[x * spp + c] = px[c];
    }
  }

  g_opj.image_destroy(image);
  g_opj.stream_destroy(stream);
  g_opj.destroy_codec(codec);
  return true;
}
