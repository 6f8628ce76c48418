// Native IO accelerator for the pctpu host runtime: PNG encoding and
// multi-layer BEV writeback (bin + 24 PNGs per cloud), exposed through a
// C ABI for ctypes.  The reference's runtime is C++ (OpenCV imwrite /
// ofstream, /root/reference/BatchMultiBevGen.cpp:294-320); this is the
// Device-framework equivalent: the device produces batched rasters, and this
// library drains them to disk without holding the GIL.
//
// Build: g++ -O2 -shared -fPIC -o libpctpu_io.so pctpu_io.cpp -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace {

void put_u32_be(std::vector<unsigned char>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<unsigned char>& out, const char tag[4],
               const unsigned char* payload, size_t n) {
  put_u32_be(out, static_cast<uint32_t>(n));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), payload, payload + n);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(n + 4));
  put_u32_be(out, crc);
}

// --- fast RLE deflate (fixed Huffman) ---------------------------------------
//
// BEV rasters are sparse (mostly-zero rows), so dist-1 run matching captures
// nearly all the redundancy; zlib's hash-chain search and per-image
// deflateInit are pure overhead for them.  This emits one BFINAL fixed-
// Huffman block — a valid zlib stream (same container, ~5-30× faster to
// encode than compress2 level 1 on these images; dense worst case expands to
// 9 bits/byte, bounded below).

struct BitWriter {
  // raw-pointer writer into a pre-reserved buffer: the per-byte push_back
  // (capacity check + size bump each) measured ~2× the whole emission cost
  // on sparse BEV layers.  64-bit accumulator, 4-byte unaligned stores.
  std::vector<unsigned char>& vec;
  unsigned char* op;
  uint64_t acc = 0;
  int n = 0;
  BitWriter(std::vector<unsigned char>& o, size_t start) : vec(o) {
    op = vec.data() + start;
  }
  inline void bits(uint64_t v, int nb) {  // deflate: LSB-first; nb ≤ 32
    acc |= v << n;
    n += nb;
    if (n >= 32) {
      uint32_t w = static_cast<uint32_t>(acc);
      std::memcpy(op, &w, 4);
      op += 4;
      acc >>= 32;
      n -= 32;
    }
  }
  void flush() {
    while (n > 0) {
      *op++ = static_cast<unsigned char>(acc);
      acc >>= 8;
      n -= 8;
    }
    vec.resize(op - vec.data());
    acc = 0;
    n = 0;
  }
};

struct Code {
  uint32_t bits;
  int n;
};

uint32_t bitrev(uint32_t c, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((c >> i) & 1u) << (n - 1 - i);
  return r;
}

struct RleTables {
  Code lit[256];   // literal codes, pre-reversed for LSB-first emission
  Code eob;        // end-of-block (symbol 256)
  Code len[259];   // full length+extra+dist(1) emission for run length 3..258
  RleTables() {
    for (int v = 0; v < 256; ++v) {
      if (v < 144)
        lit[v] = {bitrev(0x30 + v, 8), 8};
      else
        lit[v] = {bitrev(0x190 + (v - 144), 9), 9};
    }
    eob = {0, 7};  // symbol 256: 7-bit code 0000000
    // length symbol table (RFC1951 §3.2.5): base lengths + extra bit counts
    static const int base[] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int extra[] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    for (int l = 3; l <= 258; ++l) {
      int s = 28;
      while (base[s] > l) --s;
      int sym = 257 + s;
      Code huff = sym < 280 ? Code{bitrev(sym - 256, 7), 7}
                            : Code{bitrev(0xC0 + (sym - 280), 8), 8};
      uint32_t packed = huff.bits;
      int n = huff.n;
      packed |= static_cast<uint32_t>(l - base[s]) << n;  // extra, LSB-first
      n += extra[s];
      n += 5;  // distance 1: symbol 0, 5-bit code 00000 (zero bits)
      len[l] = {packed, n};
    }
  }
};

void deflate_rle_fixed(const unsigned char* raw, size_t n,
                       std::vector<unsigned char>& out) {
  static const RleTables T;
  out.push_back(0x78);  // zlib CMF: deflate, 32K window
  out.push_back(0x01);  // FLG: check bits, no dict, fastest
  // worst case 9 bits/byte + header/EOB + 4-byte store overshoot slack;
  // BitWriter writes through a raw pointer and flush() shrinks to fit
  size_t start = out.size();
  out.resize(start + n * 9 / 8 + 64);
  BitWriter bw(out, start);
  bw.bits(1, 1);  // BFINAL
  bw.bits(1, 2);  // BTYPE=01 (fixed Huffman)
  size_t i = 0;
  while (i < n) {
    unsigned char b = raw[i];
    bw.bits(T.lit[b].bits, T.lit[b].n);
    ++i;
    size_t run = 0;
    // word-wise scan: BEV rasters are dominated by long zero runs, so
    // skipping 8 equal bytes per compare is the encoder's hot path
    uint64_t pat = 0x0101010101010101ULL * b;
    while (i + run + 8 <= n) {
      uint64_t w8;
      std::memcpy(&w8, raw + i + run, 8);
      if (w8 != pat) break;
      run += 8;
    }
    while (i + run < n && raw[i + run] == b) ++run;
    while (run >= 3) {
      size_t l = run > 258 ? 258 : run;
      bw.bits(T.len[l].bits, T.len[l].n);
      i += l;
      run -= l;
    }
    // leftover run < 3 re-enters the loop as literals
  }
  bw.bits(T.eob.bits, T.eob.n);
  bw.flush();
  uint32_t ad = adler32(adler32(0L, nullptr, 0), raw, static_cast<uInt>(n));
  out.push_back((ad >> 24) & 0xff);
  out.push_back((ad >> 16) & 0xff);
  out.push_back((ad >> 8) & 0xff);
  out.push_back(ad & 0xff);
}

// Same stream as deflate_rle_fixed(raw scanlines of a 0/255 binary image),
// computed from the bit-PACKED occupancy (np.unpackbits bitorder="little"
// semantics ×255) without materializing the 8× unpacked bytes: the raw
// stream is fully determined by the run structure (filter byte 0 merges
// with zero-pixel runs), so the emission simulates the generic encoder's
// tokenization region-by-region — BYTE-IDENTICAL output (tested), ~6× less
// data touched.  adler32 is accumulated in closed form per run.
void deflate_rle_fixed_binary_packed(const uint8_t* packed, int h, int w,
                                     std::vector<unsigned char>& out) {
  static const RleTables T;
  const size_t n = static_cast<size_t>(h) * (w + 1);  // raw stream length
  out.push_back(0x78);
  out.push_back(0x01);
  size_t start = out.size();
  out.resize(start + n * 9 / 8 + 64);
  BitWriter bw(out, start);
  bw.bits(1, 1);  // BFINAL
  bw.bits(1, 2);  // BTYPE=01 (fixed Huffman)

  // adler32 state (mod 65521), updated in closed form per region
  uint64_t a = 1, b = 0;
  const uint64_t MOD = 65521;

  // emit one region of L equal bytes `v`, reproducing deflate_rle_fixed's
  // tokenization exactly: literal, 258-chunks while >=3 remain, then the
  // <3 leftover as literals
  auto region = [&](unsigned char v, size_t L) {
    bw.bits(T.lit[v].bits, T.lit[v].n);
    size_t rem = L - 1;
    while (rem >= 3) {
      size_t l = rem > 258 ? 258 : rem;
      bw.bits(T.len[l].bits, T.len[l].n);
      rem -= l;
    }
    while (rem--) bw.bits(T.lit[v].bits, T.lit[v].n);
    if (v == 0) {
      b = (b + L % MOD * a) % MOD;
    } else {
      // a_i = a + v·i; b += Σ_{i=1..L} a_i = L·a + v·L(L+1)/2
      b = (b + L % MOD * a + v * ((L * (L + 1) / 2) % MOD)) % MOD;
      a = (a + v * (L % MOD)) % MOD;
    }
  };

  // ctz-driven set-bit walk: one well-predicted loop iteration per SET
  // pixel (a byte-at-a-time three-way scan measured 38 µs/layer in branch
  // mispredictions alone).  Raw-stream position of pixel p (row-major) is
  // p + row + 1 — the +row accounts for the filter bytes, which are 0 and
  // therefore merge with zero-pixel runs; a 255-run can never span a row
  // boundary (raw gap 2 splits it), matching the generic tokenizer.
  const size_t wb = static_cast<size_t>(w) / 8;
  const size_t nbytes = static_cast<size_t>(h) * wb;
  size_t pos_fill = 0;                    // raw cursor: emitted up to here
  size_t run_start = 0, run_len = 0;      // pending 255-run (raw coords)
  size_t row = 0, row_end = static_cast<size_t>(w);
  auto handle_set = [&](size_t p) {
    while (p >= row_end) { ++row; row_end += static_cast<size_t>(w); }
    size_t raw = p + row + 1;
    if (run_len && raw == run_start + run_len) { ++run_len; return; }
    if (run_len) {
      region(255, run_len);
      pos_fill = run_start + run_len;
    }
    if (raw > pos_fill) region(0, raw - pos_fill);
    run_start = raw;
    run_len = 1;
  };
  const size_t n64 = nbytes / 8;
  for (size_t widx = 0; widx < n64; ++widx) {
    uint64_t word;
    std::memcpy(&word, packed + widx * 8, 8);
    while (word) {  // bit j*8+k of the LE word == pixel widx*64 + j*8 + k
      int k = __builtin_ctzll(word);
      word &= word - 1;
      handle_set(widx * 64 + static_cast<size_t>(k));
    }
  }
  for (size_t bi = n64 * 8; bi < nbytes; ++bi) {  // non-multiple-of-8 tail
    unsigned pb = packed[bi];
    while (pb) {
      int k = __builtin_ctz(pb);
      pb &= pb - 1;
      handle_set(bi * 8 + static_cast<size_t>(k));
    }
  }
  if (run_len) {
    region(255, run_len);
    pos_fill = run_start + run_len;
  }
  if (pos_fill < n) region(0, n - pos_fill);
  bw.bits(T.eob.bits, T.eob.n);
  bw.flush();
  uint32_t ad = static_cast<uint32_t>((b << 16) | a);
  out.push_back((ad >> 24) & 0xff);
  out.push_back((ad >> 16) & 0xff);
  out.push_back((ad >> 8) & 0xff);
  out.push_back(ad & 0xff);
}

bool encode_png_binary_packed(const uint8_t* packed, int h, int w,
                              std::vector<unsigned char>& out) {
  if (w % 8 != 0) return false;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.assign(sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;
  ihdr[9] = 0;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  static thread_local std::vector<unsigned char> comp_buf;
  comp_buf.clear();
  deflate_rle_fixed_binary_packed(packed, h, w, comp_buf);
  put_chunk(out, "IDAT", comp_buf.data(), comp_buf.size());
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool encode_png(const uint8_t* img, int h, int w, int level,
                std::vector<unsigned char>& out) {
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.assign(sig, sig + 8);

  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 0;   // grayscale
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // raw scanlines with filter byte 0 (the filter byte is itself 0, so zero
  // runs continue across row boundaries — ideal for the RLE encoder).
  // thread_local: one reused buffer per writer thread (AsyncWriter calls
  // from several) instead of a malloc per image
  static thread_local std::vector<unsigned char> raw;
  raw.resize(static_cast<size_t>(h) * (w + 1));
  for (int r = 0; r < h; ++r) {
    raw[static_cast<size_t>(r) * (w + 1)] = 0;
    std::memcpy(&raw[static_cast<size_t>(r) * (w + 1) + 1], img + static_cast<size_t>(r) * w, w);
  }
  static thread_local std::vector<unsigned char> comp_buf;
  std::vector<unsigned char>& comp = comp_buf;
  comp.clear();
  if (level == 1) {
    // fast path: hand-rolled RLE fixed-Huffman deflate (valid zlib stream)
    deflate_rle_fixed(raw.data(), raw.size(), comp);
  } else {
    uLongf bound = compressBound(static_cast<uLong>(raw.size()));
    comp.resize(bound);
    if (compress2(comp.data(), &bound, raw.data(),
                  static_cast<uLong>(raw.size()), level) != Z_OK) {
      return false;
    }
    comp.resize(bound);
  }
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const std::string& path, const void* data, size_t n) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  size_t written = n ? std::fwrite(data, 1, n, f) : 0;
  std::fclose(f);
  return written == n;
}

}  // namespace

extern "C" {

// Encode + write one 8-bit grayscale PNG.  Returns 0 on success.
int pctpu_write_png(const uint8_t* img, int h, int w, int level,
                    const char* path) {
  static thread_local std::vector<unsigned char> out;
  if (!encode_png(img, h, w, level, out)) return 1;
  return write_file(path, out.data(), out.size()) ? 0 : 2;
}

// Write one cloud's multi-BEV outputs: the raw layer-major binary and one
// PNG per layer named {img_dir}/{layer:02d}.png.  Returns 0 on success.
int pctpu_write_multi_bev(const uint8_t* multi, int layers, int h, int w,
                          const char* bin_path, const char* img_dir,
                          int level, int write_pngs) {
  size_t layer_bytes = static_cast<size_t>(h) * w;
  if (!write_file(bin_path, multi, layer_bytes * layers)) return 2;
  if (!write_pngs) return 0;
  mkdir(img_dir, 0777);  // ignore EEXIST
  char path[4096];
  for (int l = 0; l < layers; ++l) {
    std::snprintf(path, sizeof(path), "%s/%02d.png", img_dir, l);
    int rc = pctpu_write_png(multi + layer_bytes * l, h, w, level, path);
    if (rc != 0) return rc;
  }
  return 0;
}

// Forward declaration (defined below) used by the batched artifact writer.
long pctpu_format_csv_u8(const uint8_t* data, int h, int w,
                         char* out, long out_cap);

// One call per cloud writing the reference's ENTIRE in-[TIME] artifact set
// (/root/reference/BatchMultiBevGen.cpp:295-320, 352-372): the layer-major
// .bin, the per-layer PNGs ({img_dir}/{layer:02d}.png), the single-BEV PNG,
// and the FMT_CSV — eliminating the per-artifact ctypes transitions and the
// host-side occupancy unpack (pass ``packed`` — np.unpackbits
// bitorder="little" semantics, ×255 — and the expansion happens here into a
// reused thread-local buffer).  Pass exactly one of ``multi`` (unpacked
// layers*h*w of 0/255) or ``packed`` (layers*h*w/8 bit-packed).  Returns 0
// on success; 2 bin, 3 png, 4 csv, 5 bad arguments.
int pctpu_write_cloud_artifacts(
    const uint8_t* packed, const uint8_t* multi, int layers, int h, int w,
    const uint8_t* single_img, int sh, int sw,
    const char* bin_path, const char* img_dir,
    const char* single_png_path, const char* single_csv_path,
    int level, int write_pngs) {
  size_t layer_bytes = static_cast<size_t>(h) * w;
  size_t total = layer_bytes * layers;
  static thread_local std::vector<uint8_t> unpack_buf;
  if (multi == nullptr) {
    if (packed == nullptr || w % 8 != 0) return 5;
    // 256→8-byte LUT: one memcpy per packed byte (bit k → pixel 8i+k,
    // matching np.unpackbits(bitorder="little") × 255)
    static const struct Lut {
      uint8_t t[256][8];
      Lut() {
        for (int v = 0; v < 256; ++v)
          for (int k = 0; k < 8; ++k) t[v][k] = ((v >> k) & 1) ? 255 : 0;
      }
    } L;
    unpack_buf.resize(total);
    uint8_t* dst = unpack_buf.data();
    const size_t nbytes = total / 8;
    for (size_t i = 0; i < nbytes; ++i) std::memcpy(dst + i * 8, L.t[packed[i]], 8);
    multi = unpack_buf.data();
  }
  if (!write_file(bin_path, multi, total)) return 2;
  if (write_pngs) {
    mkdir(img_dir, 0777);  // ignore EEXIST
    char path[4096];
    for (int l = 0; l < layers; ++l) {
      std::snprintf(path, sizeof(path), "%s/%02d.png", img_dir, l);
      if (packed != nullptr && level == 1) {
        // binary layers encode straight from the packed bits —
        // byte-identical stream to the generic encoder, ~6× less data
        static thread_local std::vector<unsigned char> png_buf;
        if (!encode_png_binary_packed(
                packed + static_cast<size_t>(l) * h * (w / 8), h, w, png_buf))
          return 3;
        if (!write_file(path, png_buf.data(), png_buf.size())) return 3;
      } else if (pctpu_write_png(multi + layer_bytes * l, h, w, level, path) !=
                 0) {
        return 3;
      }
    }
    if (single_img != nullptr && single_png_path != nullptr &&
        pctpu_write_png(single_img, sh, sw, level, single_png_path) != 0)
      return 3;
  }
  if (single_img != nullptr && single_csv_path != nullptr) {
    static thread_local std::vector<char> csv_buf;
    csv_buf.resize(static_cast<size_t>(sh) * sw * 5 + 16);
    long n = pctpu_format_csv_u8(single_img, sh, sw, csv_buf.data(),
                                 static_cast<long>(csv_buf.size()));
    if (n < 0 || !write_file(single_csv_path, csv_buf.data(),
                             static_cast<size_t>(n)))
      return 4;
  }
  return 0;
}

// OpenCV FMT_CSV float matrix formatting: "%.<precision>g" per value,
// ", " separators, "\n" per row (no trailing newline for single-row mats —
// cv::Formatter semantics, see pctpu/io/csvfmt.py).  printf's %g is exactly
// what libopencv_core used, so this IS the reference byte format.  Returns
// bytes written, or -1 when out_cap would overflow.
long pctpu_format_csv_f32(const float* data, int h, int w, int precision,
                          char* out, long out_cap) {
  char fmt[16];
  std::snprintf(fmt, sizeof(fmt), "%%.%dg", precision);
  char tmp[64];
  long o = 0;
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      // format into a local buffer first: snprintf returns the WOULD-BE
      // length on truncation, so writing straight into `out` and advancing
      // by the return value could push the separator writes past out_cap
      int len = std::snprintf(tmp, sizeof(tmp), fmt,
                              static_cast<double>(data[static_cast<long>(r) * w + c]));
      if (len < 0 || len >= static_cast<int>(sizeof(tmp))) return -1;
      if (o + len + 3 > out_cap) return -1;  // value + ", " or "\n"
      std::memcpy(out + o, tmp, len);
      o += len;
      if (c + 1 < w) {
        out[o++] = ',';
        out[o++] = ' ';
      }
    }
    if (h > 1) out[o++] = '\n';
  }
  return o;
}

// OpenCV FMT_CSV uint8 matrix formatting: "%3d" per value, ", " separators,
// "\n" per row (none for single-row mats) — same byte format as the Python
// path in pctpu/io/csvfmt.py.  LUT of pre-rendered 5-byte cells makes each
// cell one 5-byte copy.  Returns bytes written, or -1 on overflow.
long pctpu_format_csv_u8(const uint8_t* data, int h, int w,
                         char* out, long out_cap) {
  static char lut[256][6];  // 5 cell bytes + NUL
  static bool lut_ready = false;
  if (!lut_ready) {
    for (int v = 0; v < 256; ++v) std::snprintf(lut[v], 6, "%3d, ", v);
    lut_ready = true;
  }
  // the loop writes full 5-byte cells before trimming, so cap on the
  // untrimmed size
  if (static_cast<long>(h) * w * 5 > out_cap) return -1;
  long o = 0;
  for (int r = 0; r < h; ++r) {
    const uint8_t* row = data + static_cast<long>(r) * w;
    for (int c = 0; c < w; ++c) {
      std::memcpy(out + o, lut[row[c]], 5);
      o += 5;
    }
    if (h > 1) {
      out[o - 2] = '\n';  // replace the trailing ", " with "\n"
      --o;
    } else {
      o -= 2;  // single-row: no trailing separator, no newline
    }
  }
  return o;
}

// liblzf decompression (the PCD binary_compressed codec).  Returns the
// number of bytes written to out, or -1 on a corrupt stream / overflow.
long pctpu_lzf_decompress(const uint8_t* in, long in_len,
                          uint8_t* out, long out_cap) {
  long i = 0, o = 0;
  while (i < in_len) {
    unsigned ctrl = in[i++];
    if (ctrl < 32) {  // literal run of ctrl+1 bytes
      long run = static_cast<long>(ctrl) + 1;
      if (i + run > in_len || o + run > out_cap) return -1;
      std::memcpy(out + o, in + i, run);
      i += run;
      o += run;
    } else {  // back reference
      long len = ctrl >> 5;
      if (len == 7) {
        if (i >= in_len) return -1;
        len += in[i++];
      }
      if (i >= in_len) return -1;
      long ref = o - (static_cast<long>(ctrl & 0x1F) << 8) - in[i++] - 1;
      len += 2;
      if (ref < 0 || o + len > out_cap) return -1;
      for (long k = 0; k < len; ++k) {  // may overlap: byte-by-byte
        out[o] = out[ref];
        ++o;
        ++ref;
      }
    }
  }
  return o;
}

}  // extern "C"
