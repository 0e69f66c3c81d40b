// A Zstandard frame decoder written to RFC 8878, and CRC-32C.
//
// It reads what the JAX package's checkpoints hold (tensorstore writes every
// OCDBT node and every zarr chunk as a zstd frame): raw, RLE and compressed
// blocks; Huffman-coded literals (direct or FSE-compressed weights, one or
// four streams, the previous table reused by treeless blocks); sequences
// with predefined, RLE, FSE-compressed and repeated tables and the three
// repeat offsets; frames of several blocks; skippable frames; the content
// checksum read and skipped; and frames one after another. A dictionary, a
// reserved bit or any length that does not add up is an error: the decoder
// never returns bytes it could not account for.
//
// C interface (ctypes):
//   int64 mtpu_zstd_content_size(src, n)   decompressed size of all frames
//                                          (-1: a frame does not say it;
//                                          < -1: an error code)
//   int64 mtpu_zstd_decompress(src, n, dst, cap)
//                                          bytes written, or < 0 on error
//                                          (-4: more than cap bytes)
//   const char *mtpu_zstd_error(void)      the last error's message
//   uint32 mtpu_crc32c(src, n)             CRC-32C (Castagnoli)

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct ZError {
  std::string msg;
  int64_t code;
};

[[noreturn]] void fail(const std::string &m) { throw ZError{m, -2}; }

// the output would pass the caller's capacity: -4, so that a caller that
// did not know the size can retry with more room
[[noreturn]] void fail_cap() {
  throw ZError{"output larger than the capacity given", -4};
}

inline uint32_t rd_le(const uint8_t *p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; i++) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t v) {  // index of the highest set bit, v > 0
  int r = 0;
  while (v >>= 1) r++;
  return r;
}

// Forward bit reader, least significant bit first (FSE table headers).
struct FwdBits {
  const uint8_t *p;
  size_t n;
  size_t pos = 0;  // in bits
  FwdBits(const uint8_t *p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int bits) const {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) {
      size_t b = pos + i;
      if (b >= 8 * n) break;  // reads past the end see zeros
      v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t read(int bits) {
    uint32_t v = peek(bits);
    pos += bits;
    return v;
  }
};

// Backward bit reader (Huffman streams, FSE weights, sequences): the last
// byte's highest set bit marks the end; bits are read from there towards
// the start, and positions before the start read as zeros.
struct BackBits {
  const uint8_t *p;
  size_t n;
  int64_t pos;  // bits not yet read lie in [0, pos)
  BackBits(const uint8_t *p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty backward bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("backward bitstream without its end marker");
    pos = int64_t(8 * n) - 8 + highbit(last);
  }
  // the little-endian value of bits [b, b + bits), b >= 0, bits <= 56
  uint64_t at(int64_t b, int bits) const {
    size_t i = size_t(b >> 3);
    uint64_t v = 0;
    for (size_t k = 0; k < 8 && i + k < n; k++) v |= uint64_t(p[i + k]) << (8 * k);
    v >>= (b & 7);
    return bits >= 64 ? v : v & ((uint64_t(1) << bits) - 1);
  }
  uint64_t peek(int bits) const {
    if (bits == 0) return 0;
    int64_t b = pos - bits;
    if (b >= 0) return at(b, bits);
    if (pos <= 0) return 0;
    return at(0, int(pos)) << (-b);
  }
  uint64_t read(int bits) {
    uint64_t v = peek(bits);
    pos -= bits;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// ---- FSE ----

struct FseCell {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
};

// Normalized counts -> decoding table (RFC 8878 4.1.1).
void fse_build(FseTable &t, const std::vector<int> &norm, int log) {
  int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      t.cells[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: symbol spread did not close");
  for (int i = 0; i < size; i++) {
    uint16_t s = t.cells[i].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    t.cells[i].nbits = uint8_t(nb);
    t.cells[i].base = uint16_t((ns << nb) - size);
  }
}

// Read an FSE table description; returns the bytes it took.
size_t fse_read(FseTable &t, const uint8_t *p, size_t n, int max_log,
                int max_symbol) {
  if (n == 0) fail("FSE table description: no bytes");
  FwdBits br(p, n);
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail("FSE table: accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  std::vector<int> norm;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      uint32_t r;
      do {
        r = br.read(2);
        for (uint32_t k = 0; k < r; k++) norm.push_back(0);
      } while (r == 3);
      if (int(norm.size()) > max_symbol + 1) fail("FSE table: too many zeros");
    }
    if (int(norm.size()) > max_symbol) fail("FSE table: symbol out of range");
    int mx = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1) & uint32_t(threshold - 1);
    if (int(low) < mx) {
      count = int(low);
      br.pos += nbits - 1;
    } else {
      count = int(br.peek(nbits) & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= mx;
      br.pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm.push_back(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table: probabilities do not sum up");
  size_t used = (br.pos + 7) / 8;
  if (used > n) fail("FSE table description runs past its block");
  fse_build(t, norm, log);
  return used;
}

void fse_rle(FseTable &t, int symbol) {
  t.log = 0;
  t.cells.assign(1, FseCell{uint16_t(symbol), 0, 0});
}

// ---- Huffman ----

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;  // indexed by the peeked max_bits
  bool ready = false;
};

void huf_from_weights(Huffman &h, std::vector<int> w) {
  if (w.empty() || w.size() > 255) fail("Huffman: bad number of weights");
  uint32_t total = 0;
  for (int x : w) {
    if (x > 12) fail("Huffman: weight above 12");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("Huffman: all weights zero");
  int mb = highbit(total) + 1;
  uint32_t rest = (1u << mb) - total;
  if (rest & (rest - 1)) fail("Huffman: weights do not complete a tree");
  w.push_back(highbit(rest) + 1);
  if (mb > 12) fail("Huffman: code longer than 12 bits");
  h.max_bits = mb;
  h.sym.assign(size_t(1) << mb, 0);
  h.nbits.assign(size_t(1) << mb, 0);
  uint32_t pos = 0;
  for (int wt = 1; wt <= mb; wt++) {
    for (size_t s = 0; s < w.size(); s++) {
      if (w[s] != wt) continue;
      uint32_t span = 1u << (wt - 1);
      for (uint32_t k = 0; k < span; k++) {
        h.sym[pos + k] = uint8_t(s);
        h.nbits[pos + k] = uint8_t(mb + 1 - wt);
      }
      pos += span;
    }
  }
  if (pos != (1u << mb)) fail("Huffman: table not filled");
  h.ready = true;
}

size_t huf_read(Huffman &h, const uint8_t *p, size_t n) {
  if (n < 1) fail("Huffman tree description: no bytes");
  int hb = p[0];
  std::vector<int> w;
  if (hb >= 128) {
    int num = hb - 127;
    size_t bytes = (num + 1) / 2;
    if (1 + bytes > n) fail("Huffman weights run past the literals");
    for (int i = 0; i < num; i++) {
      uint8_t b = p[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    huf_from_weights(h, w);
    return 1 + bytes;
  }
  size_t csize = hb;
  if (csize == 0 || 1 + csize > n) fail("Huffman FSE weights: bad size");
  FseTable t;
  size_t hdr = fse_read(t, p + 1, csize, 6, 255);
  if (hdr >= csize) fail("Huffman FSE weights: no bitstream");
  BackBits br(p + 1 + hdr, csize - hdr);
  uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
  auto step = [&](uint32_t &s) {
    const FseCell &c = t.cells[s];
    w.push_back(c.symbol);
    s = c.base + uint32_t(br.read(c.nbits));
  };
  while (true) {
    if (w.size() > 254) fail("Huffman FSE weights: too many");
    step(s1);
    if (br.overflowed()) {
      w.push_back(t.cells[s2].symbol);
      break;
    }
    if (w.size() > 254) fail("Huffman FSE weights: too many");
    step(s2);
    if (br.overflowed()) {
      w.push_back(t.cells[s1].symbol);
      break;
    }
  }
  huf_from_weights(h, w);
  return 1 + csize;
}

void huf_stream(const Huffman &h, const uint8_t *p, size_t n, uint8_t *out,
                size_t count) {
  BackBits br(p, n);
  for (size_t i = 0; i < count; i++) {
    uint32_t v = uint32_t(br.peek(h.max_bits));
    out[i] = h.sym[v];
    br.pos -= h.nbits[v];
  }
  if (br.pos != 0) fail("Huffman stream not consumed exactly");
}

// ---- sequences ----

const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,    1,    2,     3,     4,     5,    6,
                              7,    8,    9,     10,    11,    12,   13,
                              14,   15,   16,    18,    20,    22,   24,
                              28,   32,   40,    48,    64,    128,  256,
                              512,  1024, 2048,  4096,  8192,  16384,
                              32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  Huffman huf;
  FseTable ll, of, ml;
  bool ll_ok = false, of_ok = false, ml_ok = false;
  uint32_t rep[3] = {1, 4, 8};
};

size_t seq_table(FseTable &t, bool &ok, int mode, const uint8_t *p, size_t n,
                 const int *deflt, int ndefault, int deflog, int max_log,
                 int max_symbol, const char *name) {
  switch (mode) {
    case 0: {
      std::vector<int> norm(deflt, deflt + ndefault);
      fse_build(t, norm, deflog);
      ok = true;
      return 0;
    }
    case 1:
      if (n < 1) fail(std::string(name) + " RLE table: no byte");
      if (p[0] > max_symbol) fail(std::string(name) + " RLE symbol too big");
      fse_rle(t, p[0]);
      ok = true;
      return 1;
    case 2: {
      size_t used = fse_read(t, p, n, max_log, max_symbol);
      ok = true;
      return used;
    }
    default:
      if (!ok) fail(std::string(name) + " table repeated before one was set");
      return 0;
  }
}

void compressed_block(FrameState &fs, const uint8_t *p, size_t n,
                      std::vector<uint8_t> &out, size_t cap) {
  // literals section
  if (n < 1) fail("compressed block: empty");
  int ltype = p[0] & 3, sfmt = (p[0] >> 2) & 3;
  size_t hdr, regen, csize = 0;
  std::vector<uint8_t> lit;
  if (ltype <= 1) {
    if (sfmt == 0 || sfmt == 2) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (sfmt == 1) {
      hdr = 2;
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    if (ltype == 0) {
      if (hdr + regen > n) fail("raw literals run past the block");
      lit.assign(p + hdr, p + hdr + regen);
      hdr += regen;
    } else {
      if (hdr + 1 > n) fail("RLE literals run past the block");
      lit.assign(regen, p[hdr]);
      hdr += 1;
    }
  } else {
    int streams = sfmt == 0 ? 1 : 4;
    if (sfmt <= 1) {
      hdr = 3;
      if (n < 3) fail("literals header truncated");
      uint32_t v = rd_le(p, 3);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sfmt == 2) {
      hdr = 4;
      if (n < 4) fail("literals header truncated");
      uint32_t v = rd_le(p, 4);
      regen = (v >> 4) & 0x3FFF;
      csize = (v >> 18) & 0x3FFF;
    } else {
      hdr = 5;
      if (n < 5) fail("literals header truncated");
      uint64_t v = rd_le(p, 4) | (uint64_t(p[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
    if (hdr + csize > n) fail("compressed literals run past the block");
    const uint8_t *q = p + hdr;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = huf_read(fs.huf, q, qn);
      q += used;
      qn -= used;
    } else if (!fs.huf.ready) {
      fail("treeless literals before any Huffman table");
    }
    lit.assign(regen, 0);
    if (streams == 1) {
      huf_stream(fs.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("4-stream literals: no jump table");
      size_t s1 = rd_le(q, 2), s2 = rd_le(q + 2, 2), s3 = rd_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("4-stream literals: bad jump table");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals: too few literals");
      const uint8_t *b = q + 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int k = 0; k < 4; k++) {
        size_t cnt = k < 3 ? seg : regen - 3 * seg;
        huf_stream(fs.huf, b, sizes[k], lit.data() + k * seg, cnt);
        b += sizes[k];
      }
    }
    hdr += csize;
  }
  // sequences section
  const uint8_t *s = p + hdr;
  size_t sn = n - hdr;
  if (sn < 1) fail("sequences section missing");
  size_t nseq, k = 0;
  if (s[0] < 128) {
    nseq = s[0];
    k = 1;
  } else if (s[0] < 255) {
    if (sn < 2) fail("sequence count truncated");
    nseq = ((size_t(s[0]) - 128) << 8) + s[1];
    k = 2;
  } else {
    if (sn < 3) fail("sequence count truncated");
    nseq = s[1] + (size_t(s[2]) << 8) + 0x7F00;
    k = 3;
  }
  size_t lpos = 0;
  if (nseq > 0) {
    if (k >= sn) fail("sequence modes missing");
    uint8_t modes = s[k++];
    if (modes & 3) fail("sequence modes: reserved bits set");
    k += seq_table(fs.ll, fs.ll_ok, modes >> 6, s + k, sn - k, LL_DEFAULT,
                   36, 6, 9, 35, "literal-length");
    k += seq_table(fs.of, fs.of_ok, (modes >> 4) & 3, s + k, sn - k,
                   OF_DEFAULT, 29, 5, 8, 31, "offset");
    k += seq_table(fs.ml, fs.ml_ok, (modes >> 2) & 3, s + k, sn - k,
                   ML_DEFAULT, 53, 6, 9, 52, "match-length");
    if (k >= sn) fail("sequence bitstream missing");
    BackBits br(s + k, sn - k);
    uint32_t sl = uint32_t(br.read(fs.ll.log));
    uint32_t so = uint32_t(br.read(fs.of.log));
    uint32_t sm = uint32_t(br.read(fs.ml.log));
    for (size_t i = 0; i < nseq; i++) {
      const FseCell &cl = fs.ll.cells[sl], &co = fs.of.cells[so],
                    &cm = fs.ml.cells[sm];
      int ofc = co.symbol;
      if (ofc > 31) fail("offset code above 31");
      uint32_t ofv = (1u << ofc) + uint32_t(br.read(ofc));
      if (cm.symbol > 52 || cl.symbol > 35) fail("length code out of range");
      uint32_t ml = ML_BASE[cm.symbol] + uint32_t(br.read(ML_BITS[cm.symbol]));
      uint32_t ll = LL_BASE[cl.symbol] + uint32_t(br.read(LL_BITS[cl.symbol]));
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      } else {
        int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
          if (idx != 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sl = cl.base + uint32_t(br.read(cl.nbits));
        sm = cm.base + uint32_t(br.read(cm.nbits));
        so = co.base + uint32_t(br.read(co.nbits));
      }
      if (lpos + ll > lit.size()) fail("sequence takes more literals than exist");
      if (out.size() + ll + ml > cap) fail_cap();
      out.insert(out.end(), lit.begin() + lpos, lit.begin() + lpos + ll);
      lpos += ll;
      if (off == 0 || off > out.size()) fail("match offset before the start");
      size_t from = out.size() - off;
      for (uint32_t j = 0; j < ml; j++) out.push_back(out[from + j]);
    }
    if (br.pos != 0) fail("sequence bitstream not consumed exactly");
  } else if (k != sn) {
    fail("bytes after an empty sequences section");
  }
  if (out.size() + (lit.size() - lpos) > cap)
    fail_cap();
  out.insert(out.end(), lit.begin() + lpos, lit.end());
}

const uint32_t MAGIC = 0xFD2FB528u;
const size_t BLOCK_MAX = 128 * 1024;

struct Header {
  size_t hdr;
  int64_t content;  // -1 when not given
  bool checksum;
  uint64_t window;
};

Header frame_header(const uint8_t *p, size_t n) {
  if (n < 5) fail("frame header truncated");
  uint8_t d = p[4];
  int fcs_flag = d >> 6, single = (d >> 5) & 1, dict = d & 3;
  if (d & 8) fail("frame header: reserved bit set");
  Header h{5, -1, bool((d >> 2) & 1), 0};
  if (!single) {
    if (n < h.hdr + 1) fail("frame header truncated");
    uint8_t wd = p[h.hdr++];
    int exp = wd >> 3, mant = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exp);
    h.window = base + (base / 8) * mant;
  }
  static const int dsz[4] = {0, 1, 2, 4};
  if (n < h.hdr + dsz[dict]) fail("frame header truncated");
  uint32_t did = rd_le(p + h.hdr, dsz[dict]);
  h.hdr += dsz[dict];
  if (did != 0) fail("frame needs a dictionary");
  int fsz = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (n < h.hdr + fsz) fail("frame header truncated");
  if (fsz) {
    uint64_t v = 0;
    for (int i = 0; i < fsz; i++) v |= uint64_t(p[h.hdr + i]) << (8 * i);
    if (fsz == 2) v += 256;
    h.content = int64_t(v);
    if (single) h.window = v;
  }
  h.hdr += fsz;
  return h;
}

// One frame from p; appends to out; returns the bytes it took.
size_t frame(const uint8_t *p, size_t n, std::vector<uint8_t> &out,
             size_t cap) {
  Header h = frame_header(p, n);
  size_t at = h.hdr, start = out.size();
  FrameState fs;
  bool last = false;
  while (!last) {
    if (at + 3 > n) fail("block header truncated");
    uint32_t bh = rd_le(p + at, 3);
    at += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      if (at + 1 > n) fail("RLE block truncated");
      if (size > BLOCK_MAX) fail("block larger than 128 KB");
      if (out.size() + size > cap) fail_cap();
      out.insert(out.end(), size, p[at]);
      at += 1;
      continue;
    }
    if (size > BLOCK_MAX) fail("block larger than 128 KB");
    if (at + size > n) fail("block runs past the end of the data");
    if (type == 0) {
      if (out.size() + size > cap) fail_cap();
      out.insert(out.end(), p + at, p + at + size);
    } else {
      compressed_block(fs, p + at, size, out, cap);
    }
    at += size;
  }
  if (h.checksum) {
    if (at + 4 > n) fail("content checksum truncated");
    at += 4;  // read and skipped
  }
  if (h.content >= 0 && int64_t(out.size() - start) != h.content)
    fail("frame content size does not match its blocks");
  return at;
}

bool skippable(const uint8_t *p, size_t n, size_t &len) {
  if (n < 4) return false;
  uint32_t m = rd_le(p, 4);
  if ((m & 0xFFFFFFF0u) != 0x184D2A50u) return false;
  if (n < 8) fail("skippable frame truncated");
  len = 8 + size_t(rd_le(p + 4, 4));
  if (len > n) fail("skippable frame runs past the end");
  return true;
}

uint32_t CRC_TABLE[256];
bool crc_ready = false;

}  // namespace

extern "C" {

const char *mtpu_zstd_error(void) { return g_error.c_str(); }

int64_t mtpu_zstd_content_size(const uint8_t *src, int64_t n) {
  try {
    size_t at = 0, total = 0;
    if (n <= 0) fail("no data");
    while (at < size_t(n)) {
      size_t len;
      if (skippable(src + at, n - at, len)) {
        at += len;
        continue;
      }
      if (size_t(n) - at < 4 || rd_le(src + at, 4) != MAGIC)
        fail("not a zstd frame (bad magic number)");
      Header h = frame_header(src + at, n - at);
      if (h.content < 0) return -1;
      total += size_t(h.content);
      // skip the frame's blocks to find the next one
      size_t q = at + h.hdr;
      bool last = false;
      while (!last) {
        if (q + 3 > size_t(n)) fail("block header truncated");
        uint32_t bh = rd_le(src + q, 3);
        q += 3;
        last = bh & 1;
        size_t sz = ((bh >> 1) & 3) == 1 ? 1 : (bh >> 3);
        q += sz;
      }
      at = q + (h.checksum ? 4 : 0);
      if (at > size_t(n)) fail("frame runs past the end of the data");
    }
    return int64_t(total);
  } catch (const ZError &e) {
    g_error = e.msg;
    return -2;
  }
}

int64_t mtpu_zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(cap));
    size_t at = 0;
    if (n <= 0) fail("no data");
    while (at < size_t(n)) {
      size_t len;
      if (skippable(src + at, n - at, len)) {
        at += len;
        continue;
      }
      if (size_t(n) - at < 4 || rd_le(src + at, 4) != MAGIC)
        fail("not a zstd frame (bad magic number)");
      at += frame(src + at, size_t(n) - at, out, size_t(cap));
    }
    if (!out.empty()) std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const ZError &e) {
    g_error = e.msg;
    return e.code;
  } catch (const std::exception &e) {
    g_error = std::string("zstd decoder: ") + e.what();
    return -3;
  }
}

uint32_t mtpu_crc32c(const uint8_t *src, int64_t n) {
  if (!crc_ready) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      CRC_TABLE[i] = c;
    }
    crc_ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++) c = CRC_TABLE[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
