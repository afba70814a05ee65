// loco_zstd: a Zstandard decoder (RFC 8878) and CRC-32C for the port's
// read-only OCDBT / zarr reader (utils/ocdbt.py, utils/orbax.py), which must
// run where no zstd or tensorstore module is installed.  Built into the same
// library as loco_audio.cc and loaded through ctypes by native/__init__.py.
//
// Decodes whole inputs: any sequence of Zstandard frames and skippable
// frames; frame headers with or without window descriptor and content size;
// raw, RLE and compressed blocks; raw, RLE, Huffman-coded (one or four
// streams) and treeless literals; sequences with predefined, RLE,
// FSE-coded and repeat tables and the repeat offsets; the content checksum
// (XXH64), verified when a frame carries one.  A frame that names a
// dictionary is refused.
//
// Exposed functions:
//   lz_zstd_content_size(src, n)            sum of the frames' declared
//       content sizes; -1 if a frame declares none, -2 if malformed
//   lz_zstd_decompress(src, n, dst, cap, err, errcap)
//       bytes written; -1 on a corrupt input (err holds why), -3 if the
//       output would pass cap
//   lz_crc32c(src, n)                       CRC-32C (Castagnoli)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct OutOfRoom {};

[[noreturn]] void Fail(const std::string& why) { throw ZstdError(why); }

inline uint32_t Le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t Le24(const uint8_t* p) { return Le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t Le32(const uint8_t* p) { return Le16(p) | (Le16(p + 2) << 16); }
inline uint64_t Le64(const uint8_t* p) { return Le32(p) | (uint64_t(Le32(p + 4)) << 32); }
inline int HighBit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- XXH64
constexpr uint64_t kP1 = 11400714785074694791ULL, kP2 = 14029467366897019727ULL,
                   kP3 = 1609587929392839161ULL, kP4 = 9650029242287828579ULL,
                   kP5 = 2870177450012600261ULL;

inline uint64_t Rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t XxRound(uint64_t acc, uint64_t in) {
  return Rotl(acc + in * kP2, 31) * kP1;
}
inline uint64_t XxMerge(uint64_t acc, uint64_t v) {
  return (acc ^ XxRound(0, v)) * kP1 + kP4;
}

uint64_t Xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    for (; p + 32 <= end; p += 32) {
      v1 = XxRound(v1, Le64(p));
      v2 = XxRound(v2, Le64(p + 8));
      v3 = XxRound(v3, Le64(p + 16));
      v4 = XxRound(v4, Le64(p + 24));
    }
    h = Rotl(v1, 1) + Rotl(v2, 7) + Rotl(v3, 12) + Rotl(v4, 18);
    h = XxMerge(XxMerge(XxMerge(XxMerge(h, v1), v2), v3), v4);
  } else {
    h = kP5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = Rotl(h ^ XxRound(0, Le64(p)), 27) * kP1 + kP4;
  if (p + 4 <= end) {
    h = Rotl(h ^ (uint64_t(Le32(p)) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = Rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bits
// Forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t Peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << nb) - 1));
  }
  void Skip(int nb) { pos += nb; }
  size_t BytesUsed() const { return (pos + 7) >> 3; }
};

// Backward bit reader (Huffman and FSE streams): the stream is read from
// its last bit down; the last byte's highest set bit marks the start.
// Reading past the first bit yields zeros; Overflowed() tells.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t left = 0;  // unread bits

  BackwardBits(const uint8_t* src, size_t size) : p(src), n(size) {
    if (size == 0) Fail("empty bitstream");
    uint8_t last = src[size - 1];
    if (last == 0) Fail("bitstream without its end mark");
    left = int64_t(8 * (size - 1)) + HighBit(last);
  }
  // nb (<= 32) bits ending at `left`, without consuming them.
  uint32_t Peek(int nb) const {
    if (nb == 0) return 0;
    int64_t start = left - nb;
    if (start < 0) {
      if (left <= 0) return 0;
      BackwardBits tmp = *this;
      tmp.left = left;
      return tmp.Peek(int(left)) << (-start);
    }
    size_t byte = size_t(start >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return uint32_t((v >> (start & 7)) & ((1ULL << nb) - 1));
  }
  uint32_t Read(int nb) {
    uint32_t v = Peek(nb);
    left -= nb;
    return v;
  }
  bool Overflowed() const { return left < 0; }
  bool Finished() const { return left == 0; }
};

// ---------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
  bool ready = false;
};

// Build a decoding table from normalized counts (-1: "less than one").
void BuildFse(FseTable& t, const int16_t* norm, int max_symbol, int log) {
  const int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(max_symbol + 1);
  int high = size - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) Fail("FSE table: counts do not fill the table");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = t.cells[u];
    uint32_t state = next[e.symbol]++;
    e.nb = uint8_t(log - HighBit(state));
    e.base = uint16_t((state << e.nb) - size);
  }
  t.ready = true;
}

void RleFse(FseTable& t, int symbol) {
  t.log = 0;
  t.cells.assign(1, FseEntry{uint16_t(symbol), 0, 0});
  t.ready = true;
}

// Read an FSE table description at src; returns the bytes it used.
size_t ReadFseDescription(FseTable& t, const uint8_t* src, size_t n, int max_symbol,
                          int max_log) {
  if (n == 0) Fail("FSE table description: no bytes");
  ForwardBits bits{src, n};
  const int log = int(bits.Peek(4)) + 5;
  bits.Skip(4);
  if (log > max_log) Fail("FSE table description: accuracy log too large");
  std::vector<int16_t> norm(max_symbol + 1, 0);
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int symbol = 0;
  bool previous_zero = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous_zero) {
      int repeat;
      do {
        repeat = int(bits.Peek(2));
        bits.Skip(2);
        for (int i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) Fail("FSE table description: too many symbols");
          norm[symbol++] = 0;
        }
      } while (repeat == 3);
      if (symbol > max_symbol) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = bits.Peek(nb);
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      bits.Skip(nb - 1);
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.Skip(nb);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous_zero = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) Fail("FSE table description: counts do not sum to the table");
  if (bits.BytesUsed() > n) Fail("FSE table description: truncated");
  BuildFse(t, norm.data(), symbol - 1, log);
  return bits.BytesUsed();
}

// ---------------------------------------------------------------- Huffman
struct HufEntry {
  uint8_t symbol;
  uint8_t nb;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> cells;
  bool ready = false;
};

// Read a Huffman tree description; returns the bytes it used.
size_t ReadHuffmanTree(HufTable& t, const uint8_t* src, size_t n) {
  if (n == 0) Fail("Huffman tree: no bytes");
  const int header = src[0];
  uint8_t weights[256];
  int count = 0;
  size_t used;
  if (header < 128) {
    // FSE-coded weights: two interleaved states over one table.
    used = 1 + size_t(header);
    if (used > n) Fail("Huffman tree: truncated weights");
    FseTable fse;
    size_t desc = ReadFseDescription(fse, src + 1, header, 12, 6);
    if (desc >= size_t(header)) Fail("Huffman tree: no weight stream");
    BackwardBits bits(src + 1 + desc, header - desc);
    uint32_t s1 = bits.Read(fse.log), s2 = bits.Read(fse.log);
    for (;;) {
      if (count > 254) Fail("Huffman tree: too many weights");
      const FseEntry& e1 = fse.cells[s1];
      weights[count++] = uint8_t(e1.symbol);
      s1 = e1.base + bits.Read(e1.nb);
      if (bits.Overflowed()) {
        weights[count++] = uint8_t(fse.cells[s2].symbol);
        break;
      }
      if (count > 254) Fail("Huffman tree: too many weights");
      const FseEntry& e2 = fse.cells[s2];
      weights[count++] = uint8_t(e2.symbol);
      s2 = e2.base + bits.Read(e2.nb);
      if (bits.Overflowed()) {
        weights[count++] = uint8_t(fse.cells[s1].symbol);
        break;
      }
    }
  } else {
    count = header - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) Fail("Huffman tree: truncated weights");
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  }
  uint32_t sum = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 11) Fail("Huffman tree: weight above 11");
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) Fail("Huffman tree: all weights zero");
  const int max_bits = HighBit(sum) + 1;
  const uint32_t rest = (1u << max_bits) - sum;
  if (rest & (rest - 1)) Fail("Huffman tree: implied weight is not a power of two");
  if (max_bits > 11) Fail("Huffman tree: code longer than 11 bits");
  if (count > 255) Fail("Huffman tree: too many symbols");
  weights[count++] = uint8_t(HighBit(rest) + 1);
  t.max_bits = max_bits;
  t.cells.assign(size_t(1) << max_bits, HufEntry{0, 0});
  size_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < count; ++s) {
      if (weights[s] != w) continue;
      const size_t len = size_t(1) << (w - 1);
      const HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - w)};
      for (size_t i = 0; i < len; ++i) t.cells[pos + i] = e;
      pos += len;
    }
  }
  t.ready = true;
  return used;
}

void DecodeHuffmanStream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out,
                         size_t count) {
  BackwardBits bits(src, n);
  const int mb = t.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const HufEntry& e = t.cells[bits.Peek(mb)];
    out[i] = e.symbol;
    bits.left -= e.nb;
  }
  if (!bits.Finished()) Fail("Huffman stream: not consumed exactly");
}

// ---------------------------------------------------------------- sequences
constexpr uint32_t kLlBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMlBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLlDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMlDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1,  1,  1,  1,  1,  1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOfDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum { kLl = 0, kOf = 1, kMl = 2 };
constexpr int kMaxSymbol[3] = {35, 31, 52};
constexpr int kMaxLog[3] = {9, 8, 9};

struct FrameState {
  HufTable huffman;
  FseTable fse[3];
  uint32_t rep[3] = {1, 4, 8};
};

// Read one table of the sequences section; returns bytes used.
size_t ReadSequenceTable(FseTable& t, int kind, int mode, const uint8_t* src, size_t n) {
  switch (mode) {
    case 0:  // predefined
      if (kind == kLl) BuildFse(t, kLlDefault, 35, 6);
      else if (kind == kMl) BuildFse(t, kMlDefault, 52, 6);
      else BuildFse(t, kOfDefault, 28, 5);
      return 0;
    case 1:  // RLE
      if (n < 1) Fail("sequences: truncated RLE table");
      if (src[0] > kMaxSymbol[kind]) Fail("sequences: RLE symbol out of range");
      RleFse(t, src[0]);
      return 1;
    case 2:  // FSE-coded
      return ReadFseDescription(t, src, n, kMaxSymbol[kind], kMaxLog[kind]);
    default:  // repeat
      if (!t.ready) Fail("sequences: repeat mode without an earlier table");
      return 0;
  }
}

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t pos;
  void Need(size_t k) const {
    if (k > cap - pos) throw OutOfRoom();
  }
};

void DecodeCompressedBlock(const uint8_t* src, size_t n, FrameState& st, Output& out,
                           size_t frame_start) {
  // -- literals section
  if (n < 1) Fail("block: no literals header");
  const int lit_type = src[0] & 3, size_format = (src[0] >> 2) & 3;
  size_t regen, comp = 0, header;
  if (lit_type < 2) {
    if (size_format == 1) {
      header = 2;
    } else if (size_format == 3) {
      header = 3;
    } else {
      header = 1;
    }
    if (n < header) Fail("literals: truncated header");
    if (header == 1) regen = src[0] >> 3;
    else if (header == 2) regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    else regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
  } else {
    header = size_format < 2 ? 3 : size_format == 2 ? 4 : 5;
    if (n < header) Fail("literals: truncated header");
    uint64_t v = 0;
    for (size_t i = 0; i < header; ++i) v |= uint64_t(src[i]) << (8 * i);
    v >>= 4;
    const int bits = header == 3 ? 10 : header == 4 ? 14 : 18;
    regen = size_t(v & ((1u << bits) - 1));
    comp = size_t(v >> bits);
  }
  if (regen > (1 << 17)) Fail("literals: more than a block");
  std::vector<uint8_t> literals(regen + 8);
  size_t pos = header;
  if (lit_type == 0) {
    if (pos + regen > n) Fail("literals: truncated raw literals");
    std::memcpy(literals.data(), src + pos, regen);
    pos += regen;
  } else if (lit_type == 1) {
    if (pos + 1 > n) Fail("literals: truncated RLE literal");
    std::memset(literals.data(), src[pos], regen);
    pos += 1;
  } else {
    if (pos + comp > n) Fail("literals: truncated Huffman literals");
    const uint8_t* p = src + pos;
    size_t avail = comp;
    if (lit_type == 2) {
      size_t used = ReadHuffmanTree(st.huffman, p, avail);
      p += used;
      avail -= used;
    } else if (!st.huffman.ready) {
      Fail("literals: treeless literals without an earlier Huffman table");
    }
    if (size_format == 0) {
      DecodeHuffmanStream(st.huffman, p, avail, literals.data(), regen);
    } else {
      if (avail < 6) Fail("literals: truncated jump table");
      size_t sizes[4] = {Le16(p), Le16(p + 2), Le16(p + 4), 0};
      if (sizes[0] + sizes[1] + sizes[2] + 6 > avail) Fail("literals: bad jump table");
      sizes[3] = avail - 6 - sizes[0] - sizes[1] - sizes[2];
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) Fail("literals: too few for four streams");
      const uint8_t* q = p + 6;
      for (int s = 0; s < 4; ++s) {
        const size_t cnt = s < 3 ? seg : regen - 3 * seg;
        DecodeHuffmanStream(st.huffman, q, sizes[s], literals.data() + s * seg, cnt);
        q += sizes[s];
      }
    }
    pos += comp;
  }

  // -- sequences section
  if (pos >= n) Fail("block: no sequences header");
  size_t nseq = src[pos];
  if (nseq == 0) {
    pos += 1;
  } else if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) Fail("sequences: truncated count");
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) Fail("sequences: truncated count");
    nseq = src[pos + 1] + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const uint8_t* lit = literals.data();
  const uint8_t* lit_end = lit + regen;
  if (nseq == 0) {
    if (pos != n) Fail("sequences: bytes after an empty sequences section");
    out.Need(regen);
    std::memcpy(out.dst + out.pos, lit, regen);
    out.pos += regen;
    return;
  }
  if (pos >= n) Fail("sequences: truncated modes");
  const uint8_t modes = src[pos++];
  if (modes & 3) Fail("sequences: reserved mode bits set");
  const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
  for (int k : {kLl, kOf, kMl}) pos += ReadSequenceTable(st.fse[k], k, mode[k], src + pos, n - pos);
  if (pos >= n) Fail("sequences: no bitstream");
  BackwardBits bits(src + pos, n - pos);
  const FseTable &tl = st.fse[kLl], &to = st.fse[kOf], &tm = st.fse[kMl];
  uint32_t sl = bits.Read(tl.log), so = bits.Read(to.log), sm = bits.Read(tm.log);
  uint32_t* rep = st.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry &el = tl.cells[sl], &eo = to.cells[so], &em = tm.cells[sm];
    const int of_code = eo.symbol;
    if (of_code > 31) Fail("sequences: offset code above 31");
    uint64_t of_value = (uint64_t(1) << of_code) + bits.Read(of_code);
    const uint32_t ml = kMlBase[em.symbol] + bits.Read(kMlBits[em.symbol]);
    const uint32_t ll = kLlBase[el.symbol] + bits.Read(kLlBits[el.symbol]);
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = uint32_t(offset);
    } else {
      const uint64_t idx = of_value + (ll == 0 ? 1 : 0);
      if (idx == 1) {
        offset = rep[0];
      } else {
        offset = idx == 4 ? uint64_t(rep[0]) - 1 : rep[idx - 1];
        if (offset == 0) Fail("sequences: repeat offset of zero");
        if (idx != 2) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      }
    }
    if (i + 1 < nseq) {
      sl = el.base + bits.Read(el.nb);
      sm = em.base + bits.Read(em.nb);
      so = eo.base + bits.Read(eo.nb);
    }
    if (bits.Overflowed()) Fail("sequences: bitstream overrun");
    if (ll > size_t(lit_end - lit)) Fail("sequences: literal length past the literals");
    out.Need(size_t(ll) + ml);
    std::memcpy(out.dst + out.pos, lit, ll);
    lit += ll;
    out.pos += ll;
    if (offset > out.pos - frame_start) Fail("sequences: offset before the frame");
    uint8_t* d = out.dst + out.pos;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (uint32_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    out.pos += ml;
  }
  if (!bits.Finished()) Fail("sequences: bitstream not consumed exactly");
  const size_t tail = size_t(lit_end - lit);
  out.Need(tail);
  std::memcpy(out.dst + out.pos, lit, tail);
  out.pos += tail;
}

struct FrameHeader {
  size_t header_size;
  bool has_size;
  uint64_t content_size;
  bool checksum;
};

FrameHeader ReadFrameHeader(const uint8_t* src, size_t n, size_t at) {
  if (n < 5) Fail("frame at byte " + std::to_string(at) + ": truncated header");
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) Fail("frame at byte " + std::to_string(at) + ": reserved header bit set");
  size_t pos = 5 + (single ? 0 : 1);
  const size_t dict_size = dict_flag == 0 ? 0 : dict_flag == 1 ? 1 : dict_flag == 2 ? 2 : 4;
  const size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  if (pos + dict_size + fcs_size > n) Fail("frame at byte " + std::to_string(at) + ": truncated header");
  uint32_t dict = 0;
  for (size_t i = 0; i < dict_size; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
  if (dict != 0)
    Fail("frame at byte " + std::to_string(at) + " needs dictionary ID " + std::to_string(dict) +
         "; dictionaries are not supported");
  pos += dict_size;
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  return FrameHeader{pos, fcs_size > 0, fcs, bool((fhd >> 2) & 1)};
}

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr size_t kMaxBlock = 1 << 17;

bool IsSkippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Decode every frame of src into out; returns bytes written.
size_t Decompress(const uint8_t* src, size_t n, Output& out) {
  size_t at = 0;
  if (n == 0) Fail("no frame");
  while (at < n) {
    if (n - at < 4) Fail("trailing bytes after the last frame");
    const uint32_t magic = Le32(src + at);
    if (IsSkippable(magic)) {
      if (n - at < 8) Fail("truncated skippable frame");
      const uint64_t size = Le32(src + at + 4);
      if (size > n - at - 8) Fail("truncated skippable frame");
      at += 8 + size;
      continue;
    }
    if (magic != kFrameMagic) Fail("byte " + std::to_string(at) + ": not a Zstandard frame");
    const FrameHeader fh = ReadFrameHeader(src + at, n - at, at);
    size_t pos = at + fh.header_size;
    const size_t frame_start = out.pos;
    FrameState st;
    for (;;) {
      if (n - pos < 3) Fail("truncated block header");
      const uint32_t bh = Le24(src + pos);
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) Fail("reserved block type");
      if (size > kMaxBlock) Fail("block larger than 128 KiB");
      if (type == 1) {
        if (pos >= n) Fail("truncated RLE block");
        out.Need(size);
        std::memset(out.dst + out.pos, src[pos], size);
        out.pos += size;
        pos += 1;
      } else {
        if (size > n - pos) Fail("truncated block");
        if (type == 0) {
          out.Need(size);
          std::memcpy(out.dst + out.pos, src + pos, size);
          out.pos += size;
        } else {
          DecodeCompressedBlock(src + pos, size, st, out, frame_start);
        }
        pos += size;
      }
      if (last) break;
    }
    if (fh.has_size && out.pos - frame_start != fh.content_size)
      Fail("frame at byte " + std::to_string(at) + ": content size differs from its header");
    if (fh.checksum) {
      if (n - pos < 4) Fail("truncated content checksum");
      const uint32_t want = Le32(src + pos);
      const uint32_t got = uint32_t(Xxh64(out.dst + frame_start, out.pos - frame_start));
      if (want != got)
        Fail("frame at byte " + std::to_string(at) + ": content checksum mismatch");
      pos += 4;
    }
    at = pos;
  }
  return out.pos;
}

// Sum of declared content sizes; -1 if a frame declares none.
int64_t ContentSize(const uint8_t* src, size_t n) {
  size_t at = 0;
  uint64_t total = 0;
  while (at < n) {
    if (n - at < 8) Fail("truncated frame");
    const uint32_t magic = Le32(src + at);
    if (IsSkippable(magic)) {
      at += 8 + size_t(Le32(src + at + 4));
      continue;
    }
    if (magic != kFrameMagic) Fail("not a Zstandard frame");
    const FrameHeader fh = ReadFrameHeader(src + at, n - at, at);
    if (!fh.has_size) return -1;
    total += fh.content_size;
    size_t pos = at + fh.header_size;
    for (;;) {
      if (pos > n || n - pos < 3) Fail("truncated block header");
      const uint32_t bh = Le24(src + pos);
      pos += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
      if (bh & 1) break;
    }
    at = pos + (fh.checksum ? 4 : 0);
  }
  return int64_t(total);
}

uint32_t kCrcTable[256];
bool crc_ready = false;

}  // namespace

extern "C" {

int64_t lz_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    return ContentSize(src, size_t(n));
  } catch (const ZstdError&) {
    return -2;
  }
}

int64_t lz_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                           int64_t errcap) {
  Output out{dst, size_t(cap), 0};
  try {
    return int64_t(Decompress(src, size_t(n), out));
  } catch (const OutOfRoom&) {
    return -3;
  } catch (const ZstdError& e) {
    if (errcap > 0) std::snprintf(err, size_t(errcap), "%s", e.what());
    return -1;
  }
}

uint32_t lz_crc32c(const uint8_t* src, int64_t n) {
  if (!crc_ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      kCrcTable[i] = c;
    }
    crc_ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = kCrcTable[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
