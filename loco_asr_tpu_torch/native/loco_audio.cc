// loco_audio: the host ingest core of loco_asr_tpu_torch (C ABI, loaded
// through ctypes by native/__init__.py), the port's own copy of the JAX
// package's core.
//
// It decodes NIST SPHERE (pcm, mu-law, A-law and shorten-coded, the coding
// of LDC telephone corpora such as Fisher): the work of sph2pipe.
// ops/audio_io.read_sphere and ops/shorten.py are its numpy twins with the
// same numerics; the tests hold the two to each other.
//
// Exposed functions (all return <0 on error):
//   la_sphere_info(path, *rate, *channels, *samples_per_channel)
//   la_sphere_read(path, channel /*-1=mix*/, float* out, long cap)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kUlawBias = 0x84;

int16_t UlawToLinear(uint8_t u) {
  u = ~u;
  int sign = u & 0x80;
  int exponent = (u >> 4) & 0x07;
  int mantissa = u & 0x0F;
  int sample = (((mantissa << 3) + kUlawBias) << exponent) - kUlawBias;
  return static_cast<int16_t>(sign ? -sample : sample);
}

int16_t AlawToLinear(uint8_t a) {
  a ^= 0x55;
  int sign = a & 0x80;
  int exponent = (a >> 4) & 0x07;
  int mantissa = a & 0x0F;
  int sample = (mantissa << 4) + 8;
  if (exponent > 0) sample = (sample + 0x100) << (exponent - 1);
  return static_cast<int16_t>(sign ? -sample : sample);
}

struct SphereHeader {
  long header_size = 0;
  int sample_rate = 8000;
  int channels = 1;
  int sample_n_bytes = 2;
  long sample_count = -1;  // per channel, from the header (if present)
  bool big_endian = false;
  enum { PCM, ULAW, ALAW, SHORTEN } coding = PCM;
  long data_bytes = 0;
};

int ParseSphereHeader(FILE* f, SphereHeader* h) {
  char magic[8] = {0};
  if (fread(magic, 1, 8, f) != 8 || strncmp(magic, "NIST_1A", 7) != 0) return -1;
  char size_buf[9] = {0};
  if (fread(size_buf, 1, 8, f) != 8) return -1;
  h->header_size = atol(size_buf);
  if (h->header_size <= 16 || h->header_size > 1 << 20) return -1;
  std::vector<char> buf(h->header_size + 1, 0);
  if (fseek(f, 0, SEEK_SET) != 0) return -1;
  if (fread(buf.data(), 1, h->header_size, f) != (size_t)h->header_size) return -1;

  char* saveptr = nullptr;
  for (char* line = strtok_r(buf.data(), "\n", &saveptr); line;
       line = strtok_r(nullptr, "\n", &saveptr)) {
    if (strncmp(line, "end_head", 8) == 0) break;
    char name[128], type[32], value[512];
    if (sscanf(line, "%127s %31s %511s", name, type, value) != 3) continue;
    if (!strcmp(name, "sample_rate")) h->sample_rate = atoi(value);
    else if (!strcmp(name, "channel_count")) h->channels = atoi(value);
    else if (!strcmp(name, "sample_count")) h->sample_count = atol(value);
    else if (!strcmp(name, "sample_n_bytes")) h->sample_n_bytes = atoi(value);
    else if (!strcmp(name, "sample_byte_format")) h->big_endian = !strcmp(value, "10");
    else if (!strcmp(name, "sample_coding")) {
      if (strstr(value, "shorten")) h->coding = SphereHeader::SHORTEN;
      else if (strstr(value, "ulaw") || strstr(value, "mu-law")) h->coding = SphereHeader::ULAW;
      else if (strstr(value, "alaw")) h->coding = SphereHeader::ALAW;
      else h->coding = SphereHeader::PCM;
    }
  }
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  h->data_bytes = ftell(f) - h->header_size;
  if (fseek(f, h->header_size, SEEK_SET) != 0) return -1;
  if (h->coding != SphereHeader::PCM && h->coding != SphereHeader::SHORTEN)
    h->sample_n_bytes = 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Shorten (SHN) decoder: "embedded-shorten-v2.xx" SPHERE payloads, the
// coding sph2pipe decompresses for LDC telephone corpora.  Bitstream per
// the published shorten 2.x spec (Robinson TR156); the numpy twin is
// ops/shorten.py, and the tests hold the two to each other bit for bit.
// ---------------------------------------------------------------------------

namespace shorten {

constexpr int kUlongSize = 2, kTypeSize = 4, kChanSize = 0, kFnSize = 2;
constexpr int kEnergySize = 3, kBitshiftSize = 2, kLpcqSize = 2, kLpcQuant = 5;
constexpr int kNSkipSize = 1, kXByteSize = 7;
constexpr int kVerbatimCkSize = 5, kVerbatimByteSize = 8;
constexpr int kDefaultBlockSize = 256, kNWrap = 3;
constexpr int64_t kV2LpcqOffset = 1 << kLpcQuant;
constexpr int kMaxChannels = 16, kMaxBlocksize = 1 << 17, kMaxNlpc = 1024;

enum Fn { FN_DIFF0 = 0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QUIT, FN_BLOCKSIZE,
          FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM };

enum Type { TYPE_AU1 = 0, TYPE_S8, TYPE_U8, TYPE_S16HL, TYPE_U16HL,
            TYPE_S16LH, TYPE_U16LH, TYPE_ULAW, TYPE_AU2, TYPE_AU3,
            TYPE_ALAW };

struct BitReader {
  const uint8_t* p;
  size_t nbytes;
  size_t bitpos = 0;
  bool ok = true;

  int Bit() {
    if (bitpos >= 8 * nbytes) { ok = false; return 0; }
    int b = (p[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
    ++bitpos;
    return b;
  }
  uint32_t Bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | Bit();
    return v;
  }
  uint32_t Uvar(int k) {
    uint32_t q = 0;
    while (ok && !Bit()) {
      if (++q > (1u << 24)) { ok = false; break; }
    }
    return (q << k) | Bits(k);
  }
  int32_t Var(int k) {
    uint32_t u = Uvar(k + 1);
    return (u & 1) ? ~static_cast<int32_t>(u >> 1)
                   : static_cast<int32_t>(u >> 1);
  }
  uint32_t Ulong() { return Uvar(Uvar(kUlongSize)); }
};

inline int64_t RoundedShiftDown(int64_t x, int n) {
  return n == 0 ? x : ((x >> (n - 1)) + 1) >> 1;
}

// C-style truncating division (shorten does slong division in C).
inline int64_t CDiv(int64_t a, int64_t b) { return a / b; }

// Decodes a shorten stream into per-channel int32 samples in the internal
// domain (PCM values, or G.711-expanded linear for ulaw/alaw types).
// max_frames < 0 means decode everything.  Returns 0 or <0 on error.
int Decode(const uint8_t* data, size_t n, long max_frames, int* ftype_out,
           std::vector<std::vector<int32_t>>* out) {
  // locate magic (tolerate a small preamble)
  if (n < 9) return -4;
  size_t off = 0;
  const size_t scan = n - 4 < 4096 ? n - 4 : 4096;
  for (;; ++off) {
    if (off > scan) return -4;
    if (memcmp(data + off, "ajkg", 4) == 0) break;
  }
  if (off + 5 > n) return -4;
  int version = data[off + 4];
  if (version > 3) return -5;
  BitReader br{data + off + 5, n - off - 5};

  auto get_uint = [&](int k_default) -> uint32_t {
    return version > 0 ? br.Ulong() : br.Uvar(k_default);
  };

  int ftype = get_uint(kTypeSize);
  int nchan = get_uint(kChanSize);
  if (nchan <= 0 || nchan > kMaxChannels) return -6;
  long blocksize = kDefaultBlockSize;
  int maxnlpc = 0, nmean = 0;
  if (version > 0) {
    blocksize = get_uint(8 /* log2(kDefaultBlockSize) */);
    maxnlpc = get_uint(kLpcqSize);
    nmean = get_uint(0);
    int nskip = get_uint(kNSkipSize);
    for (int i = 0; i < nskip; ++i) br.Uvar(kXByteSize);
  }
  if (blocksize <= 0 || blocksize > kMaxBlocksize) return -6;
  if (maxnlpc > kMaxNlpc || nmean > 65536) return -6;
  const int64_t lpcqoffset = version >= 2 ? kV2LpcqOffset : 0;
  const int nwrap = maxnlpc > kNWrap ? maxnlpc : kNWrap;

  int64_t mean0 = ftype == TYPE_U8 ? 0x80
                  : (ftype == TYPE_U16HL || ftype == TYPE_U16LH) ? 0x8000 : 0;
  const int noff = nmean > 0 ? nmean : 1;
  std::vector<std::vector<int64_t>> offsets(nchan,
                                            std::vector<int64_t>(noff, mean0));
  // per-channel sample buffer with nwrap history slots at the front
  std::vector<std::vector<int64_t>> buf(
      nchan, std::vector<int64_t>(nwrap + blocksize, 0));
  out->assign(nchan, {});
  std::vector<int32_t> qlpc(kMaxNlpc);
  int bitshift = 0;
  int chan = 0;

  while (br.ok) {
    uint32_t cmd = br.Uvar(kFnSize);
    if (!br.ok) return -7;
    if (cmd == FN_QUIT) break;
    switch (cmd) {
      case FN_VERBATIM: {
        uint32_t len = br.Uvar(kVerbatimCkSize);
        for (uint32_t i = 0; i < len && br.ok; ++i) br.Uvar(kVerbatimByteSize);
        break;
      }
      case FN_BITSHIFT:
        bitshift = br.Uvar(kBitshiftSize);
        if (bitshift > 31) return -7;
        break;
      case FN_BLOCKSIZE: {
        int lg = 0;
        while ((1L << (lg + 1)) <= blocksize) ++lg;
        long nb = get_uint(lg);
        if (nb <= 0 || nb > kMaxBlocksize) return -7;
        blocksize = nb;
        for (auto& b : buf)
          if ((long)b.size() < nwrap + blocksize) b.resize(nwrap + blocksize, 0);
        break;
      }
      case FN_DIFF0: case FN_DIFF1: case FN_DIFF2: case FN_DIFF3:
      case FN_QLPC: case FN_ZERO: {
        int resn = 0;
        if (cmd != FN_ZERO) {
          resn = br.Uvar(kEnergySize);
          if (version == 0) --resn;
          if (resn < 0 || resn > 30) return -7;
        }
        std::vector<int64_t>& o = offsets[chan];
        int64_t coffset;
        if (nmean == 0) {
          coffset = o[0];
        } else {
          int64_t sum = version < 2 ? 0 : nmean / 2;
          for (int i = 0; i < nmean; ++i) sum += o[i];
          coffset = CDiv(sum, nmean);
          if (version >= 2) coffset = RoundedShiftDown(coffset, bitshift);
        }
        int64_t* cb = buf[chan].data() + nwrap;  // cb[-1]... is history
        switch (cmd) {
          case FN_ZERO:
            for (long i = 0; i < blocksize; ++i) cb[i] = 0;
            break;
          case FN_DIFF0:
            for (long i = 0; i < blocksize; ++i) cb[i] = br.Var(resn) + coffset;
            break;
          case FN_DIFF1:
            for (long i = 0; i < blocksize; ++i) cb[i] = br.Var(resn) + cb[i - 1];
            break;
          case FN_DIFF2:
            for (long i = 0; i < blocksize; ++i)
              cb[i] = br.Var(resn) + 2 * cb[i - 1] - cb[i - 2];
            break;
          case FN_DIFF3:
            for (long i = 0; i < blocksize; ++i)
              cb[i] = br.Var(resn) + 3 * (cb[i - 1] - cb[i - 2]) + cb[i - 3];
            break;
          case FN_QLPC: {
            int nlpc = br.Uvar(kLpcqSize);
            if (nlpc > nwrap) return -7;
            for (int i = 0; i < nlpc; ++i) qlpc[i] = br.Var(kLpcQuant);
            for (int i = 1; i <= nlpc; ++i) cb[-i] -= coffset;
            for (long i = 0; i < blocksize; ++i) {
              int64_t sum = lpcqoffset;
              for (int j = 0; j < nlpc; ++j) sum += qlpc[j] * cb[i - j - 1];
              cb[i] = br.Var(resn) + (sum >> kLpcQuant);
            }
            if (coffset != 0)
              for (long i = -nlpc; i < blocksize; ++i) cb[i] += coffset;
            break;
          }
        }
        if (!br.ok) return -7;
        if (nmean > 0) {
          int64_t sum = version < 2 ? 0 : blocksize / 2;
          for (long i = 0; i < blocksize; ++i) sum += cb[i];
          for (int i = 1; i < nmean; ++i) o[i - 1] = o[i];
          int64_t mean = CDiv(sum, blocksize);
          o[nmean - 1] = version < 2 ? mean : mean << bitshift;
        }
        // emit (bitshift applied) then wrap history (pre-bitshift)
        std::vector<int32_t>& dst = (*out)[chan];
        size_t base = dst.size();
        dst.resize(base + blocksize);
        for (long i = 0; i < blocksize; ++i)
          dst[base + i] = static_cast<int32_t>(cb[i] << bitshift);
        for (int i = 0; i < nwrap; ++i)
          buf[chan][i] = cb[blocksize - nwrap + i];
        chan = (chan + 1) % nchan;
        if (max_frames >= 0 && chan == 0 &&
            (long)(*out)[0].size() >= max_frames)
          goto done;
        break;
      }
      default:
        return -7;
    }
  }
done:
  *ftype_out = ftype;
  return br.ok || !(*out)[0].empty() ? 0 : -7;
}

// internal-domain sample -> float in [-1, 1]
inline float ToFloat(int32_t v, int ftype) {
  switch (ftype) {
    case TYPE_AU1: case TYPE_ULAW: case TYPE_AU2:
    case TYPE_AU3: case TYPE_ALAW:
    case TYPE_S16HL: case TYPE_S16LH:
      return v / 32768.0f;
    case TYPE_U16HL: case TYPE_U16LH:
      return (v - 32768) / 32768.0f;
    case TYPE_S8:
      return v / 128.0f;
    case TYPE_U8:
      return (v - 128) / 128.0f;
    default:
      return 0.0f;
  }
}

}  // namespace shorten

}  // namespace

extern "C" {

int la_sphere_info(const char* path, int32_t* sample_rate, int32_t* channels,
                   int64_t* samples_per_channel) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  SphereHeader h;
  int rc = ParseSphereHeader(f, &h);
  if (rc < 0) { fclose(f); return rc; }
  *sample_rate = h.sample_rate;
  *channels = h.channels;
  if (h.coding == SphereHeader::SHORTEN) {
    if (h.sample_count >= 0) {
      *samples_per_channel = h.sample_count;
      fclose(f);
      return 0;
    }
    // No sample_count in the header: exact counting would decode the
    // whole stream here AND again in la_sphere_read (2x work on the fast
    // ingest lane).  Return a generous ESTIMATE and rc=1; the caller
    // sizes a buffer from it and grows on -3 (native/__init__.py).
    // 8 samples per compressed byte per channel covers any realistic
    // speech compression ratio; zero-run pathologies are handled by the
    // caller's retry.
    fclose(f);
    int ch = h.channels > 0 ? h.channels : 1;
    *samples_per_channel = (int64_t)(h.data_bytes * 8) / ch + 4096;
    return 1;
  }
  fclose(f);
  *samples_per_channel = h.data_bytes / (h.sample_n_bytes * h.channels);
  return 0;
}

// channel: 0/1 selects, -1 mixes. Returns samples written or <0.
int64_t la_sphere_read(const char* path, int channel, float* out, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  SphereHeader h;
  if (ParseSphereHeader(f, &h) < 0) { fclose(f); return -1; }
  if (h.coding == SphereHeader::SHORTEN) {
    std::vector<uint8_t> raw(h.data_bytes);
    size_t got = fread(raw.data(), 1, h.data_bytes, f);
    fclose(f);
    std::vector<std::vector<int32_t>> chans;
    int ftype;
    if (shorten::Decode(raw.data(), got, h.sample_count, &ftype, &chans) < 0)
      return -2;
    if ((int)chans.size() != h.channels) return -2;
    long frames = chans.empty() ? 0 : (long)chans[0].size();
    for (auto& c : chans) frames = frames < (long)c.size() ? frames
                                                           : (long)c.size();
    if (h.sample_count >= 0 && frames > h.sample_count) frames = h.sample_count;
    if (frames > cap) return -3;
    for (long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      int count = 0;
      for (int c = 0; c < h.channels; ++c) {
        if (channel >= 0 && c != channel) continue;
        acc += shorten::ToFloat(chans[c][i], ftype);
        ++count;
      }
      out[i] = count ? acc / count : 0.0f;
    }
    return frames;
  }
  long n_frames = h.data_bytes / (h.sample_n_bytes * h.channels);
  if (n_frames > cap) { fclose(f); return -3; }

  std::vector<uint8_t> raw(h.data_bytes);
  size_t got = fread(raw.data(), 1, h.data_bytes, f);
  fclose(f);
  n_frames = got / (h.sample_n_bytes * h.channels);

  const float scale = 1.0f / 32768.0f;
  for (long i = 0; i < n_frames; ++i) {
    float acc = 0.0f;
    int count = 0;
    for (int c = 0; c < h.channels; ++c) {
      if (channel >= 0 && c != channel) continue;
      long idx = (i * h.channels + c) * h.sample_n_bytes;
      int16_t s;
      if (h.coding == SphereHeader::ULAW) s = UlawToLinear(raw[idx]);
      else if (h.coding == SphereHeader::ALAW) s = AlawToLinear(raw[idx]);
      else if (h.sample_n_bytes == 2) {
        uint16_t u = h.big_endian ? (raw[idx] << 8) | raw[idx + 1]
                                  : raw[idx] | (raw[idx + 1] << 8);
        s = static_cast<int16_t>(u);
      } else {
        s = static_cast<int16_t>(static_cast<int8_t>(raw[idx])) << 8;
      }
      acc += s * scale;
      ++count;
    }
    out[i] = count ? acc / count : 0.0f;
  }
  return n_frames;
}

}  // extern "C"
