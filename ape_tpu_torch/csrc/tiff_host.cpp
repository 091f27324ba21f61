// TIFF strip and tile decoding for the host CPU, in plain C++17: the codecs
// of `data/tiff.py` that are sequential bit by bit (LZW, PackBits, CCITT
// modified Huffman, Group 3 and Group 4), each as libtiff 4.7's tif_lzw.c,
// tif_packbits.c and tif_fax3.c decode one strip or tile for PIL 12.1
// (which reads every compressed TIFF through libtiff). `data/tiff.py`
// parses the directory, reverses the bits of FillOrder 2 data, undoes the
// predictors and unpacks the samples itself.
//
// LZW: codes of 9-12 bits, most significant bit first, the width growing
// one code early (at 511, 1023, 2047); a clear code resets the table, and
// consecutive clears are one; the first code after a clear must be a
// literal; a code whose string is not in the table is corrupt; the end of
// the data reads as the end code. Old-style (pre-5.0) LZW, whose data
// starts with 0x00 0x01, reads least significant bit first and grows the
// width one code late, as LZWDecodeCompat does.
//
// CCITT: the runs of each row are read as tif_fax3.c's EXPAND1D and
// EXPAND2D macros read them (makeup codes summed, a row ending early or late
// padded or cut to the width), with libtiff's end of data: missing bits read
// as zeros until no bit is left. Modified Huffman rows are byte aligned and
// have no EOL; Group 3 rows follow an EOL (fill bits skipped), and under
// T4Options bit 0 a tag bit chooses 1-D or 2-D coding; Group 4 rows are 2-D
// against the row above (an all-white row before the first), and the data
// may end after the last row or with an EOFB.
//
// C interface (ctypes): each returns 0 when the output is full, 1 for
// corrupt data (libtiff's error), 2 when the data ends first ("Not enough
// data").

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------- LZW
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMax = 12;
constexpr int kCsize = (1 << kBitsMax) + 1024;  // libtiff's CSIZE

struct Code {
  int next = -1;  // the string's prefix code, -1 for a literal
  int length = 0;
  uint8_t value = 0, firstchar = 0;
};

int lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  const bool compat = n >= 2 && in[0] == 0 && (in[1] & 1);
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  size_t pos = 0;
  uint64_t acc = 0;
  int avail = 0;
  int nbits = 9;
  // new style grows when the next free code passes mask - 1, old style past mask
  auto limit = [&](int bits) { return compat ? (1 << bits) - 1 : (1 << bits) - 2; };
  int maxcode = limit(nbits);
  int free_ent = kFirst, oldcode = 0;
  auto next_code = [&]() -> int {
    while (avail < nbits) {
      if (pos >= n) return kEoi;  // "not terminated with EOI code": a warning
      if (compat)
        acc |= (uint64_t)in[pos++] << avail;
      else
        acc = (acc << 8) | in[pos++];
      avail += 8;
    }
    int c;
    if (compat) {
      c = (int)(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      c = (int)((acc >> (avail - nbits)) & ((1u << nbits) - 1));
    }
    avail -= nbits;
    return c;
  };
  size_t o = 0;
  while (o < occ) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        for (int c = kFirst; c < kCsize; ++c) tab[c] = Code{};
        free_ent = kFirst;
        nbits = 9;
        maxcode = limit(nbits);
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 1;  // "Corrupted LZW table"
      out[o++] = (uint8_t)code;
      oldcode = code;
      continue;
    }
    if (free_ent >= kCsize) return 1;
    Code& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = tab[oldcode].length + 1;
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = limit(nbits);
    }
    oldcode = code;
    if (code >= 256) {
      const Code& s = tab[code];
      if (s.length == 0) return 1;  // "Wrong length of decoded string"
      // the string ends at o + length - 1; a string past the output is cut
      size_t len = (size_t)s.length, end = o + len;
      int c = code;
      for (size_t k = end; k-- > o;) {
        if (c < 0) return 1;
        if (k < occ) out[k] = tab[c].value;
        c = tab[c].next;
      }
      o = end < occ ? end : occ;
    } else {
      out[o++] = (uint8_t)code;
    }
  }
  return o < occ ? 2 : 0;
}

// ---------------------------------------------------------------- PackBits
int packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  size_t p = 0, o = 0;
  while (p < n && o < occ) {
    int c = in[p++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      size_t run = (size_t)(1 - c);
      if (run > occ - o) run = occ - o;  // "Discarding bytes": a warning
      if (p >= n) break;
      std::memset(out + o, in[p++], run);
      o += run;
    } else {
      size_t lit = (size_t)c + 1;
      if (lit > occ - o) lit = occ - o;
      if (n - p < lit) break;  // "lack of data"
      std::memcpy(out + o, in + p, lit);
      o += lit;
      p += lit;
    }
  }
  return o < occ ? 2 : 0;
}

// ---------------------------------------------------------------- CCITT
// run-length codes of ITU-T T.4, table 2 and 3: (bits, run) per color
struct Node {
  int child[2] = {-1, -1};
  int value = -1;  // a run length, or one of the states below
};
constexpr int kEol = -2;

const char* kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* kWhiteMakeup[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* kBlackMakeup[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
// makeup codes 1792-2560, the same for both colors
const char* kExtMakeup[13] = {"00000001000", "00000001100", "00000001101", "000000010010",
                              "000000010011", "000000010100", "000000010101", "000000010110",
                              "000000010111", "000000011100", "000000011101", "000000011110",
                              "000000011111"};
// 2-D mode codes (T.4 table 4)
enum Mode { kPass = 0, kHoriz, kV0, kVR1, kVR2, kVR3, kVL1, kVL2, kVL3, kExt, kModeEol };
const char* kModes[11] = {"0001",    "001",     "1",       "011",  "000011",      "0000011",
                          "010",     "000010",  "0000010", "0000001", "0000000"};

struct Trie {
  std::vector<Node> nodes = std::vector<Node>(1);
  void add(const char* bits, int value) {
    int at = 0;
    for (const char* b = bits; *b; ++b) {
      const int bit = *b - '0';
      if (nodes[at].child[bit] < 0) {
        nodes[at].child[bit] = (int)nodes.size();
        nodes.emplace_back();
      }
      at = nodes[at].child[bit];
    }
    nodes[at].value = value;
  }
};

struct Tables {
  Trie white, black, modes;
  Tables() {
    for (int i = 0; i < 64; ++i) {
      white.add(kWhiteTerm[i], i);
      black.add(kBlackTerm[i], i);
    }
    for (int i = 0; i < 27; ++i) {
      white.add(kWhiteMakeup[i], 64 * (i + 1));
      black.add(kBlackMakeup[i], 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      white.add(kExtMakeup[i], 1792 + 64 * i);
      black.add(kExtMakeup[i], 1792 + 64 * i);
    }
    // libtiff's tables hold an EOL as its 11 zero bits (the 1 after them is
    // left for SYNC_EOL); a code no table holds consumes no bit
    white.add("00000000000", kEol);
    black.add("00000000000", kEol);
    for (int i = 0; i < 11; ++i) modes.add(kModes[i], i);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// libtiff's bit cache: a missing bit past the end reads as 0 as long as
// some real bit is left, and the end of data is met when none is
struct Bits {
  const uint8_t* d;
  size_t n, pos = 0;
  uint64_t acc = 0;
  int avail = 0;
  bool need(int k) {
    while (avail < k) {
      if (pos >= n) {
        if (avail == 0) return false;
        acc <<= (k - avail);
        avail = k;
        return true;
      }
      acc = (acc << 8) | d[pos++];
      avail += 8;
    }
    return true;
  }
  uint32_t get(int k) const { return (uint32_t)((acc >> (avail - k)) & ((1ull << k) - 1)); }
  void clr(int k) { avail -= k; }
};

struct EndOfData {};

// the value of the code that starts the cached bits (-1 if none of the trie
// holds them), at most `width` bits looked at, the code's bits consumed
int lookup(Bits& b, const Trie& t, int width) {
  if (!b.need(width)) throw EndOfData{};
  const uint32_t v = b.get(width);
  int at = 0;
  for (int i = 0; i < width; ++i) {
    at = t.nodes[at].child[(v >> (width - 1 - i)) & 1];
    if (at < 0) return -1;
    if (t.nodes[at].value != -1) {
      b.clr(i + 1);
      return t.nodes[at].value;
    }
  }
  return -1;
}

struct Fax {
  Bits b;
  int lastx;
  // libtiff's two run arrays of nruns entries each, zeroed once: this row's
  // runs (white, black, ...) are cur[0, pa), the row above's ref[0, ...);
  // a read past the row above's runs sees what an earlier row left there
  size_t nruns;
  std::vector<int> runs;
  int* cur;
  int* ref;
  size_t pa = 0;
  int a0 = 0, run_length = 0;
  int eolcnt = 0;
  Fax(const uint8_t* d, size_t n, int width)
      : b{d, n}, lastx(width), nruns(2 * (((size_t)width + 1 + 31) / 32 * 32)),
        runs(2 * nruns, 0), cur(runs.data()), ref(runs.data() + nruns) {}

  void setvalue(int x) {
    if (pa >= nruns) throw std::string("run array overflow");
    cur[pa++] = run_length + x;
    a0 += x;
    run_length = 0;
  }
  void cleanup() {  // CLEANUP_RUNS
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= cur[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  // one color's run (makeup codes then a terminating code); false where
  // the row ends (EOL or a bad code)
  bool color_run(const Trie& t, int width, bool& eol) {
    for (;;) {
      const int v = lookup(b, t, width);
      if (v == kEol) {
        eol = true;
        return false;
      }
      if (v < 0) return false;  // "Bad code word": the row ends here
      if (v < 64) {
        setvalue(v);
        return true;
      }
      a0 += v;
      run_length += v;
    }
  }
  void expand1d() {  // EXPAND1D; EndOfData propagates after the cleanup
    const Trie& w = tables().white;
    const Trie& k = tables().black;
    try {
      for (;;) {
        bool eol = false;
        if (!color_run(w, 12, eol)) {
          if (eol) eolcnt = 1;
          break;
        }
        if (a0 >= lastx) break;
        if (!color_run(k, 13, eol)) {
          if (eol) eolcnt = 1;
          break;
        }
        if (a0 >= lastx) break;
        if (pa >= 2 && cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
      }
    } catch (const EndOfData&) {
      cleanup();
      throw;
    }
    cleanup();
  }
  void expand2d() {  // EXPAND2D against `ref`
    const Tables& T = tables();
    size_t pb = 0;
    auto refrun = [&](size_t i) -> int {
      if (i >= nruns) throw std::string("reference run array overflow");
      return ref[i];
    };
    int b1 = refrun(pb++);
    auto check_b1 = [&]() {
      if (pa != 0)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= nruns) throw std::string("reference run array overflow");
          b1 += ref[pb] + ref[pb + 1];
          pb += 2;
        }
    };
    try {
      while (a0 < lastx) {
        if (pa >= nruns) throw std::string("run array overflow");
        const int m = lookup(b, T.modes, 7);
        bool eol = false;
        switch (m) {
          case kPass:
            check_b1();
            b1 += refrun(pb++);
            run_length += b1 - a0;
            a0 = b1;
            b1 += refrun(pb++);
            break;
          case kHoriz: {
            const bool black_first = pa & 1;
            const Trie& first = black_first ? T.black : T.white;
            const Trie& second = black_first ? T.white : T.black;
            if (!color_run(first, black_first ? 13 : 12, eol) ||
                !color_run(second, black_first ? 12 : 13, eol)) {
              cleanup();  // "Bad code word": unexpected, then the row ends
              return;
            }
            check_b1();
            break;
          }
          case kV0:
            check_b1();
            setvalue(b1 - a0);
            b1 += refrun(pb++);
            break;
          case kVR1:
          case kVR2:
          case kVR3:
            check_b1();
            setvalue(b1 - a0 + (m - kV0));
            b1 += refrun(pb++);
            break;
          case kVL1:
          case kVL2:
          case kVL3: {
            const int d = m - kVR3;
            check_b1();
            if (b1 < a0 + d) {
              cleanup();
              return;
            }
            setvalue(b1 - a0 - d);
            if (pb == 0) throw std::string("reference run array underflow");
            b1 -= ref[--pb];
            break;
          }
          case kExt:  // uncompressed mode: not supported, the row ends
            cur[pa++] = lastx - a0;
            cleanup();
            return;
          case kModeEol:
            cur[pa++] = lastx - a0;
            // the main table looks at 7 zero bits; 4 more are skipped
            if (!b.need(4)) throw EndOfData{};
            b.clr(4);
            eolcnt = 1;
            cleanup();
            return;
          default:
            cleanup();
            return;
        }
      }
      if (run_length) {
        if (run_length + a0 < lastx) {  // a final V0 is expected
          if (!b.need(1)) throw EndOfData{};
          if (!b.get(1)) {
            cleanup();
            return;
          }
          b.clr(1);
        }
        setvalue(0);
      }
    } catch (const EndOfData&) {
      cleanup();
      throw;
    }
    cleanup();
  }
  void sync_eol() {  // SYNC_EOL
    if (eolcnt == 0) {
      for (;;) {
        if (!b.need(11)) throw EndOfData{};
        if (b.get(11) == 0) break;
        b.clr(1);
      }
    }
    for (;;) {
      if (!b.need(8)) throw EndOfData{};
      if (b.get(8)) break;
      b.clr(8);
    }
    while (b.get(1) == 0) b.clr(1);
    b.clr(1);
    eolcnt = 0;
  }
  void fill(uint8_t* row) {  // _TIFFFastFillRuns: black runs as 1 bits
    int x = 0;
    for (size_t i = 0; i < pa; ++i) {
      int r = cur[i];
      if (x + r > lastx || r > lastx) r = cur[i] = lastx - x;
      if (i & 1)
        for (int k = x; k < x + r; ++k) row[k >> 3] |= (uint8_t)(0x80 >> (k & 7));
      x += r;
    }
  }
  void next_row() {  // the imaginary change for the reference row, then swap
    if (pa < nruns) setvalue(0);
    std::swap(cur, ref);
  }
};

}  // namespace

extern "C" {

// LZW data `in` (n bytes) -> `occ` bytes of `out`
int ape_tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  return lzw(in, n, out, occ);
}

// PackBits data `in` (n bytes) -> `occ` bytes of `out`
int ape_tiff_packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  return packbits(in, n, out, occ);
}

// CCITT data `in` (n bytes) of compression 2, 3 or 4 (T4Options `options`
// for 3) -> `rows` rows of `width` pixels, 1 bit each (1 black), each row
// ceil(width / 8) bytes, in `out` (zeroed by the caller)
int ape_tiff_fax(const uint8_t* in, size_t n, int compression, int options, int width, int rows,
                 uint8_t* out) {
  const size_t rowbytes = ((size_t)width + 7) / 8;
  Fax f(in, n, width);
  f.ref[0] = width;
  f.ref[1] = 0;
  int line = 0;
  try {
    for (; line < rows; ++line) {
      f.a0 = 0;
      f.run_length = 0;
      f.pa = 0;
      if (compression == 2) {
        f.expand1d();
        // byte alignment: the cached bits past the last whole byte go
        f.b.clr(f.b.avail & 7);
      } else if (compression == 3) {
        f.sync_eol();
        bool one_d = true;
        if (options & 1) {
          if (!f.b.need(1)) throw EndOfData{};
          one_d = f.b.get(1);
          f.b.clr(1);
        }
        if (one_d)
          f.expand1d();
        else
          f.expand2d();
      } else {
        f.expand2d();
        if (f.eolcnt) {  // EOFB: the strip ends here
          f.fill(out + (size_t)line * rowbytes);
          return line ? 0 : 1;
        }
      }
      f.fill(out + (size_t)line * rowbytes);
      f.next_row();
    }
  } catch (const EndOfData&) {  // premature end: the partial row is filled
    f.fill(out + (size_t)line * rowbytes);
    // a badly terminated strip: Group 4 passes once a row is done and Group
    // 3 passes (PIL reads both; the rows after the end hold what libtiff's
    // buffer held, which this leaves 0, white), modified Huffman fails
    if (compression == 4) return line ? 0 : 2;
    return compression == 3 ? 0 : 2;
  } catch (const std::string&) {  // libtiff's "Buffer overflow": an error
    return 1;
  }
  return 0;
}

}  // extern "C"
