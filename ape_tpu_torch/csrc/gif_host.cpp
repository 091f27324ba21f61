// GIF for the host CPU, in plain C++17, for `data/gif.py`: the LZW decoder
// of the reader, and the median-cut quantiser and LZW encoder of the
// writer. `data/gif.py` parses and writes the blocks and applies PIL 12.1's
// frame-0 and palette rules itself.
//
// The decoder It follows Pillow's GifDecode.c: codes of 2-12 bits growing when
// the next free entry reaches the code mask, a clear code resetting the
// table, a full table (4096 entries) kept without a clear, the first code
// after a clear taken as a literal, a code one past the table (KwKwK)
// allowed, any larger code refused; the 4-pass interlace; the frame done
// once its last row is written, whatever follows. Data is taken in whole
// sub-blocks, as PIL feeds the decoder blocks of 64 KiB and the decoder
// waits for a sub-block to be complete: an end code before the frame is
// full, or sub-blocks that run past the file, leave it waiting for data the
// file no longer has, which PIL reports as a truncated file.
//
// C interface (ctypes): ape_gif_lzw returns 0 (the frame is full), 1 (broken
// data: a code past the table), 2 (truncated) or 3 (a code size past 12).
//
// The quantiser (ape_gif_quantize) is Pillow's Quant.c as `im.quantize(256)`
// runs it on an RGB image (median cut, no k-means):
//   * the colours are counted in a hash whose keys are the colours shifted
//     right by a scale that grows until at most 65536 keys remain
//     (create_pixel_hash; PIXEL_HASH is one-to-one on 8-bit colours, so a key
//     is a scaled colour);
//   * median_cut: a max-heap of boxes by pixel count (QuantHeap.c, its ties
//     kept); a box of one colour (volume 1) leaves the heap unsplit; a box is
//     split along the axis of the largest range weighted 77, 150, 29 (the
//     first on a tie), the colours sorted by that value, largest first, and
//     cut after the run of equal values in which the running count passes
//     half the box (splitlists; the last run moves right if nothing is
//     left there); at most 255 splits;
//   * the leaves numbered left (higher values) first; each palette entry the
//     mean of the unscaled pixels of its box, rounded (compute_palette_
//     from_median_cut);
//   * each colour mapped to its nearest entry by squared distance, its box's
//     entry kept on a tie, then the first of the entries sorted by their
//     distance to the box's entry and their index
//     (map_image_pixels_from_median_box, build_distance_tables).
// ape_gif_quantize returns the number of palette entries.
//
// The encoder (ape_gif_lzw_encode) is Pillow's GifEncode.c: a clear code
// first, codes that grow a bit once the next free code passes the width's
// largest, a clear code (and a reset table) once 4096 codes are in use, the
// end code, the bits packed from the least significant, the bytes cut into
// sub-blocks of 255; the rows in GIF's 4-pass order when interlaced. It
// returns the bytes written (without the terminating empty sub-block), or
// -1 if `cap` is too small.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTable = 4096;
constexpr size_t kPilBlock = 65536;  // ImageFile.MAXBLOCK

// --- the quantiser (Pillow's Quant.c, median cut)

constexpr uint32_t kMaxHashEntries = 65536;  // Quant.c's MAX_HASH_ENTRIES

struct Box {
  std::vector<uint32_t> colours;  // indices into the scaled colour table
  uint32_t count = 0;             // pixels
  int volume = -1;
  int left = -1, right = -1;      // children, once split
};

struct Scaled {
  uint8_t c[3];
  uint32_t count;
};

// QuantHeap.c: a 1-based binary max-heap under box_heap_cmp
struct BoxHeap {
  std::vector<int> heap{0};
  const std::vector<Box>* boxes;
  int cmp(int a, int b) const { return (int)(*boxes)[a].count - (int)(*boxes)[b].count; }
  bool remove(int* r) {
    if (heap.size() <= 1) return false;
    *r = heap[1];
    const int v = heap.back();
    heap.pop_back();
    const size_t count = heap.size() - 1;
    size_t k = 1, l;
    for (; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(heap[l], heap[l + 1]) < 0) ++l;
      if (cmp(v, heap[l]) > 0) break;
      heap[k] = heap[l];
    }
    if (count) heap[k] = v;
    return true;
  }
  void add(int v) {
    heap.push_back(v);
    size_t k = heap.size() - 1;
    while (k != 1) {
      if (cmp(v, heap[k / 2]) < 0) break;
      heap[k] = heap[k / 2];
      k >>= 1;
    }
    heap[k] = v;
  }
};

// the least and greatest value of each axis over `cols`
void ranges(const std::vector<uint32_t>& cols, const std::vector<Scaled>& table, int lo[3],
            int hi[3]) {
  for (int a = 0; a < 3; ++a) lo[a] = 255, hi[a] = 0;
  for (uint32_t i : cols)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], (int)table[i].c[a]);
      hi[a] = std::max(hi[a], (int)table[i].c[a]);
    }
}

int box_volume(Box& b, const std::vector<Scaled>& table) {
  if (b.volume >= 0) return b.volume;
  if (b.colours.empty()) return b.volume = 0;
  int lo[3], hi[3];
  ranges(b.colours, table, lo, hi);
  return b.volume = (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
}

void split_box(std::vector<Box>& boxes, int node, const std::vector<Scaled>& table) {
  std::vector<uint32_t> cols = std::move(boxes[node].colours);
  const uint32_t pixels = boxes[node].count;
  int lo[3], hi[3];
  ranges(cols, table, lo, hi);
  const int f[3] = {(hi[0] - lo[0]) * 77, (hi[1] - lo[1]) * 150, (hi[2] - lo[2]) * 29};
  int axis = 0;
  for (int i = 1; i < 3; ++i)
    if (f[i] > f[axis]) axis = i;
  std::sort(cols.begin(), cols.end(), [&](uint32_t a, uint32_t b) {
    return table[a].c[axis] > table[b].c[axis];
  });
  // splitlists: the runs of equal values whose running count passes half
  size_t cut = 0;
  uint32_t left = 0;
  while (cut < cols.size()) {
    left += table[cols[cut]].count;
    ++cut;
    if ((uint64_t)left * 2 > pixels) break;
  }
  if (cut < cols.size()) {
    const int v = table[cols[cut - 1]].c[axis];
    while (cut < cols.size() && table[cols[cut]].c[axis] == v) ++cut;
  }
  if (cut == cols.size()) {  // nothing right: the last run goes there
    const int v = table[cols.back()].c[axis];
    while (cut > 0 && table[cols[cut - 1]].c[axis] == v) --cut;
  }
  Box l, r;
  l.colours.assign(cols.begin(), cols.begin() + cut);
  r.colours.assign(cols.begin() + cut, cols.end());
  for (uint32_t i : l.colours) l.count += table[i].count;
  for (uint32_t i : r.colours) r.count += table[i].count;
  boxes[node].left = (int)boxes.size();
  boxes[node].right = (int)boxes.size() + 1;
  boxes.push_back(std::move(l));
  boxes.push_back(std::move(r));
}

void number_leaves(const std::vector<Box>& boxes, int node, std::vector<int>& box_of,
                   int* next) {
  const Box& b = boxes[node];
  if (b.left >= 0) {
    number_leaves(boxes, b.left, box_of, next);
    number_leaves(boxes, b.right, box_of, next);
    return;
  }
  for (uint32_t i : b.colours) box_of[i] = *next;
  if (!b.colours.empty()) ++*next;
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  const int d0 = a[0] - b[0], d1 = a[1] - b[1], d2 = a[2] - b[2];
  return (uint32_t)(d0 * d0 + d1 * d1 + d2 * d2);
}

// --- the LZW encoder (Pillow's GifEncode.c)

struct LzwWriter {
  uint8_t* out;
  size_t cap, n = 0, block_at = 0;
  int block_len = 0;
  uint32_t buffer = 0;
  int bits = 0;
  bool overflow = false;
  void byte(uint8_t v) {
    if (block_len == 0) {  // open a sub-block
      if (n >= cap) { overflow = true; return; }
      block_at = n++;
    }
    if (n >= cap) { overflow = true; return; }
    out[n++] = v;
    if (++block_len == 255) {
      out[block_at] = 255;
      block_len = 0;
    }
  }
  void code(uint32_t c, int width) {
    buffer |= c << bits;
    bits += width;
    while (bits >= 8) {
      byte((uint8_t)buffer);
      buffer >>= 8;
      bits -= 8;
    }
  }
  void finish() {
    if (bits > 0) byte((uint8_t)buffer);
    if (block_len) out[block_at] = (uint8_t)block_len;
  }
};

}  // namespace

extern "C" {

// `file` (n bytes), the frame's data from `offset` (the first sub-block's
// length byte) with LZW minimum code size `bits` -> indices of an
// xsize x ysize frame in `out`
int ape_gif_lzw(const uint8_t* file, size_t n, size_t offset, int bits, int interlace, int xsize,
                int ysize, uint8_t* out) {
  if (bits < 0 || bits > 12) return 3;
  if (xsize <= 0 || ysize <= 0) return 0;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> data(kTable), stack(kTable);
  std::vector<int> link(kTable);
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2, lastcode = 0, lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  size_t pos = offset, avail = offset + kPilBlock;
  // rows: interlace passes start at 0, 4, 2, 1 with steps 8, 8, 4, 2
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  auto newline = [&]() -> bool {  // false once the frame is full
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= (uint32_t)file[pos++] << bitcount;
        bitcount += 8;
        --blocksize;
      } else {  // the next sub-block, once PIL has fed all of it
        for (;;) {
          if (pos < std::min(avail, n) && pos + 1 + file[pos] <= std::min(avail, n)) break;
          if (avail >= n) return 2;
          avail += kPilBlock;
        }
        blocksize = file[pos++];
      }
    }
    int c = (int)(bitbuffer & (uint32_t)codemask);
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) {  // the decoder returns and waits for more of the file
      if (avail >= n) return 2;
      avail += kPilBlock;
      continue;
    }
    int count = 1;
    const uint8_t* p;
    uint8_t single;
    if (state == 2) {
      if (c > clear) return 1;
      lastdata = lastcode = c;
      state = 3;
      single = (uint8_t)c;
      p = &single;
    } else {
      const int thiscode = c;
      if (c > next) return 1;
      int top = kTable;
      if (c == next) {
        stack[--top] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (top <= 0 || c >= kTable) return 1;
        stack[--top] = data[c];
        c = link[c];
      }
      lastdata = c;
      if (next < kTable) {
        data[next] = (uint8_t)c;
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      // the string is its first symbol, then the stack
      if (top == 0) return 1;
      stack[--top] = (uint8_t)c;
      p = &stack[top];
      count = kTable - top;
    }
    for (int i = 0; i < count; ++i) {
      out[(size_t)y * xsize + x] = p[i];
      if (++x >= xsize && !newline()) return 0;
    }
  }
}

// `n` RGB pixels -> `palette` (up to 256 x 3) and each pixel's index in
// `indices`; returns the number of entries
int ape_gif_quantize(const uint8_t* rgb, size_t n, uint8_t* palette, uint8_t* indices) {
  if (n == 0) return 0;
  std::vector<uint32_t> codes(n);
  for (size_t i = 0; i < n; ++i)
    codes[i] = ((uint32_t)rgb[3 * i] << 16) | ((uint32_t)rgb[3 * i + 1] << 8) | rgb[3 * i + 2];
  std::vector<uint32_t> uniq(codes);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  // the scale: the least shift that leaves at most kMaxHashEntries keys
  int scale = 0;
  std::vector<uint32_t> keys;
  for (;; ++scale) {
    const uint32_t m = 0xffu >> scale;
    keys.resize(uniq.size());
    for (size_t i = 0; i < uniq.size(); ++i) {
      const uint32_t c = uniq[i];
      keys[i] = ((((c >> 16) >> scale) & m) << 16) | ((((c >> 8) & 255) >> scale) << 8) |
                ((c & 255) >> scale);
    }
    std::vector<uint32_t> k(keys);
    std::sort(k.begin(), k.end());
    if ((size_t)(std::unique(k.begin(), k.end()) - k.begin()) <= kMaxHashEntries) break;
  }
  // the scaled colour table and each pixel's entry in it
  std::vector<uint32_t> scaled_keys(keys);
  std::sort(scaled_keys.begin(), scaled_keys.end());
  scaled_keys.erase(std::unique(scaled_keys.begin(), scaled_keys.end()), scaled_keys.end());
  std::vector<Scaled> table(scaled_keys.size());
  for (size_t i = 0; i < table.size(); ++i) {
    table[i].c[0] = (uint8_t)(scaled_keys[i] >> 16);
    table[i].c[1] = (uint8_t)(scaled_keys[i] >> 8);
    table[i].c[2] = (uint8_t)scaled_keys[i];
    table[i].count = 0;
  }
  std::vector<uint32_t> entry_of_pixel(n);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t c = codes[i];
    const uint32_t key = (((c >> 16) >> scale) << 16) | ((((c >> 8) & 255) >> scale) << 8) |
                         ((c & 255) >> scale);
    const uint32_t e = (uint32_t)(std::lower_bound(scaled_keys.begin(), scaled_keys.end(), key) -
                                  scaled_keys.begin());
    entry_of_pixel[i] = e;
    ++table[e].count;
  }
  // median_cut
  std::vector<Box> boxes(1);
  boxes.reserve(512);
  boxes[0].colours.resize(table.size());
  for (size_t i = 0; i < table.size(); ++i) boxes[0].colours[i] = (uint32_t)i;
  boxes[0].count = (uint32_t)n;
  BoxHeap heap;
  heap.boxes = &boxes;
  heap.add(0);
  for (int left = 256; --left;) {
    int node;
    bool found = false;
    while (heap.remove(&node)) {
      if (box_volume(boxes[node], table) != 1) {
        found = true;
        break;
      }
    }
    if (!found) break;
    split_box(boxes, node, table);
    heap.add(boxes[node].left);
    heap.add(boxes[node].right);
  }
  std::vector<int> box_of(table.size(), -1);
  int entries = 0;
  number_leaves(boxes, 0, box_of, &entries);
  // the palette: each box's mean of the unscaled pixels
  std::vector<uint64_t> sum(3 * entries, 0);
  std::vector<uint32_t> count(entries, 0);
  for (size_t i = 0; i < n; ++i) {
    const int b = box_of[entry_of_pixel[i]];
    for (int a = 0; a < 3; ++a) sum[3 * b + a] += rgb[3 * i + a];
    ++count[b];
  }
  for (int b = 0; b < entries; ++b)
    for (int a = 0; a < 3; ++a)
      palette[3 * b + a] = (uint8_t)(int)(.5 + (double)sum[3 * b + a] / (double)count[b]);
  // build_distance_tables: each entry's others by distance, then index
  std::vector<uint32_t> dist((size_t)entries * entries);
  std::vector<std::vector<int>> order(entries);
  for (int i = 0; i < entries; ++i)
    for (int j = 0; j < entries; ++j)
      dist[(size_t)i * entries + j] = dist2(palette + 3 * i, palette + 3 * j);
  for (int i = 0; i < entries; ++i) {
    order[i].resize(entries);
    for (int j = 0; j < entries; ++j) order[i][j] = j;
    const uint32_t* d = &dist[(size_t)i * entries];
    std::sort(order[i].begin(), order[i].end(), [&](int a, int b) {
      return d[a] != d[b] ? d[a] < d[b] : a < b;
    });
  }
  // map_image_pixels_from_median_box, once a colour
  std::vector<int> best_of(uniq.size(), -1);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t c = codes[i];
    const size_t u = (size_t)(std::lower_bound(uniq.begin(), uniq.end(), c) - uniq.begin());
    if (best_of[u] < 0) {
      const int b = box_of[entry_of_pixel[i]];
      const uint8_t* px = rgb + 3 * i;
      uint32_t bestdist = dist2(palette + 3 * b, px);
      const uint32_t limit = bestdist << 2;
      int best = b;
      const uint32_t* d = &dist[(size_t)b * entries];
      for (int j : order[b]) {
        if (d[j] > limit) break;
        const uint32_t dj = dist2(palette + 3 * j, px);
        if (dj < bestdist) {
          bestdist = dj;
          best = j;
        }
      }
      best_of[u] = best;
    }
    indices[i] = (uint8_t)best_of[u];
  }
  return entries;
}

// `indices` (height rows of `width`) -> the LZW image data of minimum code
// size `bits` in sub-blocks, into `out` (cap bytes)
long ape_gif_lzw_encode(const uint8_t* indices, int width, int height, int interlace, int bits,
                        uint8_t* out, size_t cap) {
  if (bits < 2 || bits > 8) return -1;
  LzwWriter w{out, cap};
  const uint32_t clear = 1u << bits, end = clear + 1;
  constexpr int kHash = 8192;
  std::vector<uint32_t> key(kHash), val(kHash);
  uint32_t next = 0, max_code = 0;
  int width_bits = 0;
  auto reset = [&]() {
    next = end + 1;
    max_code = 2 * clear - 1;
    width_bits = bits + 1;
    std::fill(key.begin(), key.end(), 0u);
  };
  reset();
  w.code(clear, width_bits);
  std::vector<int> rows;
  if (interlace) {
    const int starts[4] = {0, 4, 2, 1}, steps[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; ++p)
      for (int y = starts[p]; y < height; y += steps[p]) rows.push_back(y);
  } else {
    for (int y = 0; y < height; ++y) rows.push_back(y);
  }
  const size_t total = (size_t)width * height;
  size_t pos = 0;
  auto pixel = [&](size_t k) { return indices[(size_t)rows[k / width] * width + k % width]; };
  if (total) {
    uint32_t head = pixel(pos++);
    while (pos < total) {
      const uint32_t tail = pixel(pos++);
      const uint32_t k = (head << 8) | tail | 0x80000000u;
      uint32_t h = ((head ^ (tail << 6)) * 31) & (kHash - 1);
      bool hit = false;
      while (key[h]) {
        if (key[h] == k) {
          hit = true;
          break;
        }
        h = (h + kHash - ((tail << 2) | 1)) & (kHash - 1);
      }
      if (hit) {
        head = val[h];
        continue;
      }
      w.code(head, width_bits);
      if (next < (uint32_t)kTable) {
        key[h] = k;
        val[h] = next;
        if (next > max_code) {
          max_code = max_code * 2 + 1;
          ++width_bits;
        }
        ++next;
      } else {
        w.code(clear, width_bits);
        reset();
      }
      head = tail;
    }
    w.code(head, width_bits);
  }
  w.code(end, width_bits);
  w.finish();
  return w.overflow ? -1 : (long)w.n;
}

}  // extern "C"
