// Adaptive binary arithmetic coder + coefficient/occupancy syntax.
//
// Native entropy backend for the video codecs (video/intra.py, video/hevc.py).
// Plays the role HM's CABAC plays for the reference's video substreams
// (reference: dependencies/hm-modification/... TEncBinCABAC) — the device does
// transform/quant/prediction; the bit-serial arithmetic coding finalizes
// here on the host.
//
// Engine: LZMA-style carry-counting range coder, 11-bit adaptive
// probabilities with shift-5 update. Coefficient syntax per 8x8 block
// (zigzag order, DC already DPCM'd): cbf flag; per-position significance
// (banded contexts); sign (bypass); greater-1 flag; remaining level as
// order-0 Exp-Golomb in bypass bins.
//
// Build: g++ -O3 -shared -fPIC entropy.cpp -o libvpccentropy.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint16_t kHalf = 1024;  // 11-bit probability space

struct Encoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;
  std::vector<uint8_t> out;

  void shift_low() {
    if ((uint32_t)(low >> 32) != 0 || (uint32_t)low < 0xFF000000u) {
      uint8_t carry = (uint8_t)(low >> 32);
      do {
        out.push_back((uint8_t)(cache + carry));
        cache = 0xFF;
      } while (--cache_size);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  void bit(int b, uint16_t* p) {
    uint32_t bound = (range >> 11) * (*p);
    if (!b) {
      range = bound;
      *p += (2048 - *p) >> 5;
    } else {
      low += bound;
      range -= bound;
      *p -= *p >> 5;
    }
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  void bypass(int b) {
    range >>= 1;
    if (b) low += range;
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  // order-0 Exp-Golomb of v >= 0 in bypass bins
  void eg0(uint32_t v) {
    uint32_t x = v + 1;
    int n = 0;
    while ((x >> n) > 1) n++;
    for (int i = 0; i < n; i++) bypass(1);
    bypass(0);
    for (int i = n - 1; i >= 0; i--) bypass((x >> i) & 1);
  }

  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

struct Decoder {
  const uint8_t* in;
  size_t size;
  size_t pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  void init(const uint8_t* data, size_t n) {
    in = data;
    size = n;
    pos = 1;  // first byte emitted by the encoder is always 0
    code = 0;
    for (int i = 0; i < 4; i++) code = (code << 8) | next();
  }

  uint8_t next() { return pos < size ? in[pos++] : 0; }

  int bit(uint16_t* p) {
    uint32_t bound = (range >> 11) * (*p);
    int b;
    if (code < bound) {
      range = bound;
      *p += (2048 - *p) >> 5;
      b = 0;
    } else {
      code -= bound;
      range -= bound;
      *p -= *p >> 5;
      b = 1;
    }
    while (range < kTop) {
      range <<= 8;
      code = (code << 8) | next();
    }
    return b;
  }

  int bypass() {
    range >>= 1;
    int b = 0;
    if (code >= range) {
      code -= range;
      b = 1;
    }
    while (range < kTop) {
      range <<= 8;
      code = (code << 8) | next();
    }
    return b;
  }

  uint32_t eg0() {
    int n = 0;
    while (bypass()) n++;
    uint32_t x = 1;
    for (int i = 0; i < n; i++) x = (x << 1) | bypass();
    return x - 1;
  }
};

// significance-context band per zigzag position
inline int band(int i) {
  if (i == 0) return 0;
  if (i < 4) return i;  // 1..3
  if (i < 8) return 4;
  if (i < 16) return 5;
  if (i < 24) return 6;
  if (i < 36) return 7;
  if (i < 50) return 8;
  return 9;
}

struct CoeffContexts {
  uint16_t cbf = kHalf;
  uint16_t sig[10];
  uint16_t gt1[10];
  CoeffContexts() {
    for (int i = 0; i < 10; i++) sig[i] = gt1[i] = kHalf;
  }
};

}  // namespace

extern "C" {

// coeffs: nblocks x 64 int32 (zigzag). Returns byte count written to out
// (capacity must be generous; returns -1 on overflow).
int64_t vpcc_encode_coeffs(const int32_t* coeffs, int64_t nblocks,
                           uint8_t* out, int64_t capacity) {
  Encoder enc;
  enc.out.reserve((size_t)nblocks * 8);
  CoeffContexts ctx;
  for (int64_t b = 0; b < nblocks; b++) {
    const int32_t* c = coeffs + b * 64;
    int any = 0;
    for (int i = 0; i < 64; i++) any |= (c[i] != 0);
    enc.bit(any, &ctx.cbf);
    if (!any) continue;
    for (int i = 0; i < 64; i++) {
      int32_t v = c[i];
      int bd = band(i);
      enc.bit(v != 0, &ctx.sig[bd]);
      if (v != 0) {
        uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v);
        enc.bypass(v < 0);
        enc.bit(mag > 1, &ctx.gt1[bd]);
        if (mag > 1) enc.eg0(mag - 2);
      }
    }
  }
  enc.flush();
  if ((int64_t)enc.out.size() > capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t vpcc_decode_coeffs(const uint8_t* data, int64_t size, int32_t* coeffs,
                           int64_t nblocks) {
  Decoder dec;
  dec.init(data, (size_t)size);
  CoeffContexts ctx;
  std::memset(coeffs, 0, (size_t)nblocks * 64 * sizeof(int32_t));
  for (int64_t b = 0; b < nblocks; b++) {
    int32_t* c = coeffs + b * 64;
    if (!dec.bit(&ctx.cbf)) continue;
    for (int i = 0; i < 64; i++) {
      int bd = band(i);
      if (dec.bit(&ctx.sig[bd])) {
        int neg = dec.bypass();
        uint32_t mag = 1;
        if (dec.bit(&ctx.gt1[bd])) mag = 2 + dec.eg0();
        c[i] = neg ? -(int32_t)mag : (int32_t)mag;
      }
    }
  }
  return 0;
}

// Binary plane (occupancy video): context from decoded left/top/topleft.
int64_t vpcc_encode_binary_plane(const uint8_t* plane, int64_t h, int64_t w,
                                 uint8_t* out, int64_t capacity) {
  Encoder enc;
  uint16_t ctx[8];
  for (int i = 0; i < 8; i++) ctx[i] = kHalf;
  for (int64_t y = 0; y < h; y++) {
    for (int64_t x = 0; x < w; x++) {
      int left = x > 0 ? plane[y * w + x - 1] : 0;
      int top = y > 0 ? plane[(y - 1) * w + x] : 0;
      int tl = (x > 0 && y > 0) ? plane[(y - 1) * w + x - 1] : 0;
      int k = left | (top << 1) | (tl << 2);
      enc.bit(plane[y * w + x] != 0, &ctx[k]);
    }
  }
  enc.flush();
  if ((int64_t)enc.out.size() > capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t vpcc_decode_binary_plane(const uint8_t* data, int64_t size,
                                 uint8_t* plane, int64_t h, int64_t w) {
  Decoder dec;
  dec.init(data, (size_t)size);
  uint16_t ctx[8];
  for (int i = 0; i < 8; i++) ctx[i] = kHalf;
  for (int64_t y = 0; y < h; y++) {
    for (int64_t x = 0; x < w; x++) {
      int left = x > 0 ? plane[y * w + x - 1] : 0;
      int top = y > 0 ? plane[(y - 1) * w + x] : 0;
      int tl = (x > 0 && y > 0) ? plane[(y - 1) * w + x - 1] : 0;
      int k = left | (top << 1) | (tl << 2);
      plane[y * w + x] = (uint8_t)dec.bit(&ctx[k]);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// HEVC-class CU syntax (vpcc_tpu/video/hevc.py): per 16x16 CU a split flag
// (neighbor context), then either one 16x16 block or four 8x8 blocks in
// z-order.  Each block: intra/inter mode (0..35, MPM-coded from the left/up
// 8-pixel cells) + quantized coefficients in zigzag order (cbf flag w/
// neighbor context, context-coded last-significant position, banded
// significance, greater1/greater2 flags, Exp-Golomb remainder, bypass
// sign).  Mirrors the role of HM's CABAC for our wavefront codec.

namespace {

inline int band16(int i) { return band(i >> 2); }
inline int band32(int i) { return band(i >> 4); }

struct HevcContexts {
  uint16_t split[3];
  uint16_t split32c[3];
  uint16_t mpm0 = kHalf, mpm1 = kHalf, esc = kHalf;
  uint16_t cbf8[3], cbf16[3], cbf32[3];
  uint16_t last8[6], last16[8], last32[10];
  uint16_t sig8[10], sig16[10], sig32[10];
  uint16_t gt1[2], gt2[2];
  HevcContexts() {
    for (int i = 0; i < 3; i++)
      split[i] = split32c[i] = cbf8[i] = cbf16[i] = cbf32[i] = kHalf;
    for (int i = 0; i < 6; i++) last8[i] = kHalf;
    for (int i = 0; i < 8; i++) last16[i] = kHalf;
    for (int i = 0; i < 10; i++) last32[i] = kHalf;
    for (int i = 0; i < 10; i++) sig8[i] = sig16[i] = sig32[i] = kHalf;
    for (int i = 0; i < 2; i++) gt1[i] = gt2[i] = kHalf;
  }
};

// per-8x8-cell state for mode MPM and cbf contexts
struct CellGrid {
  std::vector<int32_t> mode;
  std::vector<uint8_t> cbf;
  int64_t w;
  CellGrid(int64_t h, int64_t w_) : mode((size_t)(h * w_), 0),
                                    cbf((size_t)(h * w_), 0), w(w_) {}
  void mpm(int64_t cy, int64_t cx, int& m0, int& m1) const {
    m0 = cx > 0 ? mode[(size_t)(cy * w + cx - 1)] : 0;
    m1 = cy > 0 ? mode[(size_t)((cy - 1) * w + cx)] : 1;
    if (m1 == m0) m1 = (m0 == 0) ? 1 : 0;
  }
  int cbf_ctx(int64_t cy, int64_t cx) const {
    int l = cx > 0 ? cbf[(size_t)(cy * w + cx - 1)] : 0;
    int u = cy > 0 ? cbf[(size_t)((cy - 1) * w + cx)] : 0;
    return l + u;
  }
};

struct BlockCoder {
  HevcContexts& ctx;
  CellGrid& grid;
  BlockCoder(HevcContexts& c, CellGrid& g) : ctx(c), grid(g) {}

  void encode_mode(Encoder& enc, int64_t cy, int64_t cx, int mode) {
    int m0, m1;
    grid.mpm(cy, cx, m0, m1);
    enc.bit(mode == m0, &ctx.mpm0);
    if (mode != m0) {
      enc.bit(mode == m1, &ctx.mpm1);
      if (mode != m1) {
        int r = mode - (mode > m0) - (mode > m1);
        if (r < 32) {
          enc.bit(0, &ctx.esc);
          for (int k = 4; k >= 0; k--) enc.bypass((r >> k) & 1);
        } else {
          enc.bit(1, &ctx.esc);
          enc.bypass(r - 32);
        }
      }
    }
  }

  int decode_mode(Decoder& dec, int64_t cy, int64_t cx) {
    int m0, m1;
    grid.mpm(cy, cx, m0, m1);
    if (dec.bit(&ctx.mpm0)) return m0;
    if (dec.bit(&ctx.mpm1)) return m1;
    int r;
    if (!dec.bit(&ctx.esc)) {
      r = 0;
      for (int k = 0; k < 5; k++) r = (r << 1) | dec.bypass();
    } else {
      r = 32 + dec.bypass();
    }
    const int lo = m0 < m1 ? m0 : m1;
    const int hi = m0 < m1 ? m1 : m0;
    int mode = r;
    if (mode >= lo) mode++;
    if (mode >= hi) mode++;
    return mode;
  }

  // n in {8, 16, 32} selects the coeff syntax; fills the covered 8-px cells
  void params(int n, int& ncoef, int& nlast, int& span, uint16_t*& lastc,
              uint16_t*& sigc, uint16_t*& cbfc) {
    if (n == 32) {
      ncoef = 1024; nlast = 10; span = 4;
      lastc = ctx.last32; sigc = ctx.sig32; cbfc = ctx.cbf32;
    } else if (n == 16) {
      ncoef = 256; nlast = 8; span = 2;
      lastc = ctx.last16; sigc = ctx.sig16; cbfc = ctx.cbf16;
    } else {
      ncoef = 64; nlast = 6; span = 1;
      lastc = ctx.last8; sigc = ctx.sig8; cbfc = ctx.cbf8;
    }
  }
  static int sig_band(int n, int i) {
    return n == 32 ? band32(i) : (n == 16 ? band16(i) : band(i));
  }

  void encode_block(Encoder& enc, int64_t cy, int64_t cx, int mode,
                    const int32_t* c, int n) {
    encode_mode(enc, cy, cx, mode);
    int ncoef, nlast, span;
    uint16_t *lastc, *sigc, *cbfc;
    params(n, ncoef, nlast, span, lastc, sigc, cbfc);
    int last = -1;
    for (int i = 0; i < ncoef; i++)
      if (c[i] != 0) last = i;
    enc.bit(last >= 0, &cbfc[grid.cbf_ctx(cy, cx)]);
    for (int dy = 0; dy < span; dy++)
      for (int dx = 0; dx < span; dx++) {
        grid.mode[(size_t)((cy + dy) * grid.w + cx + dx)] = mode;
        grid.cbf[(size_t)((cy + dy) * grid.w + cx + dx)] = (uint8_t)(last >= 0);
      }
    if (last < 0) return;
    for (int k = nlast - 1; k >= 0; k--) enc.bit((last >> k) & 1, &lastc[k]);
    int nsig = 0;
    for (int i = 0; i <= last; i++) {
      int s = (c[i] != 0);
      if (i < last) enc.bit(s, &sigc[sig_band(n, i)]);
      if (!s) continue;
      uint32_t mag = (uint32_t)(c[i] < 0 ? -(int64_t)c[i] : c[i]);
      const int gctx = (nsig == 0) ? 0 : 1;
      nsig++;
      enc.bit(mag > 1, &ctx.gt1[gctx]);
      if (mag > 1) {
        enc.bit(mag > 2, &ctx.gt2[gctx]);
        if (mag > 2) enc.eg0(mag - 3);
      }
      enc.bypass(c[i] < 0);
    }
  }

  int decode_block(Decoder& dec, int64_t cy, int64_t cx, int32_t* c, int n) {
    const int mode = decode_mode(dec, cy, cx);
    int ncoef, nlast, span;
    uint16_t *lastc, *sigc, *cbfc;
    params(n, ncoef, nlast, span, lastc, sigc, cbfc);
    const int has = dec.bit(&cbfc[grid.cbf_ctx(cy, cx)]);
    for (int dy = 0; dy < span; dy++)
      for (int dx = 0; dx < span; dx++) {
        grid.mode[(size_t)((cy + dy) * grid.w + cx + dx)] = mode;
        grid.cbf[(size_t)((cy + dy) * grid.w + cx + dx)] = (uint8_t)has;
      }
    std::memset(c, 0, (size_t)ncoef * sizeof(int32_t));
    if (!has) return mode;
    int last = 0;
    for (int k = nlast - 1; k >= 0; k--) last |= dec.bit(&lastc[k]) << k;
    int nsig = 0;
    for (int i = 0; i <= last; i++) {
      int s = (i == last) ? 1 : dec.bit(&sigc[sig_band(n, i)]);
      if (!s) continue;
      const int gctx = (nsig == 0) ? 0 : 1;
      nsig++;
      uint32_t mag = 1;
      if (dec.bit(&ctx.gt1[gctx])) {
        mag = 2;
        if (dec.bit(&ctx.gt2[gctx])) mag = 3 + dec.eg0();
      }
      c[i] = dec.bypass() ? -(int32_t)mag : (int32_t)mag;
    }
    return mode;
  }
};

constexpr int kZOrder[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};

}  // namespace

int64_t vpcc_hevc_encode(const int32_t* split, const int32_t* m16,
                         const int32_t* c16, const int32_t* m8,
                         const int32_t* c8, int64_t nby, int64_t nbx,
                         uint8_t* out, int64_t capacity) {
  Encoder enc;
  const int64_t nb = nby * nbx;
  enc.out.reserve((size_t)nb * 8);
  HevcContexts ctx;
  CellGrid grid(2 * nby, 2 * nbx);
  std::vector<uint8_t> split_grid((size_t)nb, 0);
  BlockCoder bc(ctx, grid);
  for (int64_t by = 0; by < nby; by++) {
    for (int64_t bx = 0; bx < nbx; bx++) {
      const int64_t bi = by * nbx + bx;
      const int spl = split[bi] != 0;
      const int sl = bx > 0 ? split_grid[bi - 1] : 0;
      const int su = by > 0 ? split_grid[bi - nbx] : 0;
      enc.bit(spl, &ctx.split[sl + su]);
      split_grid[bi] = (uint8_t)spl;
      if (!spl) {
        bc.encode_block(enc, 2 * by, 2 * bx, (int)m16[bi], c16 + bi * 256,
                        16);
      } else {
        for (int s = 0; s < 4; s++) {
          const int64_t cy = 2 * by + kZOrder[s][0];
          const int64_t cx = 2 * bx + kZOrder[s][1];
          bc.encode_block(enc, cy, cx, (int)m8[bi * 4 + s],
                          c8 + (bi * 4 + s) * 64, 8);
        }
      }
    }
  }
  enc.flush();
  if ((int64_t)enc.out.size() > capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

// Motion vectors: one (dy, dx) pair per CU whose decoded mode set uses the
// inter lane.  Components are coded as deltas from the previous inter CU's
// MV (raster order): significance bit (adaptive, per component), bypass
// sign, Exp-Golomb magnitude-1.  Mirrors HM's MVD coding role for the
// wavefront codec's per-CU motion field.
int64_t vpcc_mv_encode(const int32_t* inter, const int32_t* mv, int64_t nb,
                       uint8_t* out, int64_t capacity) {
  Encoder enc;
  uint16_t sig[2] = {kHalf, kHalf};
  int32_t pred[2] = {0, 0};
  for (int64_t i = 0; i < nb; i++) {
    if (!inter[i]) continue;
    for (int c = 0; c < 2; c++) {
      int32_t d = mv[i * 2 + c] - pred[c];
      enc.bit(d != 0, &sig[c]);
      if (d != 0) {
        enc.bypass(d < 0);
        enc.eg0((uint32_t)(d < 0 ? -d : d) - 1);
      }
      pred[c] = mv[i * 2 + c];
    }
  }
  enc.flush();
  if ((int64_t)enc.out.size() > capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t vpcc_mv_decode(const uint8_t* data, int64_t size, const int32_t* inter,
                       int32_t* mv, int64_t nb) {
  Decoder dec;
  dec.init(data, (size_t)size);
  uint16_t sig[2] = {kHalf, kHalf};
  int32_t pred[2] = {0, 0};
  std::memset(mv, 0, (size_t)nb * 2 * sizeof(int32_t));
  for (int64_t i = 0; i < nb; i++) {
    if (!inter[i]) continue;
    for (int c = 0; c < 2; c++) {
      int32_t d = 0;
      if (dec.bit(&sig[c])) {
        int neg = dec.bypass();
        d = (int32_t)(dec.eg0() + 1);
        if (neg) d = -d;
      }
      mv[i * 2 + c] = pred[c] + d;
      pred[c] = mv[i * 2 + c];
    }
  }
  return 0;
}

// Three-level CU syntax (32/16/8): per 32x32 CU a split32 flag; unsplit CUs
// carry one 1024-coeff block; split CUs carry four 16x16 quadrants in
// z-order, each with the two-level syntax above.  Array layout (per 32-CU):
// split32 (nb32,), m32 (nb32,), c32 (nb32,1024), split16 (nb32,4),
// m16 (nb32,4), c16 (nb32,4,256), m8 (nb32,4,4), c8 (nb32,4,4,64).
int64_t vpcc_hevc32_encode(const int32_t* split32, const int32_t* m32,
                           const int32_t* c32, const int32_t* split16,
                           const int32_t* m16, const int32_t* c16,
                           const int32_t* m8, const int32_t* c8,
                           int64_t nby, int64_t nbx, uint8_t* out,
                           int64_t capacity) {
  Encoder enc;
  const int64_t nb = nby * nbx;
  enc.out.reserve((size_t)nb * 16);
  HevcContexts ctx;
  CellGrid grid(4 * nby, 4 * nbx);
  std::vector<uint8_t> s32_grid((size_t)nb, 0);
  std::vector<uint8_t> s16_grid((size_t)nb * 4, 0);
  BlockCoder bc(ctx, grid);
  for (int64_t by = 0; by < nby; by++) {
    for (int64_t bx = 0; bx < nbx; bx++) {
      const int64_t bi = by * nbx + bx;
      const int spl32 = split32[bi] != 0;
      const int sl = bx > 0 ? s32_grid[bi - 1] : 0;
      const int su = by > 0 ? s32_grid[bi - nbx] : 0;
      enc.bit(spl32, &ctx.split32c[sl + su]);
      s32_grid[bi] = (uint8_t)spl32;
      if (!spl32) {
        bc.encode_block(enc, 4 * by, 4 * bx, (int)m32[bi], c32 + bi * 1024, 32);
        continue;
      }
      for (int q = 0; q < 4; q++) {
        const int64_t cy = 4 * by + 2 * kZOrder[q][0];
        const int64_t cx = 4 * bx + 2 * kZOrder[q][1];
        const int64_t qi = bi * 4 + q;
        const int spl16 = split16[qi] != 0;
        enc.bit(spl16, &ctx.split[0]);  // flat context inside a split 32-CU
        s16_grid[qi] = (uint8_t)spl16;
        if (!spl16) {
          bc.encode_block(enc, cy, cx, (int)m16[qi], c16 + qi * 256, 16);
        } else {
          for (int s = 0; s < 4; s++) {
            const int64_t y8 = cy + kZOrder[s][0];
            const int64_t x8 = cx + kZOrder[s][1];
            bc.encode_block(enc, y8, x8, (int)m8[qi * 4 + s],
                            c8 + (qi * 4 + s) * 64, 8);
          }
        }
      }
    }
  }
  enc.flush();
  if ((int64_t)enc.out.size() > capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t vpcc_hevc32_decode(const uint8_t* data, int64_t size, int32_t* split32,
                           int32_t* m32, int32_t* c32, int32_t* split16,
                           int32_t* m16, int32_t* c16, int32_t* m8,
                           int32_t* c8, int64_t nby, int64_t nbx) {
  Decoder dec;
  dec.init(data, (size_t)size);
  const int64_t nb = nby * nbx;
  HevcContexts ctx;
  CellGrid grid(4 * nby, 4 * nbx);
  std::vector<uint8_t> s32_grid((size_t)nb, 0);
  BlockCoder bc(ctx, grid);
  std::memset(split32, 0, (size_t)nb * sizeof(int32_t));
  std::memset(m32, 0, (size_t)nb * sizeof(int32_t));
  std::memset(c32, 0, (size_t)nb * 1024 * sizeof(int32_t));
  std::memset(split16, 0, (size_t)nb * 4 * sizeof(int32_t));
  std::memset(m16, 0, (size_t)nb * 4 * sizeof(int32_t));
  std::memset(c16, 0, (size_t)nb * 4 * 256 * sizeof(int32_t));
  std::memset(m8, 0, (size_t)nb * 16 * sizeof(int32_t));
  std::memset(c8, 0, (size_t)nb * 16 * 64 * sizeof(int32_t));
  for (int64_t by = 0; by < nby; by++) {
    for (int64_t bx = 0; bx < nbx; bx++) {
      const int64_t bi = by * nbx + bx;
      const int sl = bx > 0 ? s32_grid[bi - 1] : 0;
      const int su = by > 0 ? s32_grid[bi - nbx] : 0;
      const int spl32 = dec.bit(&ctx.split32c[sl + su]);
      s32_grid[bi] = (uint8_t)spl32;
      split32[bi] = spl32;
      if (!spl32) {
        m32[bi] = bc.decode_block(dec, 4 * by, 4 * bx, c32 + bi * 1024, 32);
        continue;
      }
      for (int q = 0; q < 4; q++) {
        const int64_t cy = 4 * by + 2 * kZOrder[q][0];
        const int64_t cx = 4 * bx + 2 * kZOrder[q][1];
        const int64_t qi = bi * 4 + q;
        const int spl16 = dec.bit(&ctx.split[0]);
        split16[qi] = spl16;
        if (!spl16) {
          m16[qi] = bc.decode_block(dec, cy, cx, c16 + qi * 256, 16);
        } else {
          for (int s = 0; s < 4; s++) {
            const int64_t y8 = cy + kZOrder[s][0];
            const int64_t x8 = cx + kZOrder[s][1];
            m8[qi * 4 + s] =
                bc.decode_block(dec, y8, x8, c8 + (qi * 4 + s) * 64, 8);
          }
        }
      }
    }
  }
  return 0;
}

int64_t vpcc_hevc_decode(const uint8_t* data, int64_t size, int32_t* split,
                         int32_t* m16, int32_t* c16, int32_t* m8, int32_t* c8,
                         int64_t nby, int64_t nbx) {
  Decoder dec;
  dec.init(data, (size_t)size);
  const int64_t nb = nby * nbx;
  HevcContexts ctx;
  CellGrid grid(2 * nby, 2 * nbx);
  std::vector<uint8_t> split_grid((size_t)nb, 0);
  BlockCoder bc(ctx, grid);
  std::memset(m16, 0, (size_t)nb * sizeof(int32_t));
  std::memset(c16, 0, (size_t)nb * 256 * sizeof(int32_t));
  std::memset(m8, 0, (size_t)nb * 4 * sizeof(int32_t));
  std::memset(c8, 0, (size_t)nb * 4 * 64 * sizeof(int32_t));
  for (int64_t by = 0; by < nby; by++) {
    for (int64_t bx = 0; bx < nbx; bx++) {
      const int64_t bi = by * nbx + bx;
      const int sl = bx > 0 ? split_grid[bi - 1] : 0;
      const int su = by > 0 ? split_grid[bi - nbx] : 0;
      const int spl = dec.bit(&ctx.split[sl + su]);
      split_grid[bi] = (uint8_t)spl;
      split[bi] = spl;
      if (!spl) {
        m16[bi] = bc.decode_block(dec, 2 * by, 2 * bx, c16 + bi * 256, 16);
      } else {
        for (int s = 0; s < 4; s++) {
          const int64_t cy = 2 * by + kZOrder[s][0];
          const int64_t cx = 2 * bx + kZOrder[s][1];
          m8[bi * 4 + s] =
              bc.decode_block(dec, cy, cx, c8 + (bi * 4 + s) * 64, 8);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
