// WebP decoding for the host CPU, in plain C++17 (no library): the port's
// counterpart of PIL 12.1's WebP plugin over libwebp 1.6, which decodes every
// file through WebPAnimDecoder into RGBA. The rule is the one JAX's reader
// follows through PIL: a file PIL decodes is decoded bit for bit (the first
// frame on its canvas); a file PIL refuses gets the "corrupt" status.
//
//   * the container as WebPDemux takes it (RFC 9649; the image chunk read
//     with its pad byte, as WebPAnimDecoder hands the frame to WebPDecode):
//     a simple file (one
//     'VP8 ' or 'VP8L' chunk) or an extended one (VP8X, then an image with an
//     optional ALPH chunk, or ANIM and ANMF frames); a file shorter than its
//     RIFF size, an unknown VP8X flag, a still image whose size is not the
//     canvas's or a frame outside the canvas are refused, as WebPDemux
//     refuses them;
//   * VP8L (lossless, RFC 9649 section 3): simple and normal prefix codes,
//     the color cache, meta prefix codes, the 120-entry distance map, and the
//     predictor (modes 0-13; 14 and 15 as 0, as libwebp pads them), color,
//     subtract-green and color-indexing (with pixel bundling) transforms;
//     reading past the end of the data is an error, as in vp8l_dec.c;
//   * VP8 key frames (RFC 6386), as libwebp's dec/ decodes them: the
//     boolean decoder, segments, token partitions, coefficient probability
//     updates, 16x16, 4x4 and chroma intra prediction with libwebp's edge
//     samples (127 above, 129 left), the dequantization (y2 AC x 155 / 100,
//     at least 8), the inverse WHT and DCT, and the simple and normal loop
//     filters with sharpness and the delta adjustments, filtered after the
//     whole frame is reconstructed (prediction reads unfiltered samples);
//     partition data running out before the frame is decoded is an error;
//   * ALPH: raw or VP8L-coded alpha, its horizontal, vertical and gradient
//     filters (dsp/filters.c's unfilters); the level-reduction flag is only
//     read (libwebp dequantizes alpha only when asked to dither);
//   * output as libwebp's MODE_RGBA: fancy upsampling of the chroma
//     (dsp/upsampling.c) and the 14-bit YUV -> RGB of dsp/yuv.h, no
//     dithering; alpha 255 where the frame has none;
//   * an animated file's first frame decoded into a zeroed canvas at its
//     offset, as anim_decode.c composes a key frame.
//
// C interface (ctypes): ape_webp_decode returns 0 or 1 (a file PIL refuses)
// and writes a message into `err`; its RGBA output buffer is released with
// ape_webp_free. The alpha is PIL's "RGBA" view: 255 throughout where PIL
// presents the image as RGBX (no alpha flag, no VP8L alpha bit).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string message;
};

[[noreturn]] void fail(const std::string& m) { throw Failure{m}; }

// RFC 6386 section 13.5: the default coefficient probabilities
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// RFC 6386 section 13.4: the probabilities of a coefficient probability update
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// RFC 6386 section 11.5: the key-frame subblock mode probabilities [above][left],
// in the mode order below
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// RFC 6386 section 14.1: the DC and AC quantizer steps of each index
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 9649 section 5.2.2: the distance codes 1-120 as (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------- VP8L

// Bits LSB first. Past the data it reads zeros; vp8l_dec.c's end of stream
// is more bits consumed than the data holds (than 64 for data under 8 bytes).
struct LBitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  uint64_t pos = 0;  // bits consumed

  void init(const uint8_t* data, size_t len) {
    d = data;
    n = len;
    pos = 0;
  }
  bool eos() const { return pos > std::max<uint64_t>(64, (uint64_t)n * 8); }
  uint64_t window() const {  // the next 56 or more bits
    const size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      for (int i = 7; i >= 0; --i) v = (v << 8) | d[byte + i];
    } else {
      for (int i = 7; i >= 0; --i) v = (v << 8) | (byte + i < n ? d[byte + i] : 0);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = (uint32_t)(window() & ((1ull << k) - 1));
    pos += k;
    return v;
  }
};

// A canonical prefix code as VP8LBuildHuffmanTable accepts it: complete, or
// one symbol (read with no bits)
struct PrefixCode {
  int single = -1;
  int first[16], count[16], index[16];
  std::vector<int> sorted;
  uint16_t lut[256];  // 8 bits read -> (length << 12) | symbol, 0 if longer

  bool build(const int* lengths, int n) {
    int cnt[16] = {0};
    for (int s = 0; s < n; ++s) ++cnt[lengths[s]];
    if (cnt[0] == n) return false;
    for (int len = 1; len < 15; ++len)
      if (cnt[len] > (1 << len)) return false;
    if (n - cnt[0] == 1) {
      for (int s = 0; s < n; ++s)
        if (lengths[s]) single = s;
      return true;
    }
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = open * 2 - cnt[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    sorted.clear();
    int code = 0;
    for (int len = 1; len <= 15; ++len) {
      first[len] = code;
      count[len] = cnt[len];
      index[len] = (int)sorted.size();
      for (int s = 0; s < n; ++s)
        if (lengths[s] == len) sorted.push_back(s);
      code = (code + cnt[len]) << 1;
    }
    std::memset(lut, 0, sizeof(lut));
    for (int bits = 0; bits < 256; ++bits) {
      int c = 0;
      for (int len = 1; len <= 8; ++len) {
        c = (c << 1) | ((bits >> (len - 1)) & 1);
        if (c - first[len] < count[len]) {
          lut[bits] = (uint16_t)((len << 12) | sorted[index[len] + c - first[len]]);
          break;
        }
      }
    }
    return true;
  }

  int decode(LBitReader& br) const {
    if (single >= 0) return single;
    const uint64_t w = br.window();
    const int e = lut[w & 255];
    if (e) {
      br.pos += e >> 12;
      return e & 0xFFF;
    }
    int c = 0;
    for (int len = 1; len <= 15; ++len) {
      c = (c << 1) | (int)((w >> (len - 1)) & 1);
      if (c - first[len] < count[len]) {
        br.pos += len;
        return sorted[index[len] + c - first[len]];
      }
    }
    return 0;  // not reached: the code is complete
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((c0 >> s) & 255) + (int)((c1 >> s) & 255) - (int)((c2 >> s) & 255))
           << s;
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 255), b = (int)((c2 >> s) & 255);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ca = (int)((a >> s) & 255), cb = (int)((b >> s) & 255), cc = (int)((c >> s) & 255);
    pa_minus_pb += std::abs(cb - cc) - std::abs(ca - cc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// VP8LPredictors: L left, T top, TR top-right, TL top-left
inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

class VP8LDecoder {
 public:
  // a level-0 stream of xsize x ysize ARGB pixels (transforms allowed)
  // from bit `start` of `data`; `alpha_rule`: the end-of-stream rule of
  // vp8l_dec.c's 8-bit alpha path (data running out only with pixels left)
  std::vector<uint32_t> decode(const uint8_t* data, size_t len, int start, int xsize, int ysize,
                               bool alpha_rule) {
    br_.init(data, len);
    br_.pos = start;
    int width = xsize;
    while (br_.read(1)) read_transform(&width, ysize);
    const int cache_bits = read_cache_bits();
    Codes codes = read_codes(width, ysize, cache_bits, true);
    bool eight_bit = alpha_rule && transforms_.size() == 1 && transforms_[0].type == 3 &&
                     cache_bits == 0;
    for (const auto& g : codes.groups)
      for (int j = 1; j <= 3; ++j)
        if (g[j].single < 0) eight_bit = false;
    std::vector<uint32_t> pixels((size_t)width * ysize);
    decode_pixels(pixels, width, ysize, codes, cache_bits, eight_bit);
    if (!eight_bit && br_.eos()) fail("VP8L data ends early");
    for (size_t t = transforms_.size(); t-- > 0;) pixels = inverse(transforms_[t], pixels);
    return pixels;
  }

 private:
  using Group = std::vector<PrefixCode>;
  struct Codes {
    int bits = 0, xsize = 0;
    std::vector<uint32_t> meta;  // group index of each tile
    std::vector<Group> groups;
  };
  LBitReader br_;
  std::vector<LTransform> transforms_;
  unsigned seen_ = 0;

  int read_cache_bits() {
    if (!br_.read(1)) return 0;
    const int bits = (int)br_.read(4);
    if (bits < 1 || bits > 11) fail("bad VP8L color cache size");
    return bits;
  }

  // an entropy-coded image without transforms (a transform's data, the
  // meta prefix image, the palette)
  std::vector<uint32_t> sub_image(int xsize, int ysize) {
    const int cache_bits = read_cache_bits();
    Codes codes = read_codes(xsize, ysize, cache_bits, false);
    std::vector<uint32_t> pixels((size_t)xsize * ysize);
    decode_pixels(pixels, xsize, ysize, codes, cache_bits, false);
    if (br_.eos()) fail("VP8L data ends early");
    return pixels;
  }

  void read_transform(int* xsize, int ysize) {
    LTransform t;
    t.type = (int)br_.read(2);
    if (seen_ & (1u << t.type)) fail("a VP8L transform repeated");
    seen_ |= 1u << t.type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (t.type == 0 || t.type == 1) {
      t.bits = (int)br_.read(3) + 2;
      t.data = sub_image(sub_sample(t.xsize, t.bits), sub_sample(ysize, t.bits));
    } else if (t.type == 3) {
      const int num_colors = (int)br_.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = sub_sample(t.xsize, t.bits);
      std::vector<uint32_t> palette = sub_image(num_colors, 1);
      // the palette is coded as differences; entries past it are 0
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      const size_t kept = std::min(palette.size(), t.data.size());
      for (size_t i = 0; i < kept; ++i) t.data[i] = i ? add_pixels(palette[i], t.data[i - 1]) : palette[0];
    }
    transforms_.push_back(std::move(t));
  }

  Codes read_codes(int xsize, int ysize, int cache_bits, bool allow_meta) {
    Codes c;
    int num_groups = 1;
    if (allow_meta && br_.read(1)) {
      c.bits = (int)br_.read(3) + 2;
      c.xsize = sub_sample(xsize, c.bits);
      c.meta = sub_image(c.xsize, sub_sample(ysize, c.bits));
      for (auto& m : c.meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)m + 1);
      }
    }
    const int alphabet[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
    c.groups.resize(num_groups);
    for (auto& g : c.groups) {
      g.resize(5);
      for (int j = 0; j < 5; ++j) read_code(g[j], alphabet[j]);
    }
    return c;
  }

  void read_code(PrefixCode& code, int alphabet) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple: one or two symbols
      const int num = (int)br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br_.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = (int)br_.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) fail("bad VP8L code length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * (int)br_.read(3);
        max_symbol = 2 + (int)br_.read(nbits);
        if (max_symbol > alphabet) fail("bad VP8L code length count");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.decode(br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          const int slot = len - 16;
          const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          const int repeat = (int)br_.read(extra[slot]) + offset[slot];
          if (symbol + repeat > alphabet) fail("bad VP8L code lengths");
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = len == 16 ? prev : 0;
        }
      }
    }
    if (br_.eos()) fail("VP8L data ends early");
    if (!code.build(lengths.data(), alphabet)) fail("bad VP8L prefix code");
  }

  int copy_value(int symbol) {  // GetCopyDistance / GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br_.read(extra) + 1;
  }

  void decode_pixels(std::vector<uint32_t>& px, int xsize, int ysize, const Codes& c, int cache_bits,
                     bool eight_bit) {
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    const size_t total = (size_t)xsize * ysize;
    size_t pos = 0;
    while (pos < total) {
      const int col = (int)(pos % xsize), row = (int)(pos / xsize);
      const Group& g = c.groups[c.meta.empty() ? 0
                                               : c.meta[(size_t)(row >> c.bits) * c.xsize +
                                                        (col >> c.bits)]];
      const int code = g[0].decode(br_);
      if (code < 256) {
        const uint32_t red = g[1].decode(br_), blue = g[2].decode(br_), alpha = g[3].decode(br_);
        px[pos] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        insert(px[pos++]);
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dcode = copy_value(g[4].decode(br_));
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int p = kCodeToPlane[dcode - 1];
          dist = (p >> 4) * xsize + (8 - (p & 15));
          if (dist < 1) dist = 1;
        }
        if (pos < (size_t)dist || total - pos < (size_t)length) fail("bad VP8L backward reference");
        for (int i = 0; i < length; ++i, ++pos) {
          px[pos] = px[pos - dist];
          insert(px[pos]);
        }
      } else if (cache_bits && code < 256 + 24 + (1 << cache_bits)) {
        px[pos] = cache[code - 280];
        insert(px[pos++]);
      } else {
        fail("bad VP8L symbol");
      }
      if (eight_bit && pos < total && br_.eos()) fail("VP8L data ends early");
    }
  }

  static std::vector<uint32_t> inverse(const LTransform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out((size_t)w * h);
    if (t.type == 2) {  // subtract green
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t a = in[i], g = (a >> 8) & 255;
        out[i] = (a & 0xff00ff00u) | ((((a >> 16) + g) & 255) << 16) | (((a & 255) + g) & 255);
      }
    } else if (t.type == 3) {  // color indexing, with pixels bundled in the green byte
      const int per_byte_bits = 8 >> t.bits, in_w = sub_sample(w, t.bits);
      const uint32_t mask = (1u << per_byte_bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = &in[(size_t)y * in_w];
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (src[x >> t.bits] >> 8) & 255;
          const uint32_t idx = (packed >> ((x & ((1 << t.bits) - 1)) * per_byte_bits)) & mask;
          out[(size_t)y * w + x] = t.data[idx];
        }
      }
    } else if (t.type == 1) {  // cross color
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255),
                       r2b = (int8_t)((m >> 16) & 255);
          const uint32_t a = in[(size_t)y * w + x];
          const int8_t green = (int8_t)(a >> 8);
          int red = (int)((a >> 16) & 255), blue = (int)(a & 255);
          red = (red + ((g2r * green) >> 5)) & 255;
          blue += (g2b * green) >> 5;
          blue = (blue + ((r2b * (int8_t)red) >> 5)) & 255;
          out[(size_t)y * w + x] = (a & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
    } else {  // predictor
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* o = &out[(size_t)y * w];
        const uint32_t* r = &in[(size_t)y * w];
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : o[x - 1];
          } else if (x == 0) {
            pred = o[x - (ptrdiff_t)w];
          } else {
            const int mode = (t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15;
            const uint32_t* up = o - w;
            // the top-right of the last column is the row's first pixel
            pred = predict(mode, o[x - 1], up[x], up[x + 1], up[x - 1]);
          }
          o[x] = add_pixels(r[x], pred);
        }
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------- VP8

// The boolean decoder of RFC 6386 section 7 as libwebp's bit_reader reads
// it on x86-64: 56 bits loaded at a time while 8 bytes remain, then a byte
// at a time; past the partition one zero byte, and eof. (How the bits are
// loaded decides what a damaged stream, whose value has left its range,
// decodes to: the value's excess then overflows the 64-bit register.)
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    end = data + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {  // VP8LoadNewBytes: BITS = 56
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      value = in | (value << 56);
      bits += 56;
      buf += 7;
    } else if (buf < end) {  // VP8LoadFinalBytes
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7;
    for (uint32_t t = r; t > 1; t >>= 1) --shift;  // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

// libwebp's intra modes: the subblock modes, then the 16x16 and chroma
// ones by the same numbers (DC, TM, V = VE, H = HE)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };
constexpr int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                      -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the work buffer's stride (libwebp's yuv_b_)
constexpr int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction, mode by number
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  switch (mode) {
    case B_DC:
      dc = size;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
      break;
    case DC_NOTOP:
      dc = size / 2;
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, size, dc >> shift);
      break;
    case DC_NOLEFT:
      dc = size / 2;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, dc >> shift);
      break;
    default: fill(dst, size, 0x80); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
// dsp/dec.c's 4x4 predictors
void predict4(uint8_t* dst, int mode) {
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS], A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS],
            D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS],
            H = dst[7 - BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = (uint8_t)v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, v[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of one 4x4 block, added to dst (TransformOne)
void transform(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {  // vertical pass
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// The same transform as libwebp's SSE2 build computes it (Transform_SSE2,
// which the decoder takes for a block with coefficients past the third in
// zigzag order, and for all four blocks of a chroma plane with any AC): in
// 16-bit lanes that wrap, the multiplies as 16-bit high halves. It equals
// `transform` wherever no sum leaves int16, as in every stream an encoder
// writes; damaged data tells them apart.
inline int16_t w16(int v) { return (int16_t)(uint16_t)(unsigned)v; }
inline int16_t mulhi(int16_t a, int k) { return (int16_t)((a * k) >> 16); }

void transform16(const int16_t* in, uint8_t* dst) {
  int16_t T[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass, written transposed
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t c = w16(w16(in1 - in3) + w16(mulhi(in1, -30068) - mulhi(in3, 20091)));
    const int16_t d = w16(w16(in1 + in3) + w16(mulhi(in1, 20091) + mulhi(in3, -30068)));
    T[i * 4 + 0] = w16(a + d);
    T[i * 4 + 1] = w16(b + c);
    T[i * 4 + 2] = w16(b - c);
    T[i * 4 + 3] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r, dst += BPS) {  // horizontal pass over each output row
    const int16_t t0 = T[r], t1 = T[4 + r], t2 = T[8 + r], t3 = T[12 + r];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, -30068) - mulhi(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, 20091) + mulhi(t3, -30068)));
    const int16_t v[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    for (int x = 0; x < 4; ++x) dst[x] = clip8(dst[x] + (v[x] >> 3));
  }
}

// the inverse WHT of the 16 luma DC values into each block's coefficient 0
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
  }
}

// --- the loop filters (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `size` edge pixels from p, across the edge by hstride, along it by vstride
void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      do_filter2(p, hstride);
    else if (edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBData {
  int segment = 0, ymode = 0, uvmode = 0;
  bool i4x4 = false, skip = false;
  uint8_t imodes[16];
  int16_t coeffs[384];
  uint8_t code[24];  // libwebp's per-block transform: 3 full, 2 AC3, 1 DC, 0 none
};

class VP8Decoder {
 public:
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> Y, U, V;  // mb_w * 16 (8) wide, filtered
  int y_stride = 0, uv_stride = 0;

  void decode(const uint8_t* data, size_t n) {
    if (n < 10) fail("truncated VP8 header");
    const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(tag & 1);
    const int profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
    const uint32_t part0 = tag >> 5;
    if (profile > 3) fail("bad VP8 profile");
    if (!show) fail("VP8 frame not displayable");
    if (!key_frame) fail("VP8 frame is not a key frame");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("bad VP8 start code");
    width = ((data[7] << 8) | data[6]) & 0x3fff;
    height = ((data[9] << 8) | data[8]) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t size = n - 10;
    if (part0 > size) fail("bad VP8 partition length");
    br_.init(buf, part0);
    buf += part0;
    size -= part0;
    br_.bit(0x80);  // colorspace
    br_.bit(0x80);  // clamping type
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, size);
    parse_quant();
    br_.bit(0x80);  // refresh entropy probabilities (ignored)
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br_.value_bits(8)
                                                                         : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.bit(0x80);
    if (use_skip_proba_) skip_p_ = br_.value_bits(8);
    if (br_.eof) fail("truncated VP8 frame header");
    decode_frame();
  }

 private:
  BoolReader br_, parts_[8];
  int num_parts_ = 1;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm_[4];
  FilterInfo fstrengths_[4][2];

  void parse_segment_header() {
    use_segment_ = br_.bit(0x80);
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {
        absolute_delta_ = br_.bit(0x80);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.bit(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.bit(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) segment_proba_[s] = br_.bit(0x80) ? (uint8_t)br_.value_bits(8) : 255;
    } else {
      update_map_ = false;
    }
    if (br_.eof) fail("cannot parse VP8 segment header");
  }

  void parse_filter_header() {
    simple_ = br_.bit(0x80);
    level_ = br_.value_bits(6);
    sharpness_ = br_.value_bits(3);
    use_lf_delta_ = br_.bit(0x80);
    if (use_lf_delta_ && br_.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) fail("cannot parse VP8 filter header");
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_ = 1 << br_.value_bits(2);
    const size_t last = (size_t)num_parts_ - 1;
    if (size < 3 * last) fail("cannot parse VP8 partitions");
    const uint8_t* start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= buf_end) fail("cannot parse VP8 partitions");
  }

  void parse_quant() {
    const int base_q0 = br_.value_bits(7);
    const int dqy1_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x 155 / 100
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  // frame_dec.c PrecomputeFilterStrengths
  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      b.segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                               : br_.bit(segment_proba_[2]) + 2;
    } else {
      b.segment = 0;
    }
    b.skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
    b.i4x4 = !br_.bit(145);
    if (!b.i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE) : (br_.bit(163) ? B_VE : B_DC);
      b.ymode = ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br_.bit(142) ? B_DC : !br_.bit(114) ? B_VE : br_.bit(183) ? B_TM : B_HE;
  }

  int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // tree_dec.c GetCoeffs: returns the position after the last nonzero
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      const int sv = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = (int16_t)(sv * dq[n > 0]);
    }
    return 16;
  }

  // tree_dec.c / vp8_dec.c ParseResiduals; nz contexts as libwebp keeps them
  void parse_residuals(MBData& b, BoolReader& br, uint8_t& top_nz, uint8_t& top_dc,
                       uint8_t& left_nz, uint8_t& left_dc) {
    const Quant& q = dqm_[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    int first, ac_type;
    if (!b.i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_dc + left_dc;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      top_dc = left_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    bool any = false;
    uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        b.code[y * 4 + x] = (uint8_t)(nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
        any |= b.code[y * 4 + x] != 0;
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = (uint8_t)(top_nz >> (4 + ch));
      lnz = (uint8_t)(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          b.code[16 + ch * 2 + y * 2 + x] = (uint8_t)(nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
          any |= b.code[16 + ch * 2 + y * 2 + x] != 0;
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      out_t |= (uint32_t)(tnz << 4) << ch;
      out_l |= (uint32_t)(lnz & 0xf0) << ch;
    }
    top_nz = (uint8_t)out_t;
    left_nz = (uint8_t)out_l;
    b.skip = !any;
  }

  void decode_frame() {
    if (filter_type_ > 0) filter_strengths();
    y_stride = mb_w * 16;
    uv_stride = mb_w * 8;
    Y.assign((size_t)y_stride * mb_h * 16, 0);
    U.assign((size_t)uv_stride * mb_h * 8, 0);
    V.assign((size_t)uv_stride * mb_h * 8, 0);
    std::vector<uint8_t> intra_t((size_t)4 * mb_w, B_DC);
    std::vector<uint8_t> top_nz(mb_w, 0), top_dc(mb_w, 0);
    std::vector<uint8_t> top_y((size_t)16 * mb_w), top_u((size_t)8 * mb_w), top_v((size_t)8 * mb_w);
    std::vector<MBData> row(mb_w);
    std::vector<FilterInfo> finfo((size_t)mb_w * mb_h);
    uint8_t ws[YUV_SIZE];
    std::memset(ws, 0, sizeof(ws));
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(row[mb_x], &intra_t[(size_t)4 * mb_x], intra_l);
      if (br_.eof) fail("premature end of VP8 partition 0");
      BoolReader& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t left_nz = 0, left_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& b = row[mb_x];
        bool skip = b.skip;
        if (!skip) {
          parse_residuals(b, tokens, top_nz[mb_x], top_dc[mb_x], left_nz, left_dc);
          skip = b.skip;
        } else {
          left_nz = top_nz[mb_x] = 0;
          if (!b.i4x4) left_dc = top_dc[mb_x] = 0;
          std::memset(b.code, 0, sizeof(b.code));
          std::memset(b.coeffs, 0, sizeof(b.coeffs));
        }
        if (filter_type_ > 0) {
          FilterInfo f = fstrengths_[b.segment][b.i4x4];
          f.inner = f.inner || !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        if (tokens.eof) fail("premature end of VP8 token partition");
      }
      reconstruct_row(mb_y, row, ws, top_y, top_u, top_v);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[(size_t)mb_y * mb_w + mb_x]);
  }

  // frame_dec.c ReconstructRow, through libwebp's work buffer
  void reconstruct_row(int mb_y, std::vector<MBData>& row, uint8_t* ws, std::vector<uint8_t>& top_y,
                       std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
    uint8_t* const y_dst = ws + Y_OFF;
    uint8_t* const u_dst = ws + U_OFF;
    uint8_t* const v_dst = ws + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& b = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, &top_y[(size_t)16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &top_u[(size_t)8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &top_v[(size_t)8 * mb_x], 8);
      }
      const int16_t* coeffs = b.coeffs;
      if (b.i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, top_y[(size_t)16 * mb_x + 15], 4);
          else
            std::memcpy(top_right, &top_y[(size_t)16 * (mb_x + 1)], 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, b.imodes[n]);
          luma_transform(b.code[n], coeffs + n * 16, dst);
        }
      } else {
        int mode = b.ymode;
        if (mode == B_DC) mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                           : (mb_y == 0 ? DC_NOTOP : B_DC);
        predict_block(y_dst, 16, mode);
        for (int n = 0; n < 16; ++n)
          luma_transform(b.code[n], coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      int uvmode = b.uvmode;
      if (uvmode == B_DC) uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                             : (mb_y == 0 ? DC_NOTOP : B_DC);
      predict_block(u_dst, 8, uvmode);
      predict_block(v_dst, 8, uvmode);
      chroma_transform(&b.code[16], coeffs + 256, u_dst);
      chroma_transform(&b.code[20], coeffs + 320, v_dst);
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[(size_t)16 * mb_x], y_dst + 15 * BPS, 16);
        std::memcpy(&top_u[(size_t)8 * mb_x], u_dst + 7 * BPS, 8);
        std::memcpy(&top_v[(size_t)8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[(size_t)(mb_y * 16 + j) * y_stride + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&V[(size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  // frame_dec.c DoTransform: the SSE2 transform for a block with a
  // coefficient past the third in zigzag order, else the C code's AC3 and
  // DC-only transforms (int arithmetic, as `transform`)
  static void luma_transform(int code, const int16_t* in, uint8_t* dst) {
    if (code == 3)
      transform16(in, dst);
    else if (code)
      transform(in, dst);
  }

  // DoUVTransform: nothing for a plane without coefficients; the SSE2
  // transform for all four blocks where any has an AC coefficient, else the
  // DC-only transform of each block with a DC
  static void chroma_transform(const uint8_t* code, const int16_t* in, uint8_t* dst) {
    if (!(code[0] | code[1] | code[2] | code[3])) return;
    const bool ac = code[0] >= 2 || code[1] >= 2 || code[2] >= 2 || code[3] >= 2;
    for (int n = 0; n < 4; ++n) {
      uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
      if (ac)
        transform16(in + n * 16, d);
      else if (in[n * 16])
        transform(in + n * 16, d);
    }
  }

  // frame_dec.c DoFilter
  void filter_mb(int mb_x, int mb_y, const FilterInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = &Y[(size_t)mb_y * 16 * y_stride + mb_x * 16];
    const int ys = y_stride;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, 16, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
      return;
    }
    const int uvs = uv_stride;
    uint8_t* u = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u, 1, uvs, 8, limit + 4, il, hev_t, true);
      filter_loop(v, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u + 4, 1, uvs, 8, limit, il, hev_t, false);
      filter_loop(v + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u, uvs, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
      filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
  }
};

// ---------------------------------------------------------------- alpha

// ALPH (alpha_dec.c): a header byte (method, filter, pre-processing), then
// raw or VP8L-coded values, unfiltered row by row
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t n, int width, int height) {
  if (n <= 1) fail("empty ALPH chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved) fail("bad ALPH header");
  const size_t count = (size_t)width * height;
  std::vector<uint8_t> a(count);
  if (method == 0) {
    if (n - 1 < count) fail("truncated ALPH data");
    std::memcpy(a.data(), data + 1, count);
  } else {
    VP8LDecoder dec;
    std::vector<uint32_t> argb = dec.decode(data + 1, n - 1, 0, width, height, true);
    for (size_t i = 0; i < count; ++i) a[i] = (uint8_t)(argb[i] >> 8);
  }
  for (int y = 0; y < height; ++y) {  // dsp/filters.c unfilters
    uint8_t* row = &a[(size_t)y * width];
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 0) continue;
    if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < width; ++x) {
        const int top = prev[x];
        left = (uint8_t)(row[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = (uint8_t)left;
      }
    }
  }
  return a;
}

// ---------------------------------------------------------------- output

// dsp/yuv.h: 14-bit fixed point
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// dsp/upsampling.c's fancy upsampler, one output row: `near` is the chroma
// row nearest it (weight 3), `far` the other (weight 1); u and v packed as
// u | v << 16
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, uint8_t* dst) {
  auto load = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(nu[0], nv[0]), l = load(fu[0], fv[0]);
  uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
  yuv_to_rgba(y[0], uv0 & 0xff, uv0 >> 16, dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(nu[x], nv[x]), uv = load(fu[x], fv[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    const uint32_t a = (diag_12 + tl) >> 1, b = (diag_03 + t) >> 1;
    yuv_to_rgba(y[2 * x - 1], a & 0xff, a >> 16, dst + 4 * (2 * x - 1));
    yuv_to_rgba(y[2 * x], b & 0xff, b >> 16, dst + 4 * (2 * x));
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgba(y[len - 1], uv0 & 0xff, uv0 >> 16, dst + 4 * (len - 1));
  }
}

// ---------------------------------------------------------------- container

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

struct Chunk {
  uint32_t fourcc = 0;
  size_t start = 0, payload = 0, size = 0, next = 0;  // size: the payload's declared size
};

inline uint32_t fourcc(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

struct Frame {
  int x = 0, y = 0, width = 0, height = 0;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  bool alpha_after_image = false, lossless = false, complete = false;
  const uint8_t* image = nullptr;
  size_t image_size = 0;   // the chunk's declared size
  size_t image_data = 0;   // what the decoder reads: the payload with its pad byte
};

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;

class Container {
 public:
  Container(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  bool alpha_flag = false;  // PIL's mode is RGBA (else RGBX: alpha shown as 255)

  // the first frame and the canvas, as WebPAnimDecoderNew validates them:
  // WebPGetFeatures of the whole file, then WebPDemux
  Frame first_frame(int* canvas_w, int* canvas_h) {
    features_check();
    if (n_ < 20 || std::memcmp(d_, "RIFF", 4) || std::memcmp(d_ + 8, "WEBP", 4)) fail("not a WebP file");
    const uint32_t riff_size = le32(d_ + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) fail("bad RIFF size");
    if ((size_t)riff_size + 8 > n_) fail("truncated WebP file");
    end_ = (size_t)riff_size + 8;
    size_t pos = 12;
    if (end_ < pos + 8) fail("truncated WebP file");
    const uint32_t first = le32(d_ + pos);
    if (first == fourcc("VP8X")) return extended(pos, canvas_w, canvas_h);
    if (first != fourcc("VP8 ") && first != fourcc("VP8L")) fail("not a WebP image");
    Frame f;
    store_frame(pos, end_, &f);
    if (!f.complete) fail("bad WebP image");
    f.alpha = nullptr;  // WebPDemux drops the alpha of a file without the VP8X alpha flag
    alpha_flag = f.lossless && ((f.image[4] >> 4) & 1);  // the VP8L header's alpha bit
    *canvas_w = f.width;
    *canvas_h = f.height;
    return f;
  }

 private:
  const uint8_t* d_;
  size_t n_, end_ = 0;

  // dec/webp_dec.c ParseHeadersInternal as WebPGetFeatures runs it (without
  // all the data in hand: running out of it after a VP8X chunk passes): the
  // RIFF header, a VP8X chunk of exactly 10 bytes, for a still image the
  // chunks before its image within the RIFF size, the image chunk's header
  // and VP8GetInfo / VP8LGetInfo, and the image's size equal to the canvas
  void features_check() const {
    if (n_ < 12) fail("truncated WebP file");
    size_t pos = 0, riff = 0;
    if (!std::memcmp(d_, "RIFF", 4)) {
      if (std::memcmp(d_ + 8, "WEBP", 4)) fail("not a WebP file");
      riff = le32(d_ + 4);
      if (riff < 12 || riff > kMaxChunkPayload) fail("bad RIFF size");
      pos = 12;
    }
    if (n_ - pos < 8) fail("truncated WebP file");
    bool vp8x = false;
    int canvas_w = 0, canvas_h = 0;
    if (!std::memcmp(d_ + pos, "VP8X", 4)) {
      if (le32(d_ + pos + 4) != 10) fail("bad VP8X chunk size");
      if (n_ - pos < 18) fail("truncated WebP file");
      const uint32_t flags = le32(d_ + pos + 8);
      canvas_w = (int)le24(d_ + pos + 12) + 1;
      canvas_h = (int)le24(d_ + pos + 15) + 1;
      if ((uint64_t)canvas_w * canvas_h >= (1ull << 32)) fail("WebP canvas too large");
      if (!riff) fail("VP8X without RIFF");
      if (flags & 0x02) return;  // an animation: the features are the VP8X chunk's
      vp8x = true;
      pos += 18;
    }
    auto short_of_data = [&]() {  // NOT_ENOUGH_DATA: passes after a VP8X chunk
      if (!vp8x) fail("truncated WebP file");
    };
    if (n_ - pos < 4) return short_of_data();
    if (vp8x) {  // ParseOptionalChunks
      uint64_t total = 4 + 8 + 10;
      for (;;) {
        if (n_ - pos < 8) return short_of_data();
        const uint32_t size = le32(d_ + pos + 4);
        if (size > kMaxChunkPayload) fail("bad WebP chunk size");
        const uint64_t disk = (8 + (uint64_t)size + 1) & ~1ull;
        total += disk;
        if (riff > 0 && total > riff) fail("WebP chunk past the RIFF size");
        if (!std::memcmp(d_ + pos, "VP8 ", 4) || !std::memcmp(d_ + pos, "VP8L", 4)) break;
        if (n_ - pos < disk) return short_of_data();
        pos += disk;
      }
    }
    if (n_ - pos < 8) return short_of_data();
    const bool is_vp8 = !std::memcmp(d_ + pos, "VP8 ", 4), is_vp8l = !std::memcmp(d_ + pos, "VP8L", 4);
    if (!is_vp8 && !is_vp8l) fail("no VP8 or VP8L chunk");
    const uint32_t size = le32(d_ + pos + 4);
    if (riff >= 12 && size > riff - 12) fail("VP8 chunk past the RIFF size");
    pos += 8;
    int w, h;
    if (is_vp8) {
      if (n_ - pos < 10) return short_of_data();
      const uint8_t* p = d_ + pos;
      const uint32_t bits = le24(p);
      if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a || (bits & 1) || ((bits >> 1) & 7) > 3 ||
          !((bits >> 4) & 1) || (bits >> 5) >= size)
        fail("bad VP8 header");
      w = ((p[7] << 8) | p[6]) & 0x3fff;
      h = ((p[9] << 8) | p[8]) & 0x3fff;
      if (!w || !h) fail("empty VP8 frame");
    } else {
      if (n_ - pos < 5) return short_of_data();
      const uint8_t* p = d_ + pos;
      if (p[0] != 0x2f || (p[4] >> 5) != 0) fail("bad VP8L header");
      const uint32_t bits = le32(p + 1);
      w = (int)(bits & 0x3fff) + 1;
      h = (int)((bits >> 14) & 0x3fff) + 1;
    }
    if (vp8x && (w != canvas_w || h != canvas_h)) fail("image size is not the canvas size");
  }

  Chunk chunk_at(size_t pos, size_t limit) const {
    if (pos + 8 > limit) fail("truncated WebP chunk");
    Chunk c;
    c.fourcc = le32(d_ + pos);
    c.size = le32(d_ + pos + 4);
    if (c.size > kMaxChunkPayload) fail("bad WebP chunk size");
    const size_t padded = c.size + (c.size & 1);
    c.start = pos;
    c.payload = pos + 8;
    c.next = c.payload + padded;
    if (c.next > limit) fail("truncated WebP chunk");
    return c;
  }

  // demux.c StoreFrame: an optional ALPH, then VP8 or VP8L, from pos
  size_t store_frame(size_t pos, size_t limit, Frame* f) {
    int alpha_chunks = 0, image_chunks = 0;
    while (pos + 8 <= limit) {
      const Chunk c = chunk_at(pos, limit);
      if (c.fourcc == fourcc("ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha = d_ + c.payload;
        f->alpha_size = c.size;
        f->alpha_after_image = image_chunks > 0;
      } else if (c.fourcc == fourcc("VP8L") && alpha_chunks) {
        fail("VP8L after ALPH");  // StoreFrame refuses it before looking for a first image
      } else if ((c.fourcc == fourcc("VP8 ") || c.fourcc == fourcc("VP8L")) && image_chunks == 0) {
        ++image_chunks;
        f->lossless = c.fourcc == fourcc("VP8L");
        f->image = d_ + c.payload;
        f->image_size = c.size;
        f->image_data = c.next - c.payload;
        features(*f);
        f->complete = true;
      } else {
        break;
      }
      pos = c.next;
      if (pos != end_ && end_ - pos < 8) fail("truncated WebP chunk");  // WebPDemux waits for more
    }
    return pos;
  }

  // WebPGetFeatures of the image chunk: VP8GetInfo / VP8LGetInfo
  void features(Frame& f) const {
    const uint8_t* p = f.image;
    const size_t n = f.image_data;
    if (f.lossless) {
      if (n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) fail("bad VP8L header");
      const uint32_t bits = le32(p + 1);
      f.width = (int)(bits & 0x3fff) + 1;
      f.height = (int)((bits >> 14) & 0x3fff) + 1;
      return;
    }
    if (n < 10 || p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail("bad VP8 header");
    const uint32_t bits = le24(p);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= f.image_size)
      fail("bad VP8 frame tag");
    f.width = ((p[7] << 8) | p[6]) & 0x3fff;
    f.height = ((p[9] << 8) | p[8]) & 0x3fff;
    if (!f.width || !f.height) fail("empty VP8 frame");
  }

  Frame extended(size_t pos, int* canvas_w, int* canvas_h) {
    const Chunk x = chunk_at(pos, end_);
    if (x.size < 10) fail("bad VP8X chunk");
    const int flags = d_[x.payload];
    if (flags & ~0x3e) fail("unknown VP8X flags");
    alpha_flag = flags & 0x10;
    const bool animation = flags & 0x02;
    *canvas_w = (int)le24(d_ + x.payload + 4) + 1;
    *canvas_h = (int)le24(d_ + x.payload + 7) + 1;
    if ((uint64_t)*canvas_w * *canvas_h >= (1ull << 32)) fail("WebP canvas too large");
    pos = x.next;
    bool have_anim = false;
    Frame first;
    bool found = false;
    while (pos < end_) {
      if (pos + 8 > end_) fail("truncated WebP chunk");  // 1-7 bytes left: WebPDemux waits
      const Chunk c = chunk_at(pos, end_);
      if (c.fourcc == fourcc("VP8X")) fail("a second VP8X chunk");
      if (c.fourcc == fourcc("ALPH") || c.fourcc == fourcc("VP8 ") || c.fourcc == fourcc("VP8L")) {
        if (have_anim || animation || found) fail("a still image where WebPDemux refuses it");
        Frame f;
        pos = store_frame(pos, end_, &f);
        if (!f.complete) fail("incomplete WebP image");
        if (!(flags & 0x10)) f.alpha = nullptr;  // no alpha flag: the ALPH chunk is dropped
        if (f.alpha && f.alpha_after_image) fail("ALPH after the image");
        if (f.width != *canvas_w || f.height != *canvas_h) fail("image size is not the canvas size");
        first = f;
        found = true;
        continue;
      }
      const size_t padded = c.next - c.payload;
      if (c.fourcc == fourcc("ANIM")) {
        if (padded < 6) fail("bad ANIM chunk");
        have_anim = true;
      } else if (c.fourcc == fourcc("ANMF")) {
        if (!have_anim) fail("ANMF before ANIM");
        if (padded < 16) fail("bad ANMF chunk");
        const uint8_t* h = d_ + c.payload;
        Frame f;
        f.x = 2 * (int)le24(h);
        f.y = 2 * (int)le24(h + 3);
        const uint64_t w = le24(h + 6) + 1ull, hh = le24(h + 9) + 1ull;
        if (w * hh >= (1ull << 32)) fail("WebP frame too large");
        // demux.c ParseAnimationFrame: StoreFrame reads on from the frame's
        // header, past the ANMF if need be, and the parser goes on where it
        // stopped; reading past the ANMF's payload is an error
        const size_t after = store_frame(c.payload + 16, end_, &f);
        if (after - c.payload > padded) fail("bad ANMF chunk");
        pos = after;
        if (animation && (f.alpha || f.image)) {
          if (!f.complete) fail("incomplete WebP frame");
          if (f.alpha && f.alpha_after_image) fail("ALPH after the image");
          if (f.x + f.width > *canvas_w || f.y + f.height > *canvas_h) fail("frame outside the canvas");
          if (!found) {
            first = f;
            found = true;
          }
        }
        continue;
      }
      pos = c.next;
    }
    if (!found) fail("no WebP frame");
    return first;
  }
};

void decode_frame(const Frame& f, int canvas_w, uint8_t* canvas) {
  const int w = f.width, h = f.height;
  uint8_t* origin = canvas + ((size_t)f.y * canvas_w + f.x) * 4;
  if (f.lossless) {
    // after the 40-bit header: signature, width - 1, height - 1, alpha, version
    VP8LDecoder dec;
    std::vector<uint32_t> argb = dec.decode(f.image, f.image_data, 40, w, h, false);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t a = argb[(size_t)y * w + x];
        uint8_t* o = origin + ((size_t)y * canvas_w + x) * 4;
        o[0] = (uint8_t)(a >> 16);
        o[1] = (uint8_t)(a >> 8);
        o[2] = (uint8_t)a;
        o[3] = (uint8_t)(a >> 24);
      }
    return;
  }
  VP8Decoder dec;
  dec.decode(f.image, f.image_data);
  if (dec.width != w || dec.height != h) fail("VP8 frame size changed");
  std::vector<uint8_t> alpha;
  if (f.alpha) alpha = decode_alpha(f.alpha, f.alpha_size, w, h);
  std::vector<uint8_t> line((size_t)w * 4);
  const int uv_h = (h + 1) / 2;
  for (int y = 0; y < h; ++y) {
    const int near = y >> 1;
    int far = (y & 1) ? (y + 1) >> 1 : (y - 1) >> 1;
    far = std::min(std::max(far, 0), uv_h - 1);
    const uint8_t* yrow = &dec.Y[(size_t)y * dec.y_stride];
    upsample_row(yrow, &dec.U[(size_t)near * dec.uv_stride], &dec.V[(size_t)near * dec.uv_stride],
                 &dec.U[(size_t)far * dec.uv_stride], &dec.V[(size_t)far * dec.uv_stride], w,
                 line.data());
    uint8_t* o = origin + (size_t)y * canvas_w * 4;
    for (int x = 0; x < w; ++x) {
      std::memcpy(o + 4 * x, &line[4 * x], 3);
      o[4 * x + 3] = alpha.empty() ? 255 : alpha[(size_t)y * w + x];
    }
  }
}

void set_error(char* err, int errlen, const std::string& m) {
  if (errlen <= 0) return;
  const size_t k = std::min(m.size(), (size_t)errlen - 1);
  std::memcpy(err, m.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// WebP bytes -> the first frame on its canvas, RGBA uint8 (H, W, 4),
// allocated here (release with ape_webp_free).
int ape_webp_decode(const uint8_t* data, size_t len, uint8_t** out, int* width, int* height,
                    char* err, int errlen) {
  *out = nullptr;
  try {
    Container container(data, len);
    int cw = 0, ch = 0;
    Frame f = container.first_frame(&cw, &ch);
    if ((uint64_t)cw * ch > 178956970) fail("image size exceeds the decompression-bomb limit");
    std::vector<uint8_t> canvas((size_t)cw * ch * 4, 0);
    decode_frame(f, cw, canvas.data());
    if (!container.alpha_flag)
      for (size_t i = 3; i < canvas.size(); i += 4) canvas[i] = 255;
    *out = static_cast<uint8_t*>(std::malloc(canvas.size()));
    if (!*out) fail("out of memory");
    std::memcpy(*out, canvas.data(), canvas.size());
    *width = cw;
    *height = ch;
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.message);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

void ape_webp_free(void* p) { std::free(p); }

}  // extern "C"
