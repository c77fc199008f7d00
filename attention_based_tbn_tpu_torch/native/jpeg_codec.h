// jpeg_codec — the port's own baseline JPEG decoder (see jpeg_codec.cpp).

#pragma once

#include <cstdint>
#include <string>

namespace tbn_codec {

// The image's size from its frame header. Returns 0, or -1 with *error set.
int info(const uint8_t* data, int64_t size, int* height, int* width, std::string* error);

// Decode into out (height * width * channels bytes): channels 3 gives BGR
// (cv2's order), 1 gives grayscale (the Y plane of a YCbCr file). Returns 0,
// or -1 with *error set (a progressive or arithmetic-coded file names its
// type).
int decode(const uint8_t* data, int64_t size, uint8_t* out, int channels, std::string* error);

}  // namespace tbn_codec
