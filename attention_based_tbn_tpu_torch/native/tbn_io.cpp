// tbn_io — the port's native host-side IO: JPEG decode, bilinear resize,
// PCM WAV reading with linear resampling, and a pthread batch decode.
//
// The port's own copy of the JAX package's native/tbn_io.cpp, with the same
// C ABI (bound by ctypes in attention_based_tbn_tpu_torch/native), plus
// tbn_last_error for messages. Where that library decodes JPEG through
// libjpeg, this one decodes through the port's own baseline decoder
// (jpeg_codec.cpp), which gives libjpeg's default decode to the bit and
// needs no libjpeg headers.
//
// Decoded colour frames are BGR, as cv2.imread gives them.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include "jpeg_codec.h"

// the reason of the calling thread's last failed JPEG call
static thread_local std::string g_error;

extern "C" {

const char* tbn_last_error() { return g_error.c_str(); }

void tbn_free(void* ptr) { std::free(ptr); }

// ----------------------------------------------------------------- JPEG

// The image's size from its header. Returns 0 on success.
int tbn_jpeg_info(const uint8_t* data, int64_t size, int* height, int* width) {
  return tbn_codec::info(data, size, height, width, &g_error);
}

// Decode a JPEG from memory into out (h * w * channels bytes: query first
// with tbn_jpeg_info). channels: 3 = BGR (as cv2), 1 = grayscale. Returns 0
// on success.
int tbn_decode_jpeg(const uint8_t* data, int64_t size, uint8_t* out, int channels) {
  return tbn_codec::decode(data, size, out, channels, &g_error);
}

// --------------------------------------------------------------- resize

// Bilinear resize, cv2 INTER_LINEAR sampling: src coordinate of dst pixel x
// is (x + 0.5) * scale - 0.5, clamped.
void tbn_resize_bilinear(const uint8_t* src, int sh, int sw, int channels,
                         uint8_t* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      for (int c = 0; c < channels; ++c) {
        float v00 = src[(static_cast<int64_t>(y0) * sw + x0) * channels + c];
        float v01 = src[(static_cast<int64_t>(y0) * sw + x1) * channels + c];
        float v10 = src[(static_cast<int64_t>(y1) * sw + x0) * channels + c];
        float v11 = src[(static_cast<int64_t>(y1) * sw + x1) * channels + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<int64_t>(y) * dw + x) * channels + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// ------------------------------------------------------------------ WAV

// Read a PCM WAV file, convert to mono float32 in [-1, 1], linearly
// resample to target_sr. Caller frees *out with tbn_free.
int tbn_read_wav(const char* path, int target_sr, float** out,
                 int64_t* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&riff_size, 4, 1, f) != 1 ||
      std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return -2;
  }

  uint16_t audio_format = 0, num_channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  std::vector<uint8_t> pcm;

  char chunk_id[4];
  uint32_t chunk_size;
  while (std::fread(chunk_id, 1, 4, f) == 4 &&
         std::fread(&chunk_size, 4, 1, f) == 1) {
    if (!std::memcmp(chunk_id, "fmt ", 4)) {
      // A PCM fmt chunk is >= 16 bytes; anything smaller is malformed and
      // parsing fields at offsets 0-15 would read past the buffer.
      if (chunk_size < 16) {
        std::fclose(f);
        return -3;
      }
      std::vector<uint8_t> fmt(chunk_size);
      if (std::fread(fmt.data(), 1, chunk_size, f) != chunk_size) break;
      audio_format = *reinterpret_cast<uint16_t*>(&fmt[0]);
      num_channels = *reinterpret_cast<uint16_t*>(&fmt[2]);
      sample_rate = *reinterpret_cast<uint32_t*>(&fmt[4]);
      bits = *reinterpret_cast<uint16_t*>(&fmt[14]);
      // RIFF chunks are word-aligned: skip the pad byte after odd sizes.
      if (chunk_size & 1) std::fseek(f, 1, SEEK_CUR);
    } else if (!std::memcmp(chunk_id, "data", 4)) {
      pcm.resize(chunk_size);
      size_t got = std::fread(pcm.data(), 1, chunk_size, f);
      if (got != chunk_size) {
        // truncated file: keep only the bytes actually present (a short
        // waveform, like the Python reader) — resize() zero-filled the
        // buffer, and returning it whole would fabricate a silent tail
        pcm.resize(got);
        break;
      }
      if (chunk_size & 1) std::fseek(f, 1, SEEK_CUR);
    } else {
      std::fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (audio_format != 1 || num_channels == 0 || sample_rate == 0 ||
      pcm.empty() || (bits != 16 && bits != 8 && bits != 32)) {
    return -3;
  }

  const int64_t frames =
      static_cast<int64_t>(pcm.size()) / (num_channels * (bits / 8));
  std::vector<float> mono(frames);
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < num_channels; ++c) {
      int64_t idx = i * num_channels + c;
      if (bits == 16) {
        acc += reinterpret_cast<int16_t*>(pcm.data())[idx] / 32768.0f;
      } else if (bits == 32) {
        acc += reinterpret_cast<int32_t*>(pcm.data())[idx] / 2147483648.0f;
      } else {
        acc += (pcm[idx] - 128) / 128.0f;
      }
    }
    mono[i] = acc / num_channels;
  }

  if (static_cast<uint32_t>(target_sr) == sample_rate) {
    *out_len = frames;
    *out = static_cast<float*>(std::malloc(frames * sizeof(float)));
    std::memcpy(*out, mono.data(), frames * sizeof(float));
    return 0;
  }

  const int64_t new_len =
      static_cast<int64_t>(frames * static_cast<double>(target_sr) / sample_rate);
  float* res = static_cast<float*>(std::malloc(new_len * sizeof(float)));
  const double step = static_cast<double>(sample_rate) / target_sr;
  for (int64_t i = 0; i < new_len; ++i) {
    double pos = i * step;
    int64_t i0 = static_cast<int64_t>(pos);
    double frac = pos - i0;
    int64_t i1 = std::min(i0 + 1, frames - 1);
    res[i] = static_cast<float>(mono[i0] * (1.0 - frac) + mono[i1] * frac);
  }
  *out = res;
  *out_len = new_len;
  return 0;
}

// -------------------------------------------------- batched frame decode

// Decode + shorter-side rescale + center-crop a batch of JPEG files into a
// (n, crop, crop, channels) uint8 buffer using a native thread pool — the
// whole eval visual transform per frame without touching Python.
// Returns the number of failed frames (0 == all good).
int tbn_decode_batch(const char** paths, int n, int channels, int scale_size,
                     int crop_size, uint8_t* out, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const int64_t out_frame = static_cast<int64_t>(crop_size) * crop_size * channels;

  auto worker = [&]() {
    std::vector<uint8_t> file_buf, decode_buf, resize_buf;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;

      FILE* f = std::fopen(paths[i], "rb");
      if (!f) { failures++; continue; }
      std::fseek(f, 0, SEEK_END);
      int64_t size = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      file_buf.resize(size);
      if (std::fread(file_buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        std::fclose(f); failures++; continue;
      }
      std::fclose(f);

      int h, w;
      if (tbn_jpeg_info(file_buf.data(), size, &h, &w) != 0) {
        failures++; continue;
      }
      decode_buf.resize(static_cast<int64_t>(h) * w * channels);
      if (tbn_decode_jpeg(file_buf.data(), size, decode_buf.data(), channels)
          != 0) {
        failures++; continue;
      }

      // shorter-side rescale
      int nh, nw;
      if (h > w) { nw = scale_size; nh = static_cast<int>(scale_size * (int64_t)h / w); }
      else { nh = scale_size; nw = static_cast<int>(scale_size * (int64_t)w / h); }
      const uint8_t* src = decode_buf.data();
      int sh = h, sw = w;
      if (nh != h || nw != w) {
        resize_buf.resize(static_cast<int64_t>(nh) * nw * channels);
        tbn_resize_bilinear(decode_buf.data(), h, w, channels,
                            resize_buf.data(), nh, nw);
        src = resize_buf.data();
        sh = nh; sw = nw;
      }

      // center crop — a rescaled side smaller than the crop would make the
      // offsets negative and read before the buffer; count it as a failure.
      if (sh < crop_size || sw < crop_size) {
        failures++; continue;
      }
      const int y0 = (sh - crop_size) / 2;
      const int x0 = (sw - crop_size) / 2;
      uint8_t* dst = out + i * out_frame;
      for (int y = 0; y < crop_size; ++y) {
        std::memcpy(
            dst + static_cast<int64_t>(y) * crop_size * channels,
            src + ((static_cast<int64_t>(y0 + y)) * sw + x0) * channels,
            static_cast<int64_t>(crop_size) * channels);
      }
    }
  };

  int threads = std::max(1, num_threads);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
