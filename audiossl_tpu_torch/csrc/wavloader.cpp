// Native batch WAV loader: decode + mono-downmix + resample + random window.
//
// The port's own copy of the JAX package's host loader (data/native.py builds
// it with g++ into .torch_build/). It replaces the reference's
// dataloader-worker decode path (librosa.core.load -> libsndfile/audioread,
// src/dataset/upstream_dataset.py:55). The Python side only sees fixed-shape
// float32 batches; everything IO/parse/resample runs here on a std::thread
// pool, keeping the host CPUs feeding the card without Python-object overhead.
//
// Exposed C ABI (ctypes):
//   int avl_decode(const char* path, int target_sr, float* out, long cap);
//       -> number of samples written, or -errno-style negative code
//   int avl_load_batch(const char** paths, int n, int clip_samples,
//                      int target_sr, unsigned long long seed, int n_threads,
//                      float* out /* [n, clip_samples] */);
//       -> 0 on success, else index of first failed file + 1, negated
//
// Window semantics match extract_window (src/utils/utils.py:166-182):
// shorter clips are zero-padded symmetrically (extra sample right), longer
// clips get a uniform random crop (seeded per (seed, index) for determinism).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Wav {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

bool parse_wav(const uint8_t* buf, size_t len, Wav* out) {
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= len) {
    uint32_t chunk_len = rd_u32(buf + pos + 4);
    const uint8_t* body = buf + pos + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);
    if (memcmp(buf + pos, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (memcmp(buf + pos, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are 2-byte aligned
  }
  if (!data || channels == 0 || rate == 0) return false;
  if (fmt == 0xFFFE) fmt = 1;  // extensible: treat as PCM (common case)

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return false;
  size_t n_frames = data_len / (bytes_per * channels);
  out->sample_rate = (int)rate;
  out->samples.resize(n_frames);
  const float inv_ch = 1.0f / channels;

  for (size_t i = 0; i < n_frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      float v = 0.0f;
      if (fmt == 3 && bits == 32) {  // IEEE float
        float f;
        memcpy(&f, p, 4);
        v = f;
      } else if (bits == 16) {
        int16_t s = (int16_t)rd_u16(p);
        v = s / 32768.0f;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0f;
      } else if (bits == 24) {
        int32_t s = (int32_t)(((uint32_t)p[0] << 8) | ((uint32_t)p[1] << 16) |
                              ((uint32_t)p[2] << 24)) >> 8;
        v = s / 8388608.0f;
      } else if (bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0f;
      } else {
        return false;
      }
      acc += v;
    }
    out->samples[i] = acc * inv_ch;
  }
  return true;
}

// Windowed-sinc resampler (Hann, 16 taps/side) — quality comparable to the
// polyphase default used host-side; most corpora are already 16 kHz.
void resample(const std::vector<float>& in, int sr_in, int sr_out,
              std::vector<float>* out) {
  if (sr_in == sr_out) {
    *out = in;
    return;
  }
  const double ratio = (double)sr_out / sr_in;
  const size_t n_out = (size_t)(in.size() * ratio);
  out->resize(n_out);
  const int taps = 16;
  const double cutoff = ratio < 1.0 ? ratio : 1.0;
  for (size_t j = 0; j < n_out; ++j) {
    const double t = j / ratio;  // position in input samples
    const long center = (long)t;
    double acc = 0.0, wsum = 0.0;
    for (long k = center - taps; k <= center + taps; ++k) {
      if (k < 0 || k >= (long)in.size()) continue;
      const double x = (t - k) * cutoff;
      double sinc = x == 0.0 ? 1.0 : sin(3.14159265358979323846 * x) /
                                         (3.14159265358979323846 * x);
      const double u = (t - k) / (taps + 1.0);
      if (u <= -1.0 || u >= 1.0) continue;
      const double hann = 0.5 + 0.5 * cos(3.14159265358979323846 * u);
      const double w = sinc * hann * cutoff;
      acc += in[k] * w;
      wsum += w;
    }
    // normalize by the (possibly edge-truncated) window weight sum so
    // boundary samples keep unity gain
    (*out)[j] = wsum != 0.0 ? (float)(acc / wsum) : 0.0f;
  }
}

// offset/length select a byte range (tar-shard member); length < 0 = to EOF
bool read_file_range(const char* path, long long offset, long long length,
                     std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long long end = ftell(f);
  if (offset < 0 || offset > end) {
    fclose(f);
    return false;
  }
  long long n = length < 0 ? end - offset : length;
  if (n <= 0 || offset + n > end) {
    fclose(f);
    return false;
  }
  fseek(f, (long)offset, SEEK_SET);
  buf->resize((size_t)n);
  size_t got = fread(buf->data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  return read_file_range(path, 0, -1, buf);
}

// extract_window semantics: pad-center (extra right) or uniform random crop
void window_into(const std::vector<float>& wave, int clip, uint64_t seed,
                 float* out) {
  const long n = (long)wave.size();
  if (n < clip) {
    const long adj = clip - n;
    const long half = adj / 2;
    memset(out, 0, sizeof(float) * clip);
    memcpy(out + half, wave.data(), sizeof(float) * n);
    return;
  }
  std::mt19937_64 rng(seed);
  const long maxs = n - clip;
  const long start = maxs > 0 ? (long)(rng() % (uint64_t)(maxs + 1)) : 0;
  memcpy(out, wave.data() + start, sizeof(float) * clip);
}

}  // namespace

extern "C" {

int avl_decode(const char* path, int target_sr, float* out, long cap) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  Wav wav;
  if (!parse_wav(buf.data(), buf.size(), &wav)) return -2;
  std::vector<float> res;
  resample(wav.samples, wav.sample_rate, target_sr, &res);
  const long n = (long)res.size() < cap ? (long)res.size() : cap;
  memcpy(out, res.data(), sizeof(float) * n);
  return (int)n;
}

// offsets/lengths may be null (whole files) or per-clip byte ranges into
// tar shards (data/tar.py resolves member -> (offset, length))
int avl_load_batch2(const char** paths, const long long* offsets,
                    const long long* lengths, int n, int clip_samples,
                    int target_sr, unsigned long long seed, int n_threads,
                    float* out) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    Wav wav;
    std::vector<float> res;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      buf.clear();
      const long long off = offsets ? offsets[i] : 0;
      const long long len = lengths ? lengths[i] : -1;
      if (!read_file_range(paths[i], off, len, &buf) ||
          !parse_wav(buf.data(), buf.size(), &wav)) {
        failed.store(i + 1);
        memset(out + (size_t)i * clip_samples, 0, sizeof(float) * clip_samples);
        continue;
      }
      resample(wav.samples, wav.sample_rate, target_sr, &res);
      window_into(res, clip_samples, seed * 0x9E3779B97F4A7C15ull + i,
                  out + (size_t)i * clip_samples);
    }
  };
  const int nt = n_threads > 0 ? n_threads : 8;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return -failed.load();
}

int avl_load_batch(const char** paths, int n, int clip_samples, int target_sr,
                   unsigned long long seed, int n_threads, float* out) {
  return avl_load_batch2(paths, nullptr, nullptr, n, clip_samples, target_sr,
                         seed, n_threads, out);
}
}
