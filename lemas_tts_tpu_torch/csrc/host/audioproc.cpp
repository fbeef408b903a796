// audioproc: host-side audio DSP for the lemas-tts-tpu runtime.
//
// Native replacement for the reference's ffmpeg/pydub host path
// (utils_infer.py:306-393 silence ops, torchaudio resample): WAV codec,
// windowed-sinc polyphase resampler, dBFS silence scanning, RMS utilities.
// Exposed as a C ABI consumed via ctypes (lemas_tts_tpu/native/audio.py);
// the Python/numpy implementations remain as fallbacks.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr double kPi = 3.14159265358979323846;

double dbfs(const float* x, int64_t n) {
  if (n <= 0) return -1e30;
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += double(x[i]) * double(x[i]);
  double rms = std::sqrt(acc / double(n));
  if (rms <= 0.0) return -1e30;
  return 20.0 * std::log10(rms);
}

}  // namespace

// ----------------------------------------------------------------- WAV codec

// Parse a RIFF/WAVE blob. Supports PCM 16/24/32-bit and IEEE float32.
// Returns 0 on success; fills *out (interleaved -> planar channel-major
// float32), caller-allocated via audioproc_wav_info first.
API int audioproc_wav_info(const uint8_t* buf, int64_t len, int32_t* channels,
                           int32_t* sample_rate, int64_t* frames) {
  if (len < 44 || std::memcmp(buf, "RIFF", 4) || std::memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int fmt = 0, chans = 0, rate = 0, bits = 0;
  int64_t data_len = -1;
  while (pos + 8 <= len) {
    const uint8_t* ck = buf + pos;
    uint32_t ck_len;
    std::memcpy(&ck_len, ck + 4, 4);
    // never read past the buffer: each field access below is bounds-checked
    // against the bytes actually present, not the header's claimed length
    if (!std::memcmp(ck, "fmt ", 4) && ck_len >= 16 && pos + 24 <= len) {
      uint16_t v16;
      std::memcpy(&v16, ck + 8, 2); fmt = v16;
      std::memcpy(&v16, ck + 10, 2); chans = v16;
      uint32_t v32;
      std::memcpy(&v32, ck + 12, 4); rate = int(v32);
      std::memcpy(&v16, ck + 22, 2); bits = v16;
      if (fmt == 0xFFFE && ck_len >= 40 && pos + 34 <= len) {  // EXTENSIBLE
        std::memcpy(&v16, ck + 32, 2); fmt = v16;  // SubFormat GUID head
      }
    } else if (!std::memcmp(ck, "data", 4)) {
      // never trust the header: clamp to the bytes actually present
      // (truncated/malicious files would otherwise cause out-of-bounds reads)
      const int64_t remaining = len - (pos + 8);
      data_len = std::min<int64_t>(ck_len, remaining < 0 ? 0 : remaining);
      break;
    }
    pos += 8 + ck_len + (ck_len & 1);
  }
  if (fmt == 0 || chans == 0 || data_len < 0) return -2;
  int bytes = bits / 8;
  if (bytes == 0) return -3;
  *channels = chans;
  *sample_rate = rate;
  *frames = data_len / (bytes * chans);
  return (fmt == 1 && (bits == 16 || bits == 24 || bits == 32)) ||
                 (fmt == 3 && bits == 32)
             ? 0
             : -4;
}

API int audioproc_wav_decode(const uint8_t* buf, int64_t len, float* out) {
  int32_t chans, rate;
  int64_t frames;
  int rc = audioproc_wav_info(buf, len, &chans, &rate, &frames);
  if (rc != 0) return rc;
  // find fmt/data again (cheap)
  int64_t pos = 12;
  int fmt = 1, bits = 16;
  const uint8_t* data = nullptr;
  while (pos + 8 <= len) {
    const uint8_t* ck = buf + pos;
    uint32_t ck_len;
    std::memcpy(&ck_len, ck + 4, 4);
    if (!std::memcmp(ck, "fmt ", 4) && ck_len >= 16 && pos + 24 <= len) {
      uint16_t v16;
      std::memcpy(&v16, ck + 8, 2); fmt = v16;
      std::memcpy(&v16, ck + 22, 2); bits = v16;
      if (fmt == 0xFFFE && ck_len >= 40 && pos + 34 <= len) {
        std::memcpy(&v16, ck + 32, 2);
        fmt = v16;
      }
    } else if (!std::memcmp(ck, "data", 4)) {
      data = ck + 8;
      break;
    }
    pos += 8 + ck_len + (ck_len & 1);
  }
  if (!data) return -2;
  const int64_t n = frames * chans;
  if (fmt == 3 && bits == 32) {
    for (int64_t i = 0; i < n; ++i) {
      float v;
      std::memcpy(&v, data + 4 * i, 4);
      out[(i % chans) * frames + i / chans] = v;
    }
  } else if (bits == 16) {
    for (int64_t i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, data + 2 * i, 2);
      out[(i % chans) * frames + i / chans] = float(v) / 32768.0f;
    }
  } else if (bits == 24) {
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* p = data + 3 * i;
      int32_t v = (int32_t(p[2]) << 24 | int32_t(p[1]) << 16 | int32_t(p[0]) << 8) >> 8;
      out[(i % chans) * frames + i / chans] = float(v) / 8388608.0f;
    }
  } else if (bits == 32) {
    for (int64_t i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, data + 4 * i, 4);
      out[(i % chans) * frames + i / chans] = float(double(v) / 2147483648.0);
    }
  } else {
    return -4;
  }
  return 0;
}

// Encode mono/planar float32 -> PCM16 WAV. Returns bytes written (query with
// out=nullptr).
API int64_t audioproc_wav_encode(const float* x, int64_t frames, int32_t channels,
                                 int32_t sample_rate, uint8_t* out) {
  const int64_t data_len = frames * channels * 2;
  const int64_t total = 44 + data_len;
  if (!out) return total;
  std::memcpy(out, "RIFF", 4);
  uint32_t v32 = uint32_t(total - 8);
  std::memcpy(out + 4, &v32, 4);
  std::memcpy(out + 8, "WAVEfmt ", 8);
  v32 = 16; std::memcpy(out + 16, &v32, 4);
  uint16_t v16 = 1; std::memcpy(out + 20, &v16, 2);
  v16 = uint16_t(channels); std::memcpy(out + 22, &v16, 2);
  v32 = uint32_t(sample_rate); std::memcpy(out + 24, &v32, 4);
  v32 = uint32_t(sample_rate * channels * 2); std::memcpy(out + 28, &v32, 4);
  v16 = uint16_t(channels * 2); std::memcpy(out + 32, &v16, 2);
  v16 = 16; std::memcpy(out + 34, &v16, 2);
  std::memcpy(out + 36, "data", 4);
  v32 = uint32_t(data_len); std::memcpy(out + 40, &v32, 4);
  uint8_t* d = out + 44;
  for (int64_t f = 0; f < frames; ++f) {
    for (int32_t c = 0; c < channels; ++c) {
      float v = x[c * frames + f];
      if (v > 0.999969f) v = 0.999969f;
      if (v < -1.0f) v = -1.0f;
      int16_t s = int16_t(std::lrintf(v * 32768.0f));
      std::memcpy(d, &s, 2);
      d += 2;
    }
  }
  return total;
}

// ------------------------------------------------------------- resampling

// Polyphase windowed-sinc resampler matching torchaudio.functional.resample
// (sinc_interp_hann, lowpass_filter_width=6, rolloff=0.99) and the JAX
// implementation in lemas_tts_tpu/ops/resample.py exactly.
API int64_t audioproc_resample_len(int64_t n, int32_t orig, int32_t target) {
  auto gcd = [](int64_t a, int64_t b) { while (b) { int64_t t = a % b; a = b; b = t; } return a; };
  const int64_t g = gcd(orig, target);
  const int64_t o = orig / g, t = target / g;
  return (n * t + o - 1) / o;  // ceil(t*n/o)
}

API int audioproc_resample(const float* x, int64_t n, int32_t orig,
                           int32_t target, float* out) {
  if (orig == target) {
    std::memcpy(out, x, sizeof(float) * size_t(n));
    return 0;
  }
  auto gcd = [](int a, int b) { while (b) { int t = a % b; a = b; b = t; } return a; };
  const int g = gcd(orig, target);
  const int o = orig / g, t = target / g;
  const int lpfw = 6;
  const double rolloff = 0.99;
  const double base = double(std::min(o, t)) * rolloff;
  const int width = int(std::ceil(double(lpfw) * o / base));
  const int K = 2 * width + o;  // taps per phase
  const int64_t out_n = audioproc_resample_len(n, orig, target);

  // kernel bank [t phases][K taps], identical math to _sinc_kernel()
  std::vector<double> kernel(size_t(t) * K);
  for (int i = 0; i < t; ++i) {
    for (int k = 0; k < K; ++k) {
      double tt = (-double(i) / t + double(k - width) / o) * base;
      if (tt < -lpfw) tt = -lpfw;
      if (tt > lpfw) tt = lpfw;
      const double w = std::pow(std::cos(tt * kPi / lpfw / 2.0), 2.0);
      const double tp = tt * kPi;
      const double s = tp == 0.0 ? 1.0 : std::sin(tp) / tp;
      kernel[size_t(i) * K + k] = w * s * base / o;
    }
  }

  // out[m] = sum_k kernel[m % t][k] * x[(m / t) * o + k - width]
  for (int64_t m = 0; m < out_n; ++m) {
    const int i = int(m % t);
    const int64_t off = (m / t) * o - width;
    const double* kr = &kernel[size_t(i) * K];
    double acc = 0.0;
    const int64_t k_lo = off < 0 ? -off : 0;
    const int64_t k_hi = std::min<int64_t>(K, n - off);
    for (int64_t k = k_lo; k < k_hi; ++k) acc += kr[k] * double(x[off + k]);
    out[m] = float(acc);
  }
  return 0;
}

// ---------------------------------------------------------- silence scanning

// dBFS over a sliding window: writes one dBFS value per seek position.
// Mirrors detect_silence (infer/audio_prep.py:32-59 / pydub logic).
API int64_t audioproc_scan_dbfs(const float* x, int64_t n, int32_t sr,
                                int32_t win_ms, int32_t seek_ms, float* out,
                                int64_t out_cap) {
  const int64_t length_ms = n * 1000 / sr;
  if (length_ms < win_ms) return 0;
  const int64_t win = int64_t(win_ms) * sr / 1000;
  const int64_t last_start = length_ms - win_ms;
  int64_t count = 0;
  for (int64_t start_ms = 0; start_ms <= last_start; start_ms += seek_ms) {
    if (count >= out_cap) break;
    const int64_t s = start_ms * sr / 1000;
    const int64_t e = std::min(n, s + win);
    out[count++] = float(dbfs(x + s, e - s));
  }
  return count;
}

API double audioproc_rms(const float* x, int64_t n) {
  if (n <= 0) return 0.0;
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += double(x[i]) * double(x[i]);
  return std::sqrt(acc / double(n));
}

API const char* audioproc_version() { return "audioproc 1.0 (lemas-tts-tpu)"; }
