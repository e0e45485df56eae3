// Native batch WAV loader.
//
// Replaces the reference's per-file Python wave loader
// (StatisticalModel/AudioProcessing.py:147-181) for bulk corpus
// ingestion: parses RIFF/PCM16, merges stereo channels by per-sample max
// (AudioProcessing.py:167-175), optionally drops zero samples
// (AudioProcessing.py:176), converts to float32 into a caller-owned
// padded [n, max_samples] buffer, and runs files across a thread pool.
//
// Exposed through ctypes (poccala_tpu_torch/native/__init__.py); the Python
// wave-module path remains the fallback.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavResult {
    int32_t length = -1;    // samples written; -1 = error
    int32_t rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavResult load_one(const char* path, int64_t max_samples, int drop_zeros,
                   float* out) {
    WavResult res;
    FILE* f = std::fopen(path, "rb");
    if (!f) return res;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 44) { std::fclose(f); return res; }
    std::vector<uint8_t> buf((size_t)size);
    if (std::fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
        std::fclose(f);
        return res;
    }
    std::fclose(f);

    if (std::memcmp(buf.data(), "RIFF", 4) || std::memcmp(buf.data() + 8, "WAVE", 4))
        return res;

    uint16_t channels = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* data = nullptr;
    uint32_t data_len = 0;
    size_t pos = 12;
    while (pos + 8 <= (size_t)size) {
        uint32_t chunk_len = rd_u32(&buf[pos + 4]);
        if (!std::memcmp(&buf[pos], "fmt ", 4) && pos + 8 + 16 <= (size_t)size) {
            uint16_t fmt = rd_u16(&buf[pos + 8]);
            channels = rd_u16(&buf[pos + 10]);
            rate = rd_u32(&buf[pos + 12]);
            bits = rd_u16(&buf[pos + 22]);
            if (fmt != 1 || bits != 16) return res;  // PCM16 only
        } else if (!std::memcmp(&buf[pos], "data", 4)) {
            data = &buf[pos + 8];
            data_len = chunk_len;
            if (pos + 8 + data_len > (size_t)size)
                data_len = (uint32_t)(size - pos - 8);
        }
        pos += 8 + chunk_len + (chunk_len & 1);
    }
    if (!data || channels == 0) return res;

    int64_t frames = data_len / (2 * channels);
    int64_t n_out = 0;
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    for (int64_t i = 0; i < frames && n_out < max_samples; ++i) {
        int16_t v = s[i * channels];
        for (int c = 1; c < channels; ++c) {
            int16_t vc = s[i * channels + c];
            if (vc > v) v = vc;  // per-sample max merge
        }
        if (drop_zeros && v == 0) continue;
        out[n_out++] = (float)v;
    }
    for (int64_t i = n_out; i < max_samples; ++i) out[i] = 0.0f;
    res.length = (int32_t)n_out;
    res.rate = (int32_t)rate;
    return res;
}

}  // namespace

extern "C" {

// paths: n C strings; out: [n, max_samples] float32 (caller-allocated);
// lengths/rates: [n] int32.  Returns number of successfully loaded files.
int poccala_load_wav_batch(const char** paths, int n, int64_t max_samples,
                           int drop_zeros, int num_threads, float* out,
                           int32_t* lengths, int32_t* rates) {
    std::atomic<int> next(0), ok(0);
    auto worker = [&]() {
        while (true) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            WavResult r = load_one(paths[i], max_samples, drop_zeros,
                                   out + (int64_t)i * max_samples);
            lengths[i] = r.length;
            rates[i] = r.rate;
            if (r.length >= 0) ok.fetch_add(1);
        }
    };
    if (num_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return ok.load();
}

}  // extern "C"
