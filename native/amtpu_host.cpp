// Native host runtime for audio_modem_tpu.
//
// The device owns every sample-rate DSP loop; what remains on the host is
// control-plane byte work and the few genuinely sequential per-sample
// recurrences of the streaming ingest path. Those live here:
//
//   ema_dc_removal   the streaming receiver's DC tracker (app.js:750-755):
//                    dc = a*dc + (1-a)*x[i]; y[i] = x[i] - dc.  Sequential
//                    by definition; C++ runs it at memory bandwidth.
//   crc32_slice8     CRC-32 (IEEE, reflected) with slice-by-8 tables —
//                    frame CRC checks for high-rate multi-stream ingest.
//   pack_bits / unpack_bits   MSB-first bit<->byte (modem.js:460-476).
//   majority_vote    repetition decode, tie -> 1 (modem.js:487-495).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstddef>

extern "C" {

void ema_dc_removal(const float* x, float* y, int64_t n, double alpha,
                    double* dc_state) {
    double dc = *dc_state;
    const double one_minus = 1.0 - alpha;
    for (int64_t i = 0; i < n; ++i) {
        dc = alpha * dc + one_minus * static_cast<double>(x[i]);
        y[i] = static_cast<float>(static_cast<double>(x[i]) - dc);
    }
    *dc_state = dc;
}

// Batched variant for the multi-stream runtime: x/y are [n_streams, n],
// dc_states is [n_streams]; each row is an independent recurrence.
void ema_dc_removal_batch(const float* x, float* y, int64_t n_streams,
                          int64_t n, double alpha, double* dc_states) {
    for (int64_t s = 0; s < n_streams; ++s)
        ema_dc_removal(x + s * n, y + s * n, n, alpha, dc_states + s);
}

namespace {
struct Crc8Tables {
    uint32_t t[8][256];
    Crc8Tables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int j = 0; j < 8; ++j)
                c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int k = 1; k < 8; ++k)
                t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
    }
};
const Crc8Tables kCrc;
}  // namespace

uint32_t crc32_slice8(const uint8_t* data, int64_t n, uint32_t seed) {
    uint32_t c = seed ^ 0xFFFFFFFFu;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        c ^= static_cast<uint32_t>(data[i]) |
             (static_cast<uint32_t>(data[i + 1]) << 8) |
             (static_cast<uint32_t>(data[i + 2]) << 16) |
             (static_cast<uint32_t>(data[i + 3]) << 24);
        c = kCrc.t[7][c & 0xFF] ^ kCrc.t[6][(c >> 8) & 0xFF] ^
            kCrc.t[5][(c >> 16) & 0xFF] ^ kCrc.t[4][(c >> 24) & 0xFF] ^
            kCrc.t[3][data[i + 4]] ^ kCrc.t[2][data[i + 5]] ^
            kCrc.t[1][data[i + 6]] ^ kCrc.t[0][data[i + 7]];
    }
    for (; i < n; ++i)
        c = kCrc.t[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

void unpack_bits(const uint8_t* bytes, int8_t* bits, int64_t n_bytes) {
    for (int64_t i = 0; i < n_bytes; ++i) {
        const uint8_t b = bytes[i];
        int8_t* o = bits + i * 8;
        o[0] = (b >> 7) & 1; o[1] = (b >> 6) & 1; o[2] = (b >> 5) & 1;
        o[3] = (b >> 4) & 1; o[4] = (b >> 3) & 1; o[5] = (b >> 2) & 1;
        o[6] = (b >> 1) & 1; o[7] = b & 1;
    }
}

void pack_bits(const int8_t* bits, uint8_t* bytes, int64_t n_bytes) {
    for (int64_t i = 0; i < n_bytes; ++i) {
        const int8_t* s = bits + i * 8;
        bytes[i] = static_cast<uint8_t>(
            ((s[0] & 1) << 7) | ((s[1] & 1) << 6) | ((s[2] & 1) << 5) |
            ((s[3] & 1) << 4) | ((s[4] & 1) << 3) | ((s[5] & 1) << 2) |
            ((s[6] & 1) << 1) | (s[7] & 1));
    }
}

void majority_vote(const int8_t* bits, int8_t* out, int64_t n_groups, int rep) {
    for (int64_t i = 0; i < n_groups; ++i) {
        int sum = 0;
        const int8_t* g = bits + i * rep;
        for (int j = 0; j < rep; ++j) sum += g[j];
        out[i] = (2 * sum >= rep) ? 1 : 0;  // tie -> 1 (modem.js:493)
    }
}

}  // extern "C"
