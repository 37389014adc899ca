// Native runtime components for webaudio_modem_tpu_torch (a copy of the
// repository's native/modem_native.cpp, built by native/__init__.py).
//
// The reference runs its whole runtime in JS; the port keeps the
// compute path on the GPU (PyTorch and hand-written CUDA kernels) and
// provides C++ for the host runtime's hot byte-level paths: CRC-16 and a per-channel incremental
// XModem deframer used when draining a 4096-channel farm's decoded
// byte streams (parsing SOH|SEQ|~SEQ|LEN|PAYLOAD|CRC16 frames and bare
// control bytes without bouncing through per-byte Python).
//
// Wire format per reference src/transports/xmodem/types.ts /
// packet.ts: CRC-16-CCITT-FALSE over payload only, big-endian on wire.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

uint16_t crc_table[256];
bool crc_table_ready = false;

void init_crc_table() {
    if (crc_table_ready) return;
    for (int byte = 0; byte < 256; ++byte) {
        uint16_t crc = static_cast<uint16_t>(byte << 8);
        for (int i = 0; i < 8; ++i) {
            crc = (crc & 0x8000) ? static_cast<uint16_t>((crc << 1) ^ 0x1021)
                                 : static_cast<uint16_t>(crc << 1);
        }
        crc_table[byte] = crc;
    }
    crc_table_ready = true;
}

uint16_t crc16_ccitt(const uint8_t* data, size_t len) {
    init_crc_table();
    uint16_t crc = 0xFFFF;
    for (size_t i = 0; i < len; ++i) {
        crc = static_cast<uint16_t>((crc << 8) ^
                                    crc_table[((crc >> 8) ^ data[i]) & 0xFF]);
    }
    return crc;
}

constexpr uint8_t SOH = 0x01;
constexpr uint8_t EOT = 0x04;
constexpr uint8_t ACK = 0x06;
constexpr uint8_t NAK = 0x15;

// Poll result codes
constexpr int POLL_EMPTY = 0;       // need more bytes
constexpr int POLL_PACKET = 1;      // complete valid data packet
constexpr int POLL_CONTROL = 2;     // control byte (out[0] = byte)
constexpr int POLL_BAD_SEQ = -1;    // seq + ~seq mismatch (header consumed)
constexpr int POLL_BAD_CRC = -2;    // CRC mismatch (frame consumed)
constexpr int POLL_JUNK = -3;       // non-frame byte skipped (out[0] = byte)

struct Channel {
    std::deque<uint8_t> buf;
};

struct Deframer {
    std::vector<Channel> channels;
    size_t total_pending = 0;  // sum of all channel buffer sizes
};

}  // namespace

extern "C" {

uint16_t wam_crc16(const uint8_t* data, size_t len) {
    return crc16_ccitt(data, len);
}

// Batch CRC over `count` equal-stride frames — one call per farm drain.
void wam_crc16_batch(const uint8_t* data, size_t frame_len, size_t count,
                     uint16_t* out) {
    for (size_t i = 0; i < count; ++i) {
        out[i] = crc16_ccitt(data + i * frame_len, frame_len);
    }
}

void* wam_deframer_new(int n_channels) {
    auto* d = new Deframer();
    d->channels.resize(static_cast<size_t>(n_channels));
    return d;
}

void wam_deframer_free(void* handle) {
    delete static_cast<Deframer*>(handle);
}

void wam_deframer_push(void* handle, int channel, const uint8_t* data,
                       size_t len) {
    auto* d = static_cast<Deframer*>(handle);
    auto& ch = d->channels[static_cast<size_t>(channel)];
    ch.buf.insert(ch.buf.end(), data, data + len);
    d->total_pending += len;
}

size_t wam_deframer_total_pending(void* handle) {
    return static_cast<Deframer*>(handle)->total_pending;
}

size_t wam_deframer_pending(void* handle, int channel) {
    return static_cast<Deframer*>(handle)->channels[
        static_cast<size_t>(channel)].buf.size();
}

void wam_deframer_reset(void* handle, int channel) {
    auto* d = static_cast<Deframer*>(handle);
    auto& buf = d->channels[static_cast<size_t>(channel)].buf;
    d->total_pending -= buf.size();
    buf.clear();
}

// Try to extract the next event from a channel's stream.
// On POLL_PACKET: out[0]=seq, out[1]=len, out[2..2+len)=payload.
// On POLL_CONTROL / POLL_JUNK: out[0] = the byte.
// out must hold >= 2 + 255 bytes.
int wam_deframer_poll(void* handle, int channel, uint8_t* out) {
    auto* d = static_cast<Deframer*>(handle);
    auto& buf = d->channels[static_cast<size_t>(channel)].buf;
    size_t before = buf.size();
    // single exit below keeps total_pending consistent with every
    // consuming branch
    int code = [&]() -> int {
    while (!buf.empty()) {
        uint8_t first = buf.front();
        if (first == EOT || first == ACK || first == NAK) {
            buf.pop_front();
            out[0] = first;
            return POLL_CONTROL;
        }
        if (first != SOH) {
            buf.pop_front();
            out[0] = first;
            return POLL_JUNK;
        }
        if (buf.size() < 4) return POLL_EMPTY;  // header incomplete
        uint8_t seq = buf[1], nseq = buf[2], len = buf[3];
        if (((seq + nseq) & 0xFF) != 0xFF) {
            // header corrupt — drop the SOH, resync on next byte
            buf.erase(buf.begin(), buf.begin() + 4);
            return POLL_BAD_SEQ;
        }
        size_t total = 4u + len + 2u;
        if (buf.size() < total) return POLL_EMPTY;
        std::vector<uint8_t> payload(buf.begin() + 4, buf.begin() + 4 + len);
        uint16_t wire_crc = static_cast<uint16_t>(
            (buf[4 + len] << 8) | buf[4 + len + 1]);
        buf.erase(buf.begin(), buf.begin() + static_cast<long>(total));
        if (crc16_ccitt(payload.data(), payload.size()) != wire_crc) {
            return POLL_BAD_CRC;
        }
        out[0] = seq;
        out[1] = len;
        std::memcpy(out + 2, payload.data(), payload.size());
        return POLL_PACKET;
    }
    return POLL_EMPTY;
    }();
    d->total_pending -= before - buf.size();
    return code;
}

// Drain a whole farm quantum in ONE call (the batched entry point the
// 4096-session hub uses — one ctypes crossing per quantum instead of
// three per active channel).
//
// vals:   [n_channels, stride] row-major decoded bytes per channel
// counts: [n_channels] valid bytes per row (0 rows are skipped)
// Events are appended as fixed 4-int32 records {channel, code, a, len}
// to ev (capacity ev_cap records); `a` is seq for PACKET, the byte for
// CONTROL/JUNK, 0 otherwise.  PACKET payloads are appended back-to-
// back to payloads (capacity pay_cap; offsets are the running sum of
// PACKET lens).  Returns the record count, or -1 if a buffer would
// overflow (callers size with ev_cap >= pushed + previously pending
// bytes, which one event per byte can never exceed).
int wam_deframer_drain(void* handle, const uint8_t* vals, size_t stride,
                       const int32_t* counts, int n_channels,
                       int32_t* ev, size_t ev_cap,
                       uint8_t* payloads, size_t pay_cap) {
    auto* d = static_cast<Deframer*>(handle);
    size_t n_ev = 0;
    size_t pay_used = 0;
    uint8_t scratch[2 + 255];
    for (int c = 0; c < n_channels; ++c) {
        int32_t cnt = counts[c];
        if (cnt > 0) {
            wam_deframer_push(handle, c, vals + c * stride,
                              static_cast<size_t>(cnt));
        }
        if (d->channels[static_cast<size_t>(c)].buf.empty()) continue;
        int code;
        while ((code = wam_deframer_poll(handle, c, scratch)) !=
               POLL_EMPTY) {
            if (n_ev >= ev_cap) return -1;
            int32_t a = 0;
            int32_t len = 0;
            if (code == POLL_PACKET) {
                a = scratch[0];
                len = scratch[1];
                if (pay_used + static_cast<size_t>(len) > pay_cap)
                    return -1;
                std::memcpy(payloads + pay_used, scratch + 2,
                            static_cast<size_t>(len));
                pay_used += static_cast<size_t>(len);
            } else if (code == POLL_CONTROL || code == POLL_JUNK) {
                a = scratch[0];
            }
            ev[n_ev * 4 + 0] = c;
            ev[n_ev * 4 + 1] = code;
            ev[n_ev * 4 + 2] = a;
            ev[n_ev * 4 + 3] = len;
            ++n_ev;
        }
    }
    return static_cast<int>(n_ev);
}

}  // extern "C"
