// Native PCM codec hot paths (16/24-bit decode/encode).
//
// Host-side equivalent of the reference's c_lib AudioSamples codec work
// (SURVEY.md §2.2) for the conversions that dominate host time on large
// files. Exposed through a plain C ABI and loaded via ctypes
// (native/pcm_codec.py); NumPy remains the fallback.
//
// Semantics must match codec.py exactly:
//   decode: x = pcm / 2^(bits-1)
//   encode: pcm = clip(rint(x * 2^(bits-1)), -2^(bits-1), 2^(bits-1)-1)
// rint uses the current rounding mode (round-half-even), matching np.rint.

#include <cmath>
#include <cstdint>

extern "C" {

void decode_pcm16(const uint8_t* in, int64_t n, int big_endian, float* out) {
    const float scale = 1.0f / 32768.0f;
    if (big_endian) {
        for (int64_t i = 0; i < n; ++i) {
            int16_t v = static_cast<int16_t>((in[2 * i] << 8) | in[2 * i + 1]);
            out[i] = static_cast<float>(v) * scale;
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            int16_t v = static_cast<int16_t>(in[2 * i] | (in[2 * i + 1] << 8));
            out[i] = static_cast<float>(v) * scale;
        }
    }
}

void decode_pcm24(const uint8_t* in, int64_t n, int big_endian, float* out) {
    const float scale = 1.0f / 8388608.0f;
    if (big_endian) {
        for (int64_t i = 0; i < n; ++i) {
            int32_t v = (in[3 * i] << 16) | (in[3 * i + 1] << 8) | in[3 * i + 2];
            v = (v ^ 0x800000) - 0x800000;  // sign-extend bit 23
            out[i] = static_cast<float>(v) * scale;
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            int32_t v = in[3 * i] | (in[3 * i + 1] << 8) | (in[3 * i + 2] << 16);
            v = (v ^ 0x800000) - 0x800000;
            out[i] = static_cast<float>(v) * scale;
        }
    }
}

static inline int32_t quantize(float x, double full, double lo, double hi) {
    double v = std::nearbyint(static_cast<double>(x) * full);
    if (v < lo) v = lo;
    if (v > hi) v = hi;
    return static_cast<int32_t>(v);
}

void encode_pcm16(const float* in, int64_t n, int big_endian, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t v = quantize(in[i], 32768.0, -32768.0, 32767.0);
        if (big_endian) {
            out[2 * i] = static_cast<uint8_t>((v >> 8) & 0xFF);
            out[2 * i + 1] = static_cast<uint8_t>(v & 0xFF);
        } else {
            out[2 * i] = static_cast<uint8_t>(v & 0xFF);
            out[2 * i + 1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        }
    }
}

void encode_pcm24(const float* in, int64_t n, int big_endian, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t v = quantize(in[i], 8388608.0, -8388608.0, 8388607.0);
        if (big_endian) {
            out[3 * i] = static_cast<uint8_t>((v >> 16) & 0xFF);
            out[3 * i + 1] = static_cast<uint8_t>((v >> 8) & 0xFF);
            out[3 * i + 2] = static_cast<uint8_t>(v & 0xFF);
        } else {
            out[3 * i] = static_cast<uint8_t>(v & 0xFF);
            out[3 * i + 1] = static_cast<uint8_t>((v >> 8) & 0xFF);
            out[3 * i + 2] = static_cast<uint8_t>((v >> 16) & 0xFF);
        }
    }
}

// Peak scan (|max|) used by normalization on the host fallback path.
float peak_abs_f32(const float* in, int64_t n) {
    float m = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float a = in[i] < 0 ? -in[i] : in[i];
        if (a > m) m = a;
    }
    return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused planar paths: codec + (de)interleave in ONE pass over the bytes,
// fanned out across std::threads over contiguous frame ranges — the host
// analog of the reference's per-channel thread fan-out
// (the reference's ProcessFile.cp:60-83). The Python layer previously paid
// a separate NumPy transpose pass for the planar<->interleaved relayout;
// these read/write it in place. Thread ranges touch disjoint output bytes,
// so no synchronization beyond join (same safety-by-construction argument
// as the reference's range split). ctypes releases the GIL for the call,
// so batch-mode reader/writer workers overlap fully with these.

#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Default fan-out: floor(0.7 x cores), fallback 4 — the reference's thread
// default (the reference's main.cp:75-76) — capped by work size.
int resolve_threads(int requested, int64_t frames) {
    int t = requested;
    if (t <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        t = hc ? static_cast<int>(hc * 0.7) : 4;
    }
    // At least ~64k frames per thread, or the spawn cost dominates.
    int64_t max_useful = std::max<int64_t>(1, frames / 65536);
    return static_cast<int>(std::min<int64_t>(t, max_useful));
}

template <typename Fn>
void parallel_frames(int64_t frames, int threads, Fn fn) {
    int t = resolve_threads(threads, frames);
    if (t <= 1) {
        fn(0, frames);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(t);
    int64_t chunk = frames / t;
    for (int i = 0; i < t; ++i) {
        int64_t lo = i * chunk;
        int64_t hi = (i == t - 1) ? frames : lo + chunk;
        pool.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

inline int32_t load_pcm(const uint8_t* p, int bps, bool be) {
    if (bps == 2) {
        return be ? static_cast<int16_t>((p[0] << 8) | p[1])
                  : static_cast<int16_t>(p[0] | (p[1] << 8));
    }
    int32_t v = be ? ((p[0] << 16) | (p[1] << 8) | p[2])
                   : (p[0] | (p[1] << 8) | (p[2] << 16));
    return (v ^ 0x800000) - 0x800000;  // sign-extend bit 23
}

// 24-bit LE fast path: one unaligned 32-bit load, then shift-pair to drop
// the stray high byte and sign-extend bit 23 (x86/ARM allow unaligned
// loads; callers guarantee p+3 is readable). ~3x fewer ops than the
// byte-or form.
inline int32_t load_pcm24le_u32(const uint8_t* p) {
    uint32_t u;
    __builtin_memcpy(&u, p, 4);
    return static_cast<int32_t>(u << 8) >> 8;
}

inline void store_pcm(uint8_t* p, int32_t v, int bps, bool be) {
    if (bps == 2) {
        if (be) {
            p[0] = static_cast<uint8_t>((v >> 8) & 0xFF);
            p[1] = static_cast<uint8_t>(v & 0xFF);
        } else {
            p[0] = static_cast<uint8_t>(v & 0xFF);
            p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        }
    } else if (be) {
        p[0] = static_cast<uint8_t>((v >> 16) & 0xFF);
        p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        p[2] = static_cast<uint8_t>(v & 0xFF);
    } else {
        p[0] = static_cast<uint8_t>(v & 0xFF);
        p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        p[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
    }
}

}  // namespace

extern "C" {

// Interleaved PCM bytes -> planar float32 [channels][frames].
// bits in {16, 24}; threads <= 0 means the reference's 0.7 x cores default.
void decode_pcm_planar(const uint8_t* in, int64_t frames, int channels,
                       int bits, int big_endian, int threads, float* out) {
    const int bps = bits / 8;
    const float scale = bits == 16 ? (1.0f / 32768.0f) : (1.0f / 8388608.0f);
    const bool be = big_endian != 0;
    // The 24-bit LE u32-load trick reads one byte past sample i's 3 bytes;
    // that byte exists for every sample except the very last one of the
    // buffer, which the slow path handles. The trick also assumes a
    // little-endian HOST (memcpy-u32 then shift-pair); `be` only describes
    // the FILE's byte order, so gate on the host order at compile time and
    // let big-endian hosts take the byte-or path.
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__)
    const bool fast24 = (bps == 3) && !be;
#else
    const bool fast24 = false;
#endif
    parallel_frames(frames, threads, [=](int64_t lo, int64_t hi) {
        for (int c = 0; c < channels; ++c) {
            const uint8_t* src = in + (lo * channels + c) * bps;
            float* dst = out + c * frames + lo;
            const int64_t stride = static_cast<int64_t>(channels) * bps;
            int64_t i = lo, safe = hi;
            if (fast24) {
                if (hi == frames && c == channels - 1) safe = hi - 1;
                for (; i < safe; ++i) {
                    *dst++ = static_cast<float>(load_pcm24le_u32(src)) * scale;
                    src += stride;
                }
            }
            for (; i < hi; ++i) {
                *dst++ = static_cast<float>(load_pcm(src, bps, be)) * scale;
                src += stride;
            }
        }
    });
}

// Planar float32 [channels][frames] -> interleaved PCM bytes:
//   pcm = clip(rint(x * 2^(bits-1)), -2^(bits-1), 2^(bits-1)-1)
// (bit-identical to codec.py's NumPy fallback; any normalization gain is
// applied upstream in float32 so native and fallback paths stay
// byte-deterministic with each other).
void encode_pcm_planar(const float* in, int64_t frames, int channels,
                       int bits, int big_endian, int threads, uint8_t* out) {
    const int bps = bits / 8;
    // Quantization math runs in FLOAT, bit-identical to the double (and
    // NumPy) form: the scale 2^(bits-1) is a power of two, so x * g never
    // rounds (pure exponent shift), and std::nearbyint(float) applies the
    // same round-half-even to the same exact value as the double form.
    // Values beyond the clip bounds compare identically in either width.
    // Float math keeps the quantize chain vectorizable (vroundps).
    const float g = bits == 16 ? 32768.0f : 8388608.0f;
    const float flo = -g, fhi = g - 1.0f;
    const bool be = big_endian != 0;
    parallel_frames(frames, threads, [=](int64_t lo, int64_t hi) {
        // Two-phase blocks: (1) quantize a run of frames to int32 — a
        // pure mul/round/min/max/cvt chain the compiler vectorizes —
        // then (2) pack bytes into the channel-strided layout. The
        // int32 staging block stays L1-resident.
        constexpr int64_t BLK = 2048;
        int32_t q[BLK];
        for (int c = 0; c < channels; ++c) {
            const float* src = in + c * frames + lo;
            uint8_t* dst = out + (lo * channels + c) * bps;
            const int64_t stride = static_cast<int64_t>(channels) * bps;
            for (int64_t base = lo; base < hi; base += BLK) {
                const int64_t n = std::min(BLK, hi - base);
                for (int64_t i = 0; i < n; ++i) {
                    float v = std::nearbyint(src[i] * g);
                    v = v < flo ? flo : v;
                    v = v > fhi ? fhi : v;
                    q[i] = static_cast<int32_t>(v);
                }
                src += n;
                for (int64_t i = 0; i < n; ++i) {
                    store_pcm(dst, q[i], bps, be);
                    dst += stride;
                }
            }
        }
    });
}

}  // extern "C"
