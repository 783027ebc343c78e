// Batched TRR frame decoder: the host-side hot path feeding the card.
//
// The reference's trajectory decode happens inside MDAnalysis's
// C/Cython readers one frame at a time (SURVEY.md §2c). Here a whole
// strided frame selection is decoded in one call — big-endian XDR
// payloads byteswapped, converted nm→Å, and written straight into the
// caller's (frames, atoms, 3) float32 batch — multithreaded
// over frames so wide batches saturate memory bandwidth instead of the
// Python interpreter.
//
// Build (io/_native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -o libtrr_decode.so trr_decode.cpp -lpthread
// No -march=native, as in transport_analysis_tpu's build: with it g++ may
// fuse the box determinant's products into multiply-adds and change the
// volumes' last bits.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

namespace {

inline float be_f32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
#if defined(__GNUC__)
    v = __builtin_bswap32(v);
#endif
    float f;
    std::memcpy(&f, &v, 4);
    return f;
}

inline double be_f64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
#if defined(__GNUC__)
    v = __builtin_bswap64(v);
#endif
    double d;
    std::memcpy(&d, &v, 8);
    return d;
}

// decode n big-endian reals, scale by 10 (nm → Å), write float32
inline void decode_scaled(const uint8_t* src, float* dst, int64_t n,
                          bool dbl) {
    if (dbl) {
        for (int64_t i = 0; i < n; ++i)
            dst[i] = static_cast<float>(be_f64(src + 8 * i) * 10.0);
    } else {
        for (int64_t i = 0; i < n; ++i)
            dst[i] = be_f32(src + 4 * i) * 10.0f;
    }
}

double box_volume_from_matrix(const double m[9]) {
    // |det| of the (row-vector) box matrix = triclinic volume
    double det =
        m[0] * (m[4] * m[8] - m[5] * m[7]) -
        m[1] * (m[3] * m[8] - m[5] * m[6]) +
        m[2] * (m[3] * m[7] - m[4] * m[6]);
    return std::fabs(det);
}

}  // namespace

extern "C" {

// Decode a batch of TRR frames that share a layout.
//   buf           whole-file buffer
//   data_offsets  per selected frame: byte offset of the box block
//   n_frames      number of selected frames
//   natoms        atoms per frame
//   is_double     1 if payload reals are 8 bytes
//   box/x/v sizes byte sizes of the per-frame blocks (0 if absent)
//   positions/velocities  (n_frames, natoms, 3) float32 outputs or null
//   volumes       (n_frames,) double output in Å^3 or null
//   n_threads     worker threads over frames
int trr_decode_batch(const uint8_t* buf, const int64_t* data_offsets,
                     int64_t n_frames, int64_t natoms, int is_double,
                     int64_t box_size, int64_t x_size, int64_t v_size,
                     float* positions, float* velocities, double* volumes,
                     int n_threads) {
    const int64_t n3 = natoms * 3;
    const bool dbl = is_double != 0;

    auto work = [&](int64_t begin, int64_t end) {
        for (int64_t f = begin; f < end; ++f) {
            const uint8_t* p = buf + data_offsets[f];
            if (box_size > 0) {
                double m[9];
                for (int i = 0; i < 9; ++i)
                    m[i] = (dbl ? be_f64(p + 8 * i) : (double)be_f32(p + 4 * i))
                           * 10.0;
                if (volumes) volumes[f] = box_volume_from_matrix(m);
                p += box_size;
            } else if (volumes) {
                volumes[f] = 0.0;
            }
            if (x_size > 0) {
                if (positions) decode_scaled(p, positions + f * n3, n3, dbl);
                p += x_size;
            }
            if (v_size > 0) {
                if (velocities) decode_scaled(p, velocities + f * n3, n3, dbl);
            }
        }
    };

    if (n_threads <= 1 || n_frames < 4) {
        work(0, n_frames);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_frames + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t b = t * chunk;
        int64_t e = b + chunk < n_frames ? b + chunk : n_frames;
        if (b >= e) break;
        threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
