// Native COLMAP binary parsers.
//
// The reference's data path is Python-loop bound when loading large
// sparse models (ref:scene/colmap_loader.py parses points3D.bin one
// record at a time; MipNeRF360 scenes carry millions of points). This
// mmap-based C++ parser does the variable-length record walk at memory
// speed; loader.py beside it builds it on demand (g++ -O3) and
// binds it with ctypes, falling back to the pure-Python parser when no
// toolchain is available.
//
// File format (COLMAP points3D.bin):
//   uint64 num_points
//   per point: uint64 id; 3x double xyz; 3x uint8 rgb; double error;
//              uint64 track_len; track_len x (int32 image_id, int32 p2d)

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Scans the file once. Returns the number of points, or -1 on error.
// If xyz/rgb/err are non-null they must hold >= max_n entries and are
// filled (xyz as float32 triplets).
long long colmap_points3d_parse(const char* data, long long size,
                                float* xyz, unsigned char* rgb,
                                float* err, long long max_n) {
    if (size < 8) return -1;
    const unsigned char* p = (const unsigned char*)data;
    const unsigned char* end = p + size;
    uint64_t n;
    memcpy(&n, p, 8);
    p += 8;
    uint64_t i = 0;
    for (; i < n; ++i) {
        // fixed part: 8 + 24 + 3 + 8 + 8 = 51 bytes
        if (p + 51 > end) return -1;
        if (xyz && (long long)i < max_n) {
            double v[3];
            memcpy(v, p + 8, 24);
            xyz[i * 3 + 0] = (float)v[0];
            xyz[i * 3 + 1] = (float)v[1];
            xyz[i * 3 + 2] = (float)v[2];
            memcpy(rgb + i * 3, p + 32, 3);
            double e;
            memcpy(&e, p + 35, 8);
            err[i] = (float)e;
        }
        uint64_t track_len;
        memcpy(&track_len, p + 43, 8);
        p += 51 + track_len * 8;
        if (p > end) return -1;
    }
    return (long long)n;
}

// images.bin fast path: counts images and extracts the fixed-size pose
// block per image (qvec 4d, tvec 3d, camera_id, name offset/len).
// Layout per image: int32 id; 4x double qvec; 3x double tvec;
//   int32 camera_id; null-terminated name; uint64 n2d; n2d x 24 bytes.
long long colmap_images_parse(const char* data, long long size,
                              double* qvec, double* tvec,
                              int* image_id, int* camera_id,
                              long long* name_off, long long* name_len,
                              long long max_n) {
    if (size < 8) return -1;
    const unsigned char* base = (const unsigned char*)data;
    const unsigned char* p = base;
    const unsigned char* end = p + size;
    uint64_t n;
    memcpy(&n, p, 8);
    p += 8;
    for (uint64_t i = 0; i < n; ++i) {
        if (p + 64 > end) return -1;
        if (qvec && (long long)i < max_n) {
            memcpy(image_id + i, p, 4);
            memcpy(qvec + i * 4, p + 4, 32);
            memcpy(tvec + i * 3, p + 36, 24);
            memcpy(camera_id + i, p + 60, 4);
        }
        p += 64;
        const unsigned char* s = p;
        while (p < end && *p != 0) ++p;
        if (p >= end) return -1;
        if (qvec && (long long)i < max_n) {
            name_off[i] = (long long)(s - base);
            name_len[i] = (long long)(p - s);
        }
        ++p;  // null byte
        if (p + 8 > end) return -1;
        uint64_t n2d;
        memcpy(&n2d, p, 8);
        p += 8 + n2d * 24;
        if (p > end) return -1;
    }
    return (long long)n;
}

}  // extern "C"
