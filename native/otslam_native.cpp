// otslam_tpu native host runtime.
//
// The reference's online layer is C++ ROS nodes (SURVEY.md §2.2); the
// rebuild keeps the *host-side real-time plumbing* native while
// all numerics live in XLA/Pallas. This library provides:
//
//   * FrameRing — a lock-free single-producer/single-consumer ring buffer of
//     RGB-D frames (contiguous, reusable slabs), the sensor->device feed of
//     the capture pipeline (replaces the DDS image-topic path).
//   * depth_u16_to_m / depth_m_to_u16 — the scanner depth conversions
//     (scanner_node.cpp:276-280: NaN -> 0, > max -> 0, mm <-> m, rounding).
//   * write_ply_points / read PGM helpers — binary codecs for the on-disk
//     formats, callable without the GIL.
//
// C ABI only (loaded via ctypes). Thread-safety: FrameRing is SPSC.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// depth conversions
// ---------------------------------------------------------------------------

void depth_u16_to_m(const uint16_t* in, float* out, int64_t n,
                    float depth_scale) {
    const float inv = 1.0f / depth_scale;
    for (int64_t i = 0; i < n; ++i) out[i] = (float)in[i] * inv;
}

void depth_m_to_u16(const float* in, uint16_t* out, int64_t n,
                    float depth_scale, float depth_max) {
    for (int64_t i = 0; i < n; ++i) {
        float d = in[i];
        if (!std::isfinite(d) || d > depth_max || d < 0.0f) d = 0.0f;
        float v = d * depth_scale;
        out[i] = (uint16_t)(v + 0.5f);  // cv::convertTo rounds
    }
}

// fused capture-side filter: meters in, truncated meters out (trunc band)
void depth_filter(const float* in, float* out, int64_t n, float trunc) {
    for (int64_t i = 0; i < n; ++i) {
        float d = in[i];
        out[i] = (std::isfinite(d) && d > 0.0f && d <= trunc) ? d : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// FrameRing: SPSC ring of RGB-D frames
// ---------------------------------------------------------------------------

struct FrameRing {
    int64_t capacity;     // number of slots
    int64_t frame_bytes;  // bytes per slot
    uint8_t* data;        // capacity * frame_bytes
    double* stamps;
    std::atomic<int64_t> head;  // next write
    std::atomic<int64_t> tail;  // next read
    std::atomic<int64_t> dropped;
};

FrameRing* ring_create(int64_t capacity, int64_t frame_bytes) {
    auto* r = new FrameRing();
    r->capacity = capacity;
    r->frame_bytes = frame_bytes;
    r->data = (uint8_t*)std::malloc((size_t)(capacity * frame_bytes));
    r->stamps = (double*)std::malloc(sizeof(double) * (size_t)capacity);
    r->head.store(0);
    r->tail.store(0);
    r->dropped.store(0);
    return r;
}

void ring_destroy(FrameRing* r) {
    if (!r) return;
    std::free(r->data);
    std::free(r->stamps);
    delete r;
}

int64_t ring_size(const FrameRing* r) {
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

int64_t ring_dropped(const FrameRing* r) { return r->dropped.load(); }

// producer: copy one frame in; drops the oldest when full (sensor semantics:
// the freshest data wins, like a depth=1 QoS subscription)
int ring_push(FrameRing* r, const uint8_t* frame, double stamp) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->capacity) {
        r->tail.store(tail + 1, std::memory_order_release);  // drop oldest
        r->dropped.fetch_add(1, std::memory_order_relaxed);
    }
    int64_t slot = head % r->capacity;
    std::memcpy(r->data + slot * r->frame_bytes, frame,
                (size_t)r->frame_bytes);
    r->stamps[slot] = stamp;
    r->head.store(head + 1, std::memory_order_release);
    return 1;
}

// consumer: copy the next frame out; returns 0 if empty
int ring_pop(FrameRing* r, uint8_t* out, double* stamp) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    if (tail >= head) return 0;
    int64_t slot = tail % r->capacity;
    std::memcpy(out, r->data + slot * r->frame_bytes,
                (size_t)r->frame_bytes);
    if (stamp) *stamp = r->stamps[slot];
    r->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

// consumer: drop everything but the newest and pop it (scanner_node's
// buffer-flush-then-grab-fresh behavior, scanner_node.cpp:173-207)
int ring_pop_latest(FrameRing* r, uint8_t* out, double* stamp) {
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    if (tail >= head) return 0;
    r->tail.store(head - 1, std::memory_order_relaxed);
    return ring_pop(r, out, stamp);
}

// ---------------------------------------------------------------------------
// binary PLY point-cloud writer (xyz + rgb uchar), single pass, no GIL
// ---------------------------------------------------------------------------

int64_t write_ply_points(const char* path, const float* xyz,
                         const uint8_t* rgb, int64_t n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    char header[512];
    int hl = std::snprintf(
        header, sizeof(header),
        "ply\nformat binary_little_endian 1.0\n"
        "comment produced by otslam_tpu native runtime\n"
        "element vertex %lld\n"
        "property float x\nproperty float y\nproperty float z\n"
        "%s"
        "end_header\n",
        (long long)n,
        rgb ? "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            : "");
    std::fwrite(header, 1, (size_t)hl, f);
    if (!rgb) {
        std::fwrite(xyz, sizeof(float) * 3, (size_t)n, f);
    } else {
        const size_t rec = 3 * sizeof(float) + 3;
        uint8_t* buf = (uint8_t*)std::malloc(rec * (size_t)n);
        for (int64_t i = 0; i < n; ++i) {
            std::memcpy(buf + i * rec, xyz + i * 3, 12);
            std::memcpy(buf + i * rec + 12, rgb + i * 3, 3);
        }
        std::fwrite(buf, rec, (size_t)n, f);
        std::free(buf);
    }
    std::fclose(f);
    return n;
}

// ---------------------------------------------------------------------------
// PGM (P5) codec
// ---------------------------------------------------------------------------

int64_t write_pgm(const char* path, const uint8_t* img, int64_t h, int64_t w) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f, "P5\n%lld %lld\n255\n", (long long)w, (long long)h);
    std::fwrite(img, 1, (size_t)(h * w), f);
    std::fclose(f);
    return h * w;
}

}  // extern "C"
