// octnative: native host-runtime components of the FD-OCT framework.
//
// Capability-equivalent of the reference's native data-path pieces:
//  * aligned acquisition ring buffer with ready flags
//    (octproz_devkit/src/acquisitionbuffer.{h,cpp}: posix_memalign 128-byte
//    aligned slots, bufferReadyArray producer/consumer handshake)
//  * streaming file reads for huge-volume replay
//    (octproz-virtual-oct-system/src/virtualoctsystem.cpp:226-291)
//  * 12-bit packed sample unpacking (the UINT12_PACKED capability the
//    reference enumerates but never implements, octalgorithmparameters.h:69)
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (octproz_tpu/native.py).  No Python.h dependency: the buffers are shared
// as raw pointers wrapped with numpy.ctypeslib on the Python side.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Aligned ring buffer (acquisitionbuffer.cpp:53-92 analog)
// ---------------------------------------------------------------------------

struct RingBuffer {
    int n_slots;
    size_t slot_bytes;
    void** slots;
    std::atomic<int>* ready;     // 0 = free (producer may fill), 1 = ready
    std::atomic<long> produced;
    std::atomic<long> consumed;
};

void* rb_create(int n_slots, size_t slot_bytes, size_t alignment) {
    if (n_slots <= 0 || slot_bytes == 0) return nullptr;
    if (alignment < sizeof(void*)) alignment = 128;  // reference uses 128
    RingBuffer* rb = new RingBuffer();
    rb->n_slots = n_slots;
    rb->slot_bytes = slot_bytes;
    rb->slots = new void*[n_slots];
    rb->ready = new std::atomic<int>[n_slots];
    rb->produced.store(0);
    rb->consumed.store(0);
    for (int i = 0; i < n_slots; ++i) {
        if (posix_memalign(&rb->slots[i], alignment, slot_bytes) != 0) {
            for (int j = 0; j < i; ++j) free(rb->slots[j]);
            delete[] rb->slots;
            delete[] rb->ready;
            delete rb;
            return nullptr;
        }
        memset(rb->slots[i], 0, slot_bytes);
        rb->ready[i].store(0);
    }
    return rb;
}

void rb_destroy(void* handle) {
    if (!handle) return;
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    for (int i = 0; i < rb->n_slots; ++i) free(rb->slots[i]);
    delete[] rb->slots;
    delete[] rb->ready;
    delete rb;
}

void* rb_slot_ptr(void* handle, int slot) {
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    if (slot < 0 || slot >= rb->n_slots) return nullptr;
    return rb->slots[slot];
}

int rb_n_slots(void* handle) {
    return static_cast<RingBuffer*>(handle)->n_slots;
}

size_t rb_slot_bytes(void* handle) {
    return static_cast<RingBuffer*>(handle)->slot_bytes;
}

// Producer: returns the next free slot index, or -1 if the consumer is
// behind (back-pressure; the reference spin-waits on bufferReadyArray,
// virtualoctsystem.cpp:196-203).
int rb_acquire_write(void* handle) {
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    int slot = static_cast<int>(rb->produced.load(std::memory_order_relaxed)
                                % rb->n_slots);
    if (rb->ready[slot].load(std::memory_order_acquire) != 0) return -1;
    return slot;
}

void rb_commit_write(void* handle, int slot) {
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    // ready first (release), THEN the counter: a consumer that has seen
    // produced >= k is guaranteed to find slot k's ready flag set.
    rb->ready[slot].store(1, std::memory_order_release);
    rb->produced.fetch_add(1, std::memory_order_release);
}

// Consumer: next ready slot index, or -1 if nothing is ready.
int rb_acquire_read(void* handle) {
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    int slot = static_cast<int>(rb->consumed.load(std::memory_order_relaxed)
                                % rb->n_slots);
    if (rb->ready[slot].load(std::memory_order_acquire) != 1) return -1;
    return slot;
}

void rb_release_read(void* handle, int slot) {
    RingBuffer* rb = static_cast<RingBuffer*>(handle);
    rb->ready[slot].store(0, std::memory_order_release);
    rb->consumed.fetch_add(1, std::memory_order_relaxed);
}

// Monotonic commit/release counters.  These are the end-of-stream count
// contract (the analog of the reference's bufferReadyArray handshake,
// octproz_devkit/src/acquisitionbuffer.h:53-58): a producer publishes its
// final produced count at finish() (read on its own thread, so exact) and
// the consumer drains until consumed == that count — a "finished" flag plus
// an empty-poll is NOT sufficient (poll -1 / commit+finish / flag check is
// a lost-wakeup interleaving).
long rb_produced(void* handle) {
    return static_cast<RingBuffer*>(handle)
        ->produced.load(std::memory_order_acquire);
}

long rb_consumed(void* handle) {
    return static_cast<RingBuffer*>(handle)
        ->consumed.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// Streaming file reads (virtualoctsystem.cpp:226-291 analog)
// ---------------------------------------------------------------------------

// Read exactly nbytes at offset into dst; returns bytes read or -1.
long file_read_at(const char* path, long offset, long nbytes, void* dst) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, offset, nbytes, POSIX_FADV_SEQUENTIAL);
#endif
    char* p = static_cast<char*>(dst);
    long total = 0;
    while (total < nbytes) {
        ssize_t got = pread(fd, p + total, nbytes - total, offset + total);
        if (got < 0) { close(fd); return -1; }
        if (got == 0) break;  // EOF
        total += got;
    }
    close(fd);
    return total;
}

long file_size(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    off_t end = lseek(fd, 0, SEEK_END);
    close(fd);
    return static_cast<long>(end);
}

// ---------------------------------------------------------------------------
// 12-bit packed unpack: [s0 low 8 | s1 low 4 : s0 high 4 | s1 high 8]
// per 3-byte group (little-endian, two samples / 3 bytes).
// ---------------------------------------------------------------------------

void unpack_uint12(const uint8_t* src, uint16_t* dst, long n_samples) {
    long n_groups = n_samples / 2;
    for (long g = 0; g < n_groups; ++g) {
        const uint8_t* b = src + 3 * g;
        dst[2 * g] = static_cast<uint16_t>(b[0] | ((b[1] & 0x0F) << 8));
        dst[2 * g + 1] = static_cast<uint16_t>((b[1] >> 4) | (b[2] << 4));
    }
    if (n_samples & 1) {
        const uint8_t* b = src + 3 * n_groups;
        dst[n_samples - 1] = static_cast<uint16_t>(b[0] | ((b[1] & 0x0F) << 8));
    }
}

// Pack the other direction (for writing test fixtures / recorders).
void pack_uint12(const uint16_t* src, uint8_t* dst, long n_samples) {
    long n_groups = n_samples / 2;
    for (long g = 0; g < n_groups; ++g) {
        uint16_t s0 = src[2 * g] & 0x0FFF;
        uint16_t s1 = src[2 * g + 1] & 0x0FFF;
        uint8_t* b = dst + 3 * g;
        b[0] = static_cast<uint8_t>(s0 & 0xFF);
        b[1] = static_cast<uint8_t>(((s0 >> 8) & 0x0F) | ((s1 & 0x0F) << 4));
        b[2] = static_cast<uint8_t>((s1 >> 4) & 0xFF);
    }
    if (n_samples & 1) {
        uint16_t s0 = src[n_samples - 1] & 0x0FFF;
        uint8_t* b = dst + 3 * n_groups;
        b[0] = static_cast<uint8_t>(s0 & 0xFF);
        b[1] = static_cast<uint8_t>((s0 >> 8) & 0x0F);
        b[2] = 0;
    }
}

}  // extern "C"
