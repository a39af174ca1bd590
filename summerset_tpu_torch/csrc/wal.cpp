// Native write-ahead-log backend for the host StorageHub, the port's own
// copy of summerset_tpu/native/wal.cpp (same C ABI, same file format).
// Built at first use by summerset_tpu_torch/ops/native.py (g++, the flags
// of summerset_tpu/native/Makefile) and bound with ctypes by
// summerset_tpu_torch/host/storage.py.
//
// Parity target: reference src/server/storage.rs logger task — a flat file
// of 8-byte length-prefixed entries with Read/Write/Append/Truncate/Discard
// actions and optional fsync (storage.rs:192-510).  The reference's logger
// is a tokio task owning the file; here the hot file ops are C++ behind a
// C ABI, driven by a Python worker thread (ctypes, no pybind11 dependency).
//
// Length prefixes are 8-byte little-endian (host order on every supported
// target); bodies are opaque bytes (the Python layer pickles entries).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

namespace {

struct Wal {
    int fd = -1;
    uint64_t size = 0;  // current end-of-log offset
};

int full_pread(int fd, void* buf, size_t len, uint64_t off) {
    auto* p = static_cast<char*>(buf);
    size_t done = 0;
    while (done < len) {
        ssize_t n = ::pread(fd, p + done, len - done, off + done);
        if (n < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        if (n == 0) return -1;  // unexpected EOF
        done += static_cast<size_t>(n);
    }
    return 0;
}

int full_pwrite(int fd, const void* buf, size_t len, uint64_t off) {
    const auto* p = static_cast<const char*>(buf);
    size_t done = 0;
    while (done < len) {
        ssize_t n = ::pwrite(fd, p + done, len - done, off + done);
        if (n < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        done += static_cast<size_t>(n);
    }
    return 0;
}

}  // namespace

extern "C" {

// Opens (creating if needed) the log; returns an opaque handle or null.
void* wal_open(const char* path) {
    int fd = ::open(path, O_RDWR | O_CREAT, 0644);
    if (fd < 0) return nullptr;
    struct stat st;
    if (::fstat(fd, &st) != 0) {
        ::close(fd);
        return nullptr;
    }
    auto* w = new Wal();
    w->fd = fd;
    w->size = static_cast<uint64_t>(st.st_size);
    return w;
}

void wal_close(void* h) {
    if (h == nullptr) return;
    auto* w = static_cast<Wal*>(h);
    ::close(w->fd);
    delete w;
}

// Current end-of-log offset.
uint64_t wal_size(void* h) { return static_cast<Wal*>(h)->size; }

// Appends one length-prefixed entry; returns the new end offset, 0 on error.
uint64_t wal_append(void* h, const uint8_t* buf, uint64_t len, int sync) {
    auto* w = static_cast<Wal*>(h);
    uint64_t hdr = len;
    if (full_pwrite(w->fd, &hdr, 8, w->size) != 0) return 0;
    if (full_pwrite(w->fd, buf, len, w->size + 8) != 0) return 0;
    w->size += 8 + len;
    if (sync && ::fdatasync(w->fd) != 0) return 0;
    return w->size;
}

// Writes one entry at `off` (not advancing past existing content beyond
// it); returns the entry's end offset, 0 on error.  Mirrors the
// reference's Write action (storage.rs:282-324): the log is truncated to
// the entry's end if it previously extended further *at this offset
// chain* — here we keep it simple and only extend `size` when writing at
// or past the current end.
uint64_t wal_write_at(void* h, uint64_t off, const uint8_t* buf,
                      uint64_t len, int sync) {
    auto* w = static_cast<Wal*>(h);
    uint64_t hdr = len;
    if (full_pwrite(w->fd, &hdr, 8, off) != 0) return 0;
    if (full_pwrite(w->fd, buf, len, off + 8) != 0) return 0;
    uint64_t end = off + 8 + len;
    if (end > w->size) w->size = end;
    if (sync && ::fdatasync(w->fd) != 0) return 0;
    return end;
}

// Reads the entry at `off` into `out` (capacity `cap`); returns the entry
// length, or -1 on error / truncated tail, or -2 if `cap` is too small
// (call again with a bigger buffer).
int64_t wal_read(void* h, uint64_t off, uint8_t* out, uint64_t cap) {
    auto* w = static_cast<Wal*>(h);
    if (off + 8 > w->size) return -1;
    uint64_t len = 0;
    if (full_pread(w->fd, &len, 8, off) != 0) return -1;
    if (off + 8 + len > w->size) return -1;
    if (len > cap) return -2;
    if (len > 0 && full_pread(w->fd, out, len, off + 8) != 0) return -1;
    return static_cast<int64_t>(len);
}

// Truncates the log to `off` (storage.rs:351-373).  Returns 0 on success.
int wal_truncate(void* h, uint64_t off, int sync) {
    auto* w = static_cast<Wal*>(h);
    if (off > w->size) return -1;
    if (::ftruncate(w->fd, static_cast<off_t>(off)) != 0) return -1;
    w->size = off;
    if (sync && ::fdatasync(w->fd) != 0) return -1;
    return 0;
}

// Discards log content in [keep, off), sliding [off, size) down to `keep`
// (storage.rs:375-413: snapshot GC keeping a `keep`-byte header).
int wal_discard(void* h, uint64_t off, uint64_t keep, int sync) {
    auto* w = static_cast<Wal*>(h);
    if (off < keep || off > w->size) return -1;
    uint64_t tail = w->size - off;
    if (tail > 0) {
        std::vector<uint8_t> buf(1 << 20);
        uint64_t moved = 0;
        while (moved < tail) {
            uint64_t n = tail - moved;
            if (n > buf.size()) n = buf.size();
            if (full_pread(w->fd, buf.data(), n, off + moved) != 0) return -1;
            if (full_pwrite(w->fd, buf.data(), n, keep + moved) != 0)
                return -1;
            moved += n;
        }
    }
    if (::ftruncate(w->fd, static_cast<off_t>(keep + tail)) != 0) return -1;
    w->size = keep + tail;
    if (sync && ::fdatasync(w->fd) != 0) return -1;
    return 0;
}

}  // extern "C"
