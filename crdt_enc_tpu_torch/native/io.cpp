// Bulk op-file reader: the C++ load path for dense per-actor op logs.
//
// An op-log scan reads remote/ops/<actor>/<N> for N = first, first+1, …
// until the first missing file (the dense-version contract,
// crdt-enc-tokio/src/lib.rs:254-269).  Per-file Python open/read costs
// ~10-20µs of interpreter overhead; at compaction scale (SURVEY.md §2.2:
// "the bulk load path (1M op files) gets a C++ reader") that dwarfs the
// I/O itself.  Two-pass protocol so ctypes needs no growable buffers:
//
//   pass 1  scan_op_sizes(dir, first, max)  → per-file sizes (stat loop)
//   pass 2  read_op_files(dir, first, n, buf, offsets)  → one flat buffer
//
// A file that shrinks/vanishes between passes returns -1 and the caller
// falls back to the per-file Python path (the sync tool may race us; op
// files themselves are immutable once published).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

int path_join(char* out, size_t cap, const char* dir, int64_t version) {
  int n = snprintf(out, cap, "%s/%lld", dir, (long long)version);
  return (n > 0 && (size_t)n < cap) ? 0 : -1;
}

}  // namespace

extern "C" {

// Pass 1: sizes of the dense run starting at `first`.  Writes up to
// max_files sizes; returns the count of consecutive existing files.
int64_t scan_op_sizes(const char* dir, int64_t first, int64_t max_files,
                      int64_t* sizes_out) {
  char path[4096];
  int64_t n = 0;
  for (; n < max_files; n++) {
    if (path_join(path, sizeof(path), dir, first + n) != 0) return n;
    struct stat st;
    if (stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return n;
    sizes_out[n] = (int64_t)st.st_size;
  }
  return n;
}

// Pass 2: read n_files consecutive files into one flat buffer at the
// given offsets (offsets[i] .. offsets[i] + sizes[i]).  Returns n_files,
// or -1 if any file is missing or its size changed (caller falls back).
int64_t read_op_files(const char* dir, int64_t first, int64_t n_files,
                      const int64_t* offsets, const int64_t* sizes,
                      uint8_t* buf) {
  char path[4096];
  for (int64_t i = 0; i < n_files; i++) {
    if (path_join(path, sizeof(path), dir, first + i) != 0) return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    int64_t want = sizes[i];
    uint8_t* dst = buf + offsets[i];
    int64_t got = 0;
    while (got < want) {
      ssize_t r = read(fd, dst + got, (size_t)(want - got));
      if (r < 0 && errno == EINTR) continue;  // signal mid-read: retry
      if (r <= 0) { close(fd); return -1; }
      got += r;
    }
    // file must end exactly where pass 1 said (immutable once published)
    uint8_t extra;
    ssize_t tail;
    do {
      tail = read(fd, &extra, 1);
    } while (tail < 0 && errno == EINTR);
    if (tail != 0) { close(fd); return -1; }
    close(fd);
  }
  return n_files;
}

// Warm-open tail probe: does remote/ops/<actor>/<first> exist, for many
// actors in one call.  `rel_paths` is a flat NUL-separated buffer of n
// entries ("<actor-hex>/<version>"); out_mask[i] = 1 when the file
// exists.  dirfd-relative so each access resolves two path components
// instead of re-walking the whole remote prefix — on containerized
// kernels every syscall costs ~100µs+, so the probe is one syscall per
// actor and zero interpreter overhead.  Returns n, or -1 when base_dir
// cannot be opened (caller falls back to per-actor Python stats).
int64_t probe_op_files(const char* base_dir, int64_t n,
                       const char* rel_paths, uint8_t* out_mask) {
  int dfd = open(base_dir, O_RDONLY | O_DIRECTORY);
  if (dfd < 0) return -1;
  const char* p = rel_paths;
  for (int64_t i = 0; i < n; i++) {
    out_mask[i] = faccessat(dfd, p, F_OK, 0) == 0 ? 1 : 0;
    p += strlen(p) + 1;
  }
  close(dfd);
  return n;
}

}  // extern "C"
