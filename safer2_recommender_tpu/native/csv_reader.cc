// Native ingest: 2-column "uid,sid" CSV -> COO int32 arrays.
//
// Parallel equivalent of the reference's C++ Dataset loader (reference
// include/frecsys/dataset.h:71-99): the reference parses line-by-line with
// std::getline/atoi into unordered_map adjacency; we parse the raw bytes in
// parallel into flat COO arrays that are handed straight to device_put.
//
// Exposed via a C ABI and loaded from Python with ctypes (no pybind11 in
// the image). Two-phase protocol:
//   n = frt_csv_count(path)            // number of data rows (header skipped)
//   frt_csv_read(path, users, items, n)  // fills caller-allocated buffers
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfrt_io.so csv_reader.cc -lpthread
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap_file(Mapped& m) {
  if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// THE record predicate. Counting and parsing must agree exactly on
// what constitutes a record, or a parser can write more rows than its
// caller allocated / its thread reserved (heap overflow). One shared
// definition: a line is a record iff it contains any non-whitespace
// byte. Whitespace-only lines are skipped everywhere (the reference's
// getline+atoi loop would have turned them into phantom (0, 0)
// interactions; we refuse to invent data).
inline bool line_has_content(const char* p, const char* line_end) {
  for (const char* q = p; q < line_end; ++q)
    if (*q > ' ') return true;
  return false;
}

// Count records in [begin, end) under the shared predicate.
int64_t count_span(const char* begin, const char* end) {
  int64_t n = 0;
  for (const char* p = begin; p < end;) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = (nl == nullptr) ? end : nl;
    if (line_has_content(p, line_end)) ++n;
    p = (nl == nullptr) ? end : nl + 1;
  }
  return n;
}

// Number of records after the header line. A final record without a
// trailing newline counts too.
int64_t count_rows(const char* data, size_t size) {
  const char* header_end =
      static_cast<const char*>(memchr(data, '\n', size));
  if (header_end == nullptr) return 0;
  return count_span(header_end + 1, data + size);
}

inline const char* parse_i32(const char* p, const char* end, int32_t* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;  // atoi-like
  int32_t v = 0;
  bool neg = false;
  if (p < end && *p == '-') {
    neg = true;
    ++p;
  }
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = neg ? -v : v;
  return p;
}

// Parse records in [begin, end); begin must point at a record start.
// Returns number parsed, or -1 if more than ``cap`` records exist
// (never writes past users[cap-1]). Record iteration mirrors
// count_span exactly.
int64_t parse_span(const char* begin, const char* end, int32_t* users,
                   int32_t* items, int64_t cap) {
  const char* p = begin;
  int64_t n = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = (nl == nullptr) ? end : nl;
    if (line_has_content(p, line_end)) {
      if (n >= cap) return -1;
      int32_t u = 0, v = 0;
      const char* q = parse_i32(p, line_end, &u);
      if (q < line_end && *q == ',') ++q;
      parse_i32(q, line_end, &v);
      users[n] = u;
      items[n] = v;
      ++n;
    }
    p = (nl == nullptr) ? end : nl + 1;
  }
  return n;
}

}  // namespace

extern "C" {

int64_t frt_csv_count(const char* path) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t n = count_rows(m.data, m.size);
  unmap_file(m);
  return n;
}

// Fills users/items (length >= n). Returns rows actually parsed, or -1.
int64_t frt_csv_read(const char* path, int32_t* users, int32_t* items,
                     int64_t n) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* header_end =
      static_cast<const char*>(memchr(m.data, '\n', m.size));
  if (header_end == nullptr) {
    unmap_file(m);
    return 0;
  }
  const char* body = header_end + 1;
  const char* end = m.data + m.size;

  unsigned hw = std::thread::hardware_concurrency();
  int num_threads = hw == 0 ? 1 : static_cast<int>(hw);
  if (n < (1 << 16) || num_threads <= 1) {
    int64_t got = parse_span(body, end, users, items, n);
    unmap_file(m);
    return got;
  }

  // Split the byte range into num_threads spans aligned to record starts;
  // first count per-span so each thread writes a disjoint output slice.
  std::vector<const char*> starts(num_threads + 1);
  size_t body_size = end - body;
  starts[0] = body;
  for (int t = 1; t < num_threads; ++t) {
    const char* guess = body + (body_size * t) / num_threads;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', end - guess));
    starts[t] = (nl == nullptr) ? end : nl + 1;
  }
  starts[num_threads] = end;

  std::vector<int64_t> counts(num_threads, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < num_threads; ++t) {
      ths.emplace_back([&, t] {
        counts[t] = count_span(starts[t], starts[t + 1]);
      });
    }
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> offsets(num_threads + 1, 0);
  for (int t = 0; t < num_threads; ++t) offsets[t + 1] = offsets[t] + counts[t];
  if (offsets[num_threads] > n) {
    unmap_file(m);
    return -1;
  }
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < num_threads; ++t) {
      ths.emplace_back([&, t] {
        parse_span(starts[t], starts[t + 1], users + offsets[t],
                   items + offsets[t], counts[t]);
      });
    }
    for (auto& th : ths) th.join();
  }
  int64_t total = offsets[num_threads];
  unmap_file(m);
  return total;
}

}  // extern "C"
