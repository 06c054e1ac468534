// kalle_tpu_torch native host runtime (a copy of kalle_tpu/native/host.cpp).
//
// Native replacement for the host-side surface the reference
// leans on through third parties (SURVEY.md §2.9): the data-loader hot path
// (np.load of latent .npy files inside DataLoader workers,
// ref twj_dataset_offline.py:240-324) and the WER alignment core
// (tools/compute-wer.py dynamic program). Exposed via ctypes (no pybind11
// in this image).
//
// Built at first use by native/host.py:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread host.cpp -o build/native/libkalle_host-<hash>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Levenshtein alignment with backtrace.
// ref/hyp are int32 token ids. ops_out must hold (n+m) entries; each op is
// 0=cor 1=sub 2=del 3=ins packed with the ref/hyp indices.
// Returns the number of ops, or -1 on overflow.
// ---------------------------------------------------------------------------
int64_t kalle_align(const int32_t* ref, int64_t n, const int32_t* hyp,
                    int64_t m, int32_t* ops_out, int64_t ops_cap) {
  if (n < 0 || m < 0) return -1;
  std::vector<int32_t> cost((n + 1) * (m + 1));
  std::vector<uint8_t> back((n + 1) * (m + 1));
  const int64_t W = m + 1;
  for (int64_t i = 1; i <= n; ++i) { cost[i * W] = (int32_t)i; back[i * W] = 1; }
  for (int64_t j = 1; j <= m; ++j) { cost[j] = (int32_t)j; back[j] = 2; }
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t ri = ref[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      int32_t s = cost[(i - 1) * W + (j - 1)] + (ri == hyp[j - 1] ? 0 : 1);
      int32_t d = cost[(i - 1) * W + j] + 1;
      int32_t in = cost[i * W + (j - 1)] + 1;
      int32_t best = s; uint8_t b = 0;
      if (d < best) { best = d; b = 1; }
      if (in < best) { best = in; b = 2; }
      cost[i * W + j] = best;
      back[i * W + j] = b;
    }
  }
  // backtrace (reversed; caller flips)
  int64_t cnt = 0;
  int64_t i = n, j = m;
  while (i > 0 || j > 0) {
    if (cnt * 3 + 3 > ops_cap) return -1;
    uint8_t b = back[i * W + j];
    if (i > 0 && j > 0 && b == 0) {
      int32_t op = (ref[i - 1] == hyp[j - 1]) ? 0 : 1;
      ops_out[cnt * 3] = op; ops_out[cnt * 3 + 1] = (int32_t)(i - 1);
      ops_out[cnt * 3 + 2] = (int32_t)(j - 1);
      --i; --j;
    } else if (i > 0 && (j == 0 || b == 1)) {
      ops_out[cnt * 3] = 2; ops_out[cnt * 3 + 1] = (int32_t)(i - 1);
      ops_out[cnt * 3 + 2] = -1;
      --i;
    } else {
      ops_out[cnt * 3] = 3; ops_out[cnt * 3 + 1] = -1;
      ops_out[cnt * 3 + 2] = (int32_t)(j - 1);
      --j;
    }
    ++cnt;
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// Minimal .npy reader: supports v1.0/v2.0 headers, little-endian f4/f2/i4/i8,
// C-order. Returns 0 on success. shape_out up to 8 dims; ndim_out set.
// dtype_out: 0=f32 1=f16 2=i32 3=i64.
// Two-phase: kalle_npy_info then kalle_npy_read into caller buffer.
// ---------------------------------------------------------------------------
static int parse_npy_header(FILE* f, int64_t* shape_out, int32_t* ndim_out,
                            int32_t* dtype_out, int64_t* data_off) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return 1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return 2;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return 3;
    hlen = b[0] | (b[1] << 8);
    *data_off = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return 3;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    *data_off = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return 4;
  // descr
  size_t dp = hdr.find("'descr'");
  if (dp == std::string::npos) return 5;
  size_t q1 = hdr.find('\'', dp + 7);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4" || descr == "|f4") *dtype_out = 0;
  else if (descr == "<f2") *dtype_out = 1;
  else if (descr == "<i4") *dtype_out = 2;
  else if (descr == "<i8") *dtype_out = 3;
  else return 6;
  if (hdr.find("'fortran_order': True") != std::string::npos) return 7;
  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return 8;
  size_t p1 = hdr.find('(', sp);
  size_t p2 = hdr.find(')', p1);
  std::string shape = hdr.substr(p1 + 1, p2 - p1 - 1);
  int nd = 0;
  const char* s = shape.c_str();
  while (*s && nd < 8) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    shape_out[nd++] = strtoll(s, (char**)&s, 10);
  }
  *ndim_out = nd;
  return 0;
}

int32_t kalle_npy_info(const char* path, int64_t* shape_out,
                       int32_t* ndim_out, int32_t* dtype_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t off;
  int rc = parse_npy_header(f, shape_out, ndim_out, dtype_out, &off);
  fclose(f);
  return rc;
}

int32_t kalle_npy_read(const char* path, void* buf, int64_t buf_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t shape[8]; int32_t nd, dt; int64_t off;
  int rc = parse_npy_header(f, shape, &nd, &dt, &off);
  if (rc) { fclose(f); return rc; }
  fseek(f, (long)off, SEEK_SET);
  size_t got = fread(buf, 1, (size_t)buf_bytes, f);
  fclose(f);
  return got == (size_t)buf_bytes ? 0 : 9;
}

// ---------------------------------------------------------------------------
// Threaded batch npy loader: load N float32 .npy files concurrently into
// caller-provided buffers. paths packed as NUL-separated string.
// ---------------------------------------------------------------------------
int32_t kalle_npy_read_batch(const char* paths_packed, int64_t n_files,
                             void** bufs, const int64_t* buf_bytes,
                             int32_t n_threads, int32_t* status_out) {
  std::vector<const char*> paths(n_files);
  const char* p = paths_packed;
  for (int64_t i = 0; i < n_files; ++i) {
    paths[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) break;
      status_out[i] = kalle_npy_read(paths[i], bufs[i], buf_bytes[i]);
    }
  };
  int nt = n_threads > 0 ? n_threads : 2;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
