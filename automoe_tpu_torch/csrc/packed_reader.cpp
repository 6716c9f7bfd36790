// Native batch reader for the packed caches written by
// automoe_tpu_torch/data/packed.py (columnar .npy memmaps; the same files
// as the JAX package's packer writes, so this is a copy of its reader).
//
// Replaces the Python hot path of the host data pipeline (per-batch
// fancy-indexed gathers plus float16 -> float32 conversion) with mmap'd
// multi-threaded row gathers, so the loader's one call per batch leaves
// the training thread free to launch the step.
//
// Host C++ with a plain C interface (pr_open ... pr_close), bound with
// ctypes by automoe_tpu_torch/data/native_packed.py, which builds it at
// first use:
//   g++ -O3 -std=c++17 -shared -fPIC -o libpacked_reader.so \
//       packed_reader.cpp -lpthread
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum DType : int { kF32 = 0, kF16 = 1, kI32 = 2 };

struct Field {
  std::string name;
  int dtype = kF32;
  std::vector<int64_t> row_shape;  // shape without the leading N
  int64_t row_elems = 0;
  int64_t row_bytes = 0;
  const uint8_t* data = nullptr;  // first row
  void* map_base = nullptr;
  size_t map_len = 0;
  int64_t n = 0;
};

struct Reader {
  std::vector<Field> fields;
};

// --- float16 → float32 via a one-time 64K-entry table -----------------

float half_bits_to_float(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // +-0
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3ff;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

const float* half_table() {
  static std::vector<float> table;
  static std::once_flag once;
  std::call_once(once, [] {
    table.resize(65536);
    for (uint32_t i = 0; i < 65536; ++i)
      table[i] = half_bits_to_float(static_cast<uint16_t>(i));
  });
  return table.data();
}

// --- minimal .npy header parsing ---------------------------------------

bool parse_npy(const uint8_t* p, size_t len, Field* f) {
  if (len < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
  const int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    if (len < 12) return false;
    header_len = p[8] | (p[9] << 8) | (p[10] << 16)
                 | (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string hdr(reinterpret_cast<const char*>(p + header_off), header_len);

  auto find_val = [&](const char* key) -> std::string {
    size_t k = hdr.find(key);
    if (k == std::string::npos) return "";
    size_t c = hdr.find(':', k);
    if (c == std::string::npos) return "";
    return hdr.substr(c + 1);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("<f4") != std::string::npos) f->dtype = kF32;
  else if (descr.find("<f2") != std::string::npos) f->dtype = kF16;
  else if (descr.find("<i4") != std::string::npos) f->dtype = kI32;
  else return false;  // unsupported dtype

  std::string fortran = find_val("'fortran_order'");
  if (fortran.find("False") == std::string::npos) return false;

  size_t sh = hdr.find("'shape'");
  if (sh == std::string::npos) return false;
  size_t lp = hdr.find('(', sh), rp = hdr.find(')', sh);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape_s = hdr.substr(lp + 1, rp - lp - 1);
  std::vector<int64_t> dims;
  const char* s = shape_s.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    char* end = nullptr;
    long long v = std::strtoll(s, &end, 10);
    if (end == s) break;
    dims.push_back(v);
    s = end;
  }
  if (dims.empty()) return false;

  f->n = dims[0];
  f->row_shape.assign(dims.begin() + 1, dims.end());
  f->row_elems = 1;
  for (int64_t d : f->row_shape) f->row_elems *= d;
  const int64_t esize = (f->dtype == kF16) ? 2 : 4;
  f->row_bytes = f->row_elems * esize;
  f->data = p + header_off + header_len;
  if (static_cast<size_t>(f->n * f->row_bytes)
      > len - header_off - header_len)
    return false;
  return true;
}

// out points at a buffer of the field's OUTPUT element type: float32 for
// f32/f16 fields (f16 converts through the table), int32 for i32 fields
// (4-byte rows copy verbatim — the branch below is dtype-agnostic).
void gather_rows(const Field& f, const int64_t* idx, int64_t lo, int64_t hi,
                 float* out) {
  if (f.dtype != kF16) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * f.row_elems, f.data + idx[i] * f.row_bytes,
                  f.row_bytes);
    }
  } else {
    const float* table = half_table();
    for (int64_t i = lo; i < hi; ++i) {
      const uint16_t* src =
          reinterpret_cast<const uint16_t*>(f.data + idx[i] * f.row_bytes);
      float* dst = out + i * f.row_elems;
      for (int64_t e = 0; e < f.row_elems; ++e) dst[e] = table[src[e]];
    }
  }
}

}  // namespace

extern "C" {

// Open every supported .npy in `dir`. Returns handle or nullptr.
void* pr_open(const char* dir) {
  DIR* d = opendir(dir);
  if (!d) return nullptr;
  auto* r = new Reader();
  struct dirent* ent;
  std::vector<std::string> names;
  while ((ent = readdir(d)) != nullptr) {
    std::string name(ent->d_name);
    if (name.size() > 4 && name.substr(name.size() - 4) == ".npy")
      names.push_back(name);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  for (const auto& name : names) {
    std::string path = std::string(dir) + "/" + name;
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) continue;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 10) {
      close(fd);
      continue;
    }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) continue;
    Field f;
    f.name = name.substr(0, name.size() - 4);
    f.map_base = base;
    f.map_len = st.st_size;
    if (!parse_npy(static_cast<const uint8_t*>(base), st.st_size, &f)) {
      munmap(base, st.st_size);
      continue;  // silently skip unsupported dtypes (e.g. int indices)
    }
    r->fields.push_back(std::move(f));
  }
  if (r->fields.empty()) {
    delete r;
    return nullptr;
  }
  return r;
}

int pr_num_fields(void* h) {
  return static_cast<int>(static_cast<Reader*>(h)->fields.size());
}

const char* pr_field_name(void* h, int f) {
  return static_cast<Reader*>(h)->fields[f].name.c_str();
}

int pr_field_rank(void* h, int f) {
  return static_cast<int>(static_cast<Reader*>(h)->fields[f].row_shape.size());
}

void pr_field_shape(void* h, int f, int64_t* out) {
  const auto& sh = static_cast<Reader*>(h)->fields[f].row_shape;
  for (size_t i = 0; i < sh.size(); ++i) out[i] = sh[i];
}

int pr_field_dtype(void* h, int f) {
  return static_cast<Reader*>(h)->fields[f].dtype;
}

int64_t pr_num_samples(void* h) {
  return static_cast<Reader*>(h)->fields[0].n;
}

// Gather rows idx[0..b) of field f into out (float32), multi-threaded.
// Returns 0 on success.
int pr_read_batch(void* h, int field, const int64_t* idx, int64_t b,
                  float* out, int nthreads) {
  auto* r = static_cast<Reader*>(h);
  if (field < 0 || field >= static_cast<int>(r->fields.size())) return 1;
  const Field& f = r->fields[field];
  for (int64_t i = 0; i < b; ++i)
    if (idx[i] < 0 || idx[i] >= f.n) return 2;

  int64_t t = nthreads > 0 ? nthreads
                           : static_cast<int64_t>(
                                 std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (t > b) t = b;
  // below ~256 KiB total the thread spawn costs more than the copy
  if (b * f.row_bytes < (256 << 10)) t = 1;

  if (t == 1) {
    gather_rows(f, idx, 0, b, out);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(t);
  const int64_t per = (b + t - 1) / t;
  for (int64_t k = 0; k < t; ++k) {
    const int64_t lo = k * per;
    const int64_t hi = std::min(b, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(
        [&f, idx, lo, hi, out] { gather_rows(f, idx, lo, hi, out); });
  }
  for (auto& th : threads) th.join();
  return 0;
}

void pr_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  for (auto& f : r->fields)
    if (f.map_base) munmap(f.map_base, f.map_len);
  delete r;
}

}  // extern "C"
