// Host-DRAM KV store for embedding overflow tiers.
//
// The native piece of the multi-tier storage design (SURVEY.md §2.1): DeepRec
// keeps cold embeddings in DRAM/PMEM/SSD behind C++ KV interfaces
// (embedding/kv_interface.h, dense_hash_map_kv.h, ssd_hash_kv.h). On a TPU VM
// the analog is a host-memory table the Python tier choreographs against the
// in-HBM device table: demote cold rows here, promote them back on re-touch,
// spill to a file for the SSD tier. Open-addressing, power-of-two capacity,
// auto-growing; batch APIs only (the ctypes boundary is amortized over
// thousands of keys per call).
//
// The PyTorch port's own copy of deeprec_tpu/native/host_kv.cpp, byte for
// byte in behaviour and file format (a spill written by either package
// loads in the other). Built at first use by deeprec_tpu_torch/native
// (g++ -O3 -std=c++17 -fPIC -shared -pthread) and bound with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

struct Store {
  int dim;
  uint64_t capacity;  // power of two
  uint64_t size;
  std::vector<int64_t> keys;
  std::vector<float> values;    // [capacity, dim]
  std::vector<int32_t> freq;
  std::vector<int32_t> version;

  explicit Store(int d, uint64_t cap) : dim(d), capacity(cap), size(0) {
    keys.assign(capacity, kEmpty);
    values.assign(capacity * dim, 0.f);
    freq.assign(capacity, 0);
    version.assign(capacity, -1);
  }

  uint64_t probe(int64_t key) const {
    uint64_t mask = capacity - 1;
    uint64_t pos = mix64(static_cast<uint64_t>(key)) & mask;
    while (keys[pos] != kEmpty && keys[pos] != key) pos = (pos + 1) & mask;
    return pos;
  }

  void grow() {
    Store bigger(dim, capacity * 2);
    for (uint64_t i = 0; i < capacity; ++i) {
      if (keys[i] == kEmpty) continue;
      uint64_t pos = bigger.probe(keys[i]);
      bigger.keys[pos] = keys[i];
      std::memcpy(&bigger.values[pos * dim], &values[i * dim],
                  sizeof(float) * dim);
      bigger.freq[pos] = freq[i];
      bigger.version[pos] = version[i];
    }
    bigger.size = size;
    *this = std::move(bigger);
  }

  void put(int64_t key, const float* row, int32_t f, int32_t v) {
    if ((size + 1) * 4 >= capacity * 3) grow();  // keep load factor < 75%
    uint64_t pos = probe(key);
    if (keys[pos] == kEmpty) {
      keys[pos] = key;
      ++size;
    }
    std::memcpy(&values[pos * dim], row, sizeof(float) * dim);
    freq[pos] = f;
    version[pos] = v;
  }
};

}  // namespace

extern "C" {

void* hkv_create(int dim, uint64_t initial_capacity) {
  uint64_t cap = 1024;
  while (cap < initial_capacity) cap <<= 1;
  return new Store(dim, cap);
}

void hkv_destroy(void* h) { delete static_cast<Store*>(h); }

uint64_t hkv_size(void* h) { return static_cast<Store*>(h)->size; }

int hkv_dim(void* h) { return static_cast<Store*>(h)->dim; }

// Insert or overwrite n rows.
void hkv_put_batch(void* h, uint64_t n, const int64_t* keys,
                   const float* values, const int32_t* freqs,
                   const int32_t* versions) {
  Store* s = static_cast<Store*>(h);
  for (uint64_t i = 0; i < n; ++i) {
    s->put(keys[i], &values[i * s->dim], freqs ? freqs[i] : 0,
           versions ? versions[i] : -1);
  }
}

// Gather n rows; found[i]=1 when present (values/freqs/versions filled),
// untouched outputs otherwise.
void hkv_get_batch(void* h, uint64_t n, const int64_t* keys, float* out_values,
                   int32_t* out_freqs, int32_t* out_versions,
                   uint8_t* out_found) {
  Store* s = static_cast<Store*>(h);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t pos = s->probe(keys[i]);
    if (s->keys[pos] == keys[i]) {
      out_found[i] = 1;
      std::memcpy(&out_values[i * s->dim], &s->values[pos * s->dim],
                  sizeof(float) * s->dim);
      if (out_freqs) out_freqs[i] = s->freq[pos];
      if (out_versions) out_versions[i] = s->version[pos];
    } else {
      out_found[i] = 0;
    }
  }
}

// Remove n keys (missing keys ignored). The result is the slot layout of
// deeprec_tpu's store, which re-puts every remaining key, in slot order,
// into a fresh table of the same capacity: linear probing's occupied set
// does not depend on insertion order and shrinks when keys go, so a
// cluster (a run of occupied slots between empty ones) that lost no key
// keeps every key where it is, and a cluster that lost keys re-places its
// remaining keys in slot order within its own extent. Only those clusters
// are re-placed here, plus the cluster that wraps past the last slot,
// whose keys at the start of the table the full re-put places first.
void hkv_erase_batch(void* h, uint64_t n, const int64_t* keys) {
  Store* s = static_cast<Store*>(h);
  const int64_t kTomb = INT64_MIN + 1;
  uint64_t erased = 0;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t pos = s->probe(keys[i]);
    if (s->keys[pos] == keys[i]) {
      s->keys[pos] = kTomb;  // probes pass it; re-placed below
      ++erased;
    }
  }
  if (!erased) return;
  const uint64_t C = s->capacity;
  const int dim = s->dim;
  // runs of non-empty slots (tombstones included) in [0, C)
  std::vector<std::pair<uint64_t, uint64_t>> runs;  // [a, b]
  for (uint64_t i = 0; i < C;) {
    if (s->keys[i] == kEmpty) { ++i; continue; }
    uint64_t a = i;
    while (i < C && s->keys[i] != kEmpty) ++i;
    runs.emplace_back(a, i - 1);
  }
  const bool wraps = runs.size() > 1 && runs.front().first == 0 &&
                     runs.back().second == C - 1;
  std::vector<int64_t> k;
  std::vector<float> v;
  std::vector<int32_t> f, ver;
  auto take = [&](uint64_t a, uint64_t b) {  // survivors of [a, b], cleared
    for (uint64_t i = a; i <= b; ++i) {
      if (s->keys[i] != kTomb) {
        k.push_back(s->keys[i]);
        v.insert(v.end(), &s->values[i * dim], &s->values[i * dim] + dim);
        f.push_back(s->freq[i]);
        ver.push_back(s->version[i]);
      }
      s->keys[i] = kEmpty;
    }
  };
  auto has_tomb = [&](uint64_t a, uint64_t b) {
    for (uint64_t i = a; i <= b; ++i)
      if (s->keys[i] == kTomb) return true;
    return false;
  };
  auto place = [&]() {  // re-put in the order taken
    for (size_t j = 0; j < k.size(); ++j) {
      uint64_t pos = s->probe(k[j]);
      s->keys[pos] = k[j];
      std::memcpy(&s->values[pos * dim], &v[j * dim], sizeof(float) * dim);
      s->freq[pos] = f[j];
      s->version[pos] = ver[j];
    }
    k.clear(); v.clear(); f.clear(); ver.clear();
  };
  for (size_t r = 0; r < runs.size(); ++r) {
    if (wraps && (r == 0 || r + 1 == runs.size())) continue;
    if (!has_tomb(runs[r].first, runs[r].second)) continue;
    take(runs[r].first, runs[r].second);
    place();
  }
  if (wraps) {
    take(runs.front().first, runs.front().second);  // the start of the table
    take(runs.back().first, runs.back().second);    // then its tail
    place();
  }
  s->size -= erased;
}

// Export all rows (caller allocates hkv_size() rows).
void hkv_export(void* h, int64_t* keys, float* values, int32_t* freqs,
                int32_t* versions) {
  Store* s = static_cast<Store*>(h);
  uint64_t j = 0;
  for (uint64_t i = 0; i < s->capacity; ++i) {
    if (s->keys[i] == kEmpty) continue;
    keys[j] = s->keys[i];
    std::memcpy(&values[j * s->dim], &s->values[i * s->dim],
                sizeof(float) * s->dim);
    freqs[j] = s->freq[i];
    versions[j] = s->version[i];
    ++j;
  }
}

// File spill/load — the SSD/LevelDB-tier analog (ssd_hash_kv.h): a flat
// binary record format (header + rows).
int hkv_save(void* h, const char* path) {
  Store* s = static_cast<Store*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t magic = 0xDEE99EC0011ULL, dim = s->dim, n = s->size;
  std::fwrite(&magic, 8, 1, f);
  std::fwrite(&dim, 8, 1, f);
  std::fwrite(&n, 8, 1, f);
  for (uint64_t i = 0; i < s->capacity; ++i) {
    if (s->keys[i] == kEmpty) continue;
    std::fwrite(&s->keys[i], 8, 1, f);
    std::fwrite(&s->values[i * s->dim], sizeof(float), s->dim, f);
    std::fwrite(&s->freq[i], 4, 1, f);
    std::fwrite(&s->version[i], 4, 1, f);
  }
  std::fclose(f);
  return 0;
}

int hkv_load(void* h, const char* path) {
  Store* s = static_cast<Store*>(h);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t magic = 0, dim = 0, n = 0;
  if (std::fread(&magic, 8, 1, f) != 1 || magic != 0xDEE99EC0011ULL ||
      std::fread(&dim, 8, 1, f) != 1 || dim != (uint64_t)s->dim ||
      std::fread(&n, 8, 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  std::vector<float> row(s->dim);
  for (uint64_t i = 0; i < n; ++i) {
    int64_t k;
    int32_t fr, ver;
    if (std::fread(&k, 8, 1, f) != 1 ||
        std::fread(row.data(), sizeof(float), s->dim, f) != (size_t)s->dim ||
        std::fread(&fr, 4, 1, f) != 1 || std::fread(&ver, 4, 1, f) != 1) {
      std::fclose(f);
      return -3;
    }
    s->put(k, row.data(), fr, ver);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
