// Native MV row map: the host MaterializeExecutor's row store.
//
// The port's own copy of risingwave_tpu/native_src/mv_map.cpp. Reference
// role: the MaterializeExecutor applies chunk deltas to its StateTable
// through native Rust row maps (src/stream/src/executor/mview/
// materialize.rs:44 and MaterializeCache :551). A Python dict of tuples
// pays interpreter cost per row; this map pays about a nanosecond.
//
// A plain C interface, loaded with ctypes; every array crosses as a raw
// int64 buffer from numpy. Keys and values are fixed-arity int64 lanes
// (dictionary codes included); the Python side keeps the dict backend
// for any other layout.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct KeyHash {
    size_t operator()(const std::string& s) const {
        // FNV-1a over the raw key bytes
        uint64_t h = 1469598103934665603ull;
        for (unsigned char c : s) {
            h ^= c;
            h *= 1099511628211ull;
        }
        return static_cast<size_t>(h);
    }
};

struct MvMap {
    int64_t k_arity;
    int64_t v_arity;
    std::unordered_map<std::string, std::string, KeyHash> rows;
};

}  // namespace

extern "C" {

void* mv_new(int64_t k_arity, int64_t v_arity) {
    auto* m = new MvMap{k_arity, v_arity, {}};
    m->rows.reserve(1 << 16);
    return m;
}

void mv_free(void* h) { delete static_cast<MvMap*>(h); }

// Apply n rows in order: is_del[i] ? erase : upsert (last op per pk
// wins by construction — sequential apply).
void mv_apply(void* h, const int64_t* keys, const int64_t* vals,
              const uint8_t* is_del, int64_t n) {
    auto* m = static_cast<MvMap*>(h);
    const size_t kb = m->k_arity * sizeof(int64_t);
    const size_t vb = m->v_arity * sizeof(int64_t);
    std::string key;
    for (int64_t i = 0; i < n; i++) {
        key.assign(reinterpret_cast<const char*>(keys + i * m->k_arity), kb);
        if (is_del[i]) {
            m->rows.erase(key);  // overwrite-conflict: missing ok
        } else {
            std::string& slot = m->rows[key];
            slot.assign(reinterpret_cast<const char*>(vals + i * m->v_arity),
                        vb);
        }
    }
}

int64_t mv_len(void* h) {
    return static_cast<int64_t>(static_cast<MvMap*>(h)->rows.size());
}

// Dump every row into caller-allocated buffers (len()*arity each).
void mv_dump(void* h, int64_t* keys_out, int64_t* vals_out) {
    auto* m = static_cast<MvMap*>(h);
    const size_t kb = m->k_arity * sizeof(int64_t);
    const size_t vb = m->v_arity * sizeof(int64_t);
    int64_t i = 0;
    for (const auto& kv : m->rows) {
        std::memcpy(keys_out + i * m->k_arity, kv.first.data(), kb);
        std::memcpy(vals_out + i * m->v_arity, kv.second.data(), vb);
        i++;
    }
}

// Point lookup: returns 1 and fills vals_out if present.
int32_t mv_get(void* h, const int64_t* key, int64_t* vals_out) {
    auto* m = static_cast<MvMap*>(h);
    std::string k(reinterpret_cast<const char*>(key),
                  m->k_arity * sizeof(int64_t));
    auto it = m->rows.find(k);
    if (it == m->rows.end()) return 0;
    std::memcpy(vals_out, it->second.data(),
                m->v_arity * sizeof(int64_t));
    return 1;
}
}
