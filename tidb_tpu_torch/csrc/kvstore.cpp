// Ordered KV engine with column families — the native storage substrate
// of tidb_tpu_torch (host C++, loaded through ctypes by kv/native.py).
//
// The port's own copy of the reference engine (tidb_tpu's
// native/kvstore.cpp), with the same files. The MVCC percolator layer
// (tidb_tpu_torch/kv/mvcc.py) sits on top of this interface; PyOrderedKV
// is the pure-Python twin used when this library does not build.
//
// Durability (kv_open_at): write-ahead log + snapshot, both in one record
// format:  u8 op (1=put 2=del), u8 cf, u32 klen, u32 vlen, key, value.
// Every mutation appends to the WAL before the in-memory map changes;
// kv_checkpoint() dumps the maps to snapshot.tmp, fsyncs, renames over
// snapshot.kv, fsyncs the directory and truncates the WAL. Open replays
// snapshot then WAL; a torn tail record (crash mid-append) is truncated
// away. The Python twin (mvcc.PyOrderedKV) and the reference's engines
// read and write the same files.
//
// Interface contract (mirrors PyOrderedKV):
//   put/delete/get over (cf, key) -> value bytes
//   scan(cf, start, end, limit): ordered iteration, end=="" means +inf
//   seek_prev(cf, key): greatest entry with k <= key
//
// Concurrency: a shared_mutex per store; scans snapshot the range into the
// iterator at creation so mutation during iteration is safe.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kNumCF = 3;

struct Store {
    std::map<std::string, std::string> cf[kNumCF];
    std::shared_mutex mu;
    std::string dir;        // empty = pure in-memory
    FILE* wal = nullptr;    // append handle when durable
};

struct Iter {
    std::vector<std::pair<std::string, std::string>> items;
    size_t pos = 0;
};

bool read_rec(FILE* f, uint8_t* op, uint8_t* cf, std::string* key,
              std::string* val) {
    uint8_t hdr[10];
    if (fread(hdr, 1, sizeof hdr, f) != sizeof hdr) return false;
    *op = hdr[0];
    *cf = hdr[1];
    uint32_t klen, vlen;
    memcpy(&klen, hdr + 2, 4);
    memcpy(&vlen, hdr + 6, 4);
    if (*cf >= kNumCF || (*op != 1 && *op != 2)) return false;
    key->resize(klen);
    val->resize(vlen);
    if (klen && fread(&(*key)[0], 1, klen, f) != klen) return false;
    if (vlen && fread(&(*val)[0], 1, vlen, f) != vlen) return false;
    return true;
}

void write_rec(FILE* f, uint8_t op, uint8_t cf, const char* key, size_t klen,
               const char* val, size_t vlen) {
    uint8_t hdr[10];
    hdr[0] = op;
    hdr[1] = static_cast<uint8_t>(cf);
    uint32_t k32 = static_cast<uint32_t>(klen);
    uint32_t v32 = static_cast<uint32_t>(vlen);
    memcpy(hdr + 2, &k32, 4);
    memcpy(hdr + 6, &v32, 4);
    fwrite(hdr, 1, sizeof hdr, f);
    if (klen) fwrite(key, 1, klen, f);
    if (vlen) fwrite(val, 1, vlen, f);
}

// replays valid records; returns the byte offset of the valid prefix so a
// torn tail (crash mid-append) can be truncated away — appending after
// garbage would make every later record unreachable to the next replay
long replay_file(Store* s, const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return -1;
    uint8_t op, cf;
    std::string key, val;
    long valid = 0;
    while (read_rec(f, &op, &cf, &key, &val)) {
        if (op == 1)
            s->cf[cf][key] = val;
        else
            s->cf[cf].erase(key);
        valid = ftell(f);
    }
    fclose(f);
    return valid;
}

void log_mutation(Store* s, uint8_t op, int cf, const char* key, size_t klen,
                  const char* val, size_t vlen) {
    if (!s->wal) return;
    write_rec(s->wal, op, static_cast<uint8_t>(cf), key, klen, val, vlen);
    fflush(s->wal);
}

}  // namespace

extern "C" {

void* kv_open() { return new Store(); }

// durable variant: dir must exist; replays snapshot.kv then wal.log and
// keeps the WAL open for appends
void* kv_open_at(const char* dir) {
    auto* s = new Store();
    s->dir = dir;
    replay_file(s, s->dir + "/snapshot.kv");
    long valid = replay_file(s, s->dir + "/wal.log");
    if (valid >= 0 && truncate((s->dir + "/wal.log").c_str(), valid) != 0) {
        delete s;
        return nullptr;
    }
    s->wal = fopen((s->dir + "/wal.log").c_str(), "ab");
    if (!s->wal) {
        delete s;
        return nullptr;
    }
    return s;
}

void kv_close(void* h) {
    auto* s = static_cast<Store*>(h);
    if (s->wal) fclose(s->wal);
    delete s;
}

// fold WAL + maps into a fresh snapshot, then truncate the WAL
int kv_checkpoint(void* h) {
    auto* s = static_cast<Store*>(h);
    if (s->dir.empty()) return -1;
    std::unique_lock lk(s->mu);
    std::string tmp = s->dir + "/snapshot.tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return -1;
    for (int cf = 0; cf < kNumCF; ++cf) {
        for (const auto& kv : s->cf[cf]) {
            write_rec(f, 1, static_cast<uint8_t>(cf), kv.first.data(),
                      kv.first.size(), kv.second.data(), kv.second.size());
        }
    }
    fflush(f);
    fsync(fileno(f));
    fclose(f);
    if (rename(tmp.c_str(), (s->dir + "/snapshot.kv").c_str()) != 0)
        return -1;
    // the rename must be durable BEFORE the WAL truncates: a crash
    // between the two would otherwise leave the old snapshot and an
    // empty WAL
    int dfd = open(s->dir.c_str(), O_RDONLY);
    if (dfd < 0) return -1;
    fsync(dfd);
    close(dfd);
    if (s->wal) fclose(s->wal);
    s->wal = fopen((s->dir + "/wal.log").c_str(), "wb");
    return s->wal ? 0 : -1;
}

// 0, or -1 when the fsync failed (errno says why)
int kv_sync(void* h) {
    // fsync OUTSIDE the store mutex: holding it for the ~10-30ms disk
    // barrier would block every concurrent kv_put behind the flush and
    // defeat the commit path's cross-commit group fsync (writers must
    // be able to append WHILE the previous batch's fsync is in flight).
    // fflush stays under the lock (the stdio buffer is shared with
    // writers); fsync on the fd needs no lock — it covers every byte
    // flushed before it started, which is exactly the group-commit
    // durability contract.
    auto* s = static_cast<Store*>(h);
    int fd = -1;
    {
        std::unique_lock lk(s->mu);
        if (!s->wal) return 0;
        fflush(s->wal);
        fd = fileno(s->wal);
    }
    return fd >= 0 ? fsync(fd) : 0;
}

void kv_put(void* h, int cf, const char* key, size_t klen,
            const char* val, size_t vlen) {
    auto* s = static_cast<Store*>(h);
    std::unique_lock lk(s->mu);
    log_mutation(s, 1, cf, key, klen, val, vlen);
    s->cf[cf][std::string(key, klen)] = std::string(val, vlen);
}

void kv_delete(void* h, int cf, const char* key, size_t klen) {
    auto* s = static_cast<Store*>(h);
    std::unique_lock lk(s->mu);
    log_mutation(s, 2, cf, key, klen, nullptr, 0);
    s->cf[cf].erase(std::string(key, klen));
}

// returns value length, or -1 if absent; *out borrows until the next
// mutation — the Python wrapper copies immediately under its own lock.
long kv_get(void* h, int cf, const char* key, size_t klen,
            const char** out) {
    auto* s = static_cast<Store*>(h);
    std::shared_lock lk(s->mu);
    auto it = s->cf[cf].find(std::string(key, klen));
    if (it == s->cf[cf].end()) return -1;
    *out = it->second.data();
    return static_cast<long>(it->second.size());
}

size_t kv_count(void* h, int cf) {
    auto* s = static_cast<Store*>(h);
    std::shared_lock lk(s->mu);
    return s->cf[cf].size();
}

void* kv_scan(void* h, int cf, const char* start, size_t slen,
              const char* end, size_t elen, long limit) {
    auto* s = static_cast<Store*>(h);
    auto* iter = new Iter();
    std::shared_lock lk(s->mu);
    std::string sk(start, slen), ek(end, elen);
    auto it = s->cf[cf].lower_bound(sk);
    for (; it != s->cf[cf].end(); ++it) {
        if (elen > 0 && it->first >= ek) break;
        if (limit >= 0 && static_cast<long>(iter->items.size()) >= limit)
            break;
        iter->items.emplace_back(it->first, it->second);
    }
    return iter;
}

// 1 = produced an entry, 0 = exhausted
int kv_iter_next(void* hi, const char** k, size_t* klen,
                 const char** v, size_t* vlen) {
    auto* iter = static_cast<Iter*>(hi);
    if (iter->pos >= iter->items.size()) return 0;
    auto& e = iter->items[iter->pos++];
    *k = e.first.data();
    *klen = e.first.size();
    *v = e.second.data();
    *vlen = e.second.size();
    return 1;
}

void kv_iter_close(void* hi) { delete static_cast<Iter*>(hi); }

// greatest entry with key' <= key; returns value length or -1
long kv_seek_prev(void* h, int cf, const char* key, size_t klen,
                  const char** outk, size_t* outklen, const char** outv) {
    auto* s = static_cast<Store*>(h);
    std::shared_lock lk(s->mu);
    auto& m = s->cf[cf];
    auto it = m.upper_bound(std::string(key, klen));
    if (it == m.begin()) return -1;
    --it;
    *outk = it->first.data();
    *outklen = it->first.size();
    *outv = it->second.data();
    return static_cast<long>(it->second.size());
}

}  // extern "C"
