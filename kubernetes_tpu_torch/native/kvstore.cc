// Native revisioned KV store with CAS and a windowed watch history.
//
// This is the framework's etcd: where the reference runs etcd as an external
// native (Go) process speaking CompareAndSwap + watch
// (pkg/storage/etcd/etcd_helper.go), this library provides the same
// semantics in-process behind a C ABI consumed via ctypes
// (core/native_store.py). The contract mirrors core/store.py exactly:
// monotonic revision counter doubling as resourceVersion, CAS on update and
// delete, lazy TTL expiry emitting DELETED events, an all-or-nothing batch
// commit, and a bounded event history with an oldest-replayable revision
// (the watch-cache window, pkg/storage/cacher.go:109).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC kvstore.cc -o libkvstore.so
//
// Error codes (negative returns): -1 not found, -2 already exists,
// -3 conflict, -4 buffer too small (get only; list/events return the
// negative REQUIRED size so the caller allocates exactly once), -5 expired
// (watch window no longer covers since_rev), -6 revision window raced
// (kv_commit_txn only: another writer claimed the pre-assigned window —
// restage and retry; distinct from -3 so a CAS failure stays a real
// Conflict). Buffer-too-small results from list/events below -6 are
// distinguished by magnitude (sizes > 6).

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t ERR_NOT_FOUND = -1;
constexpr int64_t ERR_EXISTS = -2;
constexpr int64_t ERR_CONFLICT = -3;
constexpr int64_t ERR_TOO_SMALL = -4;
constexpr int64_t ERR_EXPIRED = -5;
constexpr int64_t ERR_RACED = -6;
// Buffer-too-small size hints are returned as -(size + SIZE_HINT_BASE) so
// they occupy a range disjoint from the error codes above — a tiny payload
// (e.g. 4 bytes) must not alias ERR_TOO_SMALL. Callers recover the
// required size as (-ret) - SIZE_HINT_BASE.
constexpr int64_t SIZE_HINT_BASE = 64;

double now_seconds() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

double mono_seconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

uint64_t mono_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

// CRC-32/IEEE (reflected, poly 0xEDB88320, init/xorout 0xFFFFFFFF) —
// bit-identical to Python's zlib.crc32, which is what core/wal.py
// stamps into every frame. The WAL parity contract depends on it.
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      t[i] = c;
    }
  }
};

uint32_t crc32_ieee(const uint8_t* p, size_t n) {
  static const Crc32Table tbl;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = tbl.t[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// JSON string literal for a store key (ensure_ascii semantics like
// json.dumps; keys are ASCII registry paths, but escape defensively).
std::string json_quote(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 2);
  out.push_back('"');
  for (unsigned char ch : s) {
    if (ch == '"' || ch == '\\') {
      out.push_back('\\');
      out.push_back(static_cast<char>(ch));
    } else if (ch < 0x20 || ch >= 0x7F) {
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", ch);
      out += buf;
    } else {
      out.push_back(static_cast<char>(ch));
    }
  }
  out.push_back('"');
  return out;
}

bool write_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

struct Entry {
  std::string value;
  uint64_t mod_rev = 0;
  double expiry = 0;  // 0 = no TTL
};

enum class EventType : uint8_t { Added = 0, Modified = 1, Deleted = 2 };

struct Event {
  uint64_t rev;       // revision at which the event happened
  EventType type;
  std::string key;
  uint64_t obj_rev;   // resourceVersion to stamp on the delivered object
  std::string value;
};

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  uint64_t rev = 0;
  uint64_t oldest_rev = 0;  // history no longer replays revs <= this... see emit
  size_t window;
  double next_expiry = 0;   // soonest pending TTL deadline; 0 = none
  std::map<std::string, Entry> data;  // ordered: list output is sorted
  std::deque<Event> history;

  // ---- native publish ring (kv_publish_start): in ring mode every
  // committed event batch is enqueued here under the ledger mutex and
  // a dedicated native publisher thread drains it into `history` —
  // the watch-visible ledger — advancing published_rev in strict
  // revision order. kv_wait then parks on published_rev, so watchers
  // never observe a committed-but-unpublished revision (the same
  // two-phase split core/store.py runs through _pub_queue, minus the
  // GIL). Window accounting (oldest_rev) stays LEDGER-time so the
  // Expired contract matches the Python store exactly.
  bool ring_mode = false;
  bool stopping = false;
  std::deque<std::vector<Event>> ring;
  std::condition_variable ring_cv;
  std::thread publisher;
  uint64_t published_rev = 0;

  // ---- native WAL appender (kv_wal_attach): frames caller-built
  // payloads with <u32 len><u32 crc32> and appends them to
  // wal-%020d.seg segments, mirroring core/wal.py WalWriter byte for
  // byte (lazy segment open named by the first record's revision,
  // rotation by logical record count, fsync always/batched@50ms).
  bool wal_attached = false;
  std::string wal_dir;
  int wal_fd = -1;
  bool wal_fsync_always = false;
  uint64_t wal_seg_limit = 10000;
  uint64_t wal_seg_count = 0;
  double wal_last_fsync = 0.0;

  // ---- engine counters (kv_stats): the ledger/publish split the
  // profile tooling reads, since a sampler can't see native threads.
  uint64_t commits = 0;
  uint64_t ledger_ns = 0;
  uint64_t published_batches = 0;
  uint64_t publish_ns = 0;
  uint64_t wal_frames = 0;
  uint64_t wal_bytes = 0;

  explicit Store(size_t window_size) : window(window_size) {}

  uint64_t bump() { return ++rev; }

  void push_history(Event&& e) {
    if (history.size() == window) {
      if (history.front().rev > oldest_rev)
        oldest_rev = history.front().rev;
      history.pop_front();
    }
    history.push_back(std::move(e));
  }

  // Ledger-time window accounting for ring mode: revisions map 1:1
  // onto events, so once r outruns the window the oldest replayable
  // revision is r - window regardless of how far the publisher lags —
  // exactly the commit-time _oldest_rev bump the Python store does.
  void roll_window(uint64_t r) {
    if (r > window && r - window > oldest_rev) oldest_rev = r - window;
  }

  void publish(std::vector<Event>&& batch) {
    if (batch.empty()) return;
    if (ring_mode && !stopping) {
      roll_window(batch.back().rev);
      ring.push_back(std::move(batch));
      ring_cv.notify_one();
    } else {
      for (auto& e : batch) push_history(std::move(e));
      cv.notify_all();
    }
  }

  void emit(uint64_t r, EventType t, const std::string& key,
            uint64_t obj_rev, const std::string& value) {
    std::vector<Event> one;
    one.push_back(Event{r, t, key, obj_rev, value});
    publish(std::move(one));
  }

  bool expired(const Entry& e, double now) const {
    return e.expiry != 0 && e.expiry <= now;
  }

  void note_expiry(double expiry) {
    if (expiry != 0 && (next_expiry == 0 || expiry < next_expiry))
      next_expiry = expiry;
  }

  bool wal_write_frame(const uint8_t* payload, uint64_t len,
                       uint64_t name_rev) {
    if (wal_fd < 0) {
      char name[48];
      std::snprintf(name, sizeof(name), "wal-%020llu.seg",
                    static_cast<unsigned long long>(name_rev));
      std::string path = wal_dir + "/" + name;
      wal_fd = ::open(path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
      if (wal_fd < 0) return false;
    }
    uint8_t hdr[8];
    uint32_t l = static_cast<uint32_t>(len);
    uint32_t c = crc32_ieee(payload, len);
    std::memcpy(hdr, &l, 4);
    std::memcpy(hdr + 4, &c, 4);
    if (!write_all(wal_fd, hdr, 8)) return false;
    if (!write_all(wal_fd, payload, len)) return false;
    wal_frames++;
    wal_bytes += 8 + len;
    return true;
  }

  // Post-commit WAL bookkeeping, one call per ledger window: fsync
  // per policy (always, or batched at WalWriter's 50ms cadence) and
  // rotate once the segment holds segment_records LOGICAL records —
  // the same rotate-after-commit rule WalWriter.commit applies, so
  // the same record stream lands in identically-named, byte-identical
  // segment files.
  void wal_commit_done(uint64_t n_records) {
    if (wal_fd < 0) return;
    wal_seg_count += n_records;
    double now = mono_seconds();
    if (wal_fsync_always || now - wal_last_fsync >= 0.05) {
      ::fsync(wal_fd);
      wal_last_fsync = now;
    }
    if (wal_seg_limit != 0 && wal_seg_count >= wal_seg_limit) {
      ::fsync(wal_fd);
      ::close(wal_fd);
      wal_fd = -1;
      wal_seg_count = 0;
    }
  }

  void wal_close_locked() {
    if (wal_fd >= 0) {
      ::fsync(wal_fd);
      ::close(wal_fd);
      wal_fd = -1;
    }
  }

  // TTL GC, mirroring core/store.py _gc_expired: expired entries are
  // deleted and emit DELETED carrying the stale object. Runs on reads
  // too (first-class expiry); the next_expiry guard keeps the no-due
  // common case O(1) instead of a full-map scan per call. With a WAL
  // attached the expiry deletions journal too (composed natively from
  // the stored wire bytes) — skipping them would tear revision
  // contiguity and fail recovery on the next journaled record.
  void gc(double now) {
    if (next_expiry == 0 || next_expiry > now) return;
    std::vector<std::string> dead;
    double nxt = 0;
    for (auto& [k, e] : data) {
      if (expired(e, now)) {
        dead.push_back(k);
      } else if (e.expiry != 0 && (nxt == 0 || e.expiry < nxt)) {
        nxt = e.expiry;
      }
    }
    next_expiry = nxt;
    for (auto& k : dead) {
      Entry e = data[k];
      data.erase(k);
      uint64_t r = bump();
      if (wal_attached) {
        std::string payload = "[" + std::to_string(r) + ",\"DELETED\"," +
                              json_quote(k) + ",null," + e.value + "]";
        wal_write_frame(reinterpret_cast<const uint8_t*>(payload.data()),
                        payload.size(), r);
        wal_commit_done(1);
      }
      emit(r, EventType::Deleted, k, e.mod_rev, e.value);
    }
  }
};

// Drains the publish ring into the watch-visible history, off the
// GIL: a pure native thread, so fan-out wakeups and history rolls
// cost zero interpreter time while the device executes the next tile.
void publisher_main(Store* s) {
  std::unique_lock<std::mutex> lk(s->mu);
  for (;;) {
    s->ring_cv.wait(lk, [&] { return s->stopping || !s->ring.empty(); });
    if (s->ring.empty()) {
      if (s->stopping) return;  // drained AND told to stop
      continue;
    }
    std::vector<Event> batch = std::move(s->ring.front());
    s->ring.pop_front();
    uint64_t t0 = mono_ns();
    uint64_t last = batch.back().rev;
    for (auto& e : batch) s->push_history(std::move(e));
    s->published_rev = last;
    s->published_batches++;
    s->publish_ns += mono_ns() - t0;
    s->cv.notify_all();
  }
}

// Serialize records into caller buffers.
// Event record:  u64 rev | u8 type | u32 klen | key | u64 obj_rev |
//                u32 vlen | value
// List record:   u64 obj_rev | u32 klen | key | u32 vlen | value
class Writer {
 public:
  Writer(uint8_t* buf, int64_t cap) : buf_(buf), cap_(cap) {}

  template <typename T>
  void put(T v) {
    if (pos_ + static_cast<int64_t>(sizeof(T)) <= cap_ && buf_) {
      std::memcpy(buf_ + pos_, &v, sizeof(T));
    }
    pos_ += sizeof(T);
  }

  void put_bytes(const std::string& s) {
    put<uint32_t>(static_cast<uint32_t>(s.size()));
    if (pos_ + static_cast<int64_t>(s.size()) <= cap_ && buf_) {
      std::memcpy(buf_ + pos_, s.data(), s.size());
    }
    pos_ += s.size();
  }

  bool fits() const { return pos_ <= cap_; }
  int64_t size() const { return pos_; }

 private:
  uint8_t* buf_;
  int64_t cap_;
  int64_t pos_ = 0;
};

}  // namespace

extern "C" {

void* kv_open(uint64_t window) { return new Store(window); }

// Stop the publisher (draining the ring first), wake every kv_wait
// parked thread, and seal the WAL. Idempotent; kv_close implies it.
// This is what lets NativeStore.close() behave like a process kill:
// watcher threads blocked in kv_wait return immediately instead of
// riding out their poll timeout.
void kv_shutdown(void* h) {
  Store* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stopping = true;
    s->ring_cv.notify_all();
    s->cv.notify_all();
  }
  if (s->publisher.joinable()) s->publisher.join();
  std::lock_guard<std::mutex> lk(s->mu);
  s->wal_close_locked();
}

void kv_close(void* h) {
  Store* s = static_cast<Store*>(h);
  kv_shutdown(h);
  delete s;
}

uint64_t kv_current_rev(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->rev;
}

uint64_t kv_oldest_rev(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->oldest_rev;
}

int64_t kv_create(void* h, const char* key, const uint8_t* val,
                  uint64_t val_len, double ttl_seconds) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  double now = now_seconds();
  s->gc(now);
  std::string k(key);
  if (s->data.count(k)) return ERR_EXISTS;
  uint64_t rev = s->bump();
  Entry e{std::string(reinterpret_cast<const char*>(val), val_len), rev,
          ttl_seconds > 0 ? now + ttl_seconds : 0};
  s->note_expiry(e.expiry);
  s->data[k] = e;
  s->emit(rev, EventType::Added, k, rev, e.value);
  return static_cast<int64_t>(rev);
}

int64_t kv_set(void* h, const char* key, const uint8_t* val,
               uint64_t val_len, double ttl_seconds) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  double now = now_seconds();
  s->gc(now);
  std::string k(key);
  bool existed = s->data.count(k) > 0;
  uint64_t rev = s->bump();
  Entry e{std::string(reinterpret_cast<const char*>(val), val_len), rev,
          ttl_seconds > 0 ? now + ttl_seconds : 0};
  s->note_expiry(e.expiry);
  s->data[k] = e;
  s->emit(rev, existed ? EventType::Modified : EventType::Added, k, rev,
          e.value);
  return static_cast<int64_t>(rev);
}

// expect_rev 0 = unconditional (but the key must exist).
int64_t kv_update(void* h, const char* key, const uint8_t* val,
                  uint64_t val_len, uint64_t expect_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->gc(now_seconds());
  std::string k(key);
  auto it = s->data.find(k);
  if (it == s->data.end()) return ERR_NOT_FOUND;
  if (expect_rev != 0 && it->second.mod_rev != expect_rev)
    return ERR_CONFLICT;
  uint64_t rev = s->bump();
  it->second.value.assign(reinterpret_cast<const char*>(val), val_len);
  it->second.mod_rev = rev;  // TTL carries over, like core/store.py update
  s->emit(rev, EventType::Modified, k, rev, it->second.value);
  return static_cast<int64_t>(rev);
}

int64_t kv_delete(void* h, const char* key, uint64_t expect_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->gc(now_seconds());
  std::string k(key);
  auto it = s->data.find(k);
  if (it == s->data.end()) return ERR_NOT_FOUND;
  if (expect_rev != 0 && it->second.mod_rev != expect_rev)
    return ERR_CONFLICT;
  Entry e = it->second;
  s->data.erase(it);
  uint64_t rev = s->bump();
  s->emit(rev, EventType::Deleted, k, e.mod_rev, e.value);
  return static_cast<int64_t>(rev);
}

int64_t kv_get(void* h, const char* key, uint8_t* buf, int64_t buflen,
               uint64_t* mod_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  // first-class TTL expiry (mirrors core/store.py get/list): a read
  // past a due deadline COMMITS the deletion to the ledger rather than
  // skipping passively, so history and recovery agree on when the key
  // died; the next_expiry guard keeps the no-due case O(1).
  s->gc(now_seconds());
  std::string k(key);
  auto it = s->data.find(k);
  if (it == s->data.end()) return ERR_NOT_FOUND;
  const std::string& v = it->second.value;
  *mod_rev = it->second.mod_rev;
  if (static_cast<int64_t>(v.size()) > buflen) return ERR_TOO_SMALL;
  std::memcpy(buf, v.data(), v.size());
  return static_cast<int64_t>(v.size());
}

// Buffer layout: u64 store_rev | u32 count | records...
int64_t kv_list(void* h, const char* prefix, uint8_t* buf, int64_t buflen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  double now = now_seconds();
  s->gc(now);  // first-class expiry, same contract as kv_get
  std::string p(prefix);
  Writer w(buf, buflen);
  w.put<uint64_t>(s->rev);
  uint32_t count = 0;
  Writer counter(nullptr, 0);  // first pass to count
  for (auto it = s->data.lower_bound(p); it != s->data.end(); ++it) {
    if (it->first.compare(0, p.size(), p) != 0) break;
    if (s->expired(it->second, now)) continue;
    ++count;
  }
  w.put<uint32_t>(count);
  for (auto it = s->data.lower_bound(p); it != s->data.end(); ++it) {
    if (it->first.compare(0, p.size(), p) != 0) break;
    if (s->expired(it->second, now)) continue;
    w.put<uint64_t>(it->second.mod_rev);
    w.put_bytes(it->first);
    w.put_bytes(it->second.value);
  }
  if (!w.fits()) return -(w.size() + SIZE_HINT_BASE);  // size hint: grow + retry
  return w.size();
}

// All-or-nothing multi-key CAS commit (the binding tile fast path,
// core/store.py batch). expect_revs[i] 0 = no per-key CAS check.
int64_t kv_batch(void* h, uint64_t n, const char** keys,
                 const uint8_t** vals, const uint64_t* val_lens,
                 const uint64_t* expect_revs) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->gc(now_seconds());
  // validate everything first: a mid-batch failure commits nothing
  for (uint64_t i = 0; i < n; ++i) {
    auto it = s->data.find(keys[i]);
    if (it == s->data.end()) return ERR_NOT_FOUND;
    if (expect_revs[i] != 0 && it->second.mod_rev != expect_revs[i])
      return ERR_CONFLICT;
  }
  int64_t first_rev = 0;
  for (uint64_t i = 0; i < n; ++i) {
    auto it = s->data.find(keys[i]);
    uint64_t rev = s->bump();
    if (first_rev == 0) first_rev = static_cast<int64_t>(rev);
    it->second.value.assign(reinterpret_cast<const char*>(vals[i]),
                            val_lens[i]);
    it->second.mod_rev = rev;
    s->emit(rev, EventType::Modified, it->first, rev, it->second.value);
  }
  return first_rev;
}

// Batched create: every key must be absent (including duplicates
// WITHIN the batch) or nothing commits — the write-side analogue of
// kv_batch. Returns the first assigned revision, or ERR_EXISTS.
int64_t kv_create_batch(void* h, uint64_t n, const char** keys,
                        const uint8_t** vals, const uint64_t* val_lens,
                        const double* ttls) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  double now = now_seconds();
  s->gc(now);
  std::set<std::string> seen;
  for (uint64_t i = 0; i < n; ++i) {
    std::string k(keys[i]);
    if (s->data.count(k) || !seen.insert(k).second) return ERR_EXISTS;
  }
  int64_t first_rev = 0;
  for (uint64_t i = 0; i < n; ++i) {
    std::string k(keys[i]);
    uint64_t rev = s->bump();
    if (first_rev == 0) first_rev = static_cast<int64_t>(rev);
    Entry e{std::string(reinterpret_cast<const char*>(vals[i]),
                        val_lens[i]),
            rev, ttls[i] > 0 ? now + ttls[i] : 0};
    s->note_expiry(e.expiry);
    s->data[k] = e;
    s->emit(rev, EventType::Added, k, rev, e.value);
  }
  return first_rev;
}

// Events with rev > since_rev for keys under prefix.
// Layout: u32 count | event records... Returns bytes used, or
// -(required + SIZE_HINT_BASE) if the buffer is too small, or ERR_EXPIRED.
int64_t kv_events(void* h, uint64_t since_rev, const char* prefix,
                  uint8_t* buf, int64_t buflen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (since_rev < s->oldest_rev) return ERR_EXPIRED;
  std::string p(prefix);
  Writer w(buf, buflen);
  // history is revision-ordered: binary-search the resume point so a
  // watcher poll costs O(log n + new events), not a full window scan
  auto begin = std::upper_bound(
      s->history.begin(), s->history.end(), since_rev,
      [](uint64_t rev, const Event& e) { return rev < e.rev; });
  uint32_t count = 0;
  for (auto it = begin; it != s->history.end(); ++it) {
    if (it->key.compare(0, p.size(), p) == 0) ++count;
  }
  w.put<uint32_t>(count);
  for (auto it = begin; it != s->history.end(); ++it) {
    const Event& e = *it;
    if (e.key.compare(0, p.size(), p) != 0) continue;
    w.put<uint64_t>(e.rev);
    w.put<uint8_t>(static_cast<uint8_t>(e.type));
    w.put_bytes(e.key);
    w.put<uint64_t>(e.obj_rev);
    w.put_bytes(e.value);
  }
  if (!w.fits()) return -(w.size() + SIZE_HINT_BASE);
  return w.size();
}

// ---------------------------------------------------------- recovery
// WAL recovery entry points (core/wal.py + NativeStore.recover): the
// Python side reads the snapshot + record tail and replays it here.

// Insert one snapshot entry with its original mod_rev and absolute
// expiry, emitting NO history event (snapshot state predates the
// replayable window). Advances the revision counter monotonically.
int64_t kv_restore(void* h, const char* key, const uint8_t* val,
                   uint64_t val_len, uint64_t mod_rev, double expiry) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  Entry e{std::string(reinterpret_cast<const char*>(val), val_len),
          mod_rev, expiry};
  s->note_expiry(expiry);
  s->data[std::string(key)] = e;
  if (mod_rev > s->rev) s->rev = mod_rev;
  return static_cast<int64_t>(mod_rev);
}

// Seal the snapshot restore point: revisions <= rev are not
// replayable from history (the watch-window meaning of oldest_rev).
void kv_restore_seal(void* h, uint64_t rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (rev > s->rev) s->rev = rev;
  s->oldest_rev = rev;
}

// Replay one ledger record at EXACTLY the given revision (the WAL
// tail). Unlike the write verbs, no gc runs and no revision is
// assigned here — the record's revision is authoritative, so replay
// reproduces the pre-crash ledger prefix bit-identically. obj_rev is
// the resourceVersion the delivered event stamps (pre-delete mod_rev
// for DELETED records).
int64_t kv_replay(void* h, uint64_t rev, uint8_t type, const char* key,
                  const uint8_t* val, uint64_t val_len, uint64_t obj_rev,
                  double expiry) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (rev <= s->rev) return ERR_CONFLICT;
  s->rev = rev;
  std::string k(key);
  std::string v(reinterpret_cast<const char*>(val), val_len);
  if (type == static_cast<uint8_t>(EventType::Deleted)) {
    s->data.erase(k);
    s->emit(rev, EventType::Deleted, k, obj_rev, v);
  } else {
    Entry e{v, rev, expiry};
    s->note_expiry(expiry);
    s->data[k] = e;
    s->emit(rev, static_cast<EventType>(type), k, rev, v);
  }
  return static_cast<int64_t>(rev);
}

// Replay one TXN frame's whole window (core/wal.py TXN records) in
// ONE lock window: the frame was one CRC unit on disk, so it recovers
// as one atomic unit in the engine too — mirroring kv_batch's commit
// shape. Revisions must be consecutive and start strictly after the
// current revision; per-record semantics are exactly kv_replay's.
// Returns the last replayed revision, or ERR_CONFLICT.
int64_t kv_replay_txn(void* h, uint64_t n, const uint64_t* revs,
                      const uint8_t* types, const char** keys,
                      const uint8_t** vals, const uint64_t* val_lens,
                      const uint64_t* obj_revs, const double* expiries) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (n == 0) return static_cast<int64_t>(s->rev);
  if (revs[0] <= s->rev) return ERR_CONFLICT;
  for (uint64_t i = 1; i < n; ++i)
    if (revs[i] != revs[0] + i) return ERR_CONFLICT;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t rev = revs[i];
    s->rev = rev;
    std::string k(keys[i]);
    std::string v(reinterpret_cast<const char*>(vals[i]), val_lens[i]);
    if (types[i] == static_cast<uint8_t>(EventType::Deleted)) {
      s->data.erase(k);
      s->emit(rev, EventType::Deleted, k, obj_revs[i], v);
    } else {
      Entry e{v, rev, expiries[i]};
      s->note_expiry(expiries[i]);
      s->data[k] = e;
      s->emit(rev, static_cast<EventType>(types[i]), k, rev, v);
    }
  }
  return static_cast<int64_t>(s->rev);
}

// Block until the watch-visible revision exceeds since_rev (or
// timeout, or shutdown). In ring mode that is published_rev — history
// only ever holds published events, so waking on the ledger revision
// would busy-spin watchers against not-yet-drained commits. Returns
// the watch-visible revision. ctypes releases the GIL around this, so
// watcher threads park in native code, not in Python polling loops.
uint64_t kv_wait(void* h, uint64_t since_rev, double timeout_seconds) {
  Store* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait_for(
      lk, std::chrono::duration<double>(timeout_seconds), [&] {
        return s->stopping ||
               (s->ring_mode ? s->published_rev : s->rev) > since_rev;
      });
  return s->ring_mode ? s->published_rev : s->rev;
}

// ------------------------------------------------------ native commit path

// Flip the store into ring mode and start the native publisher.
// Idempotent. From here on every committed event batch is published
// by the native thread, in enqueue (= revision) order.
int64_t kv_publish_start(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (s->ring_mode) return 0;
  if (s->stopping) return ERR_CONFLICT;
  s->ring_mode = true;
  s->published_rev = s->rev;
  s->publisher = std::thread(publisher_main, s);
  return 0;
}

// Wait until the publisher has caught up with the ledger (or timeout/
// shutdown). Returns the watch-visible revision. The committer's
// drain barrier uses this so "drained" keeps meaning "visible to
// watchers" on the native path, matching Store._drain_publish.
uint64_t kv_publish_flush(void* h, double timeout_seconds) {
  Store* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait_for(lk, std::chrono::duration<double>(timeout_seconds), [&] {
    return s->stopping || !s->ring_mode || s->published_rev >= s->rev;
  });
  return s->ring_mode ? s->published_rev : s->rev;
}

// Attach the native WAL appender. The directory must exist (the
// Python side creates it); fsync_always != 0 = fsync every commit,
// else WalWriter's 50ms batch cadence. segment_records mirrors
// WalWriter: rotate after that many LOGICAL records (0 = never).
int64_t kv_wal_attach(void* h, const char* dir, int fsync_always,
                      uint64_t segment_records) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->wal_dir = dir;
  s->wal_fsync_always = fsync_always != 0;
  s->wal_seg_limit = segment_records;
  s->wal_attached = true;
  return 0;
}

// kv_get plus the entry's absolute TTL deadline (0 = none) — the
// commit staging path needs it to carry expiry into WAL records the
// way Store.commit_txn journals the preserved entry expiry.
int64_t kv_get_ex(void* h, const char* key, uint8_t* buf, int64_t buflen,
                  uint64_t* mod_rev, double* expiry) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->gc(now_seconds());
  std::string k(key);
  auto it = s->data.find(k);
  if (it == s->data.end()) return ERR_NOT_FOUND;
  const std::string& v = it->second.value;
  *mod_rev = it->second.mod_rev;
  *expiry = it->second.expiry;
  if (static_cast<int64_t>(v.size()) > buflen) return ERR_TOO_SMALL;
  std::memcpy(buf, v.data(), v.size());
  return static_cast<int64_t>(v.size());
}

// Engine counters: [commits, ledger_ns, published_batches, publish_ns,
// wal_frames, wal_bytes, rev, published_rev]. The ledger/publish
// split a Python sampler cannot see (native threads have no frames).
void kv_stats(void* h, uint64_t* out) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  out[0] = s->commits;
  out[1] = s->ledger_ns;
  out[2] = s->published_batches;
  out[3] = s->publish_ns;
  out[4] = s->wal_frames;
  out[5] = s->wal_bytes;
  out[6] = s->rev;
  out[7] = s->ring_mode ? s->published_rev : s->rev;
}

// The native commit path: apply n records under ONE mutex window at a
// PRE-ASSIGNED revision window (first_rev .. first_rev+n-1), append
// the caller-built WAL payload(s) with native framing, and hand the
// ordered event batch to the publish ring. The caller stages
// optimistically (reads, runs update fns, stamps resourceVersions,
// builds payload bytes through core/wal.py's shared codec) and
// retries on ERR_RACED when another writer claimed the window —
// revisions inside values/payloads must match the ones assigned here,
// which is exactly what the window check guarantees.
//
// types[i]: 0 ADDED (key must be absent, also intra-batch), 1
// MODIFIED / 2 DELETED (key must exist; expect_revs[i] != 0 is a CAS
// on mod_rev). expiries[i] is an ABSOLUTE deadline (0 = none;
// MODIFIED carries the caller-read old expiry over, like kv_update).
// For DELETED, vals[i] is the pre-delete wire (the event value).
// Validation is all-or-nothing: nothing commits on any failure.
//
// frames: n_frames payloads to journal — one TXN payload for a
// transaction, or n flat record payloads (frame j names a fresh
// segment after revision first_rev + j, the WalWriter naming rule).
int64_t kv_commit_txn(void* h, uint64_t n, uint64_t first_rev,
                      const uint8_t* types, const char** keys,
                      const uint8_t** vals, const uint64_t* val_lens,
                      const uint64_t* expect_revs, const double* expiries,
                      uint64_t n_frames, const uint8_t** frames,
                      const uint64_t* frame_lens) {
  Store* s = static_cast<Store*>(h);
  uint64_t t0 = mono_ns();
  std::lock_guard<std::mutex> lk(s->mu);
  double now = now_seconds();
  s->gc(now);  // may bump revisions (and journal) — then the window check
  if (n == 0) return static_cast<int64_t>(s->rev);
  if (first_rev != s->rev + 1) return ERR_RACED;
  std::set<std::string> fresh;  // keys ADDED earlier in this batch
  for (uint64_t i = 0; i < n; ++i) {
    std::string k(keys[i]);
    bool exists = s->data.count(k) != 0 || fresh.count(k) != 0;
    if (types[i] == static_cast<uint8_t>(EventType::Added)) {
      if (exists) return ERR_EXISTS;
      fresh.insert(k);
    } else {
      if (!exists) return ERR_NOT_FOUND;
      if (expect_revs[i] != 0) {
        auto it = s->data.find(k);
        if (it == s->data.end() || it->second.mod_rev != expect_revs[i])
          return ERR_CONFLICT;
      }
    }
  }
  std::vector<Event> batch;
  batch.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t rev = s->bump();
    std::string k(keys[i]);
    std::string v(reinterpret_cast<const char*>(vals[i]), val_lens[i]);
    if (types[i] == static_cast<uint8_t>(EventType::Deleted)) {
      auto it = s->data.find(k);
      uint64_t obj_rev = (it != s->data.end()) ? it->second.mod_rev : rev;
      if (it != s->data.end()) s->data.erase(it);
      batch.push_back(Event{rev, EventType::Deleted, k, obj_rev, v});
    } else {
      Entry e{v, rev, expiries[i] > 0 ? expiries[i] : 0};
      s->note_expiry(e.expiry);
      s->data[k] = std::move(e);
      batch.push_back(Event{rev, static_cast<EventType>(types[i]), k, rev,
                            std::move(v)});
    }
  }
  if (s->wal_attached && n_frames > 0) {
    for (uint64_t j = 0; j < n_frames; ++j)
      s->wal_write_frame(frames[j], frame_lens[j], first_rev + j);
    s->wal_commit_done(n);
  }
  s->publish(std::move(batch));
  s->commits++;
  s->ledger_ns += mono_ns() - t0;
  return static_cast<int64_t>(first_rev);
}

}  // extern "C"
