// tructstore — crash-safe KV store with append-only log persistence and
// disk-resident large values.
//
// Native host-side storage for the TPU search engine, replacing the role LMDB
// plays in the reference design (source-of-truth asset store, exact-match
// dupsort databases, metadata). Design goals mirror the reference's
// consistency model (SURVEY §5: LMDB commits per batch; derived device
// indexes are rebuildable):
//
//   - Named sub-databases, two kinds:
//       * plain:   key -> single value (replace on put)
//       * dupsort: key -> sorted set of values (insert/delete individual values)
//   - Ordered keys with prefix range scans (needed for bidirectional
//     ISCC prefix matching).
//   - Durability: every mutation is framed (CRC32) and appended to store.log.
//     A torn tail is truncated on recovery. fsync only on explicit sync()
//     (parity with the reference's sync=False LMDB usage).
//   - Compaction: snapshot rewrite (store.snap) + log truncation, atomic via
//     temp+rename. Open() loads snapshot then replays the log, streaming both
//     (no full-file buffering).
//   - Value externalization (WiscKey-style, mirroring LMDB's page-cache-backed
//     working set): plain values >= TRUCTSTORE_EXT_MIN bytes (default 64) are
//     NOT copied into RAM. The in-memory map keeps (file, offset, length)
//     pointing at the value bytes already inside the log/snapshot, and reads
//     pread() them on demand (OS page cache keeps hot values memory-speed).
//     Keys, small values, and dupsort values (8-24 byte ISCC bodies/pointers)
//     stay inline — they ARE the search structure. The on-disk format is
//     unchanged; externalization is purely an in-memory residency policy.
//
// Exposed as a C ABI consumed via ctypes (iscc_search_tpu/store/kv.py).
// Thread safety: a std::shared_mutex allows concurrent readers; writers are
// exclusive (the engine additionally serializes writers, mirroring the
// reference's single-writer lock). pread() keeps reads lock-compatible.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// CRC32 (standard polynomial, table-driven)
// ---------------------------------------------------------------------------

uint32_t crc32_table[256];
std::once_flag crc32_once;  // ts_open can race from two threads (no GIL held)

void crc32_init() {
    std::call_once(crc32_once, [] {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            crc32_table[i] = c;
        }
    });
}

uint32_t crc32(const uint8_t* data, size_t len, uint32_t seed = 0) {
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++) c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Store structures
// ---------------------------------------------------------------------------

using Bytes = std::string;

// Where a plain value's bytes live when not held in RAM. SRC_LOG0 is the
// rotated previous log during (or after a crash within) an incremental
// compaction — see ts_compact.
enum ValSrc : uint8_t { SRC_INLINE = 0, SRC_LOG = 1, SRC_SNAP = 2, SRC_LOG0 = 3 };

struct ValRef {
    uint64_t off = 0;
    uint32_t len = 0;
    uint8_t src = SRC_INLINE;
};

struct Entry {
    // dupsort: sorted unique values; plain: single inline value at [0]
    // (empty when the plain value is external — see ref).
    std::vector<Bytes> vals;
    ValRef ref;  // plain external value when ref.src != SRC_INLINE
};

struct Db {
    bool dupsort = false;
    std::map<Bytes, Entry> data;
    size_t entries = 0;  // plain: #keys; dupsort: #(key,value) pairs
    size_t bytes = 0;    // approximate logical payload bytes
};

enum Op : uint8_t {
    OP_PUT = 1,       // plain put (replace)
    OP_DEL = 2,       // plain delete key
    OP_DUP_PUT = 3,   // dupsort insert value
    OP_DUP_DEL = 4,   // dupsort delete value
    OP_DROP_DB = 5,   // remove a whole sub-db
};

struct Store {
    std::string dir;
    int log_fd = -1;    // O_WRONLY append handle
    int log_rfd = -1;   // O_RDONLY handle for external value pread
    int log0_rfd = -1;  // O_RDONLY handle for the rotated log (compaction)
    int snap_rfd = -1;  // O_RDONLY handle for the current snapshot (-1 = none)
    bool compacting = false;  // an incremental compaction is in flight
    std::condition_variable_any compact_cv;  // signaled when compacting clears
    std::unordered_map<std::string, Db> dbs;
    mutable std::shared_mutex mtx;
    std::string wbuf;         // pending appends not yet written to the fd
    uint64_t log_bytes = 0;   // log bytes already written to the fd
    uint32_t ext_min = 64;    // externalize plain values >= this; 0 disables
    mutable std::mutex err_mtx;  // guards last_error (written from shared-lock paths too)
    std::string last_error;

    void set_error(const std::string& msg) {
        std::lock_guard<std::mutex> g(err_mtx);
        last_error = msg;
    }

    ~Store() {  // error paths in ts_open must not leak fds
        if (log_fd >= 0) ::close(log_fd);
        if (log_rfd >= 0) ::close(log_rfd);
        if (log0_rfd >= 0) ::close(log0_rfd);
        if (snap_rfd >= 0) ::close(snap_rfd);
    }
};

// Mutation size caps: a db name over u16 or a payload over u32 would be
// silently truncated by the record framing, producing a log record whose
// declared lengths mismatch its bytes — recovery would then stop there and
// drop every later committed record. Reject at the ABI boundary instead.
constexpr size_t MAX_DB_NAME = 65535;
constexpr size_t MAX_KEY_LEN = 1u << 20;        // 1 MiB (ISCC keys are <= 40 B)
constexpr size_t MAX_VAL_LEN = 1u << 30;        // 1 GiB

bool check_sizes(Store& s, const char* db, size_t klen, size_t vlen) {
    if (strlen(db) > MAX_DB_NAME || klen > MAX_KEY_LEN || vlen > MAX_VAL_LEN) {
        s.set_error("mutation exceeds size limits (db<=64KB, key<=1MB, val<=1GB)");
        return false;
    }
    return true;
}

size_t plain_len(const Entry& e) {
    return e.ref.src != SRC_INLINE ? e.ref.len : (e.vals.empty() ? 0 : e.vals[0].size());
}

// Read an external value's bytes. Shared lock must be held (pread keeps the
// fd offset untouched, so concurrent readers are safe; bytes still in wbuf
// are served from memory).
bool read_val(const Store& s, const ValRef& r, Bytes& out) {
    out.resize(r.len);
    if (r.len == 0) return true;
    if (r.src == SRC_LOG && r.off >= s.log_bytes) {
        uint64_t woff = r.off - s.log_bytes;
        if (woff + r.len > s.wbuf.size()) return false;
        memcpy(out.data(), s.wbuf.data() + woff, r.len);
        return true;
    }
    int fd = r.src == SRC_LOG ? s.log_rfd : (r.src == SRC_LOG0 ? s.log0_rfd : s.snap_rfd);
    if (fd < 0) return false;
    size_t done = 0;
    while (done < r.len) {
        ssize_t n = ::pread(fd, out.data() + done, r.len - done, static_cast<off_t>(r.off + done));
        if (n <= 0) {
            if (n < 0 && errno == EINTR) continue;
            return false;
        }
        done += static_cast<size_t>(n);
    }
    return true;
}

// Plain value bytes (inline or external) as an owned copy.
bool plain_value(const Store& s, const Entry& e, Bytes& out) {
    if (e.ref.src != SRC_INLINE) return read_val(s, e.ref, out);
    out = e.vals.empty() ? Bytes() : e.vals[0];
    return true;
}

// Record framing: [u32 payload_len][payload][u32 crc(payload)]
// payload: [u8 op][u16 db_len][db][u32 key_len][key][u32 val_len][val]

void put_u16(std::string& out, uint16_t v) { out.append(reinterpret_cast<char*>(&v), 2); }
void put_u32(std::string& out, uint32_t v) { out.append(reinterpret_cast<char*>(&v), 4); }

// Byte offset of the value field inside a record that starts at rec_off.
uint64_t value_off(uint64_t rec_off, size_t dblen, size_t klen) {
    return rec_off + 4 + 1 + 2 + dblen + 4 + klen + 4;
}

void encode_record(std::string& out, uint8_t op, const std::string& db, const Bytes& key, const Bytes& val) {
    std::string payload;
    payload.reserve(1 + 2 + db.size() + 4 + key.size() + 4 + val.size());
    payload.push_back(static_cast<char>(op));
    put_u16(payload, static_cast<uint16_t>(db.size()));
    payload.append(db);
    put_u32(payload, static_cast<uint32_t>(key.size()));
    payload.append(key);
    put_u32(payload, static_cast<uint32_t>(val.size()));
    payload.append(val);
    put_u32(out, static_cast<uint32_t>(payload.size()));
    out.append(payload);
    put_u32(out, crc32(reinterpret_cast<const uint8_t*>(payload.data()), payload.size()));
}

// Apply a mutation to in-memory state. Returns true if state changed. When
// `ref` is non-null (plain put of an externalized value), `val` may be empty
// and the entry stores the reference instead of the bytes.
bool apply(Store& s, uint8_t op, const std::string& dbname, const Bytes& key, const Bytes& val,
           const ValRef* ref = nullptr) {
    if (op == OP_DROP_DB) {
        return s.dbs.erase(dbname) > 0;
    }
    Db& db = s.dbs[dbname];
    switch (op) {
        case OP_PUT: {
            // Reject kind flips instead of silently corrupting the entry and
            // byte accounting (LMDB would raise MDB_INCOMPATIBLE here).
            if (db.dupsort && db.entries > 0) return false;
            db.dupsort = false;
            size_t new_len = ref ? ref->len : val.size();
            auto it = db.data.find(key);
            if (it == db.data.end()) {
                Entry e;
                if (ref) {
                    e.ref = *ref;
                } else {
                    e.vals.push_back(val);
                }
                db.data.emplace(key, std::move(e));
                db.entries += 1;
                db.bytes += key.size() + new_len;
            } else {
                db.bytes += new_len;
                db.bytes -= plain_len(it->second);
                it->second.vals.clear();
                if (ref) {
                    it->second.ref = *ref;
                } else {
                    it->second.ref = ValRef{};
                    it->second.vals.push_back(val);
                }
            }
            return true;
        }
        case OP_DEL: {
            auto it = db.data.find(key);
            if (it == db.data.end()) return false;
            db.bytes -= key.size();
            if (db.dupsort) {
                for (const auto& v : it->second.vals) db.bytes -= v.size();
                db.entries -= it->second.vals.size();
            } else {
                db.bytes -= plain_len(it->second);
                db.entries -= 1;
            }
            db.data.erase(it);
            return true;
        }
        case OP_DUP_PUT: {
            if (!db.dupsort && db.entries > 0) return false;  // kind mismatch
            db.dupsort = true;
            auto& vec = db.data[key].vals;
            auto pos = std::lower_bound(vec.begin(), vec.end(), val);
            if (pos != vec.end() && *pos == val) return false;  // dupdata=False semantics
            vec.insert(pos, val);
            db.entries += 1;
            db.bytes += (vec.size() == 1 ? key.size() : 0) + val.size();
            return true;
        }
        case OP_DUP_DEL: {
            auto it = db.data.find(key);
            if (it == db.data.end()) return false;
            auto& vec = it->second.vals;
            auto pos = std::lower_bound(vec.begin(), vec.end(), val);
            if (pos == vec.end() || *pos != val) return false;
            vec.erase(pos);
            db.entries -= 1;
            db.bytes -= val.size();
            if (vec.empty()) {
                db.bytes -= key.size();
                db.data.erase(it);
            }
            return true;
        }
        default:
            return false;
    }
}

// Log a mutation (append to write buffer) and apply it. Plain puts at or
// above ext_min are applied as a reference into the log bytes just encoded.
bool log_and_apply(Store& s, uint8_t op, const std::string& dbname, const Bytes& key, const Bytes& val) {
    if (op == OP_PUT && s.ext_min && val.size() >= s.ext_min) {
        {   // kind precheck BEFORE logging (this path logs unconditionally)
            Db& db = s.dbs[dbname];
            if (db.dupsort && db.entries > 0) return false;
        }
        uint64_t rec_off = s.log_bytes + s.wbuf.size();
        encode_record(s.wbuf, op, dbname, key, val);
        ValRef ref{value_off(rec_off, dbname.size(), key.size()), static_cast<uint32_t>(val.size()), SRC_LOG};
        apply(s, op, dbname, key, Bytes(), &ref);  // OP_PUT always changes state
        return true;
    }
    bool changed = apply(s, op, dbname, key, val);
    if (changed) encode_record(s.wbuf, op, dbname, key, val);
    return changed;
}

bool flush_wbuf(Store& s) {
    if (s.wbuf.empty()) return true;
    // pwrite at absolute offsets: a partially-failed flush (ENOSPC etc.)
    // can be retried without duplicating the already-written prefix.
    size_t done = 0;
    while (done < s.wbuf.size()) {
        ssize_t n = ::pwrite(s.log_fd, s.wbuf.data() + done, s.wbuf.size() - done,
                             static_cast<off_t>(s.log_bytes + done));
        if (n < 0) {
            if (errno == EINTR) continue;
            s.set_error(std::string("log write failed: ") + strerror(errno));
            return false;
        }
        done += static_cast<size_t>(n);
    }
    s.log_bytes += s.wbuf.size();
    s.wbuf.clear();
    return true;
}

// Parse one framed record at buf[off..]; returns consumed bytes (0 = torn /
// incomplete / corrupt tail — stop). On success fills the out-params.
size_t parse_record(const std::string& buf, size_t off, uint8_t& op, std::string& dbname, Bytes& key, Bytes& val,
                    size_t& val_in_rec) {
    if (off + 8 > buf.size()) return 0;
    uint32_t plen;
    memcpy(&plen, buf.data() + off, 4);
    if (off + 4 + plen + 4 > buf.size()) return 0;  // torn tail
    const uint8_t* payload = reinterpret_cast<const uint8_t*>(buf.data()) + off + 4;
    uint32_t stored_crc;
    memcpy(&stored_crc, buf.data() + off + 4 + plen, 4);
    if (crc32(payload, plen) != stored_crc) return 0;  // corrupt tail
    size_t p = 0;
    if (plen < 1 + 2 + 4 + 4) return 0;
    op = payload[p];
    p += 1;
    uint16_t dblen;
    memcpy(&dblen, payload + p, 2);
    p += 2;
    if (p + dblen + 4 > plen) return 0;
    dbname.assign(reinterpret_cast<const char*>(payload + p), dblen);
    p += dblen;
    uint32_t klen;
    memcpy(&klen, payload + p, 4);
    p += 4;
    if (p + klen + 4 > plen) return 0;
    key.assign(reinterpret_cast<const char*>(payload + p), klen);
    p += klen;
    uint32_t vlen;
    memcpy(&vlen, payload + p, 4);
    p += 4;
    if (p + vlen != plen) return 0;
    val.assign(reinterpret_cast<const char*>(payload + p), vlen);
    val_in_rec = 4 + p;  // value offset relative to record start
    return 4 + plen + 4;
}

// Stream-replay framed records from an open file; stops cleanly at a torn
// tail. Returns false on an I/O READ error (which must NOT be treated as
// EOF: the caller would otherwise truncate the log at the error point and
// permanently destroy committed records after a transient EIO). On success
// sets `consumed` to the number of bytes of valid records.
bool replay_fd(Store& s, int fd, uint8_t src, size_t& consumed) {
    constexpr size_t CHUNK = 4 << 20;
    std::string buf;
    size_t base = 0;  // file offset of buf[0]
    consumed = 0;
    bool eof = false;
    while (true) {
        if (!eof) {
            size_t old = buf.size();
            buf.resize(old + CHUNK);
            ssize_t n = ::read(fd, buf.data() + old, CHUNK);
            if (n < 0) {
                if (errno == EINTR) {
                    buf.resize(old);
                    continue;
                }
                s.set_error(std::string("replay read failed: ") + strerror(errno));
                return false;
            } else {
                buf.resize(old + static_cast<size_t>(n));
                if (static_cast<size_t>(n) < CHUNK) eof = true;
            }
        }
        size_t off = 0;
        while (true) {
            uint8_t op;
            std::string dbname;
            Bytes key, val;
            size_t val_in_rec = 0;
            size_t used = parse_record(buf, off, op, dbname, key, val, val_in_rec);
            if (used == 0) break;
            if (op == OP_PUT && s.ext_min && val.size() >= s.ext_min) {
                ValRef ref{base + off + val_in_rec, static_cast<uint32_t>(val.size()), src};
                apply(s, op, dbname, key, Bytes(), &ref);
            } else {
                apply(s, op, dbname, key, val);
            }
            off += used;
        }
        consumed = base + off;
        if (eof && off == 0) break;  // nothing more parseable
        // Keep the unparsed tail, slide the window
        buf.erase(0, off);
        base += off;
        if (eof) {
            // A final partial record that can never complete
            break;
        }
    }
    return true;
}

// Buffered sequential file writer for snapshot streaming.
struct FileWriter {
    int fd = -1;
    std::string buf;
    uint64_t written = 0;
    bool ok = true;

    uint64_t offset() const { return written + buf.size(); }

    void append(const std::string& data) {
        buf.append(data);
        if (buf.size() >= (4u << 20)) flush();
    }

    void flush() {
        size_t off = 0;
        while (off < buf.size()) {
            ssize_t n = ::write(fd, buf.data() + off, buf.size() - off);
            if (n < 0) {
                if (errno == EINTR) continue;
                ok = false;
                return;
            }
            off += static_cast<size_t>(n);
        }
        written += buf.size();
        buf.clear();
    }
};

// Snapshot format: same framed records as the log (a full replayable state
// dump), so one decoder serves both files. Streams records to disk (memory
// use is bounded by the write buffer, not the dataset) and collects the
// post-compaction value references to swap in after the atomic rename.
struct PendingRef {
    Entry* entry;
    ValRef ref;
};

bool sync_dir(Store& s) {
    int dfd = ::open(s.dir.c_str(), O_DIRECTORY | O_RDONLY);
    if (dfd < 0) {
        s.set_error(std::string("dir open failed: ") + strerror(errno));
        return false;
    }
    bool ok = fsync(dfd) == 0;
    ::close(dfd);
    if (!ok) s.set_error(std::string("dir fsync failed: ") + strerror(errno));
    return ok;
}

bool write_snapshot(Store& s, std::vector<PendingRef>& pending) {
    std::string tmp_path = s.dir + "/store.snap.tmp";
    std::string snap_path = s.dir + "/store.snap";
    FileWriter w;
    w.fd = ::open(tmp_path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (w.fd < 0) {
        s.set_error(std::string("snapshot open failed: ") + strerror(errno));
        return false;
    }
    std::string rec;
    Bytes vbuf;
    for (auto& [dbname, db] : s.dbs) {
        for (auto& [key, entry] : db.data) {
            if (db.dupsort) {
                for (const auto& v : entry.vals) {
                    rec.clear();
                    encode_record(rec, OP_DUP_PUT, dbname, key, v);
                    w.append(rec);
                }
            } else {
                if (!plain_value(s, entry, vbuf)) {
                    s.set_error("snapshot: external value read failed");
                    ::close(w.fd);
                    ::unlink(tmp_path.c_str());
                    return false;
                }
                uint64_t rec_off = w.offset();
                rec.clear();
                encode_record(rec, OP_PUT, dbname, key, vbuf);
                w.append(rec);
                if (s.ext_min && vbuf.size() >= s.ext_min) {
                    pending.push_back(
                        {&entry,
                         ValRef{value_off(rec_off, dbname.size(), key.size()),
                                static_cast<uint32_t>(vbuf.size()), SRC_SNAP}});
                }
            }
            if (!w.ok) break;
        }
        if (!w.ok) break;
    }
    w.flush();
    if (!w.ok) {
        s.set_error("snapshot write failed");
        ::close(w.fd);
        ::unlink(tmp_path.c_str());
        return false;
    }
    if (fdatasync(w.fd) != 0 || ::close(w.fd) != 0) {
        s.set_error("snapshot sync failed");
        ::unlink(tmp_path.c_str());
        return false;
    }
    if (::rename(tmp_path.c_str(), snap_path.c_str()) != 0) {
        s.set_error(std::string("snapshot rename failed: ") + strerror(errno));
        return false;
    }
    // Make the rename itself durable before the caller truncates the log:
    // on strict-POSIX/non-journaled filesystems a crash could otherwise
    // persist the truncation while losing the rename, dropping committed data.
    if (!sync_dir(s)) return false;
    return true;
}

// Full-stall compaction: write a snapshot and truncate the log, all under
// the caller-held EXCLUSIVE lock. External value references are rewritten to
// the new snapshot before the log is truncated, so no reference can dangle;
// on any failure the old refs (and old files) stay valid. Used at open
// (store.log.0 residue, no concurrency) and as the fallback when residue
// blocks the incremental path.
int compact_full(Store& s) {
    if (!flush_wbuf(s)) return 0;
    std::vector<PendingRef> pending;
    if (!write_snapshot(s, pending)) return 0;
    // Open the NEW snapshot's read fd BEFORE swapping refs or truncating:
    // if this open fails (EMFILE...), the old refs, the old snap fd (which
    // keeps the replaced inode alive), and the intact log keep every value
    // readable, and the next compact simply retries.
    int new_rfd = ::open((s.dir + "/store.snap").c_str(), O_RDONLY);
    if (new_rfd < 0) {
        s.set_error(std::string("snapshot reopen failed: ") + strerror(errno));
        return 0;
    }
    // Snapshot is durably in place: point refs at it and swap the read fd.
    for (auto& p : pending) {
        p.entry->vals.clear();
        p.entry->ref = p.ref;
    }
    if (s.snap_rfd >= 0) ::close(s.snap_rfd);
    s.snap_rfd = new_rfd;
    // The snapshot covers the rotated log too (it dumps full state): the
    // residue file and its refs (all swapped to SRC_SNAP above) are obsolete.
    if (s.log0_rfd >= 0) {
        ::close(s.log0_rfd);
        s.log0_rfd = -1;
        ::unlink((s.dir + "/store.log.0").c_str());
    }
    // From here every ref is valid against the new snapshot; a failed log
    // truncation just means the (idempotent) log replays over it next open.
    if (ftruncate(s.log_fd, 0) != 0) return 0;
    if (lseek(s.log_fd, 0, SEEK_SET) < 0) return 0;
    s.log_bytes = 0;
    return 1;
}

// Pending reference swap for the incremental compaction: identified by
// (db, key, old ref) instead of Entry* — the entry may be deleted or
// rewritten while the snapshot streams, and the swap must then be skipped
// (the new value's bytes live in the new log, which survives compaction).
struct PendingKeyRef {
    std::string db;
    Bytes key;
    ValRef oldref;
    ValRef newref;
};

bool same_ref(const ValRef& a, const ValRef& b) {
    return a.src == b.src && a.off == b.off && a.len == b.len;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Opens (creating if needed) a store rooted at `dir`. Returns handle or null.
// TRUCTSTORE_EXT_MIN overrides the externalization threshold (bytes; 0
// disables and keeps every value in RAM).
void* ts_open(const char* dir) {
    crc32_init();
    auto s = std::make_unique<Store>();
    s->dir = dir;
    ::mkdir(dir, 0755);
    if (const char* env = getenv("TRUCTSTORE_EXT_MIN")) {
        s->ext_min = static_cast<uint32_t>(strtoul(env, nullptr, 10));
    }

    // A crash between snapshot write and rename leaves a stale tmp file;
    // it was never the committed snapshot, so drop it.
    ::unlink((s->dir + "/store.snap.tmp").c_str());

    std::string snap_path = s->dir + "/store.snap";
    int sfd = ::open(snap_path.c_str(), O_RDONLY);
    if (sfd >= 0) {
        size_t snap_consumed = 0;
        bool ok = replay_fd(*s, sfd, SRC_SNAP, snap_consumed);
        struct stat st {};
        bool sized = fstat(sfd, &st) == 0;
        ::close(sfd);
        // Snapshots are written atomically (tmp + fdatasync + rename), so a
        // read error OR a partial parse means real corruption — fail the
        // open loudly (LMDB MDB_CORRUPTED parity) instead of silently
        // serving a store missing an arbitrary suffix of compacted keys.
        if (!ok || !sized || snap_consumed != static_cast<size_t>(st.st_size)) {
            return nullptr;
        }
        s->snap_rfd = ::open(snap_path.c_str(), O_RDONLY);
        if (s->snap_rfd < 0) return nullptr;  // externalized values need it
    }

    // Rotated-log residue from a crash mid-incremental-compaction: replay it
    // between the snapshot and the live log (its ops are older than the
    // log's). Values stay readable through log0_rfd; the first explicit
    // compact (or the post-open compact below) retires the file.
    std::string log0_path = s->dir + "/store.log.0";
    int l0fd = ::open(log0_path.c_str(), O_RDONLY);
    bool had_log0 = l0fd >= 0;
    if (had_log0) {
        size_t consumed = 0;
        bool ok = replay_fd(*s, l0fd, SRC_LOG0, consumed);
        ::close(l0fd);
        if (!ok) return nullptr;
        s->log0_rfd = ::open(log0_path.c_str(), O_RDONLY);
        if (s->log0_rfd < 0) return nullptr;
    }

    std::string log_path = s->dir + "/store.log";
    size_t valid = 0;
    bool log_existed = false;
    int lfd = ::open(log_path.c_str(), O_RDONLY);
    if (lfd >= 0) {
        log_existed = true;
        bool ok = replay_fd(*s, lfd, SRC_LOG, valid);
        ::close(lfd);
        // A transient read error is NOT a torn tail: truncating here would
        // permanently destroy committed records after the error point.
        if (!ok) return nullptr;
    }

    s->log_fd = ::open(log_path.c_str(), O_WRONLY | O_CREAT, 0644);
    if (s->log_fd < 0) return nullptr;
    // First creation: fsync the directory so the log's directory entry (and
    // the freshly created store dir) survive a crash before the first sync.
    if (!log_existed && !sync_dir(*s)) return nullptr;
    // Truncate any torn tail so new appends start at the last valid record.
    if (ftruncate(s->log_fd, static_cast<off_t>(valid)) != 0) return nullptr;
    if (lseek(s->log_fd, static_cast<off_t>(valid), SEEK_SET) < 0) return nullptr;
    s->log_bytes = valid;
    s->log_rfd = ::open(log_path.c_str(), O_RDONLY);
    if (s->log_rfd < 0) return nullptr;
    if (had_log0) {
        // Retire the residue now (single-threaded: no stall concern). A
        // failure is benign — LOG0 refs stay served via log0_rfd and the
        // next compact retries.
        compact_full(*s);
    }
    return s.release();  // fds on failure paths are closed by ~Store
}

void ts_close(void* h) {
    if (!h) return;
    Store* s = static_cast<Store*>(h);
    {
        std::unique_lock lock(s->mtx);
        flush_wbuf(*s);
        if (s->log_fd >= 0) {
            fdatasync(s->log_fd);
            ::close(s->log_fd);
            s->log_fd = -1;  // ~Store closes too: don't double-close the fd
        }
        if (s->log_rfd >= 0) ::close(s->log_rfd);
        if (s->log0_rfd >= 0) ::close(s->log0_rfd);
        if (s->snap_rfd >= 0) ::close(s->snap_rfd);
        s->log_rfd = s->log0_rfd = s->snap_rfd = -1;
    }
    delete s;
}

// Single-op mutations return 1 = applied, 0 = legitimate no-op (missing
// key, duplicate dup pair, absent db), -1 = ERROR (size limits, db-kind
// mismatch; ts_last_error carries the message). The bool-shaped 0 return
// previously conflated "no change" with "silently lost write" — callers
// could not tell an oversized value or a kind-mismatched put (both dropped)
// from an idempotent no-op.
static int kind_mismatch(Store& s, const char* db, bool want_dupsort) {
    auto it = s.dbs.find(db);
    if (it != s.dbs.end() && it->second.entries > 0 && it->second.dupsort != want_dupsort) {
        s.set_error(want_dupsort ? "dup mutation on a plain db" : "plain put into a dupsort db");
        return 1;
    }
    return 0;
}

int ts_put(void* h, const char* db, const uint8_t* key, uint32_t klen, const uint8_t* val, uint32_t vlen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    if (!check_sizes(*s, db, klen, vlen)) return -1;
    if (kind_mismatch(*s, db, false)) return -1;
    return log_and_apply(*s, OP_PUT, db, Bytes(reinterpret_cast<const char*>(key), klen),
                         Bytes(reinterpret_cast<const char*>(val), vlen))
               ? 1
               : 0;
}

int ts_del(void* h, const char* db, const uint8_t* key, uint32_t klen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    if (!check_sizes(*s, db, klen, 0)) return -1;
    return log_and_apply(*s, OP_DEL, db, Bytes(reinterpret_cast<const char*>(key), klen), Bytes()) ? 1 : 0;
}

int ts_dup_put(void* h, const char* db, const uint8_t* key, uint32_t klen, const uint8_t* val, uint32_t vlen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    if (!check_sizes(*s, db, klen, vlen)) return -1;
    if (kind_mismatch(*s, db, true)) return -1;
    return log_and_apply(*s, OP_DUP_PUT, db, Bytes(reinterpret_cast<const char*>(key), klen),
                         Bytes(reinterpret_cast<const char*>(val), vlen))
               ? 1
               : 0;
}

int ts_dup_del(void* h, const char* db, const uint8_t* key, uint32_t klen, const uint8_t* val, uint32_t vlen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    if (!check_sizes(*s, db, klen, vlen)) return -1;
    if (kind_mismatch(*s, db, true)) return -1;
    return log_and_apply(*s, OP_DUP_DEL, db, Bytes(reinterpret_cast<const char*>(key), klen),
                         Bytes(reinterpret_cast<const char*>(val), vlen))
               ? 1
               : 0;
}

int ts_drop_db(void* h, const char* db) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    return log_and_apply(*s, OP_DROP_DB, db, Bytes(), Bytes()) ? 1 : 0;
}

// Batched dupsort put: concatenated [u32 klen][key][u32 vlen][val] pairs.
// Returns number of pairs actually inserted (duplicates skipped).
// Decode a [u32 klen][key][u32 vlen][val]... buffer, validating sizes over
// the WHOLE batch before the caller applies anything: a mid-buffer rejection
// after partial application would break the all-or-nothing batch contract.
bool decode_pairs(Store& s, const char* db, const uint8_t* buf, uint64_t buflen,
                  std::vector<std::pair<Bytes, Bytes>>& out) {
    uint64_t off = 0;
    while (off + 8 <= buflen) {
        uint32_t klen;
        memcpy(&klen, buf + off, 4);
        off += 4;
        if (off + klen + 4 > buflen) return false;
        Bytes key(reinterpret_cast<const char*>(buf + off), klen);
        off += klen;
        uint32_t vlen;
        memcpy(&vlen, buf + off, 4);
        off += 4;
        if (off + vlen > buflen) return false;
        out.emplace_back(std::move(key), Bytes(reinterpret_cast<const char*>(buf + off), vlen));
        off += vlen;
        if (!check_sizes(s, db, out.back().first.size(), out.back().second.size())) return false;
    }
    return true;
}

int64_t ts_dup_putmulti(void* h, const char* db, const uint8_t* buf, uint64_t buflen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    std::vector<std::pair<Bytes, Bytes>> pairs;
    if (!decode_pairs(*s, db, buf, buflen, pairs)) return -1;
    if (!pairs.empty() && kind_mismatch(*s, db, true)) return -1;
    int64_t inserted = 0;
    for (auto& [key, val] : pairs) {
        if (log_and_apply(*s, OP_DUP_PUT, db, key, val)) inserted++;
    }
    return inserted;
}

// Get a plain value. Returns 1 and sets *val to a malloc'd copy (caller
// frees via ts_free — an owned copy, so concurrent writers can't invalidate
// it after the lock drops), 0 if absent, or -1 on an external-value READ
// ERROR — which must never masquerade as key-absent (the engine would
// conclude committed assets don't exist).
int ts_get(void* h, const char* db, const uint8_t* key, uint32_t klen, uint8_t** val, uint32_t* vlen) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    auto dbit = s->dbs.find(db);
    if (dbit == s->dbs.end()) return 0;
    auto it = dbit->second.data.find(Bytes(reinterpret_cast<const char*>(key), klen));
    if (it == dbit->second.data.end()) return 0;
    Bytes v;
    if (!plain_value(*s, it->second, v)) {
        s->set_error("external value read failed");  // shared lock held: err_mtx, not direct write
        return -1;
    }
    uint8_t* out = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
    memcpy(out, v.data(), v.size());
    *val = out;
    *vlen = static_cast<uint32_t>(v.size());
    return 1;
}

// Batched plain put: concatenated [u32 klen][key][u32 vlen][val] pairs.
// Returns the number of pairs applied (replacements count), -1 on malformed
// input.
int64_t ts_putmulti(void* h, const char* db, const uint8_t* buf, uint64_t buflen) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    std::vector<std::pair<Bytes, Bytes>> pairs;
    if (!decode_pairs(*s, db, buf, buflen, pairs)) return -1;
    if (!pairs.empty() && kind_mismatch(*s, db, false)) return -1;
    int64_t applied = 0;
    for (auto& [key, val] : pairs) {
        if (log_and_apply(*s, OP_PUT, db, key, val)) applied++;
    }
    return applied;
}

// Iteration / scan results are serialized into a malloc'd buffer of
// concatenated [u32 klen][key][u32 vlen][val] pairs. Caller frees via ts_free.
namespace {
struct ScanBuf {
    std::string data;
    uint64_t count = 0;
    bool error = false;  // external-value read failure mid-scan
};

// On error returns null with *out_len = UINT64_MAX — the binding raises
// instead of treating an I/O failure as an empty result (silently dropping
// committed entries from scans).
uint8_t* finish_scan(ScanBuf& sb, uint64_t* out_len, uint64_t* out_count) {
    if (sb.error) {
        *out_len = ~0ull;
        *out_count = 0;
        return nullptr;
    }
    *out_len = sb.data.size();
    *out_count = sb.count;
    if (sb.data.empty()) return nullptr;
    uint8_t* out = static_cast<uint8_t*>(malloc(sb.data.size()));
    memcpy(out, sb.data.data(), sb.data.size());
    return out;
}

void append_pair(ScanBuf& sb, const Bytes& key, const Bytes& val) {
    put_u32(sb.data, static_cast<uint32_t>(key.size()));
    sb.data.append(key);
    put_u32(sb.data, static_cast<uint32_t>(val.size()));
    sb.data.append(val);
    sb.count++;
}

// Append every (key, value) of one entry; returns false once limit is hit
// or an external-value read fails (sb.error distinguishes the two).
bool append_entry(const Store& s, ScanBuf& sb, const Db& db, const Bytes& key, const Entry& e, uint64_t limit) {
    if (db.dupsort) {
        for (const auto& v : e.vals) {
            append_pair(sb, key, v);
            if (limit && sb.count >= limit) return false;
        }
        return true;
    }
    Bytes v;
    if (!plain_value(s, e, v)) {
        sb.error = true;
        return false;
    }
    append_pair(sb, key, v);
    return !(limit && sb.count >= limit);
}
}  // namespace

void ts_free(uint8_t* p) { free(p); }

// All (key, value) pairs whose key starts with `prefix` (dup values expanded),
// in key order. limit==0 means unlimited.
uint8_t* ts_prefix_scan(void* h, const char* db, const uint8_t* prefix, uint32_t plen, uint64_t limit,
                        uint64_t* out_len, uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    auto dbit = s->dbs.find(db);
    if (dbit != s->dbs.end()) {
        Bytes pref(reinterpret_cast<const char*>(prefix), plen);
        for (auto it = dbit->second.data.lower_bound(pref); it != dbit->second.data.end(); ++it) {
            if (it->first.compare(0, pref.size(), pref) != 0) break;
            if (!append_entry(*s, sb, dbit->second, it->first, it->second, limit)) break;
        }
    }
    return finish_scan(sb, out_len, out_count);
}

// All values for an exact key (dupsort), serialized as [u32 vlen][val]...
uint8_t* ts_get_dups(void* h, const char* db, const uint8_t* key, uint32_t klen, uint64_t limit, uint64_t* out_len,
                     uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    auto dbit = s->dbs.find(db);
    if (dbit != s->dbs.end()) {
        auto it = dbit->second.data.find(Bytes(reinterpret_cast<const char*>(key), klen));
        if (it != dbit->second.data.end()) {
            for (const auto& v : it->second.vals) {
                put_u32(sb.data, static_cast<uint32_t>(v.size()));
                sb.data.append(v);
                sb.count++;
                if (limit && sb.count >= limit) break;
            }
        }
    }
    return finish_scan(sb, out_len, out_count);
}

// Batched plain get: n fixed-width keys concatenated. The output buffer
// holds, per key in request order, [u32 vlen][val] with vlen == 0xFFFFFFFF
// marking an absent key (a zero-length stored value is vlen == 0; real
// values are < 4 GiB by the same contract as ts_get's u32 vlen). One
// shared-lock acquisition and one boundary crossing for the whole batch —
// the serving hot path enriches top-k result rows with this. On an
// external-value read error returns null with *out_len = UINT64_MAX (the
// binding raises; an I/O failure must never masquerade as key-absent).
uint8_t* ts_get_many(void* h, const char* db, const uint8_t* keys, uint32_t klen, uint32_t n, uint64_t* out_len,
                     uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    auto dbit = s->dbs.find(db);
    for (uint32_t i = 0; i < n; ++i) {
        const Entry* e = nullptr;
        if (dbit != s->dbs.end()) {
            Bytes key(reinterpret_cast<const char*>(keys) + static_cast<size_t>(i) * klen, klen);
            auto it = dbit->second.data.find(key);
            if (it != dbit->second.data.end()) e = &it->second;
        }
        if (e == nullptr) {
            put_u32(sb.data, 0xFFFFFFFFu);
            continue;
        }
        Bytes v;
        if (!plain_value(*s, *e, v)) {
            s->set_error("external value read failed");
            sb.error = true;
            break;
        }
        put_u32(sb.data, static_cast<uint32_t>(v.size()));
        sb.data.append(v);
        sb.count++;
    }
    return finish_scan(sb, out_len, out_count);
}

// Full scan of a db from `start` key (inclusive), up to `limit` pairs.
uint8_t* ts_range_scan(void* h, const char* db, const uint8_t* start, uint32_t slen, uint64_t limit,
                       uint64_t* out_len, uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    auto dbit = s->dbs.find(db);
    if (dbit != s->dbs.end()) {
        Bytes st(reinterpret_cast<const char*>(start), slen);
        for (auto it = dbit->second.data.lower_bound(st); it != dbit->second.data.end(); ++it) {
            if (!append_entry(*s, sb, dbit->second, it->first, it->second, limit)) break;
        }
    }
    return finish_scan(sb, out_len, out_count);
}

// Pairs strictly AFTER (after_key, after_val), in (key, value) order — the
// continuation primitive for bounded paged scans over dupsort databases
// (a key-successor restart would skip or repeat a dup run that straddles a
// page boundary). limit==0 means unlimited.
uint8_t* ts_range_scan_after(void* h, const char* db, const uint8_t* akey, uint32_t aklen, const uint8_t* aval,
                             uint32_t avlen, uint64_t limit, uint64_t* out_len, uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    auto dbit = s->dbs.find(db);
    if (dbit != s->dbs.end()) {
        Db& d = dbit->second;
        Bytes ak(reinterpret_cast<const char*>(akey), aklen);
        auto it = d.data.lower_bound(ak);
        bool more = true;
        if (it != d.data.end() && it->first == ak) {
            if (d.dupsort) {
                Bytes av(reinterpret_cast<const char*>(aval), avlen);
                auto vit = std::upper_bound(it->second.vals.begin(), it->second.vals.end(), av);
                for (; vit != it->second.vals.end(); ++vit) {
                    append_pair(sb, it->first, *vit);
                    if (limit && sb.count >= limit) { more = false; break; }
                }
            }
            ++it;  // plain: the key itself was already emitted by the caller
        }
        if (more) {
            for (; it != d.data.end(); ++it) {
                if (!append_entry(*s, sb, d, it->first, it->second, limit)) break;
            }
        }
    }
    return finish_scan(sb, out_len, out_count);
}

int64_t ts_entries(void* h, const char* db) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    auto dbit = s->dbs.find(db);
    return dbit == s->dbs.end() ? 0 : static_cast<int64_t>(dbit->second.entries);
}

int64_t ts_key_count(void* h, const char* db) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    auto dbit = s->dbs.find(db);
    return dbit == s->dbs.end() ? 0 : static_cast<int64_t>(dbit->second.data.size());
}

// Approximate logical payload bytes across all dbs (monitoring parity with
// lmdb_used_bytes — reference indexes/common.py:57). Counts externalized
// values at their full size even though they are not RAM-resident.
int64_t ts_used_bytes(void* h) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    int64_t total = 0;
    for (const auto& [name, db] : s->dbs) total += static_cast<int64_t>(db.bytes + name.size());
    return total;
}

// List db names, serialized as [u32 len][name]...
uint8_t* ts_list_dbs(void* h, uint64_t* out_len, uint64_t* out_count) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    ScanBuf sb;
    for (const auto& [name, db] : s->dbs) {
        put_u32(sb.data, static_cast<uint32_t>(name.size()));
        sb.data.append(name);
        sb.count++;
    }
    return finish_scan(sb, out_len, out_count);
}

// Flush buffered appends to the OS (no fsync).
int ts_flush(void* h) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    return flush_wbuf(*s) ? 1 : 0;
}

// Flush + fdatasync the log (durability point).
int ts_sync(void* h) {
    Store* s = static_cast<Store*>(h);
    std::unique_lock lock(s->mtx);
    if (!flush_wbuf(*s)) return 0;
    return fdatasync(s->log_fd) == 0 ? 1 : 0;
}

// Incremental compaction: bounded write stalls instead of a full-store
// pause (a 1M-asset aggregator store measured a 15.5s ingest stall on the
// old full-lock path — benchmarks/AGGREGATOR_INGEST.json).
//
//   Phase A (exclusive, O(entries) pointer walk, no I/O): flush the write
//     buffer, rotate store.log -> store.log.0 (the old read fd keeps serving
//     rotated refs, retagged SRC_LOG -> SRC_LOG0), start a fresh empty log.
//   Phase B (shared, sliced): stream a snapshot of the live tables in
//     SLICE-entry slices — serialize under the shared lock, write the file
//     between slices with NO lock held. The snapshot need not be a
//     point-in-time image: every mutation since rotation is in the NEW log,
//     and all ops are idempotent absolute state-setters, so
//     "snapshot-of-any-interleaving + full new-log replay" converges to the
//     live state (same argument per key: the last logged op wins).
//   Phase C (exclusive, O(pending)): swap external refs that are still
//     byte-identical to their captured form into the new snapshot, install
//     the new snap fd, drop store.log.0 (every LOG0 ref was either swapped
//     here or superseded by a newer op whose bytes live in the new log).
//
// A crash at any point leaves {snap, log.0, log} replayable in that order
// (ts_open); failure mid-phase leaves the rotated state serving correctly
// and the next explicit compact falls back to the full-stall path.
int ts_compact(void* h) {
    Store* s = static_cast<Store*>(h);
    constexpr int SLICE = 8192;

    std::string log_path = s->dir + "/store.log";
    std::string log0_path = s->dir + "/store.log.0";

    // Pre-sync the log with NO lock held: rotation must fdatasync the
    // rotated file (post-rotation ts_sync calls only cover the new log, but
    // they promise durability of EVERYTHING ingested so far), and doing the
    // bulk of that fsync here bounds the locked one below to the delta
    // written since this line. Even a shared lock would stall writers for
    // the full fsync (seconds at 256 MB of dirty log). The fd is dup'd
    // under the lock: a concurrent compaction's Phase A closes log_fd and
    // could let the number be recycled, but the dup keeps this open file
    // description alive regardless. Skipped while another compaction is in
    // flight (its rotation already syncs; Phase A's locked sync covers any
    // delta).
    {
        int fd = -1;
        {
            std::shared_lock lock(s->mtx);
            if (!s->compacting && s->log_fd >= 0) fd = ::dup(s->log_fd);
        }
        if (fd >= 0) {
            fdatasync(fd);
            ::close(fd);
        }
    }

    // ---- Phase A: rotate the log (exclusive, short) ----
    {
        std::unique_lock lock(s->mtx);
        // Wait out any in-flight compaction rather than returning early:
        // callers of ts_compact are promised a snapshot+truncated log that
        // reflect at least the state at call time, and an in-flight pass
        // rotated BEFORE this call began. The wait holds no other locks;
        // Phase B/C of the other thread make progress and notify.
        s->compact_cv.wait(lock, [&] { return !s->compacting; });
        if (s->log0_rfd >= 0) {
            // Residue from a failed earlier attempt: the simple path heals it.
            return compact_full(*s);
        }
        if (!flush_wbuf(*s)) return 0;
        if (fdatasync(s->log_fd) != 0) {
            s->set_error(std::string("log sync failed: ") + strerror(errno));
            return 0;
        }
        if (::rename(log_path.c_str(), log0_path.c_str()) != 0) {
            s->set_error(std::string("log rotate failed: ") + strerror(errno));
            return 0;
        }
        int new_wfd = ::open(log_path.c_str(), O_WRONLY | O_CREAT, 0644);
        int new_rfd = ::open(log_path.c_str(), O_RDONLY);
        if (new_wfd < 0 || new_rfd < 0) {
            // Roll the rename back; the old fds still point at the inode.
            if (new_wfd >= 0) ::close(new_wfd);
            if (new_rfd >= 0) ::close(new_rfd);
            ::unlink(log_path.c_str());
            ::rename(log0_path.c_str(), log_path.c_str());
            s->set_error(std::string("log reopen failed: ") + strerror(errno));
            return 0;
        }
        s->log0_rfd = s->log_rfd;
        ::close(s->log_fd);
        s->log_fd = new_wfd;
        s->log_rfd = new_rfd;
        s->log_bytes = 0;
        for (auto& [dbname, db] : s->dbs) {
            for (auto& [key, entry] : db.data) {
                if (entry.ref.src == SRC_LOG) entry.ref.src = SRC_LOG0;
            }
        }
        s->compacting = true;
    }

    // ---- Phase B: stream the snapshot in slices (shared, bounded) ----
    auto fail = [&](const char* msg) {
        {
            std::unique_lock lock(s->mtx);
            if (msg) s->set_error(msg);
            s->compacting = false;  // log.0 stays; next compact heals via compact_full
            ::unlink((s->dir + "/store.snap.tmp").c_str());
        }
        s->compact_cv.notify_all();
        return 0;
    };

    std::vector<std::string> names;
    {
        std::shared_lock lock(s->mtx);
        names.reserve(s->dbs.size());
        for (auto& [dbname, db] : s->dbs) names.push_back(dbname);
    }

    std::string tmp_path = s->dir + "/store.snap.tmp";
    FileWriter w;
    w.fd = ::open(tmp_path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (w.fd < 0) return fail("snapshot open failed");
    std::vector<PendingKeyRef> pending;
    std::string batch, rec;
    Bytes vbuf;

    for (const auto& name : names) {
        Bytes last;
        bool first = true;
        while (true) {
            batch.clear();
            bool more = false;
            {
                std::shared_lock lock(s->mtx);
                auto dbit = s->dbs.find(name);
                if (dbit == s->dbs.end()) break;  // dropped mid-compact: the new log has the drop
                Db& db = dbit->second;
                auto it = first ? db.data.begin() : db.data.upper_bound(last);
                for (int n = 0; it != db.data.end() && n < SLICE; ++it, ++n) {
                    const Bytes& key = it->first;
                    Entry& entry = it->second;
                    if (db.dupsort) {
                        for (const auto& v : entry.vals) {
                            rec.clear();
                            encode_record(rec, OP_DUP_PUT, name, key, v);
                            batch.append(rec);
                        }
                    } else {
                        if (!plain_value(*s, entry, vbuf)) {
                            lock.unlock();
                            ::close(w.fd);
                            return fail("snapshot: external value read failed");
                        }
                        uint64_t rec_off = w.offset() + batch.size();
                        rec.clear();
                        encode_record(rec, OP_PUT, name, key, vbuf);
                        batch.append(rec);
                        if (s->ext_min && vbuf.size() >= s->ext_min) {
                            pending.push_back(
                                {name, key, entry.ref,
                                 ValRef{value_off(rec_off, name.size(), key.size()),
                                        static_cast<uint32_t>(vbuf.size()), SRC_SNAP}});
                        }
                    }
                    last = key;
                }
                first = false;
                more = it != db.data.end();
            }
            w.append(batch);  // file I/O with no lock held
            if (!w.ok) {
                ::close(w.fd);
                return fail("snapshot write failed");
            }
            if (!more) break;
        }
    }
    w.flush();
    bool synced = w.ok && fdatasync(w.fd) == 0;
    bool closed = ::close(w.fd) == 0;  // close exactly once, success or not
    if (!synced || !closed) return fail("snapshot sync failed");
    if (::rename(tmp_path.c_str(), (s->dir + "/store.snap").c_str()) != 0) {
        return fail("snapshot rename failed");
    }
    if (!sync_dir(*s)) return fail(nullptr);  // set_error done by sync_dir
    int new_snap_rfd = ::open((s->dir + "/store.snap").c_str(), O_RDONLY);
    if (new_snap_rfd < 0) return fail("snapshot reopen failed");

    // ---- Phase C: swap refs + drop the rotated log (exclusive, short) ----
    {
        std::unique_lock lock(s->mtx);
        for (auto& p : pending) {
            auto dbit = s->dbs.find(p.db);
            if (dbit == s->dbs.end()) continue;
            auto it = dbit->second.data.find(p.key);
            if (it == dbit->second.data.end()) continue;
            Entry& entry = it->second;
            if (same_ref(entry.ref, p.oldref)) {
                entry.vals.clear();
                entry.ref = p.newref;
            }
        }
        if (s->snap_rfd >= 0) ::close(s->snap_rfd);
        s->snap_rfd = new_snap_rfd;
        ::close(s->log0_rfd);
        s->log0_rfd = -1;
        ::unlink(log0_path.c_str());
        s->compacting = false;
    }
    s->compact_cv.notify_all();
    return 1;
}

uint64_t ts_log_bytes(void* h) {
    Store* s = static_cast<Store*>(h);
    std::shared_lock lock(s->mtx);
    return s->log_bytes + s->wbuf.size();
}

const char* ts_last_error(void* h) {
    // Copy under err_mtx into a thread-local buffer: returning the internal
    // c_str() would race concurrent writers assigning the string (the
    // returned pointer could dangle mid-read).
    static thread_local std::string buf;
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->err_mtx);
    buf = s->last_error;
    return buf.c_str();
}

}  // extern "C"
