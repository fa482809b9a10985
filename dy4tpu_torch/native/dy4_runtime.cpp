// dy4tpu native host runtime: lock-free streaming I/O for the receiver.
//
// TPU-native replacement for the reference's host plumbing: the
// mutex+condvar threadSafeQ (src/threadSafeQ.cpp:18-55) becomes a
// cache-line-aligned single-producer/single-consumer ring buffer, and the
// blocking stdin/stdout loops (src/iofunc.cpp:113-120, project.cpp:313-317)
// become dedicated reader/writer threads so the Python/JAX dispatch loop
// never stalls on a pipe.  Exposed as a C ABI for ctypes (no pybind11 in
// this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC -pthread)

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include <cerrno>
#include <poll.h>
#include <unistd.h>

namespace {

// Wait (bounded) until fd is ready for `events` (POLLIN/POLLOUT).
// Returns 1 ready, 0 timeout, -1 error/hangup-with-error.
int poll_fd(int fd, short events, int timeout_ms) {
  struct pollfd pfd;
  pfd.fd = fd;
  pfd.events = events;
  pfd.revents = 0;
  int r = ::poll(&pfd, 1, timeout_ms);
  if (r == 0) return 0;
  if (r < 0) return errno == EINTR ? 0 : -1;
  if (pfd.revents & (POLLERR | POLLNVAL)) return -1;
  return 1;
}

// ---------------------------------------------------------------------------
// SPSC byte ring buffer.  Capacity rounded up to a power of two; indices are
// monotonically increasing 64-bit counters so full/empty never ambiguity.
// ---------------------------------------------------------------------------
class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity) {
    size_t cap = 1;
    while (cap < capacity) cap <<= 1;
    buf_.resize(cap);
    mask_ = cap - 1;
  }

  size_t capacity() const { return buf_.size(); }
  size_t readable() const {
    return head_.load(std::memory_order_acquire) -
           tail_.load(std::memory_order_acquire);
  }
  size_t writable() const { return capacity() - readable(); }

  // Producer side. Returns bytes accepted (may be < n if full).
  size_t push(const uint8_t* data, size_t n) {
    const uint64_t head = head_.load(std::memory_order_relaxed);
    const uint64_t tail = tail_.load(std::memory_order_acquire);
    size_t space = capacity() - static_cast<size_t>(head - tail);
    size_t take = n < space ? n : space;
    for (size_t i = 0; i < take; ++i)
      buf_[(head + i) & mask_] = data[i];
    head_.store(head + take, std::memory_order_release);
    if (take) {
      std::lock_guard<std::mutex> g(m_);
      cv_.notify_all();
    }
    return take;
  }

  // Consumer side. Returns bytes copied (may be < n if empty).
  size_t pop(uint8_t* dst, size_t n) {
    const uint64_t tail = tail_.load(std::memory_order_relaxed);
    const uint64_t head = head_.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    size_t take = n < avail ? n : avail;
    for (size_t i = 0; i < take; ++i)
      dst[i] = buf_[(tail + i) & mask_];
    tail_.store(tail + take, std::memory_order_release);
    if (take) {
      std::lock_guard<std::mutex> g(m_);
      cv_.notify_all();
    }
    return take;
  }

  // Block until at least n bytes readable, EOF flagged, or timeout.
  // Returns readable() at wake-up.
  size_t wait_readable(size_t n, long timeout_ms) {
    std::unique_lock<std::mutex> lk(m_);
    auto pred = [&] { return readable() >= n || eof_.load(); };
    if (timeout_ms < 0) {
      cv_.wait(lk, pred);
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
    }
    return readable();
  }

  size_t wait_writable(size_t n, long timeout_ms) {
    std::unique_lock<std::mutex> lk(m_);
    auto pred = [&] { return writable() >= n || closed_.load(); };
    if (timeout_ms < 0) {
      cv_.wait(lk, pred);
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
    }
    return writable();
  }

  void set_eof() {
    eof_.store(true);
    std::lock_guard<std::mutex> g(m_);
    cv_.notify_all();
  }
  bool eof() const { return eof_.load(); }
  void close() {
    closed_.store(true);
    std::lock_guard<std::mutex> g(m_);
    cv_.notify_all();
  }
  bool closed() const { return closed_.load(); }

 private:
  std::vector<uint8_t> buf_;
  size_t mask_ = 0;
  alignas(64) std::atomic<uint64_t> head_{0};  // produced
  alignas(64) std::atomic<uint64_t> tail_{0};  // consumed
  std::atomic<bool> eof_{false};
  std::atomic<bool> closed_{false};
  std::mutex m_;               // only for blocking waits, not the fast path
  std::condition_variable cv_;
};

// ---------------------------------------------------------------------------
// Source: fd reader thread -> ring -> fixed-size blocks for the device loop.
// ---------------------------------------------------------------------------
struct Source {
  Source(int fd, size_t block_bytes, size_t capacity_blocks)
      : fd(fd), block(block_bytes),
        ring(block_bytes * (capacity_blocks < 2 ? 2 : capacity_blocks)),
        th([this] { run(); }) {}

  ~Source() {
    stop.store(true);
    ring.close();
    if (th.joinable()) th.join();
  }

  void run() {
    std::vector<uint8_t> tmp(1 << 16);
    while (!stop.load()) {
      size_t space = ring.wait_writable(tmp.size(), 100);
      if (ring.closed() || stop.load()) break;
      if (space == 0) continue;
      // Poll before the blocking read so an idle pipe (no data, no EOF)
      // can never pin this thread: ~Source sets `stop` and we notice at
      // the next 100 ms tick instead of hanging the process on join().
      int pr = poll_fd(fd, POLLIN, 100);
      if (pr == 0) continue;
      if (pr < 0) {
        ring.set_eof();
        break;
      }
      size_t want = space < tmp.size() ? space : tmp.size();
      ssize_t got = ::read(fd, tmp.data(), want);
      if (got < 0 && errno == EINTR) continue;
      if (got <= 0) {  // EOF or error: reference exits on short read
        ring.set_eof();
        break;
      }
      size_t off = 0;
      while (off < static_cast<size_t>(got) && !stop.load())
        off += ring.push(tmp.data() + off, got - off);
    }
    ring.set_eof();
  }

  // 1 = block copied, 0 = EOF (no full block left), -1 = timeout.
  int next(uint8_t* dst, long timeout_ms) {
    for (;;) {
      size_t avail = ring.wait_readable(block, timeout_ms);
      if (avail >= block) {
        size_t off = 0;
        while (off < block) off += ring.pop(dst + off, block - off);
        return 1;
      }
      if (ring.eof()) return 0;
      if (timeout_ms >= 0) return -1;
    }
  }

  int fd;
  size_t block;
  RingBuffer ring;
  std::atomic<bool> stop{false};
  std::thread th;
};

// ---------------------------------------------------------------------------
// Sink: blocks -> ring -> fd writer thread.
// ---------------------------------------------------------------------------
struct Sink {
  Sink(int fd, size_t capacity_bytes)
      : fd(fd), ring(capacity_bytes), th([this] { run(); }) {}

  ~Sink() {
    ring.set_eof();           // no more producer data
    // Grace window for the writer to drain, then force-stop: a stuck
    // downstream (pipe peer never reads) must not hang process exit.
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(1000);
    while (!done.load() && std::chrono::steady_clock::now() < deadline)
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    stop.store(true);
    ring.close();
    if (th.joinable()) th.join();
  }

  // Downstream write failed (e.g. `| aplay` exited): record it AND close
  // the ring so producers blocked in wait_writable wake up immediately —
  // otherwise a full ring + timeout_ms=-1 push() would block forever.
  void fail() {
    error.store(true);
    ring.close();
  }

  void run() {
    std::vector<uint8_t> tmp(1 << 16);
    size_t have = 0, off = 0;
    for (;;) {
      if (off == have) {
        inflight.store(0, std::memory_order_release);
        if (stop.load()) break;
        size_t avail = ring.wait_readable(1, 100);
        if (avail == 0) {
          if (ring.eof() || ring.closed()) break;
          continue;
        }
        have = ring.pop(tmp.data(), tmp.size());
        off = 0;
        inflight.store(have, std::memory_order_release);
        continue;
      }
      // Poll before write so a full pipe cannot pin this thread past the
      // destructor's stop flag (same rationale as Source::run).
      int pr = poll_fd(fd, POLLOUT, 100);
      if (stop.load()) break;
      if (pr == 0) continue;
      if (pr < 0) { fail(); break; }
      ssize_t w = ::write(fd, tmp.data() + off, have - off);
      if (w < 0 && errno == EINTR) continue;
      if (w <= 0) { fail(); break; }
      off += static_cast<size_t>(w);
      inflight.store(have - off, std::memory_order_release);
    }
    done.store(true);
  }

  // 1 = accepted, -1 = timeout/overflow, -2 = downstream write error.
  int push(const uint8_t* data, size_t n, long timeout_ms) {
    if (error.load()) return -2;
    size_t off = 0;
    while (off < n) {
      ring.wait_writable(1, timeout_ms);
      if (error.load()) return -2;
      size_t pushed = ring.push(data + off, n - off);
      if (pushed == 0 && timeout_ms >= 0) return -1;
      off += pushed;
    }
    return 1;
  }

  int flush(long timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 3600000
                                                             : timeout_ms);
    // Drained = ring empty AND no bytes popped-but-unwritten in the
    // writer's scratch buffer.
    while ((ring.readable() > 0 || inflight.load() > 0) && !error.load()) {
      if (std::chrono::steady_clock::now() > deadline) return -1;
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    return error.load() ? -2 : 1;
  }

  int fd;
  RingBuffer ring;
  std::atomic<bool> error{false};
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};
  std::atomic<size_t> inflight{0};
  std::thread th;
};

// ---------------------------------------------------------------------------
// RDS frame synchronizer (data-link layer).
//
// Native twin of dy4tpu/rds/decoder.py FrameSynchronizer (itself the
// redesign of the reference's frame_sync_receiver, model/fmMonoBlock.py:
// 174-284): 26-bit sliding window, GF(2) syndrome against the five block
// offset words, in-order tracking, miss-tolerant resync.  The Python layer
// walks the synced stream at ~0.04 Mbit/s (interpreter-bound); this one
// runs >100 Mbit/s so thousands of stations decode on one host core.
// Parity with the Python implementation is pinned by tests/test_native.py.
// ---------------------------------------------------------------------------
struct FrameSync {
  // matrix rows: syndrome contribution of each of the 26 window bits
  uint16_t rows[26];
  // offset-word syndromes and their block types (0=A,1=B,2=C,3=Cp,4=D)
  std::vector<uint16_t> off_syn;
  std::vector<uint8_t> off_type;
  int max_misses;
  // single-burst (<=5 bit) error correction, applied only while synced
  // toward the expected type (twin of decoder.py burst_error_table):
  // error-syndrome -> 26-bit error pattern, or -1
  bool correct = true;
  int32_t burst_tab[1024];
  int64_t corrected = 0;

  std::vector<uint8_t> buf;
  int64_t pos_base = 0;
  size_t cursor = 0;
  bool synced = false;
  int expected = -1;  // -1 = none; else block type expected next
  int misses = 0;
  uint16_t blocks[4] = {0, 0, 0, 0};
  uint8_t have = 0;   // bitmask of collected A/B/C/D

  void build_burst_table() {
    for (int i = 0; i < 1024; ++i) burst_tab[i] = -1;
    for (int len = 1; len <= 5; ++len) {
      for (int p = 0; p + len <= 26; ++p) {
        int nmid = len <= 1 ? 1 : (1 << (len - 2));
        for (int mid = 0; mid < nmid; ++mid) {
          uint32_t pat = len == 1
              ? 1u
              : ((1u << (len - 1)) | (uint32_t(mid) << 1) | 1u);
          uint32_t e = pat << (26 - p - len);
          uint16_t s = 0;
          for (int b = 0; b < 26; ++b)
            if ((e >> (25 - b)) & 1u) s ^= rows[b];
          burst_tab[s] = static_cast<int32_t>(e);
        }
      }
    }
  }

  uint16_t syn_of_type(int t) const {
    for (size_t i = 0; i < off_type.size(); ++i)
      if (off_type[i] == t) return off_syn[i];
    return 0;
  }

  // attempt burst correction toward the expected type; repairs buf at
  // cursor in place and returns the block type, or -1
  int try_correct(uint16_t s) {
    if (!correct || expected < 0) return -1;
    const int cands[2] = {expected, expected == 2 ? 3 : -1};
    for (int ci = 0; ci < 2; ++ci) {
      int cand = cands[ci];
      if (cand < 0) break;
      int32_t err = burst_tab[s ^ syn_of_type(cand)];
      if (err >= 0) {
        for (int b = 0; b < 26; ++b)
          buf[cursor + b] ^= (err >> (25 - b)) & 1;
        ++corrected;
        return cand;
      }
    }
    return -1;
  }

  static int next_of(int t) {  // A->B->C/Cp->D->A
    switch (t) {
      case 0: return 1;
      case 1: return 2;
      case 2: case 3: return 4;
      default: return 0;
    }
  }

  int type_of_syndrome(uint16_t s) const {
    for (size_t i = 0; i < off_syn.size(); ++i)
      if (off_syn[i] == s) return off_type[i];
    return -1;
  }

  uint16_t syndrome_at(size_t i) const {
    uint16_t s = 0;
    for (int b = 0; b < 26; ++b)
      if (buf[i + b]) s ^= rows[b];
    return s;
  }

  uint16_t msg_at(size_t i) const {
    uint16_t m = 0;
    for (int b = 0; b < 16; ++b) m = (m << 1) | buf[i + b];
    return m;
  }

  void collect(int btype, int64_t /*abs_pos*/) {
    if (btype == 0) { have = 0; }
    int key = btype == 3 ? 2 : (btype == 4 ? 3 : btype);  // Cp under C
    blocks[key] = msg_at(cursor);
    have |= 1u << key;
    expected = next_of(btype);
  }

  // returns number of groups emitted (each 4 u16 + i64 position)
  int push(const uint8_t* bits, size_t n, uint16_t* out_blocks,
           int64_t* out_pos, int cap) {
    buf.insert(buf.end(), bits, bits + n);
    int emitted = 0;
    while (cursor + 26 <= buf.size()) {
      uint16_t s = syndrome_at(cursor);
      int btype = type_of_syndrome(s);
      int64_t abs_pos = pos_base + static_cast<int64_t>(cursor);

      if (!synced) {
        if (btype >= 0) {
          synced = true;
          misses = 0;
          have = 0;
          collect(btype, abs_pos);
          cursor += 26;
        } else {
          cursor += 1;
        }
        // fall through to completion check below only after a collect
        if (have == 0xF) {
          if (emitted < cap) {
            for (int k = 0; k < 4; ++k)
              out_blocks[emitted * 4 + k] = blocks[k];
            out_pos[emitted] = abs_pos;
            ++emitted;
          }
          have = 0;
        }
        continue;
      }

      if (btype < 0) btype = try_correct(s);
      bool ok = btype >= 0 &&
                (expected < 0 || btype == expected ||
                 (expected == 2 && btype == 3));
      if (ok) {
        misses = 0;
        collect(btype, abs_pos);
      } else {
        ++misses;
        have = 0;
        if (misses > max_misses) {
          synced = false;
          expected = -1;
          cursor += 1;
          continue;
        }
      }
      cursor += 26;

      if (have == 0xF) {
        if (emitted < cap) {
          for (int k = 0; k < 4; ++k)
            out_blocks[emitted * 4 + k] = blocks[k];
          out_pos[emitted] = abs_pos;
          ++emitted;
        }
        have = 0;
      }
    }
    // drop consumed bits, keep a 25-bit overlap
    size_t keep_from = std::min(cursor,
                                buf.size() > 25 ? buf.size() - 25 : 0);
    buf.erase(buf.begin(), buf.begin() + keep_from);
    pos_base += static_cast<int64_t>(keep_from);
    cursor -= keep_from;
    return emitted;
  }
};

// ---------------------------------------------------------------------------
// Batched frame synchronizer: one context per channel, pushed in one C call
// so the Python fleet layer does no per-channel work (the reference has no
// multi-station concept; this is the host half of the channel-DP axis).
// ---------------------------------------------------------------------------
struct FrameSyncBatch {
  std::vector<FrameSync> chans;

  // Fixed-size serialized per-channel state (checkpointable fleet):
  // buf is bounded — push() always trims to < 26+26 bits.
  static constexpr size_t kMaxBuf = 128;
  struct SerState {
    int64_t pos_base;
    int32_t cursor;
    int32_t expected;
    int32_t misses;
    uint16_t blocks[4];
    uint8_t have;
    uint8_t synced;
    uint16_t buf_len;
    uint8_t buf[kMaxBuf];
  };

  int push(const uint8_t* bits, const int32_t* lens, size_t stride,
           const uint8_t* reset_mask, uint16_t* out_blocks,
           int64_t* out_pos, int32_t* out_ch, int cap) {
    int emitted = 0;
    for (size_t c = 0; c < chans.size(); ++c) {
      if (reset_mask && reset_mask[c]) {
        FrameSync& fs = chans[c];
        fs.buf.clear();
        fs.pos_base = 0;
        fs.cursor = 0;
        fs.synced = false;
        fs.expected = -1;
        fs.misses = 0;
        fs.have = 0;
      }
      int n = lens ? lens[c] : static_cast<int>(stride);
      if (n <= 0) continue;
      int got = chans[c].push(bits + c * stride, static_cast<size_t>(n),
                              out_blocks + emitted * 4, out_pos + emitted,
                              cap - emitted);
      for (int g = 0; g < got; ++g) out_ch[emitted + g] = static_cast<int>(c);
      emitted += got;
      if (emitted >= cap) break;
    }
    return emitted;
  }

  bool export_state(uint8_t* dst) const {
    for (const FrameSync& fs : chans) {
      if (fs.buf.size() > kMaxBuf) return false;
      SerState s{};
      s.pos_base = fs.pos_base;
      s.cursor = static_cast<int32_t>(fs.cursor);
      s.expected = fs.expected;
      s.misses = fs.misses;
      std::memcpy(s.blocks, fs.blocks, sizeof(s.blocks));
      s.have = fs.have;
      s.synced = fs.synced ? 1 : 0;
      s.buf_len = static_cast<uint16_t>(fs.buf.size());
      if (!fs.buf.empty()) std::memcpy(s.buf, fs.buf.data(), fs.buf.size());
      std::memcpy(dst, &s, sizeof(s));
      dst += sizeof(s);
    }
    return true;
  }

  bool import_state(const uint8_t* src) {
    // Validate every record before mutating any channel: a corrupt blob
    // (buf_len > kMaxBuf) must not cause an OOB read of the stack struct
    // nor leave the batch half-imported.
    const uint8_t* p = src;
    for (size_t c = 0; c < chans.size(); ++c, p += sizeof(SerState)) {
      uint16_t buf_len;
      std::memcpy(&buf_len, p + offsetof(SerState, buf_len),
                  sizeof(buf_len));
      if (buf_len > kMaxBuf) return false;
    }
    for (FrameSync& fs : chans) {
      SerState s;
      std::memcpy(&s, src, sizeof(s));
      src += sizeof(s);
      fs.pos_base = s.pos_base;
      fs.cursor = static_cast<size_t>(s.cursor);
      fs.expected = s.expected;
      fs.misses = s.misses;
      std::memcpy(fs.blocks, s.blocks, sizeof(fs.blocks));
      fs.have = s.have;
      fs.synced = s.synced != 0;
      fs.buf.assign(s.buf, s.buf + s.buf_len);
    }
    return true;
  }
};

}  // namespace

extern "C" {

// ---- bare ring (threadSafeQ parity object, used by tests) ----
void* dy4_ring_create(size_t capacity) { return new RingBuffer(capacity); }
void dy4_ring_destroy(void* r) { delete static_cast<RingBuffer*>(r); }
size_t dy4_ring_push(void* r, const uint8_t* d, size_t n) {
  return static_cast<RingBuffer*>(r)->push(d, n);
}
size_t dy4_ring_pop(void* r, uint8_t* d, size_t n) {
  return static_cast<RingBuffer*>(r)->pop(d, n);
}
size_t dy4_ring_readable(void* r) {
  return static_cast<RingBuffer*>(r)->readable();
}
size_t dy4_ring_wait_readable(void* r, size_t n, long timeout_ms) {
  return static_cast<RingBuffer*>(r)->wait_readable(n, timeout_ms);
}
void dy4_ring_set_eof(void* r) { static_cast<RingBuffer*>(r)->set_eof(); }

// ---- source ----
void* dy4_source_create(int fd, size_t block_bytes, size_t capacity_blocks) {
  return new Source(fd, block_bytes, capacity_blocks);
}
int dy4_source_next(void* s, uint8_t* dst, long timeout_ms) {
  return static_cast<Source*>(s)->next(dst, timeout_ms);
}
size_t dy4_source_buffered(void* s) {
  return static_cast<Source*>(s)->ring.readable();
}
void dy4_source_destroy(void* s) { delete static_cast<Source*>(s); }

// ---- RDS frame synchronizer ----
void* dy4_framesync_create(const uint16_t rows[26],
                           const uint16_t* off_syndromes,
                           const uint8_t* off_types, int n_off,
                           int max_misses) {
  auto* fs = new FrameSync();
  std::memcpy(fs->rows, rows, sizeof(fs->rows));
  fs->off_syn.assign(off_syndromes, off_syndromes + n_off);
  fs->off_type.assign(off_types, off_types + n_off);
  fs->max_misses = max_misses;
  fs->build_burst_table();
  return fs;
}
void dy4_framesync_set_correct(void* h, int on) {
  static_cast<FrameSync*>(h)->correct = on != 0;
}
long long dy4_framesync_corrected(void* h) {
  return static_cast<FrameSync*>(h)->corrected;
}
int dy4_framesync_push(void* h, const uint8_t* bits, size_t n,
                       uint16_t* out_blocks, int64_t* out_pos, int cap) {
  return static_cast<FrameSync*>(h)->push(bits, n, out_blocks, out_pos,
                                          cap);
}
int dy4_framesync_synced(void* h) {
  return static_cast<FrameSync*>(h)->synced ? 1 : 0;
}
void dy4_framesync_reset(void* h) {
  auto* fs = static_cast<FrameSync*>(h);
  fs->buf.clear();
  fs->pos_base = 0;
  fs->cursor = 0;
  fs->synced = false;
  fs->expected = -1;
  fs->misses = 0;
  fs->have = 0;
}
void dy4_framesync_destroy(void* h) { delete static_cast<FrameSync*>(h); }

// ---- batched frame synchronizer (fleet) ----
void* dy4_fsbatch_create(const uint16_t rows[26],
                         const uint16_t* off_syndromes,
                         const uint8_t* off_types, int n_off,
                         int max_misses, int channels) {
  auto* b = new FrameSyncBatch();
  b->chans.resize(channels);
  for (FrameSync& fs : b->chans) {
    std::memcpy(fs.rows, rows, sizeof(fs.rows));
    fs.off_syn.assign(off_syndromes, off_syndromes + n_off);
    fs.off_type.assign(off_types, off_types + n_off);
    fs.max_misses = max_misses;
    fs.build_burst_table();
  }
  return b;
}
void dy4_fsbatch_set_correct(void* h, int on) {
  for (FrameSync& fs : static_cast<FrameSyncBatch*>(h)->chans)
    fs.correct = on != 0;
}
long long dy4_fsbatch_corrected(void* h) {
  long long n = 0;
  for (const FrameSync& fs : static_cast<FrameSyncBatch*>(h)->chans)
    n += fs.corrected;
  return n;
}
// bits: [channels, stride] u8 row-major; lens: per-channel valid counts
// (NULL = all stride); reset_mask: per-channel pre-push reset (NULL = none).
// Emits up to cap groups as (out_ch, out_blocks[4], out_pos) triples.
int dy4_fsbatch_push(void* h, const uint8_t* bits, const int32_t* lens,
                     size_t stride, const uint8_t* reset_mask,
                     uint16_t* out_blocks, int64_t* out_pos,
                     int32_t* out_ch, int cap) {
  return static_cast<FrameSyncBatch*>(h)->push(bits, lens, stride,
                                               reset_mask, out_blocks,
                                               out_pos, out_ch, cap);
}
size_t dy4_fsbatch_state_bytes(void* h) {
  return static_cast<FrameSyncBatch*>(h)->chans.size() *
         sizeof(FrameSyncBatch::SerState);
}
int dy4_fsbatch_export(void* h, uint8_t* dst) {
  return static_cast<FrameSyncBatch*>(h)->export_state(dst) ? 1 : 0;
}
// Returns 1 on success, 0 when the blob is rejected (corrupt buf_len);
// on rejection no channel state is modified.
int dy4_fsbatch_import(void* h, const uint8_t* src) {
  return static_cast<FrameSyncBatch*>(h)->import_state(src) ? 1 : 0;
}
int dy4_fsbatch_synced(void* h, uint8_t* dst) {
  auto* b = static_cast<FrameSyncBatch*>(h);
  for (size_t c = 0; c < b->chans.size(); ++c)
    dst[c] = b->chans[c].synced ? 1 : 0;
  return static_cast<int>(b->chans.size());
}
void dy4_fsbatch_destroy(void* h) { delete static_cast<FrameSyncBatch*>(h); }

// ---- sink ----
void* dy4_sink_create(int fd, size_t capacity_bytes) {
  return new Sink(fd, capacity_bytes);
}
int dy4_sink_push(void* s, const uint8_t* data, size_t n, long timeout_ms) {
  return static_cast<Sink*>(s)->push(data, n, timeout_ms);
}
int dy4_sink_flush(void* s, long timeout_ms) {
  return static_cast<Sink*>(s)->flush(timeout_ms);
}
void dy4_sink_destroy(void* s) { delete static_cast<Sink*>(s); }

}  // extern "C"
