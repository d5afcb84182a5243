// Mutable shared-memory channel: the compiled-DAG data plane.
//
// Reference: src/ray/core_worker/experimental_mutable_object_manager.h
// (:48 WriteAcquire/WriteRelease, :153 ReadAcquire/ReadRelease) and its
// Python face, python/ray/experimental/channel/shared_memory_channel.py
// :159 — pre-allocated mutable buffers with acquire/release semantics
// so a compiled DAG's repeated passes reuse ONE allocation instead of
// minting an object per tick.
//
// Design: a single-producer single-consumer ring of fixed-size slots in
// a POSIX shm file.  Synchronization is a pthread mutex + condvar pair
// with PTHREAD_PROCESS_SHARED set, living in the mapping's header (the
// reference uses the same pthread-in-shm technique).  The producer
// blocks when the ring is full (backpressure), the consumer when it is
// empty.  Peer death is detected two ways, both on the blocking paths
// (not just the close flag): the robust mutex surfaces EOWNERDEAD when
// a holder dies mid-critical-section, and each side records its pid in
// the header at open so a blocked wait can probe the peer process
// (kill(pid, 0)) between condvar slices and return -ECONNRESET instead
// of sleeping out the full timeout against a corpse.
//
// Build: g++ -O2 -shared -fPIC channel.cc -o libray_tpu_channel.so
// (the Python wrapper compiles this lazily and loads it with ctypes —
// no pybind11 in the image).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52544348414E4E32ULL;  // "RTCHANN2"

// Blocked waits wake at least this often to probe peer liveness.
constexpr double kProbeSliceS = 0.2;

struct Header {
  uint64_t magic;
  uint64_t n_slots;
  uint64_t slot_bytes;
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t write_idx;   // next slot the producer fills
  uint64_t read_idx;    // next slot the consumer drains
  uint32_t closed;      // either side closed
  uint32_t _pad;
  uint64_t writer_pid;  // recorded at open; 0 = side never attached
  uint64_t reader_pid;
  uint64_t lengths[];   // per-slot payload length
};

struct Chan {
  Header* h;
  uint8_t* slots;
  size_t map_bytes;
  int writable;
};

size_t total_bytes(uint64_t n_slots, uint64_t slot_bytes) {
  return sizeof(Header) + n_slots * sizeof(uint64_t) +
         n_slots * slot_bytes;
}

uint8_t* slot_base(Header* h) {
  return reinterpret_cast<uint8_t*>(h) + sizeof(Header) +
         h->n_slots * sizeof(uint64_t);
}

void abs_deadline(timespec* ts, double timeout_s) {
  // MONOTONIC: a wall-clock step (NTP) must not stretch or spuriously
  // expire blocked waits (condvars are initialized with the same
  // clock below).
  clock_gettime(CLOCK_MONOTONIC, ts);
  ts->tv_sec += static_cast<time_t>(timeout_s);
  ts->tv_nsec +=
      static_cast<long>((timeout_s - static_cast<time_t>(timeout_s)) * 1e9);
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

double now_mono() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) + ts.tv_nsec * 1e-9;
}

}  // namespace

extern "C" {

// Create the channel backing file and initialize the header.
// Returns 0 on success, -errno on failure.
int rtchan_create(const char* path, uint64_t n_slots,
                  uint64_t slot_bytes) {
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return -errno;
  size_t bytes = total_bytes(n_slots, slot_bytes);
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    int e = errno;
    close(fd);
    unlink(path);
    return -e;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    unlink(path);
    return -errno;
  }
  Header* h = static_cast<Header*>(mem);
  std::memset(h, 0, sizeof(Header));
  h->n_slots = n_slots;
  h->slot_bytes = slot_bytes;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // Robust: a holder dying with the lock leaves it recoverable
  // instead of deadlocking the peer.
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&h->not_full, &ca);
  pthread_cond_init(&h->not_empty, &ca);
  pthread_condattr_destroy(&ca);

  h->magic = kMagic;  // last: marks init complete
  msync(mem, sizeof(Header), MS_SYNC);
  munmap(mem, bytes);
  return 0;
}

// Open an existing channel.  Returns an opaque handle or null.
void* rtchan_open(const char* path, int writable) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  // Record this side's pid so the peer's blocked waits can probe our
  // liveness (single producer / single consumer: one pid per side).
  if (writable) {
    h->writer_pid = static_cast<uint64_t>(getpid());
  } else {
    h->reader_pid = static_cast<uint64_t>(getpid());
  }
  Chan* c = new Chan;
  c->h = h;
  c->slots = slot_base(h);
  c->map_bytes = static_cast<size_t>(st.st_size);
  c->writable = writable;
  return c;
}

// 1 if the OTHER side attached and its process no longer exists.  A
// same-pid ring (both endpoints in one process, e.g. in-process actors)
// never reports a dead peer — thread death is the actor runtime's to
// detect.
static int peer_is_dead(Chan* c) {
  uint64_t pid =
      c->writable ? c->h->reader_pid : c->h->writer_pid;
  if (pid == 0 || pid == static_cast<uint64_t>(getpid())) return 0;
  return kill(static_cast<pid_t>(pid), 0) == -1 && errno == ESRCH;
}

static int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // Previous holder died mid-critical-section; state is still
    // consistent for our ring (indices advance after writes).
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// pthread_cond_timedwait re-acquires the robust mutex, so it too can
// surface EOWNERDEAD; failing to mark the mutex consistent there
// would poison it (ENOTRECOVERABLE) on the next unlock — exactly the
// permanent wedge robustness exists to prevent.
static int timedwait_robust(pthread_cond_t* cv, Header* h,
                            const timespec* ts) {
  int rc = pthread_cond_timedwait(cv, &h->mu, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// Block until the ring has data (reader) / a free slot (writer), with
// the mutex held on entry AND exit.  Waits in <= kProbeSliceS slices,
// probing the peer process between slices — a peer dying mid-pass
// surfaces as -ECONNRESET in one slice instead of a full-timeout hang.
// Returns 0 (condition holds), -EPIPE (closed), -ETIMEDOUT, or
// -ECONNRESET (peer process gone).
static int wait_ring(Chan* c, int for_reader, double timeout_s) {
  Header* h = c->h;
  double deadline = now_mono() + timeout_s;
  while (for_reader ? (h->read_idx == h->write_idx)
                    : (h->write_idx - h->read_idx >= h->n_slots)) {
    if (h->closed) return -EPIPE;
    double left = deadline - now_mono();
    if (left <= 0) return -ETIMEDOUT;
    if (peer_is_dead(c)) return -ECONNRESET;
    timespec ts;
    abs_deadline(&ts, left < kProbeSliceS ? left : kProbeSliceS);
    timedwait_robust(for_reader ? &h->not_empty : &h->not_full, h, &ts);
  }
  return 0;
}

// Producer: wait for a free slot, copy payload in, publish.
// Returns 0, -ETIMEDOUT, -EPIPE (closed), -ECONNRESET (reader process
// died), -EMSGSIZE, or -errno.
int rtchan_put(void* chan, const uint8_t* data, uint64_t len,
               double timeout_s) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (len > h->slot_bytes) return -EMSGSIZE;
  if (lock_robust(h) != 0) return -EINVAL;
  int rc = wait_ring(c, /*for_reader=*/0, timeout_s);
  if (rc == 0 && h->closed) rc = -EPIPE;
  if (rc != 0) {
    pthread_mutex_unlock(&h->mu);
    return rc;
  }
  uint64_t slot = h->write_idx % h->n_slots;
  // Copy OUTSIDE the lock would race the consumer's release; with one
  // producer the slot is exclusively ours while unpublished, so drop
  // the lock during the (possibly large) memcpy.
  pthread_mutex_unlock(&h->mu);
  std::memcpy(c->slots + slot * h->slot_bytes, data, len);
  if (lock_robust(h) != 0) return -EINVAL;
  h->lengths[slot] = len;
  h->write_idx += 1;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Consumer: wait for a sealed slot; copies payload into out (cap
// out_cap) and releases the slot.  Returns payload length, -ETIMEDOUT,
// -EPIPE (closed AND drained), -ECONNRESET (writer process died), or
// -EMSGSIZE if out_cap is too small (slot is NOT released so the
// caller can retry with a bigger buffer).
int64_t rtchan_get(void* chan, uint8_t* out, uint64_t out_cap,
                   double timeout_s) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) return -EINVAL;
  int wrc = wait_ring(c, /*for_reader=*/1, timeout_s);
  if (wrc != 0) {
    pthread_mutex_unlock(&h->mu);
    return wrc;
  }
  uint64_t slot = h->read_idx % h->n_slots;
  uint64_t len = h->lengths[slot];
  if (len > out_cap) {
    pthread_mutex_unlock(&h->mu);
    return -EMSGSIZE;
  }
  // Single consumer: the slot stays ours until we advance read_idx.
  pthread_mutex_unlock(&h->mu);
  std::memcpy(out, c->slots + slot * h->slot_bytes, len);
  if (lock_robust(h) != 0) return -EINVAL;
  h->read_idx += 1;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len);
}

// Peek the next payload length without consuming (-EPIPE / -ETIMEDOUT
// as in rtchan_get, 0 timeout = non-blocking probe returning -EAGAIN).
int64_t rtchan_next_len(void* chan, double timeout_s) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) return -EINVAL;
  if (timeout_s <= 0 && h->read_idx == h->write_idx) {
    int empty_rc = h->closed ? -EPIPE : -EAGAIN;
    pthread_mutex_unlock(&h->mu);
    return empty_rc;
  }
  int wrc = wait_ring(c, /*for_reader=*/1, timeout_s);
  if (wrc != 0) {
    pthread_mutex_unlock(&h->mu);
    return wrc;
  }
  int64_t len =
      static_cast<int64_t>(h->lengths[h->read_idx % h->n_slots]);
  pthread_mutex_unlock(&h->mu);
  return len;
}

// In-place slot access (SPSC makes it safe: the writer owns an
// unpublished slot exclusively, the reader owns the head slot until it
// advances read_idx).  The Python adapter assembles/parses frames
// directly in slot memory — one memcpy per side instead of three.

// Wait for a free slot and return its base pointer, or null with
// *err = -ETIMEDOUT / -EPIPE / -EINVAL.  Caller writes <= slot_bytes
// then calls rtchan_write_commit(len).
uint8_t* rtchan_write_begin(void* chan, double timeout_s, int64_t* err) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) { *err = -EINVAL; return nullptr; }
  int wrc = wait_ring(c, /*for_reader=*/0, timeout_s);
  if (wrc == 0 && h->closed) wrc = -EPIPE;
  if (wrc != 0) {
    pthread_mutex_unlock(&h->mu);
    *err = wrc;
    return nullptr;
  }
  uint64_t slot = h->write_idx % h->n_slots;
  pthread_mutex_unlock(&h->mu);
  *err = 0;
  return c->slots + slot * h->slot_bytes;
}

int rtchan_write_commit(void* chan, uint64_t len) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (len > h->slot_bytes) return -EMSGSIZE;
  if (lock_robust(h) != 0) return -EINVAL;
  uint64_t slot = h->write_idx % h->n_slots;
  h->lengths[slot] = len;
  h->write_idx += 1;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Wait for a sealed slot; returns its base pointer with *len_or_err =
// payload length, or null with *len_or_err = -ETIMEDOUT / -EPIPE /
// -EINVAL.  The slot stays valid until rtchan_read_commit.
uint8_t* rtchan_read_begin(void* chan, double timeout_s,
                           int64_t* len_or_err) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) { *len_or_err = -EINVAL; return nullptr; }
  int wrc = wait_ring(c, /*for_reader=*/1, timeout_s);
  if (wrc != 0) {
    pthread_mutex_unlock(&h->mu);
    *len_or_err = wrc;
    return nullptr;
  }
  uint64_t slot = h->read_idx % h->n_slots;
  *len_or_err = static_cast<int64_t>(h->lengths[slot]);
  pthread_mutex_unlock(&h->mu);
  return c->slots + slot * h->slot_bytes;
}

int rtchan_read_commit(void* chan) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) return -EINVAL;
  h->read_idx += 1;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Geometry getters: the adapter layer sizes frames against the slot
// capacity (oversize payloads fall back to the object plane per-pass).
int64_t rtchan_slot_bytes(void* chan) {
  return static_cast<int64_t>(static_cast<Chan*>(chan)->h->slot_bytes);
}

int64_t rtchan_n_slots(void* chan) {
  return static_cast<int64_t>(static_cast<Chan*>(chan)->h->n_slots);
}

// Test hook: take the shared mutex and DON'T release it.  A process
// calling this then dying exercises the robust-mutex recovery path
// (EOWNERDEAD → pthread_mutex_consistent) from a real peer death.
int rtchan_debug_lock(void* chan) {
  return lock_robust(static_cast<Chan*>(chan)->h);
}

// Non-blocking peer-liveness probe for the adapter layer (the same
// check the blocked waits run between condvar slices).
int rtchan_peer_dead(void* chan) {
  return peer_is_dead(static_cast<Chan*>(chan));
}

int rtchan_size(void* chan) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) != 0) return -EINVAL;
  int n = static_cast<int>(h->write_idx - h->read_idx);
  pthread_mutex_unlock(&h->mu);
  return n;
}

void rtchan_close(void* chan) {
  Chan* c = static_cast<Chan*>(chan);
  Header* h = c->h;
  if (lock_robust(h) == 0) {
    h->closed = 1;
    pthread_cond_broadcast(&h->not_empty);
    pthread_cond_broadcast(&h->not_full);
    pthread_mutex_unlock(&h->mu);
  }
}

void rtchan_free(void* chan) {
  Chan* c = static_cast<Chan*>(chan);
  munmap(c->h, c->map_bytes);
  delete c;
}

}  // extern "C"
