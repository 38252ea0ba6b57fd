// Bulk columnar decoder: msgpack op payloads → flat int arrays.
//
// The 1M-op ingestion path must not build a Python object per op
// (SURVEY.md §2.2: "decode op files directly into pre-allocated arrays
// without Python-object churn").  This decoder walks the framework's own
// canonical op encodings directly:
//
//   ORSet add:  [0, member, [actor16, counter]]
//   ORSet rm:   [1, member, {actor16: counter, ...}]
//   counter op: [dir, [actor16, counter]]   (G-Counter: bare [actor16, c])
//
// Members are interned against a caller-managed table via a callback-free
// two-pass protocol: pass 1 here extracts (kind, actor, counter) and member
// *byte spans*; the Python side interns spans (zero-copy slices) only for
// members, which in benchmarks are small ints/bytes.  For fully native
// speed, fixed-width member encodings (int64) are decoded inline.
//
// Only the msgpack subset the canonical codec emits is implemented:
// positive fixint/uint8/16/32/64, fixarray/array16/32, fixmap/map16/32,
// bin8/16/32, negative ints rejected (canonical ops never hold them).
// A counter past INT32_MAX does not fit the int32 columns: the payload is
// declined (-1) so the caller takes the per-op path, never a wrapped value.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kCounterMax = 0x7fffffff;  // the int32 column's range

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  uint8_t u8() {
    if (p >= end) { fail = true; return 0; }
    return *p++;
  }
  uint64_t be(int n) {
    uint64_t v = 0;
    if (p + n > end) { fail = true; p = end; return 0; }
    for (int i = 0; i < n; i++) v = (v << 8) | *p++;
    return v;
  }
  bool uint(uint64_t* out) {
    uint8_t t = u8();
    if (fail) return false;
    if (t <= 0x7f) { *out = t; return true; }
    if (t == 0xcc) { *out = be(1); return !fail; }
    if (t == 0xcd) { *out = be(2); return !fail; }
    if (t == 0xce) { *out = be(4); return !fail; }
    if (t == 0xcf) { *out = be(8); return !fail; }
    fail = true;
    return false;
  }
  bool arr(uint64_t* len) {
    uint8_t t = u8();
    if (fail) return false;
    if ((t & 0xf0) == 0x90) { *len = t & 0x0f; return true; }
    if (t == 0xdc) { *len = be(2); return !fail; }
    if (t == 0xdd) { *len = be(4); return !fail; }
    fail = true;
    return false;
  }
  bool map(uint64_t* len) {
    uint8_t t = u8();
    if (fail) return false;
    if ((t & 0xf0) == 0x80) { *len = t & 0x0f; return true; }
    if (t == 0xde) { *len = be(2); return !fail; }
    if (t == 0xdf) { *len = be(4); return !fail; }
    fail = true;
    return false;
  }
  // bin: returns span
  bool bin(const uint8_t** data, uint64_t* len) {
    uint8_t t = u8();
    if (fail) return false;
    if (t == 0xc4) *len = be(1);
    else if (t == 0xc5) *len = be(2);
    else if (t == 0xc6) *len = be(4);
    else { fail = true; return false; }
    if (fail || p + *len > end) { fail = true; return false; }
    *data = p;
    p += *len;
    return true;
  }
  // skip any value (for opaque members) returning its span
  bool span(const uint8_t** s, uint64_t* n) {
    const uint8_t* start = p;
    if (!skip()) return false;
    *s = start;
    *n = (uint64_t)(p - start);
    return true;
  }
  bool skip() {
    uint8_t t = u8();
    if (fail) return false;
    if (t <= 0x7f || t >= 0xe0 || t == 0xc0 || t == 0xc2 || t == 0xc3)
      return true;
    if ((t & 0xe0) == 0xa0) { uint64_t n = t & 0x1f; p += n; goto bound; }
    if ((t & 0xf0) == 0x90) { uint64_t n = t & 0x0f; return skip_n(n); }
    if ((t & 0xf0) == 0x80) { uint64_t n = t & 0x0f; return skip_n(2 * n); }
    switch (t) {
      case 0xcc: case 0xd0: p += 1; goto bound;
      case 0xcd: case 0xd1: p += 2; goto bound;
      case 0xce: case 0xd2: case 0xca: p += 4; goto bound;
      case 0xcf: case 0xd3: case 0xcb: p += 8; goto bound;
      case 0xc4: { uint64_t n = be(1); p += n; goto bound; }
      case 0xc5: { uint64_t n = be(2); p += n; goto bound; }
      case 0xc6: { uint64_t n = be(4); p += n; goto bound; }
      case 0xd9: { uint64_t n = be(1); p += n; goto bound; }
      case 0xda: { uint64_t n = be(2); p += n; goto bound; }
      case 0xdb: { uint64_t n = be(4); p += n; goto bound; }
      case 0xdc: { uint64_t n = be(2); return skip_n(n); }
      case 0xdd: { uint64_t n = be(4); return skip_n(n); }
      case 0xde: { uint64_t n = be(2); return skip_n(2 * n); }
      case 0xdf: { uint64_t n = be(4); return skip_n(2 * n); }
      default: fail = true; return false;
    }
  bound:
    if (p > end) { fail = true; return false; }
    return true;
  }
  bool skip_n(uint64_t n) {
    for (uint64_t i = 0; i < n; i++)
      if (!skip()) return false;
    return true;
  }
};

// dense 16-byte actor → index via caller-provided sorted table
int actor_index(const uint8_t* actors, uint64_t n_actors, const uint8_t* a) {
  // binary search over 16-byte keys
  uint64_t lo = 0, hi = n_actors;
  while (lo < hi) {
    uint64_t mid = (lo + hi) / 2;
    int c = memcmp(actors + 16 * mid, a, 16);
    if (c < 0) lo = mid + 1;
    else if (c > 0) hi = mid;
    else return (int)mid;
  }
  return -1;
}

// Optional open-addressing index over the actor table.  A binary search
// over 100k 16-byte keys costs ~17 scattered memcmp probes per op (~38ms
// of the config-5 decode); one hash probe with a single verify runs at
// memory latency.  slots == nullptr falls back to the binary search.
struct ActorLookup {
  const uint8_t* actors;
  uint64_t n;
  const int32_t* slots;  // n_slots entries, -1 = empty
  uint64_t mask;         // n_slots - 1 (n_slots is a power of two)
};

inline uint64_t actor_hash16(const uint8_t* a) {
  uint64_t u0, u1;
  memcpy(&u0, a, 8);
  memcpy(&u1, a + 8, 8);
  uint64_t h = (u0 ^ (u1 * 0x9E3779B97F4A7C15ull)) + (u1 >> 31);
  h ^= h >> 29;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 32;
  return h;
}

inline int actor_lookup(const ActorLookup& t, const uint8_t* a) {
  if (t.slots == nullptr) return actor_index(t.actors, t.n, a);
  uint64_t p = actor_hash16(a) & t.mask;
  for (;;) {
    int32_t s = t.slots[p];
    if (s < 0) return -1;
    if (memcmp(t.actors + 16 * (uint64_t)s, a, 16) == 0) return s;
    p = (p + 1) & t.mask;
  }
}

template <typename Sink>
int64_t orset_decode_sink(const uint8_t* buf, uint64_t len,
                          const ActorLookup& look, Sink& sink) {
  Reader r{buf, buf + len};
  uint64_t n_ops;
  if (!r.arr(&n_ops)) return -1;
  int64_t row = 0;
  for (uint64_t i = 0; i < n_ops; i++) {
    // Fast path for the dominant canonical add shape
    //   93 00 <member:fixint|cc|cd> 92 c4 10 <16B actor> <counter:…>
    // — one branch ladder instead of the generic nested walk (~2x on
    // add-heavy payloads; anything unexpected falls to the slow path).
    {
      const uint8_t* p = r.p;
      if ((uint64_t)(r.end - p) >= 24 && p[0] == 0x93 && p[1] == 0x00) {
        uint64_t moff0, mlen0;
        const uint8_t* q = p + 2;
        if (*q <= 0x7f) {
          moff0 = (uint64_t)(q - buf);
          mlen0 = 1;
          q += 1;
        } else if (*q == 0xcc && r.end - q >= 2) {
          moff0 = (uint64_t)(q - buf);
          mlen0 = 2;
          q += 2;
        } else if (*q == 0xcd && r.end - q >= 3) {
          moff0 = (uint64_t)(q - buf);
          mlen0 = 3;
          q += 3;
        } else {
          q = nullptr;
        }
        if (q != nullptr && (uint64_t)(r.end - q) >= 19 && q[0] == 0x92 &&
            q[1] == 0xc4 && q[2] == 0x10) {
          const uint8_t* a = q + 3;
          const uint8_t* c = a + 16;
          uint64_t counter;
          // the 24-byte entry guard covers fixint members only; a
          // uint16 member leaves the counter byte past it — re-bound
          bool okc = c < r.end;
          if (!okc) {
          } else if (*c <= 0x7f) {
            counter = *c;
            c += 1;
          } else if (*c == 0xcc && r.end - c >= 2) {
            counter = c[1];
            c += 2;
          } else if (*c == 0xcd && r.end - c >= 3) {
            counter = ((uint64_t)c[1] << 8) | c[2];
            c += 3;
          } else if (*c == 0xce && r.end - c >= 5) {
            counter = ((uint64_t)c[1] << 24) | ((uint64_t)c[2] << 16) |
                      ((uint64_t)c[3] << 8) | c[4];
            c += 5;
          } else {
            okc = false;
          }
          if (okc && counter > kCounterMax) return -1;
          if (okc) {
            int ai = actor_lookup(look, a);
            if (ai < 0) return -1;
            sink.emit(0, moff0, mlen0, ai, (int32_t)counter);
            row++;
            r.p = c;
            continue;
          }
        }
      }
    }
    uint64_t three, kind;
    if (!r.arr(&three) || three != 3 || !r.uint(&kind)) return -1;
    const uint8_t* mspan;
    uint64_t mlen;
    if (!r.span(&mspan, &mlen)) return -1;
    uint64_t moff = (uint64_t)(mspan - buf);
    if (kind == 0) {
      uint64_t two;
      const uint8_t* a;
      uint64_t alen, counter;
      if (!r.arr(&two) || two != 2 || !r.bin(&a, &alen) || alen != 16 ||
          !r.uint(&counter) || counter > kCounterMax)
        return -1;
      int ai = actor_lookup(look, a);
      if (ai < 0) return -1;
      sink.emit(0, moff, mlen, ai, (int32_t)counter);
      row++;
    } else if (kind == 1) {
      uint64_t m;
      if (!r.map(&m)) return -1;
      for (uint64_t j = 0; j < m; j++) {
        const uint8_t* a;
        uint64_t alen, counter;
        if (!r.bin(&a, &alen) || alen != 16 || !r.uint(&counter) ||
            counter > kCounterMax)
          return -1;
        int ai = actor_lookup(look, a);
        if (ai < 0) return -1;
        sink.emit(1, moff, mlen, ai, (int32_t)counter);
        row++;
      }
    } else {
      return -1;
    }
  }
  return row;
}

// Growable sink: single-pass decode with no pre-counting walk.
struct GrowSink {
  std::vector<int8_t> kind;
  std::vector<uint64_t> moff, mlen;
  std::vector<int32_t> actor, counter;
  inline void emit(int8_t k, uint64_t mo, uint64_t ml, int32_t a,
                   int32_t c) {
    kind.push_back(k);
    moff.push_back(mo);
    mlen.push_back(ml);
    actor.push_back(a);
    counter.push_back(c);
  }
};

}  // namespace

extern "C" {

// Fill a power-of-two open-addressing slot index over the 16-byte actor
// table (pair with orset_decode_batch_grow).  n_slots must be a power of
// two > n_actors; pick ~2× for short probe chains.
void actor_hash_build(const uint8_t* actors, uint64_t n_actors,
                      int32_t* slots, uint64_t n_slots) {
  const uint64_t mask = n_slots - 1;
  for (uint64_t i = 0; i < n_slots; i++) slots[i] = -1;
  for (uint64_t i = 0; i < n_actors; i++) {
    uint64_t p = actor_hash16(actors + 16 * i) & mask;
    while (slots[p] >= 0) p = (p + 1) & mask;
    slots[p] = (int32_t)i;
  }
}

// Batch variants: one native call for tens of thousands of payloads.  A
// per-payload ctypes round-trip costs ~25µs of Python overhead, which at
// the 100k-replica streaming scale (config 5: ~2-op files) dwarfs the
// decode itself; looping in C removes it.

// Single-pass growable batch decode: no pre-counting walk (the count
// pass re-parses every payload — ~half the decode cost at the config-5
// shape).  Returns an opaque handle + row count via n_rows_out, or
// nullptr on malformed input / unknown actor.  The caller copies the
// columns out with orset_decode_take (which frees the handle).
void* orset_decode_batch_grow(const uint8_t* buf, const uint64_t* bases,
                              const uint64_t* lens, uint64_t n_payloads,
                              const uint8_t* actors, uint64_t n_actors,
                              const int32_t* slots, uint64_t n_slots,
                              int64_t* n_rows_out) {
  ActorLookup look{actors, n_actors, slots, n_slots ? n_slots - 1 : 0};
  GrowSink* sink = nullptr;
  // bad_alloc from vector growth must not unwind through the extern "C"
  // boundary into ctypes (std::terminate); nullptr = caller falls back
  try {
    sink = new GrowSink();
    sink->kind.reserve(4 * n_payloads);
    for (uint64_t i = 0; i < n_payloads; i++) {
      const size_t before = sink->kind.size();
      int64_t got = orset_decode_sink(buf + bases[i], lens[i], look, *sink);
      if (got < 0) {
        delete sink;
        return nullptr;
      }
      for (size_t j = before; j < sink->kind.size(); j++)
        sink->moff[j] += bases[i];
    }
  } catch (const std::bad_alloc&) {
    delete sink;
    return nullptr;
  }
  *n_rows_out = (int64_t)sink->kind.size();
  return sink;
}

void orset_decode_take(void* h, int8_t* kind_out, uint64_t* member_off_out,
                       uint64_t* member_len_out, int32_t* actor_out,
                       int32_t* counter_out) {
  GrowSink* sink = (GrowSink*)h;
  const size_t n = sink->kind.size();
  if (n) {
    memcpy(kind_out, sink->kind.data(), n * sizeof(int8_t));
    memcpy(member_off_out, sink->moff.data(), n * sizeof(uint64_t));
    memcpy(member_len_out, sink->mlen.data(), n * sizeof(uint64_t));
    memcpy(actor_out, sink->actor.data(), n * sizeof(int32_t));
    memcpy(counter_out, sink->counter.data(), n * sizeof(int32_t));
  }
  delete sink;
}

void orset_decode_drop(void* h) { delete (GrowSink*)h; }

// Decode a counter op-file payload: array of [dir, [actor16, counter]]
// (PN-Counter) or [actor16, counter] (G-Counter).  Returns rows or -1.
int64_t counter_decode(const uint8_t* buf, uint64_t len,
                       const uint8_t* actors, uint64_t n_actors,
                       int8_t* sign_out, int32_t* actor_out,
                       int32_t* counter_out) {
  Reader r{buf, buf + len};
  uint64_t n_ops;
  if (!r.arr(&n_ops)) return -1;
  for (uint64_t i = 0; i < n_ops; i++) {
    uint64_t alen2;
    if (!r.arr(&alen2)) return -1;
    uint64_t dir = 0;
    const uint8_t* a;
    uint64_t alen, counter;
    if (alen2 == 2) {
      // peek: [bin, uint] = G-Counter dot; [uint, [..]] = PN op
      if (r.p < r.end && (*r.p == 0xc4 || *r.p == 0xc5 || *r.p == 0xc6)) {
        if (!r.bin(&a, &alen) || alen != 16 || !r.uint(&counter)) return -1;
      } else {
        uint64_t two;
        if (!r.uint(&dir) || dir > 1 || !r.arr(&two) || two != 2 ||
            !r.bin(&a, &alen) || alen != 16 || !r.uint(&counter))
          return -1;
      }
    } else {
      return -1;
    }
    if (counter > kCounterMax) return -1;
    int ai = actor_index(actors, n_actors, a);
    if (ai < 0) return -1;
    sign_out[i] = (int8_t)dir;
    actor_out[i] = ai;
    counter_out[i] = (int32_t)counter;
  }
  return (int64_t)n_ops;
}

// Batch counter decode into consecutive row slices (outputs must hold at
// least one row per payload byte — a safe upper bound since every op
// costs >1 byte).  Returns total rows or -1.
int64_t counter_decode_batch(const uint8_t* buf, const uint64_t* bases,
                             const uint64_t* lens, uint64_t n_payloads,
                             const uint8_t* actors, uint64_t n_actors,
                             int8_t* sign_out, int32_t* actor_out,
                             int32_t* counter_out) {
  int64_t row = 0;
  for (uint64_t i = 0; i < n_payloads; i++) {
    int64_t got = counter_decode(buf + bases[i], lens[i], actors, n_actors,
                                 sign_out + row, actor_out + row,
                                 counter_out + row);
    if (got < 0) return -1;
    row += got;
  }
  return row;
}

// FNV-1a over a byte span
static inline uint64_t span_hash(const uint8_t* p, uint64_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (uint64_t i = 0; i < n; i++) h = (h ^ p[i]) * 1099511628211ULL;
  return h;
}

// Intern member byte spans natively: rows → dense first-appearance ids.
// ``table``/``table_cap`` is caller-allocated scratch (int64, all -1,
// capacity a power of two > 2 * expected uniques).  Unique spans are
// emitted as (offset, length) pairs into uniq_off/uniq_len (capacity
// ``max_uniq``).  Returns the unique count, or -1 when uniq/table
// capacity is exhausted (caller falls back or retries bigger).
int64_t intern_spans_native(const uint8_t* buf, const uint64_t* off,
                            const uint64_t* len, int64_t n,
                            int64_t* table, int64_t table_cap,
                            int32_t* idx_out, uint64_t* uniq_off,
                            uint64_t* uniq_len, int64_t max_uniq) {
  const uint64_t mask = (uint64_t)table_cap - 1;
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* s = buf + off[i];
    const uint64_t L = len[i];
    uint64_t h = span_hash(s, L) & mask;
    for (;;) {
      int64_t slot = table[h];
      if (slot < 0) {
        if (n_uniq >= max_uniq || n_uniq * 2 >= table_cap) return -1;
        table[h] = n_uniq;
        uniq_off[n_uniq] = off[i];
        uniq_len[n_uniq] = L;
        idx_out[i] = (int32_t)n_uniq;
        n_uniq++;
        break;
      }
      if (uniq_len[slot] == L && memcmp(buf + uniq_off[slot], s, L) == 0) {
        idx_out[i] = (int32_t)slot;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return n_uniq;
}

}  // extern "C"
