// Native OR-Set state assembly: the port's copy of
// crdt_enc_tpu/native/statebuild.cpp, trimmed to what the port calls.
//
//  * a packed-u64 LSD radix sort ((segment_key)·(maxc+1) + counter), so
//    "last of run holds the segment max" falls out of the sort order;
//  * the split fresh fold (orset_fold_rows / _take / _drop): one
//    combined fold of a raw op batch into an EMPTY state, surviving rows
//    out as plain int arrays in the orset_pack_checkpoint row layout;
//  * grouped_rows_dicts: member-contiguous rows -> {member: {actor: c}}
//    dicts built through the CPython C-API, and dense_clock_dict for the
//    clock;
//  * canon_pack: the canonical msgpack packer, byte-identical to
//    utils/codec.py's pack_py on every object it accepts.
//
// Semantics are exactly ops/columnar.py orset_fold_sparse_host +
// orset_apply_coo's fresh path (strict > horizon for adds, removes kept
// only above the merged clock).
//
// This library is loaded with ctypes.PyDLL (GIL held) because it creates
// Python objects; it is built apart from libcrdtnative, whose calls
// release the GIL.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

// Presized dict creation skips the grow/rehash cascade while filling.
// _PyDict_NewPresized is a private-but-exported CPython symbol; it is
// weak-linked so a Python that drops it falls back to PyDict_New.
extern "C" PyObject* _PyDict_NewPresized(Py_ssize_t minused)
    __attribute__((weak));

namespace {

PyObject* new_dict_presized(Py_ssize_t n) {
    if (_PyDict_NewPresized != nullptr && n > 5)
        return _PyDict_NewPresized(n);
    return PyDict_New();
}

// LSD radix sort of uint64 values, 8-bit digits, skipping passes whose
// digit is constant across the array (high zero bytes of small keys).
void radix_sort_u64(std::vector<uint64_t>& a, uint64_t maxval) {
    if (a.size() < 2) return;
    std::vector<uint64_t> tmp(a.size());
    uint64_t* src = a.data();
    uint64_t* dst = tmp.data();
    bool in_tmp = false;
    for (int pass = 0; pass < 8; ++pass) {
        const int shift = pass * 8;
        if ((maxval >> shift) == 0) break;  // no set bits at/after this byte
        size_t hist[256] = {0};
        const size_t n = a.size();
        for (size_t i = 0; i < n; ++i) hist[(src[i] >> shift) & 0xff]++;
        if (hist[(src[0] >> shift) & 0xff] == n) continue;  // constant digit
        size_t sum = 0;
        for (int b = 0; b < 256; ++b) {
            size_t c = hist[b];
            hist[b] = sum;
            sum += c;
        }
        for (size_t i = 0; i < n; ++i)
            dst[hist[(src[i] >> shift) & 0xff]++] = src[i];
        std::swap(src, dst);
        in_tmp = !in_tmp;
    }
    if (in_tmp) std::memcpy(a.data(), src, a.size() * sizeof(uint64_t));
}

// Dedup a sorted packed array (key = p / M, val = p % M) into (seg, val)
// arrays keeping the last (= max val) entry of every key run.
void dedup(const std::vector<uint64_t>& packed, uint64_t M,
           std::vector<int64_t>& seg, std::vector<int64_t>& val) {
    const size_t n = packed.size();
    seg.reserve(n);
    val.reserve(n);
    for (size_t i = 0; i < n; ++i) {
        if (i + 1 < n && packed[i] / M == packed[i + 1] / M) continue;
        seg.push_back((int64_t)(packed[i] / M));
        val.push_back((int64_t)(packed[i] % M));
    }
}

struct FoldRows {
    std::vector<int64_t> aseg, aval, rseg, rval;
    int64_t R;
};

// The fold of a raw (kind, member, actor, counter) batch against an
// empty state: gate + pack + radix sort + dedup + survivor filter.
//
//  kind:    (n,) int8   0=add 1=remove (anything else ignored)
//  member:  (n,) int32  vocab index < E
//  actor:   (n,) int32  vocab index; >= R marks a padding row
//  counter: (n,) int32  dot counter / horizon
//  clock:   (R,) int32  in-out: the state's dense clock, merged in place
//
// Returns false (out untouched) when the shape overflows the packed-key
// sort; the caller then takes the numpy path.
bool orset_fresh_fold_impl(const int8_t* kind, const int32_t* member,
                           const int32_t* actor, const int32_t* counter,
                           int64_t n, int64_t E, int64_t R, int32_t* clock,
                           FoldRows& out) {
    // pass 0: max counter over participating rows (packing modulus)
    int64_t maxc = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (actor[i] >= R) continue;
        if (counter[i] > maxc) maxc = counter[i];
    }
    const uint64_t M = (uint64_t)maxc + 1;
    const uint64_t segspace = (uint64_t)E * (uint64_t)R;
    // overflow guard: packed = seg·M + c with seg < segspace must fit
    // u64 comfortably (two sides sorted separately, so no 2x factor)
    if (segspace != 0 && M > (((uint64_t)1 << 62) / (segspace + 1)))
        return false;

    // pass 1: gate + pack into separate add/remove arrays.  Add rows gate
    // against the ORIGINAL clock (copy) while the merged clock updates in
    // place — the numpy path's order of effects (np.maximum.at over live
    // adds, then the remove filter sees the merged clock).
    std::vector<int32_t> clock0(clock, clock + (size_t)R);
    std::vector<uint64_t> adds, rms;
    adds.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t a = actor[i];
        if (a < 0 || a >= R) continue;
        const int64_t c = counter[i];
        if (c < 0) continue;  // defensive: counters are non-negative
        const uint64_t seg = (uint64_t)member[i] * (uint64_t)R + (uint64_t)a;
        if (kind[i] == 0) {
            if (c > clock0[a]) {  // replay gate vs the incoming clock
                adds.push_back(seg * M + (uint64_t)c);
                if (c > clock[a]) clock[a] = (int32_t)c;  // merged clock
            }
        } else if (kind[i] == 1) {
            rms.push_back(seg * M + (uint64_t)c);
        }
    }
    const uint64_t maxpacked = segspace == 0 ? 0 : (segspace - 1) * M + maxc;
    radix_sort_u64(adds, maxpacked);
    radix_sort_u64(rms, maxpacked);

    out.R = R;
    dedup(adds, M, out.aseg, out.aval);
    dedup(rms, M, out.rseg, out.rval);

    // adds survive a STRICTLY greater horizon on their own segment (an
    // equal horizon observed the dot — it dies); merge-join on the
    // sorted segs
    {
        size_t keep = 0, r = 0;
        for (size_t i = 0; i < out.aseg.size(); ++i) {
            while (r < out.rseg.size() && out.rseg[r] < out.aseg[i]) ++r;
            const int64_t horizon =
                (r < out.rseg.size() && out.rseg[r] == out.aseg[i])
                    ? out.rval[r] : 0;
            if (out.aval[i] > horizon) {
                out.aseg[keep] = out.aseg[i];
                out.aval[keep] = out.aval[i];
                ++keep;
            }
        }
        out.aseg.resize(keep);
        out.aval.resize(keep);
    }
    // removes survive only above the MERGED clock
    {
        size_t keep = 0;
        for (size_t i = 0; i < out.rseg.size(); ++i) {
            if (out.rval[i] > clock[out.rseg[i] % R]) {
                out.rseg[keep] = out.rseg[i];
                out.rval[keep] = out.rval[i];
                ++keep;
            }
        }
        out.rseg.resize(keep);
        out.rval.resize(keep);
    }
    return true;
}

}  // namespace

extern "C" {

// ---- split fold: rows out, dicts assembled separately ---------------------
//
// The surviving rows come out as plain int arrays FIRST —
// member-contiguous, actor-ascending: exactly the orset_pack_checkpoint
// row layout — so the caller times the fold apart from the writeback,
// hands the SAME rows to grouped_rows_dicts for the dict writeback, and
// seals the warm-open checkpoint straight from them with no dict walk.

// Fold a raw op batch against an empty state: merged clock in place,
// surviving add/remove rows retained on the returned handle.  Writes
// {n_adds, n_removes} into counts.  Returns NULL when the shape overflows
// the packed-key sort or allocation fails (the caller takes the numpy
// path; clock may be partially merged — callers pass a scratch copy).
void* orset_fold_rows(const int8_t* kind, const int32_t* member,
                      const int32_t* actor, const int32_t* counter,
                      int64_t n, int64_t E, int64_t R, int32_t* clock,
                      int64_t* counts) {
    FoldRows* out = nullptr;
    try {
        out = new FoldRows;
        if (!orset_fresh_fold_impl(kind, member, actor, counter, n, E, R,
                                   clock, *out)) {
            delete out;
            return nullptr;
        }
        counts[0] = (int64_t)out->aseg.size();
        counts[1] = (int64_t)out->rseg.size();
        return out;
    } catch (const std::bad_alloc&) {
        delete out;
        return nullptr;
    }
}

// Copy the surviving rows out as (member, actor, counter) columns —
// member-contiguous (sort order), actor ascending within a member, the
// orset_pack_checkpoint group contract — and free the handle.  The caller
// sizes the six arrays from the counts orset_fold_rows wrote and passes
// them back as the write bounds; a mismatch writes NOTHING past either
// capacity and returns -1.
int orset_fold_rows_take(void* handle, int32_t* am, int32_t* aa,
                         int64_t* ac, int64_t a_capacity, int32_t* dm,
                         int32_t* da, int64_t* dc, int64_t d_capacity) {
    FoldRows* rows = (FoldRows*)handle;
    if ((int64_t)rows->aseg.size() != a_capacity ||
        (int64_t)rows->rseg.size() != d_capacity) {
        delete rows;
        return -1;
    }
    const int64_t R = rows->R;
    for (size_t i = 0; i < rows->aseg.size(); ++i) {
        am[i] = (int32_t)(rows->aseg[i] / R);
        aa[i] = (int32_t)(rows->aseg[i] % R);
        ac[i] = rows->aval[i];
    }
    for (size_t i = 0; i < rows->rseg.size(); ++i) {
        dm[i] = (int32_t)(rows->rseg[i] / R);
        da[i] = (int32_t)(rows->rseg[i] % R);
        dc[i] = rows->rval[i];
    }
    delete rows;
    return 0;
}

void orset_fold_rows_drop(void* handle) { delete (FoldRows*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------
// Canonical msgpack packer — the native twin of utils/codec.py pack_py:
// smallest-encoding msgpack, bytes as bin, tuples as arrays, and every
// map emitted with keys sorted by their packed bytes.  Unsupported types
// return 0 and the Python caller falls back.
// ---------------------------------------------------------------------

namespace {

struct Out {
  std::vector<uint8_t> b;
  void u8(uint8_t v) { b.push_back(v); }
  void be16(uint16_t v) { u8(v >> 8); u8(v & 0xff); }
  void be32(uint32_t v) { be16(v >> 16); be16(v & 0xffff); }
  void be64(uint64_t v) { be32(v >> 32); be32(v & 0xffffffffull); }
  void raw(const void* p, size_t n) {
    const uint8_t* c = (const uint8_t*)p;
    b.insert(b.end(), c, c + n);
  }
};

// returns 1 ok, 0 unsupported (no exception), -1 python error (exc set)
int canon_emit(PyObject* obj, Out& out, int depth) {
  if (depth > 200) return 0;
  if (obj == Py_None) { out.u8(0xc0); return 1; }
  if (obj == Py_True) { out.u8(0xc3); return 1; }
  if (obj == Py_False) { out.u8(0xc2); return 1; }
  if (PyLong_CheckExact(obj)) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow > 0) {
      unsigned long long u = PyLong_AsUnsignedLongLong(obj);
      if (u == (unsigned long long)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        return 0;  // > 2^64-1: let the Python packer raise its error
      }
      out.u8(0xcf);
      out.be64(u);
      return 1;
    }
    if (overflow < 0) return 0;  // < -2^63
    if (v == -1 && PyErr_Occurred()) return -1;
    if (v >= 0) {
      unsigned long long u = (unsigned long long)v;
      if (u < 0x80) out.u8((uint8_t)u);
      else if (u <= 0xff) { out.u8(0xcc); out.u8((uint8_t)u); }
      else if (u <= 0xffff) { out.u8(0xcd); out.be16((uint16_t)u); }
      else if (u <= 0xffffffffull) { out.u8(0xce); out.be32((uint32_t)u); }
      else { out.u8(0xcf); out.be64(u); }
    } else {
      if (v >= -32) out.u8((uint8_t)(int8_t)v);
      else if (v >= -128) { out.u8(0xd0); out.u8((uint8_t)(int8_t)v); }
      else if (v >= -32768) { out.u8(0xd1); out.be16((uint16_t)(int16_t)v); }
      else if (v >= -2147483648ll) {
        out.u8(0xd2);
        out.be32((uint32_t)(int32_t)v);
      } else {
        out.u8(0xd3);
        out.be64((uint64_t)v);
      }
    }
    return 1;
  }
  if (PyBytes_CheckExact(obj)) {
    const size_t n = (size_t)PyBytes_GET_SIZE(obj);
    if (n <= 0xff) { out.u8(0xc4); out.u8((uint8_t)n); }
    else if (n <= 0xffff) { out.u8(0xc5); out.be16((uint16_t)n); }
    else if (n <= 0xffffffffull) { out.u8(0xc6); out.be32((uint32_t)n); }
    else return 0;
    out.raw(PyBytes_AS_STRING(obj), n);
    return 1;
  }
  if (PyUnicode_CheckExact(obj)) {
    Py_ssize_t n;
    const char* s = PyUnicode_AsUTF8AndSize(obj, &n);
    if (s == nullptr) return -1;
    if (n < 32) out.u8(0xa0 | (uint8_t)n);
    else if (n <= 0xff) { out.u8(0xd9); out.u8((uint8_t)n); }
    else if (n <= 0xffff) { out.u8(0xda); out.be16((uint16_t)n); }
    else if ((unsigned long long)n <= 0xffffffffull) {
      out.u8(0xdb);
      out.be32((uint32_t)n);
    } else return 0;
    out.raw(s, (size_t)n);
    return 1;
  }
  if (PyFloat_CheckExact(obj)) {
    double d = PyFloat_AS_DOUBLE(obj);
    uint64_t bits;
    memcpy(&bits, &d, 8);
    out.u8(0xcb);
    out.be64(bits);
    return 1;
  }
  if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
    const int is_list = PyList_CheckExact(obj);
    const Py_ssize_t n =
        is_list ? PyList_GET_SIZE(obj) : PyTuple_GET_SIZE(obj);
    if (n < 16) out.u8(0x90 | (uint8_t)n);
    else if (n <= 0xffff) { out.u8(0xdc); out.be16((uint16_t)n); }
    else if ((unsigned long long)n <= 0xffffffffull) {
      out.u8(0xdd);
      out.be32((uint32_t)n);
    } else return 0;
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* it =
          is_list ? PyList_GET_ITEM(obj, i) : PyTuple_GET_ITEM(obj, i);
      int rc = canon_emit(it, out, depth + 1);
      if (rc != 1) return rc;
    }
    return 1;
  }
  if (PyDict_CheckExact(obj)) {
    const Py_ssize_t n = PyDict_GET_SIZE(obj);
    if (n < 16) out.u8(0x80 | (uint8_t)n);
    else if (n <= 0xffff) { out.u8(0xde); out.be16((uint16_t)n); }
    else if ((unsigned long long)n <= 0xffffffffull) {
      out.u8(0xdf);
      out.be32((uint32_t)n);
    } else return 0;
    // pack (key bytes, value bytes) pairs, sort by key bytes — the
    // canonical-map ordering pack_py defines (a stable sort, as Python's)
    struct Pair {
      std::vector<uint8_t> k, v;
    };
    std::vector<Pair> pairs;
    pairs.reserve((size_t)n);
    Py_ssize_t pos = 0;
    PyObject *key, *val;
    while (PyDict_Next(obj, &pos, &key, &val)) {
      Out ko, vo;
      int rc = canon_emit(key, ko, depth + 1);
      if (rc != 1) return rc;
      rc = canon_emit(val, vo, depth + 1);
      if (rc != 1) return rc;
      pairs.push_back(Pair{std::move(ko.b), std::move(vo.b)});
    }
    std::stable_sort(pairs.begin(), pairs.end(),
                     [](const Pair& a, const Pair& b) { return a.k < b.k; });
    for (const Pair& p : pairs) {
      out.raw(p.k.data(), p.k.size());
      out.raw(p.v.data(), p.v.size());
    }
    return 1;
  }
  return 0;  // sets, numpy scalars, subclasses, custom types → Python
}

}  // namespace

extern "C" {

// Canonical-pack ``obj``; returns a bytes object, Py_None when the object
// graph contains a type this packer does not handle (the caller falls
// back to the Python path), or NULL on a Python error.
PyObject* canon_pack(PyObject* obj) {
  // bad_alloc from buffer growth must not unwind into ctypes — surface it
  // as a Python MemoryError instead
  try {
    Out out;
    out.b.reserve(256);
    int rc = canon_emit(obj, out, 0);
    if (rc < 0) return nullptr;
    if (rc == 0) Py_RETURN_NONE;
    return PyBytes_FromStringAndSize((const char*)out.b.data(),
                                     (Py_ssize_t)out.b.size());
  } catch (const std::bad_alloc&) {
    return PyErr_NoMemory();
  }
}

// Build target[members[m]] = {actors[a]: counter} from row arrays whose
// member runs are contiguous (a plane's np.nonzero, the fresh fold's
// rows, a checkpoint's rows).  Returns 0, or -1 on any allocation
// failure / out-of-range index.  Every -1 path clears the Python error
// indicator: the caller (a ctypes c_int restype, which never checks
// PyErr) treats -1 as "clear `target` and raise", and a live indicator
// would surface later as an unrelated SystemError.
int grouped_rows_dicts(const int32_t* m_idx, const int32_t* a_idx,
                       const int64_t* ctr, int64_t n, PyObject* members,
                       PyObject* actors, PyObject* target) {
    if (!PyList_Check(members) || !PyList_Check(actors) ||
        !PyDict_Check(target))
        return -1;
    const Py_ssize_t n_m = PyList_GET_SIZE(members);
    const Py_ssize_t n_a = PyList_GET_SIZE(actors);
    int64_t i = 0;
    while (i < n) {
        const int32_t m = m_idx[i];
        if (m < 0 || (Py_ssize_t)m >= n_m) return -1;
        int64_t j = i;
        while (j < n && m_idx[j] == m) j++;
        PyObject* slot = new_dict_presized((Py_ssize_t)(j - i));
        if (!slot) { PyErr_Clear(); return -1; }
        for (int64_t t = i; t < j; ++t) {
            const int32_t a = a_idx[t];
            if (a < 0 || (Py_ssize_t)a >= n_a) { Py_DECREF(slot); return -1; }
            PyObject* c = PyLong_FromLongLong((long long)ctr[t]);
            if (!c || PyDict_SetItem(
                          slot, PyList_GET_ITEM(actors, (Py_ssize_t)a), c)
                          < 0) {
                Py_XDECREF(c);
                Py_DECREF(slot);
                PyErr_Clear();
                return -1;
            }
            Py_DECREF(c);
        }
        if (PyDict_SetItem(target, PyList_GET_ITEM(members, (Py_ssize_t)m),
                           slot) < 0) {
            Py_DECREF(slot);
            PyErr_Clear();
            return -1;
        }
        Py_DECREF(slot);
        i = j;
    }
    return 0;
}

// Build {actor_obj: counter} for the nonzero entries of a dense clock —
// the native twin of ops/columnar.py dense_to_vclock's dict body.
// Returns a NEW dict, or NULL on error.
PyObject* dense_clock_dict(const int32_t* clock, int64_t R,
                           PyObject* actor_objs) {
    int64_t nz = 0;
    for (int64_t i = 0; i < R; ++i) nz += (clock[i] != 0);
    PyObject* d = new_dict_presized((Py_ssize_t)nz);
    if (!d) return nullptr;
    for (int64_t i = 0; i < R; ++i) {
        if (clock[i] == 0) continue;
        PyObject* c = PyLong_FromLong((long)clock[i]);
        if (!c ||
            PyDict_SetItem(d, PyList_GET_ITEM(actor_objs, (Py_ssize_t)i), c) <
                0) {
            Py_XDECREF(c);
            Py_DECREF(d);
            return nullptr;
        }
        Py_DECREF(c);
    }
    return d;
}

}  // extern "C"
