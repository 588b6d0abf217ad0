// ndjson: the port's host-side campaign-log encoder and classifier.
//
// Formats campaign rows as InjectionLog-schema JSON lines, one a row,
// byte for byte what inject/logs.py's Python formatter writes
// (_ndjson_rows_py), in one C pass over the int32 columns.  The
// counterpart of the reference's coast_ndjson_encode /
// coast_ndjson_encode_rows (coast_tpu/native/coast_core.cpp); this file
// is the port's own copy and links nothing of the reference.
//
// String fields (each leaf's section kind and name, the timestamp) arrive
// JSON-escaped from Python, once a campaign.  Class codes are
// inject/classify.py's:
//   0 SUCCESS, 1 CORRECTED, 2 SDC, 3 DUE_ABORT, 4 DUE_TIMEOUT, 5 INVALID,
//   6 DUE_STACK_OVERFLOW, 7 DUE_ASSERT, 8 TRAIN_SELF_HEAL, 9 TRAIN_SDC.
// A row with t < 0 is a cache draw outside the program's footprint (never
// fired): it goes to the "cache-invalid" pseudo-section.
//
// Each entry returns the bytes written into out, -1 when the rows do not
// fit out_cap (every write is bounds-checked; the caller retries fewer
// rows), or -2 on malformed input.  Plain C interface, loaded with ctypes
// (which releases the interpreter lock for the call).
//
// coast_ndjson_classify is the read side: the class counts of
// analysis/json_parser.py's classify_run over a buffer of InjectionLog
// lines, the counterpart of the reference's function of that name.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (coast_tpu_torch/build.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Append helpers: memcpy and a hand-rolled itoa.  On overflow the writer
// latches and the encoder returns -1, so buffer safety never depends on
// the caller's per-line size estimate.
struct Writer {
  char* p;
  char* end;
  bool overflow = false;
};

inline void put_str(Writer& w, const char* s, size_t len) {
  if (w.overflow || static_cast<size_t>(w.end - w.p) < len) {
    w.overflow = true;
    return;
  }
  std::memcpy(w.p, s, len);
  w.p += len;
}

inline void put_lit(Writer& w, const char* s) {
  put_str(w, s, std::strlen(s));
}

inline void put_i64(Writer& w, int64_t v) {
  char tmp[24];
  char* q = tmp + sizeof tmp;
  const bool neg = v < 0;
  uint64_t u = neg ? static_cast<uint64_t>(-(v + 1)) + 1
                   : static_cast<uint64_t>(v);
  do {
    *--q = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  if (neg) *--q = '-';
  put_str(w, q, static_cast<size_t>(tmp + sizeof tmp - q));
}

// The RunResult fields of a completed run (SUCCESS, CORRECTED, SDC and
// the training refinements): core, runtime, errors, faults.
inline void put_run_fields(Writer& w, int64_t steps, int64_t errors,
                           int64_t corrected) {
  put_lit(w, "\"core\": 0, \"runtime\": ");
  put_i64(w, steps);
  put_lit(w, ", \"errors\": ");
  put_i64(w, errors);
  put_lit(w, ", \"faults\": ");
  put_i64(w, corrected);
  put_lit(w, "}");
}

int64_t encode_body(int64_t lo, int64_t hi, int64_t number_base,
                    const int32_t* leaf_id, const int32_t* lane,
                    const int32_t* word, const int32_t* bit,
                    const int32_t* t, const int32_t* code,
                    const int32_t* errors, const int32_t* corrected,
                    const int32_t* steps, int32_t n_leaves,
                    const char* const* sec_kind, const char* const* sec_name,
                    const char* ts, char* out, int64_t out_cap) {
  if (lo < 0 || hi < lo || n_leaves < 0 || out_cap < 0) return -2;
  const size_t ts_len = std::strlen(ts);
  std::vector<size_t> kind_len(n_leaves), name_len(n_leaves);
  for (int32_t s = 0; s < n_leaves; ++s) {
    kind_len[s] = std::strlen(sec_kind[s]);
    name_len[s] = std::strlen(sec_name[s]);
  }
  Writer w{out, out + out_cap};
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t lid = leaf_id[i];
    const bool invalid_line = t[i] < 0;
    if (!invalid_line && (lid < 0 || lid >= n_leaves)) return -2;
    put_lit(w, "{\"timestamp\": \"");
    put_str(w, ts, ts_len);
    put_lit(w, "\", \"number\": ");
    put_i64(w, number_base + i);
    put_lit(w, ", \"section\": \"");
    if (invalid_line) {
      put_lit(w, "cache-invalid");
    } else {
      put_str(w, sec_kind[lid], kind_len[lid]);
    }
    put_lit(w, "\", \"address\": ");
    put_i64(w, word[i]);
    put_lit(w, ", \"oldValue\": null, \"newValue\": null, "
               "\"sleepTime\": 0, \"cycles\": ");
    put_i64(w, t[i]);
    put_lit(w, ", \"PC\": ");
    put_i64(w, t[i]);
    put_lit(w, ", \"name\": \"");
    if (invalid_line) {
      put_lit(w, "<invalid-line>^bit");
      put_i64(w, bit[i]);
    } else {
      put_str(w, sec_name[lid], name_len[lid]);
      put_lit(w, "[lane ");
      put_i64(w, lane[i]);
      put_lit(w, "]^bit");
      put_i64(w, bit[i]);
    }
    put_lit(w, "\", \"symbol\": \"");
    if (invalid_line) {
      put_lit(w, "<invalid-line>");
    } else {
      put_str(w, sec_name[lid], name_len[lid]);
    }
    put_lit(w, "\", \"result\": ");
    switch (code[i]) {
      case 0:  // SUCCESS
      case 1:  // CORRECTED
      case 2:  // SDC
        put_lit(w, "{\"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", ");
        put_run_fields(w, steps[i], errors[i], corrected[i]);
        break;
      case 3:  // DUE_ABORT
        put_lit(w, "{\"type\": \"DWC/CFCSS\", \"message\": "
                   "\"FAULT_DETECTED abort\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", \"errors\": 1}");
        break;
      case 4:  // DUE_TIMEOUT
        put_lit(w, "{\"trap\": false, \"timeout\": \"hit step bound at ");
        put_i64(w, steps[i]);
        put_lit(w, "\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\"}");
        break;
      case 5:  // INVALID
        put_lit(w, "{\"invalid\": \"self-check out of domain (E=");
        put_i64(w, errors[i]);
        put_lit(w, ")\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\"}");
        break;
      case 6:  // DUE_STACK_OVERFLOW
        put_lit(w, "{\"stackOverflow\": \"stack check tripped at step ");
        put_i64(w, steps[i]);
        put_lit(w, "\", \"taskName\": \"<kernel>\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", \"errors\": 1}");
        break;
      case 7:  // DUE_ASSERT
        put_lit(w, "{\"assertion\": \"kernel assert tripped at step ");
        put_i64(w, steps[i]);
        put_lit(w, "\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", \"errors\": 1}");
        break;
      case 8:  // TRAIN_SELF_HEAL
        put_lit(w, "{\"selfHeal\": \"transient loss perturbation healed "
                   "(E=");
        put_i64(w, errors[i]);
        put_lit(w, ")\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", ");
        put_run_fields(w, steps[i], errors[i], corrected[i]);
        break;
      case 9:  // TRAIN_SDC
        put_lit(w, "{\"trainSdc\": \"persistent weight corruption (E=");
        put_i64(w, errors[i]);
        put_lit(w, ")\", \"timestamp\": \"");
        put_str(w, ts, ts_len);
        put_lit(w, "\", ");
        put_run_fields(w, steps[i], errors[i], corrected[i]);
        break;
      default:
        return -2;
    }
    put_lit(w, ", \"cacheInfo\": null}\n");
    if (w.overflow) return -1;
  }
  return w.p - out;
}

}  // namespace

extern "C" {

// Bulk ndjson campaign-log classifier (the analysis read path).
//
// Scans InjectionLog-schema ndjson lines and accumulates the class counts
// of analysis/json_parser.py's classify_run: the discriminating key of each
// line's "result" object, in its priority order invalid > stackOverflow >
// assertion > trainSdc > selfHeal > timeout > message > core; a core result
// is SDC when errors > 0, else CORRECTED when faults > 0, else SUCCESS, and
// adds its runtime to the completed-run step mean.  Keys are read only at
// depth 1 INSIDE the result object (the "name"/"symbol" fields can hold
// any bytes).
//
// counts must hold NUM_CLASSES (10) zeroed int64, inject/classify.py's
// order.  Returns the number of lines classified, or -1 if a non-empty
// line lacks the "result" marker or its result is not an object (the
// caller falls back to the Python parser).
int64_t coast_ndjson_classify(const char* buf, int64_t len, int64_t* counts,
                              int64_t* step_sum, int64_t* step_n) {
  static const char kResult[] = "\"result\": ";
  static const char kTail[] = ", \"cacheInfo\": null}";
  auto find = [](const char* p, const char* end, const char* needle,
                 size_t nlen) -> const char* {
    if ((size_t)(end - p) < nlen) return nullptr;
    const char* last = end - nlen;
    for (; p <= last; ++p) {
      if (p[0] == needle[0] && std::memcmp(p, needle, nlen) == 0) return p;
    }
    return nullptr;
  };
  // classify_run dispatches on the result DICT's top-level key membership
  // (analysis/json_parser.py:49-72).  Mirror that exactly: scan the result
  // object once, tracking string state and brace depth, and consider only
  // keys at depth 1.  A discriminating word appearing as a string VALUE
  // ({"status": "invalid"}) or inside a NESTED object ({"detail":
  // {"timeout": 5}}) must not reroute classification -- a plain substring
  // search silently diverges from the Python parser on such foreign lines.
  struct ResultKeys {
    bool object = false;   // result is a JSON object; anything else (list,
                           // string, null) gets Python's quirky membership
                           // semantics, so the caller must fall back.
    bool invalid = false, timeout = false, message = false, core = false;
    bool stack_overflow = false, assertion = false;
    bool self_heal = false, train_sdc = false;
    int64_t errors = 0, faults = 0, runtime = 0;
  };
  auto scan_result = [](const char* q, const char* end) -> ResultKeys {
    ResultKeys r;
    while (q < end && (*q == ' ' || *q == '\t')) ++q;
    if (q >= end || *q != '{') return r;   // r.object stays false
    r.object = true;
    int depth = 0;
    bool in_str = false, esc = false, have_key = false;
    const char* str_start = nullptr;    // open depth-1 string, if any
    const char* kb = nullptr;           // last completed depth-1 string
    size_t klen = 0;
    for (; q < end; ++q) {
      const char c = *q;
      if (in_str) {
        if (esc) esc = false;
        else if (c == '\\') esc = true;
        else if (c == '"') {
          in_str = false;
          if (depth == 1 && str_start) {
            kb = str_start;
            klen = (size_t)(q - str_start);
            have_key = true;
            str_start = nullptr;
          }
        }
        continue;
      }
      switch (c) {
        case '"':
          in_str = true;
          if (depth == 1) str_start = q + 1;
          break;
        case '{': case '[': ++depth; break;
        case '}': case ']':
          if (--depth == 0) return r;
          break;
        case ',': have_key = false; break;
        case ':':
          if (depth == 1 && have_key) {
            auto is = [&](const char* w, size_t n) {
              return klen == n && std::memcmp(kb, w, n) == 0;
            };
            if (is("invalid", 7)) r.invalid = true;
            else if (is("stackOverflow", 13)) r.stack_overflow = true;
            else if (is("assertion", 9)) r.assertion = true;
            else if (is("trainSdc", 8)) r.train_sdc = true;
            else if (is("selfHeal", 8)) r.self_heal = true;
            else if (is("timeout", 7)) r.timeout = true;
            else if (is("message", 7)) r.message = true;
            else if (is("core", 4)) r.core = true;
            else if (is("errors", 6) || is("faults", 6)
                     || is("runtime", 7)) {
              const char* v = q + 1;
              while (v < end && (*v == ' ' || *v == '\t')) ++v;
              const bool neg = (v < end && *v == '-');
              if (neg) ++v;
              int64_t x = 0;
              bool any = false;
              while (v < end && *v >= '0' && *v <= '9') {
                x = x * 10 + (*v - '0');
                ++v;
                any = true;
              }
              if (any) {
                x = neg ? -x : x;
                if (kb[0] == 'e') r.errors = x;
                else if (kb[0] == 'f') r.faults = x;
                else r.runtime = x;
              }
            }
            have_key = false;
          }
          break;
        default: break;
      }
    }
    return r;
  };
  auto rfind = [](const char* p, const char* end, const char* needle,
                  size_t nlen) -> const char* {
    if ((size_t)(end - p) < nlen) return nullptr;
    for (const char* q = end - nlen; q >= p; --q) {
      if (q[0] == needle[0] && std::memcmp(q, needle, nlen) == 0) return q;
    }
    return nullptr;
  };
  int64_t lines = 0;
  const char* p = buf;
  const char* const bend = buf + len;
  while (p < bend) {
    const char* nl = (const char*)std::memchr(p, '\n', bend - p);
    const char* lend = nl ? nl : bend;
    if (lend == p) { p = lend + 1; continue; }  // empty line
    // Anchor the result field from the line TAIL: a JSON-escaped leaf
    // name can legitimately contain the bytes "result": (escaping keeps
    // the inner quote characters), but the fixed result templates cannot,
    // so the LAST marker before the ", "cacheInfo": null} suffix is the
    // real field.  Lines without that exact suffix (foreign InjectionLog
    // writers) fall back to the first marker.
    const char* rend = lend;
    const char* res = nullptr;
    const size_t tail_len = sizeof kTail - 1;
    if ((size_t)(lend - p) > tail_len
        && std::memcmp(lend - tail_len, kTail, tail_len) == 0) {
      rend = lend - tail_len;
      res = rfind(p, rend, kResult, sizeof kResult - 1);
    } else {
      res = find(p, lend, kResult, sizeof kResult - 1);
    }
    if (!res) return -1;
    res += sizeof kResult - 1;
    const ResultKeys rk = scan_result(res, rend);
    // Non-object results (a list, a bare string, null): classify_run's
    // `"timeout" in res` membership does substring/element search there,
    // which this scanner deliberately does not model -- punt the whole
    // file to the Python parser rather than silently diverge.
    if (!rk.object) return -1;
    if (rk.invalid) {
      counts[5]++;
    } else if (rk.stack_overflow) {
      counts[6]++;
    } else if (rk.assertion) {
      counts[7]++;
    } else if (rk.train_sdc) {
      // Training refinements of SDC: completed runs (they carry the
      // ordinary core/runtime fields next to the discriminating key),
      // so they feed the mean-runtime statistic like classify_run's
      // "core" accounting does for them.
      counts[9]++;
      *step_sum += rk.runtime;
      (*step_n)++;
    } else if (rk.self_heal) {
      counts[8]++;
      *step_sum += rk.runtime;
      (*step_n)++;
    } else if (rk.timeout) {
      counts[4]++;
    } else if (rk.message) {
      counts[3]++;
    } else if (rk.core) {
      if (rk.errors > 0) counts[2]++;
      else if (rk.faults > 0) counts[1]++;
      else counts[0]++;
      *step_sum += rk.runtime;
      (*step_n)++;
    } else {
      counts[5]++;  // classify_run's final fallback: invalid
    }
    ++lines;
    p = lend + 1;
  }
  return lines;
}


// Rows [lo, hi) of whole-campaign columns: row i carries number i.
int64_t coast_ndjson_encode(
    int64_t lo, int64_t hi, const int32_t* leaf_id, const int32_t* lane,
    const int32_t* word, const int32_t* bit, const int32_t* t,
    const int32_t* code, const int32_t* errors, const int32_t* corrected,
    const int32_t* steps, int32_t n_leaves, const char* const* sec_kind,
    const char* const* sec_name, const char* ts, char* out,
    int64_t out_cap) {
  return encode_body(lo, hi, 0, leaf_id, lane, word, bit, t, code, errors,
                     corrected, steps, n_leaves, sec_kind, sec_name, ts, out,
                     out_cap);
}

// Rows [0, n) of ONE collected batch's columns, numbered number_base...:
// the streaming writer's entry, byte for byte coast_ndjson_encode over
// the same rows of the whole columns.
int64_t coast_ndjson_encode_rows(
    int64_t n, int64_t number_base, const int32_t* leaf_id,
    const int32_t* lane, const int32_t* word, const int32_t* bit,
    const int32_t* t, const int32_t* code, const int32_t* errors,
    const int32_t* corrected, const int32_t* steps, int32_t n_leaves,
    const char* const* sec_kind, const char* const* sec_name, const char* ts,
    char* out, int64_t out_cap) {
  if (n < 0 || number_base < 0) return -2;
  return encode_body(0, n, number_base, leaf_id, lane, word, bit, t, code,
                     errors, corrected, steps, n_leaves, sec_kind, sec_name,
                     ts, out, out_cap);
}

}  // extern "C"
