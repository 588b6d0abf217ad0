// ndjson: the port's host-side campaign-log encoder.
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
