// Line-protocol text of columnar rows: what the bulk load
// (convert.load_columnar) logs to a shard's WAL, so that its rows are
// durable without a flush and either package replays them.
//
// One line per selected row:
//   <series key> <name>=<value>[,<name>=<value>...] <timestamp ns>
// The series keys and the "name=" prefixes come escaped from the caller;
// string values come pre-quoted (one blob per column with int64
// offsets). Floats are written in the shortest form that parses back to
// the same double (std::to_chars where the library has it, else %.17g,
// which also round-trips). Fields whose valid byte is 0 are left out; the
// caller drops rows with no valid field (line protocol cannot carry one).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 lpformat.cpp (the port's
// native/__init__.py does this at first use).
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <version>

namespace {

enum ColType : int32_t { kFloat = 1, kInt = 2, kBool = 3, kString = 4 };

inline char* put_double(char* p, double v) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  return std::to_chars(p, p + 32, v).ptr;
#else
  return p + std::snprintf(p, 32, "%.17g", v);
#endif
}

inline char* put_int(char* p, int64_t v) {
  return std::to_chars(p, p + 24, v).ptr;
}

}  // namespace

extern "C" {

// Writes the lines of `n` rows (row indices `rows`) into `out` (`cap`
// bytes), newline-separated. Returns the bytes written, or -1 when `cap`
// is too small.
int64_t ogt_lp_format(int64_t n, const int64_t* rows, const int64_t* ts,
                      const int64_t* series_ref, const char* key_blob,
                      const int64_t* key_off, int32_t n_cols,
                      const int32_t* col_type, const void* const* col_vals,
                      const uint8_t* const* col_valid,
                      const char* const* col_prefix,
                      const int64_t* col_prefix_len,
                      const int64_t* const* col_str_off, char* out,
                      int64_t cap) {
  char* p = out;
  char* const end = out + cap;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = rows[i];
    const int64_t ref = series_ref[r];
    const int64_t klen = key_off[ref + 1] - key_off[ref];
    // the fixed parts of a line: key, two separators, the timestamp and
    // the newline
    if (end - p < klen + 24) return -1;
    if (i) *p++ = '\n';
    std::memcpy(p, key_blob + key_off[ref], klen);
    p += klen;
    char sep = ' ';
    for (int32_t c = 0; c < n_cols; ++c) {
      if (!col_valid[c][r]) continue;
      int64_t vlen = 32;
      if (col_type[c] == kString)
        vlen = col_str_off[c][r + 1] - col_str_off[c][r];
      if (end - p < 1 + col_prefix_len[c] + vlen + 24) return -1;
      *p++ = sep;
      sep = ',';
      std::memcpy(p, col_prefix[c], col_prefix_len[c]);
      p += col_prefix_len[c];
      switch (col_type[c]) {
        case kFloat:
          p = put_double(p, static_cast<const double*>(col_vals[c])[r]);
          break;
        case kInt:
          p = put_int(p, static_cast<const int64_t*>(col_vals[c])[r]);
          *p++ = 'i';
          break;
        case kBool:
          if (static_cast<const uint8_t*>(col_vals[c])[r]) {
            std::memcpy(p, "true", 4);
            p += 4;
          } else {
            std::memcpy(p, "false", 5);
            p += 5;
          }
          break;
        default:
          std::memcpy(p, static_cast<const char*>(col_vals[c]) +
                             col_str_off[c][r], vlen);
          p += vlen;
      }
    }
    *p++ = ' ';
    p = put_int(p, ts[r]);
  }
  return p - out;
}

}  // extern "C"
